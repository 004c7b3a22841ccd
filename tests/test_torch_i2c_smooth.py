"""Port vs reference: the batched Kalman filter and RTS smoother of I2C.

The port's plain versions (``i2c_filter_reference``,
``i2c_rts_smooth_reference``, ``i2c_smooth_batch_reference``, which the
wrappers run on CPU tensors) are held against ``jax.vmap`` of the
reference's scan form ``I2C._kf_rts`` and, once, against its kernel run in
interpret mode. Inputs are drawn with numpy from a seed in the pattern of
the reference's own test (tests/test_i2c_pallas.py).

Tolerance rtol/atol 2e-4 against the scans, the reference's own for its
kernel against them: float32 in both, but the scans solve by LU where the
kernel and the plain version factor by Cholesky. Against the interpreted
kernel, whose arithmetic the plain version writes out in the same order,
1e-5: XLA's CPU code contracts multiply-adds, the plain version rounds each
operation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import CartPoleSwingUpEnv, PendulumEnv
from benchmarking_mpc_solvers_tpu.ops.i2c_pallas import i2c_smooth_batch as j_smooth
from benchmarking_mpc_solvers_tpu.solvers import I2C as JI2C
from benchmarking_mpc_solvers_tpu_torch.convert import i2c_problem_from_numpy
from benchmarking_mpc_solvers_tpu_torch.ops import i2c_smooth as ts

TOL_SCAN = 2e-4
TOL_KERNEL = 1e-5


def _problem(seed, B, T, S, A, Z, shared_R=False):
    """(F, m, J, z0, R, mu0, sig0, Qproc, g_z) as numpy arrays."""
    rng = np.random.default_rng(seed)
    D = S + A
    F = np.zeros((B, T, D, D))
    F[:, :, :S, :S] = np.eye(S) * 0.9 + 0.05 * rng.standard_normal((B, T, S, S))
    F[:, :, :S, S:] = 0.3 * rng.standard_normal((B, T, S, A))
    m = 0.1 * rng.standard_normal((B, T, D))
    J = rng.standard_normal((B, T, Z, D))
    z0 = 0.2 * rng.standard_normal((B, T, Z))
    Rm = rng.standard_normal((B, Z, Z))
    R = np.einsum("bij,bkj->bik", Rm, Rm) * 0.1 + 0.5 * np.eye(Z)
    if shared_R:
        R = R[0]
    mu0 = np.concatenate([rng.standard_normal((B, S)), np.zeros((B, A))], axis=1)
    sig0 = np.zeros((D, D))
    sig0[:S, :S] = 1e-8 * np.eye(S)
    sig0[S:, S:] = 0.25 * np.eye(A)
    Qproc = np.zeros((D, D))
    Qproc[:S, :S] = 1e-6 * np.eye(S)
    Qproc[S:, S:] = 0.25 * np.eye(A)
    g_z = 0.1 * rng.standard_normal((T, Z))
    return [a.astype(np.float32) for a in (F, m, J, z0, R, mu0, sig0, Qproc, g_z)]


def _jax_scans(p, env):
    """vmap of the reference's scan form; its priors are the defaults'."""
    F, m, J, z0, R, mu0, sig0, Qproc, g_z = (jnp.asarray(a) for a in p)
    solver = JI2C(model=env.model, T=F.shape[1])
    np.testing.assert_array_equal(np.asarray(solver._prior_covs()[0]), p[6])
    np.testing.assert_array_equal(np.asarray(solver._prior_covs()[1]), p[7])
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.vmap(
            lambda F_, m_, J_, z_, R_, mu_: solver._kf_rts(F_, m_, J_, z_, R_, mu_, g_z)
        )(F, m, J, z0, R, mu0))


@pytest.mark.parametrize("env", [PendulumEnv, CartPoleSwingUpEnv], ids=["D3", "D5"])
def test_plain_smoother_matches_reference_scans(env):
    S, A = env.model.state_size, env.model.action_size
    p = _problem(S, 4, 9, S, A, S + A)
    want = _jax_scans(p, env)
    args = i2c_problem_from_numpy(*p, device="cpu")
    got = ts.i2c_smooth_batch(*args)  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_SCAN, atol=TOL_SCAN)
    np.testing.assert_array_equal(ts.i2c_smooth_batch_reference(*args).numpy(), got.numpy())


def test_plain_smoother_matches_reference_kernel():
    p = _problem(11, 4, 9, 2, 1, 3)
    want = np.asarray(j_smooth(*(jnp.asarray(a) for a in p), interpret=True))
    got = ts.i2c_smooth_batch(*i2c_problem_from_numpy(*p, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_KERNEL, atol=TOL_KERNEL)


@pytest.mark.parametrize("D,Z", [(3, 3), (5, 5), (6, 4)])
def test_filter_and_smoother_match_matrix_form(D, Z):
    """Each pass separately against the same recursion in float64 matrix
    form (numpy): the four filter outputs, then the smoother on them."""
    S, A = D - 1, 1
    p = _problem(D * 10 + Z, 3, 7, S, A, Z)
    F, m, J, z0, R, mu0, sig0, Qproc, g_z = (a.astype(np.float64) for a in p)
    B, T = F.shape[:2]
    want = [np.zeros(s) for s in ((B, T, D), (B, T, D, D), (B, T, D), (B, T, D, D))]
    mu_s = np.zeros((B, T, D))
    for b in range(B):
        mu_p, sig_p = mu0[b], sig0
        for t in range(T):
            sig_y = J[b, t] @ sig_p @ J[b, t].T + R[b]
            L = np.linalg.solve(sig_y, J[b, t] @ sig_p).T
            mu_f = mu_p + L @ (g_z[t] - (J[b, t] @ mu_p + z0[b, t]))
            sig_f = sig_p - L @ J[b, t] @ sig_p
            sig_f = 0.5 * (sig_f + sig_f.T)
            mu_p = F[b, t] @ mu_f + m[b, t]
            sig_p = F[b, t] @ sig_f @ F[b, t].T + Qproc
            for w, v in zip(want, (mu_f, sig_f, mu_p, sig_p)):
                w[b, t] = v
        mu_n, sig_n = want[0][b, -1], want[1][b, -1]
        mu_s[b, -1] = mu_n
        for t in reversed(range(T - 1)):
            G = np.linalg.solve(want[3][b, t], F[b, t] @ want[1][b, t]).T
            mu_n = want[0][b, t] + G @ (mu_n - want[2][b, t])
            sig_n = want[1][b, t] + G @ (sig_n - want[3][b, t]) @ G.T
            mu_s[b, t] = mu_n
    args = i2c_problem_from_numpy(*p, device="cpu")
    got = ts.i2c_filter(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL_SCAN, atol=TOL_SCAN)
    sm = ts.i2c_rts_smooth(*got, args[0])
    np.testing.assert_allclose(sm.numpy(), mu_s, rtol=TOL_SCAN, atol=TOL_SCAN)
    np.testing.assert_array_equal(sm[:, -1].numpy(), got[0][:, -1].numpy())


def test_shared_observation_noise_equals_repeated_rows():
    p = _problem(5, 4, 6, 2, 1, 3, shared_R=True)
    shared = ts.i2c_smooth_batch(*i2c_problem_from_numpy(*p, device="cpu"))
    p[4] = np.repeat(p[4][None], 4, axis=0)
    rows = ts.i2c_smooth_batch(*i2c_problem_from_numpy(*p, device="cpu"))
    np.testing.assert_array_equal(shared.numpy(), rows.numpy())


def test_single_step_horizon_returns_filtered_mean():
    p = _problem(6, 3, 1, 2, 1, 3)
    args = i2c_problem_from_numpy(*p, device="cpu")
    got = ts.i2c_smooth_batch(*args)
    assert got.shape == (3, 1, 3)
    np.testing.assert_array_equal(got.numpy(), ts.i2c_filter(*args)[0].numpy())
    np.testing.assert_allclose(got.numpy(), _jax_scans(p, PendulumEnv), rtol=TOL_SCAN,
                               atol=TOL_SCAN)


def test_nan_scenario_stays_nan_and_leaves_the_others():
    """A NaN passes the Cholesky floor and reaches that scenario's output;
    the other scenarios' rows are what they are without it."""
    p = _problem(7, 4, 6, 2, 1, 3)
    clean = ts.i2c_smooth_batch(*i2c_problem_from_numpy(*p, device="cpu")).numpy()
    p[0][2, 1, 0, 0] = np.nan
    got = ts.i2c_smooth_batch(*i2c_problem_from_numpy(*p, device="cpu")).numpy()
    assert np.isnan(got[2]).all()
    keep = [0, 1, 3]
    np.testing.assert_array_equal(got[keep], clean[keep])
    # a NaN covariance entry at the factorisation itself: the floor keeps it
    L = ts._chol([[torch.tensor([float("nan"), 4.0, -1.0])]], 1)[0][0]
    assert np.isnan(L[0].item()) and L[1].item() == 2.0 and L[2].item() == np.float32(1e-15)


def test_shape_errors_and_kernel_size_limit():
    p = _problem(8, 2, 4, 2, 1, 3)
    args = list(i2c_problem_from_numpy(*p, device="cpu"))
    bad = list(args)
    bad[8] = bad[8][:-1]
    with pytest.raises(ValueError, match="g_z"):
        ts.i2c_filter(*bad)
    with pytest.raises(NotImplementedError, match="use_fused=False"):
        ts._check_dims("i2c_filter", 7, 3)
    ts._check_dims("i2c_filter", 6, 6)
    # the plain version takes any size
    big = i2c_problem_from_numpy(*_problem(9, 2, 3, 6, 1, 7), device="cpu")
    assert torch.isfinite(ts.i2c_smooth_batch(*big)).all()


def test_launch_config_refuses_sizes_above_six():
    with pytest.raises(NotImplementedError, match="D, Z <= 6"):
        ts.launch_config(7, 3, 16)
