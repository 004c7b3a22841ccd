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
    model = env.model if hasattr(env, "model") else env
    solver = JI2C(model=model, T=F.shape[1])
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


@pytest.mark.parametrize("S,A,Z", [(8, 1, 9), (6, 1, 10)], ids=["D9Z9", "D7Z10"])
def test_plain_smoother_matches_reference_kernel_past_six(S, A, Z):
    """Past the register form's D, Z <= 6 (the general form's sizes): the
    reference's kernel in interpret mode at D = Z = 9 (the dummy at S = 8)
    and D = 7, Z = 10, B = 2, T = 2 (its unrolled body compiles for 84 s and
    48 s on the CPU)."""
    p = _problem(21, 2, 2, S, A, Z)
    want = np.asarray(j_smooth(*(jnp.asarray(a) for a in p), interpret=True))
    got = ts.i2c_smooth_batch(*i2c_problem_from_numpy(*p, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_KERNEL, atol=TOL_KERNEL)


@pytest.mark.parametrize("S", [8, 11, 15, 16, 23, 31])
def test_plain_smoother_matches_reference_scans_past_six(S):
    """The dummy's D = Z = S + 1 (9, 12 and 16, the general form's edges;
    17, 24 and 32, the wide form's first size and its two row lengths)
    against the vmapped scans of the reference's I2C on
    ``make_dummy_model(S, 1)``."""
    from benchmarking_mpc_solvers_tpu.models import make_dummy_model

    p = _problem(S, 4, 6, S, 1, S + 1)
    want = _jax_scans(p, make_dummy_model(S, 1))
    got = ts.i2c_smooth_batch(*i2c_problem_from_numpy(*p, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_SCAN, atol=TOL_SCAN)


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


@pytest.mark.parametrize("S,A,Z", [(2, 1, 3), (8, 1, 9)], ids=["D3", "D9"])
def test_plain_versions_hold_on_windows_of_the_horizon(S, A, Z):
    """The filter's first n steps are its run on the inputs' first n steps,
    and the smoother's last n steps its run on the last n steps of its
    inputs, bit for bit: a long horizon's outputs can be held against the
    plain versions on a few steps at either end."""
    T, n = 7, 3
    args = i2c_problem_from_numpy(*_problem(11, 3, T, S, A, Z), device="cpu")
    full = ts.i2c_filter(*args)
    first = ts.i2c_filter(*(t[:, :n] if k < 4 else t[:n] if k == 8 else t
                            for k, t in enumerate(args)))
    for f, w in zip(full, first):
        np.testing.assert_array_equal(f[:, :n].numpy(), w.numpy())
    last = ts.i2c_rts_smooth(*(t[:, -n:] for t in (*full, args[0])))
    np.testing.assert_array_equal(ts.i2c_rts_smooth(*full, args[0])[:, -n:].numpy(),
                                  last.numpy())


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
    """Shapes are checked; no size is refused: the kernels' register form
    holds D, Z <= 6, their general form D, Z <= 16, their wide form D, Z <=
    32 and their large form every larger size, its workspace in shared
    memory while a block's four fit the card's 227 KB, else in device memory
    (B workspaces)."""
    p = _problem(8, 2, 4, 2, 1, 3)
    args = list(i2c_problem_from_numpy(*p, device="cpu"))
    bad = list(args)
    bad[8] = bad[8][:-1]
    with pytest.raises(ValueError, match="g_z"):
        ts.i2c_filter(*bad)
    assert ts.large_floats(9, 9) == (3 * 81 + 2 * 81 + 81 + 27, 5 * 81 + 18)
    assert ts.large_workspace(ts.large_floats(17, 17)[0], 5, "cpu") is None
    ws = ts.large_workspace(ts.large_floats(64, 64)[0], 5, "cpu")  # 4 x 98 KB
    assert ws.shape == (5 * ts.large_floats(64, 64)[0],)
    # the plain version takes any size
    big = i2c_problem_from_numpy(*_problem(9, 2, 3, 6, 1, 7), device="cpu")
    assert torch.isfinite(ts.i2c_smooth_batch(*big)).all()


@pytest.mark.parametrize("D,Z,form", [
    (1, 1, "register"), (6, 6, "register"), (7, 3, "general"), (3, 7, "general"),
    (12, 12, "general"), (13, 1, "general"), (16, 16, "general"), (17, 16, "wide"),
    (16, 17, "wide"), (17, 17, "wide"), (17, 5, "wide"), (24, 24, "wide"), (25, 3, "wide"),
    (32, 32, "wide"), (33, 32, "large"), (32, 33, "large"), (64, 64, "large")])
def test_kernel_form_by_size(D, Z, form):
    """The kernels' form by size, at each class's edges: the register form
    up to REG_DIM, the general form up to GENERAL_MAX, the wide form up to
    WIDE_MAX, the large form past it; the smoother takes the form of (D, D)."""
    assert (ts.REG_DIM, ts.GENERAL_MAX, ts.WIDE_MAX) == (6, 16, 32)
    assert ts.kernel_form(D, Z) == form
    assert ts.kernel_form(D, D) == ("register" if D <= 6 else "general" if D <= 16
                                    else "wide" if D <= 32 else "large")


# (D, Z, the filter's form, the entry points asked with (D, Z) in order): a
# smoother in the register form beside a larger filter asks its own entry
# point at (D, D) (it holds D, Z <= 6); the general, the wide and the large
# form share one, which reports each kernel's form by size
@pytest.mark.parametrize("D,Z,form,asks", [
    (7, 3, "general", [("i2c_general_launch_config", 7, 3)]),
    (3, 3, "register", [("i2c_launch_config", 3, 3)]),
    (12, 12, "general", [("i2c_general_launch_config", 12, 12)]),
    (16, 16, "general", [("i2c_general_launch_config", 16, 16)]),
    (17, 16, "wide", [("i2c_general_launch_config", 17, 16)]),
    (16, 17, "wide", [("i2c_general_launch_config", 16, 17)]),
    (3, 9, "general", [("i2c_general_launch_config", 3, 9), ("i2c_launch_config", 3, 3)]),
    (5, 17, "wide", [("i2c_general_launch_config", 5, 17), ("i2c_launch_config", 5, 5)]),
    (17, 17, "wide", [("i2c_general_launch_config", 17, 17)]),
    (32, 32, "wide", [("i2c_general_launch_config", 32, 32)]),
    (33, 32, "large", [("i2c_general_launch_config", 33, 32)]),
    (12, 33, "large", [("i2c_general_launch_config", 12, 33)]),
    (64, 64, "large", [("i2c_general_launch_config", 64, 64)])])
def test_launch_config_refuses_sizes_above_six(monkeypatch, D, Z, form, asks):
    """Sizes above six, once refused, report the general, the wide or the
    large form's launch shape (their own entry point); the register form's
    stay as they were. Read from the entry point each asks for, without a
    card."""
    asked = []

    def fake(name):
        def fn(D_, Z_, B_, out):
            asked.append((name, D_, Z_, B_))
            return 0
        return fn

    monkeypatch.setattr(ts._build, "kernel_fn", fake)
    cfg = ts.launch_config(D, Z, 16)
    assert asked == [(*a, 16) for a in asks] and cfg["form"] == form
    assert set(cfg) == {"form", "stages", "filter", "rts"}
    assert cfg["filter"]["form"] == form and cfg["rts"]["form"] == ts.kernel_form(D, D)
    assert "local_bytes" in cfg["filter"] and "local_bytes" in cfg["rts"]
