"""Port vs reference: ``estimation/`` (Kalman filter and RTS smoother,
sigma-point moments, unscented filter and smoother).

Each function of the port is held against its counterpart in the reference
on the cases of the reference's own tests (tests/test_estimation.py), the
inputs drawn with numpy from a seed, and the batched form against
``jax.vmap``. Tolerance rtol 1e-4, atol 1e-5: both run float32 through the
same formulas; the solves go to different LAPACK drivers and XLA's CPU code
contracts multiply-adds, and 30 to 60 filter steps carry that along.

The unscented filter on the pendulum gets atol 2e-3 and its smoother 5e-3:
over 80 nonlinear steps sig_f = sig_p − L sig_y Lᵀ cancels down to a
covariance near 1e-6, and float32 itself is no closer than that. Run in
float64 the port's filter lies 4.5e-4 from its float32 self and 3.9e-4 from
the reference's float32 result; the smoothers 3.0e-3 and 1.6e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import estimation as jest
from benchmarking_mpc_solvers_tpu_torch import estimation as port

RTOL, ATOL = 1e-4, 1e-5


def _lgssm():
    A = np.array([[1.0, 0.1], [0.0, 0.95]], np.float32)
    a = np.array([0.0, 0.01], np.float32)
    B = np.array([[0.0], [0.1]], np.float32)
    C = np.array([[1.0, 0.0]], np.float32)
    Qn = 0.01 * np.eye(2, dtype=np.float32)
    Rn = 0.04 * np.eye(1, dtype=np.float32)
    mats = (A, a, B, C, Qn, Rn)
    return (jest.LGSSM(*(jnp.asarray(m) for m in mats)),
            port.LGSSM(*(torch.tensor(m) for m in mats)), mats)


def _simulate(mats, x0, us, rng):
    A, a, B, C, Qn, Rn = mats
    xs, ys = [x0], []
    x = x0
    for u in us:
        x = A @ x + a + B @ u + rng.multivariate_normal(np.zeros(2), Qn)
        ys.append(C @ x + rng.multivariate_normal(np.zeros(1), Rn))
        xs.append(x)
    return np.array(xs), np.array(ys, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    for field, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol, err_msg=field)


@pytest.mark.parametrize("seed,N,x0", [(0, 30, (1.0, 0.0)), (1, 60, (0.5, -0.2))])
def test_kalman_filter_and_smoother_match_reference(seed, N, x0):
    jm, tm, mats = _lgssm()
    rng = np.random.default_rng(seed)
    us = rng.uniform(-1, 1, (N, 1)).astype(np.float32)
    xs, ys = _simulate(mats, np.array(x0, np.float32), us, rng)
    mu0, sig0 = np.zeros(2, np.float32), np.eye(2, dtype=np.float32)
    want = jest.kalman_filter(jm, *(jnp.asarray(v) for v in (mu0, sig0, us, ys)))
    got = port.kalman_filter(tm, *(torch.tensor(v) for v in (mu0, sig0, us, ys)))
    assert got.mu_filt.shape == (N + 1, 2) and got.sig_pred.shape == (N, 2, 2)
    _close(got, want)
    want_s = jest.rts_smoother(jm, want)
    got_s = port.rts_smoother(tm, got)
    _close(got_s, want_s)
    both = port.kalman_smooth(tm, *(torch.tensor(v) for v in (mu0, sig0, us, ys)))
    _close(both, jest.kalman_smooth(jm, *(jnp.asarray(v) for v in (mu0, sig0, us, ys))))
    # smoothing improves the observed coordinate on this path, and the
    # smoother's endpoint is the filter's (the reference's own checks)
    err_filt = np.mean((got.mu_filt.numpy()[:, 0] - xs[:, 0]) ** 2)
    err_smooth = np.mean((got_s.mu_smooth.numpy()[:, 0] - xs[:, 0]) ** 2)
    assert err_smooth < err_filt
    torch.testing.assert_close(got_s.mu_smooth[-1], got.mu_filt[-1], rtol=0, atol=0)


def test_batched_filter_matches_vmapped_reference():
    jm, tm, _ = _lgssm()
    N, Bt = 10, 4
    rng = np.random.default_rng(3)
    us = rng.uniform(-1, 1, (Bt, N, 1)).astype(np.float32)
    ys = rng.uniform(-1, 1, (Bt, N, 1)).astype(np.float32)
    mu0 = rng.standard_normal((Bt, 2)).astype(np.float32)
    sig0 = np.tile(np.eye(2, dtype=np.float32), (Bt, 1, 1))
    want = jax.vmap(lambda m, s, u, y: jest.kalman_smooth(jm, m, s, u, y))(
        *(jnp.asarray(v) for v in (mu0, sig0, us, ys)))
    got = port.kalman_smooth(tm, *(torch.tensor(v) for v in (mu0, sig0, us, ys)))
    assert got.mu_smooth.shape == (Bt, N + 1, 2) and got.sig_smooth.shape == (Bt, N + 1, 2, 2)
    _close(got, want)
    # a shared prior broadcasts over the batch
    shared = port.kalman_filter(tm, torch.zeros(2), torch.eye(2), torch.tensor(us),
                                torch.tensor(ys))
    tiled = port.kalman_filter(tm, torch.zeros((Bt, 2)), torch.tensor(sig0), torch.tensor(us),
                               torch.tensor(ys))
    _close(shared, tiled, rtol=1e-6, atol=1e-6)  # a broadcast product rounds like a batched one


@pytest.mark.parametrize("alpha,beta,kappa,dim", [(1.0, 0.0, 0.0, 2), (0.5, 2.0, 1.0, 3)])
def test_sigma_points_match_reference(alpha, beta, kappa, dim):
    want = jest.make_sigma_points(alpha, beta, kappa, dim)
    got = port.make_sigma_points(alpha, beta, kappa, dim, device="cpu")
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.sf == want.sf
    assert got.wghts_m[0] == 0.0 and got.wghts_sig[0] == 0.0  # the zeroed centre weights
    rng = np.random.default_rng(dim)
    m_x = rng.standard_normal(dim).astype(np.float32)
    a = rng.standard_normal((dim, dim))
    sig_x = (a @ a.T / dim + 0.2 * np.eye(dim)).astype(np.float32)
    np.testing.assert_allclose(
        port.propagate(got, torch.tensor(m_x), torch.tensor(sig_x)).numpy(),
        np.asarray(jest.propagate(want, jnp.asarray(m_x), jnp.asarray(sig_x))),
        rtol=RTOL, atol=ATOL)
    want_m = jest.moments(want, lambda pts: jnp.sin(pts) * 2.0 + pts[:, ::-1],
                          jnp.asarray(m_x), jnp.asarray(sig_x))
    got_m = port.moments(got, lambda pts: torch.sin(pts) * 2.0 + pts.flip(-1),
                         torch.tensor(m_x), torch.tensor(sig_x))
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_sigma_points_exact_for_linear_gaussian():
    """Unscented moments of a linear map are exact (the reference's own
    check), here also over a leading batch dimension."""
    sp = port.make_sigma_points(1.0, 0.0, 0.0, 2, device="cpu")
    M = torch.tensor([[2.0, 1.0], [0.0, 3.0]])
    b = torch.tensor([0.5, -1.0])
    m_x = torch.tensor([[1.0, 2.0], [-0.5, 0.3]])
    sig_x = torch.tensor([[[0.3, 0.1], [0.1, 0.4]], [[1.0, -0.2], [-0.2, 0.5]]])
    m_y, sig_y, sig_xy = port.moments(sp, lambda pts: pts @ M.T + b, m_x, sig_x)
    torch.testing.assert_close(m_y, m_x @ M.T + b, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(sig_y, M @ sig_x @ M.T, rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(sig_xy, sig_x @ M.T, rtol=1e-3, atol=1e-5)


def _pendulum_track(tm, N, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor([0.8, 0.0])
    us = np.zeros((N, 1), np.float32)
    xs, ys = [x.numpy()], []
    for t in range(N):
        x = tm.dynamics(x[None], torch.tensor(us[t]))[0]
        xs.append(x.numpy())
        ys.append(tm.observe(x[None])[0].numpy() + 0.05 * rng.standard_normal(2))
    return np.array(xs), us, np.array(ys, np.float32)


def test_ukf_matches_reference_and_tracks_pendulum():
    jm = jest.make_pendulum_ukf(process_std=1e-3, obs_std=0.05)
    tm = port.make_pendulum_ukf(process_std=1e-3, obs_std=0.05, device="cpu")
    jsp, tsp = jest.default_sigma_points(2), port.default_sigma_points(2, device="cpu")
    N = 80
    xs, us, ys = _pendulum_track(tm, N, 2)
    pts = np.random.default_rng(0).standard_normal((5, 2)).astype(np.float32)
    np.testing.assert_allclose(tm.dynamics(torch.tensor(pts), torch.tensor([0.7])).numpy(),
                               np.asarray(jm.dynamics(jnp.asarray(pts), jnp.asarray([0.7]))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.observe(torch.tensor(pts)).numpy(),
                               np.asarray(jm.observe(jnp.asarray(pts))), rtol=1e-6, atol=1e-6)
    mu0, sig0 = np.zeros(2, np.float32), np.eye(2, dtype=np.float32)
    want = jest.ukf_filter(jm, jsp, *(jnp.asarray(v) for v in (mu0, sig0, us, ys)))
    got = port.ukf_filter(tm, tsp, *(torch.tensor(v) for v in (mu0, sig0, us, ys)))
    _close(got, want, rtol=1e-3, atol=2e-3)
    err_late = np.abs(got.mu_filt.numpy()[-20:, 0] - xs[-20:, 0]).mean()
    assert err_late < 0.1
    want_s = jest.ukf_smoother(jm, jsp, want, jnp.asarray(us))
    got_s = port.ukf_smoother(tm, tsp, got, torch.tensor(us))
    _close(got_s, want_s, rtol=1e-3, atol=5e-3)
    assert np.isfinite(got_s.mu_smooth.numpy()).all()


def test_batched_ukf_equals_its_rows():
    tm = port.make_pendulum_ukf(process_std=1e-2, obs_std=0.05, device="cpu")
    sp = port.default_sigma_points(2, device="cpu")
    tracks = [_pendulum_track(tm, 12, seed) for seed in (4, 5, 6)]
    us = torch.tensor(np.stack([t[1] for t in tracks]))
    ys = torch.tensor(np.stack([t[2] for t in tracks]))
    mu0, sig0 = torch.zeros((3, 2)), torch.eye(2).expand(3, 2, 2)
    fr = port.ukf_filter(tm, sp, mu0, sig0, us, ys)
    sm = port.ukf_smoother(tm, sp, fr, us)
    assert fr.mu_filt.shape == (3, 13, 2) and sm.sig_smooth.shape == (3, 13, 2, 2)
    for b in range(3):
        fr_b = port.ukf_filter(tm, sp, mu0[b], sig0[b], us[b], ys[b])
        sm_b = port.ukf_smoother(tm, sp, fr_b, us[b])
        torch.testing.assert_close(fr.mu_filt[b], fr_b.mu_filt, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(sm.mu_smooth[b], sm_b.mu_smooth, rtol=1e-3, atol=2e-3)


def test_constructors_default_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.make_sigma_points(1.0, 0.0, 0.0, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.make_pendulum_ukf()
