"""Port vs reference: the sequential TV-LQR recursions of ``ops/riccati.py``.

Random well-conditioned problems made with numpy go through the reference
(vmapped over the batch where the port takes a leading dimension) and the
port. Tolerance rtol = atol = 1e-4: both run the same float32 recursion,
but XLA's CPU matmuls and PyTorch's sum in different orders, and T steps of
the Riccati map carry the difference along; a wrong term moves a gain by
O(0.1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.ops import riccati as jric
from benchmarking_mpc_solvers_tpu.ops.linearize import AffineDynamics as JDyn
from benchmarking_mpc_solvers_tpu.ops.linearize import QuadCost as JCost
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch.ops import riccati as tric
from benchmarking_mpc_solvers_tpu_torch.ops.riccati_backward import tvlqr_backward_cv

TOL = 1e-4


def problem(lead, T, S, A, seed):
    """Random (dyn, cost) leaves as numpy arrays with leading dims ``lead``."""
    rng = np.random.default_rng(seed)
    eye_s, eye_a = np.eye(S), np.eye(A)

    def sym(m):
        return 0.5 * (m + np.swapaxes(m, -1, -2))

    dyn = (0.6 * eye_s + 0.2 * rng.standard_normal(lead + (T, S, S)),
           rng.standard_normal(lead + (T, S, A)),
           0.3 * rng.standard_normal(lead + (T, S)))
    cost = (0.3 * sym(rng.standard_normal(lead + (T, S, S))) + 2.0 * eye_s,
            0.1 * sym(rng.standard_normal(lead + (T, A, A))) + 1.0 * eye_a,
            0.1 * rng.standard_normal(lead + (T, A, S)),
            rng.standard_normal(lead + (T, S)),
            rng.standard_normal(lead + (T, A)),
            0.3 * sym(rng.standard_normal(lead + (S, S))) + 2.0 * eye_s,
            rng.standard_normal(lead + (S,)))
    return [a.astype(np.float32) for a in dyn], [a.astype(np.float32) for a in cost]


def both(dyn, cost):
    jd, jc = JDyn(*map(jnp.asarray, dyn)), JCost(*map(jnp.asarray, cost))
    td = convert.affine_dynamics_from_numpy(*dyn, device="cpu")
    tc = convert.quad_cost_from_numpy(*cost, device="cpu")
    return jd, jc, td, tc


def _close(got, want, name=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("A", [1, 2])
@pytest.mark.parametrize("reg", [0.0, 0.5])
def test_tvlqr_backward_matches_reference(A, reg):
    jd, jc, td, tc = both(*problem((3,), 7, 3, A, seed=A))
    want = jax.vmap(lambda d, c: jric.tvlqr_backward(d, c, reg))(jd, jc)
    got = tric.tvlqr_backward(td, tc, reg)
    _close(got.K, want.K, "K")
    _close(got.k, want.k, "k")
    one = tric.tvlqr_backward(tric.AffineDynamics(*(a[1] for a in td)),
                              tric.QuadCost(*(a[1] for a in tc)), reg)
    torch.testing.assert_close(one.K, got.K[1], rtol=1e-5, atol=1e-5)


def test_tvlqr_solve_and_rollout_match_reference():
    dyn, cost = problem((), 8, 4, 1, seed=3)
    jd, jc, td, tc = both(dyn, cost)
    x0 = np.random.default_rng(4).standard_normal(4).astype(np.float32)
    want_xs, want_us, want_pol = jric.tvlqr_solve(jd, jc, jnp.asarray(x0), reg=0.1)
    got_xs, got_us, got_pol = tric.tvlqr_solve(td, tc, torch.tensor(x0), reg=0.1)
    _close(got_pol.K, want_pol.K, "K")
    _close(got_xs, want_xs, "xs")
    _close(got_us, want_us, "us")
    xs2, us2 = tric.tvlqr_rollout(td, got_pol, torch.tensor(x0))
    torch.testing.assert_close(xs2, got_xs)
    torch.testing.assert_close(us2, got_us)


@pytest.mark.parametrize("A", [1, 2])
def test_riccati_factors_and_linear_batch_match_reference(A):
    T, S, B = 9, 3, 5
    dyn, cost = problem((), T, S, A, seed=10 + A)
    jd, jc, td, tc = both(dyn, cost)
    want_f = jric.riccati_factors(jd, jc)
    got_f = tric.riccati_factors(td, tc)
    for field in got_f._fields:
        _close(getattr(got_f, field), getattr(want_f, field), field)
    rng = np.random.default_rng(5)
    rs = rng.standard_normal((T, B, A)).astype(np.float32)
    x0s = rng.standard_normal((B, S)).astype(np.float32)
    want = jric.tvlqr_solve_linear_batch(jd, want_f, jc.q, jc.qf, jnp.asarray(rs),
                                         jnp.asarray(x0s))
    got = tric.tvlqr_solve_linear_batch(td, got_f, tc.q, tc.qf, torch.tensor(rs),
                                        torch.tensor(x0s))
    assert got.shape == (T, B, A)
    _close(got, want, "us")
    # with r_t as the linear term and M = 0 it is the TV-LQR solution itself
    if A == 1:
        cost0 = list(cost)
        cost0[2] = np.zeros_like(cost0[2])
        _, _, td0, tc0 = both(dyn, cost0)
        f0 = tric.riccati_factors(td0, tc0)
        us = tric.tvlqr_solve_linear_batch(td0, f0, tc0.q, tc0.qf,
                                           tc0.r[:, None, :].expand(T, B, A), torch.tensor(x0s))
        _, want_us, _ = tric.tvlqr_solve(
            tric.AffineDynamics(*(a.expand((B,) + a.shape) for a in td0)),
            tric.QuadCost(*(a.expand((B,) + a.shape) for a in tc0)), torch.tensor(x0s))
        torch.testing.assert_close(us.transpose(0, 1), want_us, rtol=1e-3, atol=1e-3)


def test_tvlqr_backward_cv_is_the_batched_backward_pass():
    """The kernel-tier dispatcher (its plain version here) against the
    matrix-form recursion and against the reference's own dispatcher under
    vmap with its kernel in interpret mode."""
    from benchmarking_mpc_solvers_tpu.ops.riccati_pallas import tvlqr_backward_cv as j_cv

    jd, jc, td, tc = both(*problem((4,), 6, 4, 1, seed=6))
    got = tvlqr_backward_cv(td, tc)
    want = tric.tvlqr_backward(td, tc, reg=0.0)
    torch.testing.assert_close(got.K, want.K, rtol=TOL, atol=TOL)
    torch.testing.assert_close(got.k, want.k, rtol=TOL, atol=TOL)
    ref = jax.vmap(j_cv)(jd, jc)
    _close(got.K, ref.K, "K")
    _close(got.k, ref.k, "k")


@pytest.mark.parametrize("form", ["factors", "linear_batch", "values_assoc", "backward_assoc",
                                  "assoc_general"])
def test_associative_scan_forms_agree_with_the_sequential_recursion(form):
    """Each associative-scan entry point on a three-step problem against
    the sequential recursion (tests/test_torch_riccati_assoc.py holds them
    against the reference); 2e-4, the scan's other order of float32
    solves."""
    dyn, cost = problem((), 3, 2, 1, seed=7)
    if form != "assoc_general":
        cost[2] = np.zeros_like(cost[2])  # the plain forms take no cross term
    _, _, td, tc = both(dyn, cost)
    tol = dict(rtol=2e-4, atol=2e-4)
    if form == "factors":
        got, want = tric.riccati_factors(td, tc, parallel=True), tric.riccati_factors(td, tc)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **tol)
    elif form == "linear_batch":
        f = tric.riccati_factors(td, tc)
        rs, x0s = torch.ones((3, 4, 1)), torch.full((4, 2), 0.5)
        torch.testing.assert_close(
            tric.tvlqr_solve_linear_batch(td, f, tc.q, tc.qf, rs, x0s, parallel=True),
            tric.tvlqr_solve_linear_batch(td, f, tc.q, tc.qf, rs, x0s), **tol)
    elif form == "values_assoc":
        P, _ = tric.tvlqr_values_assoc(td, tc)
        f = tric.riccati_factors(td, tc)
        # P_{t+1} c_t of the sequential factors, from the scan's values
        torch.testing.assert_close((P[1:] @ td.c[..., None])[..., 0], f.Pc, **tol)
    else:
        fn = tric.tvlqr_backward_assoc if form == "backward_assoc" else (
            tric.tvlqr_backward_assoc_general)
        got, want = fn(td, tc), tric.tvlqr_backward(td, tc)
        torch.testing.assert_close(got.K, want.K, **tol)
        torch.testing.assert_close(got.k, want.k, **tol)
