"""Port vs reference: condensing, the box-QP solvers and the ADMM kernel's
plain version (TPU kernel 7).

Numpy-seeded problems go through ``benchmarking_mpc_solvers_tpu/ops/qp.py``
and the port's ``ops/qp.py``; the plain version of ``admm_iterate`` is held
against the reference's Pallas kernel in interpret mode at the sizes of the
reference's own kernel test (tests/test_qp_pallas.py: shared and
per-problem layouts, a ragged B), and at n = 256, where the card runs the
kernel's streaming form, against the Pallas kernel (shared) and the XLA
loop the reference falls back to (per problem).

Tolerances. Condensing: rtol = atol = 1e-5 (1e-4 for g, as the reference's
own condense test: it sums T·S products of O(1) terms). The ADMM iterates:
atol 2e-5, the reference's own for kernel-vs-XLA; the iteration is a
contraction, so rounding differences of the matvec's summation order do
not grow. Iteration counts and residual flags of the early exits must be
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.ops import qp as jqp
from benchmarking_mpc_solvers_tpu.ops.linearize import AffineDynamics as JDyn
from benchmarking_mpc_solvers_tpu.ops.qp_pallas import _admm_iterate_xla
from benchmarking_mpc_solvers_tpu.ops.qp_pallas import admm_iterate as j_admm_iterate
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch.ops import qp as tqp
from benchmarking_mpc_solvers_tpu_torch.ops import qp_admm
from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import admm_iterate, admm_iterate_reference


def _spd(rng, n, lead=()):
    a = rng.standard_normal(lead + (n, n))
    return (a @ np.swapaxes(a, -1, -2) / n + np.eye(n)).astype(np.float32)


def _tracking(seed, T=6, S=3, A=1, lead=()):
    """(dyn leaves, Q, R, Qf, xref, uref, lo, hi) as numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    dyn = (f(np.eye(S) + 0.1 * rng.standard_normal(lead + (T, S, S))),
           f(rng.standard_normal(lead + (T, S, A))), f(0.1 * rng.standard_normal(lead + (T, S))))
    Q = _spd(rng, S)
    return (dyn, Q, np.eye(A, dtype=np.float32), 2.0 * Q, f(rng.standard_normal(S)),
            np.zeros(A, np.float32), -np.ones(A, np.float32), np.ones(A, np.float32))


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _jqp(H, g, lo, hi):
    n = g.shape[0]
    return jqp.CondensedQP(*_j(H, g, lo, hi), jnp.zeros((1, 1, n)), jnp.zeros((1, 1)))


def _tqp(H, g, lo, hi):
    n = g.shape[0]
    return tqp.CondensedQP(*_t(H, g, lo, hi), torch.zeros((1, 1, n)), torch.zeros((1, 1)))


def _box_qp(seed, n=12, scale=1.0):
    rng = np.random.default_rng(seed)
    return (_spd(rng, n), (scale * rng.standard_normal(n)).astype(np.float32),
            -0.5 * np.ones(n, np.float32), 0.5 * np.ones(n, np.float32))


# -- condensing ---------------------------------------------------------------------

@pytest.mark.parametrize("A", [1, 2])
def test_condense_matches_reference(A):
    dyn, *w = _tracking(0, A=A)
    x0 = np.random.default_rng(1).standard_normal(3).astype(np.float32)
    want = jqp.condense(JDyn(*_j(*dyn)), jnp.asarray(x0), *_j(*w))
    got = tqp.condense(convert.affine_dynamics_from_numpy(*dyn, device="cpu"), torch.tensor(x0),
                       *_t(*w))
    for field in got._fields:
        tol = 1e-4 if field == "g" else 1e-5
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=tol, atol=tol, err_msg=field)


def test_condense_with_leading_batch_matches_vmapped_reference():
    B = 4
    dyn, *w = _tracking(2, lead=(B,))
    x0s = np.random.default_rng(3).standard_normal((B, 3)).astype(np.float32)
    want = jax.vmap(lambda A_, B_, c_, x: jqp.condense(JDyn(A_, B_, c_), x, *_j(*w)))(
        *_j(*dyn), jnp.asarray(x0s))
    got = tqp.condense(convert.affine_dynamics_from_numpy(*dyn, device="cpu"),
                       torch.tensor(x0s), *_t(*w))
    for field in got._fields:
        tol = 1e-4 if field == "g" else 1e-5
        g = getattr(got, field)
        assert tuple(g.shape) == getattr(want, field).shape, field
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, field)), rtol=tol,
                                   atol=tol, err_msg=field)


def test_condense_batch_matches_reference():
    dyn, *w = _tracking(4)
    x0s = np.random.default_rng(5).standard_normal((5, 3)).astype(np.float32)
    want = jqp.condense_batch(JDyn(*_j(*dyn)), jnp.asarray(x0s), *_j(*w))
    got = tqp.condense_batch(convert.affine_dynamics_from_numpy(*dyn, device="cpu"),
                             torch.tensor(x0s), *_t(*w))
    for field in got._fields:
        tol = 1e-4 if field == "g" else 1e-5
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=tol, atol=tol, err_msg=field)


# -- the scalar solvers -------------------------------------------------------------

@pytest.mark.parametrize("seed,scale,eps", [(0, 1.0, 0.0), (1, 3.0, 0.0), (2, 0.2, 1e-4),
                                            (3, 1.0, 1e-3)])
def test_admm_solve_matches_reference(seed, scale, eps):
    """eps = 0 runs every iteration; eps > 0 leaves early in the reference
    and freezes here: the same U, residual flags and iteration count."""
    qp = _box_qp(seed, scale=scale)
    want = jqp.admm_solve(_jqp(*qp), rho=1.0, iters=80, eps=eps)
    got = tqp.admm_solve(_tqp(*qp), rho=1.0, iters=80, eps=eps)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), atol=2e-5)
    assert int(got.iters) == int(want.iters)
    if eps > 0:
        assert int(got.iters) < 80  # the exit was taken
        assert float(got.r_prim) < eps and float(got.r_dual) < eps
    np.testing.assert_allclose(float(got.r_prim), float(want.r_prim), atol=2e-5)
    np.testing.assert_allclose(float(got.r_dual), float(want.r_dual), atol=2e-5)
    assert float(got.U.abs().max()) <= 0.5
    np.testing.assert_allclose(float(tqp.qp_objective(_tqp(*qp), got.U)),
                               float(jqp.qp_objective(_jqp(*qp), want.U)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tqp.kkt_residual(_tqp(*qp), got.U)),
                               float(jqp.kkt_residual(_jqp(*qp), want.U)), atol=1e-4)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 3.0)])
def test_ip_solve_matches_reference(seed, scale):
    """Tolerance 1e-4: 25 damped Newton steps with float32 dense solves of a
    barrier Hessian whose entries reach μ/d² ~ 1e6 near an active bound."""
    qp = _box_qp(seed, scale=scale)
    want = jqp.ip_solve(_jqp(*qp), iters=25)
    got = tqp.ip_solve(_tqp(*qp), iters=25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # and it solves the QP: ADMM run to convergence reaches the same objective
    # (the barrier keeps the IP point 1e-6 of the box inside each bound)
    ref = tqp.admm_solve(_tqp(*qp), iters=400, eps=0.0).U
    assert float(got.abs().max()) <= 0.5
    np.testing.assert_allclose(float(tqp.qp_objective(_tqp(*qp), got)),
                               float(tqp.qp_objective(_tqp(*qp), ref)), rtol=1e-3)


@pytest.mark.parametrize("eps,bound", [(0.0, 0.3), (1e-3, 10.0)])
def test_admm_solve_riccati_batch_matches_reference(eps, bound):
    """With binding bounds every iteration runs; with loose bounds the
    batch converges in a few iterations and both packages leave the loop
    at the same count."""
    dyn, Q, R, Qf, xref, uref, lo, hi = _tracking(6, T=8)
    lo, hi = bound * lo, bound * hi
    x0s = np.random.default_rng(7).standard_normal((4, 3)).astype(np.float32)
    want = jqp.admm_solve_riccati_batch(JDyn(*_j(*dyn)), jnp.asarray(x0s),
                                        *_j(Q, R, Qf, xref, uref, lo, hi), iters=60, eps=eps)
    tdyn = convert.affine_dynamics_from_numpy(*dyn, device="cpu")
    got = tqp.admm_solve_riccati_batch(tdyn, torch.tensor(x0s),
                                       *_t(Q, R, Qf, xref, uref, lo, hi), iters=60, eps=eps)
    assert got[0].shape == (4, 8, 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5)
    assert int(got[3]) == int(want[3])
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=2e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=2e-5)
    if eps > 0:
        assert int(got[3]) < 10
    else:
        assert (got[0].abs() == bound).any()  # some controls sit on a bound
    one_w = jqp.admm_solve_riccati(JDyn(*_j(*dyn)), jnp.asarray(x0s[1]),
                                   *_j(Q, R, Qf, xref, uref, lo, hi), iters=60, eps=eps)
    one_g = tqp.admm_solve_riccati(tdyn, torch.tensor(x0s[1]),
                                   *_t(Q, R, Qf, xref, uref, lo, hi), iters=60, eps=eps)
    assert one_g[0].shape == (8, 1) and int(one_g[3]) == int(one_w[3])
    np.testing.assert_allclose(one_g[0].numpy(), np.asarray(one_w[0]), atol=2e-5)


def test_riccati_admm_and_condensed_admm_solve_the_same_qp():
    dyn, Q, R, Qf, xref, uref, lo, hi = _tracking(8, T=6)
    tdyn = convert.affine_dynamics_from_numpy(*dyn, device="cpu")
    x0 = torch.tensor(np.random.default_rng(9).standard_normal(3).astype(np.float32))
    args = _t(Q, R, Qf, xref, uref, 0.3 * lo, 0.3 * hi)
    U = tqp.admm_solve(tqp.condense(tdyn, x0, *args), iters=400, eps=0.0).U
    us, _, _, _ = tqp.admm_solve_riccati(tdyn, x0, *args, iters=400, eps=0.0)
    torch.testing.assert_close(us[:, 0], U, rtol=1e-3, atol=1e-3)


# -- kernel 7's plain version ---------------------------------------------------------

def _kernel_inputs(seed, n, B, per_problem, rho):
    rng = np.random.default_rng(seed)
    H = _spd(rng, n, (B,) if per_problem else ())
    Minv = np.linalg.inv(H.astype(np.float64) + rho * np.eye(n)).astype(np.float32)
    g = rng.standard_normal((B, n)).astype(np.float32)
    return H, Minv, g


@pytest.mark.parametrize("n,B,per_problem,rho,iters,bound", [
    (20, 7, False, 1.0, 10, 1.0), (20, 7, False, 1.0, 60, 1.0), (12, 5, True, 2.0, 80, 0.5),
    (6, 3, False, 1.0, 40, 1.0)], ids=["shared-10", "shared-60", "per-problem", "ragged"])
def test_admm_iterate_plain_matches_reference_kernel(n, B, per_problem, rho, iters, bound):
    """Against the Pallas kernel in interpret mode, its XLA loop, and (as
    the reference's own test) ``admm_solve`` with eps = 0."""
    H, Minv, g = _kernel_inputs(n, n, B, per_problem, rho)
    lo, hi = -bound * np.ones(n, np.float32), bound * np.ones(n, np.float32)
    before = admm_iterate.launches
    got = admm_iterate(*_t(Minv, g, lo, hi), rho=rho, iters=iters)
    assert admm_iterate.launches == before and got.shape == (B, n)
    want = j_admm_iterate(*_j(Minv, g, lo, hi), rho=rho, iters=iters, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    lo_b, hi_b = np.broadcast_to(lo, (B, n)), np.broadcast_to(hi, (B, n))
    xla = _admm_iterate_xla(*_j(Minv, g, lo_b, hi_b), rho, 1.6, iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=2e-5)
    assert float(got.abs().max()) <= bound
    for b in range(B):
        Hb = H[b] if per_problem else H
        ref = tqp.admm_solve(_tqp(Hb, g[b], lo, hi), rho=rho, iters=iters, eps=0.0).U
        np.testing.assert_allclose(got[b].numpy(), ref.numpy(), atol=5e-5)
    # per-problem (B, n) bounds and a sub-batch give the same rows
    again = admm_iterate_reference(*_t(Minv, g, lo_b.copy(), hi_b.copy()), rho=rho, iters=iters)
    assert torch.equal(again, got)
    one = admm_iterate(*_t(Minv[:1] if per_problem else Minv, g[:1], lo, hi), rho=rho,
                       iters=iters)
    assert torch.equal(one[0], got[0])


@pytest.mark.parametrize("per_problem", [False, True], ids=["shared", "per-problem"])
def test_admm_iterate_plain_matches_reference_past_the_shared_memory_form(per_problem):
    """n = 256, beyond what a block's shared memory holds (the card runs the
    streaming form there), 5 iterations. The shared layout against the
    Pallas kernel in interpret mode (its VMEM footprint fits the
    reference's budget); per problem against ``_admm_iterate_xla``, the
    loop the reference falls back to at this size. Tolerance atol 2e-5, as
    at the smaller sizes: XLA sums each row's 256 terms in its own order,
    the plain version in j order, and the iteration, a contraction, does
    not grow the difference (under 1e-6 here)."""
    n, B, iters = 256, 3, 5
    H, Minv, g = _kernel_inputs(31, n, B, per_problem, 1.0)
    lo, hi = -0.5 * np.ones(n, np.float32), 0.5 * np.ones(n, np.float32)
    assert qp_admm.block_plan(B, n, per_problem).form == "streaming"
    got = admm_iterate(*_t(Minv, g, lo, hi), iters=iters)
    if per_problem:
        lo_b, hi_b = np.broadcast_to(lo, (B, n)), np.broadcast_to(hi, (B, n))
        want = _admm_iterate_xla(*_j(Minv, g, lo_b, hi_b), 1.0, 1.6, iters)
    else:
        want = j_admm_iterate(*_j(Minv, g, lo, hi), iters=iters, interpret=True)
    assert got.shape == (B, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert float(got.abs().max()) <= 0.5
    assert (got.abs() == 0.5).any() and (got.abs() < 0.5).any()  # bounds bind, not all


def test_admm_iterate_size_rule_and_shape_checks():
    """The plan picks the form and its launch shape for every n: registers
    up to n = 64 (the row width n rounded up to a multiple of 4; two
    problems a warp up to 16; blocks of as many warps as still give each of
    the 132 SMs a block),
    shared memory up to n = 240 (n² + 2n floats within 227 KB), streaming
    above; never None."""
    plan = qp_admm.block_plan
    # (n, form, width, problems a block, threads, blocks at B = 512), both layouts
    for n, form, width, ppb, threads, blocks in [
            (1, "registers", 4, 2, 32, 256), (16, "registers", 16, 2, 32, 256),
            (17, "registers", 20, 2, 64, 256), (20, "registers", 20, 2, 64, 256),
            (32, "registers", 32, 2, 64, 256), (33, "registers", 36, 2, 64, 256),
            (50, "registers", 52, 2, 64, 256), (64, "registers", 64, 2, 64, 256),
            (65, "shared", 0, 1, 65, 512), (240, "shared", 0, 1, 240, 512),
            (241, "streaming", 0, 1, 256, 512), (2000, "streaming", 0, 1, 1024, 512)]:
        for per_problem in (False, True):
            p = plan(512, n, per_problem)
            assert p is not None and p[:5] == (form, width, ppb, threads, blocks), (n, p)
            assert p.smem <= qp_admm.SMEM_BUDGET_BYTES
    # the register form's warps each hold a double-buffered v (a slot a lane,
    # two past width 32, and a spare) and stage their matrices (two a warp up
    # to width 16, per problem) at an odd row stride
    assert plan(512, 20, False).smem == 4 * 2 * (2 * 36 + 20 * 21)
    assert plan(512, 16, False).smem == 4 * (2 * 36 + 16 * 17)
    assert plan(512, 16, True).smem == 4 * (2 * 36 + 2 * 16 * 17)
    assert plan(512, 50, True).smem == 4 * 2 * (2 * 68 + 50 * 51)
    assert plan(512, 5, True).smem == 4 * (2 * 36 + 2 * 5 * 5)
    assert plan(512, 240, True).smem == 4 * (240 * 240 + 2 * 240)
    # warps a block: 4 while that still leaves every SM a block, then 2, then 1
    assert plan(4 * 132, 20, True)[2:5] == (4, 128, 132)
    assert plan(4 * 131, 20, True)[2:5] == (2, 64, 262)
    assert plan(256, 50, True)[2:5] == (1, 32, 256)
    assert plan(3, 20, False)[2:5] == (1, 32, 3)
    assert plan(3, 16, False)[2:5] == (2, 32, 2)  # the last warp holds one problem
    assert plan(1024, 20, False, sms=64)[2:5] == (4, 128, 256)
    with pytest.raises(ValueError, match="no plan"):
        plan(4, 0, False)
    Minv, g = torch.eye(4), torch.zeros((3, 4))
    with pytest.raises(ValueError, match="Minv has shape"):
        admm_iterate(torch.eye(5), g, -torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match="lo has shape"):
        admm_iterate(Minv, g, -torch.ones(3), torch.ones(4))
    with pytest.raises(ValueError, match="differ in shape"):
        admm_iterate(Minv, g, -torch.ones(4), torch.ones((3, 4)))
