"""Port vs reference: the associative-scan Riccati of ``ops/riccati.py``.

``tvlqr_values_assoc``, ``tvlqr_backward_assoc`` and
``tvlqr_backward_assoc_general`` against the reference's on numpy-seeded
well-conditioned problems (tests/test_torch_tvlqr.py's), against the port's
own sequential ``tvlqr_backward``, and over a leading batch dimension
against ``jax.vmap``; ``associative_scan`` against a plain left-to-right
scan; the ``parallel=True`` forms of ``riccati_factors`` and
``tvlqr_solve_linear_batch`` against their sequential settings and the
reference's.

Tolerance rtol = atol = 2e-4. The scan composes the horizon's steps
pairwise, each composition a float32 solve of I + C P, in another order
than the sequential recursion and than XLA's scan (which pairs the same
way but solves by its own LU): the forms agree to rounding, not bit for
bit. The reference holds its own associative form to the sequential one at
1e-3 (tests/test_qp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.ops import riccati as jric
from benchmarking_mpc_solvers_tpu_torch.ops import riccati as tric
from test_torch_tvlqr import both, problem

TOL = 2e-4


def _close(got, want, name=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=name)


def _no_cross(dyn, cost):
    cost[2] = np.zeros_like(cost[2])
    return dyn, cost


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 13])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_a_plain_scan(n, reverse):
    """Affine maps x -> G x + h under composition, an associative but not
    commutative operation: every prefix (suffix) against the loop."""
    rng = np.random.default_rng(n)
    G = torch.tensor((0.7 * rng.standard_normal((n, 3, 3))).astype(np.float32))
    h = torch.tensor(rng.standard_normal((n, 3)).astype(np.float32))
    calls = []

    def compose(first, then):
        calls.append(first[0].shape[0])
        return then[0] @ first[0], (then[0] @ first[1][..., None])[..., 0] + then[1]

    got_G, got_h = tric.associative_scan(compose, (G, h), reverse=reverse)
    order = list(reversed(range(n))) if reverse else list(range(n))
    accG, acch = G[order[0]], h[order[0]]
    for i in order:
        if i != order[0]:
            accG, acch = G[i] @ accG, G[i] @ acch + h[i]
        torch.testing.assert_close(got_G[i], accG, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_h[i], acch, rtol=1e-5, atol=1e-5)
    assert len(calls) <= 2 * max(1, int(np.ceil(np.log2(max(n, 2)))))  # O(log n) calls


@pytest.mark.parametrize("T,S,A", [(6, 3, 1), (9, 2, 2), (1, 2, 1)])
def test_values_and_policy_match_reference_and_sequential(T, S, A):
    jd, jc, td, tc = both(*_no_cross(*problem((), T, S, A, seed=T)))
    P, p = tric.tvlqr_values_assoc(td, tc)
    wantP, wantp = jric.tvlqr_values_assoc(jd, jc)
    assert P.shape == (T + 1, S, S) and p.shape == (T + 1, S)
    _close(P, wantP, "P")
    _close(p, wantp, "p")
    torch.testing.assert_close(P[-1], tc.Qf, rtol=0, atol=0)
    got = tric.tvlqr_backward_assoc(td, tc)
    want = jric.tvlqr_backward_assoc(jd, jc)
    seq = tric.tvlqr_backward(td, tc)
    for g, w, s, name in ((got.K, want.K, seq.K, "K"), (got.k, want.k, seq.k, "k")):
        _close(g, w, name)
        torch.testing.assert_close(g, s, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("A", [1, 2])
def test_general_form_takes_cross_terms(A):
    jd, jc, td, tc = both(*problem((), 8, 3, A, seed=10 + A))
    assert bool(tc.M.abs().max() > 0)
    got = tric.tvlqr_backward_assoc_general(td, tc)
    want = jric.tvlqr_backward_assoc_general(jd, jc)
    seq = tric.tvlqr_backward(td, tc)
    for g, w, s, name in ((got.K, want.K, seq.K, "K"), (got.k, want.k, seq.k, "k")):
        _close(g, w, name)
        torch.testing.assert_close(g, s, rtol=TOL, atol=TOL)


def test_leading_batch_matches_vmapped_reference():
    jd, jc, td, tc = both(*problem((4,), 7, 3, 1, seed=20))
    got = tric.tvlqr_backward_assoc_general(td, tc)
    want = jax.vmap(jric.tvlqr_backward_assoc_general)(jd, jc)
    assert got.K.shape == (4, 7, 1, 3) and got.k.shape == (4, 7, 1)
    _close(got.K, want.K, "K")
    _close(got.k, want.k, "k")
    P, _ = tric.tvlqr_values_assoc(td, tc._replace(M=torch.zeros_like(tc.M)))
    assert P.shape == (4, 8, 3, 3)


def _shared(T, S, A, B, seed):
    dyn, cost = _no_cross(*problem((), T, S, A, seed=seed))
    rng = np.random.default_rng(seed + 1)
    rs = rng.standard_normal((T, B, A)).astype(np.float32)
    x0s = rng.standard_normal((B, S)).astype(np.float32)
    return both(dyn, cost) + (rs, x0s)


@pytest.mark.parametrize("T,S,A", [(6, 3, 1), (11, 2, 2)])
def test_parallel_factors_and_linear_batch_match_sequential(T, S, A):
    jd, jc, td, tc, rs, x0s = _shared(T, S, A, 5, seed=30 + T)
    f_seq = tric.riccati_factors(td, tc)
    f_par = tric.riccati_factors(td, tc, parallel=True)
    f_ref = jric.riccati_factors(jd, jc, parallel=True)
    for name, a, b, c in zip(f_seq._fields, f_par, f_seq, f_ref):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL, msg=name)
        _close(a, c, name)
    args = (torch.tensor(rs), torch.tensor(x0s))
    u_seq = tric.tvlqr_solve_linear_batch(td, f_seq, tc.q, tc.qf, *args)
    u_par = tric.tvlqr_solve_linear_batch(td, f_par, tc.q, tc.qf, *args, parallel=True)
    u_ref = jric.tvlqr_solve_linear_batch(jd, f_ref, jc.q, jc.qf, jnp.asarray(rs),
                                          jnp.asarray(x0s), parallel=True)
    assert u_par.shape == (T, 5, A)
    torch.testing.assert_close(u_par, u_seq, rtol=TOL, atol=TOL)
    _close(u_par, u_ref, "us")
