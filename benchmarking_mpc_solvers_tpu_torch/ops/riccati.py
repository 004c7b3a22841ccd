"""Time-varying LQR via Riccati recursion (sequential loop and
parallel-in-horizon associative scan).

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/riccati.py``. In the
sequential forms the horizon is a Python loop of batched matrix products.
``tvlqr_backward``, ``tvlqr_rollout`` and ``tvlqr_solve`` take any leading
batch dimensions on ``dyn``/``cost`` (the reference vmaps them), and so do
the associative-scan forms; ``riccati_factors`` and
``tvlqr_solve_linear_batch`` take one shared problem and a batch of linear
terms, as in the reference.

Cost convention, the ½-form: stage ½xᵀQx + qᵀx + ½uᵀRu + rᵀu + uᵀMx,
terminal ½xᵀQf x + qfᵀx (callers converting from the W-quadratic models
multiply their weights by 2, see ``solvers/qp_mpc.py``).

The associative-scan forms (``tvlqr_values_assoc``, ``tvlqr_backward_assoc``,
``tvlqr_backward_assoc_general``, the ``parallel=True`` switches) compose
the horizon's steps pairwise in O(log T) calls of a combine function, each
call batched over the pairs of its level (``associative_scan``). They
agree with the sequential forms to rounding, not bit for bit. The
reference's own measurements of where which form wins were taken on its
accelerator and are not carried over; none has been made for this package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .linearize import AffineDynamics, QuadCost, mT, mv


class TVLQRPolicy(NamedTuple):
    K: torch.Tensor  # (..., T, A, S)
    k: torch.Tensor  # (..., T, A)


def _solve_gains(Q_uu, rhs):
    """``Q_uu⁻¹ rhs`` with a scalar fast path for single-input systems."""
    if Q_uu.shape[-1] == 1:
        return rhs / Q_uu[..., :1, :]
    return torch.linalg.solve(Q_uu, rhs)


def _inv_quu(Q_uu):
    """``Q_uu⁻¹`` with the same scalar fast path as ``_solve_gains``."""
    if Q_uu.shape[-1] == 1:
        return 1.0 / Q_uu
    return torch.linalg.inv(Q_uu)


def tvlqr_backward(dyn: AffineDynamics, cost: QuadCost, reg: float = 0.0) -> TVLQRPolicy:
    """Backward Riccati recursion; returns the affine policy u = K x + k."""
    T, S = dyn.A.shape[-3], dyn.A.shape[-1]
    eye = torch.eye(S, dtype=dyn.A.dtype, device=dyn.A.device)
    P, p = cost.Qf, cost.qf
    Ks, ks = [None] * T, [None] * T
    for t in reversed(range(T)):
        A, B, c = dyn.A[..., t, :, :], dyn.B[..., t, :, :], dyn.c[..., t, :]
        Pc_p = mv(P, c) + p
        Q_x = cost.q[..., t, :] + mv(mT(A), Pc_p)
        Q_u = cost.r[..., t, :] + mv(mT(B), Pc_p)
        P_reg = P + reg * eye
        Q_xx = cost.Q[..., t, :, :] + mT(A) @ P @ A
        Q_uu = cost.R[..., t, :, :] + mT(B) @ P_reg @ B
        Q_ux = cost.M[..., t, :, :] + mT(B) @ P_reg @ A
        sol = _solve_gains(Q_uu, torch.cat([Q_u[..., None], Q_ux], dim=-1))
        k, K = -sol[..., 0], -sol[..., 1:]
        P_new = Q_xx + mT(K) @ Q_uu @ K + mT(K) @ Q_ux + mT(Q_ux) @ K
        p = Q_x + mv(mT(K) @ Q_uu, k) + mv(mT(K), Q_u) + mv(mT(Q_ux), k)
        P = 0.5 * (P_new + mT(P_new))
        Ks[t], ks[t] = K, k
    return TVLQRPolicy(torch.stack(Ks, dim=-3), torch.stack(ks, dim=-2))


class RiccatiFactors(NamedTuple):
    """The pieces of the TV-LQR solution that depend only on (A, B, Q, R, M),
    not on (c, q, r, x0): computed once, they turn each later solve with new
    linear terms into linear backward/forward recursions of matvecs."""

    K: torch.Tensor  # (T, A, S) feedback gains
    Quu_inv: torch.Tensor  # (T, A, A)
    Qux: torch.Tensor  # (T, A, S)
    Acl: torch.Tensor  # (T, S, S) closed loop A + B K
    Pc: torch.Tensor  # (T, S) P_{t+1} @ c_t


def riccati_factors(dyn: AffineDynamics, cost: QuadCost,
                    parallel: bool = False) -> RiccatiFactors:
    """Run the quadratic Riccati recursion once and keep the shared factors.

    ``parallel=True`` computes the P_t sequence with the O(log T)-depth
    associative scan (``tvlqr_values_assoc``) and forms every step's factors
    at once."""
    if parallel:
        P1 = tvlqr_values_assoc(dyn, cost)[0][1:]  # (T, S, S): P_{t+1} per t
        Q_uu = cost.R + mT(dyn.B) @ P1 @ dyn.B
        Q_ux = cost.M + mT(dyn.B) @ P1 @ dyn.A
        Quu_inv = _inv_quu(Q_uu)
        K = -Quu_inv @ Q_ux
        return RiccatiFactors(K, Quu_inv, Q_ux, dyn.A + dyn.B @ K, mv(P1, dyn.c))
    T = dyn.B.shape[0]
    P = cost.Qf
    out = [None] * T
    for t in reversed(range(T)):
        A_t, B_t, c_t = dyn.A[t], dyn.B[t], dyn.c[t]
        Q_uu = cost.R[t] + B_t.T @ P @ B_t
        Q_ux = cost.M[t] + B_t.T @ P @ A_t
        Quu_inv = _inv_quu(Q_uu)
        K = -Quu_inv @ Q_ux
        P_new = cost.Q[t] + A_t.T @ P @ A_t + K.T @ Q_uu @ K + K.T @ Q_ux + Q_ux.T @ K
        out[t] = (K, Quu_inv, Q_ux, A_t + B_t @ K, P @ c_t)
        P = 0.5 * (P_new + P_new.T)
    return RiccatiFactors(*(torch.stack(f) for f in zip(*out)))


def tvlqr_solve_linear_batch(dyn: AffineDynamics, f: RiccatiFactors,
                             q, qf, rs, x0s, parallel: bool = False):
    """Solve a batch of TV-LQR problems sharing (A, B, c, Q, R, Qf) with
    per-scenario linear control terms ``rs`` (T, B, A) and starts ``x0s``
    (B, S), given precomputed ``RiccatiFactors``.

    Backward: the value-gradient recursion collapses to the affine map
        p_t = Acl_tᵀ p_{t+1} + h_t,
        h_t = q_t + A_tᵀ Pc_t + K_tᵀ (r_t + B_tᵀ Pc_t),
        k_t = −Q_uu⁻¹ (r_t + B_tᵀ (Pc_t + p_{t+1})),
    forward: x_{t+1} = Acl_t x_t + B_t k_t + c_t, u_t = K_t x_t + k_t.
    Only the two recursions run step by step (one matrix product and an
    add or two each); h, k, B k and u are formed for all t at once.
    ``parallel=True`` evaluates both affine recursions with O(log T)-depth
    associative scans. Returns us (T, B, A)."""
    A, B, c = dyn.A, dyn.B, dyn.c
    T = B.shape[0]
    APc = torch.einsum("tji,tj->ti", A, f.Pc)  # AᵀPc
    BPc = torch.einsum("tji,tj->ti", B, f.Pc)  # BᵀPc
    rB = rs + BPc[:, None, :]  # (T, B, A)
    h = (q + APc)[:, None, :] + rB @ f.K  # (T, B, S)
    if parallel:
        return _solve_linear_batch_assoc(dyn, f, h, rB, qf, x0s)
    Acl = A + B @ f.K  # (T, S, S), the closed loop as the recursion uses it
    p = qf.expand(rs.shape[1], qf.shape[-1])
    p_next = [None] * T
    for t in reversed(range(T)):
        p_next[t] = p
        p = h[t] + p @ Acl[t]
    p_next = torch.stack(p_next)  # (T, B, S): p_{t+1} per t
    ks = -(rB + p_next @ B) @ mT(f.Quu_inv)  # (T, B, A)
    kB = ks @ mT(B)
    AclT = mT(f.Acl)
    x = x0s
    xs = [None] * T
    for t in range(T):
        xs[t] = x
        x = x @ AclT[t] + kB[t] + c[t]
    return torch.stack(xs) @ mT(f.K) + ks


def tvlqr_rollout(dyn: AffineDynamics, policy: TVLQRPolicy, x0):
    """Forward simulate the affine policy through the affine dynamics:
    (xs (..., T+1, S), us (..., T, A))."""
    T = dyn.A.shape[-3]
    x = x0
    xs, us = [x], []
    for t in range(T):
        u = mv(policy.K[..., t, :, :], x) + policy.k[..., t, :]
        x = mv(dyn.A[..., t, :, :], x) + mv(dyn.B[..., t, :, :], u) + dyn.c[..., t, :]
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


def tvlqr_solve(dyn: AffineDynamics, cost: QuadCost, x0, reg: float = 0.0):
    """Solve the unconstrained TV-LQR: returns (xs, us, policy)."""
    policy = tvlqr_backward(dyn, cost, reg)
    xs, us = tvlqr_rollout(dyn, policy, x0)
    return xs, us, policy


# -- parallel-in-horizon variant ---------------------------------------------
#
# The Riccati value recursion composes as an associative operation on affine
# fractional transforms (cf. the parallel-in-horizon NMPC literature in
# PAPERS.md), so a scan over the horizon has O(log T) depth. The element for
# step t represents V_t→(t+1) as the tuple (A, b, C, P, p) of a
# linear-fractional map; composition is matrix algebra.


def associative_scan(combine, elems, reverse: bool = False):
    """Inclusive scan of an associative ``combine`` over the leading axis of
    a tuple of tensors, in O(log n) ``combine`` calls (the odd/even
    recursion of ``jax.lax.associative_scan``): the pairs of a level are
    combined in one call, batched over that axis.

    ``combine(a, b)`` takes two tuples shaped like ``elems`` with a common
    leading length and returns a third; ``a`` holds the segments that come
    first along the axis. With ``reverse`` the scan runs from the end, and
    ``a`` holds the already-combined segments of the higher indices."""
    elems = tuple(elems)
    if reverse:
        out = associative_scan(combine, tuple(e.flip(0) for e in elems))
        return tuple(o.flip(0) for o in out)

    def scan(es):
        n = es[0].shape[0]
        if n < 2:
            return es
        # combine neighbours (0, 1), (2, 3), ...; scan the halves: the
        # results are the answers at the odd indices
        odd = scan(tuple(combine(tuple(e[0:-1:2] for e in es), tuple(e[1::2] for e in es))))
        # the even indices 2, 4, ... take one more element each
        head = tuple(o[:-1] for o in odd) if n % 2 == 0 else odd
        even = combine(head, tuple(e[2::2] for e in es))
        even = tuple(torch.cat([e[:1], v]) for e, v in zip(es, even))
        out = []
        for ev, od in zip(even, odd):
            woven = torch.empty((n,) + ev.shape[1:], dtype=ev.dtype, device=ev.device)
            woven[0::2], woven[1::2] = ev, od
            out.append(woven)
        return tuple(out)

    return scan(elems)


class _RicEl(NamedTuple):
    A: torch.Tensor  # (n, ..., S, S)
    b: torch.Tensor  # (n, ..., S)
    C: torch.Tensor  # (n, ..., S, S)
    P: torch.Tensor  # (n, ..., S, S)
    p: torch.Tensor  # (n, ..., S)


def _ric_combine(e2, e1):
    """Compose conditional-value elements (Särkkä & García-Fernández style
    parallel LQT): e1 is the earlier segment, e2 the later."""
    a2, b2, c2, p2, s2 = e2
    a1, b1, c1, p1, s1 = e1
    S = a1.shape[-1]
    eye = torch.eye(S, dtype=a1.dtype, device=a1.device)
    # I + C1 P2, one solve for its three right-hand sides
    sol = torch.linalg.solve(eye + c1 @ p2,
                             torch.cat([a1, c1, (b1 - mv(c1, s2))[..., None]], dim=-1))
    A = a2 @ sol[..., :S]
    b = mv(a2, sol[..., 2 * S]) + b2
    C = a2 @ sol[..., S:2 * S] @ mT(a2) + c2
    solt = torch.linalg.solve(eye + p2 @ c1,
                              torch.cat([p2, (mv(p2, b1) + s2)[..., None]], dim=-1))
    P = mT(a1) @ solt[..., :S] @ a1 + p1
    p = mv(mT(a1), solt[..., S]) + s1
    return _RicEl(A, b, C, P, p)


def _values_time_major(dyn: AffineDynamics, cost: QuadCost):
    """(P (T+1, ..., S, S), p (T+1, ..., S)), time leading: the reversed
    scan's element t accumulates the steps t..T."""
    A, B = dyn.A.movedim(-3, 0), dyn.B.movedim(-3, 0)
    S = A.shape[-1]
    Rinv = _inv_quu(cost.R.movedim(-3, 0))
    BRinv = B @ Rinv
    # per-step elements in value-passing form:
    #   A_el = A, b_el = c − B R⁻¹ r, C_el = B R⁻¹ Bᵀ, P_el = Q, p_el = q
    C_el = BRinv @ mT(B)
    b_el = dyn.c.movedim(-2, 0) - mv(BRinv, cost.r.movedim(-2, 0))
    lead = A.shape[1:-2]
    eye = torch.eye(S, dtype=A.dtype, device=A.device)
    # terminal element: identity dynamics with value (Qf, qf)
    term = (eye.expand(lead + (S, S)), torch.zeros(lead + (S,), dtype=A.dtype, device=A.device),
            torch.zeros(lead + (S, S), dtype=A.dtype, device=A.device),
            cost.Qf.expand(lead + (S, S)), cost.qf.expand(lead + (S,)))
    els = (A, b_el, C_el, cost.Q.movedim(-3, 0), cost.q.movedim(-2, 0))
    els = tuple(torch.cat([e, t[None]]) for e, t in zip(els, term))
    acc = _RicEl(*associative_scan(_ric_combine, els, reverse=True))
    return acc.P, acc.p


def tvlqr_values_assoc(dyn: AffineDynamics, cost: QuadCost):
    """(P_t)_{t=0..T} and (p_t) via the associative-scan Riccati (the
    quadratic and linear parts of ``tvlqr_backward_assoc``'s elements):
    (..., T+1, S, S) and (..., T+1, S). Cross terms must be zero."""
    P, p = _values_time_major(dyn, cost)
    return P.movedim(0, -3), p.movedim(0, -2)


def tvlqr_backward_assoc(dyn: AffineDynamics, cost: QuadCost) -> TVLQRPolicy:
    """Parallel-in-horizon Riccati: the policy of ``tvlqr_backward`` (up to
    roundoff) with O(log T) sequential depth via ``associative_scan``.

    Restriction: no cross terms (cost.M must be 0), the standard LQT form."""
    P, p = tvlqr_values_assoc(dyn, cost)
    # value at t+1 (the suffix starting at t+1)
    P1, p1 = P[..., 1:, :, :], p[..., 1:, :]
    Bt = mT(dyn.B)
    Q_uu = cost.R + Bt @ P1 @ dyn.B
    rhs = cost.r + mv(Bt, mv(P1, dyn.c) + p1)
    Q_ux = Bt @ P1 @ dyn.A
    sol = _solve_gains(Q_uu, torch.cat([rhs[..., None], Q_ux], dim=-1))
    return TVLQRPolicy(-sol[..., 1:], -sol[..., 0])


def tvlqr_backward_assoc_general(dyn: AffineDynamics, cost: QuadCost) -> TVLQRPolicy:
    """``tvlqr_backward_assoc`` for costs WITH cross terms (M ≠ 0), via the
    standard substitution ũ = u + R⁻¹Mx that eliminates them:

        A' = A − BR⁻¹M,  Q' = Q − MᵀR⁻¹M,  q' = q − MᵀR⁻¹r,
        policy maps back as K = K̃ − R⁻¹M, k = k̃.
    """
    RinvM = _solve_gains(cost.R, cost.M)  # (..., T, A, S)
    A2 = dyn.A - dyn.B @ RinvM
    Q2 = cost.Q - mT(cost.M) @ RinvM
    q2 = cost.q - mv(mT(RinvM), cost.r)
    pol = tvlqr_backward_assoc(
        AffineDynamics(A2, dyn.B, dyn.c),
        cost._replace(Q=Q2, q=q2, M=torch.zeros_like(cost.M)))
    return TVLQRPolicy(pol.K - RinvM, pol.k)


def _solve_linear_batch_assoc(dyn: AffineDynamics, f: RiccatiFactors, h, rB, qf, x0s):
    """The two affine recursions of ``tvlqr_solve_linear_batch`` as
    associative scans over (matrix, batch of vectors) pairs of the maps
    p = G p' + h: a suffix scan for the value gradient, a prefix scan for
    the states."""
    B = dyn.B
    S = B.shape[1]

    def compose(first, then):
        # then ∘ first: apply ``first``'s map, then ``then``'s
        G1, h1 = first
        G2, h2 = then
        return G2 @ G1, h1 @ mT(G2) + h2

    # suffix-compose p_t = Acl_tᵀ p_{t+1} + h_t; the terminal element is the
    # constant map to qf. With reverse the first argument is the later
    # segment, which acts first.
    eye = torch.eye(S, dtype=B.dtype, device=B.device)
    els = (torch.cat([mT(f.Acl), eye[None]]),
           torch.cat([h, qf.expand(1, h.shape[1], S)]))
    _, p_all = associative_scan(compose, els, reverse=True)
    p_next = p_all[1:]  # (T, B, S): p_{t+1} per t
    ks = -(rB + p_next @ B) @ mT(f.Quu_inv)  # (T, B, A)
    # forward x_{t+1} = Acl x_t + (B k_t + c_t): prefix scan
    Gacc, hacc = associative_scan(compose, (f.Acl, ks @ mT(B) + dyn.c[:, None, :]))
    x_later = x0s @ mT(Gacc[:-1]) + hacc[:-1]  # x_1 .. x_{T-1}
    xs = torch.cat([x0s[None], x_later])
    return xs @ mT(f.K) + ks
