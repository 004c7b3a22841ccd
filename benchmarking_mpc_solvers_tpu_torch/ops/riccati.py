"""Time-varying LQR via the sequential Riccati recursion.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/riccati.py``, the
sequential forms: the horizon is a Python loop of batched matrix products.
``tvlqr_backward``, ``tvlqr_rollout`` and ``tvlqr_solve`` take any leading
batch dimensions on ``dyn``/``cost`` (the reference vmaps them);
``riccati_factors`` and ``tvlqr_solve_linear_batch`` take one shared
problem and a batch of linear terms, as in the reference.

Cost convention, the ½-form: stage ½xᵀQx + qᵀx + ½uᵀRu + rᵀu + uᵀMx,
terminal ½xᵀQf x + qfᵀx (callers converting from the W-quadratic models
multiply their weights by 2, see ``solvers/qp_mpc.py``).

Not ported yet: the parallel-in-horizon associative-scan forms
(``tvlqr_values_assoc``, ``tvlqr_backward_assoc``,
``tvlqr_backward_assoc_general``) and the ``parallel=True`` switches; they
raise ``NotImplementedError`` naming ROADMAP.md §1 item 8a.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .linearize import AffineDynamics, QuadCost, mT, mv

_ASSOC = "the associative-scan Riccati forms are not ported yet: ROADMAP.md §1 item 8a"


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
    """Run the quadratic Riccati recursion once and keep the shared factors."""
    if parallel:
        raise NotImplementedError(_ASSOC)
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
    Returns us (T, B, A)."""
    if parallel:
        raise NotImplementedError(_ASSOC)
    A, B, c = dyn.A, dyn.B, dyn.c
    T = B.shape[0]
    APc = torch.einsum("tji,tj->ti", A, f.Pc)  # AᵀPc
    BPc = torch.einsum("tji,tj->ti", B, f.Pc)  # BᵀPc
    rB = rs + BPc[:, None, :]  # (T, B, A)
    h = (q + APc)[:, None, :] + rB @ f.K  # (T, B, S)
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


def tvlqr_values_assoc(dyn: AffineDynamics, cost: QuadCost):
    raise NotImplementedError(_ASSOC)


def tvlqr_backward_assoc(dyn: AffineDynamics, cost: QuadCost) -> TVLQRPolicy:
    raise NotImplementedError(_ASSOC)


def tvlqr_backward_assoc_general(dyn: AffineDynamics, cost: QuadCost) -> TVLQRPolicy:
    raise NotImplementedError(_ASSOC)
