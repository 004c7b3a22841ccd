"""Condensed-QP construction and box-constrained QP solvers (ADMM + IP).

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/qp.py``. Everything is
dense float32 linear algebra sized (T·A)².

Condensing: for affine time-varying dynamics x_{t+1} = A_t x_t + B_t u_t + c_t
the stacked states X = (x_1..x_T) are affine in U = (u_0..u_{T-1}):
X = Su·U + Xfree, and the tracking objective

    Σ_{t=1}^{T-1} (x_t-xref)ᵀQ(x_t-xref) + (x_T-xref)ᵀQf(x_T-xref)
  + Σ_{t=0}^{T-1} (u_t-uref)ᵀR(u_t-uref)

condenses to min_U ½UᵀHU + gᵀU with H = 2(SuᵀQ̄Su + R̄),
g = 2(SuᵀQ̄(Xfree-Xref) − R̄Uref), subject to box bounds on U.
(x_0 is given, so its stage cost is constant and dropped.)

The early exits. The reference's ``while_loop``s stop when both residuals
fall under ``eps``. ``admm_solve`` runs all ``iters`` iterations with a
freeze mask instead (the state is frozen once the test holds, so z, the
residuals and the iteration count come out the same, without a host sync
per iteration of a few small launches). ``admm_solve_riccati_batch`` reads
the test on the host once per iteration and leaves the loop: one of its
iterations is two horizon recursions, some 4·T launches, beside which the
sync is small, and a converged batch skips the rest of them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .linearize import AffineDynamics, QuadCost, mv
from .riccati import riccati_factors, tvlqr_solve_linear_batch


class CondensedQP(NamedTuple):
    H: torch.Tensor  # (..., TA, TA)
    g: torch.Tensor  # (..., TA)
    lo: torch.Tensor  # (..., TA)
    hi: torch.Tensor  # (..., TA)
    Su: torch.Tensor  # (..., T, S, TA) state-from-input map (for reconstruction)
    Xfree: torch.Tensor  # (..., T, S) free response


def _f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _input_map(A, B):
    """Su rows by the forward recursion row_t = A_t row_{t-1} + e_t ⊗ B_t:
    A (..., T, S, S), B (..., T, S, nA) -> Su (..., T, S, T·nA)."""
    T, S, nA = B.shape[-3:]
    lead = B.shape[:-3]
    row = torch.zeros(lead + (S, T, nA), dtype=B.dtype, device=B.device)
    rows = []
    for t in range(T):
        row = torch.einsum("...ij,...jta->...ita", A[..., t, :, :], row)
        e_t = torch.zeros((T,), dtype=B.dtype, device=B.device)
        e_t[t] = 1.0
        row = row + torch.einsum("t,...ia->...ita", e_t, B[..., t, :, :])
        rows.append(row)
    return torch.stack(rows, dim=-4).reshape(lead + (T, S, T * nA))


def _stacked_weights(Q, R, Qf, T):
    """(Q̄ (T, S, S): Q for x_1..x_{T-1} and Qf for x_T; R̄ = I_T ⊗ R)."""
    Qbar = Q.expand(T, *Q.shape).clone()
    Qbar[T - 1] = Qf
    Rbar = torch.kron(torch.eye(T, dtype=R.dtype, device=R.device), R)
    return Qbar, Rbar


def condense(dyn: AffineDynamics, x0, Q, R, Qf, xref, uref, u_lo, u_hi) -> CondensedQP:
    """Build the condensed box-QP. Q/R/Qf are single (S,S)/(A,A) weight
    matrices (time-invariant tracking); xref/uref are (S,)/(A,) targets.
    ``dyn`` and ``x0`` (..., S) may carry leading batch dimensions (the
    reference vmaps this function for per-scenario linearizations); every
    field of the result then carries them too."""
    A, B, c = dyn.A, dyn.B, dyn.c
    T, S, nA = B.shape[-3:]
    lead = B.shape[:-3]
    dev = B.device
    Q, R, Qf = _f32(Q, dev), _f32(R, dev), _f32(Qf, dev)
    xref, uref = _f32(xref, dev), _f32(uref, dev)
    Su = _input_map(A, B)
    xf = _f32(x0, dev)
    xfree = []
    for t in range(T):
        xf = mv(A[..., t, :, :], xf) + c[..., t, :]
        xfree.append(xf)
    xfree = torch.stack(xfree, dim=-2)

    Qbar, Rbar = _stacked_weights(Q, R, Qf, T)
    QSu = torch.einsum("tij,...tjk->...tik", Qbar, Su)
    H = 2.0 * (torch.einsum("...tsi,...tsj->...ij", Su, QSu) + Rbar)
    dX = xfree - xref
    g = 2.0 * (torch.einsum("...tsi,...ts->...i", QSu, dX) - Rbar @ uref.repeat(T))
    lo = _f32(u_lo, dev).repeat(T).expand(lead + (T * nA,))
    hi = _f32(u_hi, dev).repeat(T).expand(lead + (T * nA,))
    return CondensedQP(H, g, lo, hi, Su, xfree)


class CondensedQPBatch(NamedTuple):
    H: torch.Tensor  # (TA, TA) shared Hessian
    g: torch.Tensor  # (B, TA) per-scenario linear terms
    lo: torch.Tensor  # (TA,)
    hi: torch.Tensor  # (TA,)
    Su: torch.Tensor  # (T, S, TA)
    Xfree: torch.Tensor  # (B, T, S)


def condense_batch(dyn: AffineDynamics, x0s, Q, R, Qf, xref, uref, u_lo,
                   u_hi) -> CondensedQPBatch:
    """Batched condensing for *shared* dynamics (linear MPC linearized at a
    fixed operating point): H/Su are built once; only the free response,
    affine in x₀ via the state-transition products Φ_t = A_t···A_0, and
    hence g vary per scenario. Feeds the shared-layout ADMM kernel
    (``ops/qp_admm.py:admm_iterate``)."""
    A, B, c = dyn.A, dyn.B, dyn.c
    T, S, nA = B.shape
    dev = B.device
    Q, R, Qf = _f32(Q, dev), _f32(R, dev), _f32(Qf, dev)
    xref, uref = _f32(xref, dev), _f32(uref, dev)
    Su = _input_map(A, B)
    Phi = torch.eye(S, dtype=B.dtype, device=dev)
    xp = torch.zeros((S,), dtype=B.dtype, device=dev)
    Phis, xparts = [], []
    for t in range(T):
        Phi = A[t] @ Phi
        xp = A[t] @ xp + c[t]
        Phis.append(Phi)
        xparts.append(xp)
    Phis, xparts = torch.stack(Phis), torch.stack(xparts)

    Qbar, Rbar = _stacked_weights(Q, R, Qf, T)
    QSu = torch.einsum("tij,tjk->tik", Qbar, Su)
    H = 2.0 * (torch.einsum("tsi,tsj->ij", Su, QSu) + Rbar)
    Xfree = torch.einsum("tij,bj->bti", Phis, _f32(x0s, dev)) + xparts[None]
    dX = Xfree - xref
    g = 2.0 * (torch.einsum("tsi,bts->bi", QSu, dX) - (Rbar @ uref.repeat(T))[None])
    return CondensedQPBatch(H, g, _f32(u_lo, dev).repeat(T), _f32(u_hi, dev).repeat(T),
                            Su, Xfree)


class ADMMResult(NamedTuple):
    U: torch.Tensor  # (TA,) projected (feasible) solution
    r_prim: torch.Tensor  # final primal residual ‖U − z‖∞
    r_dual: torch.Tensor  # final dual residual ρ‖z − z_prev‖∞
    iters: torch.Tensor  # iterations executed


def admm_solve(qp: CondensedQP, rho: float = 1.0, alpha: float = 1.6, iters: int = 100,
               eps: float = 1e-6) -> ADMMResult:
    """OSQP-style ADMM for min ½UᵀHU + gᵀU s.t. lo ≤ U ≤ hi (one problem).

    Splitting U = z with box projection on z and over-relaxation alpha.
    (H + ρI) is Cholesky-factorized once; the iteration is two triangular
    solves and a clip. The reference's early exit (both residuals under
    eps) is a freeze mask here: all ``iters`` iterations run, and an
    iteration after the exit changes nothing, ``iters`` included."""
    H, g, lo, hi = qp.H, qp.g, qp.lo, qp.hi
    n = g.shape[0]
    chol = torch.linalg.cholesky(H + rho * torch.eye(n, dtype=H.dtype, device=H.device))
    z = torch.zeros_like(g)
    y = torch.zeros_like(g)
    r_p = torch.full((), torch.inf, dtype=H.dtype, device=H.device)
    r_d = r_p.clone()
    i = torch.zeros((), dtype=torch.int32, device=H.device)
    for _ in range(iters):
        live = ~((r_p < eps) & (r_d < eps))
        u = torch.cholesky_solve((rho * (z - y) - g)[:, None], chol)[:, 0]
        u_rel = alpha * u + (1.0 - alpha) * z
        z_new = torch.clamp(u_rel + y, lo, hi)
        y = torch.where(live, y + u_rel - z_new, y)
        r_p = torch.where(live, (u - z_new).abs().max(), r_p)
        r_d = torch.where(live, rho * (z_new - z).abs().max(), r_d)
        z = torch.where(live, z_new, z)
        i = i + live.to(torch.int32)
    return ADMMResult(z, r_p, r_d, i)


def ip_solve(qp: CondensedQP, iters: int = 25, mu0: float = 1.0, kappa: float = 0.2):
    """Primal log-barrier interior-point for the same box QP (one problem).

    Newton steps on ½UᵀHU + gᵀU − μ Σ[log(U−lo) + log(hi−U)] with a
    geometrically decreasing barrier μ ← κμ and a fraction-to-boundary
    damped step; a fixed iteration count."""
    H, g, lo, hi = qp.H, qp.g, qp.lo, qp.hi
    U = torch.clamp((lo + hi) / 2.0, lo + 1e-3, hi - 1e-3)
    mu = mu0
    inf = torch.full((), torch.inf, dtype=H.dtype, device=H.device)
    for _ in range(iters):
        d_lo = U - lo
        d_hi = hi - U
        grad = H @ U + g - mu / d_lo + mu / d_hi
        hess = H + torch.diag(mu / d_lo**2 + mu / d_hi**2)
        step = torch.linalg.solve(hess, grad)
        # fraction-to-boundary: keep strictly inside the box
        with_dir = torch.where(step > 0, d_lo / step, inf)
        against = torch.where(step < 0, -d_hi / step, inf)
        t_max = torch.minimum(with_dir.min(), against.min())
        t = torch.clamp(0.995 * t_max, max=1.0)
        U = U - t * step
        # float32 rounding can land exactly on the boundary -> inf barrier;
        # keep a strict interior margin
        margin = 1e-6 * (hi - lo)
        U = torch.clamp(U, lo + margin, hi - margin)
        mu = max(mu * kappa, 1e-8)
    return torch.clamp(U, lo, hi)


def admm_solve_riccati_batch(dyn: AffineDynamics, x0s, Q, R, Qf, xref, uref, u_lo, u_hi,
                             rho: float = 1.0, iters: int = 100, eps: float = 1e-6,
                             parallel_horizon: bool = False):
    """Batched ADMM for box-constrained LQ-MPC with a *Riccati* x-update.

    Condensing an unstable system over a long horizon squares an
    exponentially-conditioned Su into H (cart-pole upright at T=50 reaches
    cond ~1e14, beyond float32). This variant never condenses: the ADMM
    U-subproblem

        min_U  J_LQ(U) + (ρ/2)‖U − (z − y)‖²

    is an unconstrained time-varying LQR (control penalty ρ, linear term
    −ρ(z−y)). Dynamics and weights are shared across the batch and across
    iterations, so the quadratic Riccati factors are computed once
    (``ops/riccati.py:riccati_factors``) and every iteration's u-update is
    the linear backward/forward recursions batched over scenarios.

    x0s: (B, S). The loop leaves when the worst-case residuals over the
    whole batch drop below eps (read on the host once per iteration).
    Returns (us (B, T, A), r_prim, r_dual, iters)."""
    T, S, nA = dyn.B.shape
    dev = dyn.B.device
    Q, R, Qf = _f32(Q, dev), _f32(R, dev), _f32(Qf, dev)
    xref, uref = _f32(xref, dev), _f32(uref, dev)
    x0s = _f32(x0s, dev)
    Bn = x0s.shape[0]
    Q2 = (2.0 * Q).expand(T, S, S)
    q2 = (-2.0 * (Q @ xref)).expand(T, S)
    R2 = (2.0 * R + rho * torch.eye(nA, dtype=torch.float32, device=dev)).expand(T, nA, nA)
    M0 = torch.zeros((T, nA, S), dtype=torch.float32, device=dev)
    lo, hi = _f32(u_lo, dev), _f32(u_hi, dev)  # (A,) broadcasts over (T, B, A)
    r_base = (-2.0 * (R @ uref)).expand(T, nA)
    qf = -2.0 * (Qf @ xref)

    cost = QuadCost(Q=Q2, R=R2, M=M0, q=q2, r=r_base, Qf=2.0 * Qf, qf=qf)
    factors = riccati_factors(dyn, cost, parallel=parallel_horizon)
    z = torch.zeros((T, Bn, nA), dtype=torch.float32, device=dev)
    y = torch.zeros_like(z)
    r_p = r_d = torch.full((), torch.inf, dtype=torch.float32, device=dev)
    i = 0
    while i < iters and not bool((r_p < eps) & (r_d < eps)):
        rs = r_base[:, None, :] - rho * (z - y)  # (T, B, A)
        u = tvlqr_solve_linear_batch(dyn, factors, q2, qf, rs, x0s, parallel=parallel_horizon)
        z_new = torch.clamp(u + y, lo, hi)
        y = y + u - z_new
        r_p = (u - z_new).abs().max()
        r_d = rho * (z_new - z).abs().max()
        z = z_new
        i += 1
    return z.transpose(0, 1), r_p, r_d, torch.tensor(i, dtype=torch.int32, device=dev)


def admm_solve_riccati(dyn: AffineDynamics, x0, Q, R, Qf, xref, uref, u_lo, u_hi,
                       rho: float = 1.0, iters: int = 100, eps: float = 1e-6,
                       parallel_horizon: bool = False):
    """Single-scenario ``admm_solve_riccati_batch`` (B = 1).

    Returns (us (T, A), r_prim, r_dual, iters)."""
    us, r_p, r_d, i = admm_solve_riccati_batch(
        dyn, _f32(x0, dyn.B.device)[None], Q, R, Qf, xref, uref, u_lo, u_hi, rho=rho,
        iters=iters, eps=eps, parallel_horizon=parallel_horizon)
    return us[0], r_p, r_d, i


def qp_objective(qp: CondensedQP, U):
    return 0.5 * U @ qp.H @ U + qp.g @ U


def kkt_residual(qp: CondensedQP, U, tol: float = 1e-6):
    """∞-norm KKT residual of the box QP at U (projected-gradient form):
    r = ‖U − clip(U − (HU+g), lo, hi)‖∞, zero iff U is optimal."""
    grad = qp.H @ U + qp.g
    return (U - torch.clamp(U - grad, qp.lo, qp.hi)).abs().max()
