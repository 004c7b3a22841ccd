"""iLQR / DDP with a Levenberg–Marquardt trust region and an all-α line search.

Counterpart of ``benchmarking_mpc_solvers_tpu/solvers/ilqr.py``:

- derivatives by ``torch.func`` (``grad``, ``hessian``, ``jacrev``) over the
  written-out (B·T) batch of (x, u) points, plus the terminal cost's at x_T;
  with ``gauss_newton`` the cost Hessians are the PSD Gauss-Newton forms
  2 Jᵀ W J in feature space (stage terms from ``fused_derivs`` in one launch
  on the fused tier, else from ``gn_point_terms``), the gradients exact at
  the terminal stage;
- the backward Riccati recursion with μ in the gain solve only, the
  unregularised value recursion and the Q_uu > 0 check; the scalar-action
  fast path divides instead of solving;
- ``ddp``: the second-order dynamics terms V_x·f_(xu)(xu) in the Q-terms
  (``dynamics_hessian``); ``box_ddp``: control-limited gains, k clamped so
  that u + k stays in the box and the rows of K of active controls zeroed;
- ``diag_hessian``: the reference's own numerics (``backward_pass_ref``:
  diagonal cost Hessians, the elementwise Q_uu inverse, the terminal
  diagonal as a vector in the first step), with the terminal-cost
  derivatives taken at x_{T-1} (``derivatives(ref_terminal=True)``) and
  the terminal cost left out of the line search; scalar actions only;
- ``model_noise_std > 0``: each iteration's nominal rollout and each of its
  line-search candidates get fresh additive state noise; the derivatives
  stay clean at the noisy points;
- all α = 1.1^(−i²) candidates rolled at once, then either the reference's
  sequential accept replay (``reference_accept=True``: stop at the first α
  that improves or lies within ``threshold``) or the best α
  (``reference_accept=False``, which also scores the terminal cost);
- the μ/δ schedule (μ ∈ [1e-6, 1024], δ0 = 2), escalation on a failed
  backward pass or no accepted step, and the plan kept on a failed pass.

``solve_batch`` runs B scenarios in lock-step for ``max_iter`` iterations,
each scenario with its own μ, δ and convergence flag; a converged scenario
is frozen by masking, as a vmapped ``while_loop`` freezes it. There is no
early exit and no host sync inside the loop, so every call runs
``max_iter`` iterations. With ``use_fused`` each stage runs where the
reference's vmapped solve runs it on the accelerator (``stage_routes``):
the backward pass as ``riccati_backward_batch`` unless ``ddp``,
``box_ddp`` or ``diag_hessian`` asks for another recursion, the line
search as ``fused_linesearch`` unless the model is noisy, and with
``gauss_newton`` (not ``diag_hessian``) the stage derivatives as
``fused_derivs``: one kernel launch each per iteration on the card, their
plain versions on the CPU. A model these do not take is refused
(``solvers/base.py:check_fused_tier``) and needs ``use_fused=False``.
``solve`` is ``solve_batch`` on a batch of one without the kernels. The
reference's ``pallas_backward`` switch resolves as there: ``None`` and
``True`` leave the stages to ``use_fused``, and an explicit ``False`` runs
every stage plain, ``use_fused=True`` included.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, jacrev, vmap

from ..device import resolve_device
from ..ops.fused_derivs import fused_derivs
from ..ops.fused_linesearch import fused_linesearch
from ..ops.linearize import gn_point_terms, mT, mv
from ..ops.riccati_backward import riccati_backward_batch
from ..ops.rollout import simulate_trajectory, simulate_trajectory_noisy
from .base import Solver, check_fused_tier, fused_tier_applicable, model_noise_draws


class ILQRState(NamedTuple):
    planned_us: torch.Tensor  # (T, A), or (B, T, A) on the batched tier
    generator: torch.Generator


class Derivs(NamedTuple):
    """Batch-first derivatives along B trajectories."""

    l_x: torch.Tensor  # (B, T+1, S) (terminal row appended)
    l_u: torch.Tensor  # (B, T, A)
    l_xx: torch.Tensor  # (B, T+1, S, S)
    l_uu: torch.Tensor  # (B, T, A, A)
    l_ux: torch.Tensor  # (B, T, A, S)
    f_x: torch.Tensor  # (B, T, S, S)
    f_u: torch.Tensor  # (B, T, S, A)


class StageRoutes(NamedTuple):
    """Which stages of an iteration run as kernels (True) or plain."""

    derivs: bool  # fused_derivs
    riccati: bool  # riccati_backward_batch
    linesearch: bool  # fused_linesearch


@dataclasses.dataclass(frozen=True, eq=False)
class ILQR(Solver):
    max_iter: int = 10
    threshold: float = 1e-3
    closed_loop: bool = False  # kept for config parity (unused, as in the reference)
    mu_min: float = 1e-6
    mu_max: float = 1024.0
    delta_zero: float = 2.0
    n_alphas: int = 10
    reference_accept: bool = True
    diag_hessian: bool = False  # the reference's diagonal-Hessian numerics
    gauss_newton: bool = False
    ddp: bool = False  # second-order dynamics terms
    box_ddp: bool = False  # control-limited gains (clamp k, zero K rows)
    # planning-model noise: the nominal rollout and the line-search
    # candidates are noisy, the derivatives clean at the noisy points
    model_noise_std: float = 0.0
    # the reference's kernel switch: False runs the plain stages whatever
    # ``use_fused`` asks for (None and True: as ``use_fused`` says)
    pallas_backward: Optional[bool] = None

    # -- state ----------------------------------------------------------------
    def init_state(self, generator: torch.Generator, device="cuda") -> ILQRState:
        """The reference's initial plan hi·N(0, 1), (T, A)."""
        device = resolve_device(device)
        A = self.model.action_size
        us = self.model.hi(device) * torch.randn((self.T, A), generator=generator, device=device)
        return ILQRState(us, generator)

    def init_state_batch(self, batch: int, generator: torch.Generator,
                         device="cuda") -> ILQRState:
        """(B, T, A) initial plans hi·N(0, 1)."""
        device = resolve_device(device)
        A = self.model.action_size
        us = self.model.hi(device) * torch.randn((batch, self.T, A), generator=generator,
                                                 device=device)
        return ILQRState(us, generator)

    def has_kernel_stages(self) -> bool:
        """Whether ``pallas_backward`` allows the kernels and the
        derivative, Riccati and line-search kernels take the model's shapes
        and costs (``solvers/base.py:fused_tier_applicable``), the
        reference's gate. It holds for the plants under any weights and for
        the dummy family, whose functors run on the card; it also holds for
        a scalar-action linear model, which the reference's kernels cannot
        trace and the card refuses before the first launch
        (``check_fused_tier``), as the reference raises on the TPU."""
        return self.pallas_backward is not False and fused_tier_applicable(self.model)

    def calls_model_kernels(self) -> bool:
        """Whether a routed stage of ``solve_batch(use_fused=True)`` calls
        the model: the derivative kernel (Gauss-Newton) or the line-search
        kernel (no model noise). The Riccati kernel sees only matrices."""
        routes = self.stage_routes(True)
        return routes.derivs or routes.linesearch

    def alphas(self, device=None):
        """Line-search step sizes 1.1^(−i²), i < n_alphas, in float32."""
        i = torch.arange(self.n_alphas, dtype=torch.float32, device=device)
        return torch.pow(1.1, -(i**2))

    def stage_routes(self, use_fused: bool) -> StageRoutes:
        """The stages ``use_fused`` sends to kernels, by the reference's
        conditions (``solvers/ilqr.py:_solve``): the Riccati kernel for the
        plain recursion only, the line-search kernel without model noise,
        the derivative kernel for Gauss-Newton terms at x_T; none under
        ``pallas_backward=False``."""
        use_fused = use_fused and self.pallas_backward is not False
        return StageRoutes(
            derivs=use_fused and self.gauss_newton and not self.diag_hessian,
            riccati=use_fused and not (self.ddp or self.box_ddp or self.diag_hessian),
            linesearch=use_fused and self.model_noise_std == 0.0,
        )

    # -- derivative stage -------------------------------------------------------
    def derivatives(self, xs, us, g_z, use_fused: bool = False,
                    ref_terminal: bool = False) -> Derivs:
        """Cost gradients/Hessians and dynamics Jacobians along xs
        (B, T+1, S), us (B, T, A), and the terminal cost's at x_T: exact, or
        with ``gauss_newton`` the Gauss-Newton forms (the stage terms from
        ``fused_derivs`` when ``use_fused``). ``ref_terminal`` takes the
        terminal cost's at x_{T-1} instead, the reference quirk that
        ``diag_hessian`` keeps (its ``_calc_action`` passes the truncated
        states, whose last row the terminal stage then reads)."""
        model = self.model
        if use_fused:
            check_fused_tier("ILQR.derivatives", model, g_z)
        B, Tp1, S = xs.shape
        T, A, Z = Tp1 - 1, us.shape[-1], g_z.shape[-1]
        xT, g_last = (xs[:, -2] if ref_terminal else xs[:, -1]), g_z[-1]
        gT = vmap(grad(model.final_cost), in_dims=(0, None))(xT, g_last)
        if self.gauss_newton:
            def zt(x):
                z = model.transform(x, x.new_zeros((A,)))
                return z, z

            Jt, zT = vmap(jacrev(zt, has_aux=True))(xT)
            Wt = vmap(hessian(model.terminal_cost), in_dims=(0, None))(zT, g_last) / 2.0
            hT = 2.0 * mT(Jt) @ Wt @ Jt
        else:
            hT = vmap(hessian(model.final_cost), in_dims=(0, None))(xT, g_last)

        if self.gauss_newton and use_fused and not ref_terminal:
            f_x, f_u, _c, l_xx, l_uu, l_ux, l_x, l_u = fused_derivs(
                model, xs.contiguous(), us.contiguous(), g_z)
            return Derivs(torch.cat([l_x, gT[:, None]], dim=1), l_u,
                          torch.cat([l_xx, hT[:, None]], dim=1), l_uu, l_ux, f_x, f_u)

        def cost(xu, gz):
            return model.cost(xu[:S], xu[S:], gz)

        def dyn(xu):
            return model.dynamics(xu[:S], xu[S:])

        xu = torch.cat([xs[:, :-1], us], dim=-1).reshape(B * T, S + A)
        gz = g_z.expand(B, T, Z).reshape(B * T, Z)
        if self.gauss_newton and hasattr(model.state_cost, "W"):
            # the closed form the fused kernel computes (ops/linearize.py)
            g, h = gn_point_terms(model, xs[:, :-1], us, g_z.expand(B, T, Z))
        elif self.gauss_newton:
            def z_of(v):
                z = model.transform(v[:S], v[S:])
                return z, z

            g = vmap(grad(cost))(xu, gz).reshape(B, T, S + A)
            J, z = vmap(jacrev(z_of, has_aux=True))(xu)
            W = vmap(hessian(model.state_cost))(z, gz) / 2.0
            h = (2.0 * mT(J) @ W @ J).reshape(B, T, S + A, S + A)
        else:
            g = vmap(grad(cost))(xu, gz).reshape(B, T, S + A)
            h = vmap(hessian(cost))(xu, gz).reshape(B, T, S + A, S + A)
        # reverse mode: forward mode (jacfwd) carries the tangent of a 0-dim
        # tensor times a Python float in float64 in this PyTorch
        j = vmap(jacrev(dyn))(xu).reshape(B, T, S, S + A)
        return Derivs(
            l_x=torch.cat([g[..., :S], gT[:, None]], dim=1),
            l_u=g[..., S:],
            l_xx=torch.cat([h[..., :S, :S], hT[:, None]], dim=1),
            l_uu=h[..., S:, S:],
            l_ux=h[..., S:, :S],
            f_x=j[..., :S],
            f_u=j[..., S:],
        )

    def dynamics_hessian(self, xs, us):
        """(B, T, S, S+A, S+A) Hessians ∂²f_i/∂(x,u)² along B trajectories
        xs (B, T+1, S), us (B, T, A): the second-order terms of ``ddp``.
        Forward over reverse mode (forward over forward promotes to float64
        here, as ``derivatives`` notes)."""
        model = self.model
        B, Tp1, S = xs.shape
        T, A = Tp1 - 1, us.shape[-1]

        def dyn(xu):
            return model.dynamics(xu[:S], xu[S:])

        xu = torch.cat([xs[:, :-1], us], dim=-1).reshape(B * T, S + A)
        return vmap(jacfwd(jacrev(dyn)))(xu).reshape(B, T, S, S + A, S + A)

    # -- backward pass ----------------------------------------------------------
    def backward_pass(self, d: Derivs, mu, f_hess=None, us=None):
        """Plain batched Riccati recursion (matrix form) with per-scenario μ
        (B,) -> (ks (B, T, A), Ks (B, T, A, S), ok (B,)). ``f_hess``
        (B, T, S, S+A, S+A) adds the second-order dynamics terms (``ddp``);
        ``us`` (B, T, A), the clipped plan, makes the gains control-limited
        (``box_ddp``: k clamped so that u + k stays in the box, the rows of
        K of the controls it clamps zeroed)."""
        B, Tp1, S = d.l_x.shape
        T, A = Tp1 - 1, d.l_u.shape[-1]
        dev = d.l_x.device
        eye_s = torch.eye(S, dtype=torch.float32, device=dev)
        eye_a = torch.eye(A, dtype=torch.float32, device=dev)
        lo, hi = self.model.lo(dev), self.model.hi(dev)
        V_x, V_xx = d.l_x[:, -1], d.l_xx[:, -1]
        ok = torch.ones((B,), dtype=torch.bool, device=dev)
        ks, Ks = [None] * T, [None] * T
        for t in reversed(range(T)):
            f_x, f_u = d.f_x[:, t], d.f_u[:, t]
            if f_hess is None:
                vf_xx = vf_uu = vf_ux = 0.0
            else:
                vf = torch.einsum("bi,bijk->bjk", V_x, f_hess[:, t])  # V_x · f_(xu)(xu)
                vf_xx, vf_uu, vf_ux = vf[:, :S, :S], vf[:, S:, S:], vf[:, S:, :S]
            # μ·I enters the gain solve only; the value recursion below uses
            # the unregularised Q-terms (Tassa et al. 2012, eq. 10)
            V_reg = V_xx + mu[:, None, None] * eye_s
            Q_x = d.l_x[:, t] + mv(mT(f_x), V_x)
            Q_u = d.l_u[:, t] + mv(mT(f_u), V_x)
            Q_xx = d.l_xx[:, t] + mT(f_x) @ V_xx @ f_x + vf_xx
            Q_uu = d.l_uu[:, t] + mT(f_u) @ V_xx @ f_u + vf_uu
            Q_ux = d.l_ux[:, t] + mT(f_u) @ V_xx @ f_x + vf_ux
            Q_uu_reg = d.l_uu[:, t] + mT(f_u) @ V_reg @ f_u + vf_uu
            Q_ux_reg = d.l_ux[:, t] + mT(f_u) @ V_reg @ f_x + vf_ux
            rhs = torch.cat([Q_u[..., None], Q_ux_reg], dim=-1)  # (B, A, 1+S)
            if A == 1:  # scalar action: the solve is a division, PD is q > 0
                q00 = Q_uu_reg[:, 0, 0]
                ok_t = q00 > 0.0
                kK = rhs / torch.where(ok_t, q00, torch.ones_like(q00))[:, None, None]
            else:
                L, info = torch.linalg.cholesky_ex(Q_uu_reg)
                ok_t = (info == 0) & torch.isfinite(L).flatten(1).all(dim=1)
                kK = torch.cholesky_solve(rhs, torch.where(ok_t[:, None, None], L, eye_a))
            k, K = -kK[..., 0], -kK[..., 1:]
            if us is not None:
                u_t = us[:, t]
                u_new = u_t + k
                lo_hit, hi_hit = u_new < lo, u_new > hi
                k = torch.where(lo_hit, lo - u_t, torch.where(hi_hit, hi - u_t, k))
                K = torch.where((lo_hit | hi_hit)[..., None], 0.0, K)
            V_x = Q_x + mv(mT(K) @ Q_uu, k) + mv(mT(K), Q_u) + mv(mT(Q_ux), k)
            V_xx = Q_xx + mT(K) @ Q_uu @ K + mT(K) @ Q_ux + mT(Q_ux) @ K
            V_xx = 0.5 * (V_xx + mT(V_xx))
            ks[t], Ks[t] = k, K
            ok = ok & ok_t
        return torch.stack(ks, dim=1), torch.stack(Ks, dim=1), ok

    def backward_pass_ref(self, d: Derivs, mu):
        """The reference's numerics (``diag_hessian``), batched: only the
        cost Hessians' diagonals (as vectors) and the last row of l_ux, the
        elementwise inverse of Q_uu, and V_xx started as the terminal
        diagonal *vector*, so that the first step contracts a vector (a row
        for Q_xx) and every step broadcast-adds the l_xx row before the
        symmetrisation. Exact only for scalar actions, like the reference,
        and refused otherwise. Returns (ks, Ks, ok), ok always true: the
        elementwise inverse never fails."""
        if self.model.action_size != 1:
            raise ValueError("diag_hessian compat mode is scalar-action only")
        B, Tp1, S = d.l_x.shape
        T = Tp1 - 1
        eye_s = torch.eye(S, dtype=torch.float32, device=d.l_x.device)
        lxx_diag = torch.diagonal(d.l_xx, dim1=-2, dim2=-1)  # (B, T+1, S)
        luu_diag = torch.diagonal(d.l_uu, dim1=-2, dim2=-1)  # (B, T, A)
        lux_row = d.l_ux[:, :, -1, :]  # (B, T, S): the reference keeps hess[-1, :S]
        mu = mu[:, None, None]

        def gains(Q_u, Q_uu, Q_ux):
            Q_uu_inv = Q_uu**-1  # elementwise, the true inverse only for A = 1
            return -mv(Q_uu_inv, Q_u), -(Q_uu_inv @ Q_ux)

        ks, Ks = [None] * T, [None] * T
        # the step next to the terminal one: V_xx is still the diagonal vector
        V_x, v_xx = d.l_x[:, -1], lxx_diag[:, -1]
        f_x, f_u = d.f_x[:, -1], d.f_u[:, -1]
        Q_x = d.l_x[:, -2] + mv(mT(f_x), V_x)
        Q_u = d.l_u[:, -1] + mv(mT(f_u), V_x)
        q_xx_row = lxx_diag[:, -2] + mv(mT(f_x), mv(mT(f_x), v_xx))  # (B, S)
        V_reg = v_xx[:, None, :] + mu * eye_s  # vector + matrix broadcast
        Q_uu = luu_diag[:, -1][:, None, :] + mT(f_u) @ V_reg @ f_u
        Q_ux = lux_row[:, -1][:, None, :] + mT(f_u) @ V_reg @ f_x
        k, K = gains(Q_u, Q_uu, Q_ux)
        ks[-1], Ks[-1] = k, K
        V_x = Q_x + mv(mT(K) @ Q_uu, k) + mv(mT(K), Q_u) + mv(mT(Q_ux), k)
        V_xx = q_xx_row[:, None, :] + (mT(K) @ Q_uu @ K + mT(K) @ Q_ux + mT(Q_ux) @ K)
        V_xx = 0.5 * (V_xx + mT(V_xx))
        for t in reversed(range(T - 1)):
            f_x, f_u = d.f_x[:, t], d.f_u[:, t]
            V_reg = V_xx + mu * eye_s
            Q_x = d.l_x[:, t] + mv(mT(f_x), V_x)
            Q_u = d.l_u[:, t] + mv(mT(f_u), V_x)
            Q_uu = luu_diag[:, t][:, None, :] + mT(f_u) @ V_reg @ f_u
            Q_ux = lux_row[:, t][:, None, :] + mT(f_u) @ V_reg @ f_x
            k, K = gains(Q_u, Q_uu, Q_ux)
            ks[t], Ks[t] = k, K
            V_x = Q_x + mv(mT(K) @ Q_uu, k) + mv(mT(K), Q_u) + mv(mT(Q_ux), k)
            V_xx = (lxx_diag[:, t][:, None, :] + mT(f_x) @ V_xx @ f_x
                    + mT(K) @ Q_uu @ K + mT(K) @ Q_ux + mT(Q_ux) @ K)
            V_xx = 0.5 * (V_xx + mT(V_xx))
        ok = torch.ones((B,), dtype=torch.bool, device=d.l_x.device)
        return torch.stack(ks, dim=1), torch.stack(Ks, dim=1), ok

    # -- forward pass -----------------------------------------------------------
    def forward_pass(self, alphas, ks, Ks, xs, us, g_z, xnoise=None):
        """Plain all-α feedback rollouts from xs[:, 0]: alphas (n,) ->
        (xs_hat (n, B, T+1, S), us_hat (n, B, T, A), costs (n, B)); the
        terminal cost is added when it is part of the objective. ``xnoise``
        (n, B, T, S), when given, is added to the state after each step
        (the noisy planning model)."""
        model = self.model
        n = alphas.shape[0]
        B, T, A = us.shape
        x = xs[:, 0].expand(n, B, xs.shape[-1])
        cost = torch.zeros((n, B), dtype=torch.float32, device=xs.device)
        alpha = alphas[:, None, None]
        xs_hat, us_hat = [x], []
        for t in range(T):
            u = us[:, t] + alpha * ks[:, t] + mv(Ks[:, t], x - xs[:, t])
            u = model.clip_action(u)
            x, c = model.step_and_cost(x, u, g_z[t])
            if xnoise is not None:
                x = x + xnoise[:, :, t]
            cost = cost + c
            xs_hat.append(x)
            us_hat.append(u)
        if self._terminal_in_objective:
            cost = cost + model.final_cost(x, g_z[-1])
        return torch.stack(xs_hat, dim=2), torch.stack(us_hat, dim=2), cost

    @property
    def _terminal_in_objective(self) -> bool:
        """The modern path scores the nominal rollout and the candidates on
        stage plus terminal cost, the objective the backward pass optimises;
        the reference-accept and diag-Hessian modes keep the reference's
        stage-only metric."""
        return not (self.reference_accept or self.diag_hessian)

    # -- μ/δ schedule -------------------------------------------------------------
    def _mu_increase(self, mu, delta):
        delta = torch.clamp(delta * self.delta_zero, min=self.delta_zero)
        return torch.clamp(mu * delta, min=self.mu_min), delta

    def _mu_decrease(self, mu, delta):
        delta = torch.clamp(delta / self.delta_zero, max=1.0 / self.delta_zero)
        md = mu * delta
        return torch.where(md < self.mu_min, torch.zeros_like(md), md), delta

    # -- outer loop ---------------------------------------------------------------
    def _iteration(self, x0s, g_z, us, mu, delta, routes: StageRoutes, noise=None):
        """One outer iteration for every scenario: (us, mu, delta, converged).
        ``noise`` (standard normals (B, T, S), (B, n_alphas, T, S)) is the
        iteration's draw for the nominal rollout and the candidates."""
        model = self.model
        mu = torch.clamp(mu, self.mu_min, self.mu_max)
        if noise is None:
            xs, cost = simulate_trajectory(model, x0s, us, g_z)
        else:
            xs, cost = simulate_trajectory_noisy(model, x0s, us, g_z,
                                                 self.model_noise_std * noise[0])
        if self._terminal_in_objective:
            cost = cost + model.final_cost(xs[:, -1], g_z[-1])
        d = self.derivatives(xs, us, g_z, routes.derivs, ref_terminal=self.diag_hessian)
        if self.diag_hessian:
            ks, Ks, bp_ok = self.backward_pass_ref(d, mu)
        elif routes.riccati:
            ks, Ks, bp_ok = riccati_backward_batch(*(t.contiguous() for t in d), mu)
        else:
            f_hess = self.dynamics_hessian(xs, us) if self.ddp else None
            us_bp = model.clip_action(us) if self.box_ddp else None
            ks, Ks, bp_ok = self.backward_pass(d, mu, f_hess, us_bp)
        us_c = model.clip_action(us)
        alphas = self.alphas(x0s.device)
        if noise is not None:
            xnoise = self.model_noise_std * noise[1].transpose(0, 1)
            _, new_uss, new_costs = self.forward_pass(alphas, ks, Ks, xs, us_c, g_z, xnoise)
        elif routes.linesearch:
            new_uss, new_costs = fused_linesearch(
                model, alphas, x0s.contiguous(), us_c.contiguous(), ks.contiguous(),
                Ks.contiguous(), xs, g_z, with_terminal=self._terminal_in_objective)
        else:
            _, new_uss, new_costs = self.forward_pass(alphas, ks, Ks, xs, us_c, g_z)

        if self.reference_accept:
            # sequential accept replay over α: stop at the first α that
            # improves (accept) or whose cost lies within threshold
            best_us, cur_cost = us_c, cost
            accepted = torch.zeros_like(bp_ok)
            stop = torch.zeros_like(bp_ok)
            for j in range(self.n_alphas):
                new_cost = new_costs[j]
                improves = ~stop & (new_cost < cur_cost)
                mu_d, delta_d = self._mu_decrease(mu, delta)
                mu = torch.where(improves, mu_d, mu)
                delta = torch.where(improves, delta_d, delta)
                best_us = torch.where(improves[:, None, None], new_uss[j], best_us)
                cur_cost = torch.where(improves, new_cost, cur_cost)
                rel = torch.abs((cur_cost - new_cost) / cur_cost)
                accepted = accepted | improves
                stop = stop | (rel < self.threshold)
            us_new, converged = best_us, stop
        else:
            best_j = torch.argmin(new_costs, dim=0)  # first minimum, as argmin
            best_cost = new_costs.gather(0, best_j[None])[0]
            accepted = best_cost < cost
            pick = new_uss[best_j, torch.arange(best_j.shape[0], device=best_j.device)]
            us_new = torch.where(accepted[:, None, None], pick, us_c)
            rel = torch.abs((cost - best_cost) / cost)
            converged = accepted & (rel < self.threshold)
            mu_d, delta_d = self._mu_decrease(mu, delta)
            mu = torch.where(accepted, mu_d, mu)
            delta = torch.where(accepted, delta_d, delta)

        # backward-pass failure or no accepted step -> escalate the trust region
        escalate = ~bp_ok | ~accepted
        mu_i, delta_i = self._mu_increase(mu, delta)
        mu = torch.where(escalate, mu_i, mu)
        delta = torch.where(escalate, delta_i, delta)
        us_new = torch.where(bp_ok[:, None, None], us_new, us)
        return us_new, mu, delta, converged & bp_ok

    def solve_batch(self, state: ILQRState, xs, g_z, use_fused: bool = True, noise=None):
        """One iLQR solve for B scenarios xs (B, S), plans (B, T, A): all
        ``max_iter`` iterations in lock-step, converged scenarios frozen.

        With ``model_noise_std > 0`` every iteration draws standard normals
        (B, T, S) for the nominal rollout and (B, n_alphas, T, S) for the
        candidates from the state's generator; ``noise``, a pair of such
        draws with a leading ``max_iter`` axis, replaces them (iteration i
        takes row i, as the reference's key splits of its i-th iteration)."""
        B = xs.shape[0]
        use_fused = use_fused and self.pallas_backward is not False
        routes = self.stage_routes(use_fused)
        if use_fused:
            check_fused_tier("ILQR.solve_batch", self.model, g_z,
                             calls_model=self.calls_model_kernels())
        noise = model_noise_draws(self, state.generator, B, xs.device, noise)
        us = state.planned_us
        mu = torch.ones((B,), dtype=torch.float32, device=xs.device)
        delta = torch.full((B,), self.delta_zero, dtype=torch.float32, device=xs.device)
        converged = torch.zeros((B,), dtype=torch.bool, device=xs.device)
        for i in range(self.max_iter):
            step = self._iteration(xs, g_z, us, mu, delta, routes, noise(i))
            live = ~converged
            us = torch.where(live[:, None, None], step[0], us)
            mu = torch.where(live, step[1], mu)
            delta = torch.where(live, step[2], delta)
            converged = torch.where(live, step[3], converged)
        return state._replace(planned_us=us), us[:, 0], {}

    def solve(self, state: ILQRState, x, g_z):
        """One iLQR solve from state x (S,), plan (T, A): ``solve_batch`` on
        a batch of one, without the kernels."""
        st, u0, aux = self.solve_batch(state._replace(planned_us=state.planned_us[None]),
                                       x[None], g_z, use_fused=False)
        return state._replace(planned_us=st.planned_us[0]), u0[0], aux
