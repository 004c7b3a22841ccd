"""iLQR with a Levenberg–Marquardt trust region and an all-α line search.

Counterpart of ``benchmarking_mpc_solvers_tpu/solvers/ilqr.py``, without
second-order dynamics terms:

- derivatives by ``torch.func`` (``grad``, ``hessian``, ``jacrev``) over the
  written-out (B·T) batch of (x, u) points, plus the terminal cost's at x_T;
  with ``gauss_newton`` the cost Hessians are the PSD Gauss-Newton forms
  2 Jᵀ W J in feature space (stage terms from ``fused_derivs`` in one launch
  on the fused tier, else from ``gn_point_terms``), the gradients exact at
  the terminal stage;
- the backward Riccati recursion with μ in the gain solve only, the
  unregularised value recursion and the Q_uu > 0 check; the scalar-action
  fast path divides instead of solving;
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
``max_iter`` iterations. With ``use_fused`` the
backward pass is ``riccati_backward_batch`` and the line search
``fused_linesearch`` (and with ``gauss_newton`` the stage derivatives
``fused_derivs``): one kernel launch each per iteration on the card, their
plain versions on the CPU; a model these do not take is refused
(``solvers/base.py:check_fused_tier``) and needs ``use_fused=False``.
``solve`` is ``solve_batch`` on a batch of one without the kernels. The reference's ``pallas_backward`` switch is this
``use_fused`` argument here.

Not ported yet, and refused at construction: ``ddp``, ``box_ddp``,
``diag_hessian`` and ``model_noise_std > 0`` (ROADMAP.md §1 item 9a).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import grad, hessian, jacrev, vmap

from ..device import resolve_device
from ..ops.fused_derivs import fused_derivs
from ..ops.fused_linesearch import fused_linesearch
from ..ops.linearize import gn_point_terms, mT, mv
from ..ops.riccati_backward import riccati_backward_batch
from ..ops.rollout import simulate_trajectory
from .base import Solver, check_fused_tier


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


# option -> the ROADMAP.md §1 item that ports it
_NOT_PORTED = {
    "ddp": "item 9a",
    "box_ddp": "item 9a",
    "diag_hessian": "item 9a",
}


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
    diag_hessian: bool = False
    gauss_newton: bool = False
    ddp: bool = False
    box_ddp: bool = False
    model_noise_std: float = 0.0

    def __post_init__(self):
        for name, item in _NOT_PORTED.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"ILQR({name}=True) is not ported yet: ROADMAP.md §1 {item}")
        if self.model_noise_std > 0.0:
            raise NotImplementedError(
                "ILQR(model_noise_std > 0) is not ported yet: ROADMAP.md §1 item 9a")

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

    def alphas(self, device=None):
        """Line-search step sizes 1.1^(−i²), i < n_alphas, in float32."""
        i = torch.arange(self.n_alphas, dtype=torch.float32, device=device)
        return torch.pow(1.1, -(i**2))

    # -- derivative stage -------------------------------------------------------
    def derivatives(self, xs, us, g_z, use_fused: bool = False) -> Derivs:
        """Cost gradients/Hessians and dynamics Jacobians along xs
        (B, T+1, S), us (B, T, A), and the terminal cost's at x_T: exact, or
        with ``gauss_newton`` the Gauss-Newton forms (the stage terms from
        ``fused_derivs`` when ``use_fused``)."""
        model = self.model
        if use_fused:
            check_fused_tier("ILQR.derivatives", model, g_z)
        B, Tp1, S = xs.shape
        T, A, Z = Tp1 - 1, us.shape[-1], g_z.shape[-1]
        xT, g_last = xs[:, -1], g_z[-1]
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

        if self.gauss_newton and use_fused:
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

    # -- backward pass ----------------------------------------------------------
    def backward_pass(self, d: Derivs, mu):
        """Plain batched Riccati recursion (matrix form) with per-scenario μ
        (B,) -> (ks (B, T, A), Ks (B, T, A, S), ok (B,))."""
        B, Tp1, S = d.l_x.shape
        T, A = Tp1 - 1, d.l_u.shape[-1]
        eye_s = torch.eye(S, dtype=torch.float32, device=d.l_x.device)
        eye_a = torch.eye(A, dtype=torch.float32, device=d.l_x.device)
        V_x, V_xx = d.l_x[:, -1], d.l_xx[:, -1]
        ok = torch.ones((B,), dtype=torch.bool, device=d.l_x.device)
        ks, Ks = [None] * T, [None] * T
        for t in reversed(range(T)):
            f_x, f_u = d.f_x[:, t], d.f_u[:, t]
            # μ·I enters the gain solve only; the value recursion below uses
            # the unregularised Q-terms (Tassa et al. 2012, eq. 10)
            V_reg = V_xx + mu[:, None, None] * eye_s
            Q_x = d.l_x[:, t] + mv(mT(f_x), V_x)
            Q_u = d.l_u[:, t] + mv(mT(f_u), V_x)
            Q_xx = d.l_xx[:, t] + mT(f_x) @ V_xx @ f_x
            Q_uu = d.l_uu[:, t] + mT(f_u) @ V_xx @ f_u
            Q_ux = d.l_ux[:, t] + mT(f_u) @ V_xx @ f_x
            Q_uu_reg = d.l_uu[:, t] + mT(f_u) @ V_reg @ f_u
            Q_ux_reg = d.l_ux[:, t] + mT(f_u) @ V_reg @ f_x
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
            V_x = Q_x + mv(mT(K) @ Q_uu, k) + mv(mT(K), Q_u) + mv(mT(Q_ux), k)
            V_xx = Q_xx + mT(K) @ Q_uu @ K + mT(K) @ Q_ux + mT(Q_ux) @ K
            V_xx = 0.5 * (V_xx + mT(V_xx))
            ks[t], Ks[t] = k, K
            ok = ok & ok_t
        return torch.stack(ks, dim=1), torch.stack(Ks, dim=1), ok

    # -- forward pass -----------------------------------------------------------
    def forward_pass(self, alphas, ks, Ks, xs, us, g_z):
        """Plain all-α feedback rollouts from xs[:, 0]: alphas (n,) ->
        (xs_hat (n, B, T+1, S), us_hat (n, B, T, A), costs (n, B)); the
        terminal cost is added when it is part of the objective."""
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
        the reference-accept mode keeps the reference's stage-only metric."""
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
    def _iteration(self, x0s, g_z, us, mu, delta, use_fused: bool):
        """One outer iteration for every scenario: (us, mu, delta, converged)."""
        model = self.model
        mu = torch.clamp(mu, self.mu_min, self.mu_max)
        xs, cost = simulate_trajectory(model, x0s, us, g_z)
        if self._terminal_in_objective:
            cost = cost + model.final_cost(xs[:, -1], g_z[-1])
        d = self.derivatives(xs, us, g_z, use_fused)
        if use_fused:
            ks, Ks, bp_ok = riccati_backward_batch(*(t.contiguous() for t in d), mu)
        else:
            ks, Ks, bp_ok = self.backward_pass(d, mu)
        us_c = model.clip_action(us)
        alphas = self.alphas(x0s.device)
        if use_fused:
            new_uss, new_costs = fused_linesearch(
                model, alphas, x0s.contiguous(), us_c.contiguous(), ks, Ks, xs, g_z,
                with_terminal=self._terminal_in_objective)
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

    def solve_batch(self, state: ILQRState, xs, g_z, use_fused: bool = True):
        """One iLQR solve for B scenarios xs (B, S), plans (B, T, A): all
        ``max_iter`` iterations in lock-step, converged scenarios frozen."""
        B = xs.shape[0]
        us = state.planned_us
        mu = torch.ones((B,), dtype=torch.float32, device=xs.device)
        delta = torch.full((B,), self.delta_zero, dtype=torch.float32, device=xs.device)
        converged = torch.zeros((B,), dtype=torch.bool, device=xs.device)
        for _ in range(self.max_iter):
            step = self._iteration(xs, g_z, us, mu, delta, use_fused)
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
