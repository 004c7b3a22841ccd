"""QP-based linear MPC: condensed box-QP solved by ADMM or interior point.

Counterpart of ``benchmarking_mpc_solvers_tpu/solvers/qp_mpc.py``. Each
``solve`` call:

1. linearizes the model dynamics around an operating point (the goal state
   by default, classic linear MPC; the current state; or, ``"plan"``, along
   the previous plan's rollout),
2. condenses the horizon into a dense (T·A)² box QP (``ops/qp.py``), or keeps
   the horizon structure for the Riccati-ADMM method,
3. solves it with OSQP-style ADMM (default) or a log-barrier interior-point
   method, both with fixed iteration bounds,
4. returns the first control; the full plan seeds the next call's warm
   start through the agent-layer receding-horizon shift.

The tracking weights (Q, R, Qf) default to the state/action blocks of the
model's quadratic feature cost evaluated at the linearization point, so the
QP objective is the Gauss-Newton model of the true benchmark cost.

``solve_batch`` has the reference's three branches: the shared-factor
Riccati-ADMM (``method="riccati_admm"`` at ``"goal"``, plain PyTorch); the
ADMM kernel ``ops/qp_admm.py:admm_iterate`` (``method="admm"`` at ``"goal"``
in its shared layout, at ``"state"`` per problem); and for everything else
(``"ip"``, LTV Riccati-ADMM, ``"plan"``, planning-model noise), where the
reference vmaps its scalar solve, a loop over the scenarios calling
``solve``.

``parallel_horizon`` switches the Riccati-ADMM's horizon recursions to the
associative-scan forms of ``ops/riccati.py``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import hessian, jacrev, vmap

from ..device import resolve_device
from ..ops.linearize import AffineDynamics, linearize_dynamics
from ..ops.qp import (
    admm_solve,
    admm_solve_riccati,
    admm_solve_riccati_batch,
    condense,
    condense_batch,
    ip_solve,
)
from ..ops.qp_admm import admm_iterate, admm_iterate_reference
from ..ops.rollout import best_plan_by_rollout_cost, rollout
from .base import Solver

_METHODS = ("riccati_admm", "admm", "ip")
_LINEARIZE_AT = ("goal", "state", "plan")


class QPMPCState(NamedTuple):
    planned_us: torch.Tensor  # (T, A), or (B, T, A) on the batched tier
    generator: torch.Generator


def _chol_inv(M):
    """Cholesky-based inverse (= cholesky_solve against I), so the batched
    path matches ``admm_solve``'s numerics; an explicit inverse amplifies
    error on the ill-conditioned condensed H of unstable plants."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)
    return torch.cholesky_solve(eye, torch.linalg.cholesky(M))


@dataclasses.dataclass(frozen=True, eq=False)
class QPMPC(Solver):
    # "riccati_admm" (default: stable for unstable plants / long horizons),
    # "admm" (condensed dense: fine for stable systems / short horizons),
    # "ip" (condensed log-barrier interior point)
    method: str = "riccati_admm"
    iters: int = 100
    rho: float = 1.0
    eps: float = 1e-6
    # "goal" (classic linear MPC), "state" (re-linearize at the current
    # state, constant over the horizon), "plan" (LTV: re-linearize along
    # the previous plan's rollout, real-time-iteration SQP)
    linearize_at: str = "goal"
    # optional explicit tracking weights; default derives them from the model
    Q: Optional[tuple] = None
    R: Optional[tuple] = None
    Qf: Optional[tuple] = None
    goal_x: Optional[tuple] = None  # linearization/tracking state target
    # planning-model noise: QPMPC makes one dynamics evaluation per solve
    # (the linearization residual), so the per-predict state noise lands on
    # the affine term c
    model_noise_std: float = 0.0
    parallel_horizon: bool = False
    # init_std > 0: random initial plan ~ N(0, init_std) clipped to the box.
    # Only meaningful for linearize_at="plan": a zero plan at a symmetric
    # equilibrium is an LTV fixed point.
    init_std: float = 0.0

    def __post_init__(self):
        if self.method not in _METHODS:
            raise ValueError(f"method must be one of {_METHODS}, got {self.method!r}")
        if self.linearize_at not in _LINEARIZE_AT:
            raise ValueError(
                f"linearize_at must be one of {_LINEARIZE_AT}, got {self.linearize_at!r}")

    def _weights(self, device=None):
        """Gauss-Newton (Q, R, Qf) from the model's feature-space quadratic,
        evaluated at the goal point."""
        model = self.model
        S, A = model.state_size, model.action_size
        xu = torch.cat([self._goal_state(device),
                        torch.zeros((A,), dtype=torch.float32, device=device)])

        def z_fn(v):
            return model.transform(v[:S], v[S:])

        J = jacrev(z_fn)(xu)
        gz = torch.zeros((model.goal_size,), dtype=torch.float32, device=device)
        W = hessian(lambda z: model.state_cost(z, gz))(z_fn(xu)) / 2.0
        Hgn = J.T @ W @ J  # cost ≈ (xu)ᵀ Hgn (xu) around the operating point

        def given(value, default):
            if value is None:
                return default
            return torch.tensor(value, dtype=torch.float32, device=device)

        Q = given(self.Q, Hgn[:S, :S])
        R = given(self.R, Hgn[S:, S:])
        R = R + 1e-6 * torch.eye(A, dtype=torch.float32, device=device)
        Qf = given(self.Qf, Q)
        return Q, R, Qf

    def _goal_state(self, device=None):
        if self.goal_x is not None:
            return torch.tensor(self.goal_x, dtype=torch.float32, device=device)
        return torch.zeros((self.model.state_size,), dtype=torch.float32, device=device)

    def init_state(self, generator: torch.Generator, device="cuda", noise=None) -> QPMPCState:
        device = resolve_device(device)
        return QPMPCState(self._init_plan((), self.init_std, generator, device, noise),
                          generator)

    def init_state_batch(self, batch: int, generator: torch.Generator, device="cuda",
                         noise=None) -> QPMPCState:
        device = resolve_device(device)
        return QPMPCState(self._init_plan((batch,), self.init_std, generator, device, noise),
                          generator)

    def _linearize(self, x, planned_us=None) -> AffineDynamics:
        """Affine dynamics over the horizon for state(s) x (..., S): shared
        (T, ...) fields at ``"goal"``, else with x's leading dimensions."""
        model = self.model
        T, S, A = self.T, model.state_size, model.action_size
        lead = x.shape[:-1]
        if self.linearize_at == "plan":
            # LTV mode: re-linearize along the rollout of the previous plan
            # (one Gauss-Newton QP per MPC step, bootstrapped by the
            # receding-horizon warm start)
            g_dummy = torch.zeros((T, model.goal_size), dtype=torch.float32, device=x.device)
            us = model.clip_action(planned_us)
            xs, _ = rollout(model, x, us, g_dummy)
            return linearize_dynamics(model, xs[..., :-1, :], us)
        if self.linearize_at == "goal":
            x_op, lead = self._goal_state(x.device), ()
        else:
            x_op = x
        x_flat = x_op.reshape(-1, S)
        u_flat = torch.zeros((x_flat.shape[0], A), dtype=torch.float32, device=x.device)
        Am, Bm = vmap(jacrev(model.dynamics, argnums=(0, 1)))(x_flat, u_flat)
        c = (model.dynamics(x_flat, u_flat) - (Am @ x_flat[..., None])[..., 0]
             - (Bm @ u_flat[..., None])[..., 0])

        def over_horizon(m, tail):
            return m.reshape(lead + (1,) + tail).expand(lead + (T,) + tail)

        return AffineDynamics(over_horizon(Am, (S, S)), over_horizon(Bm, (S, A)),
                              over_horizon(c, (S,)))

    def solve(self, state: QPMPCState, x, g_z, noise=None):
        """One solve from state x (S,), plan (T, A). With
        ``model_noise_std > 0`` the residual c gets ``model_noise_std``·noise,
        noise a standard-normal (T, S) tensor, drawn from the state's
        generator unless given."""
        model = self.model
        dev = x.device
        dyn = self._linearize(x, state.planned_us)
        if self.model_noise_std > 0.0:
            if noise is None:
                noise = torch.randn(dyn.c.shape, generator=state.generator, device=dev)
            dyn = dyn._replace(c=dyn.c + self.model_noise_std * noise)
        Q, R, Qf = self._weights(dev)
        xref = self._goal_state(dev)
        uref = torch.zeros((model.action_size,), dtype=torch.float32, device=dev)
        lo, hi = model.lo(dev), model.hi(dev)
        if self.method == "riccati_admm":
            planned, _, _, _ = admm_solve_riccati(
                dyn, x, Q, R, Qf, xref, uref, lo, hi, rho=self.rho, iters=self.iters,
                eps=self.eps, parallel_horizon=self.parallel_horizon)
        else:
            qp = condense(dyn, x, Q, R, Qf, xref=xref, uref=uref, u_lo=lo, u_hi=hi)
            if self.method == "ip":
                U = ip_solve(qp, iters=self.iters)
            else:
                U = admm_solve(qp, rho=self.rho, iters=self.iters, eps=self.eps).U
            planned = U.reshape(self.T, model.action_size)
        if self.linearize_at == "plan":
            # globalized RTI step: the QP optimizes the Gauss-Newton model
            # around the previous plan, which can walk uphill in true cost;
            # accept full step / half step / keep by true rollout cost
            old = model.clip_action(state.planned_us)
            cands = torch.stack([planned, 0.5 * (planned + old), old], dim=0)
            planned = best_plan_by_rollout_cost(model, x, g_z, cands)
        return state._replace(planned_us=planned), planned[0], {}

    # -- batched path ---------------------------------------------------------
    def solve_batch(self, state: QPMPCState, xs, g_z, use_fused: bool = True, noise=None):
        """Batched solve over B scenarios xs (B, S), plans (B, T, A).

        ``method='riccati_admm'`` at ``'goal'`` shares the quadratic Riccati
        factors across the batch and all ADMM iterations
        (``ops/qp.py:admm_solve_riccati_batch``).

        ``method='admm'`` runs ``admm_iterate`` (with ``use_fused``; else its
        plain version): shared H at ``'goal'``, per-scenario factorizations
        at ``'state'``.

        Everything else ('ip', LTV riccati_admm, ``'plan'`` and the noised
        planning model, with ``noise`` (B, T, S)) loops over the scenarios
        and calls ``solve``."""
        model = self.model
        dev = xs.device
        B = xs.shape[0]
        if (self.method == "riccati_admm" and self.linearize_at == "goal"
                and self.model_noise_std == 0.0):
            Q, R, Qf = self._weights(dev)
            us, _, _, _ = admm_solve_riccati_batch(
                self._linearize(xs[0]), xs, Q, R, Qf, self._goal_state(dev),
                torch.zeros((model.action_size,), dtype=torch.float32, device=dev),
                model.lo(dev), model.hi(dev), rho=self.rho, iters=self.iters, eps=self.eps,
                parallel_horizon=self.parallel_horizon)
            return state._replace(planned_us=us), us[:, 0], {}
        if (self.method != "admm" or self.model_noise_std > 0.0
                or self.linearize_at == "plan"):
            plans = []
            for b in range(B):
                st, _, _ = self.solve(state._replace(planned_us=state.planned_us[b]), xs[b],
                                      g_z, None if noise is None else noise[b])
                plans.append(st.planned_us)
            planned = torch.stack(plans)
            return state._replace(planned_us=planned), planned[:, 0], {}

        iterate = admm_iterate if use_fused else admm_iterate_reference
        z = iterate(*self.admm_problem(xs), rho=self.rho, alpha=1.6, iters=self.iters)
        planned = z.reshape(B, self.T, model.action_size)
        return state._replace(planned_us=planned), planned[:, 0], {}

    def admm_problem(self, xs):
        """What ``method='admm'`` hands ``admm_iterate`` for states xs (B, S):
        ``(Minv, g, lo, hi)`` of the condensed box-QPs, Minv = (H + ρI)⁻¹
        shared (n, n) at ``'goal'`` or per scenario (B, n, n) at ``'state'``,
        all contiguous."""
        model = self.model
        dev = xs.device
        Q, R, Qf = self._weights(dev)
        xref = self._goal_state(dev)
        uref = torch.zeros((model.action_size,), dtype=torch.float32, device=dev)
        lo, hi = model.lo(dev), model.hi(dev)
        eye = torch.eye(self.T * model.action_size, dtype=torch.float32, device=dev)
        if self.linearize_at == "goal":
            qp = condense_batch(self._linearize(xs[0]), xs, Q, R, Qf, xref, uref, lo, hi)
        else:
            # per-scenario linearizations: full per-scenario H and bounds
            qp = condense(self._linearize(xs), xs, Q, R, Qf, xref, uref, lo, hi)
        Minv = _chol_inv(qp.H + self.rho * eye)  # (n, n) shared or (B, n, n)
        return (Minv.contiguous(), qp.g.contiguous(), qp.lo.contiguous(), qp.hi.contiguous())
