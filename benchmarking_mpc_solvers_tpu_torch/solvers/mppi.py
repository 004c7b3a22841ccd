"""MPPI — Model-Predictive Path Integral control.

Counterpart of ``benchmarking_mpc_solvers_tpu/solvers/mppi.py``:

- per-sample cost = Σ_t stage_cost(x_t, u_t) + λ uₜ·δuₜ / std², u = plan + δ;
- non-finite costs score 1e30; softmax weights w ∝ exp(−(c−β)/λ), β = min;
- plan += Σ_k w_k δu_k; rollout actions are not clipped (models clip);
- ``resample=False`` reuses the δu drawn at init (the reference's quirk).

Three tiers: ``solve`` (one scenario), ``solve_batch`` (B scenarios, through
the fused rollout kernel ``ops/fused.py``) and ``solve_batch_tm`` (the whole
step as one kernel, ``ops/fused_mppi.py``). ``solve`` draws from the state's
``torch.Generator``. ``solve_batch`` draws each scenario's perturbations, and
on its plain tier its planning-model noise, from its own counter-based stream
(``scenario_normals``: the scenario's seed, its draw count, k, t), so they do
not depend on the batch slot, as the reference's per-scenario keys do not.
The kernel tier draws its own counter-based noise from one seed per call.
The parity tests inject the reference's draws instead. ``solve_batch``
marks its stages with ``utils.profiling.span``: ``mppi.draw``,
``mppi.rollout`` and ``mppi.update``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..ops.fused import fused_rollout_costs_tm
from ..ops.fused_mppi import fused_mppi_step, pick_lanes, scenario_normals, scenario_seeds
from ..ops.rollout import rollout_cost, rollout_cost_noisy
from ..utils.profiling import span
from .base import Solver


class MPPIState(NamedTuple):
    planned_us: torch.Tensor  # (T, A), or (B, T, A) on the batched tier
    delta_u: torch.Tensor  # (K, T, A) fixed perturbations (resample=False)
    generator: torch.Generator
    seeds: Optional[torch.Tensor] = None  # (B,) int64 noise seeds (batched tier)
    calls: Optional[torch.Tensor] = None  # (B,) int64 draws made per scenario


def _weights(costs, lam: float, dim: int):
    """Failure guard, then the baselined softmax over samples."""
    costs = torch.where(torch.isfinite(costs), costs, torch.full_like(costs, 1e30))
    beta = costs.min(dim=dim, keepdim=True).values
    return costs, torch.softmax(-(costs - beta) / lam, dim=dim)


@dataclasses.dataclass(frozen=True, eq=False)
class MPPI(Solver):
    K: int = 100
    std: float = 1.0
    lam: float = 1.0
    resample: bool = True  # False = reference's sample-once quirk
    model_noise_std: float = 0.0  # planning-model noise

    def init_state(self, generator: torch.Generator, device="cuda") -> MPPIState:
        device = resolve_device(device)
        A = self.model.action_size
        planned = torch.zeros((self.T, A), dtype=torch.float32, device=device)
        delta = self.std * torch.randn(
            (self.K, self.T, A), generator=generator, device=device)
        return MPPIState(planned, delta, generator)

    def solve(self, state: MPPIState, x, g_z, delta_u=None, xnoise=None):
        """One MPPI step from state x (S,). ``delta_u`` (K, T, A) and
        ``xnoise`` (K, T, S) replace the generator's draws when given."""
        model = self.model
        dev = state.planned_us.device
        if not self.resample:
            delta_u = state.delta_u
        elif delta_u is None:
            delta_u = self.std * torch.randn(
                (self.K, self.T, model.action_size), generator=state.generator, device=dev)
        samples = state.planned_us[None] + delta_u  # (K, T, A)
        if self.model_noise_std > 0.0:
            if xnoise is None:
                xnoise = self.model_noise_std * torch.randn(
                    (self.K, self.T, model.state_size), generator=state.generator, device=dev)
            roll, _ = rollout_cost_noisy(model, x, samples, g_z, xnoise)
        else:
            roll, _ = rollout_cost(model, x, samples, g_z)
        ctrl = self.lam * torch.einsum("kta,kta->k", samples, delta_u) / (self.std**2)
        costs, w = _weights(roll + ctrl, self.lam, dim=0)
        planned = state.planned_us + torch.einsum("k,kta->ta", w, delta_u)
        return state._replace(planned_us=planned), planned[0], {"sample_costs": costs}

    # -- batched-scenario tiers ------------------------------------------------
    def init_state_batch(self, batch: int, generator: torch.Generator,
                         device="cuda") -> MPPIState:
        """Zero (B, T, A) plans and one noise seed per scenario; the delta
        placeholder is (B, 1, 1, 1) (the sample-once mode stays on the
        per-scenario tier)."""
        device = resolve_device(device)
        planned = torch.zeros((batch, self.T, self.model.action_size),
                              dtype=torch.float32, device=device)
        return MPPIState(planned, planned.new_zeros((batch, 1, 1, 1)), generator,
                         scenario_seeds(batch, generator, device),
                         torch.zeros((batch,), dtype=torch.int64, device=device))

    def solve_batch(self, state: MPPIState, xs, g_z, use_fused: bool = True,
                    delta_tm=None, xnoise=None):
        """One MPPI step for B scenarios, xs (B, S), plans (B, T, A).

        Perturbations are time-major (T, B·K), column b·K + k, std-scaled:
        ``delta_tm`` injects them (action_size == 1), else each scenario's
        are drawn from its own stream (``scenario_normals``: without model
        noise already scaled, (B, K, T) viewed time-major). With
        ``use_fused`` (and a scalar action) the B·K rollouts go through
        ``fused_rollout_costs_tm``, else through the plain batched rollout;
        both apply the same update law.

        Planning-model noise (``model_noise_std > 0``) enters the plain tier
        only, as it enters the reference's per-scenario ``solve``: state
        noise (B, K, T, S), already scaled, is added after every model step
        of the rollouts. ``xnoise`` injects it; else scenario b's comes from
        its own stream at the same draw count as its perturbations, at
        timestep indices T·A onwards, which the perturbations never use.
        The fused tier plans with a clean model, as the reference's batched
        tiers do, and refuses an injected ``xnoise``."""
        model = self.model
        B, S = xs.shape
        K, T, A = self.K, self.T, model.action_size
        N = B * K
        if state.seeds is None:
            raise ValueError("solve_batch needs per-scenario seeds: make the state "
                             "with init_state_batch")
        if use_fused and xnoise is not None:
            raise ValueError("solve_batch: the fused tier plans without model noise; "
                             "pass xnoise with use_fused=False")
        noisy = not use_fused and self.model_noise_std > 0.0
        with span("mppi.draw"):
            draws = None
            if delta_tm is None or (noisy and xnoise is None):
                # the draw scales by std where it holds the perturbations alone
                draws = scenario_normals(state.seeds, state.calls, K,
                                         T * (A + S) if noisy else T * A,
                                         scale=1.0 if noisy else self.std)
            if delta_tm is None:
                delta = (self.std * draws[..., :T * A] if noisy else draws).reshape(B, K, T, A)
                if A == 1:
                    delta_tm = delta[..., 0].permute(2, 0, 1).reshape(T, N)
            else:
                delta = delta_tm.reshape(T, B, K).permute(1, 2, 0)[..., None]
            if noisy and xnoise is None:
                xnoise = self.model_noise_std * draws[..., T * A:].reshape(B, K, T, S)
            state = state._replace(calls=state.calls + 1)

        if use_fused and A == 1:
            with span("mppi.rollout"):
                planned_tm = state.planned_us[..., 0].T  # (T, B)
                us_tm = planned_tm[:, :, None].expand(T, B, K).reshape(T, N) + delta_tm
                x0_tm = xs.T[:, :, None].expand(S, B, K).reshape(S, N)
                roll = fused_rollout_costs_tm(model, x0_tm, us_tm, g_z).reshape(B, K)
            with span("mppi.update"):
                ctrl = self.lam * (us_tm * delta_tm).sum(dim=0).reshape(B, K) / self.std**2
                costs, w = _weights(roll + ctrl, self.lam, dim=1)
                upd = (w[None] * delta_tm.reshape(T, B, K)).sum(dim=-1).T
                planned = state.planned_us + upd[:, :, None]
        else:
            with span("mppi.rollout"):
                samples = state.planned_us[:, None] + delta  # (B, K, T, A)
                if noisy:
                    roll, _ = rollout_cost_noisy(model, xs[:, None], samples, g_z, xnoise)
                else:
                    roll, _ = rollout_cost(model, xs[:, None], samples, g_z)
            with span("mppi.update"):
                ctrl = self.lam * (samples * delta).sum(dim=(2, 3)) / self.std**2
                costs, w = _weights(roll + ctrl, self.lam, dim=1)
                planned = state.planned_us + (w[:, :, None, None] * delta).sum(dim=1)
        return state._replace(planned_us=planned), planned[:, 0], {"sample_costs": costs}

    def calls_model_kernels(self) -> bool:
        """A scalar action's ``solve_batch(use_fused=True)`` rolls out on
        kernel 2."""
        return self.model.action_size == 1

    def kernel_ok(self) -> bool:
        """True when the single-kernel step applies: scalar action, a
        quad_cost stage cost and no planning-model noise."""
        return (self.model.action_size == 1
                and hasattr(self.model.state_cost, "W")
                and self.model_noise_std == 0.0)

    def solve_batch_tm(self, planned_tm, xs_tm, g_z, seed: int):
        """One MPPI step for B scenarios as one ``fused_mppi_step``: plans
        (T, B), states (S, B), g_z (T, Z), an int32 seed to vary per step.
        Returns (new plans (T, B), unclipped first actions (B,))."""
        lanes = pick_lanes(planned_tm.shape[1])
        planned = fused_mppi_step(
            self.model, self.K, self.std, self.lam, lanes, planned_tm, xs_tm, g_z, seed)
        return planned, planned[0]
