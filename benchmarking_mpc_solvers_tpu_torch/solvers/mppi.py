"""MPPI — Model-Predictive Path Integral control.

Counterpart of ``benchmarking_mpc_solvers_tpu/solvers/mppi.py``:

- per-sample cost = Σ_t stage_cost(x_t, u_t) + λ uₜ·δuₜ / std², u = plan + δ;
- non-finite costs score 1e30; softmax weights w ∝ exp(−(c−β)/λ), β = min;
- plan += Σ_k w_k δu_k; rollout actions are not clipped (models clip);
- ``resample=False`` reuses the δu drawn at init (the reference's quirk).

Three tiers: ``solve`` (one scenario), ``solve_batch`` (B scenarios, through
the fused rollout kernel ``ops/fused.py``) and ``solve_batch_tm`` (the whole
step as one kernel, ``ops/fused_mppi.py``). Perturbations come from the
state's ``torch.Generator`` (the kernel tier draws its own counter-based
noise from a seed), or are injected by the caller, as the parity tests do
with the reference's draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..ops.fused import fused_rollout_costs_tm
from ..ops.fused_mppi import fused_mppi_step, pick_lanes
from ..ops.rollout import rollout_cost, rollout_cost_noisy
from .base import Solver


class MPPIState(NamedTuple):
    planned_us: torch.Tensor  # (T, A), or (B, T, A) on the batched tier
    delta_u: torch.Tensor  # (K, T, A) fixed perturbations (resample=False)
    generator: torch.Generator


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
        """Zero (B, T, A) plans; the delta placeholder is (B, 1, 1, 1) (the
        sample-once mode stays on the per-scenario tier)."""
        device = resolve_device(device)
        planned = torch.zeros((batch, self.T, self.model.action_size),
                              dtype=torch.float32, device=device)
        return MPPIState(planned, planned.new_zeros((batch, 1, 1, 1)), generator)

    def solve_batch(self, state: MPPIState, xs, g_z, use_fused: bool = True,
                    delta_tm=None):
        """One MPPI step for B scenarios, xs (B, S), plans (B, T, A).

        Perturbations are time-major (T, B·K), column b·K + k, std-scaled:
        ``delta_tm`` injects them (action_size == 1), else they are drawn from
        the state's generator. With ``use_fused`` (and a scalar action) the
        B·K rollouts go through ``fused_rollout_costs_tm``, else through the
        plain batched rollout; both apply the same update law."""
        model = self.model
        B, S = xs.shape
        K, T, A = self.K, self.T, model.action_size
        N = B * K
        if delta_tm is None:
            delta = self.std * torch.randn(
                (B, K, T, A), generator=state.generator, device=xs.device)
            if A == 1:
                delta_tm = delta[..., 0].permute(2, 0, 1).reshape(T, N)
        else:
            delta = delta_tm.reshape(T, B, K).permute(1, 2, 0)[..., None]

        if use_fused and A == 1:
            planned_tm = state.planned_us[..., 0].T  # (T, B)
            us_tm = planned_tm[:, :, None].expand(T, B, K).reshape(T, N) + delta_tm
            x0_tm = xs.T[:, :, None].expand(S, B, K).reshape(S, N)
            roll = fused_rollout_costs_tm(model, x0_tm, us_tm, g_z).reshape(B, K)
            ctrl = self.lam * (us_tm * delta_tm).sum(dim=0).reshape(B, K) / self.std**2
            costs, w = _weights(roll + ctrl, self.lam, dim=1)
            upd = torch.einsum("bk,tbk->bt", w, delta_tm.reshape(T, B, K))
            planned = state.planned_us + upd[:, :, None]
        else:
            samples = state.planned_us[:, None] + delta  # (B, K, T, A)
            roll, _ = rollout_cost(model, xs[:, None], samples, g_z)
            ctrl = self.lam * torch.einsum("bkta,bkta->bk", samples, delta) / self.std**2
            costs, w = _weights(roll + ctrl, self.lam, dim=1)
            planned = state.planned_us + torch.einsum("bk,bkta->bta", w, delta)
        return state._replace(planned_us=planned), planned[:, 0], {"sample_costs": costs}

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
