"""CEM — Cross-Entropy Method MPC.

Counterpart of ``benchmarking_mpc_solvers_tpu/solvers/cem.py``:

- per call, std restarts from ``std`` while the plan mean persists;
- each iteration samples K sequences ~ N(mean, std), clips them to the
  bounds, scores them by rollout cost (non-finite -> 1e30) and keeps the
  n_elite cheapest;
- new = α·old + (1−α)·elite statistic, for mean and std;
- early exit once every std entry is below ε.

Tiers: ``solve`` (one scenario, the ε exit as a loop condition),
``solve_batch`` (B scenarios in lock-step for ``max_iter`` iterations with
per-scenario ``done`` masking, each iteration's B·K rollouts in one
``fused_rollout_costs_tm`` launch, elites by ``topk``, one-hot elite mean
and std) and ``solve_batch_tm`` (all iterations as one ``fused_cem_step``
launch, no ε exit). ``solve`` draws from the state's generator;
``solve_batch`` draws each scenario's noise from its own counter-based
stream (``scenario_normals``: its seed, its draw count, k, t), so a
scenario's noise does not depend on its batch slot. The parity tests inject
the reference's draws instead. ``solve_batch(use_fused=False)`` runs the
same lock-step iterations with the plain rollout in place of the kernel and
``solve``'s elite statistics, for any action size and with planning-model
noise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..ops.fused import fused_rollout_costs_tm
from ..ops.fused_cem import fused_cem_step
from ..ops.fused_mppi import pick_lanes, scenario_normals, scenario_seeds
from ..ops.rollout import rollout_cost, rollout_cost_noisy
from .base import Solver


class CEMState(NamedTuple):
    planned_us: torch.Tensor  # (T, A), or (B, T, A) on the batched tier
    generator: torch.Generator
    seeds: Optional[torch.Tensor] = None  # (B,) int64 noise seeds (batched tier)
    calls: Optional[torch.Tensor] = None  # (B,) int64 draws made per scenario


def _guard(costs):
    """Failure guard: a non-finite cost is infinitely bad, never elite."""
    return torch.where(torch.isfinite(costs), costs, torch.full_like(costs, 1e30))


@dataclasses.dataclass(frozen=True, eq=False)
class CEM(Solver):
    K: int = 50
    max_iter: int = 5
    n_elite: int = 10
    epsilon: float = 1e-2
    alpha: float = 0.2
    std: float = 1.0
    model_noise_std: float = 0.0  # planning-model noise

    def init_state(self, generator: torch.Generator, device="cuda") -> CEMState:
        device = resolve_device(device)
        planned = torch.zeros((self.T, self.model.action_size), dtype=torch.float32,
                              device=device)
        return CEMState(planned, generator)

    def solve(self, state: CEMState, x, g_z, noise=None, xnoise=None):
        """One CEM solve from state x (S,). ``noise`` (max_iter, K, T, A)
        standard normals and ``xnoise`` (max_iter, K, T, S) model noise
        replace the generator's draws when given."""
        model = self.model
        T, A = self.T, model.action_size
        dev = state.planned_us.device
        lo, hi = model.lo(dev), model.hi(dev)
        mean = state.planned_us
        std = torch.full((T, A), self.std, dtype=torch.float32, device=dev)
        i = 0
        while i < self.max_iter and not bool((std < self.epsilon).all()):
            d = noise[i] if noise is not None else torch.randn(
                (self.K, T, A), generator=state.generator, device=dev)
            samples = torch.clamp(mean[None] + std[None] * d, lo, hi)
            if self.model_noise_std > 0.0:
                xn = xnoise[i] if xnoise is not None else self.model_noise_std * torch.randn(
                    (self.K, T, model.state_size), generator=state.generator, device=dev)
                costs, _ = rollout_cost_noisy(model, x, samples, g_z, xn)
            else:
                costs, _ = rollout_cost(model, x, samples, g_z)
            elites = samples[torch.topk(-_guard(costs), self.n_elite).indices]
            new_mean = elites.mean(dim=0)
            new_std = torch.sqrt(((elites - new_mean) ** 2).mean(dim=0))
            mean = self.alpha * mean + (1.0 - self.alpha) * new_mean
            std = self.alpha * std + (1.0 - self.alpha) * new_std
            i += 1
        return state._replace(planned_us=mean), mean[0], {}

    # -- batched-scenario tiers ------------------------------------------------
    def init_state_batch(self, batch: int, generator: torch.Generator,
                         device="cuda") -> CEMState:
        """Zero (B, T, A) plans and one noise seed per scenario."""
        device = resolve_device(device)
        planned = torch.zeros((batch, self.T, self.model.action_size), dtype=torch.float32,
                              device=device)
        return CEMState(planned, generator, scenario_seeds(batch, generator, device),
                        torch.zeros((batch,), dtype=torch.int64, device=device))

    def solve_batch(self, state: CEMState, xs, g_z, use_fused: bool = True, noise=None,
                    xnoise=None):
        """One CEM solve for B scenarios xs (B, S), plans (B, T, A).

        All ``max_iter`` iterations run in lock-step; a scenario whose std
        is below ε everywhere keeps its mean and std (``done``). ``noise``
        (max_iter, B, K, T, A), or (max_iter, B, K, T) for a scalar action,
        injects standard normals; else iteration i of scenario b draws
        ``scenario_normals`` at draw count calls[b] + i.

        With ``use_fused`` (scalar actions only) the B·K rollouts of an
        iteration are one ``fused_rollout_costs_tm`` launch and the elite
        moments one-hot sums over K; the model is planned without noise, as
        the reference's batched tier plans it. Else the plain tier: the
        reference's per-scenario ``solve`` over the batch, for any action
        size, with the elites' mean and std per (t, a) and, when
        ``model_noise_std > 0``, planning-model state noise (B, K, T, S),
        already scaled, drawn once per iteration and added after every model
        step. ``xnoise`` (max_iter, B, K, T, S) injects it; else it comes
        from the iteration's draw of the scenario's stream at timestep
        indices T·A onwards, which the samples never use. The fused tier
        refuses an injected ``xnoise``."""
        model = self.model
        if use_fused and model.action_size != 1:
            raise NotImplementedError("CEM.solve_batch(use_fused=True) supports action_size == 1; "
                                      "pass use_fused=False for larger actions")
        if use_fused and xnoise is not None:
            raise ValueError("solve_batch: the fused tier plans without model noise; "
                             "pass xnoise with use_fused=False")
        B, S = xs.shape
        K, T, A = self.K, self.T, model.action_size
        noisy = not use_fused and self.model_noise_std > 0.0
        draw_x = noisy and xnoise is None
        if state.seeds is None and (noise is None or draw_x):
            raise ValueError("solve_batch needs per-scenario seeds: make the state "
                             "with init_state_batch")
        width = T * (A + S) if draw_x else T * A
        mean = state.planned_us  # (B, T, A)
        std = torch.full((B, T, A), self.std, dtype=torch.float32, device=xs.device)
        done = torch.zeros((B,), dtype=torch.bool, device=xs.device)
        if use_fused:
            x0_tm = xs.T[:, :, None].expand(S, B, K).reshape(S, B * K)
        else:
            box = (model.lo(xs.device), model.hi(xs.device))
        for i in range(self.max_iter):
            draws = None
            if noise is None or draw_x:
                draws = scenario_normals(state.seeds, state.calls + i, K, width)  # (B, K, width)
            d = (noise[i] if noise is not None else draws[..., :T * A]).reshape(B, K, T, A)
            if use_fused:
                e_mean, e_std = self._fused_iteration(model, x0_tm, g_z, mean[..., 0],
                                                      std[..., 0], d[..., 0])
                e_mean, e_std = e_mean[..., None], e_std[..., None]
            else:
                xn = None
                if noisy:
                    xn = xnoise[i] if xnoise is not None else (
                        self.model_noise_std * draws[..., T * A:].reshape(B, K, T, S))
                e_mean, e_std = self._plain_iteration(model, xs, g_z, box, mean, std, d, xn)
            new_mean = self.alpha * mean + (1.0 - self.alpha) * e_mean
            new_std = self.alpha * std + (1.0 - self.alpha) * e_std
            mean = torch.where(done[:, None, None], mean, new_mean)
            std = torch.where(done[:, None, None], std, new_std)
            done = done | (std < self.epsilon).flatten(1).all(dim=1)
        calls = None if state.calls is None else state.calls + self.max_iter
        return state._replace(planned_us=mean, calls=calls), mean[:, 0], {}

    def _fused_iteration(self, model, x0_tm, g_z, mean, std, d):
        """Elite mean and std (B, T) of one iteration of the fused tier from
        starts x0_tm (S, B·K): samples time-major (T, B, K), as the kernel
        reads them, and one-hot moments over K."""
        B, T = mean.shape
        K = self.K
        N = B * K
        lo, hi = float(model.bounds_low[0]), float(model.bounds_high[0])
        samples_tm = torch.clamp(mean.T[:, :, None] + std.T[:, :, None] * d.permute(2, 0, 1),
                                 lo, hi).contiguous()  # (T, B, K)
        costs = _guard(fused_rollout_costs_tm(model, x0_tm, samples_tm.reshape(T, N), g_z)
                       .reshape(B, K))
        elite = torch.topk(-costs, self.n_elite, dim=1).indices  # (B, n_elite)
        mask = torch.zeros((B, K), dtype=torch.float32, device=mean.device).scatter(
            1, elite, 1.0 / self.n_elite)
        e_mean = (mask[None] * samples_tm).sum(dim=-1).T
        e_sq = (mask[None] * samples_tm**2).sum(dim=-1).T
        return e_mean, torch.sqrt(torch.clamp(e_sq - e_mean**2, min=0.0))

    def _plain_iteration(self, model, xs, g_z, box, mean, std, d, xn):
        """Elite mean and std (B, T, A) of one iteration of the plain tier,
        as ``solve`` takes them: samples clipped to ``box`` (lo, hi), state
        noise ``xn`` (B, K, T, S) or None."""
        samples = torch.clamp(mean[:, None] + std[:, None] * d, *box)
        if xn is None:
            costs, _ = rollout_cost(model, xs[:, None], samples, g_z)
        else:
            costs, _ = rollout_cost_noisy(model, xs[:, None], samples, g_z, xn)
        elite = torch.topk(-_guard(costs), self.n_elite, dim=1).indices  # (B, n_elite)
        elites = samples[torch.arange(xs.shape[0], device=xs.device)[:, None], elite]
        e_mean = elites.mean(dim=1)
        return e_mean, torch.sqrt(((elites - e_mean[:, None]) ** 2).mean(dim=1))

    # -- single-kernel tier ------------------------------------------------------
    def kernel_ok(self) -> bool:
        """True when the single-kernel step applies: scalar action, a
        quad_cost stage cost and no planning-model noise."""
        return (self.model.action_size == 1
                and hasattr(self.model.state_cost, "W")
                and self.model_noise_std == 0.0)

    def solve_batch_tm(self, planned_tm, xs_tm, g_z, seed: int):
        """One full CEM refinement for B scenarios as one ``fused_cem_step``:
        plans (T, B), states (S, B), g_z (T, Z), an int32 seed to vary per
        call. Returns (new plan means (T, B), unclipped first actions (B,))."""
        lanes = pick_lanes(planned_tm.shape[1])
        planned = fused_cem_step(self.model, self.K, self.n_elite, self.max_iter, self.alpha,
                                 self.std, lanes, planned_tm, xs_tm, g_z, seed)
        return planned, planned[0]
