"""Closed-loop episode runners: solver + plant, stepped on the device.

Counterpart of ``benchmarking_mpc_solvers_tpu/experiment/episode.py``. The
JAX package compiles an episode into one ``lax.scan``; here the episode is a
Python loop over MPC steps whose work per step is batched tensors and, on
the kernel tier, one kernel launch. Scenario batches are a leading
dimension, not a vmap.

Recorded history (the reference result schema): observations, true states
(with x0), actuated and commanded actions, plant costs, done flags, and with
``record_plans`` the per-step plans, their simulated states and costs, and
the warm-start plans.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import default_generator, resolve_device
from ..envs.env import Env, NoiseConfig, env_step
from ..ops.rollout import simulate_trajectory
from ..solvers.base import Solver, predict_action, shift_plan, warm_start


class EpisodeResult(NamedTuple):
    observations: torch.Tensor  # ([B,] N, S) post-step observed states
    true_states: torch.Tensor  # ([B,] N+1, S) plant states incl. x0
    actions: torch.Tensor  # ([B,] N, A) actuated (noise-injected) actions
    true_actions: torch.Tensor  # ([B,] N, A) commanded actions
    costs: torch.Tensor  # ([B,] N) plant stage costs
    dones: torch.Tensor  # ([B,] N) termination predicate per step
    planned_states: Optional[torch.Tensor]  # ([B,] N, T+1, S) per-step plans
    planned_actions: Optional[torch.Tensor]  # ([B,] N, T, A)
    planned_costs: Optional[torch.Tensor]  # ([B,] N)
    warmstart_trajectories: Optional[torch.Tensor]  # ([B,] W, T, A)

    @property
    def total_cost(self):
        return self.costs.sum(dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class EpisodeConfig:
    n_steps: int = 100  # reference experiment_length
    warmstart: int = 0  # solver iterations before the episode
    noise: NoiseConfig = NoiseConfig()
    record_plans: bool = True  # reference agent logging
    goal_state: Optional[tuple] = None  # defaults to zeros(S+A)


def _goal(cfg: EpisodeConfig, solver: Solver, device) -> torch.Tensor:
    """(T, Z) goal features, contiguous (the kernels take it as is)."""
    Z = solver.model.goal_size
    if cfg.goal_state is None:
        return torch.zeros((solver.T, Z), dtype=torch.float32, device=device)
    return solver.goal_traj(cfg.goal_state, device)


def _stack(recs, batch_first: bool):
    """Per-step records -> stacked tensors; (N, B, ...) -> (B, N, ...)."""
    out = []
    for field in zip(*recs):
        if field[0] is None:
            out.append(None)
            continue
        t = torch.stack(field)
        out.append(t.transpose(0, 1) if batch_first else t)
    return out


def _result(x0, recs, ws, batch_first: bool) -> EpisodeResult:
    obs, true_states, actions, true_actions, costs, dones, pxs, pus, pcs = _stack(
        recs, batch_first)
    x0 = x0[:, None] if batch_first else x0[None]
    return EpisodeResult(
        observations=obs,
        true_states=torch.cat([x0, true_states], dim=1 if batch_first else 0),
        actions=actions,
        true_actions=true_actions,
        costs=costs,
        dones=dones,
        planned_states=pxs,
        planned_actions=pus,
        planned_costs=pcs,
        warmstart_trajectories=ws,
    )


def run_episode(env: Env, solver: Solver, cfg: EpisodeConfig, x0=None,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> EpisodeResult:
    """One closed-loop episode through ``solver.solve`` (per-scenario tier)."""
    device = resolve_device(device)
    gen = default_generator(generator, device)
    x0 = env.start_state(device) if x0 is None else torch.as_tensor(
        x0, dtype=torch.float32, device=device)
    g_z = _goal(cfg, solver, device)
    sstate = solver.init_state(gen, device)
    ws = None
    if cfg.warmstart > 0:
        sstate, ws = warm_start(solver, sstate, x0, g_z, cfg.warmstart)
    x_true = obs = x0
    recs = []
    for _ in range(cfg.n_steps):
        out = predict_action(solver, sstate, obs, g_z, shift=cfg.record_plans)
        es = env_step(env, x_true, out.action, cfg.noise, gen)
        plans = ((out.planned_xs, out.planned_us, out.planned_cost)
                 if cfg.record_plans else (None, None, None))
        recs.append((es.observation, es.true_state, es.action, es.true_action,
                     es.cost, es.done) + plans)
        sstate, x_true, obs = out.state, es.true_state, es.observation
    return _result(x0, recs, ws, batch_first=False)


def _run_episodes_two_stage(env: Env, solver, cfg: EpisodeConfig, x0s, gen,
                            use_fused: bool) -> EpisodeResult:
    """B episodes through ``solver.solve_batch``, with the agent layer's
    clip / log / shift semantics written out over the batch."""
    model = env.model
    device = x0s.device
    g_z = _goal(cfg, solver, device)
    sstates = solver.init_state_batch(x0s.shape[0], gen, device)

    ws = None
    if cfg.warmstart > 0:
        trajs = []
        for _ in range(cfg.warmstart):
            sstates, _, _ = solver.solve_batch(sstates, x0s, g_z, use_fused=use_fused)
            sstates = sstates._replace(planned_us=model.clip_action(sstates.planned_us))
            trajs.append(sstates.planned_us)
        if cfg.record_plans:
            ws = torch.stack(trajs, dim=1)  # (B, W, T, A)

    x_true = obs = x0s
    recs = []
    for _ in range(cfg.n_steps):
        sstates, u0s, _ = solver.solve_batch(sstates, obs, g_z, use_fused=use_fused)
        planned = model.clip_action(sstates.planned_us)
        if cfg.record_plans:
            pxs, pcs = simulate_trajectory(model, obs, planned, g_z)
            sstates = sstates._replace(planned_us=shift_plan(planned))
            plans = (pxs, planned, pcs)
        else:
            sstates = sstates._replace(planned_us=planned)
            plans = (None, None, None)
        es = env_step(env, x_true, model.clip_action(u0s), cfg.noise, gen)
        recs.append((es.observation, es.true_state, es.action, es.true_action,
                     es.cost, es.done) + plans)
        x_true, obs = es.true_state, es.observation
    return _result(x0s, recs, ws, batch_first=True)


def run_episodes_batch(env: Env, solver, cfg: EpisodeConfig, x0s,
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> EpisodeResult:
    """B scenarios x0s (B, S) through the plain batched solve (no kernels)."""
    device = resolve_device(device)
    x0s = torch.as_tensor(x0s, dtype=torch.float32, device=device)
    return _run_episodes_two_stage(env, solver, cfg, x0s,
                                   default_generator(generator, device), use_fused=False)


def run_episodes_fused(env: Env, solver, cfg: EpisodeConfig, x0s,
                       generator: Optional[torch.Generator] = None,
                       use_kernel: bool = True, seeds=None,
                       device="cuda") -> EpisodeResult:
    """Batched closed-loop episodes on the fused tiers (the bench path).

    With ``use_kernel`` and a solver whose ``kernel_ok()`` holds, every MPC
    step is one ``solve_batch_tm`` launch (``_run_episodes_kernel``; ``seeds``
    are its per-call noise seeds). Otherwise the two-stage tier runs, its
    B·K rollouts per step in one ``fused_rollout_costs_tm`` launch."""
    device = resolve_device(device)
    x0s = torch.as_tensor(x0s, dtype=torch.float32, device=device)
    gen = default_generator(generator, device)
    if use_kernel and getattr(solver, "kernel_ok", None) and solver.kernel_ok():
        return _run_episodes_kernel(env, solver, cfg, x0s, seeds=seeds, generator=gen,
                                    device=device)
    return _run_episodes_two_stage(env, solver, cfg, x0s, gen, use_fused=True)


def _run_episodes_kernel(env: Env, solver, cfg: EpisodeConfig, x0s, seeds=None,
                         generator: Optional[torch.Generator] = None,
                         device="cuda") -> EpisodeResult:
    """Single-kernel episode tier: one ``solve_batch_tm`` per solver call,
    the plan carried time-major (T, B).

    ``seeds`` holds one int32 per solver call (warm-start iterations, then
    episode steps), as the reference derives them from its keys; without it
    they are drawn from ``generator`` over [-2**31, 2**31 - 1)."""
    device = resolve_device(device)
    x0s = torch.as_tensor(x0s, dtype=torch.float32, device=device)
    gen = default_generator(generator, device)
    model = env.model
    B = x0s.shape[0]
    n_calls = cfg.warmstart + cfg.n_steps
    if seeds is None:
        seeds = torch.randint(-(2**31), 2**31 - 1, (n_calls,), generator=gen,
                              device=device, dtype=torch.int64)
    if torch.is_tensor(seeds):
        seeds = seeds.cpu()
    seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
    if len(seeds) != n_calls:
        raise ValueError(f"need {n_calls} seeds (warmstart + n_steps), got {len(seeds)}")
    g_z = _goal(cfg, solver, device)
    lo, hi = float(model.bounds_low[0]), float(model.bounds_high[0])

    planned_tm = torch.zeros((solver.T, B), dtype=torch.float32, device=device)
    x0s_tm = x0s.T.contiguous()
    ws = []
    for seed in seeds[: cfg.warmstart]:
        planned_tm, _ = solver.solve_batch_tm(planned_tm, x0s_tm, g_z, seed)
        planned_tm = torch.clamp(planned_tm, lo, hi)
        ws.append(planned_tm.T[..., None])

    x_true = obs = x0s
    recs = []
    for seed in seeds[cfg.warmstart:]:
        planned_tm, u0s = solver.solve_batch_tm(planned_tm, obs.T.contiguous(), g_z, seed)
        planned_tm = torch.clamp(planned_tm, lo, hi)
        if cfg.record_plans:
            planned = planned_tm.T[..., None]  # (B, T, 1)
            pxs, pcs = simulate_trajectory(model, obs, planned, g_z)
            plans = (pxs, planned, pcs)
            planned_next = torch.roll(planned_tm, -1, dims=0)
            planned_next[-1] = 0.0
        else:
            plans = (None, None, None)
            planned_next = planned_tm
        actions = torch.clamp(u0s, lo, hi)[:, None]  # (B, A=1)
        es = env_step(env, x_true, actions, cfg.noise, gen)
        recs.append((es.observation, es.true_state, es.action, es.true_action,
                     es.cost, es.done) + plans)
        planned_tm, x_true, obs = planned_next, es.true_state, es.observation
    ws = torch.stack(ws, dim=1) if (ws and cfg.record_plans) else None
    return _result(x0s, recs, ws, batch_first=True)
