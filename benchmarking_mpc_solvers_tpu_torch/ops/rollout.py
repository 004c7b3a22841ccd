"""Horizon rollout engine on batched tensors.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/rollout.py``. The JAX
package scans over the horizon and vmaps over samples and scenarios; here
samples and scenarios are leading tensor dimensions and the horizon is a
Python loop. ``x0`` (..., S) broadcasts against the leading dimensions of
``us`` (..., T, A); ``g_z`` is (T, Z) or (..., T, Z).

Cost convention: stage cost at the current (x, u) before the dynamics
step, total = Σ stage costs, no terminal cost.
"""

from __future__ import annotations

import torch

from ..models.base import Model


def _start(x0, us):
    lead = torch.broadcast_shapes(x0.shape[:-1], us.shape[:-2])
    return x0.expand(lead + x0.shape[-1:])


def rollout(model: Model, x0, us, g_z):
    """xs (..., T+1, S) including x0, and per-step costs (..., T)."""
    x = _start(x0, us)
    xs, costs = [x], []
    for t in range(us.shape[-2]):
        x, c = model.step_and_cost(x, us[..., t, :], g_z[..., t, :])
        xs.append(x)
        costs.append(c)
    return torch.stack(xs, dim=-2), torch.stack(costs, dim=-1)


def rollout_cost(model: Model, x0, us, g_z):
    """(total cost (...), last state (..., S)) without the trajectory."""
    x = _start(x0, us)
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for t in range(us.shape[-2]):
        x, c = model.step_and_cost(x, us[..., t, :], g_z[..., t, :])
        acc = acc + c
    return acc, x


def rollout_cost_noisy(model: Model, x0, us, g_z, xnoise):
    """``rollout_cost`` with additive per-step state noise xnoise (..., T, S)
    (the planning-model sensor noise of the noise sweeps)."""
    x = _start(x0, us)
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for t in range(us.shape[-2]):
        x, c = model.step_and_cost(x, us[..., t, :], g_z[..., t, :])
        x = x + xnoise[..., t, :]
        acc = acc + c
    return acc, x


def rollout_noisy(model: Model, x0, us, g_z, xnoise):
    """Trajectory counterpart of ``rollout_cost_noisy``."""
    x = _start(x0, us)
    xs, costs = [x], []
    for t in range(us.shape[-2]):
        x, c = model.step_and_cost(x, us[..., t, :], g_z[..., t, :])
        x = x + xnoise[..., t, :]
        xs.append(x)
        costs.append(c)
    return torch.stack(xs, dim=-2), torch.stack(costs, dim=-1)


def simulate_trajectory(model: Model, x0, us, g_z):
    """(xs, total_cost): the reference ``Agent.simulate_trajectory`` contract."""
    xs, costs = rollout(model, x0, us, g_z)
    return xs, costs.sum(dim=-1)


def simulate_trajectory_noisy(model: Model, x0, us, g_z, xnoise):
    """Noisy-planning-model variant of ``simulate_trajectory``."""
    xs, costs = rollout_noisy(model, x0, us, g_z, xnoise)
    return xs, costs.sum(dim=-1)


def best_plan_by_rollout_cost(model: Model, x, g_z, candidates):
    """The candidate plan (C, T, A) with the lowest rollout cost from x (S,);
    non-finite costs lose, ties go to the first."""
    _, cs = rollout(model, x, candidates, g_z)
    costs = cs.sum(dim=-1)
    costs = torch.where(torch.isfinite(costs), costs, torch.inf)
    return candidates[torch.argmin(costs)]
