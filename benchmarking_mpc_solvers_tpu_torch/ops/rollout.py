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


def _sum_in_order(costs):
    """Σ_t costs[..., t] added in t order from 0, as ``rollout_cost`` and the
    line search sum: iLQR compares a plan's total with its candidates' (a
    repeated trajectory must score exactly the same), and XLA sums a short
    horizon in this order too."""
    total = torch.zeros_like(costs[..., 0])
    for t in range(costs.shape[-1]):
        total = total + costs[..., t]
    return total


def simulate_trajectory(model: Model, x0, us, g_z):
    """(xs, total_cost): the reference ``Agent.simulate_trajectory`` contract."""
    xs, costs = rollout(model, x0, us, g_z)
    return xs, _sum_in_order(costs)


def simulate_trajectory_noisy(model: Model, x0, us, g_z, xnoise):
    """Noisy-planning-model variant of ``simulate_trajectory``."""
    xs, costs = rollout_noisy(model, x0, us, g_z, xnoise)
    return xs, _sum_in_order(costs)


def best_plan_by_rollout_cost(model: Model, x, g_z, candidates):
    """The candidate plan with the lowest rollout cost; non-finite costs
    lose, ties go to the first. Either candidates (C, T, A) from one state x
    (S,), giving (T, A); or, per scenario, candidates (B, C, T, A) from x
    (B, S), giving (B, T, A), with g_z (T, Z) or (B, 1, T, Z)."""
    batched = candidates.ndim == 4
    _, cs = rollout(model, x[:, None] if batched else x, candidates, g_z)
    costs = cs.sum(dim=-1)
    costs = torch.where(torch.isfinite(costs), costs, torch.inf)
    best = torch.argmin(costs, dim=-1)  # the first minimum
    if batched:
        return candidates[torch.arange(candidates.shape[0], device=best.device), best]
    return candidates[best]
