"""MPPI in plain PyTorch, on the two tiers the program's episode runner picks.

Per sample k: u = plan + std·δ_k, its cost the sum over the horizon of the
stage cost plus λ·u·δ/std², a non-finite cost scoring 1e30; weights
softmax(−(c − min c)/λ) over the samples; the plan moves by Σ_k w_k·std·δ_k.

- Single-kernel tier (no planning-model noise): δ from the per-call seed's
  stream (``noise.normals``), the weights' total and the update summed in
  kernel 1's order (``lane_tree``).
- Two-stage tier (``model_noise_std`` > 0: the program then plans with a
  clean model, as the reference suite's batched tiers do): δ from each
  scenario's own stream (``noise.scenario_normals``), whose seeds the plant
  generator gives first, one draw a step; the whole batch in the program's
  time-major layouts.

The closed loop is chaotic at these widths: with λ = 1 the weights follow
cost differences of tens, and one rounding's difference in a step's update
grows to actions at opposite bounds within the ten steps (measured on the
card). So the reference sums in the program's order, which is arithmetic
and not state: it still works everything out again from the inputs. With
``order="witness"`` it sums over the samples in plain k order instead: a
sound witness of what another summation order reads.
"""

from __future__ import annotations

import numpy as np
import torch

from . import noise
from .loop import Episodes, PlantNoise, closed_loop

LANES = 32  # kernel 1's lanes a scenario: a warp


def lane_tree(x, K: int):
    """Σ over k of x (K, ...) in kernel 1's order: lane l sums k = l, l + 32,
    ... from 0 in k order, then the 32 lanes' sums meet in a butterfly
    (each lane adds the partner's sum at distances 16, 8, 4, 2, 1)."""
    lanes = torch.zeros((LANES,) + x.shape[1:], dtype=x.dtype, device=x.device)
    for k in range(K):
        lanes[k % LANES] = lanes[k % LANES] + x[k]
    idx = torch.arange(LANES, device=x.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ o]
    return lanes[0]


def k_order(x, K: int):
    """Σ over k of x (K, ...) from k = 0 up, one term at a time."""
    total = x[0]
    for k in range(1, K):
        total = total + x[k]
    return total


def kernel_step(plant, K, T, std, lam, plan, x, seed, layout, dt, order="program"):
    """One single-kernel MPPI step for n scenarios: plan (T, n), x (n, S)."""
    pid, i1, i2 = layout
    n, S = x.shape
    seed_c = noise.combined_seeds(seed, K, pid)
    ctrl_scale = float(np.float32(lam * (1.0 / (std * std))))
    xk = x.expand(K, n, S)
    acc = torch.zeros((K, n), dtype=dt, device=x.device)
    sds = []
    for t in range(T):
        sd = std * noise.normals(seed_c, t, i1, i2, dt)
        sds.append(sd)
        u = (plan[t] + sd)[..., None]
        c = plant.stage_cost(xk, u) + ctrl_scale * (u[..., 0] * sd)
        xk = plant.dynamics(xk, u)
        acc = acc + c
    costs = torch.where(torch.isfinite(acc), acc, torch.full_like(acc, 1e30))
    w = torch.exp(-(costs - costs.min(dim=0).values) / lam)
    ksum = lane_tree if order == "program" else k_order
    w = w / ksum(w, K)
    sds = torch.stack(sds, dim=1)  # (K, T, n)
    out = plan + ksum(w[:, None] * sds, K)
    return out, out[0]


def two_stage_step(plant, K, T, std, lam, plan, x, seeds, calls, dt, order="program"):
    """One two-stage MPPI step for all B scenarios, in the program's layouts
    (its reductions' order follows from them): plan (B, T), x (B, S)."""
    B, S = x.shape
    N = B * K
    delta = std * noise.scenario_normals(seeds, calls, K, T, dt)  # (B, K, T)
    delta_tm = delta.permute(2, 0, 1).reshape(T, N)
    us_tm = plan.T[:, :, None].expand(T, B, K).reshape(T, N) + delta_tm
    xk = x.T[:, :, None].expand(S, B, K).reshape(S, N).T
    acc = torch.zeros((N,), dtype=dt, device=x.device)
    for t in range(T):
        u = us_tm[t][:, None]
        acc = acc + plant.stage_cost(xk, u)
        xk = plant.dynamics(xk, u)
    ctrl = lam * (us_tm * delta_tm).sum(dim=0).reshape(B, K) / std**2
    costs = acc.reshape(B, K) + ctrl
    costs = torch.where(torch.isfinite(costs), costs, torch.full_like(costs, 1e30))
    beta = costs.min(dim=1, keepdim=True).values
    if order == "program":
        w = torch.softmax(-(costs - beta) / lam, dim=1)
        out = plan + (w[None] * delta_tm.reshape(T, B, K)).sum(dim=-1).T
    else:
        e = torch.exp(-(costs - beta) / lam).T  # (K, B)
        w = e / k_order(e, K)
        out = plan + k_order(w[:, :, None] * delta_tm.reshape(T, B, K).permute(2, 1, 0), K)
    return out, out[:, 0]


def episodes(plant, solver: dict, traffic: dict, inputs, idx, dt=torch.float32,
             order="program"):
    """The episodes of scenarios ``idx`` of one batch (``inputs``: the
    batch's x0s, per-call seeds and plant seed, as the benchmark made them)."""
    K, T, std, lam = solver["K"], solver["T"], solver["std"], solver["lam"]
    B, dev = traffic["batch"], inputs.x0s.device
    idx_t = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    x0s = inputs.x0s[idx_t]
    sensor = traffic.get("sensor_std", 0.0)
    if traffic.get("model_noise_std", 0.0) == 0.0:
        layout = noise.noise_layout(B, idx_t, dev)
        plant_noise = PlantNoise(inputs.plant_seed, B, plant.S, idx_t, dev)

        def solve(step, plan, obs):
            return kernel_step(plant, K, T, std, lam, plan, obs, inputs.call_seeds[step],
                               layout, dt, order)
        init = torch.zeros((T, len(idx)), dtype=dt, device=dev)
    else:  # the whole batch: its reductions' order depends on the shapes
        everyone = torch.arange(B, device=dev)
        plant_noise = PlantNoise(
            inputs.plant_seed, B, plant.S, everyone, dev,
            pre_draws=lambda g: torch.randint(0, 2**63 - 1, (B,), generator=g,
                                              dtype=torch.int64, device=g.device))
        seeds = plant_noise.start

        def solve(step, plan, obs):
            calls = torch.full_like(seeds, step)
            return two_stage_step(plant, K, T, std, lam, plan, obs, seeds, calls, dt, order)
        init = torch.zeros((B, T), dtype=dt, device=dev)
        ep = closed_loop(plant, inputs.x0s, traffic["steps"], solve, init, sensor,
                         plant_noise, dt)
        return Episodes(*(f[idx_t] for f in ep))
    return closed_loop(plant, x0s, traffic["steps"], solve, init, sensor, plant_noise, dt)
