"""CEM in plain PyTorch, on the single-kernel tier the program's episode
runner picks without planning-model noise.

Per call the std restarts at ``std`` and the plan mean persists. Each of
``max_iter`` iterations draws K samples clip(mean + std·δ, lo, hi) from the
per-call seed's stream (the iteration adds 15485863 to the seed), scores
them by their summed stage costs (non-finite -> 1e30), marks the n_elite
cheapest by rounds of masked minima (every tied candidate marked, weights
1/count), and smooths mean and std by α toward the elites' moments, summed
in k order, the program's, or with ``order="witness"`` from k = K − 1 down:
a sound witness of another summation order. There is no early exit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import noise
from .loop import PlantNoise, closed_loop


def kernel_step(plant, K, T, n_elite, max_iter, alpha, std0, plan, x, seed, layout, dt,
                order="program"):
    """One single-kernel CEM solve for n scenarios: plan (T, n), x (n, S)."""
    pid, i1, i2 = layout
    n, S = x.shape
    a = float(np.float32(alpha))
    one_minus_a = float(np.float32(1.0) - np.float32(alpha))
    excl = float(np.float32(4.0 * T * 1e30))
    mean = plan.clone()
    std = torch.full_like(mean, float(np.float32(std0)))
    for it in range(max_iter):
        seed_c = noise.combined_seeds(int(seed) + it * noise.IT_STRIDE, K, pid)
        xk = x.expand(K, n, S)
        acc = torch.zeros((K, n), dtype=dt, device=x.device)
        samples = []
        for t in range(T):
            u = torch.clamp(mean[t] + std[t] * noise.normals(seed_c, t, i1, i2, dt),
                            plant.LO, plant.HI)
            samples.append(u)
            acc = acc + plant.stage_cost(xk, u[..., None])
            xk = plant.dynamics(xk, u[..., None])
        costs = torch.where(torch.isfinite(acc), acc, torch.full_like(acc, 1e30))
        sel = torch.zeros_like(costs)
        for _ in range(n_elite):
            cur = costs + sel * excl
            is_new = (cur == cur.min(dim=0).values) & (sel < 0.5)
            sel = torch.where(is_new, torch.ones_like(sel), sel)
        w = sel / torch.clamp(sel.sum(dim=0), min=1.0)
        u = torch.stack(samples)  # (T, K, n)
        m1 = torch.zeros_like(mean)
        m2 = torch.zeros_like(mean)
        for k in (range(K) if order == "program" else reversed(range(K))):
            m1 = m1 + w[k] * u[:, k]
            m2 = m2 + w[k] * (u[:, k] * u[:, k])
        e_std = torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0))
        mean = a * mean + one_minus_a * m1
        std = a * std + one_minus_a * e_std
    return mean, mean[0]


def episodes(plant, solver: dict, traffic: dict, inputs, idx, dt=torch.float32,
             order="program"):
    """The episodes of scenarios ``idx`` of one batch (``inputs``: the
    batch's x0s, per-call seeds and plant seed, as the benchmark made them)."""
    if traffic.get("model_noise_std", 0.0) != 0.0:
        raise NotImplementedError("the CEM reference covers the single-kernel tier")
    K, T = solver["K"], solver["T"]
    B, dev = traffic["batch"], inputs.x0s.device
    idx_t = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    layout = noise.noise_layout(B, idx_t, dev)
    plant_noise = PlantNoise(inputs.plant_seed, B, plant.S, idx_t, dev)

    def solve(step, plan, obs):
        return kernel_step(plant, K, T, solver["n_elite"], solver["max_iter"], solver["alpha"],
                           solver["std"], plan, obs, inputs.call_seeds[step], layout, dt,
                           order)
    init = torch.zeros((T, len(idx)), dtype=dt, device=dev)
    return closed_loop(plant, inputs.x0s[idx_t], traffic["steps"], solve, init,
                       traffic.get("sensor_std", 0.0), plant_noise, dt)
