"""Per-stage profile and episode throughput of CEM at configuration 5
(cart-pole, T=50, K=64, n_elite=8, 3 iterations, B=10,240).

Counterpart of ``scripts/profile_cem.py``, with its stage and record keys:

1. the stages of one refinement iteration of ``CEM.solve_batch`` on the
   card: the per-scenario noise draw (``scenario_normals``), the draw and
   the rollout scoring through kernel 2 (``fused_rollout_costs_tm``), top-k
   with the elite mask, and the elite moments; each a chained paired
   difference (``utils.device_step_latency``) with its resolution;
2. whole-batch episode throughput (10 steps, no warm start) of the plain
   batched tier (``run_episodes_batch``, the reference's vmapped scalar
   solves), the two-stage tier (``run_episodes_fused(use_kernel=False)``:
   kernel 2) and the kernel tier (kernel 3), the least wall time of a few
   episodes.

Writes ``<results-dir>/measure/profile_cem.json``.
"""

from __future__ import annotations

import json
import time

import torch

from ..device import resolve_device
from ..envs import CartPoleSwingUpEnv
from ..experiment.episode import EpisodeConfig, run_episodes_batch, run_episodes_fused
from ..ops.fused import fused_rollout_costs_tm
from ..ops.fused_mppi import scenario_normals
from ..solvers import CEM
from ._common import (
    chain_options, device_record, measure_parser, perturbations, stage_timer, write_measure)


def run(args) -> dict:
    device = resolve_device(args.device)
    q = args.quick
    env = CartPoleSwingUpEnv
    model = env.model
    T, K, n_elite, iters = (5, 8, 2, 1) if q else (50, 64, 8, 3)
    B = 16 if q else 10240
    n_steps = 2 if q else 10
    samples = args.samples or (2 if q else 10)
    solver = CEM(model=model, T=T, K=K, n_elite=n_elite, max_iter=iters)
    g_z = torch.zeros((T, model.goal_size), device=device)
    x0s = env.start_state(device).expand(B, -1).contiguous()
    S = model.state_size

    out = {"config": f"cartpole CEM T={T} K={K} n_elite={n_elite} max_iter={iters} B={B}",
           "device": device_record(device)}

    # --- stage profile of one refinement iteration (solve_batch's body) ---
    stages = {}
    timed = stage_timer(stages, device, samples, chain_options(args))
    N = B * K
    x0_tm = x0s.T[:, :, None].expand(S, B, K).reshape(S, N).contiguous()
    mean0 = torch.zeros((B, T), device=device)
    std0 = torch.ones((B, T), device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = solver.init_state_batch(B, gen, device)
    calls = [state.calls + i for i in range(8)]  # each step its own draw
    lo, hi = float(model.bounds_low[0]), float(model.bounds_high[0])

    def draw(c):
        return scenario_normals(state.seeds, c, K, T)  # (B, K, T)

    def samples_tm(c):
        return torch.clamp(mean0.T[:, :, None] + std0.T[:, :, None] * draw(c).permute(2, 0, 1),
                           lo, hi).contiguous()  # (T, B, K)

    timed("noise_draw", lambda c: torch.sum(draw(c)), calls, max_hi=40 if q else 800)
    timed("noise+fused_rollout_score",
          lambda c: torch.sum(fused_rollout_costs_tm(model, x0_tm, samples_tm(c).reshape(T, N),
                                                     g_z)),
          calls, max_hi=40 if q else 400)

    us0 = samples_tm(calls[0])
    costs0 = fused_rollout_costs_tm(model, x0_tm, us0.reshape(T, N), g_z).reshape(B, K)
    jitter = perturbations((B, K), device)

    def elite_mask(costs):
        elite = torch.topk(-costs, n_elite, dim=1).indices
        return torch.zeros((B, K), device=device).scatter(1, elite, 1.0 / n_elite)

    timed("topk+elite_mask", lambda j: torch.sum(elite_mask(costs0 + j) * (costs0 + j)),
          jitter, max_hi=40 if q else 2000)

    def moments(j):
        mask = elite_mask(costs0 + j)
        e_mean = (mask[None] * us0).sum(dim=-1).T
        e_sq = (mask[None] * us0**2).sum(dim=-1).T
        return torch.sum(torch.sqrt(torch.clamp(e_sq - e_mean**2, min=0.0))) + torch.sum(e_mean)

    timed("topk+elite_moments", moments, jitter, max_hi=40 if q else 2000)

    # --- episode throughput: plain batched tier, two-stage tier, kernel tier ---
    cfg = EpisodeConfig(n_steps=n_steps, record_plans=False, warmstart=0)

    def throughput(runner, label):
        def call(seed):
            g = torch.Generator(device=device).manual_seed(seed)
            res = runner(env, solver, cfg, x0s, generator=g, device=device)
            return float(res.costs.sum())

        call(0)  # warm-up
        ts = []
        for i in range(1 if q else 4):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            call(i + 1)
            ts.append(time.perf_counter() - t0)
        wall = min(ts)
        sps = B * n_steps / wall
        out[label] = {"wall_s_per_call": round(wall, 4), "solves_per_s": round(sps, 1)}
        print(f"{label}: {sps:,.0f} solves/s ({wall:.3f}s per {B}x{n_steps})", flush=True)

    throughput(run_episodes_batch, "episodes_vmapped_scalar")
    throughput(lambda *a, **kw: run_episodes_fused(*a, use_kernel=False, **kw),
               "episodes_fused_solve_batch")
    throughput(lambda *a, **kw: run_episodes_fused(*a, use_kernel=True, **kw),
               "episodes_single_kernel")

    out["stage_ms"] = stages
    return out


def main(argv=None) -> dict:
    args = measure_parser(__doc__).parse_args(argv)
    out = run(args)
    write_measure(args, "profile_cem", out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
