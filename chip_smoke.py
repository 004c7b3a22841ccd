"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # build, check, drive, time; one card

Phases (any failure exits non-zero before the result line):
1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles every kernel from ``benchmarking_mpc_solvers_tpu_torch/
   csrc`` (one nvcc per source, in parallel).
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on each model, at the main path's shapes.
4. main path: the bench configuration (cart-pole swing-up, MPPI K=32, T=50,
   B=8192 scenarios, 20 MPC steps) through ``run_episodes_fused`` on the
   kernel tier and on the two-stage tier, with the launch counters set to 0
   just before each run and read just after; a small kernel-tier episode
   against the plain version on the CPU; a short swing-up progress check.
5. timings with CUDA events: each kernel, its plain version, and the
   episode's solves/s.
Then a ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.

Imports only the port (``benchmarking_mpc_solvers_tpu_torch``), never JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HORIZON, K_SAMPLES, BATCH, N_STEPS = 50, 32, 8192, 20

# Kernel-vs-plain tolerance. Both sides run float32 one IEEE operation at a
# time (the kernels are built with --fmad=false and accurate libm calls), so
# the rollouts agree to rounding; what differs is summation order (warp
# trees vs sequential sums) in the softmax and the plan update, ~1e-6
# relative. 1e-4 leaves room for a rollout that rounds differently near a
# branch of a clamp or floor-mod.
RTOL, ATOL = 1e-4, 1e-4

# FP32 operations per rollout step, counted by hand from csrc/models.cuh
# (each add, mul, div, clamp compare and each libm call counted once, so
# the bound is a lower bound): transform + nonzero-W cost with its clip +
# dynamics + the running sum. Cart-pole: transform 8, cost 10, dynamics 40,
# sum 1.
STEP_OPS = {"pendulum": 34, "cartpole_swingup": 59, "acrobot": 252}
# the noise draw (u01 x2, +1e-7, log, -2*, sqrt, 2pi*, cos, r*), counted once
# per (b, k, t): the function needs one normal there. The kernel draws it a
# second time in pass 2 instead of keeping it; that is a cost of the design,
# not of the function, and is left out of the bound. MPPI extras: pass 1
# std*d, plan+sd, control term (3); pass 2 w/sum, std*d, w*(.), +=.
NOISE_OPS, PASS1_EXTRA, PASS2_EXTRA = 9, 5, 4
PEAK_FP32 = 67e12  # H100 SXM FP32 (non-tensor) FLOP/s, published, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median per-call device time of fn over reps, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mppi_inputs(model, B, T, seed, dev):
    rng = np.random.default_rng(seed)
    S = model.state_size
    plan = rng.uniform(-0.5, 0.5, (T, B)).astype(np.float32)
    x0 = rng.uniform(-1.0, 1.0, (S, B)).astype(np.float32)
    gz = rng.uniform(-0.2, 0.2, (T, S + 1)).astype(np.float32)
    return [torch.from_numpy(a).to(dev).contiguous() for a in (plan, x0, gz)]


def compare(name, got, want):
    """Max abs and rel error of got against want, each printed beside the
    reference value where it occurs; fails beyond the tolerance."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output not finite")
    err = (got - want).abs()
    rel = err / want.abs().clamp_min(1e-30)
    ia, ir = int(err.argmax()), int(rel.argmax())
    max_abs, max_rel = float(err.flatten()[ia]), float(rel.flatten()[ir])
    ok = bool((err <= ATOL + RTOL * want.abs()).all())
    print(f"{name}: max_abs_err={max_abs:.3e} at |want|={float(want.flatten()[ia].abs()):.3e}, "
          f"max_rel_err={max_rel:.3e} at |want|={float(want.flatten()[ir].abs()):.3e}, "
          f"|want| max {float(want.abs().max()):.3e} "
          f"(rtol={RTOL}, atol={ATOL}) {'ok' if ok else 'EXCEEDED'}", flush=True)
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs, max_rel


def main():
    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    from benchmarking_mpc_solvers_tpu_torch import _build
    from benchmarking_mpc_solvers_tpu_torch.envs import CartPoleSwingUpEnv, PendulumEnv
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import (
        fused_rollout_costs_tm, fused_rollout_costs_tm_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import (
        fused_mppi_step, fused_mppi_step_reference, pick_lanes)
    from benchmarking_mpc_solvers_tpu_torch.solvers import MPPI

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all(ptxas_verbose="--ptxas" in sys.argv)
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}", flush=True)
    for src, (_, log) in built.items():
        if log.strip():
            print(f"--- nvcc {src}\n{log.strip()}", flush=True)

    # 3. kernel vs plain version, on the card
    err1 = err2 = (0.0, 0.0)
    cases1 = [("cartpole_swingup", BATCH, 7), ("pendulum", 3000, 2**31 - 2),
              ("acrobot", 5000, 12345)]
    for name, B, seed in cases1:
        model = REGISTRY[name]
        plan, x0, gz = mppi_inputs(model, B, HORIZON, 1, dev)
        lanes = pick_lanes(B)
        got = fused_mppi_step(model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, seed)
        want = fused_mppi_step_reference(model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, seed)
        e = compare(f"fused_mppi_step[{name}, B={B}, seed={seed}]", got, want)
        if name == "cartpole_swingup":
            err1 = e
    N = BATCH * K_SAMPLES
    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        model = REGISTRY[name]
        rng = np.random.default_rng(2)
        x0 = torch.from_numpy(rng.uniform(-1, 1, (model.state_size, N)).astype(np.float32)).to(dev)
        us = torch.from_numpy(rng.uniform(-1.5, 1.5, (HORIZON, N)).astype(np.float32)).to(dev)
        gz = torch.from_numpy(rng.uniform(-0.2, 0.2, (HORIZON, model.goal_size)).astype(np.float32)).to(dev)
        got = fused_rollout_costs_tm(model, x0, us, gz)
        want = fused_rollout_costs_tm_reference(model, x0, us, gz)
        e = compare(f"fused_rollout_costs_tm[{name}, N={N}]", got, want)
        if name == "cartpole_swingup":
            err2 = e

    # 4. main path, bench configuration
    env = CartPoleSwingUpEnv
    solver = MPPI(model=env.model, T=HORIZON, K=K_SAMPLES, std=1.0, lam=1.0)
    cfg = EpisodeConfig(n_steps=N_STEPS, warmstart=0, record_plans=False)
    x0s = env.start_state(dev).expand(BATCH, -1).contiguous()

    def episode(use_kernel=True):
        gen = torch.Generator(device=dev).manual_seed(0)
        return run_episodes_fused(env, solver, cfg, x0s, generator=gen,
                                  use_kernel=use_kernel, device=dev)

    fused_mppi_step.launches = 0
    fused_rollout_costs_tm.launches = 0
    res = episode()
    torch.cuda.synchronize()
    launches1 = fused_mppi_step.launches
    if launches1 != cfg.warmstart + cfg.n_steps:
        fail(f"kernel tier launched fused_mppi_step {launches1} times, "
             f"expected {cfg.warmstart + cfg.n_steps}")
    if res.costs.shape != (BATCH, N_STEPS) or not torch.isfinite(res.costs).all():
        fail("kernel-tier episode costs not finite or misshapen")
    print(f"main path (kernel tier): fused_mppi_step launches={launches1}, "
          f"mean episode cost {float(res.costs.sum(1).mean()):.3f}", flush=True)

    fused_mppi_step.launches = 0
    fused_rollout_costs_tm.launches = 0
    res2 = episode(use_kernel=False)
    torch.cuda.synchronize()
    launches2 = fused_rollout_costs_tm.launches
    if launches2 != cfg.n_steps or fused_mppi_step.launches != 0:
        fail(f"two-stage tier launched fused_rollout_costs_tm {launches2} times, "
             f"expected {cfg.n_steps}")
    if not torch.isfinite(res2.costs).all():
        fail("two-stage episode costs not finite")
    print(f"main path (two-stage tier): fused_rollout_costs_tm launches={launches2}, "
          f"mean episode cost {float(res2.costs.sum(1).mean()):.3f}", flush=True)

    # a small kernel-tier episode against the plain version on the CPU
    small = MPPI(model=env.model, T=10, K=8)
    small_cfg = EpisodeConfig(n_steps=3, warmstart=1, record_plans=True)
    xs_small = env.start_state("cpu").expand(64, -1) + 0.05 * torch.from_numpy(
        np.random.default_rng(3).standard_normal((64, 4)).astype(np.float32))
    seeds = [11, -7, 2**31 - 2, 5]
    on_card = run_episodes_fused(env, small, small_cfg, xs_small.to(dev), seeds=seeds, device=dev)
    on_cpu = run_episodes_fused(env, small, small_cfg, xs_small, seeds=seeds, device="cpu")
    for field in ("costs", "true_states", "planned_actions"):
        got, want = getattr(on_card, field).cpu(), getattr(on_cpu, field)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"small episode {field}: card vs CPU plain max err "
                 f"{float((got - want).abs().max()):.3e}")
    print("small episode: card kernel tier matches the CPU plain version", flush=True)

    # swing-up progress on the kernel tier (the reference's own check)
    penv = PendulumEnv
    psolver = MPPI(model=penv.model, T=15, K=16, std=1.0, lam=1.0)
    pres = run_episodes_fused(
        penv, psolver, EpisodeConfig(n_steps=40, warmstart=20, record_plans=False),
        penv.start_state(dev).expand(16, -1).contiguous(),
        generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    c = pres.costs.cpu()
    if not (torch.isfinite(c).all() and c[:, -10:].mean() < 0.75 * c[:, :10].mean()):
        fail(f"pendulum swing-up made no progress: early {float(c[:, :10].mean()):.3f}, "
             f"late {float(c[:, -10:].mean()):.3f}")
    print(f"swing-up progress: early {float(c[:, :10].mean()):.3f} -> "
          f"late {float(c[:, -10:].mean()):.3f}", flush=True)

    # 5. timings at the main path's shapes
    model = env.model
    plan, x0, gz = mppi_inputs(model, BATCH, HORIZON, 1, dev)
    lanes = pick_lanes(BATCH)
    ms1 = cuda_time_ms(lambda: fused_mppi_step(model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, 7))
    plain1 = cuda_time_ms(lambda: fused_mppi_step_reference(
        model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, 7), reps=3, warmup=1)
    x0n = x0.repeat_interleave(K_SAMPLES, dim=1)
    usn = (plan.repeat_interleave(K_SAMPLES, dim=1)
           + torch.randn((HORIZON, N), generator=torch.Generator(device=dev).manual_seed(4),
                         device=dev))
    ms2 = cuda_time_ms(lambda: fused_rollout_costs_tm(model, x0n, usn, gz))
    plain2 = cuda_time_ms(lambda: fused_rollout_costs_tm_reference(model, x0n, usn, gz),
                          reps=3, warmup=1)

    def episode_seconds(use_kernel, reps):
        """Host-clock times of whole episodes, each ending in a synchronise,
        after one untimed warm-up episode."""
        episode(use_kernel)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            episode(use_kernel)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    ep_times = episode_seconds(True, 12)
    ep2_times = episode_seconds(False, 6)
    ep_s, ep2_s = statistics.median(ep_times), statistics.median(ep2_times)
    q1, _, q3 = statistics.quantiles(ep_times, n=4)

    # where an episode's time goes: device time by kernel over one
    # kernel-tier episode, and the device's busy share of the wall time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        episode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = sorted(
        ((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_time_total > 0 and str(e.device_type).endswith("CUDA")),
        key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_kernel)
    if busy_ms > 0:
        print(f"[{smi}] profiled kernel-tier episode: wall {wall_ms:.2f} ms, device busy "
              f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
              f"{sum(r[2] for r in by_kernel)} device kernels", flush=True)
        for key, ms, count in by_kernel[:6]:
            print(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    else:
        print("profiled kernel-tier episode: no device time recorded (not measured)", flush=True)

    # bounds from this run's shapes
    S, Z = model.state_size, model.goal_size
    steps = BATCH * K_SAMPLES * HORIZON
    ops1 = steps * (NOISE_OPS + STEP_OPS[model.name] + PASS1_EXTRA + PASS2_EXTRA)
    bytes1 = 4 * (2 * HORIZON * BATCH + S * BATCH + HORIZON * Z)
    ops2 = steps * STEP_OPS[model.name]
    bytes2 = 4 * (S * N + HORIZON * N + HORIZON * Z + N)
    b1 = {"bytes": bytes1 / PEAK_BYTES * 1e3, "operations": ops1 / PEAK_FP32 * 1e3}
    b2 = {"bytes": bytes2 / PEAK_BYTES * 1e3, "operations": ops2 / PEAK_FP32 * 1e3}

    print(f"[{smi}] fused_mppi_step B={BATCH} K={K_SAMPLES} T={HORIZON}: kernel {ms1:.4f} ms, "
          f"plain {plain1:.3f} ms, bound {max(b1.values()):.4f} ms", flush=True)
    print(f"[{smi}] fused_rollout_costs_tm N={N} T={HORIZON}: kernel {ms2:.4f} ms, "
          f"plain {plain2:.3f} ms, bound {max(b2.values()):.4f} ms", flush=True)
    print(f"[{smi}] episode B={BATCH} x {N_STEPS} steps, kernel tier: median {ep_s * 1e3:.3f} ms "
          f"(quartiles {q1 * 1e3:.3f}-{q3 * 1e3:.3f} ms, n={len(ep_times)}) = "
          f"{BATCH * N_STEPS / ep_s:.1f} solves/s", flush=True)
    print(f"[{smi}] episode B={BATCH} x {N_STEPS} steps, two-stage tier: median "
          f"{ep2_s * 1e3:.3f} ms (n={len(ep2_times)}) = {BATCH * N_STEPS / ep2_s:.1f} solves/s",
          flush=True)

    kernels = [
        {"name": "fused_mppi_step", "route": "cuda",
         "source": "benchmarking_mpc_solvers_tpu_torch/csrc/fused_mppi.cu",
         "replaces": "benchmarking_mpc_solvers_tpu/ops/fused_mppi.py:171",
         "launches": launches1, "max_abs_err": err1[0], "max_rel_err": err1[1],
         "ms": ms1, "plain_ms": plain1,
         "bound_ms": max(b1.values()), "bound_by": max(b1, key=b1.get),
         "library_ms": None, "pass": True},
        {"name": "fused_rollout_costs_tm", "route": "cuda",
         "source": "benchmarking_mpc_solvers_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "benchmarking_mpc_solvers_tpu/ops/fused.py:81",
         "launches": launches2, "max_abs_err": err2[0], "max_rel_err": err2[1],
         "ms": ms2, "plain_ms": plain2,
         "bound_ms": max(b2.values()), "bound_by": max(b2, key=b2.get),
         "library_ms": None, "pass": True},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
