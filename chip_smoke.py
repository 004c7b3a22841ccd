"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # build, check, drive, time; one card

Phases (any failure exits non-zero before the result line):
1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles every kernel from ``benchmarking_mpc_solvers_tpu_torch/
   csrc`` (one nvcc per source, in parallel).
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on each model, at the main paths' shapes (CEM's elite masks and
   the Riccati ``ok`` flags exactly).
4. main paths, each with the launch counters set to 0 just before its run
   and read just after:
   - MPPI, the bench configuration (cart-pole swing-up, K=32, T=50,
     B=8192, 20 MPC steps) on the kernel tier and the two-stage tier;
   - CEM, the sweep configuration (cart-pole swing-up, K=64, n_elite=8,
     max_iter=3, T=50, B=10240, 10 MPC steps) on both tiers;
   - iLQR, the batched configuration (cart-pole swing-up, T=100,
     max_iter=5, reference_accept=False, B=1024, warm start 10, 20 MPC
     steps) through the Riccati and line-search kernels;
   plus small MPPI, CEM and iLQR episodes on the card against the plain
   versions on the CPU, and a short swing-up progress check.
5. timings with CUDA events: each kernel, its plain version and its bound;
   host-clock episode solves/s of every path; device time by kernel.
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
# CEM sweep (scripts/bench_suite.py:256-266) and iLQR configuration 3
# (scripts/bench_suite.py:216-223) of the reference's suite
CEM_T, CEM_K, CEM_ELITE, CEM_ITERS, CEM_B, CEM_STEPS = 50, 64, 8, 3, 10240, 10
ILQR_T, ILQR_ITERS, ILQR_B, ILQR_WARM, ILQR_STEPS, N_ALPHAS = 100, 5, 1024, 10, 20, 10

# Kernel-vs-plain tolerance. Both sides run float32 one IEEE operation at a
# time (the kernels are built with --fmad=false and accurate libm calls), so
# the rollouts agree to rounding; what differs is summation order (warp
# trees vs sequential sums) in the softmax and the plan update, ~1e-6
# relative. 1e-4 leaves room for a rollout that rounds differently near a
# branch of a clamp or floor-mod.
RTOL, ATOL = 1e-4, 1e-4
# Card vs CPU episodes of CEM and iLQR: the card's and the CPU's libm round
# sin/cos/log apart by an ulp; CEM's std = sqrt(m2 − m1²) of nearly equal
# elites turns that into up to 2.4e-4·|m1|, and a converged iLQR accept
# test (best < nominal within one ulp) can fall either way, a step of
# ~1e-3 (tests/test_torch_cem.py, tests/test_torch_ilqr.py).
CEM_EPISODE_TOL, ILQR_EPISODE_TOL = 1e-3, 2e-3

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
# CEM, from csrc/fused_cem.cu: per (b, k, t, it) the sample mean+std*d and
# its clip (4); per (b, elite, t, it) the moments m1 += w*u, m2 += w*(u*u)
# (5); per (b, t, it) std_e = sqrt(max(m2 - m1*m1, 0)) and the two
# smoothings (10); per (b, k, round, it) the masked-min cost + sel*excl,
# the min and the tie test (4). The pass-2 redraw of the elites' noise is a
# cost of the design (it keeps no samples) and is left out.
CEM_SAMPLE_OPS, CEM_MOMENT_OPS, CEM_UPDATE_OPS, CEM_SELECT_OPS = 4, 5, 10, 4
# line search, from csrc/fused_linesearch.cu: per (a, b, t) the feedback
# sum_i K_i*(x_i - xref_i) (3S), us + alpha*ks + fb (3), the clip (2); the
# terminal cost, once per candidate, is left out (under 0.3 % of the ops)
LS_EXTRA = lambda S: 3 * S + 5  # noqa: E731
PEAK_FP32 = 67e12  # H100 SXM FP32 (non-tensor) FLOP/s, published, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def riccati_ops(S: int) -> int:
    """FP32 operations of one Riccati step in csrc/riccati_backward.cu
    (without c): each sum of S products counts 2S, each added term 1."""
    sums = 2 * S
    return (S * (sums + 1)          # q_x
            + sums + 1              # q_u
            + S * S * sums          # m = V_xx f_x
            + S * S * (sums + 1)    # q_xx
            + S * sums + sums + 1   # V_xx f_u, q_uu
            + S * (sums + 1)        # q_ux
            + sums + 2              # fufu, q_uu_r
            + S * (sums + 2)        # q_ux_r
            + 3 + 2 + 2 * S         # pd test and inverse, k, K
            + 6 * S                 # V_x
            + 7 * S * S             # V_xx before symmetrising
            + 2 * S * S)            # symmetrising


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


def episode_seconds(run, reps: int):
    """Host-clock times of whole episodes, each ending in a synchronise,
    after one untimed warm-up episode."""
    run()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def mppi_inputs(model, B, T, seed, dev):
    rng = np.random.default_rng(seed)
    S = model.state_size
    plan = rng.uniform(-0.5, 0.5, (T, B)).astype(np.float32)
    x0 = rng.uniform(-1.0, 1.0, (S, B)).astype(np.float32)
    gz = rng.uniform(-0.2, 0.2, (T, S + 1)).astype(np.float32)
    return [torch.from_numpy(a).to(dev).contiguous() for a in (plan, x0, gz)]


def compare(name, got, want):
    """Max abs and rel error of got against want, each printed beside the
    reference value where it occurs; fails beyond the tolerance. Entries
    where the plain version is not finite must be equal in the kernel's
    output (both overflowed alike) and are left out of the errors."""
    torch.cuda.synchronize()
    bad = ~torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), ~bad) or not torch.equal(
            torch.nan_to_num(got[bad], nan=0.0), torch.nan_to_num(want[bad], nan=0.0)):
        fail(f"{name}: kernel output not finite where the plain version is, or not alike")
    got, want = got[~bad], want[~bad]
    err = (got - want).abs()
    rel = err / want.abs().clamp_min(1e-30)
    ia, ir = int(err.argmax()), int(rel.argmax())
    max_abs, max_rel = float(err.flatten()[ia]), float(rel.flatten()[ir])
    ok = bool((err <= ATOL + RTOL * want.abs()).all())
    print(f"{name}: max_abs_err={max_abs:.3e} at |want|={float(want.flatten()[ia].abs()):.3e}, "
          f"max_rel_err={max_rel:.3e} at |want|={float(want.flatten()[ir].abs()):.3e}, "
          f"|want| max {float(want.abs().max()):.3e}"
          f"{f', {int(bad.sum())} non-finite alike' if bool(bad.any()) else ''} "
          f"(rtol={RTOL}, atol={ATOL}) {'ok' if ok else 'EXCEEDED'}", flush=True)
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs, max_rel


def exact(name, got, want):
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{name}: kernel and plain version differ ({int((got != want).sum())} entries)")
    print(f"{name}: identical", flush=True)


def profile_window(label, smi, fn):
    """Device time by kernel over one call of fn, and the device's busy
    share of the wall time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = sorted(
        ((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_time_total > 0 and str(e.device_type).endswith("CUDA")),
        key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in by_kernel)
    if busy_ms > 0:
        print(f"[{smi}] profiled {label}: wall {wall_ms:.2f} ms, device busy "
              f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
              f"{sum(r[2] for r in by_kernel)} device kernels", flush=True)
        for key, ms, count in by_kernel[:6]:
            print(f"  {ms:8.3f} ms  x{count:<6d} {key[:90]}", flush=True)
    else:
        print(f"profiled {label}: no device time recorded (not measured)", flush=True)


def report_episodes(smi, label, times, batch, steps):
    med = statistics.median(times)
    q1, _, q3 = statistics.quantiles(times, n=4) if len(times) > 1 else (med, med, med)
    print(f"[{smi}] episode {label} B={batch} x {steps} steps: median {med * 1e3:.3f} ms "
          f"(quartiles {q1 * 1e3:.3f}-{q3 * 1e3:.3f} ms, n={len(times)}) = "
          f"{batch * steps / med:.1f} solves/s", flush=True)
    return med


def bound(bytes_, ops):
    b = {"bytes": bytes_ / PEAK_BYTES * 1e3, "operations": ops / PEAK_FP32 * 1e3}
    return max(b.values()), max(b, key=b.get)


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
    t_start = time.perf_counter()

    from benchmarking_mpc_solvers_tpu_torch import _build
    from benchmarking_mpc_solvers_tpu_torch.envs import CartPoleSwingUpEnv, PendulumEnv
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import (
        fused_rollout_costs_tm, fused_rollout_costs_tm_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_cem import (
        fused_cem_step, fused_cem_step_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import (
        fused_linesearch, fused_linesearch_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import (
        fused_mppi_step, fused_mppi_step_reference, pick_lanes)
    from benchmarking_mpc_solvers_tpu_torch.ops.riccati_backward import (
        riccati_backward_batch, riccati_backward_batch_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.rollout import simulate_trajectory
    from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, ILQR, MPPI

    counters = (fused_mppi_step, fused_rollout_costs_tm, fused_cem_step,
                riccati_backward_batch, fused_linesearch)

    def reset_counts():
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all(ptxas_verbose="--ptxas" in sys.argv)
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}", flush=True)
    for src, (_, log) in built.items():
        if log.strip():
            print(f"--- nvcc {src}\n{log.strip()}", flush=True)

    # 3. kernel vs plain version, on the card
    errs = {}
    cases1 = [("cartpole_swingup", BATCH, 7), ("pendulum", 3000, 2**31 - 2),
              ("acrobot", 5000, 12345)]
    for name, B, seed in cases1:
        model = REGISTRY[name]
        plan, x0, gz = mppi_inputs(model, B, HORIZON, 1, dev)
        lanes = pick_lanes(B)
        got = fused_mppi_step(model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, seed)
        want = fused_mppi_step_reference(model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, seed)
        e = compare(f"fused_mppi_step[{name}, B={B}, seed={seed}]", got, want)
        errs.setdefault("fused_mppi_step", e)
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
        errs.setdefault("fused_rollout_costs_tm", e)

    # CEM step: the sweep shape, a multi-tile ragged B, the seed 2**31 - 2
    for name, B, seed in [("cartpole_swingup", CEM_B, 7), ("pendulum", 3000, 2**31 - 2),
                          ("acrobot", 5000, 12345)]:
        model = REGISTRY[name]
        plan, x0, gz = mppi_inputs(model, B, CEM_T, 3, dev)
        args = (model, CEM_K, CEM_ELITE, CEM_ITERS, 0.2, 1.0, pick_lanes(B), plan, x0, gz, seed)
        got, got_masks = fused_cem_step(*args, return_masks=True)
        want, want_masks = fused_cem_step_reference(*args, return_masks=True)
        label = f"fused_cem_step[{name}, B={B}, seed={seed}]"
        exact(f"{label} elite masks", got_masks, want_masks)
        errs.setdefault("fused_cem_step", compare(label, got, want))

    # Riccati: every model's derivatives along random plans at iLQR's shape,
    # then random well-conditioned blocks with non-PD steps (ok mixed) and
    # the with_c form (SQP's: mu = 0, no PD check)
    def model_derivs(name, B, T):
        model = REGISTRY[name]
        solver = ILQR(model=model, T=T)
        gen = torch.Generator(device=dev).manual_seed(5)
        x0 = 0.3 * torch.randn((B, model.state_size), generator=gen, device=dev)
        us = solver.init_state_batch(B, gen, dev).planned_us
        gz = torch.zeros((T, model.goal_size), device=dev)
        xs, _ = simulate_trajectory(model, x0, us, gz)
        return [t.contiguous() for t in solver.derivatives(xs, us, gz)]

    def random_derivs(B, T, S, seed):
        rng = np.random.default_rng(seed)
        eye = np.eye(S)
        sym = lambda m: 0.5 * (m + np.swapaxes(m, -1, -2))  # noqa: E731
        l_uu = 0.5 + rng.uniform(size=(B, T, 1, 1))
        l_uu[::5, T // 3] = -50.0  # every 5th scenario has a non-PD step
        arrays = (rng.standard_normal((B, T + 1, S)), rng.standard_normal((B, T, 1)),
                  sym(rng.standard_normal((B, T + 1, S, S))) + 2.0 * eye, l_uu,
                  rng.standard_normal((B, T, 1, S)),
                  0.5 * eye + 0.1 * rng.standard_normal((B, T, S, S)),
                  rng.standard_normal((B, T, S, 1)), 0.3 * rng.standard_normal((B, T, S)))
        return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]

    ones = torch.ones((ILQR_B,), device=dev)
    riccati_main = model_derivs("cartpole_swingup", ILQR_B, ILQR_T)
    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        d = riccati_main if name == "cartpole_swingup" else model_derivs(name, ILQR_B, ILQR_T)
        got, want = riccati_backward_batch(*d, ones), riccati_backward_batch_reference(*d, ones)
        label = f"riccati_backward_batch[{name} derivatives, B={ILQR_B}, T={ILQR_T}]"
        exact(f"{label} ok ({int(want[2].sum())} of {ILQR_B} true)", got[2], want[2])
        e = max(compare(f"{label} ks", got[0], want[0]), compare(f"{label} Ks", got[1], want[1]))
        errs["riccati_backward_batch"] = max(errs.get("riccati_backward_batch", e), e)
    *d, c = random_derivs(ILQR_B, ILQR_T, 4, 6)
    mu = torch.from_numpy(np.random.default_rng(7).choice(
        [1e-6, 1e-3, 1.0, 32.0], ILQR_B).astype(np.float32)).to(dev)
    got, want = riccati_backward_batch(*d, mu), riccati_backward_batch_reference(*d, mu)
    n_ok = int(want[2].sum())
    if not 0 < n_ok < ILQR_B:
        fail(f"riccati non-PD case: ok is not mixed ({n_ok} of {ILQR_B})")
    exact(f"riccati_backward_batch[non-PD steps] ok ({n_ok} of {ILQR_B} true)", got[2], want[2])
    for e in (compare("riccati_backward_batch[non-PD steps] ks", got[0], want[0]),
              compare("riccati_backward_batch[non-PD steps] Ks", got[1], want[1])):
        errs["riccati_backward_batch"] = max(errs["riccati_backward_batch"], e)
    zero = torch.zeros((ILQR_B,), device=dev)
    got = riccati_backward_batch(*d, zero, c, check_pd=False, with_c=True)
    want = riccati_backward_batch_reference(*d, zero, c, check_pd=False, with_c=True)
    for e in (compare("riccati_backward_batch[with_c] ks", got[0], want[0]),
              compare("riccati_backward_batch[with_c] Ks", got[1], want[1])):
        errs["riccati_backward_batch"] = max(errs["riccati_backward_batch"], e)

    # line search: n_alpha=10, B=1024, T=100, both flags, every model
    alphas = ILQR(model=REGISTRY["cartpole_swingup"], T=ILQR_T).alphas(dev)

    def ls_inputs(model, seed):
        rng = np.random.default_rng(seed)
        B, T, S = ILQR_B, ILQR_T, model.state_size
        x0 = torch.from_numpy((0.3 * rng.standard_normal((B, S))).astype(np.float32)).to(dev)
        us = torch.from_numpy((0.5 * rng.standard_normal((B, T, 1))).astype(np.float32)).to(dev)
        gz = torch.zeros((T, model.goal_size), device=dev)
        xref, _ = simulate_trajectory(model, x0, us, gz)
        ks = torch.from_numpy((0.3 * rng.standard_normal((B, T, 1))).astype(np.float32)).to(dev)
        Ks = torch.from_numpy((0.05 * rng.standard_normal((B, T, 1, S))).astype(np.float32)).to(dev)
        return x0, us, ks, Ks, xref.contiguous(), gz

    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        model = REGISTRY[name]
        inputs = ls_inputs(model, 8)
        for with_terminal in (True, False):
            for return_states in (False, True):
                got = fused_linesearch(model, alphas, *inputs, with_terminal=with_terminal,
                                       return_states=return_states)
                want = fused_linesearch_reference(model, alphas, *inputs,
                                                  with_terminal=with_terminal,
                                                  return_states=return_states)
                label = (f"fused_linesearch[{name}, n_a={N_ALPHAS}, B={ILQR_B}, T={ILQR_T}, "
                         f"terminal={with_terminal}, states={return_states}]")
                e = compare(f"{label} us", got[0], want[0])
                if return_states:
                    compare(f"{label} xs", got[1], want[1])
                e = max(e, compare(f"{label} costs", got[-1], want[-1]))
                if name == "cartpole_swingup" and with_terminal and not return_states:
                    errs["fused_linesearch"] = e  # the iLQR main path's flags

    # 4. main paths
    launches = {}
    env = CartPoleSwingUpEnv
    x0s = env.start_state(dev).expand(BATCH, -1).contiguous()
    solver = MPPI(model=env.model, T=HORIZON, K=K_SAMPLES, std=1.0, lam=1.0)
    cfg = EpisodeConfig(n_steps=N_STEPS, warmstart=0, record_plans=False)

    def mppi_episode(use_kernel=True):
        gen = torch.Generator(device=dev).manual_seed(0)
        return run_episodes_fused(env, solver, cfg, x0s, generator=gen,
                                  use_kernel=use_kernel, device=dev)

    def run_path(label, run, expect):
        """Drive one path with the counts at 0; check each expected count
        and that no other kernel launched."""
        reset_counts()
        res = run()
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in counters}
        want = {fn.__name__: 0 for fn in counters}
        want.update(expect)
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")
        if not torch.isfinite(res.costs).all():
            fail(f"{label}: episode costs not finite")
        launches[label] = got
        print(f"main path ({label}): launches {expect}, mean episode cost "
              f"{float(res.costs.sum(1).mean()):.3f}", flush=True)
        return res

    res = run_path("mppi kernel tier", mppi_episode,
                   {"fused_mppi_step": cfg.warmstart + cfg.n_steps})
    if res.costs.shape != (BATCH, N_STEPS):
        fail("kernel-tier episode costs misshapen")
    run_path("mppi two-stage tier", lambda: mppi_episode(False),
             {"fused_rollout_costs_tm": cfg.n_steps})

    cem = CEM(model=env.model, T=CEM_T, K=CEM_K, n_elite=CEM_ELITE, max_iter=CEM_ITERS)
    cem_cfg = EpisodeConfig(n_steps=CEM_STEPS, warmstart=0, record_plans=False)
    cem_x0s = env.start_state(dev).expand(CEM_B, -1).contiguous()

    def cem_episode(use_kernel=True):
        gen = torch.Generator(device=dev).manual_seed(0)
        return run_episodes_fused(env, cem, cem_cfg, cem_x0s, generator=gen,
                                  use_kernel=use_kernel, device=dev)

    run_path("cem kernel tier", cem_episode,
             {"fused_cem_step": cem_cfg.warmstart + cem_cfg.n_steps})
    run_path("cem two-stage tier", lambda: cem_episode(False),
             {"fused_rollout_costs_tm": cem_cfg.n_steps * CEM_ITERS})

    ilqr = ILQR(model=env.model, T=ILQR_T, max_iter=ILQR_ITERS, reference_accept=False)
    ilqr_cfg = EpisodeConfig(n_steps=ILQR_STEPS, warmstart=ILQR_WARM, record_plans=False)
    ilqr_x0s = env.start_state(dev).expand(ILQR_B, -1).contiguous()

    def ilqr_episode():
        gen = torch.Generator(device=dev).manual_seed(0)
        return run_episodes_fused(env, ilqr, ilqr_cfg, ilqr_x0s, generator=gen, device=dev)

    # solve_batch runs max_iter outer iterations per call, without an early
    # exit: one Riccati and one line-search launch each
    ilqr_iters = (ILQR_WARM + ILQR_STEPS) * ILQR_ITERS
    run_path("ilqr", ilqr_episode,
             {"riccati_backward_batch": ilqr_iters, "fused_linesearch": ilqr_iters})
    print(f"ilqr: {ilqr_iters} outer iterations ran ({ILQR_WARM + ILQR_STEPS} solves x "
          f"{ILQR_ITERS})", flush=True)
    st = ilqr.init_state_batch(ILQR_B, torch.Generator(device=dev).manual_seed(0), dev)
    out = ilqr.solve_batch(st, ilqr_x0s, torch.zeros((ILQR_T, env.model.goal_size), device=dev))[0]
    # a solve that accepts no step returns the plan, or the clipped plan
    kept = ((out.planned_us == st.planned_us).flatten(1).all(dim=1)
            | (out.planned_us == env.model.clip_action(st.planned_us)).flatten(1).all(dim=1))
    print(f"ilqr: one solve from the initial plans accepted a step in {int((~kept).sum())} of "
          f"{ILQR_B} scenarios", flush=True)

    # small episodes on the card against the plain versions on the CPU
    def small_match(label, tol, run):
        on_card, on_cpu = run(dev), run("cpu")
        for field in ("costs", "true_states", "planned_actions"):
            got, want = getattr(on_card, field).cpu(), getattr(on_cpu, field)
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                fail(f"small {label} episode {field}: card vs CPU plain max err "
                     f"{float((got - want).abs().max()):.3e}")
        print(f"small {label} episode: card matches the CPU plain version (tol {tol})",
              flush=True)

    xs_small = env.start_state("cpu").expand(64, -1) + 0.05 * torch.from_numpy(
        np.random.default_rng(3).standard_normal((64, 4)).astype(np.float32))
    seeds = [11, -7, 2**31 - 2, 5]
    small_cfg = EpisodeConfig(n_steps=3, warmstart=1, record_plans=True)
    small_match("mppi kernel-tier", RTOL, lambda d: run_episodes_fused(
        env, MPPI(model=env.model, T=10, K=8), small_cfg, xs_small.to(d), seeds=seeds, device=d))
    small_match("cem kernel-tier", CEM_EPISODE_TOL, lambda d: run_episodes_fused(
        env, CEM(model=env.model, T=10, K=16, n_elite=4, max_iter=2), small_cfg, xs_small.to(d),
        seeds=seeds, device=d))
    plans = 0.5 * np.random.default_rng(4).standard_normal((8, 10, 1)).astype(np.float32)
    small_match("ilqr", ILQR_EPISODE_TOL, lambda d: run_episodes_fused(
        env, ILQR(model=env.model, T=10, max_iter=3, reference_accept=False), small_cfg,
        xs_small[:8].to(d), init_plans=plans, device=d))

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

    # 5. timings at the main paths' shapes, with each bound from this run's shapes
    model = env.model
    S, Z = model.state_size, model.goal_size
    ms, plain_ms, bounds = {}, {}, {}
    plan, x0, gz = mppi_inputs(model, BATCH, HORIZON, 1, dev)
    lanes = pick_lanes(BATCH)
    ms["fused_mppi_step"] = cuda_time_ms(
        lambda: fused_mppi_step(model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, 7))
    plain_ms["fused_mppi_step"] = cuda_time_ms(lambda: fused_mppi_step_reference(
        model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, 7), reps=3, warmup=1)
    steps = BATCH * K_SAMPLES * HORIZON
    bounds["fused_mppi_step"] = bound(
        4 * (2 * HORIZON * BATCH + S * BATCH + HORIZON * Z),
        steps * (NOISE_OPS + STEP_OPS[model.name] + PASS1_EXTRA + PASS2_EXTRA))

    x0n = x0.repeat_interleave(K_SAMPLES, dim=1)
    usn = (plan.repeat_interleave(K_SAMPLES, dim=1)
           + torch.randn((HORIZON, N), generator=torch.Generator(device=dev).manual_seed(4),
                         device=dev))
    ms["fused_rollout_costs_tm"] = cuda_time_ms(lambda: fused_rollout_costs_tm(model, x0n, usn, gz))
    plain_ms["fused_rollout_costs_tm"] = cuda_time_ms(
        lambda: fused_rollout_costs_tm_reference(model, x0n, usn, gz), reps=3, warmup=1)
    bounds["fused_rollout_costs_tm"] = bound(4 * (S * N + HORIZON * N + HORIZON * Z + N),
                                             steps * STEP_OPS[model.name])

    plan, x0, gz = mppi_inputs(model, CEM_B, CEM_T, 3, dev)
    cem_args = (model, CEM_K, CEM_ELITE, CEM_ITERS, 0.2, 1.0, pick_lanes(CEM_B), plan, x0, gz, 7)
    ms["fused_cem_step"] = cuda_time_ms(lambda: fused_cem_step(*cem_args))
    plain_ms["fused_cem_step"] = cuda_time_ms(lambda: fused_cem_step_reference(*cem_args),
                                              reps=3, warmup=1)
    cem_steps = CEM_B * CEM_K * CEM_T * CEM_ITERS
    bounds["fused_cem_step"] = bound(
        4 * (2 * CEM_T * CEM_B + S * CEM_B + CEM_T * Z),
        cem_steps * (NOISE_OPS + STEP_OPS[model.name] + CEM_SAMPLE_OPS)
        + CEM_B * CEM_ITERS * (CEM_ELITE * CEM_T * CEM_MOMENT_OPS + CEM_T * CEM_UPDATE_OPS
                               + CEM_K * CEM_ELITE * CEM_SELECT_OPS))
    print(f"fused_cem_step: {cem_steps} rollout steps per launch", flush=True)

    d = riccati_main
    ms["riccati_backward_batch"] = cuda_time_ms(lambda: riccati_backward_batch(*d, ones))
    plain_ms["riccati_backward_batch"] = cuda_time_ms(
        lambda: riccati_backward_batch_reference(*d, ones), reps=3, warmup=1)
    per_t = S + 1 + S * S + 1 + S + S * S + S  # l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u
    bounds["riccati_backward_batch"] = bound(
        4 * ILQR_B * (ILQR_T * (per_t + 1 + S) + S + S * S + 2),
        ILQR_B * ILQR_T * riccati_ops(S))

    ls_in = ls_inputs(model, 8)
    ms["fused_linesearch"] = cuda_time_ms(
        lambda: fused_linesearch(model, alphas, *ls_in, with_terminal=True))
    plain_ms["fused_linesearch"] = cuda_time_ms(
        lambda: fused_linesearch_reference(model, alphas, *ls_in, with_terminal=True),
        reps=3, warmup=1)
    ls_steps = N_ALPHAS * ILQR_B * ILQR_T
    bounds["fused_linesearch"] = bound(
        4 * (2 * ILQR_B * ILQR_T * (1 + S) + ILQR_B * S + N_ALPHAS + ILQR_T * Z
             + N_ALPHAS * ILQR_B * (ILQR_T + 1)),
        ls_steps * (STEP_OPS[model.name] + LS_EXTRA(S)))

    for name in ms:
        print(f"[{smi}] {name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.3f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})", flush=True)

    ep = {
        "mppi kernel tier": report_episodes(smi, "mppi kernel tier", episode_seconds(
            mppi_episode, 12), BATCH, N_STEPS),
        "mppi two-stage tier": report_episodes(smi, "mppi two-stage tier", episode_seconds(
            lambda: mppi_episode(False), 6), BATCH, N_STEPS),
        "cem kernel tier": report_episodes(smi, "cem kernel tier", episode_seconds(
            cem_episode, 8), CEM_B, CEM_STEPS),
        "cem two-stage tier": report_episodes(smi, "cem two-stage tier", episode_seconds(
            lambda: cem_episode(False), 4), CEM_B, CEM_STEPS),
        "ilqr": report_episodes(smi, f"ilqr (warm start {ILQR_WARM} in the time)",
                                episode_seconds(ilqr_episode, 3), ILQR_B, ILQR_STEPS),
    }

    profile_window("mppi kernel-tier episode", smi, mppi_episode)
    profile_window("cem kernel-tier episode", smi, cem_episode)
    gen = torch.Generator(device=dev).manual_seed(0)
    st = ilqr.init_state_batch(ILQR_B, gen, dev)
    gz = torch.zeros((ILQR_T, Z), device=dev)
    profile_window(f"ilqr solve (one MPC step, {ILQR_ITERS} iterations)", smi,
                   lambda: ilqr.solve_batch(st, ilqr_x0s, gz))
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s", flush=True)

    sources = {
        "fused_mppi_step": ("fused_mppi.cu", "benchmarking_mpc_solvers_tpu/ops/fused_mppi.py:171"),
        "fused_rollout_costs_tm": ("fused_rollout.cu", "benchmarking_mpc_solvers_tpu/ops/fused.py:81"),
        "fused_cem_step": ("fused_cem.cu", "benchmarking_mpc_solvers_tpu/ops/fused_cem.py:111"),
        "riccati_backward_batch": ("riccati_backward.cu",
                                   "benchmarking_mpc_solvers_tpu/ops/riccati_pallas.py:107"),
        "fused_linesearch": ("fused_linesearch.cu",
                             "benchmarking_mpc_solvers_tpu/ops/fused_linesearch.py:122"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        by_path = {path: n[name] for path, n in launches.items() if n[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"benchmarking_mpc_solvers_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None, "pass": True})
    print(json.dumps({"kernels": kernels, "episode_ms": {k: v * 1e3 for k, v in ep.items()},
                      "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
