"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # build, check, drive, time; one card
    python3 chip_smoke.py --ptxas    # the same, and each kernel's registers and spills

Phases (any failure exits non-zero before the result line):
1. device: requires CUDA; prints the card's name and power limit.
2. build: compiles every kernel from ``benchmarking_mpc_solvers_tpu_torch/
   csrc`` (one nvcc per source, in parallel).
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on each model, at the main paths' shapes (kernels 2, 3, 5, 6, 7,
   8a and 8b bit for bit, 1, 2, 3, 5, 6, 8a and 8b also at the edges of their
   lane groups, blocks and shared-memory stages; kernel 1 also at the
   sweep's MPPI row and in the form that redraws its noise, kernel 2 also at
   the CEM two-stage shape, kernel 7 at the edges of its three forms and
   past a block's shared memory, n up to 1,100; the two-stage tiers' noise
   draw, ``scenario_normals``, bit for bit with its int64 emulation at the
   noise cell's and CEM two-stage shape, the MPPI two-stage tier's, the
   plain tier's width and ragged ones).
4. main paths, each with the launch counters set to 0 just before its run
   and read just after:
   - MPPI, the bench configuration (cart-pole swing-up, K=32, T=50,
     B=8192, 20 MPC steps) on the kernel tier and the two-stage tier (the
     latter also one draw launch a step; CEM's two-stage tier one an
     iteration, the plain batched tiers one a solve or an iteration);
   - CEM, the sweep configuration (cart-pole swing-up, K=64, n_elite=8,
     max_iter=3, T=50, B=10240, 10 MPC steps) on both tiers;
   - iLQR, the batched configuration (cart-pole swing-up, T=100,
     max_iter=5, reference_accept=False, B=1024, warm start 10; its 20 MPC
     steps cut to 3) through the Riccati and line-search kernels, with exact
     Hessians and again with gauss_newton=True (then also the derivative
     kernel);
   - SQP, the suite's configuration 4 (acrobot, T=100, max_iter=4, B=1024,
     from [0.1, 0, 0.2, 0]; its 20 MPC steps cut to 5) through the
     derivative, Riccati and line-search kernels;
   - QP-MPC, the suite's configuration 1 (pendulum, T=20, condensed ADMM,
     100 iterations, B=512, 50 MPC steps) through the ADMM kernel, and
     configuration 2 (cart-pole stabilisation, T=50, Riccati-ADMM, 60
     iterations, B=256; its 40 MPC steps cut to 20), which is plain PyTorch;
   - I2C, the suite's configuration 6 (pendulum, T=25, max_iter=10, B=256,
     its 50 MPC steps cut to 25) and its row of the six-family sweep
     (cart-pole swing-up, T=50, max_iter=3, B=10240, 10 MPC steps), each
     iteration through the Kalman-filter and RTS-smoother kernels;
   - through ``Experiment.run`` (its untimed first call and its timed
     call): MPPI at the bench configuration on the kernel tier (its result
     through a ``ResultStore`` and back bit for bit); iLQR under model
     noise at scripts/noise_tests.py's configuration (kernel 5, no kernel
     6); iLQR with ddp, box_ddp and diag_hessian at scripts/ilqr_tuning.py's
     widths (kernel 6, no kernel 5); SQP under model noise at configuration
     4's widths (kernels 4 and 5); each result with the reference's keys;
     each new path at a tiny size on the card against the CPU; one
     per-step timed run;
   - the sharded paths on a one-device mesh: ``sharded_episodes_kernel``
     at the MPPI bench width and the CEM sweep's (bit for bit with
     ``run_episodes_fused``, kernel 1 or 3 once a call), ``sharded_episodes``
     (equal to ``run_episodes_batch``), the sample-sharded MPPI step at the
     bench width against the closed form and ``MPPI.solve_batch``; the
     batch-major wrappers of kernel 2 (``fused_rollout_costs``,
     ``fused_rollout_cost_samples``) at the MPPI two-stage shape, bit for
     bit; iLQR (configuration 3, both Hessians), SQP (configuration 4) and
     I2C (configuration 6) under ``pallas_backward=False`` /
     ``pallas_smoother=False`` with ``use_fused=True`` (no kernel launched,
     results against the kernel route), SWITCH_STEPS steps each;
   - the models the functors take beyond the registered plants (phases (g)
     to (j), their launches kept apart from the plants' paths): the dummy
     (S=2) on the MPPI bench and CEM sweep widths, both tiers each, episode
     medians with solves/s; make_dummy_model(8, 1) at iLQR configuration
     3's widths (exact and Gauss-Newton) and the dummy at SQP configuration
     4's, cut to FAMILY_WARM warm-start solves and FAMILY_STEPS steps, with
     kernels 4, 5 and 6 held against their plain versions on one solve's
     own inputs; cart-pole under configuration 2's weights through one call
     each of kernels 1, 2 and 3 and one Gauss-Newton iLQR configuration-3
     solve, the generic cost form's device time beside the registered
     cart-pole's specialised one; the linear model refused by
     run_episodes_fused (MPPI and iLQR) before any launch;
   - the study entry points (phase (k)): the first configuration of each
     sweep script's grid (benchmarking_mpc_solvers_tpu_torch/scripts/) at
     its full widths through the script's own run_and_store, cut to
     STUDY_STEPS steps and STUDY_WARM warm-start solves, with the launches
     its route predicts and its record read back from the store, and the
     kernels of an iLQR route held against their plain versions on one
     solve's own inputs at that configuration;
   - the measurement scripts (phase (l)): kernels 9 and 10
     (csrc/roofline.cu) against their plain versions bit for bit at the
     roofline rows' grids (kernel 9 also at a chain off its unroll), the
     noise draw's reduced libm forms (csrc/models.cuh, which kernels 1, 3
     and 10 draw through) against libm on all 2^24 inputs of each uniform,
     bit for bit (``draw_domain_check``), then roofline, profile_cem,
     profile_ilqr,
     profile_sqp, profile_i2c, bench_riccati and scaling_bench
     (benchmarking_mpc_solvers_tpu_torch/scripts/) at their full shapes
     through their own main(), MEASURE_SAMPLES timing samples a stage, each
     with the launches of its route and no other; the Riccati crossover;
     kernels 9 and 10 timed at the kernel rows' shapes beside their bound
     and the SASS issue and pipe floors of their loops;
   - the repairs and the benchmark entry points (phase (m)): kernels 1, 2
     and 3 on the dummy past S = 8 (their dummy form: S = 9, 16 and 31 at a
     small shape, S = 12 under dense weights, 1 and 3 at S = 16 under the
     mid-list and off-square weights, each with its launch configuration and
     the dummy form it must take, S = 16 at the
     MPPI bench, MPPI two-stage and CEM sweep widths, 1, 3 and 2 there beside
     the SASS issue and pipe floors of their one-term or rows-form loop
     (``DUMMY_SASS_LOOPS``), and on the MPPI and CEM tiers), kernel 7's
     shared-memory form (per problem, n = 120, B = 256, 60 iterations), kernels
     8a/8b in their general form (D, Z from 7 to 16, block edges, T = 1)
     and their wide form (D, Z from 17 to 32), timed at the sweep row's B
     and T at D = Z = 9, 16, 17 and 32 and held there on the horizon's
     first steps, ``I2C.solve_batch(use_fused=True)`` on
     make_dummy_model(S, 1) at S = 8, 15, 16 and 31, and their large form
     (D = Z = 33, its device-memory workspace), each against its plain
     version; then
     ``scripts/bench_suite.py``'s main()
     through its six configurations at full widths, cut to 1 step and one
     timing repetition (``SUITE_ARGS``), each configuration's launches by
     its route, kernels 4, 5 and 6 of configuration 5's iLQR and SQP rows held
     on one solve's own inputs at B = 10,240; and ``scripts/bench.py``'s
     main() once;
   plus small MPPI, CEM, iLQR, SQP, QP-MPC and I2C episodes on the card
   against the plain versions on the CPU, and short swing-up progress
   checks.
5. timings with CUDA events: each kernel around one call and as device
   time (calls queued behind a sleeping kernel, ``device_time_ms``), its
   plain version and its bound (for kernels 5, 6, 7, 8a and 8b also with the
   dependent chain of the horizon or of the iterations; for kernels 1, 2
   and 3 and the draw also the instruction-issue floor of the rollout (or
   draw) loop, counted in its SASS, and its pipe floor, the busiest pipe's time for the same
   instructions (``pipe_counts``); the launch shape of 1, 2, 3, 6 and 7;
   kernels 1, 2 and 7 at
   further shapes too); host-clock
   episode solves/s of every path; device time by kernel under the
   profiler (one episode of each MPPI and CEM tier, one solve of iLQR, SQP,
   QP-MPC and I2C); ``utils.device_step_latency`` and ``utils.slope_timer``
   on kernel 1 at the bench shape, within 2x of its device time.
Then a ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.

Imports only the port (``benchmarking_mpc_solvers_tpu_torch``), never JAX.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HORIZON, K_SAMPLES, BATCH, N_STEPS = 50, 32, 8192, 20
# the MPPI row of the six-family sweep (scripts/bench_suite.py:257, cart-pole,
# T = 50), at which kernel 1 is also checked and timed
MPPI_SWEEP_K, MPPI_SWEEP_B = 64, 10240
# CEM sweep (scripts/bench_suite.py:256-266) and iLQR configuration 3
# (scripts/bench_suite.py:216-223) of the reference's suite, iLQR's 20 MPC
# steps cut to ILQR_STEPS for the time limit (both Hessians)
CEM_T, CEM_K, CEM_ELITE, CEM_ITERS, CEM_B, CEM_STEPS = 50, 64, 8, 3, 10240, 10
ILQR_T, ILQR_ITERS, ILQR_B, ILQR_WARM, ILQR_STEPS, N_ALPHAS = 100, 5, 1024, 10, 3, 10
# SQP configuration 4 (its 20 steps cut to SQP_STEPS) and the QP-MPC
# configurations 1 and 2 (scripts/bench_suite.py:225-238, :168-177, :179-214;
# configuration 2's 40 steps cut to QP2_STEPS)
SQP_T, SQP_ITERS, SQP_B, SQP_STEPS, SQP_START = 100, 4, 1024, 5, (0.1, 0.0, 0.2, 0.0)
QP1_T, QP1_ITERS, QP1_B, QP1_STEPS = 20, 100, 512, 50
QP2_T, QP2_ITERS, QP2_B, QP2_STEPS, QP2_START = 50, 60, 256, 20, (0.3, 0.0, 0.4, 0.0)
# I2C configuration 6 (its 50 steps cut to I2C6_STEPS) and the I2C row of
# the six-family sweep (scripts/bench_suite.py:341-347, :251-264), starts
# jittered by 1e-3 as there
I2C6_T, I2C6_ITERS, I2C6_B, I2C6_STEPS = 25, 10, 256, 25
I2CS_T, I2CS_ITERS, I2CS_B, I2CS_STEPS = 50, 3, 10240, 10
QP2_WEIGHTS = dict(goal_x=(0.0, 0.0, 0.0, 0.0), R=((0.1,),),
                   Q=((0.5, 0, 0, 0), (0, 0.1, 0, 0), (0, 0, 5.0, 0), (0, 0, 0, 0.5)))
# Experiment paths. iLQR under model noise at scripts/noise_tests.py's
# configuration (cart-pole, T=25, max_iter=5, threshold=1e-7, sensor noise
# 0.1 with model noise, 5 repetitions); its 100 steps and warm start 50 are
# cut to EXP_NOISE_STEPS and EXP_NOISE_WARM for the time limit. The iLQR
# variants at scripts/ilqr_tuning.py's widths (pendulum, T=25, max_iter=5,
# threshold=1e-7, 5 repetitions), 100 steps and warm start 50 cut to
# EXP_VARIANT_STEPS and EXP_VARIANT_WARM. Kernels 5 and 6 are also held
# against their plain versions on one solve's inputs of those paths. SQP
# under model noise at configuration 4's widths (acrobot, T=100,
# max_iter=4, 1024 repetitions) for EXP_SQP_STEPS steps. The per-step
# timed run: MPPI at the bench widths.
EXP_NOISE_STEPS, EXP_NOISE_WARM = 5, 5
EXP_VARIANT_STEPS, EXP_VARIANT_WARM = 5, 2
EXP_SQP_STEPS, EXP_PER_STEP_STEPS = 3, 10
EXP_REPS = 5
ILQR_NOISE_CONFIG = {"T": 25, "max_iter": 5, "threshold": 1e-7, "closed_loop": False}
# the reference's results dict (benchmarking_mpc_solvers_tpu/experiment/
# experiment.py:167-201, :247-281), kept here because the card's machine has
# no JAX; tests/test_torch_experiment.py holds it against the reference
EXPERIMENT_KEYS = (
    "name", "computation_time", "timing_mode", "passed_time", "compile_time", "warmstart",
    "warmstart_trajectories", "env_name", "model_name", "agent_name", "agent_config",
    "env_start_state", "env_states", "env_actions", "env_costs", "actuation_noise",
    "sensor_noise", "model_noise", "agent_planning_states", "agent_planning_actions",
    "agent_planning_costs", "repetitions")


def experiment_keys(sensor: bool, actuation: bool, per_step: bool) -> list:
    """The sorted keys of the reference's results dict for the noise flags
    and the timing mode."""
    keys = list(EXPERIMENT_KEYS)
    if not per_step:
        keys += ["batch_costs", "batch_total_costs"]
    if sensor:
        keys += ["env_true_states", "sensor_noise_std"]
    if actuation:
        keys += ["env_true_actions", "actuation_noise_std"]
    return sorted(keys)


# Phase (k), the study entry points: the first configuration of each sweep
# script's full-mode grid (benchmarking_mpc_solvers_tpu_torch/scripts/), at
# its full widths (K, T, repetitions, solver settings), through the
# script's own run_and_store; its 100 steps (200 in experiment_test) and
# warm start 50 cut to STUDY_STEPS and STUDY_WARM for the time limit. Each
# names the kernels its route launches once a solver iteration (two calls
# of STUDY_WARM + STUDY_STEPS solves of max_iter iterations): iLQR with
# diag_hessian the line search alone (its backward pass is the variant's
# own recursion), exact-Hessian iLQR the Riccati pass and the line search,
# each held bit for bit on one solve's calls at the configuration; CEM,
# MPPI and QP-MPC take the plain batched tier, as the reference's vmapped
# solves reach no kernel, but for the noise draw: one launch a solve of MPPI
# and an iteration of CEM
STUDY_STEPS, STUDY_WARM = 5, 5
STUDY_ROUTES = {
    "experiment_test": (), "sample_test": (), "mppi_temperature": (),
    "ilqr_tuning": ("fused_linesearch",), "noise_tests": (), "new_solver_sweep": (),
    "ilqr_modern_cells": ("riccati_backward_batch", "fused_linesearch"),
}


def study_paths(counters, reset_counts, smi: str, launches: dict) -> dict:
    """Phase (k): each sweep's first configuration on the card into a
    temporary results directory, with the launch counts at 0 just before
    and read just after; its record read back from the store bit for bit,
    with the reference's keys; each kernel of its route against the plain
    version on every call of one solve at the configuration (iLQR's widths,
    repetitions and start state). Fails on any other launch count, any
    difference, and if the phase imported pandas or matplotlib."""
    import importlib
    import tempfile

    from benchmarking_mpc_solvers_tpu_torch.experiment import ResultStore
    from benchmarking_mpc_solvers_tpu_torch.scripts import _common

    dev = torch.device("cuda", 0)
    host_only = ("pandas", "matplotlib")
    loaded = {m for m in host_only if sys.modules.get(m) is not None}
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, route in STUDY_ROUTES.items():
            mod = importlib.import_module(f"benchmarking_mpc_solvers_tpu_torch.scripts.{name}")
            args = _common.std_parser("").parse_args(["--results-dir", tmp, "--no-plots"])
            collection, params, warm = next(iter(mod.grid(args)))
            full = (params["experiment_length"], warm)
            params = dict(params, experiment_length=STUDY_STEPS)
            store = ResultStore(tmp, collection)
            t0 = time.perf_counter()
            reset_counts()
            res = _common.run_and_store(store, params, STUDY_WARM, device=args.device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {fn.__name__: fn.launches for fn in counters}
            solves = 2 * (STUDY_WARM + STUDY_STEPS)
            n = solves * params["agent_config"].get("max_iter", 0)
            want = {fn.__name__: n if fn.__name__ in route else 0 for fn in counters}
            want["scenario_normals"] = {"MPPI": solves, "CEM": n}.get(params["agent"], 0)
            if res is None or got != want:
                fail(f"study {name}: launches {got}, expected {want}")
            keys = experiment_keys(res["sensor_noise"], res["actuation_noise"], False)
            if sorted(res) != keys:
                fail(f"study {name}: results keys {sorted(res)}, expected the reference's {keys}")
            (back,) = store.find()
            if sorted(set(back) - {"_id", "date"}) != keys:
                fail(f"study {name}: the stored record's keys {sorted(back)}")
            for key, val in res.items():
                same = (back[key].dtype == val.dtype and back[key].tobytes() == val.tobytes()
                        if isinstance(val, np.ndarray) else back[key] == val)
                if not same:
                    fail(f"study {name}: {key} did not come back from the store as written")
            # each kernel of the route on this configuration's own inputs:
            # every call of one solve at its agent_config and repetitions,
            # from its start state, against the plain version
            calls = {}
            for wrapper in route:
                if params["agent"] != "ILQR":
                    fail(f"study {name}: a route for {params['agent']}, spied as iLQR's")
                calls[wrapper] = ilqr_path_calls(
                    wrapper, params["env"], params["agent_config"],
                    params.get("sensor_noise", 0.0) if params.get("model_noise") else 0.0,
                    res["repetitions"], dev, x0=params["start_state"])
                if len(calls[wrapper]) != params["agent_config"]["max_iter"]:
                    fail(f"study {name}: one solve made {len(calls[wrapper])} calls of "
                         f"{wrapper}, expected max_iter")
            held = held_calls(f"study {name} ({params['env']}, B={res['repetitions']}, "
                              f"T={params['agent_config']['T']})", calls)
            launches[f"study {name}"] = got
            readings[name] = {
                "collection": collection, "agent": params["agent"], "env": params["env"],
                "agent_config": params["agent_config"], "repetitions": res["repetitions"],
                "steps": STUDY_STEPS, "warmstart": STUDY_WARM,
                "passed_time": res["passed_time"], "compile_time": res["compile_time"],
                "wall_s": wall, "launches": {k: v for k, v in got.items() if v},
                "held_calls": {k: len(v) for k, v in calls.items()},
                "held_max_abs_err": held,
                "non_finite_runs": _common.episode_counts([res])[1]}
            print(f"[{smi}] study {name} ({params['agent']} on {params['env']}, "
                  f"{params['agent_config']}, {res['repetitions']} repetitions, {STUDY_STEPS} "
                  f"steps and warm start {STUDY_WARM} of {full[0]} and {full[1]}): passed_time "
                  f"{res['passed_time']} s, compile_time {res['compile_time']} s, wall "
                  f"{wall:.1f} s, launches {readings[name]['launches']}, "
                  f"{readings[name]['non_finite_runs']} non-finite runs; the record back from "
                  f"the store bit for bit; one solve's calls held against the plain versions: "
                  f"{readings[name]['held_calls']}", flush=True)
    now = {m for m in host_only if sys.modules.get(m) is not None}
    if now != loaded:
        fail(f"study phase imported {sorted(now - loaded)}")
    return readings


# Phase (l), the measurement scripts (benchmarking_mpc_solvers_tpu_torch/
# scripts/): each at its configuration's full shapes through its own main(),
# with the kernels its route launches. The profiles take MEASURE_SAMPLES
# timing samples a stage (the scripts' default is 10), those of iLQR, SQP and
# I2C chains of one step and of at least two (--min-chains: their solves
# take 0.2-0.5 s), bench_riccati RICCATI_REPS-call chains once (its
# default: 50 and 15, three times), for the time limit; no shape is cut.
MEASURE_SAMPLES, RICCATI_REPS = 2, 2
MEASURE_ROUTES = {
    "roofline": ((), ("roofline_op", "roofline_noise")),
    "profile_cem": (("--samples", str(MEASURE_SAMPLES)),
                    ("fused_rollout_costs_tm", "fused_cem_step", "scenario_normals")),
    "profile_ilqr": (("--samples", str(MEASURE_SAMPLES), "--min-chains"),
                     ("riccati_backward_batch", "fused_linesearch")),
    "profile_sqp": (("--samples", str(MEASURE_SAMPLES), "--min-chains"),
                    ("fused_derivs", "riccati_backward_batch", "fused_linesearch")),
    "profile_i2c": (("--samples", str(MEASURE_SAMPLES), "--min-chains"),
                    ("i2c_filter", "i2c_rts_smooth")),
    "bench_riccati": (("--reps", str(RICCATI_REPS), "--outer", "1"), ()),
    "scaling_bench": ((), ("fused_mppi_step",)),
}
# kernels 9 and 10 against their plain versions before the timings: at the
# roofline rows' full grids with a reduced chain, of whole trips and (the
# second) with a remainder
ROOFLINE_CHECK_INNER, ROOFLINE_RAGGED_INNER = 64, 77
# FP32 operations of one application of each op of kernel 9, each libm call
# counted once (a lower bound): fma mul + add; log abs, add, log; div add,
# div; exp abs, neg, exp. A normal of kernel 10: NOISE_OPS and the sum's add
# (NOISE_DRAW_EXTRA); a paired draw also the sine, its product and a second
# add.
ROOFLINE_OP_OPS = {"fma": 2, "cos": 1, "sin": 1, "log": 3, "div": 2, "exp": 3}
NOISE_DRAW_EXTRA = {"single": 1, "paired": 4}
# the kernel rows' shapes (scripts/roofline.py:measure_pallas_op and
# measure_pallas_noise), at which each instantiation is timed
ROOFLINE_GRID, ROOFLINE_INNER, NOISE_PROGRAMS, NOISE_INNER = 256, 2048, 1024, 256


def roofline_loop_counts(library: Path) -> dict:
    """Per instantiation of csrc/roofline.cu ({op} of kernel 9, "single" and
    "paired" of kernel 10), the fast-path SASS instructions of one trip of
    its chain's loop (the longest loop of the function; what one trip does,
    ops/roofline.py:launch_config reports), the loop's static
    instructions and the trip's count by pipe; {} where cuobjdump is
    missing."""
    from benchmarking_mpc_solvers_tpu_torch.ops.roofline import OPS

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        return {}
    dump = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True)
    if dump.returncode != 0:
        return {}
    funcs = sass_functions(dump.stdout)
    marks = {op: ("roofline_op", f"Op{op.capitalize()}") for op in OPS}
    marks.update(single=("roofline_noise", "ILb0E"), paired=("roofline_noise", "ILb1E"))
    counts = {}
    for key, frags in marks.items():
        ins = next((v for k, v in funcs.items() if all(f in k for f in frags)), None)
        if ins is None:
            continue
        loops = [(next(j for j, (x, _) in enumerate(ins) if x == tgt), i)
                 for i, (a, text) in enumerate(ins)
                 if (tgt := _branch_target(text)) is not None and tgt <= a]
        if loops:
            head, tail = max(loops, key=lambda hl: hl[1] - hl[0])
            path = fast_path(ins, head, tail)
            counts[key] = (len(path), tail - head + 1, pipe_counts(path))
    return counts


def draw_domain_check(dev) -> dict:
    """The noise draw's reduced libm forms (csrc/models.cuh: the radius, the
    cosine of the single draw, sincos of the paired one) against libm on all
    2^24 inputs of each uniform, bit for bit, the two radii of -0.0 (u1
    rounds to 1) included; fails on any difference. Returns the summary."""
    from benchmarking_mpc_solvers_tpu_torch.ops.roofline import DOMAIN_ROWS, draw_domain

    rows = draw_domain(dev).view(torch.int32)
    torch.cuda.synchronize()
    out = {"inputs": rows.shape[1]}
    for i in range(0, len(DOMAIN_ROWS), 2):
        differ = int((rows[i] != rows[i + 1]).sum())
        out[DOMAIN_ROWS[i + 1]] = {"differ": differ}
        if differ:
            k = int(torch.nonzero(rows[i] != rows[i + 1])[0])
            fail(f"draw domain: {DOMAIN_ROWS[i + 1]} differs from libm at {differ} of "
                 f"{rows.shape[1]} inputs (first k={k}: {int(rows[i + 1, k]):#010x} against "
                 f"{int(rows[i, k]):#010x})")
    neg_zero = int((rows[0] == -2**31).sum())
    out["radius"]["negative_zeros"] = neg_zero
    if neg_zero != 2:
        fail(f"draw domain: {neg_zero} radii of -0.0 through libm, expected 2")
    print(f"draw domain: the reduced radius, cosine and sincos equal libm bit for bit on all "
          f"{rows.shape[1]} inputs of each uniform ({neg_zero} radii of -0.0 among them)",
          flush=True)
    del rows
    return out


def measurement_paths(counters, reset_counts, smi: str, launches: dict, errs: dict) -> tuple:
    """Phase (l): kernels 9 and 10 against their plain versions on the
    card; then each measurement script on the card with the launch counts
    at 0 just before and read just after, each kernel of its route launched
    and no other; then kernels 9 and 10 timed at the roofline rows' shapes
    beside their bound and the issue floor of their loops' SASS. Returns the
    scripts' records and the kernels-line entries of kernels 9 and 10."""
    import importlib

    from benchmarking_mpc_solvers_tpu_torch import _build
    from benchmarking_mpc_solvers_tpu_torch.ops.roofline import (
        OPS, launch_config, roofline_noise, roofline_noise_reference, roofline_op,
        roofline_op_reference)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(9)
    grid_x = torch.from_numpy(rng.uniform(-2.0, 2.0, (ROOFLINE_GRID, 8, 512)).astype(
        np.float32)).to(dev)
    row_x = torch.from_numpy(rng.uniform(-2.0, 2.0, (8, 512 * 1024)).astype(np.float32)).to(dev)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    for op in OPS:  # every op at both rows' shapes, identical bits
        for x, inner in ((grid_x, ROOFLINE_CHECK_INNER), (row_x, ROOFLINE_CHECK_INNER),
                         (grid_x, ROOFLINE_RAGGED_INNER)):
            got = roofline_op(op, x, inner)
            want = roofline_op_reference(op, x, inner)
            errs.setdefault(f"roofline_op[{op}]", (0.0, 0.0))
            if not torch.equal(got, want):
                fail(f"roofline_op[{op}] at {tuple(x.shape)}, inner {inner}: kernel vs plain max "
                     f"err {float((got - want).abs().max()):.3e}, expected identical bits")
    for form in ("single", "paired"):
        for inner in (ROOFLINE_CHECK_INNER, ROOFLINE_RAGGED_INNER):
            got = roofline_noise(seed, NOISE_PROGRAMS, inner, form == "paired")
            want = roofline_noise_reference(seed, NOISE_PROGRAMS, inner, form == "paired")
            if not torch.equal(got, want):
                fail(f"roofline_noise[{form}], inner {inner}: kernel vs plain max err "
                     f"{float((got - want).abs().max()):.3e}, expected identical bits")
        errs[f"roofline_noise[{form}]"] = (0.0, 0.0)
    print(f"roofline kernels: every op of kernel 9 at ({ROOFLINE_GRID}, 8, 512) and (8, 524288), "
          f"inner {ROOFLINE_CHECK_INNER}, and at ({ROOFLINE_GRID}, 8, 512), inner "
          f"{ROOFLINE_RAGGED_INNER}; both forms of kernel 10 at ({NOISE_PROGRAMS}, 8, 512), inner "
          f"{ROOFLINE_CHECK_INNER} and {ROOFLINE_RAGGED_INNER}: identical bits with the plain "
          f"versions", flush=True)
    domain = draw_domain_check(dev)

    readings, by_op, by_form = {}, {}, {}
    for name, (argv, route) in MEASURE_ROUTES.items():  # records to results_torch/measure/
        mod = importlib.import_module(f"benchmarking_mpc_solvers_tpu_torch.scripts.{name}")
        t0 = time.perf_counter()
        reset_counts()
        rec = mod.main(list(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {fn.__name__: fn.launches for fn in counters}
        bad = {k: v for k, v in got.items() if (v > 0) != (k in route)}
        if bad:
            fail(f"measure {name}: launches {got}, expected the route {route} and no other")
        if name == "roofline":
            by_op, by_form = dict(roofline_op.by_op), dict(roofline_noise.by_form)
        launches[f"measure {name}"] = got
        readings[name] = {"wall_s": wall, "launches": {k: v for k, v in got.items() if v},
                          "record": rec}
        print(f"[{smi}] measure {name}: {wall:.1f} s, launches "
              f"{readings[name]['launches']}", flush=True)

    # the Riccati crossover: per bench and B, the horizons where the scan wins
    cross = {}
    for r in readings["bench_riccati"]["record"]["lines"]:
        cross.setdefault(f"{r['bench']} B={r.get('B', '-')}", []).append(
            (r["T"], r["parallel_speedup"]))
    print(f"[{smi}] riccati crossover (T, sequential/scan time; >1: the scan wins): "
          f"{json.dumps(cross)}", flush=True)
    readings["bench_riccati"]["crossover"] = cross

    # kernels 9 and 10 at the kernel rows' shapes, beside bound and issue floor
    clock = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    counts = roofline_loop_counts(_build._target("roofline.cu"))
    src = "benchmarking_mpc_solvers_tpu_torch/csrc/roofline.cu"
    entries = []

    def entry(name, replaces, n_launch, fn, plain_fn, bnd, trips, key, cfg, per_s, per_trip):
        around, device = cuda_time_ms(fn), device_time_ms(fn)
        plain = cuda_time_ms(plain_fn, reps=3, warmup=1)
        counted = counts.get(key)
        floor = pipe = None
        if counted is not None:
            floor = counted[0] * trips / (sms * 4 * clock * 1e3)
            pipe = pipe_floor_ms(counted[2], trips, sms, clock)
        if floor is not None and device < floor / 1.05:
            fail(f"{name}: device {device:.4f} ms beats its issue floor {floor:.4f} ms by more "
                 f"than 5 %: the SASS count ({counted}) is wrong")
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": n_launch, "launches_by_path": {"measure roofline": n_launch},
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1], "ms": around,
            "device_ms": device, "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
            "chain_bound_ms": None, "issue_bound_ms": floor, "sass_per_trip": counted,
            "pipe_bound_ms": None if pipe is None else pipe[0],
            "pipe_bound_by": None if pipe is None else pipe[1], "trip": per_trip,
            "rate_per_s": per_s / (device * 1e-3), "other_shapes": [], "library_ms": None,
            "launch": cfg, "pass": True})
        print(f"[{smi}] {name}: around one call {around:.4f} ms, device {device:.4f} ms, plain "
              f"{plain:.3f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), "
              + ("issue floor not measured" if floor is None else
                 f"issue floor {floor:.4f} ms ({counted[0]} SASS instructions a trip of "
                 f"{per_trip}, {trips} warp trips), pipe floor {pipe[0]:.4f} ms ({pipe[1]}; by "
                 f"pipe {counted[2]})")
              + f"; {per_s / (device * 1e-3):.4g} a second; launch {cfg}", flush=True)

    n = grid_x.numel()
    for op in OPS:
        evals = n * ROOFLINE_INNER
        cfg = launch_config(op, n)
        entry(f"roofline_op[{op}]", "scripts/roofline.py:88", by_op.get(op, 0),
              lambda op=op: roofline_op(op, grid_x, ROOFLINE_INNER),
              lambda op=op: roofline_op_reference(op, grid_x, ROOFLINE_INNER),
              bound(8 * n, evals * ROOFLINE_OP_OPS[op]),
              -(-n // (32 * cfg["elements"])) * (ROOFLINE_INNER // cfg["unroll"]), op, cfg, evals,
              f"{cfg['unroll']} applications to each of {cfg['elements']} elements")
    n = NOISE_PROGRAMS * 8 * 512
    for form in ("single", "paired"):
        draws = n * NOISE_INNER
        cfg = launch_config("noise_paired" if form == "paired" else "noise", n)
        entry(f"roofline_noise[{form}]", "scripts/roofline.py:133", by_form.get(form, 0),
              lambda form=form: roofline_noise(seed, NOISE_PROGRAMS, NOISE_INNER,
                                               form == "paired"),
              lambda form=form: roofline_noise_reference(seed, NOISE_PROGRAMS, NOISE_INNER,
                                                         form == "paired"),
              bound(4 * n + 4, draws * (NOISE_OPS + NOISE_DRAW_EXTRA[form])),
              -(-n // 32) * (NOISE_INNER // cfg["unroll"]), form, cfg,
              draws * (2 if form == "paired" else 1),
              f"{cfg['unroll']} {'pairs' if form == 'paired' else 'draws'}")
    entries[-1]["draw_domain"] = domain
    return readings, entries


# Kernel-vs-plain tolerance. Both sides run float32 one IEEE operation at a
# time (the kernels are built with --fmad=false and accurate libm calls), so
# the rollouts agree to rounding; what differs is summation order (warp
# trees vs sequential sums) in the softmax and the plan update, ~1e-6
# relative. 1e-4 leaves room for a rollout that rounds differently near a
# branch of a clamp or floor-mod.
# The derivative kernel pushes forward-mode tangents through the model where
# its plain version differentiates in reverse mode: the same float32
# formulas in another order, a few ulps of the largest term of each sum,
# inside the same tolerance (the reference holds its kernel to 1e-5 at
# O(1) inputs). The ADMM kernel sums its matvec in the plain version's
# order and must match it bit for bit, as must the rollout-cost kernel,
# whose rollouts sum their steps in the plain version's order.
RTOL, ATOL = 1e-4, 1e-4
# Card vs CPU episodes of CEM and iLQR: the card's and the CPU's libm round
# sin/cos/log apart by an ulp; CEM's std = sqrt(m2 − m1²) of nearly equal
# elites turns that into up to 2.4e-4·|m1|, and a converged iLQR accept
# test (best < nominal within one ulp) can fall either way, a step of
# ~1e-3 (tests/test_torch_cem.py, tests/test_torch_ilqr.py).
CEM_EPISODE_TOL, ILQR_EPISODE_TOL = 1e-3, 2e-3
# SQP's accept test and argmin over alpha tie like iLQR's
# (tests/test_torch_sqp.py); QP-MPC's condensed H is factorized by another
# Cholesky routine on the card than on the CPU (tests/test_torch_qp_mpc.py)
SQP_EPISODE_TOL, QP_EPISODE_TOL = 2e-3, 1e-3
# I2C's smoother kernels match their plain versions bit for bit; around them
# the card's and the CPU's libm and matrix products round apart, and the
# line search compares three rollout costs (tests/test_torch_i2c.py)
I2C_EPISODE_TOL = 2e-3
# The sample-sharded MPPI step against the closed form and MPPI.solve_batch on
# the same deltas: the card-vs-CPU tolerance of the solver paths (the
# softmax of other sums, kernel 2's rollouts)
SHARDED_STEP_TOL = 2e-3
# Host-clock episodes of each long path (iLQR, SQP, QP-MPC configuration 2,
# I2C): its launch-count run, which follows the kernels' warm-up, is the
# first of them
LONG_EPISODE_REPS = 2
# episodes of the sharded kernel tier and of run_episodes_fused, timed in turns
SHARDED_ROUNDS = 8
# The plain routes under pallas_backward=False / pallas_smoother=False
# against the kernel routes, SWITCH_STEPS MPC steps at each configuration's
# width: the plain stages sum in another order than the kernels
# (tests/test_torch_kernel_switch.py, 2e-3 as the solver tests), so a
# scenario whose accept test, alpha argmin or line-search pick ties within
# rounding can take the other branch and its closed loop splits (1 of 128
# scenarios for iLQR configuration 3 and for I2C configuration 6 on the CPU).
# At most SWITCH_SPLIT of the scenarios may lie apart by more than SWITCH_TOL.
SWITCH_TOL, SWITCH_STEPS, SWITCH_SPLIT = 2e-3, 2, 0.05

# The model family the functors take beyond the registered plants, driven at
# the widths above (phases (g) to (j)): the dummy (models/synthetic.py) on
# the MPPI bench and CEM sweep tiers, make_dummy_model(8, 1) at iLQR
# configuration 3's widths and DummyModel at SQP configuration 4's, cut to
# FAMILY_WARM warm-start solves (iLQR; configuration 3 has 10) and
# FAMILY_STEPS MPC steps (20 in both) for the time limit; cart-pole under
# configuration 2's weights on its features (scripts/bench_suite.py:184-185)
FAMILY_WARM, FAMILY_STEPS, FAMILY_REPS = 2, 3, 2
CART2_W = (0.5, 0.1, 5.0, 0.5, 0.1)
DUMMY_START = (0.5, -0.3)

# FP32 operations per rollout step, counted by hand from csrc/models.cuh
# (each add, mul, div, clamp compare and each libm call counted once, so
# the bound is a lower bound): transform + nonzero-W cost with its clip +
# dynamics + the running sum. Cart-pole: transform 8, cost 10, dynamics 40,
# sum 1.
STEP_OPS = {"pendulum": 34, "cartpole_swingup": 59, "acrobot": 252}


def step_ops(model, split=None) -> int:
    """``STEP_OPS`` of a model under its own weights: a plant's count with
    its registered cost's terms replaced by the model's (4 a term, the clip
    2); the dummy's copies cost nothing, so its step is the cost and the
    sum. With the dummy form's ``split`` (n_lead, tail: ``dummy_split``) the
    step is the tail's terms, the clip and the sum: the leading run is work
    of a (b, t), counted apart (``lead_ops``)."""
    if split is not None:
        return 4 * split[1] + 2 + 1
    nz = len(model.state_cost.nz)
    if model.name in STEP_OPS:
        from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
        return STEP_OPS[model.name] + 4 * (nz - len(REGISTRY[model.name].state_cost.nz))
    return 4 * nz + 2 + 1


def dummy_split(model):
    """(n_lead, tail) of the dummy form's cost: the leading run that kernels
    1 and 3 sum once per (b, t) and the terms every step adds
    (``_build.dummy_terms``)."""
    from benchmarking_mpc_solvers_tpu_torch import _build

    terms, n_lead = _build.dummy_terms(model.state_cost, "cpu")
    return n_lead, terms.shape[0] - n_lead


def lead_ops(B, T, split) -> int:
    """The leading run's operations, once per (b, t) as the function needs
    them (4 a term); 0 without a split."""
    return 0 if split is None else B * T * 4 * split[0]


# the noise draw (u01 x2, +1e-7, log, -2*, sqrt, 2pi*, cos, r*), counted once
# per (b, k, t): the function needs one normal there. Where its cache does
# not fit, the kernel draws it a second time in pass 2; that is a cost of the
# design, not of the function, and is left out of the bound. MPPI extras
# per (b, k, t): pass 1 std*d, plan+sd, control term (3); pass 2 w*(std*d)
# and += (std*d is pass 1's). Per (b, k), the softmax: the min, c - beta,
# /lam, exp, the weight sum and w/sum, once per sample as the function
# needs them.
NOISE_OPS, PASS1_EXTRA, PASS2_EXTRA, MPPI_WEIGHT_OPS = 9, 5, 2, 6
# the two-stage tiers' draw (csrc/fused_rollout.cu:scenario_normals_kernel):
# a normal is NOISE_OPS and the product by the scale
DRAW_OPS = NOISE_OPS + 1
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
# ADMM, per row and iteration, as the function needs them: the matvec's n
# products and n - 1 adds (2n - 1), v = rho*(z-y)-g (3), u' (3), u' + y (1),
# the clip (2), y+ = (u' + y) - z+ (1, the sum before the clip reused)
ADMM_ROW_OPS = lambda n: 2 * n + 9  # noqa: E731
# kernel 7 at a problem of n > 240 (the streaming form), timed beside its
# shapes of the suite: the shared layout, as QP-MPC at linearize_at="goal"
ADMM_BIG_N, ADMM_BIG_B, ADMM_BIG_ITERS = 300, 512, 20
# kernel 7's shared-memory form (64 < n <= 240) as kernel_ab.py times it, (B, n, iterations)
ADMM_SHARED_SHAPE = (256, 120, 60)
PEAK_FP32 = 67e12  # H100 SXM FP32 (non-tensor) FLOP/s, published, at 700 W
# a dependent FP32 operation's latency in cycles, the least the card's
# pipeline takes (a square root or a division takes many more)
FP32_LATENCY_CYCLES = 4
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


def chol_ops(n: int) -> int:
    """FP32 operations of the unrolled n x n Cholesky factorisation in
    csrc/i2c_smooth.cu: entry (i, j) takes j multiply-subtracts and a square
    root or a division; each diagonal entry one more for its floor."""
    return sum(2 * j + 1 for i in range(n) for j in range(i + 1)) + n


def i2c_filter_ops(D: int, Z: int) -> int:
    """FP32 operations of one filter step in csrc/i2c_smooth.cu: each sum
    of n products counts 2n, each added term 1."""
    return (D * Z * 2 * D                       # P J^T
            + Z * (Z + 1) // 2 * (2 * D + 1)    # lower triangle of sig_y
            + chol_ops(Z)
            + D * 2 * Z * Z                     # D pairs of triangular solves
            + Z * (2 * D + 2)                   # innovation
            + D * (2 * Z + 1)                   # mu_f
            + D * D * (2 * Z + 1) + 2 * D * D   # sig_f and its symmetrising
            + D * (2 * D + 1)                   # mu_pred
            + D * D * 2 * D + D * D * (2 * D + 1))  # F sig_f, sig_pred


def i2c_rts_ops(D: int) -> int:
    """FP32 operations of one smoother step in csrc/i2c_smooth.cu."""
    return (D * D * 2 * D + chol_ops(D) + D * 2 * D * D   # F sig_f, factor, D solves
            + D + D * (2 * D + 1)                         # mu_s
            + D * D + D * D * 2 * D + D * D * (2 * D + 1))  # sig_s


def i2c_work(p, clock_mhz: float) -> tuple:
    """(bytes, operations, chain ms) of the filter and of the smoother on
    the problem ``p`` (the filter's arguments): each input read once, each
    output written once; the horizon's loop-carried chain at the clock."""
    B_, T_, D = p[0].shape[:3]
    Zf = p[2].shape[2]
    pts = B_ * T_
    shared = 2 * D * D + T_ * Zf + p[4].numel() + B_ * D  # sig0, Qproc, g_z, R, mu0
    return ((4 * (pts * (D * D + D + Zf * D + Zf + 2 * (D + D * D)) + shared),
             pts * i2c_filter_ops(D, Zf), chain_ms(T_, i2c_filter_chain(D, Zf), clock_mhz)),
            (4 * (pts * (2 * (D + D * D) + D * D + D)), pts * i2c_rts_ops(D),
             chain_ms(T_ - 1, i2c_rts_chain(D), clock_mhz)))


def _dep(*depths):
    """Depth of one operation on operands of the given depths: one more
    than the deepest. None marks a value the chain does not wait for (an
    input of the step, which a kernel may load or compute ahead)."""
    known = [d for d in depths if d is not None]
    return max(known) + 1 if known else None


def _sum(terms):
    """A sum taken from 0 upwards, as the reference takes it (0 + t0 is an
    operation of its own)."""
    s = None
    for t in terms:
        s = _dep(s, t)
    return s


def _chol_depths(A, n):
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = _dep(s, _dep(L[i][k], L[j][k]))
            L[i][j] = _dep(_dep(s)) if i == j else _dep(s, L[j][j])  # floor, sqrt
    return L


def _solve_depths(L, b, n):
    y, x = [None] * n, [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = _dep(s, _dep(L[i][k], y[k]))
        y[i] = _dep(s, L[i][i])
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = _dep(s, _dep(L[k][i], x[k]))
        x[i] = _dep(s, L[i][i])
    return x


def _filter_step_depth(D, Z, sig, mu):
    """Deepest new carried value (predicted covariance and mean) of one
    filter step of csrc/i2c_smooth.cu, from carried depths sig and mu."""
    rd, rz = range(D), range(Z)
    sig_p, mu_p = [[sig] * D for _ in rd], [mu] * D
    PJt = [[_sum(_dep(sig_p[i][k], None) for k in rd) for _ in rz] for i in rd]
    sig_y = [[_dep(None, _sum(_dep(None, PJt[k][c]) for k in rd)) for c in rz] for _ in rz]
    Lc = _chol_depths(sig_y, Z)
    sols = [_solve_depths(Lc, PJt[i], Z) for i in rd]
    innov = [_dep(None, _dep(_sum(_dep(None, mu_p[k]) for k in rd), None)) for _ in rz]
    mu_f = [_dep(mu_p[i], _sum(_dep(sols[i][a], innov[a]) for a in rz)) for i in rd]
    sf = [[_dep(sig_p[i][j], _sum(_dep(sols[i][a], PJt[j][a]) for a in rz)) for j in rd]
          for i in rd]
    sig_f = [[_dep(_dep(sf[i][j], sf[j][i])) for j in rd] for i in rd]
    FS = [[_sum(_dep(None, sig_f[k][j]) for k in rd) for j in rd] for _ in rd]
    new = [_dep(_sum(_dep(FS[i][k], None) for k in rd), None) for i in rd for _ in rd]
    new += [_dep(None, _sum(_dep(None, mu_f[k]) for k in rd)) for _ in rd]
    return max((d for d in new if d is not None), default=0)


def i2c_filter_chain(D: int, Z: int) -> int:
    """Dependent FP32 operations of one filter step's loop-carried chain in
    csrc/i2c_smooth.cu: the longest path from one step's predicted
    covariance (or mean) to the next step's, every sum in the reference
    order, a square root, a division and the Cholesky floor each one
    operation. T of them in a row are a lower bound of the horizon's time."""
    return max(_filter_step_depth(D, Z, 0, None), _filter_step_depth(D, Z, None, 0))


def _rts_step_depth(D, sig, mu):
    rd = range(D)
    sig_next, mu_next = [[sig] * D for _ in rd], [mu] * D
    # G, its factor and M come from the step's inputs alone
    new = [_dep(None, _sum(_dep(None, _dep(mu_next[k], None)) for k in rd)) for _ in rd]
    Dlt = [[_dep(sig_next[i][j], None) for j in rd] for i in rd]
    GD = [[_sum(_dep(None, Dlt[k][j]) for k in rd) for j in rd] for _ in rd]
    new += [_dep(None, _sum(_dep(GD[i][k], None) for k in rd)) for i in rd for _ in rd]
    return max((d for d in new if d is not None), default=0)


def i2c_rts_chain(D: int) -> int:
    """The smoother's loop-carried chain per step, as ``i2c_filter_chain``:
    the gain G does not depend on the carry, so only sig_s and mu_s are on it."""
    return max(_rts_step_depth(D, 0, None), _rts_step_depth(D, None, 0))


def _riccati_step_depth(S, vxx, vx, with_c):
    """Deepest new carried value (V_xx or V_x) of one step of
    csrc/riccati_backward.cu, from carried depths vxx and vx; the step's
    inputs (f_x, f_u, l_*, c, mu) are off the chain."""
    rs = range(S)
    vxc = [_dep(vx, _sum(_dep(vxx, None) for _ in rs)) if with_c else vx for _ in rs]
    m = [[_sum(_dep(vxx, None) for _ in rs) for _ in rs] for _ in rs]
    w = [_sum(_dep(vxx, None) for _ in rs) for _ in rs]
    q_x = [_dep(None, _sum(_dep(None, vxc[i]) for i in rs)) for _ in rs]
    q_u = _dep(None, _sum(_dep(None, vxc[i]) for i in rs))
    q_xx = [[_dep(None, _sum(_dep(None, m[i][jp]) for i in rs)) for jp in rs] for _ in rs]
    q_uu = _dep(None, _sum(_dep(None, w[i]) for i in rs))
    q_ux = [_dep(None, _sum(_dep(None, m[i][j]) for i in rs)) for j in rs]
    inv = _dep(_dep(_dep(_dep(q_uu, None))))  # + mu*fufu, the PD test, its select, 1/x
    k = _dep(_dep(q_u), inv)
    K = [_dep(_dep(_dep(q_ux[j], None)), inv) for j in rs]  # + mu*(f_u f_x), -, * inv
    new = [_dep(_dep(q_x[j], _dep(K[j], _dep(_dep(q_uu, k), q_u))), _dep(q_ux[j], k))
           for j in rs]
    vnew = [[_dep(_dep(_dep(q_xx[j][jp], _dep(_dep(K[j], q_uu), K[jp])), _dep(K[j], q_ux[jp])),
                  _dep(q_ux[j], K[jp])) for jp in rs] for j in rs]
    new += [_dep(_dep(vnew[j][jp], vnew[jp][j])) for j in rs for jp in rs]
    return max((d for d in new if d is not None), default=0)


def riccati_chain(S: int, with_c: bool = False) -> int:
    """Dependent FP32 operations of one Riccati step's loop-carried chain in
    csrc/riccati_backward.cu, from one step's V_xx (or V_x) to the next's,
    every sum in the reference order and the division one operation, as
    ``i2c_filter_chain`` counts. T of them in a row bound the horizon's time."""
    return max(_riccati_step_depth(S, 0, None, with_c), _riccati_step_depth(S, None, 0, with_c))


def _clamp_depth(d):
    """A clip: a max and a min."""
    return _dep(_dep(d))


def _pendulum_step_depths(x, u):
    """Depths of the pendulum functor's next state (csrc/models.cuh), from
    the depths of its state and action."""
    torque = _clamp_depth(u)
    newthdot = _dep(x[1], _dep(_dep(_dep(_dep(_dep(x[0]))), _dep(torque))))  # sin(th + pi)
    newth = _dep(x[0], _dep(newthdot))
    return [newth, _clamp_depth(newthdot)]


def _cartpole_step_depths(x, u):
    """Depths of the cart-pole functor's next state."""
    action = _dep(_clamp_depth(u))  # clip, * FORCE_MAG
    s, c = _dep(x[2]), _dep(x[2])  # sinf, cosf
    td2, c2 = _dep(x[3], x[3]), _dep(c, c)
    num1 = _dep(_dep(_dep(_dep(_dep(td2), s), _dep(_dep(s), c)), _dep(action)), _dep(x[1]))
    den = _dep(_dep(c2))
    num2 = _dep(_dep(_dep(_dep(_dep(td2), s), c), _dep(s)),
                _dep(_dep(_dep(action, _dep(x[1]))), c))
    return [_dep(x[0], _dep(x[1])), _dep(x[1], _dep(_dep(num1, den))), _dep(x[2], _dep(x[3])),
            _dep(x[3], _dep(_dep(num2, den)))]


def _acrobot_dsdt_depths(s, a):
    cos2, sin2 = _dep(s[1]), _dep(s[1])
    d1 = _dep(_dep(_dep(None, _dep(_dep(None, _dep(cos2))))))  # + I1 + I2 folded: two adds
    d1 = _dep(d1)
    d2 = _dep(_dep(_dep(None, _dep(cos2))))
    phi2 = _dep(_dep(_dep(_dep(s[0], s[1]))))  # (t1 + t2 - pi/2), cos, * k
    phi1 = _dep(_dep(_dep(_dep(_dep(_dep(s[3], s[3])), sin2),
                          _dep(_dep(_dep(_dep(s[3]), s[2]), sin2))),
                     _dep(_dep(_dep(s[0])))), phi2)
    dd2 = _dep(_dep(_dep(_dep(a, _dep(_dep(d2, d1), phi1)),
                         _dep(_dep(_dep(s[2], s[2])), sin2)), phi2),
               _dep(None, _dep(_dep(d2, d2), d1)))
    dd1 = _dep(_dep(_dep(_dep(d2, dd2), phi1)), d1)
    return [s[2], s[3], dd1, dd2]


def _acrobot_step_depths(x, u):
    """Depths of the acrobot functor's next state: RK4 over dsdt, the wraps
    (fmodf, the sign test's add, the offsets) and the velocity clips."""
    k1 = _acrobot_dsdt_depths(x, u)
    y = [_dep(x[i], _dep(k1[i])) for i in range(4)]
    k2 = _acrobot_dsdt_depths(y, u)
    y = [_dep(x[i], _dep(k2[i])) for i in range(4)]
    k3 = _acrobot_dsdt_depths(y, u)
    y = [_dep(x[i], _dep(k3[i])) for i in range(4)]
    k4 = _acrobot_dsdt_depths(y, u)
    ns = [_dep(x[i], _dep(_dep(_dep(_dep(k1[i], _dep(k2[i])), _dep(k3[i])), k4[i])))
          for i in range(4)]
    wrap = lambda d: _dep(_dep(_dep(_dep(d))))  # noqa: E731  - lo, fmodf, + span, + lo
    return [wrap(ns[0]), wrap(ns[1]), _clamp_depth(ns[2]), _clamp_depth(ns[3])]


STEP_DEPTHS = {"pendulum": _pendulum_step_depths, "cartpole_swingup": _cartpole_step_depths,
               "acrobot": _acrobot_step_depths}


def admm_chain(n: int) -> int:
    """Dependent FP32 operations one ADMM iteration carries into the next,
    as the function needs them (the reference's row sum starts from its
    first product): v = rho*(z - y) - g (3), the first product (1), the
    row's n - 1 adds in order (n - 1), u' = alpha*u + (1 - alpha)*z (2),
    + y and the clip's two compares (3), and y+ = (u' + y) - z+ after the
    clip (1). The other products run beside the adds; the kernel's own add
    of its first product to 0, the round trip of v through shared memory
    and the zero terms up to the register form's row width (n rounded up
    to a multiple of 4) are costs of the design, left out."""
    return 3 + 1 + (n - 1) + 2 + 3 + 1


def linesearch_chain(name: str) -> int:
    """Dependent FP32 operations of one feedback step's loop-carried chain in
    csrc/fused_linesearch.cu: from one step's state through the feedback
    sum (in the reference order), the clip and the model functor's step to
    the next state; each libm call (sinf, cosf, fmodf) and each division one
    operation, as ``riccati_chain`` counts, so that T of them in a row are a
    lower bound of the horizon's time. The step's inputs (gains, reference
    state, us + alpha*ks) and the stage cost are off the chain."""
    S = len(STEP_DEPTHS[name]([0] * 4, 0))
    fb = _sum(_dep(None, _dep(0, None)) for _ in range(S))  # K_i * (x_i - xref_i)
    u = _clamp_depth(_dep(None, fb))
    return max(STEP_DEPTHS[name]([0] * S, u))


def derivs_ops(model) -> int:
    """FP32 operations fused_derivs needs per point, a lower bound counted
    from csrc/fused_derivs.cu: one primal pass of dynamics + transform (the
    rollout step without its cost and running sum), S+1 tangent pushes of
    at least as many operations each, the residual c, and the Gauss-Newton
    products over the nonzero entries of W_sym."""
    S = model.state_size
    D = Z = S + 1
    W = np.asarray(model.state_cost.W)
    Wsym = 0.5 * (W + W.T)
    nnz, rows = int((Wsym != 0).sum()), int((Wsym != 0).any(axis=1).sum())
    cost_ops = 4 * len(model.state_cost.nz) + 2
    primal = step_ops(model) - cost_ops - 1
    gn = (Z + 2 * nnz) + D * (2 * rows + 1) + D * (2 * nnz + D * (2 * rows + 1))
    return (1 + D) * primal + 2 * S * D + gn


def ilqr_derivs_for(name, B, T, dev):
    """The Riccati kernel's inputs at an iLQR iteration: the model's exact
    derivatives along rollouts of the solver's initial plans from small
    random starts (l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u)."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.rollout import simulate_trajectory
    from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR
    model = REGISTRY[name]
    solver = ILQR(model=model, T=T)
    gen = torch.Generator(device=dev).manual_seed(5)
    x0 = 0.3 * torch.randn((B, model.state_size), generator=gen, device=dev)
    us = solver.init_state_batch(B, gen, dev).planned_us
    gz = torch.zeros((T, model.goal_size), device=dev)
    xs, _ = simulate_trajectory(model, x0, us, gz)
    return [t.contiguous() for t in solver.derivatives(xs, us, gz)]


def ilqr_path_calls(wrapper: str, env_name: str, agent_config: dict, noise_std: float, B: int,
                    dev, x0=None) -> list:
    """The arguments (args, kwargs) of every call that one iLQR solve of an
    Experiment path makes to a kernel wrapper of ``solvers/ilqr.py``
    (``riccati_backward_batch`` or ``fused_linesearch``, by name), from the
    path's start state ``x0`` (default the environment's) and the solver's
    initial plans, so that the kernel can be held against its plain version
    on exactly those inputs."""
    from benchmarking_mpc_solvers_tpu_torch.envs.env import REGISTRY as ENVS
    from benchmarking_mpc_solvers_tpu_torch.experiment import make_solver
    from benchmarking_mpc_solvers_tpu_torch.solvers import ilqr as ilqr_module
    env = ENVS[env_name]
    solver = make_solver("ILQR", env.model, agent_config, model_noise_std=noise_std)
    st = solver.init_state_batch(B, torch.Generator(device=dev).manual_seed(0), dev)
    x0 = env.start_state(dev) if x0 is None else torch.as_tensor(x0, dtype=torch.float32,
                                                                  device=dev)
    x0 = x0.expand(B, -1).contiguous()
    gz = torch.zeros((solver.T, env.model.goal_size), device=dev)
    return spy_calls([(ilqr_module, wrapper)], lambda: solver.solve_batch(st, x0, gz))[wrapper]


def spy_calls(targets, run) -> dict:
    """The arguments (args, kwargs) of every call that ``run()`` makes to
    each kernel wrapper ``targets`` names as (module, name) (the name it is
    called by there), by name; the wrappers still run, so the path's own
    inputs can be held against the plain versions afterwards."""
    calls = {name: [] for _, name in targets}
    reals = [(module, name, getattr(module, name)) for module, name in targets]

    def spy(name, real):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return real(*args, **kwargs)
        call.launches = 0  # a wrapper spied in its own module counts its launches here
        return call

    for module, name, real in reals:
        setattr(module, name, spy(name, real))
    try:
        run()
    finally:
        for module, name, real in reals:
            real.launches += getattr(module, name).launches
            setattr(module, name, real)
    return calls


def held_calls(label, calls) -> dict:
    """Each call of kernels 4, 5 and 6 that ``spy_calls`` captured, against
    its plain version on the path's own inputs: 5 and 6 bit for bit, 4
    within the tolerance. Returns each kernel's largest errors."""
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import (
        fused_derivs, fused_derivs_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import (
        fused_linesearch, fused_linesearch_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.riccati_backward import (
        riccati_backward_batch, riccati_backward_batch_reference)
    errs_ = {}
    for i, (args, kw) in enumerate(calls.get("fused_derivs", [])):
        got, want = fused_derivs(*args, **kw), fused_derivs_reference(*args, **kw)
        e = max(compare(f"fused_derivs[{label}, iteration {i}] {key}", g, w)
                for key, g, w in zip(("A", "Bd", "c", "Q", "R", "M", "q", "r"), got, want))
        errs_["fused_derivs"] = max(errs_.get("fused_derivs", e), e)
    for i, (args, kw) in enumerate(calls.get("riccati_backward_batch", [])):
        got = riccati_backward_batch(*args, **kw)
        want = riccati_backward_batch_reference(*args, **kw)
        for key, g, w in zip(("ks", "Ks", "ok"), got, want):
            exact_nan(f"riccati_backward_batch[{label}, iteration {i}] {key}", g.float(),
                      w.float())
    for i, (args, kw) in enumerate(calls.get("fused_linesearch", [])):
        got = fused_linesearch(*args, **kw)
        want = fused_linesearch_reference(*args, **kw)
        for key, g, w in zip(("us", "xs", "costs") if len(got) == 3 else ("us", "costs"),
                             got, want):
            exact_nan(f"fused_linesearch[{label}, iteration {i}] {key}", g, w)
        e = compare(f"fused_linesearch[{label}, iteration {i}] costs", got[-1], want[-1])
        errs_["fused_linesearch"] = max(errs_.get("fused_linesearch", e), e)
    return errs_


def derivs_inputs_for(model, B, T, seed, rolled, dev):
    """fused_derivs' inputs: plans with some controls on the action bounds
    and, rolled, the states they roll out to from random starts, else
    uniform states (for the pendulum, angles on both sides of the wrap)."""
    from benchmarking_mpc_solvers_tpu_torch.ops.rollout import simulate_trajectory
    rng = np.random.default_rng(seed)
    S = model.state_size
    hi = float(model.bounds_high[0])
    us = rng.uniform(-1.2, 1.2, (B, T, 1)).astype(np.float32) * (0.3 * hi if rolled else hi)
    us[::7, ::5], us[1::7, ::5] = hi, -hi
    us = torch.from_numpy(np.clip(us, -hi, hi)).to(dev)
    gz = torch.from_numpy(rng.uniform(-0.2, 0.2, (T, S + 1)).astype(np.float32)).to(dev)
    if rolled:
        x0 = torch.from_numpy((0.3 * rng.standard_normal((B, S))).astype(np.float32)).to(dev)
        xs, _ = simulate_trajectory(model, x0, us, gz)
    else:
        span = 4.0 if model.name == "pendulum" else 1.2
        xs = torch.from_numpy(
            rng.uniform(-span, span, (B, T + 1, S)).astype(np.float32)).to(dev)
    return xs.contiguous(), us.contiguous(), gz


def sqp_riccati_inputs_for(B, T, dev):
    """The Riccati kernel's inputs at an SQP iteration of configuration 4
    (SQP._subproblem on the fused tier): the acrobot's Gauss-Newton terms
    along rolled-out trajectories, c = 0, R + reg with reg = 1e-6, mu = 0.
    Returns (l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u, mu, c)."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import fused_derivs
    from benchmarking_mpc_solvers_tpu_torch.ops.linearize import gn_terminal_terms
    model = REGISTRY["acrobot"]
    xs, us, gz = derivs_inputs_for(model, B, T, 9, True, dev)
    A, Bd, c, Q, R, M, q, r = fused_derivs(model, xs, us, gz)
    qf, Qf = gn_terminal_terms(model, xs[:, -1], gz[-1])
    l_x = torch.cat([q, qf[:, None]], dim=1).contiguous()
    l_xx = torch.cat([Q, Qf[:, None]], dim=1).contiguous()
    return [l_x, r.contiguous(), l_xx, (R + 1e-6).contiguous(), M.contiguous(), A.contiguous(),
            Bd.contiguous(), torch.zeros((B,), device=dev), torch.zeros_like(c)]


def ls_inputs_for(model, B, T, seed, dev):
    """The line-search kernel's inputs at an iteration: small random plans,
    gains and feedforward terms, and the reference trajectory the plans roll
    out to from random starts. Returns (x0, us, ks, Ks, xref, g_z)."""
    from benchmarking_mpc_solvers_tpu_torch.ops.rollout import simulate_trajectory
    rng = np.random.default_rng(seed)
    S = model.state_size
    x0 = torch.from_numpy((0.3 * rng.standard_normal((B, S))).astype(np.float32)).to(dev)
    us = torch.from_numpy((0.5 * rng.standard_normal((B, T, 1))).astype(np.float32)).to(dev)
    gz = torch.zeros((T, model.goal_size), device=dev)
    xref, _ = simulate_trajectory(model, x0, us, gz)
    ks = torch.from_numpy((0.3 * rng.standard_normal((B, T, 1))).astype(np.float32)).to(dev)
    Ks = torch.from_numpy((0.05 * rng.standard_normal((B, T, 1, S))).astype(np.float32)).to(dev)
    return x0, us, ks, Ks, xref.contiguous(), gz


def qp1_problem_for(B, dev):
    """What QP-MPC configuration 1 hands the ADMM kernel (shared layout,
    n = 20) at B pendulum states jittered around the start."""
    from benchmarking_mpc_solvers_tpu_torch.envs import PendulumEnv
    from benchmarking_mpc_solvers_tpu_torch.solvers import QPMPC
    solver = QPMPC(model=PendulumEnv.model, T=QP1_T, method="admm", iters=QP1_ITERS)
    xs = PendulumEnv.start_state(dev).expand(B, -1) + 0.3 * torch.randn(
        (B, 2), generator=torch.Generator(device=dev).manual_seed(10), device=dev)
    return solver.admm_problem(xs)


def random_qps_for(B, n, per_problem, per_bounds, seed, dev):
    """(Minv, g, lo, hi) of B random box-QPs of n variables: Minv (n, n)
    shared or (B, n, n) per problem, bounds (n,) or (B, n) per problem."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(((B,) if per_problem else ()) + (n, n))
    H = a @ np.swapaxes(a, -1, -2) / n + np.eye(n)
    shape = (B, n) if per_bounds else (n,)
    arrays = (np.linalg.inv(H + np.eye(n)), 2.0 * rng.standard_normal((B, n)),
              -rng.uniform(0.2, 1.0, shape), rng.uniform(0.2, 1.0, shape))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


def sass_functions(sass: str) -> dict:
    """{mangled name: [(address, instruction), ...]} of a cuobjdump -sass dump."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _branch_target(ins: str):
    m = re.search(r"\bBRA\s+(?:`\(\S+\)\s*)?(0x[0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def fast_path(ins, head: int, tail: int) -> list:
    """The instructions one trip of the loop ins[head..tail] (indices; tail
    its back-edge) issues on its fast path: a forward branch that jumps over
    a call (a division's or a square root's slow path) or over a loop (a
    sine's or cosine's argument reduction for huge arguments) is taken, any
    other unconditional one is followed, any other conditional one falls
    through."""
    at = {a: i for i, (a, _) in enumerate(ins)}
    path, i = [], head
    while i <= tail:
        a, text = ins[i]
        path.append(text)
        tgt = _branch_target(text)
        if i == tail or tgt is None or tgt <= a or tgt not in at:
            i += 1
            continue
        j = at[tgt]
        skipped = ins[i + 1:j]
        jumps_slow = any("CALL" in t or ((b := _branch_target(t)) is not None and b <= x)
                         for x, t in skipped)
        i = j if (not text.startswith("@") or jumps_slow) else i + 1
    return path


# The pipes an SM issues a trip's instructions to, with their results a
# clock per SM on compute capability 9.0 (the CUDA C++ programming guide's
# table of arithmetic instruction throughput): FP32 add, multiply and fma
# 128; MUFU (reciprocal, reciprocal square root, log2, exp2, sine, cosine)
# 16; type conversions 16; 32-bit integer multiply-add (IMAD in all its
# forms: the compiler also moves and adds with it) 64; everything else
# (integer add, shift and logic, compares, selects, min/max, moves,
# branches) at the table's 64 of integer add, shift, logic and compare.
PIPE_RATES = {"fp32": 128, "mufu": 16, "conversion": 16, "imad": 64, "other": 64}
_FP32_OPS = ("FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "HFMA2", "HADD2", "HMUL2")
_CONVERSIONS = ("I2F", "F2I", "I2FP", "F2IP", "F2F", "FRND")


def pipe_of(text: str) -> str:
    """The pipe of one SASS instruction (``PIPE_RATES``' keys)."""
    op = (text.split()[1] if text.startswith("@") else text.split()[0]).split(".")[0]
    if op in _FP32_OPS:
        return "fp32"
    if op == "MUFU":
        return "mufu"
    if op in _CONVERSIONS:
        return "conversion"
    if op == "IMAD":
        return "imad"
    return "other"


def pipe_counts(path) -> dict:
    """A trip's instructions by pipe."""
    counts = dict.fromkeys(PIPE_RATES, 0)
    for text in path:
        counts[pipe_of(text)] += 1
    return counts


def pipe_floor_ms(pipes: dict, warp_trips: int, sms: int, clock_mhz: float) -> tuple:
    """The least time the busiest pipe takes for ``warp_trips`` warp trips of
    a loop whose trip issues ``pipes`` (by pipe), spread over every SM at the
    card's maximum clock, and that pipe."""
    cycles = {p: n * 32 / PIPE_RATES[p] for p, n in pipes.items()}
    busiest = max(cycles, key=cycles.get)
    return cycles[busiest] * warp_trips / (sms * clock_mhz * 1e3), busiest


# The cart-pole rollout loop of kernels 3, 1 and 2 in their SASS, by source:
# the function (the first of the names found: the form compiled for
# cart-pole's cost terms, kCostTerms = term(0, 0) | term(2, 2) = 131073, in
# kernel 1 its noise-cache form; else a build from before the generic form,
# or before kernel 1 had a cache form) and the least count of
# each instruction that marks the loop. Kernels 3 and 1 draw noise in it
# (the square root's MUFU.RSQ) beside the model's two divisions (MUFU.RCP);
# kernel 2 draws none, and its loop is the one with the two divisions and
# the load of us (LDG).
SASS_LOOPS = {
    "fused_cem.cu": (("fused_cem_kernelIN4bmpc8CartPoleELm131073E",
                      "fused_cem_kernelIN4bmpc8CartPoleE"), {"MUFU.RSQ": 1, "MUFU.RCP": 2}),
    "fused_mppi.cu": (("fused_mppi_kernelIN4bmpc8CartPoleELb1ELm131073E",
                       "fused_mppi_kernelIN4bmpc8CartPoleELb1E",
                       "fused_mppi_kernelIN4bmpc8CartPoleE"), {"MUFU.RSQ": 1, "MUFU.RCP": 2}),
    "fused_rollout.cu": (("fused_rollout_kernelIN4bmpc8CartPoleELm131073E",
                          "fused_rollout_kernelIN4bmpc8CartPoleE"), {"MUFU.RCP": 2, "LDG": 1}),
}


# The dummy form's rollout loop of kernels 3 and 1 (the one-term tail, the
# identity's; kernel 1 in its noise-cache form): a loop without the plants'
# divisions. Kernel 3's is the loop with the draw's MUFU.RSQ and the loads of
# mean, std and the step's staged record (pass 2's loop over the elites loads
# two words); kernel 1's is the only loop of its cache form that draws.
# Kernel 2's rows form at rows of 16 without action terms (the identity's at
# S = 13 to 16): the step loop, with its five float4 loads of the staged
# goals and the next step's action (the staging loop stores, not loads,
# shared memory).
DUMMY_SASS_LOOPS = {
    "fused_cem.cu": (("fused_cem_dummy_kernelILi0E",), {"MUFU.RSQ": 1, "LDS": 3}),
    "fused_mppi.cu": (("fused_mppi_dummy_kernelILb1ELi0E",), {"MUFU.RSQ": 1}),
    "fused_rollout.cu": (("fused_rollout_dummy_rows_kernelILi16ELb0E",), {"LDS": 5, "LDG": 1}),
}


# The draw kernel's loop, a lane's element a trip: the loop with the two
# shuffles of the column's counter base and sample index and the store.
DRAW_SASS_LOOPS = {"fused_rollout.cu": (("scenario_normals_kernel",), {"SHFL": 2, "STG": 1})}


def rollout_loop_count(sass: str, source: str, loops: dict = SASS_LOOPS):
    """The fast-path instructions per trip of the rollout's time loop in a
    build of ``source`` (``loops``: ``SASS_LOOPS`` or ``DUMMY_SASS_LOOPS``):
    the innermost loop that holds the instructions that mark it. Returns
    (count, static instructions of the loop, the count by pipe), or None
    where no such function or loop is found."""
    names, marks = loops[source]
    funcs = sass_functions(sass)
    ins = next((v for name in names for k, v in funcs.items() if name in k), None)
    if ins is None:
        return None
    best = None
    for i, (a, text) in enumerate(ins):
        tgt = _branch_target(text)
        if tgt is None or tgt > a:
            continue
        head = next(j for j, (x, _) in enumerate(ins) if x == tgt)
        body = [t for _, t in ins[head:i + 1]]
        if (all(sum(m in t for t in body) >= n for m, n in marks.items())
                and (best is None or i - head < best[1] - best[0])):
            best = (head, i)
    if best is None:
        return None
    path = fast_path(ins, *best)
    return len(path), best[1] - best[0] + 1, pipe_counts(path)


def sass_loop(library: Path, source: str, loops: dict = SASS_LOOPS):
    """``rollout_loop_count`` of a built library of ``source`` (cuobjdump),
    or None where the toolkit has no cuobjdump or no loop is found."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        return None
    dump = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True)
    return rollout_loop_count(dump.stdout, source, loops) if dump.returncode == 0 else None


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median over reps of CUDA events around one call of fn on an idle
    card: the time holds the call's host work before its launch (a
    wrapper's checks and allocations) as well as its device time."""
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


# cycles the sleeping kernel spins while the host enqueues the timed calls
SLEEP_CYCLES = 20_000_000
QUEUED_CALLS = 20


def device_time_ms(fn) -> float:
    """Device time of one call of fn: CUDA events around QUEUED_CALLS calls
    queued behind a sleeping kernel, per call. The host has enqueued them
    before the card reaches them, so its work before each launch stays out."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(QUEUED_CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / QUEUED_CALLS


def episode_seconds(run, reps: int, warmup: bool = True):
    """Host-clock times of whole episodes, each ending in a synchronise,
    after one untimed warm-up episode (left out for the long episodes that
    the launch-count run has already warmed)."""
    if warmup:
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


def exact_nan(name, got, want):
    """``exact`` for float32 outputs that may hold NaN: NaN at the same
    places in both, every other entry the same bits (a zero's sign too).
    Returns the largest absolute and relative differences off the NaN."""
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan) or not torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32)):
        fail(f"{name}: kernel and plain version differ")
    print(f"{name}: identical{f' ({int(nan.sum())} NaN alike)' if bool(nan.any()) else ''}",
          flush=True)
    g, w = got[~nan].double(), want[~nan].double()
    if g.numel() == 0:
        return 0.0, 0.0
    diff = (g - w).abs()
    return float(diff.max()), float((diff / w.abs().clamp_min(1e-30)).max())


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
        n_kernels = sum(r[2] for r in by_kernel)
        print(f"[{smi}] profiled {label}: wall {wall_ms:.2f} ms, device busy "
              f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
              f"{n_kernels} device kernels", flush=True)
        for key, ms, count in by_kernel[:6]:
            print(f"  {ms:8.3f} ms  x{count:<6d} {key[:90]}", flush=True)
        return n_kernels
    print(f"profiled {label}: no device time recorded (not measured)", flush=True)
    return None


def report_episodes(smi, label, times, batch, steps):
    med = statistics.median(times)
    q1, _, q3 = statistics.quantiles(times, n=4) if len(times) > 1 else (med, med, med)
    print(f"[{smi}] episode {label} B={batch} x {steps} steps: median {med * 1e3:.3f} ms "
          f"(quartiles {q1 * 1e3:.3f}-{q3 * 1e3:.3f} ms, n={len(times)}) = "
          f"{batch * steps / med:.1f} solves/s", flush=True)
    return med


def bound(bytes_, ops, chain_ms=None):
    """The least time in ms for the work, and what sets it: the bytes at the
    card's memory rate, the operations at its FP32 rate and, where given, a
    dependent chain's latency."""
    b = {"bytes": bytes_ / PEAK_BYTES * 1e3, "operations": ops / PEAK_FP32 * 1e3}
    if chain_ms is not None:
        b["chain"] = chain_ms
    return max(b.values()), max(b, key=b.get)


def mppi_bound_for(model, B, K, T, split=None):
    """Kernel 1's bound at (B, K, T) on the model: the plans, states and
    goals moved once; a normal, a rollout step and the MPPI extras per (b,
    k, t), the softmax per (b, k); with the dummy form's ``split``, the
    leading run per (b, t) and the tail per step."""
    S, Z = model.state_size, model.goal_size
    return bound(4 * (2 * T * B + S * B + T * Z),
                 B * K * T * (NOISE_OPS + step_ops(model, split) + PASS1_EXTRA + PASS2_EXTRA)
                 + B * K * MPPI_WEIGHT_OPS + lead_ops(B, T, split))


def rollout_bound_for(model, N, T):
    """Kernel 2's bound for N rollouts of T steps on the model."""
    S, Z = model.state_size, model.goal_size
    return bound(4 * (S * N + T * N + T * Z + N), N * T * step_ops(model))


def draw_bound_for(B, K, W):
    """The draw kernel's bound at (B, K, W): the normals stored and the
    seeds and counts read once, the operations of each normal."""
    return bound(4 * B * K * W + 16 * B, B * K * W * DRAW_OPS)


def cem_bound_for(model, B, K, T, n_elite, iters, split=None):
    """Kernel 3's bound: the plans, states and goals moved once; a normal,
    a rollout step and the sample's clip per (b, k, t, it), the moments,
    the update and the selection as the function needs them; with the
    dummy form's ``split``, the leading run once per (b, t) and the tail per
    step."""
    S, Z = model.state_size, model.goal_size
    return bound(4 * (2 * T * B + S * B + T * Z),
                 B * K * T * iters * (NOISE_OPS + step_ops(model, split) + CEM_SAMPLE_OPS)
                 + B * iters * (n_elite * T * CEM_MOMENT_OPS + T * CEM_UPDATE_OPS
                                + K * n_elite * CEM_SELECT_OPS) + lead_ops(B, T, split))


def ls_bound_for(model, n_a, B, T, return_states=False):
    """Kernel 6's bound (bytes and operations; its chain apart)."""
    S, Z = model.state_size, model.goal_size
    out = n_a * B * (T + 1) * (1 + (S if return_states else 0))
    return bound(4 * (2 * B * T * (1 + S) + B * S + n_a + T * Z + out),
                 n_a * B * T * (step_ops(model) + LS_EXTRA(S)))


def derivs_bound_for(model, B, T):
    """Kernel 4's bound: a point's state and action in, its eight outputs
    out, ``derivs_ops`` a point."""
    S = model.state_size
    pts = B * T
    return bound(4 * (pts * (S + 1) + T * (S + 1) + pts * (2 * S * S + 4 * S + 2)),
                 pts * derivs_ops(model))


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def chain_ms(steps: int, chain: int, clock_mhz: float) -> float:
    """steps dependent chains of ``chain`` operations at the least latency
    each, at the card's maximum SM clock."""
    return steps * chain * FP32_LATENCY_CYCLES / (clock_mhz * 1e3)


def i2c_first_iteration_inputs_for(env_, T, B, seed, dev):
    """What ``I2C._smooth_once`` hands the smoother at a solve's first
    iteration from jittered starts and small random plans."""
    from benchmarking_mpc_solvers_tpu_torch.solvers import I2C
    solver = I2C(model=env_.model, T=T)
    gen = torch.Generator(device=dev).manual_seed(seed)
    S = env_.model.state_size
    xs = env_.start_state(dev).expand(B, -1) + 0.1 * torch.randn((B, S), generator=gen, device=dev)
    us = 0.3 * torch.randn((B, T, env_.model.action_size), generator=gen, device=dev)
    gz = torch.zeros((T, env_.model.goal_size), device=dev)
    F, m, J, z0, mu0 = solver._smoother_inputs(xs, us, gz)
    return [t.contiguous() for t in (F, m, J, z0, solver._obs_noise(solver.alphas()[0], dev),
                                     mu0, *solver._prior_covs(dev), gz)]


def i2c_random_problem(B, T, S, A, Z, seed, dev):
    """The filter's arguments at D = S + A (S states, A actions) and Z
    features, drawn on the card from ``seed``: F near the identity on the
    states, J ignoring the actions (its action columns negative zeros), R
    per scenario and positive definite, the priors of ``I2C._prior_covs``."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    D = S + A
    F = torch.zeros((B, T, D, D), device=dev)
    F[:, :, :S, :S] = torch.eye(S, device=dev) * 0.9 + 0.05 * randn(B, T, S, S)
    F[:, :, :S, S:] = 0.3 * randn(B, T, S, A)
    Rm = randn(B, Z, Z)
    R = Rm @ Rm.transpose(1, 2) * 0.1 + 0.5 * torch.eye(Z, device=dev)
    sig0, Q = torch.zeros((D, D), device=dev), torch.zeros((D, D), device=dev)
    sig0[:S, :S], sig0[S:, S:] = 1e-8 * torch.eye(S, device=dev), 0.25 * torch.eye(A, device=dev)
    Q[:S, :S], Q[S:, S:] = 1e-6 * torch.eye(S, device=dev), 0.25 * torch.eye(A, device=dev)
    J = randn(B, T, Z, D)
    J[:, :, :, S:] = -0.0  # features that ignore the action: structural zeros
    mu0 = torch.cat([randn(B, S), torch.zeros((B, A), device=dev)], dim=1)
    return [t.contiguous() for t in (F, 0.1 * randn(B, T, D), J, 0.2 * randn(B, T, Z), R, mu0,
                                     sig0, Q, 0.1 * randn(T, Z))]


def i2c_first_steps(p, n):
    """The filter's arguments ``p`` cut to the horizon's first n steps."""
    return [t[:, :n].contiguous() if k < 4 else t[:n].contiguous() if k == 8 else t
            for k, t in enumerate(p)]


# Phase (m): the repairs of kernels 1-3 (the dummy past S = 8) and 8a/8b (D, Z
# above 6) on the card, then the benchmark suite's and bench's entry points.
# The repairs: kernels 1, 2 and 3 on the dummy at S in REPAIR_DUMMY_S at a
# small shape (T=17, B=1001, K=48, ragged blocks), once under dense weights
# (and 1 and 3 under the mid-list weights: the identity and a symmetric
# (8, S) term, state-only terms after an action term; and the off-square
# weights, whose one action term is (S - 1, S)), each kernel's form
# asserted, and at REPAIR_WIDE_S at the MPPI bench width, the MPPI
# two-stage N (kernel 2's rows form with its step loop's SASS issue floor)
# and the CEM sweep's width;
# kernel 7's shared-memory form at ADMM_SHARED_SHAPE;
# kernels 8a/8b in their general form (D, Z up to 16) and wide form (up to
# 32) at (S, A, Z) in REPAIR_I2C_DIMS (D = S + A), D != Z both ways, at the
# edges of the general form's 4-scenario blocks, T = 1, the large form
# past 32 (both its workspaces), and at the sweep row's B and T at D = Z in
# REPAIR_I2C_WIDE, held there on the first REPAIR_I2C_HELD steps of each
# kernel's run (the filter's first, the smoother's last): the plain
# versions take about 5 s a step at D = Z = 32 whatever B (each entry of
# each matrix is a PyTorch call). The suite at its full
# widths, cut to SUITE_ARGS' steps and timing repetitions.
REPAIR_DUMMY_S, REPAIR_WIDE_S, REPAIR_DENSE_S = (9, 16, 31), 16, 12
REPAIR_I2C_DIMS = ((6, 1, 7), (8, 1, 9), (11, 1, 12), (15, 1, 16), (6, 1, 10), (8, 1, 3),
                   (12, 1, 13), (16, 1, 17), (16, 1, 5), (4, 1, 20))
REPAIR_I2C_WIDE = (9, 16, 17, 32)
REPAIR_I2C_HELD = 3
REPAIR_I2C_EDGES = ((1, 3), (4, 5), (5, 2), (33, 4), (6, 1))  # (B, T) at D = Z = 9
REPAIR_EPISODE_STEPS = 3
SUITE_ARGS = ["--steps", "1", "--inner", "2", "--outer", "1", "--samples", "2", "--min-chains"]
# each suite configuration's kernels (its route), none other may launch
SUITE_ROUTES = {
    1: ("admm_iterate",), 2: (),
    3: ("riccati_backward_batch", "fused_linesearch"),
    4: ("fused_derivs", "riccati_backward_batch", "fused_linesearch"),
    5: ("fused_mppi_step", "fused_cem_step", "fused_derivs", "riccati_backward_batch",
        "fused_linesearch", "i2c_filter", "i2c_rts_smooth"),
    6: ("i2c_filter", "i2c_rts_smooth"),
}


def repair_and_suite_paths(counters, reset_counts, smi: str, clock: float,
                           launches: dict) -> tuple:
    """Phase (m). The suite's and bench's launch counts go into
    ``launches`` (the registered plants' paths); returns the readings, the
    kernels line's entries of the new shapes and the launch counts of the
    repairs' paths."""
    import dataclasses
    import tempfile

    from benchmarking_mpc_solvers_tpu_torch import _build
    from benchmarking_mpc_solvers_tpu_torch.envs import CartPoleSwingUpEnv, PendulumEnv
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.models import make_dummy_model
    from benchmarking_mpc_solvers_tpu_torch.models.base import quad_cost
    from benchmarking_mpc_solvers_tpu_torch.ops import i2c_smooth as ts
    from benchmarking_mpc_solvers_tpu_torch.ops import riccati_backward as riccati_module
    from benchmarking_mpc_solvers_tpu_torch.ops import qp_admm
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import (
        fused_rollout_costs_tm, fused_rollout_costs_tm_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import launch_config as rollout_config
    from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import (
        admm_iterate, admm_iterate_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_cem import (
        fused_cem_step, fused_cem_step_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_cem import launch_config as cem_config
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import (
        fused_mppi_step, fused_mppi_step_reference, pick_lanes)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import launch_config as mppi_config
    from benchmarking_mpc_solvers_tpu_torch.scripts import bench, bench_suite
    from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, I2C, MPPI
    from benchmarking_mpc_solvers_tpu_torch.solvers import ilqr as ilqr_module
    from benchmarking_mpc_solvers_tpu_torch.solvers import sqp as sqp_module

    dev = torch.device("cuda", 0)
    readings, entries, repair = {}, [], {}
    errs = {}

    def err(name, e):
        errs[name] = max(errs.get(name, e), e)

    def counts():
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in counters}

    def drive(label, run, expect):
        """One path with the counts at 0 before and read after: each count
        of ``expect``, no other launch."""
        reset_counts()
        res = run()
        got = counts()
        want = {fn.__name__: 0 for fn in counters}
        want.update(expect)
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")
        repair[label] = got
        print(f"[{smi}] phase (m) {label}: launches {expect}", flush=True)
        return res

    def entry(base, label, n, e, fn, plain_fn, bnd, cfg=None, plain_reps=3, chain=None,
              issue=None):
        """A kernels-line entry; plain_fn is the plain version, or its time
        in ms where the check already took it. ``issue``: the rollout loop's
        (SASS a trip, warp trips, the earlier form's bound) of the dummy
        form, for its issue and pipe floors."""
        around, device = cuda_time_ms(fn), device_time_ms(fn)
        plain = (plain_fn if isinstance(plain_fn, float)
                 else cuda_time_ms(plain_fn, reps=plain_reps, warmup=min(plain_reps, 1)))
        floors, floors_text = {}, ""
        if issue is not None:
            counted, trips, old_bound = issue
            floor = None if counted is None else counted[0] * trips / (sms * 4 * clock * 1e3)
            pipe = None if counted is None else pipe_floor_ms(counted[2], trips, sms, clock)[0]
            floors = {"issue_bound_ms": floor, "pipe_bound_ms": pipe, "sass_per_trip": counted}
            if old_bound is not None:
                floors["bound_ms_all_terms_a_step"] = old_bound[0]
                floors_text = f", every term a step {old_bound[0]:.5f} ms"
            floors_text += (f"; rollout loop {counted} (SASS a trip, in its body, by pipe; None: "
                            f"not counted), {trips} warp trips: issue floor {floor} ms, pipe "
                            f"floor {pipe} ms")
        entries.append({"base": base, "name": f"{base}[{label}]", "route": "cuda",
                        "launches": n, "max_abs_err": e[0], "max_rel_err": e[1], "ms": around,
                        "device_ms": device, "plain_ms": plain, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "library_ms": None, "launch": cfg, "pass": True,
                        **({} if chain is None else {"chain_bound_ms": chain}), **floors})
        print(f"[{smi}] {base}[{label}]: around one call {around:.4f} ms, device {device:.4f} ms,"
              f" plain {plain:.3f} ms, bound {bnd[0]:.5f} ms ({bnd[1]})"
              + ("" if chain is None else f", chain {chain:.5f} ms") + floors_text
              + f"; launch {cfg}", flush=True)

    def timed(fn):
        """fn's result and its ms on the card (CUDA events around one call)."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    # (a) kernels 1, 2 and 3 on the dummy past S = 8: small shapes
    def sampling(model, T, B, K, N, seed, tag, which=(1, 2, 3), form="one term",
                 rollout_form="rows"):
        """Kernels ``which`` of 1, 2 and 3 against their plain versions
        (2 and 3 bit for bit), 1 and 3 in the dummy form ``form``
        (``_build.DUMMY_TAIL_FORMS``), 2 in ``rollout_form``
        (``ops.fused.DUMMY_FORMS``) without local memory; returns each
        one's arguments and errors."""
        S, Z = model.state_size, model.goal_size
        rng = np.random.default_rng(seed)
        plan = torch.from_numpy(rng.uniform(-1.5, 1.5, (T, B)).astype(np.float32)).to(dev)
        x0 = torch.from_numpy(rng.uniform(-1, 1, (S, B)).astype(np.float32)).to(dev)
        gz = torch.from_numpy(rng.uniform(-0.2, 0.2, (T, Z)).astype(np.float32)).to(dev)
        lanes = pick_lanes(B)
        out = {}
        if 1 in which:
            a1 = (model, K, 0.9, 0.7, lanes, plan, x0, gz, 5)
            out[1] = a1, compare(f"fused_mppi_step[{tag}, B={B}, K={K}, T={T}]",
                                 fused_mppi_step(*a1), fused_mppi_step_reference(*a1))
            err("fused_mppi_step", out[1][1][0])
            cfg = mppi_config(model, T, K, B)
            print(f"[{smi}] fused_mppi_step[{tag}, B={B}, K={K}, T={T}] dummy form: {cfg}",
                  flush=True)
            if cfg["form"] != form:
                fail(f"phase (m) fused_mppi_step[{tag}]: form {cfg['form']}, not {form}")
        if 2 in which:
            xn = torch.from_numpy(rng.uniform(-1, 1, (S, N)).astype(np.float32)).to(dev)
            us = torch.from_numpy(rng.uniform(-2, 2, (T, N)).astype(np.float32)).to(dev)
            a2 = (model, xn, us, gz)
            got, want = fused_rollout_costs_tm(*a2), fused_rollout_costs_tm_reference(*a2)
            exact_nan(f"fused_rollout_costs_tm[{tag}, N={N}, T={T}]", got, want)
            out[2] = a2, compare(f"fused_rollout_costs_tm[{tag}, N={N}, T={T}]", got, want)
            err("fused_rollout_costs_tm", out[2][1][0])
            cfg = rollout_config(model, N, T)
            print(f"[{smi}] fused_rollout_costs_tm[{tag}, N={N}, T={T}] dummy form: {cfg}",
                  flush=True)
            if (cfg["form"], cfg["local_bytes"]) != (rollout_form, 0):
                fail(f"phase (m) fused_rollout_costs_tm[{tag}]: form {cfg['form']} with "
                     f"{cfg['local_bytes']} local bytes, not {rollout_form} with none")
        if 3 in which:
            a3 = (model, K, CEM_ELITE if K >= 64 else 5, CEM_ITERS, 0.2, 1.5, lanes, plan, x0,
                  gz, 7)
            got, masks = fused_cem_step(*a3, return_masks=True)
            want, wmasks = fused_cem_step_reference(*a3, return_masks=True)
            exact(f"fused_cem_step[{tag}] elite masks", masks, wmasks)
            exact_nan(f"fused_cem_step[{tag}, B={B}, K={K}, T={T}] plan", got, want)
            out[3] = a3, compare(f"fused_cem_step[{tag}] plan", got, want)
            err("fused_cem_step", out[3][1][0])
            cfg = cem_config(model, T, K, B)
            print(f"[{smi}] fused_cem_step[{tag}, B={B}, K={K}, T={T}] dummy form: {cfg}",
                  flush=True)
            if cfg["form"] != form:
                fail(f"phase (m) fused_cem_step[{tag}]: form {cfg['form']}, not {form}")
        return out

    reset_counts()
    for S in REPAIR_DUMMY_S:
        sampling(make_dummy_model(S, 1), 17, 1001, 48, 4097, S, f"dummy S={S}")
    Zd = REPAIR_DENSE_S + 1
    Wm = np.random.default_rng(12).uniform(-0.5, 1.0, (Zd, Zd)).astype(np.float32)
    dense = dataclasses.replace(make_dummy_model(REPAIR_DENSE_S, 1),
                                state_cost=quad_cost(Wm @ Wm.T))
    sampling(dense, 17, 1001, 48, 4097, 13, f"dummy S={REPAIR_DENSE_S} dense weights",
             form="whole list", rollout_form="list")
    # the mid-list weights: a state-only term after an action term (kernels 1
    # and 3 split the cost only where one action term ends the list); the
    # off-square weights: the identity's action term moved to (S - 1, S)
    Sw = REPAIR_WIDE_S
    Wl = np.eye(Sw + 1, dtype=np.float32)
    Wl[8, Sw] = Wl[Sw, 8] = 0.3
    midlist = dataclasses.replace(make_dummy_model(Sw, 1), state_cost=quad_cost(Wl))
    sampling(midlist, 17, 1001, 48, 0, 14, f"dummy S={Sw} mid-list weights", (1, 3),
             "whole list")
    Wo = np.eye(Sw + 1, dtype=np.float32)
    Wo[Sw, Sw], Wo[Sw - 1, Sw], Wo[Sw, Sw - 1] = 0.0, 0.3, 0.3
    offsquare = dataclasses.replace(make_dummy_model(Sw, 1), state_cost=quad_cost(Wo))
    sampling(offsquare, 17, 1001, 48, 0, 15, f"dummy S={Sw} off-square weights", (1, 3))
    small = counts()
    n_small = len(REPAIR_DUMMY_S) + 1
    if small != {**{fn.__name__: 0 for fn in counters}, "fused_mppi_step": n_small + 2,
                 "fused_rollout_costs_tm": n_small, "fused_cem_step": n_small + 2}:
        fail(f"phase (m) sampling kernels on the dummy past S = 8: launches {small}")
    repair["dummy past S = 8, small shapes"] = small

    # the dummy at REPAIR_WIDE_S at the MPPI bench, MPPI two-stage and CEM
    # sweep widths, then its closed loop on the kernel and two-stage tiers
    wide = make_dummy_model(REPAIR_WIDE_S, 1)
    a1, e1 = sampling(wide, HORIZON, BATCH, K_SAMPLES, 0, 51,
                      f"dummy S={REPAIR_WIDE_S} bench width", (1,))[1]
    a2, e2 = sampling(wide, HORIZON, 0, 0, BATCH * K_SAMPLES, 52,
                      f"dummy S={REPAIR_WIDE_S} MPPI two-stage N", (2,))[2]
    a3, e3 = sampling(wide, CEM_T, CEM_B, CEM_K, 0, 53,
                      f"dummy S={REPAIR_WIDE_S} CEM sweep width", (3,))[3]
    denv = dataclasses.replace(PendulumEnv, name="dummy", model=wide,
                               default_start=(0.5,) * REPAIR_WIDE_S)
    cfg_m = EpisodeConfig(n_steps=REPAIR_EPISODE_STEPS, record_plans=False)
    gen = torch.Generator(device=dev)
    paths = (
        ("dummy S=16 mppi kernel tier", MPPI(model=wide, T=HORIZON, K=K_SAMPLES), BATCH, True,
         {"fused_mppi_step": REPAIR_EPISODE_STEPS}),
        ("dummy S=16 mppi two-stage tier", MPPI(model=wide, T=HORIZON, K=K_SAMPLES), BATCH,
         False, {"fused_rollout_costs_tm": REPAIR_EPISODE_STEPS,
                 "scenario_normals": REPAIR_EPISODE_STEPS}),
        ("dummy S=16 cem kernel tier", CEM(model=wide, T=CEM_T, K=CEM_K, n_elite=CEM_ELITE,
                                           max_iter=CEM_ITERS), CEM_B, True,
         {"fused_cem_step": REPAIR_EPISODE_STEPS}))
    for label, sol, B, use_kernel, expect in paths:
        x0s = denv.start_state(dev).expand(B, -1).contiguous()
        res = drive(label, lambda sol=sol, x0s=x0s, use_kernel=use_kernel: run_episodes_fused(
            denv, sol, cfg_m, x0s, generator=gen.manual_seed(0), use_kernel=use_kernel,
            device=dev), expect)
        if not bool(torch.isfinite(res.costs).all()):
            fail(f"phase (m) {label}: episode costs not finite")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = dummy_split(wide)
    loops = {src: sass_loop(_build._target(src), src, DUMMY_SASS_LOOPS)
             for src in DUMMY_SASS_LOOPS}
    entry("fused_mppi_step", f"dummy S={REPAIR_WIDE_S}, B={BATCH}, K={K_SAMPLES}, T={HORIZON}",
          REPAIR_EPISODE_STEPS, e1, lambda: fused_mppi_step(*a1),
          lambda: fused_mppi_step_reference(*a1),
          mppi_bound_for(wide, BATCH, K_SAMPLES, HORIZON, split),
          mppi_config(wide, HORIZON, K_SAMPLES, BATCH),
          issue=(loops["fused_mppi.cu"], BATCH * -(-K_SAMPLES // 32) * HORIZON,
                 mppi_bound_for(wide, BATCH, K_SAMPLES, HORIZON)))
    N2 = BATCH * K_SAMPLES
    entry("fused_rollout_costs_tm", f"dummy S={REPAIR_WIDE_S}, N={N2}, T={HORIZON}",
          REPAIR_EPISODE_STEPS, e2, lambda: fused_rollout_costs_tm(*a2),
          lambda: fused_rollout_costs_tm_reference(*a2),
          rollout_bound_for(wide, N2, HORIZON), rollout_config(wide, N2, HORIZON),
          issue=(loops["fused_rollout.cu"], -(-N2 // 32) * HORIZON, None))

    # kernel 7's shared-memory form at kernel_ab.py's shape: one launch with
    # the counts at 0, its iterate held against the plain version's bits
    B7, n7, it7 = ADMM_SHARED_SHAPE
    plan7 = qp_admm.block_plan(B7, n7, True, sms)
    if plan7.form != "shared":
        fail(f"phase (m) admm_iterate at per problem n={n7}, B={B7}: plan {plan7}, not shared")
    a7 = random_qps_for(B7, n7, True, False, 28, dev)
    got7 = drive(f"admm_iterate shared-memory form (per problem, n={n7}, B={B7}, {it7} "
                 f"iterations)", lambda: admm_iterate(*a7, iters=it7), {"admm_iterate": 1})
    want7, plain7 = timed(lambda: admm_iterate_reference(*a7, iters=it7))
    exact(f"admm_iterate[shared-memory form, per problem, n={n7}, B={B7}, {it7} iterations]",
          got7, want7)
    e7 = compare(f"admm_iterate[shared-memory form, n={n7}, B={B7}]", got7, want7)
    err("admm_iterate", e7[0])
    entry("admm_iterate", f"shared-memory form, per problem, n={n7}, B={B7}, {it7} iterations",
          1, e7, lambda: admm_iterate(*a7, iters=it7), plain7,
          bound(4 * (B7 * n7 * n7 + 2 * B7 * n7 + 2 * n7), B7 * it7 * n7 * ADMM_ROW_OPS(n7)),
          qp_admm.launch_config(B7, n7, True), chain=chain_ms(it7, admm_chain(n7), clock))
    entry("fused_cem_step", f"dummy S={REPAIR_WIDE_S}, B={CEM_B}, K={CEM_K}, T={CEM_T}, "
          f"n_elite={CEM_ELITE}, max_iter={CEM_ITERS}", REPAIR_EPISODE_STEPS, e3,
          lambda: fused_cem_step(*a3), lambda: fused_cem_step_reference(*a3),
          cem_bound_for(wide, CEM_B, CEM_K, CEM_T, CEM_ELITE, CEM_ITERS, split),
          cem_config(wide, CEM_T, CEM_K, CEM_B), plain_reps=1,
          issue=(loops["fused_cem.cu"], CEM_B * -(-CEM_K // 32) * CEM_T * CEM_ITERS,
                 cem_bound_for(wide, CEM_B, CEM_K, CEM_T, CEM_ELITE, CEM_ITERS)))

    def i2c_held(tag, p):
        """Both kernels against their plain versions, bit for bit; the
        filter's outputs and the plain versions' ms (one call each)."""
        got = ts.i2c_filter(*p)
        want, plain_f = timed(lambda: ts.i2c_filter_reference(*p))
        for key, g, w in zip(("mu_f", "sig_f", "mu_pred", "sig_pred"), got, want):
            exact_nan(f"i2c_filter[{tag}] {key}", g, w)
        plain_r = None
        if p[0].shape[1] > 1:
            want, plain_r = timed(lambda: ts.i2c_rts_smooth_reference(*got, p[0]))
            exact_nan(f"i2c_rts_smooth[{tag}]", ts.i2c_rts_smooth(*got, p[0]), want)
        return got, plain_f, plain_r

    reset_counts()
    n_rts = 0
    for i, (S, A, Z) in enumerate(REPAIR_I2C_DIMS):
        p = i2c_random_problem(17, 6, S, A, Z, 60 + i, dev)
        i2c_held(f"{ts.kernel_form(S + A, Z)}, D={S + A}, Z={Z}, B=17, T=6", p)
        n_rts += 1
    for i, (B, T) in enumerate(REPAIR_I2C_EDGES):
        p = i2c_random_problem(B, T, 8, 1, 9, 70 + i, dev)
        i2c_held(f"general, D=Z=9, B={B}, T={T}", p)
        n_rts += T > 1
    got = counts()
    n_filter = len(REPAIR_I2C_DIMS) + len(REPAIR_I2C_EDGES)
    if (got["i2c_filter"], got["i2c_rts_smooth"]) != (n_filter, n_rts) or sum(got.values()) != (
            n_filter + n_rts):
        fail(f"phase (m) general- and wide-form I2C checks: launches {got}")
    repair["i2c general and wide forms, small shapes"] = got
    # the large form just past the wide form: its shared-memory workspace
    # against the plain versions and its device-memory workspace against
    # the shared one, bit for bit (3 steps: ~5 s a step of plain versions)
    B, T, D = 6, 3, 33
    p = i2c_random_problem(B, T, 32, 1, 33, 80, dev)
    fl, rl = ts.large_floats(D, D)
    outs = []
    for ws in (None, torch.empty(B * max(fl, rl), device=dev)):
        o = [torch.empty(s, device=dev) for s in ((B, T, D), (B, T, D, D), (B, T, D),
                                                  (B, T, D, D))]
        _build.check_rc("i2c_filter_general_launch", _build.kernel_fn(
            "i2c_filter_general_launch")(*(_build.ptr(t) for t in (*p, *o)), B, T, D, D, 1,
                                         None if ws is None else _build.ptr(ws),
                                         _build.stream_ptr(dev)))
        mu_s = torch.empty((B, T, D), device=dev)
        _build.check_rc("i2c_rts_general_launch", _build.kernel_fn("i2c_rts_general_launch")(
            *(_build.ptr(t) for t in (*o, p[0], mu_s)), B, T, D,
            None if ws is None else _build.ptr(ws), _build.stream_ptr(dev)))
        outs.append(o + [mu_s])
    want = ts.i2c_filter_reference(*p)
    for key, g, w in zip(("mu_f", "sig_f", "mu_pred", "sig_pred"), outs[0], want):
        exact_nan(f"i2c_filter[large, D=Z={D}, B={B}, T={T}] {key}", g, w)
    exact_nan(f"i2c_rts_smooth[large, D={D}, B={B}, T={T}]", outs[0][4],
              ts.i2c_rts_smooth_reference(*outs[0][:4], p[0]))
    for a, b in zip(*outs):
        exact_nan("i2c large form, device-memory workspace against shared memory", a, b)
    # I2C.solve_batch(use_fused=True) on make_dummy_model(S, 1), D = Z = S + 1
    # at REPAIR_I2C_WIDE: 3 iterations, a launch of each kernel an iteration
    for D in REPAIR_I2C_WIDE:
        if ts.kernel_form(D, D) not in ("general", "wide"):
            fail(f"phase (m): D = Z = {D} takes the {ts.kernel_form(D, D)} form")
        S = D - 1
        solver = I2C(model=make_dummy_model(S, 1), T=I2C6_T, max_iter=3)
        st = solver.init_state_batch(I2C6_B, torch.Generator(device=dev).manual_seed(0), dev)
        reset_counts()
        st, u, _ = solver.solve_batch(st, 0.5 * torch.ones((I2C6_B, S), device=dev),
                                      torch.zeros((I2C6_T, D), device=dev), use_fused=True)
        got = counts()
        if got != {**{fn.__name__: 0 for fn in counters}, "i2c_filter": 3, "i2c_rts_smooth": 3}:
            fail(f"phase (m) I2C.solve_batch on the dummy at S = {S}: launches {got}")
        if not bool(torch.isfinite(st.planned_us).all()) or not bool(torch.isfinite(u).all()):
            fail(f"phase (m) I2C on the dummy at S = {S}: plans not finite")
        repair[f"i2c solve_batch dummy S={S} (D=Z={D})"] = got
        print(f"[{smi}] phase (m) I2C.solve_batch(use_fused=True) on the dummy at S = {S} "
              f"(D = Z = {D}, B={I2C6_B}, T={I2C6_T}, 3 iterations): launches {got}", flush=True)
    # the sweep row's B and T at D = Z in REPAIR_I2C_WIDE: bytes and chain
    # bounds, launch shape with its waves on this card, no local memory;
    # the timed launches' outputs held against the plain versions bit for
    # bit on the first REPAIR_I2C_HELD steps of each kernel's run (the
    # filter is causal: its first steps hang on the inputs' first steps
    # alone; the smoother starts at the horizon's end: its last steps hang
    # on the filter's outputs and F at those steps alone), whose time is
    # the entries' plain_ms
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = REPAIR_I2C_HELD
    for D in REPAIR_I2C_WIDE:
        form = ts.kernel_form(D, D)
        p = i2c_random_problem(I2CS_B, I2CS_T, D - 1, 1, D, 90 + D, dev)
        outs = ts.i2c_filter(*p)
        mu_s = ts.i2c_rts_smooth(*outs, p[0])
        want, plain_f = timed(lambda: ts.i2c_filter_reference(*i2c_first_steps(p, n)))
        e_f = [exact_nan(f"i2c_filter[{form}, D=Z={D}, B={I2CS_B}, T={I2CS_T}, steps 0-{n - 1}]"
                         f" {key}", g[:, :n], w) for key, g, w in
               zip(("mu_f", "sig_f", "mu_pred", "sig_pred"), outs, want)]
        want, plain_r = timed(lambda: ts.i2c_rts_smooth_reference(
            *(t[:, -n:].contiguous() for t in (*outs, p[0]))))
        e_r = exact_nan(f"i2c_rts_smooth[{form}, D={D}, B={I2CS_B}, T={I2CS_T}, steps "
                        f"{I2CS_T - n}-{I2CS_T - 1}]", mu_s[:, -n:], want)
        work = i2c_work(p, clock)
        cfg = ts.launch_config(D, D, I2CS_B)
        if (cfg["filter"]["form"], cfg["rts"]["form"]) != (form, form):
            fail(f"phase (m) I2C at D = Z = {D}: launch config {cfg}, not the {form} form")
        if cfg["filter"]["local_bytes"] or cfg["rts"]["local_bytes"]:
            fail(f"phase (m) I2C at D = Z = {D}: the {form} form keeps local memory: {cfg}")
        for k, first in (("filter", "first"), ("rts", "last")):
            cfg[k]["waves"] = cfg[k]["blocks"] / (cfg[k]["blocks_per_sm"] * sms)
            cfg[k]["plain_ms_at"] = f"B={I2CS_B}, the {first} {n} of T={I2CS_T} steps"
        entry("i2c_filter", f"{form} form, D=Z={D}, B={I2CS_B}, T={I2CS_T}", 3,
              tuple(max(e[i] for e in e_f) for i in (0, 1)), lambda p=p: ts.i2c_filter(*p),
              plain_f, bound(*work[0][:2]), cfg, chain=work[0][2])
        entry("i2c_rts_smooth", f"{form} form, D={D}, B={I2CS_B}, T={I2CS_T}", 3, e_r,
              lambda p=p, o=outs: ts.i2c_rts_smooth(*o, p[0]), plain_r, bound(*work[1][:2]),
              cfg, chain=work[1][2])

    # (b) the suite's main() through all six configurations, full widths
    t0 = time.perf_counter()
    suite_counts = {}

    def after(conf, line_):
        got_ = counts()
        route = SUITE_ROUTES[conf.key]
        if any(got_[k] == 0 for k in route) or any(v for k, v in got_.items() if k not in route):
            fail(f"suite configuration {conf.key}: launches {got_}, route {route}")
        suite_counts[conf.key] = {k: v for k, v in got_.items() if v}
        launches[f"suite configuration {conf.key}"] = got_
        print(f"[{smi}] suite configuration {conf.key} ({conf.name}, B={conf.B}): launches "
              f"{suite_counts[conf.key]}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        lines = bench_suite.main(SUITE_ARGS + ["--results-dir", tmp],
                                 before=lambda conf: reset_counts(), after=after)
    suite_wall = time.perf_counter() - t0
    if len(lines) != 6:
        fail(f"the suite printed {len(lines)} lines")
    costs5 = lines[4]["median_costs"]
    if not all(np.isfinite(costs5[k]) for k in ("QPMPC", "ILQR", "SQP")):
        fail(f"suite configuration 5: median costs {costs5}")
    # kernels 4, 5 and 6 of configuration 5's iLQR and SQP rows on one
    # solve's own inputs at B = 10,240, T = 50
    conf5 = bench_suite.configurations(False, 1)[4]
    x5 = CartPoleSwingUpEnv.start_state(dev).expand(conf5.B, -1).contiguous()
    gz5 = torch.zeros((50, 5), device=dev)
    held5 = {}
    for label, solver, targets in (
            ("ILQR", dict(conf5.rows)["ILQR"],
             [(ilqr_module, "riccati_backward_batch"), (ilqr_module, "fused_linesearch")]),
            ("SQP", dict(conf5.rows)["SQP"],
             [(sqp_module, "fused_derivs"), (riccati_module, "riccati_backward_batch"),
              (sqp_module, "fused_linesearch")])):
        st = solver.init_state_batch(conf5.B, torch.Generator(device=dev).manual_seed(0), dev)
        calls = spy_calls(targets, lambda: solver.solve_batch(st, x5, gz5))
        if not all(calls.values()):
            fail(f"suite configuration 5 {label}: calls {[len(v) for v in calls.values()]}")
        held5[label] = held_calls(f"suite configuration 5 {label} solve (B={conf5.B}, T=50)",
                                  calls)
    readings["suite"] = {"args": SUITE_ARGS, "wall_s": suite_wall, "lines": lines,
                         "launches": suite_counts, "config5_held_max_abs_err": held5}

    # (c) bench's main() once
    t0 = time.perf_counter()
    reset_counts()
    rec = bench.main([])
    got = counts()
    # a warm-up and OUTER_REPS chains of 1 batch, then of INNER_REPS batches
    want = bench.N_STEPS * (1 + bench.OUTER_REPS) * (1 + bench.INNER_REPS)
    if got["fused_mppi_step"] != want or sum(got.values()) != want:
        fail(f"bench: launches {got}, expected fused_mppi_step {want}")
    launches["bench"] = got
    readings["bench"] = {"line": rec, "wall_s": time.perf_counter() - t0,
                         "launches": got["fused_mppi_step"]}
    readings["max_abs_err"] = errs
    print(f"[{smi}] phase (m) bench: {rec}, fused_mppi_step {want} launches", flush=True)
    return readings, entries, repair


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
    from benchmarking_mpc_solvers_tpu_torch.envs import (
        AcrobotEnv, CartPoleSwingUpEnv, PendulumEnv)
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import (
        fused_rollout_costs_tm, fused_rollout_costs_tm_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import launch_config as rollout_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_cem import (
        fused_cem_step, fused_cem_step_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_cem import launch_config as cem_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import (
        fused_derivs, fused_derivs_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import (
        fused_linesearch, fused_linesearch_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import launch_config as ls_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import (
        fused_mppi_step, fused_mppi_step_reference, pick_lanes, scenario_normals,
        scenario_normals_launch_config, scenario_normals_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import launch_config as mppi_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.i2c_smooth import (
        i2c_filter, i2c_filter_reference, i2c_rts_smooth, i2c_rts_smooth_reference,
        i2c_smooth_batch, i2c_smooth_batch_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.i2c_smooth import launch_config as i2c_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import (
        admm_iterate, admm_iterate_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import launch_config as admm_launch_config  # noqa: E501
    from benchmarking_mpc_solvers_tpu_torch.ops.riccati_backward import (
        riccati_backward_batch, riccati_backward_batch_reference)
    from benchmarking_mpc_solvers_tpu_torch.ops.rollout import simulate_trajectory
    from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, I2C, ILQR, MPPI, QPMPC, SQP

    from benchmarking_mpc_solvers_tpu_torch.ops.roofline import roofline_noise, roofline_op
    counters = (fused_mppi_step, fused_rollout_costs_tm, fused_cem_step,
                riccati_backward_batch, fused_linesearch, fused_derivs, admm_iterate,
                i2c_filter, i2c_rts_smooth, roofline_op, roofline_noise, scenario_normals)

    def reset_counts():
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        roofline_op.by_op = dict.fromkeys(roofline_op.by_op, 0)
        roofline_noise.by_form = dict.fromkeys(roofline_noise.by_form, 0)

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all(ptxas_verbose="--ptxas" in sys.argv)
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}", flush=True)
    for src, (_, log) in built.items():
        if log.strip():
            print(f"--- nvcc {src}\n{log.strip()}", flush=True)
    cfg33, cfg55 = i2c_launch_config(3, 3, I2C6_B), i2c_launch_config(5, 5, I2CS_B)
    for (D, Z, B), c in (((3, 3, I2C6_B), cfg33), ((5, 5, I2CS_B), cfg55)):
        print(f"i2c kernels at D={D}, Z={Z}, B={B}, rings of {c['stages']} stages: " + "; ".join(
            f"{name} {k['threads']} threads = {k['scenarios_per_block']} scenarios per block, "
            f"{k['chunk']} steps per stage, {k['shared_bytes']} shared bytes, {k['registers']} "
            f"registers, {k['blocks_per_sm']} blocks per SM"
            for name, k in (("filter", c["filter"]), ("smoother", c["rts"]))), flush=True)

    # 3. kernel vs plain version, on the card
    errs = {}

    # MPPI step: the bench shape on every model; then, on every model, K = 48
    # (lanes with one sample and lanes with two) with a ragged last block, and
    # a K*T whose noise cache is above the kernel's budget (pass 2 redraws
    # the noise); and the sweep's MPPI row (two samples a lane). Each case
    # names the form its launch must take
    def mppi_check(label, model, B, T, K, seed, cache):
        plan, x0, gz = mppi_inputs(model, B, T, 1, dev)
        cfg = mppi_launch_config(model, T, K, B)
        label = (f"fused_mppi_step[{label}: {model.name}, B={B}, T={T}, K={K}, seed={seed}, "
                 f"{'noise cache' if cfg['noise_cache'] else 'redraw'}]")
        if cfg["noise_cache"] != cache:
            fail(f"{label}: launch {cfg}, expected noise_cache={cache}")
        lanes = pick_lanes(B)
        got = fused_mppi_step(model, K, 1.0, 1.0, lanes, plan, x0, gz, seed)
        want = fused_mppi_step_reference(model, K, 1.0, 1.0, lanes, plan, x0, gz, seed)
        return compare(label, got, want)

    for name, B, seed in [("cartpole_swingup", BATCH, 7), ("pendulum", 3000, 2**31 - 2),
                          ("acrobot", 5000, 12345)]:
        errs.setdefault("fused_mppi_step", mppi_check(
            "bench shape", REGISTRY[name], B, HORIZON, K_SAMPLES, seed, True))
    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        mppi_check("K=48, ragged last block", REGISTRY[name], 1001, 17, 48, 2**31 - 2, True)
        mppi_check("cache above its budget", REGISTRY[name], 777, 90, 48, 12345, False)
    mppi_check("the sweep's MPPI row", REGISTRY["cartpole_swingup"], MPPI_SWEEP_B, HORIZON,
               MPPI_SWEEP_K, 7, True)

    # rollout costs, bit for bit (each rollout sums its steps in the plain
    # version's order): the MPPI two-stage shape on every model and a ragged
    # N (not a multiple of the block), then the CEM two-stage shape
    def rollout_check(model, N, T, seed):
        rng = np.random.default_rng(seed)
        x0 = torch.from_numpy(rng.uniform(-1, 1, (model.state_size, N)).astype(np.float32)).to(dev)
        us = torch.from_numpy(rng.uniform(-1.5, 1.5, (T, N)).astype(np.float32)).to(dev)
        gz = torch.from_numpy(rng.uniform(-0.2, 0.2, (T, model.goal_size)).astype(np.float32)).to(dev)
        got = fused_rollout_costs_tm(model, x0, us, gz)
        want = fused_rollout_costs_tm_reference(model, x0, us, gz)
        label = f"fused_rollout_costs_tm[{model.name}, N={N}, T={T}]"
        exact_nan(label, got, want)
        return compare(label, got, want)

    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        errs.setdefault("fused_rollout_costs_tm", rollout_check(
            REGISTRY[name], BATCH * K_SAMPLES, HORIZON, 2))
        rollout_check(REGISTRY[name], 4097, 23, 5)
    rollout_check(REGISTRY["cartpole_swingup"], CEM_B * CEM_K, CEM_T, 6)

    # the two-stage tiers' noise draw, bit for bit with its int64 emulation
    # on the same tensors: the noise cell's shape (MPPI's sweep row, std 1 and
    # another scale), the CEM two-stage shape, the MPPI two-stage tier's, the
    # plain tier's width T·(A+S) on cart-pole, ragged shapes with rows of one
    # step and of under a warp; seeds with the high word set (negative ones
    # too) and draw counts past 2**32
    def draw_check(B, K, W, scale, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        seeds = torch.randint(-(2**63), 2**63 - 1, (B,), generator=g, device=dev)
        calls = torch.randint(0, 2**40, (B,), generator=g, device=dev)
        exact(f"scenario_normals[B={B}, K={K}, W={W}, scale={scale}]",
              scenario_normals(seeds, calls, K, W, scale=scale),
              scale * scenario_normals_reference(seeds, calls, K, W))

    for shape in ((MPPI_SWEEP_B, MPPI_SWEEP_K, HORIZON, 1.0),
                  (MPPI_SWEEP_B, MPPI_SWEEP_K, HORIZON, 0.7), (CEM_B, CEM_K, CEM_T, 1.0),
                  (BATCH, K_SAMPLES, HORIZON, 1.0),
                  (1001, 48, HORIZON * (1 + REGISTRY["cartpole_swingup"].state_size), 1.0),
                  (37, 5, 7, 1.0), (100, 3, 1, 0.3)):
        draw_check(*shape, seed=shape[0] + shape[2])
    errs["scenario_normals"] = (0.0, 0.0)

    # CEM step, the plan and the elite masks bit for bit: the sweep shape, a
    # multi-tile ragged B, the seed 2**31 - 2; then the kernel's edges on every
    # model: K not a multiple of the warp (lanes with one and with two
    # samples), one step, every sample an elite, a ragged last block
    def cem_check(label, model, B, T, K, n_elite, max_iter, seed):
        plan, x0, gz = mppi_inputs(model, B, T, 3, dev)
        args = (model, K, n_elite, max_iter, 0.2, 1.0, pick_lanes(B), plan, x0, gz, seed)
        got, got_masks = fused_cem_step(*args, return_masks=True)
        want, want_masks = fused_cem_step_reference(*args, return_masks=True)
        label = (f"fused_cem_step[{label}, B={B}, T={T}, K={K}, n_elite={n_elite}, "
                 f"max_iter={max_iter}, seed={seed}]")
        exact(f"{label} elite masks", got_masks, want_masks)
        exact_nan(f"{label} plan", got, want)
        return got, want

    for name, B, seed in [("cartpole_swingup", CEM_B, 7), ("pendulum", 3000, 2**31 - 2),
                          ("acrobot", 5000, 12345)]:
        got, want = cem_check(name, REGISTRY[name], B, CEM_T, CEM_K, CEM_ELITE, CEM_ITERS, seed)
        errs.setdefault("fused_cem_step", compare(f"fused_cem_step[{name}] plan", got, want))
    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        for B, T, K, n_elite, max_iter in ((1001, 17, 48, CEM_ELITE, CEM_ITERS),
                                           (333, 1, CEM_K, CEM_ELITE, 2),
                                           (777, 33, 48, 48, 1), (100, 5, 33, 5, CEM_ITERS)):
            cem_check(name, REGISTRY[name], B, T, K, n_elite, max_iter, 2**31 - 2)

    # Riccati: every model's derivatives along random plans at iLQR's shape,
    # then random well-conditioned blocks with non-PD steps (ok mixed) and
    # the with_c form (SQP's: mu = 0, no PD check)
    def model_derivs(name, B, T):
        return ilqr_derivs_for(name, B, T, dev)

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

    def riccati_check(label, d, mu, c=None, check_pd=True, with_c=False):
        """Kernel against plain version, every output bit for bit (NaN alike)."""
        got = riccati_backward_batch(*d, mu, c, check_pd=check_pd, with_c=with_c)
        want = riccati_backward_batch_reference(*d, mu, c, check_pd=check_pd, with_c=with_c)
        exact(f"riccati_backward_batch[{label}] ok ({int(want[2].sum())} of "
              f"{want[2].numel()} true)", got[2], want[2])
        exact_nan(f"riccati_backward_batch[{label}] ks", got[0], want[0])
        exact_nan(f"riccati_backward_batch[{label}] Ks", got[1], want[1])
        return got, want

    ones = torch.ones((ILQR_B,), device=dev)
    riccati_main = model_derivs("cartpole_swingup", ILQR_B, ILQR_T)
    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        d = riccati_main if name == "cartpole_swingup" else model_derivs(name, ILQR_B, ILQR_T)
        got, want = riccati_check(f"{name} derivatives, B={ILQR_B}, T={ILQR_T}", d, ones)
        e = max(compare(f"riccati_backward_batch[{name}] ks", got[0], want[0]),
                compare(f"riccati_backward_batch[{name}] Ks", got[1], want[1]))
        errs["riccati_backward_batch"] = max(errs.get("riccati_backward_batch", e), e)
    *d, c = random_derivs(ILQR_B, ILQR_T, 4, 6)
    mu = torch.from_numpy(np.random.default_rng(7).choice(
        [1e-6, 1e-3, 1.0, 32.0], ILQR_B).astype(np.float32)).to(dev)
    got, want = riccati_check("non-PD steps", d, mu)
    n_ok = int(want[2].sum())
    if not 0 < n_ok < ILQR_B:
        fail(f"riccati non-PD case: ok is not mixed ({n_ok} of {ILQR_B})")
    zero = torch.zeros((ILQR_B,), device=dev)
    riccati_check("with_c", d, zero, c, check_pd=False, with_c=True)
    sq = sqp_riccati_inputs_for(SQP_B, SQP_T, dev)  # timed below
    riccati_check(f"SQP's inputs (acrobot, with_c, mu = 0), B={SQP_B}, T={SQP_T}", sq[:7], sq[7],
                  sq[8], check_pd=False, with_c=True)
    # what iLQR under model noise hands it through Experiment (the paths'
    # SQP inputs are the ones above): each iteration's inputs of one solve
    # at that path's configuration (cart-pole, B=5, T=25; from the
    # solver's initial plans no scenario's pass is ok there), and random
    # blocks at that shape with ok mixed
    exp_T = ILQR_NOISE_CONFIG["T"]
    for i, (args, _) in enumerate(ilqr_path_calls("riccati_backward_batch", "cartpole_swingup",
                                                  ILQR_NOISE_CONFIG, 0.1, EXP_REPS, dev)):
        riccati_check(f"iLQR model noise's inputs (cart-pole), B={EXP_REPS}, T={exp_T}, "
                      f"iteration {i}", args[:7], args[7])
    *d_exp, _ = random_derivs(EXP_REPS, exp_T, 4, 52)
    _, want = riccati_check(f"random, S=4, B={EXP_REPS}, T={exp_T}", d_exp,
                            torch.ones((EXP_REPS,), device=dev))
    if not 0 < int(want[2].sum()) < EXP_REPS:
        fail(f"riccati at B={EXP_REPS}, T={exp_T}: ok is not mixed")
    # the kernel's edges: every S (an entry per lane in groups of 1, 4 or 16
    # lanes at S <= 4, entries S*S..G-1 idle; one thread per scenario above),
    # a ragged last block, a horizon of one step and one past one and two
    # stages (stages of 16 steps at S <= 4, else 4), a NaN in one scenario,
    # inputs at a storage offset of one float
    for S_ in range(1, 9):
        for T_ in (1, 17, 33):
            *dd, cc = random_derivs(1001, T_, S_, 40 + S_)
            mm = torch.from_numpy(np.random.default_rng(S_).choice(
                [0.0, 1e-3, 1.0, 32.0], 1001).astype(np.float32)).to(dev)
            riccati_check(f"random, S={S_}, ragged B=1001, T={T_}", dd, mm)
            riccati_check(f"random, S={S_}, ragged B=1001, T={T_}, with_c", dd, mm, cc,
                          check_pd=False, with_c=True)
    *dn, cn = random_derivs(300, 20, 4, 50)
    mn = torch.ones((300,), device=dev)
    clean = riccati_backward_batch(*dn, mn, cn, check_pd=True, with_c=True)
    if not (torch.isfinite(clean[1][9]).all() and bool(clean[2][9])):
        fail("riccati NaN case: scenario 9 is not clean before the NaN")
    dn[5][9, 3, 0, 0] = float("nan")  # f_x of scenario 9 at t = 3
    got, _ = riccati_check("NaN in f_x of scenario 9, B=300, T=20, with_c", dn, mn, cn,
                           with_c=True)
    others = torch.arange(300, device=dev) != 9
    if not (torch.isnan(got[0][9, :3]).all() and torch.isnan(got[1][9, :3]).all()
            and torch.isnan(got[1][9, 3, 0, 0]) and bool(got[2][9]) is False and all(
            torch.equal(g[others], w[others]) or torch.equal(  # NaN alike where it overflows
                torch.nan_to_num(g[others], nan=7.0), torch.nan_to_num(w[others], nan=7.0))
            for g, w in zip(got, clean))):
        fail("riccati: the NaN scenario's gains are not NaN from its step down, or it "
             "touched another")
    d_off = [torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t)
             for t in random_derivs(777, 30, 4, 51)]
    if not all(t.storage_offset() == 1 and t.is_contiguous() for t in d_off):
        fail("riccati: the offset views are not contiguous views at offset 1")
    *d_off, c_off = d_off
    riccati_check("random, S=4, B=777, T=30, views at a storage offset of one float, with_c",
                  d_off, torch.full((777,), 1e-3, device=dev), c_off, with_c=True)

    # line search, every output bit for bit: n_alpha=10, B=1024, T=100, both
    # flags, every model; SQP's step sizes (n_alpha=8); then the kernel's
    # edges: a horizon of one step and one past one and two stages of 16, a
    # ragged last group of scenarios, one alpha, and more alphas than a warp
    # (two blocks of alphas, the second ragged)
    alphas = ILQR(model=REGISTRY["cartpole_swingup"], T=ILQR_T).alphas(dev)
    sqp_alphas = SQP(model=REGISTRY["acrobot"], T=SQP_T).alphas(dev)

    def ls_check(label, model, alphas_, inputs, with_terminal, return_states):
        got = fused_linesearch(model, alphas_, *inputs, with_terminal=with_terminal,
                               return_states=return_states)
        want = fused_linesearch_reference(model, alphas_, *inputs, with_terminal=with_terminal,
                                          return_states=return_states)
        label = f"fused_linesearch[{label}, terminal={with_terminal}, states={return_states}]"
        exact_nan(f"{label} us", got[0], want[0])
        if return_states:
            exact_nan(f"{label} xs", got[1], want[1])
        exact_nan(f"{label} costs", got[-1], want[-1])
        return got, want

    for name in ("cartpole_swingup", "pendulum", "acrobot"):
        model = REGISTRY[name]
        inputs = ls_inputs_for(model, ILQR_B, ILQR_T, 8, dev)
        for with_terminal in (True, False):
            for return_states in (False, True):
                got, want = ls_check(f"{name}, n_a={N_ALPHAS}, B={ILQR_B}, T={ILQR_T}", model,
                                     alphas, inputs, with_terminal, return_states)
                if name == "cartpole_swingup" and with_terminal and not return_states:
                    errs["fused_linesearch"] = max(  # the iLQR main path's flags
                        compare("fused_linesearch[iLQR's shape] us", got[0], want[0]),
                        compare("fused_linesearch[iLQR's shape] costs", got[1], want[1]))
        ls_check(f"{name}, SQP's step sizes n_a={len(sqp_alphas)}, B={SQP_B}, T={SQP_T}", model,
                 sqp_alphas, ls_inputs_for(model, SQP_B, SQP_T, 9, dev), True, True)
        for T_ in (1, 17, 33):
            inputs = ls_inputs_for(model, 1001, T_, 10 + T_, dev)
            for with_terminal in (True, False):
                for return_states in (False, True):
                    ls_check(f"{name}, n_a={N_ALPHAS}, ragged B=1001, T={T_}", model, alphas,
                             inputs, with_terminal, return_states)
        many = torch.pow(1.05, -torch.arange(45, dtype=torch.float32, device=dev))
        inputs = ls_inputs_for(model, 333, 17, 11, dev)
        for alphas_ in (alphas[:1], many):
            ls_check(f"{name}, n_a={len(alphas_)}, B=333, T=17", model, alphas_, inputs, True,
                     True)
    # what the iLQR variants hand it through Experiment: each iteration's
    # inputs of one solve at their configuration (pendulum, B=5, T=25)
    for variant in ("ddp", "box_ddp", "diag_hessian"):
        for i, (args, kw) in enumerate(ilqr_path_calls(
                "fused_linesearch", "pendulum", {**ILQR_NOISE_CONFIG, variant: True}, 0.0,
                EXP_REPS, dev)):
            ls_check(f"iLQR {variant}'s inputs (pendulum), n_a={N_ALPHAS}, B={EXP_REPS}, "
                     f"T={ILQR_NOISE_CONFIG['T']}, iteration {i}", args[0], args[1], args[2:],
                     kw["with_terminal"], False)

    # derivatives: every model at SQP's shape along rolled-out trajectories
    # (some controls on the action bounds), and a ragged batch of uniform
    # states (for the pendulum, angles on both sides of the wrap)
    def derivs_inputs(model, B, T, seed, rolled):
        return derivs_inputs_for(model, B, T, seed, rolled, dev)

    derivs_names = ("A", "Bd", "c", "Q", "R", "M", "q", "r")
    for name in ("acrobot", "cartpole_swingup", "pendulum"):
        model = REGISTRY[name]
        for B, T, rolled in ((SQP_B, SQP_T, True), (999, 37, False)):
            inputs = derivs_inputs(model, B, T, 9, rolled)
            got, want = fused_derivs(model, *inputs), fused_derivs_reference(model, *inputs)
            label = (f"fused_derivs[{name}, B={B}, T={T}, "
                     f"{'rolled-out' if rolled else 'uniform'} states]")
            e = max(compare(f"{label} {key}", g, w) for key, g, w in zip(derivs_names, got, want))
            if name == "acrobot" and rolled:
                errs["fused_derivs"] = e  # the SQP main path's model and shape

    # ADMM: the shared layout on configuration 1's own problem (pendulum,
    # n=20, B=512), then random SPD problems per problem (n=20 and n=50),
    # ragged batches, bounds per problem
    def qp1_problem(B):
        return qp1_problem_for(B, dev)

    def random_qps(B, n, per_problem, per_bounds, seed):
        return random_qps_for(B, n, per_problem, per_bounds, seed, dev)

    admm_main = qp1_problem(QP1_B)
    admm_cases = [(f"shared, configuration 1, n={QP1_T}, B={QP1_B}", admm_main, QP1_ITERS),
                  (f"shared, configuration 1, n={QP1_T}, ragged B=509", qp1_problem(509), QP1_ITERS),
                  ("per problem, n=20, B=512", random_qps(512, 20, True, False, 11), 100),
                  ("per problem, n=20, ragged B=509, bounds per problem",
                   random_qps(509, 20, True, True, 12), 100),
                  ("per problem, n=50, B=256", random_qps(256, 50, True, False, 13), 60),
                  ("per problem, n=50, ragged B=251, bounds per problem",
                   random_qps(251, 50, True, True, 14), 60),
                  ("shared, n=50, ragged B=251", random_qps(251, 50, False, False, 15), 60),
                  # the forms' edges: register widths 4 to 16 (two problems a
                  # warp; the last warp of B=511 holds one), to 32, to 64 (two
                  # rows a lane), the shared-memory form from 65 to 240, the
                  # streaming form above (n=1100: more rows than threads)
                  ("shared, n=1, ragged B=7", random_qps(7, 1, False, False, 16), 100),
                  ("per problem, n=5, ragged B=77, bounds per problem",
                   random_qps(77, 5, True, True, 27), 100),
                  ("per problem, n=16, ragged B=511, bounds per problem",
                   random_qps(511, 16, True, True, 17), 100),
                  ("shared, n=17, ragged B=263", random_qps(263, 17, False, False, 18), 100),
                  ("per problem, n=32, ragged B=530, bounds per problem",
                   random_qps(530, 32, True, True, 19), 100),
                  ("shared, n=33, ragged B=131", random_qps(131, 33, False, False, 20), 60),
                  ("per problem, n=64, ragged B=129", random_qps(129, 64, True, False, 21), 60),
                  ("shared, n=65, ragged B=9, bounds per problem",
                   random_qps(9, 65, False, True, 22), 20),
                  ("per problem, n=240, B=3", random_qps(3, 240, True, False, 23), 20),
                  ("per problem, n=241, ragged B=5, bounds per problem",
                   random_qps(5, 241, True, True, 24), 10),
                  (f"shared, n={ADMM_BIG_N}, B={ADMM_BIG_B}",
                   random_qps(ADMM_BIG_B, ADMM_BIG_N, False, False, 25), ADMM_BIG_ITERS),
                  ("shared, n=1100, B=2", random_qps(2, 1100, False, False, 26), 4)]
    for label, args, iters in admm_cases:
        got = admm_iterate(*args, iters=iters)
        want = admm_iterate_reference(*args, iters=iters)
        exact(f"admm_iterate[{label}, {iters} iterations]", got, want)
        at_bound = float(((want == args[2]) | (want == args[3])).float().mean())
        print(f"  {100 * at_bound:.1f} % of its variables end on a bound", flush=True)
        if not bool(((got >= args[2]) & (got <= args[3])).all()):
            fail(f"admm_iterate[{label}]: iterate outside the box")
        e = compare(f"admm_iterate[{label}, {iters} iterations]", got, want)
        if args is admm_main:
            errs["admm_iterate"] = e  # the QP-MPC main path's problem

    # Kalman filter and RTS smoother, each against its plain version, bit for
    # bit: random problems (D = Z = 3 with a ragged batch, the sweep's shape
    # at D = Z = 5, D = 6 with Z = 4, per-scenario and shared R), a horizon of
    # one step, a NaN in one scenario's F, then the matrices of a real first
    # iteration on every model (cart-pole's at the sweep's shape are the
    # ones timed below)
    def i2c_random(seed, B, T, S, A, Z, shared_R, variant=None):
        """A random smoother problem. variant "offset": each array a
        contiguous view one float into a larger buffer; "zeros": a zero row
        of J, and negative zeros in F's action rows, J's first column and
        mu0's actions (zero dividends of both signs in the solves)."""
        rng = np.random.default_rng(seed)
        D = S + A
        F = np.zeros((B, T, D, D))
        F[:, :, :S, :S] = np.eye(S) * 0.9 + 0.05 * rng.standard_normal((B, T, S, S))
        F[:, :, :S, S:] = 0.3 * rng.standard_normal((B, T, S, A))
        m = 0.1 * rng.standard_normal((B, T, D))
        J = rng.standard_normal((B, T, Z, D))
        z0 = 0.2 * rng.standard_normal((B, T, Z))
        Rm = rng.standard_normal((B, Z, Z))
        R = np.einsum("bij,bkj->bik", Rm, Rm) * 0.1 + 0.5 * np.eye(Z)
        mu0 = np.concatenate([rng.standard_normal((B, S)), np.zeros((B, A))], axis=1)
        sig0, Qproc = np.zeros((D, D)), np.zeros((D, D))
        sig0[:S, :S], sig0[S:, S:] = 1e-8 * np.eye(S), 0.25 * np.eye(A)
        Qproc[:S, :S], Qproc[S:, S:] = 1e-6 * np.eye(S), 0.25 * np.eye(A)
        g = 0.1 * rng.standard_normal((T, Z))
        if variant == "zeros":
            F[:, :, S:, :], J[:, :, :, 0], mu0[:, S:] = -0.0, -0.0, -0.0
            J[:, :, 0, :] = 0.0
        arrays = (F, m, J, z0, R[0] if shared_R else R, mu0, sig0, Qproc, g)
        out = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]
        if variant == "offset":
            out = [torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t) for t in out]
        return out

    def i2c_first_iteration(env_, T, B, seed):
        return i2c_first_iteration_inputs_for(env_, T, B, seed, dev)

    def i2c_check(label, p):
        got, want = i2c_filter(*p), i2c_filter_reference(*p)
        for key, g, w in zip(("mu_f", "sig_f", "mu_pred", "sig_pred"), got, want):
            exact_nan(f"i2c_filter[{label}] {key}", g, w)
        if p[0].shape[1] > 1:
            exact_nan(f"i2c_rts_smooth[{label}]", i2c_rts_smooth(*got, p[0]),
                      i2c_rts_smooth_reference(*want, p[0]))
        out, out_plain = i2c_smooth_batch(*p), i2c_smooth_batch_reference(*p)
        exact_nan(f"i2c_smooth_batch[{label}]", out, out_plain)
        return got, want, out

    i2c_check("random, D=Z=3, ragged B=3000, T=25", i2c_random(20, 3000, 25, 2, 1, 3, False))
    i2c_check(f"random, D=Z=5, B={I2CS_B}, T={I2CS_T}, shared R",
              i2c_random(21, I2CS_B, I2CS_T, 4, 1, 5, True))
    i2c_check("random, D=6, Z=4, B=1000, T=12", i2c_random(22, 1000, 12, 5, 1, 4, False))
    i2c_check("random, D=4 (two actions), Z=6, B=333, T=9", i2c_random(23, 333, 9, 2, 2, 6, True))
    # the lane-group kernels' edges: a ragged last group and block, T one
    # past a stage, T over many passes of the ring, D = Z = 6, D = 1, views
    # with a storage offset of one float
    i2c_check("random, D=Z=3, B=4k+1=401, T=25", i2c_random(27, 401, 25, 2, 1, 3, False))
    # the filter walks T steps, the smoother T - 1: one past a stage of each,
    # and exactly one stage of the smoother, in its narrow and wide blocks
    for B in (13, 5001):
        c = i2c_launch_config(3, 3, B)
        fc, rc = c["filter"]["chunk"], c["rts"]["chunk"]
        for T in sorted({fc + 1, rc + 2, rc + 1}):
            i2c_check(f"random, D=Z=3, B={B}, T={T} (stages of {fc} and {rc} steps)",
                      i2c_random(28, B, T, 2, 1, 3, True))
    i2c_check("random, D=Z=5, B=77, T=200", i2c_random(29, 77, 200, 4, 1, 5, False))
    i2c_check("random, D=Z=6, B=301, T=20", i2c_random(30, 301, 20, 5, 1, 6, False))
    i2c_check("random, D=1, Z=2, B=64, T=17", i2c_random(31, 64, 17, 1, 0, 2, True))
    p_off = i2c_random(32, 257, 25, 2, 1, 3, False, "offset")
    if not all(t.storage_offset() == 1 and t.is_contiguous() for t in p_off):
        fail("i2c: the offset views are not contiguous views at offset 1")
    i2c_check("random, D=Z=3, B=257, T=25, views at a storage offset of one float", p_off)
    # zero dividends: the filter's solves on a zero row of J, the smoother's
    # factorisation on the negative zeros of sig_pred's action rows
    p_z = i2c_random(33, 3000, 10, 4, 1, 5, True, "zeros")
    got_z, _, _ = i2c_check("random, D=Z=5, B=3000, T=10, a zero row of J", p_z)
    neg = [torch.where(t == 0, torch.full_like(t, -0.0), t) for t in got_z]
    exact_nan("i2c_rts_smooth[every zero of its inputs negative]", i2c_rts_smooth(*neg, p_z[0]),
              i2c_rts_smooth_reference(*neg, p_z[0]))
    _, _, out = i2c_check("T=1, D=Z=3, B=100", i2c_random(24, 100, 1, 2, 1, 3, False))
    if out.shape != (100, 1, 3):
        fail("i2c_smooth_batch: a one-step horizon is misshapen")
    p_nan = i2c_random(25, 300, 9, 2, 1, 3, False)
    clean = i2c_smooth_batch(*p_nan)
    p_nan[0][7, 2, 0, 0] = float("nan")
    _, _, out = i2c_check("NaN in F of scenario 7, D=Z=3, B=300, T=9", p_nan)
    others = torch.arange(300, device=dev) != 7
    if not (torch.isnan(out[7]).all() and torch.equal(out[others], clean[others])):
        fail("i2c_smooth_batch: the NaN scenario is not all NaN, or it touched another")
    i2c_first_iteration_inputs = {}
    for env_, T, B in ((PendulumEnv, I2C6_T, I2C6_B), (CartPoleSwingUpEnv, I2CS_T, I2CS_B),
                       (AcrobotEnv, I2CS_T, 1024)):
        p = i2c_first_iteration(env_, T, B, 26)
        label = f"{env_.model.name} first iteration, B={B}, T={T}"
        got, want, out = i2c_check(label, p)
        i2c_first_iteration_inputs[env_.model.name] = (p, got)
        if env_ is CartPoleSwingUpEnv:  # the sweep's shape and model
            errs["i2c_filter"] = max(compare(f"i2c_filter[{label}] {key}", g, w) for key, g, w
                                     in zip(("mu_f", "sig_f", "mu_pred", "sig_pred"), got, want))
            errs["i2c_rts_smooth"] = compare(
                f"i2c_rts_smooth[{label}]", i2c_rts_smooth(*got, p[0]),
                i2c_rts_smooth_reference(*want, p[0]))

    # 4. main paths
    launches, path_s = {}, {}
    env = CartPoleSwingUpEnv
    x0s = env.start_state(dev).expand(BATCH, -1).contiguous()
    solver = MPPI(model=env.model, T=HORIZON, K=K_SAMPLES, std=1.0, lam=1.0)
    cfg = EpisodeConfig(n_steps=N_STEPS, warmstart=0, record_plans=False)

    def mppi_episode(use_kernel=True):
        gen = torch.Generator(device=dev).manual_seed(0)
        return run_episodes_fused(env, solver, cfg, x0s, generator=gen,
                                  use_kernel=use_kernel, device=dev)

    def run_path(label, run, expect, into=None):
        """Drive one path with the counts at 0; check each expected count
        and that no other kernel launched; keep the counts in ``into``
        (``launches``, the registered plants' paths, by default). The run's
        host-clock time is kept in ``path_s``: the long episodes take it as
        their first timed sample."""
        reset_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        path_s[label] = time.perf_counter() - t0
        got = {fn.__name__: fn.launches for fn in counters}
        want = {fn.__name__: 0 for fn in counters}
        want.update(expect)
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")
        if not torch.isfinite(res.costs).all():
            fail(f"{label}: episode costs not finite")
        (launches if into is None else into)[label] = got
        print(f"main path ({label}): launches {expect}, mean episode cost "
              f"{float(res.costs.sum(1).mean()):.3f}", flush=True)
        return res

    res = run_path("mppi kernel tier", mppi_episode,
                   {"fused_mppi_step": cfg.warmstart + cfg.n_steps})
    if res.costs.shape != (BATCH, N_STEPS):
        fail("kernel-tier episode costs misshapen")
    run_path("mppi two-stage tier", lambda: mppi_episode(False),
             {"fused_rollout_costs_tm": cfg.n_steps, "scenario_normals": cfg.n_steps})

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
             {"fused_rollout_costs_tm": cem_cfg.n_steps * CEM_ITERS,
              "scenario_normals": cem_cfg.n_steps * CEM_ITERS})

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

    # the same configuration with Gauss-Newton Hessians: the stage
    # derivatives come from fused_derivs, one more launch per iteration
    ilqr_gn = ILQR(model=env.model, T=ILQR_T, max_iter=ILQR_ITERS, reference_accept=False,
                   gauss_newton=True)

    def ilqr_gn_episode():
        gen = torch.Generator(device=dev).manual_seed(0)
        return run_episodes_fused(env, ilqr_gn, ilqr_cfg, ilqr_x0s, generator=gen, device=dev)

    run_path("ilqr gauss-newton", ilqr_gn_episode,
             {"fused_derivs": ilqr_iters, "riccati_backward_batch": ilqr_iters,
              "fused_linesearch": ilqr_iters})
    out_gn = ilqr_gn.solve_batch(st, ilqr_x0s,
                                 torch.zeros((ILQR_T, env.model.goal_size), device=dev))[0]
    kept_gn = ((out_gn.planned_us == st.planned_us).flatten(1).all(dim=1)
               | (out_gn.planned_us == env.model.clip_action(st.planned_us)).flatten(1).all(dim=1))
    print(f"ilqr gauss-newton: one solve from the same initial plans accepted a step in "
          f"{int((~kept_gn).sum())} of {ILQR_B} scenarios (exact Hessians: "
          f"{int((~kept).sum())})", flush=True)

    # why neither accepts: the backward pass's Q_uu > 0 test on the initial
    # plans, with Gauss-Newton derivatives, at the largest mu
    gz3 = torch.zeros((ILQR_T, env.model.goal_size), device=dev)
    xs3, _ = simulate_trajectory(env.model, ilqr_x0s, st.planned_us, gz3)
    d_gn = [t.contiguous() for t in ilqr_gn.derivatives(xs3, st.planned_us, gz3, True)]
    ok_gn = riccati_backward_batch(*d_gn, torch.full((ILQR_B,), ilqr_gn.mu_max, device=dev))[2]
    beyond = (st.planned_us.abs() > 1.0).flatten(1)
    zero_quu = ((d_gn[3][:, :, 0, 0] == 0) & (d_gn[6].abs().sum(dim=(2, 3)) == 0))
    print(f"ilqr gauss-newton: backward pass ok at mu={ilqr_gn.mu_max:g} in {int(ok_gn.sum())} of "
          f"{ILQR_B}; {100 * float(beyond.float().mean()):.1f} % of the initial plans' controls "
          f"lie beyond the action bounds, {int(zero_quu.any(dim=1).sum())} of {ILQR_B} plans "
          f"have a step with l_uu = 0 and f_u = 0 (Q_uu = 0 at any mu), and the terminal "
          f"Hessian's smallest diagonal entry is negative in "
          f"{int((d_gn[2][:, -1].diagonal(dim1=-2, dim2=-1).min(dim=1).values < 0).sum())} "
          f"of {ILQR_B}", flush=True)

    # SQP, configuration 4: acrobot, every scenario from the same start
    sqp = SQP(model=AcrobotEnv.model, T=SQP_T, max_iter=SQP_ITERS)
    sqp_cfg = EpisodeConfig(n_steps=SQP_STEPS, record_plans=False)
    sqp_x0s = torch.tensor(SQP_START, device=dev).expand(SQP_B, -1).contiguous()

    def sqp_episode():
        return run_episodes_fused(AcrobotEnv, sqp, sqp_cfg, sqp_x0s, device=dev)

    sqp_iters = SQP_STEPS * SQP_ITERS
    res = run_path("sqp", sqp_episode,
                   {"fused_derivs": sqp_iters, "riccati_backward_batch": sqp_iters,
                    "fused_linesearch": sqp_iters})
    if res.costs.shape != (SQP_B, SQP_STEPS) or float(res.true_actions.abs().max()) > 1.0:
        fail("sqp: episode misshapen or an action outside the box")
    # the reference's own check of an SQP solve (tests/test_qp.py): the plan
    # it returns rolls out cheaper than the plan it started from
    sqp_gz = torch.zeros((SQP_T, AcrobotEnv.model.goal_size), device=dev)
    sqp_st = sqp.init_state_batch(SQP_B, torch.Generator(device=dev).manual_seed(0), dev)
    _, cost0 = simulate_trajectory(AcrobotEnv.model, sqp_x0s, sqp_st.planned_us, sqp_gz)
    solved = sqp.solve_batch(sqp_st, sqp_x0s, sqp_gz)[0]
    _, cost1 = simulate_trajectory(AcrobotEnv.model, sqp_x0s, solved.planned_us, sqp_gz)
    print(f"sqp: one solve takes the plan's rollout cost from {float(cost0.mean()):.3f} to "
          f"{float(cost1.mean()):.3f} (mean of {SQP_B})", flush=True)
    if not bool((cost1 < cost0).all()):
        fail("sqp: a solve did not improve the plan's rollout cost")

    # QP-MPC, configuration 1 (the ADMM kernel, shared layout) and
    # configuration 2 (Riccati-ADMM, plain PyTorch)
    qp1 = QPMPC(model=PendulumEnv.model, T=QP1_T, method="admm", iters=QP1_ITERS)
    qp1_cfg = EpisodeConfig(n_steps=QP1_STEPS, record_plans=False)
    qp1_x0s = PendulumEnv.start_state(dev).expand(QP1_B, -1).contiguous()

    def qp1_episode():
        return run_episodes_fused(PendulumEnv, qp1, qp1_cfg, qp1_x0s, device=dev)

    res = run_path("qpmpc configuration 1", qp1_episode, {"admm_iterate": QP1_STEPS})
    if float(res.true_actions.abs().max()) > 2.0:
        fail("qpmpc configuration 1: an action outside the box")
    qp2 = QPMPC(model=env.model, T=QP2_T, iters=QP2_ITERS, **QP2_WEIGHTS)
    qp2_cfg = EpisodeConfig(n_steps=QP2_STEPS, record_plans=False)
    qp2_x0s = torch.tensor(QP2_START, device=dev).expand(QP2_B, -1).contiguous()

    def qp2_episode():
        return run_episodes_fused(env, qp2, qp2_cfg, qp2_x0s, device=dev)

    res = run_path("qpmpc configuration 2", qp2_episode, {})
    final_theta = float(res.true_states[:, -1, 2].abs().max())
    print(f"qpmpc configuration 2: max final pole angle {final_theta:.4f} rad from "
          f"{QP2_START[2]} rad, max |action| {float(res.true_actions.abs().max()):.4f}",
          flush=True)
    if not final_theta < QP2_START[2] or float(res.true_actions.abs().max()) > 1.0:
        fail("qpmpc configuration 2: the pole was not brought towards upright within the box")

    # I2C: configuration 6 (pendulum) and the sweep's row (cart-pole), one
    # launch of the filter and one of the smoother per iteration
    def jittered(env_, B, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return (env_.start_state(dev).expand(B, -1) + 1e-3 * torch.randn(
            (B, env_.model.state_size), generator=gen, device=dev)).contiguous()

    i2c6 = I2C(model=PendulumEnv.model, T=I2C6_T, max_iter=I2C6_ITERS)
    i2c6_cfg = EpisodeConfig(n_steps=I2C6_STEPS, record_plans=False)
    i2c6_x0s = jittered(PendulumEnv, I2C6_B, 0)

    def i2c6_episode():
        return run_episodes_fused(PendulumEnv, i2c6, i2c6_cfg, i2c6_x0s, device=dev)

    n = I2C6_STEPS * I2C6_ITERS
    res = run_path("i2c configuration 6", i2c6_episode, {"i2c_filter": n, "i2c_rts_smooth": n})
    if res.costs.shape != (I2C6_B, I2C6_STEPS) or float(res.true_actions.abs().max()) > 2.0:
        fail("i2c configuration 6: episode misshapen or an action outside the box")
    c6 = res.costs
    early, late = float(c6[:, :10].mean()), float(c6[:, -10:].mean())
    print(f"i2c configuration 6: mean plant cost of the first 10 steps {early:.3f}, of the last "
          f"10 {late:.3f}; max |theta| at the end "
          f"{float(res.true_states[:, -1, 0].abs().max()):.3f}", flush=True)
    if not late < early:
        fail("i2c configuration 6: the plant cost did not fall over the episode")

    i2cs = I2C(model=env.model, T=I2CS_T, max_iter=I2CS_ITERS)
    i2cs_cfg = EpisodeConfig(n_steps=I2CS_STEPS, record_plans=False)
    i2cs_x0s = jittered(env, I2CS_B, 0)

    def i2cs_episode():
        return run_episodes_fused(env, i2cs, i2cs_cfg, i2cs_x0s, device=dev)

    n = I2CS_STEPS * I2CS_ITERS
    res = run_path("i2c sweep row", i2cs_episode, {"i2c_filter": n, "i2c_rts_smooth": n})
    if res.costs.shape != (I2CS_B, I2CS_STEPS) or float(res.true_actions.abs().max()) > 1.0:
        fail("i2c sweep row: episode misshapen or an action outside the box")
    # one solve improves the plan's rollout cost (the line search keeps the
    # old plan otherwise, so no scenario may get worse)
    i2cs_gz = torch.zeros((I2CS_T, env.model.goal_size), device=dev)
    i2cs_st = i2cs.init_state_batch(I2CS_B, torch.Generator(device=dev).manual_seed(0), dev)
    _, cost0 = simulate_trajectory(env.model, i2cs_x0s, i2cs_st.planned_us, i2cs_gz)
    solved = i2cs.solve_batch(i2cs_st, i2cs_x0s, i2cs_gz)[0]
    _, cost1 = simulate_trajectory(env.model, i2cs_x0s, solved.planned_us, i2cs_gz)
    print(f"i2c sweep row: one solve takes the plan's rollout cost from {float(cost0.mean()):.3f} "
          f"to {float(cost1.mean()):.3f} (mean of {I2CS_B}), lower in "
          f"{int((cost1 < cost0).sum())}", flush=True)
    if not bool((cost1 <= cost0 + 1e-3 * cost0.abs()).all() and (cost1 < cost0).any()):
        fail("i2c sweep row: a solve made a plan's rollout cost worse, or moved none")

    def port_layer_paths():
        """The sharded tiers on a one-device mesh, the sample-sharded MPPI
        step, the batch-major kernel-2 wrappers and the plain routes under
        the kernel switches; their names stay local to this function."""
        from benchmarking_mpc_solvers_tpu_torch.experiment import run_episodes_batch
        from benchmarking_mpc_solvers_tpu_torch.ops.fused import (
            fused_rollout_cost_samples, fused_rollout_cost_samples_reference,
            fused_rollout_costs, fused_rollout_costs_reference)
        from benchmarking_mpc_solvers_tpu_torch.ops.rollout import rollout_cost
        from benchmarking_mpc_solvers_tpu_torch.parallel import (
            BATCH_AXIS, SAMPLE_AXIS, make_mesh, make_sharded_mppi_step, sharded_episodes,
            sharded_episodes_kernel)
        readings = {}
        mesh = make_mesh(1)

        def gen(seed):
            return torch.Generator(device=dev).manual_seed(seed)

        def same(label, got, want):
            torch.cuda.synchronize()
            for field, w in zip(want._fields, want):
                g = getattr(got, field)
                if (g is None) != (w is None) or (w is not None and not torch.equal(g, w)):
                    fail(f"{label}: {field} differs from the unsharded run")
            print(f"{label}: every field identical to the unsharded run", flush=True)

        # (a) the kernel tier on a one-device mesh at the MPPI bench width and
        # the CEM sweep's, bit for bit with run_episodes_fused, one launch a call
        for label, sol, c, xs, direct, kernel in (
                ("mppi sharded kernel tier", solver, cfg, x0s, mppi_episode, "fused_mppi_step"),
                ("cem sharded kernel tier", cem, cem_cfg, cem_x0s, cem_episode,
                 "fused_cem_step")):
            fn = sharded_episodes_kernel(env, sol, c, mesh)

            def sharded(fn=fn, xs=xs):
                return fn(xs, generators=[gen(0)])

            same(label, run_path(label, sharded, {kernel: c.warmstart + c.n_steps}), direct())
            # in turns (sharded, direct, direct, sharded, ...): the host-bound
            # episodes drift within a call
            times = {sharded: [], direct: []}
            for r in range(SHARDED_ROUNDS):
                for run in ((sharded, direct) if r % 2 == 0 else (direct, sharded)):
                    times[run] += episode_seconds(run, 1, warmup=False)
            t_sharded, t_direct = (statistics.median(times[f]) for f in (sharded, direct))
            readings[label] = {"sharded_ms": t_sharded * 1e3, "direct_ms": t_direct * 1e3}
            print(f"[{smi}] {label} (B={xs.shape[0]}, {c.n_steps} steps, one-device mesh): "
                  f"median episode {t_sharded * 1e3:.3f} ms, run_episodes_fused "
                  f"{t_direct * 1e3:.3f} ms ({SHARDED_ROUNDS} each, in turns)", flush=True)

        # (b) the plain batched tier on the mesh, equal to run_episodes_batch:
        # one draw launch a solve
        small = MPPI(model=env.model, T=10, K=16)
        small_cfg = EpisodeConfig(n_steps=3, warmstart=1, record_plans=True)
        fn = sharded_episodes(env, small, small_cfg, mesh)
        got = run_path("mppi sharded plain tier", lambda: fn(x0s[:64], generators=[gen(1)]),
                       {"scenario_normals": small_cfg.warmstart + small_cfg.n_steps})
        same("mppi sharded plain tier", got, run_episodes_batch(
            env, small, small_cfg, x0s[:64], generator=gen(1), device=dev))

        # (c) the sample-sharded MPPI step on a (batch 1 x sample 1) mesh at the
        # bench width, with injected normals: against the closed form and
        # against MPPI.solve_batch's update (kernel 2's rollouts) on the same deltas
        step = make_sharded_mppi_step(
            solver, make_mesh(1, axes=(BATCH_AXIS, SAMPLE_AXIS), shape=(1, 1)))
        g = gen(5)
        noise = torch.randn((BATCH, K_SAMPLES, HORIZON, 1), generator=g, device=dev)
        planned = 0.3 * torch.randn((BATCH, HORIZON, 1), generator=g, device=dev)
        xs_c = x0s + 0.1 * torch.randn(x0s.shape, generator=g, device=dev)
        gz0 = torch.zeros((HORIZON, env.model.goal_size), device=dev)
        reset_counts()
        new_planned, u0s = step(planned, xs_c, noise=noise)
        torch.cuda.synchronize()
        if any(f.launches for f in counters):
            fail("sample-sharded mppi step: a kernel launched on its plain path")
        delta = solver.std * noise
        samples = planned[:, None] + delta
        roll, _ = rollout_cost(env.model, xs_c[:, None], samples, gz0)
        cost = roll + solver.lam * (samples * delta).sum(dim=(2, 3)) / solver.std**2
        w = torch.softmax(-(cost - cost.min(dim=1, keepdim=True).values) / solver.lam, dim=1)
        closed = planned + (w[:, :, None, None] * delta).sum(dim=1)
        st = solver.init_state_batch(BATCH, gen(0), dev)._replace(planned_us=planned)
        delta_tm = delta[..., 0].permute(2, 0, 1).reshape(HORIZON, BATCH * K_SAMPLES)
        via_solve = solver.solve_batch(st, xs_c, gz0, delta_tm=delta_tm)[0].planned_us
        errs_c = [float((new_planned - want).abs().max()) for want in (closed, via_solve)]
        print(f"sample-sharded mppi step (B={BATCH}, K={K_SAMPLES}, T={HORIZON}, one-by-one "
              f"mesh): max abs err {errs_c[0]:.3e} against the closed form, {errs_c[1]:.3e} "
              f"against MPPI.solve_batch on the same deltas (tol {SHARDED_STEP_TOL}); u0 "
              f"within the box: {bool((u0s.abs() <= 1.0).all())}", flush=True)
        if max(errs_c) > SHARDED_STEP_TOL or not bool((u0s.abs() <= 1.0).all()):
            fail("sample-sharded mppi step disagrees with the closed form or MPPI.solve_batch")
        readings["sample-sharded step max abs err"] = errs_c

        # (d) the batch-major wrappers of kernel 2 at the MPPI two-stage shape,
        # through their entry points with the counts at 0, then held against
        # their plain versions bit for bit
        N = BATCH * K_SAMPLES
        rng = np.random.default_rng(12)
        x0b = torch.from_numpy(rng.uniform(-1, 1, (N, env.model.state_size)).astype(
            np.float32)).to(dev)
        usb = torch.from_numpy(rng.uniform(-1.5, 1.5, (N, HORIZON)).astype(np.float32)).to(dev)
        reset_counts()
        costs_b = fused_rollout_costs(env.model, x0b, usb, gz0)
        costs_s = fused_rollout_cost_samples(env.model, x0b[0], usb[:, :, None], gz0)
        torch.cuda.synchronize()
        got = {f.__name__: f.launches for f in counters}
        want = {f.__name__: 0 for f in counters}
        want["fused_rollout_costs_tm"] = 2
        if got != want:
            fail(f"batch-major kernel-2 wrappers: launches {got}, expected {want}")
        launches["batch-major kernel-2 wrappers"] = got
        exact_nan(f"fused_rollout_costs[cart-pole, N={N}, T={HORIZON}]", costs_b,
                  fused_rollout_costs_reference(env.model, x0b, usb, gz0))
        exact_nan(f"fused_rollout_cost_samples[cart-pole, K={N}, T={HORIZON}]", costs_s,
                  fused_rollout_cost_samples_reference(env.model, x0b[0], usb[:, :, None], gz0))

        # (e) pallas_backward=False / pallas_smoother=False under use_fused=True:
        # no launch of the route's kernels, results against the None route
        for label, env_, cls, kw, switch, xs in (
                ("ilqr", env, ILQR, dict(T=ILQR_T, max_iter=ILQR_ITERS, reference_accept=False),
                 "pallas_backward", ilqr_x0s),
                ("ilqr gauss-newton", env, ILQR, dict(T=ILQR_T, max_iter=ILQR_ITERS,
                                                      reference_accept=False, gauss_newton=True),
                 "pallas_backward", ilqr_x0s),
                ("sqp", AcrobotEnv, SQP, dict(T=SQP_T, max_iter=SQP_ITERS), "pallas_backward",
                 sqp_x0s),
                ("i2c configuration 6", PendulumEnv, I2C, dict(T=I2C6_T, max_iter=I2C6_ITERS),
                 "pallas_smoother", i2c6_x0s)):
            c = EpisodeConfig(n_steps=SWITCH_STEPS, record_plans=False)

            def run(flag, env_=env_, cls=cls, kw=kw, switch=switch, xs=xs, c=c):
                sol = cls(model=env_.model, **{switch: flag}, **kw)
                if sol.has_kernel_stages() != (flag is None):
                    fail(f"{cls.__name__}({switch}={flag}).has_kernel_stages() is wrong")
                return run_episodes_fused(env_, sol, c, xs, generator=gen(0), device=dev)

            t0 = time.perf_counter()
            off = run_path(f"{label}, {switch}=False", lambda run=run: run(False), {})
            t_off = time.perf_counter() - t0
            t0 = time.perf_counter()
            on = run(None)
            torch.cuda.synchronize()
            t_on = time.perf_counter() - t0
            fields = ("costs", "true_states", "true_actions")
            per = torch.stack([(getattr(off, f) - getattr(on, f)).abs().flatten(1).max(dim=1).values
                               for f in fields]).max(dim=0).values  # each scenario's largest
            split = per > SWITCH_TOL
            n_split, err = int(split.sum()), float(per.max())
            rest = float(per[~split].max()) if bool((~split).any()) else float("nan")
            bits = all(torch.equal(getattr(off, f), getattr(on, f)) for f in fields)
            print(f"[{smi}] {label}, {switch}=False, use_fused=True (B={xs.shape[0]}, "
                  f"{SWITCH_STEPS} steps): no kernel launched; against the None route "
                  f"{'bit for bit' if bits else f'max abs err {err:.3e}'}; {n_split} scenarios "
                  f"apart by more than {SWITCH_TOL} (at most {SWITCH_SPLIT:.0%} allowed), the "
                  f"others within {rest:.3e}; episode {t_off:.3f} s plain, {t_on:.3f} s with the "
                  f"kernels", flush=True)
            if n_split > SWITCH_SPLIT * xs.shape[0]:
                fail(f"{label}: the plain route under {switch}=False leaves the kernel route")
            readings[f"{label} {switch}=False"] = {
                "bit_for_bit": bits, "max_abs_err": err, "scenarios_apart": n_split,
                "max_abs_err_of_the_others": rest, "plain_s": t_off, "kernels_s": t_on}
        return readings

    t0 = time.perf_counter()
    port_layer = port_layer_paths()
    print(f"port layer phases: {time.perf_counter() - t0:.1f} s", flush=True)

    def model_family_paths():
        """Phases (g) to (j): the dummy family and cart-pole under other
        weights through kernels 1, 2, 3, 4 and 6 (each in its generic cost
        form), every kernel call held against its plain version and each
        path's launches counted (in ``family_launches``, apart from the
        registered plants' paths); then the linear model refused with no
        launch. Their names stay local to this function. Returns the
        readings and the kernels line's entries of these instantiations."""
        import dataclasses

        from benchmarking_mpc_solvers_tpu_torch.models import (
            DummyModel, make_dummy_model, make_linear_model)
        from benchmarking_mpc_solvers_tpu_torch.models.base import quad_cost
        from benchmarking_mpc_solvers_tpu_torch.ops import riccati_backward as riccati_module
        from benchmarking_mpc_solvers_tpu_torch.solvers import ilqr as ilqr_module
        from benchmarking_mpc_solvers_tpu_torch.solvers import sqp as sqp_module
        readings, entries = {}, []

        def gen(seed=0):
            return torch.Generator(device=dev).manual_seed(seed)

        def env_of(model_, start):
            return dataclasses.replace(PendulumEnv, name=model_.name, model=model_,
                                       default_start=start)

        def starts(env_, B, seed):
            """B starts jittered by 0.3·N(0, 1) around the env's start."""
            S_ = env_.model.state_size
            return (env_.start_state(dev).expand(B, -1) + 0.3 * torch.randn(
                (B, S_), generator=gen(seed), device=dev)).contiguous()

        def new_entry(base, label, launches_, err, fn, plain_fn, bnd, cfg, specialised=None):
            """A kernels-line entry of a new instantiation at one shape: times
            around one call and on the device, the plain version's, the bound;
            with ``specialised`` (the registered cart-pole's call at the same
            shape) the specialised form's device time beside the generic's."""
            around, device = cuda_time_ms(fn), device_time_ms(fn)
            plain = cuda_time_ms(plain_fn, reps=3, warmup=1)
            e = {"base": base, "name": f"{base}[{label}]", "route": "cuda",
                 "launches": launches_, "max_abs_err": err[0], "max_rel_err": err[1],
                 "ms": around, "device_ms": device, "plain_ms": plain, "bound_ms": bnd[0],
                 "bound_by": bnd[1], "library_ms": None, "launch": cfg, "pass": True}
            line = (f"[{smi}] {e['name']}: around one call {around:.4f} ms, device "
                    f"{device:.4f} ms, plain {plain:.3f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}); "
                    f"launch {cfg}")
            if specialised is not None:
                e["specialised_device_ms"] = device_time_ms(specialised)
                line += (f"; the registered cart-pole's specialised form at the same shape: "
                         f"device {e['specialised_device_ms']:.4f} ms (generic "
                         f"{device / e['specialised_device_ms']:.2f}x)")
            print(line, flush=True)
            entries.append(e)

        def sampling_checks(label, model_, specialised_model=None):
            """Kernels 1, 2 and 3 on ``model_`` at the MPPI bench, MPPI
            two-stage and CEM sweep shapes, each in its generic form and held
            against its plain version (2 and 3 bit for bit), plans beyond ±1."""
            S_ = model_.state_size
            out = {}
            plan, x0, gz = mppi_inputs(model_, BATCH, HORIZON, 40, dev)
            plan = 3.0 * plan  # uniform on ±1.5
            lanes = pick_lanes(BATCH)
            cfg_ = mppi_launch_config(model_, HORIZON, K_SAMPLES, BATCH)
            if not cfg_["generic_cost"]:
                fail(f"fused_mppi_step[{label}]: launch {cfg_}, expected the generic cost")
            a1 = (K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, 7)
            out["fused_mppi_step"] = (compare(
                f"fused_mppi_step[{label}, B={BATCH}, K={K_SAMPLES}, T={HORIZON}, generic cost]",
                fused_mppi_step(model_, *a1), fused_mppi_step_reference(model_, *a1)),
                lambda: fused_mppi_step(model_, *a1),
                lambda: fused_mppi_step_reference(model_, *a1),
                mppi_bound_for(model_, BATCH, K_SAMPLES, HORIZON), cfg_,
                None if specialised_model is None else
                (lambda: fused_mppi_step(specialised_model, *a1)))
            N = BATCH * K_SAMPLES
            rng = np.random.default_rng(41)
            x0n = torch.from_numpy(rng.uniform(-1, 1, (S_, N)).astype(np.float32)).to(dev)
            usn = torch.from_numpy(rng.uniform(-1.5, 1.5, (HORIZON, N)).astype(np.float32)).to(dev)
            cfg_ = rollout_launch_config(model_, N)
            if not cfg_["generic_cost"]:
                fail(f"fused_rollout_costs_tm[{label}]: launch {cfg_}, expected the generic cost")
            a2 = (x0n, usn, gz)
            got, want = (fused_rollout_costs_tm(model_, *a2),
                         fused_rollout_costs_tm_reference(model_, *a2))
            name = f"fused_rollout_costs_tm[{label}, N={N}, T={HORIZON}, generic cost]"
            exact_nan(name, got, want)
            out["fused_rollout_costs_tm"] = (
                compare(name, got, want), lambda: fused_rollout_costs_tm(model_, *a2),
                lambda: fused_rollout_costs_tm_reference(model_, *a2),
                rollout_bound_for(model_, N, HORIZON), cfg_,
                None if specialised_model is None else
                (lambda: fused_rollout_costs_tm(specialised_model, *a2)))
            plan, x0, gz = mppi_inputs(model_, CEM_B, CEM_T, 42, dev)
            cfg_ = cem_launch_config(model_, CEM_T, CEM_K, CEM_B)
            if not cfg_["generic_cost"]:
                fail(f"fused_cem_step[{label}]: launch {cfg_}, expected the generic cost")
            a3 = (CEM_K, CEM_ELITE, CEM_ITERS, 0.2, 1.0, pick_lanes(CEM_B), plan, x0, gz, 7)
            got, got_masks = fused_cem_step(model_, *a3, return_masks=True)
            want, want_masks = fused_cem_step_reference(model_, *a3, return_masks=True)
            name = (f"fused_cem_step[{label}, B={CEM_B}, T={CEM_T}, K={CEM_K}, "
                    f"n_elite={CEM_ELITE}, max_iter={CEM_ITERS}, generic cost]")
            exact(f"{name} elite masks", got_masks, want_masks)
            exact_nan(f"{name} plan", got, want)
            out["fused_cem_step"] = (
                compare(f"{name} plan", got, want), lambda: fused_cem_step(model_, *a3),
                lambda: fused_cem_step_reference(model_, *a3),
                cem_bound_for(model_, CEM_B, CEM_K, CEM_T, CEM_ELITE, CEM_ITERS), cfg_,
                None if specialised_model is None else
                (lambda: fused_cem_step(specialised_model, *a3)))
            return out

        def episodes(label, run, B, steps):
            """FAMILY_REPS host-clock episodes: the launch-count run (already
            warm) and the others run now."""
            times = [path_s[label]] + episode_seconds(run, FAMILY_REPS - 1, warmup=False)
            readings[f"{label} median episode s"] = report_episodes(smi, label, times, B, steps)

        # (g) the dummy on the sampling tiers: MPPI at the bench
        # configuration's widths and CEM at the sweep's, each on the kernel
        # tier and the two-stage tier
        denv = env_of(DummyModel, DUMMY_START)
        dm = MPPI(model=DummyModel, T=HORIZON, K=K_SAMPLES, std=1.0, lam=1.0)
        dm_cfg = EpisodeConfig(n_steps=N_STEPS, warmstart=0, record_plans=False)
        dm_x0s = starts(denv, BATCH, 31)
        dc = CEM(model=DummyModel, T=CEM_T, K=CEM_K, n_elite=CEM_ELITE, max_iter=CEM_ITERS)
        dc_cfg = EpisodeConfig(n_steps=CEM_STEPS, warmstart=0, record_plans=False)
        dc_x0s = starts(denv, CEM_B, 32)
        paths = (
            ("dummy mppi kernel tier", dm, dm_cfg, dm_x0s, True,
             {"fused_mppi_step": N_STEPS}),
            ("dummy mppi two-stage tier", dm, dm_cfg, dm_x0s, False,
             {"fused_rollout_costs_tm": N_STEPS, "scenario_normals": N_STEPS}),
            ("dummy cem kernel tier", dc, dc_cfg, dc_x0s, True, {"fused_cem_step": CEM_STEPS}),
            ("dummy cem two-stage tier", dc, dc_cfg, dc_x0s, False,
             {"fused_rollout_costs_tm": CEM_STEPS * CEM_ITERS,
              "scenario_normals": CEM_STEPS * CEM_ITERS}))
        for label, sol, c, xs, use_kernel, expect in paths:
            def run(sol=sol, c=c, xs=xs, use_kernel=use_kernel):
                return run_episodes_fused(denv, sol, c, xs, generator=gen(0),
                                          use_kernel=use_kernel, device=dev)

            run_path(label, run, expect, into=family_launches)
            episodes(label, run, xs.shape[0], c.n_steps)
        dummy_calls = sampling_checks("dummy S=2", DummyModel)  # the paths' launches count
        for base, path in (("fused_mppi_step", "dummy mppi kernel tier"),
                           ("fused_rollout_costs_tm", "dummy mppi two-stage tier"),
                           ("fused_cem_step", "dummy cem kernel tier")):
            err, fn, plain_fn, bnd, cfg_, _ = dummy_calls[base]
            n = family_launches[path][base] + (
                family_launches["dummy cem two-stage tier"][base]
                if base == "fused_rollout_costs_tm" else 0)
            new_entry(base, "dummy S=2, generic cost", n, err, fn, plain_fn, bnd, cfg_)

        # (h) the dummy on the trajectory tiers: make_dummy_model(8, 1) at iLQR
        # configuration 3's widths (exact and Gauss-Newton Hessians) and
        # DummyModel at SQP configuration 4's, cut to FAMILY_WARM warm-start
        # solves and FAMILY_STEPS MPC steps
        d8 = make_dummy_model(8, 1)
        env8 = env_of(d8, (0.5,) * 8)
        x8 = starts(env8, ILQR_B, 33)
        traj = {}
        for label, gn in (("dummy S=8 ilqr", False), ("dummy S=8 ilqr gauss-newton", True)):
            sol = ILQR(model=d8, T=ILQR_T, max_iter=ILQR_ITERS, reference_accept=False,
                       gauss_newton=gn)
            c = EpisodeConfig(n_steps=FAMILY_STEPS, warmstart=FAMILY_WARM, record_plans=False)
            n = (FAMILY_WARM + FAMILY_STEPS) * ILQR_ITERS
            expect = {"riccati_backward_batch": n, "fused_linesearch": n}
            if gn:
                expect["fused_derivs"] = n

            def run(sol=sol, c=c):
                return run_episodes_fused(env8, sol, c, x8, generator=gen(0), device=dev)

            run_path(label, run, expect, into=family_launches)
            episodes(label, run, ILQR_B, FAMILY_STEPS)
            st = sol.init_state_batch(ILQR_B, gen(0), dev)
            gz8 = torch.zeros((ILQR_T, d8.goal_size), device=dev)
            calls = spy_calls([(ilqr_module, "fused_derivs"),
                               (ilqr_module, "riccati_backward_batch"),
                               (ilqr_module, "fused_linesearch")],
                              lambda: sol.solve_batch(st, x8, gz8))
            traj[label] = (calls, held_calls(label + " solve", calls))
        print(f"[{smi}] fused_linesearch on the dummy S=8 at iLQR's shape: launch "
              f"{ls_launch_config(d8, N_ALPHAS, ILQR_B)}", flush=True)
        sq_env = env_of(DummyModel, DUMMY_START)
        sq = SQP(model=DummyModel, T=SQP_T, max_iter=SQP_ITERS)
        sq_x0s = starts(sq_env, SQP_B, 34)
        n = FAMILY_STEPS * SQP_ITERS

        def sq_run():
            return run_episodes_fused(sq_env, sq, EpisodeConfig(
                n_steps=FAMILY_STEPS, record_plans=False), sq_x0s, device=dev)

        run_path("dummy sqp", sq_run, {"fused_derivs": n, "riccati_backward_batch": n,
                                       "fused_linesearch": n}, into=family_launches)
        episodes("dummy sqp", sq_run, SQP_B, FAMILY_STEPS)
        sq_st = sq.init_state_batch(SQP_B, gen(0), dev)
        sq_gz = torch.zeros((SQP_T, DummyModel.goal_size), device=dev)
        calls = spy_calls([(sqp_module, "fused_derivs"),
                           (riccati_module, "riccati_backward_batch"),
                           (sqp_module, "fused_linesearch")],
                          lambda: sq.solve_batch(sq_st, sq_x0s, sq_gz))
        traj["dummy sqp"] = (calls, held_calls("dummy sqp solve", calls))
        # kernels 4 and 6 of the dummy at S = 8 (the iLQR paths) and S = 2 (the
        # SQP path), timed on the first captured call of a solve
        for label, path, ls_paths, model_, B_, T_, sqp_ls in (
                ("dummy S=8", "dummy S=8 ilqr gauss-newton",
                 ("dummy S=8 ilqr", "dummy S=8 ilqr gauss-newton"), d8, ILQR_B, ILQR_T, False),
                ("dummy S=2", "dummy sqp", ("dummy sqp",), DummyModel, SQP_B, SQP_T, True)):
            calls, errs_ = traj[path]
            args, kw = calls["fused_derivs"][0]
            new_entry("fused_derivs", label, family_launches[path]["fused_derivs"],
                      errs_["fused_derivs"], lambda: fused_derivs(*args, **kw),
                      lambda: fused_derivs_reference(*args, **kw),
                      derivs_bound_for(model_, B_, T_), None)
            calls, errs_ = traj[ls_paths[0]]
            args, kw = calls["fused_linesearch"][0]
            n_a = args[1].shape[0]
            new_entry("fused_linesearch", f"{label}, generic cost",
                      sum(family_launches[p]["fused_linesearch"] for p in ls_paths),
                      errs_["fused_linesearch"], lambda: fused_linesearch(*args, **kw),
                      lambda: fused_linesearch_reference(*args, **kw),
                      ls_bound_for(model_, n_a, B_, T_, sqp_ls),
                      ls_launch_config(model_, n_a, B_))

        # (i) cart-pole under configuration 2's weights (dataclasses.replace):
        # one call of kernels 1, 2 and 3 at the MPPI bench and CEM sweep
        # shapes and one Gauss-Newton iLQR configuration-3 solve (kernels 4, 5
        # and 6), each held against its plain version; for 1, 2, 3 and 6 the
        # generic form's device time beside the registered cart-pole's
        # specialised form at the same shape
        cart = REGISTRY["cartpole_swingup"]
        cart2 = dataclasses.replace(cart, state_cost=quad_cost(np.diag(np.array(
            CART2_W, dtype=np.float32))))
        reset_counts()
        cart_calls = sampling_checks("cart-pole reweighted", cart2, cart)
        torch.cuda.synchronize()
        family_launches["cart-pole reweighted, one call each"] = {
            fn_.__name__: fn_.launches for fn_ in counters}
        for base, (err, fn, plain_fn, bnd, cfg_, spec) in cart_calls.items():
            new_entry(base, "cart-pole reweighted, generic cost",
                      family_launches["cart-pole reweighted, one call each"][base], err, fn,
                      plain_fn, bnd, cfg_, spec)
        ilqr2 = ILQR(model=cart2, T=ILQR_T, max_iter=ILQR_ITERS, reference_accept=False,
                     gauss_newton=True)
        st2 = ilqr2.init_state_batch(ILQR_B, gen(0), dev)
        x2 = CartPoleSwingUpEnv.start_state(dev).expand(ILQR_B, -1).contiguous()
        gz2 = torch.zeros((ILQR_T, cart2.goal_size), device=dev)
        reset_counts()
        calls = spy_calls([(ilqr_module, "fused_derivs"), (ilqr_module, "riccati_backward_batch"),
                           (ilqr_module, "fused_linesearch")],
                          lambda: ilqr2.solve_batch(st2, x2, gz2))
        torch.cuda.synchronize()
        got = {fn_.__name__: fn_.launches for fn_ in counters}
        want = {fn_.__name__: 0 for fn_ in counters}
        want.update({k: ILQR_ITERS for k in ("fused_derivs", "riccati_backward_batch",
                                             "fused_linesearch")})
        if got != want:
            fail(f"cart-pole reweighted gauss-newton ilqr solve: launches {got}, expected {want}")
        family_launches["cart-pole reweighted gauss-newton ilqr solve"] = got
        errs_ = held_calls("cart-pole reweighted gauss-newton ilqr solve", calls)
        cfg_ = ls_launch_config(cart2, N_ALPHAS, ILQR_B)
        if not cfg_["generic_cost"]:
            fail(f"fused_linesearch[cart-pole reweighted]: launch {cfg_}, expected generic")
        ls_in = ls_inputs_for(cart2, ILQR_B, ILQR_T, 8, dev)
        ls_alphas = ilqr2.alphas(dev)
        new_entry("fused_linesearch", "cart-pole reweighted, generic cost", ILQR_ITERS,
                  errs_["fused_linesearch"],
                  lambda: fused_linesearch(cart2, ls_alphas, *ls_in, with_terminal=True),
                  lambda: fused_linesearch_reference(cart2, ls_alphas, *ls_in,
                                                     with_terminal=True),
                  ls_bound_for(cart2, N_ALPHAS, ILQR_B, ILQR_T), cfg_,
                  lambda: fused_linesearch(cart, ls_alphas, *ls_in, with_terminal=True))
        readings["cart-pole reweighted gauss-newton ilqr solve max abs err"] = {
            k: v[0] for k, v in errs_.items()}

        # (j) the linear model (the tests/test_ilqr.py problem, bounds 50) has
        # no functor: run_episodes_fused refuses it for MPPI and iLQR on the
        # card on its first line, before any kernel launches
        lin = make_linear_model([[1.0, 0.1], [0.0, 1.0]], [[0.0], [0.1]], np.diag([1.0, 0.1]),
                                [[0.1]], np.diag([5.0, 1.0]), bounds=50.0)
        lenv = env_of(lin, (1.0, 0.5))
        for sol in (MPPI(model=lin, T=HORIZON, K=K_SAMPLES),
                    ILQR(model=lin, T=ILQR_T, max_iter=ILQR_ITERS, reference_accept=False)):
            label = f"linear model, {type(sol).__name__}"
            reset_counts()
            try:
                run_episodes_fused(lenv, sol, EpisodeConfig(n_steps=2, record_plans=False),
                                   lenv.start_state(dev).expand(64, -1), device=dev)
            except NotImplementedError as e:
                msg = str(e)
            else:
                fail(f"{label}: run_episodes_fused did not refuse the linear model")
            torch.cuda.synchronize()
            got = {fn_.__name__: fn_.launches for fn_ in counters}
            if any(got.values()) or "do not trace either" not in msg:
                fail(f"{label}: launches {got} before the refusal, or another refusal: {msg}")
            family_launches[label] = got
            print(f"{label}: refused by run_episodes_fused with no kernel launched: {msg}",
                  flush=True)
        readings["traj max abs err"] = {k: {n_: e[0] for n_, e in v[1].items()}
                                        for k, v in traj.items()}
        return readings, entries

    family_launches = {}
    t0 = time.perf_counter()
    family, family_entries = model_family_paths()
    print(f"model family phases: {time.perf_counter() - t0:.1f} s", flush=True)

    def experiment_paths():
        """The Experiment phases; their names stay local to this function."""
        # the Experiment host layer's paths, each through Experiment.run (its
        # first call and its timed call), the counts at 0 just before the run
        from benchmarking_mpc_solvers_tpu_torch.experiment import Experiment, ResultStore
        exp_walls, exp_results = {}, {}

        def run_experiment(label, params, expect, warmstart=0):
            """Drive one Experiment with the counts at 0; check each expected
            count, that no other kernel launched, the reference's key set and
            finite costs."""
            t0 = time.perf_counter()
            reset_counts()
            res = Experiment(params, device=dev).run(warmstart=warmstart)
            torch.cuda.synchronize()
            got = {fn.__name__: fn.launches for fn in counters}
            want = {fn.__name__: 0 for fn in counters}
            want.update(expect)
            if got != want:
                fail(f"{label}: launches {got}, expected {want}")
            keys = experiment_keys(params.get("sensor_noise", 0) > 0,
                                   params.get("actuation_noise", 0) > 0,
                                   params.get("timed_per_step", False))
            if sorted(res) != keys:
                fail(f"{label}: results keys {sorted(res)}, expected the reference's {keys}")
            costs = res["env_costs"] if params.get("timed_per_step") else res["batch_costs"]
            if not np.isfinite(costs).all():
                fail(f"{label}: costs not finite")
            launches[label] = got
            exp_walls[label] = time.perf_counter() - t0
            exp_results[label] = res
            print(f"[{smi}] experiment ({label}): launches {expect}, passed_time "
                  f"{res['passed_time']} s, compile_time {res['compile_time']} s, mean total cost "
                  f"{float(np.mean(costs.sum(axis=-1))):.3f}, wall {exp_walls[label]:.1f} s",
                  flush=True)
            return res

        # 1. MPPI at the bench configuration on the kernel tier: one kernel-1
        # launch per step in each of the two calls; the result through the store
        bench_params = dict(env="cartpole_swingup", agent="MPPI",
                            agent_config={"K": K_SAMPLES, "T": HORIZON, "std": 1.0, "lam": 1.0},
                            experiment_length=N_STEPS, start_state=list(env.default_start),
                            repetitions=BATCH, fused=True)
        res = run_experiment("experiment mppi kernel tier", bench_params,
                             {"fused_mppi_step": 2 * N_STEPS})
        if res["batch_costs"].shape != (BATCH, N_STEPS):
            fail(f"experiment mppi: batch_costs {res['batch_costs'].shape}")
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            store = ResultStore(tmp, "chip_smoke")
            store.insert(res)
            found = store.find({"agent_config.K": K_SAMPLES})
            if len(found) != 1:
                fail(f"result store: find by agent_config.K gave {len(found)} results")
            for key, val in res.items():
                if isinstance(val, np.ndarray) and not (
                        found[0][key].dtype == val.dtype
                        and found[0][key].tobytes() == val.tobytes()):
                    fail(f"result store: {key} did not come back bit for bit")
        print("result store: the bench result inserted, found by agent_config.K and every array "
              "back bit for bit", flush=True)

        # 2. iLQR under model noise, fused=False: kernel 5 each iteration, the
        # noisy line search plain (no kernel 6), as in the reference
        n = 2 * (EXP_NOISE_WARM + EXP_NOISE_STEPS) * ILQR_NOISE_CONFIG["max_iter"]
        run_experiment("experiment ilqr model noise", dict(
            env="cartpole_swingup", agent="ILQR", agent_config=ILQR_NOISE_CONFIG,
            experiment_length=EXP_NOISE_STEPS, start_state=list(env.default_start),
            sensor_noise=0.1, model_noise=True, repetitions=EXP_REPS), {"riccati_backward_batch": n},
            warmstart=EXP_NOISE_WARM)

        # 3. the iLQR variants, fused=False: kernel 6 each iteration, the
        # backward pass plain (the variant's own recursion), as in the reference
        n = 2 * (EXP_VARIANT_WARM + EXP_VARIANT_STEPS) * ILQR_NOISE_CONFIG["max_iter"]
        for variant in ("ddp", "box_ddp", "diag_hessian"):
            run_experiment(f"experiment ilqr {variant}", dict(
                env="pendulum", agent="ILQR", agent_config={**ILQR_NOISE_CONFIG, variant: True},
                experiment_length=EXP_VARIANT_STEPS, start_state=list(PendulumEnv.default_start),
                repetitions=EXP_REPS), {"fused_linesearch": n}, warmstart=EXP_VARIANT_WARM)

        # 4. SQP under model noise at configuration 4's widths, fused=False:
        # kernels 4 and 5 each iteration, the noisy candidates plain
        n = 2 * EXP_SQP_STEPS * SQP_ITERS
        run_experiment("experiment sqp model noise", dict(
            env="acrobot", agent="SQP", agent_config={"T": SQP_T, "max_iter": SQP_ITERS},
            experiment_length=EXP_SQP_STEPS, start_state=list(SQP_START), sensor_noise=0.1,
            model_noise=True, repetitions=SQP_B), {"fused_derivs": n, "riccati_backward_batch": n})

        # 5. each new path on the card against the CPU at a tiny size, from the
        # same plans (and, under model noise, the same injected draws: the card's
        # and the CPU's generators are different streams)
        t0 = time.perf_counter()
        tiny = {"ilqr model noise": ("cartpole_swingup", "ILQR", {"T": 8, "max_iter": 3},
                                     ILQR_EPISODE_TOL),
                "ilqr ddp": ("pendulum", "ILQR", {"T": 8, "max_iter": 3, "ddp": True},
                             ILQR_EPISODE_TOL),
                "ilqr box_ddp": ("pendulum", "ILQR", {"T": 8, "max_iter": 3, "box_ddp": True},
                                 ILQR_EPISODE_TOL),
                "ilqr diag_hessian": ("pendulum", "ILQR",
                                      {"T": 8, "max_iter": 3, "diag_hessian": True},
                                      ILQR_EPISODE_TOL),
                "sqp model noise": ("acrobot", "SQP", {"T": 8, "max_iter": 3}, SQP_EPISODE_TOL)}
        rng = np.random.default_rng(8)
        for label, (env_name, agent, cfg, tol) in tiny.items():
            env_ = {"pendulum": PendulumEnv, "cartpole_swingup": CartPoleSwingUpEnv,
                    "acrobot": AcrobotEnv}[env_name]
            noisy = "noise" in label
            solver = Experiment(dict(env=env_name, agent=agent, agent_config=cfg,
                                     experiment_length=1, start_state=list(env_.default_start),
                                     sensor_noise=0.1 if noisy else 0.0, model_noise=noisy),
                                device="cpu")._build()[0]
            S, B_ = env_.model.state_size, 8
            plans = (0.3 * rng.standard_normal((B_, cfg["T"], 1))).astype(np.float32)
            x0s_ = (env_.start_state("cpu").expand(B_, -1) + torch.from_numpy(
                0.05 * rng.standard_normal((B_, S)).astype(np.float32))).contiguous()
            if noisy:
                draws = (rng.standard_normal((cfg["max_iter"], B_, cfg["T"], S)),
                         rng.standard_normal((cfg["max_iter"], B_, solver.n_alphas, cfg["T"], S)))
                gz_ = torch.zeros((cfg["T"], env_.model.goal_size))

                def run_tiny(d):
                    st_ = solver.init_state_batch(B_, torch.Generator(device=d).manual_seed(0), d)
                    st_ = st_._replace(planned_us=torch.from_numpy(plans).to(d))
                    return solver.solve_batch(st_, x0s_.to(d), gz_.to(d), noise=draws)[0].planned_us
            else:
                def run_tiny(d):
                    return run_episodes_fused(env_, solver, EpisodeConfig(n_steps=3, warmstart=1),
                                              x0s_.to(d), use_kernel=False, init_plans=plans,
                                              device=d).planned_actions
            got, want = run_tiny(dev).cpu(), run_tiny("cpu")
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                fail(f"tiny {label}: card vs CPU max err {float((got - want).abs().max()):.3e}")
            print(f"tiny {label} ({'one solve, injected noise' if noisy else '3 steps'}, B={B_}, "
                  f"T={cfg['T']}): card matches the CPU (tol {tol}), max err "
                  f"{float((got - want).abs().max()):.3e}", flush=True)
        exp_walls["card against CPU"] = time.perf_counter() - t0

        # 6. one per-step timed run: MPPI at the bench widths, one scenario
        res = run_experiment("experiment mppi per step", dict(
            bench_params, repetitions=1, fused=False, experiment_length=EXP_PER_STEP_STEPS,
            timed_per_step=True), {})
        if res["timing_mode"] != "per_step":
            fail("experiment per step: timing_mode is not per_step")
        print(f"[{smi}] experiment mppi per step: median solve "
              f"{1e3 * statistics.median(res['computation_time']):.3f} ms over "
              f"{EXP_PER_STEP_STEPS} steps (K={K_SAMPLES}, T={HORIZON}, one scenario)", flush=True)
        print(f"[{smi}] experiment phases: {json.dumps({k: round(v, 2) for k, v in exp_walls.items()})}"
              f", {sum(exp_walls.values()):.1f} s in all", flush=True)

        # the device's busy share over one solve of each new path's solver,
        # from its experiment's start state and the solver's initial plans
        from benchmarking_mpc_solvers_tpu_torch.experiment import make_solver
        for label, env_, cfg_, noise_std, B_ in (
                ("ilqr model noise", CartPoleSwingUpEnv, ILQR_NOISE_CONFIG, 0.1, EXP_REPS),
                ("ilqr ddp", PendulumEnv, {**ILQR_NOISE_CONFIG, "ddp": True}, 0.0, EXP_REPS),
                ("sqp model noise", AcrobotEnv, {"T": SQP_T, "max_iter": SQP_ITERS}, 0.1, SQP_B)):
            solver_ = make_solver(label.split()[0].upper(), env_.model, cfg_,
                                  model_noise_std=noise_std)
            gen_ = torch.Generator(device=dev).manual_seed(0)
            st_ = solver_.init_state_batch(B_, gen_, dev)
            start = SQP_START if env_ is AcrobotEnv else env_.default_start
            x0_ = torch.tensor(start, device=dev).expand(B_, -1).contiguous()
            gz_ = torch.zeros((solver_.T, env_.model.goal_size), device=dev)
            profile_window(f"{label} solve (one MPC step, B={B_}, {solver_.max_iter} "
                           f"iterations)", smi, lambda: solver_.solve_batch(st_, x0_, gz_))
        return exp_walls, exp_results

    exp_walls, exp_results = experiment_paths()

    # (k) the study entry points: each sweep script's first configuration
    t0 = time.perf_counter()
    study = study_paths(counters, reset_counts, smi, launches)
    print(f"[{smi}] study phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # (l) the measurement scripts, kernels 9 and 10 among them
    t0 = time.perf_counter()
    measure, roofline_entries = measurement_paths(counters, reset_counts, smi, launches, errs)
    print(f"[{smi}] measurement phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # (m) the repairs (the dummy past S = 8 on kernels 1-3, D and Z above 6 on
    # 8a/8b), then the suite's and bench's entry points
    t0 = time.perf_counter()
    suite, repair_entries, repair_launches = repair_and_suite_paths(
        counters, reset_counts, smi, max_sm_clock_mhz(), launches)
    print(f"[{smi}] repair and suite phase: {time.perf_counter() - t0:.1f} s", flush=True)

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

    sqp_small = torch.tensor(SQP_START).expand(8, -1) + 0.02 * torch.from_numpy(
        np.random.default_rng(5).standard_normal((8, 4)).astype(np.float32))
    small_match("sqp", SQP_EPISODE_TOL, lambda d: run_episodes_fused(
        AcrobotEnv, SQP(model=AcrobotEnv.model, T=10, max_iter=3), small_cfg, sqp_small.to(d),
        device=d))
    qp_small = torch.tensor([0.4, -0.3]).expand(8, -1) + 0.1 * torch.from_numpy(
        np.random.default_rng(6).standard_normal((8, 2)).astype(np.float32))
    for mode in ("goal", "state"):
        small_match(f"qpmpc admm at {mode}", QP_EPISODE_TOL, lambda d: run_episodes_fused(
            PendulumEnv, QPMPC(model=PendulumEnv.model, T=10, method="admm", iters=40,
                               linearize_at=mode), small_cfg, qp_small.to(d), device=d))

    i2c_small = torch.tensor([3.0, 0.2]).expand(8, -1) + 0.1 * torch.from_numpy(
        np.random.default_rng(7).standard_normal((8, 2)).astype(np.float32))
    small_match("i2c", I2C_EPISODE_TOL, lambda d: run_episodes_fused(
        PendulumEnv, I2C(model=PendulumEnv.model, T=10, max_iter=3), small_cfg,
        i2c_small.to(d), device=d))

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
    ms, dev_ms, plain_ms, bounds, chains = {}, {}, {}, {}, {}

    def time_kernel(name, fn):
        """Around one call (the table's column) and device time; the
        difference is the wrapper's host work before its launch."""
        ms[name], dev_ms[name] = cuda_time_ms(fn), device_time_ms(fn)

    # kernels 1, 2 and 3, each beside its instruction-issue floor: the
    # rollout loop's fast-path SASS instructions per trip (a warp's step of a
    # sample a lane, or of a rollout a thread) over every trip of the call,
    # at one warp instruction per cycle on each of an SM's four schedulers.
    # Kernel 1 at the bench shape (the kernels line) and the sweep's MPPI
    # row, kernel 2 at the MPPI (the kernels line) and CEM two-stage shapes
    clock = max_sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    loops = {src: sass_loop(_build._target(src), src) for src in SASS_LOOPS}
    loops["draw"] = sass_loop(_build._target("fused_rollout.cu"), "fused_rollout.cu",
                              DRAW_SASS_LOOPS)
    issue, other_shapes, launch_cfgs = {}, {}, {}

    def issue_line(name, label, src, trips, around_ms, device_ms, bnd, cfg):
        """Prints a kernel's times beside its bound, issue floor and pipe
        floor; returns the two floors in ms (None where the loop was not
        counted)."""
        counted = loops[src]
        floor = None if counted is None else counted[0] * trips / (sms * 4 * clock * 1e3)
        pipe = None if counted is None else pipe_floor_ms(counted[2], trips, sms, clock)
        what = ("instruction-issue floor not measured (no cuobjdump, or no rollout loop found "
                "in its output)" if counted is None else
                f"its loop issues {counted[0]} SASS instructions a trip on its fast path "
                f"({counted[1]} in its body; cuobjdump), {trips} warp trips: instruction-issue "
                f"floor {floor:.4f} ms at {sms} SMs x 4 schedulers x {clock:.0f} MHz, pipe floor "
                f"{pipe[0]:.4f} ms ({pipe[1]}; by pipe {counted[2]})")
        print(f"[{smi}] {name} at {label}: around one call {around_ms:.4f} ms, device "
              f"{device_ms:.4f} ms; {what}, beside the bound {bnd[0]:.4f} ms ({bnd[1]}); "
              f"launch {cfg}", flush=True)
        return floor, None if pipe is None else pipe[0]

    plan, x0, gz = mppi_inputs(model, BATCH, HORIZON, 1, dev)
    lanes = pick_lanes(BATCH)
    time_kernel("fused_mppi_step",
                lambda: fused_mppi_step(model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, 7))
    plain_ms["fused_mppi_step"] = cuda_time_ms(lambda: fused_mppi_step_reference(
        model, K_SAMPLES, 1.0, 1.0, lanes, plan, x0, gz, 7), reps=3, warmup=1)
    bounds["fused_mppi_step"] = mppi_bound_for(model, BATCH, K_SAMPLES, HORIZON)
    issue["fused_mppi_step"] = issue_line(
        "fused_mppi_step", f"the bench shape (cart-pole, B={BATCH}, K={K_SAMPLES}, T={HORIZON})",
        "fused_mppi.cu", BATCH * -(-K_SAMPLES // 32) * HORIZON, ms["fused_mppi_step"],
        dev_ms["fused_mppi_step"], bounds["fused_mppi_step"],
        mppi_launch_config(model, HORIZON, K_SAMPLES, BATCH))

    # (f) the ported timers on kernel 1 at the bench shape, beside its device
    # time: a chain of steps, each one launch (and the scalar it returns)
    from benchmarking_mpc_solvers_tpu_torch.utils import device_step_latency, slope_timer

    def mppi_chain_step(carry, seed):
        out = fused_mppi_step(model, K_SAMPLES, 1.0, 1.0, lanes, carry, x0, gz, seed)
        return out, out[0, 0]

    def mppi_fresh(g):
        fresh = plan + 0.01 * torch.randn(plan.shape, generator=g, device=dev)
        return fused_mppi_step(model, K_SAMPLES, 1.0, 1.0, lanes, fresh, x0, gz, 7)[0, 0]

    p50, p90, resolution = device_step_latency(mppi_chain_step, plan, np.arange(7, 23),
                                               return_stats=True, device=dev)
    slope = slope_timer(mppi_fresh, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev) * 1e3
    timers = {"device_step_latency_p50_ms": p50, "device_step_latency_p90_ms": p90,
              "resolution_ms": resolution, "slope_timer_ms": slope,
              "device_time_ms": dev_ms["fused_mppi_step"]}
    print(f"[{smi}] utils timers on fused_mppi_step at the bench shape: device_step_latency "
          f"p50 {p50:.4f} ms, p90 {p90:.4f} ms (resolution {resolution:.4f} ms); slope_timer "
          f"{slope:.4f} ms a call (a fresh plan each, one randn and one add more); "
          f"device_time_ms {dev_ms['fused_mppi_step']:.4f} ms", flush=True)
    if not (p50 > 0 and slope > 0 and dev_ms["fused_mppi_step"] / 2 <= p50
            <= 2 * dev_ms["fused_mppi_step"]):
        fail("the utils timers read kernel 1 outside 2x of its device time")

    N = BATCH * K_SAMPLES
    x0n = x0.repeat_interleave(K_SAMPLES, dim=1)
    usn = (plan.repeat_interleave(K_SAMPLES, dim=1)
           + torch.randn((HORIZON, N), generator=torch.Generator(device=dev).manual_seed(4),
                         device=dev))
    time_kernel("fused_rollout_costs_tm", lambda: fused_rollout_costs_tm(model, x0n, usn, gz))
    plain_ms["fused_rollout_costs_tm"] = cuda_time_ms(
        lambda: fused_rollout_costs_tm_reference(model, x0n, usn, gz), reps=3, warmup=1)
    bounds["fused_rollout_costs_tm"] = rollout_bound_for(model, N, HORIZON)
    issue["fused_rollout_costs_tm"] = issue_line(
        "fused_rollout_costs_tm", f"the MPPI two-stage shape (cart-pole, N={N}, T={HORIZON})",
        "fused_rollout.cu", -(-N // 32) * HORIZON, ms["fused_rollout_costs_tm"],
        dev_ms["fused_rollout_costs_tm"], bounds["fused_rollout_costs_tm"],
        rollout_launch_config(model, N))

    # the two-stage draw at the noise cell's shape, which is also the CEM
    # two-stage shape (a warp trip: an element of each lane)
    gen_d = torch.Generator(device=dev).manual_seed(5)
    seeds_d = torch.randint(0, 2**63 - 1, (MPPI_SWEEP_B,), generator=gen_d, device=dev)
    calls_d = torch.randint(0, 20, (MPPI_SWEEP_B,), generator=gen_d, device=dev)
    Nd = MPPI_SWEEP_B * MPPI_SWEEP_K
    time_kernel("scenario_normals",
                lambda: scenario_normals(seeds_d, calls_d, MPPI_SWEEP_K, HORIZON))
    plain_ms["scenario_normals"] = cuda_time_ms(lambda: scenario_normals_reference(
        seeds_d, calls_d, MPPI_SWEEP_K, HORIZON), reps=3, warmup=1)
    bounds["scenario_normals"] = draw_bound_for(MPPI_SWEEP_B, MPPI_SWEEP_K, HORIZON)
    launch_cfgs["scenario_normals"] = scenario_normals_launch_config(Nd)
    issue["scenario_normals"] = issue_line(
        "scenario_normals", f"the noise cell's shape (B={MPPI_SWEEP_B}, K={MPPI_SWEEP_K}, "
        f"W={HORIZON})", "draw", -(-Nd // 32) * HORIZON, ms["scenario_normals"],
        dev_ms["scenario_normals"], bounds["scenario_normals"], launch_cfgs["scenario_normals"])
    del seeds_d, calls_d

    def other_shape(name, label, src, trips, fn, bnd, cfg):
        around, device = cuda_time_ms(fn), device_time_ms(fn)
        floor, pipe = issue_line(name, label, src, trips, around, device, bnd, cfg)
        other_shapes.setdefault(name, []).append({
            "shape": label, "ms": around, "device_ms": device, "bound_ms": bnd[0],
            "bound_by": bnd[1], "issue_bound_ms": floor, "pipe_bound_ms": pipe, "launch": cfg})

    plan, x0, gz = mppi_inputs(model, MPPI_SWEEP_B, HORIZON, 1, dev)
    lanes_s = pick_lanes(MPPI_SWEEP_B)
    other_shape("fused_mppi_step", f"the sweep's MPPI row (cart-pole, B={MPPI_SWEEP_B}, "
                f"K={MPPI_SWEEP_K}, T={HORIZON})", "fused_mppi.cu",
                MPPI_SWEEP_B * -(-MPPI_SWEEP_K // 32) * HORIZON,
                lambda: fused_mppi_step(model, MPPI_SWEEP_K, 1.0, 1.0, lanes_s, plan, x0, gz, 7),
                mppi_bound_for(model, MPPI_SWEEP_B, MPPI_SWEEP_K, HORIZON),
                mppi_launch_config(model, HORIZON, MPPI_SWEEP_K, MPPI_SWEEP_B))
    Nc = CEM_B * CEM_K
    rng = np.random.default_rng(4)
    x0c = torch.from_numpy(rng.uniform(-1, 1, (S, Nc)).astype(np.float32)).to(dev)
    usc = torch.from_numpy(rng.uniform(-1, 1, (CEM_T, Nc)).astype(np.float32)).to(dev)
    gzc = torch.zeros((CEM_T, Z), device=dev)
    other_shape("fused_rollout_costs_tm", f"the CEM two-stage shape (cart-pole, N={Nc}, "
                f"T={CEM_T})", "fused_rollout.cu", -(-Nc // 32) * CEM_T,
                lambda: fused_rollout_costs_tm(model, x0c, usc, gzc),
                rollout_bound_for(model, Nc, CEM_T),
                rollout_launch_config(model, Nc))
    del x0c, usc

    plan, x0, gz = mppi_inputs(model, CEM_B, CEM_T, 3, dev)
    cem_args = (model, CEM_K, CEM_ELITE, CEM_ITERS, 0.2, 1.0, pick_lanes(CEM_B), plan, x0, gz, 7)
    time_kernel("fused_cem_step", lambda: fused_cem_step(*cem_args))
    plain_ms["fused_cem_step"] = cuda_time_ms(lambda: fused_cem_step_reference(*cem_args),
                                              reps=3, warmup=1)
    cem_steps = CEM_B * CEM_K * CEM_T * CEM_ITERS
    bounds["fused_cem_step"] = cem_bound_for(model, CEM_B, CEM_K, CEM_T, CEM_ELITE, CEM_ITERS)
    print(f"fused_cem_step: {cem_steps} rollout steps per launch", flush=True)
    issue["fused_cem_step"] = issue_line(
        "fused_cem_step", "the sweep's shape", "fused_cem.cu",
        CEM_B * -(-CEM_K // 32) * CEM_T * CEM_ITERS, ms["fused_cem_step"],
        dev_ms["fused_cem_step"], bounds["fused_cem_step"],
        cem_launch_config(model, CEM_T, CEM_K, CEM_B))

    # kernel 5 at iLQR's shape (cart-pole derivatives, check_pd) and at SQP's
    # (acrobot, with_c, mu = 0); the bound with the horizon's chain beside
    # the bytes' and operations'
    d = riccati_main
    time_kernel("riccati_backward_batch", lambda: riccati_backward_batch(*d, ones))
    plain_ms["riccati_backward_batch"] = cuda_time_ms(
        lambda: riccati_backward_batch_reference(*d, ones), reps=3, warmup=1)
    per_t = S + 1 + S * S + 1 + S + S * S + S  # l_x, l_u, l_xx, l_uu, l_ux, f_x, f_u
    riccati_bytes = 4 * ILQR_B * (ILQR_T * (per_t + 1 + S) + S + S * S + 2)
    bounds["riccati_backward_batch"] = bound(riccati_bytes, ILQR_B * ILQR_T * riccati_ops(S))
    chains["riccati_backward_batch"] = chain_ms(ILQR_T, riccati_chain(S), clock)
    with_chain = bound(riccati_bytes, ILQR_B * ILQR_T * riccati_ops(S),
                       chains["riccati_backward_batch"])
    print(f"[{smi}] riccati_backward_batch at iLQR's shape (cart-pole, B={ILQR_B}, T={ILQR_T}, "
          f"S={S}): around one call {ms['riccati_backward_batch']:.4f} ms, device "
          f"{dev_ms['riccati_backward_batch']:.4f} ms; bound {bounds['riccati_backward_batch'][0]:.5f}"
          f" ms ({bounds['riccati_backward_batch'][1]}), with the chain ({riccati_chain(S)} "
          f"dependent operations a step at {clock:.0f} MHz) {with_chain[0]:.5f} ms "
          f"({with_chain[1]})", flush=True)
    fn = lambda: riccati_backward_batch(*sq[:8], sq[8], check_pd=False, with_c=True)  # noqa: E731
    print(f"[{smi}] riccati_backward_batch at SQP's shape (acrobot, with_c, mu = 0, B={SQP_B}, "
          f"T={SQP_T}): around one call {cuda_time_ms(fn):.4f} ms, device "
          f"{device_time_ms(fn):.4f} ms; chain {chain_ms(SQP_T, riccati_chain(4, True), clock):.5f}"
          f" ms", flush=True)

    # kernel 6 at iLQR's shape (cart-pole, with_terminal) and at SQP's
    # (acrobot, n_alpha=8, with_terminal and return_states); the bound with
    # the horizon's chain beside the bytes' and operations'
    acro = AcrobotEnv.model
    ls_in = ls_inputs_for(model, ILQR_B, ILQR_T, 8, dev)
    time_kernel("fused_linesearch",
                lambda: fused_linesearch(model, alphas, *ls_in, with_terminal=True))
    plain_ms["fused_linesearch"] = cuda_time_ms(
        lambda: fused_linesearch_reference(model, alphas, *ls_in, with_terminal=True),
        reps=3, warmup=1)
    bounds["fused_linesearch"] = ls_bound_for(model, N_ALPHAS, ILQR_B, ILQR_T)
    chains["fused_linesearch"] = chain_ms(ILQR_T, linesearch_chain(model.name), clock)
    cfg_ls = ls_launch_config(model, N_ALPHAS, ILQR_B)
    print(f"[{smi}] fused_linesearch at iLQR's shape (cart-pole, n_a={N_ALPHAS}, B={ILQR_B}, "
          f"T={ILQR_T}, terminal): around one call {ms['fused_linesearch']:.4f} ms, device "
          f"{dev_ms['fused_linesearch']:.4f} ms; bound {bounds['fused_linesearch'][0]:.5f} ms "
          f"({bounds['fused_linesearch'][1]}), chain ({linesearch_chain(model.name)} dependent "
          f"operations a step at {clock:.0f} MHz) {chains['fused_linesearch']:.5f} ms; launch "
          f"{cfg_ls}", flush=True)
    ls_sqp = ls_inputs_for(acro, SQP_B, SQP_T, 9, dev)
    fn = lambda: fused_linesearch(acro, sqp_alphas, *ls_sqp, with_terminal=True,  # noqa: E731
                                  return_states=True)
    print(f"[{smi}] fused_linesearch at SQP's shape (acrobot, n_a={len(sqp_alphas)}, B={SQP_B}, "
          f"T={SQP_T}, terminal, states): around one call {cuda_time_ms(fn):.4f} ms, device "
          f"{device_time_ms(fn):.4f} ms; chain ({linesearch_chain(acro.name)} dependent "
          f"operations a step) {chain_ms(SQP_T, linesearch_chain(acro.name), clock):.5f} ms; "
          f"launch {ls_launch_config(acro, len(sqp_alphas), SQP_B)}", flush=True)

    # kernel 4 at SQP's shape and model (acrobot), kernel 7 at configuration 1's
    dv_in = derivs_inputs(acro, SQP_B, SQP_T, 9, True)
    time_kernel("fused_derivs", lambda: fused_derivs(acro, *dv_in))
    plain_ms["fused_derivs"] = cuda_time_ms(lambda: fused_derivs_reference(acro, *dv_in),
                                            reps=3, warmup=1)
    bounds["fused_derivs"] = derivs_bound_for(acro, SQP_B, SQP_T)
    print(f"fused_derivs: {derivs_ops(acro)} operations per acrobot point, {SQP_B * SQP_T} "
          f"points", flush=True)
    dv_cart = derivs_inputs(model, ILQR_B, ILQR_T, 9, True)
    fn = lambda: fused_derivs(model, *dv_cart)  # noqa: E731
    print(f"[{smi}] fused_derivs on cart-pole (the Gauss-Newton iLQR path), B={ILQR_B}, "
          f"T={ILQR_T}: around one call {cuda_time_ms(fn):.4f} ms, device "
          f"{device_time_ms(fn):.4f} ms", flush=True)

    # kernel 7 at configuration 1's shape (the kernels line), per problem at
    # n=50 and past the shared-memory form at n=300 (other_shapes); the bound
    # with the iterations' chain beside the bytes' and operations'
    def admm_bound(B, n, iters, per_problem):
        return bound(4 * ((B if per_problem else 1) * n * n + 2 * B * n + 2 * n),
                     B * iters * n * ADMM_ROW_OPS(n))

    time_kernel("admm_iterate", lambda: admm_iterate(*admm_main, iters=QP1_ITERS))
    plain_ms["admm_iterate"] = cuda_time_ms(
        lambda: admm_iterate_reference(*admm_main, iters=QP1_ITERS), reps=3, warmup=1)
    bounds["admm_iterate"] = admm_bound(QP1_B, QP1_T, QP1_ITERS, False)
    chains["admm_iterate"] = chain_ms(QP1_ITERS, admm_chain(QP1_T), clock)
    print(f"[{smi}] admm_iterate at configuration 1's shape (shared, n={QP1_T}, B={QP1_B}, "
          f"{QP1_ITERS} iterations): around one call {ms['admm_iterate']:.4f} ms, device "
          f"{dev_ms['admm_iterate']:.4f} ms; bound {bounds['admm_iterate'][0]:.5f} ms "
          f"({bounds['admm_iterate'][1]}), chain ({admm_chain(QP1_T)} dependent operations an "
          f"iteration at {clock:.0f} MHz) {chains['admm_iterate']:.5f} ms; launch "
          f"{admm_launch_config(QP1_B, QP1_T, False)}", flush=True)
    for label, args, iters, chain in (
            ("per problem, n=50, B=256, 60 iterations", random_qps(256, 50, True, False, 13), 60,
             chain_ms(60, admm_chain(50), clock)),
            (f"shared, n={ADMM_BIG_N}, B={ADMM_BIG_B}, {ADMM_BIG_ITERS} iterations (streaming)",
             random_qps(ADMM_BIG_B, ADMM_BIG_N, False, False, 25), ADMM_BIG_ITERS, None)):
        B_, n_ = args[1].shape
        fn = lambda a=args, k=iters: admm_iterate(*a, iters=k)  # noqa: E731
        around, device = cuda_time_ms(fn), device_time_ms(fn)
        bnd, launch = admm_bound(B_, n_, iters, args[0].ndim == 3), admm_launch_config(
            B_, n_, args[0].ndim == 3)
        plain = cuda_time_ms(lambda a=args, k=iters: admm_iterate_reference(*a, iters=k),
                             reps=3, warmup=1)
        print(f"[{smi}] admm_iterate {label}: around one call {around:.4f} ms, device "
              f"{device:.4f} ms, plain {plain:.3f} ms; bound {bnd[0]:.5f} ms ({bnd[1]})"
              f"{'' if chain is None else f', chain {chain:.5f} ms'}; launch {launch}", flush=True)
        other_shapes.setdefault("admm_iterate", []).append({
            "shape": label, "ms": around, "device_ms": device, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "chain_bound_ms": chain, "launch": launch})

    # kernels 8a and 8b on a first iteration's matrices: cart-pole at the
    # sweep's shape (the table's row), then the pendulum at configuration 6's.
    # Each bound is the bytes' and the operations' (the kernels line's) and,
    # beside it, the larger with the horizon's loop-carried chain

    def i2c_bounds(p):
        work = i2c_work(p, clock)
        return [bound(b_, o_) for b_, o_, _ in work], [bound(*w) for w in work]

    def i2c_line(label, p, outs, times, plain):
        two, three = i2c_bounds(p)
        D, Zf = p[0].shape[2], p[2].shape[2]
        for i, name in enumerate(("i2c_filter", "i2c_rts_smooth")):
            chain = i2c_filter_chain(D, Zf) if i == 0 else i2c_rts_chain(D)
            print(f"[{smi}] {name} at {label}: kernel {times[i]:.4f} ms, plain {plain[i]:.3f} ms, "
                  f"bound {two[i][0]:.5f} ms ({two[i][1]}); with the chain ({chain} dependent "
                  f"operations a step at {clock:.0f} MHz) {three[i][0]:.5f} ms ({three[i][1]}), "
                  f"{100 * three[i][0] / times[i]:.1f} % of it", flush=True)
        return two

    p, outs = i2c_first_iteration_inputs["cartpole_swingup"]
    time_kernel("i2c_filter", lambda: i2c_filter(*p))
    time_kernel("i2c_rts_smooth", lambda: i2c_rts_smooth(*outs, p[0]))
    chains["i2c_filter"] = chain_ms(I2CS_T, i2c_filter_chain(5, 5), clock)
    chains["i2c_rts_smooth"] = chain_ms(I2CS_T - 1, i2c_rts_chain(5), clock)
    plain_ms["i2c_filter"] = cuda_time_ms(lambda: i2c_filter_reference(*p), reps=3, warmup=1)
    plain_ms["i2c_rts_smooth"] = cuda_time_ms(lambda: i2c_rts_smooth_reference(*outs, p[0]),
                                              reps=3, warmup=1)
    bounds["i2c_filter"], bounds["i2c_rts_smooth"] = i2c_line(
        f"the sweep's shape (cart-pole, B={I2CS_B}, T={I2CS_T}, D=Z=5)", p, outs,
        (ms["i2c_filter"], ms["i2c_rts_smooth"]), (plain_ms["i2c_filter"], plain_ms["i2c_rts_smooth"]))
    print(f"i2c_filter: {i2c_filter_ops(5, 5)} operations per point at D = Z = 5, "
          f"i2c_rts_smooth: {i2c_rts_ops(5)}; {I2CS_B * I2CS_T} points", flush=True)
    p6, outs6 = i2c_first_iteration_inputs["pendulum"]
    fns6 = (lambda: i2c_filter(*p6), lambda: i2c_rts_smooth(*outs6, p6[0]))
    i2c_line(f"configuration 6's shape (pendulum, B={I2C6_B}, T={I2C6_T}, D=Z=3)", p6, outs6,
             [cuda_time_ms(f) for f in fns6],
             (cuda_time_ms(lambda: i2c_filter_reference(*p6), reps=3, warmup=1),
              cuda_time_ms(lambda: i2c_rts_smooth_reference(*outs6, p6[0]), reps=3, warmup=1)))
    print(f"[{smi}] i2c_filter and i2c_rts_smooth at configuration 6's shape: device "
          f"{device_time_ms(fns6[0]):.4f} and {device_time_ms(fns6[1]):.4f} ms", flush=True)

    for name in ms:
        print(f"[{smi}] {name}: around one call {ms[name]:.4f} ms, device {dev_ms[name]:.4f} ms "
              f"(the wrapper's host work before its launch {ms[name] - dev_ms[name]:.4f} ms), "
              f"plain {plain_ms[name]:.3f} ms, bound {bounds[name][0]:.4f} ms ({bounds[name][1]})",
              flush=True)

    def timed_again(label, run):
        """LONG_EPISODE_REPS host-clock episodes of a long path: its
        launch-count run (already warm) and the others run now."""
        return [path_s[label]] + episode_seconds(run, LONG_EPISODE_REPS - 1, warmup=False)

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
                                timed_again("ilqr", ilqr_episode),
                                ILQR_B, ILQR_STEPS),
        "ilqr gauss-newton": report_episodes(
            smi, f"ilqr gauss-newton (warm start {ILQR_WARM} in the time)",
            timed_again("ilqr gauss-newton", ilqr_gn_episode), ILQR_B, ILQR_STEPS),
        "sqp": report_episodes(smi, "sqp", timed_again("sqp", sqp_episode),
                               SQP_B, SQP_STEPS),
        "qpmpc configuration 1": report_episodes(
            smi, "qpmpc configuration 1", episode_seconds(qp1_episode, 5), QP1_B, QP1_STEPS),
        "qpmpc configuration 2": report_episodes(
            smi, "qpmpc configuration 2", timed_again("qpmpc configuration 2", qp2_episode),
            QP2_B, QP2_STEPS),
        "i2c configuration 6": report_episodes(
            smi, "i2c configuration 6", timed_again("i2c configuration 6", i2c6_episode),
            I2C6_B, I2C6_STEPS),
        "i2c sweep row": report_episodes(
            smi, "i2c sweep row", timed_again("i2c sweep row", i2cs_episode),
            I2CS_B, I2CS_STEPS),
    }

    print(f"[{smi}] experiment mppi kernel tier: passed_time "
          f"{exp_results['experiment mppi kernel tier']['passed_time']:.4f} s with "
          f"record_plans=True (a simulate_trajectory of the plans each step), beside the "
          f"direct run_episodes_fused episode of the same path without it, median "
          f"{ep['mppi kernel tier']:.4f} s", flush=True)

    profile_window("mppi kernel-tier episode", smi, mppi_episode)
    profile_window("mppi two-stage episode", smi, lambda: mppi_episode(False))
    profile_window("cem kernel-tier episode", smi, cem_episode)
    profile_window("cem two-stage episode", smi, lambda: cem_episode(False))
    gen = torch.Generator(device=dev).manual_seed(0)
    st = ilqr.init_state_batch(ILQR_B, gen, dev)
    gz = torch.zeros((ILQR_T, Z), device=dev)
    profile_window(f"ilqr solve (one MPC step, {ILQR_ITERS} iterations)", smi,
                   lambda: ilqr.solve_batch(st, ilqr_x0s, gz))
    qp1_st = qp1.init_state_batch(QP1_B, torch.Generator(device=dev).manual_seed(0), dev)
    qp1_gz = torch.zeros((QP1_T, PendulumEnv.model.goal_size), device=dev)
    profile_window("qpmpc configuration 1 solve (one MPC step)", smi,
                   lambda: qp1.solve_batch(qp1_st, qp1_x0s, qp1_gz))
    n_kernels = profile_window(f"sqp solve (one MPC step, {SQP_ITERS} iterations)", smi,
                               lambda: sqp.solve_batch(sqp_st, sqp_x0s, sqp_gz))
    if n_kernels:
        print(f"sqp solve: {n_kernels / SQP_ITERS:.0f} device kernels per iteration (the one "
              f"nominal rollout of the solve shared out over them)", flush=True)
    i2c6_st = i2c6.init_state_batch(I2C6_B, torch.Generator(device=dev).manual_seed(0), dev)
    i2c6_gz = torch.zeros((I2C6_T, PendulumEnv.model.goal_size), device=dev)
    for label, iters, solve in (
            ("configuration 6", I2C6_ITERS, lambda: i2c6.solve_batch(i2c6_st, i2c6_x0s, i2c6_gz)),
            ("sweep row", I2CS_ITERS, lambda: i2cs.solve_batch(i2cs_st, i2cs_x0s, i2cs_gz))):
        n_kernels = profile_window(f"i2c {label} solve (one MPC step, {iters} iterations)", smi,
                                   solve)
        if n_kernels:
            print(f"i2c {label} solve: {n_kernels / iters:.0f} device kernels per iteration",
                  flush=True)
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s", flush=True)

    sources = {
        "fused_mppi_step": ("fused_mppi.cu", "benchmarking_mpc_solvers_tpu/ops/fused_mppi.py:171"),
        "fused_rollout_costs_tm": ("fused_rollout.cu", "benchmarking_mpc_solvers_tpu/ops/fused.py:81"),
        "fused_cem_step": ("fused_cem.cu", "benchmarking_mpc_solvers_tpu/ops/fused_cem.py:111"),
        "riccati_backward_batch": ("riccati_backward.cu",
                                   "benchmarking_mpc_solvers_tpu/ops/riccati_pallas.py:107"),
        "fused_linesearch": ("fused_linesearch.cu",
                             "benchmarking_mpc_solvers_tpu/ops/fused_linesearch.py:122"),
        "fused_derivs": ("fused_derivs.cu", "benchmarking_mpc_solvers_tpu/ops/fused_derivs.py:86"),
        "admm_iterate": ("admm_iterate.cu", "benchmarking_mpc_solvers_tpu/ops/qp_pallas.py:148"),
        "i2c_filter": ("i2c_smooth.cu", "benchmarking_mpc_solvers_tpu/ops/i2c_pallas.py:121"),
        "i2c_rts_smooth": ("i2c_smooth.cu", "benchmarking_mpc_solvers_tpu/ops/i2c_pallas.py:239"),
        # no kernel: the reference's batched tiers draw per-scenario keys in XLA
        "scenario_normals": ("fused_rollout.cu", "benchmarking_mpc_solvers_tpu/solvers/mppi.py:140"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        by_path = {path: n[name] for path, n in launches.items() if n[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"benchmarking_mpc_solvers_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": ms[name], "device_ms": dev_ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "chain_bound_ms": chains.get(name),
            "issue_bound_ms": issue.get(name, (None, None))[0],
            "pipe_bound_ms": issue.get(name, (None, None))[1],
            "other_shapes": other_shapes.get(name, []), "launch": launch_cfgs.get(name),
            "library_ms": None, "pass": True})
    kernels += roofline_entries  # kernels 9 and 10, phase (l)
    for e in family_entries:  # the generic-cost and dummy instantiations, phases (g) to (i)
        src, replaces = sources[e.pop("base")]
        kernels.append({**e, "source": f"benchmarking_mpc_solvers_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches_by_path": {
                            p: n[e["name"].split("[")[0]] for p, n in family_launches.items()
                            if n[e["name"].split("[")[0]]}})
    for e in repair_entries:  # the dummy form past S = 8 and 8a/8b's general form, phase (m)
        src, replaces = sources[e.pop("base")]
        kernels.append({**e, "source": f"benchmarking_mpc_solvers_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches_by_path": {
                            p: n[e["name"].split("[")[0]] for p, n in repair_launches.items()
                            if n[e["name"].split("[")[0]]}})
    print(json.dumps({"kernels": kernels, "episode_ms": {k: v * 1e3 for k, v in ep.items()},
                      "experiment_wall_s": exp_walls, "port_layer": port_layer,
                      "model_family": family, "utils_timers": timers, "study_entry_points": study,
                      "measurement_scripts": {k: {"wall_s": v["wall_s"], "launches": v["launches"]}
                                              for k, v in measure.items()},
                      "repairs_and_suite": suite,
                      "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
