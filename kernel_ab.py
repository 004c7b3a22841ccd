"""Times builds of one kernel source against each other on one NVIDIA GPU.

    python3 kernel_ab.py i2c_smooth.cu --against DIR
        this checkout's csrc/i2c_smooth.cu against DIR's (another checkout,
        for example the parent commit unpacked with ``git archive``)
    python3 kernel_ab.py i2c_smooth.cu -D I2C_RTS_SHAPE=1 -D I2C_RTS_SHAPE=2
        this checkout's source as it is and built with each define
    python3 kernel_ab.py riccati_backward.cu --against DIR
    python3 kernel_ab.py fused_derivs.cu --against DIR
    python3 kernel_ab.py fused_linesearch.cu --against DIR
    python3 kernel_ab.py fused_cem.cu --against DIR
    python3 kernel_ab.py fused_mppi.cu --against DIR
    python3 kernel_ab.py fused_rollout.cu --against DIR
    python3 kernel_ab.py admm_iterate.cu --against DIR
        kernels 5, 4, 6, 3, 1, 2 and 7 against DIR's

Every variant is compiled with the package's flags, all at once, and is
loaded in place of the package's library for that source while it runs, so
that the wrappers a user calls launch it. The variants take turns on each
case (a, b, ..., b, a), and each call is timed two ways:
- around one call: CUDA events around one wrapper call on an idle card, the
  timer of chip_smoke.py (the wrapper's host work before the launch is in it);
- device: CUDA events around 20 calls queued behind a sleeping kernel, per
  call (the host has enqueued them before the card reaches them, so its
  overhead stays out).
Every variant's outputs must equal the first variant's bit for bit. The cases
are the main paths' shapes from chip_smoke.py (``CASES``: the sources of
kernels 8a and 8b, 5, 4, 6, 3, 1, 2 and 7); a source with no cases here is
refused. A variant that does not take a case (a build of admm_iterate.cu
from before its streaming form, at n > 240 and in the streaming form's
timings at n = 120 and 240) sits that case out. For
fused_mppi.cu, fused_rollout.cu and admm_iterate.cu the variants also take
turns on whole episodes of the paths that launch them (``EPISODES``: the
MPPI kernel tier; the MPPI and CEM two-stage tiers; QP-MPC configuration
1), timed on the host clock as chip_smoke.py times them, their costs bit
for bit. For fused_cem.cu, fused_mppi.cu and fused_rollout.cu each variant's
cart-pole rollout loop is counted in its SASS as chip_smoke.py counts it. A build of riccati_backward.cu from before its ok
flags were written as bools is called through the entry point and wrapper
steps of that time, and so is a build of admm_iterate.cu from before its
three forms (entry point ``admm_iterate_launch``, P problems a block). The
last line is a JSON object of every reading.

Imports only the port (``benchmarking_mpc_solvers_tpu_torch``), never JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from benchmarking_mpc_solvers_tpu_torch import _build


def i2c_cases(dev):
    """Kernels 8a and 8b on a first iteration's matrices at configuration
    6's shape and at the sweep row's, as chip_smoke.py times them."""
    from benchmarking_mpc_solvers_tpu_torch.envs import CartPoleSwingUpEnv, PendulumEnv
    from benchmarking_mpc_solvers_tpu_torch.ops.i2c_smooth import i2c_filter, i2c_rts_smooth

    cases = []
    for label, env_, T, B in (
            (f"configuration 6 (pendulum, B={cs.I2C6_B}, T={cs.I2C6_T}, D=Z=3)", PendulumEnv,
             cs.I2C6_T, cs.I2C6_B),
            (f"the sweep's shape (cart-pole, B={cs.I2CS_B}, T={cs.I2CS_T}, D=Z=5)",
             CartPoleSwingUpEnv, cs.I2CS_T, cs.I2CS_B)):
        p = cs.i2c_first_iteration_inputs_for(env_, T, B, 26, dev)
        outs = i2c_filter(*p)
        cases.append((label, [("i2c_filter", lambda p=p: i2c_filter(*p)),
                              ("i2c_rts_smooth", lambda p=p, o=outs: i2c_rts_smooth(*o, p[0]))]))
    return cases


def riccati_cases(dev):
    """Kernel 5 at iLQR's shape (cart-pole derivatives along the initial
    plans, check_pd) and at SQP's (the acrobot's Gauss-Newton terms, with_c,
    mu = 0), as chip_smoke.py times them."""
    from benchmarking_mpc_solvers_tpu_torch.ops.riccati_backward import riccati_backward_batch

    def run(d, mu, c, check_pd, with_c):
        lib = _build._LIBS["riccati_backward.cu"]
        if hasattr(lib, "riccati_backward_batch_launch"):
            return riccati_backward_batch(*d, mu, c, check_pd=check_pd, with_c=with_c)
        return riccati_float_ok(lib, d, mu, c, check_pd, with_c)

    d = cs.ilqr_derivs_for("cartpole_swingup", cs.ILQR_B, cs.ILQR_T, dev)
    ones = torch.ones((cs.ILQR_B,), device=dev)
    sq = cs.sqp_riccati_inputs_for(cs.SQP_B, cs.SQP_T, dev)
    return [
        (f"iLQR's shape (cart-pole, B={cs.ILQR_B}, T={cs.ILQR_T}, check_pd)",
         [("riccati_backward_batch", lambda: run(d, ones, None, True, False))]),
        (f"SQP's shape (acrobot, B={cs.SQP_B}, T={cs.SQP_T}, with_c, mu = 0)",
         [("riccati_backward_batch", lambda: run(sq[:7], sq[7], sq[8], False, True))])]


def riccati_float_ok(lib, d, mu, c, check_pd, with_c):
    """A library whose entry point is the one before the kernel wrote ok as
    a bool (``riccati_backward_launch``, ok as 1.0/0.0 floats), called as its
    wrapper called it: three outputs, then ``ok > 0.5``."""
    fn = lib.riccati_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, Tp1, S = d[0].shape
    T = Tp1 - 1
    dev = d[0].device
    ks = torch.empty((B, T, 1), device=dev)
    Ks = torch.empty((B, T, 1, S), device=dev)
    ok = torch.empty((B,), device=dev)
    _build.check_rc("riccati_backward_launch", fn(
        *(t.data_ptr() for t in (*d, mu)), c.data_ptr() if with_c else None, ks.data_ptr(),
        Ks.data_ptr(), ok.data_ptr(), B, T, S, int(check_pd), _build.stream_ptr(dev)))
    return ks, Ks, ok > 0.5


def derivs_cases(dev):
    """Kernel 4 at the Gauss-Newton iLQR path's shape (cart-pole) and at
    SQP's (acrobot), along rolled-out trajectories, as chip_smoke.py times
    them."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import fused_derivs

    cases = []
    for label, name, B, T in (
            ("Gauss-Newton iLQR's shape", "cartpole_swingup", cs.ILQR_B, cs.ILQR_T),
            ("SQP's shape", "acrobot", cs.SQP_B, cs.SQP_T)):
        model = REGISTRY[name]
        inputs = cs.derivs_inputs_for(model, B, T, 9, True, dev)
        cases.append((f"{label} ({name}, B={B}, T={T})",
                      [("fused_derivs", lambda m=model, i=inputs: fused_derivs(m, *i))]))
    return cases


def linesearch_cases(dev):
    """Kernel 6 at iLQR's shape (cart-pole, n_alpha=10, with_terminal) and at
    SQP's (acrobot, n_alpha=8, with_terminal and return_states), as
    chip_smoke.py times them."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import fused_linesearch
    from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR, SQP

    cart, acro = REGISTRY["cartpole_swingup"], REGISTRY["acrobot"]
    a_ilqr = ILQR(model=cart, T=cs.ILQR_T).alphas(dev)
    a_sqp = SQP(model=acro, T=cs.SQP_T).alphas(dev)
    ilqr_in = cs.ls_inputs_for(cart, cs.ILQR_B, cs.ILQR_T, 8, dev)
    sqp_in = cs.ls_inputs_for(acro, cs.SQP_B, cs.SQP_T, 9, dev)
    return [
        (f"iLQR's shape (cart-pole, n_a={len(a_ilqr)}, B={cs.ILQR_B}, T={cs.ILQR_T}, terminal)",
         [("fused_linesearch",
           lambda: fused_linesearch(cart, a_ilqr, *ilqr_in, with_terminal=True))]),
        (f"SQP's shape (acrobot, n_a={len(a_sqp)}, B={cs.SQP_B}, T={cs.SQP_T}, terminal, "
         f"states)",
         [("fused_linesearch", lambda: fused_linesearch(acro, a_sqp, *sqp_in, with_terminal=True,
                                                        return_states=True))])]


def cem_cases(dev):
    """Kernel 3 at the CEM sweep's shape (cart-pole), with the elite masks,
    as chip_smoke.py checks it."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_cem import fused_cem_step
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import pick_lanes

    model = REGISTRY["cartpole_swingup"]
    plan, x0, gz = cs.mppi_inputs(model, cs.CEM_B, cs.CEM_T, 3, dev)
    args = (model, cs.CEM_K, cs.CEM_ELITE, cs.CEM_ITERS, 0.2, 1.0, pick_lanes(cs.CEM_B), plan,
            x0, gz, 7)
    return [(f"the CEM sweep's shape (cart-pole, B={cs.CEM_B}, T={cs.CEM_T}, K={cs.CEM_K}, "
             f"n_elite={cs.CEM_ELITE}, max_iter={cs.CEM_ITERS}, masks)",
             [("fused_cem_step", lambda: fused_cem_step(*args, return_masks=True))])]


def mppi_cases(dev):
    """Kernel 1 at the bench shape and at the sweep's MPPI row (cart-pole),
    as chip_smoke.py times it; then at three K*T past its noise cache's
    budget (14,080, 17,280 and 32,768 bytes a scenario; with the cache an
    SM would hold 4, 3 and 1 blocks of 4 scenarios), where the two forms
    are compared by building with -DFUSED_MPPI_CACHE_BYTES=0 (redraw) and
    a large value (cache)."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import fused_mppi_step, pick_lanes

    model = REGISTRY["cartpole_swingup"]
    cases = []
    for label, B, K, T in (("the bench shape", cs.BATCH, cs.K_SAMPLES, cs.HORIZON),
                           ("the sweep's MPPI row", cs.MPPI_SWEEP_B, cs.MPPI_SWEEP_K, cs.HORIZON),
                           ("past the cache's budget", cs.BATCH, 32, 110),
                           ("past the cache's budget", cs.BATCH, 48, 90),
                           ("past the cache's budget", cs.BATCH, 64, 128)):
        plan, x0, gz = cs.mppi_inputs(model, B, T, 1, dev)
        args = (model, K, 1.0, 1.0, pick_lanes(B), plan, x0, gz, 7)
        cases.append((f"{label} (cart-pole, B={B}, K={K}, T={T})",
                      [("fused_mppi_step", lambda a=args: fused_mppi_step(*a))]))
    return cases


def rollout_cases(dev):
    """Kernel 2 at the MPPI and the CEM two-stage tiers' shapes (cart-pole),
    as chip_smoke.py times it."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import fused_rollout_costs_tm

    model = REGISTRY["cartpole_swingup"]
    cases = []
    for label, N, T in (("the MPPI two-stage shape", cs.BATCH * cs.K_SAMPLES, cs.HORIZON),
                        ("the CEM two-stage shape", cs.CEM_B * cs.CEM_K, cs.CEM_T)):
        gen = torch.Generator(device=dev).manual_seed(N)
        x0 = torch.rand((model.state_size, N), generator=gen, device=dev) * 2 - 1
        us = torch.rand((T, N), generator=gen, device=dev) * 3 - 1.5
        gz = torch.rand((T, model.goal_size), generator=gen, device=dev) * 0.4 - 0.2
        cases.append((f"{label} (cart-pole, N={N}, T={T})",
                      [("fused_rollout_costs_tm",
                        lambda i=(x0, us, gz): fused_rollout_costs_tm(model, *i))]))
    return cases


def admm_run(Minv, g, lo, hi, rho=1.0, alpha=1.6, iters=100):
    """Kernel 7 through the loaded build of admm_iterate.cu: this checkout's
    entry point through ``admm_iterate``, or a build from before the
    kernel's three forms through its own, as its wrapper called it (see
    ``admm_old_entry``)."""
    from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import admm_iterate

    lib = _build._LIBS["admm_iterate.cu"]
    if hasattr(lib, "admm_launch"):
        return admm_iterate(Minv, g, lo, hi, rho, alpha, iters)
    return admm_old_entry(lib, Minv, g, lo, hi, rho, alpha, iters)


def admm_streaming(Minv, g, lo, hi, rho=1.0, alpha=1.6, iters=100):
    """Kernel 7's streaming form at a shape where ``block_plan`` picks
    another, through the loaded build (the same bits); None for a build
    from before the kernel's three forms, which has no such form."""
    from benchmarking_mpc_solvers_tpu_torch.ops import qp_admm

    if not hasattr(_build._LIBS["admm_iterate.cu"], "admm_launch"):
        return None
    return qp_admm.run_plan(qp_admm.streaming_plan(*g.shape), Minv, g, lo, hi, rho, alpha,
                            iters)


def admm_old_entry(lib, Minv, g, lo, hi, rho, alpha, iters):
    """A build whose entry point is ``admm_iterate_launch`` (a block of P
    problems, Minv in shared memory), called with its wrapper's plan: P =
    128 // n problems, halved until (n² or P·n²) + 2·P·n floats fit 227 KB
    and P·n threads 1,024. None where that wrapper refused (n > 240).

    This, and the cases a variant sits out in ``main`` (None from a run),
    serve only A/Bs against builds from before the kernel's three forms;
    once no such build is compared, both can go."""
    B, n = g.shape
    per_problem = Minv.ndim == 3
    P = max(1, min(128 // n, B))
    while True:
        floats = (P if per_problem else 1) * n * n + 2 * P * n
        if 4 * floats <= 232448 and P * n <= 1024:
            break
        if P == 1:
            return None
        P //= 2
    fn = lib.admm_iterate_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    z = torch.empty((B, n), device=g.device)
    _build.check_rc("admm_iterate_launch", fn(
        *(t.data_ptr() for t in (Minv, g, lo, hi, z)), B, n, P, int(per_problem),
        int(lo.ndim == 2), rho, alpha, 1.0 - alpha, iters, 4 * floats,
        _build.stream_ptr(g.device)))
    return z


def admm_cases(dev):
    """Kernel 7 at QP-MPC configuration 1's problem (shared layout, n=20,
    B=512) and its ragged B=509, per problem at n=20 (B=512), n=50 (B=256;
    the register form), n=120 and n=240 (B=256) and shared at n=120 (B=256;
    the shared-memory form, each also timed in the streaming form: where
    the forms split), and past a block's shared memory (n=300, B=512), as
    chip_smoke.py checks and times them."""
    cases = []
    for label, args, iters, split in (
            (f"configuration 1 (shared, n={cs.QP1_T}, B={cs.QP1_B})",
             cs.qp1_problem_for(cs.QP1_B, dev), cs.QP1_ITERS, False),
            (f"configuration 1, ragged (shared, n={cs.QP1_T}, B=509)",
             cs.qp1_problem_for(509, dev), cs.QP1_ITERS, False),
            ("per problem, n=20, B=512", cs.random_qps_for(512, 20, True, False, 11, dev), 100,
             False),
            ("per problem, n=50, B=256", cs.random_qps_for(256, 50, True, False, 13, dev), 60,
             False),
            ("per problem, n=120, B=256", cs.random_qps_for(256, 120, True, False, 28, dev), 60,
             True),
            ("shared, n=120, B=256", cs.random_qps_for(256, 120, False, False, 29, dev), 60, True),
            ("per problem, n=240, B=256", cs.random_qps_for(256, 240, True, False, 30, dev), 60,
             True),
            (f"shared, n={cs.ADMM_BIG_N}, B={cs.ADMM_BIG_B}",
             cs.random_qps_for(cs.ADMM_BIG_B, cs.ADMM_BIG_N, False, False, 25, dev),
             cs.ADMM_BIG_ITERS, False)):
        kernels = [("admm_iterate", lambda a=args, k=iters: admm_run(*a, iters=k))]
        if split:
            kernels.append(("admm_iterate, streaming form",
                            lambda a=args, k=iters: admm_streaming(*a, iters=k)))
        cases.append((f"{label}, {iters} iterations", kernels))
    return cases


def admm_episodes(dev):
    """QP-MPC configuration 1's episode, as chip_smoke.py drives it, its
    solver pointed at ``admm_run`` so that a build of either entry point
    runs it."""
    from benchmarking_mpc_solvers_tpu_torch.envs import PendulumEnv
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.solvers import QPMPC, qp_mpc

    qp_mpc.admm_iterate = admm_run
    solver = QPMPC(model=PendulumEnv.model, T=cs.QP1_T, method="admm", iters=cs.QP1_ITERS)
    cfg = EpisodeConfig(n_steps=cs.QP1_STEPS, record_plans=False)
    x0s = PendulumEnv.start_state(dev).expand(cs.QP1_B, -1).contiguous()
    return [(f"QP-MPC configuration 1 (B={cs.QP1_B}, {cs.QP1_STEPS} steps)", 3,
             lambda: run_episodes_fused(PendulumEnv, solver, cfg, x0s, device=dev).costs)]


def mppi_episodes(dev):
    """The MPPI kernel tier's episode, as chip_smoke.py drives it."""
    from benchmarking_mpc_solvers_tpu_torch.envs import CartPoleSwingUpEnv as env
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.solvers import MPPI

    solver = MPPI(model=env.model, T=cs.HORIZON, K=cs.K_SAMPLES, std=1.0, lam=1.0)
    cfg = EpisodeConfig(n_steps=cs.N_STEPS, warmstart=0, record_plans=False)
    x0s = env.start_state(dev).expand(cs.BATCH, -1).contiguous()
    return [(f"the MPPI kernel tier (B={cs.BATCH}, {cs.N_STEPS} steps)", 12,
             lambda: run_episodes_fused(env, solver, cfg, x0s,
                                        generator=torch.Generator(device=dev).manual_seed(0),
                                        device=dev).costs)]


def rollout_episodes(dev):
    """The MPPI and the CEM two-stage tiers' episodes, as chip_smoke.py
    drives them."""
    from benchmarking_mpc_solvers_tpu_torch.envs import CartPoleSwingUpEnv as env
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, MPPI

    out = []
    for label, solver, B, steps, reps in (
            ("the MPPI two-stage tier",
             MPPI(model=env.model, T=cs.HORIZON, K=cs.K_SAMPLES, std=1.0, lam=1.0), cs.BATCH,
             cs.N_STEPS, 6),
            ("the CEM two-stage tier",
             CEM(model=env.model, T=cs.CEM_T, K=cs.CEM_K, n_elite=cs.CEM_ELITE,
                 max_iter=cs.CEM_ITERS), cs.CEM_B, cs.CEM_STEPS, 4)):
        cfg = EpisodeConfig(n_steps=steps, warmstart=0, record_plans=False)
        x0s = env.start_state(dev).expand(B, -1).contiguous()
        out.append((f"{label} (B={B}, {steps} steps)", reps,
                    lambda s=solver, c=cfg, x=x0s: run_episodes_fused(
                        env, s, c, x, generator=torch.Generator(device=dev).manual_seed(0),
                        use_kernel=False, device=dev).costs))
    return out


CASES = {"i2c_smooth.cu": i2c_cases, "riccati_backward.cu": riccati_cases,
         "fused_derivs.cu": derivs_cases, "fused_linesearch.cu": linesearch_cases,
         "fused_cem.cu": cem_cases, "fused_mppi.cu": mppi_cases,
         "fused_rollout.cu": rollout_cases, "admm_iterate.cu": admm_cases}
# whole episodes of the paths that launch a source's kernel: (label, episodes
# per turn, a run returning the episode's costs)
EPISODES = {"fused_mppi.cu": mppi_episodes, "fused_rollout.cu": rollout_episodes,
            "admm_iterate.cu": admm_episodes}


def loop_count(path: Path, source: str) -> str:
    """A build's cart-pole rollout loop, as chip_smoke.py counts it."""
    counted = cs.sass_loop(path, source)
    if counted is None:
        return "rollout loop not counted"
    return (f"the cart-pole rollout loop issues {counted[0]} SASS instructions a trip on its "
            f"fast path ({counted[1]} in its body)")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        return a.dtype == b.dtype and bool(torch.equal(a, b))
    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan)) and bool(torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="a file of benchmarking_mpc_solvers_tpu_torch/csrc")
    ap.add_argument("--against", action="append", default=[], metavar="DIR",
                    help="another checkout whose source is a variant")
    ap.add_argument("-D", dest="defines", action="append", default=[], metavar="NAME=VALUE",
                    help="a variant: this checkout's source built with -DNAME=VALUE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this script needs a CUDA card")
        return 1
    if args.source not in CASES:
        print(f"FAIL: no cases for {args.source}; there are for {sorted(CASES)}")
        return 1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    here = _build.CSRC / args.source
    variants = [("this checkout", here, ())]
    variants += [(f"{d}'s", Path(d) / "benchmarking_mpc_solvers_tpu_torch" / "csrc" / args.source, ())
                 for d in args.against]
    variants += [(f"this checkout, -D{d}", here, (f"-D{d}",)) for d in args.defines]
    if len(variants) < 2:
        print("FAIL: name a variant to compare with (--against DIR or -D NAME=VALUE)")
        return 1

    dev = torch.device("cuda")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (_, src, defines) in enumerate(variants):
        path = _build.BUILD_DIR / f"ab{i}-{Path(args.source).stem}.so"
        procs.append((path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(src.parent), "-o", str(path),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (label, _, _), (path, proc) in zip(variants, procs):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"FAIL: nvcc for {label}:\n{log}")
            return 1
        libs.append(_build.typed(ctypes.CDLL(str(path)), args.source))
        if args.source in cs.SASS_LOOPS:
            print(f"{label} source: {loop_count(path, args.source)}", flush=True)

    _build._LIBS[args.source] = libs[0]  # the wrappers launch whichever is here
    cases = CASES[args.source](dev)
    order = list(range(len(variants))) + list(reversed(range(len(variants))))
    readings = []
    for label, kernels in cases:
        for name, fn in kernels:
            first, takes = None, []
            for i, lib in enumerate(libs):
                _build._LIBS[args.source] = lib
                out = fn()
                takes.append(out is not None)
                if out is None:
                    if i == 0:
                        print(f"FAIL: {name} at {label}: {variants[0][0]} does not take it")
                        return 1
                    print(f"{name} at {label}: {variants[i][0]} source does not take this "
                          f"case", flush=True)
                    continue
                out = list(out) if isinstance(out, tuple) else [out]
                torch.cuda.synchronize()
                if first is None:
                    first = out
                elif not all(same_bits(a, b) for a, b in zip(out, first)):
                    print(f"FAIL: {name} at {label}: {variants[i][0]} outputs differ from "
                          f"{variants[0][0]}")
                    return 1
            times = [{"around_one_call_ms": [], "device_ms": []} for _ in variants]
            for i in order:
                if not takes[i]:
                    continue
                _build._LIBS[args.source] = libs[i]
                times[i]["around_one_call_ms"].append(cs.cuda_time_ms(fn))
                times[i]["device_ms"].append(cs.device_time_ms(fn))
            base = statistics.mean(times[0]["device_ms"])
            for (vlabel, _, _), t, took in zip(variants, times, takes):
                if not took:
                    continue
                print(f"[{smi}] {name} at {label}, {vlabel} source: around one call "
                      f"{', '.join(f'{x:.4f}' for x in t['around_one_call_ms'])} ms; device "
                      f"{', '.join(f'{x:.4f}' for x in t['device_ms'])} ms; "
                      f"{statistics.mean(t['device_ms']) / base:.2f}x this checkout's "
                      f"device time", flush=True)
            readings.append({"kernel": name, "case": label, "variants": [
                dict(variant=v[0], **t) for v, t in zip(variants, times)]})
    episodes = []
    for label, reps, run in EPISODES.get(args.source, lambda _: [])(dev):
        first = None
        for i, lib in enumerate(libs):
            _build._LIBS[args.source] = lib
            costs = run()  # also the warm-up of this variant
            if first is None:
                first = costs
            elif not same_bits(costs, first):
                print(f"FAIL: the episode of {label}: {variants[i][0]} costs differ from "
                      f"{variants[0][0]}")
                return 1
        times = [[] for _ in variants]
        for i in order:
            _build._LIBS[args.source] = libs[i]
            times[i] += [s * 1e3 for s in cs.episode_seconds(run, reps, warmup=False)]
        for (vlabel, _, _), t in zip(variants, times):
            q1, med, q3 = statistics.quantiles(t, n=4)
            print(f"[{smi}] episode of {label}, {vlabel} source: median "
                  f"{statistics.median(t):.3f} ms (quartiles {q1:.3f}-{q3:.3f}, n={len(t)})",
                  flush=True)
        episodes.append({"episode": label, "variants": [
            {"variant": v[0], "episode_ms": t} for v, t in zip(variants, times)]})
    print(f"outputs identical across the {len(variants)} variants in every case they take",
          flush=True)
    print(json.dumps({"device": smi, "source": args.source, "readings": readings,
                      "episodes": episodes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
