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
    python3 kernel_ab.py roofline.cu --against DIR
        kernels 5, 4, 6, 3, 1, 2, 7, and 9 and 10 against DIR's
    python3 kernel_ab.py fused_mppi.cu --against DIR -D BMPC_GENERIC_COST=1
        also this checkout's kernel 1 with every stage cost in its generic
        form (the same for fused_rollout.cu, fused_cem.cu, fused_linesearch.cu)
    python3 kernel_ab.py draw
        the two-stage tiers' noise draw: its plain PyTorch version (the int64
        emulation, then the std scaling and the time-major view, as
        MPPI.solve_batch drew before the draw kernel) against the kernel in
        this checkout's fused_rollout.cu, at the noise cell's shape, beside
        its bound and its loop's issue and pipe floors (``draw_ab``)

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
kernels 8a and 8b, 5, 4, 6, 3, 1, 2 and 7; kernels 1, 2, 3, 4 and 6 on the
three plants; kernels 9 and 10 at the roofline rows' shapes); a source with
no cases here is refused. A variant whose
``models.cuh`` has another kMaxZ (a build from before the dummy family's
functors: 5) is handed its weights in that layout, and a build of
fused_rollout.cu from before the dummy's rows form runs that form's
launches in its list form (``rows_as_list``). For
fused_mppi.cu, fused_rollout.cu and admm_iterate.cu the variants also take
turns on whole episodes of the paths that launch them (``EPISODES``: the
MPPI kernel tier; the MPPI and CEM two-stage tiers; QP-MPC configuration
1), timed on the host clock as chip_smoke.py times them, their costs bit
for bit. For fused_cem.cu, fused_mppi.cu and fused_rollout.cu each variant's
cart-pole rollout loop is counted in its SASS as chip_smoke.py counts it (by
pipe too), and for roofline.cu each instantiation's chain loop. A
build of riccati_backward.cu from before its ok flags were written as bools
is called through the entry point and wrapper steps of that time. The last
line is a JSON object of every reading.

Imports only the port (``benchmarking_mpc_solvers_tpu_torch``), never JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from benchmarking_mpc_solvers_tpu_torch import _build


def i2c_cases(dev):
    """Kernels 8a and 8b on a first iteration's matrices at configuration
    6's shape and at the sweep row's, as chip_smoke.py times them, on the
    dummy at S = 5 (D = Z = 6, the register form's largest instance), in
    the general form on the dummy at S = 8 and 15 (D = Z = 9 and 16), in
    the wide form on the dummy at S = 16, 23 and 31 (D = Z = 17, 24 and 32)
    and on a random problem at D = 20, Z = 28, and in the large form on the
    dummy at S = 32 (D = Z = 33), each at the sweep row's B and T."""
    from benchmarking_mpc_solvers_tpu_torch.envs import CartPoleSwingUpEnv, PendulumEnv
    from benchmarking_mpc_solvers_tpu_torch.models import make_dummy_model
    from benchmarking_mpc_solvers_tpu_torch.ops.i2c_smooth import (
        i2c_filter, i2c_rts_smooth, kernel_form)

    def dummy_env(S):
        return dataclasses.replace(PendulumEnv, name="dummy", model=make_dummy_model(S, 1),
                                   default_start=(0.5,) * S)

    problems = [
        (f"configuration 6 (pendulum, B={cs.I2C6_B}, T={cs.I2C6_T}, D=Z=3)",
         lambda: cs.i2c_first_iteration_inputs_for(PendulumEnv, cs.I2C6_T, cs.I2C6_B, 26, dev)),
        (f"the sweep's shape (cart-pole, B={cs.I2CS_B}, T={cs.I2CS_T}, D=Z=5)",
         lambda: cs.i2c_first_iteration_inputs_for(CartPoleSwingUpEnv, cs.I2CS_T, cs.I2CS_B, 26,
                                                   dev)),
        (f"the register form's largest (dummy S=5, B={cs.I2C6_B}, T={cs.I2C6_T}, D=Z=6)",
         lambda: cs.i2c_first_iteration_inputs_for(dummy_env(5), cs.I2C6_T, cs.I2C6_B, 26, dev))]
    for S in (8, 15, 16, 23, 31, 32):
        problems.append((f"the {kernel_form(S + 1, S + 1)} form (dummy S={S}, B={cs.I2CS_B}, "
                         f"T={cs.I2CS_T}, D=Z={S + 1})",
                         lambda S=S: cs.i2c_first_iteration_inputs_for(
                             dummy_env(S), cs.I2CS_T, cs.I2CS_B, 26, dev)))
    problems.append((f"the wide form, D != Z (random, B={cs.I2CS_B}, T={cs.I2CS_T}, D=20, Z=28)",
                     lambda: cs.i2c_random_problem(cs.I2CS_B, cs.I2CS_T, 19, 1, 28, 27, dev)))
    cases = []
    for label, make in problems:
        p = make()
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
    """Kernel 4 at the Gauss-Newton iLQR path's shape (cart-pole, and the
    pendulum) and at SQP's (acrobot), along rolled-out trajectories, as
    chip_smoke.py times them."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import fused_derivs

    cases = []
    for label, name, B, T in (
            ("Gauss-Newton iLQR's shape", "cartpole_swingup", cs.ILQR_B, cs.ILQR_T),
            ("SQP's shape", "acrobot", cs.SQP_B, cs.SQP_T),
            ("Gauss-Newton iLQR's shape", "pendulum", cs.ILQR_B, cs.ILQR_T)):
        model = REGISTRY[name]
        inputs = cs.derivs_inputs_for(model, B, T, 9, True, dev)
        cases.append((f"{label} ({name}, B={B}, T={T})",
                      [("fused_derivs", lambda m=model, i=inputs: fused_derivs(m, *i))]))
    return cases


def linesearch_cases(dev):
    """Kernel 6 at iLQR's shape (cart-pole and the pendulum, n_alpha=10,
    with_terminal) and at SQP's (acrobot, n_alpha=8, with_terminal and
    return_states), as chip_smoke.py times them."""
    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import fused_linesearch
    from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR, SQP

    cart, acro, pend = REGISTRY["cartpole_swingup"], REGISTRY["acrobot"], REGISTRY["pendulum"]
    a_ilqr = ILQR(model=cart, T=cs.ILQR_T).alphas(dev)
    a_sqp = SQP(model=acro, T=cs.SQP_T).alphas(dev)
    ilqr_in = cs.ls_inputs_for(cart, cs.ILQR_B, cs.ILQR_T, 8, dev)
    sqp_in = cs.ls_inputs_for(acro, cs.SQP_B, cs.SQP_T, 9, dev)
    pend_in = cs.ls_inputs_for(pend, cs.ILQR_B, cs.ILQR_T, 8, dev)
    return [
        (f"iLQR's shape (cart-pole, n_a={len(a_ilqr)}, B={cs.ILQR_B}, T={cs.ILQR_T}, terminal)",
         [("fused_linesearch",
           lambda: fused_linesearch(cart, a_ilqr, *ilqr_in, with_terminal=True))]),
        (f"iLQR's shape (pendulum, n_a={len(a_ilqr)}, B={cs.ILQR_B}, T={cs.ILQR_T}, terminal)",
         [("fused_linesearch",
           lambda: fused_linesearch(pend, a_ilqr, *pend_in, with_terminal=True))]),
        (f"SQP's shape (acrobot, n_a={len(a_sqp)}, B={cs.SQP_B}, T={cs.SQP_T}, terminal, "
         f"states)",
         [("fused_linesearch", lambda: fused_linesearch(acro, a_sqp, *sqp_in, with_terminal=True,
                                                        return_states=True))])]


def draw_ab(dev, B: int = 10240, K: int = 64, T: int = 50, std: float = 1.0) -> dict:
    """The two-stage draw at (B, K, T) (the noise cell's): the plain version
    as ``MPPI.solve_batch`` ran it before the draw kernel (the int64
    emulation, std times it, the time-major view) against the kernel's
    scaled draw and the same view, in turns (plain, kernel, kernel, plain),
    each output held bit for bit against the plain one. Beside them the
    kernel's bound (its stores at the card's memory rate, its operations at
    the FP32 rate) and the issue and pipe floors of its loop's SASS."""
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import (
        scenario_normals, scenario_normals_launch_config, scenario_normals_reference)

    gen = torch.Generator(device=dev).manual_seed(B)
    seeds = torch.randint(0, 2**63 - 1, (B,), generator=gen, device=dev)
    calls = torch.randint(0, 20, (B,), generator=gen, device=dev)
    N = B * K

    def plain():
        delta = std * scenario_normals_reference(seeds, calls, K, T).reshape(B, K, T, 1)
        return delta[..., 0].permute(2, 0, 1).reshape(T, N)

    def kernel():
        return scenario_normals(seeds, calls, K, T, scale=std).permute(2, 0, 1).reshape(T, N)

    forms = {"plain (int64 emulation, std *, time-major view)": plain,
             "kernel, scaled, time-major view": kernel}
    if not torch.equal(kernel(), plain()):
        raise AssertionError("the draw kernel differs from the plain version")
    times = {label: {"around_one_call_ms": [], "device_ms": []} for label in forms}
    order = list(forms) + list(reversed(forms))
    for label in order:
        times[label]["around_one_call_ms"].append(cs.cuda_time_ms(forms[label]))
        times[label]["device_ms"].append(cs.device_time_ms(forms[label]))
    bnd = cs.draw_bound_for(B, K, T)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = cs.max_sm_clock_mhz()
    trips = -(-N // 32) * T
    counted = cs.sass_loop(_build._target("fused_rollout.cu"), "fused_rollout.cu",
                          cs.DRAW_SASS_LOOPS)
    floors = None if counted is None else {
        "issue_ms": counted[0] * trips / (sms * 4 * clock * 1e3),
        "pipe_ms": cs.pipe_floor_ms(counted[2], trips, sms, clock), "sass_per_trip": counted,
        "warp_trips": trips, "sms": sms, "clock_mhz": clock}
    return {"shape": f"B={B}, K={K}, T={T}", "times": times, "bound_ms": bnd[0],
            "bound_by": bnd[1], "floors": floors, "launch": scenario_normals_launch_config(N)}


def _model(name):
    """A registered plant; ``dummy<S>``: make_dummy_model(S, 1); ``dense<S>``:
    the dummy under dense weights drawn as chip_smoke.py's phase (m) draws
    them (at S = 12 its own: 12 of its 91 terms leave out the action, and
    the dummy form of kernels 1 and 3 takes the whole list); ``midlist16``:
    the dummy at S = 16 under the identity with a symmetric (8, 16) term (9
    terms from the first action term on, the whole list too)."""
    import numpy as np

    from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY, make_dummy_model
    from benchmarking_mpc_solvers_tpu_torch.models.base import quad_cost

    if name.startswith("dense"):
        S = int(name[len("dense"):])
        Wm = np.random.default_rng(12).uniform(-0.5, 1.0, (S + 1, S + 1)).astype(np.float32)
        return dataclasses.replace(make_dummy_model(S, 1), state_cost=quad_cost(Wm @ Wm.T))
    if name == "midlist16":
        W = np.eye(17, dtype=np.float32)
        W[8, 16] = W[16, 8] = 0.3
        return dataclasses.replace(make_dummy_model(16, 1), state_cost=quad_cost(W))
    if name.startswith("dummy"):
        return make_dummy_model(int(name[len("dummy"):]), 1)
    return REGISTRY[name]


def without_n_lead(lib: ctypes.CDLL, source: str) -> None:
    """A build of ``source`` from before the dummy form split its cost takes
    no n_lead: its dummy entry point, typed as it was, is called with the
    wrappers' arguments less that one."""
    name = {"fused_cem.cu": "fused_cem_dummy_launch",
            "fused_mppi.cu": "fused_mppi_dummy_launch"}.get(source)
    if name is None or not hasattr(lib, name) or hasattr(lib, f"{name}_config"):
        return
    fn = lib[name]
    argtypes = _build.SIGNATURES[name][1]
    fn.argtypes = argtypes[:-2] + argtypes[-1:]
    fn.restype = ctypes.c_int
    setattr(lib, name, lambda *a: fn(*a[:-2], a[-1]))


def cem_cases(dev):
    """Kernel 3 at the CEM sweep's shape on each plant (cart-pole's is the
    sweep's), with the elite masks, as chip_smoke.py checks it; on the dummy
    at S = 2 and 8 (its functors) and past 8 in its dummy form: S = 16 (one
    action term), the dense S = 12 and the mid-list weights (the whole
    list)."""
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_cem import fused_cem_step
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import pick_lanes

    cases = []
    for name in ("cartpole_swingup", "pendulum", "acrobot", "dummy2", "dummy8", "dummy16",
                 "dense12", "midlist16"):
        model = _model(name)
        plan, x0, gz = cs.mppi_inputs(model, cs.CEM_B, cs.CEM_T, 3, dev)
        args = (model, cs.CEM_K, cs.CEM_ELITE, cs.CEM_ITERS, 0.2, 1.0, pick_lanes(cs.CEM_B),
                plan, x0, gz, 7)
        cases.append((f"the CEM sweep's shape ({name}, B={cs.CEM_B}, T={cs.CEM_T}, "
                      f"K={cs.CEM_K}, n_elite={cs.CEM_ELITE}, max_iter={cs.CEM_ITERS}, masks)",
                      [("fused_cem_step",
                        lambda a=args: fused_cem_step(*a, return_masks=True))]))
    return cases


def mppi_cases(dev):
    """Kernel 1 at the bench shape (each plant; the dummy as kernel 3's
    cases have it) and at the sweep's MPPI row
    (cart-pole), as chip_smoke.py times it; then at three K*T past its noise cache's
    budget (14,080, 17,280 and 32,768 bytes a scenario; with the cache an
    SM would hold 4, 3 and 1 blocks of 4 scenarios), where the two forms
    are compared by building with -DFUSED_MPPI_CACHE_BYTES=0 (redraw) and
    a large value (cache)."""
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import fused_mppi_step, pick_lanes

    cases = []
    for label, name, B, K, T in (
            ("the bench shape", "cartpole_swingup", cs.BATCH, cs.K_SAMPLES, cs.HORIZON),
            ("the bench shape", "pendulum", cs.BATCH, cs.K_SAMPLES, cs.HORIZON),
            ("the bench shape", "acrobot", cs.BATCH, cs.K_SAMPLES, cs.HORIZON),
            ("the bench shape", "dummy2", cs.BATCH, cs.K_SAMPLES, cs.HORIZON),
            ("the bench shape", "dummy8", cs.BATCH, cs.K_SAMPLES, cs.HORIZON),
            ("the bench shape", "dummy16", cs.BATCH, cs.K_SAMPLES, cs.HORIZON),
            ("the bench shape", "dense12", cs.BATCH, cs.K_SAMPLES, cs.HORIZON),
            ("the bench shape", "midlist16", cs.BATCH, cs.K_SAMPLES, cs.HORIZON),
            ("the sweep's MPPI row", "cartpole_swingup", cs.MPPI_SWEEP_B, cs.MPPI_SWEEP_K,
             cs.HORIZON),
            ("past the cache's budget", "cartpole_swingup", cs.BATCH, 32, 110),
            ("past the cache's budget", "cartpole_swingup", cs.BATCH, 48, 90),
            ("past the cache's budget", "cartpole_swingup", cs.BATCH, 64, 128)):
        model = _model(name)
        plan, x0, gz = cs.mppi_inputs(model, B, T, 1, dev)
        args = (model, K, 1.0, 1.0, pick_lanes(B), plan, x0, gz, 7)
        cases.append((f"{label} ({name}, B={B}, K={K}, T={T})",
                      [("fused_mppi_step", lambda a=args: fused_mppi_step(*a))]))
    return cases


def rollout_cases(dev):
    """Kernel 2 at the MPPI two-stage tier's shape (each plant; the dummy
    through its functors at S = 2 and 8 and in its dummy form: the rows
    form at S = 9, 16 and 31, the list form under the dense S = 12 weights)
    and the CEM two-stage tier's (cart-pole; the dummy's rows form and the
    dense S = 12), as chip_smoke.py times it."""
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import fused_rollout_costs_tm

    mppi, cem = cs.BATCH * cs.K_SAMPLES, cs.CEM_B * cs.CEM_K
    shapes = [("the MPPI two-stage shape", name, mppi, cs.HORIZON)
              for name in ("cartpole_swingup", "pendulum", "acrobot", "dummy2", "dummy8",
                           "dummy9", "dummy16", "dummy31", "dense12")]
    shapes += [("the CEM two-stage shape", name, cem, cs.CEM_T)
               for name in ("cartpole_swingup", "dummy9", "dummy16", "dummy31", "dense12")]
    cases = []
    for label, name, N, T in shapes:
        model = _model(name)
        gen = torch.Generator(device=dev).manual_seed(N)
        x0 = torch.rand((model.state_size, N), generator=gen, device=dev) * 2 - 1
        us = torch.rand((T, N), generator=gen, device=dev) * 3 - 1.5
        gz = torch.rand((T, model.goal_size), generator=gen, device=dev) * 0.4 - 0.2
        cases.append((f"{label} ({name}, N={N}, T={T})",
                      [("fused_rollout_costs_tm",
                        lambda m=model, i=(x0, us, gz): fused_rollout_costs_tm(m, *i))]))
    return cases


def rows_terms(rows, S: int) -> list:
    """The term list (i, j, the bits of the float32 w, 0) in ``quad_cost``'s
    order that the rows form's weights ``rows`` (``ops.fused.DummyRows``) at
    state size S stand for: ``_build.dummy_terms``' of the same cost."""
    import numpy as np

    terms = []
    for r in range(S):
        terms.append((r, r, rows.d[r]))
        if (rows.acts >> r) & 1:
            terms.append((r, S, rows.a[r]))
    if rows.square:
        terms.append((S, S, rows.s))
    return [(i, j, int(np.float32(w).view(np.int32)), 0) for i, j, w in terms]


def rows_as_list(lib: ctypes.CDLL, source: str) -> None:
    """A build of fused_rollout.cu from before the dummy's rows form has
    only the list form: its library is given the rows form's entry point,
    which runs the list kernel on the term list the rows' weights stand for
    (``rows_terms``, kept on the device per weights and S)."""
    if source != "fused_rollout.cu" or hasattr(lib, "fused_rollout_dummy_rows_launch"):
        return
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import DummyRows

    lists = {}

    def launch(row, acts, x0, us, gz, out, T, N, S, w, stream):
        if (w, S) not in lists:
            lists[w, S] = torch.tensor(rows_terms(DummyRows.from_address(w), S),
                                       dtype=torch.int32, device="cuda").reshape(-1, 4)
        terms = lists[w, S]
        return lib.fused_rollout_dummy_launch(S, x0, us, gz, out, T, N, _build.ptr(terms),
                                              terms.shape[0], stream)

    lib.fused_rollout_dummy_rows_launch = launch


def draw_of(lib: ctypes.CDLL, this: ctypes.CDLL) -> None:
    """A build of fused_rollout.cu from before the draw kernel is given this
    checkout's draw entry points (``this``), so that the two-stage episodes,
    which launch the draw, run that build's kernel 2 beside the same draw."""
    for name in ("scenario_normals_launch", "scenario_normals_launch_config"):
        if hasattr(this, name) and not hasattr(lib, name):
            setattr(lib, name, getattr(this, name))


def roofline_cases(dev):
    """Kernel 9, every op, at the roofline kernel rows' shape (grid 256 x
    (8, 512), inner 2,048), and kernel 10, both forms, at the noise rows'
    (1,024 x (8, 512), inner 256), as chip_smoke.py times them."""
    import numpy as np

    from benchmarking_mpc_solvers_tpu_torch.ops.roofline import OPS, roofline_noise, roofline_op

    x = torch.from_numpy(np.random.default_rng(9).uniform(
        -2.0, 2.0, (cs.ROOFLINE_GRID, 8, 512)).astype(np.float32)).to(dev)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    cases = [(f"the kernel row (grid {cs.ROOFLINE_GRID} x (8, 512), inner {cs.ROOFLINE_INNER})",
              [(f"roofline_op[{op}]", lambda op=op: roofline_op(op, x, cs.ROOFLINE_INNER))
               for op in OPS])]
    cases.append((f"the noise row ({cs.NOISE_PROGRAMS} x (8, 512), inner {cs.NOISE_INNER})",
                  [(f"roofline_noise[{form}]",
                    lambda p=form == "paired": roofline_noise(seed, cs.NOISE_PROGRAMS,
                                                              cs.NOISE_INNER, p))
                   for form in ("single", "paired")]))
    return cases


def admm_run(Minv, g, lo, hi, rho=1.0, alpha=1.6, iters=100):
    """Kernel 7 through the loaded build of admm_iterate.cu."""
    from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import admm_iterate

    return admm_iterate(Minv, g, lo, hi, rho, alpha, iters)


def admm_streaming(Minv, g, lo, hi, rho=1.0, alpha=1.6, iters=100):
    """Kernel 7's streaming form at a shape where ``block_plan`` picks
    another, through the loaded build (the same bits)."""
    from benchmarking_mpc_solvers_tpu_torch.ops import qp_admm

    return qp_admm.run_plan(qp_admm.streaming_plan(*g.shape), Minv, g, lo, hi, rho, alpha,
                            iters)


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
    solver pointed at ``admm_run``."""
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
         "fused_rollout.cu": rollout_cases, "admm_iterate.cu": admm_cases,
         "roofline.cu": roofline_cases}
# whole episodes of the paths that launch a source's kernel: (label, episodes
# per turn, a run returning the episode's costs)
EPISODES = {"fused_mppi.cu": mppi_episodes, "fused_rollout.cu": rollout_episodes,
            "admm_iterate.cu": admm_episodes}


def loop_count(path: Path, source: str, loops: dict = cs.SASS_LOOPS) -> str:
    """A build's cart-pole rollout loop (kernels 1, 2, 3; with
    ``cs.DUMMY_SASS_LOOPS`` the dummy form's one-term loop of 1 and 3), or
    each roofline instantiation's chain loop (kernels 9, 10), as
    chip_smoke.py counts it."""
    if source == "roofline.cu":
        counts = cs.roofline_loop_counts(path)
        if not counts:
            return "chain loops not counted"
        return "chain loops' SASS a trip (static; by pipe): " + "; ".join(
            f"{k} {c[0]} ({c[1]}; {c[2]})" for k, c in counts.items())
    counted = cs.sass_loop(path, source, loops)
    what = "the cart-pole rollout loop" if loops is cs.SASS_LOOPS else "the dummy form's loop"
    if counted is None:
        return f"{what} not counted"
    return (f"{what} issues {counted[0]} SASS instructions a trip on its fast path "
            f"({counted[1]} in its body; by pipe {counted[2]})")


def max_z_of(csrc: Path) -> int:
    """The kMaxZ of a variant's ``models.cuh``: the row stride of the weights
    its entry points read."""
    return int(re.search(r"constexpr int kMaxZ = (\d+);",
                         (csrc / "models.cuh").read_text()).group(1))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        return a.dtype == b.dtype and bool(torch.equal(a, b))
    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan)) and bool(torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", help="a file of benchmarking_mpc_solvers_tpu_torch/csrc, or "
                                   "draw (the noise draw against its plain version)")
    ap.add_argument("--against", action="append", default=[], metavar="DIR",
                    help="another checkout whose source is a variant")
    ap.add_argument("-D", dest="defines", action="append", default=[], metavar="NAME=VALUE",
                    help="a variant: this checkout's source built with -DNAME=VALUE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this script needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.source == "draw":
        print(smi, flush=True)
        res = draw_ab(torch.device("cuda"))
        for label, t in res["times"].items():
            print(f"[{smi}] the draw at {res['shape']}, {label}: around one call "
                  f"{', '.join(f'{x:.4f}' for x in t['around_one_call_ms'])} ms; device "
                  f"{', '.join(f'{x:.4f}' for x in t['device_ms'])} ms", flush=True)
        print(f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}); loop floors "
              f"{res['floors'] or 'not counted'}; launch {res['launch']}")
        print(json.dumps({"device": smi, "source": "draw", **res}))
        return 0
    if args.source not in CASES:
        print(f"FAIL: no cases for {args.source}; there are for {sorted(CASES)}")
        return 1

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
        without_n_lead(libs[-1], args.source)
        rows_as_list(libs[-1], args.source)
        if args.source in cs.SASS_LOOPS or args.source == "roofline.cu":
            print(f"{label} source: {loop_count(path, args.source)}", flush=True)
        if args.source in cs.DUMMY_SASS_LOOPS:
            print(f"{label} source: {loop_count(path, args.source, cs.DUMMY_SASS_LOOPS)}",
                  flush=True)

    for lib in libs[1:]:
        draw_of(lib, libs[0])
    max_z = [max_z_of(src.parent) for _, src, _ in variants]

    def load(i):
        """Variant i's library in the wrappers' place, its weight layout theirs."""
        _build._LIBS[args.source] = libs[i]
        _build.MAX_Z = max_z[i]

    load(0)
    cases = CASES[args.source](dev)
    order = list(range(len(variants))) + list(reversed(range(len(variants))))
    readings = []
    for label, kernels in cases:
        for name, fn in kernels:
            first = None
            for i in range(len(libs)):
                load(i)
                out = fn()
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
                load(i)
                times[i]["around_one_call_ms"].append(cs.cuda_time_ms(fn))
                times[i]["device_ms"].append(cs.device_time_ms(fn))
            base = statistics.mean(times[0]["device_ms"])
            for (vlabel, _, _), t in zip(variants, times):
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
        for i in range(len(libs)):
            load(i)
            costs = run()  # also the warm-up of this variant
            if first is None:
                first = costs
            elif not same_bits(costs, first):
                print(f"FAIL: the episode of {label}: {variants[i][0]} costs differ from "
                      f"{variants[0][0]}")
                return 1
        times = [[] for _ in variants]
        for i in order:
            load(i)
            times[i] += [s * 1e3 for s in cs.episode_seconds(run, reps, warmup=False)]
        for (vlabel, _, _), t in zip(variants, times):
            q1, med, q3 = statistics.quantiles(t, n=4)
            print(f"[{smi}] episode of {label}, {vlabel} source: median "
                  f"{statistics.median(t):.3f} ms (quartiles {q1:.3f}-{q3:.3f}, n={len(t)})",
                  flush=True)
        episodes.append({"episode": label, "variants": [
            {"variant": v[0], "episode_ms": t} for v, t in zip(variants, times)]})
    load(0)
    print(f"outputs identical across the {len(variants)} variants in every case", flush=True)
    print(json.dumps({"device": smi, "source": args.source, "readings": readings,
                      "episodes": episodes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
