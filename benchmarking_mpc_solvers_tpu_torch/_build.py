"""Build, load and launch helpers for the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers, so
a build takes seconds. Libraries are built at first use from the package's
own sources into ``build/`` beside them (git-ignored), named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the cached library. ``build_all`` starts one ``nvcc`` per source at
once.

The flags keep IEEE float semantics: no ``--use_fast_math`` (the noise
stream's ``logf``/``cosf`` and the models' ``sinf``/``cosf`` must be the
accurate versions) and ``--fmad=false`` (no contraction of a*b+c into one
rounding), so a kernel rounds as the plain PyTorch version does, one
operation at a time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .models import acrobot, cartpole, pendulum, synthetic

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_mppi.cu", "fused_rollout.cu", "fused_cem.cu", "riccati_backward.cu",
           "fused_linesearch.cu", "fused_derivs.cu", "admm_iterate.cu", "i2c_smooth.cu",
           "roofline.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

# The device functors of csrc/models.cuh, by the case of BMPC_DISPATCH_MODEL:
# the three plants (ids 0 to 2, in DEVICE_MODELS' order), then the dummy
# family (make_dummy_model(S, 1)) at S in DUMMY_STATES (id dummy_id(S)).
# MAX_Z is its kMaxZ, the largest feature size a functor has: the dummy's
# S + 1 at S = 8, the Riccati kernel's largest state. Edit the two files
# together. Kernels 1, 2 and 3 also take the dummy at any larger S, in a
# form of their own whose S and weights are arguments (dummy_size,
# dummy_terms).
DEVICE_MODELS = ("pendulum", "cartpole_swingup", "acrobot")
DUMMY_STATES = tuple(range(1, 9))
MAX_Z = 9


def dummy_id(S: int) -> int:
    """The functor id of ``Dummy<S>``."""
    return len(DEVICE_MODELS) + DUMMY_STATES.index(S)


# A plant's functor by its physics: (dynamics, transform) -> (index, state
# size), so that a dataclasses.replace of a plant with other costs or bounds
# keeps it
_PLANTS = {(m.dynamics, m.transform): (DEVICE_MODELS.index(m.name), m.state_size)
           for m in (pendulum.PendulumModel, cartpole.CartPoleSwingUpModel,
                     acrobot.AcrobotModel)}

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(source: str) -> Path:
    """Library path keyed by the flags, the source and every shared header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(ptxas_verbose: bool = False) -> dict:
    """Compile every source whose library is missing, all in parallel.

    Returns {source: (library path, compiler output)}; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    procs, done = {}, {}
    for src in SOURCES:
        target = _target(src)
        if target.exists() and not ptxas_verbose:
            done[src] = (target, "")
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (target, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, target)
        done[src] = (target, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return done


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one ``csrc`` source, built on first use."""
    lib = _LIBS.get(source)
    if lib is None:
        path, _ = build_all()[source]
        lib = typed(ctypes.CDLL(str(path)), source)
        _LIBS[source] = lib
    return lib


# --- launch helpers ------------------------------------------------------------

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_L = ctypes.c_longlong
_W = ctypes.POINTER(ctypes.c_float)  # host array of cost weights
# C entry point -> (source, argument types); pointers and the stream as void*
SIGNATURES = {
    "fused_mppi_step_launch": (
        "fused_mppi.cu",
        [_I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _U, _I, _I, _W, _P]),
    "fused_mppi_launch_config": ("fused_mppi.cu", [_I, _I, _I, _I, _W, _P]),
    "fused_rollout_costs_launch": (
        "fused_rollout.cu", [_I, _P, _P, _P, _P, _I, _I, _W, _P]),
    "fused_rollout_launch_config": ("fused_rollout.cu", [_I, _I, _W, _P]),
    "fused_cem_step_launch": (
        "fused_cem.cu",
        [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _U, _I, _I, _W, _P]),
    "fused_cem_launch_config": ("fused_cem.cu", [_I, _I, _I, _I, _W, _P]),
    "riccati_backward_batch_launch": (
        "riccati_backward.cu", [_P] * 12 + [_I, _I, _I, _I, _P]),
    "fused_linesearch_launch": (
        "fused_linesearch.cu",
        [_I] + [_P] * 10 + [_I, _I, _I, _F, _F, _I, _W, _W, _P]),
    "fused_linesearch_launch_config": ("fused_linesearch.cu", [_I, _I, _I, _W, _P]),
    "fused_derivs_launch": (
        "fused_derivs.cu", [_I] + [_P] * 11 + [_I, _I, _W, _P]),
    "admm_launch": (
        "admm_iterate.cu", [_I, _I] + [_P] * 7 + [_I] * 4 + [_F, _F, _F] + [_I] * 4 + [_P]),
    "admm_launch_config": ("admm_iterate.cu", [_I, _I, _I, _I, _P]),
    "fused_mppi_dummy_launch": (
        "fused_mppi.cu",
        [_I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _U, _I, _I, _P, _I, _I, _P]),
    "fused_mppi_dummy_launch_config": ("fused_mppi.cu", [_I] * 6 + [_P]),
    "fused_rollout_dummy_launch": (
        "fused_rollout.cu", [_I, _P, _P, _P, _P, _I, _I, _P, _I, _P]),
    "fused_rollout_dummy_rows_launch": (
        "fused_rollout.cu", [_I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P]),
    "fused_rollout_dummy_launch_config": ("fused_rollout.cu", [_I] * 5 + [_P]),
    "scenario_normals_launch": ("fused_rollout.cu", [_P, _P, _P, _I, _I, _I, _F, _P]),
    "scenario_normals_launch_config": ("fused_rollout.cu", [_I, _P]),
    "fused_cem_dummy_launch": (
        "fused_cem.cu",
        [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _U, _I, _I, _P, _I, _I,
         _P]),
    "fused_cem_dummy_launch_config": ("fused_cem.cu", [_I] * 6 + [_P]),
    "i2c_filter_launch": ("i2c_smooth.cu", [_P] * 13 + [_I] * 5 + [_P]),
    "i2c_rts_launch": ("i2c_smooth.cu", [_P] * 6 + [_I] * 3 + [_P]),
    "i2c_launch_config": ("i2c_smooth.cu", [_I, _I, _I, _P]),
    "i2c_filter_general_launch": ("i2c_smooth.cu", [_P] * 13 + [_I] * 5 + [_P, _P]),
    "i2c_rts_general_launch": ("i2c_smooth.cu", [_P] * 6 + [_I] * 3 + [_P, _P]),
    "i2c_general_launch_config": ("i2c_smooth.cu", [_I, _I, _I, _P]),
    "roofline_op_launch": ("roofline.cu", [_I, _P, _P, _L, _I, _P]),
    "roofline_noise_launch": ("roofline.cu", [_I, _P, _P, _I, _I, _P]),
    "roofline_launch_config": ("roofline.cu", [_I, _I, _L, _P]),
    "roofline_draw_domain_launch": ("roofline.cu", [_P, _P]),
}


def typed(lib: ctypes.CDLL, source: str) -> ctypes.CDLL:
    """Gives a library built from ``source`` the C types of its entry points
    (those it has) and returns it."""
    for name, (src, argtypes) in SIGNATURES.items():
        if src == source and hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def kernel_fn(name: str):
    """The ctypes function of a C entry point, typed; it returns cudaError."""
    return getattr(load(SIGNATURES[name][0]), name)


WAY_ROUND = ("run it on the plain stages: use_fused=False (solve_batch, and "
             "run_episodes_batch for MPPI and CEM, whose use_kernel=False tier still calls "
             "the rollout kernel) or pallas_backward=False (iLQR, SQP)")


def dummy_size(model) -> int | None:
    """S of a ``make_dummy_model(S, 1)`` past ``DUMMY_STATES``, which kernels
    1, 2 and 3 take in their dummy form (S and the weights as arguments;
    ``csrc/models.cuh``: dummy_cost); None for every other model."""
    if ((model.dynamics, model.transform) == (synthetic.dummy_dynamics, synthetic.features)
            and model.action_size == 1 and model.state_size > DUMMY_STATES[-1]):
        return model.state_size
    return None


def dummy_terms(cost, device) -> tuple:
    """A ``quad_cost``'s nonzero (i, j, w) terms, in its order, as the
    (n, 4) int32 device array of the kernels' dummy form (i, j, the bits of
    the float32 w, 0), and ``n_lead``: the length of the leading run of
    terms that leave out the action (the last feature), which kernels 1 and
    3 sum once per scenario and step (``csrc/models.cuh``: dummy_lead).
    Built once per cost and device and kept on the cost."""
    cache = getattr(cost, "terms_dev", None)
    if cache is None:
        nz = getattr(cost, "nz", None)
        if nz is None:
            raise NotImplementedError("the kernels need a quad_cost cost")
        action = np.asarray(cost.W).shape[0] - 1
        cache = cost.terms_dev = {
            "host": torch.tensor([(i, j, int(np.float32(w).view(np.int32)), 0)
                                  for i, j, w in nz], dtype=torch.int32).reshape(-1, 4),
            "n_lead": next((e for e, (_, j, _) in enumerate(nz) if j == action), len(nz))}
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = cache["host"].to(device)
    return cache[key], cache["n_lead"]


# The forms of the dummy form of kernels 1 and 3 (csrc/models.cuh: DummyTail),
# by their index: the leading run summed once per scenario and step and one
# action term added at each step; the whole list at each step
DUMMY_TAIL_FORMS = ("one term", "whole list")


def model_id(model) -> int:
    """Index of the model's CUDA device functor, found by its physics: the
    pair (``model.dynamics``, ``model.transform``). A plant's module-level
    functions map to its functor whatever its costs and bounds (the kernels
    take the weights and bounds as arguments); the dummy family's shared
    functions map to ``Dummy<S>`` for a scalar action and 1 ≤ S ≤ 8 (kernels
    1, 2 and 3 take larger S in their dummy form: ``dummy_size``). Any other
    model raises ``NotImplementedError`` naming it and why: the linear model
    (its dynamics contract the state axis, which the reference's kernels
    cannot trace either), a model that reuses a plant's name with other
    functions, a dummy with a larger action, and (for the kernels that need
    a functor, 4 and 6) a dummy with S > 8."""
    key = (model.dynamics, model.transform)
    if key in _PLANTS:
        index, S = _PLANTS[key]
        if model.state_size == S and model.action_size == 1:
            return index
        why = (f"state size {model.state_size} and action size {model.action_size} are not "
               f"the plant's")
    elif key == (synthetic.dummy_dynamics, synthetic.features):
        S = model.state_size
        if model.action_size == 1 and S in DUMMY_STATES:
            return dummy_id(S)
        why = (f"the dummy's functor takes state sizes {DUMMY_STATES[0]} to {DUMMY_STATES[-1]} "
               f"and a scalar action (kernels 1, 2 and 3 take any S with a scalar action), "
               f"got S={S}, A={model.action_size}")
    elif model.transform is synthetic.features:
        why = ("its dynamics are not the dummy's identity (a make_linear_model contracts the "
               "state axis, which the reference's kernels do not trace either: they call "
               "dynamics on lane tiles)")
    else:
        why = "its dynamics and transform are not a plant's or the dummy's"
    raise NotImplementedError(
        f"no CUDA device function for model {model.name!r}: {why}; {WAY_ROUND}")


def quad_weights(cost):
    """A ``quad_cost``'s nonzero (i, j, w) terms (a model's stage or
    terminal cost) as the dense upper-triangle (MAX_Z*MAX_Z,) float array
    the kernels take (zeros are skipped there), built once per cost and
    layout and kept on it beside ``W`` and ``nz``."""
    w = getattr(cost, "w_quad", None)
    if w is not None and len(w) == MAX_Z * MAX_Z:
        return w
    nz = getattr(cost, "nz", None)
    if nz is None:
        raise NotImplementedError("the kernels need a quad_cost cost")
    w = (ctypes.c_float * (MAX_Z * MAX_Z))()
    for i, j, v in nz:
        w[i * MAX_Z + j] = v
    cost.w_quad = w
    return w


def sym_weights(cost):
    """A ``quad_cost``'s dense symmetrised weights 0.5·(W + Wᵀ) as the
    (MAX_Z*MAX_Z,) float array ``fused_derivs`` takes (row stride MAX_Z),
    built once per cost and layout and kept on it beside ``W`` and ``nz``."""
    w = getattr(cost, "w_sym", None)
    if w is not None and len(w) == MAX_Z * MAX_Z:
        return w
    W = getattr(cost, "W", None)
    if W is None:
        raise NotImplementedError("the kernels need a quad_cost cost")
    Wsym = 0.5 * (W + W.T)
    w = (ctypes.c_float * (MAX_Z * MAX_Z))()
    for i in range(Wsym.shape[0]):
        for j in range(Wsym.shape[1]):
            w[i * MAX_Z + j] = float(Wsym[i, j])
    cost.w_sym = w
    return w


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda_args(name: str, device, **tensors) -> None:
    """Every tensor float32, contiguous and on ``device``."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
