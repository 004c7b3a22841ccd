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

import torch

from .models import REGISTRY

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_mppi.cu", "fused_rollout.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

# The registered models that have a device functor in csrc/models.cuh; the
# index is the case of its BMPC_DISPATCH_MODEL switch, and MAX_Z its kMaxZ
# (the largest feature size a functor has). Edit the two files together.
DEVICE_MODELS = ("pendulum", "cartpole_swingup", "acrobot")
MAX_Z = 5

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
        lib = ctypes.CDLL(str(path))
        _LIBS[source] = lib
    return lib


# --- launch helpers ------------------------------------------------------------

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_W = ctypes.POINTER(ctypes.c_float)  # host array of cost weights
# C entry point -> (source, argument types); pointers and the stream as void*
SIGNATURES = {
    "fused_mppi_step_launch": (
        "fused_mppi.cu",
        [_I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _U, _I, _I, _W, _P]),
    "fused_rollout_costs_launch": (
        "fused_rollout.cu", [_I, _P, _P, _P, _P, _I, _I, _W, _P]),
}


def kernel_fn(name: str):
    """The ctypes function of a C entry point, typed; it returns cudaError."""
    source, argtypes = SIGNATURES[name]
    fn = getattr(load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def model_id(model) -> int:
    """Index of the model's CUDA device functor. The functors hard-code the
    registered models' physics, so only those very Model instances have
    one; any other model (a non-scalar action, no functor yet, or a model
    that reuses a registered name with other functions) raises."""
    for i, name in enumerate(DEVICE_MODELS):
        if model is REGISTRY[name]:
            return i
    raise NotImplementedError(f"no CUDA device function for model {model.name!r}")


def quad_weights(model):
    """The stage cost's nonzero (i, j, w) terms as the dense upper-triangle
    (MAX_Z*MAX_Z,) float array the kernels take (zeros are skipped there)."""
    nz = getattr(model.state_cost, "nz", None)
    if nz is None:
        raise NotImplementedError(f"model {model.name!r} has no quad_cost stage cost")
    w = (ctypes.c_float * (MAX_Z * MAX_Z))()
    for i, j, v in nz:
        w[i * MAX_Z + j] = v
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
