"""The roofline kernels: the rate of an operation applied in a chain, and the
rate of the kernels' own noise stream.

Counterpart of the two Pallas kernels of ``scripts/roofline.py``:

- ``roofline_op`` (kernel 9, ``measure_pallas_op``, kernel body ``:88-94``):
  every element of x has the operation ``op`` applied ``inner`` times in a
  row; returns the last values. ``op`` is one of ``OPS``, the reference
  script's rows: ``fma`` x·1.000001 + 1e-7, ``cos``, ``sin``, ``log``
  log(|x| + 1), ``div`` 0.731 / (x + 1), ``exp`` exp(−|x|).
- ``roofline_noise`` (kernel 10, ``measure_pallas_noise``, kernel body
  ``:133-146``): program g of ``programs`` sums ``inner`` (8, 512) tiles of
  standard normals. The TPU kernel draws them from the core's hardware
  generator (``prng_seed``), which has no lowering off the TPU; here
  program g, iteration i, element (s, l) draws the stream kernels 1 and 3
  consume, ``ops/fused_mppi.py:interp_normals(seed + g, i, 512)[s, l]``.
  ``paired`` adds both halves of each Box–Muller draw, r·cos and r·sin of
  the same two hashed uniforms (the reference's ``_std_normal_pair``).

On CUDA tensors each launches its hand-written kernel in
``csrc/roofline.cu``; on CPU tensors it runs its plain PyTorch version
(``*_reference``), which sums in the kernel's order. ``launch_config``
reports a kernel's launch shape. ``roofline_op.launches`` and
``roofline_noise.launches`` count kernel launches, and
``roofline_op.by_op`` / ``roofline_noise.by_form`` the same launches by
instantiation.

``draw_domain`` (a check; no TPU counterpart) gives the noise draw's radius,
cosine and sine at every one of the 2^24 values a 24-bit uniform takes,
through libm and through the reduced forms that kernels 1, 3 and 10 draw
through (``csrc/models.cuh``), so that the two can be compared bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .fused_mppi import _MASK, _TWO_PI_F32, SUBLANES, _hash, _normals, _u01

LANES = 512
TILE = SUBLANES * LANES
# kernel 9's operations, in the order of csrc/roofline.cu's dispatch
OPS = ("fma", "cos", "sin", "log", "div", "exp")


def _apply(op: str, x):
    if op == "fma":
        return x * 1.000001 + 1e-7
    if op == "cos":
        return torch.cos(x)
    if op == "sin":
        return torch.sin(x)
    if op == "log":
        return torch.log(torch.abs(x) + 1.0)
    if op == "div":
        # a true division: PyTorch computes `scalar / tensor` as a product
        # with the reciprocal, the kernel (and the reference) divide
        return x.new_tensor(0.731) / (x + 1.0)
    if op == "exp":
        return torch.exp(-torch.abs(x))
    raise ValueError(f"unknown op {op!r}; expected one of {OPS}")


def roofline_op_reference(op: str, x, inner: int):
    """Plain version: ``op`` applied ``inner`` times to every element."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    for _ in range(inner):
        x = _apply(op, x)
    return x.clone() if inner == 0 else x


def roofline_op(op: str, x, inner: int):
    """x (any shape, float32) with ``op`` applied ``inner`` times to every
    element: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if inner < 0:
        raise ValueError(f"inner must be >= 0, got {inner}")
    if x.device.type == "cpu":
        return roofline_op_reference(op, x, inner)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _build.check_cuda_args("roofline_op", x.device, x=x)
    out = torch.empty_like(x)
    rc = _build.kernel_fn("roofline_op_launch")(
        OPS.index(op), _build.ptr(x), _build.ptr(out), x.numel(), inner,
        _build.stream_ptr(x.device))
    _build.check_rc("roofline_op", rc)
    roofline_op.launches += 1
    roofline_op.by_op[op] += 1
    return out


roofline_op.launches = 0
roofline_op.by_op = dict.fromkeys(OPS, 0)


def _check_seed(seed) -> None:
    if not torch.is_tensor(seed) or seed.dtype != torch.int32 or seed.shape != (1,):
        raise TypeError("roofline_noise: seed must be a (1,) int32 tensor")


def roofline_noise_reference(seed, programs: int, inner: int, paired: bool = False):
    """Plain version: (programs, 8, 512) float32, program g's sum over i <
    ``inner`` of the normals of ``interp_normals(seed + g, i, 512)``, and
    with ``paired`` the sine half of each draw after its cosine half, in the
    kernel's order."""
    _check_seed(seed)
    dev = seed.device
    g = torch.arange(programs, dtype=torch.int64, device=dev)[:, None, None]
    seed_c = (seed.to(torch.int64) + g) & _MASK  # (programs, 1, 1)
    idx = torch.arange(TILE, dtype=torch.int64, device=dev).reshape(SUBLANES, LANES)
    acc = torch.zeros((programs, SUBLANES, LANES), dtype=torch.float32, device=dev)
    for i in range(inner):
        if not paired:
            acc = acc + _normals(seed_c, i, idx, idx + TILE)
            continue
        u1 = _u01(_hash(seed_c, i, idx)) + 1e-7
        u2 = _u01(_hash(seed_c, i, idx + TILE))
        r = torch.sqrt(-2.0 * torch.log(u1))
        ang = _TWO_PI_F32 * u2
        acc = acc + r * torch.cos(ang)
        acc = acc + r * torch.sin(ang)
    return acc


def roofline_noise(seed, programs: int, inner: int, paired: bool = False):
    """Kernel 10: (programs, 8, 512) float32 sums of ``inner`` tiles of
    normals a program, seeded by ``seed``, a (1,) int32 tensor whose device
    decides: the kernel on the card (which reads the seed there), the plain
    version on the CPU. The TPU kernel writes one (8, 512) tile that every
    program overwrites, so it returns the last program's sum; here each
    program keeps its own, so that no program's work is dead."""
    _check_seed(seed)
    if programs < 0 or inner < 0:
        raise ValueError(f"programs and inner must be >= 0, got {programs}, {inner}")
    if seed.device.type == "cpu":
        return roofline_noise_reference(seed, programs, inner, paired)
    if seed.device.type != "cuda":
        raise ValueError(f"unsupported device {seed.device}")
    if not seed.is_contiguous():
        raise ValueError("roofline_noise: seed must be contiguous")
    out = torch.empty((programs, SUBLANES, LANES), dtype=torch.float32, device=seed.device)
    rc = _build.kernel_fn("roofline_noise_launch")(
        int(paired), _build.ptr(seed), _build.ptr(out), programs, inner,
        _build.stream_ptr(seed.device))
    _build.check_rc("roofline_noise", rc)
    roofline_noise.launches += 1
    roofline_noise.by_form["paired" if paired else "single"] += 1
    return out


roofline_noise.launches = 0
roofline_noise.by_form = {"single": 0, "paired": 0}


# the rows of draw_domain, in csrc/roofline.cu:roofline_draw_domain's order
DOMAIN_ROWS = ("radius_libm", "radius", "cos_libm", "cos", "sincos_sin_libm", "sincos_sin",
               "sincos_cos_libm", "sincos_cos")
DOMAIN = 1 << 24


def draw_domain_reference(device=None):
    """Plain version: (8, 2^24) float32, the radius sqrt(-2 log(u1)) of
    u1 = k·2^-24 + 1e-7, cos(2π·k·2^-24) and sin and cos of that angle, for
    every k < 2^24, in ``DOMAIN_ROWS``' order; PyTorch has one form of each,
    so a row and its libm row are the same tensor's values."""
    k = torch.arange(DOMAIN, dtype=torch.int64, device=device)
    u = k.to(torch.float32) * (1.0 / DOMAIN)
    r = torch.sqrt(-2.0 * torch.log(u + 1e-7))
    a = _TWO_PI_F32 * u
    c, s = torch.cos(a), torch.sin(a)
    return torch.stack([r, r, c, c, s, s, c, c])


def draw_domain(device):
    """``draw_domain_reference``'s rows on ``device``: on the card the check
    kernel, each libm row beside its reduced row; on the CPU the plain
    version."""
    device = torch.device(device)
    if device.type == "cpu":
        return draw_domain_reference(device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((len(DOMAIN_ROWS), DOMAIN), dtype=torch.float32, device=device)
    _build.check_rc("draw_domain", _build.kernel_fn("roofline_draw_domain_launch")(
        _build.ptr(out), _build.stream_ptr(device)))
    draw_domain.launches += 1
    return out


draw_domain.launches = 0


def launch_config(what: str, n: int) -> dict:
    """A kernel's launch shape over n elements on the current card: threads
    per block, blocks, registers per thread, resident blocks per SM,
    elements a thread, and what one trip of its loop does: applications of
    the op to each of a thread's elements (kernel 9) or normals drawn
    (kernel 10). ``what`` is an op of ``OPS`` (kernel 9), ``"noise"`` or
    ``"noise_paired"`` (kernel 10)."""
    paired = {"noise": 0, "noise_paired": 1}.get(what, -1)
    if paired < 0 and what not in OPS:
        raise ValueError(f"unknown kernel {what!r}")
    out = (ctypes.c_int * 6)()
    _build.check_rc("launch_config", _build.kernel_fn("roofline_launch_config")(
        OPS.index(what) if paired < 0 else 0, paired, n, ctypes.cast(out, ctypes.c_void_p)))
    return dict(zip(("threads", "blocks", "registers", "blocks_per_sm", "elements", "unroll"),
                    out))
