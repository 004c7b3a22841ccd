"""Fixed-count ADMM for batched box-QPs in one launch: the QP-MPC hot loop.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/qp_pallas.py:
admm_iterate``. It solves B independent condensed box-QPs

    min_U  ½ Uᵀ H_b U + g_bᵀ U   s.t.  lo ≤ U ≤ hi      (n = T·A variables)

by OSQP-style ADMM with a precomputed inverse M = (H + ρI)⁻¹:

    u   = M (ρ(z − y) − g)
    u'  = α u + (1−α) z
    z⁺  = clip(u' + y, lo, hi)
    y⁺  = y + u' − z⁺

from z = y = 0 for a fixed ``iters`` (no early exit; the batch runs in
lock-step, matching ``qp.admm_solve`` with eps=0), and returns the last z,
which always lies in the box. Two layouts, chosen by ``Minv.ndim``:
**shared** (2-D Minv: linear MPC linearized at the goal, only g varies) and
**per-problem** (3-D Minv: one H per scenario).

On CUDA tensors ``admm_iterate`` launches the hand-written kernel in
``csrc/admm_iterate.cu``; on CPU tensors it runs ``admm_iterate_reference``,
the plain PyTorch loop with each row's sum taken over j in order, as every
form of the kernel sums it (so the two agree bit for bit on the card).
``admm_iterate.launches`` counts kernel launches.

The kernel comes in three forms; ``block_plan`` picks one, and its launch
shape, from (B, n, layout), for any n ≥ 1:

- **registers** (n ≤ 64): a warp per problem (two where n ≤ 16), lane i
  keeping row i of Minv in registers (and row i + 32 where n > 32), v
  passed between lanes through a per-warp shared vector; compiled for each
  row width that is a multiple of 4, n rounded up to one.
  Blocks of 4, 2 or 1 warps: the most that still give every SM a block.
- **shared** (64 < n ≤ 240): a block of n threads per problem, its Minv
  and a double-buffered v in shared memory, n² + 2n floats within the
  227 KB a block can have on the H100 (``SMEM_BUDGET_BYTES``). The
  streaming form is 2.3–16× slower at n = 120 and 240 (the readings are in
  the source), so this form runs as far as that budget allows.
- **streaming** (larger n): a block per problem, Minv read from device
  memory every iteration through a transposed copy the wrapper makes once;
  z, y and v in device memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

SMEM_BUDGET_BYTES = 232448  # shared memory one block can have on the H100 (227 KB)
MAX_THREADS = 1024
MAX_REGISTER_WIDTH = 64  # the register form's widest row (compiled for each multiple of 4)
H100_SMS = 132
FORMS = ("registers", "shared", "streaming")  # the C entry point's form codes, in order


class Plan(NamedTuple):
    """A launch of the kernel: its form, the register form's row width (0
    for the others), problems and threads a block, blocks, and dynamic
    shared bytes a block."""
    form: str
    width: int
    problems_per_block: int
    threads: int
    blocks: int
    smem: int


def _check_shapes(Minv, g, lo, hi):
    B, n = g.shape
    if Minv.ndim not in (2, 3) or tuple(Minv.shape) != ((n, n) if Minv.ndim == 2 else (B, n, n)):
        raise ValueError(f"admm_iterate: Minv has shape {tuple(Minv.shape)}, expected "
                         f"{(n, n)} or {(B, n, n)}")
    for key, t in (("lo", lo), ("hi", hi)):
        if tuple(t.shape) not in ((n,), (B, n)):
            raise ValueError(f"admm_iterate: {key} has shape {tuple(t.shape)}, expected "
                             f"{(n,)} or {(B, n)}")
    if lo.shape != hi.shape:
        raise ValueError("admm_iterate: lo and hi differ in shape")
    return B, n


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_plan(B: int, n: int, per_problem: bool, sms: int = H100_SMS) -> Plan:
    """The kernel's form and launch shape for B problems of n variables on a
    card of ``sms`` SMs (n ≥ 1, B ≥ 1)."""
    if n < 1 or B < 1:
        raise ValueError(f"admm_iterate: no plan for B = {B}, n = {n}")
    if n <= MAX_REGISTER_WIDTH:
        width = _cdiv(n, 4) * 4
        per_warp = 2 if width <= 16 else 1
        warps = _cdiv(B, per_warp)
        wpb = next((w for w in (4, 2) if _cdiv(warps, w) >= sms), 1)
        # a warp's double-buffered v (a slot a lane, two past width 32, and
        # one for the lanes without a row) and its staged matrices (one, or
        # two per problem up to width 16) at an odd row stride
        floats = (2 * (32 * (2 if width > 32 else 1) + 4)
                  + (per_warp if per_problem else 1) * n * (n | 1))
        return Plan("registers", width, wpb * per_warp, 32 * wpb, _cdiv(warps, wpb),
                    4 * wpb * floats)
    smem = 4 * (n * n + 2 * n)
    if smem <= SMEM_BUDGET_BYTES:
        return Plan("shared", 0, 1, n, B, smem)
    return streaming_plan(B, n)


def streaming_plan(B: int, n: int) -> Plan:
    """The streaming form's launch for B problems of n variables (any n):
    a block per problem, a thread per row up to 1,024."""
    return Plan("streaming", 0, 1, min(_cdiv(n, 32) * 32, MAX_THREADS), B, 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_config(B: int, n: int, per_problem: bool) -> dict:
    """The kernel's launch shape for B problems of n variables on the
    current card: the plan's fields, registers per thread and resident
    blocks per SM."""
    plan = block_plan(B, n, per_problem, _sm_count(torch.cuda.current_device()))
    out = (ctypes.c_int * 2)()
    _build.check_rc("launch_config", _build.kernel_fn("admm_launch_config")(
        FORMS.index(plan.form), plan.width, plan.threads, plan.smem,
        ctypes.cast(out, ctypes.c_void_p)))
    return dict(plan._asdict(), registers=out[0], blocks_per_sm=out[1])


def admm_iterate_reference(Minv, g, lo, hi, rho: float = 1.0, alpha: float = 1.6,
                           iters: int = 100):
    """Plain version: the iteration as a loop, the matvec as n column
    updates added in order from 0 (the kernel's summation order)."""
    n = g.shape[1]
    cols = [Minv[..., :, j] for j in range(n)]  # (n,) or (B, n): column j of each Minv
    z = torch.zeros_like(g)
    y = torch.zeros_like(g)
    for _ in range(iters):
        v = rho * (z - y) - g
        u = torch.zeros_like(g)
        for j in range(n):
            u = u + cols[j] * v[:, j:j + 1]
        u_rel = alpha * u + (1.0 - alpha) * z
        z_new = torch.clamp(u_rel + y, lo, hi)
        y = y + u_rel - z_new
        z = z_new
    return z


def admm_iterate(Minv, g, lo, hi, rho: float = 1.0, alpha: float = 1.6, iters: int = 100):
    """Minv (n, n) shared or (B, n, n) per problem, g (B, n), lo/hi (n,) or
    (B, n) -> z (B, n) after ``iters`` iterations. The kernel on CUDA
    tensors (any n, in the form ``block_plan`` picks), the plain version on
    CPU tensors."""
    B, n = _check_shapes(Minv, g, lo, hi)
    if g.device.type == "cpu":
        return admm_iterate_reference(Minv, g, lo, hi, rho, alpha, iters)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    _build.check_cuda_args("admm_iterate", g.device, Minv=Minv, g=g, lo=lo, hi=hi)
    if B * n == 0:
        return torch.empty((B, n), dtype=torch.float32, device=g.device)
    if iters <= 0:
        return torch.zeros((B, n), dtype=torch.float32, device=g.device)
    plan = block_plan(B, n, Minv.ndim == 3, _sm_count(g.device.index))
    return run_plan(plan, Minv, g, lo, hi, rho, alpha, iters)


def run_plan(plan: Plan, Minv, g, lo, hi, rho: float, alpha: float, iters: int):
    """Launch the kernel in ``plan``'s form and shape on ``admm_iterate``'s
    checked CUDA arguments (B, n ≥ 1, iters ≥ 1). ``admm_iterate`` passes
    ``block_plan``'s; any form that takes (B, n) gives the same bits, so
    ``kernel_ab.py`` times the streaming form against the others here."""
    B, n = g.shape
    dev = g.device
    z = torch.empty((B, n), dtype=torch.float32, device=dev)
    y = v = None
    if plan.form == "streaming":
        Minv = Minv.transpose(-1, -2).contiguous()  # column j of each Minv, contiguous
        y = torch.empty((B, n), dtype=torch.float32, device=dev)
        v = torch.empty((B, 2, n), dtype=torch.float32, device=dev)
    rc = _build.kernel_fn("admm_launch")(
        FORMS.index(plan.form), plan.width, _build.ptr(Minv), _build.ptr(g), _build.ptr(lo),
        _build.ptr(hi), _build.ptr(z), None if y is None else _build.ptr(y),
        None if v is None else _build.ptr(v), B, n, int(Minv.ndim == 3), int(lo.ndim == 2),
        float(rho), float(alpha), float(1.0 - alpha), int(iters),
        plan.threads, plan.blocks, plan.smem, _build.stream_ptr(dev))
    _build.check_rc("admm_iterate", rc)
    admm_iterate.launches += 1
    return z


admm_iterate.launches = 0
