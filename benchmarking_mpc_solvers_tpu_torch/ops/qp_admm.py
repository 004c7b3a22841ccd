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
``csrc/admm_iterate.cu`` (a block holds P problems, thread (p, i) owns row
i; Minv waits in shared memory, z and y in registers for all iterations);
on CPU tensors it runs ``admm_iterate_reference``, the plain PyTorch loop
with the matvec summed over j in order, as the kernel sums it.
``admm_iterate.launches`` counts kernel launches.

The size rule. The kernel keeps Minv in shared memory, of which a block on
the H100 can have ``SMEM_BUDGET_BYTES`` (227 KB): (n² + 2·P·n) floats in the
shared layout, P·(n² + 2n) per problem, and P·n ≤ 1024 threads. P starts
at ``TARGET_THREADS // n`` and is halved until the block fits. If one
problem does not fit (n above 240) the wrapper raises on CUDA tensors: a
kernel that tiles Minv through shared memory is ROADMAP.md §1 item 11a.
"""

from __future__ import annotations

import torch

from .. import _build

SMEM_BUDGET_BYTES = 232448  # shared memory one block can have on the H100 (227 KB)
MAX_THREADS = 1024
TARGET_THREADS = 128


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


def block_plan(B: int, n: int, per_problem: bool):
    """(problems per block P, dynamic shared-memory bytes) of the kernel
    for this size, or None when one problem's block exceeds the budget
    (``admm_iterate`` then raises on CUDA tensors)."""
    if n > MAX_THREADS:
        return None
    P = max(1, min(TARGET_THREADS // n, B))
    while True:
        floats = (P if per_problem else 1) * n * n + 2 * P * n
        if 4 * floats <= SMEM_BUDGET_BYTES and P * n <= MAX_THREADS:
            return P, 4 * floats
        if P == 1:
            return None
        P //= 2


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
    tensors (n up to the module's size rule), the plain version on CPU
    tensors."""
    B, n = _check_shapes(Minv, g, lo, hi)
    if g.device.type == "cpu":
        return admm_iterate_reference(Minv, g, lo, hi, rho, alpha, iters)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    dev = g.device
    _build.check_cuda_args("admm_iterate", dev, Minv=Minv, g=g, lo=lo, hi=hi)
    per_problem = Minv.ndim == 3
    plan = block_plan(B, n, per_problem)
    if plan is None:
        raise NotImplementedError(
            f"admm_iterate: one problem of n = {n} variables exceeds a block's shared "
            f"memory ({SMEM_BUDGET_BYTES} bytes); a tiled Minv is ROADMAP.md §1 item 11a")
    z = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B * n == 0:
        return z
    if iters <= 0:
        return z.zero_()
    P, smem = plan
    rc = _build.kernel_fn("admm_iterate_launch")(
        _build.ptr(Minv), _build.ptr(g), _build.ptr(lo), _build.ptr(hi), _build.ptr(z),
        B, n, P, int(per_problem), int(lo.ndim == 2), float(rho), float(alpha),
        float(1.0 - alpha), int(iters), smem, _build.stream_ptr(dev))
    _build.check_rc("admm_iterate", rc)
    admm_iterate.launches += 1
    return z


admm_iterate.launches = 0
