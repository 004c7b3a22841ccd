"""Linearize + Gauss-Newton-quadratize every trajectory point in one launch.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/fused_derivs.py:
fused_derivs``. On CUDA tensors ``fused_derivs`` launches the hand-written
kernel in ``csrc/fused_derivs.cu`` (one thread per (scenario, t) point
pushing all S+1 basis tangents through the model's device functions at once
as a multi-tangent dual number, the outputs staged in shared memory and
written in contiguous runs); on CPU tensors it runs
``fused_derivs_reference``, the plain
PyTorch version: ``linearize_dynamics`` plus the stage terms of
``quadratize_cost(gauss_newton=True)`` over the (B·T) points.
``fused_derivs.launches`` counts kernel launches.

Per point: A, Bd = ∂f/∂x, ∂f/∂u, c = f(x, u) − A x − Bd u, and the
closed-form Gauss-Newton terms grad = 2 Jᵀ W_sym (z − g), H = 2 Jᵀ W_sym J of
the stage cost (J the transform Jacobian), split into q, r, Q, R, M. The
terminal expansion is one point per scenario and stays outside
(``ops/linearize.py:gn_terminal_terms``).

Scope as in the reference: action_size == 1, ``quad_cost`` costs, and a
goal trajectory shared by the batch (the same gate as the fused line
search).
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..models.base import Model
from .fused_linesearch import linesearch_applicable
from .linearize import gn_point_terms, linearize_dynamics


def _check_shapes(model, xs, us, g_z):
    B, T, _ = us.shape
    S = model.state_size
    want = {"xs": (B, T + 1, S), "us": (B, T, 1), "g_z": (T, model.goal_size)}
    got = {"xs": xs, "us": us, "g_z": g_z}
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"fused_derivs: {key} has shape {tuple(got[key].shape)}, "
                             f"expected {shape}")
    return B, T, S


def fused_derivs_reference(model: Model, xs, us, g_z):
    """Plain version: reverse-mode Jacobians over the flattened points."""
    S = model.state_size
    x_pts = xs[:, :-1]
    dyn = linearize_dynamics(model, x_pts, us)
    g, H = gn_point_terms(model, x_pts, us, g_z)
    return (dyn.A, dyn.B, dyn.c, H[..., :S, :S], H[..., S:, S:], H[..., S:, :S],
            g[..., :S], g[..., S:])


def fused_derivs(model: Model, xs, us, g_z):
    """xs (B, T+1, S) (xs[:, :T] used), us (B, T, 1), g_z (T, Z) ->
    (A (B,T,S,S), Bd (B,T,S,1), c (B,T,S), Q (B,T,S,S), R (B,T,1,1),
    M (B,T,1,S), q (B,T,S), r (B,T,1)), the shapes of ``linearize_dynamics``
    and ``quadratize_cost``. The kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if not linesearch_applicable(model):
        raise NotImplementedError(
            "fused_derivs supports action_size == 1 with quad_cost costs")
    B, T, S = _check_shapes(model, xs, us, g_z)
    if xs.device.type == "cpu":
        return fused_derivs_reference(model, xs, us, g_z)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    mid = _build.model_id(model)
    w_sym = _build.sym_weights(model.state_cost)
    dev = xs.device
    _build.check_cuda_args("fused_derivs", dev, xs=xs, us=us, g_z=g_z)
    out = _outputs(B, T, S, dev)
    if B * T > 0:
        rc = _build.kernel_fn("fused_derivs_launch")(
            mid, xs.data_ptr(), us.data_ptr(), g_z.data_ptr(), *(t.data_ptr() for t in out),
            B, T, w_sym, _build.stream_ptr(dev))
        _build.check_rc("fused_derivs", rc)
        fused_derivs.launches += 1
    return out


def _outputs(B: int, T: int, S: int, dev):
    """The eight outputs as contiguous views of one buffer, in the kernel's
    order (it writes a range 16 bytes a lane where the range starts on 16
    bytes, as every range does when B·T is a multiple of 4)."""
    tails = ((S, S), (S, 1), (S,), (S, S), (1, 1), (1, S), (S,), (1,))
    sizes = [B * T * math.prod(tail) for tail in tails]
    parts = torch.empty(sum(sizes), dtype=torch.float32, device=dev).split(sizes)
    return tuple(p.view((B, T) + tail) for p, tail in zip(parts, tails))


fused_derivs.launches = 0
