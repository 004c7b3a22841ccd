"""Fused rollout + cost: N independent horizon-T rollouts in one launch.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/fused.py:
fused_rollout_costs_tm``, the hot path of the two-stage MPPI tier. On a CUDA
tensor ``fused_rollout_costs_tm`` launches the hand-written kernel in
``csrc/fused_rollout.cu`` (one thread per rollout, state in registers, the
stage cost compiled for the model's own weights; ``launch_config`` reports
the launch shape); on a CPU tensor it runs
``fused_rollout_costs_tm_reference``, the plain PyTorch version of the same
function. ``fused_rollout_costs_tm.launches`` counts kernel launches.

Scope as in the reference: single-input models (action_size == 1) with a
``quad_cost`` stage cost, and on the card only models that have a device
function in ``csrc/models.cuh``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..models.base import Model
from .rollout import rollout_cost


def launch_config(model: Model, N: int) -> dict:
    """The kernel's launch shape for N rollouts on the current card: threads
    (rollouts) per block, blocks, registers per thread, resident blocks per
    SM."""
    out = (ctypes.c_int * 4)()
    _build.check_rc("launch_config", _build.kernel_fn("fused_rollout_launch_config")(
        _build.model_id(model), N, ctypes.cast(out, ctypes.c_void_p)))
    return dict(zip(("threads", "blocks", "registers", "blocks_per_sm"), out))


def fused_rollout_costs_tm_reference(model: Model, x0_tm, us_tm, g_z):
    """Plain version: x0_tm (S, N), us_tm (T, N), g_z (T, Z) -> (N,) summed
    clipped stage costs, by ``rollout_cost`` on the batch-major layout."""
    return rollout_cost(model, x0_tm.T, us_tm.T[..., None], g_z)[0]


def fused_rollout_costs_tm(model: Model, x0_tm, us_tm, g_z):
    """Time-major summed rollout costs: x0_tm (S, N), us_tm (T, N), g_z (T, Z)
    -> (N,). The kernel on CUDA tensors, the plain version on CPU tensors."""
    if model.action_size != 1:
        raise NotImplementedError("fused rollout supports action_size == 1")
    S, N = x0_tm.shape
    T = us_tm.shape[0]
    if us_tm.shape != (T, N) or g_z.shape != (T, model.goal_size) or S != model.state_size:
        raise ValueError(
            f"shapes x0_tm {tuple(x0_tm.shape)}, us_tm {tuple(us_tm.shape)}, "
            f"g_z {tuple(g_z.shape)} do not fit model {model.name!r}")
    if x0_tm.device.type == "cpu":
        return fused_rollout_costs_tm_reference(model, x0_tm, us_tm, g_z)
    if x0_tm.device.type != "cuda":
        raise ValueError(f"unsupported device {x0_tm.device}")
    mid = _build.model_id(model)
    w = _build.quad_weights(model.state_cost)
    dev = x0_tm.device
    _build.check_cuda_args("fused_rollout_costs_tm", dev, x0_tm=x0_tm, us_tm=us_tm, g_z=g_z)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    rc = _build.kernel_fn("fused_rollout_costs_launch")(
        mid, _build.ptr(x0_tm), _build.ptr(us_tm), _build.ptr(g_z), _build.ptr(out),
        T, N, w, _build.stream_ptr(dev))
    _build.check_rc("fused_rollout_costs_tm", rc)
    fused_rollout_costs_tm.launches += 1
    return out


fused_rollout_costs_tm.launches = 0
