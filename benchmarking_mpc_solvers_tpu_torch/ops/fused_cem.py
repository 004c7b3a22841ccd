"""Single-kernel CEM step: noise, K scored samples, elite selection and the
smoothed mean/std update, for all ``max_iter`` refinement iterations.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/fused_cem.py:
fused_cem_step``. On a CUDA tensor ``fused_cem_step`` launches the
hand-written kernel in ``csrc/fused_cem.cu`` (one warp per scenario, one
lane per sample, the stage cost compiled for the model's own weights; the
dummy family past S = 8 in the kernel's dummy form, S and the weights as
arguments, where one action term ends the weights' list the terms before
it summed once per scenario and step; ``launch_config`` reports the launch
shape of either form); on a CPU tensor it runs
``fused_cem_step_reference``, the plain PyTorch version.
``fused_cem_step.launches`` counts kernel launches.

Per iteration ``it`` (the reference kernel's semantics):
- sample k of scenario b at step t is ``clip(mean_t + std_t·δ, lo, hi)``,
  clipped before it is scored and before the statistics;
- δ is the reference's interpret-mode stream (``interp_normals``) under the
  combined seed ``seed + it·15485863 + k·7919 + pid·104729`` (uint32 wrap),
  scenario b in the slot of the padded (T, 8, Bp/8) tiling (``noise_layout``);
- costs are the summed clipped quadratic stage costs, non-finite -> 1e30;
- n_elite rounds of masked-min pick the elites (exclusion offset 4·T·1e30),
  every tied candidate is marked, and the weights are 1/count;
- Σw·u and Σw·u² are summed in k order; std = sqrt(max(m2 − m1², 0));
- mean and std are α-smoothed. std restarts at ``std0`` on every call and
  there is no ε exit. The returned plan is not clipped.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..models.base import Model
from .fused_mppi import _MASK, _normals, _round_up, _seeds, SUBLANES, noise_layout

IT_STRIDE = 15485863  # the iteration's term of the combined seed


def _smoothing(alpha: float):
    """(α, 1 − α) as the reference kernel rounds them: float32 α, and 1 − α
    taken in float32."""
    a = np.float32(alpha)
    return float(a), float(np.float32(1.0) - a)


def launch_config(model: Model, T: int, K: int, B: int) -> dict:
    """The kernel's launch shape at (T, K, B) on the current card: threads
    and scenarios per block, blocks, shared bytes per block, registers per
    thread, resident blocks per SM, and the stage cost's form
    (``generic_cost``: True where the model's weights are not its functor's
    compiled terms). For the dummy past S = 8, the dummy form's: in place of ``generic_cost``
    its form (``_build.DUMMY_TAIL_FORMS``), the leading run its prologue sums
    (``n_lead``; 0 in the whole list's form) and the terms each step adds
    (``tail``)."""
    S_dummy = _build.dummy_size(model)
    if S_dummy is not None:
        terms, n_lead = _build.dummy_terms(model.state_cost, "cuda")
        out = (ctypes.c_int * 9)()
        _build.check_rc("launch_config", _build.kernel_fn("fused_cem_dummy_launch_config")(
            S_dummy, T, K, B, terms.shape[0], n_lead, ctypes.cast(out, ctypes.c_void_p)))
        keys = ("threads", "scenarios_per_block", "blocks", "shared_bytes", "registers",
                "blocks_per_sm", "form", "n_lead", "tail")
        return {**dict(zip(keys, out)), "form": _build.DUMMY_TAIL_FORMS[out[6]]}
    out = (ctypes.c_int * 7)()
    _build.check_rc("launch_config", _build.kernel_fn("fused_cem_launch_config")(
        _build.model_id(model), T, K, B, _build.quad_weights(model.state_cost),
        ctypes.cast(out, ctypes.c_void_p)))
    keys = ("threads", "scenarios_per_block", "blocks", "shared_bytes", "registers",
            "blocks_per_sm", "generic_cost")
    return {**dict(zip(keys, out)), "generic_cost": bool(out[6])}


def fused_cem_step_reference(model: Model, K: int, n_elite: int, max_iter: int, alpha: float,
                             std0: float, lanes: int, planned_tm, x0_tm, gz, seed: int,
                             return_masks: bool = False):
    """Plain version: (K, B) rollouts vectorised, the horizon and the
    selection rounds as loops, the moments summed over k in order.
    ``return_masks`` also returns the (max_iter, K, B) elite masks."""
    T, B = planned_tm.shape
    dev = planned_tm.device
    lo, hi = float(model.bounds_low[0]), float(model.bounds_high[0])
    a, one_minus_a = _smoothing(alpha)
    excl = float(np.float32(4.0 * T * 1e30))
    pid, i1, i2 = noise_layout(B, lanes, dev)
    mean = planned_tm.clone()
    std = torch.full_like(mean, float(np.float32(std0)))
    masks = []
    for it in range(max_iter):
        seed_c = _seeds(int(seed) + it * IT_STRIDE, K, pid)  # (K, B), uint32 wrap
        x = x0_tm.T.expand(K, B, x0_tm.shape[0])
        acc = torch.zeros((K, B), dtype=torch.float32, device=dev)
        samples = []
        for t in range(T):
            u = torch.clamp(mean[t] + std[t] * _normals(seed_c, t, i1, i2), lo, hi)
            samples.append(u)
            c = model.state_cost(model.transform(x, u[..., None]), gz[t])
            x = model.dynamics(x, u[..., None])
            acc = acc + c
        costs = torch.where(torch.isfinite(acc), acc, torch.full_like(acc, 1e30))
        sel = torch.zeros_like(costs)
        for _ in range(n_elite):
            cur = costs + sel * excl
            is_new = (cur == cur.min(dim=0).values) & (sel < 0.5)
            sel = torch.where(is_new, torch.ones_like(sel), sel)
        w = sel / torch.clamp(sel.sum(dim=0), min=1.0)
        m1 = torch.zeros_like(mean)
        m2 = torch.zeros_like(mean)
        u = torch.stack(samples)  # (T, K, B)
        for kk in range(K):  # the reference's order: m += w_k * u_k
            m1 = m1 + w[kk] * u[:, kk]
            m2 = m2 + w[kk] * (u[:, kk] * u[:, kk])
        e_std = torch.sqrt(torch.clamp(m2 - m1 * m1, min=0.0))
        mean = a * mean + one_minus_a * m1
        std = a * std + one_minus_a * e_std
        masks.append(sel)
    if return_masks:
        return mean, torch.stack(masks)
    return mean


def fused_cem_step(model: Model, K: int, n_elite: int, max_iter: int, alpha: float,
                   std0: float, lanes: int, planned_tm, x0_tm, gz, seed: int,
                   return_masks: bool = False):
    """One full CEM refinement for B scenarios: planned_tm (T, B), x0_tm
    (S, B), gz (T, Z), int32 seed -> new (T, B) plan means (and, with
    ``return_masks``, the (max_iter, K, B) elite masks). The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if model.action_size != 1:
        raise NotImplementedError("fused CEM supports action_size == 1")
    T, B = planned_tm.shape
    S = model.state_size
    if x0_tm.shape != (S, B) or gz.shape != (T, model.goal_size):
        raise ValueError(
            f"shapes planned_tm {tuple(planned_tm.shape)}, x0_tm {tuple(x0_tm.shape)}, "
            f"gz {tuple(gz.shape)} do not fit model {model.name!r}")
    if not 0 < n_elite <= K:
        raise ValueError(f"n_elite {n_elite} must lie in [1, K={K}]")
    if planned_tm.device.type == "cpu":
        return fused_cem_step_reference(model, K, n_elite, max_iter, alpha, std0, lanes,
                                        planned_tm, x0_tm, gz, seed, return_masks)
    if planned_tm.device.type != "cuda":
        raise ValueError(f"unsupported device {planned_tm.device}")
    S_dummy = _build.dummy_size(model)
    mid = None if S_dummy is not None else _build.model_id(model)
    dev = planned_tm.device
    _build.check_cuda_args("fused_cem_step", dev, planned_tm=planned_tm, x0_tm=x0_tm, gz=gz)
    out = torch.empty_like(planned_tm)
    masks = (torch.empty((max_iter, K, B), dtype=torch.float32, device=dev)
             if return_masks else None)
    if B == 0 or T == 0:
        out.copy_(planned_tm)
        return (out, masks) if return_masks else out
    a, one_minus_a = _smoothing(alpha)
    C = _round_up(max(B, SUBLANES * lanes), SUBLANES * lanes) // SUBLANES
    args = (_build.ptr(planned_tm), _build.ptr(x0_tm), _build.ptr(gz), _build.ptr(out),
            _build.ptr(masks) if return_masks else None,
            T, B, K, n_elite, max_iter, a, one_minus_a, float(np.float32(std0)),
            float(model.bounds_low[0]), float(model.bounds_high[0]),
            int(seed) & _MASK, lanes, C)
    if S_dummy is None:
        rc = _build.kernel_fn("fused_cem_step_launch")(
            mid, *args, _build.quad_weights(model.state_cost), _build.stream_ptr(dev))
    else:
        terms, n_lead = _build.dummy_terms(model.state_cost, dev)
        rc = _build.kernel_fn("fused_cem_dummy_launch")(
            S_dummy, *args, _build.ptr(terms), terms.shape[0], n_lead, _build.stream_ptr(dev))
    _build.check_rc("fused_cem_step", rc)
    fused_cem_step.launches += 1
    return (out, masks) if return_masks else out


fused_cem_step.launches = 0
