"""All line-search candidates of a batched iLQR/SQP iteration in one launch.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/fused_linesearch.py:
fused_linesearch``. On CUDA tensors ``fused_linesearch`` launches the
hand-written kernel in ``csrc/fused_linesearch.cu`` (two warps a block: a
lane of the chain warp per (α, scenario) candidate, and a producer warp
that stages the horizon's inputs in shared memory and writes the outputs;
``launch_config`` reports the launch shape); on CPU tensors it runs
``fused_linesearch_reference``, the plain PyTorch version with the
reference kernel's order of operations. ``fused_linesearch.launches``
counts kernel launches.

Each of the n_α·B candidates (α-major, candidate a·B + b) rolls from x0:
``u = clip(u_t + α·k_t + K_t(x − xref_t), lo, hi)`` (the feedback term
summed over i in order), adds the ±1e30-clipped stage cost over the
nonzero W entries, steps the dynamics, and with ``with_terminal`` adds the
clipped terminal cost at zero action against g_z[T-1]. The clipped
controls are returned, and with ``return_states`` the state trajectories.
Scope as in the reference: action_size == 1 and ``quad_cost`` costs.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..models.base import Model


def linesearch_applicable(model: Model) -> bool:
    """Gate of the solvers' dispatch to ``fused_linesearch``."""
    return (model.action_size == 1
            and hasattr(model.state_cost, "W")
            and hasattr(model.terminal_cost, "W"))


def _check_shapes(model, alphas, x0, us, ks, Ks, xref, g_z):
    B, T, _ = us.shape
    S = model.state_size
    want = {"alphas": (alphas.shape[0],), "x0": (B, S), "us": (B, T, 1), "ks": (B, T, 1),
            "Ks": (B, T, 1, S), "xref": (B, T + 1, S), "g_z": (T, model.goal_size)}
    got = {"alphas": alphas, "x0": x0, "us": us, "ks": ks, "Ks": Ks, "xref": xref, "g_z": g_z}
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"fused_linesearch: {key} has shape {tuple(got[key].shape)}, "
                             f"expected {shape}")
    return B, T, S


def launch_config(model: Model, n_a: int, B: int) -> dict:
    """The kernel's launch shape for n_a alphas and B scenarios on the
    current card: threads per block, scenarios and alphas per block, blocks,
    shared bytes per block, registers per thread, resident blocks per SM,
    and the stage cost's form (``generic_cost``: True where the model's
    weights are not its functor's compiled terms)."""
    out = (ctypes.c_int * 8)()
    _build.check_rc("launch_config", _build.kernel_fn("fused_linesearch_launch_config")(
        _build.model_id(model), n_a, B, _build.quad_weights(model.state_cost),
        ctypes.cast(out, ctypes.c_void_p)))
    keys = ("threads", "scenarios_per_block", "alphas_per_block", "blocks", "shared_bytes",
            "registers", "blocks_per_sm", "generic_cost")
    return {**dict(zip(keys, out)), "generic_cost": bool(out[7])}


def fused_linesearch_reference(model: Model, alphas, x0, us, ks, Ks, xref, g_z,
                               with_terminal: bool = False, return_states: bool = False):
    """Plain version: the (n_α, B) candidates vectorised, the horizon a loop."""
    n_a = alphas.shape[0]
    B, T, _ = us.shape
    S = model.state_size
    lo, hi = float(model.bounds_low[0]), float(model.bounds_high[0])
    x = x0.expand(n_a, B, S)
    acc = torch.zeros((n_a, B), dtype=torch.float32, device=x0.device)
    alpha = alphas[:, None]
    uss, xss = [], [x]
    for t in range(T):
        fb = torch.zeros((n_a, B), dtype=torch.float32, device=x0.device)
        for i in range(S):
            fb = fb + Ks[:, t, 0, i] * (x[..., i] - xref[:, t, i])
        u = torch.clamp(us[:, t, 0] + alpha * ks[:, t, 0] + fb, lo, hi)[..., None]
        acc = acc + model.state_cost(model.transform(x, u), g_z[t])
        x = model.dynamics(x, u)
        uss.append(u)
        xss.append(x)
    if with_terminal:
        acc = acc + model.final_cost(x, g_z[T - 1])
    us_hat = torch.stack(uss, dim=2)  # (n_a, B, T, 1)
    if return_states:
        return us_hat, torch.stack(xss, dim=2), acc
    return us_hat, acc


def fused_linesearch(model: Model, alphas, x0, us, ks, Ks, xref, g_z,
                     with_terminal: bool = False, return_states: bool = False):
    """alphas (n_α,), x0 (B, S), us/ks (B, T, 1), Ks (B, T, 1, S), xref
    (B, T+1, S) (xref[:, :T] used), g_z (T, Z) -> (us_hat (n_α, B, T, 1),
    costs (n_α, B)), or with ``return_states`` (us_hat, xs_hat
    (n_α, B, T+1, S), costs). The kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if not linesearch_applicable(model):
        raise NotImplementedError(
            "fused line search supports action_size == 1 with quad_cost costs")
    B, T, S = _check_shapes(model, alphas, x0, us, ks, Ks, xref, g_z)
    if x0.device.type == "cpu":
        return fused_linesearch_reference(model, alphas, x0, us, ks, Ks, xref, g_z,
                                          with_terminal, return_states)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    mid = _build.model_id(model)
    w = _build.quad_weights(model.state_cost)
    w_term = _build.quad_weights(model.terminal_cost)
    dev = x0.device
    _build.check_cuda_args("fused_linesearch", dev, alphas=alphas, x0=x0, us=us, ks=ks, Ks=Ks,
                           xref=xref, g_z=g_z)
    n_a = alphas.shape[0]
    us_hat = torch.empty((n_a, B, T, 1), dtype=torch.float32, device=dev)
    costs = torch.empty((n_a, B), dtype=torch.float32, device=dev)
    xs_hat = (torch.empty((n_a, B, T + 1, S), dtype=torch.float32, device=dev)
              if return_states else None)
    if n_a * B > 0:
        rc = _build.kernel_fn("fused_linesearch_launch")(
            mid, _build.ptr(alphas), _build.ptr(x0), _build.ptr(us), _build.ptr(ks),
            _build.ptr(Ks), _build.ptr(xref), _build.ptr(g_z), _build.ptr(us_hat),
            _build.ptr(costs), _build.ptr(xs_hat) if return_states else None,
            n_a, B, T, float(model.bounds_low[0]), float(model.bounds_high[0]),
            int(with_terminal), w, w_term, _build.stream_ptr(dev))
        _build.check_rc("fused_linesearch", rc)
        fused_linesearch.launches += 1
    if return_states:
        return us_hat, xs_hat, costs
    return us_hat, costs


fused_linesearch.launches = 0
