"""Single-kernel MPPI step: noise, K rollouts, softmax and plan update.

Counterpart of ``benchmarking_mpc_solvers_tpu/ops/fused_mppi.py:
fused_mppi_step``. On a CUDA tensor ``fused_mppi_step`` launches the
hand-written kernel in ``csrc/fused_mppi.cu`` (one warp per scenario, one
lane per sample, the stage cost compiled for the model's own weights, pass
1's noise kept in shared memory for pass 2 where it fits; the dummy family
past S = 8 in the kernel's dummy form, S and the weights as arguments,
where one action term ends the weights' list the terms before it summed
once per scenario and step; ``launch_config`` reports the launch shape of
either form); on a CPU tensor it runs
``fused_mppi_step_reference``, the plain PyTorch version.
``fused_mppi_step.launches`` counts kernel launches.

Noise is the reference kernel's interpret-mode stream (``interp_normals``):
counter-based and stateless, so this module, the CUDA kernel and the JAX
kernel in interpret mode all draw the same delta for (scenario, k, t). The
uint32 hash is emulated here in int64 with a mask after every operation.
Scenario b takes the noise of the slot the reference's padded
(T, 8, Bp/8) tiling gives it (``noise_layout``).

The two-stage tiers draw each scenario's noise from its own stream
(``scenario_normals``, (B, K, W), scaled): on a CUDA tensor one launch of
the draw kernel in ``csrc/fused_rollout.cu`` (``scenario_normals.launches``
counts them), on a CPU tensor ``scenario_normals_reference``, the int64
emulation.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import _build
from ..models.base import Model

SUBLANES = 8
DEFAULT_LANES = 512
_MASK = 0xFFFFFFFF
_TWO_PI_F32 = float(np.float32(2.0) * np.float32(math.pi))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pick_lanes(B: int) -> int:
    """Lane count whose (8·lanes) tile divides B, else 512 (B >= 4096) or 128."""
    for lanes in (512, 256, 128):
        if B % (SUBLANES * lanes) == 0:
            return lanes
    return 512 if B >= 4096 else 128


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 a in [0, 2**32) and a constant c, without
    overflowing int64 (16-bit halves of c)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _hash(seed_c, t, idx):
    """murmur3 finalizer over (seed, t, index), all in [0, 2**32): ints or
    int64 tensors."""
    x = (_mul32(seed_c, 0x9E3779B9) + _mul32(t, 0x85EBCA6B) + idx) & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _u01(x):
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _normals(seed_c, t, i1, i2):
    """Box-Muller cos half from the uniforms at counter indices i1, i2."""
    u1 = _u01(_hash(seed_c, t, i1)) + 1e-7
    u2 = _u01(_hash(seed_c, t, i2))
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI_F32 * u2)


def interp_normals(seed_c: int, t: int, lanes: int, device=None):
    """(8, lanes) normals of one (combined seed, timestep), as the reference's
    ``interp_normals`` lays them out."""
    idx = torch.arange(SUBLANES * lanes, dtype=torch.int64, device=device).reshape(SUBLANES, lanes)
    seed = torch.tensor(seed_c & _MASK, dtype=torch.int64, device=device)
    return _normals(seed, t, idx, idx + SUBLANES * lanes)


def noise_layout(B: int, lanes: int, device=None):
    """Per scenario b: grid program pid and the two counter indices of its
    slot in the reference's padded (T, 8, Bp/8) layout."""
    tile = SUBLANES * lanes
    C = _round_up(max(B, tile), tile) // SUBLANES
    b = torch.arange(B, dtype=torch.int64, device=device)
    s, col = b // C, b % C
    pid, lane = col // lanes, col % lanes
    return pid, s * lanes + lane, (SUBLANES + s) * lanes + lane


def scenario_seeds(batch: int, generator: torch.Generator, device) -> torch.Tensor:
    """(B,) int64 noise seeds, one per scenario, drawn once from the
    generator (on the generator's device, then moved to ``device``)."""
    return torch.randint(0, 2**63 - 1, (batch,), generator=generator, dtype=torch.int64,
                         device=generator.device).to(device)


def scenario_normals_reference(seeds, calls, K: int, T: int):
    """Plain version of ``scenario_normals``: the uint32 hash emulated in
    int64 over (B, K, T)."""
    stream = _hash(seeds & _MASK, calls & _MASK, (seeds >> 32) & _MASK)
    k = torch.arange(K, dtype=torch.int64, device=seeds.device)[None, :, None]
    t = torch.arange(T, dtype=torch.int64, device=seeds.device)[None, None, :]
    return _normals(stream[:, None, None], t, 2 * k, 2 * k + 1)


def _draw(seeds, calls, K: int, W: int, scale: float):
    """One launch of the draw kernel: (B, K, W), every normal times
    ``scale``."""
    B = seeds.shape[0]
    dev = seeds.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if seeds.dtype != torch.int64 or calls.dtype != torch.int64:
        raise TypeError(f"scenario_normals: seeds and calls must be int64, got {seeds.dtype}, "
                        f"{calls.dtype}")
    if seeds.dim() != 1 or calls.shape != seeds.shape or calls.device != dev:
        raise ValueError(f"scenario_normals: seeds {tuple(seeds.shape)} on {dev} and calls "
                         f"{tuple(calls.shape)} on {calls.device} must be one (B,) pair")
    if B * K >= 2**31 or 32 * W >= 2**31:
        raise ValueError(f"scenario_normals: B·K = {B * K}, W = {W} past the kernel's indices")
    out = torch.empty((B, K, W), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    seeds, calls = seeds.contiguous(), calls.contiguous()
    _build.check_rc("scenario_normals", _build.kernel_fn("scenario_normals_launch")(
        _build.ptr(seeds), _build.ptr(calls), _build.ptr(out), B * K, K, W, scale,
        _build.stream_ptr(dev)))
    scenario_normals.launches += 1
    return out


def scenario_normals(seeds, calls, K: int, T: int, scale: float = 1.0):
    """(B, K, T) standard normals of the batched tiers' per-scenario streams,
    each times ``scale``.

    Entry [b, k, t] is a function of (seeds[b], calls[b], k, t) alone: the
    stream of a (scenario, draw) pair is the hash of the seed's low word,
    the draw count and the seed's high word, and within it (k, t) takes the
    uniforms at counter indices 2k and 2k+1 of timestep t. So a scenario's
    draws do not depend on its batch slot or on B, and permuting the
    scenarios (with their seeds and counts) permutes the draws. On CUDA
    tensors one launch of the draw kernel; on CPU tensors the plain version,
    then the product by ``scale``: the same values either way, bit for bit."""
    if seeds.device.type != "cpu":
        return _draw(seeds, calls, K, T, scale)
    draws = scenario_normals_reference(seeds, calls, K, T)
    return draws if scale == 1.0 else scale * draws


def scenario_normals_launch_config(N: int) -> dict:
    """The draw kernel's launch shape over N = B·K columns on the current
    card: threads per block, blocks, registers per thread, resident blocks
    per SM, local bytes per thread."""
    out = (ctypes.c_int * 5)()
    _build.check_rc("scenario_normals_launch_config", _build.kernel_fn(
        "scenario_normals_launch_config")(N, ctypes.cast(out, ctypes.c_void_p)))
    keys = ("threads", "blocks", "registers", "blocks_per_sm", "local_bytes")
    return dict(zip(keys, out))


scenario_normals.launches = 0


def _seeds(seed: int, K: int, pid):
    """(K, B) combined seeds seed + k*7919 + pid*104729 mod 2**32."""
    k = torch.arange(K, dtype=torch.int64, device=pid.device)[:, None]
    return ((seed & _MASK) + k * 7919 + pid[None] * 104729) & _MASK


def launch_config(model: Model, T: int, K: int, B: int) -> dict:
    """The kernel's launch shape at (T, K, B) on the current card: threads
    and scenarios per block, blocks, shared bytes per block, registers per
    thread, resident blocks per SM, and whether pass 2 reads pass 1's noise
    from shared memory (``noise_cache``; else it draws it again), and the
    stage cost's form (``generic_cost``: True where the model's weights are
    not its functor's compiled terms). For the dummy past S = 8, the dummy
    form's: in place of ``generic_cost``
    its form (``_build.DUMMY_TAIL_FORMS``), the leading run its prologue sums
    (``n_lead``; 0 in the whole list's form) and the terms each step adds
    (``tail``)."""
    S_dummy = _build.dummy_size(model)
    if S_dummy is not None:
        terms, n_lead = _build.dummy_terms(model.state_cost, "cuda")
        out = (ctypes.c_int * 10)()
        _build.check_rc("launch_config", _build.kernel_fn("fused_mppi_dummy_launch_config")(
            S_dummy, T, K, B, terms.shape[0], n_lead, ctypes.cast(out, ctypes.c_void_p)))
        keys = ("threads", "scenarios_per_block", "blocks", "shared_bytes", "registers",
                "blocks_per_sm", "noise_cache", "form", "n_lead", "tail")
        return {**dict(zip(keys, out)), "noise_cache": bool(out[6]),
                "form": _build.DUMMY_TAIL_FORMS[out[7]]}
    out = (ctypes.c_int * 8)()
    _build.check_rc("launch_config", _build.kernel_fn("fused_mppi_launch_config")(
        _build.model_id(model), T, K, B, _build.quad_weights(model.state_cost),
        ctypes.cast(out, ctypes.c_void_p)))
    keys = ("threads", "scenarios_per_block", "blocks", "shared_bytes", "registers",
            "blocks_per_sm", "noise_cache", "generic_cost")
    return {**dict(zip(keys, out)), "noise_cache": bool(out[6]), "generic_cost": bool(out[7])}


def fused_mppi_step_reference(model: Model, K: int, std: float, lam: float, lanes: int,
                              planned_tm, x0_tm, gz, seed: int):
    """Plain version of the MPPI step: the horizon as a loop, (K, B) rollouts
    vectorised, the noise kept from pass 1 for pass 2."""
    T, B = planned_tm.shape
    dev = planned_tm.device
    pid, i1, i2 = noise_layout(B, lanes, dev)
    seed_c = _seeds(int(seed), K, pid)
    inv_var = 1.0 / (std * std)
    x = x0_tm.T.expand(K, B, x0_tm.shape[0])
    acc = torch.zeros((K, B), dtype=torch.float32, device=dev)
    deltas = []
    for t in range(T):
        d = _normals(seed_c, t, i1, i2)
        deltas.append(d)
        sd = std * d
        u = (planned_tm[t] + sd)[..., None]
        c = model.state_cost(model.transform(x, u), gz[t])
        c = c + (lam * inv_var) * (u[..., 0] * sd)
        x = model.dynamics(x, u)
        acc = acc + c
    costs = torch.where(torch.isfinite(acc), acc, torch.full_like(acc, 1e30))
    beta = costs.min(dim=0).values
    wts = torch.exp(-(costs - beta) / lam)
    w = wts / wts.sum(dim=0)
    deltas = torch.stack(deltas)  # (T, K, B)
    out = planned_tm.clone()
    for k in range(K):  # the reference's order: out += w_k * std * delta_k
        out = out + w[k] * (std * deltas[:, k])
    return out


def fused_mppi_step(model: Model, K: int, std: float, lam: float, lanes: int,
                    planned_tm, x0_tm, gz, seed: int):
    """One full MPPI update for B scenarios: planned_tm (T, B), x0_tm (S, B),
    gz (T, Z), int32 seed -> new (T, B) plans. The kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if model.action_size != 1:
        raise NotImplementedError("fused MPPI supports action_size == 1")
    T, B = planned_tm.shape
    S = model.state_size
    if x0_tm.shape != (S, B) or gz.shape != (T, model.goal_size):
        raise ValueError(
            f"shapes planned_tm {tuple(planned_tm.shape)}, x0_tm {tuple(x0_tm.shape)}, "
            f"gz {tuple(gz.shape)} do not fit model {model.name!r}")
    if planned_tm.device.type == "cpu":
        return fused_mppi_step_reference(model, K, std, lam, lanes, planned_tm, x0_tm, gz, seed)
    if planned_tm.device.type != "cuda":
        raise ValueError(f"unsupported device {planned_tm.device}")
    S_dummy = _build.dummy_size(model)
    mid = None if S_dummy is not None else _build.model_id(model)
    dev = planned_tm.device
    _build.check_cuda_args("fused_mppi_step", dev, planned_tm=planned_tm, x0_tm=x0_tm, gz=gz)
    if B == 0 or T == 0:
        return planned_tm.clone()
    out = torch.empty_like(planned_tm)
    tile = SUBLANES * lanes
    C = _round_up(max(B, tile), tile) // SUBLANES
    ctrl_scale = lam * (1.0 / (std * std))
    args = (_build.ptr(planned_tm), _build.ptr(x0_tm), _build.ptr(gz), _build.ptr(out),
            T, B, K, std, ctrl_scale, lam, int(seed) & _MASK, lanes, C)
    if S_dummy is None:
        rc = _build.kernel_fn("fused_mppi_step_launch")(
            mid, *args, _build.quad_weights(model.state_cost), _build.stream_ptr(dev))
    else:
        terms, n_lead = _build.dummy_terms(model.state_cost, dev)
        rc = _build.kernel_fn("fused_mppi_dummy_launch")(
            S_dummy, *args, _build.ptr(terms), terms.shape[0], n_lead, _build.stream_ptr(dev))
    _build.check_rc("fused_mppi_step", rc)
    fused_mppi_step.launches += 1
    return out


fused_mppi_step.launches = 0
