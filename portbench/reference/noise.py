"""The counter-based noise streams the port's MPPI and CEM tiers draw, in
plain PyTorch: a frozen copy of their arithmetic, so that the reference
draws the same normal for the same (stream, k, t) without importing the
program.

Two streams:
- the single-kernel tiers' (kernels 1 and 3): one int32 seed per solver
  call, combined with the sample k and the scenario's grid program, and
  scenario b in the slot of a padded (T, 8, Bp/8) tiling (``noise_layout``);
- the two-stage tiers' per-scenario stream (``scenario_normals``): a
  function of the scenario's own int64 seed, its draw count, k and t.

The uint32 murmur3 finalizer is emulated in int64 with a mask after every
operation. Uniforms come from the top 24 bits; a normal is the cosine half
of Box-Muller. ``dt`` is the float type the normals are formed in: float32
as the program forms them, a lower one for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SUBLANES = 8
MASK = 0xFFFFFFFF
TWO_PI_F32 = float(np.float32(2.0) * np.float32(math.pi))
K_STRIDE, PID_STRIDE, IT_STRIDE = 7919, 104729, 15485863


def _mul32(a, c: int):
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def hash32(seed_c, t, idx):
    """murmur3 finalizer over (seed, t, index), each in [0, 2**32)."""
    x = (_mul32(seed_c, 0x9E3779B9) + _mul32(t, 0x85EBCA6B) + idx) & MASK
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _u01(x, dt):
    return (x >> 8).to(torch.float32).to(dt) * (1.0 / (1 << 24))


def normals(seed_c, t, i1, i2, dt=torch.float32):
    """Box-Muller cosine half of the uniforms at counter indices i1, i2."""
    u1 = _u01(hash32(seed_c, t, i1), dt) + 1e-7
    u2 = _u01(hash32(seed_c, t, i2), dt)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI_F32 * u2)


def pick_lanes(B: int) -> int:
    """The lanes of the tiling the single-kernel tiers lay B scenarios in."""
    for lanes in (512, 256, 128):
        if B % (SUBLANES * lanes) == 0:
            return lanes
    return 512 if B >= 4096 else 128


def noise_layout(B: int, idx, device):
    """For the scenarios ``idx`` of a batch of B: their grid program and
    the two counter indices of their slot in the padded tiling."""
    lanes = pick_lanes(B)
    tile = SUBLANES * lanes
    C = -(-max(B, tile) // tile) * tile // SUBLANES
    b = torch.as_tensor(idx, dtype=torch.int64, device=device)
    s, col = b // C, b % C
    pid, lane = col // lanes, col % lanes
    return pid, s * lanes + lane, (SUBLANES + s) * lanes + lane


def combined_seeds(seed: int, K: int, pid):
    """(K, n) combined seeds seed + k*7919 + pid*104729 (mod 2**32)."""
    k = torch.arange(K, dtype=torch.int64, device=pid.device)[:, None]
    return ((int(seed) & MASK) + k * K_STRIDE + pid[None] * PID_STRIDE) & MASK


def scenario_normals(seeds, calls, K: int, T: int, dt=torch.float32):
    """(n, K, T) normals of the two-stage tiers' per-scenario streams."""
    stream = hash32(seeds & MASK, calls & MASK, (seeds >> 32) & MASK)
    k = torch.arange(K, dtype=torch.int64, device=seeds.device)[None, :, None]
    t = torch.arange(T, dtype=torch.int64, device=seeds.device)[None, None, :]
    return normals(stream[:, None, None], t, 2 * k, 2 * k + 1, dt)
