"""Torque-limited pendulum swing-up model.

Counterpart of ``benchmarking_mpc_solvers_tpu/models/pendulum.py``:

- semi-implicit Euler with dt=0.05: thdot' first, th' from the *unclipped*
  thdot', then thdot' clipped to ±8;
- torque clipped to ±2 inside the dynamics;
- features z = -(angle_normalize(th), thdot, u), where angle_normalize is a
  floor-mod (``torch.remainder``, as ``%`` on floats in the reference);
- stage cost zᵀ diag(1, .1, .001) z; terminal zᵀ diag(1, 2, 0) z.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import Model, clip, quad_cost

MAX_TORQUE = 2.0
MAX_SPEED = 8.0
DT = 0.05
G = 10.0
M = 1.0
L = 1.0

W = np.diag(np.array([1.0, 0.1, 0.001], dtype=np.float32))
W_T = np.diag(np.array([1.0, 2.0, 0.0], dtype=np.float32))


def angle_normalize(x):
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def dynamics(x, u):
    """x = (..., [th, thdot]); u = (..., [torque])."""
    torque = clip(u[..., 0], -MAX_TORQUE, MAX_TORQUE)
    th, thdot = x[..., 0], x[..., 1]
    newthdot = thdot + (
        (-3.0 * G / (2.0 * L)) * torch.sin(th + math.pi)
        + (3.0 / (M * L**2)) * torque
    ) * DT
    newth = th + newthdot * DT
    newthdot = clip(newthdot, -MAX_SPEED, MAX_SPEED)
    return torch.stack([newth, newthdot], dim=-1)


def transform(x, u):
    return -torch.stack([angle_normalize(x[..., 0]), x[..., 1], u[..., 0]], dim=-1)


PendulumModel = Model(
    name="pendulum",
    state_size=2,
    action_size=1,
    bounds_low=(-MAX_TORQUE,),
    bounds_high=(MAX_TORQUE,),
    dynamics=dynamics,
    transform=transform,
    state_cost=quad_cost(W),
    terminal_cost=quad_cost(W_T),
)
