"""Acrobot (2-link underactuated pendulum) model.

Counterpart of ``benchmarking_mpc_solvers_tpu/models/acrobot.py``:

- one RK4 step with dt=0.2 of the manipulator equations ("book" variant),
  holding u constant over the step;
- theta1, theta2 wrapped to [-pi, pi) by floor-mod; velocities clipped to
  ±4π / ±9π;
- torque is NOT clipped inside the dynamics;
- features z = (-cosθ1 - cos(θ1+θ2) - 2, 0, 0, 0, u);
- stage and terminal cost both zᵀ diag(1,0,0,0,0) z.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .base import Model, quad_cost

DT = 0.2
L1 = 1.0
M1 = 1.0
M2 = 1.0
LC1 = 0.5
LC2 = 0.5
I1 = 1.0
I2 = 1.0
GRAV = 9.8
MAX_VEL_1 = 4.0 * np.pi
MAX_VEL_2 = 9.0 * np.pi

W = np.diag(np.array([1.0, 0.0, 0.0, 0.0, 0.0], dtype=np.float32))


def _dsdt(s, a):
    """Manipulator-equation derivative, "book" variant."""
    theta1, theta2, dtheta1, dtheta2 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    cos2 = torch.cos(theta2)
    sin2 = torch.sin(theta2)
    d1 = (
        M1 * LC1**2
        + M2 * ((L1**2 + LC2**2) + (2.0 * L1 * LC2) * cos2)
        + I1
        + I2
    )
    d2 = M2 * (LC2**2 + (L1 * LC2) * cos2) + I2
    phi2 = (M2 * LC2 * GRAV) * torch.cos(theta1 + theta2 - math.pi / 2.0)
    phi1 = (
        (-M2 * L1 * LC2) * (dtheta2 * dtheta2) * sin2
        - (2.0 * M2 * L1 * LC2) * dtheta2 * dtheta1 * sin2
        + ((M1 * LC1 + M2 * L1) * GRAV) * torch.cos(theta1 - math.pi / 2.0)
        + phi2
    )
    ddtheta2 = (
        a
        + d2 / d1 * phi1
        - (M2 * L1 * LC2) * (dtheta1 * dtheta1) * sin2
        - phi2
    ) / ((M2 * LC2**2 + I2) - (d2 * d2) / d1)
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2], dim=-1)


def wrap(x, lo, hi):
    """Wrap x into [lo, hi) by floor-mod."""
    return torch.remainder(x - lo, hi - lo) + lo


def dynamics(x, u):
    """x = (..., [theta1, theta2, dtheta1, dtheta2]); u = (..., [torque])."""
    a = u[..., 0]
    k1 = _dsdt(x, a)
    k2 = _dsdt(x + (DT / 2.0) * k1, a)
    k3 = _dsdt(x + (DT / 2.0) * k2, a)
    k4 = _dsdt(x + DT * k3, a)
    ns = x + (DT / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return torch.stack(
        [
            wrap(ns[..., 0], -math.pi, math.pi),
            wrap(ns[..., 1], -math.pi, math.pi),
            torch.clamp(ns[..., 2], -MAX_VEL_1, MAX_VEL_1),
            torch.clamp(ns[..., 3], -MAX_VEL_2, MAX_VEL_2),
        ],
        dim=-1,
    )


def transform(x, u):
    tip = -torch.cos(x[..., 0]) - torch.cos(x[..., 1] + x[..., 0]) - 2.0
    zeros = torch.zeros_like(tip)
    return torch.stack([tip, zeros, zeros, zeros, u[..., 0] + zeros], dim=-1)


AcrobotModel = Model(
    name="acrobot",
    state_size=4,
    action_size=1,
    bounds_low=(-1.0,),
    bounds_high=(1.0,),
    dynamics=dynamics,
    transform=transform,
    state_cost=quad_cost(W),
    terminal_cost=quad_cost(W),
)
