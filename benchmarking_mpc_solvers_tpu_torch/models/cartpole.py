"""Cart-pole swing-up model (DeepPILCO-style physics).

Counterpart of ``benchmarking_mpc_solvers_tpu/models/cartpole.py``:

- action clipped to ±1 then scaled by force_mag=10;
- Euler integration dt=0.05, positions updated with the old velocities;
- friction b=0.1 on the cart velocity;
- features z = ((x/2.4)² + (x/2.4)¹⁰, ẋ, 1-cosθ, θ̇, u);
- stage cost zᵀ diag(1,0,5,0,0) z; terminal cost zᵀ diag(-5,0,-10,0,0) z
  (the reference's terminal weight keeps its negative sign).

Constants are grouped as the reference groups them (Python-float products
first, then float32 tensor arithmetic) and powers are written as repeated
multiplication, so results agree with the reference to float32 rounding.
The CUDA device function in ``csrc/models.cuh`` follows the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Model, quad_cost

G = 9.82
M_C = 0.5
M_P = 0.5
TOTAL_M = M_P + M_C
L = 0.6
M_P_L = M_P * L
FORCE_MAG = 10.0
DT = 0.05
B_FRICTION = 0.1
X_THRESHOLD = 2.4

W = np.diag(np.array([1.0, 0.0, 5.0, 0.0, 0.0], dtype=np.float32))
W_T = np.diag(np.array([-5.0, 0.0, -10.0, 0.0, 0.0], dtype=np.float32))


def dynamics(x, u):
    """x = (..., [pos, pos_dot, theta, theta_dot]); u = (..., [force])."""
    action = torch.clamp(u[..., 0], -1.0, 1.0) * FORCE_MAG
    xc, x_dot, theta, theta_dot = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    s = torch.sin(theta)
    c = torch.cos(theta)
    td2 = theta_dot * theta_dot
    c2 = c * c
    xdot_update = (
        (-2.0 * M_P_L) * td2 * s
        + (3.0 * M_P * G) * s * c
        + 4.0 * action
        - (4.0 * B_FRICTION) * x_dot
    ) / ((4.0 * TOTAL_M) - (3.0 * M_P) * c2)
    thetadot_update = (
        (-3.0 * M_P_L) * td2 * s * c
        + (6.0 * TOTAL_M * G) * s
        + 6.0 * (action - B_FRICTION * x_dot) * c
    ) / ((4.0 * L * TOTAL_M) - (3.0 * M_P_L) * c2)
    new_x = xc + x_dot * DT
    new_theta = theta + theta_dot * DT
    new_x_dot = x_dot + xdot_update * DT
    new_theta_dot = theta_dot + thetadot_update * DT
    return torch.stack([new_x, new_x_dot, new_theta, new_theta_dot], dim=-1)


def transform(x, u):
    a = x[..., 0] / X_THRESHOLD
    a2 = a * a
    a8 = (a2 * a2) * (a2 * a2)
    xc = a2 + a2 * a8  # a**10 as the reference's square-and-multiply
    return torch.stack(
        [xc, x[..., 1], 1.0 - torch.cos(x[..., 2]), x[..., 3], u[..., 0]], dim=-1
    )


CartPoleSwingUpModel = Model(
    name="cartpole_swingup",
    state_size=4,
    action_size=1,
    bounds_low=(-1.0,),
    bounds_high=(1.0,),
    dynamics=dynamics,
    transform=transform,
    state_cost=quad_cost(W),
    terminal_cost=quad_cost(W_T),
)
