"""Cart-pole swing-up in plain PyTorch: the plant the configurations drive.

DeepPILCO-style physics as the benchmark suite states it: the action clipped
to [-1, 1] and scaled by a force of 10, Euler steps of dt = 0.05 with the
positions moved by the old velocities, friction 0.1 on the cart; features
z = ((x/2.4)^2 + (x/2.4)^10, x_dot, 1 - cos(theta), theta_dot, u) and the
stage cost z^T diag(1, 0, 5, 0, 0) z against a zero goal, clipped to 1e30.
Constants are grouped and powers multiplied out in the order the program
rounds them, so that float32 results agree bit for bit where the operations
are the same.
"""

from __future__ import annotations

import math

import torch

S, A = 4, 1
LO, HI = -1.0, 1.0
START = (0.0, 0.0, math.pi, 0.0)
G, M_C, M_P, L = 9.82, 0.5, 0.5, 0.6
TOTAL_M, M_P_L = M_P + M_C, M_P * L
FORCE_MAG, DT, B_FRICTION, X_THRESHOLD = 10.0, 0.05, 0.1, 2.4
COST_TERMS = ((0, 0, 1.0), (2, 2, 5.0))  # (i, j, weight) of diag(1, 0, 5, 0, 0)
COST_CLIP = 1e30


def dynamics(x, u):
    """x (..., 4), u (..., 1) -> next state (..., 4)."""
    action = torch.clamp(u[..., 0], LO, HI) * FORCE_MAG
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
    return torch.stack([xc + x_dot * DT, x_dot + xdot_update * DT,
                        theta + theta_dot * DT, theta_dot + thetadot_update * DT], dim=-1)


def features(x, u):
    a = x[..., 0] / X_THRESHOLD
    a2 = a * a
    a8 = (a2 * a2) * (a2 * a2)
    return torch.stack([a2 + a2 * a8, x[..., 1], 1.0 - torch.cos(x[..., 2]), x[..., 3],
                        u[..., 0]], dim=-1)


def stage_cost(x, u):
    """The clipped quadratic stage cost of (x, u) against the zero goal."""
    z = features(x, u)
    out = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    for i, j, w in COST_TERMS:
        out = out + w * (z[..., i] * z[..., j])
    return torch.clamp(out, -COST_CLIP, COST_CLIP)
