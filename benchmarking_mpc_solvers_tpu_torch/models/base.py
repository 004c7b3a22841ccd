"""Pure-function dynamics and cost models on batched tensors.

PyTorch counterpart of ``benchmarking_mpc_solvers_tpu/models/base.py``. A
model is a frozen bundle of functions over tensors with any leading batch
dimensions:

    dynamics(x, u)        -> x_next   (..., S), (..., A) -> (..., S)
    transform(x, u)       -> z        (..., S), (..., A) -> (..., Z), Z = S + A
    state_cost(z, g_z)    -> cost     (..., Z), (..., Z) -> (...)
    terminal_cost(z, g_z) -> cost

The stage cost is evaluated at the current ``(x, u)`` before the dynamics
step; reward is ``-cost``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

COST_CLIP = 1e30


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    """A pure-function model definition (functions take batched tensors)."""

    name: str
    state_size: int
    action_size: int
    bounds_low: tuple  # per-action lower bounds, length action_size
    bounds_high: tuple  # per-action upper bounds, length action_size
    dynamics: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    transform: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    state_cost: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    terminal_cost: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    @property
    def goal_size(self) -> int:
        """Size of the feature vector z (= state_size + action_size)."""
        return self.state_size + self.action_size

    def lo(self, device=None) -> torch.Tensor:
        return torch.tensor(self.bounds_low, dtype=torch.float32, device=device)

    def hi(self, device=None) -> torch.Tensor:
        return torch.tensor(self.bounds_high, dtype=torch.float32, device=device)

    def cost(self, x, u, g_z):
        """Stage cost of (x, u) against goal features g_z."""
        return self.state_cost(self.transform(x, u), g_z)

    def final_cost(self, x, g_z):
        """Terminal cost: features of (x, 0) against g_z."""
        u0 = x.new_zeros(x.shape[:-1] + (self.action_size,))
        return self.terminal_cost(self.transform(x, u0), g_z)

    def step_and_cost(self, x, u, g_z):
        """(next state, cost at the current (x, u))."""
        return self.dynamics(x, u), self.cost(x, u, g_z)

    def clip_action(self, u):
        return torch.clamp(u, self.lo(u.device), self.hi(u.device))


def nonzero_pairs(W) -> list:
    """Upper-triangle nonzero entries of sym(W) as (i, j, weight) with the
    off-diagonal weights doubled: the terms of (z-g)ᵀ W (z-g) that the
    quadratic cost and the CUDA kernels contract."""
    W = np.asarray(W, dtype=np.float32)
    Wsym = 0.5 * (W + W.T)
    Z = W.shape[0]
    return [
        (i, j, float(Wsym[i, j] * (1.0 if i == j else 2.0)))
        for i in range(Z)
        for j in range(i, Z)
        if Wsym[i, j] != 0.0
    ]


def quad_cost(W) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Quadratic cost (z-g)ᵀ W (z-g) over the nonzero entries of W, clipped
    to ±1e30.

    Contracting only the nonzero entries keeps an overflowed feature at
    ±inf -> ±1e30 instead of the inf*0 = nan a dense product gives, and the
    clip keeps horizon sums of fully diverged rollouts finite. ``cost.W``
    and ``cost.nz`` are attached for the fused kernels.
    """
    W = np.asarray(W, dtype=np.float32)
    nz = nonzero_pairs(W)

    def cost(z, g_z):
        zd = z - g_z
        out = torch.zeros(zd.shape[:-1], dtype=torch.float32, device=zd.device)
        for i, j, w in nz:
            out = out + w * (zd[..., i] * zd[..., j])
        return torch.clamp(out, -COST_CLIP, COST_CLIP)

    cost.W = W
    cost.nz = nz
    return cost
