"""Carry solver state and model weights across from numpy arrays.

The reference package's state (a plan warmed up there, its perturbations,
its cost weights) reaches this package as numpy arrays; these helpers turn
them into this package's tensors and check that both packages hold the same
cost weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import default_generator, resolve_device
from .models import REGISTRY
from .models.base import nonzero_pairs
from .solvers.mppi import MPPIState


def mppi_state_from_numpy(planned_us, delta_u=None,
                          generator: Optional[torch.Generator] = None,
                          device="cuda") -> MPPIState:
    """MPPIState from a (T, A) or (B, T, A) plan and, optionally, the (K, T, A)
    fixed perturbations of the sample-once mode."""
    device = resolve_device(device)
    planned = torch.tensor(np.asarray(planned_us, np.float32), device=device)
    if delta_u is None:
        delta = planned.new_zeros((1, 1, 1))
    else:
        delta = torch.tensor(np.asarray(delta_u, np.float32), device=device)
    return MPPIState(planned, delta, default_generator(generator, device))


def plan_tm_from_numpy(planned_tm, device="cuda") -> torch.Tensor:
    """A time-major (T, B) plan as the contiguous float32 tensor the kernel
    tier carries."""
    device = resolve_device(device)
    return torch.tensor(np.asarray(planned_tm, np.float32), device=device)


def model_weights_from_numpy(W, W_T, name: Optional[str] = None) -> list:
    """Check stage and terminal weights (W, W_T) against this package's model
    (the one called ``name``, or any model) and return the stage cost's
    nonzero (i, j, w) terms, the form the kernels take. Raises if no model
    here holds exactly these weights."""
    W = np.asarray(W, np.float32)
    W_T = np.asarray(W_T, np.float32)
    models = [REGISTRY[name]] if name is not None else list(REGISTRY.values())
    for model in models:
        if (np.array_equal(model.state_cost.W, W)
                and np.array_equal(model.terminal_cost.W, W_T)):
            return nonzero_pairs(W)
    raise ValueError(f"no model {'named ' + repr(name) if name else ''} holds these weights")
