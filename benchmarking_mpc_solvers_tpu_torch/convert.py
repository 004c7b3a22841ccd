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
from .ops.fused_mppi import scenario_seeds
from .ops.linearize import AffineDynamics, QuadCost
from .solvers.cem import CEMState
from .solvers.i2c import I2CState
from .solvers.ilqr import ILQRState
from .solvers.mppi import MPPIState
from .solvers.qp_mpc import QPMPCState
from .solvers.sqp import SQPState


def _plan_state(planned_us, generator, device):
    """(plan tensor, generator, and for a (B, T, A) plan the batched tiers'
    per-scenario seeds and zero draw counts, else None, None)."""
    device = resolve_device(device)
    planned = torch.tensor(np.asarray(planned_us, np.float32), device=device)
    gen = default_generator(generator, device)
    if planned.ndim != 3:
        return planned, gen, None, None
    B = planned.shape[0]
    return (planned, gen, scenario_seeds(B, gen, device),
            torch.zeros((B,), dtype=torch.int64, device=device))


def mppi_state_from_numpy(planned_us, delta_u=None,
                          generator: Optional[torch.Generator] = None,
                          device="cuda") -> MPPIState:
    """MPPIState from a (T, A) or (B, T, A) plan and, optionally, the (K, T, A)
    fixed perturbations of the sample-once mode."""
    planned, gen, seeds, calls = _plan_state(planned_us, generator, device)
    if delta_u is None:
        delta = planned.new_zeros((1, 1, 1))
    else:
        delta = torch.tensor(np.asarray(delta_u, np.float32), device=planned.device)
    return MPPIState(planned, delta, gen, seeds, calls)


def cem_state_from_numpy(planned_us, generator: Optional[torch.Generator] = None,
                         device="cuda") -> CEMState:
    """CEMState from a (T, A) or (B, T, A) plan mean."""
    return CEMState(*_plan_state(planned_us, generator, device))


def ilqr_state_from_numpy(planned_us, generator: Optional[torch.Generator] = None,
                          device="cuda") -> ILQRState:
    """ILQRState from a (T, A) or (B, T, A) plan, e.g. the reference's
    ``init_state`` draw, so both packages start from the same plan."""
    planned, gen, _, _ = _plan_state(planned_us, generator, device)
    return ILQRState(planned, gen)


def sqp_state_from_numpy(planned_us, generator: Optional[torch.Generator] = None,
                         device="cuda") -> SQPState:
    """SQPState from a (T, A) or (B, T, A) plan."""
    planned, gen, _, _ = _plan_state(planned_us, generator, device)
    return SQPState(planned, gen)


def qpmpc_state_from_numpy(planned_us, generator: Optional[torch.Generator] = None,
                           device="cuda") -> QPMPCState:
    """QPMPCState from a (T, A) or (B, T, A) plan."""
    planned, gen, _, _ = _plan_state(planned_us, generator, device)
    return QPMPCState(planned, gen)


def i2c_state_from_numpy(planned_us, generator: Optional[torch.Generator] = None,
                         device="cuda") -> I2CState:
    """I2CState from a (T, A) or (B, T, A) plan."""
    planned, gen, _, _ = _plan_state(planned_us, generator, device)
    return I2CState(planned, gen)


def _tensors(arrays, device):
    device = resolve_device(device)
    return [torch.tensor(np.asarray(a, np.float32), device=device) for a in arrays]


def affine_dynamics_from_numpy(A, B, c, device="cuda") -> AffineDynamics:
    """The reference's ``AffineDynamics`` leaves (A, B, c), as numpy arrays
    with any leading batch dimensions, as this package's tuple."""
    return AffineDynamics(*_tensors((A, B, c), device))


def quad_cost_from_numpy(Q, R, M, q, r, Qf, qf, device="cuda") -> QuadCost:
    """The reference's ``QuadCost`` leaves, in its field order, as this
    package's tuple."""
    return QuadCost(*_tensors((Q, R, M, q, r, Qf, qf), device))


def i2c_problem_from_numpy(F, m, J, z0, R, mu0, sig0, Qproc, g_z, device="cuda") -> tuple:
    """The arguments of the reference's ``i2c_smooth_batch`` (F (B, T, D, D),
    m (B, T, D), J (B, T, Z, D), z0 (B, T, Z), R (B, Z, Z) or (Z, Z), mu0
    (B, D), sig0 and Qproc (D, D), g_z (T, Z)), in its order, as the
    contiguous float32 tensors this package's ``ops.i2c_smooth`` takes."""
    return tuple(_tensors((F, m, J, z0, R, mu0, sig0, Qproc, g_z), device))


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
