"""Solver interface and the MPC agent-layer semantics.

Counterpart of ``benchmarking_mpc_solvers_tpu/solvers/base.py``. A Solver is
a frozen dataclass with ``init_state(generator, device) -> state`` and
``solve(state, x, g_z) -> (state, u0, aux)``; ``predict_action`` composes
them with the reference agent's clip -> simulate -> shift semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from ..models.base import Model
from ..ops.rollout import simulate_trajectory


@dataclasses.dataclass(frozen=True, eq=False)
class Solver:
    """Base class: holds the planning model and the horizon length."""

    model: Model
    T: int  # horizon length

    def init_state(self, generator: torch.Generator, device="cuda") -> Any:
        raise NotImplementedError

    def solve(self, state, x, g_z):
        """One full solver invocation (the reference ``_calc_action``)."""
        raise NotImplementedError

    @property
    def goal_size(self) -> int:
        return self.model.goal_size

    def goal_traj(self, goal_state, device="cuda"):
        """Repeat a goal state over the horizon: (T, Z)."""
        goal = torch.as_tensor(goal_state, dtype=torch.float32, device=resolve_device(device))
        return goal.expand(self.T, self.goal_size).contiguous()


class StepOutput(NamedTuple):
    state: Any  # updated solver state
    action: torch.Tensor  # (A,) clipped first action
    planned_xs: torch.Tensor  # (T+1, S) simulated plan
    planned_us: torch.Tensor  # (T, A) clipped plan (pre-shift)
    planned_cost: torch.Tensor  # scalar plan cost


def shift_plan(us):
    """Receding-horizon shift along the time axis (-2): roll(-1), zero last."""
    out = torch.roll(us, -1, dims=-2)
    out[..., -1, :] = 0.0
    return out


def _clip_plan(solver: Solver, state):
    return state._replace(planned_us=solver.model.clip_action(state.planned_us))


def predict_action(solver: Solver, state, x, g_z, shift: bool = True) -> StepOutput:
    """Reference ``Agent.predict_action``: solve, clip the plan, simulate it
    for logging and, with ``shift=True``, roll it by one step with the last
    action zeroed."""
    state, u0, _aux = solver.solve(state, x, g_z)
    state = _clip_plan(solver, state)
    planned_us = state.planned_us
    planned_xs, planned_cost = simulate_trajectory(solver.model, x, planned_us, g_z)
    if shift:
        state = state._replace(planned_us=shift_plan(planned_us))
    action = solver.model.clip_action(u0)
    return StepOutput(state, action, planned_xs, planned_us, planned_cost)


def warm_start(solver: Solver, state, x, g_z, n_iter: int):
    """Run the solver n_iter times without shifting. Returns the warmed state
    and the stacked (n_iter, T, A) warm-start plans."""
    trajs = []
    for _ in range(n_iter):
        state, _u0, _aux = solver.solve(state, x, g_z)
        state = _clip_plan(solver, state)
        trajs.append(state.planned_us)
    return state, torch.stack(trajs) if trajs else None
