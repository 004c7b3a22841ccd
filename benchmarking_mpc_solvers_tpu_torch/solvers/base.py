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
from ..ops.fused_linesearch import linesearch_applicable
from ..ops.riccati_backward import pallas_riccati_applicable
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

    def has_kernel_stages(self) -> bool:
        """Whether ``solve_batch(use_fused=True)`` runs stages as kernels
        for this model, as the reference's vmapped ``solve`` reaches
        kernels on the TPU; none do unless a solver says so."""
        return False

    def _init_plan(self, lead: tuple, init_std: float, generator: torch.Generator,
                   device, noise=None):
        """Initial plans ``lead + (T, A)``: zeros when ``init_std == 0``
        (deterministic), else init_std·N(0, 1) clipped to the box, the
        symmetric-equilibrium break SQP and QPMPC opt into. ``noise``, a
        standard-normal tensor of that shape, replaces the draw."""
        shape = tuple(lead) + (self.T, self.model.action_size)
        if init_std <= 0.0:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
        if noise.shape != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {shape}")
        return self.model.clip_action(init_std * noise)

    @property
    def goal_size(self) -> int:
        return self.model.goal_size

    def goal_traj(self, goal_state, device="cuda"):
        """Repeat a goal state over the horizon: (T, Z)."""
        goal = torch.as_tensor(goal_state, dtype=torch.float32, device=resolve_device(device))
        return goal.expand(self.T, self.goal_size).contiguous()


def fused_tier_applicable(model: Model) -> bool:
    """Whether the derivative, Riccati and line-search wrappers take the
    model: a scalar action, ``quad_cost`` costs and a state the Riccati
    kernel holds."""
    return (linesearch_applicable(model)
            and pallas_riccati_applicable(model.state_size, model.action_size))


def check_fused_tier(name: str, model: Model, g_z) -> None:
    """Gate of the trajectory solvers' ``use_fused=True``: the model must be
    ``fused_tier_applicable`` and the goal one trajectory (T, Z) for the
    whole batch. Anything else is refused here, on any device, so that a
    fused solve never runs plain stages unasked."""
    if not fused_tier_applicable(model):
        raise NotImplementedError(
            f"{name}(use_fused=True) needs action_size == 1, quad_cost costs and a state "
            f"size the Riccati kernel holds; pass use_fused=False")
    if g_z.ndim != 2:
        raise NotImplementedError(
            f"{name}(use_fused=True) needs one goal trajectory (T, Z) shared by the batch, "
            f"got g_z of shape {tuple(g_z.shape)}; pass use_fused=False")


def model_noise_draws(solver, generator: torch.Generator, B: int, device, noise=None):
    """Planning-model noise of a batched iLQR or SQP solve: i -> iteration
    i's standard normals (B, T, S) for the nominal rollout and
    (B, n_alphas, T, S) for the line-search candidates, drawn from
    ``generator``, or None when the solver has no model noise. ``noise``, a
    pair of such draws with a leading ``max_iter`` axis, replaces the draws
    (row i for iteration i, as the reference splits its key once an
    iteration)."""
    S = solver.model.state_size
    shapes = ((B, solver.T, S), (B, solver.n_alphas, solver.T, S))
    if solver.model_noise_std <= 0.0:
        if noise is not None:
            raise ValueError("noise given to a solver without model noise")
        return lambda i: None
    if noise is None:
        return lambda i: tuple(torch.randn(s, generator=generator, device=device)
                               for s in shapes)
    noise = tuple(torch.as_tensor(n, dtype=torch.float32, device=device) for n in noise)
    for n, s in zip(noise, shapes):
        if tuple(n.shape) != (solver.max_iter,) + s:
            raise ValueError(f"noise has shape {tuple(n.shape)}, expected "
                             f"{(solver.max_iter,) + s}")
    return lambda i: (noise[0][i], noise[1][i])


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
