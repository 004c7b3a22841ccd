"""The closed loop of the benchmark's episodes, in plain PyTorch.

Each MPC step: the solver plans from the observation, the plan is clipped
to the action bounds and carried to the next step unshifted, the plan's
first action drives the plant from its true state, and the observation is
the new true state plus sensor noise. The stage cost is taken at the true
state and the action before the plant moves. The plant's sensor noise is
drawn from a CUDA generator the benchmark seeds, one (B, S) draw a step
after whatever the solver's tier draws at the start (``pre_draws``), and
the reference keeps its own scenarios' rows.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Episodes(NamedTuple):
    actions: torch.Tensor  # (n, steps) float32
    states: torch.Tensor  # (n, steps + 1, S) true states from x0
    costs: torch.Tensor  # (n, steps) stage costs


class PlantNoise:
    """Replays the plant generator's draws: the tier's draws at the start,
    then one (B, S) standard-normal draw a step, of which rows ``idx``."""

    def __init__(self, seed: int, B: int, S: int, idx, device, pre_draws: Callable = None):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.shape, self.idx, self.device = (B, S), idx, device
        self.start = pre_draws(self.gen) if pre_draws is not None else None

    def step(self):
        return torch.randn(self.shape, generator=self.gen, device=self.device)[self.idx]


def closed_loop(plant, x0s, n_steps: int, solve: Callable, init_plan, sensor_std: float,
                noise: PlantNoise, dt=torch.float32) -> Episodes:
    """n scenarios; ``solve(step, plan, obs) -> (plan, first actions)``,
    both unclipped."""
    x_true = obs = x0s.to(dt)
    plan = init_plan
    acts, states, costs = [], [x_true], []
    for step in range(n_steps):
        plan, u0 = solve(step, plan, obs)
        plan = torch.clamp(plan, plant.LO, plant.HI)
        u = torch.clamp(u0, plant.LO, plant.HI)[:, None]
        cost = plant.stage_cost(x_true, u)
        x_true = plant.dynamics(x_true, u)
        obs = x_true
        if sensor_std:
            obs = x_true + sensor_std * noise.step().to(dt)
        acts.append(u[:, 0])
        states.append(x_true)
        costs.append(cost)
    f32 = torch.float32
    return Episodes(torch.stack(acts, 1).to(f32), torch.stack(states, 1).to(f32),
                    torch.stack(costs, 1).to(f32))
