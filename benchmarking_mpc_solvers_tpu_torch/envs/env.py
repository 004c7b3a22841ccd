"""Closed-loop environments (plant + noise + termination).

Counterpart of ``benchmarking_mpc_solvers_tpu/envs/env.py``. An Env is a
declarative bundle (model + done predicate + default start state) and
``env_step`` a pure function over a batch of plant states.

Noise semantics:
- actuation noise: u_true = u + N(0, actuation_std) before the dynamics;
  the noisy u is recorded as "action", the commanded u as "true_action";
- sensor noise: observation = true_state + N(0, sensor_std);
- cost is the model stage cost at (true_state, noisy u) with zero goal.

Noise comes from an explicit ``torch.Generator`` or is passed in as
pre-drawn standard normals (tests inject the same draws into both packages).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..device import resolve_device
from ..models import AcrobotModel, CartPoleSwingUpModel, PendulumModel
from ..models.base import Model


class NoiseConfig(NamedTuple):
    """Gaussian noise std-devs; 0 disables a source."""

    actuation_std: float = 0.0
    sensor_std: float = 0.0
    model_sensor_std: float = 0.0  # planning-model noise


class EnvStep(NamedTuple):
    true_state: torch.Tensor  # plant state after the step
    observation: torch.Tensor  # true_state (+ sensor noise)
    action: torch.Tensor  # actuated (noisy) action
    true_action: torch.Tensor  # commanded action
    cost: torch.Tensor  # stage cost at (prev true_state, actuated action)
    done: torch.Tensor  # termination predicate of the new state


@dataclasses.dataclass(frozen=True, eq=False)
class Env:
    name: str
    model: Model
    done_fn: Callable[[torch.Tensor], torch.Tensor]  # (..., S) -> (...) bool
    default_start: tuple  # canonical benchmark start state

    def start_state(self, device="cuda") -> torch.Tensor:
        return torch.tensor(self.default_start, dtype=torch.float32,
                            device=resolve_device(device))

    def reset(self, generator: Optional[torch.Generator] = None, state=None,
              device="cuda") -> torch.Tensor:
        """A start state (S,) on ``device``: ``state`` as float32, else drawn
        uniformly from ``generator``. Keeps the reference's quirk of taking
        the range from the *action* bounds, [bounds_low[0], bounds_high[0]]
        in every coordinate."""
        device = resolve_device(device)
        if state is not None:
            return torch.as_tensor(state, dtype=torch.float32, device=device)
        lo, hi = float(self.model.bounds_low[0]), float(self.model.bounds_high[0])
        u = torch.rand((self.model.state_size,), generator=generator, device=device)
        return lo + (hi - lo) * u


def env_step(
    env: Env,
    true_state,
    u,
    noise: NoiseConfig,
    generator: Optional[torch.Generator] = None,
    act_noise=None,
    sense_noise=None,
) -> EnvStep:
    """One plant step for (..., S) states and (..., A) actions: actuation
    noise -> dynamics -> sensor noise -> cost. ``act_noise`` / ``sense_noise``
    are optional standard-normal draws shaped like ``u`` / the state; a
    noise source with a nonzero std and no draw takes it from ``generator``."""
    model = env.model
    true_u = u
    if noise.actuation_std:
        if act_noise is None:
            act_noise = torch.randn(u.shape, generator=generator, device=u.device)
        u = u + noise.actuation_std * act_noise
    g0 = torch.zeros((model.goal_size,), dtype=torch.float32, device=u.device)
    next_state, cost = model.step_and_cost(true_state, u, g0)
    obs = next_state
    if noise.sensor_std:
        if sense_noise is None:
            sense_noise = torch.randn(
                next_state.shape, generator=generator, device=next_state.device
            )
        obs = next_state + noise.sensor_std * sense_noise
    return EnvStep(next_state, obs, u, true_u, cost, env.done_fn(next_state))


# --- concrete environments ---------------------------------------------------

def _pendulum_done(x):
    # the reference pendulum never terminates
    return torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)


def _cartpole_done(x):
    # |cart position| > 2.4
    return torch.abs(x[..., 0]) > 2.4


def _acrobot_done(x):
    # tip height -cos(th1) - cos(th1+th2) > 1
    return (-torch.cos(x[..., 0]) - torch.cos(x[..., 1] + x[..., 0])) > 1.0


PendulumEnv = Env(
    name="PendulumEnvironment",
    model=PendulumModel,
    done_fn=_pendulum_done,
    default_start=(math.pi, 0.0),
)

CartPoleSwingUpEnv = Env(
    name="CartpoleSwingupEnvironment",
    model=CartPoleSwingUpModel,
    done_fn=_cartpole_done,
    default_start=(0.0, 0.0, math.pi, 0.0),
)

AcrobotEnv = Env(
    name="AcrobotEnvironment",
    model=AcrobotModel,
    done_fn=_acrobot_done,
    default_start=(0.0, 0.0, 0.0, 0.0),
)

REGISTRY = {
    "pendulum": PendulumEnv,
    "cartpole_swingup": CartPoleSwingUpEnv,
    "acrobot": AcrobotEnv,
}
