"""Gymnasium interop: external simulators as plants and planning models.

Counterpart of ``benchmarking_mpc_solvers_tpu/envs/gym_wrapper.py``. The
wrappers run a gymnasium (or gymnasium MuJoCo) env as the true plant, with
the reference environment's history columns and a bounds check on each
action, and ``GymEnvModel`` plans with a live env (set its state, step
once). They are host-side Python around an external simulator, for the
per-scenario solver path. gymnasium (and mujoco) are optional imports;
actions may be given as tensors.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..device import to_numpy

try:
    import gymnasium

    HAVE_GYMNASIUM = True
except ImportError:  # pragma: no cover
    gymnasium = None
    HAVE_GYMNASIUM = False


class GymWrapperEnv:
    """Closed-loop plant backed by a gymnasium env.

    Records the same history columns as the reference environment
    (state / true_state / action / true_action / cost — ``envs/env.py:48-49``)
    and raises on actions outside the action space like the reference
    wrapper (``envs/gym_wrapper.py`` bounds check).
    """

    def __init__(self, env_or_id: Any, seed: Optional[int] = None):
        if not HAVE_GYMNASIUM:
            raise ImportError("gymnasium is not available")
        self.env = (
            gymnasium.make(env_or_id) if isinstance(env_or_id, str) else env_or_id
        )
        self.name = f"GymWrapper({self.env.spec.id if self.env.spec else 'env'})"
        self._seed = seed
        self.history: list = []
        self.state = None
        self.true_state = None

    def reset(self, state: Optional[np.ndarray] = None):
        obs, _info = self.env.reset(seed=self._seed)
        if state is not None:
            # poke the underlying simulator state (classic-control pattern,
            # reference gym_model.py:14-27)
            self.env.unwrapped.state = to_numpy(state).astype(np.float64)
            obs = np.asarray(self.env.unwrapped.state, dtype=np.float32)
        self.true_state = self.state = np.asarray(obs, np.float32)
        self.history = []
        return self.true_state

    def step(self, u):
        u = to_numpy(u)
        space = self.env.action_space
        if hasattr(space, "low") and (
            np.any(u < space.low) or np.any(u > space.high)
        ):
            raise ValueError(f"action {u} outside bounds [{space.low}, {space.high}]")
        obs, reward, terminated, truncated, _info = self.env.step(u)
        self.true_state = self.state = np.asarray(obs, np.float32)
        self.history.append(
            {
                "state": self.state,
                "true_state": self.true_state,
                "action": u,
                "true_action": u,
                "cost": -float(reward),
            }
        )
        return self.true_state, float(reward), bool(terminated or truncated), {}

    def render(self):
        return self.env.render()

    def close(self):
        self.env.close()


class MujocoWrapperEnv(GymWrapperEnv):
    """Closed-loop plant backed by a gymnasium MuJoCo env — capability parity
    with the reference's mujoco-py wrapper (``envs/mujym_wrapper.py:7-45``),
    which tracked the full simulator state via ``env.sim.get_state()`` in its
    history rather than the observation.

    The modern MuJoCo bindings expose the physics state as
    ``unwrapped.data.qpos / qvel``; ``true_state`` here is their
    concatenation (observations may hide coordinates, e.g. x of a hopper),
    while ``state`` remains the observation — mirroring the reference's
    state/observation split. Raises on out-of-bounds actions like the
    reference (``mujym_wrapper.py`` bounds check).
    """

    def __init__(self, env_or_id: Any, seed: Optional[int] = None):
        super().__init__(env_or_id, seed=seed)
        data = getattr(self.env.unwrapped, "data", None)
        if data is None or not hasattr(data, "qpos"):
            raise TypeError(
                f"{self.env} does not expose MuJoCo physics state "
                "(unwrapped.data.qpos); use GymWrapperEnv instead"
            )
        self.name = f"MujocoWrapper({self.env.spec.id if self.env.spec else 'env'})"

    def _physics_state(self) -> np.ndarray:
        d = self.env.unwrapped.data
        return np.concatenate(
            [np.asarray(d.qpos).ravel(), np.asarray(d.qvel).ravel()]
        ).astype(np.float32)

    def reset(self, state: Optional[np.ndarray] = None):
        obs, _info = self.env.reset(seed=self._seed)
        if state is not None:
            nq = self.env.unwrapped.model.nq
            state = to_numpy(state).astype(np.float64)
            self.env.unwrapped.set_state(state[:nq], state[nq:])
        self.state = np.asarray(obs, np.float32)
        self.true_state = self._physics_state()
        self.history = []
        return self.true_state

    def step(self, u):
        u = to_numpy(u)
        space = self.env.action_space
        if np.any(u < space.low) or np.any(u > space.high):
            raise ValueError(f"action {u} outside bounds [{space.low}, {space.high}]")
        obs, reward, terminated, truncated, _info = self.env.step(u)
        self.state = np.asarray(obs, np.float32)
        self.true_state = self._physics_state()
        self.history.append(
            {
                "state": self.state,
                "true_state": self.true_state,
                "action": u,
                "true_action": u,
                "cost": -float(reward),
            }
        )
        return self.true_state, float(reward), bool(terminated or truncated), {}


class GymEnvModel:
    """Planning model backed by a live gymnasium env (reference
    ``models/gym_model.py``): prediction = set simulator state, step once.

    Host-side and stateful — usable only with non-jitted planning loops;
    ``batch_predict`` loops (the reference raised NotImplementedError).
    """

    def __init__(self, env_or_id: Any):
        if not HAVE_GYMNASIUM:
            raise ImportError("gymnasium is not available")
        self.env = (
            gymnasium.make(env_or_id) if isinstance(env_or_id, str) else env_or_id
        )
        self.env.reset()
        self.name = "GymEnvModel"
        self.last_reward = 0.0
        space = self.env.action_space
        self.bounds_low = np.asarray(getattr(space, "low", -np.inf))
        self.bounds_high = np.asarray(getattr(space, "high", np.inf))
        obs_space = self.env.observation_space
        self.state_size = int(np.prod(obs_space.shape))
        self.action_size = int(np.prod(space.shape)) if space.shape else 1

    def predict(self, state, action):
        self.env.unwrapped.state = to_numpy(state).astype(np.float64)
        obs, reward, _t, _tr, _info = self.env.step(to_numpy(action))
        self.last_reward = float(reward)
        return np.asarray(self.env.unwrapped.state, np.float32)

    def batch_predict(self, states, actions):
        return np.stack([self.predict(s, a) for s, a in zip(states, actions)])

    def get_reward(self):
        return self.last_reward
