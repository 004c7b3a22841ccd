"""Port vs reference: rendering, the gymnasium wrappers and ``Env.reset``.

- ``render_state`` gives the reference's pixels exactly, for the three
  plants, from tensors; ``render_episode`` writes its frames as a GIF.
- ``GymWrapperEnv``, ``MujocoWrapperEnv`` and ``GymEnvModel`` on the same
  gymnasium env and seed give the reference's states, histories,
  predictions and rewards exactly, actions given as tensors.
- ``Env.reset`` draws inside the action bounds (the reference's quirk),
  repeats under one generator and returns a given state as float32.
"""

import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import gym_wrapper as jgym
from benchmarking_mpc_solvers_tpu.envs import render as jrender
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.envs import gym_wrapper as tgym
from benchmarking_mpc_solvers_tpu_torch.envs import render as trender

STATES = {
    "pendulum": ([2.5, 0.3], 1.2),
    "cartpole_swingup": ([0.7, 0.1, 2.0, -0.4], None),
    "acrobot": ([0.9, -1.3, 0.2, 0.0], None),
}


@pytest.mark.parametrize("name", sorted(STATES))
def test_render_state_pixels_match_reference(name):
    state, u = STATES[name]
    want = jrender.render_state(name, np.asarray(state, np.float32), u)
    got = trender.render_state(name, torch.tensor(state), u)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)


def test_render_episode_writes_its_frames(tmp_path):
    from PIL import Image

    states = torch.tensor([[3.0, 0.0], [2.5, 0.5], [1.8, 1.0], [1.0, 1.2], [0.3, 0.8]])
    actions = torch.tensor([[0.5], [-1.0], [2.0], [0.0], [1.0]])
    path = tmp_path / "ep.gif"
    frames = trender.render_episode("PendulumEnvironment", states, actions, path=str(path),
                                    stride=2)
    want = jrender.render_episode("PendulumEnvironment", states.numpy(), actions.numpy(),
                                  stride=2)
    assert len(frames) == 3
    for g, w in zip(frames, want):
        np.testing.assert_array_equal(g, w)
    with Image.open(path) as gif:
        assert gif.n_frames == 3 and gif.size == frames[0].shape[1::-1]


def _drive(wrapper, actions):
    out = [wrapper.reset()]
    for u in actions:
        out.append(wrapper.step(u))
    return out


@pytest.mark.parametrize("kind,env_id", [("gym", "Pendulum-v1"),
                                         ("mujoco", "InvertedPendulum-v5")])
def test_gym_wrappers_match_reference(kind, env_id):
    if not tgym.HAVE_GYMNASIUM:
        pytest.skip("gymnasium is not installed")
    cls = {"gym": (tgym.GymWrapperEnv, jgym.GymWrapperEnv),
           "mujoco": (tgym.MujocoWrapperEnv, jgym.MujocoWrapperEnv)}[kind]
    mine, theirs = cls[0](env_id, seed=3), cls[1](env_id, seed=3)
    acts = np.random.default_rng(0).uniform(-1.5, 1.5, (6, 1)).astype(np.float32)
    got = _drive(mine, [torch.tensor(a) for a in acts])
    want = _drive(theirs, acts)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:] == w[1:]
    assert mine.name == theirs.name and len(mine.history) == len(theirs.history) == 6
    for g, w in zip(mine.history, theirs.history):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
    np.testing.assert_array_equal(mine.state, theirs.state)
    with pytest.raises(ValueError, match="outside bounds"):
        mine.step(torch.tensor([9.0]))
    if kind == "gym":  # a given state is poked into the simulator
        np.testing.assert_array_equal(mine.reset(torch.tensor([0.5, -0.2])),
                                      theirs.reset(np.array([0.5, -0.2])))
    mine.close()
    theirs.close()


def test_gym_env_model_matches_reference():
    if not tgym.HAVE_GYMNASIUM:
        pytest.skip("gymnasium is not installed")
    mine, theirs = tgym.GymEnvModel("Pendulum-v1"), jgym.GymEnvModel("Pendulum-v1")
    assert (mine.state_size, mine.action_size) == (theirs.state_size, theirs.action_size)
    np.testing.assert_array_equal(mine.bounds_low, theirs.bounds_low)
    np.testing.assert_array_equal(mine.bounds_high, theirs.bounds_high)
    x, u = np.array([0.4, -1.0], np.float32), np.array([0.7], np.float32)
    np.testing.assert_array_equal(mine.predict(torch.tensor(x), torch.tensor(u)),
                                  theirs.predict(x, u))
    assert mine.get_reward() == theirs.get_reward()
    xs = np.array([[0.4, -1.0], [2.0, 0.5], [-1.0, 3.0]], np.float32)
    us = np.array([[0.7], [-2.0], [1.5]], np.float32)
    np.testing.assert_array_equal(mine.batch_predict(torch.tensor(xs), torch.tensor(us)),
                                  theirs.batch_predict(xs, us))


@pytest.mark.parametrize("name", sorted(TENVS))
def test_env_reset(name):
    env = TENVS[name]
    lo, hi = env.model.bounds_low[0], env.model.bounds_high[0]
    draws = [env.reset(torch.Generator().manual_seed(5), device="cpu") for _ in range(2)]
    assert draws[0].shape == (env.model.state_size,) and draws[0].dtype == torch.float32
    assert bool(((draws[0] >= lo) & (draws[0] <= hi)).all())
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    other = env.reset(torch.Generator().manual_seed(6), device="cpu")
    assert not torch.equal(other, draws[0])
    many = torch.stack([env.reset(g, device="cpu")
                        for g in [torch.Generator().manual_seed(i) for i in range(200)]])
    assert float(many.min()) < lo + 0.1 * (hi - lo) and float(many.max()) > hi - 0.1 * (hi - lo)
    given = np.arange(env.model.state_size, dtype=np.float64)
    out = env.reset(state=given, device="cpu")
    assert out.dtype == torch.float32 and torch.equal(out, torch.tensor(given,
                                                                        dtype=torch.float32))
