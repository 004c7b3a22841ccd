"""Port vs reference: models, env_step, rollouts and weight conversion.

The same numpy inputs (fixed seeds) go through the JAX package and its
PyTorch port on the CPU. Tolerance rtol 1e-5 (atol 1e-5 for outputs near
zero, where float32 cancellation leaves absolute, not relative, error): both
compute in float32 with the same operation order, but XLA's and PyTorch's
CPU sin/cos/log differ in the last bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import envs as jenvs
from benchmarking_mpc_solvers_tpu import models as jmodels
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch import envs as tenvs
from benchmarking_mpc_solvers_tpu_torch import models as tmodels

# the ops packages re-export a function named ``rollout`` over the module
jrollout = importlib.import_module("benchmarking_mpc_solvers_tpu.ops.rollout")
trollout = importlib.import_module("benchmarking_mpc_solvers_tpu_torch.ops.rollout")

NAMES = ["pendulum", "cartpole_swingup", "acrobot"]
RTOL, ATOL = 1e-5, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _inputs(model, n, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-scale, scale, (n, model.state_size)).astype(np.float32)
    u = rng.uniform(-3.0, 3.0, (n, model.action_size)).astype(np.float32)
    g = rng.uniform(-0.5, 0.5, (n, model.goal_size)).astype(np.float32)
    return x, u, g


@pytest.mark.parametrize("name", NAMES)
def test_dynamics_and_transform(name):
    jm, tm = jmodels.REGISTRY[name], tmodels.REGISTRY[name]
    x, u, _ = _inputs(jm, 256, 0)
    _close(tm.dynamics(torch.tensor(x), torch.tensor(u)), jax.vmap(jm.dynamics)(x, u))
    _close(tm.transform(torch.tensor(x), torch.tensor(u)), jax.vmap(jm.transform)(x, u))


@pytest.mark.parametrize("name", NAMES)
def test_cost_and_final_cost_with_overflow(name):
    """Random states plus states |x| >= 400, where cart-pole's (x/2.4)^10
    overflows and the ±1e30 clip of quad_cost decides the cost."""
    jm, tm = jmodels.REGISTRY[name], tmodels.REGISTRY[name]
    x, u, g = _inputs(jm, 128, 1)
    x[:16] = np.random.default_rng(2).uniform(400.0, 3000.0, (16, jm.state_size)) * np.sign(
        x[:16])
    xt, ut, gt = torch.tensor(x), torch.tensor(u), torch.tensor(g)
    want_c = np.asarray(jax.vmap(jm.cost)(x, u, g))
    want_f = np.asarray(jax.vmap(jm.final_cost)(x, g))
    _close(tm.cost(xt, ut, gt), want_c, atol=0)
    _close(tm.final_cost(xt, gt), want_f, atol=0)
    if name == "cartpole_swingup":
        assert np.all(np.abs(want_c[:16]) == 1e30)


@pytest.mark.parametrize("name", NAMES)
def test_env_step_with_injected_noise(name):
    jenv, tenv = jenvs.REGISTRY[name], tenvs.REGISTRY[name]
    noise_j = jenvs.NoiseConfig(actuation_std=0.3, sensor_std=0.05)
    noise_t = tenvs.NoiseConfig(actuation_std=0.3, sensor_std=0.05)
    x, u, _ = _inputs(jenv.model, 32, 3, scale=1.0)
    keys = jax.random.split(jax.random.PRNGKey(4), 32)
    want = jax.vmap(lambda k, x, u: jenvs.env_step(jenv, k, x, u, noise_j))(keys, x, u)
    # the reference's own draws, injected into the port
    splits = jax.vmap(jax.random.split)(keys)
    act = jax.vmap(lambda k: jax.random.normal(k, (1,), jnp.float32))(splits[:, 0])
    sense = jax.vmap(lambda k: jax.random.normal(k, (jenv.model.state_size,), jnp.float32))(
        splits[:, 1])
    got = tenvs.env_step(tenv, torch.tensor(x), torch.tensor(u), noise_t,
                         act_noise=torch.tensor(np.asarray(act)),
                         sense_noise=torch.tensor(np.asarray(sense)))
    for field in ("true_state", "observation", "action", "true_action", "cost"):
        _close(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))


@pytest.mark.parametrize("name", NAMES)
def test_rollout_and_simulate_trajectory(name):
    jm, tm = jmodels.REGISTRY[name], tmodels.REGISTRY[name]
    T, B = 10, 6
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-1, 1, (B, jm.state_size)).astype(np.float32)
    us = rng.uniform(-1.5, 1.5, (B, T, 1)).astype(np.float32)
    g_z = rng.uniform(-0.3, 0.3, (T, jm.goal_size)).astype(np.float32)
    xs_j, cs_j = jrollout.rollout_batch(jm, x0, us, g_z)
    xs_t, cs_t = trollout.rollout(tm, torch.tensor(x0), torch.tensor(us), torch.tensor(g_z))
    _close(xs_t, xs_j, rtol=1e-4, atol=1e-4)
    _close(cs_t, cs_j, rtol=1e-4, atol=1e-4)
    sx_j, sc_j = jax.vmap(lambda x, u: jrollout.simulate_trajectory(jm, x, u, g_z))(x0, us)
    sx_t, sc_t = trollout.simulate_trajectory(tm, torch.tensor(x0), torch.tensor(us),
                                              torch.tensor(g_z))
    _close(sx_t, sx_j, rtol=1e-4, atol=1e-4)
    _close(sc_t, sc_j, rtol=1e-4, atol=1e-4)
    tot_t, last_t = trollout.rollout_cost(tm, torch.tensor(x0), torch.tensor(us),
                                          torch.tensor(g_z))
    tot_j, last_j = jax.vmap(lambda x, u: jrollout.rollout_cost(jm, x, u, g_z))(x0, us)
    _close(tot_t, tot_j, rtol=1e-4, atol=1e-4)
    _close(last_t, last_j, rtol=1e-4, atol=1e-4)
    xn = (0.01 * rng.standard_normal((B, T, jm.state_size))).astype(np.float32)
    nt, _ = trollout.rollout_cost_noisy(tm, torch.tensor(x0), torch.tensor(us),
                                        torch.tensor(g_z), torch.tensor(xn))
    nj, _ = jax.vmap(lambda x, u, n: jrollout.rollout_cost_noisy(jm, x, u, g_z, n))(x0, us, xn)
    _close(nt, nj, rtol=1e-4, atol=1e-4)
    nx_t, nc_t = trollout.simulate_trajectory_noisy(tm, torch.tensor(x0), torch.tensor(us),
                                                    torch.tensor(g_z), torch.tensor(xn))
    nx_j, nc_j = jax.vmap(lambda x, u, n: jrollout.simulate_trajectory_noisy(jm, x, u, g_z, n))(
        x0, us, xn)
    _close(nx_t, nx_j, rtol=1e-4, atol=1e-4)
    _close(nc_t, nc_j, rtol=1e-4, atol=1e-4)


def test_best_plan_by_rollout_cost():
    jm, tm = jmodels.CartPoleSwingUpModel, tmodels.CartPoleSwingUpModel
    rng = np.random.default_rng(6)
    cands = rng.uniform(-1, 1, (7, 8, 1)).astype(np.float32)
    x = np.array([0.0, 0.0, np.pi, 0.0], np.float32)
    g_z = np.zeros((8, 5), np.float32)
    want = jrollout.best_plan_by_rollout_cost(jm, x, g_z, cands)
    got = trollout.best_plan_by_rollout_cost(tm, torch.tensor(x), torch.tensor(g_z),
                                             torch.tensor(cands))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_convert_weights_match_reference(name):
    """Both packages hold the same stage and terminal weights, and the
    kernels' nonzero terms are those of the reference's quad_cost."""
    jm = jmodels.REGISTRY[name]
    W, W_T = np.asarray(jm.state_cost.W), np.asarray(jm.terminal_cost.W)
    nz = convert.model_weights_from_numpy(W, W_T, name=name)
    np.testing.assert_array_equal(tmodels.REGISTRY[name].state_cost.W, W)
    np.testing.assert_array_equal(tmodels.REGISTRY[name].terminal_cost.W, W_T)
    assert nz == tmodels.REGISTRY[name].state_cost.nz
    with pytest.raises(ValueError):
        convert.model_weights_from_numpy(W + 1.0, W_T, name=name)
