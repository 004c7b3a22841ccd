"""Port vs reference: SQP under planning-model noise.

The reference's noisy solve (``solvers/sqp.py:_solve_noisy``) splits its
key three ways on every iteration: one part for the nominal rollout's
(T, S) state noise, one for its n_alphas line-search candidates'
(n_alphas, T, S). The port's ``solve_batch`` takes those draws replayed
(``noise=``) and is held against the vmapped reference solve on the scan
path (``pallas_backward=False``), with ``use_fused`` True (the derivative
and Riccati kernels' plain versions on the CPU; the noisy candidates roll
out plain, as in the reference) and False.

Tolerance 2e-3 on the solves, that of ``tests/test_torch_sqp.py``: XLA's CPU
code fuses multiply-adds where the port rounds each operation, and SQP's
accept test and argmin over α can then fall either way at a converged
scenario.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.solvers import SQP as JSQP
from benchmarking_mpc_solvers_tpu.solvers.sqp import SQPState as JSQPState
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.solvers import SQP as TSQP
from test_torch_ilqr_variants import replayed_draws

TOL = 2e-3
T, B, MAX_ITER, STD = 8, 5, 3, 0.05


def _problem(name, seed=0):
    env = JENVS[name]
    rng = np.random.default_rng(seed)
    S = env.model.state_size
    start = np.array([0.1, 0.0, 0.2, 0.0], np.float32) if name == "acrobot" else np.asarray(
        env.start_state)
    x0s = (np.tile(start, (B, 1)) + 0.05 * rng.standard_normal((B, S))).astype(np.float32)
    plans = (0.3 * rng.standard_normal((B, T, 1))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed + 7), B)
    return env, x0s, plans, keys, np.zeros((T, env.model.goal_size), np.float32)


@pytest.mark.parametrize("name", ["acrobot", "pendulum"])
def test_noisy_solve_batch_matches_reference_on_replayed_draws(name):
    env, x0s, plans, keys, g_z = _problem(name)
    js = JSQP(model=env.model, T=T, max_iter=MAX_ITER, model_noise_std=STD,
              pallas_backward=False)
    new_j, u0_j, _ = jax.jit(jax.vmap(lambda p, k, x: js.solve(JSQPState(p, k), x,
                                                               jnp.asarray(g_z))))(
        jnp.asarray(plans), keys, jnp.asarray(x0s))
    assert np.abs(np.asarray(new_j.planned_us) - np.clip(plans, -2, 2)).max() > 0.05
    noise = replayed_draws(js, keys)
    ts = TSQP(model=TENVS[name].model, T=T, max_iter=MAX_ITER, model_noise_std=STD)
    for fused in (True, False):
        st = convert.sqp_state_from_numpy(plans, device="cpu")
        new_t, u0_t, _ = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z),
                                        use_fused=fused, noise=noise)
        np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                                   rtol=TOL, atol=TOL, err_msg=f"use_fused={fused}")
        np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=TOL, atol=TOL)


def test_noise_changes_the_solve_and_is_drawn_from_the_generator():
    """Without injected draws the noise comes from the state's generator:
    the same seed gives the same plans, another seed others, and both
    differ from the clean solve; the scalar ``solve`` is the batch of one."""
    env, x0s, plans, _, g_z = _problem("acrobot", seed=3)
    tm = TENVS["acrobot"].model
    noisy = TSQP(model=tm, T=T, max_iter=MAX_ITER, model_noise_std=STD)
    clean = TSQP(model=tm, T=T, max_iter=MAX_ITER)

    def solve(solver, seed):
        st = convert.sqp_state_from_numpy(plans, torch.Generator().manual_seed(seed), "cpu")
        return solver.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z))[0].planned_us

    a, b = solve(noisy, 0), solve(noisy, 0)
    assert torch.equal(a, b)
    assert not torch.equal(a, solve(noisy, 1)) and not torch.equal(a, solve(clean, 0))
    st = convert.sqp_state_from_numpy(plans[0], torch.Generator().manual_seed(0), "cpu")
    one, u0, _ = noisy.solve(st, torch.tensor(x0s[0]), torch.tensor(g_z))
    assert one.planned_us.shape == (T, 1) and u0.shape == (1,)
    assert bool(one.planned_us.abs().max() <= 1.0)
