"""Port vs reference: CEM's kernel, its scalar tier and its two-stage tier.

The kernel's plain version draws the reference kernel's interpret-mode
noise stream exactly, so it is compared with the JAX kernel run in
interpret mode. The tiers that draw with threefry in the reference get the
reference's draws injected. Tolerance rtol 2e-4 / atol 2e-5, the reference
kernel test's own (tests/test_fused.py): float32 rollouts in both, rounded
at other places. Where the two-stage statistics std = sqrt(max(m2 − m1², 0))
meet elites that nearly coincide, atol is 1e-3: XLA's CPU code contracts
m2 − m1·m1 into one fused multiply-add while the port rounds m1·m1 first,
and the square root turns that half-ulp difference into up to
sqrt(2^-24)·|m1| ≈ 2.4e-4·|m1| in std, which the next iteration's samples
carry (|u| ≤ 2 here). The elite selection is discrete: one swapped elite
moves a plan entry by (1-α)·|u_i - u_j|/n_elite, O(0.1) here, far above
either tolerance, so agreement means the same elites were chosen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import models as jmodels
from benchmarking_mpc_solvers_tpu.ops import fused_cem as jfused_cem
from benchmarking_mpc_solvers_tpu.solvers import CEM as JCEM
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch import models as tmodels
from benchmarking_mpc_solvers_tpu_torch.ops import fused_cem as tfused_cem
from benchmarking_mpc_solvers_tpu_torch.solvers import CEM as TCEM

RTOL, ATOL = 2e-4, 2e-5
STD_ATOL = 1e-3  # after sqrt(m2 − m1²) of nearly equal elites, see above


def _inputs(model, T, B, seed):
    rng = np.random.default_rng(seed)
    g_z = rng.uniform(-0.2, 0.2, (T, model.goal_size)).astype(np.float32)
    x0_tm = rng.uniform(-1, 1, (model.state_size, B)).astype(np.float32)
    plan_tm = rng.uniform(-0.5, 0.5, (T, B)).astype(np.float32)
    return plan_tm, x0_tm, g_z


@pytest.mark.parametrize("name,B,seed", [
    ("pendulum", 16, 11),                  # one tile, mostly padding
    ("cartpole_swingup", 2000, 2**31 - 2),  # ragged second tile, seed wrap
    ("acrobot", 1024, -(2**31) + 5),        # exactly one tile
])
def test_fused_cem_step_plain_matches_reference_kernel(name, B, seed):
    T, K, n_elite, max_iter, alpha, std0, lanes = 6, 8, 3, 3, 0.2, 0.9, 128
    plan_tm, x0_tm, g_z = _inputs(jmodels.REGISTRY[name], T, B, 2)
    want = jfused_cem.fused_cem_step(jmodels.REGISTRY[name], K, n_elite, max_iter, alpha, std0,
                                     lanes, jnp.asarray(plan_tm), jnp.asarray(x0_tm),
                                     jnp.asarray(g_z), seed)
    got = tfused_cem.fused_cem_step(tmodels.REGISTRY[name], K, n_elite, max_iter, alpha, std0,
                                    lanes, torch.tensor(plan_tm), torch.tensor(x0_tm),
                                    torch.tensor(g_z), seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=STD_ATOL)


def test_fused_cem_step_marks_every_tie():
    """With std0 = 0 every sample is the plan itself, so all K costs tie:
    the first masked-min round marks all K, each weighted 1/K, and the plan
    stays as it was."""
    model = tmodels.PendulumModel
    T, B, K = 4, 3, 6
    plan = torch.linspace(-0.5, 0.5, T * B).reshape(T, B)
    out, masks = tfused_cem.fused_cem_step_reference(model, K, 2, 2, 0.2, 0.0, 128, plan,
                                                     torch.zeros((2, B)), torch.zeros((T, 3)),
                                                     5, return_masks=True)
    assert masks.shape == (2, K, B)
    assert (masks == 1.0).all()
    torch.testing.assert_close(out, plan)


def _scalar_noise(key, K, T, A, n):
    """The reference scalar solve's per-iteration draws (solvers/cem.py:61-64)."""
    out = []
    for _ in range(n):
        k_sample, key = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k_sample, (K, T, A), jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("name,epsilon", [("pendulum", 1e-2), ("cartpole_swingup", 0.6)])
def test_solve_matches_reference_with_injected_noise(name, epsilon):
    """epsilon 0.6 makes the ε exit fire after 3 of 5 iterations on
    cart-pole (every std entry is then below 0.53)."""
    kw = dict(T=8, K=24, n_elite=4, max_iter=5, epsilon=epsilon)
    js = JCEM(model=jmodels.REGISTRY[name], **kw)
    ts = TCEM(model=tmodels.REGISTRY[name], **kw)
    st = js.init_state(jax.random.PRNGKey(3))
    plan = np.random.default_rng(0).uniform(-0.5, 0.5, (8, 1)).astype(np.float32)
    st = st._replace(planned_us=jnp.asarray(plan))
    x = np.random.default_rng(1).uniform(-1, 1, js.model.state_size).astype(np.float32)
    g_z = np.zeros((8, js.model.goal_size), np.float32)
    new_j, u0_j, _ = js.solve(st, jnp.asarray(x), jnp.asarray(g_z))
    noise = _scalar_noise(st.key, 24, 8, 1, 5)
    new_t, u0_t, _ = ts.solve(convert.cem_state_from_numpy(plan, device="cpu"), torch.tensor(x),
                              torch.tensor(g_z), noise=torch.tensor(noise))
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("epsilon", [1e-2, 0.7])
def test_solve_batch_matches_reference_with_injected_noise(epsilon):
    """epsilon 0.7 stops one scenario after 2 iterations and three after 3
    of 4 (``done`` masking); no std lies within 0.02 of it."""
    kw = dict(T=10, K=16, n_elite=4, max_iter=4, epsilon=epsilon)
    js = JCEM(model=jmodels.CartPoleSwingUpModel, **kw)
    ts = TCEM(model=tmodels.CartPoleSwingUpModel, **kw)
    B, K, T = 6, 16, 10
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    xs = (np.tile([0.0, 0.0, np.pi, 0.0], (B, 1))
          + 0.3 * np.random.default_rng(1).standard_normal((B, 4))).astype(np.float32)
    plans = np.random.default_rng(2).uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    g_z = np.zeros((T, 5), np.float32)
    st = js.init_state_batch(keys)._replace(planned_us=jnp.asarray(plans))
    new_j, u0_j, _ = js.solve_batch(st, jnp.asarray(xs), jnp.asarray(g_z))

    noise, k = [], st.key
    for _ in range(4):  # the reference's per-iteration, per-scenario draws
        splits = jax.vmap(jax.random.split)(k)
        k_sample, k = splits[:, 0], splits[:, 1]
        noise.append(np.asarray(jax.vmap(
            lambda kk: jax.random.normal(kk, (K, T), jnp.float32))(k_sample)))  # (B, K, T)
    tst = convert.cem_state_from_numpy(plans, device="cpu")
    for use_fused in (True, False):
        new_t, u0_t, _ = ts.solve_batch(tst, torch.tensor(xs), torch.tensor(g_z),
                                        use_fused=use_fused, noise=torch.tensor(np.stack(noise)))
        np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                                   rtol=RTOL, atol=STD_ATOL)
        np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=RTOL, atol=STD_ATOL)


def test_kernel_ok_and_solve_batch_tm():
    ts = TCEM(model=tmodels.CartPoleSwingUpModel, T=5, K=8, n_elite=2, max_iter=2)
    assert ts.kernel_ok()
    assert not TCEM(model=tmodels.CartPoleSwingUpModel, T=5, model_noise_std=0.1).kernel_ok()
    plan = torch.zeros((5, 16))
    xs = torch.tensor(np.tile([[0.0], [0.0], [np.pi], [0.0]], (1, 16)), dtype=torch.float32)
    before = tfused_cem.fused_cem_step.launches
    new, u0 = ts.solve_batch_tm(plan, xs, torch.zeros((5, 5)), 3)
    assert tfused_cem.fused_cem_step.launches == before  # CPU: the plain version
    assert new.shape == (5, 16) and u0.shape == (16,)
    torch.testing.assert_close(u0, new[0])
