"""Port vs reference: MPPI's per-scenario and batched tiers.

The reference draws its perturbations with threefry; the test draws the
same values from the reference's keys and injects them into the port, so
both solve the same problem. Tolerance rtol/atol 1e-4 (the reference's own
for its fused-vs-scan equivalence, tests/test_equivalence.py): float32
rollout costs summed in another order move the softmax weights slightly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import models as jmodels
from benchmarking_mpc_solvers_tpu.solvers import MPPI as JMPPI
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch import models as tmodels
from benchmarking_mpc_solvers_tpu_torch.solvers import MPPI as TMPPI

TOL = 1e-4


def _solvers(name, **kw):
    return (JMPPI(model=jmodels.REGISTRY[name], **kw),
            TMPPI(model=tmodels.REGISTRY[name], **kw))


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup"])
def test_solve_matches_reference_with_injected_delta(name):
    js, ts = _solvers(name, T=8, K=16, std=0.8, lam=0.5)
    st = js.init_state(jax.random.PRNGKey(3))
    st = st._replace(planned_us=jnp.float32(
        np.random.default_rng(0).uniform(-0.5, 0.5, (8, 1))))
    x = np.random.default_rng(1).uniform(-1, 1, js.model.state_size).astype(np.float32)
    g_z = jnp.zeros((8, js.model.goal_size), jnp.float32)
    new_j, u0_j, aux_j = js.solve(st, jnp.asarray(x), g_z)

    k_delta, _ = jax.random.split(st.key)
    delta = 0.8 * jax.random.normal(k_delta, (16, 8, 1), jnp.float32)
    tst = convert.mppi_state_from_numpy(np.asarray(st.planned_us), device="cpu")
    new_t, u0_t, aux_t = ts.solve(tst, torch.tensor(x), torch.zeros((8, js.model.goal_size)),
                                  delta_u=torch.tensor(np.asarray(delta)))
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux_t["sample_costs"].numpy(), np.asarray(aux_j["sample_costs"]),
                               rtol=TOL, atol=TOL)


def test_solve_sample_once_reuses_init_delta():
    """resample=False: the state's fixed delta_u is used, not a fresh draw."""
    _, ts = _solvers("pendulum", T=6, K=8, resample=False)
    st = ts.init_state(torch.Generator().manual_seed(0), device="cpu")
    x = torch.tensor([np.pi, 0.0], dtype=torch.float32)
    g_z = torch.zeros((6, 3))
    a, _, _ = ts.solve(st, x, g_z)
    b, _, _ = ts.solve(st, x, g_z)
    torch.testing.assert_close(a.planned_us, b.planned_us, rtol=0, atol=0)


@pytest.mark.parametrize("use_fused", [True, False])
def test_solve_batch_matches_reference_with_injected_delta(use_fused):
    js, ts = _solvers("cartpole_swingup", T=10, K=8, std=1.0, lam=1.0)
    B, K, T = 6, 8, 10
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    xs = (np.tile([0.0, 0.0, np.pi, 0.0], (B, 1))
          + 0.05 * np.random.default_rng(1).standard_normal((B, 4))).astype(np.float32)
    g_z = jnp.zeros((T, 5), jnp.float32)
    st = js.init_state_batch(keys)
    new_j, u0_j, _ = js.solve_batch(st, jnp.asarray(xs), g_z, use_fused=use_fused)

    k_delta = jax.vmap(jax.random.split)(st.key)[:, 0]
    if use_fused:  # the reference's (K, T) draw, laid out time-major
        delta_tm = jax.vmap(lambda k: jax.random.normal(k, (K, T), jnp.float32).T,
                            out_axes=1)(k_delta).reshape(T, B * K)
    else:  # its (K, T, A) draw per scenario, laid out the same way
        delta = jax.vmap(lambda k: jax.random.normal(k, (K, T, 1), jnp.float32))(k_delta)
        delta_tm = jnp.transpose(delta[..., 0], (2, 0, 1)).reshape(T, B * K)
    tst = ts.init_state_batch(B, torch.Generator(), device="cpu")
    new_t, u0_t, _ = ts.solve_batch(tst, torch.tensor(xs), torch.zeros((T, 5)),
                                    use_fused=use_fused,
                                    delta_tm=torch.tensor(np.asarray(delta_tm)))
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=TOL, atol=TOL)


def test_kernel_ok_and_solve_batch_tm_shapes():
    _, ts = _solvers("cartpole_swingup", T=5, K=4)
    assert ts.kernel_ok()
    assert not TMPPI(model=tmodels.CartPoleSwingUpModel, T=5, model_noise_std=0.1).kernel_ok()
    plan = convert.plan_tm_from_numpy(np.zeros((5, 16), np.float32), device="cpu")
    xs = torch.tensor(np.tile([[0.0], [0.0], [np.pi], [0.0]], (1, 16)), dtype=torch.float32)
    new, u0 = ts.solve_batch_tm(plan, xs, torch.zeros((5, 5)), 3)
    assert new.shape == (5, 16) and u0.shape == (16,)
    torch.testing.assert_close(u0, new[0])
