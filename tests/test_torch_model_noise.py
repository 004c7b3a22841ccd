"""Planning-model noise on the plain batched MPPI and CEM tiers, and CEM's
plain tier for any action size.

The reference's ``run_episodes_batch`` is ``vmap(run_episode)`` over the
per-scenario ``solve``, which rolls its samples out through a model with
additive state noise whenever ``model_noise_std > 0`` and takes any action
size. The port's ``run_episodes_batch`` runs ``solve_batch(use_fused=False)``,
so that tier must do the same. Here the reference's own draws are replayed
from its keys (``solve``'s splits for δu, CEM's sample noise and the state
noise) and injected into the port, and the port's plans are held against
``jax.vmap(solve)``.

Tolerance: MPPI rtol = atol = 1e-4, the reference's own for its batched
tiers (tests/test_equivalence.py): float32 rollouts rounded apart by XLA's
fused multiply-adds move the softmax weights by a few ulps. CEM rtol 2e-4,
atol 1e-3, as tests/test_torch_cem.py states: the elites' std of nearly
equal samples turns an ulp of difference into up to 2.4e-4·|mean|. One
swapped elite would move a plan by O(0.1), far beyond either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import models as jmodels
from benchmarking_mpc_solvers_tpu.solvers import CEM as JCEM
from benchmarking_mpc_solvers_tpu.solvers import MPPI as JMPPI
from benchmarking_mpc_solvers_tpu_torch import envs as tenvs
from benchmarking_mpc_solvers_tpu_torch import models as tmodels
from benchmarking_mpc_solvers_tpu_torch.experiment import (
    EpisodeConfig,
    run_episodes_batch,
    run_episodes_fused,
)
from benchmarking_mpc_solvers_tpu_torch.solvers import CEM as TCEM
from benchmarking_mpc_solvers_tpu_torch.solvers import MPPI as TMPPI

MPPI_TOL = 1e-4
CEM_RTOL, CEM_ATOL = 2e-4, 1e-3
B, T, K, NOISE = 2, 5, 8, 5.0


def _models(name):
    if name == "dummy-2-2":
        return jmodels.make_dummy_model(2, 2), tmodels.make_dummy_model(2, 2)
    return jmodels.REGISTRY[name], tmodels.REGISTRY[name]


def _problem(model, seed=1):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1.0, 1.0, (B, model.state_size)).astype(np.float32)
    plans = rng.uniform(-0.5, 0.5, (B, T, model.action_size)).astype(np.float32)
    g_z = rng.uniform(-0.2, 0.2, (T, model.goal_size)).astype(np.float32)
    return xs, plans, g_z


def test_mppi_plain_tier_matches_vmap_solve_with_model_noise():
    jm, tm = _models("pendulum")
    kw = dict(T=T, K=K, std=0.8, lam=0.5, model_noise_std=NOISE)
    js, ts = JMPPI(model=jm, **kw), TMPPI(model=tm, **kw)
    xs, plans, g_z = _problem(jm)
    st = jax.vmap(js.init_state)(jax.random.split(jax.random.PRNGKey(0), B))
    st = st._replace(planned_us=jnp.asarray(plans))
    new_j, u0_j, aux_j = jax.vmap(lambda s, x: js.solve(s, x, jnp.asarray(g_z)))(
        st, jnp.asarray(xs))

    def draws(key):  # solve's splits: δu, then the model noise
        k_delta, key = jax.random.split(key)
        delta = 0.8 * jax.random.normal(k_delta, (K, T, 1), jnp.float32)
        k_noise, _ = jax.random.split(key)
        return delta, NOISE * jax.random.normal(k_noise, (K, T, jm.state_size), jnp.float32)

    delta, xnoise = jax.vmap(draws)(st.key)  # (B, K, T, 1), (B, K, T, S)
    delta_tm = jnp.transpose(delta[..., 0], (2, 0, 1)).reshape(T, B * K)
    tst = ts.init_state_batch(B, torch.Generator().manual_seed(0), device="cpu")
    tst = tst._replace(planned_us=torch.tensor(plans))
    new_t, u0_t, aux_t = ts.solve_batch(tst, torch.tensor(xs), torch.tensor(g_z),
                                        use_fused=False,
                                        delta_tm=torch.tensor(np.asarray(delta_tm)),
                                        xnoise=torch.tensor(np.asarray(xnoise)))
    np.testing.assert_allclose(aux_t["sample_costs"].numpy(), np.asarray(aux_j["sample_costs"]),
                               rtol=MPPI_TOL, atol=MPPI_TOL)
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                               rtol=MPPI_TOL, atol=MPPI_TOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=MPPI_TOL, atol=MPPI_TOL)
    # the noise matters: without it the plans differ by far more than the tolerance
    clean, _, _ = ts.solve_batch(tst, torch.tensor(xs), torch.tensor(g_z), use_fused=False,
                                 delta_tm=torch.tensor(np.asarray(delta_tm)),
                                 xnoise=torch.zeros((B, K, T, jm.state_size)))
    assert float((clean.planned_us - new_t.planned_us).abs().max()) > 100 * MPPI_TOL


@pytest.mark.parametrize("name,noise_std", [("pendulum", NOISE), ("dummy-2-2", NOISE),
                                            ("dummy-2-2", 0.0)])
def test_cem_plain_tier_matches_vmap_solve(name, noise_std):
    """Pendulum with model noise; a two-dimensional action with and without it."""
    jm, tm = _models(name)
    S, A = jm.state_size, jm.action_size
    kw = dict(T=T, K=K, n_elite=3, max_iter=3, std=0.9, model_noise_std=noise_std)
    js, ts = JCEM(model=jm, **kw), TCEM(model=tm, **kw)
    xs, plans, g_z = _problem(jm, 2)
    st = jax.vmap(js.init_state)(jax.random.split(jax.random.PRNGKey(4), B))
    st = st._replace(planned_us=jnp.asarray(plans))
    new_j, u0_j, _ = jax.vmap(lambda s, x: js.solve(s, x, jnp.asarray(g_z)))(st, jnp.asarray(xs))

    def draws(key):  # each iteration of solve's body: the samples, then the model noise
        noise, xnoise = [], []
        for _ in range(3):
            k_sample, key = jax.random.split(key)
            noise.append(jax.random.normal(k_sample, (K, T, A), jnp.float32))
            if noise_std > 0.0:
                k_mnoise, key = jax.random.split(key)
                xnoise.append(noise_std * jax.random.normal(k_mnoise, (K, T, S), jnp.float32))
        return jnp.stack(noise), (jnp.stack(xnoise) if xnoise else None)

    noise, xnoise = jax.vmap(draws, out_axes=1)(st.key)  # (max_iter, B, K, T, .)
    tst = ts.init_state_batch(B, torch.Generator().manual_seed(0), device="cpu")
    tst = tst._replace(planned_us=torch.tensor(plans))
    new_t, u0_t, _ = ts.solve_batch(
        tst, torch.tensor(xs), torch.tensor(g_z), use_fused=False,
        noise=torch.tensor(np.asarray(noise)),
        xnoise=None if xnoise is None else torch.tensor(np.asarray(xnoise)))
    assert new_t.planned_us.shape == (B, T, A) and u0_t.shape == (B, A)
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                               rtol=CEM_RTOL, atol=CEM_ATOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=CEM_RTOL, atol=CEM_ATOL)


def _episode_solvers(noise_std):
    model = tenvs.PendulumEnv.model
    return [TMPPI(model=model, T=T, K=K, model_noise_std=noise_std),
            TCEM(model=model, T=T, K=K, n_elite=3, max_iter=2, model_noise_std=noise_std)]


def _episode(solver, fused):
    env = tenvs.PendulumEnv
    x0s = env.start_state("cpu").expand(B, -1) + torch.tensor([[0.1, 0.0], [-0.2, 0.3]])
    cfg = EpisodeConfig(n_steps=3, record_plans=False)
    gen = torch.Generator().manual_seed(7)
    if fused:
        return run_episodes_fused(env, solver, cfg, x0s, generator=gen, use_kernel=False,
                                  device="cpu")
    return run_episodes_batch(env, solver, cfg, x0s, generator=gen, device="cpu")


@pytest.mark.parametrize("which", [0, 1], ids=["mppi", "cem"])
def test_model_noise_changes_run_episodes_batch(which):
    """The probe that showed the fault: with the same generator, planning-model
    noise must change the actions of the plain batched episodes, as it changes
    the reference's vmap(run_episode)."""
    clean = _episode(_episode_solvers(0.0)[which], fused=False)
    noisy = _episode(_episode_solvers(NOISE)[which], fused=False)
    assert torch.isfinite(noisy.true_actions).all()
    assert not torch.equal(clean.true_actions, noisy.true_actions)


@pytest.mark.parametrize("which", [0, 1], ids=["mppi", "cem"])
def test_fused_tier_still_plans_without_model_noise(which):
    """The reference's batched tiers ignore model_noise_std; the fused tier
    keeps doing so, bit for bit, and refuses injected state noise."""
    clean_solver, noisy_solver = _episode_solvers(0.0)[which], _episode_solvers(NOISE)[which]
    clean, noisy = _episode(clean_solver, fused=True), _episode(noisy_solver, fused=True)
    assert torch.equal(clean.true_actions, noisy.true_actions)
    xs = torch.tensor([[3.0, 0.1], [2.5, -0.4]])
    st = noisy_solver.init_state_batch(B, torch.Generator().manual_seed(1), device="cpu")
    a, _, _ = clean_solver.solve_batch(st, xs, torch.zeros((T, 3)))
    b, _, _ = noisy_solver.solve_batch(st, xs, torch.zeros((T, 3)))
    assert torch.equal(a.planned_us, b.planned_us)
    xnoise = torch.zeros((B, K, T, 2)) if which == 0 else torch.zeros((2, B, K, T, 2))
    with pytest.raises(ValueError, match="use_fused=False"):
        noisy_solver.solve_batch(st, xs, torch.zeros((T, 3)), xnoise=xnoise)


def test_cem_fused_tier_refuses_larger_actions_naming_the_plain_tier():
    model = tmodels.make_dummy_model(2, 2)
    solver = TCEM(model=model, T=T, K=K, n_elite=3, max_iter=2)
    st = solver.init_state_batch(B, torch.Generator().manual_seed(1), device="cpu")
    with pytest.raises(NotImplementedError, match="use_fused=False"):
        solver.solve_batch(st, torch.zeros((B, 2)), torch.zeros((T, 4)))
    out, u0, _ = solver.solve_batch(st, torch.zeros((B, 2)), torch.zeros((T, 4)), use_fused=False)
    assert out.planned_us.shape == (B, T, 2) and u0.shape == (B, 2)
    assert torch.equal(out.calls, st.calls + 2)
