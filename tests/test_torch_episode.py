"""Port vs reference: closed-loop episodes.

``_run_episodes_kernel`` takes the reference's per-call seeds, derived as
the reference derives them from its keys, and with zero plant noise both
packages then run the same closed loop. The loop is chaotic (a 1e-7
perturbation grows past 1e-3 within tens of steps, PARITY.md), so only the
first steps are compared; the tolerance 1e-4 covers float32 rounding that
the loop amplifies over those steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.experiment import EpisodeConfig as JConfig
from benchmarking_mpc_solvers_tpu.experiment.episode import _run_episodes_kernel as j_kernel
from benchmarking_mpc_solvers_tpu.solvers import MPPI as JMPPI
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.experiment import (
    EpisodeConfig,
    run_episode,
    run_episodes_batch,
    run_episodes_fused,
)
from benchmarking_mpc_solvers_tpu_torch.experiment.episode import _run_episodes_kernel
from benchmarking_mpc_solvers_tpu_torch.solvers import MPPI

TOL = 1e-4
FIELDS = ("costs", "actions", "true_actions", "true_states", "observations", "dones",
          "planned_actions", "planned_states", "planned_costs", "warmstart_trajectories")


def _reference_seeds(keys, n_calls):
    """The reference's per-call seeds (experiment/episode.py:232-238)."""
    k_all = jax.vmap(jax.random.split)(keys)
    return np.asarray(jax.random.randint(k_all[0, 0], (n_calls,), -(2**31), 2**31 - 1,
                                         jnp.int32))


@pytest.mark.parametrize("name,record", [("cartpole_swingup", True), ("pendulum", False)])
def test_kernel_episode_matches_reference(name, record):
    B, T, K, steps, warm = 16, 8, 8, 4, 2
    jenv, tenv = JENVS[name], TENVS[name]
    start = np.asarray(jenv.start_state)
    x0s = (np.tile(start, (B, 1))
           + 0.05 * np.random.default_rng(0).standard_normal((B, start.size))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    want = j_kernel(jenv, JMPPI(model=jenv.model, T=T, K=K),
                    JConfig(n_steps=steps, warmstart=warm, record_plans=record),
                    keys, jnp.asarray(x0s))
    got = _run_episodes_kernel(tenv, MPPI(model=tenv.model, T=T, K=K),
                               EpisodeConfig(n_steps=steps, warmstart=warm, record_plans=record),
                               torch.tensor(x0s), seeds=_reference_seeds(keys, warm + steps),
                               device="cpu")
    for field in FIELDS:
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=field)


def test_kernel_episode_rejects_wrong_seed_count():
    env = TENVS["pendulum"]
    with pytest.raises(ValueError):
        _run_episodes_kernel(env, MPPI(model=env.model, T=4, K=4), EpisodeConfig(n_steps=3),
                             env.start_state("cpu").expand(2, -1), seeds=[1, 2], device="cpu")


def test_batched_tiers_run():
    """All three batched tiers (kernel tier with generator-drawn seeds,
    two-stage tier, plain batched runner) keep the reference's result
    schema and record plans when asked."""
    env = TENVS["cartpole_swingup"]
    solver = MPPI(model=env.model, T=6, K=8)
    cfg = EpisodeConfig(n_steps=3, warmstart=2, record_plans=True)
    x0s = env.start_state("cpu").expand(4, -1)
    for res in (run_episodes_fused(env, solver, cfg, x0s, device="cpu"),
                run_episodes_fused(env, solver, cfg, x0s, use_kernel=False, device="cpu"),
                run_episodes_batch(env, solver, cfg, x0s, device="cpu")):
        assert res.costs.shape == (4, 3) and torch.isfinite(res.costs).all()
        assert res.true_states.shape == (4, 4, 4)
        assert res.planned_states.shape == (4, 3, 7, 4)
        assert res.warmstart_trajectories.shape == (4, 2, 6, 1)
        assert res.actions.abs().max() <= 1.0


def test_run_episode_swings_pendulum_up():
    """Per-scenario tier: the pendulum swing-up cost drops over the episode."""
    env = TENVS["pendulum"]
    res = run_episode(env, MPPI(model=env.model, T=20, K=64),
                      EpisodeConfig(n_steps=40, warmstart=2, record_plans=False),
                      generator=torch.Generator().manual_seed(0), device="cpu")
    c = res.costs.numpy()
    assert np.isfinite(c).all()
    assert c[-5:].mean() < c[:5].mean()
