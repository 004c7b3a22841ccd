"""Port vs reference: closed-loop CEM and iLQR episodes.

- CEM on the kernel tier: ``run_episodes_fused`` with the reference's
  per-call seeds against the reference's kernel-tier episode in interpret
  mode. Tolerance 1e-3: the CEM statistics' sqrt(m2 − m1²) of nearly equal
  elites turns XLA's fused multiply-adds into up to 2.4e-4·|m1| of std
  (tests/test_torch_cem.py), and the closed loop carries it a few steps.
- iLQR from the reference's initial plans (``init_plans``), zero plant
  noise, against the reference's ``run_episodes_batch``, on the port's
  plain runner and on its fused runner (the kernels' plain versions here).
  Tolerance 2e-3, for the accept-test ties of tests/test_torch_ilqr.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.experiment import EpisodeConfig as JConfig
from benchmarking_mpc_solvers_tpu.experiment.episode import run_episodes_batch as j_batch
from benchmarking_mpc_solvers_tpu.experiment.episode import run_episodes_fused as j_fused
from benchmarking_mpc_solvers_tpu.solvers import CEM as JCEM
from benchmarking_mpc_solvers_tpu.solvers import ILQR as JILQR
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.experiment import (
    EpisodeConfig,
    run_episodes_batch,
    run_episodes_fused,
)
from benchmarking_mpc_solvers_tpu_torch.ops.fused import fused_rollout_costs_tm
from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, ILQR

FIELDS = ("costs", "actions", "true_states", "observations", "dones", "planned_actions",
          "planned_states", "planned_costs", "warmstart_trajectories")


def _x0s(env, B, scale=0.05):
    start = np.asarray(env.start_state)
    return (np.tile(start, (B, 1))
            + scale * np.random.default_rng(0).standard_normal((B, start.size))).astype(np.float32)


def _compare(got, want, tol):
    for field in FIELDS:
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol, err_msg=field)


def test_cem_kernel_episode_matches_reference():
    B, T, steps, warm = 16, 6, 3, 1
    kw = dict(T=T, K=8, n_elite=3, max_iter=2)
    jenv, tenv = JENVS["cartpole_swingup"], TENVS["cartpole_swingup"]
    x0s = _x0s(jenv, B)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    want = j_fused(jenv, JCEM(model=jenv.model, **kw),
                   JConfig(n_steps=steps, warmstart=warm, record_plans=True),
                   keys, jnp.asarray(x0s), use_kernel=True)
    # the reference's per-call seeds (experiment/episode.py:232-238)
    k_all = jax.vmap(jax.random.split)(keys)
    seeds = np.asarray(jax.random.randint(k_all[0, 0], (warm + steps,), -(2**31), 2**31 - 1,
                                          jnp.int32))
    got = run_episodes_fused(tenv, CEM(model=tenv.model, **kw),
                             EpisodeConfig(n_steps=steps, warmstart=warm, record_plans=True),
                             torch.tensor(x0s), seeds=seeds, device="cpu")
    _compare(got, want, 1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_ilqr_episode_matches_reference(fused):
    B, T, steps, warm = 4, 6, 3, 1
    kw = dict(T=T, max_iter=2, reference_accept=False)
    jenv, tenv = JENVS["cartpole_swingup"], TENVS["cartpole_swingup"]
    x0s = _x0s(jenv, B)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    jsolver = JILQR(model=jenv.model, **kw)
    want = j_batch(jenv, jsolver, JConfig(n_steps=steps, warmstart=warm), keys,
                   jnp.asarray(x0s))
    # run_episode's initial plan: init_state(split(key)[0]) (experiment/episode.py:72-73)
    plans = np.array(jax.vmap(lambda k: jsolver.init_state(jax.random.split(k)[0]).planned_us)(
        keys))
    runner = run_episodes_fused if fused else run_episodes_batch
    got = runner(tenv, ILQR(model=tenv.model, **kw), EpisodeConfig(n_steps=steps, warmstart=warm),
                 torch.tensor(x0s), init_plans=plans, device="cpu")
    _compare(got, want, 2e-3)


def test_cem_two_stage_episode_runs_on_the_cpu():
    """The two-stage CEM tier keeps the result schema; on the CPU the fused
    rollout is its plain version and counts no launch."""
    env = TENVS["pendulum"]
    cfg = EpisodeConfig(n_steps=3, warmstart=1, record_plans=False)
    before = fused_rollout_costs_tm.launches
    res = run_episodes_fused(env, CEM(model=env.model, T=5, K=8, n_elite=2, max_iter=2), cfg,
                             env.start_state("cpu").expand(3, -1), use_kernel=False,
                             device="cpu")
    assert fused_rollout_costs_tm.launches == before
    assert res.costs.shape == (3, 3) and torch.isfinite(res.costs).all()
    assert res.actions.abs().max() <= 2.0


def test_init_plans_shape_is_checked():
    env = TENVS["pendulum"]
    with pytest.raises(ValueError, match="init_plans"):
        run_episodes_batch(env, ILQR(model=env.model, T=4, max_iter=1),
                           EpisodeConfig(n_steps=1), env.start_state("cpu").expand(2, -1),
                           init_plans=np.zeros((2, 5, 1), np.float32), device="cpu")
