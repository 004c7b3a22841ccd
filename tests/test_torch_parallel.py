"""Port vs reference: the sharded paths (``parallel/``) on CPU meshes.

The reference's meshes are JAX's 8 virtual CPU devices (conftest.py); the
port's are ``make_mesh(n, device_type="cpu")``, the CPU device n times.

- ``sharded_episodes_kernel`` (kernel 1 for MPPI, kernel 3 for CEM, their
  plain versions here) on a 4-shard mesh against the reference's on
  ``make_mesh(4)``, each shard given the reference's per-call seeds of its
  own keys, zero plant noise. Tolerances as the unsharded kernel-tier tests:
  1e-4 for MPPI (tests/test_torch_episode.py), 1e-3 for CEM
  (tests/test_torch_episode_cem_ilqr.py).
- The port's sharded tiers against their unsharded runners shard by shard,
  with the same generators: bit for bit.
- ``make_sharded_mppi_step`` on a (batch 4 × sample 2) mesh, with injected
  normals, against the reference's formula over the union of the sample
  shards, its rollout costs from the reference's ``rollout_cost_samples``
  (the math of tests/test_parallel.py): rtol 1e-4, atol 1e-5 as there.
- ``global_stats`` against the reference's on the same values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import parallel as jpar
from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.experiment import EpisodeConfig as JConfig
from benchmarking_mpc_solvers_tpu.ops import rollout_cost_samples as j_rollout_cost_samples
from benchmarking_mpc_solvers_tpu.solvers import CEM as JCEM
from benchmarking_mpc_solvers_tpu.solvers import MPPI as JMPPI
from benchmarking_mpc_solvers_tpu_torch import parallel as tpar
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.experiment import (
    EpisodeConfig,
    run_episodes_batch,
    run_episodes_fused,
)
from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, MPPI

FIELDS = ("costs", "actions", "true_actions", "true_states", "observations", "dones")
B, T, SHARDS, STEPS, WARM = 32, 6, 4, 4, 2
SOLVERS = {
    "mppi": (JMPPI, MPPI, dict(T=T, K=4), 1e-4),
    "cem": (JCEM, CEM, dict(T=T, K=4, n_elite=2, max_iter=2), 1e-3),
}


def _x0s(name, n):
    start = np.asarray(JENVS[name].start_state)
    return (np.tile(start, (n, 1)) + 0.05 * np.random.default_rng(0).standard_normal(
        (n, start.size))).astype(np.float32)


def _reference_seeds(keys, n_calls):
    """The reference's per-call seeds of a shard's keys
    (experiment/episode.py:232-238)."""
    k_all = jax.vmap(jax.random.split)(keys)
    return np.asarray(jax.random.randint(k_all[0, 0], (n_calls,), -(2**31), 2**31 - 1,
                                         jnp.int32))


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_sharded_kernel_tier_matches_reference(solver):
    jcls, tcls, kw, tol = SOLVERS[solver]
    jenv, tenv = JENVS["pendulum"], TENVS["pendulum"]
    x0s = _x0s("pendulum", B)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    cfg = dict(n_steps=STEPS, warmstart=WARM, record_plans=False)
    want = jpar.sharded_episodes_kernel(jenv, jcls(model=jenv.model, **kw), JConfig(**cfg),
                                        jpar.make_mesh(SHARDS))(keys, jnp.asarray(x0s))
    per = B // SHARDS
    seeds = [_reference_seeds(keys[i * per:(i + 1) * per], STEPS + WARM) for i in range(SHARDS)]
    fn = tpar.sharded_episodes_kernel(tenv, tcls(model=tenv.model, **kw), EpisodeConfig(**cfg),
                                      tpar.make_mesh(SHARDS, device_type="cpu"))
    got = fn(torch.tensor(x0s), seeds=seeds)
    assert got.costs.shape == (B, STEPS)
    for field in FIELDS:
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=tol, atol=tol, err_msg=field)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_sharded_kernel_tier_is_the_unsharded_tier_per_shard(solver):
    """Each shard draws its seeds from its own generator: shard i's rows
    equal ``run_episodes_fused`` on those rows with generator i's draws, bit
    for bit, plans recorded."""
    _, tcls, kw, _ = SOLVERS[solver]
    env = TENVS["pendulum"]
    x0s = torch.tensor(_x0s("pendulum", B))
    cfg = EpisodeConfig(n_steps=STEPS, warmstart=WARM, record_plans=True)
    sol = tcls(model=env.model, **kw)
    mesh = tpar.make_mesh(SHARDS, device_type="cpu")
    gens = [torch.Generator().manual_seed(10 + i) for i in range(SHARDS)]
    got = tpar.sharded_episodes_kernel(env, sol, cfg, mesh)(x0s, generators=gens)
    default = tpar.sharded_episodes_kernel(env, sol, cfg, mesh)(tpar.shard_batch(mesh, x0s))
    per = B // SHARDS
    for i in range(SHARDS):
        rows = slice(i * per, (i + 1) * per)
        for k, gen_seed in ((got, 10 + i), (default, i)):
            want = run_episodes_fused(env, sol, cfg, x0s[rows],
                                      generator=torch.Generator().manual_seed(gen_seed),
                                      device="cpu")
            for field, w in zip(want._fields, want):
                torch.testing.assert_close(getattr(k, field)[rows], w, rtol=0, atol=0,
                                           msg=field)


def test_sharded_kernel_tier_refuses_what_the_reference_refuses():
    env = TENVS["pendulum"]
    mesh = tpar.make_mesh(SHARDS, device_type="cpu")
    cfg = EpisodeConfig(n_steps=1, record_plans=False)
    fn = tpar.sharded_episodes_kernel(env, MPPI(model=env.model, T=4, K=4), cfg, mesh)
    with pytest.raises(ValueError, match="does not split"):
        fn(torch.zeros((B + 1, 2)))
    with pytest.raises(ValueError, match="kernel tier"):
        tpar.sharded_episodes_kernel(env, MPPI(model=env.model, T=4, K=4, model_noise_std=0.1),
                                     cfg, mesh)


def test_sharded_episodes_is_run_episodes_batch_per_shard():
    env = TENVS["cartpole_swingup"]
    x0s = torch.tensor(_x0s("cartpole_swingup", 8))
    cfg = EpisodeConfig(n_steps=3, warmstart=1, record_plans=True)
    sol = MPPI(model=env.model, T=5, K=6)
    mesh = tpar.make_mesh(2, device_type="cpu")
    got = tpar.sharded_episodes(env, sol, cfg, mesh)(x0s)
    for i in range(2):
        want = run_episodes_batch(env, sol, cfg, x0s[4 * i:4 * (i + 1)],
                                  generator=torch.Generator().manual_seed(i), device="cpu")
        for field, w in zip(want._fields, want):
            torch.testing.assert_close(getattr(got, field)[4 * i:4 * (i + 1)], w, rtol=0,
                                       atol=0, msg=field)


def test_sample_sharded_mppi_matches_reference_math():
    """The sample-axis reductions equal the softmax over the union of the
    sample shards, on the same deltas, with the reference's rollout costs;
    and the port's batched MPPI update on them."""
    jm, tm = JENVS["pendulum"].model, TENVS["pendulum"].model
    Bm, Tm, K, std, lam = 8, 5, 8, 0.7, 0.5
    mesh = tpar.make_mesh(8, axes=(tpar.BATCH_AXIS, tpar.SAMPLE_AXIS), shape=(4, 2),
                          device_type="cpu")
    assert mesh.shape == dict(jpar.make_mesh(8, axes=("batch", "sample"), shape=(4, 2)).shape)
    solver = MPPI(model=tm, T=Tm, K=K, std=std, lam=lam)
    rng = np.random.default_rng(2)
    planned = (0.3 * rng.standard_normal((Bm, Tm, 1))).astype(np.float32)
    xs = np.tile(np.asarray(JENVS["pendulum"].start_state), (Bm, 1)).astype(np.float32)
    noise = rng.standard_normal((Bm, K, Tm, 1)).astype(np.float32)
    step = tpar.make_sharded_mppi_step(solver, mesh)
    new_planned, u0s = step(torch.tensor(planned), torch.tensor(xs), noise=noise)
    assert new_planned.shape == (Bm, Tm, 1) and u0s.shape == (Bm, 1)
    assert float(u0s.abs().max()) <= 2.0

    g_z = jnp.zeros((Tm, jm.goal_size), jnp.float32)
    for b in range(Bm):
        delta = std * jnp.asarray(noise[b])
        s = jnp.asarray(planned[b])[None] + delta
        rc, _ = j_rollout_cost_samples(jm, jnp.asarray(xs[b]), s, g_z)
        cost = rc + lam * jnp.einsum("kta,kta->k", s, delta) / std**2
        w = jax.nn.softmax(-(cost - cost.min()) / lam)
        want = jnp.asarray(planned[b]) + jnp.einsum("k,kta->ta", w, delta)
        np.testing.assert_allclose(new_planned[b].numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)

    st = solver.init_state_batch(Bm, torch.Generator().manual_seed(0), device="cpu")
    delta_tm = torch.tensor(std * noise[..., 0]).permute(2, 0, 1).reshape(Tm, Bm * K)
    want = solver.solve_batch(st._replace(planned_us=torch.tensor(planned)), torch.tensor(xs),
                              torch.zeros((Tm, tm.goal_size)), use_fused=False,
                              delta_tm=delta_tm)[0].planned_us
    torch.testing.assert_close(new_planned, want, rtol=1e-5, atol=1e-5)

    # drawn deltas: deterministic under one generator, distinct per sample shard
    a = step(torch.tensor(planned), torch.tensor(xs), generator=torch.Generator().manual_seed(3))
    b = step(torch.tensor(planned), torch.tensor(xs), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert torch.isfinite(a[0]).all() and not torch.equal(a[0], torch.tensor(planned))


def test_sample_sharded_mppi_refuses_k_not_divisible():
    mesh = tpar.make_mesh(4, axes=(tpar.BATCH_AXIS, tpar.SAMPLE_AXIS), shape=(2, 2),
                          device_type="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tpar.make_sharded_mppi_step(MPPI(model=TENVS["pendulum"].model, T=4, K=5), mesh)


def test_distributed_init_noop_single_process():
    assert tpar.distributed_init(num_processes=1) is False


def test_global_stats_matches_reference():
    vals = np.random.default_rng(4).standard_normal(32).astype(np.float32)
    jmesh = jpar.make_mesh(8, axes=("batch",))
    (jvals,) = jpar.shard_batch(jmesh, (jnp.asarray(vals),))
    want = jpar.global_stats(jvals, jmesh)
    mesh = tpar.make_mesh(8, device_type="cpu")
    shards = tpar.shard_batch(mesh, torch.tensor(vals))
    assert [tuple(s.shape) for s in shards] == [(4,)] * 8
    for got in (tpar.global_stats(shards, mesh), tpar.global_stats(torch.tensor(vals), mesh)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="does not split"):
        tpar.shard_batch(mesh, torch.zeros(33))
