"""Port vs reference: closed-loop I2C episodes, end to end.

Short episodes through ``run_episodes_fused`` (on the CPU the smoother
kernels' plain versions), ``run_episodes_batch`` (the per-step
``torch.linalg`` form) and ``run_episode`` against the reference's
``run_episodes_batch``, which is ``jax.vmap`` of its scalar ``run_episode``
(the path its suite drives I2C through). Zero plant noise, zero initial
plans (both packages' default for I2C).

Tolerance 2e-3 on costs, states and actions, that of
tests/test_torch_i2c.py for one solve, carried through a few closed-loop
steps on the pendulum, whose plans stay inside the ±2 box here (cart-pole's
saturate at once, and a saturated control's clip derivative depends on the
last bit: see tests/test_torch_i2c.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.experiment import EpisodeConfig as JConfig
from benchmarking_mpc_solvers_tpu.experiment.episode import run_episodes_batch as j_batch
from benchmarking_mpc_solvers_tpu.solvers import I2C as JI2C
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.experiment import (
    EpisodeConfig,
    run_episode,
    run_episodes_batch,
    run_episodes_fused,
)
from benchmarking_mpc_solvers_tpu_torch.ops.i2c_smooth import i2c_filter, i2c_rts_smooth
from benchmarking_mpc_solvers_tpu_torch.solvers import I2C

TOL = 2e-3
FIELDS = ("costs", "true_states", "observations", "dones", "actions", "true_actions",
          "planned_states", "planned_costs", "planned_actions", "warmstart_trajectories")


def _x0s(centre, B, seed=0, scale=0.05):
    centre = np.asarray(centre, np.float32)
    return (np.tile(centre, (B, 1))
            + scale * np.random.default_rng(seed).standard_normal((B, centre.size))
            ).astype(np.float32)


def _compare(got, want):
    for field in FIELDS:
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=field)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("record_plans,warmstart", [(True, 0), (False, 0), (True, 2)])
def test_i2c_episode_matches_reference(fused, record_plans, warmstart):
    B, T, steps = 4, 8, 4
    jenv, tenv = JENVS["pendulum"], TENVS["pendulum"]
    x0s = _x0s(jenv.start_state, B)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    want = j_batch(jenv, JI2C(model=jenv.model, T=T, max_iter=3, pallas_smoother=False),
                   JConfig(n_steps=steps, record_plans=record_plans, warmstart=warmstart),
                   keys, jnp.asarray(x0s))
    runner = run_episodes_fused if fused else run_episodes_batch
    before = (i2c_filter.launches, i2c_rts_smooth.launches)
    got = runner(tenv, I2C(model=tenv.model, T=T, max_iter=3),
                 EpisodeConfig(n_steps=steps, record_plans=record_plans, warmstart=warmstart),
                 torch.tensor(x0s), device="cpu")
    assert (i2c_filter.launches, i2c_rts_smooth.launches) == before  # no kernel on the CPU
    _compare(got, want)
    assert got.costs.shape == (B, steps) and float(got.true_actions.abs().max()) <= 2.0
    assert float(got.true_actions.abs().max()) > 0.1  # the solver acted


def test_scalar_runner_takes_i2c():
    """``run_episode`` through ``solve`` agrees with row 0 of the batch."""
    tenv = TENVS["pendulum"]
    cfg = EpisodeConfig(n_steps=3, record_plans=True)
    x0 = torch.tensor([np.pi - 0.1, 0.2], dtype=torch.float32)
    solver = I2C(model=tenv.model, T=6, max_iter=2)
    one = run_episode(tenv, solver, cfg, x0=x0, device="cpu")
    many = run_episodes_batch(tenv, solver, cfg, x0.expand(2, -1), device="cpu")
    torch.testing.assert_close(one.costs, many.costs[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(one.planned_actions, many.planned_actions[0], rtol=1e-3,
                               atol=1e-3)


def test_entry_points_default_to_the_card():
    tenv = TENVS["pendulum"]
    solver = I2C(model=tenv.model, T=4, max_iter=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_episodes_fused(tenv, solver, EpisodeConfig(n_steps=1), torch.zeros((2, 2)))
