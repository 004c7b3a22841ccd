"""Port vs reference: closed-loop SQP and QP-MPC episodes, end to end.

Short episodes through ``run_episodes_fused`` (on the CPU the kernels' plain
versions) and ``run_episodes_batch`` against the reference's
``run_episodes_fused``, zero plant noise, zero initial plans (both
packages' default for these solvers):

- SQP on the acrobot from the suite's start [0.1, 0, 0.2, 0] (jittered);
  tolerance 2e-3, for the accept-test and argmin ties of
  tests/test_torch_sqp.py carried through a few closed-loop steps;
- QP-MPC on the pendulum with ``method="admm"`` (the ADMM kernel's shared
  layout; the reference runs its Pallas kernel in interpret mode) and on
  cart-pole with the default Riccati-ADMM and the suite's weights;
  tolerance 1e-3 on costs and states and 2e-3 on actions, the reference's
  own for its fused-vs-generic QPMPC episode (tests/test_qp_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.experiment import EpisodeConfig as JConfig
from benchmarking_mpc_solvers_tpu.experiment.episode import run_episodes_fused as j_fused
from benchmarking_mpc_solvers_tpu.solvers import QPMPC as JQPMPC
from benchmarking_mpc_solvers_tpu.solvers import SQP as JSQP
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.experiment import (
    EpisodeConfig,
    run_episode,
    run_episodes_batch,
    run_episodes_fused,
)
from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import fused_derivs
from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import admm_iterate
from benchmarking_mpc_solvers_tpu_torch.solvers import QPMPC, SQP
from test_torch_qp_mpc import CARTPOLE

FIELDS = ("costs", "true_states", "observations", "dones", "planned_states", "planned_costs",
          "warmstart_trajectories")
ACTIONS = ("actions", "true_actions", "planned_actions")


def _x0s(centre, B, seed=0, scale=0.02):
    centre = np.asarray(centre, np.float32)
    return (np.tile(centre, (B, 1))
            + scale * np.random.default_rng(seed).standard_normal((B, centre.size))
            ).astype(np.float32)


def _compare(got, want, tol, action_tol):
    for field in FIELDS + ACTIONS:
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        t = action_tol if field in ACTIONS else tol
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=t, atol=t, err_msg=field)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("record_plans", [True, False])
def test_sqp_episode_matches_reference(fused, record_plans):
    B, T, steps = 4, 8, 3
    jenv, tenv = JENVS["acrobot"], TENVS["acrobot"]
    x0s = _x0s([0.1, 0.0, 0.2, 0.0], B)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    want = j_fused(jenv, JSQP(model=jenv.model, T=T, max_iter=2, pallas_backward=False),
                   JConfig(n_steps=steps, record_plans=record_plans), keys, jnp.asarray(x0s))
    runner = run_episodes_fused if fused else run_episodes_batch
    before = fused_derivs.launches
    got = runner(tenv, SQP(model=tenv.model, T=T, max_iter=2),
                 EpisodeConfig(n_steps=steps, record_plans=record_plans), torch.tensor(x0s),
                 device="cpu")
    assert fused_derivs.launches == before
    _compare(got, want, 2e-3, 2e-3)
    assert got.costs.shape == (B, steps) and float(got.true_actions.abs().max()) <= 1.0


QP_CASES = [
    ("pendulum-admm", "pendulum", [0.4, -0.3], dict(method="admm", iters=40)),
    ("pendulum-admm-state", "pendulum", [0.4, -0.3],
     dict(method="admm", iters=40, linearize_at="state")),
    ("cartpole-riccati", "cartpole_swingup", [0.3, 0.0, 0.4, 0.0], dict(iters=30, **CARTPOLE)),
]


@pytest.mark.parametrize("label,name,centre,kw", QP_CASES, ids=[c[0] for c in QP_CASES])
@pytest.mark.parametrize("fused", [True, False])
def test_qpmpc_episode_matches_reference(label, name, centre, kw, fused):
    B, T, steps = 4, 8, 4
    jenv, tenv = JENVS[name], TENVS[name]
    x0s = _x0s(centre, B, seed=1)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    want = j_fused(jenv, JQPMPC(model=jenv.model, T=T, **kw),
                   JConfig(n_steps=steps, record_plans=True), keys, jnp.asarray(x0s))
    runner = run_episodes_fused if fused else run_episodes_batch
    before = admm_iterate.launches
    got = runner(tenv, QPMPC(model=tenv.model, T=T, **kw),
                 EpisodeConfig(n_steps=steps, record_plans=True), torch.tensor(x0s), device="cpu")
    assert admm_iterate.launches == before
    _compare(got, want, 1e-3, 2e-3)
    bound = float(tenv.model.bounds_high[0])
    assert float(got.true_actions.abs().max()) <= bound


def test_scalar_runner_takes_the_new_solvers():
    """``run_episode`` through ``solve`` agrees with row 0 of the batch."""
    tenv = TENVS["pendulum"]
    cfg = EpisodeConfig(n_steps=3, record_plans=True)
    x0 = torch.tensor([0.4, -0.3])
    for solver in (QPMPC(model=tenv.model, T=6, method="admm", iters=30),
                   SQP(model=tenv.model, T=6, max_iter=2)):
        one = run_episode(tenv, solver, cfg, x0=x0, device="cpu")
        many = run_episodes_batch(tenv, solver, cfg, x0.expand(2, -1), device="cpu")
        torch.testing.assert_close(one.costs, many.costs[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(one.planned_actions, many.planned_actions[0], rtol=1e-3,
                                   atol=1e-3)
