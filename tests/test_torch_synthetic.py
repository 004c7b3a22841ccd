"""Port vs reference: the synthetic models (``models/synthetic.py``).

``make_dummy_model``, ``DummyModel`` and ``make_linear_model`` against the
reference's on numpy-seeded states and actions: ``step_and_cost``, the
terminal cost, the cost weights and the clip, over leading batch dimensions
where the reference vmaps. Tolerance 1e-6 relative: the same float32
products, summed in another order by the two matrix-product routines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import models as jmodels
from benchmarking_mpc_solvers_tpu_torch import _build
from benchmarking_mpc_solvers_tpu_torch import models as tmodels
from benchmarking_mpc_solvers_tpu_torch.ops.rollout import rollout

TOL = 1e-6


def _linear(seed, S, A, Qf=True):
    rng = np.random.default_rng(seed)
    Am = (0.9 * np.eye(S) + 0.1 * rng.standard_normal((S, S))).astype(np.float32)
    Bm = rng.standard_normal((S, A)).astype(np.float32)
    q = rng.standard_normal((S, S))
    Q = (q @ q.T / S).astype(np.float32)
    R = (0.1 * np.eye(A)).astype(np.float32)
    args = (Am, Bm, Q, R) + ((2.0 * Q,) if Qf else ())
    return jmodels.make_linear_model(*args, bounds=0.7), tmodels.make_linear_model(
        *args, bounds=0.7)


CASES = {
    "dummy": lambda: (jmodels.DummyModel, tmodels.DummyModel),
    "dummy-3-2": lambda: (jmodels.make_dummy_model(3, 2), tmodels.make_dummy_model(3, 2)),
    "linear-2-1": lambda: _linear(0, 2, 1),
    "linear-4-2-no-Qf": lambda: _linear(1, 4, 2, Qf=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_and_cost_match_reference(case):
    jm, tm = CASES[case]()
    assert (tm.name, tm.state_size, tm.action_size, tm.goal_size) == (
        jm.name, jm.state_size, jm.action_size, jm.goal_size)
    assert tm.bounds_low == jm.bounds_low and tm.bounds_high == jm.bounds_high
    np.testing.assert_array_equal(tm.state_cost.W, np.asarray(jm.state_cost.W))
    np.testing.assert_array_equal(tm.terminal_cost.W, np.asarray(jm.terminal_cost.W))
    rng = np.random.default_rng(5)
    N, S, A = 7, jm.state_size, jm.action_size
    x = rng.standard_normal((N, S)).astype(np.float32)
    u = rng.standard_normal((N, A)).astype(np.float32)
    g = rng.standard_normal((N, S + A)).astype(np.float32)
    xn_j, c_j = jax.vmap(jm.step_and_cost)(jnp.asarray(x), jnp.asarray(u), jnp.asarray(g))
    xn_t, c_t = tm.step_and_cost(torch.tensor(x), torch.tensor(u), torch.tensor(g))
    np.testing.assert_allclose(xn_t.numpy(), np.asarray(xn_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=TOL)
    f_j = jax.vmap(jm.final_cost)(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(tm.final_cost(torch.tensor(x), torch.tensor(g)).numpy(),
                               np.asarray(f_j), rtol=1e-5, atol=TOL)
    np.testing.assert_array_equal(tm.clip_action(torch.tensor(u)).numpy(),
                                  np.asarray(jnp.clip(jnp.asarray(u), jm.lo, jm.hi)))
    # a single point, and two leading batch dimensions
    one, _ = tm.step_and_cost(torch.tensor(x[0]), torch.tensor(u[0]), torch.tensor(g[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(xn_j[0]), rtol=TOL, atol=TOL)
    two, c2 = tm.step_and_cost(torch.tensor(x).expand(3, N, S), torch.tensor(u).expand(3, N, A),
                               torch.tensor(g))
    assert two.shape == (3, N, S) and c2.shape == (3, N)
    np.testing.assert_allclose(two[1].numpy(), np.asarray(xn_j), rtol=TOL, atol=TOL)


def test_rollout_broadcasts_one_start_over_samples():
    """A (S,) start against (K, T, A) samples, as the sampling solvers roll
    out: the dummy's identity dynamics must still give (K, T+1, S)."""
    for tm in (tmodels.DummyModel, _linear(2, 3, 1)[1]):
        S, A = tm.state_size, tm.action_size
        us = torch.tensor(np.random.default_rng(0).standard_normal((5, 4, A)).astype(np.float32))
        xs, costs = rollout(tm, torch.ones(S), us, torch.zeros((4, S + A)))
        assert xs.shape == (5, 5, S) and costs.shape == (5, 4)
    xs, _ = rollout(tmodels.DummyModel, torch.ones(2), us, torch.zeros((4, 3)))
    assert bool((xs == 1.0).all())


def test_registry_and_device_functors():
    """The dummy is registered as in the reference. The dummy family has a
    device functor (``Dummy<S>``, S = 1 to 8, a scalar action), which the
    kernels that call a model's dynamics take; the linear model has none,
    as the reference's kernels cannot trace it, and is refused."""
    assert tmodels.REGISTRY["dummy"] is tmodels.DummyModel
    assert set(tmodels.REGISTRY) == set(jmodels.REGISTRY)
    assert _build.model_id(tmodels.DummyModel) == _build.dummy_id(2)
    assert _build.model_id(tmodels.make_dummy_model(3, 1)) != _build.model_id(
        tmodels.DummyModel)
    for model in (_linear(3, 2, 1)[1], _linear(2, 1, 1)[1]):
        with pytest.raises(NotImplementedError, match="no CUDA device function"):
            _build.model_id(model)
