"""Port vs reference: trajectory linearization and quadratization.

The same numpy-seeded trajectories go through the reference's
``ops/linearize.py`` (vmapped over scenarios) and the port's batched
functions. Some points sit on an action bound (where the clip's derivative
is 1/2 in both packages), and the pendulum's angles lie on either side of
its wrap at ±π.

Tolerance rtol = atol = 1e-5, the reference's own for its derivative kernel
(tests/test_fused_derivs.py): both sides differentiate the same float32
formulas, the port in reverse mode and the reference in forward mode, so
the entries differ by a few ulps of the largest term in their sums. The
cart-pole Hessians reach ~1e2 here, hence the relative part.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.ops import linearize as jlin
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.ops import linearize as tlin

NAMES = ["pendulum", "cartpole_swingup", "acrobot"]
TOL = 1e-5
B, T = 4, 6


def trajectories(name, seed=0):
    """(xs (B, T+1, S), us (B, T, 1), g_z (T, Z)) with points on the action
    bounds and, for the pendulum, angles just inside and outside ±π."""
    model = JENVS[name].model
    rng = np.random.default_rng(seed)
    S = model.state_size
    xs = rng.uniform(-1.2, 1.2, (B, T + 1, S)).astype(np.float32)
    us = rng.uniform(-1.0, 1.0, (B, T, 1)).astype(np.float32)
    us[0, 0], us[1, 1] = float(model.hi[0]), float(model.lo[0])
    if name == "pendulum":
        xs[0, :4, 0] = [np.pi - 0.01, np.pi + 0.01, -np.pi + 0.01, -np.pi - 0.01]
    g_z = rng.uniform(-0.2, 0.2, (T, model.goal_size)).astype(np.float32)
    return xs, us, g_z


def _close(got, want, name):
    assert got.dtype == torch.float32, name
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=name)


class _NoW:
    """A cost without the ``.W`` attribute: the autodiff fallbacks."""

    def __init__(self, f):
        self._f = f

    def __call__(self, *args):
        return self._f(*args)


@pytest.mark.parametrize("name", NAMES)
def test_linearize_dynamics_matches_reference(name):
    xs, us, _ = trajectories(name)
    jm, tm = JENVS[name].model, TENVS[name].model
    want = jax.vmap(lambda x, u: jlin.linearize_dynamics(jm, x[:-1], u))(
        jnp.asarray(xs), jnp.asarray(us))
    got = tlin.linearize_dynamics(tm, torch.tensor(xs[:, :-1]), torch.tensor(us))
    for field in got._fields:
        _close(getattr(got, field), getattr(want, field), field)
    # the residual makes the affine model exact at the point
    x, u = torch.tensor(xs[:, :-1]), torch.tensor(us)
    pred = (got.A @ x[..., None])[..., 0] + (got.B @ u[..., None])[..., 0] + got.c
    torch.testing.assert_close(pred, tm.dynamics(x, u), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_gn_point_and_terminal_terms_match_reference(name):
    xs, us, g_z = trajectories(name, seed=1)
    jm, tm = JENVS[name].model, TENVS[name].model
    x, u, gz = xs[:, 0], us[:, 0], g_z[0]
    want_g, want_H = jax.vmap(lambda a, b: jlin.gn_point_terms(jm, a, b, jnp.asarray(gz)))(
        jnp.asarray(x), jnp.asarray(u))
    got_g, got_H = tlin.gn_point_terms(tm, torch.tensor(x), torch.tensor(u), torch.tensor(gz))
    _close(got_g, want_g, "grad")
    _close(got_H, want_H, "H")
    want_qf, want_Qf = jax.vmap(lambda a: jlin.gn_terminal_terms(jm, a, jnp.asarray(gz)))(
        jnp.asarray(x))
    got_qf, got_Qf = tlin.gn_terminal_terms(tm, torch.tensor(x), torch.tensor(gz))
    _close(got_qf, want_qf, "qf")
    _close(got_Qf, want_Qf, "Qf")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mode", ["closed_form", "no_W_fallback", "exact_hessian"])
def test_quadratize_cost_matches_reference(name, mode):
    xs, us, g_z = trajectories(name, seed=2)
    jm, tm = JENVS[name].model, TENVS[name].model
    if mode == "no_W_fallback":
        jm = dataclasses.replace(jm, state_cost=_NoW(jm.state_cost),
                                 terminal_cost=_NoW(jm.terminal_cost))
        tm = dataclasses.replace(tm, state_cost=_NoW(tm.state_cost),
                                 terminal_cost=_NoW(tm.terminal_cost))
    gn = mode != "exact_hessian"
    want = jax.vmap(lambda x, u: jlin.quadratize_cost(jm, x, u, jnp.asarray(g_z),
                                                      gauss_newton=gn))(
        jnp.asarray(xs), jnp.asarray(us))
    got = tlin.quadratize_cost(tm, torch.tensor(xs), torch.tensor(us), torch.tensor(g_z),
                               gauss_newton=gn)
    for field in got._fields:
        _close(getattr(got, field), getattr(want, field), f"{mode} {field}")


def test_unbatched_trajectory_and_per_scenario_goals():
    """One trajectory without a batch dimension, and a (B, T, Z) goal, give
    the rows of the batched call."""
    xs, us, g_z = trajectories("cartpole_swingup", seed=3)
    tm = TENVS["cartpole_swingup"].model
    xs_t, us_t, gz_t = torch.tensor(xs), torch.tensor(us), torch.tensor(g_z)
    batched = tlin.quadratize_cost(tm, xs_t, us_t, gz_t)
    single = tlin.quadratize_cost(tm, xs_t[1], us_t[1], gz_t)
    tiled = tlin.quadratize_cost(tm, xs_t, us_t, gz_t.expand(B, T, -1))
    for field in batched._fields:
        torch.testing.assert_close(getattr(single, field), getattr(batched, field)[1])
        torch.testing.assert_close(getattr(tiled, field), getattr(batched, field))
    dyn = tlin.linearize_dynamics(tm, xs_t[1, :-1], us_t[1])
    assert dyn.A.shape == (T, 4, 4) and dyn.B.shape == (T, 4, 1) and dyn.c.shape == (T, 4)


def test_converters_carry_the_reference_tuples_across():
    xs, us, g_z = trajectories("acrobot", seed=4)
    jm = JENVS["acrobot"].model
    dyn = jlin.linearize_dynamics(jm, jnp.asarray(xs[0, :-1]), jnp.asarray(us[0]))
    cost = jlin.quadratize_cost(jm, jnp.asarray(xs[0]), jnp.asarray(us[0]), jnp.asarray(g_z))
    tdyn = convert.affine_dynamics_from_numpy(*(np.asarray(a) for a in dyn), device="cpu")
    tcost = convert.quad_cost_from_numpy(*(np.asarray(a) for a in cost), device="cpu")
    assert isinstance(tdyn, tlin.AffineDynamics) and isinstance(tcost, tlin.QuadCost)
    assert tdyn._fields == dyn._fields and tcost._fields == cost._fields
    for t, j in zip(tuple(tdyn) + tuple(tcost), tuple(dyn) + tuple(cost)):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
