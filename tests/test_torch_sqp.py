"""Port vs reference: the SQP solver and Gauss-Newton iLQR.

The port's ``SQP.solve_batch`` starts from numpy-seeded plans and is held
against the reference's scalar solve under ``vmap`` (``pallas_backward=
False``, the scan path), with and without ``use_fused`` (on the CPU the
kernels' plain versions); ``ILQR(gauss_newton=True)`` likewise, its
``use_fused=True`` against the reference's ``pallas_backward=True`` (Pallas
kernels in interpret mode).

Tolerance 2e-3 on the solves, as for iLQR (tests/test_torch_ilqr.py) and as
the reference's own Pallas-vs-scan SQP test (tests/test_riccati_pallas.py):
XLA's CPU code fuses multiply-adds, the port rounds each operation, so a
cost differs by an ulp or two. SQP's accept test ``best < cost − tol·|cost|``
and its ``argmin`` over α then fall either way once a scenario has
converged, a step of α·k near the optimum; a wrong gain, reg schedule or α
moves the plan by O(0.1). The derivatives agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.ops.rollout import simulate_trajectory as j_sim
from benchmarking_mpc_solvers_tpu.solvers import ILQR as JILQR
from benchmarking_mpc_solvers_tpu.solvers import SQP as JSQP
from benchmarking_mpc_solvers_tpu.solvers.sqp import SQPState as JSQPState
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR as TILQR
from benchmarking_mpc_solvers_tpu_torch.solvers import SQP as TSQP

TOL = 2e-3
T, B = 8, 5


def _problem(name, seed=0, plan_scale=0.3):
    env = JENVS[name]
    rng = np.random.default_rng(seed)
    S = env.model.state_size
    start = np.array([0.1, 0.0, 0.2, 0.0], np.float32) if name == "acrobot" else np.asarray(
        env.start_state)
    x0s = (np.tile(start, (B, 1)) + 0.05 * rng.standard_normal((B, S))).astype(np.float32)
    plans = (plan_scale * rng.standard_normal((B, T, 1))).astype(np.float32)
    return env, x0s, plans, np.zeros((T, env.model.goal_size), np.float32)


def _reference_sqp(env, x0s, plans, g_z, **kw):
    js = JSQP(model=env.model, T=T, pallas_backward=False, **kw)
    key = jax.random.PRNGKey(0)
    return jax.vmap(lambda p, x: js.solve(JSQPState(p, key), x, jnp.asarray(g_z)))(
        jnp.asarray(plans), jnp.asarray(x0s))


@pytest.mark.parametrize("name", ["acrobot", "pendulum", "cartpole_swingup"])
def test_solve_batch_matches_vmapped_reference(name):
    env, x0s, plans, g_z = _problem(name)
    new_j, u0_j, _ = _reference_sqp(env, x0s, plans, g_z, max_iter=3)
    ts = TSQP(model=TENVS[name].model, T=T, max_iter=3)
    st = convert.sqp_state_from_numpy(plans, device="cpu")
    out = {}
    for fused in (False, True):
        new_t, u0_t, _ = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z), use_fused=fused)
        np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                                   rtol=TOL, atol=TOL, err_msg=f"use_fused={fused}")
        np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=TOL, atol=TOL)
        out[fused] = new_t.planned_us
    # the fused tier (plain versions here) against the plain tier of the port
    torch.testing.assert_close(out[True], out[False], rtol=TOL, atol=TOL)
    assert not torch.equal(out[False], torch.tensor(plans))  # the solve moved the plans


def test_solve_matches_reference_scalar_solve():
    env, x0s, plans, g_z = _problem("acrobot", seed=1)
    js = JSQP(model=env.model, T=T, max_iter=4, pallas_backward=False)
    new_j, u0_j, _ = js.solve(JSQPState(jnp.asarray(plans[0]), jax.random.PRNGKey(0)),
                              jnp.asarray(x0s[0]), jnp.asarray(g_z))
    ts = TSQP(model=TENVS["acrobot"].model, T=T, max_iter=4)
    st = convert.sqp_state_from_numpy(plans[0], device="cpu")
    new_t, u0_t, _ = ts.solve(st, torch.tensor(x0s[0]), torch.tensor(g_z))
    assert new_t.planned_us.shape == (T, 1) and u0_t.shape == (1,)
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=TOL, atol=TOL)


def test_subproblem_policy_and_candidates_match_reference():
    """One iteration's stages, before any accept decision: the deviation
    policy and the all-α candidates, to 1e-4."""
    from benchmarking_mpc_solvers_tpu.ops.riccati import TVLQRPolicy as JPolicy

    env, x0s, plans, g_z = _problem("acrobot", seed=2)
    js = JSQP(model=env.model, T=T, pallas_backward=False)
    ts = TSQP(model=TENVS["acrobot"].model, T=T)
    xs = np.asarray(jax.vmap(lambda x, u: j_sim(env.model, x, u, jnp.asarray(g_z))[0])(
        jnp.asarray(x0s), jnp.asarray(plans)))
    reg = 1e-2
    want = jax.vmap(lambda x, u: js._subproblem(x, u, jnp.asarray(g_z), reg))(
        jnp.asarray(xs), jnp.asarray(plans))
    regs = torch.full((B,), reg)
    for fused in (False, True):
        got = ts._subproblem(torch.tensor(xs), torch.tensor(plans), torch.tensor(g_z), regs, fused)
        np.testing.assert_allclose(got.K.numpy(), np.asarray(want.K), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.alphas().numpy(), np.asarray(js.alphas), rtol=0, atol=0)
    want_c = jax.vmap(lambda a: jax.vmap(
        lambda K, k, x, u: js._try_step(a, JPolicy(K, k), x, u, jnp.asarray(g_z)))(
            want.K, want.k, jnp.asarray(xs), jnp.asarray(plans)))(js.alphas)
    got_c = ts._try_step(ts.alphas(), got, torch.tensor(xs), torch.tensor(plans),
                         torch.tensor(g_z))
    for g, w, key in zip(got_c, want_c, ("us", "xs", "cost")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=key)


def test_per_scenario_goals_take_the_plain_stages():
    """A (B, T, Z) goal does not fit the kernels' shared g_z: the fused tier
    refuses it and says how to ask for the plain stages, which with equal
    goals give the shared-goal plans."""
    env, x0s, plans, g_z = _problem("acrobot", seed=5)
    ts = TSQP(model=TENVS["acrobot"].model, T=T, max_iter=2)
    st = convert.sqp_state_from_numpy(plans, device="cpu")
    tiled_gz = torch.tensor(g_z).expand(B, T, -1)
    with pytest.raises(NotImplementedError, match="pass use_fused=False"):
        ts.solve_batch(st, torch.tensor(x0s), tiled_gz, use_fused=True)
    shared, _, _ = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z), use_fused=True)
    tiled, _, _ = ts.solve_batch(st, torch.tensor(x0s), tiled_gz, use_fused=False)
    torch.testing.assert_close(tiled.planned_us, shared.planned_us, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", ["sqp", "ilqr", "ilqr gauss-newton"])
def test_fused_tier_refuses_a_model_its_kernels_do_not_take(which):
    """``use_fused=True`` asks for the kernels' wrappers: a model without
    ``quad_cost`` costs is refused on any device, never sent to the plain
    stages unasked; ``use_fused=False`` solves it."""
    import dataclasses

    base = TENVS["pendulum"].model
    model = dataclasses.replace(base, state_cost=lambda z, g: base.state_cost(z, g))
    if which == "sqp":
        solver, st = TSQP(model=model, T=4, max_iter=1), convert.sqp_state_from_numpy
    else:
        solver = TILQR(model=model, T=4, max_iter=1, gauss_newton=which.endswith("newton"))
        st = convert.ilqr_state_from_numpy
    state = st(np.full((2, 4, 1), 0.1, np.float32), device="cpu")
    xs, g_z = torch.tensor([[0.3, 0.0], [0.5, 0.1]]), torch.zeros((4, base.goal_size))
    with pytest.raises(NotImplementedError, match="pass use_fused=False"):
        solver.solve_batch(state, xs, g_z, use_fused=True)
    out, u0, _ = solver.solve_batch(state, xs, g_z, use_fused=False)
    assert out.planned_us.shape == (2, 4, 1) and torch.isfinite(u0).all()


def test_init_state_draws_clipped_plans_from_injected_noise():
    tm = TENVS["acrobot"].model
    zero = TSQP(model=tm, T=4).init_state_batch(3, torch.Generator().manual_seed(0), device="cpu")
    assert zero.planned_us.shape == (3, 4, 1) and not zero.planned_us.any()
    noise = np.random.default_rng(0).standard_normal((3, 4, 1)).astype(np.float32)
    st = TSQP(model=tm, T=4, init_std=2.0).init_state_batch(
        3, torch.Generator().manual_seed(0), device="cpu", noise=noise)
    np.testing.assert_allclose(st.planned_us.numpy(), np.clip(2.0 * noise, -1.0, 1.0))
    drawn = TSQP(model=tm, T=4, init_std=2.0).init_state(torch.Generator().manual_seed(1),
                                                         device="cpu")
    want = torch.clamp(2.0 * torch.randn((4, 1), generator=torch.Generator().manual_seed(1)),
                       -1.0, 1.0)
    torch.testing.assert_close(drawn.planned_us, want)


@pytest.mark.parametrize("option,item", [({"model_noise_std": 0.1}, "item 9a")])
def test_unported_sqp_options_raise_naming_the_roadmap(option, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 {item}"):
        TSQP(model=TENVS["acrobot"].model, T=4, **option)


@pytest.mark.parametrize("fused", [False, True])
def test_parallel_horizon_matches_sequential_and_reference(fused):
    """``SQP(parallel_horizon=True)`` solves its subproblem by the
    associative-scan Riccati: the plans of the sequential setting and of
    the reference's same switch, to the solve tolerance."""
    env, x0s, plans, g_z = _problem("acrobot", seed=6)
    want_j, _, _ = _reference_sqp(env, x0s, plans, g_z, max_iter=2, parallel_horizon=True)
    st = convert.sqp_state_from_numpy(plans, device="cpu")
    out = {}
    for par in (True, False):
        ts = TSQP(model=TENVS["acrobot"].model, T=T, max_iter=2, parallel_horizon=par)
        out[par] = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z),
                                  use_fused=fused)[0].planned_us
    torch.testing.assert_close(out[True], out[False], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out[True].numpy(), np.asarray(want_j.planned_us), rtol=TOL,
                               atol=TOL)
    assert not torch.equal(out[True], torch.tensor(plans))


# -- ILQR(gauss_newton=True) -------------------------------------------------------

@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup", "acrobot"])
def test_gauss_newton_derivatives_match_reference(name):
    env, x0s, plans, g_z = _problem(name, seed=3, plan_scale=1.0)
    js = JILQR(model=env.model, T=T, gauss_newton=True, pallas_backward=False)
    xs = jax.vmap(lambda x, u: j_sim(env.model, x, u, jnp.asarray(g_z))[0])(
        jnp.asarray(x0s), jnp.asarray(plans))
    want = jax.vmap(lambda x, u: js.derivatives(x, u, jnp.asarray(g_z)))(xs, jnp.asarray(plans))
    ts = TILQR(model=TENVS[name].model, T=T, gauss_newton=True)
    for fused in (False, True):
        got = ts.derivatives(torch.tensor(np.asarray(xs)), torch.tensor(plans), torch.tensor(g_z),
                             use_fused=fused)
        for field, w in zip(got._fields, want):
            g = getattr(got, field)
            assert g.dtype == torch.float32, field
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{field} use_fused={fused}")


@pytest.mark.parametrize("fused", [False, True])
def test_gauss_newton_solve_matches_reference(fused):
    env, x0s, plans, g_z = _problem("cartpole_swingup", seed=4, plan_scale=1.0)
    kw = dict(T=T, max_iter=3, reference_accept=False, gauss_newton=True)
    js = JILQR(model=env.model, pallas_backward=fused, **kw)
    key = jax.random.PRNGKey(0)
    from benchmarking_mpc_solvers_tpu.solvers.ilqr import ILQRState as JState

    new_j, u0_j, _ = jax.vmap(lambda p, x: js.solve(JState(p, key), x, jnp.asarray(g_z)))(
        jnp.asarray(plans), jnp.asarray(x0s))
    ts = TILQR(model=TENVS["cartpole_swingup"].model, **kw)
    st = convert.ilqr_state_from_numpy(plans, device="cpu")
    new_t, u0_t, _ = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z), use_fused=fused)
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=TOL, atol=TOL)
    # where the exact-Hessian iLQR stalls on cart-pole, Gauss-Newton takes steps
    moved = (new_t.planned_us != ts.model.clip_action(torch.tensor(plans))).flatten(1).any(1)
    assert moved.all()
