"""Port vs reference: the I2C solver.

``I2C.solve_batch`` starts from numpy-seeded plans (carried across by
``convert.i2c_state_from_numpy``) and is held against ``jax.vmap`` of the
reference's scalar ``solve`` on its scan path (``pallas_smoother=False``),
with ``use_fused`` (on the CPU the kernels' plain versions, a Cholesky
factorisation written out) and without (``torch.linalg`` per step).

Tolerance 2e-3 on the solves, the reference's own for its kernels against
its scans through a solve (tests/test_i2c_pallas.py): the smoothed means
agree to a few 1e-4 per iteration (float32 solves, LU against Cholesky, on
covariances whose prior blocks span 1e-8 to 0.25; XLA's fused
multiply-adds), the iteration feeds them back through new linearisations,
and the line search compares three rollout costs whose sums XLA and PyTorch
take in different orders, so a near-tie between the full and the half step
could fall either way; a wrong prior, gain or temperature moves the plan by
O(0.1). One iteration's smoothed controls, before any decision, agree to
1e-3 at magnitudes up to 4 (measured: 5.3e-4 at worst).

Cart-pole runs two iterations, not three. Its plans saturate at the ±1 box,
where the dynamics' clip has derivative ½ exactly at the bound and 1 just
inside it. A full step ``us + 1.0·(us_new − us)`` towards a clipped 1.0 lands
on 1.0 or on the float below it, depending on the last bit of ``us``; the
third iteration then linearises with another B column and moves that
scenario's plan by O(0.3): the port's two tiers split from each other
there as much as from the reference (measured: 0.33 in one scenario of
five, 2e-5 after two iterations). Two iterations stay clear of that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.models import make_linear_model as j_linear
from benchmarking_mpc_solvers_tpu.solvers import I2C as JI2C
from benchmarking_mpc_solvers_tpu.solvers.i2c import I2CState as JState
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.models import make_dummy_model
from benchmarking_mpc_solvers_tpu_torch.models import make_linear_model as t_linear
from benchmarking_mpc_solvers_tpu_torch.ops.rollout import (
    best_plan_by_rollout_cost,
    simulate_trajectory,
)
from benchmarking_mpc_solvers_tpu_torch.solvers import I2C as TI2C
from benchmarking_mpc_solvers_tpu_torch.solvers import I2CState

TOL = 2e-3
T, B = 8, 5


def _problem(name, seed=0, plan_scale=0.3):
    env = JENVS[name]
    rng = np.random.default_rng(seed)
    S = env.model.state_size
    x0s = (np.tile(np.asarray(env.start_state), (B, 1))
           + 0.1 * rng.standard_normal((B, S))).astype(np.float32)
    plans = (plan_scale * rng.standard_normal((B, T, 1))).astype(np.float32)
    return env, x0s, plans, np.zeros((T, env.model.goal_size), np.float32)


def _reference(env, x0s, plans, g_z, keys=None, **kw):
    js = JI2C(model=env.model, T=T, pallas_smoother=False, **kw)
    if keys is None:
        keys = jnp.tile(jax.random.PRNGKey(0), (len(plans), 1))
    return jax.vmap(lambda p, k, x: js.solve(JState(p, k), x, jnp.asarray(g_z)))(
        jnp.asarray(plans), keys, jnp.asarray(x0s))


def _both_tiers(ts, plans, x0s, g_z, want, **kw):
    st = convert.i2c_state_from_numpy(plans, device="cpu")
    out = {}
    for fused in (True, False):
        new_t, u0_t, _ = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z), use_fused=fused,
                                        **kw)
        np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(want[0].planned_us),
                                   rtol=TOL, atol=TOL, err_msg=f"use_fused={fused}")
        np.testing.assert_allclose(u0_t.numpy(), np.asarray(want[1]), rtol=TOL, atol=TOL)
        out[fused] = new_t.planned_us
    torch.testing.assert_close(out[True], out[False], rtol=TOL, atol=TOL)
    return out[True]


@pytest.mark.parametrize("name,options", [
    ("pendulum", {}),
    ("pendulum", {"prior_lag": True}),
    ("pendulum", {"line_search": False}),
    ("cartpole_swingup", {"max_iter": 2}),
    ("cartpole_swingup", {"max_iter": 2, "prior_lag": True, "line_search": False}),
], ids=["pendulum", "pendulum-lag", "pendulum-no-ls", "cartpole", "cartpole-lag-no-ls"])
def test_solve_batch_matches_vmapped_reference(name, options):
    env, x0s, plans, g_z = _problem(name)
    options = {"max_iter": 3, **options}
    want = _reference(env, x0s, plans, g_z, **options)
    ts = TI2C(model=TENVS[name].model, T=T, **options)
    got = _both_tiers(ts, plans, x0s, g_z, want)
    assert not torch.equal(got, torch.tensor(plans))  # the solve moved the plans


def test_smooth_once_matches_reference():
    """One iteration's smoothed controls, before guard, clip and line
    search, on both tiers, to 1e-3; and the annealed temperatures exactly."""
    env, x0s, plans, g_z = _problem("cartpole_swingup", seed=1)
    js = JI2C(model=env.model, T=T, pallas_smoother=False)
    ts = TI2C(model=TENVS["cartpole_swingup"].model, T=T)
    for alpha in (1.0, 7.59375):
        want = jax.vmap(lambda x, u: js._smooth_once(x, u, jnp.asarray(g_z), jnp.float32(alpha)))(
            jnp.asarray(x0s), jnp.asarray(plans))
        for fused in (True, False):
            got = ts._smooth_once(torch.tensor(x0s), torch.tensor(plans), torch.tensor(g_z),
                                  np.float32(alpha), use_fused=fused)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
    a, want_a = jnp.float32(1.0), []
    for _ in range(15):
        want_a.append(float(a))
        a = jnp.minimum(a * 1.5, 100.0)
    got_a = TI2C(model=ts.model, T=T, max_iter=15).alphas()
    assert all(isinstance(v, np.float32) for v in got_a)
    assert [float(v) for v in got_a] == want_a and want_a[-1] == 100.0
    for mine, theirs in zip(ts._prior_covs(), js._prior_covs()):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_solve_matches_reference_scalar_solve():
    env, x0s, plans, g_z = _problem("pendulum", seed=2)
    js = JI2C(model=env.model, T=T, max_iter=4, pallas_smoother=False)
    new_j, u0_j, _ = js.solve(JState(jnp.asarray(plans[0]), jax.random.PRNGKey(0)),
                              jnp.asarray(x0s[0]), jnp.asarray(g_z))
    ts = TI2C(model=TENVS["pendulum"].model, T=T, max_iter=4)
    st = convert.i2c_state_from_numpy(plans[0], device="cpu")
    new_t, u0_t, _ = ts.solve(st, torch.tensor(x0s[0]), torch.tensor(g_z))
    assert new_t.planned_us.shape == (T, 1) and u0_t.shape == (1,)
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=TOL, atol=TOL)


def test_injected_model_noise_matches_reference():
    """The reference draws each iteration's state noise from its key; the
    same numbers, drawn there and injected here, give the same plans."""
    env, x0s, plans, g_z = _problem("pendulum", seed=3)
    std, iters, S = 0.05, 3, env.model.state_size
    keys = jax.random.split(jax.random.PRNGKey(7), B)

    def draws(key):
        out = []
        for _ in range(iters):
            key, k_noise = jax.random.split(key)
            out.append(jax.random.normal(k_noise, (T, S), jnp.float32))
        return jnp.stack(out)

    noise = np.asarray(jax.vmap(draws)(keys)).transpose(1, 0, 2, 3)  # (iters, B, T, S)
    want = _reference(env, x0s, plans, g_z, keys=keys, max_iter=iters, model_noise_std=std)
    ts = TI2C(model=TENVS["pendulum"].model, T=T, max_iter=iters, model_noise_std=std)
    noisy = _both_tiers(ts, plans, x0s, g_z, want, noise=torch.tensor(noise))
    quiet = TI2C(model=ts.model, T=T, max_iter=iters).solve_batch(
        convert.i2c_state_from_numpy(plans, device="cpu"), torch.tensor(x0s), torch.tensor(g_z))
    assert not torch.allclose(noisy, quiet[0].planned_us, atol=1e-3)  # the noise mattered
    # without an injected tensor the draw comes from the state's generator
    st = I2CState(torch.tensor(plans), torch.Generator().manual_seed(5))
    own = torch.randn((iters, B, T, S), generator=torch.Generator().manual_seed(5))
    a = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z))[0].planned_us
    st = convert.i2c_state_from_numpy(plans, device="cpu")
    b = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z), noise=own)[0].planned_us
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="noise has shape"):
        ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z), noise=own[:, :2])


def _lq():
    A = np.array([[1.0, 0.1], [0.0, 1.0]], np.float32)
    Bm = np.array([[0.0], [0.1]], np.float32)
    Q = np.diag([1.0, 0.1]).astype(np.float32)
    R = np.array([[0.1]], np.float32)
    return A, Bm, Q, R


def test_i2c_approaches_lqr_on_linear_system():
    """The reference's own fixed-point test (tests/test_i2c.py) on the port:
    within 2 % of the closed-form LQR cost, controls within 0.08; and the
    port's plan within 2e-3 of the reference's."""
    A, Bm, Q, R = _lq()
    Tl = 15
    kw = dict(T=Tl, max_iter=25, alpha0=1.0, anneal=1.6, sigma_u=1.0)
    model = t_linear(A, Bm, Q, R, Q, bounds=1e6)
    solver = TI2C(model=model, **kw)
    x0 = torch.tensor([1.0, 0.0])
    g_z = torch.zeros((Tl, 3))
    state = solver.init_state(torch.Generator().manual_seed(0), device="cpu")
    state, u0, _ = solver.solve(state, x0, g_z)

    P = np.zeros((2, 2), np.float32)
    Ks = []
    for _ in range(Tl):
        K = np.linalg.solve(R + Bm.T @ P @ Bm, Bm.T @ P @ A)
        P = Q + A.T @ P @ A - A.T @ P @ Bm @ K
        Ks.append(K)
    Ks = Ks[::-1]
    us, xx = [], np.array([1.0, 0.0], np.float32)
    for t in range(Tl):
        u = -Ks[t] @ xx
        us.append(u)
        xx = A @ xx + Bm @ u
    _, c_lqr = simulate_trajectory(model, x0, torch.tensor(np.array(us)), g_z)
    _, c_i2c = simulate_trajectory(model, x0, state.planned_us, g_z)
    assert float(c_i2c) <= 1.02 * float(c_lqr), (float(c_i2c), float(c_lqr))
    np.testing.assert_allclose(state.planned_us.numpy(), np.array(us), atol=0.08)

    js = JI2C(model=j_linear(A, Bm, Q, R, Q, bounds=1e6), **kw)
    want, _, _ = js.solve(js.init_state(jax.random.PRNGKey(0)), jnp.array([1.0, 0.0]),
                          jnp.zeros((Tl, 3)))
    np.testing.assert_allclose(state.planned_us.numpy(), np.asarray(want.planned_us),
                               rtol=TOL, atol=TOL)


def test_i2c_improves_pendulum():
    model = TENVS["pendulum"].model
    solver = TI2C(model=model, T=25, max_iter=15, sigma_u=1.0)
    x0 = torch.tensor([np.pi, 0.0], dtype=torch.float32)
    g_z = torch.zeros((25, 3))
    state = solver.init_state(torch.Generator().manual_seed(0), device="cpu")
    _, c0 = simulate_trajectory(model, x0, state.planned_us, g_z)
    state, _, _ = solver.solve(state, x0, g_z)
    _, c1 = simulate_trajectory(model, x0, state.planned_us, g_z)
    assert float(c1) < 0.9 * float(c0)
    assert state.planned_us.abs().max() <= 2.0 + 1e-5


def test_nonfinite_scenario_keeps_its_plan():
    """The failure guard, per scenario: a start state at infinity makes that
    scenario's smoothed controls NaN; it keeps its plan, the others move as
    they do without it."""
    env, x0s, plans, g_z = _problem("pendulum", seed=4)
    ts = TI2C(model=TENVS["pendulum"].model, T=T, max_iter=2)
    st = convert.i2c_state_from_numpy(plans, device="cpu")
    clean, _, _ = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z))
    x0s[1, 1] = np.inf
    for fused in (True, False):
        got, u0, _ = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z), use_fused=fused)
        np.testing.assert_array_equal(got.planned_us[1].numpy(), plans[1])
        keep = [0, 2, 3, 4]
        torch.testing.assert_close(got.planned_us[keep], clean.planned_us[keep], rtol=TOL,
                                   atol=TOL)
        assert torch.isfinite(u0).all()


def test_fused_tier_refuses_what_the_kernels_do_not_take():
    env, x0s, plans, g_z = _problem("pendulum", seed=5)
    ts = TI2C(model=TENVS["pendulum"].model, T=T, max_iter=2)
    st = convert.i2c_state_from_numpy(plans, device="cpu")
    tiled_gz = torch.tensor(g_z).expand(B, T, -1)
    with pytest.raises(NotImplementedError, match="pass use_fused=False"):
        ts.solve_batch(st, torch.tensor(x0s), tiled_gz, use_fused=True)
    shared, _, _ = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z), use_fused=True)
    tiled, _, _ = ts.solve_batch(st, torch.tensor(x0s), tiled_gz, use_fused=False)
    torch.testing.assert_close(tiled.planned_us, shared.planned_us, rtol=TOL, atol=TOL)
    # D = Z = 7 is above the kernels' size; the plain per-step form runs it
    big = TI2C(model=make_dummy_model(5, 2), T=4, max_iter=2)
    state = big.init_state_batch(3, torch.Generator().manual_seed(0), device="cpu")
    xs, gz7 = torch.full((3, 5), 0.5), torch.zeros((4, 7))
    with pytest.raises(NotImplementedError, match="pass use_fused=False"):
        big.solve_batch(state, xs, gz7, use_fused=True)
    out, u0, _ = big.solve_batch(state, xs, gz7, use_fused=False)
    assert out.planned_us.shape == (3, 4, 2) and torch.isfinite(u0).all()


def test_two_actions_run_on_the_fused_tier():
    """``action_size > 1`` is not refused: the smoother is general in D."""
    rng = np.random.default_rng(6)
    A = (0.9 * np.eye(3) + 0.05 * rng.standard_normal((3, 3))).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((3, 2))).astype(np.float32)
    Q, R = np.eye(3, dtype=np.float32), 0.1 * np.eye(2, dtype=np.float32)
    kw = dict(T=6, max_iter=4, sigma_u=1.0)
    ts = TI2C(model=t_linear(A, Bm, Q, R, bounds=1e6), **kw)
    js = JI2C(model=j_linear(A, Bm, Q, R, bounds=1e6), pallas_smoother=False, **kw)
    x0s = rng.standard_normal((4, 3)).astype(np.float32)
    plans = np.zeros((4, 6, 2), np.float32)
    g_z = np.zeros((6, 5), np.float32)
    want = jax.vmap(lambda p, x: js.solve(JState(p, jax.random.PRNGKey(0)), x, jnp.asarray(g_z)))(
        jnp.asarray(plans), jnp.asarray(x0s))
    st = convert.i2c_state_from_numpy(plans, device="cpu")
    for fused in (True, False):
        got, u0, _ = ts.solve_batch(st, torch.tensor(x0s), torch.tensor(g_z), use_fused=fused)
        assert u0.shape == (4, 2)
        np.testing.assert_allclose(got.planned_us.numpy(), np.asarray(want[0].planned_us),
                                   rtol=TOL, atol=TOL)


def test_batched_line_search_picks_per_scenario():
    """The batched ``best_plan_by_rollout_cost``: the argmin per scenario,
    a non-finite cost loses, the first minimum wins; each row equals the
    scalar form's answer."""
    model = TENVS["pendulum"].model
    rng = np.random.default_rng(7)
    cands = torch.tensor(rng.uniform(-2, 2, (4, 3, T, 1)).astype(np.float32))
    cands[1, 0] = float("nan")  # scenario 1: the first candidate is not finite
    cands[2, 1] = cands[2, 0]  # scenario 2: a tie between 0 and 1
    cands[3, 2] = 0.0
    xs = torch.tensor(rng.standard_normal((4, 2)).astype(np.float32))
    g_z = torch.zeros((T, 3))
    got = best_plan_by_rollout_cost(model, xs, g_z, cands)
    assert got.shape == (4, T, 1)
    for b in range(4):
        torch.testing.assert_close(got[b], best_plan_by_rollout_cost(model, xs[b], g_z, cands[b]),
                                   rtol=0, atol=0)
    assert torch.isfinite(got[1]).all()
    _, costs = simulate_trajectory(model, xs[:, None], torch.nan_to_num(cands, nan=0.0), g_z)
    assert int(torch.argmin(costs[2])) in (0, 1)
    if int(torch.argmin(costs[2])) == 0:
        assert got[2].data_ptr() != cands[2, 1].data_ptr()
    tiled = best_plan_by_rollout_cost(model, xs, g_z.expand(4, 1, T, 3), cands)
    torch.testing.assert_close(tiled, got, rtol=0, atol=0)


def test_init_state_and_reference_field_names():
    tm = TENVS["pendulum"].model
    zero = TI2C(model=tm, T=4).init_state_batch(3, torch.Generator().manual_seed(0),
                                                device="cpu")
    assert zero.planned_us.shape == (3, 4, 1) and not zero.planned_us.any()
    noise = np.random.default_rng(0).standard_normal((3, 4, 1)).astype(np.float32)
    st = TI2C(model=tm, T=4, init_std=3.0).init_state_batch(
        3, torch.Generator().manual_seed(0), device="cpu", noise=noise)
    np.testing.assert_allclose(st.planned_us.numpy(), np.clip(3.0 * noise, -2.0, 2.0))
    import dataclasses

    mine = {f.name: f.default for f in dataclasses.fields(TI2C) if f.name not in ("model", "T")}
    theirs = {f.name: f.default for f in dataclasses.fields(JI2C) if f.name not in ("model", "T")}
    assert mine == theirs
    # the reference's kernel switch is a field only: both settings solve alike
    env, x0s, plans, g_z = _problem("pendulum", seed=8)
    outs = [TI2C(model=tm, T=T, max_iter=2, pallas_smoother=flag).solve_batch(
        convert.i2c_state_from_numpy(plans, device="cpu"), torch.tensor(x0s),
        torch.tensor(g_z))[0].planned_us for flag in (True, False)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TI2C(model=tm, T=4).init_state(torch.Generator().manual_seed(0))
