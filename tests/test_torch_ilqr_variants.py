"""Port vs reference: iLQR's ``ddp``, ``box_ddp``, ``diag_hessian`` and
planning-model noise.

Each variant's ``solve_batch`` starts from the plans the reference drew and
is held against the vmapped reference solve on the scan path
(``pallas_backward=False``), with ``use_fused`` True (the kernels' plain
versions on the CPU, routed as the reference routes its stages) and False.
The noisy solve replays the reference's draws: its key splits three ways
on every iteration, one part for the nominal rollout's (T, S) noise and one
for the candidates' (n_alphas, T, S).

Tolerances are those of ``tests/test_torch_ilqr.py``: 2e-3 on the solves
(XLA's CPU code fuses multiply-adds where the port rounds each operation,
and a converged scenario's accept test can fall either way), 1e-5 on the
derivatives and gains at O(1) inputs (relative, as the gains grow with
1/Q_uu).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.ops.rollout import simulate_trajectory as j_sim
from benchmarking_mpc_solvers_tpu.solvers import ILQR as JILQR
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.models import make_dummy_model
from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR as TILQR

TOL = 2e-3
DERIV_TOL = 1e-5
T, B, MAX_ITER = 6, 5, 3
# cart-pole from the reference's hi·N(0, 1) draws accepts no step (plans far
# outside its ±1 box, exact Hessians indefinite): its plans are scaled down
PLAN_SCALE = {"pendulum": 1.0, "cartpole_swingup": 0.3}


def _problem(name):
    env = JENVS[name]
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    x0s = np.asarray(jnp.tile(env.start_state, (B, 1)) + 0.05 * jax.random.normal(
        jax.random.PRNGKey(5), (B, env.model.state_size)), np.float32)
    return env, keys, x0s, np.zeros((T, env.model.goal_size), np.float32)


def _reference_solve(name, **option):
    """(initial reference state, reference solve, x0s, g_z)."""
    env, keys, x0s, g_z = _problem(name)
    js = JILQR(model=env.model, T=T, max_iter=MAX_ITER, pallas_backward=False, **option)
    st = jax.vmap(js.init_state)(keys)
    st = st._replace(planned_us=PLAN_SCALE[name] * st.planned_us)
    new, _, _ = jax.vmap(lambda s, x: js.solve(s, x, jnp.asarray(g_z)))(st, jnp.asarray(x0s))
    return js, st, new, x0s, g_z


def _assert_solves_match(name, st, new_j, x0s, g_z, noise=None, **option):
    ts = TILQR(model=TENVS[name].model, T=T, max_iter=MAX_ITER, **option)
    start = np.clip(np.asarray(st.planned_us), -10.0, 10.0)
    # the case must move the plan, or it shows nothing
    assert np.abs(np.asarray(new_j.planned_us) - start).max() > 0.1
    for fused in (True, False):
        tst = convert.ilqr_state_from_numpy(np.asarray(st.planned_us), device="cpu")
        new_t, u0_t, _ = ts.solve_batch(tst, torch.tensor(x0s), torch.tensor(g_z),
                                        use_fused=fused, noise=noise)
        np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                                   rtol=TOL, atol=TOL, err_msg=f"use_fused={fused}")
        assert new_t.planned_us.dtype == torch.float32 and u0_t.shape == (B, 1)


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup"])
@pytest.mark.parametrize("option", [{"ddp": True}, {"box_ddp": True}, {"diag_hessian": True}],
                         ids=["ddp", "box_ddp", "diag_hessian"])
def test_variant_solve_batch_matches_vmapped_reference(name, option):
    _, st, new_j, x0s, g_z = _reference_solve(name, **option)
    _assert_solves_match(name, st, new_j, x0s, g_z, **option)


def replayed_draws(js, keys):
    """The noise draws of a reference iLQR or SQP solver ``js`` from each
    scenario's key, as its solve splits the key on each iteration: standard
    normals (max_iter, B, T, S) and (max_iter, B, n_alphas, T, S)."""
    S = js.model.state_size
    sims, fwds = [], []
    for key in keys:
        sim, fwd = [], []
        for _ in range(js.max_iter):
            key, k_sim, k_fwd = jax.random.split(key, 3)
            sim.append(np.asarray(jax.random.normal(k_sim, (js.T, S), jnp.float32)))
            fwd.append(np.asarray(jax.random.normal(k_fwd, (js.n_alphas, js.T, S),
                                                    jnp.float32)))
        sims.append(sim)
        fwds.append(fwd)
    return np.swapaxes(np.array(sims), 0, 1), np.swapaxes(np.array(fwds), 0, 1)


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup"])
def test_noisy_solve_batch_matches_reference_on_replayed_draws(name):
    option = {"model_noise_std": 0.1}
    js, st, new_j, x0s, g_z = _reference_solve(name, **option)
    noise = replayed_draws(js, st.key)
    _assert_solves_match(name, st, new_j, x0s, g_z, noise=noise, **option)


def test_noisy_solve_draws_from_the_generator_and_checks_injected_shapes():
    tm = TENVS["pendulum"].model
    ts = TILQR(model=tm, T=4, max_iter=2, model_noise_std=0.1)
    x0s, g_z = torch.tensor([[3.0, 0.0], [2.5, 0.1]]), torch.zeros((4, tm.goal_size))
    plans = np.full((2, 4, 1), 0.2, np.float32)

    def solve(seed, noise=None):
        st = convert.ilqr_state_from_numpy(plans, torch.Generator().manual_seed(seed), "cpu")
        return ts.solve_batch(st, x0s, g_z, noise=noise)[0].planned_us

    assert torch.equal(solve(0), solve(0)) and not torch.equal(solve(0), solve(1))
    with pytest.raises(ValueError, match="expected"):
        solve(0, noise=(np.zeros((1, 2, 4, 2)), np.zeros((1, 2, 10, 4, 2))))
    with pytest.raises(ValueError, match="without model noise"):
        TILQR(model=tm, T=4).solve_batch(
            convert.ilqr_state_from_numpy(plans, device="cpu"), x0s, g_z,
            noise=(np.zeros((10, 2, 4, 2)), np.zeros((10, 2, 10, 4, 2))))


@functools.lru_cache(maxsize=None)
def _trajectory(name):
    env, keys, x0s, g_z = _problem(name)
    us = (0.5 * np.random.default_rng(1).standard_normal((B, T, 1))).astype(np.float32)
    xs = jax.vmap(lambda x, u: j_sim(env.model, x, u, jnp.asarray(g_z))[0])(
        jnp.asarray(x0s), jnp.asarray(us))
    return env, np.asarray(xs), us, g_z


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup", "acrobot"])
def test_dynamics_hessian_matches_reference(name):
    env, xs, us, _ = _trajectory(name)
    js = JILQR(model=env.model, T=T)
    want = jax.jit(jax.vmap(js.dynamics_hessian))(jnp.asarray(xs), jnp.asarray(us))
    got = TILQR(model=TENVS[name].model, T=T).dynamics_hessian(torch.tensor(xs), torch.tensor(us))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DERIV_TOL, atol=DERIV_TOL)


@pytest.mark.parametrize("gauss_newton", [False, True])
def test_diag_hessian_derivatives_and_backward_pass_match_reference(gauss_newton):
    """``derivatives(ref_terminal=True)`` (the terminal cost's at x_{T-1})
    and ``backward_pass_ref`` at the same points as the reference."""
    env, xs, us, g_z = _trajectory("pendulum")
    js = JILQR(model=env.model, T=T, diag_hessian=True, gauss_newton=gauss_newton)
    ts = TILQR(model=TENVS["pendulum"].model, T=T, diag_hessian=True,
               gauss_newton=gauss_newton)
    mu = np.array([0.1, 0.3, 0.5, 1.0, 4.0], np.float32)

    @jax.jit
    def reference(xs, us, mu):
        d = jax.vmap(lambda x, u: js.derivatives(x, u, jnp.asarray(g_z), ref_terminal=True))(
            xs, us)
        return d, jax.vmap(js.backward_pass_ref)(d, mu)

    d_j, want = reference(jnp.asarray(xs), jnp.asarray(us), jnp.asarray(mu))
    d_t = ts.derivatives(torch.tensor(xs), torch.tensor(us), torch.tensor(g_z), ref_terminal=True)
    for field, w in zip(d_t._fields, d_j):
        np.testing.assert_allclose(getattr(d_t, field).numpy(), np.asarray(w), rtol=DERIV_TOL,
                                   atol=DERIV_TOL, err_msg=field)
    clean = ts.derivatives(torch.tensor(xs), torch.tensor(us), torch.tensor(g_z))
    assert not torch.equal(clean.l_x[:, -1], d_t.l_x[:, -1])  # x_T, not x_{T-1}
    got = ts.backward_pass_ref(d_t, torch.tensor(mu))
    for g, w, key in zip(got, want, ("ks", "Ks", "ok")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=DERIV_TOL, atol=DERIV_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("option", ["ddp", "box_ddp"])
def test_second_order_and_box_backward_pass_match_reference(option):
    env, xs, us, g_z = _trajectory("pendulum")
    us = 2.5 * us  # some controls beyond the ±2 box, whose gains box_ddp clamps
    js = JILQR(model=env.model, T=T)
    ts = TILQR(model=TENVS["pendulum"].model, T=T)
    mu = np.full((B,), 0.5, np.float32)
    uc = np.clip(us, -2.0, 2.0)

    @jax.jit
    def reference(xs, us, uc, mu):
        def one(x, u, u_box, m):
            d = js.derivatives(x, u, jnp.asarray(g_z))
            if option == "ddp":
                return js.backward_pass(d, m, f_hess=js.dynamics_hessian(x, u))
            return js.backward_pass(d, m, us=u_box)

        return jax.vmap(one)(xs, us, uc, mu)

    want = reference(jnp.asarray(xs), jnp.asarray(us), jnp.asarray(uc), jnp.asarray(mu))
    d_t = ts.derivatives(torch.tensor(xs), torch.tensor(us), torch.tensor(g_z))
    if option == "ddp":
        got = ts.backward_pass(d_t, torch.tensor(mu),
                               f_hess=ts.dynamics_hessian(torch.tensor(xs), torch.tensor(us)))
    else:
        got = ts.backward_pass(d_t, torch.tensor(mu), us=torch.tensor(uc))
        assert bool((got[1] == 0).all(dim=-1).any())  # an active control's K row
    for g, w, key in zip(got, want, ("ks", "Ks", "ok")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=DERIV_TOL, atol=DERIV_TOL,
                                   err_msg=key)


def test_stage_routes_follow_the_reference():
    """The stages a fused solve sends to kernels, by the reference's own
    conditions, and none without ``use_fused``."""
    tm = TENVS["pendulum"].model
    cases = [({}, (False, True, True)), ({"gauss_newton": True}, (True, True, True)),
             ({"ddp": True}, (False, False, True)), ({"box_ddp": True}, (False, False, True)),
             ({"diag_hessian": True, "gauss_newton": True}, (False, False, True)),
             ({"model_noise_std": 0.1}, (False, True, False)),
             ({"model_noise_std": 0.1, "gauss_newton": True}, (True, True, False))]
    for option, want in cases:
        solver = TILQR(model=tm, T=4, **option)
        assert tuple(solver.stage_routes(True)) == want, option
        assert tuple(solver.stage_routes(False)) == (False, False, False)


def test_diag_hessian_refuses_a_larger_action():
    model = make_dummy_model(2, 2)
    ts = TILQR(model=model, T=4, max_iter=1, diag_hessian=True)
    st = convert.ilqr_state_from_numpy(np.full((2, 4, 2), 0.1, np.float32), device="cpu")
    with pytest.raises(ValueError, match="scalar-action only"):
        ts.solve_batch(st, torch.zeros((2, 2)), torch.zeros((4, 4)), use_fused=False)
