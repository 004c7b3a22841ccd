"""Port vs reference: the iLQR solver.

The port's ``ILQR.solve_batch`` starts from the plans the reference's
``init_state`` drew from its keys and is held against the vmapped reference
solve: with ``use_fused=True`` (the kernels' plain versions on the CPU)
against ``pallas_backward=True``, without against the scan path.

Tolerance 2e-3 on the solves, the reference's own for its SQP
Pallas-vs-scan solve (tests/test_riccati_pallas.py), for the same reason:
XLA's CPU code contracts the cost sums c + w·(z_i·z_j) into fused
multiply-adds, the port rounds the product first, so a cost differs by an
ulp or two. Once a scenario has converged, its best candidate and its
nominal plan cost the same to within one ulp, and the accept test
``best < nominal`` then falls either way: a step of α·k near the optimum,
1.6e-3 on one entry of these cases. A wrong μ/δ schedule, α choice or gain
moves the plan by O(0.1). The derivatives agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.solvers import ILQR as JILQR
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR as TILQR

TOL = 2e-3
T, B, MAX_ITER = 6, 5, 3


def _problem(name):
    env = JENVS[name]
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    x0s = np.asarray(jnp.tile(env.start_state, (B, 1)) + 0.05 * jax.random.normal(
        jax.random.PRNGKey(5), (B, env.model.state_size)), np.float32)
    return env, keys, x0s, np.zeros((T, env.model.goal_size), np.float32)


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup", "acrobot"])
@pytest.mark.parametrize("reference_accept", [True, False])
def test_solve_batch_matches_vmapped_reference(name, reference_accept):
    env, keys, x0s, g_z = _problem(name)
    ts = TILQR(model=TENVS[name].model, T=T, max_iter=MAX_ITER,
               reference_accept=reference_accept)
    for fused in (True, False):
        js = JILQR(model=env.model, T=T, max_iter=MAX_ITER, reference_accept=reference_accept,
                   pallas_backward=fused)
        st = jax.vmap(js.init_state)(keys)
        new_j, u0_j, _ = jax.vmap(lambda s, x: js.solve(s, x, jnp.asarray(g_z)))(
            st, jnp.asarray(x0s))
        tst = convert.ilqr_state_from_numpy(np.asarray(st.planned_us), device="cpu")
        new_t, u0_t, _ = ts.solve_batch(tst, torch.tensor(x0s), torch.tensor(g_z),
                                        use_fused=fused)
        np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                                   rtol=TOL, atol=TOL, err_msg=f"use_fused={fused}")
        np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=TOL, atol=TOL)


def test_solve_matches_reference_scalar_solve():
    env, keys, x0s, g_z = _problem("cartpole_swingup")
    js = JILQR(model=env.model, T=T, max_iter=4, reference_accept=False)
    st = js.init_state(keys[0])
    new_j, u0_j, _ = js.solve(st, jnp.asarray(x0s[0]), jnp.asarray(g_z))
    ts = TILQR(model=TENVS["cartpole_swingup"].model, T=T, max_iter=4, reference_accept=False)
    tst = convert.ilqr_state_from_numpy(np.asarray(st.planned_us), device="cpu")
    new_t, u0_t, _ = ts.solve(tst, torch.tensor(x0s[0]), torch.tensor(g_z))
    assert new_t.planned_us.shape == (T, 1) and u0_t.shape == (1,)
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=TOL, atol=TOL)


def test_derivatives_match_reference():
    """torch.func derivatives (the clip's tie derivative 1/2 included: the
    plan sits on the action bound) against the reference's jax ones."""
    env, keys, x0s, g_z = _problem("pendulum")
    us = np.clip(2.5 * np.random.default_rng(0).standard_normal((B, T, 1)), -2.0, 2.0)
    us = us.astype(np.float32)
    assert (np.abs(us) == 2.0).any()
    from benchmarking_mpc_solvers_tpu.ops.rollout import simulate_trajectory

    js = JILQR(model=env.model, T=T)
    xs = jax.vmap(lambda x, u: simulate_trajectory(env.model, x, u, jnp.asarray(g_z))[0])(
        jnp.asarray(x0s), jnp.asarray(us))
    want = jax.vmap(lambda x, u: js.derivatives(x, u, jnp.asarray(g_z)))(xs, jnp.asarray(us))
    ts = TILQR(model=TENVS["pendulum"].model, T=T)
    got = ts.derivatives(torch.tensor(np.asarray(xs)), torch.tensor(us), torch.tensor(g_z))
    for field, w in zip(got._fields, want):
        g = getattr(got, field)
        assert g.dtype == torch.float32, field
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=field)


@pytest.mark.parametrize("option", [{"gauss_newton": True, "ddp": True}, {"ddp": True},
                                    {"box_ddp": True},
                                    {"diag_hessian": True}, {"model_noise_std": 0.1}])
def test_unported_options_raise_naming_the_roadmap(option):
    """The options once refused here (naming the roadmap) are ported: each
    constructs, with the reference's ``pallas_backward`` field too, and
    solves (tests/test_torch_ilqr_variants.py holds them against the
    reference)."""
    ts = TILQR(model=TENVS["pendulum"].model, T=4, max_iter=1, pallas_backward=True, **option)
    st = convert.ilqr_state_from_numpy(np.full((2, 4, 1), 0.3, np.float32), device="cpu")
    out, u0, _ = ts.solve_batch(st, torch.tensor([[3.0, 0.0], [2.0, 0.5]]),
                                torch.zeros((4, 3)), use_fused=False)
    assert out.planned_us.shape == (2, 4, 1) and torch.isfinite(u0).all()


def test_init_state_is_hi_times_normal():
    ts = TILQR(model=TENVS["pendulum"].model, T=4)
    st = ts.init_state_batch(3, torch.Generator().manual_seed(0), device="cpu")
    want = 2.0 * torch.randn((3, 4, 1), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(st.planned_us, want)
