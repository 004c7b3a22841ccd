"""Port vs reference: the QP-MPC solver.

``QPMPC.solve`` over every method and linearization mode, and the three
branches of ``solve_batch`` (shared-factor Riccati-ADMM; the ADMM kernel's
plain version in its shared and per-problem layouts; the per-scenario
fallback), from numpy-seeded states and plans, against the reference.

Tolerance atol 5e-4 on plans, the reference's own for its batched-vs-scalar
QPMPC test (tests/test_qp_pallas.py): the condensed H of a T = 8 horizon is
formed in float32 in a different summation order and then factorized, and
the ADMM iterates inherit that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu.envs import REGISTRY as JENVS
from benchmarking_mpc_solvers_tpu.solvers import QPMPC as JQPMPC
from benchmarking_mpc_solvers_tpu.solvers.qp_mpc import QPMPCState as JState
from benchmarking_mpc_solvers_tpu_torch import convert
from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import admm_iterate
from benchmarking_mpc_solvers_tpu_torch.solvers import QPMPC as TQPMPC

TOL = 5e-4
T, B = 8, 4
CARTPOLE = dict(goal_x=(0.0, 0.0, 0.0, 0.0), R=((0.1,),),
                Q=((0.5, 0, 0, 0), (0, 0.1, 0, 0), (0, 0, 5.0, 0), (0, 0, 0, 0.5)))


def _problem(name, seed=0):
    env = JENVS[name]
    rng = np.random.default_rng(seed)
    S = env.model.state_size
    centre = np.array([0.3, 0.0, 0.4, 0.0], np.float32) if name == "cartpole_swingup" else (
        np.array([0.4, -0.3], np.float32))
    xs = (centre + 0.1 * rng.standard_normal((B, S))).astype(np.float32)
    plans = (0.3 * rng.standard_normal((B, T, 1))).astype(np.float32)
    return env, xs, plans, np.zeros((T, env.model.goal_size), np.float32)


def _both(name, **kw):
    return (JQPMPC(model=JENVS[name].model, T=T, **kw), TQPMPC(model=TENVS[name].model, T=T, **kw))


@pytest.mark.parametrize("name,kw", [("pendulum", {}), ("cartpole_swingup", CARTPOLE)])
def test_weights_and_linearization_match_reference(name, kw):
    env, xs, plans, _ = _problem(name)
    for mode in ("goal", "state", "plan"):
        js, ts = _both(name, linearize_at=mode, **kw)
        for got, want in zip(ts._weights("cpu"), js._weights()):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        want = js._linearize(jnp.asarray(xs[0]), jnp.asarray(plans[0]))
        got = ts._linearize(torch.tensor(xs[0]), torch.tensor(plans[0]))
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape, mode
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=mode)
    # per-scenario linearization of a batch of states, as solve_batch takes it
    js, ts = _both(name, linearize_at="state", **kw)
    want = jax.vmap(js._linearize)(jnp.asarray(xs))
    got = ts._linearize(torch.tensor(xs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["riccati_admm", "admm", "ip"])
@pytest.mark.parametrize("linearize_at", ["goal", "state", "plan"])
def test_solve_matches_reference(method, linearize_at):
    env, xs, plans, g_z = _problem("pendulum", seed=1)
    iters = 15 if method == "ip" else 40
    js, ts = _both("pendulum", method=method, linearize_at=linearize_at, iters=iters)
    new_j, u0_j, _ = js.solve(JState(jnp.asarray(plans[0]), jax.random.PRNGKey(0)),
                              jnp.asarray(xs[0]), jnp.asarray(g_z))
    st = convert.qpmpc_state_from_numpy(plans[0], device="cpu")
    new_t, u0_t, _ = ts.solve(st, torch.tensor(xs[0]), torch.tensor(g_z))
    assert new_t.planned_us.shape == (T, 1) and u0_t.shape == (1,)
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us), atol=TOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), atol=TOL)
    assert float(new_t.planned_us.abs().max()) <= 2.0


BRANCHES = [
    ("riccati-shared", "cartpole_swingup", dict(iters=30, **CARTPOLE)),
    ("kernel-shared", "pendulum", dict(method="admm", iters=40)),
    ("kernel-per-problem", "pendulum", dict(method="admm", iters=40, linearize_at="state")),
    ("loop-ip", "pendulum", dict(method="ip", iters=15)),
    ("loop-ltv-riccati", "pendulum", dict(linearize_at="state", iters=30)),
    ("loop-plan", "pendulum", dict(method="admm", linearize_at="plan", iters=40)),
]


@pytest.mark.parametrize("label,name,kw", BRANCHES, ids=[b[0] for b in BRANCHES])
def test_solve_batch_branches_match_reference(label, name, kw):
    env, xs, plans, g_z = _problem(name, seed=2)
    js, ts = _both(name, **kw)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    new_j, u0_j, _ = js.solve_batch(JState(jnp.asarray(plans), keys), jnp.asarray(xs),
                                    jnp.asarray(g_z))
    st = convert.qpmpc_state_from_numpy(plans, device="cpu")
    before = admm_iterate.launches
    for fused in (True, False):
        new_t, u0_t, _ = ts.solve_batch(st, torch.tensor(xs), torch.tensor(g_z), use_fused=fused)
        assert new_t.planned_us.shape == (B, T, 1) and u0_t.shape == (B, 1)
        np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us),
                                   atol=TOL, err_msg=f"{label} use_fused={fused}")
        np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), atol=TOL)
    assert admm_iterate.launches == before  # CPU tensors launch nothing
    # a batched solve is the scalar solve of each scenario
    one, _, _ = ts.solve(st._replace(planned_us=st.planned_us[1]), torch.tensor(xs[1]),
                         torch.tensor(g_z))
    np.testing.assert_allclose(new_t.planned_us[1].numpy(), one.planned_us.numpy(), atol=TOL)


def test_model_noise_lands_on_the_residual():
    """The planning-model noise of the reference, drawn there from the
    state's key, handed to the port as a tensor."""
    env, xs, plans, g_z = _problem("pendulum", seed=3)
    js, ts = _both("pendulum", method="admm", iters=40, model_noise_std=0.3)
    key = jax.random.PRNGKey(5)
    new_j, _, _ = js.solve(JState(jnp.asarray(plans[0]), key), jnp.asarray(xs[0]),
                           jnp.asarray(g_z))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[1], (T, 2), jnp.float32))
    st = convert.qpmpc_state_from_numpy(plans[0], device="cpu")
    new_t, _, _ = ts.solve(st, torch.tensor(xs[0]), torch.tensor(g_z), noise=torch.tensor(noise))
    np.testing.assert_allclose(new_t.planned_us.numpy(), np.asarray(new_j.planned_us), atol=TOL)
    clean, _, _ = _both("pendulum", method="admm", iters=40)[1].solve(
        st, torch.tensor(xs[0]), torch.tensor(g_z))
    assert float((clean.planned_us - new_t.planned_us).abs().max()) > 1e-2
    # the batched solve hands each scenario its own noise; undrawn, it comes
    # from the state's generator
    stb = convert.qpmpc_state_from_numpy(plans, generator=torch.Generator().manual_seed(0),
                                         device="cpu")
    noises = torch.zeros((B, T, 2))
    noises[0] = torch.tensor(noise)
    out, _, _ = ts.solve_batch(stb, torch.tensor(np.tile(xs[:1], (B, 1))), torch.tensor(g_z),
                               noise=noises)
    np.testing.assert_allclose(out.planned_us[0].numpy(), new_t.planned_us.numpy(), atol=1e-6)
    drawn, _, _ = ts.solve_batch(stb, torch.tensor(xs), torch.tensor(g_z))
    assert torch.isfinite(drawn.planned_us).all()


def test_init_state_batch_and_options():
    tm = TENVS["pendulum"].model
    st = TQPMPC(model=tm, T=5).init_state_batch(3, torch.Generator().manual_seed(0), device="cpu")
    assert st.planned_us.shape == (3, 5, 1) and not st.planned_us.any()
    noise = np.random.default_rng(0).standard_normal((3, 5, 1)).astype(np.float32)
    st = TQPMPC(model=tm, T=5, init_std=3.0).init_state_batch(
        3, torch.Generator().manual_seed(0), device="cpu", noise=noise)
    np.testing.assert_allclose(st.planned_us.numpy(), np.clip(3.0 * noise, -2.0, 2.0))
    assert TQPMPC(model=tm, T=5, parallel_horizon=True).parallel_horizon  # no longer refused
    with pytest.raises(ValueError, match="method must be one of"):
        TQPMPC(model=tm, T=5, method="osqp")
    with pytest.raises(ValueError, match="linearize_at must be one of"):
        TQPMPC(model=tm, T=5, linearize_at="trajectory")


@pytest.mark.parametrize("name,kw", [("pendulum", {}), ("cartpole_swingup", CARTPOLE)])
def test_parallel_horizon_matches_sequential_and_reference(name, kw):
    """``QPMPC(parallel_horizon=True)`` runs the Riccati-ADMM's three horizon
    recursions as associative scans: the plans of the sequential setting
    and of the reference's same switch, through ``solve_batch`` (shared
    factors) and ``solve``."""
    env, xs, plans, g_z = _problem(name, seed=7)
    js, ts = _both(name, iters=30, parallel_horizon=True, **kw)
    _, seq = _both(name, iters=30, **kw)
    st = convert.qpmpc_state_from_numpy(plans, device="cpu")
    par_t, u0_t, _ = ts.solve_batch(st, torch.tensor(xs), torch.tensor(g_z))
    seq_t, _, _ = seq.solve_batch(st, torch.tensor(xs), torch.tensor(g_z))
    torch.testing.assert_close(par_t.planned_us, seq_t.planned_us, rtol=TOL, atol=TOL)
    want, u0_j, _ = js.solve_batch(JState(jnp.asarray(plans), jax.random.PRNGKey(0)),
                                   jnp.asarray(xs), jnp.asarray(g_z))
    np.testing.assert_allclose(par_t.planned_us.numpy(), np.asarray(want.planned_us),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(u0_t.numpy(), np.asarray(u0_j), rtol=TOL, atol=TOL)
    one = convert.qpmpc_state_from_numpy(plans[0], device="cpu")
    new_t, _, _ = ts.solve(one, torch.tensor(xs[0]), torch.tensor(g_z))
    torch.testing.assert_close(new_t.planned_us, par_t.planned_us[0], rtol=TOL, atol=TOL)


def test_admm_solve_riccati_batch_parallel_horizon_keeps_iteration_count():
    """The function-level switch: the same plans, residuals below eps and
    the same number of ADMM iterations as the sequential recursions."""
    from benchmarking_mpc_solvers_tpu_torch.ops.qp import admm_solve_riccati_batch

    env, xs, _, _ = _problem("pendulum", seed=8)
    ts = TQPMPC(model=TENVS["pendulum"].model, T=T)
    Q, R, Qf = ts._weights("cpu")
    args = (ts._linearize(torch.tensor(xs[0])), torch.tensor(xs), Q, R, Qf, torch.zeros(2),
            torch.zeros(1), torch.tensor([-2.0]), torch.tensor([2.0]))
    seq = admm_solve_riccati_batch(*args, iters=300, eps=1e-3)
    par = admm_solve_riccati_batch(*args, iters=300, eps=1e-3, parallel_horizon=True)
    torch.testing.assert_close(par[0], seq[0], rtol=TOL, atol=TOL)
    assert int(seq[3]) < 300 and abs(int(par[3]) - int(seq[3])) <= 2
    assert float(par[1]) < 1e-3 and float(par[2]) < 1e-3
