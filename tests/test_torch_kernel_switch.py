"""The reference's kernel switches in the port: ``pallas_backward`` (iLQR,
SQP) and ``pallas_smoother`` (I2C) resolve as the reference's tri-state
(``ops/riccati_pallas.py:use_pallas_riccati``). ``None`` and ``True`` leave
the stages to ``solve_batch(use_fused=...)``; an explicit ``False`` runs the
plain stages under ``use_fused=True`` too.

On the CPU the kernel wrappers run their plain versions and count no
launches, so the route is read from spies on the wrappers the solvers call:
under ``False`` none is called. The ``False`` route is the
``use_fused=False`` route bit for bit, and it matches the kernel route (the
kernels' plain versions) to the solver tests' tolerance, 2e-3: the plain
stages sum in another order than the kernels' plain versions (up to 1.1e-4
apart at these sizes).
"""

import functools

import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as TENVS
from benchmarking_mpc_solvers_tpu_torch.experiment import experiment as texp_mod
from benchmarking_mpc_solvers_tpu_torch.ops import riccati_backward as rb_mod
from benchmarking_mpc_solvers_tpu_torch.solvers import I2C, ILQR, SQP
from benchmarking_mpc_solvers_tpu_torch.solvers import i2c as i2c_mod
from benchmarking_mpc_solvers_tpu_torch.solvers import ilqr as ilqr_mod
from benchmarking_mpc_solvers_tpu_torch.solvers import sqp as sqp_mod

TOL = 2e-3
T, B = 8, 6

# (solver class, options, the switch's name, the wrappers its fused route calls)
CASES = {
    "ilqr": (ILQR, {"reference_accept": False}, "pallas_backward",
             ("riccati_backward_batch", "fused_linesearch")),
    "ilqr gauss-newton": (ILQR, {"gauss_newton": True}, "pallas_backward",
                          ("fused_derivs", "riccati_backward_batch", "fused_linesearch")),
    "sqp": (SQP, {}, "pallas_backward",
            ("fused_derivs", "riccati_backward_batch", "fused_linesearch")),
    "i2c": (I2C, {}, "pallas_smoother", ("i2c_smooth_batch",)),
}
WRAPPERS = {  # where each solver looks its wrappers up
    "fused_derivs": (ilqr_mod, sqp_mod),
    "fused_linesearch": (ilqr_mod, sqp_mod),
    "riccati_backward_batch": (ilqr_mod, rb_mod),
    "i2c_smooth_batch": (i2c_mod,),
}


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of each kernel wrapper the solvers reach."""
    seen = {name: 0 for name in WRAPPERS}

    def spy(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name, modules in WRAPPERS.items():
        for mod in modules:
            monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    return seen


def _problem(name, seed):
    env = TENVS[name]
    rng = np.random.default_rng(seed)
    x0s = torch.tensor(np.tile(env.default_start, (B, 1))
                       + 0.1 * rng.standard_normal((B, env.model.state_size)),
                       dtype=torch.float32)
    plans = torch.tensor(0.5 * rng.standard_normal((B, T, 1)), dtype=torch.float32)
    return env.model, x0s, plans, torch.zeros((T, env.model.goal_size))


def _solve(case, name, flag, use_fused, seed=0):
    cls, options, switch, _ = CASES[case]
    model, x0s, plans, g_z = _problem(name, seed)
    solver = cls(model=model, T=T, max_iter=3, **{switch: flag}, **options)
    st = solver.init_state_batch(B, torch.Generator().manual_seed(0), device="cpu")
    return solver.solve_batch(st._replace(planned_us=plans), x0s, g_z,
                              use_fused=use_fused)[0].planned_us


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup", "acrobot"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_false_runs_the_plain_stages(calls, case, name):
    """Under ``False`` no kernel wrapper is called with ``use_fused=True``,
    and the plan is the ``use_fused=False`` plan bit for bit; ``None`` and
    ``True`` call each of the route's wrappers and agree bit for bit; the two
    routes agree to TOL."""
    plain = _solve(case, name, False, True)
    assert calls == {n: 0 for n in WRAPPERS}
    torch.testing.assert_close(plain, _solve(case, name, None, False), rtol=0, atol=0)
    fused = _solve(case, name, None, True)
    expected = CASES[case][3]
    assert all(calls[n] > 0 for n in expected), calls
    assert all(calls[n] == 0 for n in WRAPPERS if n not in expected), calls
    torch.testing.assert_close(_solve(case, name, True, True), fused, rtol=0, atol=0)
    torch.testing.assert_close(plain, fused, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("option", [{}, {"gauss_newton": True}, {"ddp": True},
                                    {"box_ddp": True}, {"diag_hessian": True},
                                    {"model_noise_std": 0.1}])
def test_stage_routes_and_kernel_stages_follow_the_switch(option):
    """``ILQR.stage_routes``: no stage on a kernel under ``False``, the same
    stages under ``True`` as under ``None``; ``has_kernel_stages`` is false
    under ``False`` for each solver, and unchanged otherwise."""
    tm = TENVS["pendulum"].model
    auto = ILQR(model=tm, T=4, **option)
    assert tuple(ILQR(model=tm, T=4, pallas_backward=False, **option).stage_routes(True)) == (
        False, False, False)
    assert ILQR(model=tm, T=4, pallas_backward=True, **option).stage_routes(True) == (
        auto.stage_routes(True))
    for cls, switch in ((ILQR, "pallas_backward"), (SQP, "pallas_backward"),
                        (I2C, "pallas_smoother")):
        assert cls(model=tm, T=4).has_kernel_stages()
        assert cls(model=tm, T=4, **{switch: True}).has_kernel_stages()
        assert not cls(model=tm, T=4, **{switch: False}).has_kernel_stages()


def test_false_takes_a_model_the_kernels_refuse():
    """``use_fused=True`` refuses a model the kernels do not take unless the
    switch is ``False``, which runs the plain stages as the reference does."""
    from benchmarking_mpc_solvers_tpu_torch.models import make_dummy_model

    wide = make_dummy_model(2, 2)
    x0s, g_z = torch.zeros((2, 2)), torch.zeros((4, wide.goal_size))
    for cls in (ILQR, SQP):
        st = cls(model=wide, T=4).init_state_batch(2, torch.Generator().manual_seed(0),
                                                   device="cpu")
        with pytest.raises(NotImplementedError, match="use_fused=False"):
            cls(model=wide, T=4, max_iter=1).solve_batch(st, x0s, g_z)
        out = cls(model=wide, T=4, max_iter=1, pallas_backward=False).solve_batch(st, x0s, g_z)
        assert torch.isfinite(out[0].planned_us).all()


@pytest.mark.parametrize("agent,switch", [("ILQR", "pallas_backward"), ("SQP", "pallas_backward"),
                                          ("I2C", "pallas_smoother")])
def test_experiment_takes_the_plain_tier_under_false(monkeypatch, agent, switch):
    """``Experiment(fused=False)`` sends a solver built with its switch
    ``False`` to the plain batched tier, as the reference's vmapped solve
    then reaches no kernel."""
    seen = []
    real_fused, real_batch = texp_mod.run_episodes_fused, texp_mod.run_episodes_batch
    monkeypatch.setitem(texp_mod.SOLVER_REGISTRY, agent,
                        functools.partial(texp_mod.SOLVER_REGISTRY[agent], **{switch: False}))
    monkeypatch.setattr(texp_mod, "run_episodes_fused",
                        lambda *a, **k: seen.append("fused") or real_fused(*a, **k))
    monkeypatch.setattr(texp_mod, "run_episodes_batch",
                        lambda *a, **k: seen.append("plain") or real_batch(*a, **k))
    env, start = {"ILQR": ("pendulum", [3.0, 0.0]), "SQP": ("acrobot", [0.1, 0.0, 0.2, 0.0]),
                  "I2C": ("pendulum", [3.0, 0.0])}[agent]
    params = dict(env=env, agent=agent, agent_config={"T": 4, "max_iter": 1},
                  experiment_length=1, start_state=start, repetitions=2, fused=False)
    texp_mod.Experiment(params, device="cpu").run()
    assert seen == ["plain", "plain"]
