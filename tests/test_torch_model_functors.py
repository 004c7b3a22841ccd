"""Port vs reference: the models the model-calling kernels take beyond the
three plants as registered, and the map from a model to its device functor.

The reference's kernels 1, 2, 3, 4 and 6 trace any model whose functions
act element by element over the leading axes: the dummy family
(``make_dummy_model(S, 1)``) and the plants under other ``quad_cost``
weights. The port's plain versions of those kernels are held here against
the JAX kernels run in interpret mode on ``DummyModel``, the dummy at S = 1,
8, 9, 16, 31 and 33 (kernels 1, 2 and 3 take S > 8 in their dummy form, S an
argument; kernel 2 holds S up to 32 in registers), the dummy at S = 16 under four other weights
(``test_torch_dummy_split.py``), and cart-pole with configuration 2's weights
(``scripts/bench_suite.py:184-185``), with actions beyond the dummy's ±1
bounds (its transform sees u unclipped). The noise is the reference's
interpret-mode stream, which the plain versions draw exactly. Tolerances
are those of the plants' tests: kernel 1 rtol 2e-4 / atol 2e-5
(``test_torch_fused.py``), kernel 2 rtol 2e-4 / atol 1e-4, kernel 3 rtol
2e-4 / atol 1e-3 (its std of nearly equal elites, ``test_torch_cem.py``),
kernel 4 1e-5 (``test_torch_fused_derivs.py``), kernel 6 1e-5 on controls
and states and 1e-4 on costs (``test_torch_linesearch.py``).

The reference's kernels do not trace the linear model (its ``A @ x``
contracts the wrong axis of the lane tiles), and the card refuses it before
anything launches; on the CPU the plain versions take it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import models as jmodels
from benchmarking_mpc_solvers_tpu.envs import PendulumEnv as JPendulumEnv
from benchmarking_mpc_solvers_tpu.experiment import EpisodeConfig as JConfig
from benchmarking_mpc_solvers_tpu.experiment import run_episodes_fused as j_run_fused
from benchmarking_mpc_solvers_tpu.models.base import quad_cost as jquad_cost
from benchmarking_mpc_solvers_tpu.ops import fused as jfused
from benchmarking_mpc_solvers_tpu.ops import fused_cem as jfused_cem
from benchmarking_mpc_solvers_tpu.ops import fused_derivs as jfused_derivs
from benchmarking_mpc_solvers_tpu.ops import fused_linesearch as jfused_linesearch
from benchmarking_mpc_solvers_tpu.ops import fused_mppi as jfused_mppi
from benchmarking_mpc_solvers_tpu.solvers import CEM as JCEM
from benchmarking_mpc_solvers_tpu.solvers import MPPI as JMPPI
from benchmarking_mpc_solvers_tpu_torch import _build
from benchmarking_mpc_solvers_tpu_torch import models as tmodels
from benchmarking_mpc_solvers_tpu_torch.envs import PendulumEnv as TPendulumEnv
from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
from benchmarking_mpc_solvers_tpu_torch.models.base import Model
from benchmarking_mpc_solvers_tpu_torch.models.base import quad_cost as tquad_cost
from benchmarking_mpc_solvers_tpu_torch.ops import fused as tfused
from benchmarking_mpc_solvers_tpu_torch.ops import fused_cem as tfused_cem
from benchmarking_mpc_solvers_tpu_torch.ops import fused_mppi as tfused_mppi
from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import fused_derivs
from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import fused_linesearch
from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, ILQR, MPPI, SQP
from benchmarking_mpc_solvers_tpu_torch.solvers.base import check_device_functor
from test_torch_dummy_split import _weights as dummy_weights
from test_torch_episode import _reference_seeds

# configuration 2's weights on cart-pole's features (scripts/bench_suite.py:184-185)
W_CART2 = np.diag(np.array([0.5, 0.1, 5.0, 0.5, 0.1], dtype=np.float32))


def _pair(name):
    """(JAX model, port model) of one case; ``dummy<S>-<weights>``: the
    dummy under ``test_torch_dummy_split._weights``."""
    if name.startswith("dummy"):
        S, _, weights = name[len("dummy"):].partition("-")
        pair = jmodels.make_dummy_model(int(S), 1), tmodels.make_dummy_model(int(S), 1)
        if not weights:
            return pair
        W = dummy_weights(weights, int(S))
        return (dataclasses.replace(pair[0], state_cost=jquad_cost(W)),
                dataclasses.replace(pair[1], state_cost=tquad_cost(W)))
    return (dataclasses.replace(jmodels.CartPoleSwingUpModel, state_cost=jquad_cost(W_CART2)),
            dataclasses.replace(tmodels.CartPoleSwingUpModel, state_cost=tquad_cost(W_CART2)))


# dummy9 to dummy31: kernels 1, 2 and 3 take the dummy at any S (their dummy
# form, S an argument); kernels 4 and 6 stop at S = 8 (the Riccati kernel's
# state bound keeps larger S off their tiers in both packages). dummy16-*:
# the weights that send kernels 1 and 3's dummy form down its other paths
# (test_torch_dummy_split.py); dummy33: past kernel 2's widest row of
# registers (its list form, ops/fused.py: dummy_plan)
MODELS = ["dummy2", "dummy1", "dummy8", "cartpole_reweighted", "dummy9", "dummy16", "dummy31",
          "dummy16-dense", "dummy16-midlist", "dummy16-noaction", "dummy16-offsquare",
          "dummy33"]
# the reference's kernel 4 pushes a tangent per state: in interpret mode it
# takes 38 s at S = 16 and 188 s at S = 31, so its test stops at S = 9
DERIV_MODELS = MODELS[:5]
T, B = 8, 16


def _inputs(model, seed):
    """plan (T, B) with samples beyond ±1, x0 (S, B), g_z (T, Z)."""
    rng = np.random.default_rng(seed)
    plan = rng.uniform(-1.5, 1.5, (T, B)).astype(np.float32)
    x0 = rng.uniform(-1, 1, (model.state_size, B)).astype(np.float32)
    gz = rng.uniform(-0.2, 0.2, (T, model.goal_size)).astype(np.float32)
    return plan, x0, gz


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", MODELS)
def test_mppi_step_plain_matches_reference_kernel(name):
    jm, tm = _pair(name)
    plan, x0, gz = _inputs(jm, 1)
    want = jfused_mppi.fused_mppi_step(jm, 4, 0.7, 0.5, 128, jnp.asarray(plan),
                                       jnp.asarray(x0), jnp.asarray(gz), 7)
    got = tfused_mppi.fused_mppi_step(tm, 4, 0.7, 0.5, 128, torch.tensor(plan),
                                      torch.tensor(x0), torch.tensor(gz), 7)
    _close(got.numpy(), want, 2e-4, 2e-5)


@pytest.mark.parametrize("name", MODELS)
def test_rollout_costs_plain_matches_reference_kernel(name):
    jm, tm = _pair(name)
    plan, x0, gz = _inputs(jm, 2)
    want = jfused.fused_rollout_costs_tm(jm, jnp.asarray(x0), jnp.asarray(plan),
                                         jnp.asarray(gz), 128)
    got = tfused.fused_rollout_costs_tm(tm, torch.tensor(x0), torch.tensor(plan),
                                        torch.tensor(gz))
    _close(got.numpy(), want, 2e-4, 1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_cem_step_plain_matches_reference_kernel(name):
    jm, tm = _pair(name)
    plan, x0, gz = _inputs(jm, 3)
    args = (8, 3, 2, 0.2, 0.9, 128)
    want = jfused_cem.fused_cem_step(jm, *args, jnp.asarray(plan), jnp.asarray(x0),
                                     jnp.asarray(gz), 2**31 - 2)
    got = tfused_cem.fused_cem_step(tm, *args, torch.tensor(plan), torch.tensor(x0),
                                    torch.tensor(gz), 2**31 - 2)
    _close(got.numpy(), want, 2e-4, 1e-3)


@pytest.mark.parametrize("name", DERIV_MODELS)
def test_derivs_plain_matches_reference_kernel(name):
    """At T = 4: the interpret-mode kernel runs a grid step per t."""
    jm, tm = _pair(name)
    rng = np.random.default_rng(4)
    S, Td = jm.state_size, 4
    xs = rng.uniform(-1.2, 1.2, (B, Td + 1, S)).astype(np.float32)
    us = rng.uniform(-1.5, 1.5, (B, Td, 1)).astype(np.float32)
    us[::5, ::3] = 1.0  # on the action bound: cart-pole's clip passes half its tangent
    gz = rng.uniform(-0.2, 0.2, (Td, jm.goal_size)).astype(np.float32)
    want = jfused_derivs.fused_derivs(jm, jnp.asarray(xs), jnp.asarray(us), jnp.asarray(gz))
    before = fused_derivs.launches
    got = fused_derivs(tm, torch.tensor(xs), torch.tensor(us), torch.tensor(gz))
    assert fused_derivs.launches == before  # no launch on the CPU
    for key, g, w in zip(("A", "Bd", "c", "Q", "R", "M", "q", "r"), got, want):
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", MODELS)
def test_linesearch_plain_matches_reference_kernel(name):
    jm, tm = _pair(name)
    rng = np.random.default_rng(5)
    S = jm.state_size
    alphas = (1.1 ** (-np.arange(4, dtype=np.float32) ** 2)).astype(np.float32)
    arrays = [a.astype(np.float32) for a in (
        0.5 * rng.standard_normal((B, S)), rng.uniform(-1.5, 1.5, (B, T, 1)),
        0.3 * rng.standard_normal((B, T, 1)), 0.2 * rng.standard_normal((B, T, 1, S)),
        0.3 * rng.standard_normal((B, T + 1, S)), rng.uniform(-0.2, 0.2, (T, jm.goal_size)))]
    want = jfused_linesearch.fused_linesearch(
        jm, jnp.asarray(alphas), *(jnp.asarray(a) for a in arrays), with_terminal=True,
        interpret=True, return_states=True)
    got = fused_linesearch(
        tm, torch.tensor(alphas), *(torch.tensor(a) for a in arrays), with_terminal=True,
        return_states=True)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-4 if i == 2 else 1e-5  # the costs last
        _close(g.numpy(), w, tol, tol)


def test_dummy_kernel_episode_matches_reference():
    """The dummy's closed loop through ``run_episodes_fused`` on the MPPI
    kernel tier, with the reference's per-call seeds, against the JAX
    package's (its kernel in interpret mode)."""
    Bn, Tn, K, steps, warm = 16, 8, 8, 4, 2
    jenv = dataclasses.replace(JPendulumEnv, name="dummy", model=jmodels.DummyModel,
                               default_start=(0.5, -0.3))
    tenv = dataclasses.replace(TPendulumEnv, name="dummy", model=tmodels.DummyModel,
                               default_start=(0.5, -0.3))
    x0s = (np.tile(np.asarray(tenv.default_start, np.float32), (Bn, 1))
           + 0.3 * np.random.default_rng(0).standard_normal((Bn, 2))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), Bn)
    want = j_run_fused(jenv, JMPPI(model=jenv.model, T=Tn, K=K),
                       JConfig(n_steps=steps, warmstart=warm, record_plans=True), keys,
                       jnp.asarray(x0s))
    got = run_episodes_fused(tenv, MPPI(model=tenv.model, T=Tn, K=K),
                             EpisodeConfig(n_steps=steps, warmstart=warm, record_plans=True),
                             torch.tensor(x0s), seeds=_reference_seeds(keys, warm + steps),
                             device="cpu")
    for field in ("costs", "true_actions", "true_states", "planned_actions",
                  "warmstart_trajectories"):
        _close(getattr(got, field).numpy(), getattr(want, field), 1e-4, 1e-4)


@pytest.mark.parametrize("S", [9, 16, 31])
def test_dummy_past_eight_takes_the_reference_kernel_tier(S):
    """Past S = 8 both packages send MPPI and CEM to their single-kernel
    tier (``kernel_ok``) and the port no longer refuses the model on the
    card; the closed loop on the MPPI kernel tier, with the reference's
    per-call seeds, matches the JAX package's (its kernel in interpret
    mode), at the episode test's tolerance."""
    jm, tm = _pair(f"dummy{S}")
    for J, P in ((JMPPI, MPPI), (JCEM, CEM)):
        assert J(model=jm, T=4).kernel_ok() and P(model=tm, T=4).kernel_ok()
    check_device_functor("run_episodes_fused", tm, "cuda")  # no CUDA needed: it only looks
    Bn, Tn, K, steps, warm = 8, 6, 8, 2, 1
    start = tuple(np.linspace(-0.5, 0.5, S).tolist())
    jenv = dataclasses.replace(JPendulumEnv, name="dummy", model=jm, default_start=start)
    tenv = dataclasses.replace(TPendulumEnv, name="dummy", model=tm, default_start=start)
    x0s = (np.tile(np.asarray(start, np.float32), (Bn, 1))
           + 0.3 * np.random.default_rng(S).standard_normal((Bn, S))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(S), Bn)
    want = j_run_fused(jenv, JMPPI(model=jm, T=Tn, K=K),
                       JConfig(n_steps=steps, warmstart=warm, record_plans=False), keys,
                       jnp.asarray(x0s))
    got = run_episodes_fused(tenv, MPPI(model=tm, T=Tn, K=K),
                             EpisodeConfig(n_steps=steps, warmstart=warm, record_plans=False),
                             torch.tensor(x0s), seeds=_reference_seeds(keys, warm + steps),
                             device="cpu")
    for field in ("costs", "true_actions", "true_states"):
        _close(getattr(got, field).numpy(), getattr(want, field), 1e-4, 1e-4)


@pytest.mark.parametrize("S", _build.DUMMY_STATES + (9, 16, 31, 64))
def test_dummy_family_maps_to_its_functor(S):
    """Every make_dummy_model(S, 1) shares the dummy's functions, and so its
    ``Dummy<S>`` functor (S ≤ 8), or kernels 1, 2 and 3's dummy form (any
    larger S: ``dummy_size``), whatever its weights; the dummy form's terms
    are the cost's nonzero terms in quad_cost's order."""
    model = tmodels.make_dummy_model(S, 1)
    other = dataclasses.replace(model, state_cost=tquad_cost(2.0 * np.eye(S + 1)))
    if S in _build.DUMMY_STATES:
        assert _build.dummy_size(model) is None
        assert _build.model_id(model) == _build.dummy_id(S)
        assert _build.model_id(other) == _build.model_id(model)
    else:
        assert _build.dummy_size(model) == _build.dummy_size(other) == S
        terms, n_lead = _build.dummy_terms(other.state_cost, "cpu")
        assert _build.dummy_terms(other.state_cost, "cpu")[0] is terms  # built once
        assert terms.tolist() == [[i, i, int(np.float32(2.0).view(np.int32)), 0]
                                  for i in range(S + 1)]
        assert n_lead == S  # the state's squares lead, the action's is the tail
    check_device_functor("test", model, "cuda")  # no CUDA needed: it only looks


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup", "acrobot"])
def test_reweighted_and_rebounded_plants_map_to_their_functor(name):
    plant = tmodels.REGISTRY[name]
    Z = plant.goal_size
    W = np.random.default_rng(1).uniform(0.0, 2.0, (Z, Z)).astype(np.float32)
    for model in (dataclasses.replace(plant, state_cost=tquad_cost(W),
                                      terminal_cost=tquad_cost(W.T)),
                  dataclasses.replace(plant, bounds_low=(-0.5,), bounds_high=(0.5,))):
        assert _build.model_id(model) == _build.DEVICE_MODELS.index(name)


def _linear():
    return tmodels.make_linear_model(np.eye(2), np.ones((2, 1)), np.eye(2), np.eye(1),
                                     bounds=50.0)


@pytest.mark.parametrize("case", ["linear", "foreign under a plant's name", "dummy S=9",
                                  "dummy A=2"])
def test_models_without_a_functor_are_refused(case):
    """Refused with the model's name, the reason and the way round; on a
    CUDA device the early check refuses it the same way. The dummy at S = 9
    has no ``Dummy<S>`` functor, so kernels 4 and 6 refuse it by name, but
    kernels 1, 2 and 3 take it in their dummy form: the early check lets it
    through."""
    model = {
        "linear": _linear,
        "foreign under a plant's name": lambda: Model(
            name="pendulum", state_size=2, action_size=1, bounds_low=(-1.0,),
            bounds_high=(1.0,), dynamics=tmodels.synthetic.dummy_dynamics,
            transform=tmodels.pendulum.transform, state_cost=tquad_cost(np.eye(3)),
            terminal_cost=tquad_cost(np.eye(3))),
        "dummy S=9": lambda: tmodels.make_dummy_model(9, 1),
        "dummy A=2": lambda: tmodels.make_dummy_model(2, 2),
    }[case]()
    with pytest.raises(NotImplementedError, match=f"model {model.name!r}: .*use_fused=False"):
        _build.model_id(model)
    if case == "dummy S=9":
        assert _build.dummy_size(model) == 9
        check_device_functor("run_episodes_fused", model, "cuda")
    else:
        assert _build.dummy_size(model) is None
        with pytest.raises(NotImplementedError, match="no CUDA device function"):
            check_device_functor("run_episodes_fused", model, "cuda")
    check_device_functor("run_episodes_fused", model, "cpu")  # the CPU takes every model
    if case == "linear":
        with pytest.raises(NotImplementedError, match="do not trace either"):
            _build.model_id(model)


def test_plain_versions_take_the_linear_model_on_the_cpu():
    """On the CPU nothing is refused: the MPPI kernel tier's plain version
    and iLQR's fused tier run the linear model."""
    model = _linear()
    env = dataclasses.replace(TPendulumEnv, name="linear", model=model,
                              default_start=(0.5, -0.5))
    x0s = env.start_state("cpu").expand(4, -1)
    cfg = EpisodeConfig(n_steps=2, record_plans=False)
    for solver in (MPPI(model=model, T=5, K=4), ILQR(model=model, T=5, max_iter=2)):
        res = run_episodes_fused(env, solver, cfg, x0s, device="cpu")
        assert bool(torch.isfinite(res.costs).all())


def test_solvers_say_which_fused_stages_call_the_model():
    """The early check runs where a kernel of the fused tier calls the model:
    MPPI and CEM (kernel 2), SQP (kernels 4 and 6), iLQR where kernel 4 or 6
    is routed (not under model noise without Gauss-Newton: kernel 5 alone
    sees only matrices), none under pallas_backward=False."""
    m = tmodels.DummyModel
    assert MPPI(model=m, T=4).calls_model_kernels()
    assert CEM(model=m, T=4).calls_model_kernels()
    assert SQP(model=m, T=4).calls_model_kernels()
    assert not SQP(model=m, T=4, pallas_backward=False).calls_model_kernels()
    assert ILQR(model=m, T=4).calls_model_kernels()
    assert not ILQR(model=m, T=4, model_noise_std=0.1).calls_model_kernels()
    assert ILQR(model=m, T=4, model_noise_std=0.1, gauss_newton=True).calls_model_kernels()
    assert not ILQR(model=m, T=4, pallas_backward=False).calls_model_kernels()
    assert ILQR(model=m, T=4).has_kernel_stages() and SQP(model=m, T=4).has_kernel_stages()


@pytest.mark.parametrize("kernel", ["fused_mppi_step", "fused_linesearch"])
def test_reference_kernels_refuse_the_linear_model(kernel):
    """The reference's kernels call the model's dynamics on lane tiles of
    shape (S, 8, lanes); the linear model's ``A @ x`` contracts the wrong
    axis there, so tracing raises (ROADMAP.md §3, the reference's
    behaviour)."""
    jm = jmodels.make_linear_model(np.eye(2), np.ones((2, 1)), np.eye(2), np.eye(1),
                                   bounds=50.0)
    plan, x0, gz = _inputs(jm, 6)
    with pytest.raises(TypeError, match="dot_general requires contracting dimensions"):
        if kernel == "fused_mppi_step":
            jfused_mppi.fused_mppi_step(jm, 4, 0.7, 0.5, 128, jnp.asarray(plan),
                                        jnp.asarray(x0), jnp.asarray(gz), 7)
        else:
            jfused_linesearch.fused_linesearch(
                jm, jnp.ones(3), jnp.asarray(x0.T), jnp.asarray(plan.T[..., None]),
                jnp.zeros((B, T, 1)), jnp.zeros((B, T, 1, 2)), jnp.zeros((B, T + 1, 2)),
                jnp.asarray(gz), interpret=True)
