"""Port vs reference: the two kernels' plain versions against the JAX
Pallas kernels run in interpret mode on the CPU.

``fused_mppi_step`` on a CPU tensor runs its plain version, which draws the
reference's interpret-mode noise stream exactly, so the comparison is exact
in the noise. Tolerance rtol 2e-4 / atol 2e-5, the reference kernel test's
own (tests/test_fused.py): float32 rollouts in both, summed in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu import models as jmodels
from benchmarking_mpc_solvers_tpu.ops import fused as jfused
from benchmarking_mpc_solvers_tpu.ops import fused_mppi as jfused_mppi
from benchmarking_mpc_solvers_tpu_torch import models as tmodels
from benchmarking_mpc_solvers_tpu_torch.ops import fused as tfused
from benchmarking_mpc_solvers_tpu_torch.ops import fused_mppi as tfused_mppi

RTOL, ATOL = 2e-4, 2e-5


def _mppi_inputs(model, T, B, seed):
    rng = np.random.default_rng(seed)
    g_z = rng.uniform(-0.2, 0.2, (T, model.goal_size)).astype(np.float32)
    x0_tm = rng.uniform(-1, 1, (model.state_size, B)).astype(np.float32)
    plan_tm = rng.uniform(-0.5, 0.5, (T, B)).astype(np.float32)
    return plan_tm, x0_tm, g_z


def _both(name, K, std, lam, lanes, plan_tm, x0_tm, g_z, seed):
    want = jfused_mppi.fused_mppi_step(jmodels.REGISTRY[name], K, std, lam, lanes,
                                       jnp.asarray(plan_tm), jnp.asarray(x0_tm),
                                       jnp.asarray(g_z), seed)
    got = tfused_mppi.fused_mppi_step(tmodels.REGISTRY[name], K, std, lam, lanes,
                                      torch.tensor(plan_tm), torch.tensor(x0_tm),
                                      torch.tensor(g_z), seed)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", [7, 2**31 - 2, -(2**31) + 3])
def test_interp_normals_match(seed):
    for t in (0, 3, 49):
        want = np.asarray(jfused_mppi.interp_normals(jnp.int32(seed), t, 128))
        got = tfused_mppi.interp_normals(seed, t, 128).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup"])
@pytest.mark.parametrize("seed", [7, 2**31 - 2])
def test_fused_mppi_step_plain_matches_reference_kernel(name, seed):
    T, K, B, lanes = 5, 4, 16, 128
    plan_tm, x0_tm, g_z = _mppi_inputs(jmodels.REGISTRY[name], T, B, 1)
    got, want = _both(name, K, 0.7, 0.5, lanes, plan_tm, x0_tm, g_z, seed)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fused_mppi_step_plain_multi_tile():
    """Two grid programs (B = 2 tiles at lanes=128): the pid-strided seeds
    and the slot of every scenario must follow the reference's layout."""
    T, K, lanes = 4, 3, 128
    B = 2 * 8 * lanes
    plan_tm, x0_tm, g_z = _mppi_inputs(jmodels.PendulumModel, T, B, 2)
    got, want = _both("pendulum", K, 1.0, 1.0, lanes, plan_tm, x0_tm, g_z, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pick_lanes_matches_reference():
    for B in (16, 1000, 1024, 2048, 4096, 8192, 10240, 12288, 5000):
        assert tfused_mppi.pick_lanes(B) == jfused_mppi.pick_lanes(B)


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup", "acrobot"])
@pytest.mark.parametrize("N", [128, 200])  # one tile, and a padded one
def test_fused_rollout_costs_plain_matches_reference_kernel(name, N):
    jm, tm = jmodels.REGISTRY[name], tmodels.REGISTRY[name]
    T = 7
    rng = np.random.default_rng(4)
    x0_tm = rng.uniform(-1, 1, (jm.state_size, N)).astype(np.float32)
    us_tm = rng.uniform(-1.5, 1.5, (T, N)).astype(np.float32)
    g_z = rng.uniform(-0.5, 0.5, (T, jm.goal_size)).astype(np.float32)
    want = np.asarray(jfused.fused_rollout_costs_tm(jm, jnp.asarray(x0_tm), jnp.asarray(us_tm),
                                                    jnp.asarray(g_z), 128))
    got = tfused.fused_rollout_costs_tm(tm, torch.tensor(x0_tm), torch.tensor(us_tm),
                                        torch.tensor(g_z))
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4)


def test_wrappers_count_no_launch_on_cpu():
    """On CPU tensors the wrappers run the plain version and launch nothing."""
    tm = tmodels.PendulumModel
    before = (tfused_mppi.fused_mppi_step.launches, tfused.fused_rollout_costs_tm.launches)
    plan = torch.zeros((3, 4))
    x0 = torch.zeros((2, 4))
    gz = torch.zeros((3, 3))
    tfused_mppi.fused_mppi_step(tm, 2, 1.0, 1.0, 128, plan, x0, gz, 0)
    tfused.fused_rollout_costs_tm(tm, x0, plan, gz)
    assert (tfused_mppi.fused_mppi_step.launches,
            tfused.fused_rollout_costs_tm.launches) == before


@pytest.mark.parametrize("name", ["synthetic", "pendulum"])
def test_wrappers_reject_models_without_device_function(name):
    """A model without a CUDA device function raises before anything reaches
    the card, also when it reuses a registered name with other physics; the
    registered models map to their functors."""
    from benchmarking_mpc_solvers_tpu_torch import _build
    from benchmarking_mpc_solvers_tpu_torch.models.base import Model, quad_cost

    odd = Model(name=name, state_size=2, action_size=1, bounds_low=(-1.0,),
                bounds_high=(1.0,), dynamics=None, transform=None,
                state_cost=quad_cost(np.eye(3)), terminal_cost=quad_cost(np.eye(3)))
    with pytest.raises(NotImplementedError):
        _build.model_id(odd)
    assert [_build.model_id(tmodels.REGISTRY[n]) for n in _build.DEVICE_MODELS] == [0, 1, 2]


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup", "acrobot"])
def test_batch_major_wrappers_match_reference(name):
    """``fused_rollout_costs`` (N, S), (N, T) and ``fused_rollout_cost_samples``
    (K samples from one state) against the reference's, whose Pallas kernel
    runs in interpret mode at one tile (N = K = 100 of 128 lanes); each
    wrapper equals its plain version bit for bit on the CPU."""
    jm, tm = jmodels.REGISTRY[name], tmodels.REGISTRY[name]
    T, N = 7, 100
    rng = np.random.default_rng(5)
    x0b = rng.uniform(-1, 1, (N, jm.state_size)).astype(np.float32)
    usb = rng.uniform(-1.5, 1.5, (N, T)).astype(np.float32)
    g_z = rng.uniform(-0.5, 0.5, (T, jm.goal_size)).astype(np.float32)
    want = np.asarray(jfused.fused_rollout_costs(jm, jnp.asarray(x0b), jnp.asarray(usb),
                                                 jnp.asarray(g_z), 128))
    args = (tm, torch.tensor(x0b), torch.tensor(usb), torch.tensor(g_z))
    got = tfused.fused_rollout_costs(*args)
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4)
    torch.testing.assert_close(got, tfused.fused_rollout_costs_reference(*args), rtol=0, atol=0)

    samples = usb[..., None]
    want = np.asarray(jfused.fused_rollout_cost_samples(jm, jnp.asarray(x0b[0]),
                                                        jnp.asarray(samples), jnp.asarray(g_z),
                                                        128))
    args = (tm, torch.tensor(x0b[0]), torch.tensor(samples), torch.tensor(g_z))
    got = tfused.fused_rollout_cost_samples(*args)
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4)
    torch.testing.assert_close(got, tfused.fused_rollout_cost_samples_reference(*args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup", "acrobot"])
def test_rollout_cost_samples_matches_reference(name):
    """``rollout_cost_samples``: (S,), (K, T, A) -> (K,) costs and (K, S)
    final states, against the reference's vmap of ``rollout_cost``."""
    from benchmarking_mpc_solvers_tpu.ops import rollout_cost_samples as j_samples
    from benchmarking_mpc_solvers_tpu_torch.ops import rollout_cost_samples as t_samples

    jm, tm = jmodels.REGISTRY[name], tmodels.REGISTRY[name]
    T, K = 6, 5
    rng = np.random.default_rng(6)
    x0 = rng.uniform(-1, 1, (jm.state_size,)).astype(np.float32)
    samples = rng.uniform(-1.5, 1.5, (K, T, 1)).astype(np.float32)
    g_z = rng.uniform(-0.5, 0.5, (T, jm.goal_size)).astype(np.float32)
    want = j_samples(jm, jnp.asarray(x0), jnp.asarray(samples), jnp.asarray(g_z))
    got = t_samples(tm, torch.tensor(x0), torch.tensor(samples), torch.tensor(g_z))
    assert got[0].shape == (K,) and got[1].shape == (K, jm.state_size)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-4)
