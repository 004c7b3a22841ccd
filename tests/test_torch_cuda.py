"""The port's CUDA kernels on the card against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip without them.
On the card (where JAX is absent, so without the suite's conftest):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance rtol/atol 1e-4: both sides run float32 one IEEE operation at a
time (the kernels are built with --fmad=false); only summation orders in
the softmax and plan update differ.
"""

import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
from benchmarking_mpc_solvers_tpu_torch.ops.fused import (
    fused_rollout_costs_tm,
    fused_rollout_costs_tm_reference,
)
from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import (
    fused_mppi_step,
    fused_mppi_step_reference,
    pick_lanes,
)

pytestmark = pytest.mark.cuda
NAMES = ["pendulum", "cartpole_swingup", "acrobot"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


@pytest.mark.parametrize("name", NAMES)
def test_fused_mppi_kernel_matches_plain(dev, name):
    model = REGISTRY[name]
    T, B, K = 12, 1500, 32
    rng = np.random.default_rng(0)
    plan = _t(rng.uniform(-0.5, 0.5, (T, B)), dev)
    x0 = _t(rng.uniform(-1, 1, (model.state_size, B)), dev)
    gz = _t(rng.uniform(-0.2, 0.2, (T, model.goal_size)), dev)
    lanes = pick_lanes(B)
    before = fused_mppi_step.launches
    got = fused_mppi_step(model, K, 0.9, 0.7, lanes, plan, x0, gz, 2**31 - 5)
    torch.cuda.synchronize()
    assert fused_mppi_step.launches == before + 1
    want = fused_mppi_step_reference(model, K, 0.9, 0.7, lanes, plan, x0, gz, 2**31 - 5)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_fused_rollout_kernel_matches_plain(dev, name):
    model = REGISTRY[name]
    T, N = 20, 5000
    rng = np.random.default_rng(1)
    x0 = _t(rng.uniform(-1, 1, (model.state_size, N)), dev)
    us = _t(rng.uniform(-1.5, 1.5, (T, N)), dev)
    gz = _t(rng.uniform(-0.2, 0.2, (T, model.goal_size)), dev)
    before = fused_rollout_costs_tm.launches
    got = fused_rollout_costs_tm(model, x0, us, gz)
    torch.cuda.synchronize()
    assert fused_rollout_costs_tm.launches == before + 1
    torch.testing.assert_close(got, fused_rollout_costs_tm_reference(model, x0, us, gz),
                               rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_bad_arguments(dev):
    model = REGISTRY["pendulum"]
    plan = torch.zeros((4, 8), device=dev, dtype=torch.float64)
    x0 = torch.zeros((2, 8), device=dev)
    gz = torch.zeros((4, 3), device=dev)
    with pytest.raises(TypeError):
        fused_mppi_step(model, 4, 1.0, 1.0, 128, plan, x0, gz, 0)
    with pytest.raises(ValueError):
        fused_rollout_costs_tm(model, x0, torch.zeros((4, 8), device=dev).T, gz)
