"""The port's CUDA kernels on the card against their plain versions.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip without them.
On the card (where JAX is absent, so without the suite's conftest):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance rtol/atol 1e-4: both sides run float32 one IEEE operation at a
time (the kernels are built with --fmad=false); only summation orders in
the softmax and plan update differ. The rollout-cost kernel sums each
rollout's steps in the plain version's order and must match it bit for bit.
The CEM kernel sums its moments in the plain version's order, and its plan and elite masks must match exactly, as
must every output of the line-search kernel. The Riccati kernel sums every
entry in the plain version's order and must match it bit for bit, its
``ok`` flags included.
The derivative kernel pushes forward-mode tangents where its plain version
differentiates in reverse mode: the same formulas in another order, well
inside 1e-4. The ADMM kernel sums its matvec in the plain version's order
and must match it bit for bit, and so must the Kalman-filter and
RTS-smoother kernels, whose every sum follows the plain version's order.
"""

import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu_torch.models import REGISTRY
from benchmarking_mpc_solvers_tpu_torch.ops.fused import (
    fused_rollout_costs_tm,
    fused_rollout_costs_tm_reference,
)
from benchmarking_mpc_solvers_tpu_torch.ops.fused_cem import (
    fused_cem_step,
    fused_cem_step_reference,
)
from benchmarking_mpc_solvers_tpu_torch.ops.fused_derivs import (
    fused_derivs,
    fused_derivs_reference,
)
from benchmarking_mpc_solvers_tpu_torch.ops.fused_linesearch import (
    fused_linesearch,
    fused_linesearch_reference,
)
from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import (
    fused_mppi_step,
    fused_mppi_step_reference,
    pick_lanes,
)
from benchmarking_mpc_solvers_tpu_torch.ops.qp_admm import (
    admm_iterate,
    admm_iterate_reference,
)
from benchmarking_mpc_solvers_tpu_torch.ops.riccati_backward import (
    riccati_backward_batch,
    riccati_backward_batch_reference,
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
    _bits(got, fused_rollout_costs_tm_reference(model, x0, us, gz))


# K = 48 gives lanes one sample and lanes two, with a ragged last block; K =
# 64 two samples a lane, with blocks above 48 KB of shared memory (the
# sweep's MPPI row); K·T = 48·90 puts pass 1's noise (17,280 bytes a
# scenario) above the kernel's 13 KB cache, so pass 2 draws it again
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("K,T,B,cache", [(48, 17, 1001, True), (64, 50, 1030, True),
                                         (48, 90, 777, False)],
                         ids=["K48-ragged-block", "K64", "cache-above-budget"])
def test_fused_mppi_kernel_edges(dev, name, K, T, B, cache):
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import launch_config

    model = REGISTRY[name]
    rng = np.random.default_rng(K + T)
    plan = _t(rng.uniform(-0.5, 0.5, (T, B)), dev)
    x0 = _t(rng.uniform(-1, 1, (model.state_size, B)), dev)
    gz = _t(rng.uniform(-0.2, 0.2, (T, model.goal_size)), dev)
    assert launch_config(model, T, K, B)["noise_cache"] is cache
    lanes = pick_lanes(B)
    before = fused_mppi_step.launches
    got = fused_mppi_step(model, K, 0.9, 0.7, lanes, plan, x0, gz, 2**31 - 5)
    torch.cuda.synchronize()
    assert fused_mppi_step.launches == before + 1
    want = fused_mppi_step_reference(model, K, 0.9, 0.7, lanes, plan, x0, gz, 2**31 - 5)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# one block plus one rollout at one step (no action to load ahead), and 16
# blocks plus one at 23 steps
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("N,T", [(257, 1), (4097, 23)])
def test_fused_rollout_kernel_ragged_n(dev, name, N, T):
    model = REGISTRY[name]
    rng = np.random.default_rng(N + T)
    x0 = _t(rng.uniform(-1, 1, (model.state_size, N)), dev)
    us = _t(rng.uniform(-1.5, 1.5, (T, N)), dev)
    gz = _t(rng.uniform(-0.2, 0.2, (T, model.goal_size)), dev)
    got = fused_rollout_costs_tm(model, x0, us, gz)
    torch.cuda.synchronize()
    _bits(got, fused_rollout_costs_tm_reference(model, x0, us, gz))


@pytest.mark.parametrize("name", NAMES)
def test_mppi_and_rollout_launch_shapes(dev, name):
    """The bench shape and the sweep's MPPI row keep the noise in shared
    memory (the row's blocks above the default 48 KB); above the cache's
    budget only the weights are kept."""
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import launch_config as rollout_config
    from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import launch_config

    model = REGISTRY[name]
    for (T, K, B), cache in (((50, 32, 8192), True), ((50, 64, 10240), True),
                             ((90, 48, 777), False)):
        c = launch_config(model, T, K, B)
        assert c["noise_cache"] is cache
        assert c["scenarios_per_block"] == 4 and c["threads"] == 128
        assert c["blocks"] == -(-B // 4)
        assert c["shared_bytes"] == 4 * 4 * (K + (K * T if cache else 0))
        assert 0 < c["registers"] <= 255 and c["blocks_per_sm"] >= (4 if cache else 8)
    r = rollout_config(model, 262144)
    assert (r["threads"], r["blocks"]) == (256, 1024)
    assert 0 < r["registers"] <= 255 and r["blocks_per_sm"] >= 1


def test_mppi_and_rollout_kernels_refuse_other_weights(dev):
    """Kernels 1 and 2 are compiled for the model's own nonzero cost terms:
    a weight array with another term is refused before anything launches."""
    import ctypes

    from benchmarking_mpc_solvers_tpu_torch import _build

    model = REGISTRY["cartpole_swingup"]
    w = (ctypes.c_float * (_build.MAX_Z * _build.MAX_Z))()
    ctypes.memmove(w, _build.quad_weights(model.state_cost), ctypes.sizeof(w))
    w[1 * _build.MAX_Z + 1] = 1.0  # W_11, zero in cart-pole's cost
    T, B, K = 4, 8, 32
    plan, out = torch.zeros((T, B), device=dev), torch.full((T, B), 7.0, device=dev)
    x0, gz = torch.zeros((4, B), device=dev), torch.zeros((T, 5), device=dev)
    stream = _build.stream_ptr(dev)
    mid = _build.model_id(model)
    rc = _build.kernel_fn("fused_mppi_step_launch")(
        mid, _build.ptr(plan), _build.ptr(x0), _build.ptr(gz), _build.ptr(out), T, B, K, 1.0,
        1.0, 1.0, 0, 128, 128, w, stream)
    assert rc != 0
    costs = torch.full((B,), 7.0, device=dev)
    rc = _build.kernel_fn("fused_rollout_costs_launch")(
        mid, _build.ptr(x0), _build.ptr(plan), _build.ptr(gz), _build.ptr(costs), T, B, w, stream)
    assert rc != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and bool((costs == 7.0).all())


@pytest.mark.parametrize("name", NAMES)
def test_fused_cem_kernel_matches_plain(dev, name):
    model = REGISTRY[name]
    T, B, K, n_elite, max_iter = 10, 1500, 40, 5, 3
    rng = np.random.default_rng(2)
    plan = _t(rng.uniform(-0.5, 0.5, (T, B)), dev)
    x0 = _t(rng.uniform(-1, 1, (model.state_size, B)), dev)
    gz = _t(rng.uniform(-0.2, 0.2, (T, model.goal_size)), dev)
    args = (model, K, n_elite, max_iter, 0.2, 0.9, pick_lanes(B), plan, x0, gz, 2**31 - 2)
    before = fused_cem_step.launches
    got, got_masks = fused_cem_step(*args, return_masks=True)
    torch.cuda.synchronize()
    assert fused_cem_step.launches == before + 1
    want, want_masks = fused_cem_step_reference(*args, return_masks=True)
    assert torch.equal(got_masks, want_masks)
    _bits(got, want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("K,n_elite,T,B,max_iter", [
    (48, 8, 17, 1001, 3), (64, 8, 1, 333, 2), (48, 48, 33, 777, 1), (33, 5, 5, 100, 3)])
def test_fused_cem_kernel_edges_bit_for_bit(dev, name, K, n_elite, T, B, max_iter):
    """K not a multiple of the warp (lanes with one and two samples), one
    step, every sample an elite, a ragged last block: the plan and the masks
    bit for bit."""
    model = REGISTRY[name]
    rng = np.random.default_rng(K + T)
    plan = _t(rng.uniform(-0.5, 0.5, (T, B)), dev)
    x0 = _t(rng.uniform(-1, 1, (model.state_size, B)), dev)
    gz = _t(rng.uniform(-0.2, 0.2, (T, model.goal_size)), dev)
    args = (model, K, n_elite, max_iter, 0.3, 0.8, pick_lanes(B), plan, x0, gz, 12345)
    got, got_masks = fused_cem_step(*args, return_masks=True)
    want, want_masks = fused_cem_step_reference(*args, return_masks=True)
    assert torch.equal(got_masks, want_masks)
    _bits(got, want)


def _riccati_inputs(B, T, S, dev, seed=3):
    rng = np.random.default_rng(seed)
    eye = np.eye(S)
    sym = lambda m: 0.5 * (m + np.swapaxes(m, -1, -2))  # noqa: E731
    l_uu = 0.5 + rng.uniform(size=(B, T, 1, 1))
    l_uu[::7, T // 2] = -50.0  # every 7th scenario has a non-PD step
    return [_t(a, dev) for a in (
        rng.standard_normal((B, T + 1, S)), rng.standard_normal((B, T, 1)),
        sym(rng.standard_normal((B, T + 1, S, S))) + 2.0 * eye, l_uu,
        rng.standard_normal((B, T, 1, S)),
        0.5 * eye + 0.1 * rng.standard_normal((B, T, S, S)),
        rng.standard_normal((B, T, S, 1)),
        rng.choice([0.0, 1e-3, 1.0, 32.0], size=B),
        0.3 * rng.standard_normal((B, T, S)))]


def _bits(got, want):
    """Bit for bit (a zero's sign included), NaN at the same places."""
    if got.dtype == torch.bool:
        assert torch.equal(got, want)
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _riccati_both(d, mu, c, with_c, check_pd=None):
    check_pd = not with_c if check_pd is None else check_pd
    before = riccati_backward_batch.launches
    got = riccati_backward_batch(*d, mu, c, check_pd=check_pd, with_c=with_c)
    torch.cuda.synchronize()
    assert riccati_backward_batch.launches == before + 1
    assert got[2].dtype == torch.bool and got[2].shape == (d[0].shape[0],)
    want = riccati_backward_batch_reference(*d, mu, c, check_pd=check_pd, with_c=with_c)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _bits(g, w)
    return got, want


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("with_c", [False, True])
def test_riccati_kernel_matches_plain(dev, S, with_c):
    """ks, Ks and ok bit for bit: every entry is summed in the plain order."""
    *d, mu, c = _riccati_inputs(300, 20, S, dev)
    _, want = _riccati_both(d, mu, c, with_c)
    if not with_c:
        assert 0 < int(want[2].sum()) < 300  # ok is mixed


# At S <= 4 the kernel gives a scenario's entries a lane each, in groups of
# 1, 4 or 16 lanes (32, 8 or 2 scenarios a warp), and stages 16 steps; above,
# a thread per scenario, 8 a block, and stages of 4 steps. These reach every
# S, ragged last blocks, a horizon of one step, of exactly one stage and one
# past one or two.
@pytest.mark.parametrize("B,T,S", [(1001, 17, 1), (999, 17, 2), (777, 33, 3), (1001, 17, 4),
                                   (333, 5, 5), (201, 9, 6), (101, 7, 7), (97, 5, 8),
                                   (1001, 1, 4), (33, 1, 8), (65, 16, 4), (30, 4, 8), (3, 33, 4)])
@pytest.mark.parametrize("with_c", [False, True])
def test_riccati_kernel_edges_bit_for_bit(dev, B, T, S, with_c):
    *d, mu, c = _riccati_inputs(B, T, S, dev, seed=B + T + S)
    _riccati_both(d, mu, c, with_c)


def test_riccati_kernel_nan_scenario_and_storage_offset(dev):
    *d, mu, c = _riccati_inputs(300, 20, 4, dev, seed=8)
    clean = riccati_backward_batch(*d, mu, c, check_pd=True, with_c=True)
    assert torch.isfinite(clean[1][8]).all() and bool(clean[2][8])  # scenario 8 is clean
    d[5][8, 3, 0, 0] = float("nan")  # f_x of scenario 8 at t = 3
    got, _ = _riccati_both(d, mu, c, with_c=True, check_pd=True)
    # from t = 3 down: K's column 0 at t = 3 (through V_xx f_x), all of k and K below
    assert torch.isnan(got[0][8, :3]).all() and torch.isnan(got[1][8, :3]).all()
    assert torch.isnan(got[1][8, 3, 0, 0]) and torch.isfinite(got[1][8, 3, 0, 1:]).all()
    assert not bool(got[2][8])
    others = torch.arange(300, device=dev) != 8
    for g, w in zip(got, clean):  # other scenarios as before, those that overflow NaN alike
        _bits(g[others], w[others])
    off = [torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t)
           for t in _riccati_inputs(257, 11, 4, dev, seed=9)]
    assert all(t.storage_offset() == 1 and t.is_contiguous() for t in off)
    *d_off, mu_off, c_off = off
    for with_c in (False, True):
        _riccati_both(d_off, mu_off, c_off, with_c)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("with_terminal,return_states", [(False, False), (True, True)])
def test_fused_linesearch_kernel_matches_plain(dev, name, with_terminal, return_states):
    model = REGISTRY[name]
    B, T, S = 700, 30, model.state_size
    rng = np.random.default_rng(4)
    alphas = torch.pow(1.1, -(torch.arange(10, dtype=torch.float32, device=dev) ** 2))
    args = [alphas] + [_t(a, dev) for a in (
        0.3 * rng.standard_normal((B, S)), 0.5 * rng.standard_normal((B, T, 1)),
        0.3 * rng.standard_normal((B, T, 1)), 0.2 * rng.standard_normal((B, T, 1, S)),
        0.3 * rng.standard_normal((B, T + 1, S)),
        rng.uniform(-0.2, 0.2, (T, model.goal_size)))]
    before = fused_linesearch.launches
    got = fused_linesearch(model, *args, with_terminal=with_terminal,
                           return_states=return_states)
    torch.cuda.synchronize()
    assert fused_linesearch.launches == before + 1
    want = fused_linesearch_reference(model, *args, with_terminal=with_terminal,
                                      return_states=return_states)
    for g, w in zip(got, want):
        _bits(g, w)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("T", [1, 17, 33])
@pytest.mark.parametrize("n_a,B", [(1, 1003), (8, 1001), (10, 1001), (45, 333)])
def test_fused_linesearch_kernel_edges_bit_for_bit(dev, name, T, n_a, B):
    """A horizon of one step and one past one and two stages, a ragged last
    group of scenarios, one alpha and more alphas than a warp: every output
    bit for bit, with and without the terminal cost and the states."""
    model = REGISTRY[name]
    S = model.state_size
    rng = np.random.default_rng(T + n_a)
    alphas = torch.pow(1.1, -(torch.arange(n_a, dtype=torch.float32, device=dev) ** 2))
    args = [alphas] + [_t(a, dev) for a in (
        0.3 * rng.standard_normal((B, S)), 0.5 * rng.standard_normal((B, T, 1)),
        0.3 * rng.standard_normal((B, T, 1)), 0.2 * rng.standard_normal((B, T, 1, S)),
        0.3 * rng.standard_normal((B, T + 1, S)),
        rng.uniform(-0.2, 0.2, (T, model.goal_size)))]
    for with_terminal in (False, True):
        for return_states in (False, True):
            got = fused_linesearch(model, *args, with_terminal=with_terminal,
                                   return_states=return_states)
            want = fused_linesearch_reference(model, *args, with_terminal=with_terminal,
                                              return_states=return_states)
            for g, w in zip(got, want):
                assert g.shape == w.shape
                _bits(g, w)


def _derivs_both(model, B, T, dev, seed=5):
    """Kernel against plain version at rtol = atol = 1e-4, the launch counted,
    every output contiguous. Where B·T is not a multiple of 4 some output
    ranges do not start on 16 bytes and take the kernel's 4-byte stores."""
    S = model.state_size
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1.2, 1.2, (B, T + 1, S))
    us = rng.uniform(-1.0, 1.0, (B, T, 1))
    us[::7, 0], us[1::7, min(1, T - 1)] = model.bounds_high[0], model.bounds_low[0]
    if model.name == "pendulum":  # angles on both sides of the wrap
        xs[0, :min(4, T + 1), 0] = [np.pi - 0.01, np.pi + 0.01, -np.pi + 0.01,
                                    -np.pi - 0.01][:min(4, T + 1)]
    args = [_t(a, dev) for a in (xs, us, rng.uniform(-0.2, 0.2, (T, model.goal_size)))]
    before = fused_derivs.launches
    got = fused_derivs(model, *args)
    torch.cuda.synchronize()
    assert fused_derivs.launches == before + 1
    for g, w in zip(got, fused_derivs_reference(model, *args)):
        assert g.shape == w.shape and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_fused_derivs_kernel_matches_plain(dev, name):
    """300 x 17 points: a ragged last block of 128 points."""
    _derivs_both(REGISTRY[name], 300, 17, dev)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("B,T", [(1, 1), (7, 7), (1, 128), (3, 43)])
def test_fused_derivs_kernel_edges(dev, name, B, T):
    """One point, less than a block of 128 points, a block's worth and more."""
    _derivs_both(REGISTRY[name], B, T, dev, seed=B * T)


def _admm_both(dev, n, B, per_problem, per_bounds, iters, seed=6):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(((B,) if per_problem else ()) + (n, n))
    H = a @ np.swapaxes(a, -1, -2) / n + np.eye(n)
    Minv = _t(np.linalg.inv(H + np.eye(n)), dev)
    g = _t(2.0 * rng.standard_normal((B, n)), dev)
    shape = (B, n) if per_bounds else (n,)
    lo, hi = _t(-rng.uniform(0.2, 1.0, shape), dev), _t(rng.uniform(0.2, 1.0, shape), dev)
    before = admm_iterate.launches
    got = admm_iterate(Minv, g, lo, hi, rho=1.0, alpha=1.6, iters=iters)
    torch.cuda.synchronize()
    assert admm_iterate.launches == before + 1
    want = admm_iterate_reference(Minv, g, lo, hi, rho=1.0, alpha=1.6, iters=iters)
    assert torch.equal(got, want)
    assert bool(((got >= lo) & (got <= hi)).all())


@pytest.mark.parametrize("n,B,per_problem,per_bounds", [
    (20, 512, False, False), (20, 509, True, True), (50, 251, True, False),
    (50, 256, False, True), (240, 3, True, False),
    # the edges of the forms: register widths 4 to 16 (two problems a warp),
    # to 32, to 64 (two rows a lane), shared memory from 65; ragged batches
    (1, 7, False, False), (1, 3, True, True), (5, 77, True, True), (13, 64, False, False),
    (16, 511, True, True), (16, 512, False, False),
    (17, 263, True, False), (32, 530, False, True), (33, 131, True, True),
    (64, 129, False, False), (64, 40, True, True), (65, 9, True, False), (65, 6, False, True),
    (240, 5, False, True)])
def test_admm_kernel_matches_plain(dev, n, B, per_problem, per_bounds):
    _admm_both(dev, n, B, per_problem, per_bounds, 60)


@pytest.mark.parametrize("n,B,per_problem,per_bounds", [
    (241, 5, False, False), (241, 4, True, True), (300, 3, False, True), (300, 3, True, False),
    (1100, 2, False, False)])
def test_admm_streaming_form_matches_plain(dev, n, B, per_problem, per_bounds):
    """Past a block's shared memory (n > 240, and n = 1,100 with more rows
    than a block's 1,024 threads) the kernel streams Minv from device
    memory, bit for bit with the plain version."""
    _admm_both(dev, n, B, per_problem, per_bounds, 4)


@pytest.mark.parametrize("n,B,per_problem", [(20, 9, False), (65, 6, True), (120, 5, False),
                                               (240, 3, True)])
def test_admm_streaming_form_matches_the_planned_form(dev, n, B, per_problem):
    """Below n = 241 ``block_plan`` picks the register or the shared-memory
    form; the streaming form, launched at the same (B, n) through
    ``run_plan`` (as ``kernel_ab.py`` times it), gives the same bits."""
    from benchmarking_mpc_solvers_tpu_torch.ops import qp_admm

    rng = np.random.default_rng(n)
    a = rng.standard_normal(((B,) if per_problem else ()) + (n, n))
    Minv = _t(np.linalg.inv(a @ np.swapaxes(a, -1, -2) / n + 2 * np.eye(n)), dev)
    g = _t(2.0 * rng.standard_normal((B, n)), dev)
    lo, hi = _t(-rng.uniform(0.2, 1.0, n), dev), _t(rng.uniform(0.2, 1.0, n), dev)
    planned = admm_iterate(Minv, g, lo, hi, iters=30)
    assert qp_admm.block_plan(B, n, per_problem).form != "streaming"
    before = admm_iterate.launches
    streamed = qp_admm.run_plan(qp_admm.streaming_plan(B, n), Minv, g, lo, hi, 1.0, 1.6, 30)
    torch.cuda.synchronize()
    assert admm_iterate.launches == before + 1
    assert torch.equal(streamed, planned)


def test_qpmpc_episode_past_the_shared_memory_form_runs_on_the_card(dev):
    """QP-MPC with T·A = 242 at ``linearize_at="goal"`` goes through the
    kernel's streaming form, with the plain version's plans. The plant is a
    stable two-input linear model: over 121 steps an unstable plant's
    condensed H (the pendulum's, linearised upright) is too ill-conditioned
    for a float32 Cholesky factor, on either path."""
    from benchmarking_mpc_solvers_tpu_torch.envs.env import Env
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.models.synthetic import make_linear_model
    from benchmarking_mpc_solvers_tpu_torch.solvers import QPMPC

    model = make_linear_model(0.95 * np.eye(2), np.eye(2), np.eye(2), 0.1 * np.eye(2),
                              bounds=0.3)
    env = Env(name="linear", model=model, default_start=(2.0, -1.0),
              done_fn=lambda x: torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device))
    solver = QPMPC(model=model, T=121, method="admm", iters=20)
    x0s = env.start_state(dev).expand(4, -1).contiguous()
    st = solver.init_state_batch(4, torch.Generator(device=dev).manual_seed(0), dev)
    gz = torch.zeros((121, model.goal_size), device=dev)
    assert torch.equal(solver.solve_batch(st, x0s, gz)[0].planned_us,
                       solver.solve_batch(st, x0s, gz, use_fused=False)[0].planned_us)
    before = admm_iterate.launches
    res = run_episodes_fused(env, solver, EpisodeConfig(n_steps=2, record_plans=False), x0s,
                             device=dev)
    assert torch.isfinite(res.costs).all() and admm_iterate.launches == before + 2


def test_sqp_and_qpmpc_episodes_run_on_the_card(dev):
    """SQP, Gauss-Newton iLQR and QP-MPC hand the kernels what they take."""
    from benchmarking_mpc_solvers_tpu_torch.envs import AcrobotEnv, PendulumEnv
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.solvers import ILQR, QPMPC, SQP

    cfg = EpisodeConfig(n_steps=2, record_plans=False)
    x0s = torch.tensor([0.1, 0.0, 0.2, 0.0], device=dev).expand(50, -1).contiguous()
    counts = fused_derivs.launches, riccati_backward_batch.launches, fused_linesearch.launches
    res = run_episodes_fused(AcrobotEnv, SQP(model=AcrobotEnv.model, T=8, max_iter=2), cfg, x0s,
                             device=dev)
    assert torch.isfinite(res.costs).all()
    assert (fused_derivs.launches, riccati_backward_batch.launches,
            fused_linesearch.launches) == tuple(c + 4 for c in counts)
    res = run_episodes_fused(AcrobotEnv, ILQR(model=AcrobotEnv.model, T=8, max_iter=2,
                                              gauss_newton=True), cfg, x0s, device=dev)
    assert torch.isfinite(res.costs).all() and fused_derivs.launches == counts[0] + 8
    p0 = PendulumEnv.start_state(dev).expand(40, -1).contiguous()
    for mode in ("goal", "state"):
        before = admm_iterate.launches
        res = run_episodes_fused(PendulumEnv, QPMPC(model=PendulumEnv.model, T=8, method="admm",
                                                    iters=30, linearize_at=mode), cfg, p0,
                                 device=dev)
        assert torch.isfinite(res.costs).all() and admm_iterate.launches == before + 2
    res = run_episodes_fused(PendulumEnv, QPMPC(model=PendulumEnv.model, T=8, iters=10), cfg, p0,
                             device=dev)
    assert torch.isfinite(res.costs).all()


@pytest.mark.parametrize("use_kernel", [True, False])
def test_cem_and_ilqr_episodes_run_on_the_card(dev, use_kernel):
    """The batched CEM tiers and iLQR hand the kernels what they take."""
    from benchmarking_mpc_solvers_tpu_torch.envs import CartPoleSwingUpEnv
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, ILQR

    env = CartPoleSwingUpEnv
    cfg = EpisodeConfig(n_steps=2, warmstart=1, record_plans=False)
    x0s = env.start_state(dev).expand(300, -1).contiguous()
    solver = CEM(model=env.model, T=8, K=16, n_elite=4, max_iter=2)
    res = run_episodes_fused(env, solver, cfg, x0s, use_kernel=use_kernel, device=dev)
    assert torch.isfinite(res.costs).all()
    res = run_episodes_fused(env, ILQR(model=env.model, T=8, max_iter=2), cfg, x0s[:50],
                             device=dev)
    assert torch.isfinite(res.costs).all()


def test_model_clip_takes_cpu_bounds_on_the_card(dev):
    """The models' clip puts 0-dim CPU bound tensors beside CUDA tensors."""
    from benchmarking_mpc_solvers_tpu_torch.models.base import clip

    x = torch.tensor([-3.0, 0.5, 3.0], device=dev)
    torch.testing.assert_close(clip(x, -1.0, 1.0), torch.clamp(x, -1.0, 1.0))


def test_wrapper_rejects_bad_arguments(dev):
    model = REGISTRY["pendulum"]
    plan = torch.zeros((4, 8), device=dev, dtype=torch.float64)
    x0 = torch.zeros((2, 8), device=dev)
    gz = torch.zeros((4, 3), device=dev)
    with pytest.raises(TypeError):
        fused_mppi_step(model, 4, 1.0, 1.0, 128, plan, x0, gz, 0)
    with pytest.raises(ValueError):
        fused_rollout_costs_tm(model, x0, torch.zeros((4, 8), device=dev).T, gz)


# -- the I2C Kalman filter and RTS smoother ------------------------------------------

def _i2c_problem(dev, seed, B, T, S, A, Z, shared_R=False, variant=None):
    """A random smoother problem. variant "offset": each array a contiguous
    view one float into a larger buffer; "zeros": feature 0 observes nothing
    (a zero row of J, so the filter's solves divide zeros), and F's action
    rows, J's first column and mu0's actions are negative zeros."""
    rng = np.random.default_rng(seed)
    D = S + A
    F = np.zeros((B, T, D, D))
    F[:, :, :S, :S] = np.eye(S) * 0.9 + 0.05 * rng.standard_normal((B, T, S, S))
    F[:, :, :S, S:] = 0.3 * rng.standard_normal((B, T, S, A))
    Rm = rng.standard_normal((B, Z, Z))
    R = np.einsum("bij,bkj->bik", Rm, Rm) * 0.1 + 0.5 * np.eye(Z)
    sig0, Qproc = np.zeros((D, D)), np.zeros((D, D))
    sig0[:S, :S], sig0[S:, S:] = 1e-8 * np.eye(S), 0.25 * np.eye(A)
    Qproc[:S, :S], Qproc[S:, S:] = 1e-6 * np.eye(S), 0.25 * np.eye(A)
    J = rng.standard_normal((B, T, Z, D))
    mu0 = np.concatenate([rng.standard_normal((B, S)), np.zeros((B, A))], axis=1)
    if variant == "zeros":
        F[:, :, S:, :] = -0.0
        J[:, :, :, 0] = -0.0
        J[:, :, 0, :] = 0.0
        mu0[:, S:] = -0.0
    arrays = (F, 0.1 * rng.standard_normal((B, T, D)), J,
              0.2 * rng.standard_normal((B, T, Z)), R[0] if shared_R else R,
              mu0, sig0, Qproc, 0.1 * rng.standard_normal((T, Z)))
    out = [_t(a, dev) for a in arrays]
    if variant == "offset":
        out = [torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape).copy_(t) for t in out]
        assert all(t.storage_offset() == 1 and t.is_contiguous() for t in out)
    return out


# The kernels give a scenario 8 lanes and a block 8 scenarios with stages of
# 4 time steps, or, the smoother above 8 scenarios per SM, 16 scenarios with
# stages of 3 steps: the later cases reach a ragged last group and block, a
# horizon one step past a stage of each (the filter walks T steps, the
# smoother T - 1), one of exactly one smoother stage, one of many passes of
# the ring, the largest and smallest D, inputs at a storage offset of one
# float, zero dividends of both signs, and the smoother's wide blocks.
@pytest.mark.parametrize("B,T,S,A,Z,shared_R,variant", [
    (3000, 25, 2, 1, 3, False, None), (1024, 50, 4, 1, 5, True, None),
    (500, 12, 5, 1, 4, False, None), (333, 9, 2, 2, 6, True, None),
    (100, 1, 2, 1, 3, False, None), (33, 5, 1, 1, 1, False, None),
    (401, 25, 2, 1, 3, False, None), (13, 7, 2, 1, 3, True, None),
    (50, 5, 2, 1, 3, False, None), (50, 4, 2, 1, 3, False, None),
    (77, 200, 4, 1, 5, False, None),
    (301, 20, 5, 1, 6, False, None), (64, 17, 1, 0, 2, True, None),
    (257, 25, 2, 1, 3, False, "offset"), (5001, 5, 2, 1, 3, False, None),
    (2000, 4, 2, 1, 3, True, None), (2000, 9, 5, 1, 6, False, None),
    (300, 12, 2, 1, 3, False, "zeros"), (3000, 10, 4, 1, 5, True, "zeros"),
], ids=["D3-ragged", "D5-shared-R", "D6-Z4", "two-actions-Z6", "T1", "D2-Z1",
        "B-4k+1", "B-not-a-block", "T-one-past-a-stage", "T-one-smoother-stage",
        "T200", "D6-Z6", "D1", "storage-offset", "wide-T-one-past-a-stage",
        "wide-T-one-stage", "wide-D6-Z6", "signed-zeros", "wide-signed-zeros"])
def test_i2c_filter_and_smoother_match_plain_bit_for_bit(dev, B, T, S, A, Z, shared_R, variant):
    from benchmarking_mpc_solvers_tpu_torch.ops import i2c_smooth as ts

    p = _i2c_problem(dev, B + T, B, T, S, A, Z, shared_R, variant)
    before = (ts.i2c_filter.launches, ts.i2c_rts_smooth.launches)
    got, want = ts.i2c_filter(*p), ts.i2c_filter_reference(*p)
    for g, w in zip(got, want):
        _bits(g, w)
    if T > 1:
        _bits(ts.i2c_rts_smooth(*got, p[0]), ts.i2c_rts_smooth_reference(*want, p[0]))
    if variant == "zeros":
        # every zero of the filter's outputs made negative: the smoother's
        # factorisation then divides negative zeros (sig_pred's action rows)
        neg = [torch.where(t == 0, torch.full_like(t, -0.0), t) for t in got]
        assert bool(torch.signbit(neg[3][neg[3] == 0]).all()) and bool((neg[3] == 0).any())
        _bits(ts.i2c_rts_smooth(*neg, p[0]), ts.i2c_rts_smooth_reference(*neg, p[0]))
    out = ts.i2c_smooth_batch(*p)
    _bits(out, ts.i2c_smooth_batch_reference(*p))
    assert out.shape == (B, T, S + A)
    n_rts = (2 if T > 1 else 0) + (variant == "zeros")  # the negative-zero smoother call
    assert (ts.i2c_filter.launches, ts.i2c_rts_smooth.launches) == (
        before[0] + 2, before[1] + n_rts)


def test_i2c_launch_shape_fits_the_sweep(dev):
    """At the sweep's D = Z = 5 at least two blocks of each kernel fit on an
    SM, and every instantiation launches (a shared-memory request above the
    default 48 KB is granted)."""
    from benchmarking_mpc_solvers_tpu_torch.ops.i2c_smooth import launch_config

    for name, k in launch_config(5, 5, 10240).items():
        if name != "stages":
            assert k["threads"] == 8 * k["scenarios_per_block"]
            assert k["blocks_per_sm"] >= 2
    assert launch_config(3, 3, 256)["rts"]["scenarios_per_block"] == 8  # narrow at B = 256
    for B in (300, 10240):
        for D in range(1, 7):
            for Z in range(1, 7):
                c = launch_config(D, Z, B)
                assert c["filter"]["blocks_per_sm"] >= 1 and c["rts"]["blocks_per_sm"] >= 1


def test_i2c_nan_scenario_stays_nan_on_the_card(dev):
    from benchmarking_mpc_solvers_tpu_torch.ops import i2c_smooth as ts

    p = _i2c_problem(dev, 7, 300, 9, 2, 1, 3)
    clean = ts.i2c_smooth_batch(*p)
    p[0][7, 2, 0, 0] = float("nan")
    out = ts.i2c_smooth_batch(*p)
    _bits(out, ts.i2c_smooth_batch_reference(*p))
    others = torch.arange(300, device=dev) != 7
    assert torch.isnan(out[7]).all() and torch.equal(out[others], clean[others])


def test_i2c_kernels_refuse_sizes_above_six_and_bad_arguments(dev):
    from benchmarking_mpc_solvers_tpu_torch.ops import i2c_smooth as ts

    big = _i2c_problem(dev, 8, 16, 4, 6, 1, 7)  # D = Z = 7
    with pytest.raises(NotImplementedError, match="use_fused=False"):
        ts.i2c_filter(*big)
    with pytest.raises(NotImplementedError, match="use_fused=False"):
        ts.i2c_smooth_batch(*big)
    cpu = [t.cpu() for t in big]
    assert torch.isfinite(ts.i2c_smooth_batch(*cpu)).all()  # the plain version takes it
    p = _i2c_problem(dev, 9, 16, 4, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ts.i2c_filter(*p[:4], p[4].transpose(1, 2), *p[5:])
    with pytest.raises(ValueError, match="is on"):
        ts.i2c_filter(p[0].cuda(), *[t.cpu() for t in p[1:]])
    with pytest.raises(TypeError):
        ts.i2c_filter(*p[:8], p[8].double())


@pytest.mark.parametrize("name,T,iters", [("pendulum", 25, 4), ("cartpole_swingup", 20, 3)])
def test_i2c_solve_batch_launches_and_matches_cpu(dev, name, T, iters):
    """One ``solve_batch`` on the card launches each kernel once per
    iteration and gives the CPU tier's plans (2e-3, tests/test_torch_i2c.py);
    the fused tier refuses a per-scenario goal on the card too."""
    from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as ENVS
    from benchmarking_mpc_solvers_tpu_torch.ops import i2c_smooth as ts
    from benchmarking_mpc_solvers_tpu_torch.solvers import I2C

    env = ENVS[name]
    solver = I2C(model=env.model, T=T, max_iter=iters)
    rng = np.random.default_rng(3)
    S = env.model.state_size
    # cart-pole's plans saturate at the box, where the clip's derivative
    # depends on the last bit (tests/test_torch_i2c.py): one iteration there
    x0s = env.start_state("cpu").expand(64, -1) + torch.from_numpy(
        0.1 * rng.standard_normal((64, S)).astype(np.float32))
    g_z = torch.zeros((T, env.model.goal_size))
    if name == "cartpole_swingup":
        solver, iters = I2C(model=env.model, T=T, max_iter=1), 1
    ts.i2c_filter.launches = ts.i2c_rts_smooth.launches = 0
    st = solver.init_state_batch(64, torch.Generator(device=dev).manual_seed(0), dev)
    on_card, u0, _ = solver.solve_batch(st, x0s.to(dev), g_z.to(dev))
    assert (ts.i2c_filter.launches, ts.i2c_rts_smooth.launches) == (iters, iters)
    st_cpu = solver.init_state_batch(64, torch.Generator().manual_seed(0), "cpu")
    on_cpu, _, _ = solver.solve_batch(st_cpu, x0s, g_z)
    torch.testing.assert_close(on_card.planned_us.cpu(), on_cpu.planned_us, rtol=2e-3, atol=2e-3)
    assert u0.shape == (64, 1) and bool(on_card.planned_us.abs().max() > 0)
    plain, _, _ = solver.solve_batch(st, x0s.to(dev), g_z.to(dev), use_fused=False)
    assert (ts.i2c_filter.launches, ts.i2c_rts_smooth.launches) == (iters, iters)
    torch.testing.assert_close(plain.planned_us, on_card.planned_us, rtol=2e-3, atol=2e-3)
    with pytest.raises(NotImplementedError, match="pass use_fused=False"):
        solver.solve_batch(st, x0s.to(dev), g_z.to(dev).expand(64, T, -1))


# The Experiment paths of the iLQR variants and noisy SQP: (agent, env,
# agent_config, noise params, the kernels expected per solver iteration)
EXPERIMENT_ROUTES = {
    "ilqr model noise": ("ILQR", "cartpole_swingup", {"T": 8, "max_iter": 2},
                         {"sensor_noise": 0.1, "model_noise": True},
                         {"riccati_backward_batch"}),
    "ilqr ddp": ("ILQR", "pendulum", {"T": 8, "max_iter": 2, "ddp": True}, {},
                 {"fused_linesearch"}),
    "ilqr box_ddp": ("ILQR", "pendulum", {"T": 8, "max_iter": 2, "box_ddp": True}, {},
                     {"fused_linesearch"}),
    "ilqr diag_hessian": ("ILQR", "pendulum", {"T": 8, "max_iter": 2, "diag_hessian": True},
                          {}, {"fused_linesearch"}),
    "sqp model noise": ("SQP", "acrobot", {"T": 8, "max_iter": 2},
                        {"sensor_noise": 0.1, "model_noise": True},
                        {"fused_derivs", "riccati_backward_batch"}),
}


@pytest.mark.parametrize("label", sorted(EXPERIMENT_ROUTES))
def test_experiment_routes_the_reference_kernels(dev, label):
    """``Experiment(fused=False)`` launches the kernels the reference's
    vmapped solve reaches on the accelerator, once per solver iteration of
    each of its two calls, and no other; the card's plans match the CPU's
    from the same plans and noise (2e-3, tests/test_torch_ilqr.py and
    tests/test_torch_sqp.py)."""
    from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as ENVS
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, Experiment
    from benchmarking_mpc_solvers_tpu_torch.experiment import run_episodes_fused

    agent, env_name, cfg, noise, kernels = EXPERIMENT_ROUTES[label]
    env = ENVS[env_name]
    counters = {f.__name__: f for f in (riccati_backward_batch, fused_linesearch, fused_derivs)}
    before = {k: f.launches for k, f in counters.items()}
    steps, reps = 2, 4
    params = dict(env=env_name, agent=agent, agent_config=cfg, experiment_length=steps,
                  start_state=list(env.default_start), repetitions=reps, **noise)
    exp = Experiment(params, device=dev)
    res = exp.run(warmstart=1)
    torch.cuda.synchronize()
    iters = 2 * (1 + steps) * cfg["max_iter"]
    got = {k: f.launches - before[k] for k, f in counters.items()}
    assert got == {k: iters if k in kernels else 0 for k in counters}
    assert res["batch_costs"].shape == (reps, steps) and np.isfinite(res["batch_costs"]).all()

    solver, _ = exp._build()
    rng = np.random.default_rng(5)
    plans = (0.3 * rng.standard_normal((reps, cfg["T"], 1))).astype(np.float32)
    x0s = env.start_state("cpu").expand(reps, -1) + torch.from_numpy(
        0.05 * rng.standard_normal((reps, env.model.state_size)).astype(np.float32))
    if noise:
        # one solve, the noise injected so that both devices draw alike
        S, n = env.model.state_size, solver.n_alphas
        draws = (rng.standard_normal((cfg["max_iter"], reps, cfg["T"], S)),
                 rng.standard_normal((cfg["max_iter"], reps, n, cfg["T"], S)))
        g_z = torch.zeros((cfg["T"], env.model.goal_size))

        def run(d):
            st = solver.init_state_batch(reps, torch.Generator(device=d).manual_seed(0), d)
            st = st._replace(planned_us=torch.from_numpy(plans).to(d))
            return solver.solve_batch(st, x0s.to(d), g_z.to(d), noise=draws)[0].planned_us
    else:
        def run(d):
            return run_episodes_fused(env, solver, EpisodeConfig(n_steps=2, warmstart=1),
                                      x0s.to(d), use_kernel=False, init_plans=plans,
                                      device=d).planned_actions
    torch.testing.assert_close(run(dev).cpu(), run("cpu"), rtol=2e-3, atol=2e-3)


# The kernel switches: (solver, options, switch, the kernels of its fused route)
SWITCH_ROUTES = {
    "ilqr": ("ILQR", "cartpole_swingup", {"reference_accept": False}, "pallas_backward",
             {"riccati_backward_batch", "fused_linesearch"}),
    "ilqr gauss-newton": ("ILQR", "cartpole_swingup", {"reference_accept": False,
                                                       "gauss_newton": True},
                          "pallas_backward",
                          {"fused_derivs", "riccati_backward_batch", "fused_linesearch"}),
    "sqp": ("SQP", "acrobot", {}, "pallas_backward",
            {"fused_derivs", "riccati_backward_batch", "fused_linesearch"}),
    "i2c": ("I2C", "pendulum", {}, "pallas_smoother", {"i2c_filter", "i2c_rts_smooth"}),
}


@pytest.mark.parametrize("label", sorted(SWITCH_ROUTES))
def test_switch_false_launches_no_kernel(dev, label):
    """``pallas_backward=False`` / ``pallas_smoother=False`` under
    ``use_fused=True``: no launch of the route's kernels, and the plans of
    the kernel route within the solver tests' 2e-3 (the plain stages sum
    in another order than the kernels)."""
    from benchmarking_mpc_solvers_tpu_torch import solvers
    from benchmarking_mpc_solvers_tpu_torch.envs import REGISTRY as ENVS
    from benchmarking_mpc_solvers_tpu_torch.ops import i2c_smooth as ts

    agent, env_name, options, switch, kernels = SWITCH_ROUTES[label]
    env = ENVS[env_name]
    counters = {f.__name__: f for f in (riccati_backward_batch, fused_linesearch, fused_derivs,
                                        ts.i2c_filter, ts.i2c_rts_smooth)}
    T, B, iters = 10, 64, 3
    rng = np.random.default_rng(9)
    plans = torch.from_numpy((0.5 * rng.standard_normal((B, T, 1))).astype(np.float32)).to(dev)
    x0s = (env.start_state(dev).expand(B, -1) + torch.from_numpy(
        0.1 * rng.standard_normal((B, env.model.state_size)).astype(np.float32)).to(dev))
    g_z = torch.zeros((T, env.model.goal_size), device=dev)
    out = {}
    for flag in (False, None):
        solver = getattr(solvers, agent)(model=env.model, T=T, max_iter=iters,
                                         **{switch: flag}, **options)
        st = solver.init_state_batch(B, torch.Generator(device=dev).manual_seed(0), dev)
        before = {k: f.launches for k, f in counters.items()}
        out[flag] = solver.solve_batch(st._replace(planned_us=plans), x0s, g_z)[0].planned_us
        torch.cuda.synchronize()
        got = {k: f.launches - before[k] for k, f in counters.items()}
        assert got == {k: (iters if flag is None and k in kernels else 0) for k in counters}
        assert solver.has_kernel_stages() == (flag is None)
    torch.testing.assert_close(out[False], out[None], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("agent", ["MPPI", "CEM"])
def test_one_device_sharded_kernel_tier_is_run_episodes_fused(dev, agent):
    """``sharded_episodes_kernel`` on a one-device mesh is
    ``run_episodes_fused`` with the same generator, bit for bit, one launch
    of kernel 1 (MPPI) or 3 (CEM) per solver call."""
    from benchmarking_mpc_solvers_tpu_torch import solvers
    from benchmarking_mpc_solvers_tpu_torch.envs import CartPoleSwingUpEnv as env
    from benchmarking_mpc_solvers_tpu_torch.experiment import EpisodeConfig, run_episodes_fused
    from benchmarking_mpc_solvers_tpu_torch.parallel import make_mesh, sharded_episodes_kernel

    kw = {"MPPI": dict(K=32), "CEM": dict(K=16, n_elite=4, max_iter=2)}[agent]
    solver = getattr(solvers, agent)(model=env.model, T=20, **kw)
    kernel = fused_mppi_step if agent == "MPPI" else fused_cem_step
    cfg = EpisodeConfig(n_steps=4, warmstart=2, record_plans=True)
    x0s = env.start_state(dev).expand(300, -1).contiguous()
    before = kernel.launches
    got = sharded_episodes_kernel(env, solver, cfg, make_mesh(1))(
        x0s, generators=[torch.Generator(device=dev).manual_seed(4)])
    torch.cuda.synchronize()
    assert kernel.launches - before == 6
    want = run_episodes_fused(env, solver, cfg, x0s,
                              generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    for field, w in zip(want._fields, want):
        torch.testing.assert_close(getattr(got, field), w, rtol=0, atol=0, msg=field)


@pytest.mark.parametrize("name", NAMES)
def test_batch_major_rollout_wrappers_match_plain_bit_for_bit(dev, name):
    from benchmarking_mpc_solvers_tpu_torch.ops.fused import (
        fused_rollout_cost_samples,
        fused_rollout_cost_samples_reference,
        fused_rollout_costs,
        fused_rollout_costs_reference,
    )

    model = REGISTRY[name]
    rng = np.random.default_rng(8)
    N, T = 4097, 23
    x0b = _t(rng.uniform(-1, 1, (N, model.state_size)), dev)
    usb = _t(rng.uniform(-1.5, 1.5, (N, T)), dev)
    gz = _t(rng.uniform(-0.2, 0.2, (T, model.goal_size)), dev)
    before = fused_rollout_costs_tm.launches
    got = fused_rollout_costs(model, x0b, usb, gz)
    torch.testing.assert_close(got, fused_rollout_costs_reference(model, x0b, usb, gz),
                               rtol=0, atol=0, equal_nan=True)
    got = fused_rollout_cost_samples(model, x0b[0], usb[:, :, None], gz)
    torch.testing.assert_close(
        got, fused_rollout_cost_samples_reference(model, x0b[0], usb[:, :, None], gz),
        rtol=0, atol=0, equal_nan=True)
    assert fused_rollout_costs_tm.launches - before == 2


def test_new_entry_points_raise_without_cuda(monkeypatch):
    """The entry points of the mesh, the timers, ``Env.reset`` and the
    process group default to the card and raise without it (also on the
    CPU, where this test runs too)."""
    from benchmarking_mpc_solvers_tpu_torch.envs import PendulumEnv
    from benchmarking_mpc_solvers_tpu_torch.parallel import (
        distributed_init, global_mesh, make_mesh)
    from benchmarking_mpc_solvers_tpu_torch.utils import device_step_latency, slope_timer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.zeros(2)
    for call in (lambda: make_mesh(),
                 lambda: make_mesh(1, axes=("batch", "sample"), shape=(1, 1)),
                 lambda: global_mesh(),
                 lambda: distributed_init(num_processes=2, process_id=0),
                 lambda: PendulumEnv.reset(torch.Generator()),
                 lambda: device_step_latency(lambda c, i: (c, c.sum()), x, x[:, None]),
                 lambda: slope_timer(lambda g: x.sum())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
