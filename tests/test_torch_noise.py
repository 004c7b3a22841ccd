"""The batched tiers' per-scenario noise (MPPI and CEM ``solve_batch``).

A scenario's perturbations are a function of its own seed and draw count,
not of its batch slot or of B, as the reference's per-scenario keys make
them (solvers/cem.py:124-127). So permuting the scenarios, with their seeds
and counts, permutes every output bit for bit on the CPU, and a scenario
solved in a smaller batch gets the same result.
"""

import numpy as np
import pytest
import torch

from benchmarking_mpc_solvers_tpu_torch.models import CartPoleSwingUpModel
from benchmarking_mpc_solvers_tpu_torch.ops.fused_mppi import scenario_normals
from benchmarking_mpc_solvers_tpu_torch.solvers import CEM, MPPI

B, T = 7, 6


def _problem():
    rng = np.random.default_rng(0)
    xs = torch.tensor((np.tile([0.0, 0.0, np.pi, 0.0], (B, 1))
                       + 0.3 * rng.standard_normal((B, 4))).astype(np.float32))
    plans = torch.tensor(rng.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32))
    return xs, plans, torch.zeros((T, 5))


def _solvers():
    return [MPPI(model=CartPoleSwingUpModel, T=T, K=8),
            CEM(model=CartPoleSwingUpModel, T=T, K=8, n_elite=3, max_iter=2)]


def _two_calls(solver, state, xs, g_z, use_fused):
    outs = []
    for _ in range(2):
        state, u0, _ = solver.solve_batch(state, xs, g_z, use_fused=use_fused)
        outs.append((state.planned_us, u0, state.calls))
    return outs


def test_scenario_normals_do_not_depend_on_slot_or_batch():
    seeds = torch.tensor([3, 2**40 + 5, 2**62 + 17, 12345], dtype=torch.int64)
    calls = torch.tensor([0, 4, 1, 9], dtype=torch.int64)
    full = scenario_normals(seeds, calls, 5, 7)
    assert full.shape == (4, 5, 7)
    perm = torch.tensor([2, 0, 3, 1])
    assert torch.equal(scenario_normals(seeds[perm], calls[perm], 5, 7), full[perm])
    assert torch.equal(scenario_normals(seeds[1:2], calls[1:2], 5, 7), full[1:2])
    # a new draw count is a new stream; the draws are standard normal
    assert not torch.equal(scenario_normals(seeds, calls + 1, 5, 7), full)
    many = scenario_normals(torch.arange(64, dtype=torch.int64), torch.zeros(64, dtype=torch.int64),
                            32, 50)
    assert abs(float(many.mean())) < 0.02 and abs(float(many.std()) - 1.0) < 0.02


@pytest.mark.parametrize("K,T,scale", [(5, 7, 1.0), (1, 1, 0.3), (8, 30, 2.5)])
def test_scaled_draw_is_the_scaled_normals_and_follows_the_scenario(K, T, scale):
    """``scenario_normals(..., scale)`` is ``scale * scenario_normals`` bit
    for bit, and keeps their independence of the slot and of B: permuting
    the scenarios permutes the draws, and a sub-batch draws the same rows.
    On the CPU no kernel launches."""
    seeds = torch.tensor([3, 2**40 + 5, 2**62 + 17, 12345, -(2**50) - 9], dtype=torch.int64)
    calls = torch.tensor([0, 4, 1, 9, 2**33 + 1], dtype=torch.int64)
    before = scenario_normals.launches
    scaled = scenario_normals(seeds, calls, K, T, scale=scale)
    assert scaled.shape == (seeds.shape[0], K, T)
    assert torch.equal(scaled, scale * scenario_normals(seeds, calls, K, T))
    perm = torch.tensor([2, 0, 4, 3, 1])
    assert torch.equal(scenario_normals(seeds[perm], calls[perm], K, T, scale=scale),
                       scaled[perm])
    assert torch.equal(scenario_normals(seeds[1:3], calls[1:3], K, T, scale=scale),
                       scaled[1:3])
    assert scenario_normals.launches == before


@pytest.mark.parametrize("which", [0, 1], ids=["mppi", "cem"])
def test_fused_tier_draws_the_scenario_normals(which):
    """The fused tiers' draw is each scenario's normals: injecting them (as
    MPPI's std-scaled ``delta_tm``, as CEM's ``noise``) gives the same solve
    bit for bit, and the draw counts move alike."""
    solver = [MPPI(model=CartPoleSwingUpModel, T=T, K=8, std=0.7), _solvers()[1]][which]
    xs, plans, g_z = _problem()
    st = solver.init_state_batch(B, torch.Generator().manual_seed(5), device="cpu")
    st = st._replace(planned_us=plans, calls=torch.arange(B, dtype=torch.int64))
    drawn, u0, _ = solver.solve_batch(st, xs, g_z)
    if which == 0:
        delta_tm = (0.7 * scenario_normals(st.seeds, st.calls, 8, T)).permute(2, 0, 1)
        given, u0_given, _ = solver.solve_batch(st, xs, g_z, delta_tm=delta_tm.reshape(T, -1))
    else:
        noise = torch.stack([scenario_normals(st.seeds, st.calls + i, 8, T)
                             for i in range(solver.max_iter)])
        given, u0_given, _ = solver.solve_batch(st, xs, g_z, noise=noise)
    assert torch.equal(drawn.planned_us, given.planned_us) and torch.equal(u0, u0_given)
    assert torch.equal(drawn.calls, given.calls)


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("which", [0, 1], ids=["mppi", "cem"])
def test_solve_batch_permutation_permutes_outputs(which, use_fused):
    solver = _solvers()[which]
    xs, plans, g_z = _problem()
    st = solver.init_state_batch(B, torch.Generator().manual_seed(5), device="cpu")
    st = st._replace(planned_us=plans)
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(1))
    st_p = st._replace(planned_us=plans[perm], seeds=st.seeds[perm], calls=st.calls[perm])
    for a, b in zip(_two_calls(solver, st, xs, g_z, use_fused),
                    _two_calls(solver, st_p, xs[perm], g_z, use_fused)):
        for x, y in zip(a, b):
            assert torch.equal(x[perm], y)


@pytest.mark.parametrize("which", [0, 1], ids=["mppi", "cem"])
def test_solve_batch_result_does_not_depend_on_batch_size(which):
    solver = _solvers()[which]
    xs, plans, g_z = _problem()
    st = solver.init_state_batch(B, torch.Generator().manual_seed(5), device="cpu")
    st = st._replace(planned_us=plans)
    full, _, _ = solver.solve_batch(st, xs, g_z)
    sub = st._replace(planned_us=plans[2:5], seeds=st.seeds[2:5], calls=st.calls[2:5])
    part, _, _ = solver.solve_batch(sub, xs[2:5], g_z)
    assert torch.equal(part.planned_us, full.planned_us[2:5])


def _noisy_solvers():
    return [MPPI(model=CartPoleSwingUpModel, T=T, K=8, model_noise_std=0.5),
            CEM(model=CartPoleSwingUpModel, T=T, K=8, n_elite=3, max_iter=2,
                model_noise_std=0.5)]


@pytest.mark.parametrize("which", [0, 1], ids=["mppi", "cem"])
def test_plain_tier_model_noise_follows_the_scenario(which):
    """With model_noise_std > 0 the plain tier draws each scenario's state
    noise from its own stream, at the draw count of its perturbations and at
    timestep indices T·A onwards, which the perturbations never use: the
    drawn noise is exactly those draws, permuting the scenarios permutes
    every output, and a sub-batch gets the same result."""
    solver = _noisy_solvers()[which]
    xs, plans, g_z = _problem()
    st = solver.init_state_batch(B, torch.Generator().manual_seed(5), device="cpu")
    st = st._replace(planned_us=plans, calls=torch.arange(B, dtype=torch.int64))
    drawn, u0, _ = solver.solve_batch(st, xs, g_z, use_fused=False)
    iters = [0] if which == 0 else range(solver.max_iter)
    xnoise = torch.stack([0.5 * scenario_normals(st.seeds, st.calls + i, 8, T * 5)[..., T:]
                          .reshape(B, 8, T, 4) for i in iters])
    given, _, _ = solver.solve_batch(st, xs, g_z, use_fused=False,
                                     xnoise=xnoise[0] if which == 0 else xnoise)
    assert torch.equal(given.planned_us, drawn.planned_us)
    clean, _, _ = solver.solve_batch(st, xs, g_z, use_fused=False, xnoise=torch.zeros_like(
        xnoise[0] if which == 0 else xnoise))
    assert not torch.equal(clean.planned_us, drawn.planned_us)

    perm = torch.randperm(B, generator=torch.Generator().manual_seed(1))
    st_p = st._replace(planned_us=plans[perm], seeds=st.seeds[perm], calls=st.calls[perm])
    for a, b in zip(_two_calls(solver, st, xs, g_z, False),
                    _two_calls(solver, st_p, xs[perm], g_z, False)):
        for x, y in zip(a, b):
            assert torch.equal(x[perm], y)
    sub = st._replace(planned_us=plans[2:5], seeds=st.seeds[2:5], calls=st.calls[2:5])
    part, _, _ = solver.solve_batch(sub, xs[2:5], g_z, use_fused=False)
    assert torch.equal(part.planned_us, drawn.planned_us[2:5])
