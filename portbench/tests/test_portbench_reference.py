"""The plain reference against the program's plain CPU tier at tiny sizes,
on each cell's configuration and traffic."""

import pytest
import torch

from portbench import check
from portbench.run import run_cell
from portbench.workload import Workload

from .helpers import CELLS, tiny_spec


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_is_correct(cell):
    out = run_cell(tiny_spec(cell), 2**31 + 17, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_reference_episodes_follow_the_program(cell):
    spec = tiny_spec(cell)
    wl = Workload(spec["config"], spec["traffic"], "cpu")
    plant, solver = check.reference_for(spec["config"])
    inp = wl.inputs(-5, 3)
    res = wl.run(inp)
    idx = list(range(wl.B))
    ref = solver.episodes(plant, spec["config"]["solver_args"], wl.run_spec, inp, idx)
    # the program's plain CPU tier sums kernel 1's update in k order: a rounding
    torch.testing.assert_close(res.actions[..., 0], ref.actions, rtol=0, atol=1e-6)
    torch.testing.assert_close(res.true_states, ref.states, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(res.costs, ref.costs, rtol=1e-6, atol=1e-6)
    assert check.gaps(check.program_outputs(res, idx), ref, plant)["plant_gap"] == 0.0


def test_sensor_noise_reaches_the_observations():
    spec = tiny_spec("mppi-k64-sensor-noise")
    wl = Workload(spec["config"], spec["traffic"], "cpu")
    res = wl.run(wl.inputs(1, 0))
    assert not wl.solver.kernel_ok()  # the two-stage tier
    noise = (res.observations - res.true_states[:, 1:]).abs()
    assert 0.0 < float(noise.max()) < 1.0
