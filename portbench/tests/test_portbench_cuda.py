"""On the card, at each cell's own size and limits: a short run is correct,
the control is not, and a run whose solver step is broken underneath is
not. Run there with ``python -m pytest portbench/tests -m cuda``."""

import pytest

from portbench import check
from portbench.control import control_readings
from portbench.run import cell_spec, run_cell

from .helpers import CELLS, FAULTS, ROOT, broken_workload


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the program's CUDA kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_and_the_control_is_not(card, cell):
    spec = cell_spec(cell, ROOT)
    out = run_cell(spec, 2**31 + 101, 1.0, False)
    assert out["correct"], out["checks"]
    got = control_readings(spec, 2**31 + 102, spec["checks"])
    assert not check.judge(got, spec["checks"]["limits"]), got


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct_on_the_card(card, cell, fault):
    spec = cell_spec(cell, ROOT)
    out = run_cell(spec, 2**31 + 103, 1.0, False, workload=broken_workload(spec, fault, "cuda"))
    print(cell, fault, {k: v["value"] for k, v in out["checks"].items()})
    assert not out["correct"], out["checks"]
