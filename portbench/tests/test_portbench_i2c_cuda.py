"""On the card, the I2C cell at its own size and limits: a short run is
correct, the control is not, and a run whose ``I2C.solve_batch`` is broken
underneath (``i2c_helpers.broken_i2c_workload``) is not. Run there with
``python -m pytest portbench/tests -m cuda``."""

import pytest

from portbench import check
from portbench.control import control_readings
from portbench.run import cell_spec, run_cell

from .helpers import FAULTS, ROOT
from .i2c_helpers import CELL, broken_i2c_workload


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the program's CUDA kernels)")


@pytest.mark.cuda
def test_a_short_run_is_correct_and_the_control_is_not(card):
    spec = cell_spec(CELL, ROOT)
    out = run_cell(spec, 2**31 + 201, 1.0, False)
    assert out["correct"], out["checks"]
    got = control_readings(spec, 2**31 + 202, spec["checks"])
    print(CELL, "control", got)
    assert not check.judge(got, spec["checks"]["limits"]), got


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_is_not_correct_on_the_card(card, fault):
    spec = cell_spec(CELL, ROOT)
    out = run_cell(spec, 2**31 + 203, 1.0, False,
                   workload=broken_i2c_workload(spec, fault, "cuda"))
    print(CELL, fault, {k: v["value"] for k, v in out["checks"].items()})
    assert not out["correct"], out["checks"]
