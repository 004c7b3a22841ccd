"""A run's last line, and ``correct`` against the control, a sound witness
and the faults a cell can have, judged by the cell's own limits at tiny
sizes on the CPU (the look for a card skipped)."""

import json

import pytest
import torch

from portbench import check
from portbench.control import control_readings
from portbench.run import run_cell

from .helpers import CELLS, FAULTS, broken_workload, cell_limits, tiny_spec

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_the_last_line_keys():
    spec = tiny_spec("mppi-k64-clean")
    out = run_cell(spec, 7, 0.3, False, device="cpu")
    assert list(out) == KEYS  # the compared numbers come last
    assert set(out["metrics"]) == {"solves_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(check.GAPS)
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    json.dumps(out)


def test_a_traced_run_carries_the_window_and_breakdown():
    out = run_cell(tiny_spec("cem-k64-clean"), 8, 1.5, True, device="cpu")
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    spec = tiny_spec(cell, cell_limits(cell))
    for seed in (1, 2, 3):
        got = control_readings(spec, seed, spec["checks"], device="cpu")
        assert not check.judge(got, spec["checks"]["limits"]), got


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_reordering_is_correct(cell):
    spec = tiny_spec(cell, cell_limits(cell))
    for seed in (1, 2, 3):
        got = control_readings(spec, seed, spec["checks"], device="cpu", dt=torch.float32,
                               order="witness")
        assert check.judge(got, spec["checks"]["limits"]), got


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault):
    spec = tiny_spec(cell, cell_limits(cell))
    out = run_cell(spec, 11, 0.3, False, device="cpu", workload=broken_workload(spec, fault))
    assert not out["correct"], out["checks"]
    if fault == "late_half_left_out":  # the first step is sound: departed_pct catches it
        gap = out["checks"]["first_action_gap"]
        assert gap["value"] <= gap["limit"]
        assert out["checks"]["departed_pct"]["value"] > out["checks"]["departed_pct"]["limit"]
