"""On the card, at each cell's own size: a traced run's recorded
``episode.step`` spans are the stretch's steps, the solve and plant stages
fit in the stretch's time a step, and the idle time put down to the
program's stages and to the harness sums to the stretch's idle time. Run
there with ``python -m pytest portbench/tests -m cuda``."""

import pytest

from portbench import spans
from portbench.run import cell_spec, run_cell

from .helpers import CELLS, ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the program's CUDA kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_spans_account_for_the_stretch(card, cell, monkeypatch):
    import portbench.trace
    from benchmarking_mpc_solvers_tpu_torch.utils import profiling

    seen = []
    profile = portbench.trace.profile_stretch

    def kept(run_batches):
        seen.append(profile(run_batches))
        return seen[-1]
    monkeypatch.setattr(portbench.trace, "profile_stretch", kept)
    profiling.clear_spans()
    out = run_cell(cell_spec(cell, ROOT), 2**31 + 105, 3.0, True)
    (tr,) = seen
    m = {k: v["value"] for k, v in out["metrics"].items()}
    split = spans.idle_split(tr)
    print(cell, tr.steps, tr.window_s, m, split)
    assert out["correct"], out["checks"]
    assert profiling.span_totals(spans.BATCH)[spans.STEP]["count"] == tr.steps
    window_ms = tr.window_s * 1e3 / tr.steps
    assert m["solve_ms_per_step"] + m["plant_ms_per_step"] <= window_ms
    idle_us = m["device_idle_pct"] * tr.window_s * 1e6 / 100
    assert abs(sum(split.values()) - idle_us) <= 1.0 * tr.steps
    three = sum(m[f"idle_in_{p}_ms_per_step"] for p in ("solve", "plant", "runner"))
    assert three <= idle_us * 1e-3 / tr.steps + 1e-9
    assert three * tr.steps * 1e3 + split["outside"] == pytest.approx(idle_us, abs=tr.steps)
    if cell == "mppi-k64-sensor-noise":
        assert 0.0 < m["draw_ms_per_step"] <= m["solve_ms_per_step"]
    profiling.clear_spans()
