"""The benchmark's readers of the program's spans (``portbench/spans.py``
and the six ``metrics/*_per_step.py``).

- On a small synthetic stretch with the program's spans as trace ranges and
  as recorded timing marks: each stage's ms a step, the idle gaps split by
  intersection with the host's stages (every idle µs once: the parts sum to
  the stretch's idle time), and nothing to read where the recorded steps
  are not the stretch's or the program records no spans.
- A traced run of each tiny cell on the CPU carries the new metrics, and
  its recorded steps are the stretch's.
"""

from types import SimpleNamespace

import pytest

from benchmarking_mpc_solvers_tpu_torch.utils import profiling
from portbench import spans
from portbench.run import reader, run_cell
from portbench.tests.helpers import CELLS, tiny_spec
from portbench.trace import from_chrome

READERS = ("solve_ms_per_step", "plant_ms_per_step", "draw_ms_per_step",
           "idle_in_solve_ms_per_step", "idle_in_plant_ms_per_step",
           "idle_in_runner_ms_per_step")
K1 = "void (anonymous namespace)::fused_mppi_kernel<bmpc::CartPole, true, 131073ul>(float const*)"


def X(name, cat, ts, end):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts}


def U(name, ts, end):
    return X(name, "user_annotation", ts, end)


# two steps in one batch, µs; device busy 1100-1250, 1320-1400, 1500-1650, 1900-1950
DOC = {"traceEvents": [
    U("portbench.stretch", 1000.0, 2000.0),
    U("portbench.episodes", 1000.0, 1900.0),
    U("episode.batch", 1010.0, 1890.0),
    U("episode.step", 1020.0, 1450.0),
    U("episode.solve", 1030.0, 1300.0),
    U("mppi.draw", 1040.0, 1100.0),
    U("episode.plant", 1310.0, 1440.0),
    U("episode.step", 1460.0, 1880.0),
    U("episode.solve", 1470.0, 1700.0),
    U("episode.plant", 1710.0, 1870.0),
    X(K1, "kernel", 1100.0, 1250.0),
    X(K1, "kernel", 1320.0, 1400.0),
    X(K1, "kernel", 1500.0, 1650.0),
    X("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1900.0, 1950.0),
    X("aten::mul", "cpu_op", 1420.0, 1440.0),
]}
# (name, enclosing span, (start ns, end ns)) as the CPU records them
RECORDED = [("mppi.draw", "episode.warmstart", (0, 500_000)),  # not under a solve: left out
            ("mppi.draw", "episode.solve", (0, 60_000)),
            ("episode.solve", "episode.step", (0, 270_000)),
            ("episode.plant", "episode.step", (0, 130_000)),
            ("episode.step", "episode.batch", (0, 430_000)),
            ("episode.solve", "episode.step", (0, 230_000)),
            ("episode.plant", "episode.step", (0, 160_000)),
            ("episode.step", "episode.batch", (0, 420_000)),
            ("episode.batch", None, (0, 880_000))]
# idle µs by part, gap by gap: solve 70+50+30+50, plant 10+40+160,
# runner 20+10+30+30, outside 10+10+50
SPLIT = {"solve": 200.0, "plant": 210.0, "runner": 90.0, "outside": 70.0}


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(profiling, "_SPANS", list(RECORDED))
    return SimpleNamespace(trace=from_chrome(DOC, steps=2))


def test_each_stage_a_step(ctx):
    assert reader("solve_ms_per_step")(ctx) == pytest.approx((0.27 + 0.23) / 2)
    assert reader("plant_ms_per_step")(ctx) == pytest.approx((0.13 + 0.16) / 2)
    assert reader("draw_ms_per_step")(ctx) == pytest.approx(0.06 / 2)


def test_idle_is_split_by_intersection_and_sums_to_the_idle_time(ctx):
    tr = ctx.trace
    got = spans.idle_split(tr)
    assert got == pytest.approx(SPLIT)
    idle_us = sum(e - s for s, e in tr.gaps())
    assert idle_us == pytest.approx((tr.window_s - tr.busy_s) * 1e6)
    assert sum(got.values()) == pytest.approx(idle_us, abs=1e-6)
    for part in ("solve", "plant", "runner"):
        assert reader(f"idle_in_{part}_ms_per_step")(ctx) == pytest.approx(
            SPLIT[part] * 1e-3 / 2)


def test_nothing_to_read_where_the_steps_differ(ctx, monkeypatch):
    ctx.trace.steps = 3
    assert all(reader(name)(ctx) is None for name in READERS)
    ctx.trace.steps = 2
    monkeypatch.setattr(profiling, "_SPANS", RECORDED[:-2] + RECORDED[-1:])  # a step lost
    assert all(reader(name)(ctx) is None for name in READERS)


def test_nothing_to_read_from_a_program_without_spans(ctx, monkeypatch):
    monkeypatch.delattr(profiling, "span_totals")
    assert all(reader(name)(ctx) is None for name in READERS)
    assert reader("device_idle_pct")(ctx) == pytest.approx(57.0)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_carries_the_span_metrics(cell, monkeypatch):
    import portbench.trace

    seen = []
    profile = portbench.trace.profile_stretch

    def kept(run_batches):
        seen.append(profile(run_batches))
        return seen[-1]
    monkeypatch.setattr(portbench.trace, "profile_stretch", kept)
    profiling.clear_spans()
    out = run_cell(tiny_spec(cell), 2**33 + 17, 1.2, True, device="cpu")
    assert out["correct"]
    want = set(READERS) - ({"draw_ms_per_step"} if cell != "mppi-k64-sensor-noise" else set())
    got = {k: v["value"] for k, v in out["metrics"].items() if k in READERS}
    assert set(got) == want
    assert all(out["metrics"][k]["unit"] == "ms" and v >= 0.0 for k, v in got.items())
    (tr,) = seen
    assert profiling.span_totals("episode.batch")["episode.step"]["count"] == tr.steps
    idle = sum(spans.idle_split(tr).values())
    assert idle == pytest.approx((tr.window_s - tr.busy_s) * 1e6)
    parts = sum(got[f"idle_in_{p}_ms_per_step"] for p in ("solve", "plant", "runner"))
    assert parts <= idle * 1e-3 / tr.steps + 1e-9
    profiling.clear_spans()
