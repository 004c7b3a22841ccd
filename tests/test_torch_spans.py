"""The program's spans (``utils.profiling.span``) on the CPU.

- Under ``torch.profiler`` a batch of ``run_episodes_fused`` on each tiny
  benchmark cell, on the kernel tier and on the two-stage tier, records the
  span tree: one ``episode.batch``, one ``episode.step`` a step, and in each
  step an ``episode.solve`` (with the batched solve's stages on the
  two-stage tier) before an ``episode.plant``. The trace holds the same
  tree as ``user_annotation`` ranges, nested in time, and ``trace`` writes
  the totals to ``spans.json``.
- With the profiler off a span is the shared no-op: no ``record_function``
  is entered and nothing is recorded.
"""

import json
from collections import Counter

import pytest
import torch

from benchmarking_mpc_solvers_tpu_torch.experiment.episode import run_episodes_fused
from benchmarking_mpc_solvers_tpu_torch.utils import profiling
from portbench.tests.helpers import tiny_spec
from portbench.workload import Workload

STEPS = 3  # the tiny cells' episode length
STAGES = {"MPPI": ("mppi.draw", "mppi.rollout", "mppi.update"),
          "CEM": ("cem.draw", "cem.rollout", "cem.refit")}


def _batch(cell: str, use_kernel: bool):
    """A tiny cell's workload and a function that runs one batch of it."""
    spec = tiny_spec(cell)
    wl = Workload(spec["config"], spec["traffic"], "cpu")
    inp = wl.inputs(3, 0)

    def run():
        wl.plant_gen.manual_seed(inp.plant_seed)
        return run_episodes_fused(wl.env, wl.solver, wl.episode, inp.x0s,
                                  generator=wl.plant_gen, use_kernel=use_kernel,
                                  seeds=inp.call_seeds, device="cpu")
    return wl, run


def _expected_tree(wl, use_kernel: bool) -> Counter:
    """(name, enclosing span's name) of every span one batch records."""
    tree = Counter({("episode.batch", None): 1, ("episode.step", "episode.batch"): STEPS,
                    ("episode.solve", "episode.step"): STEPS,
                    ("episode.plant", "episode.step"): STEPS})
    if not (use_kernel and wl.solver.kernel_ok()):
        per_solve = wl.solver.max_iter if type(wl.solver).__name__ == "CEM" else 1
        for stage in STAGES[type(wl.solver).__name__]:
            tree[(stage, "episode.solve")] = STEPS * per_solve
    return tree


@pytest.mark.parametrize("cell,use_kernel", [
    ("mppi-k64-clean", True), ("cem-k64-clean", True), ("mppi-k64-sensor-noise", True),
    ("mppi-k64-clean", False), ("cem-k64-clean", False)])
def test_the_span_tree_of_a_batch(tmp_path, cell, use_kernel):
    wl, run = _batch(cell, use_kernel)
    two_stage = not (use_kernel and wl.solver.kernel_ok())
    assert two_stage == (cell == "mppi-k64-sensor-noise" or not use_kernel)
    want = _expected_tree(wl, use_kernel)
    with profiling.trace(str(tmp_path)):
        res = run()
    assert res.costs.shape == (wl.B, STEPS)
    assert Counter((name, parent) for name, parent, _ in profiling._SPANS) == want
    assert profiling._OPEN == []

    totals = json.loads((tmp_path / "spans.json").read_text())
    names = Counter()
    for (name, _), n in want.items():
        names[name] += n
    assert {k: v["count"] for k, v in totals.items()} == dict(names)
    assert all(v["device_ms"] >= 0.0 for v in totals.values())
    assert profiling.span_totals("episode.step") == {
        k: v for k, v in profiling.span_totals().items()
        if k in ("episode.solve", "episode.plant")}

    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = sorted(((ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                     for ev in events if ev.get("ph") == "X"
                     and ev.get("cat") == "user_annotation"), key=lambda r: r[1])
    assert Counter(r[0] for r in ranges) == names
    (batch,) = [r for r in ranges if r[0] == "episode.batch"]
    steps = [r for r in ranges if r[0] == "episode.step"]
    for name, s, e in ranges:
        assert batch[1] <= s and e <= batch[2]
    for _, s, e in steps:
        inside = [r for r in ranges if s <= r[1] and r[2] <= e and r[0] != "episode.step"]
        solve = [r for r in inside if r[0] == "episode.solve"]
        plant = [r for r in inside if r[0] == "episode.plant"]
        assert len(solve) == len(plant) == 1 and solve[0][2] <= plant[0][1]
        for name, s2, e2 in inside:
            if name.startswith(("mppi.", "cem.")):
                assert solve[0][1] <= s2 and e2 <= solve[0][2]


def test_a_span_is_a_shared_no_op_with_the_profiler_off(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    profiling.clear_spans()
    assert profiling.span("episode.batch") is profiling.span("mppi.draw")
    for cell, use_kernel in (("mppi-k64-clean", True), ("mppi-k64-sensor-noise", True),
                             ("cem-k64-clean", False)):
        run = _batch(cell, use_kernel)[1]
        run()
    assert entered == [] and profiling._SPANS == [] and profiling._OPEN == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("episode.batch"):
            with profiling.span("episode.step"):
                pass
    assert entered == ["episode.batch", "episode.step"]
    assert [(n, p) for n, p, _ in profiling._SPANS] == [("episode.step", "episode.batch"),
                                                         ("episode.batch", None)]
    profiling.clear_spans()
    assert profiling._SPANS == [] and profiling.span_totals() == {}
