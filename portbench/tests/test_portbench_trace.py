"""The trace readers on a small synthetic Chrome trace."""

import re
from types import SimpleNamespace

import pytest

from portbench.run import reader
from portbench.trace import from_chrome, hand_written

from .helpers import ROOT

K1 = "void (anonymous namespace)::fused_mppi_kernel<bmpc::CartPole, true, 131073ul>(float const*)"
ADD = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >(int)"


GLOBAL = r"__global__ void (?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\("


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


DOC = {"traceEvents": [
    X("portbench.stretch", "user_annotation", 1000.0, 1000.0),
    X("portbench.episodes", "user_annotation", 1000.0, 900.0),
    X(K1, "kernel", 1100.0, 300.0),
    X(ADD, "kernel", 1450.0, 50.0),
    X(ADD, "kernel", 1480.0, 70.0),
    X("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1900.0, 50.0),
    X(K1, "kernel", 3000.0, 300.0),  # after the stretch: left out
    X("aten::mul", "cpu_op", 1420.0, 20.0),
    X("aten::copy_", "cpu_op", 1600.0, 400.0),
    {"ph": "M", "name": "process_name"},
]}


@pytest.fixture
def ctx():
    tr = from_chrome(DOC, steps=2)
    return SimpleNamespace(trace=tr, batch=64, steps=2, config={
        "env": "cartpole_swingup", "solver_args": {"K": 64, "T": 50}})


def test_busy_idle_and_window(ctx):
    tr = ctx.trace
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx((300 + 100 + 50) * 1e-6)
    assert reader("device_idle_pct")(ctx) == pytest.approx(55.0)
    assert [g for g in tr.gaps()] == [(1000.0, 1100.0), (1400.0, 1450.0), (1550.0, 1900.0),
                                      (1950.0, 2000.0)]


def test_launches_and_torch_ops(ctx):
    assert reader("launches_per_step")(ctx) == 1.5
    assert reader("torch_ops_ms_per_step")(ctx) == pytest.approx(0.120 / 2)


def test_roofline_of_the_matched_kernel(ctx):
    from portbench import counts

    least, _ = counts.least_time_s(counts.mppi_work(counts.plant("cartpole_swingup"), 64, 64, 50))
    assert reader("fused_mppi_roofline")(ctx) == pytest.approx(100 * least / 300e-6)
    assert reader("fused_cem_roofline")(ctx) is None  # nothing to read: no kernel 3


def test_idle_gaps_are_named_by_the_host(ctx):
    gaps = dict(ctx.trace.breakdown()["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx((350 + 50) * 1e-6)
    assert gaps["portbench.episodes"] == pytest.approx(100e-6)
    assert gaps["aten::mul"] == pytest.approx(50e-6)
    ops = dict(ctx.trace.breakdown()["device_ops"])
    assert ops[K1] == pytest.approx(300e-6)


def test_every_hand_written_kernel_has_a_pattern():
    src = ROOT / "benchmarking_mpc_solvers_tpu_torch" / "csrc"
    names = set()
    for path in list(src.glob("*.cu")) + list(src.glob("*.cuh")):
        names |= set(re.findall(GLOBAL, path.read_text()))
    assert names
    rx = re.compile("|".join(hand_written().values()))
    for name in names:
        assert rx.search(f"void (anonymous namespace)::{name}<float>(int)"), name
    assert not rx.search(ADD)
