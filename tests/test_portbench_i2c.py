"""The I2C cell (``i2c-t50-clean``) on the CPU, at its tiny spec (B = 8,
T = 8, 3 steps, its three smoothing iterations):

- the program's episodes through ``portbench.workload.Workload`` against
  the plain reference (``portbench/reference/i2c.py``): equal to the bit,
  tolerance 0, since the reference takes the program's order of operations
  and the CPU runs kernels 8a/8b's plain versions, which keep the kernels'
  bits; so every gap reads 0, under the cell's limits;
- the reference summed in the witness's order and in bfloat16 on the same
  inputs: the witness within the cell's limits, bfloat16 outside them;
- the four faults planted in ``I2C.solve_batch``, each read ``correct``
  false under the cell's own limits;
- the reference loads neither JAX nor the program;
- the frozen counts of kernels 8a/8b are ``chip_smoke.py``'s at the cell's
  shape;
- the solver's three stage spans, once an iteration under
  ``episode.solve``, with the plans the same to the bit as with spans off.
"""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmarking_mpc_solvers_tpu_torch.utils import profiling
from portbench import check, counts
from portbench.counts import i2c as i2c_counts
from portbench.run import reader, run_cell
from portbench.tests.helpers import FAULTS, cell_limits
from portbench.tests.i2c_helpers import CELL, broken_i2c_workload, tiny_i2c_spec
from portbench.workload import Workload

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("i2c.linearize", "i2c.smooth", "i2c.linesearch")
SEED = 2**33 + 25


@pytest.fixture(scope="module")
def tiny():
    """The tiny cell's workload, one batch's inputs and the program's episodes."""
    spec = tiny_i2c_spec(cell_limits(CELL))
    wl = Workload(spec["config"], spec["traffic"], "cpu")
    inp = wl.inputs(SEED, 3)
    return spec, wl, inp, wl.run(inp)


def _reference(spec, wl, inp, **kwargs):
    plant, solver = check.reference_for(spec["config"])
    ref = solver.episodes(plant, spec["config"]["solver_args"], wl.run_spec, inp,
                          list(range(wl.B)), **kwargs)
    return plant, ref


def test_the_program_matches_the_reference_to_the_bit(tiny):
    spec, wl, inp, res = tiny
    plant, ref = _reference(spec, wl, inp)
    assert torch.equal(res.actions[..., 0], ref.actions)
    assert torch.equal(res.true_states, ref.states)
    assert torch.equal(res.costs, ref.costs)
    got = check.gaps(check.program_outputs(res, list(range(wl.B))), ref, plant)
    assert got == {k: 0.0 for k in check.GAPS}
    assert check.judge(got, spec["checks"]["limits"])


@pytest.mark.parametrize("kind", ["witness", "bfloat16"])
def test_the_witness_passes_and_bfloat16_does_not(tiny, kind):
    spec, wl, inp, _ = tiny
    kwargs = {"order": "witness"} if kind == "witness" else {"dt": torch.bfloat16}
    plant, ref = _reference(spec, wl, inp)
    _, low = _reference(spec, wl, inp, **kwargs)
    got = check.gaps((low.actions, low.states, low.costs), ref, plant)
    assert got["first_action_gap"] > 0.0
    assert check.judge(got, spec["checks"]["limits"]) == (kind == "witness"), got


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(fault):
    spec = tiny_i2c_spec(cell_limits(CELL))
    out = run_cell(spec, SEED, 0.3, False, device="cpu",
                   workload=broken_i2c_workload(spec, fault))
    assert not out["correct"], out["checks"]
    assert out["failed"] == 0


def test_the_reference_loads_neither_jax_nor_the_program():
    code = ("import sys, portbench.reference.i2c, portbench.reference.cartpole_swingup; "
            "print(sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'benchmarking_mpc_solvers_tpu', "
            "'benchmarking_mpc_solvers_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_counts_are_chip_smokes_at_the_cell_shape():
    import chip_smoke

    B, T, D = 40960, 50, counts.plant("cartpole_swingup")["Z"]

    def meta(*shape):
        return torch.empty(shape, device="meta")
    p = [meta(B, T, D, D), meta(B, T, D), meta(B, T, D, D), meta(B, T, D), meta(D, D),
         meta(B, D), meta(D, D), meta(D, D), meta(T, D)]
    (fb, fo, _), (rb, ro, _) = chip_smoke.i2c_work(p, 1980.0)
    assert i2c_counts.filter_work(B, T, D, D) == (fb, fo)
    assert i2c_counts.rts_work(B, T, D) == (rb, ro)
    # the kernel table's bytes bounds at the sweep's B = 10,240 (PERF.md)
    for work, ms in ((i2c_counts.filter_work(10240, T, D, D), 0.0734),
                     (i2c_counts.rts_work(10240, T, D), 0.0550)):
        seconds, by = counts.least_time_s(work)
        assert by == "bytes" and seconds * 1e3 == pytest.approx(ms, rel=2e-3)


def test_the_stage_spans_mark_each_iteration_and_keep_the_bits(tiny):
    from portbench.trace import profile_stretch

    spec, wl, inp, res = tiny
    profiling.clear_spans()
    got = []

    def one_batch():
        got.append(wl.run(inp))
        return wl.steps
    traced = profile_stretch(one_batch)
    iters = wl.steps * spec["config"]["solver_args"]["max_iter"]
    totals = profiling.span_totals("episode.solve")
    assert {name: totals[name]["count"] for name in STAGES} == dict.fromkeys(STAGES, iters)
    assert not any(name in profiling.span_totals("episode.step") for name in STAGES)
    for field in ("actions", "true_states", "costs"):
        assert torch.equal(getattr(got[0], field), getattr(res, field))
    ctx = SimpleNamespace(trace=traced, config=spec["config"], batch=wl.B)
    for stage in ("linearize", "smooth", "linesearch"):
        assert reader(f"i2c_{stage}_ms_per_step")(ctx) > 0.0
    assert reader("i2c_filter_roofline")(ctx) is None  # no kernel on the CPU
    assert reader("i2c_smoother_roofline")(ctx) is None
    profiling.clear_spans()

