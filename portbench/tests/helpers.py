"""Tiny cells for the CPU tests: the benchmark's own configurations and
traffic mixes, cut to B = 8, T = 10, K = 16 and 3 steps; and the faults a
cell's timed path can have, planted in the program's solver step."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("mppi-k64-clean", "cem-k64-clean", "mppi-k64-sensor-noise")
TIGHT = {"first_action_gap": 1e-6, "departed_pct": 0.0, "plant_gap": 0.0}
FAULTS = ("unchanged", "half_left_out", "late_half_left_out", "answer_altered")


def cell_limits(cell: str) -> dict:
    """The limits the cell's runs are judged by (``checks/<cell>.json``)."""
    from portbench.workload import load_json

    return dict(load_json("checks", cell, ROOT / "portbench")["limits"])


def tiny_spec(cell: str, limits: dict = None) -> dict:
    """The cell's spec from this checkout, at a size the CPU runs in seconds."""
    from portbench.run import cell_spec

    spec = cell_spec(cell, ROOT)
    args = dict(spec["config"]["solver_args"], T=10, K=16)
    spec["config"] = dict(spec["config"], solver_args=args, n_steps=3)
    spec["traffic"] = dict(spec["traffic"], batch=8)
    spec["checks"] = {"sample_batches": 2, "sample_scenarios": 8,
                      "limits": dict(limits or TIGHT)}
    return spec


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def broken_workload(spec: dict, fault: str, device="cpu"):
    """The cell's workload with its solver's step broken underneath:
    ``unchanged`` returns the plan as it came; ``half_left_out`` leaves half
    of the batch's plans unchanged; ``late_half_left_out`` does so from the
    solver's second call of an episode on, so that the first step is sound;
    ``answer_altered`` adds 0.01 to every plan it returns."""
    from portbench.workload import Workload

    wl = Workload(spec["config"], spec["traffic"], device)
    solver = wl.solver
    kernel = solver.kernel_ok()
    step = type(solver).solve_batch_tm if kernel else type(solver).solve_batch
    calls = [0]

    def broken(*args, **kwargs):
        if kernel:
            plan = args[0]
            new, _ = step(solver, *args, **kwargs)
        else:
            plan = args[0].planned_us
            state, _, info = step(solver, *args, **kwargs)
            new = state.planned_us
        call, calls[0] = calls[0] % wl.steps, calls[0] + 1
        if fault == "unchanged":
            new = plan.clone()
        elif fault == "half_left_out" or (fault == "late_half_left_out" and call > 0):
            half = new.shape[1 if kernel else 0] // 2
            new = new.clone()
            if kernel:
                new[:, half:] = plan[:, half:]
            else:
                new[half:] = plan[half:]
        elif fault == "answer_altered":
            new = new + 0.01
        if kernel:
            return new, new[0]
        return state._replace(planned_us=new), new[:, 0], info

    name = "solve_batch_tm" if kernel else "solve_batch"
    wl.solver = _Patched(solver, name, broken)
    return wl


class _Patched:
    """A solver whose one method is replaced; everything else forwarded."""

    def __init__(self, solver, name, fn):
        self._solver, self._name, self._fn = solver, name, fn

    def __getattr__(self, attr):
        return self._fn if attr == self._name else getattr(self._solver, attr)
