"""The I2C cell for the tests: its tiny spec for the CPU, and the faults of
``helpers.FAULTS`` planted in ``I2C.solve_batch`` (``helpers.broken_workload``
plants them in a solver with a kernel tier; I2C has none)."""

from .helpers import ROOT, TIGHT, _Patched

CELL = "i2c-t50-clean"


def tiny_i2c_spec(limits: dict = None) -> dict:
    """The cell's spec from this checkout at B = 8, T = 8 and 3 steps, its
    three smoothing iterations kept: a size the CPU runs in seconds."""
    from portbench.run import cell_spec

    spec = cell_spec(CELL, ROOT)
    spec["config"] = dict(spec["config"], solver_args=dict(spec["config"]["solver_args"], T=8),
                          n_steps=3)
    spec["traffic"] = dict(spec["traffic"], batch=8)
    spec["checks"] = {"sample_batches": 2, "sample_scenarios": 8,
                      "limits": dict(limits or TIGHT)}
    return spec


def broken_i2c_workload(spec: dict, fault: str, device="cpu"):
    """The cell's workload with ``I2C.solve_batch`` broken underneath:
    ``unchanged`` returns the plans as they came; ``half_left_out`` leaves
    half of the batch's plans unchanged; ``late_half_left_out`` does so
    from the solver's second call of an episode on, so that the first step
    is sound; ``answer_altered`` adds 0.01 to every plan it returns."""
    from portbench.workload import Workload

    wl = Workload(spec["config"], spec["traffic"], device)
    solver = wl.solver
    solve = type(solver).solve_batch
    calls = [0]

    def broken(state, xs, g_z, **kwargs):
        plan = state.planned_us
        out, _, info = solve(solver, state, xs, g_z, **kwargs)
        new = out.planned_us
        call, calls[0] = calls[0] % wl.steps, calls[0] + 1
        if fault == "unchanged":
            new = plan.clone()
        elif fault == "half_left_out" or (fault == "late_half_left_out" and call > 0):
            half = new.shape[0] // 2
            new = new.clone()
            new[half:] = plan[half:]
        elif fault == "answer_altered":
            new = new + 0.01
        return out._replace(planned_us=new), new[:, 0], info

    wl.solver = _Patched(solver, "solve_batch", broken)
    return wl
