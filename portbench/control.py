"""Readings that set a cell's limits: the program's sound runs and the
control, at the cell's own size, in one process.

    python3 -m portbench.control --workload <name> --seeds 11 12 ... \
        --control-seeds 21 22 23 --witness-seeds 31 32 --seconds 3

For each of ``--seeds`` a short run of the cell (its window, its sample,
its reference), whose three gaps are the program's sound readings. For
each of ``--control-seeds`` the control: the reference computed in
bfloat16, the nearest precision below the float32 the configurations
state, put in the program's place on the same inputs and the same sampled
scenarios as a run compares, and held against the float32 reference. For
each of ``--witness-seeds`` a sound witness: the reference in float32 with
its sums over the samples in another order (``order="witness"``), in the
program's place the same way. One JSON line per reading; the benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from portbench import check
from portbench.run import cell_spec, run_cell
from portbench.workload import Workload

NO_LIMIT = {k: float("inf") for k in check.GAPS}


def control_readings(spec: dict, seed: int, checks: dict, device="cuda",
                     dt=torch.bfloat16, order="program") -> dict:
    """The control's gaps: ``checks['sample_batches']`` batches of the seed's
    inputs, their sampled scenarios through the reference in ``dt`` (summed
    in ``order``) against the reference in float32."""
    wl = Workload(spec["config"], spec["traffic"], device)
    plant, solver = check.reference_for(spec["config"])
    args = spec["config"]["solver_args"]
    out = {k: 0.0 for k in check.GAPS}
    by_step = None
    with torch.no_grad():
        for bi in range(checks["sample_batches"]):
            idx = check.sample(seed, bi, wl.B, checks["sample_scenarios"])
            inp = wl.inputs(seed, bi)
            ref = solver.episodes(plant, args, wl.run_spec, inp, idx)
            low = solver.episodes(plant, args, wl.run_spec, inp, idx, dt=dt, order=order)
            got = check.gaps((low.actions, low.states, low.costs), ref, plant)
            out = {k: max(out[k], got[k]) for k in check.GAPS}
            gone = ((low.actions - ref.actions).abs() > check.DEPART).cummax(dim=1).values
            share = (100.0 * gone.float().mean(dim=0)).tolist()
            by_step = share if by_step is None else [max(a, b) for a, b in zip(by_step, share)]
    out["departed_pct_by_step"] = by_step
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    spec = cell_spec(args.workload, Path.cwd())
    checks = spec["checks"] = {**spec["checks"], "limits": NO_LIMIT}
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        out = run_cell(spec, seed, args.seconds, False, t0=t)
        print(json.dumps({"workload": args.workload, "kind": "program", "seed": seed,
                          "readings": {k: v["value"] for k, v in out["checks"].items()},
                          "metrics": out["metrics"], "seconds": time.perf_counter() - t}),
              flush=True)
    for seed in args.control_seeds:
        t = time.perf_counter()
        got = control_readings(spec, seed, checks)
        print(json.dumps({"workload": args.workload, "kind": "control_bfloat16", "seed": seed,
                          "readings": got, "seconds": time.perf_counter() - t}), flush=True)
    for seed in args.witness_seeds:
        t = time.perf_counter()
        got = control_readings(spec, seed, checks, dt=torch.float32, order="witness")
        print(json.dumps({"workload": args.workload, "kind": "witness_order", "seed": seed,
                          "readings": got, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
