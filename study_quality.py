"""The study's T=10 quality check: the port's sweeps on the card against
the JAX package's study runs in ``results/``.

    python3 study_quality.py run      # on the card; resumes where a cut call stopped
    python3 study_quality.py compare  # host only: the table from the two stores

``run`` takes the T=10 column's configurations from the port's own sweep
grids and runs them through each script's ``run_and_store`` on the card,
at full width (5 repetitions, 100 steps, warm start 50), into
``--results-dir`` (default ``results_torch``): MPPI with the six
temperatures at K=100 (``mppi_temperature``), iLQR at max_iter 5, 10 and 25
(``ilqr_tuning``), CEM at K=50 with the five elite ratios
(``sample_test``), on each of the three plants. Each collection's sweep
checkpoint skips what an earlier call finished. It ends with ``compare``.

``compare`` gives, per (plant, solver) cell, the port's median episode
total with its quartiles (the study's aggregation: each step's cost clipped
to [-20, 20], summed over the episode, every repetition an episode;
``experiment/tables.py:aggregate``) beside the JAX package's over the same
configurations in ``results/`` (every ``agent_config`` key equal,
noiseless, 100 steps), the ratio of the medians, the episodes on each side,
the non-finite episodes on each side (kept in the median, never dropped),
and whether the port's median lies within the JAX runs' [Q25, Q75]. Then
each configuration's ``passed_time`` and ``compile_time`` on the card, and
an estimate of the three sweeps' full wall time from them. It writes the
whole as JSON to ``--json`` (default ``<results-dir>/study_quality.json``).
Imports only the port and numpy.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

from benchmarking_mpc_solvers_tpu_torch.experiment import ResultStore
from benchmarking_mpc_solvers_tpu_torch.experiment.tables import aggregate
from benchmarking_mpc_solvers_tpu_torch.scripts import (
    _common, ilqr_tuning, mppi_temperature, sample_test)

STEPS = 100
# the JAX package's study runs, only read
REFERENCE_DIR = str(pathlib.Path(__file__).resolve().parent / "results")
# the T=10 column of each sweep, cheapest first: (script, configuration filter)
SUBSET = (
    (mppi_temperature, lambda p: p["agent_config"]["T"] == 10),
    (ilqr_tuning, lambda p: p["agent_config"]["T"] == 10),
    (sample_test, lambda p: p["agent"] == "CEM" and p["agent_config"]["T"] == 10
     and p["agent_config"]["K"] == 50),
)


def configs(args):
    """The subset's (script, collection, params, warmstart), from the full
    grids in their order."""
    for mod, keep in SUBSET:
        for collection, params, warm in mod.grid(args):
            if keep(params):
                yield mod, collection, params, warm


def run(args) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _common.run_grid(args, (c[1:] for c in configs(args)))
    print(f"[{smi}] run: {time.perf_counter() - t0:.1f} s", flush=True)


def _matching(store, params):
    return [r for r in store.find({"env_name": _common.ENV_NAMES[params["env"]],
                                   "agent_name": params["agent"],
                                   "actuation_noise": False, "sensor_noise": False})
            if r["agent_config"] == params["agent_config"]
            and np.asarray(r["batch_costs"]).shape[-1] == STEPS]


def compare(args) -> dict:
    cells, timings = {}, []
    for mod, collection, params, _warm in configs(args):
        cell = cells.setdefault((params["env"], params["agent"]),
                                {"port": [], "jax": [], "configs": 0, "run": 0})
        port = _matching(ResultStore(args.results_dir, collection), params)
        cell["configs"] += 1
        if port:  # a configuration the port has not run yet is left out on both sides
            cell["run"] += 1
            cell["port"] += port
            cell["jax"] += _matching(ResultStore(REFERENCE_DIR, collection), params)
        for r in port:
            timings.append({"script": mod.__name__.rsplit(".", 1)[1], "env": params["env"],
                            "agent_config": params["agent_config"],
                            "passed_time": r["passed_time"], "compile_time": r["compile_time"]})
    rows = []
    print("| Plant | Solver | port median [Q25, Q75] | JAX median [Q25, Q75] | port/JAX "
          "| episodes port / JAX | non-finite port / JAX | inside JAX [Q25, Q75] "
          "| configurations |")
    print("|---|---|---|---|---|---|---|---|---|")
    for (env, agent), cell in cells.items():
        row = {"env": env, "agent": agent, "configurations": f"{cell['run']} of {cell['configs']}"}
        for side in ("port", "jax"):
            if cell[side]:
                agg = aggregate(cell[side])
                episodes, bad = _common.episode_counts(cell[side])
                row[side] = {"median": agg["Median"], "q25": agg["Q 25"], "q75": agg["Q 75"],
                             "episodes": episodes, "non_finite": bad,
                             "records": len(cell[side])}
        if "port" in row and "jax" in row:
            p, j = row["port"], row["jax"]
            row["ratio"] = p["median"] / j["median"]
            row["inside"] = bool(j["q25"] <= p["median"] <= j["q75"])
            print(f"| {env} | {agent} | {p['median']:.3f} [{p['q25']:.3f}, {p['q75']:.3f}] "
                  f"| {j['median']:.3f} [{j['q25']:.3f}, {j['q75']:.3f}] | {row['ratio']:.3f} "
                  f"| {p['episodes']} / {j['episodes']} | {p['non_finite']} / "
                  f"{j['non_finite']} | {'yes' if row['inside'] else 'NO'} "
                  f"| {row['configurations']} |")
        else:
            print(f"| {env} | {agent} | {'—' if 'port' not in row else 'port only'} | | | | | "
                  f"| {row['configurations']} |")
        rows.append(row)
    # a full sweep's wall time, estimated: each configuration's two calls
    # (compile_time + 2 passed_time) at T=10, scaled linearly in T, the same
    # for every K of the batched tiers
    per_config = {}
    for t in timings:
        key = (t["script"], t["env"], t["agent_config"].get("max_iter"))
        per_config.setdefault(key, []).append(t["compile_time"] + 2 * t["passed_time"])
    estimates = {}
    for mod, _ in SUBSET:
        name = mod.__name__.rsplit(".", 1)[1]
        total, missing = 0.0, 0
        for _c, params, _w in mod.grid(args):
            solver_script = ("mppi_temperature" if params["agent"] == "MPPI" else name)
            got = per_config.get((solver_script, params["env"],
                                  params["agent_config"].get("max_iter")))
            if got is None:
                missing += 1
                continue
            total += float(np.mean(got)) * params["agent_config"]["T"] / 10
        estimates[name] = {"estimated_s": total, "configs_without_a_measurement": missing}
    print("estimated full-sweep wall time (s):", json.dumps(estimates))
    out = {"cells": rows, "timings": timings, "sweep_estimates": estimates}
    path = pathlib.Path(args.json)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("command", choices=["run", "compare"])
    ap.add_argument("--results-dir", default="results_torch")
    ap.add_argument("--json", default=None)
    opts = ap.parse_args(argv)
    # the sweeps' own options at their defaults (full grids, on the card)
    args = _common.std_parser("").parse_args(["--results-dir", opts.results_dir])
    args.command = opts.command
    args.json = opts.json or str(pathlib.Path(opts.results_dir) / "study_quality.json")
    if args.command == "run":
        run(args)
    return compare(args)


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
