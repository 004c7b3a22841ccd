"""One run of one benchmark cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and traffic come
from ``BENCHMARK.json`` and the files under ``portbench/`` named after
them. Set-up (imports, the card, the kernels' libraries, two warm-up
batches of the cell's own shapes) is ``setup_s``. The window then runs
batch after batch of closed-loop episodes for ``--seconds``: a batch starts
when the previous batch's summed costs are on the host. With ``--trace 1``
a few batches after the first second run under the profiler, and the
result carries the per-layer metrics; else the end-to-end ones. Once the
window has closed a sample of its episodes is held against the plain
reference (``check.py``). The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error too.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "benchmarking_mpc_solvers_tpu")
TRACE_AFTER_S = 1.0  # the stretch starts once the window has run this long (or a third of it)
TRACE_MIN_S, TRACE_MIN_BATCHES = 0.25, 3  # and lasts at least this long and this many


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the JAX package's."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def cell_spec(name: str, root: Path) -> dict:
    """The workload entry, its configuration, traffic and check, and its
    metrics, from the checkout at ``root``."""
    from portbench.workload import load_json

    here = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}

    def applies(m):
        return name in m.get("workloads", [name])
    return {"cell": cell, "dir": here,
            "config": json.loads((root / configs[cell["config"]]["file"]).read_text()),
            "traffic": load_json("traffic", cell["traffic"], here),
            "checks": load_json("checks", name, here),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def reader(name: str, root: Path = HERE):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    from portbench.workload import find

    path = find("metrics", name, root)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: list, ctx, root: Path = HERE) -> dict:
    """Each metric a reader finds something for, by name, with its unit."""
    out = {}
    for m in metrics:
        value = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def card_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or ''."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float = T0, workload=None) -> dict:
    """One run of a cell (``cell_spec``) on ``device``; returns the result's
    fields. A test passes its own ``workload``, e.g. one whose timed path is
    broken."""
    import torch
    from torch.profiler import record_function

    from portbench import check
    from portbench.workload import WARMUP, Workload

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    wl = workload or Workload(spec["config"], spec["traffic"], device)
    checks = spec["checks"]
    for i in range(2):  # the cell's own shapes: loads the libraries, fills the caches
        wl.run(wl.inputs(seed, i, WARMUP)).costs.sum(dim=1).cpu()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), int(seed < 0), 7]))
    kept = check.Reservoir(checks["sample_batches"], rng)
    times, failed, traced = [], 0, None

    def one_batch(i):
        nonlocal failed
        with record_function("portbench.inputs"):
            inp = wl.inputs(seed, i)
        tb = time.perf_counter()
        with record_function("portbench.episodes"):
            res = wl.run(inp)
        with record_function("portbench.fetch"):
            tot = res.costs.sum(dim=1).cpu().numpy()
        times.append(time.perf_counter() - tb)
        failed += int((~np.isfinite(tot)).sum())
        kept.offer((i, res))

    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds or (trace and traced is None):
        if trace and traced is None and time.perf_counter() - start >= min(TRACE_AFTER_S,
                                                                             seconds / 3):
            from portbench.trace import profile_stretch

            def stretch():
                nonlocal i
                s0, n0 = time.perf_counter(), i
                while i - n0 < TRACE_MIN_BATCHES or time.perf_counter() - s0 < TRACE_MIN_S:
                    one_batch(i)
                    i += 1
                return (i - n0) * wl.steps
            traced = profile_stretch(stretch)
            continue
        one_batch(i)
        i += 1
    window_s = time.perf_counter() - start
    memory = torch.cuda.max_memory_allocated() if cuda else 0

    ctx = SimpleNamespace(config=spec["config"], traffic=spec["traffic"],
                          batch=wl.B, steps=wl.steps, batches=i, batch_times=times,
                          window_s=window_s, setup_s=setup_s, trace=traced)
    metrics = read_metrics(spec["per_layer"] if trace else spec["end_to_end"], ctx,
                           spec.get("dir", HERE))

    # the check: the kept batches' sampled scenarios against the reference
    plant, solver = check.reference_for(spec["config"])
    readings = {k: 0.0 for k in check.GAPS}
    with torch.no_grad():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for bi, res in sorted(kept.items, key=lambda item: item[0]):
            idx = check.sample(seed, bi, wl.B, checks["sample_scenarios"])
            ref = solver.episodes(plant, spec["config"]["solver_args"], wl.run_spec,
                                  wl.inputs(seed, bi), idx)
            got = check.gaps(check.program_outputs(res, idx), ref, plant)
            readings = {k: max(readings[k], got[k]) for k in check.GAPS}
        sync()
    kept.items.clear()
    compared = {k: {"value": readings[k], "limit": checks["limits"][k]} for k in check.GAPS}
    correct = bool(kept.seen) and check.judge(readings, checks["limits"]) and failed == 0

    out = {"correct": correct, "attempted": i * wl.B, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                      "count": spec["cell"]["chips"], "memory_peak_bytes": int(memory)}}
    if traced is not None:
        out["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        out["breakdown"] = traced.breakdown()
    out["checks"] = compared
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    cache = root / "build" / "portbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    spec = cell_spec(args.workload, root)

    import torch

    torch.set_num_threads(1)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    print(f"portbench: card {card_limit()}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
