"""Shared pieces of the study scripts: start states, environment names, the
argument parser, and ``run_and_store`` with its sweep checkpoint; and the
measurement scripts' timer and output file.

Counterpart of ``scripts/_common.py``. Each sweep script yields its
configurations from ``grid(args)`` as ``(collection, params, warmstart)``,
touching nothing on disk, and ``run_grid`` runs them. Results go to
``results_torch/`` and figures to ``ResultPlots_torch/`` unless
``--results-dir`` / ``--plots-dir`` say otherwise: ``results/`` holds the
JAX package's study runs, each marked done in its collection's checkpoint,
and is only read. ``--device`` (default ``cuda``) is where the episodes run;
without CUDA a sweep raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..experiment import Experiment, ResultStore
from ..utils import SweepCheckpoint

START_STATES = {
    "pendulum": np.array([np.pi, 0.0]),
    "cartpole_swingup": np.array([0.0, 0.0, np.pi, 0.0]),
    "acrobot": np.array([0.0, 0.0, 0.0, 0.0]),
}

ENV_NAMES = {
    "pendulum": "PendulumEnvironment",
    "cartpole_swingup": "CartpoleSwingupEnvironment",
    "acrobot": "AcrobotEnvironment",
}

# one configuration of a sweep: (collection, Experiment params, warm start)
Config = Tuple[str, dict, Optional[int]]


def std_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--results-dir", default="results_torch")
    p.add_argument("--plots-dir", default="ResultPlots_torch")
    p.add_argument("--quick", action="store_true",
                   help="tiny sweep for smoke-testing (seconds instead of minutes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-data", action="store_true", help="skip data generation")
    p.add_argument("--no-plots", action="store_true", help="skip plot generation")
    p.add_argument("--device", default="cuda",
                   help="where the episodes run: cuda (the default; raises without a card) "
                        "or cpu (the plain PyTorch versions)")
    return p


def config_key(params: dict, warmstart: Optional[int]) -> str:
    """A configuration's entry in the sweep checkpoint, in the JAX
    package's format."""
    return json.dumps(
        {k: v for k, v in params.items() if k != "start_state"}
        | {"start_state": np.asarray(params["start_state"]).tolist(), "ws": warmstart},
        sort_keys=True, default=str,
    )


def run_and_store(store: ResultStore, params: dict, warmstart: Optional[int] = 50,
                  device="cuda") -> Optional[dict]:
    """Run one configuration into the store, with crash-resume: each
    completed configuration is marked in a checkpoint file beside the
    collection, so a killed sweep run again skips finished work."""
    ckpt = SweepCheckpoint(str(store.dir / "sweep_checkpoint.json"))
    cfg_key = config_key(params, warmstart)
    if ckpt.is_done(cfg_key):
        print(f"[skip – done] {params['agent']} on {params['env']} {params['agent_config']}")
        return None
    result = Experiment(params, device=device)(warmstart=warmstart)
    store.insert(result)
    ckpt.mark(cfg_key)
    total = float(np.sum(result["env_costs"]))
    print(
        f"[{params['agent']} on {params['env']}] cfg={params['agent_config']} "
        f"cost={total:.1f} time={result['passed_time']}s (compile {result.get('compile_time')}s)",
        flush=True,
    )
    return result


def run_grid(args: argparse.Namespace, configs: Iterable[Config]) -> List[dict]:
    """Run every configuration of a grid into its collection under
    ``args.results_dir`` on ``args.device``; returns the new results."""
    resolve_device(args.device)
    stores, results = {}, []
    for collection, params, warmstart in configs:
        if collection not in stores:
            stores[collection] = ResultStore(args.results_dir, collection)
        result = run_and_store(stores[collection], params, warmstart, device=args.device)
        if result is not None:
            results.append(result)
    return results


def cost_band(results: Iterable[dict], key: Callable[[dict], float]) -> dict:
    """Median and quartiles of the episode totals (each step's cost clipped
    to [-20, 20]) of results grouped by ``key``, every repetition an
    episode: one band of ``plot_cost_bands``."""
    groups = {}
    for r in results:
        batch = np.asarray(r.get("batch_costs", r["env_costs"][None]))
        groups.setdefault(key(r), []).extend(np.clip(batch, -20, 20).sum(axis=1))
    xs = sorted(groups)
    return {"x": xs,
            "median": [np.median(groups[x]) for x in xs],
            "q25": [np.quantile(groups[x], 0.25) for x in xs],
            "q75": [np.quantile(groups[x], 0.75) for x in xs]}


def episode_counts(results: Iterable[dict]) -> Tuple[int, int]:
    """The episodes of results, every repetition one, and how many of them
    have a non-finite total: reported beside a median, never dropped."""
    totals = np.concatenate([np.asarray(r["batch_costs"]).sum(axis=1) for r in results])
    return int(totals.size), int((~np.isfinite(totals)).sum())


# --- the measurement scripts (roofline, profile_*, bench_riccati, scaling_bench) ---

def wall_seconds(fn: Callable, device, reps: int = 5) -> float:
    """The least seconds of one ``fn()`` over ``reps`` calls after a warm-up
    call: CUDA events around the call on the card (the host's launches
    inside the interval), the host clock on the CPU, each ending in a
    synchronise."""
    device = torch.device(device)
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return min(times)


def device_record(device) -> dict:
    """What a measurement ran on: the card's name and count, or the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def write_measure(args: argparse.Namespace, name: str, out: dict) -> pathlib.Path:
    """Writes a measurement script's record to
    ``<results-dir>/measure/<name>.json`` and returns the path."""
    path = pathlib.Path(args.results_dir) / "measure" / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print("wrote", path, flush=True)
    return path


def measure_parser(description: str) -> argparse.ArgumentParser:
    """``std_parser`` with ``--samples``: the paired timing samples a
    measurement takes (default: the script's own)."""
    p = std_parser(description)
    p.add_argument("--samples", type=int, default=None,
                   help="timing samples per stage (default: the script's)")
    p.add_argument("--min-chains", action="store_true",
                   help="chains of 1 step and of at least 2, sized to the target time: for "
                        "stages long beside a chain's constant")
    return p


def chain_options(args: argparse.Namespace) -> dict:
    """``utils.device_step_latency``'s chain settings for a measurement
    script's arguments: with ``--quick`` the shortest chains (1 and 2 steps;
    a smoke run, no measurement), with ``--min-chains`` a short chain of one
    step and a long one sized to the target time but at least one step
    longer (for stages long beside a chain's constant), else the timer's
    own."""
    if args.quick:
        return dict(n_lo=1, min_hi=1, target_s=0.0)
    if args.min_chains:
        return dict(n_lo=1, min_hi=1)
    return {}


def stage_timer(stages: dict, device, samples: int, chains: dict, n_inputs: int = 8):
    """``timed(name, fn, inputs, max_hi=160)``: the per-step latency of the
    stage ``fn(input) -> scalar tensor`` over chains of its inputs
    (``utils.device_step_latency`` with ``chains``, a chain's constant cost
    cancelled in the paired difference), into ``stages[name]`` as p50, p90
    and the resolution in ms; a p50 at or below the resolution is flagged.
    A step's chain is host-issued PyTorch, so a stage whose host work
    outlasts its device work reads its host time."""
    from ..utils import device_step_latency

    def timed(name, fn, inputs, max_hi=160):
        def step(c, inp):
            v = fn(inp)
            return c + v, v

        p50, p90, res = device_step_latency(
            step, torch.zeros((), device=device), list(inputs)[:n_inputs], samples=samples,
            max_hi=max_hi, return_stats=True, device=device, **chains)
        stages[name] = {"p50_ms": round(p50, 4), "p90_ms": round(p90, 4),
                        "resolution_ms": round(res, 4)}
        if p50 <= res:
            stages[name]["below_resolution"] = True
        print(f"{name}: p50 {p50:.4f} ms  p90 {p90:.4f} ms  (resolution {res:.4f} ms)",
              flush=True)

    return timed


def perturbations(shape, device, scale: float = 1e-6, n: int = 8, seed: int = 3) -> list:
    """n tensors of ``scale``·N(0, 1) of ``shape`` (numpy, fixed seed): the
    per-step inputs that keep a stage's chained evaluations apart."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(device)
            for _ in range(n)]
