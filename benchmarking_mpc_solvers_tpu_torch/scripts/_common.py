"""Shared pieces of the study scripts: start states, environment names, the
argument parser, and ``run_and_store`` with its sweep checkpoint.

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
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

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
