"""LaTeX tables of experiment results.

Counterpart of ``benchmarking_mpc_solvers_tpu/experiment/tables.py``:
cost statistics (mean, min, median and quartiles of the per-episode total
cost, each step's cost clipped to [-20, 20]) and the summed solve time per
(env, solver, T) and per (env, solver, K) group, pivoted with pandas, each
column scaled by its power of ten, written as standalone LaTeX documents.
The pivots need pandas, which ``format_table`` and ``generate_tables``
import when they run: ``aggregate`` is numpy only, so that the quality
check runs where pandas is not installed.
"""

from __future__ import annotations

import pathlib
from typing import TYPE_CHECKING, Dict, Iterable, List

import numpy as np

from .store import ResultStore

if TYPE_CHECKING:
    import pandas as pd

STAT_NAMES = {
    "avg": "Average",
    "min": "Min",
    "med": "Median",
    "q25": "Q 25",
    "q75": "Q 75",
    "time": "Time",
}


def aggregate(results: Iterable[Dict], clip: float = 20.0) -> Dict[str, float]:
    """Cost/time statistics over a set of result dicts (one table row); the
    batched repetitions of a result count as episodes too."""
    times, totals = [], []
    for r in results:
        times.append(float(r["passed_time"]))
        costs = np.asarray(r["env_costs"])
        totals.append(float(np.clip(costs, -clip, clip).sum()))
        batch = r.get("batch_costs")
        if batch is not None and np.asarray(batch).ndim == 2:
            extra = np.clip(np.asarray(batch), -clip, clip).sum(axis=1)
            totals.extend(float(t) for t in extra[1:])
    totals_arr = np.asarray(totals)
    return {
        STAT_NAMES["avg"]: float(totals_arr.mean()),
        STAT_NAMES["min"]: float(totals_arr.min()),
        STAT_NAMES["med"]: float(np.median(totals_arr)),
        STAT_NAMES["q25"]: float(np.quantile(totals_arr, 0.25)),
        STAT_NAMES["q75"]: float(np.quantile(totals_arr, 0.75)),
        STAT_NAMES["time"]: float(np.sum(times)),
    }


def format_table(table: pd.DataFrame) -> str:
    """Column-wise power-of-ten scaling and booktabs LaTeX."""
    mins = table.min()
    exps = mins.apply(lambda x: int(np.floor(np.log10(abs(x)))) if x else 0)
    powers = exps.apply(lambda e: 10.0**e)
    scaled = table.apply(lambda row: row / powers, axis=1)
    scaled = scaled.rename(
        columns={c: c + r" $(1 \times 10^{" + str(exps[c]) + r"})$" for c in table.columns}
    )
    return scaled.to_latex(escape=False, float_format="%.2f")


def write_latex_table(path: str, table_tex: str) -> None:
    doc = "\n".join(
        [
            r"\documentclass[]{standalone}",
            r"\usepackage{booktabs}",
            r"\usepackage[table,xcdraw]{xcolor}",
            r"\begin{document}",
            table_tex,
            r"\end{document}",
        ]
    )
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(path).write_text(doc)


def generate_tables(
    stores: List[ResultStore],
    out_dir: str,
    envs: Iterable[str] = (
        "PendulumEnvironment",
        "CartpoleSwingupEnvironment",
        "AcrobotEnvironment",
    ),
    solvers: Iterable[str] = ("CEM", "ILQR", "MPPI", "QPMPC", "SQP", "I2C"),
    horizons: Iterable[int] = (5, 10, 25, 50),
    sample_counts: Iterable[int] = (10, 20, 50, 200, 500),
) -> List[str]:
    """Write <env>_T_table.tex and <env>_K_table.tex; returns their paths."""
    import pandas as pd

    written = []
    for env in envs:
        rows_T, rows_K = [], []
        for T in horizons:
            for solver in solvers:
                results = []
                for store in stores:
                    results += store.find({"env_name": env, "agent_name": solver,
                                           "agent_config.T": T})
                if results:
                    rows_T.append({"T": T, "Solver": solver, **aggregate(results)})
        for K in sample_counts:
            for solver in solvers:
                results = []
                for store in stores:
                    results += store.find({"env_name": env, "agent_name": solver,
                                           "agent_config.K": K})
                if results:
                    rows_K.append({"K": K, "Solver": solver, **aggregate(results)})
        for suffix, rows, keys in (("T", rows_T, ["T", "Solver"]),
                                   ("K", rows_K, ["K", "Solver"])):
            if not rows:
                continue
            df = pd.DataFrame(rows).set_index(keys)
            path = str(pathlib.Path(out_dir) / f"{env}_{suffix}_table.tex")
            write_latex_table(path, format_table(df))
            written.append(path)
    return written
