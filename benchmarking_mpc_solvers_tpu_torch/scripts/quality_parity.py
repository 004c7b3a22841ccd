"""The quality table: achieved closed-loop cost against the upstream
study's published medians.

Counterpart of ``scripts/quality_parity.py``. For every (env, solver, T)
cell of the upstream study's T-tables (``ResultPlots/time_comparison/
*_T_table.tex``, transcribed in BASELINE.md), and every (env, solver, K)
cell of its K-tables, it aggregates the sweeps' results the study's way
(each step's cost clipped to [-20, 20], summed over the episode, the median
over every matching noiseless run) and gives each cell a verdict; then the
extension families (QPMPC, SQP, I2C) beside the best published family.
Lower is better everywhere. numpy only.

Run after the sweep scripts have filled ``--results-dir``; the table goes
to ``--out`` (default ``<plots-dir>/QUALITY.md``), never to the JAX
package's ``QUALITY.md``.
"""

import collections
import pathlib

import numpy as np

from ..experiment import ResultStore
from ..experiment.tables import aggregate
from ._common import std_parser

# The upstream study's median episode costs by (env, T, solver), from
# ResultPlots/time_comparison/{Pendulum,CartpoleSwingup,Acrobot}Environment_T_table.tex
REF_MEDIANS = {
    ("PendulumEnvironment", 5): {"CEM": 6.6e2, "ILQR": 6.4e2, "MPPI": 9.0e2},
    ("PendulumEnvironment", 10): {"CEM": 4.2e2, "ILQR": 5.6e2, "MPPI": 6.6e2},
    ("PendulumEnvironment", 25): {"CEM": 3.7e2, "ILQR": 3.9e2, "MPPI": 3.8e2},
    ("PendulumEnvironment", 50): {"CEM": 4.7e2, "ILQR": 3.5e2, "MPPI": 4.6e2},
    ("CartpoleSwingupEnvironment", 5): {"CEM": 8.9e2, "ILQR": 1.3e3, "MPPI": 1.0e3},
    ("CartpoleSwingupEnvironment", 10): {"CEM": 3.4e2, "ILQR": 8.8e2, "MPPI": 2.5e2},
    ("CartpoleSwingupEnvironment", 25): {"CEM": 2.7e2, "ILQR": 6.3e2, "MPPI": 2.3e2},
    ("CartpoleSwingupEnvironment", 50): {"CEM": 4.4e2, "ILQR": 6.3e2, "MPPI": 4.4e2},
    ("AcrobotEnvironment", 5): {"CEM": 1.3e3, "ILQR": 1.2e3, "MPPI": 1.4e3},
    ("AcrobotEnvironment", 10): {"CEM": 9.2e2, "ILQR": 1.3e3, "MPPI": 1.0e3},
    ("AcrobotEnvironment", 25): {"CEM": 1.0e3, "ILQR": 1.1e3, "MPPI": 1.2e3},
    ("AcrobotEnvironment", 50): {"CEM": 1.1e3, "ILQR": 1.2e3, "MPPI": 1.2e3},
}

# the same tables' Q25 and Q75 columns: the study's own spread, the
# yardstick of a missed median
REF_IQR = {
    ("PendulumEnvironment", 5): {"CEM": (6.5e2, 6.9e2), "ILQR": (6.4e2, 6.4e2), "MPPI": (8.5e2, 9.1e2)},
    ("PendulumEnvironment", 10): {"CEM": (4.2e2, 5.5e2), "ILQR": (5.6e2, 5.6e2), "MPPI": (5.6e2, 7.0e2)},
    ("PendulumEnvironment", 25): {"CEM": (3.6e2, 3.8e2), "ILQR": (3.9e2, 3.9e2), "MPPI": (3.6e2, 5.0e2)},
    ("PendulumEnvironment", 50): {"CEM": (4.3e2, 5.5e2), "ILQR": (3.5e2, 3.6e2), "MPPI": (3.5e2, 4.9e2)},
    ("CartpoleSwingupEnvironment", 5): {"CEM": (8.5e2, 1.3e3), "ILQR": (1.3e3, 1.3e3), "MPPI": (9.0e2, 1.2e3)},
    ("CartpoleSwingupEnvironment", 10): {"CEM": (2.8e2, 4.0e2), "ILQR": (7.6e2, 1.2e3), "MPPI": (2.4e2, 3.5e2)},
    ("CartpoleSwingupEnvironment", 25): {"CEM": (2.3e2, 4.5e2), "ILQR": (5.8e2, 7.3e2), "MPPI": (1.9e2, 3.3e2)},
    ("CartpoleSwingupEnvironment", 50): {"CEM": (2.8e2, 8.0e2), "ILQR": (4.9e2, 7.1e2), "MPPI": (3.6e2, 4.9e2)},
    ("AcrobotEnvironment", 5): {"CEM": (1.1e3, 1.3e3), "ILQR": (1.2e3, 1.3e3), "MPPI": (1.3e3, 1.5e3)},
    ("AcrobotEnvironment", 10): {"CEM": (8.3e2, 1.1e3), "ILQR": (1.3e3, 1.3e3), "MPPI": (9.5e2, 1.1e3)},
    ("AcrobotEnvironment", 25): {"CEM": (9.0e2, 1.2e3), "ILQR": (1.1e3, 1.1e3), "MPPI": (1.1e3, 1.5e3)},
    ("AcrobotEnvironment", 50): {"CEM": (1.0e3, 1.3e3), "ILQR": (1.2e3, 1.2e3), "MPPI": (1.2e3, 1.5e3)},
}

# by (env, K, solver), from *Environment_K_table.tex: every horizon (and
# every CEM elite ratio) pooled per K cell; K=100 is swept but unpublished,
# and the published rows end with an MPPI-only K=500 row
REF_K_MEDIANS = {
    ("PendulumEnvironment", 10): {"CEM": 5.5e2, "MPPI": 6.7e2},
    ("PendulumEnvironment", 20): {"CEM": 4.8e2, "MPPI": 6.2e2},
    ("PendulumEnvironment", 50): {"CEM": 4.7e2, "MPPI": 5.8e2},
    ("PendulumEnvironment", 200): {"CEM": 4.8e2, "MPPI": 5.4e2},
    ("PendulumEnvironment", 500): {"MPPI": 6.5e2},
    ("CartpoleSwingupEnvironment", 10): {"CEM": 4.9e2, "MPPI": 4.7e2},
    ("CartpoleSwingupEnvironment", 20): {"CEM": 4.0e2, "MPPI": 4.7e2},
    ("CartpoleSwingupEnvironment", 50): {"CEM": 3.7e2, "MPPI": 3.5e2},
    ("CartpoleSwingupEnvironment", 200): {"CEM": 3.8e2, "MPPI": 3.4e2},
    ("CartpoleSwingupEnvironment", 500): {"MPPI": 2.5e2},
    ("AcrobotEnvironment", 10): {"CEM": 1.1e3, "MPPI": 1.3e3},
    ("AcrobotEnvironment", 20): {"CEM": 1.1e3, "MPPI": 1.3e3},
    ("AcrobotEnvironment", 50): {"CEM": 1.1e3, "MPPI": 1.2e3},
    ("AcrobotEnvironment", 200): {"CEM": 1.1e3, "MPPI": 1.2e3},
    ("AcrobotEnvironment", 500): {"MPPI": 1.1e3},
}

REF_K_IQR = {
    ("PendulumEnvironment", 10): {"CEM": (4.2e2, 6.9e2), "MPPI": (4.9e2, 8.7e2)},
    ("PendulumEnvironment", 20): {"CEM": (4.1e2, 6.7e2), "MPPI": (5.1e2, 8.3e2)},
    ("PendulumEnvironment", 50): {"CEM": (4.1e2, 6.5e2), "MPPI": (3.7e2, 7.2e2)},
    ("PendulumEnvironment", 200): {"CEM": (3.7e2, 6.5e2), "MPPI": (3.7e2, 7.3e2)},
    ("PendulumEnvironment", 500): {"MPPI": (3.6e2, 9.0e2)},
    ("CartpoleSwingupEnvironment", 10): {"CEM": (3.4e2, 9.2e2), "MPPI": (4.2e2, 9.5e2)},
    ("CartpoleSwingupEnvironment", 20): {"CEM": (3.2e2, 9.3e2), "MPPI": (3.4e2, 6.7e2)},
    ("CartpoleSwingupEnvironment", 50): {"CEM": (2.7e2, 9.8e2), "MPPI": (2.6e2, 6.1e2)},
    ("CartpoleSwingupEnvironment", 200): {"CEM": (2.7e2, 9.6e2), "MPPI": (2.3e2, 6.5e2)},
    ("CartpoleSwingupEnvironment", 500): {"MPPI": (2.3e2, 6.2e2)},
    ("AcrobotEnvironment", 10): {"CEM": (1.0e3, 1.3e3), "MPPI": (1.1e3, 1.5e3)},
    ("AcrobotEnvironment", 20): {"CEM": (9.9e2, 1.3e3), "MPPI": (1.1e3, 1.4e3)},
    ("AcrobotEnvironment", 50): {"CEM": (9.4e2, 1.3e3), "MPPI": (1.0e3, 1.4e3)},
    ("AcrobotEnvironment", 200): {"CEM": (9.4e2, 1.3e3), "MPPI": (9.6e2, 1.3e3)},
    ("AcrobotEnvironment", 500): {"MPPI": (1.0e3, 1.4e3)},
}

STORES = ["cem_ratios", "mppi_samples", "temperature_exp", "ilqr_runs2", "noise_test"]
# the K cells pool the collections the K-tables aggregate (table_generation's,
# without the noise sweep, whose noiseless CEM baselines sit off the grid)
K_STORES = ["cem_ratios", "mppi_samples", "temperature_exp", "experiment_test"]
# the families the upstream study never had (new_solver_sweep), against the
# best published family per cell: (column, agent_name, row filter)
EXT_STORE = "qp_sqp_i2c"
EXT_SOLVERS = (
    ("QPMPC", "QPMPC",
     lambda r: r["agent_config"].get("linearize_at", "goal") == "goal"),
    ("QPMPC-LTV", "QPMPC",
     lambda r: r["agent_config"].get("linearize_at") == "plan"),
    ("SQP", "SQP", lambda r: True),
    ("I2C", "I2C", lambda r: True),
)
NOISELESS = {"actuation_noise": False, "sensor_noise": False}


def our_stats(stores, env_name, solver, x, cfg_key="agent_config.T"):
    """The study's statistics over the noiseless runs of one cell, and the
    number of episodes they hold (every repetition counts)."""
    results = []
    for store in stores:
        results += store.find({"env_name": env_name, "agent_name": solver, cfg_key: x,
                               **NOISELESS})
    if not results:
        return None, 0
    n = len(results) + sum(
        max(0, int(np.asarray(r.get("batch_costs", [[0]])).shape[0]) - 1)
        for r in results if r.get("batch_costs") is not None
    )
    return aggregate(results), n


def verdict_rows(ref_medians, stores, cfg_key):
    """One verdict table's rows, its tally by verdict, and its misses."""
    rows, tally, misses = [], collections.Counter(), []
    for (env_name, x), ref_row in sorted(ref_medians.items()):
        for solver, ref_med in sorted(ref_row.items()):
            agg, n = our_stats(stores, env_name, solver, x, cfg_key)
            if agg is None:
                rows.append(f"| {env_name} | {x} | {solver} | {ref_med:.3g} | — | — | 0 | NO DATA |")
                tally["NO DATA"] += 1
                continue
            ratio = agg["Median"] / ref_med
            verdict = "BEAT" if ratio < 1.0 else "match" if ratio <= 1.05 else "MISS"
            tally[verdict] += 1
            if verdict == "MISS":
                misses.append((env_name, x, solver, ref_med, agg, n))
            rows.append(f"| {env_name} | {x} | {solver} | {ref_med:.3g} | {agg['Median']:.3g} "
                        f"| {ratio:.2f} | {n} | {verdict} |")
    return rows, tally, misses


def miss_rows(misses, ref_iqr):
    """Each missed median beside the study's own [Q25, Q75] of the cell."""
    rows = []
    for env_name, x, solver, ref_med, agg, _n in misses:
        q25, q75 = ref_iqr.get((env_name, x), {}).get(solver, (None, None))
        inside = "yes" if (q25 is not None and q25 <= agg["Median"] <= q75) else "NO"
        ref = f"{ref_med:.3g} [{q25:.3g}, {q75:.3g}]" if q25 is not None else f"{ref_med:.3g} [—]"
        rows.append(f"| {env_name} | {x} | {solver} | {ref} "
                    f"| {agg['Median']:.3g} [{agg['Q 25']:.3g}, {agg['Q 75']:.3g}] | {inside} |")
    return rows


MISS_HEADER = ["| Env | {} | Solver | ref median [Q25, Q75] | ours median [Q25, Q75] "
               "| inside ref IQR? |", "|---|---|---|---|---|---|"]
TABLE_HEADER = ["| Env | {} | Solver | ref median | ours median | ours/ref | runs | verdict |",
                "|---|---|---|---|---|---|---|---|"]


def header(rows, x):
    return [r.format(x) for r in rows]


def build(results_dir) -> list:
    """The quality table's lines from the collections under results_dir."""
    stores = [ResultStore(results_dir, name) for name in STORES]
    lines = [
        "# QUALITY — achieved closed-loop cost against the upstream study's published medians",
        "",
        "Median total episode cost (each step's cost clipped to [-20, 20], summed over",
        "the 100-step episode, the median over all matching noiseless runs), the",
        "aggregation of the study's table generator. Published medians from",
        "`ResultPlots/time_comparison/*_T_table.tex`. `ours/ref` < 1 beats the study's",
        "solution quality; <= 1.05 matches it.",
        "",
        *header(TABLE_HEADER, "T"),
    ]
    rows, tally, misses = verdict_rows(REF_MEDIANS, stores, "agent_config.T")
    lines += rows
    lines += [
        "",
        f"**Summary: {tally['BEAT']} beaten, {tally['match']} matched, {tally['MISS']} missed, "
        f"{tally['NO DATA']} without data** out of {sum(tally.values())} "
        "reference table cells.",
    ]
    if misses:
        lines += ["", "## Miss analysis", "",
                  "Each missed median beside the study's own [Q25, Q75] for the cell.", "",
                  *header(MISS_HEADER, "T"), *miss_rows(misses, REF_IQR)]
        # the exact-Hessian iLQR path (ilqr_modern_cells) on the missed iLQR cells
        modern = ResultStore(results_dir, "ilqr_modern")
        modern_rows = []
        for env_name, T, solver, ref_med, agg, _n in misses:
            if solver != "ILQR":
                continue
            m_agg, m_n = our_stats([modern], env_name, solver, T)
            if m_agg is None:
                continue
            verdict = ("beats the reference cell" if m_agg["Median"] < ref_med
                       else "does not beat the reference cell either")
            modern_rows.append(
                f"| {env_name} | {T} | {ref_med:.3g} | {agg['Median']:.3g} "
                f"| {m_agg['Median']:.3g} ({m_n} runs) | {verdict} |")
        if modern_rows:
            lines += ["", "### Both-path ILQR evidence", "",
                      "The replicated numerics' medians beside the exact-Hessian path's",
                      "(`reference_accept=False`, collection ilqr_modern):", "",
                      "| Env | T | ref median | compat median | modern median | verdict |",
                      "|---|---|---|---|---|---|", *modern_rows]

    k_stores = [ResultStore(results_dir, c) for c in K_STORES]
    rows, k_tally, k_misses = verdict_rows(REF_K_MEDIANS, k_stores, "agent_config.K")
    lines += [
        "", "## By sample count K (sampling solvers)", "",
        "The published K-tables pool every horizon (and every CEM elite ratio) per",
        "(env, K, solver) cell; the same aggregation and verdicts as above.", "",
        *header(TABLE_HEADER, "K"), *rows, "",
        f"**K-cells: {k_tally['BEAT']} beaten, {k_tally['match']} matched, "
        f"{k_tally['MISS']} missed** out of "
        f"{k_tally['BEAT'] + k_tally['match'] + k_tally['MISS']} published reference "
        "K-table cells.",
    ]
    if k_misses:
        lines += ["", "### K-cell miss analysis", "",
                  *header(MISS_HEADER, "K"), *miss_rows(k_misses, REF_K_IQR)]

    ext_store = ResultStore(results_dir, EXT_STORE)
    ext_rows = []
    for (env_name, T), ref_row in sorted(REF_MEDIANS.items()):
        best_ref_solver, best_ref = min(ref_row.items(), key=lambda kv: kv[1])
        cells = []
        for _label, agent, keep in EXT_SOLVERS:
            results = [r for r in ext_store.find({"env_name": env_name, "agent_name": agent,
                                                  "agent_config.T": T, **NOISELESS})
                       if keep(r)]
            cells.append(f"{aggregate(results)['Median']:.3g}" if results else "—")
        ext_rows.append(f"| {env_name} | {T} | {best_ref} ({best_ref_solver}) | "
                        + " | ".join(cells) + " |")
    lines += [
        "", "## Extension families (no reference counterpart)", "",
        "QPMPC (goal-linearized, and LTV along the previous plan), SQP and I2C over",
        "the same grid (collection qp_sqp_i2c, 5 repetitions, warm start 50) beside",
        "the best published family's median per cell.", "",
        "| Env | T | best ref median (family) | QPMPC | QPMPC-LTV | SQP | I2C |",
        "|---|---|---|---|---|---|---|",
        *ext_rows,
    ]
    return lines


def main(argv=None):
    p = std_parser(__doc__)
    p.add_argument("--out", default=None,
                   help="where the table goes (default <plots-dir>/QUALITY.md)")
    args = p.parse_args(argv)
    lines = build(args.results_dir)
    out = pathlib.Path(args.out or pathlib.Path(args.plots_dir) / "QUALITY.md")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"\nwrote {out}")
    return out


if __name__ == "__main__":
    main()
