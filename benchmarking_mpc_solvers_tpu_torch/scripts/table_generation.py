"""LaTeX tables: aggregated cost and time per (env, solver, T) and per
(env, solver, K) from every study collection, written as standalone LaTeX
documents under ``<plots-dir>/time_comparison``.

Counterpart of ``scripts/table_generation.py``. Needs pandas, which the
port imports only here.
"""

from ._common import std_parser

COLLECTIONS = ["cem_ratios", "mppi_samples", "temperature_exp", "ilqr_runs2",
               "experiment_test", "qp_sqp_i2c"]


def main(argv=None):
    from ..experiment import ResultStore, generate_tables

    args = std_parser(__doc__).parse_args(argv)
    stores = [ResultStore(args.results_dir, c) for c in COLLECTIONS]
    written = generate_tables(stores, f"{args.plots_dir}/time_comparison")
    for p in written:
        print("wrote", p)
    return written


if __name__ == "__main__":
    main()
