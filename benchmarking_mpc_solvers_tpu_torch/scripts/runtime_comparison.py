"""Cost against solve time, a scatter per plant over every study collection
(one point per result, sized by its horizon).

Counterpart of ``scripts/runtime_comparison.py``. Needs matplotlib, which
it imports only when it draws.
"""

import pathlib

import numpy as np

from ._common import ENV_NAMES, std_parser

COLLECTIONS = ["cem_ratios", "mppi_samples", "temperature_exp", "ilqr_runs2",
               "noise_test", "experiment_test", "qp_sqp_i2c"]


def generate_plots(args):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..experiment import ResultStore

    stores = [ResultStore(args.results_dir, c) for c in COLLECTIONS]
    out = pathlib.Path(args.plots_dir) / "runtime_comparison"
    out.mkdir(parents=True, exist_ok=True)
    for env_name in ENV_NAMES.values():
        fig, ax = plt.subplots(figsize=(8, 6))
        seen = False
        for store in stores:
            for r in store.find({"env_name": env_name}):
                cost = float(np.clip(np.asarray(r["env_costs"]), -20, 20).sum())
                t = float(r["passed_time"])
                T = r["agent_config"].get("T", 0)
                ax.scatter(t, cost, s=18 + 2 * T, alpha=0.6,
                           label=f"{r['agent_name']} T={T}")
                seen = True
        if not seen:
            plt.close(fig)
            continue
        handles, labels = ax.get_legend_handles_labels()
        uniq = dict(zip(labels, handles))  # one legend entry a label
        ax.legend(uniq.values(), uniq.keys(), fontsize=7)
        ax.set_xlabel("episode solve time (s)")
        ax.set_ylabel("total clipped cost")
        ax.set_xscale("log")
        ax.set_title(env_name)
        fig.tight_layout()
        fig.savefig(out / f"{env_name}_cost_vs_time.png", dpi=80)
        plt.close(fig)
        print(f"wrote {out}/{env_name}_cost_vs_time.png")


def main(argv=None):
    generate_plots(std_parser(__doc__).parse_args(argv))


if __name__ == "__main__":
    main()
