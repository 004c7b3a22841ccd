"""MPPI temperature sweep: lambda in {0.001, 0.01, 0.1, 0.5, 1, 10} x T in
{5, 10, 25, 50}, K=100, on the three plants (collection temperature_exp).

Counterpart of ``scripts/mppi_temperature.py``.
"""

import pathlib

from ._common import ENV_NAMES, START_STATES, cost_band, run_grid, std_parser


def grid(args):
    lams = [0.1, 1.0] if args.quick else [0.001, 0.01, 0.1, 0.5, 1.0, 10.0]
    Ts = [5] if args.quick else [5, 10, 25, 50]
    envs = ["pendulum"] if args.quick else list(START_STATES)
    K = 8 if args.quick else 100
    length = 8 if args.quick else 100
    reps = 2 if args.quick else 5
    for env in envs:
        for T in Ts:
            for lam in lams:
                yield "temperature_exp", {
                    "env": env,
                    "agent": "MPPI",
                    "agent_config": {"K": K, "T": T, "std": 1.0, "lam": lam},
                    "experiment_length": length,
                    "start_state": START_STATES[env],
                    "repetitions": reps,
                    "seed": args.seed,
                }, 3 if args.quick else 50


def generate_data(args):
    return run_grid(args, grid(args))


def generate_plots(args):
    from ..experiment import ResultStore, plot_cost_bands

    store = ResultStore(args.results_dir, "temperature_exp")
    out = pathlib.Path(args.plots_dir) / "mppi_temperature"
    out.mkdir(parents=True, exist_ok=True)
    for env_name in ENV_NAMES.values():
        grouped = {}
        metas = store.find({"env_name": env_name}, arrays=False)
        for T in sorted({m["agent_config"]["T"] for m in metas}):
            results = store.find({"env_name": env_name, "agent_config.T": T})
            if results:
                grouped[f"T={T}"] = cost_band(results, lambda r: r["agent_config"]["lam"])
        if grouped:
            fig = plot_cost_bands(grouped, xlabel="temperature λ")
            fig.axes[0].set_xscale("log")
            fig.savefig(out / f"{env_name}_lambda_cost.png", dpi=80)
            print(f"wrote {out}/{env_name}_lambda_cost.png")


def main(argv=None):
    args = std_parser(__doc__).parse_args(argv)
    if not args.no_data:
        generate_data(args)
    if not args.no_plots:
        generate_plots(args)


if __name__ == "__main__":
    main()
