"""iLQR iteration sweep: max_iter in {5, 10, 25} x T in {5, 10, 25, 50} on
the three plants (collection ilqr_runs2).

Counterpart of ``scripts/ilqr_tuning.py``. On the card each solve's line
search is kernel 6; ``diag_hessian`` keeps the backward pass plain, as the
reference routes it.
"""

import pathlib

from ._common import ENV_NAMES, START_STATES, cost_band, run_grid, std_parser


def grid(args):
    iters = [2] if args.quick else [5, 10, 25]
    Ts = [5] if args.quick else [5, 10, 25, 50]
    envs = ["pendulum"] if args.quick else list(START_STATES)
    length = 6 if args.quick else 100
    for env in envs:
        for T in Ts:
            for mi in iters:
                yield "ilqr_runs2", {
                    "env": env,
                    "agent": "ILQR",
                    # threshold=1e-7 as the upstream study's sweep.
                    # diag_hessian=True: the sweep replicates the upstream
                    # study's iLQR numerics (a diagonal cost Hessian and the
                    # terminal cost at x_{T-1}); the exact-Hessian path is
                    # swept by ilqr_modern_cells
                    "agent_config": {"T": T, "max_iter": mi,
                                     "threshold": 1e-7, "closed_loop": False,
                                     "diag_hessian": True},
                    "experiment_length": length,
                    "start_state": START_STATES[env],
                    "repetitions": 1 if args.quick else 5,
                    "seed": args.seed,
                }, 2 if args.quick else 50


def generate_data(args):
    return run_grid(args, grid(args))


def generate_plots(args):
    from ..experiment import ResultStore, plot_cost_bands

    store = ResultStore(args.results_dir, "ilqr_runs2")
    out = pathlib.Path(args.plots_dir) / "ilqr_iterations"
    out.mkdir(parents=True, exist_ok=True)
    for env_name in ENV_NAMES.values():
        results = store.find({"env_name": env_name})
        if not results:
            continue
        grouped = {}
        for T in sorted({r["agent_config"]["T"] for r in results}):
            sub = [r for r in results if r["agent_config"]["T"] == T]
            grouped[f"T={T}"] = cost_band(sub, lambda r: r["agent_config"]["max_iter"])
        fig = plot_cost_bands(grouped, xlabel="iLQR max_iter")
        fig.savefig(out / f"{env_name}_iters_cost.png", dpi=80)
        print(f"wrote {out}/{env_name}_iters_cost.png")


def main(argv=None):
    args = std_parser(__doc__).parse_args(argv)
    if not args.no_data:
        generate_data(args)
    if not args.no_plots:
        generate_plots(args)


if __name__ == "__main__":
    main()
