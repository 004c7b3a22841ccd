"""CEM elite-ratio and MPPI sample-count sweeps (collections cem_ratios and
mppi_samples), each configuration's repetitions one batch on the card.

Counterpart of ``scripts/sample_test.py``. Full sweep: CEM ratio in
{.1, .25, .5, .75, 1} x K in {50, 10, 20, 100, 200}; MPPI K in
{10, 20, 50, 100, 200, 500} x lambda in {0.1, 0.5}; each over T in
{5, 10, 25, 50} on pendulum, cart-pole and acrobot; 100 steps, 5
repetitions, warm start 50.
"""

import pathlib

from ._common import ENV_NAMES, START_STATES, cost_band, run_grid, std_parser


def grid(args):
    # the upstream study's acrobot line is commented out, yet its published
    # T-table has acrobot CEM rows: acrobot is swept too, so that the study
    # table is fully populated
    envs = ["pendulum"] if args.quick else ["pendulum", "cartpole_swingup", "acrobot"]
    ratios = [0.25, 0.5] if args.quick else [0.1, 0.25, 0.5, 0.75, 1.0]
    Ks = [8, 16] if args.quick else [10, 20, 50, 100, 200, 500]
    # CEM sweeps MPPI's K grid without K=500 (the upstream study's CEM half
    # never runs it); K=50 comes first, as the JAX package's sweep ran it
    Ks_cem = [8] if args.quick else [50, 10, 20, 100, 200]
    Ts = [5] if args.quick else [5, 10, 25, 50]
    length = 10 if args.quick else 100
    reps = 2 if args.quick else 5
    warm = 3 if args.quick else 50

    for env in envs:
        start = START_STATES[env]
        for T in Ts:
            for K_cem in Ks_cem:
                for ratio in ratios:
                    yield "cem_ratios", {
                        "env": env,
                        "agent": "CEM",
                        # max_iter=10: the upstream study's published CEM
                        # medians come from 10-iteration solves
                        "agent_config": {"K": K_cem, "T": T,
                                         "max_iter": 1 if args.quick else 10,
                                         "n_elite": max(1, int(K_cem * ratio)),
                                         "elite_ratio": ratio,
                                         "epsilon": 1e-5, "alpha": 0.2, "std": 1.0},
                        "experiment_length": length,
                        "start_state": start,
                        "repetitions": reps,
                        "seed": args.seed,
                    }, warm
            for K in Ks:
                # lam=0.5 is the upstream study's temperature here, 0.1 the
                # runtime comparison's; both pool into the published K cells
                for lam in ([0.1] if args.quick else [0.1, 0.5]):
                    yield "mppi_samples", {
                        "env": env,
                        "agent": "MPPI",
                        "agent_config": {"K": K, "T": T, "std": 1.0, "lam": lam},
                        "experiment_length": length,
                        "start_state": start,
                        "repetitions": reps,
                        "seed": args.seed,
                    }, warm


def generate_data(args):
    return run_grid(args, grid(args))


def generate_plots(args):
    from ..experiment import ResultStore, plot_cost_bands

    for collection, folder, key, xlabel, suffix in (
            ("mppi_samples", "mppi_samples", "K", "samples K", "K_cost"),
            ("cem_ratios", "cem_ratio", "elite_ratio", "elite ratio", "ratio_cost")):
        store = ResultStore(args.results_dir, collection)
        out = pathlib.Path(args.plots_dir) / folder
        out.mkdir(parents=True, exist_ok=True)
        for env_name in ENV_NAMES.values():
            grouped = {}
            metas = store.find({"env_name": env_name}, arrays=False)
            for T in sorted({m["agent_config"]["T"] for m in metas}):
                results = store.find({"env_name": env_name, "agent_config.T": T})
                if results:
                    grouped[f"T={T}"] = cost_band(results,
                                                  lambda r, k=key: r["agent_config"][k])
            if grouped:
                fig = plot_cost_bands(grouped, xlabel=xlabel)
                fig.savefig(out / f"{env_name}_{suffix}.png", dpi=80)
                print(f"wrote {out}/{env_name}_{suffix}.png")


def main(argv=None):
    args = std_parser(__doc__).parse_args(argv)
    if not args.no_data:
        generate_data(args)
    if not args.no_plots:
        generate_plots(args)


if __name__ == "__main__":
    main()
