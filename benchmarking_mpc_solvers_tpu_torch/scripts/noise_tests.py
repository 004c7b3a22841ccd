"""Noise-robustness sweeps: actuation noise sigma in {0.1, 0.5, 1} and
sensor noise with planning-model noise for each solver x env, plus the
noiseless baselines, summarized as noise-vs-cost curves (collection
noise_test).

Counterpart of ``scripts/noise_tests.py``.
"""

import pathlib

from ._common import ENV_NAMES, START_STATES, cost_band, run_grid, std_parser

SOLVER_CONFIGS = {
    # CEM max_iter and the iLQR threshold as the upstream study's noise sweep
    "CEM": {"K": 50, "T": 25, "max_iter": 10, "n_elite": 12, "epsilon": 1e-5,
            "alpha": 0.2, "std": 1.0},
    "MPPI": {"K": 100, "T": 25, "std": 1.0, "lam": 0.1},
    "ILQR": {"T": 25, "max_iter": 5, "threshold": 1e-7, "closed_loop": False},
    # beyond the upstream study: I2C joins the robustness study
    "I2C": {"T": 25, "max_iter": 5},
}

QUICK_CONFIGS = {
    "MPPI": {"K": 8, "T": 5, "std": 1.0, "lam": 0.1},
    # iLQR in quick mode takes the planning-model-noise path of the
    # derivative solvers
    "ILQR": {"T": 5, "max_iter": 3, "threshold": 1e-3, "closed_loop": False},
}


def grid(args):
    sigmas = [0.0, 0.5] if args.quick else [0.0, 0.1, 0.5, 1.0]
    envs = ["pendulum"] if args.quick else list(START_STATES)
    configs = QUICK_CONFIGS if args.quick else SOLVER_CONFIGS
    length = 6 if args.quick else 100
    reps = 2 if args.quick else 5
    for env in envs:
        for agent, cfg in configs.items():
            for sigma in sigmas:
                for mode in ("actuation", "sensor"):
                    if sigma == 0.0 and mode == "sensor":
                        continue  # noiseless baseline recorded once
                    params = {
                        "env": env,
                        "agent": agent,
                        "agent_config": cfg,
                        "experiment_length": length,
                        "start_state": START_STATES[env],
                        "repetitions": reps,
                        "seed": args.seed,
                        "noise_mode": mode if sigma > 0 else "none",
                    }
                    if mode == "actuation":
                        params["actuation_noise"] = sigma
                    else:
                        params["sensor_noise"] = sigma
                        params["model_noise"] = True
                    yield "noise_test", params, 2 if args.quick else 50


def generate_data(args):
    return run_grid(args, grid(args))


def generate_plots(args):
    from ..experiment import ResultStore, plot_cost_bands

    store = ResultStore(args.results_dir, "noise_test")
    out = pathlib.Path(args.plots_dir) / "noise_test"
    out.mkdir(parents=True, exist_ok=True)
    for env_name in ENV_NAMES.values():
        results = store.find({"env_name": env_name})
        if not results:
            continue
        for mode, std_key in (("actuation", "actuation_noise_std"),
                              ("sensor", "sensor_noise_std")):
            grouped = {}
            for agent in sorted({r["agent_name"] for r in results}):
                sub = [
                    r for r in results
                    if r["agent_name"] == agent
                    and (r.get(std_key) or not (r["actuation_noise"] or r["sensor_noise"]))
                ]
                if sub:
                    grouped[agent] = cost_band(
                        sub, lambda r, k=std_key: float(r.get(k, 0.0) or 0.0))
            if grouped:
                fig = plot_cost_bands(grouped, xlabel=f"{mode} noise σ")
                fig.savefig(out / f"{env_name}_{mode}_cost.png", dpi=80)
                print(f"wrote {out}/{env_name}_{mode}_cost.png")


def main(argv=None):
    args = std_parser(__doc__).parse_args(argv)
    if not args.no_data:
        generate_data(args)
    if not args.no_plots:
        generate_plots(args)


if __name__ == "__main__":
    main()
