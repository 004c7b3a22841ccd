"""Minimal end-to-end benchmark run: CEM, MPPI, iLQR and SQP on acrobot
(T=50, K=20, 200 steps, warm start 50), collection experiment_test.

Counterpart of ``scripts/experiment_test.py``. Quick mode shrinks
everything to run in seconds.
"""

import pathlib

from ._common import START_STATES, run_grid, std_parser


def grid(args):
    T = 10 if args.quick else 50
    length = 10 if args.quick else 200
    K = 8 if args.quick else 20
    warm = 3 if args.quick else 50
    configs = [
        ("CEM", {"K": K, "T": T, "max_iter": 1, "n_elite": max(2, K // 4),
                 "epsilon": 1e-5, "alpha": 0.2, "std": 1.0}),
        ("MPPI", {"K": K, "T": T, "std": 1.0, "lam": 0.1}),
        ("ILQR", {"T": T, "max_iter": 1 if args.quick else 10,
                  "threshold": 1e-3, "closed_loop": False}),
        ("SQP", {"T": T, "max_iter": 2 if args.quick else 8}),
    ]
    for agent, cfg in configs:
        yield "experiment_test", {
            "env": "acrobot",
            "agent": agent,
            "agent_config": cfg,
            "experiment_length": length,
            "start_state": START_STATES["acrobot"],
            "seed": args.seed,
        }, warm


def main(argv=None):
    args = std_parser(__doc__).parse_args(argv)
    results = run_grid(args, grid(args))
    if not args.no_plots and results:
        from ..experiment import plot_experiments

        out = pathlib.Path(args.plots_dir) / "experiment_test"
        out.mkdir(parents=True, exist_ok=True)
        fig = plot_experiments(results)
        fig.savefig(out / "acrobot_comparison.png", dpi=80)
        print(f"wrote {out}/acrobot_comparison.png")


if __name__ == "__main__":
    main()
