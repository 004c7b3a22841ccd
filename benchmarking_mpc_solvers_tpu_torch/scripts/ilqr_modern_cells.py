"""Exact-Hessian iLQR on the two cart-pole study cells the replicated
numerics miss (collection ilqr_modern).

Counterpart of ``scripts/ilqr_modern_cells.py``. The study sweep
(``ilqr_tuning``) runs the upstream study's numerics (``diag_hessian=True``
and its line-search acceptance); this sweep runs the same cells with exact
feature-cost Hessians and the terminal-in-objective line search
(``reference_accept=False``), on the card through kernels 5 and 6. Grid:
cart-pole x T in {10, 25} x max_iter in {5, 10, 25} x seeds {0, 1, 2} x 5
repetitions.
"""

from ._common import START_STATES, run_grid, std_parser


def grid(args):
    Ts = [5] if args.quick else [10, 25]
    iters = [2] if args.quick else [5, 10, 25]
    seeds = [0] if args.quick else [0, 1, 2]
    length = 6 if args.quick else 100
    for seed in seeds:
        for T in Ts:
            for mi in iters:
                yield "ilqr_modern", {
                    "env": "cartpole_swingup",
                    "agent": "ILQR",
                    "agent_config": {"T": T, "max_iter": mi,
                                     "threshold": 1e-7,
                                     "closed_loop": False,
                                     "diag_hessian": False,
                                     "reference_accept": False},
                    "experiment_length": length,
                    "start_state": START_STATES["cartpole_swingup"],
                    "repetitions": 1 if args.quick else 5,
                    "seed": seed,
                }, 2 if args.quick else 50


def main(argv=None):
    args = std_parser(__doc__).parse_args(argv)
    run_grid(args, grid(args))


if __name__ == "__main__":
    main()
