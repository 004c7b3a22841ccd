"""Manual solver comparison: several solvers (MPPI at two temperatures,
CEM, iLQR) on one environment, with per-solver trajectory figures, CSV logs
and, with ``--render``, GIF animations of the closed loop.

Counterpart of ``scripts/test.py``, with its configurations and artifacts,
written under ``--out`` (default ``experiments/<timestamp>/``, git-ignored):
``<solver>_trajectory.png``, ``<solver>_log.csv`` (the states, the action,
the cost and the solve time per step), ``<solver>.gif`` and
``comparison.png``. The episodes run on ``--device`` (default ``cuda``);
matplotlib is imported when the first figure is drawn.

    python -m benchmarking_mpc_solvers_tpu_torch.scripts.test --quick --device cpu
"""

import csv
import datetime
import pathlib

import numpy as np

from ..envs import render_episode
from ..experiment import Experiment
from ._common import START_STATES, std_parser


def configs(T: int, K: int, quick: bool) -> list:
    """(agent, agent_config, label) of each solver compared."""
    return [
        ("MPPI", {"K": K, "T": T, "std": 1.0, "lam": 0.1}, "MPPI lam=0.1"),
        ("MPPI", {"K": K, "T": T, "std": 1.0, "lam": 1.0}, "MPPI lam=1.0"),
        ("CEM", {"K": K, "T": T, "max_iter": 1, "n_elite": max(2, K // 4),
                 "epsilon": 1e-5, "alpha": 0.2, "std": 1.0}, "CEM"),
        ("ILQR", {"T": T, "max_iter": 2 if quick else 10,
                  "threshold": 1e-3, "closed_loop": False}, "ILQR"),
    ]


def main(argv=None) -> pathlib.Path:
    p = std_parser(__doc__)
    p.add_argument("--env", default="pendulum", choices=list(START_STATES))
    p.add_argument("--render", action="store_true", help="write GIF animations")
    p.add_argument("--out", default=None,
                   help="artifact directory (default experiments/<timestamp>)")
    args = p.parse_args(argv)
    from ..experiment import plot_experiment, plot_experiments  # matplotlib

    T = 8 if args.quick else 25
    K = 8 if args.quick else 100
    length = 8 if args.quick else 100
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    out = pathlib.Path(args.out or pathlib.Path("experiments") / stamp)
    out.mkdir(parents=True, exist_ok=True)

    results = []
    for agent, cfg, label in configs(T, K, args.quick):
        exp = Experiment({
            "env": args.env,
            "agent": agent,
            "agent_config": cfg,
            "experiment_length": length,
            "start_state": START_STATES[args.env],
            "seed": args.seed,
        }, device=args.device)
        res = exp(warmstart=2 if args.quick else 50)
        res = {**res, "agent_name": label}
        results.append(res)
        total = float(np.sum(res["env_costs"]))
        print(f"{label}: total cost {total:.1f}, solve time {res['passed_time']}s")

        # per-solver figure and CSV log
        safe = label.replace(" ", "_").replace("=", "")
        fig = plot_experiment(res, plot_planning=not args.quick)
        fig.savefig(out / f"{safe}_trajectory.png", dpi=80)
        with open(out / f"{safe}_log.csv", "w", newline="") as f:
            writer = csv.writer(f)
            S = res["env_states"].shape[1]
            writer.writerow([f"x{i}" for i in range(S)] + ["u0", "cost", "solve_time"])
            for i in range(length):
                writer.writerow(list(res["env_states"][i])
                                + [res["env_actions"][i][0], res["env_costs"][i],
                                   res["computation_time"][i]])
        if args.render:
            render_episode(args.env, res["env_states"], res["env_actions"],
                           path=str(out / f"{safe}.gif"))

    fig = plot_experiments(results)
    fig.savefig(out / "comparison.png", dpi=80)
    print(f"artifacts in {out}")
    return out


if __name__ == "__main__":
    main()
