"""Sweep of the three solver families the upstream study never had: QPMPC
(condensed linear MPC, goal-linearized and along the plan), SQP
(Gauss-Newton NMPC) and I2C (input inference), over the study's grid (the
three plants x T in {5, 10, 25, 50}, 5 repetitions, 100 steps, warm start
50, noiseless), collection qp_sqp_i2c.

Counterpart of ``scripts/new_solver_sweep.py``. On the card SQP runs
kernels 4, 5 and 6 and I2C kernels 8a and 8b each iteration; QPMPC runs the
plain batched tier, as the reference's vmapped solve reaches no kernel.
"""

from ._common import START_STATES, run_grid, std_parser

# init_std=1: the swing-up tasks start at symmetric equilibria where a zero
# initial plan has zero gradient and a local planner never leaves; the
# goal-linearized QPMPC solves a convex problem and needs no init, the LTV
# variant (linearize_at="plan") is a local planner and takes the same
# break. I2C is tuned per environment: pendulum and acrobot with the
# corrected control prior and the rollout-cost line search, cart-pole with
# the lagged prior and no line search.
SOLVER_CONFIGS = {
    "QPMPC": ("QPMPC", lambda env, T: {"T": T, "max_iter": 50}),
    "QPMPC_LTV": ("QPMPC", lambda env, T: {
        "T": T, "max_iter": 50, "linearize_at": "plan", "init_std": 1.0}),
    "SQP": ("SQP", lambda env, T: {"T": T, "max_iter": 6, "init_std": 1.0}),
    "I2C": ("I2C", lambda env, T: (
        {"T": T, "max_iter": 10, "init_std": 1.0,
         "prior_lag": True, "line_search": False}
        if env == "cartpole_swingup"
        else {"T": T, "max_iter": 10, "init_std": 1.0,
              "line_search": True})),
}


def grid(args):
    Ts = [5] if args.quick else [5, 10, 25, 50]
    envs = ["pendulum"] if args.quick else list(START_STATES)
    length = 6 if args.quick else 100
    for env in envs:
        for T in Ts:
            for agent, make_cfg in SOLVER_CONFIGS.values():
                yield "qp_sqp_i2c", {
                    "env": env,
                    "agent": agent,
                    "agent_config": make_cfg(env, T),
                    "experiment_length": length,
                    "start_state": START_STATES[env],
                    "repetitions": 1 if args.quick else 5,
                    "seed": args.seed,
                }, 2 if args.quick else 50


def main(argv=None):
    args = std_parser(__doc__).parse_args(argv)
    run_grid(args, grid(args))


if __name__ == "__main__":
    main()
