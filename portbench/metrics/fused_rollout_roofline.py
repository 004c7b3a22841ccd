"""Kernel 2 (the two-stage tiers' summed-cost rollouts, N = B x K of T
steps a launch): the least time its work takes on the card
(``counts.rollout_work``) over its mean device time in the traced
stretch, in %."""

from portbench import counts
from portbench.trace import hand_written


def read(ctx):
    times = ctx.trace.kernel_times(hand_written()["fused_rollout"]) if ctx.trace else []
    if not times:
        return None
    a = ctx.config["solver_args"]
    least, _ = counts.least_time_s(counts.rollout_work(counts.plant(ctx.config["env"]),
                                                       ctx.batch * a["K"], a["T"]))
    return 100.0 * least / (sum(times) / len(times))
