"""Kernel 3 (the single-kernel CEM solve): the least time its work takes on
the card (``counts.cem_work`` at the cell's B, K, T, elites and
iterations) over its mean device time in the traced stretch, in %."""

from portbench import counts
from portbench.trace import hand_written


def read(ctx):
    times = ctx.trace.kernel_times(hand_written()["fused_cem"]) if ctx.trace else []
    if not times:
        return None
    a = ctx.config["solver_args"]
    work = counts.cem_work(counts.plant(ctx.config["env"]), ctx.batch, a["K"], a["T"],
                           a["n_elite"], a["max_iter"])
    least, _ = counts.least_time_s(work)
    return 100.0 * least / (sum(times) / len(times))
