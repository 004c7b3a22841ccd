"""Kernel 8a (I2C's Kalman filter, ``i2c_filter_*``): the least time its
work takes on the card (``counts.i2c.filter_work`` at the cell's B and T,
D = Z = the plant's features, which are (x, u)) over its mean device time in
the traced stretch, in %."""

from portbench import counts
from portbench.counts import i2c

PATTERN = r"i2c_filter_(kernel|general|wide|large)"


def read(ctx):
    times = ctx.trace.kernel_times(PATTERN) if ctx.trace else []
    if not times:
        return None
    D = counts.plant(ctx.config["env"])["Z"]
    work = i2c.filter_work(ctx.batch, ctx.config["solver_args"]["T"], D, D)
    least, _ = counts.least_time_s(work)
    return 100.0 * least / (sum(times) / len(times))
