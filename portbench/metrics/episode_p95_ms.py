"""The 95th percentile, over every batch of the window, of one batch's wall
time from its launch to its summed costs on the host."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.batch_times, 95)) * 1e3 if ctx.batch_times else None
