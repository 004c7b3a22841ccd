"""The share of the traced stretch's wall time in which no operation ran on
the device: 100 x (1 - union of device intervals / stretch)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
