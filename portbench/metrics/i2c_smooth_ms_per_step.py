"""Device time of the batched I2C solve's ``i2c.smooth`` spans in each
``episode.solve`` (one a smoothing iteration: kernels 8a and 8b, the
smoothed control means, their failure guard and clip), between their
timing marks on the card's stream, in ms per MPC step of the traced
stretch."""

from portbench.spans import SOLVE, device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "i2c.smooth", SOLVE)
