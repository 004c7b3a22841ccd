"""Device time of the batched I2C solve's ``i2c.linearize`` spans in each
``episode.solve`` (one a smoothing iteration: the nominal rollout, the
linearisation, the smoother's inputs, R and the prior covariances), between
their timing marks on the card's stream, in ms per MPC step of the traced
stretch."""

from portbench.spans import SOLVE, device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "i2c.linearize", SOLVE)
