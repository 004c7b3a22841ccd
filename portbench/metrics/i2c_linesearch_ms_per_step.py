"""Device time of the batched I2C solve's ``i2c.linesearch`` spans in each
``episode.solve`` (one a smoothing iteration: the three candidate plans,
their rollout on the true cost and the choice), between their timing marks
on the card's stream, in ms per MPC step of the traced stretch."""

from portbench.spans import SOLVE, device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "i2c.linesearch", SOLVE)
