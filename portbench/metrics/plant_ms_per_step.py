"""Device time of the episode runner's plant stage (the ``episode.plant``
span of each ``episode.step``: the action's clip, the plant step and the
step's record), between its timing marks on the card's stream, in ms per
MPC step of the traced stretch."""

from portbench.spans import PLANT, STEP, device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, PLANT, STEP)
