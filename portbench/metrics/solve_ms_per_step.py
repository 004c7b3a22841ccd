"""Device time of the episode runner's solve stage (the ``episode.solve``
span of each ``episode.step``: the solver call and the runner's clip and
shift of the plan), between its timing marks on the card's stream, in ms
per MPC step of the traced stretch."""

from portbench.spans import SOLVE, STEP, device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, SOLVE, STEP)
