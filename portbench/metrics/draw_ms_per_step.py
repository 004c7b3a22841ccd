"""Device time of the batched MPPI solve's noise draw (the ``mppi.draw``
span of each ``episode.solve``: ``scenario_normals`` and the reshaping into
the time-major perturbations), between its timing marks on the card's
stream, in ms per MPC step of the traced stretch."""

from portbench.spans import SOLVE, device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "mppi.draw", SOLVE)
