"""The traced stretch's device idle time while the host was in the episode
runner between its stages (inside an ``episode.batch``, ``episode.step``
or ``episode.warmstart`` span, outside the solve and plant spans), in ms
per MPC step; each idle gap is split by intersection with the program's
spans in the trace (``portbench.spans.idle_split``)."""

from portbench.spans import idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, "runner")
