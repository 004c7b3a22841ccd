"""The traced stretch's device idle time while the host was in the plant
stage (an ``episode.plant`` span: the action's clip, the plant step and
the step's record), in ms per MPC step; each idle gap is split by
intersection with the program's spans in the trace
(``portbench.spans.idle_split``)."""

from portbench.spans import idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, "plant")
