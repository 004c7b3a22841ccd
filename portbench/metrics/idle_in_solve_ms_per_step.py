"""The traced stretch's device idle time while the host was in the solve
stage (an ``episode.solve`` span: the solver call and its stages), in ms
per MPC step; each idle gap is split by intersection with the program's
spans in the trace (``portbench.spans.idle_split``)."""

from portbench.spans import idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, "solve")
