"""Device time of every kernel that is not one of the program's hand-written
kernels (``kernels.json``), in ms per MPC step of the traced stretch: the
PyTorch operations of the solver's and the plant's host stages."""

import re

from portbench.trace import hand_written


def read(ctx):
    if ctx.trace is None or not ctx.trace.steps or not ctx.trace.kernels:
        return None
    rx = re.compile("|".join(hand_written().values()))
    s = sum(e - b for name, b, e, _ in ctx.trace.kernels if not rx.search(name))
    return s * 1e-3 / ctx.trace.steps
