"""Device kernels in the traced stretch per MPC step in it: an exact count
of the launches the episode runner, the plant step and the solver make."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.steps or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.steps
