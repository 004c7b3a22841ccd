"""Scenario-steps completed in the window (B x episode steps x batches)
over the window's seconds on the host clock."""


def read(ctx):
    return ctx.batches * ctx.batch * ctx.steps / ctx.window_s
