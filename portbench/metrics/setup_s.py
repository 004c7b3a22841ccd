"""The run's set-up on the host clock: imports, the card, the kernels'
libraries (built only where the checkout has none), two warm-up batches."""


def read(ctx):
    return ctx.setup_s
