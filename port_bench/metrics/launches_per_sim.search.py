"""CUDA kernel launches of the traced search over its simulations."""


def read(ctx):
    return ctx.trace.launches / ctx.unit["sims"]
