"""CUDA kernel launches of the traced move (every game's search, its
root work and the step)."""


def read(ctx):
    return ctx.trace.launches / ctx.unit["moves"]
