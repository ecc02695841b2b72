"""Device ms of the operations under the program's `mcts.evaluate` range
(encoder, symmetry, forward, post-processing) a simulation."""


def read(ctx):
    us, _ = ctx.trace.stage_us("mcts.evaluate")
    return us / 1e3 / ctx.unit["sims"] if us else None
