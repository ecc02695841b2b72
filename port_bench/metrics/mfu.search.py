"""The whole search's share of the bf16 peak: the net's forward operations
for every row the window evaluated (B a simulation and B roots a search)
over the window."""


def read(ctx):
    p = ctx.peaks
    return 100.0 * p.forward_flops(ctx.net) * ctx.totals["evals"] / ctx.window_s / p.BF16_FLOPS
