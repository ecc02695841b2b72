"""The whole move's share of the bf16 peak: the net's forward operations
for every evaluation the window needed (queries the NN cache neither hit
nor served as an in-batch duplicate) over the window."""


def read(ctx):
    t, p = ctx.totals, ctx.peaks
    evals = t["queries"] - t["hits"] - t["dups"]
    return 100.0 * p.forward_flops(ctx.net) * evals / ctx.window_s / p.BF16_FLOPS
