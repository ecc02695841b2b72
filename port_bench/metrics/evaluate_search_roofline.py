"""Share of the evaluate stage's device time that the net's own work
needs at the peak: the larger of its operations over the bf16 peak and its
bytes (weights, each layer's input and output once) over the HBM peak, for
the B rows a simulation evaluates, over the device time under
`mcts.evaluate`."""


def read(ctx):
    us, _ = ctx.trace.stage_us("mcts.evaluate")
    if not us:
        return None
    p, rows = ctx.peaks, ctx.h.wl["batch"]
    bound_s = max(p.forward_flops(ctx.net) * rows / p.BF16_FLOPS,
                  p.forward_bytes(ctx.net, rows) / p.HBM_BYTES_PER_S) * ctx.unit["sims"]
    return 100.0 * bound_s / (us / 1e6)
