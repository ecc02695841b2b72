"""Share of the window's NN evaluation queries that the cache served:
hits plus in-batch duplicates, from the cache's own counters."""


def read(ctx):
    t = ctx.totals
    return 100.0 * (t["hits"] + t["dups"]) / t["queries"] if t["queries"] else None
