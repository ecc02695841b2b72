"""Host syncs of the search's descent (one a tree level it walks) a
simulation, from the program's recorder over the untraced unit's search."""

from port_bench.recorder import per_sim


def read(ctx):
    return per_sim(lambda rec: rec.counter("descent_syncs"))
