"""Host ms a simulation in the descent's host syncs (`mcts.descent.sync`:
the wait for the card to drain its queue, and the copy back), from the
program's recorder over the untraced unit's search."""

from port_bench.recorder import per_sim


def read(ctx):
    return per_sim(lambda rec: rec.ms("mcts.descent.sync"))
