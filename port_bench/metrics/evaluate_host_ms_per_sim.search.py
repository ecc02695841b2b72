"""Host ms a simulation in the search's evaluate stage (`mcts.evaluate`),
which makes no host sync, so it is the stage's dispatch; from the
program's recorder over the untraced unit's search."""

from port_bench.recorder import per_sim


def read(ctx):
    return per_sim(lambda rec: rec.ms("mcts.evaluate"))
