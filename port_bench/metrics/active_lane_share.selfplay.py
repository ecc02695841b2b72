"""Share of the lane-simulations of the untraced unit's search that do
work: a lane inside its playout budget on a root that is not terminal,
over B x the simulations the search runs on every lane (program's
recorder)."""

from port_bench.recorder import untraced_run


def read(ctx):
    rec = untraced_run()
    n = rec.counter("lane_sims") if rec is not None else 0
    return 100.0 * rec.counter("lane_sims_active") / n if n else None
