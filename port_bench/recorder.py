"""The program's span-and-counter recorder (sayuri_tpu_torch/telemetry.py)
as the per-layer readers see it: the run record of a search made with the
profiler off, so that no reading carries the profiler's cost."""


def untraced_run():
    """The newest run record (one `MCTS.run` call) made with the profiler
    off: in a --trace 1 run, the search of the window's one unit, which the
    traced unit follows. None where the program has no recorder or made no
    such record."""
    try:
        from sayuri_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.last(profiled=False)


def per_sim(value_of):
    """`value_of(record)` over the record's simulations, or None."""
    rec = untraced_run()
    return value_of(rec) / rec.sims if rec is not None and rec.sims else None
