"""Share of the traced unit's wall time in which no operation ran on the
card (port_bench/trace.py `Trace.idle_share`)."""


def read(ctx):
    return ctx.trace.idle_share()
