"""Share of the traced slice's device-idle time (no kernel running) that lies
inside a ``decode.step`` span of the single-request path, in %: the idle the
step's host work leaves (``benchmark.programspans``)."""

from benchmark import programspans


def read(ctx):
    s = programspans.load(ctx)
    return s.idle_in_step_pct(programspans.kernel_intervals(ctx), engine=False) if s else None
