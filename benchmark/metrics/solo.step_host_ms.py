"""Host milliseconds per decode step of the single-request path, without the
profiler: the mean ``decode.step`` span (its early-exit read, ``decode.sync``,
inside) off the engine's thread after the warm-up and before the traced
slice (``benchmark.programspans``)."""

from benchmark import programspans


def read(ctx):
    s = programspans.load(ctx)
    return s.mean_ms("decode.step", engine=False) if s else None
