"""Host milliseconds per decode step of the continuous engine, without the
profiler: the mean ``decode.step`` span on the engine's thread after the
warm-up and before the traced slice (``benchmark.programspans``)."""

from benchmark import programspans


def read(ctx):
    s = programspans.load(ctx)
    return s.mean_ms("decode.step", engine=True) if s else None
