"""Milliseconds a prepped /stream request waits to join the engine's batch
(its ``join`` at a segment boundary): the mean ``engine.join_wait`` stage span
over the requests served after the warm-up and before the traced slice
(``benchmark.programspans``)."""

from benchmark import programspans


def read(ctx):
    s = programspans.load(ctx)
    return s.stage_mean_ms("engine.join_wait") if s else None
