"""Milliseconds from a request's join to its first PCM planned onto the
engine's ship queue: the mean ``engine.first_audio`` stage span over the
requests served after the warm-up and before the traced slice
(``benchmark.programspans``)."""

from benchmark import programspans


def read(ctx):
    s = programspans.load(ctx)
    return s.stage_mean_ms("engine.first_audio") if s else None
