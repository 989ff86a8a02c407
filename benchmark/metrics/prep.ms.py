"""Milliseconds from a /stream request's put on the engine's queue to its put
on the prepped queue (the queue wait, G2P and the conditioner forward): the
mean ``prep`` stage span over the requests served after the warm-up and
before the traced slice (``benchmark.programspans``)."""

from benchmark import programspans


def read(ctx):
    s = programspans.load(ctx)
    return s.stage_mean_ms("prep") if s else None
