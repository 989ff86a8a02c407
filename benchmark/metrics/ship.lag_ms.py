"""Milliseconds from a request's first PCM planned to its chunk handed to the
HTTP handler by the engine's shipper (the PCM readback among them): the mean
``ship`` stage span over the requests served after the warm-up and before the
traced slice (``benchmark.programspans``)."""

from benchmark import programspans


def read(ctx):
    s = programspans.load(ctx)
    return s.stage_mean_ms("ship") if s else None
