"""Milliseconds the engine's loop blocks per segment on the status readback
(the device finishing the segment): the mean ``engine.status_wait`` span
after the warm-up and before the traced slice (``benchmark.programspans``)."""

from benchmark import programspans


def read(ctx):
    s = programspans.load(ctx)
    return s.mean_ms("engine.status_wait") if s else None
