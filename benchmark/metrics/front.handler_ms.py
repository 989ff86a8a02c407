"""Milliseconds a /stream request spends in the program's HTTP front before
its first PCM byte: the mean over the requests served after the warm-up and
before the traced slice of its ``front.read`` (read, params and speaker
set-up, the put on the engine's queue) plus ``front.write`` (the first chunk
written) stage spans (``benchmark.programspans``)."""

from benchmark import programspans


def read(ctx):
    s = programspans.load(ctx)
    return s.stage_mean_ms("front.read", "front.write") if s else None
