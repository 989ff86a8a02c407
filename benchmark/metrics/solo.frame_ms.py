"""Wall milliseconds per decoded frame of the single-request path in the
traced slice: the slice's length over the decode steps that started in it
(the wrapper's host marks; one step decodes one frame)."""


def read(ctx):
    steps = ctx.steps()
    return 1e3 * ctx.window_s / steps if steps else None
