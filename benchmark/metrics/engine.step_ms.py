"""Wall milliseconds per step of the continuous engine in the traced slice:
the slice's length over the decode steps that started in it (the wrapper's
host marks, one per call of the backbone's one-frame forward)."""


def read(ctx):
    steps = ctx.steps()
    return 1e3 * ctx.window_s / steps if steps else None
