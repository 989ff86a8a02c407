"""Device kernels launched per decode step in the traced slice: the
profiler's kernels over the decode steps that started in it (the wrapper's
host marks)."""


def read(ctx):
    steps, launches = ctx.steps(), len(list(ctx.clipped()))
    return launches / steps if steps and launches else None
