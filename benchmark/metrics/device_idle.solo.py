"""Share of the traced slice in which no kernel runs on the device (the
union of the kernels' intervals), in %."""


def read(ctx):
    if not ctx.kernels or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s() / ctx.window_s)
