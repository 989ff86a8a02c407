"""The whole decode step's share of one H100: its least time
(``roofline.step_least_s`` at the cell's rows: int8 weights and scales read
once against the matmul operations at the bf16 peak) over the traced
slice's wall time per step, in %."""

from benchmark import roofline


def read(ctx):
    steps = ctx.steps()
    if not steps:
        return None
    return 100.0 * roofline.step_least_s(ctx.cfg, ctx.rows) / (ctx.window_s / steps)
