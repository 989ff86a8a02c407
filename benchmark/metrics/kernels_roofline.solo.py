"""Share of their roofline that K1 and K3 reach in the traced slice: Σ of
their launches' least times (``benchmark.roofline``, from the step's shapes
at the cell's rows; launches beyond the steps' own are prefills' heads at 2
rows) over Σ of their device time, in %."""

from benchmark import roofline


def read(ctx):
    steps = ctx.steps()
    device_s, launches = ctx.kernel_time_s()
    if not steps or not device_s:
        return None
    calls = roofline.step_calls(ctx.cfg, ctx.rows)
    per_step = sum(2 if kind == "k3" else 1 for kind, _ in calls)
    extra = max(launches - steps * per_step, 0.0)
    least = steps * roofline.kernels_least_s(ctx.cfg, ctx.rows) + extra * roofline.heads_least_s(ctx.cfg, 2)
    return 100.0 * least / device_s
