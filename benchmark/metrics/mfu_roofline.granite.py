"""The whole decode step's share of one H100 in the Granite cell: its least
time (``roofline_ssm.step_least_s`` at the cell's rows: int8 weights and
scales, and every Mamba-2 layer's SSD and conv states read and written once
in bf16, against the matmul operations at the bf16 peak) over the traced
slice's wall time per step, in %. None where the configuration has no
Mamba-2 layers: ``mfu_roofline.engine`` is that step's share."""

from benchmark import roofline_ssm


def read(ctx):
    steps = ctx.steps()
    if not steps or not ctx.cfg.get("backbone", {}).get("ssm_cfg"):
        return None
    return 100.0 * roofline_ssm.step_least_s(ctx.cfg, ctx.rows) / (ctx.window_s / steps)
