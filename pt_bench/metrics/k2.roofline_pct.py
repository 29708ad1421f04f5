"""k2.roofline_pct: kernel K2's share of its roofline in a fused pass: the
least time of each K2 launch of the checked pass (``yardstick/
transition_work.py``: its bytes and operations, counted from the lanes it
processed, the state it left and the lanes that ended, against the H100's
peaks) summed, over K2's device time a traced pass (``trace.fused_roofline``)."""

from pt_bench.trace import fused_roofline

K2_NAME = "transition16"


def read(ctx):
    return fused_roofline(ctx, K2_NAME, ctx.checked.k2_ms if ctx.checked else None)
