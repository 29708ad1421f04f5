"""k1.roofline_pct: K1's share of its roofline over the launches of the
first traced pass's first closest-hit traversal (every primary ray from the
root, eight arrivals a launch until the last ray ends): the least time of
each launch (``yardstick/roofline.py``: its bytes and operations, counted by
the frozen plain arrivals, against the H100's peaks) summed, over the same
launches' device time from the profiler."""

from pt_bench.trace import K1_NAME


def read(ctx):
    tr, bounds = ctx.trace, ctx.k1_bounds
    if tr is None or not bounds or not tr.passes:
        return None
    k1 = [x for x in tr.kernels_in(0) if K1_NAME in x[0]][:len(bounds)]
    if len(k1) < len(bounds):
        return None
    device_us = sum(e - s for _n, s, e in k1)
    return 100.0 * sum(b for b, _what in bounds) * 1e3 / device_us
