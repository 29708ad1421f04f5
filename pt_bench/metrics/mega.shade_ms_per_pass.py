"""mega.shade_ms_per_pass: device milliseconds a traced pass of every
kernel other than K1: the megakernel's plain-PyTorch shading, camera rays
and film."""

from pt_bench.trace import K1_NAME


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels or not ctx.n_traced:
        return None
    us = sum(e - s for n, s, e in tr.kernels if K1_NAME not in n)
    return us * 1e-3 / ctx.n_traced
