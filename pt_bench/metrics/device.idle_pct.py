"""device.idle_pct: the share of the traced passes' host span in which no
kernel, copy or set ran on the card: one minus the union of the device
intervals the profiler saw, over the span."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not (tr.kernels or tr.copies) or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
