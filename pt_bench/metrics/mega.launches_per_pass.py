"""mega.launches_per_pass: device kernels a traced pass (profiler), K1's
and the plain-PyTorch shading's; the run prints the traversals' host reads
of their loop test a pass beside it."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels or not ctx.n_traced:
        return None
    return len(tr.kernels) / ctx.n_traced
