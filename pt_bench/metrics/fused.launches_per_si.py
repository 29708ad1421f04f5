"""fused.launches_per_si: device kernels in the traced passes (profiler;
copies and sets apart, as ``experiments/k2_span.py::launches_per_si`` counts
them) over the traced passes' super-iterations (the port's count)."""


def read(ctx):
    tr, sis = ctx.trace, ctx.traced_counters.get("super_iterations", 0)
    if tr is None or not tr.kernels or not sis:
        return None
    return len(tr.kernels) / sis
