"""fused.si_ms: the window's wall time over its super-iterations, in ms: the
port's count of a fused pass's super-iterations (``Renderer.stats()``'s
``super_iterations``, a host integer), summed over the window's passes."""


def read(ctx):
    sis = ctx.counters.get("super_iterations", 0)
    return 1e3 * ctx.window_s / sis if sis else None
