"""mega.shade_host_ms_per_pass: self time a traced pass of the program's
``uwpt.mega.shade`` spans, less the shadow traversals nested in them: the
host dispatching the megakernel's plain-PyTorch shading."""

from pt_bench import spans


def read(ctx):
    return spans.per_pass(ctx.trace, lambda lo, hi, sp: spans.self_ms(sp, {"uwpt.mega.shade"}))
