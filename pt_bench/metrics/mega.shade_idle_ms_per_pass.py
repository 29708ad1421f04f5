"""mega.shade_idle_ms_per_pass: device-idle milliseconds a traced pass
while the host's innermost ``uwpt.*`` span is ``uwpt.mega.shade``: the card
waiting on the shading's dispatch."""

from pt_bench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, {"uwpt.mega.shade"})
