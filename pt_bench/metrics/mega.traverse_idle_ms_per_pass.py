"""mega.traverse_idle_ms_per_pass: device-idle milliseconds a traced pass
while the host's innermost ``uwpt.*`` span is ``uwpt.mega.closest`` or
``uwpt.mega.shadow``: the card waiting on the traversals' issue, outside
their loop tests."""

from pt_bench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, {"uwpt.mega.closest", "uwpt.mega.shadow"})
