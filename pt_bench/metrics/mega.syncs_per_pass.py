"""mega.syncs_per_pass: the host's blocking reads a traced pass, counted as
the program's ``uwpt.sync.*`` spans (the traversal loops' tests, the
bounces' alive tests, the queue tests of the other integrators)."""

from pt_bench import spans


def read(ctx):
    return spans.per_pass(ctx.trace, lambda lo, hi, sp: len(spans.syncs(sp)))
