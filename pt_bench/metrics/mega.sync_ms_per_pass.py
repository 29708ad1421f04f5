"""mega.sync_ms_per_pass: host milliseconds a traced pass inside the
program's ``uwpt.sync.*`` spans: the host blocked on the card's answer to a
loop test."""

from pt_bench import spans


def read(ctx):
    return spans.per_pass(ctx.trace,
                          lambda lo, hi, sp: 1e-3 * sum(e - s for _n, s, e in spans.syncs(sp)))
