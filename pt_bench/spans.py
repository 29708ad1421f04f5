"""The program's own spans in a traced run: the ranges the port opens at
its layer boundaries while the profiler records (``uwpt.*``), read by name
from the host events of :class:`pt_bench.trace.Trace`, on the clock of the
device's kernels and copies.  Nothing of the port is imported.

A span's self time is its duration less the part its child spans cover;
its children are the ``uwpt.*`` spans nested directly inside it.  The
device is idle, inside a traced pass, where no kernel or copy runs; each
idle microsecond goes to the span whose self time covers it (the innermost
``uwpt.*`` span the host was in), by interval overlap.  Every reading is a
mean over the traced passes (``pt_bench.pass{k}``), each pass taking the
spans that start inside it.
"""

from __future__ import annotations

PREFIX = "uwpt."
SYNC = PREFIX + "sync."


def _union(intervals) -> list:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """Total length of the intersection of two sorted, disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def program_spans(tr) -> list:
    """The ``uwpt.*`` host spans of ``tr`` as ``(name, start, end)``,
    outer before inner: by start, the longer first."""
    return sorted((h for h in tr.host if h[0].startswith(PREFIX)), key=lambda h: (h[1], -h[2]))


def self_intervals(spans) -> list:
    """For each span of ``spans`` (ordered as :func:`program_spans` orders
    them), ``(name, intervals)``: the span's interval less its children's."""
    children = [[] for _ in spans]
    stack = []
    for k, (_n, s, e) in enumerate(spans):
        while stack and spans[stack[-1]][2] <= s:
            stack.pop()
        if stack and e <= spans[stack[-1]][2]:
            children[stack[-1]].append((s, e))
        stack.append(k)
    out = []
    for (name, s, e), kids in zip(spans, children):
        parts, cur = [], s
        for ks, ke in _union(kids):
            if ks > cur:
                parts.append([cur, ks])
            cur = max(cur, ke)
        if e > cur:
            parts.append([cur, e])
        out.append((name, parts))
    return out


def idle_intervals(tr, lo: float, hi: float) -> list:
    """The device-idle intervals inside ``[lo, hi]``: the complement of
    the union of the kernels and copies."""
    busy = _union((max(s, lo), min(e, hi)) for _n, s, e in tr.kernels + tr.copies
                  if e > lo and s < hi)
    out, cur = [], lo
    for s, e in busy:
        if s > cur:
            out.append([cur, s])
        cur = max(cur, e)
    if hi > cur:
        out.append([cur, hi])
    return out


def per_pass(tr, fn):
    """Mean over the traced passes of ``fn(lo, hi, spans)``, ``spans`` the
    pass's ``uwpt.*`` spans; None where the trace holds none (a program
    without spans)."""
    if tr is None or not tr.passes:
        return None
    spans = program_spans(tr)
    if not spans:
        return None
    vals = [fn(lo, hi, [x for x in spans if lo <= x[1] < hi]) for lo, hi in tr.passes]
    return sum(vals) / len(vals)


def syncs(spans) -> list:
    return [x for x in spans if x[0].startswith(SYNC)]


def self_ms(spans, names) -> float:
    """Self time, in ms, of the spans named in ``names``."""
    return 1e-3 * sum(e - s for n, parts in self_intervals(spans) if n in names
                      for s, e in parts)


def idle_ms(tr, names):
    """Mean device-idle ms a traced pass while the innermost ``uwpt.*``
    span is one of ``names``; None without device events."""
    if tr is None or not (tr.kernels or tr.copies):
        return None

    def one(lo, hi, spans):
        own = _union(tuple(p) for n, parts in self_intervals(spans) if n in names
                     for p in parts)
        return 1e-3 * _overlap(own, idle_intervals(tr, lo, hi))

    return per_pass(tr, one)
