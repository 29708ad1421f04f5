"""The readers of the program's spans (``pt_bench/spans.py`` and the
``mega.*`` metrics that read it) on a trace built by hand, with known
spans, kernels and gaps; and a tiny traced run of each cell on the CPU,
which reports the three metrics read from host spans alone."""

import types

import pytest

from pt_bench import registry
from pt_bench.trace import Trace
from pt_bench.tests.tiny import cells, run_tiny

HOST_SPAN_METRICS = ("mega.syncs_per_pass", "mega.sync_ms_per_pass", "mega.shade_host_ms_per_pass")
IDLE_METRICS = ("mega.shade_idle_ms_per_pass", "mega.traverse_idle_ms_per_pass")


def _trace(with_spans=True, with_device=True) -> Trace:
    """Two passes, times in us.  Pass 0, [0, 100]: the device busy on
    [0, 5], [12, 25], [45, 50] and [70, 100], idle on [5, 12] (closest's
    own 5, then its loop test's 2), [25, 45] (shade 5 + 5, shadow 5 + 2,
    the shadow's loop test 3) and [50, 70] (shade 10, alive test 5, the
    step's own 5).  Pass 1, [100, 200]: busy on [100, 110] and [150, 200],
    idle on [110, 150], all of it in a shade span with no children."""
    spans = [
        ("uwpt.api.step", 1, 99), ("uwpt.mega.closest", 2, 20), ("uwpt.sync.loop_test", 10, 14),
        ("uwpt.mega.shade", 20, 60), ("uwpt.mega.shadow", 30, 40),
        ("uwpt.sync.loop_test", 35, 38), ("uwpt.sync.alive", 60, 65),
        ("uwpt.api.step", 101, 199), ("uwpt.mega.shade", 110, 150),
        ("uwpt.sync.alive", 150, 160),
    ]
    host = [("aten::add", 22, 23), ("aten::mul", 111, 149)] + (spans if with_spans else [])
    kernels = [("k", 0, 5), ("k", 12, 25), ("arrival16", 45, 50), ("k", 100, 110),
               ("k", 150, 200)]
    copies = [("Memcpy DtoH", 70, 100)]
    return Trace(window=(0, 200), passes=[(0, 100), (100, 200)],
                 kernels=kernels if with_device else [], copies=copies if with_device else [],
                 host=host)


def _read(name, tr):
    return registry.reader(name)(types.SimpleNamespace(trace=tr, n_traced=2))


@pytest.mark.parametrize("name, want", [
    ("mega.syncs_per_pass", (3 + 1) / 2),
    ("mega.sync_ms_per_pass", 1e-3 * ((4 + 3 + 5) + 10) / 2),
    ("mega.shade_host_ms_per_pass", 1e-3 * ((10 + 20) + 40) / 2),
    ("mega.shade_idle_ms_per_pass", 1e-3 * ((5 + 5 + 10) + 40) / 2),
    ("mega.traverse_idle_ms_per_pass", 1e-3 * ((5 + 5 + 2) + 0) / 2),
])
def test_reader_on_a_known_trace(name, want):
    assert _read(name, _trace()) == pytest.approx(want, rel=1e-12)


def test_idle_is_split_by_overlap_and_bounded_by_the_idle_time():
    """Idle time that straddles spans goes to each by overlap, never to
    the gap's midpoint alone, and the named shares stay within the idle
    time of the passes."""
    from pt_bench import spans

    tr = _trace()
    by = {}
    for lo, hi in tr.passes:
        sp = [x for x in spans.program_spans(tr) if lo <= x[1] < hi]
        idle = spans.idle_intervals(tr, lo, hi)
        for name, parts in spans.self_intervals(sp):
            by[name] = by.get(name, 0.0) + spans._overlap(sorted(parts), idle)
    assert by == {"uwpt.api.step": 5.0, "uwpt.mega.closest": 5.0, "uwpt.sync.loop_test": 5.0,
                  "uwpt.mega.shade": 60.0, "uwpt.mega.shadow": 7.0, "uwpt.sync.alive": 5.0}
    idle_us = tr.window_us - tr.busy_us
    assert sum(by.values()) == idle_us == 87.0


@pytest.mark.parametrize("name", HOST_SPAN_METRICS + IDLE_METRICS)
def test_reader_is_silent_without_spans(name):
    """A program without the spans (the parent of the change that added
    them) or a run without a trace: the reader returns None, no error."""
    assert _read(name, _trace(with_spans=False)) is None
    assert _read(name, None) is None


@pytest.mark.parametrize("name", IDLE_METRICS)
def test_idle_reader_is_silent_without_device_events(name):
    assert _read(name, _trace(with_device=False)) is None


@pytest.mark.parametrize("name", cells())
def test_tiny_traced_run_reports_the_host_span_metrics(name):
    result, _lines = run_tiny(name, trace=True)
    assert result["correct"] is True
    got = result["metrics"]
    assert set(HOST_SPAN_METRICS) <= set(got)
    assert got["mega.syncs_per_pass"]["value"] > 0
    assert got["mega.syncs_per_pass"]["unit"] == "reads"
    # The CPU trace has no device events.
    assert not set(IDLE_METRICS) & set(got)
