"""The traced passes: a ``torch.profiler`` scope over a few passes of the
window's own loop, reduced in memory to what the per-layer readers need
(no trace file is written).

Device intervals are every kernel, copy and set the profiler saw on the
card; their union is the busy time, the traced window is the host span
around the passes (each pass ends synchronised, so its device work lies
inside it).  Kernel launches are counted as
``experiments/k2_span.py::launches_per_si`` counts them (device kernel
events, copies and sets apart; the method copied at commit
628fc1bc0151d37c4767d2275c25b153616afc0d).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

WINDOW = "pt_bench.traced_passes"
PASS = "pt_bench.pass"
K1_NAME = "arrival16"


@dataclasses.dataclass
class Trace:
    window: tuple                 # (start, end) us of the traced passes, host span
    passes: list                  # (start, end) us of each traced pass
    kernels: list                 # (name, start, end) us, device kernels in start order
    copies: list                  # (name, start, end) us, device copies and sets
    host: list                    # (name, start, end) us, host-side ops and spans

    @property
    def busy_us(self) -> float:
        lo, hi = self.window
        total, end = 0.0, lo
        for _n, s, e in sorted(self.kernels + self.copies, key=lambda x: x[1]):
            s, e = max(s, end), min(e, hi)
            if e > s:
                total += e - s
                end = e
        return total

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernels_in(self, k: int) -> list:
        lo, hi = self.passes[k]
        return [x for x in self.kernels if lo <= x[1] < hi]

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for n, s, e in self.kernels + self.copies:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest device-idle gaps in the window, each named by the
        innermost host op running at its middle."""
        lo, hi = self.window
        gaps, end = [], lo
        for _n, s, e in sorted(self.kernels + self.copies, key=lambda x: x[1]):
            if s > end:
                gaps.append((end, min(s, hi)))
            end = max(end, e)
        if hi > end:
            gaps.append((end, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        out = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            cover = [h for h in self.host if h[1] <= mid <= h[2]]
            name = min(cover, key=lambda h: h[2] - h[1])[0] if cover else "host (no op)"
            out.append([name, (e - s) * 1e-6])
        return out


def _reduce(prof) -> Trace | None:
    window, passes, kernels, copies, host = None, [], [], [], []
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or ev.name.startswith("pt_bench."):
                continue                       # a host span's mirror on the device
            low = ev.name.lower()
            (copies if ("memcpy" in low or "memset" in low) else kernels).append((ev.name, s, e))
        elif ev.name == WINDOW:
            window = (s, e)
        elif ev.name.startswith(PASS):
            passes.append((s, e))
        else:
            host.append((ev.name, s, e))
    if window is None:
        return None
    kernels.sort(key=lambda x: x[1])
    passes.sort()
    return Trace(window, passes, kernels, copies, host)


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the block; yields a holder whose ``trace`` is set on exit
    (None when the profiler saw no window).  The block marks its passes
    with :func:`pass_span` inside :func:`window_span`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    holder = type("Holder", (), {"trace": None})()
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    holder.trace = _reduce(prof)


def window_span():
    return torch.profiler.record_function(WINDOW)


def pass_span(k: int):
    return torch.profiler.record_function(f"{PASS}{k}")

