"""Profiling and observability (``utils/profiling.py`` of the reference).

* :class:`Timer`: a wall-clock scope that waits for the card's work on
  exit when its tensors lie on the card;
* :class:`RenderStats`: rays, arrivals, occupancy and seconds pooled over
  passes, fed by the single or sharded fused pass's counters
  (``fused_pass_with_stats``, ``parallel/film_tiling.py``);
* :func:`trace`: a ``torch.profiler`` scope whose Chrome trace is written
  to a directory;
* :func:`span`: the port's named ranges (``uwpt.*``) at its layer
  boundaries, recorded only while a profiler records;
* :func:`scene_summary`: the scene's counts and device bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "uwpt."
_NO_SPAN = contextlib.nullcontext()


def _tensors(tree):
    """The tensors in a tensor, a (named) tuple, a list or a dict."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


class Timer:
    """Wall-clock scope; on exit it synchronizes the CUDA devices that hold
    a tensor of ``sync_on`` (the reference's ``block_until_ready``)."""

    def __init__(self, name: str, sync_on=None, log=print):
        self.name = name
        self.sync_on = sync_on
        self.log = log
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for dev in {x.device for x in _tensors(self.sync_on) if x.is_cuda}:
            torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self._t0
        if self.log:
            self.log(f"[timer] {self.name}: {self.elapsed * 1e3:.1f} ms")
        return False


@dataclasses.dataclass
class RenderStats:
    """Accumulated render telemetry across passes."""

    rays: int = 0
    arrivals: int = 0
    seconds: float = 0.0
    occupancy_sum: float = 0.0
    passes: int = 0

    def update(self, rays, arrivals, occupancy, seconds) -> None:
        """One pass's counters (ints, floats or device scalars)."""
        self.rays += int(rays)
        self.arrivals += int(arrivals)
        self.occupancy_sum += float(occupancy)
        self.seconds += seconds
        self.passes += 1

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6

    @property
    def occupancy(self) -> float:
        return self.occupancy_sum / max(self.passes, 1)

    def summary(self) -> str:
        return (f"{self.rays:,} rays in {self.seconds:.2f}s "
                f"({self.mrays_per_sec:.2f} Mrays/s), "
                f"{self.arrivals:,} BVH arrivals, "
                f"occupancy {self.occupancy:.2f}")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` scope over the host and, where there is one, the
    card; its Chrome trace is written to ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str):
    """A range named ``"uwpt." + name`` around a block: while a
    ``torch.profiler`` records (``trace``, or any other profiler scope), a
    ``record_function``, so the range lands in the same trace and on the
    same clock as the card's kernels and copies, nested in the enclosing
    range of its thread; otherwise one shared no-op context, after a single
    flag test (no ``RecordFunction`` is made, which costs about as much as
    a few small PyTorch ops)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def scene_summary(scene_data) -> dict:
    """Structured scene statistics (the reference's BVHScene Debug.Log
    block) of the port's ``SceneData``; ``hbm_bytes`` sums every table's
    bytes on its device."""
    return {
        "triangles": int(scene_data.tris.shape[0]),
        "materials": int(scene_data.materials.shape[0]),
        "texture_words": int(scene_data.texture_data.shape[0]),
        "lights": int(scene_data.lights.shape[0]),
        "instances": int(scene_data.inst_l2w.shape[0]),
        "wide_rows": int(scene_data.wide16_nodes.shape[0]),
        "env_resolution": tuple(int(x) for x in scene_data.env.image.shape[:2]),
        "hbm_bytes": sum(x.numel() * x.element_size() for x in _tensors(tuple(scene_data))),
    }
