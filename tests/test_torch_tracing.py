"""The port's spans (``utils/profiling.py::span``) and the megakernel's
counters in ``Renderer.stats()``, on the CPU at a tiny size: the spans of
one pass under ``torch.profiler``, named and nested at the layer
boundaries; no ``RecordFunction`` without a profiler; every host read of a
pass inside a ``uwpt.sync.*`` span; ``stats()`` against ``path_trace``'s
counters summed by hand, ``TRAVERSE_STATS`` and K1's launch counter."""

import collections

import pytest
import torch

from unity_webgpu_pathtracer_torch.api import Renderer
from unity_webgpu_pathtracer_torch.config import RenderConfig
from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
from unity_webgpu_pathtracer_torch.ops import cuda_arrival
from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as tw16
from unity_webgpu_pathtracer_torch.render import camera as ucamera
from unity_webgpu_pathtracer_torch.render import integrator
from unity_webgpu_pathtracer_torch.utils import profiling
from unity_webgpu_pathtracer_torch.utils import rng as urng

torch.set_num_threads(2)

W, H = 16, 9
MEGA = {"uwpt.api.step", "uwpt.api.image", "uwpt.mega.camera", "uwpt.mega.closest",
        "uwpt.mega.shade", "uwpt.mega.shadow", "uwpt.mega.accumulate", "uwpt.sync.loop_test",
        "uwpt.sync.alive"}
# Each span and the spans it sits directly inside.
PARENTS = {"uwpt.api.step": {None}, "uwpt.api.image": {None},
           "uwpt.mega.camera": {"uwpt.api.step"}, "uwpt.mega.closest": {"uwpt.api.step"},
           "uwpt.mega.shade": {"uwpt.api.step"}, "uwpt.mega.shadow": {"uwpt.mega.shade"},
           "uwpt.mega.accumulate": {"uwpt.api.step"}, "uwpt.sync.alive": {"uwpt.api.step"},
           "uwpt.sync.loop_test": {"uwpt.mega.closest", "uwpt.mega.shadow"},
           "uwpt.sync.queue": {"uwpt.api.step"}}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The north-star scene's shapes at 2,000 triangles, its HDRI (so every
    shaded lane fires a shadow ray), built once on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    scene, cam = million_triangle_scene(2000)
    yield scene.build("wide16", device="cpu"), cam
    mp.undo()


def _renderer(grid, integrator_="megakernel", spp=1):
    sd, cam = grid
    cfg = RenderConfig(width=W, height=H, samples_per_pass=spp, max_bounces=2,
                       integrator=integrator_, pool_size=1024)
    return Renderer(sd, cfg, ucamera.make_camera_params(width=W, height=H, **cam, device="cpu"),
                    device="cpu")


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` (host only): the ``uwpt.*`` spans
    as ``(name, start, end)``, outer first, and the host reads (the
    profiler's ``aten::_local_scalar_dense``) as ``(start, end)``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    spans, reads = [], []
    for ev in prof.events():
        r = (ev.time_range.start, ev.time_range.end)
        if ev.name.startswith(profiling.SPAN_PREFIX):
            spans.append((ev.name, *r))
        elif ev.name == "aten::_local_scalar_dense":
            reads.append(r)
    return sorted(spans, key=lambda x: (x[1], -x[2])), reads


def _parents(spans) -> list:
    """``(name, parent name or None)`` of each span: the innermost span
    that holds it."""
    out, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][2] <= s:
            stack.pop()
        out.append((name, stack[-1][0] if stack and e <= stack[-1][2] else None))
        stack.append((name, s, e))
    return out


def test_span_is_a_shared_no_op_without_a_profiler():
    assert profiling.span("mega.shade") is profiling.span("api.step")
    with profiling.span("mega.shade") as got:
        assert got is None


def test_pass_without_a_profiler_makes_no_record_function(grid, monkeypatch):
    """With no profiler recording, a pass of each integrator runs with
    ``record_function`` made to raise."""

    def refuse(*a, **k):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for name in ("megakernel", "wavefront", "fused"):
        r = _renderer(grid, name)
        r.step()
        r.image()
        assert r.sample_count == 1


def test_megakernel_pass_spans(grid):
    """One megakernel pass and its presentation under the profiler: every
    span of the table, nested as the layers nest; one
    ``uwpt.sync.loop_test`` a traversal loop test, one ``uwpt.sync.alive``
    a bounce tested; every host read of the pass inside a sync span."""
    r = _renderer(grid)
    r.step()
    reads0 = tw16.TRAVERSE_STATS["host_reads"]
    spans, reads = _profiled(lambda: (r.step(), r.image()))
    st = r.stats()
    names = collections.Counter(n for n, _s, _e in spans)
    assert set(names) == MEGA
    assert names["uwpt.api.step"] == names["uwpt.api.image"] == names["uwpt.mega.camera"] == 1
    for name, parent in _parents(spans):
        assert parent in PARENTS[name], (name, parent)
    loop_tests = tw16.TRAVERSE_STATS["host_reads"] - reads0
    assert names["uwpt.sync.loop_test"] == loop_tests > 0
    alive_tests = st["host_reads"] - loop_tests
    assert names["uwpt.sync.alive"] == alive_tests
    assert st["bounces"] <= alive_tests <= st["bounces"] + 1
    assert names["uwpt.mega.closest"] == names["uwpt.mega.shade"] == st["bounces"]
    syncs = [(s, e) for n, s, e in spans if n.startswith("uwpt.sync.")]
    assert len(reads) == st["host_reads"]
    assert all(any(s <= a and b <= e for s, e in syncs) for a, b in reads)


@pytest.mark.parametrize("name", ["fused", "wavefront"])
def test_queue_spans_and_stats(grid, name):
    """The fused and wavefront loops' tests are ``uwpt.sync.queue`` spans;
    ``stats()`` after those passes is as it was (the fused pass's four
    counters, ``{}`` after a wavefront pass)."""
    r = _renderer(grid, name)
    spans, reads = _profiled(r.step)
    names = collections.Counter(n for n, _s, _e in spans)
    assert names["uwpt.api.step"] == 1 and names["uwpt.sync.queue"] >= 2
    for span_name, parent in _parents(spans):
        assert parent in PARENTS[span_name], (span_name, parent)
    syncs = [(s, e) for n, s, e in spans if n.startswith("uwpt.sync.")]
    assert all(any(s <= a and b <= e for s, e in syncs) for a, b in reads)
    st = r.stats()
    if name == "fused":
        assert set(st) == {"occupancy", "rays", "arrivals", "super_iterations"}
        assert names["uwpt.sync.queue"] == st["super_iterations"] + 1
        assert "uwpt.mega.shade" not in names
    else:
        assert st == {}
        assert names["uwpt.mega.shade"] >= 1


def test_megakernel_stats_match_the_counters(grid, monkeypatch):
    """``stats()`` after a 2-spp megakernel pass: the rays and bounces of
    ``path_trace(stats=...)`` over the pass's samples, summed by hand; K1's
    launches the delta of ``arrival_steps16_cuda.launches`` (counted here
    by a wrapper on the CPU, where the plain twin runs), one a traversal
    loop test; the shading kernel's launches 0 (the CPU shades in plain
    PyTorch); host reads the loop tests and the alive tests.  The rays
    stay device scalars until ``stats()`` reads them."""
    real = cuda_arrival.arrival_steps16_cuda

    def counted(nodes, *a, **k):
        counted.launches["arrival16_run"] += 1
        return real(nodes, *a, **k)

    counted.launches = dict(real.launches)
    monkeypatch.setattr(cuda_arrival, "arrival_steps16_cuda", counted)

    r = _renderer(grid, spp=2)
    r.step()
    k1_0, reads0 = sum(counted.launches.values()), tw16.TRAVERSE_STATS["host_reads"]
    sample = r.sample_count
    r.step()
    assert all(isinstance(r._last[k], torch.Tensor) for k in ("closest_rays", "shadow_rays"))
    st = r.stats()
    k1 = sum(counted.launches.values()) - k1_0
    loop_tests = tw16.TRAVERSE_STATS["host_reads"] - reads0

    sd, cfg, params = r.scene, r.config, r.params
    pix = torch.arange(W * H, dtype=torch.int64)
    state = urng.seed(pix, sample, params.seed_root)
    want = collections.Counter()
    for _ in range(cfg.samples_per_pass):
        coords, state = ucamera.jittered_pixel_coords(pix, cfg, state)
        o, d, state = ucamera.get_screen_ray(coords, cfg, params, state)
        one = {}
        _rad, state = integrator.path_trace(sd, cfg, params, o.T.contiguous(), d.T.contiguous(),
                                            state, one)
        want.update({k: int(v) for k, v in one.items()})
    assert want["closest"] > 0 and want["shadow"] > 0 and want["bounces"] >= 2
    assert st == {"closest_rays": want["closest"], "shadow_rays": want["shadow"],
                  "bounces": want["bounces"], "k1_launches": k1, "shade_launches": 0,
                  "host_reads": loop_tests + want["alive_tests"]}
    assert k1 == loop_tests > 0
    r.reset()
    assert r.stats() == {}
