"""The port's CUDA kernels against their plain PyTorch twins, on the card,
and the kernel entries the wrappers call against the sources (on the CPU).

Every test marked ``gpu`` needs a CUDA device and skips without one.  On a
machine with a GPU (which need not have JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX.)  Inputs are a real
pass on the 64K-triangle benchmark scene, whose wide16 table is committed
under ``.bvh_cache``.  Tolerances: integer state equal; float state within
rtol 1e-5 / atol 1e-6 (the kernels are built with -fmad=false and are
expected to match their twins exactly; sin/cos/log/pow may differ by an
ulp between the kernel's and PyTorch's builds).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from unity_webgpu_pathtracer_torch.config import RenderConfig
from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
from unity_webgpu_pathtracer_torch.ops import (
    cuda_arrival,
    cuda_build,
    cuda_probes,
    cuda_shade,
    cuda_transition,
)
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import arrival_step16, arrival_steps16
from unity_webgpu_pathtracer_torch.render import fused
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

W, H = 96, 64
gpu = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene64k(cuda):
    scene, cam = million_triangle_scene(64_000)
    return scene.build("wide16", device=cuda), make_camera_params(
        width=W, height=H, device=cuda, **cam)


def _config(**kw):
    return RenderConfig(width=W, height=H, samples_per_pass=2, max_bounces=5,
                        transition_every=4, pool_size=4096, **kw)


def _assert_same(got, want, name):
    if got.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, equal_nan=True,
                                   msg=lambda m: f"{name}: {m}")
    else:
        assert torch.equal(got, want), name


def _clone(s):
    return s._replace(**{f: getattr(s, f).clone() for f in s._fields})


def _assert_exact(got, want, name):
    """Every field equal: integers exactly, floats with max abs error 0."""
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m: f"{name}.{f}: {m}")
        else:
            assert torch.equal(a, b), f"{name}.{f}"


def test_entries_match_sources():
    """The C entries of each source are exactly those ``cuda_build`` binds,
    with as many arguments, and every kernel the wrappers name has one.
    The one-arrival kernel and its entries are gone: one arrival is the
    multi-arrival kernel at steps = 1."""
    for name, entries in cuda_build.ENTRIES.items():
        with open(os.path.join(cuda_build.SRC_DIR, f"{name}.cu")) as f:
            text = f.read()
        found = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text))
        assert set(found) == set(entries), name
        for entry, args in found.items():
            assert len(args.split(",")) == len(entries[entry]), entry
        assert 'extern "C" const char* cuda_error_string' in text
    launches = {f"{k}_launch" for k in (*cuda_arrival.RUN_KERNELS.values(),
                                         *cuda_transition.KERNELS.values(),
                                         *cuda_shade.KERNELS)}
    assert launches <= {e for entries in cuda_build.ENTRIES.values() for e in entries}
    with open(os.path.join(cuda_build.SRC_DIR, "arrival16.cu")) as f:
        k1 = f.read()
    for gone in ("arrival16_kernel", "ArrivalArgs", "PlaneRay", "PlaneStack",
                 "arrival16_probe_launch",
                 *(f"{k}_launch" for k in cuda_arrival.KERNELS.values())):
        assert re.search(rf"\b{gone}\b", k1) is None, gone
        assert all(gone not in entries for entries in cuda_build.ENTRIES.values()), gone
    assert set(cuda_arrival.arrival_step16_cuda.launches) == set(cuda_arrival.KERNELS.values())
    assert set(cuda_arrival.arrival_steps16_cuda.launches) == set(
        cuda_arrival.RUN_KERNELS.values())
    assert {f"{k}_run" for k in cuda_arrival.KERNELS.values()} == set(
        cuda_arrival.RUN_KERNELS.values())
    assert set(cuda_transition.transition16_cuda.launches) == set(
        cuda_transition.KERNELS.values())
    # The megakernel's shading kernel: its two entries, each counted.
    assert set(cuda_build.ENTRIES["shade16"]) == {f"{k}_launch" for k in cuda_shade.KERNELS}
    assert set(cuda_shade.shade16_cuda.launches) == set(cuda_shade.KERNELS)
    # The probes: K1's probe modes behind two entries, the others in probes.cu.
    assert {"arrival16_run_probe_launch", "arrival16_diet_launch"} <= set(
        cuda_build.ENTRIES["arrival16"])
    assert set(cuda_arrival.arrival_probe_cuda.launches) == set(
        cuda_arrival.PROBE_KERNELS.values())
    assert set(cuda_probes.LAUNCHES) == set(cuda_probes.KERNELS)


@gpu
def test_kernels_build(cuda):
    libs = cuda_build.load()
    for name, entries in cuda_build.ENTRIES.items():
        for entry in entries:
            assert getattr(libs[name], entry) is not None


@gpu
def test_decode_check_entry_exact(cuda):
    """The kernels' f16 decode over all 65,536 halfwords against numpy, and
    their uint32 -> uniform conversion at the edges against PyTorch's."""
    h = torch.arange(65536, dtype=torch.int32, device=cuda)
    k = np.arange(-4, 5)
    u = np.concatenate([[0, 1, 2, 0xFFFFFFFF, 0xFFFFFFFE], 2**31 + k, 2**24 + k,
                        np.random.default_rng(0).integers(0, 2**32, 4096)]).astype(np.int64)
    half, uni = cuda_transition.decode_check_cuda(h, torch.from_numpy(u).to(cuda))
    want = np.arange(65536).astype(np.uint16).view(np.float16).astype(np.float32)
    np.testing.assert_array_equal(half.cpu().numpy().view(np.uint32), want.view(np.uint32))
    from unity_webgpu_pathtracer_torch.utils import rng as urng
    ref = torch.from_numpy(u).to(cuda).to(torch.float32) * urng._INV_U32
    assert torch.equal(uni.view(torch.int32), ref.view(torch.int32))


def _instanced_table(leaf8=False):
    """Three instances of one 400-triangle mesh (moved, scaled, rotated)
    over a two-level table (leaf8 rows with ``leaf8``), and its depth."""
    from unity_webgpu_pathtracer_torch.accel import wide16
    from unity_webgpu_pathtracer_torch.models.primitives import transform_trs

    rng = np.random.default_rng(4)
    c = rng.uniform(-1.0, 1.0, (400, 1, 3))
    tris = (c + rng.uniform(-0.3, 0.3, (400, 3, 3))).astype(np.float32)
    recs = np.concatenate([tris[:, 2] - tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 0]],
                          axis=1).astype(np.float32)
    p = tris.reshape(-1, 3)
    inst = [(0, transform_trs(translate=(x, 0.0, 0.0), rotate_y=0.4 * x, scale=0.5 + 0.3 * k),
             None) for k, x in enumerate((-2.5, 0.0, 2.5))]
    w, _l2w, _w2l, _layout = wide16.build_tlas_wide16(
        [wide16.build_scene_wide16(tris, recs, leaf8=leaf8)], [(p.min(0), p.max(0))], inst, [0])
    return w.nodes, w.depth


@gpu
@pytest.mark.parametrize("leaf8", [False, True])
def test_instanced_kernel_matches_twin(cuda, leaf8):
    """K1's instanced kernels against the twin, arrival by arrival, on
    random rays (half aimed at the instances) over a two-level table."""
    from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import init_state16
    from unity_webgpu_pathtracer_torch.utils.math import safe_rcp

    nodes, depth = _instanced_table(leaf8)
    b = 8192
    rng = np.random.default_rng(11)
    o = rng.uniform(-5.0, 5.0, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    aim = rng.uniform(-3.0, 3.0, (b, 3)) * np.float32([1.0, 0.3, 0.3]) - o
    d[: b // 2] = aim[: b // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = torch.from_numpy(nodes).to(cuda)
    oT = torch.from_numpy(o.T.copy()).to(cuda)
    dT = torch.from_numpy(d.T.copy()).to(cuda)
    invT = safe_rcp(dT)
    active = torch.from_numpy(rng.random(b) < 0.9).to(cuda)
    s = init_state16(b, 1e5, depth=depth + 4, device=cuda)
    kernel = cuda_arrival.KERNELS[(nodes.shape[1], True)]
    before = cuda_arrival.arrival_step16_cuda.launches[kernel]
    for _ in range(40):
        out = cuda_arrival.arrival_step16_cuda(tn, oT, dT, invT, s, active, has_instances=True)
        ref = arrival_step16(tn, oT.T, dT.T, invT.T, s, active, has_instances=True)
        for name in out._fields:
            _assert_same(getattr(out, name), getattr(ref, name), f"arrival_inst.{name}")
        s = out
    torch.cuda.synchronize()
    assert cuda_arrival.arrival_step16_cuda.launches[kernel] - before == 40
    assert bool((s.hit_inst >= 0).any()) and bool(s.found.any())


@gpu
@pytest.mark.parametrize("leaf8", [False, True])
@pytest.mark.parametrize("instanced", [False, True])
def test_run_kernels_match_plain(cuda, leaf8, instanced):
    """Each multi-arrival entry against its plain version, launch after
    launch until every lane has ended, max abs error 0 on every field (the
    stack planes too): 8 arrivals a launch, a live mask, and half of the
    lanes stopping at their first hit."""
    from unity_webgpu_pathtracer_torch.accel import wide16
    from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import init_state16
    from unity_webgpu_pathtracer_torch.utils.math import safe_rcp

    rng = np.random.default_rng(12)
    if instanced:
        nodes, depth = _instanced_table(leaf8)
        aim = rng.uniform(-3.0, 3.0, (8192, 3)) * np.float32([1.0, 0.3, 0.3])
    else:
        c = rng.uniform(-5.0, 5.0, (3000, 1, 3))
        tris = (c + rng.uniform(-0.4, 0.4, (3000, 3, 3))).astype(np.float32)
        recs = np.concatenate([tris[:, 2] - tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 0]],
                              axis=1).astype(np.float32)
        w = wide16.build_scene_wide16(tris, recs, leaf8=leaf8)
        nodes, depth = w.nodes, w.depth
        aim = rng.uniform(-5.0, 5.0, (8192, 3))
    b = 8192
    o = rng.uniform(-6.0, 6.0, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d[: 3 * b // 4] = (aim - o)[: 3 * b // 4]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = torch.from_numpy(nodes).to(cuda)
    oT = torch.from_numpy(o.T.copy()).to(cuda)
    dT = torch.from_numpy(d.T.copy()).to(cuda)
    invT = safe_rcp(dT)
    live = torch.from_numpy(rng.random(b) < 0.9).to(cuda)
    stop = torch.from_numpy(rng.random(b) < 0.5).to(cuda)
    s = init_state16(b, 1e5, depth=depth + 4, device=cuda)
    kernel = cuda_arrival.RUN_KERNELS[(nodes.shape[1], instanced)]
    before = cuda_arrival.arrival_steps16_cuda.launches[kernel]
    launches = 0
    while bool(((s.ptr >= 0) & live & ~(stop & s.found)).any()):
        ref = arrival_steps16(tn, oT.T, dT.T, invT.T, _clone(s), 8, live, stop, instanced)
        out = cuda_arrival.arrival_steps16_cuda(tn, oT, dT, invT, s, 8, live, stop, instanced)
        assert out is s
        _assert_exact(out, ref, kernel)
        launches += 1
    torch.cuda.synchronize()
    assert cuda_arrival.arrival_steps16_cuda.launches[kernel] - before == launches > 1
    assert bool(s.found.any()) and (not instanced or bool((s.hit_inst >= 0).any()))


@gpu
@pytest.mark.parametrize("flags", ["main_path", "firefly_and_canary", "leaf8_attr_raw",
                                   "oct_rows"])
def test_kernels_match_twins_along_a_pass(cuda, scene64k, monkeypatch, flags):
    """Every K1 and K2 call of a real pass, against the plain version on the
    same inputs, max abs error 0 on every state field, on died and on
    rad_out where a lane died (the pass goes on with the kernel's state);
    also with K2's firefly clamp, at a threshold that clamps lanes, and NaN
    canary on; on leaf8 rows with ``attr_in_kernel``; and with oct rows
    (``transition16_oct``)."""
    sd, params = scene64k
    if flags == "firefly_and_canary":
        cfg = _config(use_firefly_filter=True, debug_nan_canary=True)
        params = dataclasses.replace(
            params, max_firefly_luminance=torch.tensor(0.5, device=cuda))
    elif flags == "leaf8_attr_raw":
        scene, _cam = million_triangle_scene(64_000)
        sd = scene.build("wide16", device=cuda, leaf8=True)
        cfg = _config(attr_in_kernel=True)
    elif flags == "oct_rows":
        cfg = _config(attr_compact=3)
    else:
        cfg = _config()
    calls = {"k1": 0, "k2": 0}

    def k1(nodes, oT, dT, invT, s, steps, live=None, stop_on_found=None,
           has_instances=False):
        ref = arrival_steps16(nodes, oT.T, dT.T, invT.T, _clone(s), steps, live,
                              stop_on_found, has_instances)
        out = cuda_arrival.arrival_steps16_cuda(nodes, oT, dT, invT, s, steps, live,
                                                stop_on_found, has_instances)
        _assert_exact(out, ref, "arrivals")
        calls["k1"] += 1
        return out

    def k2(scene, config, prm, st):
        ref = _clone(st)
        died_r, rad_r = cuda_transition.transition16_plain(scene, config, prm, ref)
        died, rad = cuda_transition.transition16_cuda(scene, config, prm, st)
        _assert_exact(st, ref, "transition")
        assert torch.equal(died, died_r)
        torch.testing.assert_close(rad[:, died], rad_r[:, died], rtol=0, atol=0, equal_nan=True)
        calls["k2"] += 1
        return died, rad

    monkeypatch.setattr(fused, "arrival_steps16_cuda", k1)
    monkeypatch.setattr(fused, "transition16_cuda", k2)
    film, _occ, _rays, _arr, iters = fused.fused_pass_with_stats(sd, cfg, params, 0)
    assert calls == {"k1": iters, "k2": iters}
    assert torch.isfinite(film).all()


@gpu
def test_pass_with_kernels_equals_pass_with_twins(cuda, scene64k, monkeypatch):
    sd, params = scene64k
    cfg = _config()
    k1_before = cuda_arrival.arrival_steps16_cuda.launches["arrival16_run"]
    k2_before = cuda_transition.transition16_cuda.launches["transition16"]
    film_k, _occ, rays_k, arr_k, iters = fused.fused_pass_with_stats(sd, cfg, params, 0)
    assert cuda_arrival.arrival_steps16_cuda.launches["arrival16_run"] - k1_before == iters
    assert cuda_transition.transition16_cuda.launches["transition16"] - k2_before == iters

    monkeypatch.setattr(fused, "arrival_steps16_cuda",
                        lambda n, o, d, i, s, k, lv=None, st=None, has_instances=False:
                        arrival_steps16(n, o.T, d.T, i.T, s, k, lv, st, has_instances))
    monkeypatch.setattr(fused, "transition16_cuda", cuda_transition.transition16_plain)
    film_p, _occ, rays_p, arr_p, _ = fused.fused_pass_with_stats(sd, cfg, params, 0)
    assert int(rays_k) == int(rays_p) and int(arr_k) == int(arr_p)
    a, b = film_k.cpu().numpy(), film_p.cpu().numpy()
    assert np.isclose(a, b, rtol=1e-4, atol=1e-6).all(-1).mean() >= 0.99
    assert abs(a.mean() - b.mean()) <= 0.01 * abs(b.mean())


@gpu
def test_kernel_route_runs_no_torch_env_sample(cuda, scene64k, monkeypatch):
    """The kernel route samples the environment in K2: a pass renders with
    the PyTorch env sample and row decode made to raise."""
    sd, params = scene64k

    def refuse(*a, **k):
        raise AssertionError("the kernel route ran the PyTorch glue")

    monkeypatch.setattr(fused, "sample_env_transition", refuse)
    monkeypatch.setattr(fused, "shade_rows", refuse)
    before = cuda_transition.transition16_cuda.launches["transition16"]
    film, _occ, rays, _arr, iters = fused.fused_pass_with_stats(sd, _config(), params, 0)
    assert cuda_transition.transition16_cuda.launches["transition16"] - before == iters
    assert torch.isfinite(film).all() and float(film.mean()) > 0 and int(rays) > 0


@gpu
def test_wrappers_reject_bad_inputs(cuda, scene64k):
    sd, _params = scene64k
    from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import init_state16

    b = 1024
    s = init_state16(b, 1e5, depth=sd.stack_depth, device=cuda)
    planes = torch.zeros((3, b), device=cuda)
    with pytest.raises(ValueError):
        cuda_arrival.arrival_step16_cuda(sd.wide16_nodes, planes.T, planes, planes, s)
    with pytest.raises(ValueError):
        cuda_arrival.arrival_step16_cuda(sd.wide16_nodes, planes, planes, planes,
                                         s._replace(t=s.t.double()))
    with pytest.raises(ValueError):
        cuda_arrival.arrival_steps16_cuda(sd.wide16_nodes, planes, planes, planes,
                                          s._replace(v=s.u), 8)
    with pytest.raises(ValueError):
        cuda_arrival.arrival_steps16_cuda(sd.wide16_nodes, planes, planes, planes, s, 0)


@gpu
@pytest.mark.parametrize("mode", cuda_arrival.PROBE_KERNELS)
def test_probe_modes_match_twin(cuda, scene64k, monkeypatch, mode):
    """K1's probe modes against the twin, in place on a copy: on the kernel
    diet's synthetic rows (each lane on its own row) and on a state
    captured from a pass, after one call and after replays of a CUDA graph
    of restore + call.  The diet's modes exact, the leaf decodes integers
    equal and floats within rtol 1e-5 / atol 1e-6."""
    from unity_webgpu_pathtracer_torch.experiments.round14_kernel_diet import synthetic_inputs

    sd, params = scene64k
    captured = {}

    def k1(nodes, oT, dT, invT, s, steps, live=None, stop_on_found=None,
           has_instances=False):
        if "k1" not in captured:   # the first arrival's inputs, before the update
            active = live & ~(stop_on_found & s.found)
            captured["k1"] = (nodes, s.ptr.clone(), oT, dT, invT, _clone(s), active)
        return cuda_arrival.arrival_steps16_cuda(nodes, oT, dT, invT, s, steps, live,
                                                 stop_on_found, has_instances)

    def check(out, ref):
        if mode in cuda_arrival.DIET_MODES:
            _assert_exact(out, ref, mode)
        else:
            for name in cuda_arrival._FLAT_FIELDS:
                _assert_same(getattr(out, name), getattr(ref, name), f"{mode}.{name}")

    monkeypatch.setattr(fused, "arrival_steps16_cuda", k1)
    fused.fused_pass_with_stats(sd, _config(), params, 0)
    before = cuda_arrival.arrival_probe_cuda.launches[cuda_arrival.PROBE_KERNELS[mode]]
    for nodes, rows, oT, dT, invT, s, active in (synthetic_inputs(cuda, b=8192),
                                                  captured["k1"]):
        ref = cuda_arrival.arrival_probe_plain(nodes, rows, oT, dT, invT, s, active, mode)
        work = _clone(s)

        def call():
            for f in cuda_arrival._FLAT_FIELDS:
                getattr(work, f).copy_(getattr(s, f))
            return cuda_arrival.arrival_probe_cuda(nodes, rows, oT, dT, invT, work, active, mode)

        assert call() is work
        check(work, ref)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            call()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        check(work, ref)
    assert cuda_arrival.arrival_probe_cuda.launches[cuda_arrival.PROBE_KERNELS[mode]] == before + 4


@gpu
def test_probe_kernels_match_plain(cuda):
    """Every kernel of csrc/probes.cu against its plain version at a small
    size: gathers, integers, the step chain and both lobe chains (f32 and
    bf16, also over 25 binades of either sign) exact; the Schlick chain and transcendentals within rtol 1e-5 /
    atol 1e-6, the sum within rtol 1e-5 of ``torch.sum`` and exact against
    its plain version, up to 4,194,304 elements."""
    from unity_webgpu_pathtracer_torch.experiments import round2_probe, round18_mosaic_probe

    tab = round2_probe.table(4000, cuda_probes.RING_W, cuda)
    # Fewer rows than slots, an uneven plan, the probe's largest chunk, one
    # whose blocks reuse their ring slots, and one past 1,024 k a block on
    # every SM (more blocks than SMs).
    for chunk in (5, 1000, 8192, 20000, 1025 * torch.cuda.get_device_properties(cuda)
                  .multi_processor_count):
        idx = torch.from_numpy(round2_probe.hashed_idx(chunk, 4000)).to(cuda)
        assert torch.equal(cuda_probes.ring_gather(tab, idx),
                           cuda_probes.ring_gather_plain(tab, idx)), chunk
    # The one-pass scan at ragged sizes, the pool's and a large one, in an
    # order that changes the tile count from call to call.
    for n in (1, 1025, 98_303, 4_194_304, 98_304, 1025):
        a = torch.from_numpy(np.random.default_rng(n).integers(-1000, 1000, n)
                             .astype(np.int32)).to(cuda)
        assert torch.equal(cuda_probes.intrinsic("cumsum_i32", a),
                           cuda_probes.intrinsic_plain("cumsum_i32", a)), n
    for n, on_chip in ((1024, True), (20000, False)):
        tab = round2_probe.table(n, cuda_probes.TABLE_W, cuda)
        idx = torch.from_numpy(round2_probe.hashed_idx(4096, n)).to(cuda)
        assert torch.equal(cuda_probes.table_sum(tab, idx, on_chip),
                           cuda_probes.table_sum_plain(tab, idx))
    x = torch.linspace(0.1, 0.9, 8192, device=cuda)
    _assert_same(cuda_probes.schlick_chain(x), cuda_probes.schlick_chain_plain(x), "schlick")
    # The probe's range at an odd count (the last block part full), and
    # inputs of either sign over 25 binades, zeros and ones, where the
    # divisions and square roots meet operands far from it.
    rng = np.random.default_rng(6)
    wide = 2.0 ** rng.uniform(-20, 5, 8192) * rng.choice([-1.0, 1.0], 8192)
    for xl in (torch.rand(4097, device=cuda) * 0.9 + 0.05,
               torch.from_numpy(np.concatenate([wide, [0.0, -0.0, 1.0, -1.0]])
                                .astype(np.float32)).to(cuda)):
        for dtype in (torch.float32, torch.bfloat16):
            torch.testing.assert_close(cuda_probes.lobe_chain(xl, dtype),
                                       cuda_probes.lobe_chain_plain(xl, dtype), rtol=0, atol=0,
                                       equal_nan=True, msg=lambda m, d=dtype: f"{d}: {m}")
    # P7 at a ragged lane count (the last warp part full), and with indices
    # outside the table, which give rows of zeros.
    table = torch.rand((cuda_probes.TREE_ROWS, cuda_probes.TREE_COLS), device=cuda).bfloat16()
    rows = torch.randint(0, cuda_probes.TREE_ROWS, (5001,), dtype=torch.int32, device=cuda)
    rows[::5] = torch.tensor([-1, cuda_probes.TREE_ROWS, 2**31 - 1, -(2**31)],
                             dtype=torch.int32, device=cuda).repeat(251)[:1001]
    for n in (5001, 3, 1):
        got = cuda_probes.tree_gather(table, rows[:n])
        assert torch.equal(got, cuda_probes.tree_gather_plain(table, rows[:n])), n
        assert not bool(got[::5].any()), n
    # Every op: whole vectors only, tails of 1-3 elements, the pool's size
    # less one.
    for n in (3000, 1, 3, 1025, 98_303):
        t = round18_mosaic_probe.inputs(cuda, n)
        for op in cuda_probes.INTRINSICS:
            args = round18_mosaic_probe.operands(op, t)
            _assert_same(cuda_probes.intrinsic(op, *args),
                         cuda_probes.intrinsic_plain(op, *args), f"{op} n={n}")
    t = round18_mosaic_probe.inputs(cuda, 3000)
    torch.testing.assert_close(cuda_probes.sum_scalar(t["f"]), t["f"].sum().reshape(1),
                               rtol=1e-5, atol=0.0)
    # The sum exact against its plain version (which follows its order),
    # the same bits on a second call, from one block to 1,024 blocks, and
    # two rounds a block past 4,194,304.
    for n in (1, 3, 1023, 1025, 98_303, 98_304, 10**6, 4_194_304, 4_194_309):
        f = round18_mosaic_probe.inputs(cuda, n)["f"]
        first, second = cuda_probes.sum_scalar(f), cuda_probes.sum_scalar(f)
        assert torch.equal(first, cuda_probes.sum_scalar_plain(f)), n
        assert torch.equal(first.view(torch.int32), second.view(torch.int32)), n
    x = torch.arange(4096, dtype=torch.float32, device=cuda).reshape(4, 8, 128)
    assert torch.equal(cuda_probes.step_chain(x), cuda_probes.step_chain_plain(x))
    torch.cuda.synchronize()


@gpu
def test_cumsum_graph_replays(cuda):
    """The scan's scratch carries from call to call (its counters and
    epoch): one call captured in a CUDA graph and replayed twice gives the
    exact cumsum after each replay."""
    a = torch.from_numpy(np.random.default_rng(7).integers(-1000, 1000, 98_304)
                         .astype(np.int32)).to(cuda)
    want = torch.cumsum(a, 0, dtype=torch.int32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_probes.intrinsic("cumsum_i32", a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_probes.intrinsic("cumsum_i32", a)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@gpu
def test_cumsum_scratch_outlives_growth(cuda):
    """A graph captured at a small n keeps its scratch after an eager call
    at a larger n on the same stream outgrows it, and a call on another
    stream takes a scratch of its own: every output stays exact."""
    rng = np.random.default_rng(8)
    small, large = (torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32)).to(cuda)
                    for n in (1025, 1_000_000))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        cuda_probes.intrinsic("cumsum_i32", small)
        with torch.cuda.graph(graph, stream=side):
            out = cuda_probes.intrinsic("cumsum_i32", small)
        grown = cuda_probes.intrinsic("cumsum_i32", large)
    other = torch.cuda.Stream()
    other.wait_stream(side)
    with torch.cuda.stream(other):
        apart = cuda_probes.intrinsic("cumsum_i32", large)
    torch.cuda.synchronize()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.cumsum(small, 0, dtype=torch.int32))
    assert torch.equal(grown, torch.cumsum(large, 0, dtype=torch.int32))
    assert torch.equal(apart, grown)


@gpu
def test_sum_scalar_graph_replays(cuda):
    """The sum's scratch carries from call to call (its ticket and epoch):
    one call captured in a CUDA graph and replayed twice gives the plain
    version's bits after each replay."""
    x = torch.from_numpy(np.random.default_rng(9).uniform(-1.0, 3.0, 98_304)
                         .astype(np.float32)).to(cuda)
    want = cuda_probes.sum_scalar_plain(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_probes.sum_scalar(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_probes.sum_scalar(x)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@gpu
def test_sum_scalar_scratch_outlives_growth(cuda):
    """A graph captured at a small n keeps the sum's scratch after an eager
    call at a larger n on the same stream outgrows it, and a call on
    another stream takes a scratch of its own: every output stays exact."""
    rng = np.random.default_rng(10)
    small, large = (torch.from_numpy(rng.uniform(-1.0, 3.0, n).astype(np.float32)).to(cuda)
                    for n in (1025, 1_000_000))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        cuda_probes.sum_scalar(small)
        with torch.cuda.graph(graph, stream=side):
            out = cuda_probes.sum_scalar(small)
        grown = cuda_probes.sum_scalar(large)
    other = torch.cuda.Stream()
    other.wait_stream(side)
    with torch.cuda.stream(other):
        apart = cuda_probes.sum_scalar(large)
    torch.cuda.synchronize()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, cuda_probes.sum_scalar_plain(small))
    assert torch.equal(grown, cuda_probes.sum_scalar_plain(large))
    assert torch.equal(apart, grown)


def _bits_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Every element's bits equal, NaN where the other is NaN (torch.equal
    calls no NaN equal, and lets -0.0 equal +0.0)."""
    nan = got.isnan()
    return bool(torch.equal(nan, want.isnan())
                and torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]))


def _probe_table(n: int, dev):
    from unity_webgpu_pathtracer_torch.experiments import round2_probe

    return round2_probe.table(n, cuda_probes.TABLE_W, dev)


@gpu
@pytest.mark.parametrize("on_chip,rows", [(True, 128), (True, 1024), (True, 10_416),
                                          (False, 10_416), (False, 125_000)])
@pytest.mark.parametrize("n_idx", [1, 4095, 4096, 4097, 20_000])
def test_table_sum_exact_on_probe_tables(cuda, on_chip, rows, n_idx):
    """P2 in both modes equals ``table_sum_plain`` on the probe's tables
    (integers 0-6, so any order sums exactly): 24 KB, 192 KB and 2 MB on
    chip (clusters of 8, 8 and 16), 2 and 24 MB in device memory, at the
    probe's 4,096 indices and ragged counts."""
    from unity_webgpu_pathtracer_torch.experiments import round2_probe

    tab = _probe_table(rows, cuda)
    idx = torch.from_numpy(round2_probe.hashed_idx(n_idx, rows)).to(cuda)
    assert torch.equal(cuda_probes.table_sum(tab, idx, on_chip),
                       cuda_probes.table_sum_plain(tab, idx))


@gpu
@pytest.mark.parametrize("on_chip", [True, False])
def test_table_sum_graph_replays(cuda, on_chip):
    """One P2 call captured in a CUDA graph and replayed 20 times gives the
    plain version's sum after every replay (the device mode's scratch
    resets itself; the cluster launch replays)."""
    from unity_webgpu_pathtracer_torch.experiments import round2_probe

    tab = _probe_table(1024 if on_chip else 10_416, cuda)
    idx = torch.from_numpy(round2_probe.hashed_idx(4096, tab.shape[0])).to(cuda)
    want = cuda_probes.table_sum_plain(tab, idx)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_probes.table_sum(tab, idx, on_chip)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_probes.table_sum(tab, idx, on_chip)
    for _ in range(20):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@gpu
def test_table_sum_scratch_outlives_growth(cuda):
    """A graph captured at a few indices keeps P2's scratch after an eager
    call with more indices on the same stream outgrows it, and a call on
    another stream takes a scratch of its own: every output stays exact."""
    from unity_webgpu_pathtracer_torch.experiments import round2_probe

    tab = _probe_table(10_416, cuda)
    small, large = (torch.from_numpy(round2_probe.hashed_idx(n, 10_416)).to(cuda)
                    for n in (1025, 1_000_000))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        cuda_probes.table_sum(tab, small, False)
        with torch.cuda.graph(graph, stream=side):
            out = cuda_probes.table_sum(tab, small, False)
        grown = cuda_probes.table_sum(tab, large, False)
    other = torch.cuda.Stream()
    other.wait_stream(side)
    with torch.cuda.stream(other):
        apart = cuda_probes.table_sum(tab, large, False)
    torch.cuda.synchronize()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, cuda_probes.table_sum_plain(tab, small))
    assert torch.equal(grown, cuda_probes.table_sum_plain(tab, large))
    assert torch.equal(apart, grown)


def _block_tree(acc: np.ndarray) -> np.ndarray:
    """csrc/probes.cu ``block_tree`` of each row of ``acc`` (blocks, threads)
    in float32: the shuffle tree within each warp, then over the warps'
    sums."""
    w = acc.reshape(acc.shape[0], -1, 32)
    for off in (16, 8, 4, 2, 1):
        w = w[..., :off] + w[..., off:2 * off]
    w = w[..., 0]
    off = w.shape[1] // 2
    while off:
        w = w[:, :off] + w[:, off:2 * off]
        off //= 2
    return w[:, 0]


def _table_sum_model(vals: np.ndarray, rows: int, on_chip: bool) -> np.float32:
    """P2's sum of the float32 terms ``vals`` in the kernel's own order:
    in device memory each thread's rounds, the tree of each block, the
    last block's threads over the partials (``TABLE_MAX_BLOCKS /
    TABLE_THREADS`` each) and the tree again; on chip each rank's slice of
    ``TABLE_CL_THREADS`` = 256 threads, 2 indices a thread a round, its
    tree, and rank 0 over the ranks' partials in rank order."""
    n = vals.shape[0]
    if not on_chip:
        blocks, rounds = cuda_probes.table_plan(n)
        t = cuda_probes.TABLE_THREADS
        pad = np.zeros(blocks * rounds * t, np.float32)
        pad[:n] = vals
        acc = np.zeros((blocks, t), np.float32)
        for r in range(rounds):
            acc = acc + pad.reshape(blocks, rounds, t)[:, r]
        parts = np.zeros(cuda_probes.TABLE_MAX_BLOCKS, np.float32)
        parts[:blocks] = _block_tree(acc)
        part = np.zeros(t, np.float32)
        for k in range(cuda_probes.TABLE_MAX_BLOCKS // t):
            part = part + parts[k * t:(k + 1) * t]
        return _block_tree(part[None])[0]
    c, _ = cuda_probes.table_cluster_plan(rows)
    t, vec = 256, 2
    each = -(-n // c)
    total = np.float32(0.0)
    for rank in range(c):
        lo = min(n, rank * each)
        hi = min(n, lo + each)
        acc = np.zeros(t, np.float32)
        for first in range(lo, hi, t * vec):
            for j in range(vec):
                i = first + j * t + np.arange(t)
                acc = acc + np.where(i < hi, vals[np.minimum(i, n - 1)], np.float32(0.0))
        total = np.float32(total + _block_tree(acc[None])[0])
    return total


@gpu
@pytest.mark.parametrize("on_chip,rows", [(True, 1024), (True, 10_416), (False, 125_000)])
def test_table_sum_random_tables(cuda, on_chip, rows):
    """On a table of random floats of either sign P2 gives the same bits on
    every call, the bits of a float32 model of its own summation order (so
    a dropped or repeated term shows), and differs from the float64 sum by
    at most 32 u sum_k |t_k|, u = 2^-24 (its tree of additions is at most
    26 deep at 4,096 terms: 2 a thread, 8 in the block, 16 over the ranks).
    ``table_sum_plain`` sums in another order: within 4 sqrt(n) u sum_k
    |t_k| of it, the size rounding errors of either sign reach in practice
    (Higham, Accuracy and Stability, section 4.2), since no bound on the
    depth of PyTorch's own order is stated."""
    rng = np.random.default_rng(rows)
    tab = torch.from_numpy(rng.uniform(-3.0, 5.0, (rows, cuda_probes.TABLE_W))
                           .astype(np.float32)).to(cuda)
    n = 4096
    idx = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32)).to(cuda)
    first = cuda_probes.table_sum(tab, idx, on_chip)
    for _ in range(4):
        assert torch.equal(cuda_probes.table_sum(tab, idx, on_chip).view(torch.int32),
                           first.view(torch.int32))
    terms = tab[idx.long(), 0]
    model = _table_sum_model(terms.cpu().numpy(), rows, on_chip)
    assert first.cpu().numpy().reshape(()).view(np.int32) == np.float32(model).view(np.int32)
    scale = 2.0 ** -24 * float(terms.double().abs().sum())
    assert abs(float(first) - float(terms.double().sum())) <= 32 * scale
    assert abs(float(first) - float(cuda_probes.table_sum_plain(tab, idx))) <= 4 * n ** 0.5 * scale


@gpu
def test_table_sum_refuses_and_reports_clusters(cuda):
    """A table above the on-chip capacity is refused on the card too; the
    card can place the clusters the probe's tables take."""
    big = torch.zeros((cuda_probes.TABLE_ROWS_MAX + 1, cuda_probes.TABLE_W), device=cuda)
    idx = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        cuda_probes.table_sum(big, idx, True)
    assert float(cuda_probes.table_sum(big, idx, False)) == 0.0
    for rows, cluster in ((128, 8), (1024, 8), (10_416, 16)):
        c, per, count = cuda_probes.table_max_clusters(rows, cuda)
        assert (c, per * c >= rows, count >= 1) == (cluster, True, True), (rows, count)


@gpu
def test_schlick_chain_exact_over_wide_inputs(cuda):
    """P3 bit for bit against ``schlick_chain_plain`` (NaN where it is NaN):
    on the probe's input, on inputs of either sign over 25 binades, and on
    zeros, ones, +-Inf, NaN and values at and above the remainder's short
    form (2048), which the chain's remainder meets through fmodf."""
    from unity_webgpu_pathtracer_torch.experiments import round2_probe

    x = torch.from_numpy(np.linspace(0.1, 0.9, round2_probe.SHADE_B).astype(np.float32)
                         .reshape(-1, 128)).to(cuda)
    assert _bits_equal(cuda_probes.schlick_chain(x), cuda_probes.schlick_chain_plain(x))
    rng = np.random.default_rng(11)
    wide = 2.0 ** rng.uniform(-20, 5, 8192) * rng.choice([-1.0, 1.0], 8192)
    special = [0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 2047.99, 2048.0, 2049.0, 3000.0,
               -7000.0, 1e6, 1e30, 3.4e38, 1e-40, -1e-45]
    xs = torch.from_numpy(np.concatenate([wide, special]).astype(np.float32)).to(cuda)
    assert _bits_equal(cuda_probes.schlick_chain(xs), cuda_probes.schlick_chain_plain(xs))


@gpu
def test_remainder_check_exhaustive(cuda):
    """P3's remainder equals fmodf by 0.9f on all 2^31 non-negative f32 bit
    patterns (Inf and NaN included); the check does count mismatches where
    there are some (the short form is not meant for negative dividends)."""
    assert cuda_probes.remainder_check(device=cuda) == 0
    assert cuda_probes.remainder_check(2**31 + 0x3F000000, 1 << 20, cuda) > 0
