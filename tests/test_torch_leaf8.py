"""The port's leaf8 wide16 tables (48-float rows, 8-triangle leaves)
against the reference: the tables, flat and two-level, byte for byte;
kernel K1's twin on them against the reference's Pallas arrival in
interpret mode; the prestep on them; whole-ray ``closest_hit`` and
``occluded`` on both row widths against the port's brute-force oracle and
the reference's traversal; a fused pass on leaf8 rows with
``attr_in_kernel`` against the reference's fused pass; and the entry
points' refusal to run without a device.

Tolerances: tables byte-identical.  Arrivals: every integer register
equal after 1, 8 and 40 arrivals; ``t`` within rtol/atol 1e-5 and the
barycentrics ``u``, ``v`` within atol 1e-4 (XLA contracts FMAs, PyTorch
does not; the ulp it moves cancels in the barycentric dot products:
measured 1.7e-5 on one lane of 2048).  Whole rays: hit/miss and hit triangle
agree on >= 99.5% of rays (the reference's ``tests/test_wide16_leaf8.py``
threshold; near-ties flip between two triangles).  Fused pass: the
``tests/test_torch_fused.py`` contract (rays and arrivals within 0.5%,
film mean within 1%, >= 99% of pixels within rtol 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_native import native_pair  # noqa: F401  (fixture)
from tests.test_torch_arrival import _rays, _recs, _torch_state, _tris
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.accel import wide16 as tw16
from unity_webgpu_pathtracer_torch.api import Renderer as TRenderer
from unity_webgpu_pathtracer_torch.models import benchmark as tbench
from unity_webgpu_pathtracer_torch.models import examples as texamples
from unity_webgpu_pathtracer_torch.models import primitives as tprim
from unity_webgpu_pathtracer_torch.ops import intersect as tint
from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as ttw
from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_step16_cuda
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params as tcamera
from unity_webgpu_pathtracer_torch.scene.scene import rebuild_tlas_rows, scene_from_numpy
from unity_webgpu_pathtracer_torch.utils.math import safe_rcp
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.accel import wide16 as jw16
from unity_webgpu_pathtracer_tpu.models import benchmark as jbench
from unity_webgpu_pathtracer_tpu.models import examples as jexamples
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as jtw
from unity_webgpu_pathtracer_tpu.ops.pallas_arrival import arrival_step16_pallas
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params as jcamera
from unity_webgpu_pathtracer_tpu.scene import scene as jscene
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE

torch.set_num_threads(2)

_pallas_step = jax.jit(arrival_step16_pallas, static_argnames=("interpret", "has_instances"))

TABLE_FIELDS = ("wide16_nodes", "wide16_top", "attr_shade_c", "attr_shade_o", "materials",
                "inst_l2w", "inst_w2l", "inst_offsets")
INT_FIELDS = ("ptr", "pend", "sp", "tri", "found", "inst", "hit_inst", "sp_enter",
              "stack_row", "stack_mask")


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


@pytest.fixture
def jax_leaf8(monkeypatch):
    """The reference builds leaf8 tables under ``UWPT_WIDE16_LEAF8=1``."""
    monkeypatch.setenv("UWPT_WIDE16_LEAF8", "1")


def _same_bytes(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, name
    assert a.tobytes() == b.tobytes(), name


def _jax_arrays(sd) -> dict:
    out = {f: np.asarray(getattr(sd, f)) for f in TABLE_FIELDS + ("stack_levels",)}
    out["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    return out


# ---- tables ----

@pytest.mark.parametrize("n", [12, 300, 4000])
def test_leaf8_soup_tables_byte_identical(native_pair, n):  # noqa: F811
    tris = _tris(n, seed=n)
    got = tw16.build_scene_wide16(tris, _recs(tris), leaf8=True)
    want = jw16.build_scene_wide16(tris, _recs(tris), leaf8=True)
    assert got.nodes.shape[1] == tw16.ROW8
    _same_bytes(got.nodes, want.nodes, "nodes")
    _same_bytes(got.order, want.order, "order")
    assert got.depth == want.depth
    tw16.validate_wide16(got, n)
    assert got.nodes[:, tw16.OFF_META].view(np.int32).max() <= tw16.LEAF8


def test_leaf8_bench_scene_tables_byte_identical(native_pair, jax_leaf8):  # noqa: F811
    """``Scene.build_arrays(leaf8=True)`` of the 2,000-triangle bench scene
    against the reference's ``Scene.build("wide16")`` under the switch."""
    scene, _cam = tbench.million_triangle_scene(2000)
    got = scene.build_arrays(leaf8=True)
    want = _jax_arrays(jbench.million_triangle_scene(2000)[0].build("wide16"))
    for f in ("wide16_nodes", "wide16_top", "attr_shade_c", "attr_shade_o", "materials"):
        _same_bytes(got[f], want[f], f)
    assert got["wide16_nodes"].shape[1] == tw16.ROW8
    assert got["stack_levels"].shape == want["stack_levels"].shape


def test_leaf8_decode_and_validate_both_widths():
    """``decode_leaf_tris`` returns each leaf's triangles, on either width,
    within f16 quantization of the source records; ``validate_wide16``
    refuses a table with a lost leaf."""
    tris = _tris(300, seed=1)
    recs = _recs(tris)
    for leaf8 in (False, True):
        w = tw16.build_scene_wide16(tris, recs, leaf8=leaf8)
        tw16.validate_wide16(w, 300)
        meta = w.nodes[:, tw16.OFF_META].view(np.int32)
        leaf = int(np.flatnonzero(meta > 0)[0])
        cnt, got, idx = tw16.decode_leaf_tris(w.nodes[leaf])
        assert cnt == meta[leaf] and got.shape == (cnt, 9)
        np.testing.assert_allclose(got, recs[w.order[idx]], rtol=2e-3, atol=2e-3)
        # Every leaf pointing at attribute row 0 loses the other triangles.
        broken = dataclasses.replace(w, nodes=w.nodes.copy())
        off = tw16.OFF_IDX8 if leaf8 else tw16.OFF_IDX
        broken.nodes[meta > 0, off:off + (tw16.LEAF8 if leaf8 else tw16.WIDTH)] = 0.0
        with pytest.raises(ValueError, match="coverage"):
            tw16.validate_wide16(broken, 300)


def _two_instances(pkg):
    """Two instances of one 300-triangle leaf8 mesh, the second scaled and
    moved, built with ``pkg``'s wide16 module."""
    tris = _tris(300, seed=9) * np.float32(0.2)
    p = tris.reshape(-1, 3)
    t2 = np.eye(4, dtype=np.float32)
    t2[:3, 3] = (3.0, 0.5, -1.0)
    t2[0, 0] = 2.0
    blas = pkg.build_scene_wide16(tris, _recs(tris), leaf8=True)
    return pkg.build_tlas_wide16([blas], [(p.min(0), p.max(0))],
                                 [(0, np.eye(4, dtype=np.float32), None), (0, t2, None)], [0])


def test_leaf8_two_level_tables_byte_identical(native_pair, jax_leaf8):  # noqa: F811
    (jw, jl2w, jw2l, jlayout), (tw, tl2w, tw2l, tlayout) = (
        _two_instances(jw16), _two_instances(tw16))
    assert tw.nodes.shape[1] == tw16.ROW8
    _same_bytes(tw.nodes, jw.nodes, "nodes")
    _same_bytes(tl2w, jl2w, "l2w")
    _same_bytes(tw2l, jw2l, "w2l")
    assert tw.depth == jw.depth
    assert dataclasses.asdict(tlayout) == dataclasses.asdict(jlayout)
    # The instanced example scene, and its transform-only refresh.
    want = _jax_arrays(jexamples.tlas_scene(n=4)[0]._build_instanced_wide16())
    tscene = texamples.tlas_scene(n=4)[0]
    got = tscene.build_arrays(leaf8=True)
    for f in TABLE_FIELDS:
        _same_bytes(got[f], want[f], f)
    move = tprim.transform_trs(translate=(0.3, 2.1, -0.4), rotate_y=0.5, scale=1.2)
    js = jexamples.tlas_scene(n=4)[0]
    js._build_instanced_wide16()
    js.set_instance_transform(2, move)
    tscene.set_instance_transform(2, move)
    for g, w, name in zip(rebuild_tlas_rows(tscene), jscene.rebuild_tlas_rows(js, "wide16"),
                          ("rows", "l2w", "w2l")):
        _same_bytes(g, w, name)


# ---- arrivals ----

@pytest.fixture(scope="module")
def leaf8_tables():
    """(flat leaf8 nodes, triangles, two-level leaf8 nodes, its depth)."""
    tris = _tris(3000, seed=21)
    flat = jw16.build_scene_wide16(tris, _recs(tris), leaf8=True).nodes
    two = _two_instances(jw16)[0]
    return flat, tris, two.nodes, two.depth


def _instanced_rays(b, seed):
    """Free rays, half aimed into one of the two instances."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4.0, 4.0, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    centre = np.where(rng.random((b, 1)) < 0.5, 0.0, np.float32([3.0, 0.5, -1.0]))
    aim = centre + rng.uniform(-0.8, 0.8, (b, 3)) - o
    d[: b // 2] = aim[: b // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("kind", ["flat", "instanced"])
@pytest.mark.parametrize("steps", [1, 8, 40])
def test_leaf8_arrivals_match_pallas(leaf8_tables, kind, steps):
    flat, tris, two, two_depth = leaf8_tables
    b = 2048
    if kind == "flat":
        nodes, depth, has_inst = flat, 12, False
        o, d = _rays(b, tris, seed=22)
    else:
        nodes, depth, has_inst = two, two_depth + 2, True
        o, d = _instanced_rays(b, seed=31)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jinv = 1.0 / jnp.where(jd == 0.0, 1e-30, jd)
    js = jtw.init_state16(b, jnp.float32(FAR_PLANE), depth=depth)
    ts = _torch_state(js)
    tnodes = torch.from_numpy(nodes)
    to, td = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    tinv = safe_rcp(td)
    jn = jnp.asarray(nodes)
    for _ in range(steps):
        js = _pallas_step(jn, jo.T, jd.T, jinv.T, js, None, interpret=True,
                          has_instances=has_inst)
        ts = arrival_step16_cuda(tnodes, to, td, tinv, ts, has_instances=has_inst)
    if steps == 1:
        assert bool((ts.ptr >= 0).any())
    else:
        assert bool(ts.found.any())
        assert not has_inst or bool((ts.hit_inst >= 0).any())
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_allclose(ts.t.numpy(), np.asarray(js.t), rtol=1e-5, atol=1e-5)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_prestep_on_leaf8_table_bit_exact(jax_leaf8):
    """The prestep reads only words below 48: on the leaf8 bench table it
    equals the reference's, both levels."""
    scene, cam = jbench.million_triangle_scene(2000)
    sd = scene.build("wide16")
    nodes, top = np.array(sd.wide16_nodes), np.array(sd.wide16_top)
    assert nodes.shape[1] == tw16.ROW8 and top.shape[0] == 16
    _same_bytes(tw16.derive_top16(nodes), top, "top")
    b = 2048
    rng = np.random.default_rng(3)
    eye = np.asarray(cam["eye"], np.float32)
    o = np.tile(eye[None, :], (b, 1))
    d = (rng.uniform(-0.4, 0.4, (b, 3)) - eye).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    fresh = rng.random(b) < 0.8
    depth = sd.stack_levels.shape[0]
    jd = jnp.asarray(d)
    js = jtw.prestep16(jnp.asarray(nodes), jnp.asarray(top), jnp.asarray(o), jd,
                       1.0 / jnp.where(jd == 0.0, 1e-30, jd),
                       jtw.init_state16(b, jnp.float32(FAR_PLANE), depth=depth),
                       jnp.asarray(fresh))
    td = torch.from_numpy(d)
    ts = ttw.prestep16(torch.from_numpy(nodes), torch.from_numpy(top), torch.from_numpy(o), td,
                       safe_rcp(td), ttw.init_state16(b, FAR_PLANE, depth=depth, device="cpu"),
                       torch.from_numpy(fresh))
    assert (ts.ptr.numpy() > 0).mean() > 0.3
    for name in ("ptr", "sp", "stack_row", "stack_mask"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)


# ---- whole rays ----

class _JaxScene:
    """What the reference's ``traverse_wide16.closest_hit`` reads."""

    def __init__(self, nodes, depth):
        self.wide16_nodes = jnp.asarray(nodes)
        self.stack_levels = jnp.zeros((depth,), jnp.int32)
        self.inst_w2l = jnp.zeros((0, 12), jnp.float32)


@pytest.mark.parametrize("leaf8", [False, True])
def test_closest_hit_matches_bruteforce_and_reference(leaf8):
    tris = _tris(1500, seed=leaf8 + 40)
    recs = _recs(tris)
    w = tw16.build_scene_wide16(tris, recs, leaf8=leaf8)
    o, d = _rays(512, tris, seed=7)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    nodes = torch.from_numpy(w.nodes)
    t, bary, tri, inst = ttw.closest_hit(nodes, to, td, w.depth + 1)
    tb, _baryb, trib, _ = tint.closest_hit_bruteforce(torch.from_numpy(recs[w.order]), to, td)
    jt, _jb, jtri, _ = jtw.closest_hit(_JaxScene(w.nodes, w.depth + 1), jnp.asarray(o),
                                       jnp.asarray(d))

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        ida, idb = w.order[np.maximum(a, 0)], w.order[np.maximum(b, 0)]
        return ((a >= 0) == (b >= 0)) & ((b < 0) | (ida == idb))

    hits = tri.numpy() >= 0
    assert 0.2 < hits.mean() < 1.0 and (inst.numpy() == -1).all()
    assert same(tri, trib).mean() >= 0.995
    assert same(tri, jtri).mean() >= 0.995
    np.testing.assert_allclose(t.numpy()[hits], np.asarray(jt)[hits], rtol=1e-5, atol=1e-5)
    # The table stores f16 triangles: t within their quantization where
    # both hit the same triangle.
    both = hits & same(tri, trib)
    np.testing.assert_allclose(t.numpy()[both], tb.numpy()[both], rtol=1e-2, atol=1e-2)
    # Shadow rays up to just short of the closest hit, and far past it.
    t_max = torch.where(t < FAR_PLANE, t * 0.999, torch.full_like(t, 50.0))
    occ = ttw.occluded(nodes, to, td, t_max, w.depth + 1)
    occ_b = tint.occluded_bruteforce(torch.from_numpy(recs[w.order]), to, td, t_max)
    assert (occ == occ_b).float().mean() >= 0.995 and not bool(occ[~torch.from_numpy(hits)].any())
    assert bool(ttw.occluded(nodes, to, td, torch.full_like(t, 50.0), w.depth + 1)[hits].all())


def test_closest_hit_on_two_level_leaf8_table():
    """Whole rays through the leaf8 two-level table: hits in the identity
    instance are the hits of the mesh alone."""
    w, _l2w, _w2l, _layout = _two_instances(tw16)
    tris = _tris(300, seed=9) * np.float32(0.2)
    o, d = _instanced_rays(512, seed=4)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t, _bary, tri, inst = ttw.closest_hit(torch.from_numpy(w.nodes), to, td, w.depth + 4,
                                          has_instances=True)
    alone = tw16.build_scene_wide16(tris, _recs(tris), leaf8=True)
    t0, _b0, tri0, _ = ttw.closest_hit(torch.from_numpy(alone.nodes), to, td, alone.depth + 1)
    in0 = (inst == 0) & (tri0 >= 0)
    assert bool(in0.any()) and bool((inst == 1).any())
    np.testing.assert_allclose(t.numpy()[in0.numpy()], t0.numpy()[in0.numpy()],
                               rtol=1e-5, atol=1e-5)


# ---- a fused pass ----

def test_leaf8_attr_in_kernel_pass_matches_reference(jax_leaf8):
    """The 2,000-triangle bench scene on leaf8 rows, K2 fed the raw
    attribute rows (``attr_in_kernel``), against the reference's fused
    pass with both Pallas kernels on the same tables."""
    w = h = 32
    scene, cam = jbench.million_triangle_scene(2000)
    sd = scene.build("wide16")
    assert sd.wide16_nodes.shape[1] == tw16.ROW8
    common = dict(width=w, height=h, samples_per_pass=4, max_bounces=5, pool_size=1024,
                  transition_every=4, attr_in_kernel=True)
    jcfg = jconfig.RenderConfig(traversal="wide16", integrator="fused", attr_compact=2,
                                use_pallas_arrival=True, use_pallas_transition=True,
                                sky_mode=jconfig.SKY_MODE_ENVIRONMENT,
                                has_environment_texture=True, **common)
    step = jax.jit(jfused.fused_pass_with_stats, static_argnums=(1,))
    jfilm, jocc, jrays, jarr = step(sd, jcfg, jcamera(width=w, height=h, **cam), 0)
    tfilm, tocc, trays, tarr, iters = tfused.fused_pass_with_stats(
        scene_from_numpy(_jax_arrays(sd), device="cpu"), tconfig.RenderConfig(**common),
        tcamera(width=w, height=h, **cam, device="cpu"), 0)
    print(f"rays port {int(trays)} reference {int(jrays)}; arrivals port {int(tarr)} "
          f"reference {int(jarr)}; super-iterations {iters}")
    assert abs(int(trays) - int(jrays)) <= 0.005 * int(jrays)
    assert abs(int(tarr) - int(jarr)) <= 0.005 * int(jarr)
    assert abs(float(tocc) - float(jocc)) <= 0.005
    got, want = tfilm.numpy(), np.asarray(jfilm)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    print(f"pixels diverged beyond rtol 1e-4: {int((~close).sum())} of {close.size}")
    assert close.mean() >= 0.99 and want.mean() > 0
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


# ---- the device default ----

def test_entry_points_need_a_device_or_cpu(monkeypatch):
    """With no ``device`` and no CUDA device the entry points raise and name
    ``device='cpu'``; with ``device="cpu"`` they run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam = tbench.million_triangle_scene(2000)
    cfg = tconfig.RenderConfig(width=8, height=8, pool_size=1024)
    for call in (lambda: scene.build(),
                 lambda: scene_from_numpy(scene.build_arrays()),
                 lambda: tcamera(width=8, height=8, **cam),
                 lambda: tconfig.params_from_numpy({}),
                 lambda: TRenderer(scene, cfg, tcamera(width=8, height=8, **cam,
                                                       device="cpu"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    r = TRenderer(scene, cfg, tcamera(width=8, height=8, **cam, device="cpu"), device="cpu")
    assert r.device.type == "cpu" and r.scene.wide16_nodes.device.type == "cpu"
