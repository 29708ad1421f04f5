"""Tree quality in the port against the reference, on the CPU.

* ``accel/wide16.py::build_scene_wide16`` at quality 0-3 (binned SAH,
  SBVH spatial splits, each with the greedy or the DP collapse), flat and
  leaf8, byte for byte (rows as uint32, ``order``, depth) against the
  reference's, on random triangles and on beams; the switches
  ``UWPT_BVH_QUALITY``, ``UWPT_COLLAPSE``, ``UWPT_COLLAPSE_CNODE`` and
  ``UWPT_BVH_CACHE`` as the reference reads them; the cache key; a leaf
  size the builder refuses.
* ``models/benchmark.py::beam_scene`` array for array, its wide16 tables
  byte for byte at quality 0 and 3, K1's plain twin on them against the
  brute-force oracle, and a small fused pass at quality 0 against the
  reference's (rays and arrivals exact, the film within
  ``tests/test_torch_fused.py``'s bounds).
* ``validate_bvh2``, ``validate_mbvh`` and ``native_f2h_or_none``.
* ``experiments/round6_sbvh_ab.py::ab`` at a tiny size.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from tests.torch_native import assert_native_pair, native_pair  # noqa: F401  (fixture)
from tests.test_torch_fused import _film_close
from tests.test_torch_scene import ENV_FIELDS, jax_arrays
from tests.test_wide8 import random_rays, random_tris, recs_of
from tests.test_wide16 import _beam_tris
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.accel import bvh2 as tbvh2
from unity_webgpu_pathtracer_torch.accel import mbvh as tmbvh
from unity_webgpu_pathtracer_torch.accel import native as tnative
from unity_webgpu_pathtracer_torch.accel import wide16 as tw16
from unity_webgpu_pathtracer_torch.experiments import round6_sbvh_ab
from unity_webgpu_pathtracer_torch.models import benchmark as tbench
from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as ttrav
from unity_webgpu_pathtracer_torch.ops.intersect import closest_hit_bruteforce
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params as tcamera
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.accel import bvh2 as jbvh2
from unity_webgpu_pathtracer_tpu.accel import mbvh as jmbvh
from unity_webgpu_pathtracer_tpu.accel import native as jnative
from unity_webgpu_pathtracer_tpu.accel import wide16 as jw16
from unity_webgpu_pathtracer_tpu.models import benchmark as jbench
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params as jcamera

torch.set_num_threads(2)

SWITCHES = ("UWPT_BVH_QUALITY", "UWPT_COLLAPSE", "UWPT_COLLAPSE_CNODE", "UWPT_BVH_CACHE",
            "UWPT_WIDE16_LEAF8")


@pytest.fixture
def env(monkeypatch, tmp_path):
    """No build switch set, the cache under ``tmp_path``."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path))
    return monkeypatch


@pytest.fixture
def fresh(env):
    """No cache: every build is a build."""
    env.setenv("UWPT_BVH_CACHE", "0")
    return env


def _soup(name):
    tris = {"r300": lambda: random_tris(300, seed=300),
            "r4000": lambda: random_tris(4000, seed=4000),
            "beams400": lambda: _beam_tris(400, seed=19)}[name]()
    return tris, recs_of(tris)


def _same(got: tw16.Wide16, want) -> None:
    assert got.nodes.shape == want.nodes.shape
    assert got.nodes.view(np.uint32).tobytes() == np.asarray(want.nodes).view(np.uint32).tobytes()
    np.testing.assert_array_equal(got.order, np.asarray(want.order, np.int32))
    assert got.depth == want.depth


@pytest.mark.parametrize("leaf8", [False, True], ids=["flat", "leaf8"])
@pytest.mark.parametrize("quality", [0, 1, 2, 3])
@pytest.mark.parametrize("soup", ["r300", "r4000", "beams400"])
def test_build_byte_identical(native_pair, fresh, soup, quality, leaf8):  # noqa: F811
    tris, recs = _soup(soup)
    got = tw16.build_scene_wide16(tris, recs, quality=quality, leaf8=leaf8)
    _same(got, jw16.build_scene_wide16(tris, recs, quality=quality, leaf8=leaf8))
    tw16.validate_wide16(got, tris.shape[0])
    # Spatial splits (bit 0) reference some triangles twice on these soups.
    assert (got.order.shape[0] > tris.shape[0]) == (quality & 1 == 1 and soup != "r300")


@pytest.mark.parametrize("switches, quality, want", [
    ({}, None, 1),
    ({"UWPT_BVH_QUALITY": "0"}, None, 0),
    ({"UWPT_COLLAPSE": "dp"}, None, 3),
    ({"UWPT_BVH_QUALITY": "0", "UWPT_COLLAPSE": "dp"}, None, 2),
    ({"UWPT_BVH_QUALITY": "1", "UWPT_COLLAPSE": "greedy"}, None, 1),
    ({"UWPT_COLLAPSE": "dp"}, 0, 2),            # an explicit 0 or 1 takes the bit too
    ({"UWPT_COLLAPSE": "dp"}, 3, 3),            # 2 and 3 pass through
    ({"UWPT_BVH_QUALITY": "3"}, 0, 0),          # an explicit quality wins
])
def test_switches_resolve_as_the_reference(native_pair, fresh,  # noqa: F811
                                           switches, quality, want):
    for k, v in switches.items():
        fresh.setenv(k, v)
    assert tw16.resolve_quality(quality) == want
    tris, recs = _soup("r4000")
    got = tw16.build_scene_wide16(tris, recs, quality=quality)
    _same(got, jw16.build_scene_wide16(tris, recs, quality=quality))
    for k in switches:
        fresh.delenv(k)
    _same(got, tw16.build_scene_wide16(tris, recs, quality=want))


def test_collapse_cnode_changes_the_dp_table_and_misses(native_pair, env, tmp_path):  # noqa: F811
    """``UWPT_COLLAPSE_CNODE`` weighs the DP collapse's inner rows: another
    weight builds another table (the reference's), under another key."""
    tris, recs = _soup("r4000")
    base = tw16.build_scene_wide16(tris, recs, quality=3)
    greedy = tw16.build_scene_wide16(tris, recs, quality=1)
    env.setenv("UWPT_COLLAPSE_CNODE", "4.0")
    stats = dict(tw16.CACHE_STATS)
    heavy = tw16.build_scene_wide16(tris, recs, quality=3)
    assert tw16.CACHE_STATS["miss"] == stats["miss"] + 1
    assert heavy.nodes.tobytes() != base.nodes.tobytes()
    # The greedy collapse does not read it, but the key does.
    _same(tw16.build_scene_wide16(tris, recs, quality=1), greedy)
    assert tw16.CACHE_STATS["miss"] == stats["miss"] + 2
    assert len(list(tmp_path.iterdir())) == 4
    env.setenv("UWPT_BVH_CACHE", "0")
    _same(heavy, jw16.build_scene_wide16(tris, recs, quality=3))
    # Loaded again from its own key.
    env.delenv("UWPT_BVH_CACHE")
    _same(tw16.build_scene_wide16(tris, recs, quality=3), heavy)
    assert tw16.CACHE_STATS["hit"] == stats["hit"] + 1


@pytest.mark.parametrize("quality", [0, 1, 2, 3])
def test_cache_path_is_the_reference_key(env, quality):
    tris, recs = _soup("r300")
    for leaf_size, leaf8 in ((4, False), (4, True), (2, False)):
        want = jw16._bvh_cache_path(tris, recs, leaf_size, quality, leaf8)
        assert tw16.bvh_cache_path(tris, recs, leaf_size, quality, leaf8) == want


def test_cache_off_writes_nothing(env, tmp_path):
    env.setenv("UWPT_BVH_CACHE", "0")
    tris, recs = _soup("r300")
    assert tw16.bvh_cache_path(tris, recs) is None
    assert jw16._bvh_cache_path(tris, recs, 4, 1, False) is None
    stats = dict(tw16.CACHE_STATS)
    for _ in range(2):
        tw16.build_scene_wide16(tris, recs, quality=0)
    with tnative.disabled(), pytest.warns(UserWarning, match="native BVH builder"):
        tw16.build_scene_wide16(tris, recs)
    assert tw16.CACHE_STATS["miss"] == stats["miss"] + 3
    assert tw16.CACHE_STATS["hit"] == stats["hit"]
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("leaf_size, leaf8", [(17, False), (12, True), (0, False)])
def test_refused_leaf_size(fresh, leaf_size, leaf8):
    """The native builder refuses a leaf size outside [1, the row's leaf
    slots].  The reference's binding then returns None and its build falls
    back to the numpy builder without a word, whose leaves then exceed the
    row's slots (on this soup at 17 its emit was still recursing after 20
    s); the port refuses up front (ROADMAP.md queue 3)."""
    tris, recs = _soup("r300")
    assert jnative.native_wide16_or_none(tris, recs, leaf_size, 1, leaf8) is None
    with pytest.raises(RuntimeError, match="native wide16 build failed"):
        tnative.native_wide16(tris, recs, leaf_size, 1, leaf8)
    with pytest.raises(ValueError, match="leaf_size"):
        tw16.build_scene_wide16(tris, recs, leaf_size=leaf_size, leaf8=leaf8)


def _assert_scenes_equal(got, want):
    assert len(got.meshes) == len(want.meshes) and not got.instances
    for (tm, txf), (jm, jxf) in zip(got.meshes, want.meshes):
        for f in ("vertices", "indices", "normals", "tangents", "uvs"):
            a, b = getattr(tm, f), getattr(jm, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype, f
        assert tm.material_index == jm.material_index
        np.testing.assert_array_equal(txf, jxf)
    assert [dataclasses.asdict(m) for m in got.materials] == [
        dataclasses.asdict(m) for m in want.materials]
    np.testing.assert_array_equal(got.env_image, want.env_image)


def test_beam_scene_equals_the_reference():
    (got, tcam), (want, jcam) = tbench.beam_scene(2_000), jbench.beam_scene(2_000)
    assert tcam == jcam
    _assert_scenes_equal(got, want)
    assert sum(m.triangle_count for m, _xf in got.meshes) == 2_000
    mesh = got.meshes[0][0]
    copy, jcopy = tbench.sphere_copy(mesh, 2), jbench.sphere_copy(want.meshes[0][0], 2)
    assert np.shares_memory(copy.vertices, mesh.vertices)
    assert copy.material_index == jcopy.material_index == 2
    # The grid is built from sphere_copy in both packages.
    _assert_scenes_equal(tbench.million_triangle_scene(2_000)[0],
                         jbench.million_triangle_scene(2_000)[0])


@pytest.fixture(scope="module")
def beams():
    """``beam_scene(2_000)`` of both packages and its wide16 tables at
    quality 0 and 3: the reference's ``SceneData`` as numpy arrays and the
    port's ``build_arrays`` and table, each built under
    ``UWPT_BVH_QUALITY`` with the cache off."""
    assert_native_pair()
    mp = pytest.MonkeyPatch()
    for k in SWITCHES:
        mp.delenv(k, raising=False)
    mp.setenv("UWPT_BVH_CACHE", "0")
    (tscene, cam), (jscene, _jcam) = tbench.beam_scene(2_000), jbench.beam_scene(2_000)
    flat = tscene.flatten()
    out = {}
    try:
        for q in (0, 3):
            mp.setenv("UWPT_BVH_QUALITY", str(q))
            out[q] = dict(jax=jscene.build("wide16"), port=tscene.build_arrays(),
                          table=tw16.build_scene_wide16(flat.positions, flat.tri_records()))
    finally:
        mp.undo()
    return tscene, cam, flat, out


@pytest.mark.parametrize("quality", [0, 3])
def test_beam_tables_byte_identical(native_pair, beams, quality):  # noqa: F811
    _scene, _cam, _flat, out = beams
    want, got = jax_arrays(out[quality]["jax"]), out[quality]["port"]
    for f in ("wide16_nodes", "wide16_top", "attr_shade_c", "materials"):
        assert got[f].shape == want[f].shape and got[f].tobytes() == want[f].tobytes(), f
    assert got["stack_levels"].shape == want["stack_levels"].shape
    for f in ENV_FIELDS:
        assert got["env"][f].tobytes() == want["env"][f].tobytes(), f
    np.testing.assert_array_equal(np.asarray(out[quality]["jax"].tris), got["tris"])


@pytest.mark.parametrize("quality", [0, 3])
def test_k1_twin_on_beams_matches_oracle(native_pair, beams, quality):  # noqa: F811
    """``tests/test_wide16.py::test_wide16_beams_matches_bruteforce``'s
    bounds on the port's tables of the beam scene: K1's plain twin
    (``closest_hit``) against the brute-force oracle over the table's leaf
    triangles as K1 reads them (``leaf_triangles``: f16 edges and
    corners), in original-triangle-id space, and against the reference's
    traversal on the same tables.  Against the f32 records neither package
    meets those bounds on this scene (2-3% of these rays differ, the same
    in both): a beam is 0.008-0.04 wide and up to 5 long, and its f16 edges
    are off by up to ~2^-11 of their length (ROADMAP.md queue 3)."""
    from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as jtrav

    _scene, _cam, flat, out = beams
    w = out[quality]["table"]
    jo, jd = random_rays(512, seed=23, tris=flat.positions)
    o, d = torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jd))
    t16, _b, slot, _i = ttrav.closest_hit(torch.from_numpy(w.nodes), o, d, w.depth + 1)
    t16, slot = t16.numpy(), slot.numpy()
    id16 = np.where(slot >= 0, w.order[np.maximum(slot, 0)], -1)

    def against(recs, ids):
        tb, _bb, sb, _ib = closest_hit_bruteforce(torch.from_numpy(recs), o, d)
        tb, sb = tb.numpy(), sb.numpy()
        idb = np.where(sb >= 0, ids[np.maximum(sb, 0)], -1)
        same = id16 == idb
        both = same & (idb >= 0)
        rel = np.abs(t16[both] - tb[both]) / np.maximum(tb[both], 1e-3)
        return same, np.quantile(rel, 0.99)

    same, q99 = against(*tw16.leaf_triangles(w))
    assert same.mean() >= 0.99 and q99 < 5e-3, (same.mean(), q99)
    exact, _q = against(flat.tri_records(), np.arange(flat.count))
    jt, _jb, jslot, _ji = jtrav.closest_hit(out[quality]["jax"], jo, jd)
    jslot = np.asarray(jslot)
    jid = np.where(jslot >= 0, w.order[np.maximum(jslot, 0)], -1)
    np.testing.assert_array_equal(id16, jid)
    # The jitted reference contracts multiply-adds (up to 6.8e-5 here).
    np.testing.assert_allclose(t16, np.asarray(jt), rtol=1e-4)
    print(f"ids equal to the f32 oracle's on {exact.mean():.4f} of the rays")
    assert 0.95 <= exact.mean() < 0.99


def test_fused_pass_on_binned_beams_matches_reference(beams):
    """The fused pass (K1 and K2's twins) on the quality-0 beam tables at
    12x12, 2 spp, against the reference's on the same tables, run eagerly
    (``jax.disable_jit``, its XLA arrival and transition): rays and
    arrivals equal, the film within ``tests/test_torch_fused.py``'s bounds.
    The jitted reference contracts multiply-adds: its Pallas pass made 56
    arrivals fewer of 28,500 at 16x16 on these tables.  Occupancy is not
    compared: the port rounds the pool up to whole 1,024-lane blocks as the
    reference's Pallas route does, and its XLA route keeps 256 lanes (the
    same samples either way)."""
    _scene, cam, _flat, out = beams
    slice_ = dict(width=12, height=12, samples_per_pass=2, max_bounces=5, pool_size=256,
                  transition_every=8)
    jcfg = jconfig.RenderConfig(
        traversal="wide16", sky_mode=jconfig.SKY_MODE_ENVIRONMENT,
        has_environment_texture=True, integrator="fused", attr_compact=2,
        use_pallas_arrival=False, use_pallas_transition=False, **slice_)
    with jax.disable_jit():
        jfilm, _jocc, jrays, jarr = jfused.fused_pass_with_stats(
            out[0]["jax"], jcfg, jcamera(width=12, height=12, **cam), 0)
    from unity_webgpu_pathtracer_torch.scene.scene import scene_from_numpy

    tsd = scene_from_numpy(out[0]["port"], device="cpu")
    tfilm, _occ, trays, tarr, _iters = tfused.fused_pass_with_stats(
        tsd, tconfig.RenderConfig(**slice_), tcamera(width=12, height=12, device="cpu", **cam), 0)
    assert int(trays) == int(jrays) and int(tarr) == int(jarr)
    _film_close(tfilm.numpy(), np.asarray(jfilm))


@pytest.mark.parametrize("fault", ["none", "order", "leaf_box", "child_box"])
def test_validate_bvh2_as_the_reference(fault):
    pos = random_tris(200, seed=9)
    bvh = tbvh2.build_bvh2(pos, leaf_size=4)
    bvh = dataclasses.replace(bvh, **{f: getattr(bvh, f).copy() for f in
                                      ("nmin", "nmax", "order")})
    leaf = int(np.nonzero(bvh.count > 0)[0][0])
    if fault == "order":
        bvh.order[1] = bvh.order[0]
    elif fault == "leaf_box":
        bvh.nmax[leaf] = bvh.nmin[leaf]
    elif fault == "child_box":
        bvh.nmin[bvh.left[0]] -= 1.0
    ref = jbvh2.BVH2(**dataclasses.asdict(bvh))
    if fault == "none":
        tbvh2.validate_bvh2(bvh, pos)
        jbvh2.validate_bvh2(ref, pos)
        return
    with pytest.raises(AssertionError):
        jbvh2.validate_bvh2(ref, pos)
    with pytest.raises(ValueError):
        tbvh2.validate_bvh2(bvh, pos)


@pytest.mark.parametrize("fault", ["none", "twice", "box", "lost"])
def test_validate_mbvh_as_the_reference(fault):
    pos = random_tris(300, seed=4)
    bounds, child, order = tmbvh.collapse_to_mbvh8(tbvh2.build_bvh2(pos, leaf_size=3))
    bounds, child = bounds.copy(), child.copy()
    n, k = (int(x[0]) for x in np.nonzero(child < 0))
    if fault == "twice":
        child[n, (k + 1) % tmbvh.WIDTH] = child[n, k]
    elif fault == "box":
        bounds[n].reshape(6, tmbvh.WIDTH)[3:6, k] = bounds[n].reshape(6, tmbvh.WIDTH)[0:3, k]
    elif fault == "lost":
        child[n, k] = 0
    if fault == "none":
        tmbvh.validate_mbvh(bounds, child, pos, order)
        jmbvh.validate_mbvh(bounds, child, pos, order)
        return
    with pytest.raises(AssertionError):
        jmbvh.validate_mbvh(bounds, child, pos, order)
    with pytest.raises(ValueError):
        tmbvh.validate_mbvh(bounds, child, pos, order)


def test_f2h_matches_canon_f16(native_pair):  # noqa: F811
    """``tests/test_native.py::test_f2h_parity_fuzz``'s inputs: the
    builder's f2h through the port's binding, the port's numpy
    ``_canon_f16`` and the reference's binding agree bit for bit."""
    rng = np.random.default_rng(0xF16)
    bits = rng.integers(0, 2**32, size=1_000_000, dtype=np.uint64).astype(np.uint32)
    edges = np.array([
        0.0, -0.0, 1.0, -1.0, 65504.0, -65504.0, 65519.996, 65520.0, 65536.0, 1e30, -1e30,
        np.inf, -np.inf, np.nan, 6.103515625e-05, 6.0975551605224609e-05,
        5.960464477539063e-08, 2.9802322387695312e-08, 3.0e-08, 1e-20, -1e-20, 2.0**-25,
        2.0**-24], np.float32)
    x = np.concatenate([bits.view(np.float32), edges])
    got = tnative.native_f2h_or_none(x)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # overflow in the cast is the point
        canon = tw16._canon_f16(x.astype(np.float16))
    np.testing.assert_array_equal(got, canon)
    np.testing.assert_array_equal(got, jnative.native_f2h_or_none(x))
    with tnative.disabled():
        assert tnative.native_f2h_or_none(x) is None


def test_quality_ab_on_the_cpu(fresh):
    """``round6_sbvh_ab.ab`` at 16x16: the rows it reports per quality, and
    ``UWPT_COLLAPSE=dp`` turning the reference's loop over 0 and 1 into 2
    and 3."""
    scene, cam = tbench.beam_scene(400)
    fresh.setenv("UWPT_COLLAPSE", "dp")
    res = round6_sbvh_ab.ab(scene, cam, (0, 1), torch.device("cpu"), width=16, height=16,
                            spp=1, te=4, pool=128, reps=1, log=lambda m: None)
    assert [r["quality"] for r in res["rows"]] == [2, 3] and list(res["tables"]) == [2, 3]
    for r in res["rows"]:
        assert r["rays"] > 0 and r["arrivals"] > 0 and r["si_total"] >= r["super_iterations"]
        assert r["k1_launches"] == r["k2_launches"] == 0     # counted on the card only
        assert len(r["times"]) == 1 and r["s_pass"] == r["times"][0]
        assert r["refs"] >= 400 and r["table_mib"] > 0
    assert res["rows"][1]["refs"] > res["rows"][0]["refs"]     # spatial splits
