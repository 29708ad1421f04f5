"""The port's host builders without the native library, and its CWBVH
exporter, against the reference's, on the CPU.

* ``accel/cwbvh.py``: ``build_cwbvh_from_positions`` byte-identical to the
  reference's (nodes, records and order), ``validate_cwbvh`` holds, and
  the reference's format checks (``tests/test_features.py``) pass.
* ``accel/wide16.py::build_wide16``: with both packages' native builders
  disabled, ``build_scene_wide16`` emits the reference's numpy table byte
  for byte, 96-float rows and leaf8; it warns, counts the build and stores
  the table in the cache under the reference's numpy key, which the
  native build never loads.
* ``accel/wide8.py``: the native and the numpy wide8 tables equal the
  reference's byte for byte and validate.
"""

import numpy as np
import pytest

from tests.test_wide8 import random_tris, recs_of
from unity_webgpu_pathtracer_torch.accel import bvh2 as tbvh2
from unity_webgpu_pathtracer_torch.accel import cwbvh as tcw
from unity_webgpu_pathtracer_torch.accel import mbvh as tmbvh
from unity_webgpu_pathtracer_torch.accel import native as tnative
from unity_webgpu_pathtracer_torch.accel import wide8 as tw8
from unity_webgpu_pathtracer_torch.accel import wide16 as tw16
from unity_webgpu_pathtracer_tpu.accel import cwbvh as jcw
from unity_webgpu_pathtracer_tpu.accel import native as jnative
from unity_webgpu_pathtracer_tpu.accel import wide8 as jw8
from unity_webgpu_pathtracer_tpu.accel import wide16 as jw16


@pytest.fixture
def no_native(monkeypatch, tmp_path):
    """Both packages' native builders missing, the tables cached under
    ``tmp_path`` (the reference's cache off)."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "native_wide16_or_none", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "native_wide8_or_none", lambda *a, **k: None)
    monkeypatch.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("UWPT_BVH_CACHE", "0")
    return tmp_path


def _same(a: np.ndarray, b: np.ndarray) -> None:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def _soup(n, seed):
    r = np.random.default_rng(seed)
    return (r.uniform(-10, 10, (n, 1, 3)) + r.normal(0, 0.5, (n, 3, 3))).astype(np.float32)


@pytest.mark.parametrize("n", [1, 40, 300])
def test_cwbvh_from_positions_byte_identical(n):
    pos = _soup(n, n)
    got, want = tcw.build_cwbvh_from_positions(pos), jcw.build_cwbvh_from_positions(pos)
    for g, w in zip(got, want):
        _same(g, w)
    bounds, child, _order = tmbvh.collapse_to_mbvh8(tbvh2.build_bvh2(pos, leaf_size=3))
    nodes, _tri_order = tcw.build_cwbvh(bounds, child)
    tcw.validate_cwbvh(nodes, bounds, child)


def test_cwbvh_parity_format():
    pos = _soup(300, 0)
    bounds, child, _order = tmbvh.collapse_to_mbvh8(tbvh2.build_bvh2(pos, leaf_size=3))
    nodes, tri_order = tcw.build_cwbvh(bounds, child)
    assert nodes.shape[1] == 20
    assert sorted(tri_order.tolist()) == list(range(300))
    iview = nodes.view(np.uint32)
    meta = np.stack([iview[:, 6], iview[:, 7]], -1).view(np.uint8).reshape(-1, 8)
    inner = (meta & 0b11111) >= 24
    assert ((meta[~inner] & 0b11111) <= 24).all()
    _nodes2, recs, final_order = tcw.build_cwbvh_from_positions(pos)
    assert recs.shape == (300, 12)
    np.testing.assert_array_equal(recs[:, 11].view(np.int32), final_order)
    lo, hi = tcw.decode_child_bounds(nodes)
    assert lo.shape == hi.shape == (nodes.shape[0], 3, 8)
    bad = nodes.copy()
    bad[0, 0:3] += 1.0        # shift a node's origin: its boxes no longer contain
    with pytest.raises(ValueError, match="not conservative"):
        tcw.validate_cwbvh(bad, bounds, child)


@pytest.mark.parametrize("leaf8", [False, True])
def test_wide16_numpy_build_byte_identical(no_native, leaf8):
    tris = random_tris(600, seed=5)
    recs = recs_of(tris)
    want = jw16.build_scene_wide16(tris, recs, leaf8=leaf8)
    misses, numpy_builds = tw16.CACHE_STATS["miss"], tw16.CACHE_STATS["numpy"]
    with pytest.warns(UserWarning, match="native BVH builder is unavailable"):
        got = tw16.build_scene_wide16(tris, recs, leaf8)
    assert tw16.CACHE_STATS["numpy"] == numpy_builds + 1
    assert tw16.CACHE_STATS["miss"] == misses + 1
    _same(got.nodes, want.nodes)
    _same(got.order, np.asarray(want.order, np.int32))
    assert got.depth == want.depth
    tw16.validate_wide16(got, 600)
    # The table went to the cache: the next build loads it.
    again = tw16.build_scene_wide16(tris, recs, leaf8)
    assert tw16.CACHE_STATS["numpy"] == numpy_builds + 1
    _same(again.nodes, got.nodes)


@pytest.mark.parametrize("native_built", [True, False], ids=["native", "numpy"])
def test_cache_key_is_the_reference_key(monkeypatch, tmp_path, native_built):
    """Each builder's key is the reference's: the builder's source, or
    ``numpy-fallback`` where the library is missing."""
    monkeypatch.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jnative, "_LIB_PATH", __file__ if native_built
                        else str(tmp_path / "missing.so"))
    tris = random_tris(100, seed=3)
    recs = recs_of(tris)
    want = jw16._bvh_cache_path(tris, recs, tw16.LEAF_SIZE, tw16.QUALITY, False)
    got = tw16.bvh_cache_path(tris, recs, False, native_built)
    assert got == want


def test_numpy_table_is_not_a_hit_for_the_native_builder(monkeypatch, tmp_path):
    """A table the numpy builder cached is not loaded once the library is
    back: the native build misses, builds its own table and caches it
    under its own key; each key then hits with its own table."""
    monkeypatch.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path))
    tris = random_tris(400, seed=11)
    recs = recs_of(tris)
    with tnative.disabled(), pytest.warns(UserWarning, match="native BVH builder"):
        from_numpy = tw16.build_scene_wide16(tris, recs, False)
    stats = dict(tw16.CACHE_STATS)
    from_native = tw16.build_scene_wide16(tris, recs, False)
    assert tw16.CACHE_STATS == dict(stats, miss=stats["miss"] + 1)
    rows, depth, order = tnative.native_wide16(tris, recs, tw16.LEAF_SIZE, tw16.QUALITY)
    _same(from_native.nodes, rows)
    _same(from_native.order, order)
    assert from_native.depth == depth
    assert from_native.nodes.tobytes() != from_numpy.nodes.tobytes()
    assert len(list(tmp_path.iterdir())) == 2
    with tnative.disabled():
        _same(tw16.build_scene_wide16(tris, recs, False).nodes, from_numpy.nodes)
    _same(tw16.build_scene_wide16(tris, recs, False).nodes, from_native.nodes)
    assert tw16.CACHE_STATS["hit"] == stats["hit"] + 2


def test_native_disabled_block():
    """``native.disabled()`` makes the library count as missing inside the
    block only."""
    tris = random_tris(50, seed=2)
    with tnative.disabled():
        assert tnative.native_wide16(tris, recs_of(tris), 4, 1) is None
        assert tnative.native_wide8_or_none(tris, recs_of(tris)) is None
    assert tnative.native_wide16(tris, recs_of(tris), 4, 1) is not None


@pytest.mark.parametrize("n", [12, 300, 4000])
def test_wide8_build_byte_identical(n):
    tris = random_tris(n, seed=n)
    recs = recs_of(tris)
    got, want = tw8.build_scene_wide8(tris, recs), jw8.build_scene_wide8(tris, recs)
    _same(got.nodes, want.nodes)
    _same(got.order, want.order)
    assert got.depth == want.depth
    tw8.validate_wide8(got, n)


def test_wide8_numpy_build_byte_identical(no_native):
    tris = random_tris(300, seed=8)
    recs = recs_of(tris)
    got, want = tw8.build_scene_wide8(tris, recs), jw8.build_scene_wide8(tris, recs)
    _same(got.nodes, want.nodes)
    _same(got.order, want.order)
    tw8.validate_wide8(got, 300)
