"""Shared helpers of the tests of the reference's traversal backends in
the port (``test_torch_mbvh_skip.py``, ``test_torch_wide.py``): one scene
built by both packages, the reference's ``SceneData`` as numpy arrays,
seeded ray sets, and a case of deliberate ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_bvh import _random_rays, _random_tris
from tests.test_wide8 import random_rays
from unity_webgpu_pathtracer_torch.accel import native as tnative
from unity_webgpu_pathtracer_torch.config import RenderConfig as TConfig
from unity_webgpu_pathtracer_torch.ops import get_intersectors as tget
from unity_webgpu_pathtracer_torch.scene.mesh import Mesh as TMesh
from unity_webgpu_pathtracer_torch.scene.scene import Scene as TScene
from unity_webgpu_pathtracer_torch.scene.scene import scene_to_numpy
from unity_webgpu_pathtracer_tpu.accel import native as jnative
from unity_webgpu_pathtracer_tpu.config import RenderConfig as JConfig
from unity_webgpu_pathtracer_tpu.ops import get_intersectors as jget
from unity_webgpu_pathtracer_tpu.scene.mesh import Mesh as JMesh
from unity_webgpu_pathtracer_tpu.scene.scene import Scene as JScene

# Every table a backend reads, and the per-triangle tables beside them.
TABLES = ("tris", "tri_index", "bvh_bounds", "bvh_child", "skip_nodes", "wide_nodes",
          "wide2_inner", "wide2_leaf", "wide2_leaf_skip", "wide2_entry", "attr_normals",
          "attr_uvs", "attr_material", "attr_tangents", "attr_shade", "attr_shade_c",
          "attr_shade_o", "materials", "inst_l2w", "inst_w2l", "inst_offsets")
T_TOL = dict(rtol=1e-5, atol=1e-5)
BARY_TOL = dict(rtol=1e-4, atol=1e-4)


def jax_arrays(sd) -> dict:
    """The reference's ``SceneData`` as the numpy dict ``scene_from_numpy``
    reads."""
    out = {f: np.asarray(getattr(sd, f)) for f in sd._fields if f != "env"}
    out["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    return out


def same_tables(got: dict, want: dict, fields=TABLES) -> None:
    for f in fields:
        g, w = np.ascontiguousarray(got[f]), np.ascontiguousarray(want[f])
        assert g.shape == w.shape and g.dtype == w.dtype and g.tobytes() == w.tobytes(), f


def soup_scenes(positions: np.ndarray):
    """One mesh of the (F, 3, 3) triangles in each package."""
    n = positions.shape[0]
    out = []
    for scene_cls, mesh_cls in ((JScene, JMesh), (TScene, TMesh)):
        sc = scene_cls()
        sc.add_mesh(mesh_cls(vertices=positions.reshape(-1, 3),
                             indices=np.arange(3 * n).reshape(n, 3)))
        out.append(sc)
    return out


def built_pair(positions: np.ndarray, traversal: str, octants: int = 1):
    """``(reference SceneData, the port's)`` of a triangle soup, the port's
    tables checked byte for byte against the reference's."""
    jsc, tsc = soup_scenes(positions)
    jsd = jsc.build(traversal, octants=octants)
    tsd = tsc.build(traversal, device="cpu", octants=octants)
    same_tables(scene_to_numpy(tsd), jax_arrays(jsd))
    return jsd, tsd


def ray_sets(ntri: int, nray: int):
    """The reference's ``_random_tris``/``_random_rays`` case of
    ``tests/test_bvh.py`` and, for more hits, as many rays aimed at the
    triangles (``tests/test_wide8.py::random_rays``): ``(positions, o,
    d)``, numpy."""
    pos = _random_tris(ntri, seed=ntri)
    o1, d1 = (np.asarray(x) for x in _random_rays(nray, seed=ntri + 1))
    o2, d2 = random_rays(nray, seed=ntri + 2, spread=12.0, tris=pos)
    return pos, np.concatenate([o1, o2]), np.concatenate([d1, d2])


def tie_case():
    """Six copies each of two overlapping triangles in the plane z = 0 (equal
    boxes in several leaves: equal entry distances and equal hit
    distances) and a cloud above; rays along +-z whose other components
    are -0.0 and 0.0 (-0.0 counts as positive in the octant)."""
    a = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32)
    b = np.array([[0.5, 0.5, 0], [2.5, 0.5, 0], [0.5, 2.5, 0]], np.float32)
    r = np.random.default_rng(5)
    cloud = r.uniform(-6, 6, (40, 1, 3)) + r.normal(0, 0.3, (40, 3, 3)) + [0, 0, 8]
    pos = np.concatenate([np.stack([a] * 6 + [b] * 6), cloud]).astype(np.float32)
    g = np.linspace(0.05, 2.4, 12, dtype=np.float32)
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    n = xy.shape[0]
    up, down = (np.concatenate([xy, np.full((n, 1), z, np.float32)], 1) for z in (5, -5))
    dirs = [np.tile(np.array([v], np.float32), (n, 1))
            for v in ([-0.0, 0.0, -1.0], [0.0, -0.0, 1.0], [-0.0, -0.0, -1.0])]
    return pos, np.concatenate([up, down, up]), np.concatenate(dirs)


def hits_match(jsd, tsd, traversal: str, o: np.ndarray, d: np.ndarray, seed: int = 0,
               eager: bool = False) -> int:
    """Closest hits and occlusion of both packages' backends on the same
    rays: slots, instances and occlusion bits equal to the jitted
    reference's, ``t`` within rtol 1e-5 / atol 1e-5 of it and the
    barycentrics within 1e-4 on >= 99% of lanes (XLA contracts the slab and
    Möller-Trumbore multiply-adds, a grazing hit's barycentric cancels);
    with ``eager``, ``t`` and barycentrics bit for bit against the
    reference evaluated eagerly (``jax.disable_jit``), which rounds each
    product as the port does.  Lanes outside ``live`` come back as misses.
    Returns the hit count."""
    jc, jo = jget(JConfig(traversal=traversal))
    tc, to = tget(TConfig(traversal=traversal, integrator="megakernel"))
    jt, jb, js, ji = jc(jsd, jnp.asarray(o), jnp.asarray(d))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    tt, tb, ts, ti = tc(tsd, ot, dt)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **T_TOL)
    assert np.isclose(tb.numpy(), np.asarray(jb), **BARY_TOL).all(-1).mean() >= 0.99
    if eager:
        with jax.disable_jit():
            et, eb, es, _ei = jc(jsd, jnp.asarray(o), jnp.asarray(d))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(es))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(et))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(eb))
    t_max = np.random.default_rng(seed).uniform(0.5, 20.0, o.shape[0]).astype(np.float32)
    jocc = jo(jsd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    tocc = to(tsd, ot, dt, torch.from_numpy(t_max))
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    live = torch.from_numpy(np.arange(o.shape[0]) % 3 != 0)
    _lt, _lb, ls, _li = tc(tsd, ot, dt, live)
    np.testing.assert_array_equal(ls.numpy()[live.numpy()], np.asarray(js)[live.numpy()])
    assert (ls.numpy()[~live.numpy()] == -1).all()
    return int((np.asarray(js) >= 0).sum())


@pytest.fixture
def numpy_builders(monkeypatch, tmp_path):
    """Both packages' native builders missing (the port's library, the
    reference's bindings of every format), tables cached under
    ``tmp_path``."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    for name in ("native_wide16_or_none", "native_wide8_or_none", "native_build_or_none",
                 "native_linearize_or_none", "native_wide_or_none"):
        monkeypatch.setattr(jnative, name, lambda *a, **k: None)
    monkeypatch.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("UWPT_BVH_CACHE", "0")
    return tmp_path


def reference_tlas_fixed(table: np.ndarray) -> np.ndarray:
    """The reference's joined TLAS + BLAS table with the port's one change:
    the TLAS rows that skip to the TLAS's end (the first BLAS row) skip to
    the table's end instead."""
    t = np.array(table, np.float32)
    rows = t[0]
    kind = rows[:, 45:46].view(np.int32)[:, 0]
    tlas_len = int(rows[kind < 0, 24:25].view(np.int32).min())
    skips = rows[:tlas_len, 44:45].view(np.int32)
    skips[skips == tlas_len] = rows.shape[0]
    return t


def reference_instanced_fixed(jsd, traversal: str):
    """The reference's instanced ``SceneData`` on ``reference_tlas_fixed``
    tables (split again for wide2 by the reference's ``split_wide``)."""
    from unity_webgpu_pathtracer_tpu.accel.wide2 import split_wide

    fixed = reference_tlas_fixed(np.asarray(jsd.wide_nodes))
    out = jsd._replace(wide_nodes=jnp.asarray(fixed))
    if traversal == "wide2":
        w2 = split_wide(fixed)
        assert w2.inner.shape[1] > 0
        out = out._replace(wide2_inner=jnp.asarray(w2.inner), wide2_leaf=jnp.asarray(w2.leaf_geo),
                           wide2_leaf_skip=jnp.asarray(w2.leaf_skip))
    return out
