"""The port's two-level (TLAS) wide16 scenes against the reference: the
instanced tables and their transform-only refresh byte for byte, kernel
K1's instanced twin against the reference's Pallas arrival in interpret
mode, whole instanced passes against the reference's fused pass (at 48x48
and at the golden configuration), the instanced render against the same
scene flattened, and ``Renderer.update_instance_transform``.

The reference's two-level wide16 build is ``Scene._build_instanced_wide16``
(``_build_instanced_quant("wide16")``); its ``Scene.build("wide16")``
does not reach it for instanced scenes (it builds the 4-wide "wide" tables
and leaves a one-row placeholder wide16 table), so the tests call it
directly.  The same slip makes the committed ``tlas`` golden an image of
the sky alone, which no render of the instances can match; the golden
configuration is held instead against the reference's two-level pass and
the flattened scene.

Tolerances: tables and TLAS refreshes byte-identical.  Instanced
arrivals: every integer register equal after 1, 8 and 40 arrivals; float
registers within rtol 1e-5 / atol 1e-5 (FMA contraction in XLA moves an
ulp).  Whole pass: the ``tests/test_torch_fused.py`` contract (rays and
arrivals within 0.5%, film mean within 1%, >= 99% of pixels within rtol
1e-4).  Instanced vs flattened: the ``tests/test_tlas.py`` statistic on
8x8-pixel tiles, mean |difference| / (flat + 0.05) below 5%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_native import native_pair  # noqa: F401  (fixture)
from tests import golden_common
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.accel import wide16 as tw16
from unity_webgpu_pathtracer_torch.api import Renderer as TRenderer
from unity_webgpu_pathtracer_torch.models import examples as texamples
from unity_webgpu_pathtracer_torch.models import primitives as tprim
from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as ttw
from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_step16_cuda
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params as tcamera
from unity_webgpu_pathtracer_torch.scene.scene import rebuild_tlas_rows, scene_from_numpy
from unity_webgpu_pathtracer_torch.utils.math import safe_rcp
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.accel import wide16 as jw16
from unity_webgpu_pathtracer_tpu.models import examples as jexamples
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as jtw
from unity_webgpu_pathtracer_tpu.ops.pallas_arrival import arrival_step16_pallas
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params as jcamera
from unity_webgpu_pathtracer_tpu.scene import scene as jscene
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE

torch.set_num_threads(2)

_pallas_step = jax.jit(arrival_step16_pallas, static_argnames=("interpret", "has_instances"))

TABLE_FIELDS = ("wide16_nodes", "wide16_top", "attr_shade_c", "materials",
                "inst_l2w", "inst_w2l", "inst_offsets")
INT_FIELDS = ("ptr", "pend", "sp", "tri", "found", "inst", "hit_inst", "sp_enter",
              "stack_row", "stack_mask")
PLANE_FIELDS = ("local_o", "local_d", "local_inv")   # (B, 3) in JAX, (3, B) here


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _same_bytes(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, name
    assert a.tobytes() == b.tobytes(), name


def _jax_arrays(sd) -> dict:
    """A JAX ``SceneData`` as the numpy dict ``scene_from_numpy`` reads."""
    out = {f: np.asarray(getattr(sd, f)) for f in TABLE_FIELDS + ("stack_levels",)}
    out["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    return out


def _two_instance_fixture(pkg):
    """Two instances of one 300-triangle mesh, the second scaled and moved
    (the reference's ``tests/test_pallas_arrival.py`` TLAS fixture), built
    with ``pkg``'s wide16 module."""
    rng = np.random.default_rng(9)
    c = rng.uniform(-1.0, 1.0, (300, 1, 3))
    tris = (c + rng.uniform(-0.3, 0.3, (300, 3, 3))).astype(np.float32)
    recs = np.concatenate([tris[:, 2] - tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 0]],
                          axis=1).astype(np.float32)
    p = tris.reshape(-1, 3)
    t2 = np.eye(4, dtype=np.float32)
    t2[:3, 3] = (3.0, 0.5, -1.0)
    t2[0, 0] = 2.0
    return pkg.build_tlas_wide16([pkg.build_scene_wide16(tris, recs)], [(p.min(0), p.max(0))],
                                 [(0, np.eye(4, dtype=np.float32), None), (0, t2, None)], [0])


def test_tlas_scene_tables_byte_identical(native_pair):  # noqa: F811
    want = _jax_arrays(jexamples.tlas_scene(n=4)[0]._build_instanced_wide16())
    got = texamples.tlas_scene(n=4)[0].build_arrays()
    for f in TABLE_FIELDS:
        _same_bytes(got[f], want[f], f)
    assert got["stack_levels"].shape == want["stack_levels"].shape
    for f in want["env"]:
        _same_bytes(got["env"][f], want["env"][f], f"env.{f}")


def test_two_instance_fixture_byte_identical(native_pair):  # noqa: F811
    (jw, jl2w, jw2l, jlayout), (tw, tl2w, tw2l, tlayout) = (
        _two_instance_fixture(jw16), _two_instance_fixture(tw16))
    _same_bytes(tw.nodes, jw.nodes, "nodes")
    _same_bytes(tl2w, jl2w, "l2w")
    _same_bytes(tw2l, jw2l, "w2l")
    assert tw.depth == jw.depth
    assert dataclasses.asdict(tlayout) == dataclasses.asdict(jlayout)


def test_rebuild_tlas_rows_byte_identical(native_pair):  # noqa: F811
    """The transform-only refresh after ``set_instance_transform``."""
    move = tprim.transform_trs(translate=(0.3, 2.1, -0.4), rotate_y=0.5, scale=1.2)
    js = jexamples.tlas_scene(n=4)[0]
    js._build_instanced_wide16()
    js.set_instance_transform(2, move)
    ts = texamples.tlas_scene(n=4)[0]
    ts.build_arrays()
    ts.set_instance_transform(2, move)
    for got, want, name in zip(rebuild_tlas_rows(ts), jscene.rebuild_tlas_rows(js, "wide16"),
                               ("rows", "l2w", "w2l")):
        _same_bytes(got, want, name)


def _rays(b, seed):
    """Free rays, half of them aimed into one of the two instances."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4.0, 4.0, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    centre = np.where(rng.random((b, 1)) < 0.5, 0.0, np.float32([3.0, 0.5, -1.0]))
    aim = centre + rng.uniform(-0.8, 0.8, (b, 3)) - o
    d[: b // 2] = aim[: b // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("steps", [1, 8, 40])
def test_instanced_arrivals_match_pallas(steps):
    w, _l2w, _w2l, _layout = _two_instance_fixture(jw16)
    b = 2048
    o, d = _rays(b, seed=31)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jinv = 1.0 / jnp.where(jd == 0.0, 1e-30, jd)
    js = jtw.init_state16(b, jnp.float32(FAR_PLANE), depth=w.depth + 2)
    ts = ttw.init_state16(b, FAR_PLANE, depth=w.depth + 2, device="cpu")
    tnodes = torch.from_numpy(w.nodes)
    to, td = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    tinv = safe_rcp(td)
    jn = jnp.asarray(w.nodes)
    for _ in range(steps):
        js = _pallas_step(jn, jo.T, jd.T, jinv.T, js, None, interpret=True,
                          has_instances=True)
        ts = arrival_step16_cuda(tnodes, to, td, tinv, ts, has_instances=True)
    # The instanced registers are exercised: lanes inside a BLAS (after the
    # entry arrival) and hits recorded with their instance.
    assert (ts.ptr.numpy() >= 0).any()
    if steps > 1:
        assert (ts.inst.numpy() >= 0).any() or (ts.hit_inst.numpy() >= 0).any()
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name in PLANE_FIELDS:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)).T,
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ---- whole passes ----

W = H = 48
SLICE = dict(width=W, height=H, samples_per_pass=2, max_bounces=4, pool_size=1024,
             transition_every=4)


@pytest.fixture(scope="module")
def tlas_both():
    scene, cam, overrides = jexamples.tlas_scene(n=4)
    sd = scene._build_instanced_wide16()
    params = jcamera(width=W, height=H, **cam)
    jcfg = jconfig.RenderConfig(traversal="wide16", integrator="fused", attr_compact=2,
                                use_pallas_arrival=True, use_pallas_transition=True,
                                sky_mode=overrides["sky_mode"], **SLICE)
    tparams = tcamera(width=W, height=H, **cam, device="cpu")
    return sd, params, jcfg, scene_from_numpy(_jax_arrays(sd), device="cpu"), tparams, \
        tconfig.RenderConfig(sky_mode=overrides["sky_mode"], **SLICE)


def _film_close(got, want):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    print(f"pixels diverged beyond rtol 1e-4: {int((~close).sum())} of {close.size}")
    assert close.mean() >= 0.99
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


def test_instanced_pass_matches_reference(tlas_both):
    sd, params, jcfg, tsd, tparams, tcfg = tlas_both
    step = jax.jit(jfused.fused_pass_with_stats, static_argnums=(1,))
    jfilm, jocc, jrays, jarr = step(sd, jcfg, params, 0)
    tfilm, tocc, trays, tarr, iters = tfused.fused_pass_with_stats(tsd, tcfg, tparams, 0)
    print(f"rays port {int(trays)} reference {int(jrays)}; arrivals port {int(tarr)} "
          f"reference {int(jarr)}; super-iterations {iters}")
    assert abs(int(trays) - int(jrays)) <= 0.005 * int(jrays)
    assert abs(int(tarr) - int(jarr)) <= 0.005 * int(jarr)
    assert abs(float(tocc) - float(jocc)) <= 0.005
    _film_close(tfilm.numpy(), np.asarray(jfilm))


def _flattened(scene):
    """``scene`` with every instance baked into world space as a mesh with
    the instance's material."""
    from unity_webgpu_pathtracer_torch.scene.mesh import Mesh
    from unity_webgpu_pathtracer_torch.scene.scene import Scene

    flat = Scene(materials=list(scene.materials), env_image=scene.env_image)
    for mesh_id, xf, mat in scene.instances:
        m = scene.meshes[mesh_id][0]
        flat.add_mesh(Mesh(vertices=m.vertices, indices=m.indices, normals=m.normals,
                           uvs=m.uvs, material_index=m.material_index if mat is None else mat),
                      xf)
    return flat


GOLDEN = dict(width=golden_common.SIZE, height=golden_common.SIZE,
              samples_per_pass=golden_common.SPP, max_bounces=4, pool_size=4096,
              use_firefly_filter=True)


def _golden_params(camera, cam, **device):
    return camera(width=golden_common.SIZE, height=golden_common.SIZE, **cam,
                  seed_root=np.uint32(golden_common.TEST_SEED_BASE),
                  max_firefly_luminance=np.float32(2.0), **device)


@pytest.fixture(scope="module")
def tlas_golden_port():
    """The port's ``tlas`` pass at the golden configuration (64x64, 32 spp,
    4 bounces, pool 4096, firefly clamp at luminance 2, the golden test
    seed): the scene, its camera, the config and the pass's outputs."""
    scene, cam, overrides = texamples.tlas_scene()
    cfg = tconfig.RenderConfig(**GOLDEN, **overrides)
    return scene, cam, cfg, tfused.fused_pass_with_stats(
        scene.build(device="cpu"), cfg, _golden_params(tcamera, cam, device="cpu"), 0)


def test_tlas_matches_reference_at_golden_config(tlas_golden_port):
    """The same pass against the reference's fused pass on its two-level
    build (``Scene._build_instanced_wide16``), under the whole-pass
    contract."""
    *_, (tfilm, tocc, trays, tarr, _iters) = tlas_golden_port
    scene, cam, overrides = jexamples.tlas_scene()
    jcfg = jconfig.RenderConfig(traversal="wide16", integrator="fused", attr_compact=2,
                                sky_mode=overrides["sky_mode"], **GOLDEN)
    step = jax.jit(jfused.fused_pass_with_stats, static_argnums=(1,))
    jfilm, jocc, jrays, jarr = step(scene._build_instanced_wide16(), jcfg,
                                    _golden_params(jcamera, cam), 0)
    print(f"rays port {int(trays)} reference {int(jrays)}; arrivals port {int(tarr)} "
          f"reference {int(jarr)}")
    assert abs(int(trays) - int(jrays)) <= 0.005 * int(jrays)
    assert abs(int(tarr) - int(jarr)) <= 0.005 * int(jarr)
    assert abs(float(tocc) - float(jocc)) <= 0.005
    _film_close(tfilm.numpy(), np.asarray(jfilm))


def test_tlas_matches_flattened_at_golden_config(tlas_golden_port):
    """The same pass against the same scene baked flat."""
    scene, cam, cfg, (film, *_) = tlas_golden_port
    size, spp = golden_common.SIZE, golden_common.SPP
    flat = tfused.fused_pass_with_stats(_flattened(scene).build(device="cpu"), cfg,
                                        _golden_params(tcamera, cam, device="cpu"), 0)[0]
    films = [f.numpy().reshape(size, size, 3) / spp for f in (film, flat)]
    k = 8
    a, b = (f.reshape(size // k, k, size // k, k, 3).mean((1, 3)) for f in films)
    rel = float((np.abs(a - b) / (b + 0.05)).mean())
    print(f"tile statistic {rel:.4f}; means {films[0].mean():.5f} {films[1].mean():.5f}")
    assert np.isfinite(films[0]).all() and rel < 0.05


# ---- dynamic instances ----

def test_update_instance_transform_moves_object():
    size = 32
    scene, cam, overrides = texamples.tlas_scene(n=3, phase=0.0)
    cfg = tconfig.RenderConfig(width=size, height=size, samples_per_pass=8, max_bounces=2,
                               pool_size=1024, **overrides)
    r = TRenderer(scene, cfg, tcamera(width=size, height=size, **cam, device="cpu"),
                  device="cpu")
    r.render(1)
    before = r.radiance().copy()
    # Move the middle sphere up by 1.5 (Bounce.cs analogue).
    r.update_instance_transform(1, tprim.transform_trs(translate=(1 - 1.5, 2.0, 0)))
    assert r.sample_count == 0 and r.stats() == {}
    r.render(1)
    assert np.abs(r.radiance() - before).max() > 0.05


def test_tlas_only_update_matches_full_rebuild():
    """The in-place TLAS refresh equals a from-scratch build; BLAS rows
    untouched."""
    scene, cam, overrides = texamples.tlas_scene(n=5)
    cfg = tconfig.RenderConfig(width=8, height=8, **overrides)
    r = TRenderer(scene, cfg, tcamera(width=8, height=8, **cam, device="cpu"), device="cpu")
    before = r.scene.wide16_nodes.clone()
    r.update_instance_transform(2, tprim.transform_trs(translate=(0.0, 1.5, 0.5)))
    cap = tw16.tlas_capacity(len(scene.instances))
    scene._blas16_cache = scene._tlas16_layout = None
    full = scene.build_arrays()
    _same_bytes(r.scene.wide16_nodes.numpy(), full["wide16_nodes"], "nodes")
    _same_bytes(r.scene.inst_l2w.numpy(), full["inst_l2w"], "l2w")
    _same_bytes(r.scene.inst_w2l.numpy(), full["inst_w2l"], "w2l")
    # Compared as bits: integer words may read as NaN floats.
    after = r.scene.wide16_nodes.view(torch.int32)
    assert torch.equal(after[cap:], before.view(torch.int32)[cap:])
    assert not torch.equal(after[:cap], before.view(torch.int32)[:cap])
