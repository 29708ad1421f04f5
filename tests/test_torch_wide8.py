"""The port's wide8 cross-check backend (``accel/wide8.py``,
``ops/traverse_wide8.py``, ``Scene.build("wide8")``) against the
reference's, on the CPU.

Contract: tables byte-identical (flat and two-level, and after a TLAS-only
update); ``closest_hit`` ids and instances bit-exact on seeded rays, t
within rtol 1e-5 / atol 1e-5 (the ulps the wide16 twin is held to:
XLA contracts the slab and Möller-Trumbore multiply-adds), ``occluded``
equal; the reference's checks against the brute-force oracle
(``tests/test_wide8.py``) pass on the port.  The three integrators run on
wide8: the fused pass gives the reference's rays and arrivals and its film
(>= 99% of pixels within rtol 1e-4, mean within 1%); the megakernel and
the wavefront their films within 1e-5.  As the reference's
``test_wide16_fused_film_matches_wide8``, the port's fused films on wide8
and wide16 agree statistically, and the port's two-level wide16 render of
an instanced scene is held to the reference's wide8 render of it (the
reference's own wide16 build ignores instancing).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_native import native_pair  # noqa: F401  (fixture)
from tests.test_wide8 import random_rays, random_tris, recs_of
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.accel import wide8 as tw8a
from unity_webgpu_pathtracer_torch.api import Renderer as TRenderer
from unity_webgpu_pathtracer_torch.models import examples as texamples
from unity_webgpu_pathtracer_torch.models import primitives as tprim
from unity_webgpu_pathtracer_torch.ops import intersect as tbf
from unity_webgpu_pathtracer_torch.ops import traverse_wide8 as tw8
from unity_webgpu_pathtracer_torch.render import camera as tcamera
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.scene import scene as tscene
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc as TMaterialDesc
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.api import Renderer as JRenderer
from unity_webgpu_pathtracer_tpu.models import examples as jexamples
from unity_webgpu_pathtracer_tpu.models import primitives as jprim
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
from unity_webgpu_pathtracer_tpu.ops import traverse_wide8 as jtw8
from unity_webgpu_pathtracer_tpu.render import camera as jcamera
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.scene.material import MaterialDesc as JMaterialDesc
from unity_webgpu_pathtracer_tpu.scene.scene import Scene as JScene
from unity_webgpu_pathtracer_tpu.scene.scene import rebuild_tlas_rows as jrebuild_tlas_rows

torch.set_num_threads(2)

FIELDS = ("wide8_nodes", "stack_levels", "attr_shade", "attr_shade_c", "attr_shade_o",
          "materials", "inst_l2w", "inst_w2l", "inst_offsets", "tris", "tri_index",
          "attr_normals", "attr_uvs", "attr_material", "attr_tangents")
T_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _arrays(sd) -> dict:
    out = {f: np.asarray(getattr(sd, f)) for f in FIELDS}
    out["wide16_nodes"] = np.zeros((1, 96), np.float32)
    out["wide16_top"] = np.zeros((1, 119), np.float32)
    out["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    return out


def _same_tables(got: dict, want: dict):
    for f in FIELDS:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if f == "stack_levels":
            assert g.shape == w.shape
            continue
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), f


class _JaxTables:
    def __init__(self, nodes, depth):
        self.wide8_nodes = jnp.asarray(nodes)
        self.inst_w2l = jnp.zeros((0, 12), jnp.float32)
        self.stack_levels = jnp.zeros((depth + 1,), jnp.int32)


@pytest.mark.parametrize("n", [300, 4000])
def test_wide8_hits_match_reference(n):
    tris = random_tris(n, seed=n + 7)
    w = tw8a.build_scene_wide8(tris, recs_of(tris))
    o, d = random_rays(1024, seed=n, tris=tris)
    jt, jb, jtri, jinst = jtw8.closest_hit(_JaxTables(w.nodes, w.depth), o, d)
    nodes, ot, dt = (torch.from_numpy(np.array(x)) for x in (w.nodes, o, d))
    tt, tb, ttri, tinst = tw8.closest_hit(nodes, ot, dt, w.depth + 1)
    np.testing.assert_array_equal(ttri.numpy(), np.asarray(jtri))
    np.testing.assert_array_equal(tinst.numpy(), np.asarray(jinst))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **T_TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)
    t_max = np.random.default_rng(n).uniform(0.5, 20.0, 1024).astype(np.float32)
    jocc = jtw8.occluded(_JaxTables(w.nodes, w.depth), o, d, jnp.asarray(t_max))
    tocc = tw8.occluded(nodes, ot, dt, torch.from_numpy(t_max), w.depth + 1)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))


@pytest.mark.parametrize("n,thresh", [(12, 0.99), (300, 0.995), (4000, 0.995)])
def test_wide8_matches_bruteforce(n, thresh):
    tris = random_tris(n, seed=n + 7)
    recs = recs_of(tris)
    w = tw8a.build_scene_wide8(tris, recs)
    o, d = random_rays(512, seed=n, tris=tris)
    o, d = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    t8, _b8, slot8, _ = tw8.closest_hit(torch.from_numpy(w.nodes), o, d, w.depth + 1)
    tb, _bb, slotb, _ = tbf.closest_hit_bruteforce(torch.from_numpy(recs[w.order]), o, d)
    slot8, slotb = slot8.numpy(), slotb.numpy()
    hit8, hitb = slot8 >= 0, slotb >= 0
    same = (hit8 == hitb) & (~hitb | (slot8 == slotb))
    assert same.mean() >= thresh, f"only {same.mean():.4f} agree"
    both = hit8 & hitb & same
    assert both.any()
    rel = np.abs(t8.numpy()[both] - tb.numpy()[both]) / np.maximum(tb.numpy()[both], 1e-3)
    assert np.quantile(rel, 0.99) < 5e-3


def test_wide8_occluded_matches():
    tris = random_tris(800, seed=3)
    recs = recs_of(tris)
    w = tw8a.build_scene_wide8(tris, recs)
    o, d = random_rays(512, seed=4, tris=tris)
    o, d = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    _tb, _, slotb, _ = tbf.closest_hit_bruteforce(torch.from_numpy(recs[w.order]), o, d)
    occ = tw8.occluded(torch.from_numpy(w.nodes), o, d, torch.full((512,), 1e5), w.depth + 1)
    assert (occ.numpy() == (slotb.numpy() >= 0)).mean() >= 0.995


def _tlas_pair(n=5):
    """The reference's TLAS-only-update scene in both packages."""
    out = []
    for prim, scene_cls, desc in ((jprim, JScene, JMaterialDesc),
                                  (tprim, tscene.Scene, TMaterialDesc)):
        scene = scene_cls()
        m = scene.add_material(desc(base_color=(0.7, 0.3, 0.2, 1.0)))
        mesh = scene.add_mesh(prim.uv_sphere(radius=0.4, stacks=8, slices=12, material_index=m))
        for i in range(n):
            scene.add_instance(mesh, prim.transform_trs(translate=(i * 1.2, 0, 0)))
        out.append(scene)
    return out


def test_wide8_instanced_tables_byte_identical(native_pair):  # noqa: F811
    jsc, tsc = _tlas_pair()
    _same_tables(tscene.scene_to_numpy(tsc.build("wide8", device="cpu")),
                 _arrays(jsc.build("wide8")))


def test_wide8_tlas_only_update_matches_full_rebuild(native_pair):  # noqa: F811
    """A transform-only update rewrites only the TLAS rows, in place on the
    device table (``Renderer.update_instance_transform``): the result
    equals a rebuild from scratch and the reference's rows."""
    jsc, tsc = _tlas_pair()
    cap = tw8a.tlas_capacity(5)
    cfg = tconfig.RenderConfig(width=8, height=8, traversal="wide8", integrator="megakernel",
                               sky_mode=tconfig.SKY_MODE_BASIC, has_environment_texture=False)
    params = tcamera.make_camera_params(eye=(2.4, 1.0, 6.0), target=(2.4, 0.0, 0.0),
                                        fov_y_deg=45.0, width=8, height=8, device="cpu")
    r = TRenderer(tsc, cfg, params, device="cpu")
    before = r.scene.wide8_nodes.clone()
    move = tprim.transform_trs(translate=(2.4, 1.5, 0))
    r.update_instance_transform(2, move)
    updated = r.scene.wide8_nodes.numpy()
    np.testing.assert_array_equal(updated[cap:], before.numpy()[cap:])
    tsc._blas8_cache = tsc._tlas8_layout = None
    full = tsc.build_arrays(traversal="wide8")
    np.testing.assert_array_equal(updated, full["wide8_nodes"])
    np.testing.assert_array_equal(r.scene.inst_l2w.numpy(), full["inst_l2w"])
    np.testing.assert_array_equal(r.scene.inst_w2l.numpy(), full["inst_w2l"])
    jsc.build("wide8")
    jsc.set_instance_transform(2, move)
    rows, _l2w, _w2l = jrebuild_tlas_rows(jsc)
    assert rows.tobytes() == updated[:cap].tobytes()


@pytest.fixture(scope="module")
def cornell8():
    scene, cam = cornell_box()
    sd = scene.build("wide8")
    size = 24
    jparams = jcamera.make_camera_params(width=size, height=size, **cam)
    tparams = tcamera.make_camera_params(width=size, height=size, device="cpu", **cam)
    common = dict(width=size, height=size, samples_per_pass=4, max_bounces=3, sky_mode=2,
                  traversal="wide8", pool_size=512)
    return sd, tscene.scene_from_numpy(_arrays(sd), device="cpu"), jparams, tparams, common


def test_wide8_fused_pass_matches_reference(cornell8):
    sd, tsd, jparams, tparams, common = cornell8
    jcfg = jconfig.RenderConfig(integrator="fused", **common)
    tcfg = tconfig.RenderConfig(integrator="fused", has_environment_texture=False, **common)
    jfilm, _jocc, jrays, jarr = jax.jit(jfused.fused_pass_with_stats, static_argnums=(1,))(
        sd, jcfg, jparams, 0)
    tfilm, _tocc, trays, tarr, _iters = tfused.fused_pass_with_stats(tsd, tcfg, tparams, 0)
    assert int(trays) == int(jrays) and int(tarr) == int(jarr)
    got, want = tfilm.numpy(), np.asarray(jfilm)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


@pytest.mark.parametrize("integrator", ["megakernel", "wavefront"])
def test_wide8_integrator_film_matches_reference(cornell8, integrator):
    sd, tsd, jparams, tparams, common = cornell8
    jr = JRenderer(sd, jconfig.RenderConfig(integrator=integrator, **common), jparams,
                   compile_cache=False)
    tr = TRenderer(tsd, tconfig.RenderConfig(integrator=integrator,
                                             has_environment_texture=False, **common),
                   tparams, device="cpu")
    jr.render(1)
    tr.render(1)
    np.testing.assert_allclose(tr.radiance(), np.asarray(jr.radiance()), rtol=0, atol=1e-5)


def test_wide16_fused_film_matches_wide8():
    """The reference's statistical check on the port: the fused films on
    wide8 and wide16 of Cornell at 64x64, 16 spp agree (means within 2%,
    >90% of pixels within rtol 0.25 / atol 0.05)."""
    from unity_webgpu_pathtracer_torch.models.cornell import cornell_box as tcornell

    size = 64
    scene, cam = tcornell()
    params = tcamera.make_camera_params(width=size, height=size, device="cpu", **cam)
    films = {}
    for trav in ("wide8", "wide16"):
        cfg = tconfig.RenderConfig(width=size, height=size, samples_per_pass=16, max_bounces=3,
                                   traversal=trav, sky_mode=2, pool_size=4096,
                                   has_environment_texture=False)
        film, *_ = tfused.fused_pass_with_stats(scene.build(trav, device="cpu"), cfg, params, 0)
        films[trav] = film.numpy().reshape(size, size, 3) / 16.0
        assert np.isfinite(films[trav]).all()
    a, b = films["wide8"], films["wide16"]
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 0.02
    assert np.isclose(a, b, rtol=0.25, atol=0.05).all(axis=-1).mean() > 0.90


def test_two_level_wide16_matches_reference_wide8_render():
    """An instanced scene: the port's two-level wide16 megakernel render
    against the reference's wide8 render (its wide16 sees only the sky).
    Both trace f16 leaves, anchored differently, so the hits differ only at
    silhouettes: means within 2%, >= 95% of pixels within rtol 0.05 /
    atol 0.02."""
    size, spp = 32, 4
    jscene, cam, over = jexamples.tlas_scene(n=4)
    tscene_, _cam, _over = texamples.tlas_scene(n=4)
    common = dict(width=size, height=size, samples_per_pass=spp, max_bounces=3,
                  sky_mode=over["sky_mode"], integrator="megakernel")
    jr = JRenderer(jscene, jconfig.RenderConfig(traversal="wide8", **common),
                   jcamera.make_camera_params(width=size, height=size, **cam),
                   compile_cache=False)
    jr.render(1)
    tr = TRenderer(tscene_, tconfig.RenderConfig(traversal="wide16",
                                                 has_environment_texture=False, **common),
                   tcamera.make_camera_params(width=size, height=size, device="cpu", **cam),
                   device="cpu")
    tr.render(1)
    a, b = tr.radiance(), np.asarray(jr.radiance())
    assert a.std() > 0
    assert abs(a.mean() - b.mean()) / max(b.mean(), 1e-6) < 0.02
    assert np.isclose(a, b, rtol=0.05, atol=0.02).all(-1).mean() >= 0.95


def test_wide8_config_and_cli():
    cfg = tconfig.RenderConfig(traversal="wide8")
    assert cfg.traversal == "wide8" and cfg.integrator == "fused"
    assert dataclasses.replace(cfg, integrator="wavefront").traversal == "wide8"
    from unity_webgpu_pathtracer_torch import cli

    with pytest.raises(SystemExit):
        cli.main(["render", "builtin:cornell", "--traversal", "wide32"])
