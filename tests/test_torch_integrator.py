"""The port's megakernel integrator (``render/integrator.py``) against the
reference's: its f32 triangle tables byte for byte, ``trace_bounce`` lane
by lane, ``render_pass`` film against film, and the reference's Cornell
checks (convergence, structure, determinism, checkpoint resume) on the
port, with checkpoints crossing between the packages.

Per-lane contract (``trace_bounce``, fed the same state on both sides,
three bounces from camera rays): PCG states, ``alive``, ``depth`` and the
hit records' light index, type and validity equal; radiance and
throughput within rtol 1e-5 / atol 1e-6 of the reference's jitted bounce
on >= 99% of lanes, and every other lane within that of the reference
evaluated eagerly (``jax.disable_jit``) on that lane: the jitted
reference contracts multiply-adds that its eager evaluation rounds twice,
which moves the glass lobe's f by up to 5e-5 relative, and the port
rounds as the eager reference does; the other floats (ray origins and
directions, pdfs, roughness) within rtol 1e-5 / atol 1e-6 on >= 99.5% of
elements and every element within rtol 1e-3 / atol 1e-5 (XLA's and
PyTorch's sin/cos/pow differ by an ulp, and a sampled direction's small
components cancel).
Both sides trace with the brute-force oracle, except the instanced case,
which needs the two-level wide16 table (the port's K1 twin against the
reference's wide16 traversal).  Films: within 1e-5 absolute.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_native import native_pair  # noqa: F401  (fixture)
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.api import Renderer
from unity_webgpu_pathtracer_torch.models import benchmark as tbench
from unity_webgpu_pathtracer_torch.models import examples as texamples
from unity_webgpu_pathtracer_torch.models import primitives as tprim
from unity_webgpu_pathtracer_torch.ops import get_intersectors
from unity_webgpu_pathtracer_torch.render import camera as tcamera
from unity_webgpu_pathtracer_torch.render import integrator as tint
from unity_webgpu_pathtracer_torch.render.hitinfo import intersect_analytic_lights, shade_prep
from unity_webgpu_pathtracer_torch.scene import material as tmaterial
from unity_webgpu_pathtracer_torch.scene import scene as tscene
from unity_webgpu_pathtracer_torch.utils import rng as trng
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.api import Renderer as JRenderer
from unity_webgpu_pathtracer_tpu.models import benchmark as jbench
from unity_webgpu_pathtracer_tpu.models import examples as jexamples
from unity_webgpu_pathtracer_tpu.models import primitives as jprim
from unity_webgpu_pathtracer_tpu.ops import intersect as jbf
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as jtw16
from unity_webgpu_pathtracer_tpu.render import camera as jcamera
from unity_webgpu_pathtracer_tpu.render import film as jfilm
from unity_webgpu_pathtracer_tpu.render import hitinfo as jhitinfo
from unity_webgpu_pathtracer_tpu.render import integrator as jint
from unity_webgpu_pathtracer_tpu.scene import material as jmaterial
from unity_webgpu_pathtracer_tpu.scene import scene as jscene

torch.set_num_threads(2)

MEGA_FIELDS = ("tris", "tri_index", "attr_normals", "attr_uvs", "attr_material",
               "attr_tangents")
TABLE_FIELDS = ("wide16_nodes", "wide16_top", "stack_levels", "attr_shade_c", "materials",
                "texture_data", "lights", "inst_l2w", "inst_w2l", "inst_offsets") + MEGA_FIELDS
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
W, H = 24, 16

_jax_bounce = jax.jit(jint.trace_bounce, static_argnums=(1, 4, 5, 6))
_jax_render_pass = jax.jit(jint.render_pass, static_argnums=(1,))

JAX_PKG = types.SimpleNamespace(Scene=jscene.Scene, MaterialDesc=jmaterial.MaterialDesc,
                                prim=jprim, examples=jexamples,
                                hdri=jbench.procedural_hdri)
TORCH_PKG = types.SimpleNamespace(Scene=tscene.Scene, MaterialDesc=tmaterial.MaterialDesc,
                                  prim=tprim, examples=texamples,
                                  hdri=tbench.procedural_hdri)


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _textured_blend_quad(pkg):
    """A quad with a bump normal map and an alpha-blended base colour
    texture (random alpha) over a floor, under the HDRI."""
    scene = pkg.Scene()
    h = w = 32
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sx, sy = np.sin(xx / w * 8 * np.pi) * 0.8, np.sin(yy / h * 8 * np.pi) * 0.8
    z = np.sqrt(np.maximum(1.0 - sx ** 2 - sy ** 2, 0.05))
    nm = np.stack([(sx * 0.5 + 0.5), (sy * 0.5 + 0.5), (z * 0.5 + 0.5)], -1)
    nid = scene.add_texture((np.clip(nm, 0, 1) * 255).astype(np.uint8))
    bid = scene.add_texture(np.random.default_rng(5).integers(0, 256, (16, 24, 4), np.uint8))
    m = scene.add_material(pkg.MaterialDesc(base_color=(0.8, 0.8, 0.8, 0.7), roughness=0.3,
                                            normal_texture=nid, base_color_texture=bid,
                                            alpha_mode=jconfig.ALPHA_MODE_BLEND,
                                            uv_scale=(2.0, 1.5), uv_offset=(0.1, 0.2)))
    scene.add_mesh(pkg.prim.quad(size=(4, 4), material_index=m))
    floor = scene.add_material(pkg.MaterialDesc(base_color=(0.6, 0.6, 0.6, 1), roughness=1.0))
    scene.add_mesh(pkg.prim.quad(size=(8, 8), material_index=floor),
                   pkg.prim.transform_trs(translate=(0, 0, -1.0)))
    scene.set_environment(pkg.hdri(32))
    cam = dict(eye=(0, 0.5, 3.0), target=(0, 0, 0), fov_y_deg=45.0)
    return scene, cam, dict(sky_mode=0, has_environment_texture=True, has_textures=True,
                            has_normal_maps=True)


def _hdri_quad(pkg):
    scene, cam, _ = pkg.examples.quad_scene()
    scene.set_environment(pkg.hdri(32))
    return scene, cam, dict(sky_mode=0, has_environment_texture=True)


def _instanced(pkg):
    scene, cam, over = pkg.examples.tlas_scene(n=4)
    scene.set_environment(pkg.hdri(32))
    over = {k: v for k, v in over.items() if k not in ("traversal", "has_tlas")}
    return scene, cam, dict(over, sky_mode=0, has_environment_texture=True)


def _case(pkg, name):
    """(scene, camera kwargs, config overrides) of a case in ``pkg``."""
    if name == "textured_blend":
        return _textured_blend_quad(pkg)
    if name == "hdri_quad":
        return _hdri_quad(pkg)
    if name == "instanced":
        return _instanced(pkg)
    scene, cam, over = pkg.examples.EXAMPLES[name]()
    over = {k: v for k, v in over.items() if k not in ("traversal", "has_tlas")}
    over.setdefault("has_lights", bool(scene.lights))
    over.setdefault("has_textures", bool(scene.textures))
    return scene, cam, over


def _jax_build(scene, traversal="wide16"):
    return scene._build_instanced_wide16() if scene.instances else scene.build(traversal)


def _arrays(sd) -> dict:
    out = {f: np.asarray(getattr(sd, f)) for f in TABLE_FIELDS}
    out["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    return out


@pytest.mark.parametrize("name", ["cornell", "quad", "texture", "lights", "rect_lights",
                                  "aperture", "brdf", "tlas", "sponza_like", "textured_blend"])
def test_megakernel_tables_byte_identical(native_pair, name):  # noqa: F811
    """The megakernel's tables of the port's ``Scene.build`` equal the
    reference's (flat builds: ``build("wide16")``; instanced:
    ``_build_instanced_wide16()``), byte for byte."""
    want = _arrays(_jax_build(_case(JAX_PKG, name)[0]))
    got = _case(TORCH_PKG, name)[0].build_arrays()
    for f in MEGA_FIELDS:
        w, g = want[f], got[f]
        assert g.dtype == w.dtype and g.shape == w.shape, (f, g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), f


def test_bruteforce_build_byte_identical():
    """``build("bruteforce")``: scene order, no node table, as the
    reference's; the instanced scene is refused."""
    want = _arrays(_case(JAX_PKG, "lights")[0].build("bruteforce"))
    got = tscene.scene_to_numpy(_case(TORCH_PKG, "lights")[0].build("bruteforce", device="cpu"))
    for f in TABLE_FIELDS:
        if f == "stack_levels":
            assert got[f].shape == want[f].shape
            continue
        assert got[f].shape == want[f].shape and got[f].tobytes() == want[f].tobytes(), f
    with pytest.raises(ValueError, match="instanced"):
        _case(TORCH_PKG, "tlas")[0].build("bruteforce", device="cpu")


def _configs(over, traversal, w=W, h=H, **kw):
    common = dict(width=w, height=h, max_bounces=4, integrator="megakernel",
                  traversal=traversal, **over, **kw)
    return jconfig.RenderConfig(**common), tconfig.RenderConfig(**common)


def _setup(name, traversal, w=W, h=H, **kw):
    """Both packages on the reference's tables: (jsd, tsd, jcfg, tcfg,
    jparams, tparams)."""
    jsc, cam, over = _case(JAX_PKG, name)
    jsd = _jax_build(jsc, traversal)
    tsd = tscene.scene_from_numpy(_arrays(jsd), device="cpu")
    jcfg, tcfg = _configs(over, traversal, w, h, **kw)
    uniforms = dict(seed_root=np.uint32(0xDEADBEEF))
    jparams = jcamera.make_camera_params(width=w, height=h, **cam, **uniforms)
    tparams = tcamera.make_camera_params(width=w, height=h, **cam, **uniforms, device="cpu")
    return jsd, tsd, jcfg, tcfg, jparams, tparams


def _to_jax(s: tint.PathState):
    return jint.PathState(
        origin=jnp.asarray(s.origin.T.numpy()), direction=jnp.asarray(s.direction.T.numpy()),
        radiance=jnp.asarray(s.radiance.T.numpy()),
        throughput=jnp.asarray(s.throughput.T.numpy()),
        rng=jnp.asarray(s.rng.numpy().astype(np.uint32)), alive=jnp.asarray(s.alive.numpy()),
        prev_pdf=jnp.asarray(s.prev_pdf.numpy()),
        max_roughness=jnp.asarray(s.max_roughness.numpy()),
        depth=jnp.asarray(s.depth.numpy()))


def _lanes(s: tint.PathState, lanes) -> tint.PathState:
    return tint.PathState(**{f: getattr(s, f)[..., lanes] for f in s.__dataclass_fields__})


def _compare(t: tint.PathState, j, what, eager=None):
    """``t`` against the jitted reference's ``j``; ``eager(lanes)``: the
    reference's bounce evaluated eagerly on those lanes."""
    assert np.array_equal(t.rng.numpy(), np.asarray(j.rng).astype(np.int64)), f"{what}: rng"
    assert np.array_equal(t.alive.numpy(), np.asarray(j.alive)), f"{what}: alive"
    assert np.array_equal(t.depth.numpy(), np.asarray(j.depth)), f"{what}: depth"
    ok = np.ones(t.alive.shape[0], bool)
    for f in ("radiance", "throughput"):
        ok &= np.isclose(getattr(t, f).T.numpy(), np.asarray(getattr(j, f)), **FLOAT_TOL).all(-1)
    bad = np.flatnonzero(~ok)
    assert bad.size <= 0.01 * ok.size, f"{what}: {bad.size} lanes off the jitted reference"
    if bad.size:
        je = eager(bad)
        for f in ("radiance", "throughput"):
            np.testing.assert_allclose(getattr(t, f)[:, bad].T.numpy(), np.asarray(getattr(je, f)),
                                       err_msg=f"{what}: {f} (eager)", **FLOAT_TOL)
    for f in ("origin", "direction", "prev_pdf", "max_roughness"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        a = a.T if a.ndim == 2 else a
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5, err_msg=f"{what}: {f}")
        close = np.isclose(a, b, **FLOAT_TOL).mean()
        assert close >= 0.995, f"{what}: {f}: {close:.4f} of elements within {FLOAT_TOL}"


def _camera_state(tcfg, tparams, npix):
    pix = torch.arange(npix, dtype=torch.int64)
    rng = trng.seed(pix, 3, tparams.seed_root)
    coords, rng = tcamera.jittered_pixel_coords(pix, tcfg, rng)
    o, d, rng = tcamera.get_screen_ray(coords, tcfg, tparams, rng)
    return tint.new_path_state(o.T.contiguous(), d.T.contiguous(), rng)


def _jax_hits(sd, o, d, closest):
    hit = jhitinfo.shade_prep(sd, o, d, *closest(sd, o, d))
    return jhitinfo.intersect_analytic_lights(sd, o, d, hit)


_jax_hits_jit = jax.jit(_jax_hits, static_argnums=(3,))


@pytest.mark.parametrize("name", ["cornell", "hdri_quad", "lights", "rect_lights",
                                  "textured_blend", "instanced"])
def test_trace_bounce_matches_reference(name):
    """Three bounces from camera rays, each fed the same input state on
    both sides (the port's output of the last), ``with_stats`` on: the
    state and the shade mask lane by lane; with lights, the hit records."""
    traversal = "wide16" if name == "instanced" else "bruteforce"
    jsd, tsd, jcfg, tcfg, jparams, tparams = _setup(name, traversal)
    if traversal == "wide16":
        jclosest, joccluded = jtw16.closest_hit, jtw16.occluded
    else:
        jclosest, joccluded = jbf.closest_hit_bruteforce, jbf.occluded_bruteforce
    tclosest, toccluded = get_intersectors(tcfg)
    s = _camera_state(tcfg, tparams, W * H)
    shaded = 0
    for k in range(3):
        if tcfg.has_lights:
            hit_t = intersect_analytic_lights(
                tsd, s.origin, s.direction,
                shade_prep(tsd, s.origin, s.direction, *tclosest(tsd, s.origin.T, s.direction.T)))
            hit_j = _jax_hits_jit(jsd, jnp.asarray(s.origin.T.numpy()),
                                  jnp.asarray(s.direction.T.numpy()), jclosest)
            for f in ("light_index", "intersect_type", "valid"):
                assert np.array_equal(getattr(hit_t, f).numpy(), np.asarray(getattr(hit_j, f))), f
            np.testing.assert_allclose(hit_t.t.numpy(), np.asarray(hit_j.t), **FLOAT_TOL)
            assert int((hit_t.intersect_type == 1).sum()) > 0 or k > 0
        out_t, shade_t = tint.trace_bounce(tsd, tcfg, tparams, s, tclosest, toccluded,
                                           with_stats=True)
        out_j, shade_j = _jax_bounce(jsd, jcfg, jparams, _to_jax(s), jclosest, joccluded, True)
        def eager(lanes, s=s):
            with jax.disable_jit():
                return jint.trace_bounce(jsd, jcfg, jparams, _to_jax(_lanes(s, lanes)),
                                         jclosest, joccluded)

        _compare(out_t, out_j, f"{name} bounce {k}", eager)
        assert np.array_equal(shade_t.numpy(), np.asarray(shade_j)), f"bounce {k}: shade"
        shaded += int(shade_t.sum())
        s = out_t
    assert shaded > 0 and float(s.radiance.sum()) > 0.0


@pytest.mark.parametrize("name,traversal,size", [("cornell", "bruteforce", 16),
                                                 ("lights", "bruteforce", 16),
                                                 ("hdri_quad", "wide16", 8)])
def test_render_pass_matches_reference(name, traversal, size):
    """A whole pass of 2 spp: the port's film within 1e-5 of the
    reference's, on the reference's tables and on the port's own build."""
    jsd, tsd, jcfg, tcfg, jparams, tparams = _setup(name, traversal, size, size,
                                                    samples_per_pass=2)
    want = np.asarray(_jax_render_pass(jsd, jcfg, jparams, 5))
    got = tint.render_pass(tsd, tcfg, tparams, 5)
    assert got.shape == (size * size, 3) and float(got.sum()) > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    own = _case(TORCH_PKG, name)[0].build(traversal, device="cpu")
    np.testing.assert_array_equal(tint.render_pass(own, tcfg, tparams, 5).numpy(), got.numpy())


# ---- the reference's Cornell checks (tests/test_integrator_cornell.py) ----

SIZE = 32


def _cornell(size, spp, bounces):
    scene, cam = texamples.cornell_box()
    cfg = tconfig.RenderConfig(width=size, height=size, samples_per_pass=spp,
                               max_bounces=bounces, traversal="bruteforce", sky_mode=2,
                               integrator="megakernel")
    return scene, cfg, tcamera.make_camera_params(width=size, height=size, **cam,
                                                  device="cpu")


@pytest.fixture(scope="module")
def cornell_render():
    scene, cfg, params = _cornell(SIZE, 2, 4)
    r = Renderer(scene, cfg, params, device="cpu")
    r.render(passes=4)   # 8 spp
    return r


def test_converges_no_nans(cornell_render):
    img = cornell_render.radiance()
    assert np.isfinite(img).all()
    assert cornell_render.sample_count == 8
    st = cornell_render.stats()
    assert set(st) == {"closest_rays", "shadow_rays", "bounces", "k1_launches",
                       "shade_launches", "host_reads"}
    # The box is lit by its emissive quad, with no sky sample and no
    # analytic light: no NEE branch, so no shadow ray.
    assert st["closest_rays"] > 0 and st["shadow_rays"] == 0 and st["bounces"] >= 1
    # The brute force has no loop test and launches no K1, and the CPU
    # shades in plain PyTorch: the host reads are the alive tests, one a
    # bounce and at most one more a sample.
    spp = cornell_render.config.samples_per_pass
    assert st["k1_launches"] == 0 and st["shade_launches"] == 0
    assert st["bounces"] <= st["host_reads"] <= st["bounces"] + spp


def test_global_illumination_structure(cornell_render):
    img = cornell_render.radiance()
    h, w, _ = img.shape
    assert img.mean() > 0.01
    left = img[h // 2 - 8: h // 2 + 8, : w // 8]
    right = img[h // 2 - 8: h // 2 + 8, -w // 8:]
    assert left[..., 0].mean() > left[..., 1].mean() * 1.5
    assert right[..., 1].mean() > right[..., 0].mean() * 1.5
    top_center = img[-h // 8:, w // 2 - 8: w // 2 + 8]
    assert top_center.mean() > img.mean()


def test_deterministic_given_seed():
    scene, cfg, params = _cornell(16, 2, 3)
    r1 = Renderer(scene, cfg, params, device="cpu")
    r2 = Renderer(scene, cfg, params, device="cpu")
    r1.render(2)
    r2.render(2)
    np.testing.assert_array_equal(r1.radiance(), r2.radiance())


def test_film_checkpoint_resume(tmp_path):
    """Save after pass 1, load into a new renderer, pass 2: the film equals
    the uninterrupted run's bit for bit."""
    scene, cfg, params = _cornell(16, 2, 3)
    r1 = Renderer(scene, cfg, params, device="cpu")
    r1.render(1)
    r1.save_checkpoint(str(tmp_path / "ckpt.npz"))
    r1.render(1)
    r2 = Renderer(scene, cfg, params, device="cpu")
    r2.load_checkpoint(str(tmp_path / "ckpt.npz"))
    assert r2.sample_count == 2
    r2.render(1)
    np.testing.assert_array_equal(r1.radiance(), r2.radiance())
    with pytest.raises(ValueError, match="film of"):
        Renderer(scene, tconfig.RenderConfig(width=8, height=8, integrator="megakernel",
                                             traversal="bruteforce", sky_mode=2),
                 params, device="cpu").load_checkpoint(str(tmp_path / "ckpt.npz"))


def test_checkpoints_cross_packages(tmp_path):
    """A film written by either package loads in the other."""
    rng = np.random.default_rng(3)
    accum = rng.random((6, 10, 3), dtype=np.float32)
    jfilm.save(str(tmp_path / "j.npz"), jfilm.Film(jnp.asarray(accum),
                                                   jnp.asarray(12, jnp.int32)))
    scene, cfg, params = _cornell(8, 1, 1)
    r = Renderer(scene, tconfig.RenderConfig(width=10, height=6, integrator="megakernel",
                                             traversal="bruteforce", sky_mode=2),
                 params, device="cpu")
    r.load_checkpoint(str(tmp_path / "j.npz"))
    assert r.sample_count == 12 and np.array_equal(r.radiance(), accum)
    r.save_checkpoint(str(tmp_path / "t.npz"))
    jr = JRenderer(_case(JAX_PKG, "cornell")[0],
                   jconfig.RenderConfig(width=10, height=6, traversal="bruteforce"),
                   jcamera.make_camera_params(width=10, height=6, eye=(0, 0, 3),
                                              target=(0, 0, 0), fov_y_deg=45.0),
                   compile_cache=False)
    jr.load_checkpoint(str(tmp_path / "t.npz"))
    assert jr.sample_count == 12 and np.array_equal(jr.radiance(), accum)
    assert np.asarray(jr.film.sample_count).dtype == np.int32


def test_renderer_runs_on_the_card_by_default(monkeypatch):
    """Without a CUDA device the megakernel and wavefront renderers raise
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, _cfg, params = _cornell(8, 1, 1)
    for integ in ("megakernel", "wavefront"):
        cfg = tconfig.RenderConfig(width=8, height=8, integrator=integ)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Renderer(scene, cfg, params)
        Renderer(scene, cfg, params, device="cpu")
