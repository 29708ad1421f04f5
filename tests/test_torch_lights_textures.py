"""The port's analytic lights, textures, normal maps and thin lens against
the reference.

- Tables: the port's host build of every builtin scene byte-identical to
  the reference's ``SceneData`` (lights, atlas, tangents, materials and the
  rest of what the fused integrator reads), the two-level build of
  ``tlas`` against ``_build_instanced_wide16``.
- Per-lane functions on seeded inputs: ``sample_texture``, the textured
  ``derive_material``, ``apply_normal_map``, ``_analytic_light_hit`` (the
  reference's unrolled route at three lights, its ``fori_loop`` route at
  32, and ties between coplanar lights) and the thin-lens
  ``get_screen_ray``; float results within rtol 1e-5 / atol 1e-6 (XLA's
  and PyTorch's sqrt/sin/cos/pow may differ by an ulp), integer results
  equal.
- One general transition on a captured state of ``lights``, ``texture``,
  a textured and normal-mapped HDRI quad, and a five-light scene (the
  reference's ``fori_loop`` route): the contract of
  ``tests/test_torch_general.py``.
- One whole pass of ``lights``, ``texture`` and ``aperture``: the
  contract of ``tests/test_torch_general.py::test_cornell_pass_matches_reference``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_native import native_pair  # noqa: F401  (fixture)
from tests.test_torch_general import _capture, _pairs, _to_jax
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.models import examples as texamples
from unity_webgpu_pathtracer_torch.render import camera as tcam
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.scene import material as tmaterial
from unity_webgpu_pathtracer_torch.scene import texture as ttexture
from unity_webgpu_pathtracer_torch.scene.scene import scene_from_numpy, scene_to_numpy
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.models import examples as jexamples
from unity_webgpu_pathtracer_tpu.models import primitives as jprim
from unity_webgpu_pathtracer_tpu.models.benchmark import procedural_hdri
from unity_webgpu_pathtracer_tpu.render import camera as jcam
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.scene import material as jmaterial
from unity_webgpu_pathtracer_tpu.scene import texture as jtexture
from unity_webgpu_pathtracer_tpu.scene.lights import LightDesc
from unity_webgpu_pathtracer_tpu.scene.material import MaterialDesc
from unity_webgpu_pathtracer_tpu.scene.scene import Scene

torch.set_num_threads(2)

_jax_transition = jax.jit(jfused._transition, static_argnums=(1, 4))

TABLE_FIELDS = ("wide16_nodes", "wide16_top", "stack_levels", "attr_shade_c", "attr_shade_o",
                "attr_tangents", "materials", "texture_data", "lights", "inst_l2w",
                "inst_w2l", "inst_offsets")
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _arrays(sd) -> dict:
    out = {f: np.asarray(getattr(sd, f)) for f in TABLE_FIELDS}
    out["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    return out


def _jax_build(scene):
    return scene._build_instanced_wide16() if scene.instances else scene.build("wide16")


def _textured_hdri_quad():
    """A quad with a base colour and a bump normal map under the HDRI (the
    scene of the reference's normal-map feature test, textured)."""
    scene = Scene()
    h = w = 32
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sx, sy = np.sin(xx / w * 8 * np.pi) * 0.8, np.sin(yy / h * 8 * np.pi) * 0.8
    z = np.sqrt(np.maximum(1.0 - sx ** 2 - sy ** 2, 0.05))
    nm = np.stack([(sx * 0.5 + 0.5), (sy * 0.5 + 0.5), (z * 0.5 + 0.5)], -1)
    nid = scene.add_texture((np.clip(nm, 0, 1) * 255).astype(np.uint8))
    bid = scene.add_texture(np.random.default_rng(5).integers(0, 256, (16, 24, 4), np.uint8))
    m = scene.add_material(MaterialDesc(base_color=(0.8, 0.8, 0.8, 1.0), roughness=0.3,
                                        normal_texture=nid, base_color_texture=bid,
                                        uv_scale=(2.0, 1.5), uv_offset=(0.1, 0.2)))
    scene.add_mesh(jprim.quad(size=(4, 4), material_index=m))
    scene.set_environment(procedural_hdri(32))
    cam = dict(eye=(0, 0.5, 3.0), target=(0, 0, 0), fov_y_deg=45.0)
    return scene, cam, dict(sky_mode=0, has_environment_texture=True, has_textures=True,
                            has_normal_maps=True)


def _five_lights():
    """``lights_scene`` with two more rect lights in view: five lights take
    the reference's ``fori_loop`` route."""
    scene, cam, over = jexamples.lights_scene()
    for x in (-1.5, 1.5):
        scene.add_light(LightDesc(type=3, position=(x, 1.2, -1.0), right=(1, 0, 0),
                                  up=(0, 1, 0), size=(0.8, 0.6), color=(0.9, 0.8, 1.0),
                                  intensity=5.0, range=30))
    return scene, cam, over


def _jax_scene(name):
    if name == "textured_hdri_quad":
        return _textured_hdri_quad()
    if name == "five_lights":
        return _five_lights()
    return jexamples.EXAMPLES[name]()


@pytest.mark.parametrize("name", ["lights", "rect_lights", "texture", "tlas", "cornell", "brdf",
                                  "quad", "aperture", "sponza_like"])
def test_tables_byte_identical(native_pair, name):  # noqa: F811
    """The port's ``Scene.build`` of a builtin equals the reference's
    ``SceneData`` field for field, byte for byte."""
    jscene = _jax_scene(name)[0]
    tscene = texamples.EXAMPLES[name]()[0]
    want = _arrays(_jax_build(jscene))
    got = scene_to_numpy(tscene.build(device="cpu"))
    for f in TABLE_FIELDS:
        w, g = want[f], got[f]
        if f == "stack_levels":
            assert g.shape == w.shape, f
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (f, g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), f
    for f, w in want["env"].items():
        assert got["env"][f].tobytes() == w.tobytes(), f
    if name in ("lights", "rect_lights"):
        assert want["lights"].shape[0] >= 3
    if name == "texture":
        assert want["texture_data"].size > 4


def _atlas():
    rng = np.random.default_rng(11)
    texs = [rng.integers(0, 256, (7, 9, 4), np.uint8), rng.integers(0, 256, (16, 5, 3), np.uint8),
            rng.uniform(0, 1, (4, 4)).astype(np.float32)]
    atlas = jtexture.build_atlas(texs)
    assert np.array_equal(atlas, ttexture.build_atlas(texs))
    return atlas, torch.from_numpy(atlas.view(np.int32))


def test_sample_texture_matches_reference():
    atlas, tatlas = _atlas()
    rng = np.random.default_rng(12)
    b = 4096
    idx = rng.integers(-1, 3, b).astype(np.int32)
    uv = rng.uniform(-3, 3, (b, 2)).astype(np.float32)
    uv[:16] = np.array([[0, 0], [1, 1], [0.999999, 0.5], [-1e-7, 2.0]] * 4, np.float32)
    for bilinear in (True, False):
        want = np.asarray(jtexture.sample_texture(jnp.asarray(atlas), jnp.asarray(idx),
                                                  jnp.asarray(uv), bilinear=bilinear))
        got = ttexture.sample_texture(tatlas, torch.from_numpy(idx), torch.from_numpy(uv[:, 0]),
                                      torch.from_numpy(uv[:, 1]), bilinear=bilinear).numpy().T
        np.testing.assert_allclose(got, want, **FLOAT_TOL)
        assert (want[idx < 0] == 0).all() and want[idx >= 0].max() > 0.9


def _records(rng, b, n_tex):
    """Seeded material records with every texture slot bound or not."""
    descs = []
    for i in range(8):
        pick = rng.integers(-1, n_tex, 5)
        descs.append(MaterialDesc(
            base_color=tuple(rng.uniform(0.1, 1, 4)), emission=tuple(rng.uniform(0, 2, 3)),
            metallic=float(rng.uniform()), roughness=float(rng.uniform(0, 1)),
            ior=float(rng.uniform(1, 2)), anisotropic=float(rng.uniform(-1, 1)),
            normal_scale=float(rng.uniform(0.2, 2)), clearcoat_gloss=float(rng.uniform()),
            base_color_texture=int(pick[0]), metallic_roughness_texture=int(pick[1]),
            normal_texture=int(pick[2]), emission_texture=int(pick[3]),
            occlusion_texture=int(pick[4]), uv_scale=tuple(rng.uniform(0.5, 3, 2)),
            uv_offset=tuple(rng.uniform(-1, 1, 2))))
    table = jmaterial.pack_materials(descs)
    assert np.array_equal(table, tmaterial.pack_materials(descs))
    return table[rng.integers(0, 8, b)]


def _unit(rng, b):
    v = rng.normal(size=(b, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_textured_material_and_normal_map_match_reference():
    atlas, tatlas = _atlas()
    rng = np.random.default_rng(13)
    b = 4096
    md = _records(rng, b, 3)
    uv = rng.uniform(-2, 2, (b, 2)).astype(np.float32)
    ray, normal, tangent = _unit(rng, b), _unit(rng, b), _unit(rng, b)
    tangent[:8] = normal[:8]                        # degenerate tangents keep the normal
    j = dict(texture_data=jnp.asarray(atlas), has_textures=True)
    want = jmaterial.derive_material(jnp.asarray(md), jnp.asarray(uv), jnp.asarray(ray),
                                     jnp.asarray(normal), **j)
    mdT = torch.from_numpy(md.T.copy())
    planes = [tuple(torch.from_numpy(x[:, c].copy()) for c in range(x.shape[1]))
              for x in (uv, ray, normal, tangent)]
    got = tmaterial.derive_material(mdT, planes[1], planes[2], planes[0], tatlas, True)
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f)
        g = np.stack([x.numpy() for x in g], -1) if isinstance(g, tuple) else g.numpy()
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, **FLOAT_TOL, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert (np.asarray(want.occlusion) < 1).any() and (np.asarray(want.occlusion) == 1).any()

    want_n = np.asarray(jmaterial.apply_normal_map(
        jnp.asarray(md), jnp.asarray(uv), jnp.asarray(normal), jnp.asarray(tangent),
        jnp.asarray(atlas), True))
    got_n = tmaterial.apply_normal_map(mdT, planes[0], planes[2], planes[3], tatlas, True)
    got_n = np.stack([x.numpy() for x in got_n], -1)
    np.testing.assert_allclose(got_n, want_n, **FLOAT_TOL)
    moved = np.abs(want_n - normal).max(-1) > 1e-3
    assert 0.2 < moved.mean() < 0.95 and not moved[:8].any()


def _light_table(rng, n, coplanar=False):
    from unity_webgpu_pathtracer_tpu.scene.lights import pack_lights

    descs = []
    for i in range(n):
        pos = (0.0, 0.0, -2.0) if coplanar else (*rng.uniform(-3, 3, 2), rng.uniform(-3, -1))
        kind = 3 if coplanar or i % 4 else 2        # point lights are never intercepted
        descs.append(LightDesc(type=kind, position=pos, right=(1, 0, 0), up=(0, 1, 0),
                               size=tuple(rng.uniform(0.5, 2.5, 2)), color=(1, 1, 1),
                               intensity=float(i + 1), range=30))
    return pack_lights(descs)


@pytest.mark.parametrize("case", ["three", "thirty_two", "coplanar_ties"])
def test_analytic_light_hit_matches_reference(case):
    """The port tests every light at once and takes the first index of the
    nearest hit; the reference tests them in order (unrolled up to four
    lights, a ``fori_loop`` past that).  Coplanar lights that overlap tie
    on ``t``: the lowest index must win, as in the reference."""
    rng = np.random.default_rng({"three": 1, "thirty_two": 2, "coplanar_ties": 3}[case])
    n = {"three": 3, "thirty_two": 32, "coplanar_ties": 3}[case]
    table = _light_table(rng, n, coplanar=case == "coplanar_ties")
    b = 4096
    # Rays from in front of the lights (they face +z) toward a light's
    # centre, jittered: most meet one, some miss or come from behind.
    o = rng.uniform(-4, 4, (b, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(-1, 5, b)
    centre = table[:, 0:3] + 0.5 * (table[:, 8:11] + table[:, 12:15])
    aim = centre[rng.integers(0, n, b)] + rng.normal(0, 0.5, (b, 3))
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    t = np.where(rng.uniform(size=b) < 0.3, rng.uniform(0.5, 5, b), 1e5).astype(np.float32)

    class S:
        lights = jnp.asarray(table)

    jhit, jt, jidx = jfused._analytic_light_hit(S, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))
    planes = [tuple(torch.from_numpy(x[:, c].copy()) for c in range(3)) for x in (o, d)]
    thit, tt, tidx = tfused._analytic_light_hit(torch.from_numpy(table), *planes,
                                                torch.from_numpy(t))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **FLOAT_TOL)
    hits = np.asarray(jidx)
    assert (hits >= 0).mean() > 0.2, "the rays seldom meet a light"
    if case == "coplanar_ties":
        assert set(np.unique(hits[hits >= 0])) <= {0, 1, 2} and (hits == 0).sum() > 0


def test_thin_lens_rays_match_reference():
    """``get_screen_ray`` with ``use_depth_of_field`` against the
    reference: the same lens pair drawn after the jitter, the same rays;
    a zero aperture keeps the pinhole ray and still draws the pair."""
    w, h = 40, 24
    rng = np.random.default_rng(21)
    b = 2048
    coords = rng.uniform(0, [w, h], (b, 2)).astype(np.float32)
    state = rng.integers(0, 2 ** 32, b, dtype=np.uint64).astype(np.uint32)
    cam = dict(eye=(0.3, 0.8, 4.0), target=(0, 0, 0), fov_y_deg=40.0, width=w, height=h)
    for aperture, focal in ((0.25, 4.0), (0.0, 4.0)):
        jcfg = jconfig.RenderConfig(width=w, height=h, use_depth_of_field=True)
        tcfg = tconfig.RenderConfig(width=w, height=h, use_depth_of_field=True)
        jo, jd, js = jcam.get_screen_ray(
            jnp.asarray(coords), jcfg,
            jcam.make_camera_params(**cam, aperture=aperture, focal_length=focal),
            jnp.asarray(state))
        to, td, ts = tcam.get_screen_ray(
            torch.from_numpy(coords), tcfg,
            tcam.make_camera_params(**cam, aperture=aperture, focal_length=focal, device="cpu"),
            torch.from_numpy(state.astype(np.int64)))
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FLOAT_TOL)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **FLOAT_TOL)
        if aperture:
            assert (to.numpy().std(0)[:2] > 0.02).all()
        else:
            assert (np.ptp(to.numpy(), axis=0) == 0).all()


def _configs(cfg_kw, w, h, **common):
    jkw = dict(cfg_kw)
    jkw.setdefault("has_environment_texture", False)
    tkw = dict(cfg_kw)
    tkw.setdefault("has_environment_texture", jkw["has_environment_texture"])
    jcfg = jconfig.RenderConfig(width=w, height=h, traversal="wide16", integrator="fused",
                                attr_compact=2, **common, **jkw)
    return jcfg, tconfig.RenderConfig(width=w, height=h, **common, **tkw)


@pytest.mark.parametrize("name", ["lights", "texture", "textured_hdri_quad", "five_lights"])
def test_general_transition_matches_reference(name):
    """One general transition on a state captured from a port pass: integer
    fields equal, floats within rtol 1e-3 / atol 1e-5 and >= 99.5% within
    rtol 1e-5 / atol 1e-6 (``tests/test_torch_general.py``)."""
    w, h = 24, 16
    scene, cam, over = _jax_scene(name)
    over = dict(over)
    over.setdefault("has_lights", bool(scene.lights))
    over.setdefault("has_textures", bool(scene.textures))
    jsd = _jax_build(scene)
    jcfg, tcfg = _configs(over, w, h, samples_per_pass=4, max_bounces=5, pool_size=1024,
                          transition_every=4)
    tsd = scene_from_numpy(_arrays(jsd), device="cpu")
    tparams = tcam.make_camera_params(width=w, height=h, **cam, device="cpu")
    jparams = jcam.make_camera_params(width=w, height=h, **cam)
    assert not tfused._kernel_transition_supported(tsd, tcfg)
    cap = _capture(tsd, tcfg, tparams)
    s = copy.deepcopy(cap["s"])
    tfused._transition(tsd, tcfg, tparams, s, cap["budget"], 0)
    want = _jax_transition(jsd, jcfg, jparams, _to_jax(cap["s"]), cap["budget"], 0,
                           jnp.asarray(cap["trav_done"].numpy()))
    before = np.bincount(cap["s"].mode.numpy(), minlength=4)
    after = np.bincount(s.mode.numpy(), minlength=4)
    print(name, "lane modes before", before, "after", after)
    if tcfg.has_lights:
        assert before[2] > 0 and after[2] > 0, "no lane in light NEE"
    for field, g, wnt in _pairs(s, want):
        assert g.shape == wnt.shape, field
        if np.issubdtype(wnt.dtype, np.floating):
            np.testing.assert_allclose(g, wnt, rtol=1e-3, atol=1e-5, err_msg=field)
            close = np.isclose(g, wnt, rtol=1e-5, atol=1e-6).mean()
            assert close >= 0.995, (field, close)
        else:
            np.testing.assert_array_equal(g.astype(np.int64), wnt.astype(np.int64),
                                          err_msg=field)


@pytest.mark.parametrize("name", ["lights", "texture", "aperture"])
def test_pass_matches_reference(name):
    """A whole pass against the reference's fused pass: rays and arrivals
    within 0.5%, occupancy within 0.005, >= 99% of pixels within rtol 1e-4,
    the mean within 1%."""
    w = h = 32
    scene, cam, over = jexamples.EXAMPLES[name]()
    over = dict(over)
    over.setdefault("has_lights", bool(scene.lights))
    over.setdefault("has_textures", bool(scene.textures))
    sd = scene.build("wide16")
    jcfg, tcfg = _configs(over, w, h, samples_per_pass=4, max_bounces=4, pool_size=1024,
                          transition_every=4)
    step = jax.jit(jfused.fused_pass_with_stats, static_argnums=(1,))
    jfilm, jocc, jrays, jarr = step(sd, jcfg, jcam.make_camera_params(width=w, height=h, **cam), 0)
    tfilm, tocc, trays, tarr, iters = tfused.fused_pass_with_stats(
        scene_from_numpy(_arrays(sd), device="cpu"), tcfg,
        tcam.make_camera_params(width=w, height=h, **cam, device="cpu"), 0)
    print(f"{name}: rays port {int(trays)} reference {int(jrays)}; arrivals port {int(tarr)} "
          f"reference {int(jarr)}; super-iterations {iters}")
    assert abs(int(trays) - int(jrays)) <= 0.005 * int(jrays)
    assert abs(int(tarr) - int(jarr)) <= 0.005 * int(jarr)
    assert abs(float(tocc) - float(jocc)) <= 0.005
    got, want = tfilm.numpy(), np.asarray(jfilm)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    print(f"pixels diverged beyond rtol 1e-4: {int((~close).sum())} of {close.size}")
    assert close.mean() >= 0.99 and want.mean() > 0
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())
