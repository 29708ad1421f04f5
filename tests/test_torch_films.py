"""The port's f32 attribute rows, its scenes past 65,536 materials and its
three films (``render/fused.py``), against the reference, on the CPU.

Attribute rows: ``attr_shade`` byte-identical to the reference's; the
reference's ``tests/test_film_modes.py::test_attr_compact_modes`` on the
port (modes 1 and 2 bit for bit, ``attr_direct`` either way bit for bit
(the port accepts the knob and reads the same f32 values either way),
the f16 modes within 2e-3 of the f32 rows), and each mode's film against
the reference's (>= 99% of pixels within rtol 1e-4, mean within 1%).

65,537 materials: the build warns with the reference's text and degrades
the compact tables to its placeholders; the megakernel and the fused pass
at ``attr_compact=0`` give the reference's films (within 1e-5); the
compact modes refuse at pass time with the reference's message.

Films: the reference's ``tests/test_film_modes.py`` :43-92 and :123-128
on the port (the sorted-prefix and record films, with backpressure at
``film_k_shift`` 6, equal the legacy film within rtol 3e-7 / atol 1e-7;
the record film takes the dispatch over the sorted one; both are
deterministic), also under a shard of the film; and the legacy film
against the reference's.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.api import Renderer as TRenderer
from unity_webgpu_pathtracer_torch.models import primitives as tprim
from unity_webgpu_pathtracer_torch.render import camera as tcamera
from unity_webgpu_pathtracer_torch.render import fused as tfused
from unity_webgpu_pathtracer_torch.scene import scene as tscene
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc as TMaterialDesc
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.api import Renderer as JRenderer
from unity_webgpu_pathtracer_tpu.models import primitives as jprim
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
from unity_webgpu_pathtracer_tpu.render import camera as jcamera
from unity_webgpu_pathtracer_tpu.render import fused as jfused
from unity_webgpu_pathtracer_tpu.scene.material import MaterialDesc as JMaterialDesc
from unity_webgpu_pathtracer_tpu.scene.scene import Scene as JScene

torch.set_num_threads(2)

FIELDS = ("wide16_nodes", "wide16_top", "stack_levels", "attr_shade", "attr_shade_c",
          "attr_shade_o", "materials", "tris", "tri_index", "attr_normals", "attr_uvs",
          "attr_material", "attr_tangents")
FILM_TOL = dict(rtol=3e-7, atol=1e-7)
SIZE = 24
PLACEHOLDER_WARNING = ("attr_compact supports at most 65536 materials; compact attr table "
                       "degraded to placeholder")
REFUSAL = "config.attr_compact requires <= 65536 materials"


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _arrays(sd) -> dict:
    out = {f: np.asarray(getattr(sd, f)) for f in FIELDS}
    out["env"] = {f: np.asarray(getattr(sd.env, f)) for f in sd.env._fields}
    return out


def _film_close(got, want):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, f"{int((~close).sum())} of {close.size} pixels off"
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())


@pytest.fixture(scope="module")
def cornell():
    """Both packages on the reference's Cornell tables: (jsd, tsd, jparams,
    tparams, common config fields), the reference's film-mode setting."""
    scene, cam = cornell_box()
    sd = scene.build("wide16")
    jparams = jcamera.make_camera_params(width=SIZE, height=SIZE, **cam)
    tparams = tcamera.make_camera_params(width=SIZE, height=SIZE, device="cpu", **cam)
    common = dict(width=SIZE, height=SIZE, samples_per_pass=4, max_bounces=3, sky_mode=2,
                  traversal="wide16", integrator="fused", pool_size=512)
    return sd, tscene.scene_from_numpy(_arrays(sd), device="cpu"), jparams, tparams, common


def _port(cornell, passes=2, **kw) -> np.ndarray:
    _sd, tsd, _jp, tparams, common = cornell
    r = TRenderer(tsd, tconfig.RenderConfig(has_environment_texture=False, **common, **kw),
                  tparams, device="cpu")
    r.render(passes)
    return r.radiance()


def _reference(cornell, passes=2, **kw) -> np.ndarray:
    sd, _tsd, jparams, _tp, common = cornell
    r = JRenderer(sd, jconfig.RenderConfig(**common, **kw), jparams, compile_cache=False)
    r.render(passes)
    return np.asarray(r.radiance())


LEGACY = dict(use_sorted_film=False, use_record_film=False)


@pytest.fixture(scope="module")
def legacy(cornell):
    return _port(cornell, **LEGACY)


def test_attr_shade_byte_identical():
    """The f32 rows the port's scene exports (packed from its per-triangle
    tables) and the rest of its tables equal the reference's, on Cornell
    and on the bruteforce build."""
    scene, _cam = cornell_box()
    from unity_webgpu_pathtracer_torch.models.cornell import cornell_box as tcornell

    tsc, _ = tcornell()
    for traversal in ("wide16", "bruteforce"):
        want = _arrays(scene.build(traversal))
        got = tscene.scene_to_numpy(tsc.build(traversal, device="cpu"))
        for f in FIELDS:
            if f == "stack_levels":
                continue
            g, w = np.asarray(got[f]), want[f]
            assert g.shape == w.shape and g.tobytes() == w.tobytes(), (traversal, f)
        assert got["attr_shade"].shape == (-(-got["tris"].shape[0] // 3), 48)


def test_attr_compact_modes(cornell):
    """Modes 1 and 2 read the same f16 halfwords, bit for bit; mode 0 gives
    the same film with ``attr_direct`` either way, bit for bit; the f16
    modes are within f16 rounding of mode 0."""
    f32 = _port(cornell, passes=1, attr_compact=0)
    f32_packed = _port(cornell, passes=1, attr_compact=0, attr_direct=False)
    c1 = _port(cornell, passes=1, attr_compact=1)
    c2 = _port(cornell, passes=1, attr_compact=2)
    np.testing.assert_array_equal(f32, f32_packed)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_allclose(c2, f32, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("mode", [0, 1])
def test_attr_mode_matches_reference(cornell, mode):
    _film_close(_port(cornell, passes=1, attr_compact=mode),
                _reference(cornell, passes=1, attr_compact=mode))


def test_legacy_film_matches_reference(cornell, legacy):
    _film_close(legacy, _reference(cornell, **LEGACY))


@pytest.mark.parametrize("kw", [
    dict(use_record_film=False, use_sorted_film=True, film_k_shift=1),
    dict(use_record_film=False, use_sorted_film=True, film_k_shift=6),
    dict(use_record_film=True, film_k_shift=1),
    dict(use_record_film=True, film_k_shift=6),
    dict(use_record_film=True, use_sorted_film=True),
], ids=["sorted", "sorted_backpressure", "record", "record_backpressure", "record_dispatch"])
def test_film_matches_legacy(cornell, legacy, kw):
    """K = 512 >> 6 = 8 records a transition: nearly every death waits in
    its lane and retries, and the pass flushes the last after the loop;
    the radiance is conserved all the same."""
    np.testing.assert_allclose(_port(cornell, **kw), legacy, **FILM_TOL)


@pytest.mark.parametrize("kw", [dict(use_record_film=True, film_k_shift=2),
                                dict(use_record_film=False, use_sorted_film=True,
                                     film_k_shift=2)], ids=["record", "sorted"])
def test_film_deterministic(cornell, kw):
    np.testing.assert_array_equal(_port(cornell, passes=1, **kw), _port(cornell, passes=1, **kw))


@pytest.mark.parametrize("kw", [LEGACY, dict(use_record_film=False, film_k_shift=6),
                                dict(film_k_shift=6)], ids=["legacy", "sorted", "record"])
def test_film_under_a_shard(cornell, legacy, kw):
    """A shard of the film (the second half of its pixels, samples 1-2 of
    the pass) in each film mode equals those rows of the single pass taken
    on those samples."""
    _sd, tsd, _jp, tparams, common = cornell
    cfg = tconfig.RenderConfig(has_environment_texture=False, **common, **kw)
    npix = SIZE * SIZE
    shard = (npix // 2, npix // 2, 1, 2)
    film, *_ = tfused.fused_pass_with_stats(tsd, cfg, tparams, 0, shard=shard)
    whole = sum(tfused.fused_pass_with_stats(
        tsd, dataclasses.replace(cfg, samples_per_pass=1, **LEGACY), tparams, s)[0]
        for s in (1, 2))
    np.testing.assert_allclose(film.numpy(), whole[npix // 2:].numpy(), **FILM_TOL)


def _many_materials(pkg_scene, desc, prim, n_mat=65_537):
    """One quad on material ``n_mat - 1`` under the basic sky (the scene of
    the port fault the reference renders)."""
    scene = pkg_scene()
    for i in range(n_mat):
        scene.add_material(desc(base_color=((i % 7) / 7.0, 0.5, 0.5, 1.0), roughness=0.5))
    scene.add_mesh(prim.quad(size=(2.0, 2.0), material_index=n_mat - 1))
    return scene


@pytest.fixture(scope="module")
def many_materials():
    with pytest.warns(UserWarning, match=PLACEHOLDER_WARNING):
        tsc = _many_materials(tscene.Scene, TMaterialDesc, tprim)
        tsd = tsc.build("wide16", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsd = _many_materials(JScene, JMaterialDesc, jprim).build("wide16")
    cam = dict(eye=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0), fov_y_deg=45.0)
    return jsd, tsd, cam


def test_many_materials_tables(many_materials):
    jsd, tsd, _cam = many_materials
    assert tsd.materials.shape[0] == 65_537
    got = tscene.scene_to_numpy(tsd)
    for f in ("attr_shade", "attr_shade_c", "attr_shade_o", "attr_material"):
        g, w = got[f], np.asarray(getattr(jsd, f))
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), f
    assert got["attr_shade_c"].shape == (2, 8) and got["attr_shade_o"].shape == (4, 4)
    assert int(got["attr_material"].max()) == 65_536


@pytest.mark.parametrize("integrator", ["megakernel", "fused"])
def test_many_materials_render_like_reference(many_materials, integrator):
    jsd, tsd, cam = many_materials
    common = dict(width=8, height=8, samples_per_pass=4, max_bounces=3, sky_mode=1,
                  traversal="wide16", integrator=integrator, attr_compact=0)
    jr = JRenderer(jsd, jconfig.RenderConfig(**common),
                   jcamera.make_camera_params(width=8, height=8, **cam), compile_cache=False)
    tr = TRenderer(tsd, tconfig.RenderConfig(has_environment_texture=False, **common),
                   tcamera.make_camera_params(width=8, height=8, device="cpu", **cam),
                   device="cpu")
    jr.render(1)
    tr.render(1)
    got, want = tr.radiance(), np.asarray(jr.radiance())
    assert got.mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_many_materials_refuse_compact_modes(many_materials, mode):
    jsd, tsd, cam = many_materials
    cfg = dict(width=8, height=8, sky_mode=1, traversal="wide16", integrator="fused",
               attr_compact=mode)
    with pytest.raises(ValueError, match=REFUSAL):
        jax.jit(jfused.fused_pass_with_stats, static_argnums=(1,))(
            jsd, jconfig.RenderConfig(**cfg), jcamera.make_camera_params(width=8, height=8,
                                                                         **cam), 0)
    with pytest.raises(ValueError, match=REFUSAL):
        tfused.fused_pass_with_stats(
            tsd, tconfig.RenderConfig(has_environment_texture=False, **cfg),
            tcamera.make_camera_params(width=8, height=8, device="cpu", **cam), 0)
