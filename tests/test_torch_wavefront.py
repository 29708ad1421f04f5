"""The port's wavefront integrator (``render/wavefront.py``) against the
reference's pass on the same tables, and the reference's wavefront checks
on the port (``tests/test_wavefront.py``): agreement with the megakernel
within Monte-Carlo noise, exact sample accounting, occupancy, and
determinism (the port's splat writes each work item's row once, so equal
seeds give equal films bit for bit)."""

import jax
import numpy as np
import pytest
import torch

from tests import torch_native  # noqa: F401  (loads both packages' native builders whole)
from unity_webgpu_pathtracer_torch import config as tconfig
from unity_webgpu_pathtracer_torch.api import Renderer
from unity_webgpu_pathtracer_torch.models import primitives as tprim
from unity_webgpu_pathtracer_torch.models.cornell import cornell_box as tcornell
from unity_webgpu_pathtracer_torch.render import camera as tcamera
from unity_webgpu_pathtracer_torch.render import wavefront as twave
from unity_webgpu_pathtracer_torch.scene import scene as tscene
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
from unity_webgpu_pathtracer_tpu import config as jconfig
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box as jcornell
from unity_webgpu_pathtracer_tpu.models.examples import lights_scene as jlights
from unity_webgpu_pathtracer_tpu.render import camera as jcamera
from unity_webgpu_pathtracer_tpu.render import wavefront as jwave

torch.set_num_threads(2)

SIZE = 32
FIELDS = ("wide16_nodes", "wide16_top", "stack_levels", "attr_shade_c", "materials", "lights",
          "tris", "tri_index", "attr_normals", "attr_tangents", "attr_uvs", "attr_material")


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _setup(spp, integrator, pool_size=0, size=SIZE, bounces=4, traversal="wide16", **kw):
    scene, cam = tcornell()
    config = tconfig.RenderConfig(width=size, height=size, samples_per_pass=spp,
                                  max_bounces=bounces, traversal=traversal, sky_mode=2,
                                  integrator=integrator, pool_size=pool_size, **kw)
    return scene, config, tcamera.make_camera_params(
        width=size, height=size, **cam, max_firefly_luminance=np.float32(2.0), device="cpu")


@pytest.mark.parametrize("name,traversal", [("cornell", "bruteforce"), ("lights", "wide16")])
def test_wavefront_pass_matches_reference(name, traversal):
    """One pass (2 spp, an odd pool of 100 lanes) on the reference's
    tables: the film within 1e-5 of the reference's (which sums each
    pixel's samples in another order), the occupancy and the closest and
    shadow ray counts equal."""
    if name == "cornell":
        jsc, cam = jcornell()
        over = dict(sky_mode=2)
    else:
        jsc, cam, over = jlights()
        over = dict(over, has_lights=True)
    jsd = jsc.build(traversal)
    arrays = {f: np.asarray(getattr(jsd, f)) for f in FIELDS}
    arrays["env"] = {f: np.asarray(getattr(jsd.env, f)) for f in jsd.env._fields}
    tsd = tscene.scene_from_numpy(arrays, device="cpu")
    common = dict(width=16, height=16, samples_per_pass=2, max_bounces=4, traversal=traversal,
                  integrator="wavefront", **over)
    jcfg, tcfg = jconfig.RenderConfig(**common), tconfig.RenderConfig(**common)
    jp = jcamera.make_camera_params(width=16, height=16, **cam, seed_root=np.uint32(77))
    tp = tcamera.make_camera_params(width=16, height=16, **cam, seed_root=np.uint32(77),
                                    device="cpu")
    want = jax.jit(jwave.wavefront_pass_with_stats, static_argnums=(1, 4))(jsd, jcfg, jp, 2,
                                                                           100)
    film, occ, closest, shadow = twave.wavefront_pass_with_stats(tsd, tcfg, tp, 2, 100)
    assert float(film.sum()) > 0.0
    np.testing.assert_allclose(film.numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    assert int(closest) == int(want[2]) and int(shadow) == int(want[3])
    assert float(occ) == float(want[1])


def test_wavefront_matches_megakernel_statistically():
    """Identical estimator, different sample pairings: over four passes
    of 8 spp under widely spaced seed roots, the global means agree
    within 4 standard errors of the per-pass means (the seed formula
    correlates a pass's pixels, so the spread of pass means is the honest
    error), and 8x8 tiles within 15% on average.  Both clamp fireflies
    at luminance 2, as the golden renders do (brute-force traversal: the
    box has 36 triangles)."""
    means, films = {}, {}
    for integ in ("wavefront", "megakernel"):
        scene, cfg, _ = _setup(8, integ, pool_size=512, size=24, traversal="bruteforce",
                               use_firefly_filter=True)
        passes = []
        for i in range(4):
            params = tcamera.make_camera_params(
                width=24, height=24, **tcornell()[1], max_firefly_luminance=np.float32(2.0),
                seed_root=np.uint32(1000 + i * 1000003), device="cpu")
            r = Renderer(scene, cfg, params, device="cpu")
            r.render(1)
            # A wavefront pass leaves no counters; a megakernel pass its own.
            if integ == "wavefront":
                assert r.stats() == {}
            else:
                st = r.stats()
                assert st["closest_rays"] > 0 and st["bounces"] >= 1
            passes.append(r.radiance())
        passes = np.stack(passes)
        assert np.isfinite(passes).all()
        means[integ] = passes.mean(axis=(1, 2, 3))
        films[integ] = passes.mean(axis=0)
    mw, mm = means["wavefront"], means["megakernel"]
    sem = np.sqrt(mw.var(ddof=1) / mw.size + mm.var(ddof=1) / mm.size)
    assert abs(mw.mean() - mm.mean()) < 4.0 * sem + 1e-4, (mw, mm)
    k = 8
    a_ds = films["wavefront"].reshape(24 // k, k, 24 // k, k, 3).mean(axis=(1, 3))
    b_ds = films["megakernel"].reshape(24 // k, k, 24 // k, k, 3).mean(axis=(1, 3))
    rel = np.abs(a_ds - b_ds) / (b_ds + 0.05)
    assert rel.mean() < 0.15, rel.mean()


def test_wavefront_sample_accounting():
    """Every pixel receives exactly spp samples regardless of pool size:
    every ray misses a scene behind the camera and sees the constant
    environment at exactly 1, so each pixel's sum is spp exactly."""
    scene = tscene.Scene()
    m = scene.add_material(MaterialDesc())
    scene.add_mesh(tprim.quad(size=(1, 1), material_index=m),
                   tprim.transform_trs(translate=(0, 0, 10)))
    config = tconfig.RenderConfig(width=12, height=10, samples_per_pass=3, max_bounces=4,
                                  sky_mode=0, has_environment_texture=False,
                                  integrator="wavefront")
    params = tcamera.make_camera_params(width=12, height=10, eye=(0, 0, 0), target=(0, 0, -1),
                                        fov_y_deg=45.0, environment_color=(1.0, 1.0, 1.0),
                                        device="cpu")
    sd = scene.build(device="cpu")
    film_sum, occ = twave.wavefront_pass(sd, config, params, 0, pool_size=17)   # odd pool
    np.testing.assert_array_equal(film_sum.numpy(), np.full((120, 3), 3.0, np.float32))
    assert 0.0 < float(occ) <= 1.0


def test_wavefront_occupancy_high():
    scene, config, params = _setup(8, "wavefront", pool_size=256, size=24)
    sd = scene.build(device="cpu")
    _, occ = twave.wavefront_pass(sd, config, params, 0, pool_size=256)
    # Path regeneration keeps the pool > 80% full.
    assert float(occ) > 0.8, float(occ)


def test_wavefront_deterministic():
    scene, config, params = _setup(2, "wavefront", pool_size=128, size=16)
    r1 = Renderer(scene, config, params, device="cpu")
    r2 = Renderer(scene, config, params, device="cpu")
    r1.render(2)
    r2.render(2)
    np.testing.assert_array_equal(r1.radiance(), r2.radiance())
    assert r1.sample_count == 4


def test_wavefront_default_pool():
    """The pool follows the reference: ``pool_size`` argument, else the
    config's, else min(pixels, 65536)."""
    scene, config, params = _setup(1, "wavefront", size=8, bounces=1)
    sd = scene.build(device="cpu")
    seen = []
    real = twave.trace_bounce

    def spy(scene_, config_, params_, s, *a, **k):
        seen.append(s.alive.shape[0])
        return real(scene_, config_, params_, s, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(twave, "trace_bounce", spy)
    try:
        twave.wavefront_pass(sd, config, params, 0)
        twave.wavefront_pass(sd, tconfig.RenderConfig(**{**config.__dict__, "pool_size": 40}),
                             params, 0)
        twave.wavefront_pass(sd, config, params, 0, pool_size=24)
    finally:
        mp.undo()
    assert sorted(set(seen)) == [24, 40, 64]
