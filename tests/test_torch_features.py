"""The reference's feature checks (``tests/test_features.py``) on the port,
through ``Renderer`` on the CPU: texture and alpha mask, analytic lights,
thin-lens geometry and blur, the tonemap operators, normal maps (flat is
the identity, a bump grid changes the shading), and ``Renderer``'s light
and camera updates.  The reference renders these with its megakernel or
4-wide backends; the port has the fused wide16 integrator only.
"""

import numpy as np
import pytest
import torch

from unity_webgpu_pathtracer_torch.api import Renderer
from unity_webgpu_pathtracer_torch.config import PostParams, RenderConfig
from unity_webgpu_pathtracer_torch.models import primitives as prim
from unity_webgpu_pathtracer_torch.models.benchmark import procedural_hdri
from unity_webgpu_pathtracer_torch.models.examples import (
    camera_aperture_scene,
    lights_scene,
    texture_scene,
)
from unity_webgpu_pathtracer_torch.post import tonemap as tm
from unity_webgpu_pathtracer_torch.render import camera as uc
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
from unity_webgpu_pathtracer_torch.scene.scene import Scene

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _render(scene, cam, overrides, size=48, spp=16, max_bounces=3, **cfg_extra):
    overrides = dict(overrides)
    overrides.setdefault("has_lights", bool(scene.lights))
    overrides.setdefault("has_textures", bool(scene.textures))
    overrides.update(cfg_extra)
    config = RenderConfig(width=size, height=size, samples_per_pass=spp,
                          max_bounces=max_bounces, pool_size=1024, **overrides)
    r = Renderer(scene, config, uc.make_camera_params(width=size, height=size, **cam,
                                                      device="cpu"), device="cpu")
    r.render(1)
    return r.radiance()


def test_texture_and_alpha_mask():
    img = _render(*texture_scene())
    assert np.isfinite(img).all()
    # Checker texture: the centre alternates in red/green dominance.
    assert img[20:28, 16:32].std() > 0.02
    # Alpha-masked border: rays pass the quad's edge to the floor or sky,
    # so the border differs from an opaque quad's.
    scene, cam, over = texture_scene()
    scene.materials[0].alpha_mode = 0
    opaque = _render(scene, cam, over)
    assert abs(img[8:12, 8:40].mean() - opaque[8:12, 8:40].mean()) > 0.01


def test_analytic_lights_illuminate():
    img = _render(*lights_scene(), spp=24)
    assert np.isfinite(img).all()
    # No sky: all the energy comes from the lights, and the floor is lit.
    assert img.mean() > 0.005 and img.max() > 0.05
    scene, cam, over = lights_scene()
    dark = _render(scene, cam, over, spp=4, has_lights=False)
    assert dark.max() == 0.0


def test_depth_of_field_geometry():
    """Thin-lens rays: origins spread over the aperture disk and meet at
    the focal plane (``camera.hlsl:22-38``)."""
    config = RenderConfig(width=8, height=8, use_depth_of_field=True)
    params = uc.make_camera_params(eye=(0, 0, 4), target=(0, 0, 0), fov_y_deg=40, width=8,
                                   height=8, aperture=0.5, focal_length=4.0, device="cpu")
    coords = torch.full((256, 2), 4.0)
    o, d, _ = uc.get_screen_ray(coords, config, params, torch.arange(256, dtype=torch.int64))
    o, d = o.numpy(), d.numpy()
    assert o[:, 0].std() > 0.05 and o[:, 1].std() > 0.05     # lens sampling
    t = (0 - o[:, 2]) / d[:, 2]
    p = o + t[:, None] * d
    assert p.std(axis=0).max() < 1e-6                        # focal convergence


def test_depth_of_field_blurs_out_of_focus():
    scene, cam, over = camera_aperture_scene()
    cam = dict(cam, aperture=1.2, focal_length=1.5)          # strongly defocused
    dof = _render(scene, cam, over, spp=48, max_bounces=2)
    scene2, _, _ = camera_aperture_scene()
    pin = _render(scene2, dict(cam, aperture=0.0, focal_length=0.0),
                  dict(sky_mode=over["sky_mode"]), spp=48, max_bounces=2)

    def grad_energy(x, k=4):
        # Downsample first: per-pixel noise would dominate the gradient;
        # defocus blur survives averaging, noise does not.
        h = x.shape[0] // k
        ds = x.reshape(h, k, h, k, 3).mean((1, 3)).mean(-1)
        return np.abs(np.diff(ds, axis=0)).mean() + np.abs(np.diff(ds, axis=1)).mean()

    assert grad_energy(dof) < grad_energy(pin) * 0.7


def test_tonemap_operators_behave():
    x = torch.from_numpy(np.linspace(0, 8, 64, dtype=np.float32).reshape(-1, 1).repeat(3, 1))
    for op in (tm.aces, tm.filmic, tm.reinhard, tm.lottes):
        y = op(x).numpy()
        assert np.isfinite(y).all()
        assert (np.diff(y[:, 0]) >= -1e-3).all(), op.__name__  # monotone
        assert y[-1, 0] <= 1.4
    v = torch.from_numpy(np.linspace(0, 1, 32, dtype=np.float32))
    np.testing.assert_allclose(tm.srgb_to_linear(tm.linear_to_srgb(v)).numpy(), v.numpy(),
                               atol=1e-5)
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 4, (16, 16, 3)).astype(np.float32))
    out = tm.present(img, PostParams(vignette=0.3)).numpy()
    assert out.min() >= 0 and out.max() <= 1


def _normal_map_scene(bumpy: bool):
    """A quad with a normal map under the HDRI: flat (128, 128, 255) or a
    strong bump grid."""
    scene = Scene()
    h = w = 64
    nm = np.zeros((h, w, 3), np.uint8)
    nm[..., 0] = 128
    nm[..., 1] = 128
    nm[..., 2] = 255
    if bumpy:
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        sx = np.sin(xx / w * 8 * np.pi) * 0.8
        sy = np.sin(yy / h * 8 * np.pi) * 0.8
        z = np.sqrt(np.maximum(1.0 - sx ** 2 - sy ** 2, 0.05))
        nm[..., 0] = np.clip((sx * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
        nm[..., 1] = np.clip((sy * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
        nm[..., 2] = np.clip((z * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    tid = scene.add_texture(nm)
    m = scene.add_material(MaterialDesc(base_color=(0.8, 0.8, 0.8, 1.0), roughness=0.3,
                                        normal_texture=tid))
    scene.add_mesh(prim.quad(size=(4, 4), material_index=m))
    scene.set_environment(procedural_hdri(64))
    return scene, dict(eye=(0, 0.5, 3.0), target=(0, 0, 0), fov_y_deg=45.0)


@pytest.mark.parametrize("bumpy", [False, True], ids=["flat_is_identity", "bump_changes_shading"])
def test_normal_map(bumpy):
    """A flat map leaves the image as it is (the frame reduces to the
    interpolated normal); a bump grid visibly modulates the shading."""
    renders = {}
    for has_nm in (False, True):
        scene, cam = _normal_map_scene(bumpy)
        renders[has_nm] = _render(scene, cam, dict(sky_mode=0, has_environment_texture=True),
                                  size=40, spp=8, max_bounces=2, has_textures=True,
                                  has_normal_maps=has_nm)
    off, on = renders[False], renders[True]
    assert np.isfinite(on).all()
    if bumpy:
        assert np.abs(on - off).mean() > 0.005, "the normal map changed nothing"
        assert on.std() > off.std() * 0.9
    else:
        assert abs(on.mean() - off.mean()) / max(off.mean(), 1e-6) < 0.01


def test_update_lights_and_camera():
    """``Renderer.update_lights`` replaces the light table and restarts
    accumulation (no lights, no light under sky mode 2); ``update_camera``
    takes new uniforms and restarts, or, with ``reproject=True``, warps
    the film to a per-pixel count."""
    scene, cam, over = lights_scene()
    size = 24
    config = RenderConfig(width=size, height=size, samples_per_pass=4, max_bounces=2,
                          pool_size=1024, **over)
    r = Renderer(scene, config, uc.make_camera_params(width=size, height=size, **cam,
                                                      device="cpu"), device="cpu")
    r.render(1)
    lit = r.radiance()
    assert lit.mean() > 0 and r.stats()
    r.update_lights([])
    assert r.sample_count == 0 and r.stats() == {} and r.scene.lights.shape == (0, 16)
    r.render(1)
    assert r.radiance().max() == 0.0
    r.update_lights(lights_scene()[0].lights[:1])
    r.render(1)
    assert 0 < r.radiance().mean() < lit.mean()
    moved = uc.make_camera_params(width=size, height=size, **dict(cam, eye=(0, 6.0, 0.5)),
                                  device="cpu")
    r.update_camera(moved)
    assert r.sample_count == 0 and torch.equal(r.params.cam_to_world, moved.cam_to_world)
    r.render(1)
    r.update_camera(moved, reproject=True)
    assert tuple(r.film.pixel_counts.shape) == (size, size, 1)
    assert r.sample_count == int(r.film.pixel_counts.max()) == 4
