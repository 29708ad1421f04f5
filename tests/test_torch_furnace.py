"""The reference's furnace tests (``tests/test_furnace.py``) on the port's
BSDF (``render/bsdf.py``) and renderer, on the CPU.

A convex sphere under a constant white environment scatters each camera
ray at most once, so each pixel is the material's directional albedo
rho(V.n), which lat-long quadrature of ``eval_brdf`` gives.  The port's
albedo curve is held to the reference's (the same quadrature over the
reference's ``eval_brdf``, rtol 1e-4), and the port's megakernel render of
the sphere to that prediction with the reference's bounds: core mean
within 5%, the 95th percentile of the per-pixel gap under 0.12, the
background 1 within 1e-3.  The reference renders 48x48 at 64 spp; here
16x16 at 128 spp (half the rays, each pixel's estimate less noisy)
keeps the file to seconds, and the bounds are unchanged.
Glass: no energy creation at any angle and a render mean in [0.90, 1.08],
at 64 spp as in the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unity_webgpu_pathtracer_torch.api import Renderer
from unity_webgpu_pathtracer_torch.config import SKY_MODE_ENVIRONMENT, RenderConfig
from unity_webgpu_pathtracer_torch.models import primitives as prim
from unity_webgpu_pathtracer_torch.render import bsdf as tbsdf
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
from unity_webgpu_pathtracer_torch.scene.material import (
    MaterialDesc,
    derive_material,
    pack_materials,
)
from unity_webgpu_pathtracer_torch.scene.scene import Scene
from unity_webgpu_pathtracer_tpu.render import bsdf as jbsdf
from unity_webgpu_pathtracer_tpu.scene import material as jmaterial

torch.set_num_threads(2)

SIZE = 16
SPP = 128
EYE_Z = 3.0
FOV = 45.0

MATERIALS = {
    "diffuse_rough": dict(base_color=(1, 1, 1, 1), roughness=1.0),
    "diffuse_smooth": dict(base_color=(1, 1, 1, 1), roughness=0.3),
    "metal": dict(base_color=(1, 1, 1, 1), metallic=1.0, roughness=0.3),
    "clearcoat_diffuse": dict(base_color=(1, 1, 1, 1), roughness=0.8, clearcoat=1.0,
                              clearcoat_gloss=0.5),
    "gray_diffuse": dict(base_color=(0.5, 0.5, 0.5, 1), roughness=1.0),
}
GLASS = dict(base_color=(1, 1, 1, 1), roughness=0.1, ior=1.5, transmission=1.0)


@pytest.fixture(autouse=True, scope="module")
def _bvh_cache_elsewhere(tmp_path_factory):
    """Build tables into a temporary cache, not the repository's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("UWPT_BVH_CACHE_DIR", str(tmp_path_factory.mktemp("bvh_cache")))
    yield
    mp.undo()


def _lat_long(n_theta=96, n_phi=192):
    theta = (np.arange(n_theta) + 0.5) / n_theta * np.pi
    phi = (np.arange(n_phi) + 0.5) / n_phi * 2.0 * np.pi
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    l = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)],
                 axis=-1).reshape(-1, 3).astype(np.float32)
    w = (np.sin(tt) * (np.pi / n_theta) * (2.0 * np.pi / n_phi)).reshape(-1)
    return l, w


def _albedo_port(kw: dict, mu: float, l: np.ndarray, w: np.ndarray) -> float:
    b = l.shape[0]
    s = float(np.sqrt(max(1.0 - mu * mu, 0.0)))
    mdataT = torch.from_numpy(pack_materials([MaterialDesc(**kw)])).T.expand(32, b)
    n = tuple(torch.full((b,), c) for c in (0.0, 0.0, 1.0))
    view = tuple(torch.full((b,), c) for c in (s, 0.0, float(mu)))
    zero = torch.zeros((b,))
    mat = derive_material(mdataT, tuple(-c for c in view), n, (zero, zero),
                          torch.zeros((0,), dtype=torch.int32), False)
    f, _pdf = tbsdf.eval_brdf(mat, view, n, tuple(torch.from_numpy(l[:, c].copy())
                                                  for c in range(3)))
    return float((torch.stack(f, -1).numpy().mean(-1) * w).sum())


def _albedo_reference(kw: dict, mu: float, l: np.ndarray, w: np.ndarray) -> float:
    b = l.shape[0]
    s = float(np.sqrt(max(1.0 - mu * mu, 0.0)))
    mdata = jnp.broadcast_to(jnp.asarray(jmaterial.pack_materials([jmaterial.MaterialDesc(**kw)])),
                             (b, 32))
    n = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (b, 3))
    view = jnp.broadcast_to(jnp.asarray([s, 0.0, float(mu)]), (b, 3))
    mat = jmaterial.derive_material(mdata, jnp.zeros((b, 2)), -view, n)
    f, _pdf = jbsdf.eval_brdf(mat, view, n, jnp.asarray(l))
    return float((np.asarray(f).mean(axis=-1) * w).sum())


def _albedo_curve(kw: dict, n_mu=17):
    """The port's rho(mu) at 17 view angles, held to the reference's."""
    l, w = _lat_long()
    mus = np.linspace(0.03, 1.0, n_mu)
    port = np.array([_albedo_port(kw, m, l, w) for m in mus])
    ref = np.array([_albedo_reference(kw, m, l, w) for m in mus])
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-6)
    return mus, port


def _render_sphere(kw: dict, spp=SPP, bounces=8) -> np.ndarray:
    scene = Scene()
    m = scene.add_material(MaterialDesc(**kw))
    scene.add_mesh(prim.uv_sphere(radius=1.0, stacks=24, slices=48, material_index=m))
    config = RenderConfig(width=SIZE, height=SIZE, samples_per_pass=spp, max_bounces=bounces,
                          traversal="wide16", integrator="megakernel",
                          sky_mode=SKY_MODE_ENVIRONMENT, has_environment_texture=False,
                          use_russian_roulette=True)
    params = make_camera_params(eye=(0, 0, EYE_Z), target=(0, 0, 0), fov_y_deg=FOV, width=SIZE,
                                height=SIZE, device="cpu",
                                environment_color=np.array([1.0, 1.0, 1.0], np.float32),
                                environment_intensity=np.float32(1.0))
    r = Renderer(scene, config, params, device="cpu")
    r.render(1)
    return np.asarray(r.radiance())


def _predicted_image(mus, rhos):
    """Pixel-centre rays at the camera's geometry against the unit sphere:
    rho(V.n) where they hit, 1 where they miss."""
    img = np.ones((SIZE, SIZE), np.float32)
    inside = np.zeros((SIZE, SIZE), bool)
    tan_h = np.tan(np.radians(FOV) / 2.0)
    o = np.array([0.0, 0.0, EYE_Z])
    for y in range(SIZE):
        for x in range(SIZE):
            d = np.array([(2.0 * (x + 0.5) / SIZE - 1.0) * tan_h,
                          (1.0 - 2.0 * (y + 0.5) / SIZE) * tan_h, -1.0])
            d /= np.linalg.norm(d)
            bq = np.dot(o, d)
            disc = bq * bq - (np.dot(o, o) - 1.0)
            if disc <= 0:
                continue
            n = o + (-bq - np.sqrt(disc)) * d
            n /= np.linalg.norm(n)
            img[y, x] = np.interp(float(np.dot(-d, n)), mus, rhos)
            inside[y, x] = True
    return img, inside


def _erode(mask, it=2):
    m = mask.copy()
    for _ in range(it):
        m = m & np.roll(m, 1, 0) & np.roll(m, -1, 0) & np.roll(m, 1, 1) & np.roll(m, -1, 1)
    return m


@pytest.mark.parametrize("name", sorted(MATERIALS))
def test_furnace_matches_quadrature(name):
    """Render == the quadrature albedo, per pixel, for every reflective
    material class."""
    mus, rhos = _albedo_curve(MATERIALS[name])
    img = _render_sphere(MATERIALS[name])
    assert np.isfinite(img).all()
    mean_img = img.mean(axis=-1)
    pred, inside = _predicted_image(mus, rhos)
    bg = _erode(~inside, 3)
    assert mean_img[bg].mean() == pytest.approx(1.0, abs=1e-3)
    core = _erode(inside, 3)
    err = abs(mean_img[core].mean() - pred[core].mean()) / pred[core].mean()
    assert err < 0.05, (name, mean_img[core].mean(), pred[core].mean())
    assert np.quantile(np.abs(mean_img - pred)[core], 0.95) < 0.12
