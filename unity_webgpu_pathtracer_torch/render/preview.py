"""Fast preview renderer: one primary pass, no accumulation
(``render/preview.py`` of the reference).

The reference's renderer ships a raster Disney-BRDF preview shader
(``PathTracer.shader:146-216``).  Here one primary-visibility pass (kernel
K1 through ``ops.get_intersectors`` on CUDA tensors, its plain twin on CPU
tensors) is shaded by the path tracer's own ``bsdf.eval_brdf`` toward one
directional key light, plus a hemispheric ambient and the emission; rays
that miss show the sky.  The shading is plain PyTorch on (3, B) planes, as
the reference's is XLA.
"""

from __future__ import annotations

import torch

from unity_webgpu_pathtracer_torch.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_torch.ops import get_intersectors
from unity_webgpu_pathtracer_torch.render import camera as ucamera
from unity_webgpu_pathtracer_torch.render.bsdf import eval_brdf
from unity_webgpu_pathtracer_torch.render.hitinfo import shade_prep
from unity_webgpu_pathtracer_torch.render.sky import sample_sky_radiance
from unity_webgpu_pathtracer_torch.scene.material import derive_material
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.math import normalize, vdot, vneg

KEY_LIGHT = (0.4, 0.8, 0.45)   # direction before normalisation (preview.py:50)


def preview(scene, config: RenderConfig, params: RenderParams) -> torch.Tensor:
    """A (H, W, 3) preview image (linear radiance) on the scene's device."""
    dev = scene.materials.device
    pixels = torch.arange(config.pixel_count(), dtype=torch.int64, device=dev)
    state = urng.seed(pixels, 0, params.seed_root)
    coords, state = ucamera.jittered_pixel_coords(pixels, config, state)
    o, d, state = ucamera.get_screen_ray(coords, config, params, state)

    closest_fn, _ = get_intersectors(config)
    t, bary, slot, inst = closest_fn(scene, o, d)
    dT = d.T
    hit = shade_prep(scene, o.T, dT, t, bary, slot, inst)
    md = scene.materials[torch.clamp_min(hit.material, 0).long()].T    # (32, B)
    mat = derive_material(md, dT, hit.normal, hit.uv, scene.texture_data, config.has_textures)

    # The key light: the reference shader's ForwardBase directional pass,
    # evaluated with the path tracer's Disney BSDF.
    key_dir = normalize(torch.tensor(KEY_LIGHT, dtype=torch.float32, device=dev))
    key_l = tuple(key_dir[c].expand(t.shape) for c in range(3))
    f, _pdf = eval_brdf(mat, vneg(dT), hit.ffnormal, key_l)
    n_dot_l = torch.clamp_min(vdot(hit.ffnormal, key_l), 0.0)
    key = torch.stack([fc * (3.0 * n_dot_l) for fc in f])

    # Hemispheric ambient + emission (the shader's ambient term).
    n_dot_v = torch.abs(vdot(hit.ffnormal, vneg(dT)))
    up = torch.clamp(0.5 + 0.5 * hit.ffnormal[1], 0.0, 1.0)
    amb = 0.15 + 0.2 * up + 0.1 * n_dot_v
    shaded = key + torch.stack([mat.base_color[c] * amb for c in range(3)]) \
        + torch.stack(mat.emission)

    sky, _ = sample_sky_radiance(config, params, d, torch.zeros_like(slot), scene.env)
    img = torch.where(hit.valid[:, None], shaded.T, sky)
    return img.reshape(config.height, config.width, 3)
