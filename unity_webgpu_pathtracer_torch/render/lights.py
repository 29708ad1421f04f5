"""Next-event estimation: environment and analytic lights
(``render/lights.py`` of the reference; ``util/light.hlsl``).

``direct_light`` is the megakernel integrator's NEE: the HDRI by its
inverse-CDF sample, the constant environment by a uniform sphere
direction, and one uniformly picked analytic light (rect by area sample
with its solid-angle pdf, point, spot).  The fused integrator applies the
same falloff and spot cone fade in its transition.  The reference's two
documented deviations from upstream hold here too: shadow rays toward a
light end at the light, and the uniform pick is compensated by the light
count for every light type.  Lane vectors are planes (``utils/math.py``).
"""

from __future__ import annotations

import torch

from unity_webgpu_pathtracer_torch.config import (
    LIGHT_TYPE_POINT,
    LIGHT_TYPE_RECTANGLE,
    LIGHT_TYPE_SPOT,
    SKY_MODE_ENVIRONMENT,
    RenderConfig,
    RenderParams,
)
from unity_webgpu_pathtracer_torch.render import bsdf as ubsdf
from unity_webgpu_pathtracer_torch.render.sampling import power_heuristic, uniform_sample_sphere
from unity_webgpu_pathtracer_torch.scene.envmap import sample_env_map
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.math import (
    EPSILON,
    FAR_PLANE,
    PI,
    sqrt,
    vcross,
    vdot,
    vneg,
    vnormalize,
    vwhere,
)
from unity_webgpu_pathtracer_torch.utils.profiling import span


def _unity_falloff(dist: torch.Tensor, range_: torch.Tensor) -> torch.Tensor:
    """Unity-style distance attenuation (``light.hlsl:69-72``)."""
    r = dist / torch.clamp_min(range_, 1e-6)
    atten = torch.clamp(1.0 / (1.0 + 25.0 * r * r) * torch.clamp((1.0 - r) * 5.0, 0.0, 1.0),
                        0.0, 1.0)
    return torch.where(dist > range_, torch.zeros_like(atten), atten)


def spot_cone_fade(cos_theta: torch.Tensor, cos_outer: torch.Tensor,
                   cos_inner: torch.Tensor) -> torch.Tensor:
    """Spot cone edge fade (``light.hlsl:82-94``): linear in the cosine
    between the outer and inner cone angles, clamped to [0, 1]."""
    return torch.clamp((cos_theta - cos_outer) / torch.clamp_min(cos_inner - cos_outer, 1e-6),
                       0.0, 1.0)


def _gate(use: torch.Tensor, ld: tuple, contrib) -> tuple:
    return tuple(ld[c] + torch.where(use, contrib[c], torch.zeros_like(contrib[c]))
                 for c in range(3))


def _length(v) -> torch.Tensor:
    return sqrt(torch.clamp_min(vdot(v, v), 0.0))


def direct_light(scene, config: RenderConfig, params: RenderParams, hit, mat, ray_dir,
                 state: torch.Tensor, occluded_fn, live: torch.Tensor | None = None):
    """One NEE bounce (``light.hlsl:117-173``): the environment sample
    (sky mode 0), then one uniformly picked analytic light, the uniforms
    drawn in the reference's order (the env sample's one, or the constant
    environment's pair; the pick; the light's pair).  Shadow rays are
    traced for the lanes of ``live`` (None: every lane), the lanes whose
    result the caller reads.  Returns ``(Ld planes, state)``."""
    zero = torch.zeros_like(mat.metallic)
    ld = (zero, zero, zero)
    scatter_pos = tuple(hit.position[c] + hit.normal[c] * EPSILON for c in range(3))
    scatter_t = torch.stack(scatter_pos, dim=-1)
    v = vneg(ray_dir)
    far = torch.full_like(zero, FAR_PLANE)

    if config.sky_mode == SKY_MODE_ENVIRONMENT:
        if config.has_environment_texture:
            light_dir, color, light_pdf, state = sample_env_map(
                scene.env, params.environment_rotation, state)
            with span("mega.shadow"):
                shadowed = occluded_fn(scene, scatter_t, light_dir, far, live)
            light_dir, color = light_dir.T, color.T
            f, bsdf_pdf = ubsdf.eval_brdf(mat, v, hit.ffnormal, light_dir)
            mis = power_heuristic(light_pdf, bsdf_pdf)
            den = torch.clamp_min(light_pdf, 1e-20)
            contrib = tuple(mis * color[c] * f[c] * params.environment_intensity / den
                            for c in range(3))
            use = ~shadowed & (bsdf_pdf > 0.0) & (light_pdf > 0.0) & (mis > 0.0)
        else:
            # The reference's deviation: a uniform sphere direction, so the
            # 1/4pi pdf is consistent on both the NEE and the sky-MIS side.
            (r1, r2), state = urng.random_floats(state, 2)
            light_dir = uniform_sample_sphere(r1, r2)
            li = params.environment_color * params.environment_intensity
            light_pdf = 1.0 / (4.0 * PI)
            with span("mega.shadow"):
                shadowed = occluded_fn(scene, scatter_t, torch.stack(light_dir, dim=-1), far,
                                       live)
            f, bsdf_pdf = ubsdf.eval_brdf(mat, v, hit.ffnormal, light_dir)
            mis = power_heuristic(light_pdf, bsdf_pdf)
            contrib = tuple(mis * li[c] * f[c] / light_pdf for c in range(3))
            use = ~shadowed & (bsdf_pdf > 0.0) & (mis > 0.0)
        ld = _gate(use, ld, contrib)

    if config.has_lights and scene.lights.shape[0] > 0:
        lcount = scene.lights.shape[0]
        u_pick, state = urng.random_float(state)
        idx = torch.clamp((u_pick * lcount).to(torch.int32), 0, lcount - 1)
        rec = scene.lights[idx.long()].T                          # (16, B)
        ltype = rec[3].to(torch.int32)
        lpos, lu, lv = (rec[0], rec[1], rec[2]), (rec[8], rec[9], rec[10]), \
            (rec[12], rec[13], rec[14])
        emission = tuple(rec[4 + c] * float(lcount) for c in range(3))
        lrange, larea = rec[7], rec[11]
        (r1, r2), state = urng.random_floats(state, 2)

        # Rect: area sample with solid-angle pdf (light.hlsl:7-23).
        to_rect = tuple(lpos[c] + lu[c] * r1 + lv[c] * r2 - scatter_pos[c] for c in range(3))
        rect_dist = _length(to_rect)
        rect_den = torch.clamp_min(rect_dist, 1e-20)
        rect_dir = tuple(to_rect[c] / rect_den for c in range(3))
        rect_normal = vnormalize(vcross(lu, lv))
        rect_pdf = rect_dist * rect_dist / torch.clamp_min(
            larea * torch.abs(vdot(rect_normal, rect_dir)), 1e-20)

        # Point/spot: delta direction (light.hlsl:25-45).
        to_light = tuple(lpos[c] - scatter_pos[c] for c in range(3))
        delta_dist = _length(to_light)
        delta_den = torch.clamp_min(delta_dist, 1e-20)
        delta_dir = tuple(to_light[c] / delta_den for c in range(3))

        is_rect = ltype == LIGHT_TYPE_RECTANGLE
        is_spot = ltype == LIGHT_TYPE_SPOT
        is_point = ltype == LIGHT_TYPE_POINT
        light_dir = vwhere(is_rect, rect_dir, delta_dir)
        light_dist = torch.where(is_rect, rect_dist, delta_dist)
        light_normal = vwhere(is_rect, rect_normal,
                              vwhere(is_spot, vnormalize(lu), vneg(delta_dir)))
        light_pdf = torch.where(is_rect, rect_pdf, zero)

        # EvalLight (light.hlsl:60-114); the spot cone is
        # v.x = cos(outer), v.y = cos(inner) (light.hlsl:82-94).
        falloff = _unity_falloff(light_dist, lrange)
        cos_theta = vdot(vneg(light_dir), vnormalize(light_normal))
        falloff = torch.where(is_rect & (cos_theta < 0.0), zero, falloff)
        falloff = torch.where(is_spot, falloff * spot_cone_fade(cos_theta, rec[12], rec[13]),
                              falloff)
        with span("mega.shadow"):
            shadowed = occluded_fn(scene, scatter_t, torch.stack(light_dir, dim=-1),
                                   light_dist - EPSILON, live)
        # The reference evaluates analytic-light NEE about hit.normal
        # (light.hlsl:105).
        f, _bsdf_pdf = ubsdf.eval_brdf(mat, v, hit.normal, light_dir)
        lpdf = torch.where(light_pdf > 0.0, light_pdf, torch.ones_like(light_pdf))
        contrib = tuple(emission[c] * falloff * f[c] / lpdf for c in range(3))
        use = ~shadowed & (is_rect | is_spot | is_point) & (falloff > 0.0)
        ld = _gate(use, ld, contrib)

    return ld, state
