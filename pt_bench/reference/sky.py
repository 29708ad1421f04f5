# Frozen copy of unity_webgpu_pathtracer_torch/render/sky.py at commit 628fc1bc0151d37c4767d2275c25b153616afc0d,
# imports rewritten to this package; the benchmark's yardstick, not to be edited with the port.
"""Sky radiance for escaped rays (``render/sky.py`` of the reference;
``sky.hlsl``), the modes the general transition reads: the constant
environment colour, the basic gradient sky and no sky; and, given the
scene's environment tables, the HDRI (``eval_env_map``), as the megakernel
reads it.  The fused transition reads the HDRI through
``scene/envmap.py::sample_env_transition`` instead (one merged row gather
serves both its sky and its NEE sample).  Directions and colours are
(B, 3), as in the reference."""

from __future__ import annotations

import torch

from pt_bench.reference.config import (
    SKY_MODE_BASIC,
    SKY_MODE_ENVIRONMENT,
    RenderConfig,
    RenderParams,
)
from pt_bench.reference.envmap import eval_env_map
from pt_bench.reference.vmath import PI


def basic_sky(directions: torch.Tensor, intensity: torch.Tensor):
    """RTiOW gradient (``sky.hlsl:101-108``): ``(color (B, 3), pdf (B,))``."""
    a = torch.clamp(0.5 * (directions[..., 1] + 1.0), 0.0, 1.0)[..., None]
    horizon = torch.ones(3, dtype=directions.dtype, device=directions.device)
    zenith = torch.tensor([0.5, 0.7, 1.0], dtype=directions.dtype,
                          device=directions.device) ** 2.2
    color = (1.0 - a) * horizon + a * zenith
    pdf = torch.full(directions.shape[:-1], 1.0 / (4.0 * PI), dtype=directions.dtype,
                     device=directions.device)
    return color * intensity[..., None], pdf


def sample_sky_radiance(config: RenderConfig, params: RenderParams,
                        directions: torch.Tensor, ray_depth: torch.Tensor, env=None):
    """Sky radiance and its pdf (``sky.hlsl:110-129``); the HDRI needs the
    scene's ``env`` tables.  Primary rays (depth 0) see the sky at
    intensity 1, secondary rays at ``environment_intensity``."""
    hdri = config.sky_mode == SKY_MODE_ENVIRONMENT and config.has_environment_texture
    if hdri and env is None:
        raise ValueError("the HDRI needs the scene's env tables (the fused transition "
                         "samples it by sample_env_transition)")
    intensity = torch.where(ray_depth > 0, params.environment_intensity,
                            torch.ones_like(params.environment_intensity))
    if hdri:
        return eval_env_map(env, directions, intensity, params.environment_rotation)
    if config.sky_mode == SKY_MODE_ENVIRONMENT:
        color = params.environment_color * intensity[..., None]
        pdf = torch.full(directions.shape[:-1], 1.0 / (4.0 * PI), dtype=directions.dtype,
                         device=directions.device)
        return color, pdf
    if config.sky_mode == SKY_MODE_BASIC:
        return basic_sky(directions, intensity)
    return torch.zeros_like(directions), torch.zeros_like(directions[..., 0])
