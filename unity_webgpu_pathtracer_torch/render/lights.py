"""Analytic-light attenuation (``render/lights.py`` of the reference;
``util/light.hlsl``): the distance falloff and the spot cone fade that the
fused integrator's light NEE applies.  The reference's ``direct_light``
serves its megakernel integrator only, which the port does not have yet.
"""

from __future__ import annotations

import torch


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
