# Frozen copy of unity_webgpu_pathtracer_torch/post/tonemap.py at commit 628fc1bc0151d37c4767d2275c25b153616afc0d,
# imports rewritten to this package; the benchmark's yardstick, not to be edited with the port.
"""Tonemap operators (``util/tonemap.hlsl``) and the presentation chain
(``Presentation.shader:36-73``): ``post/tonemap.py`` of the reference on
torch tensors, on the film's device.

Every operator is elementwise on (..., 3) colours; the 3x3 colour matrices
of ACES are written out per channel in the reference's summation order.
"""

from __future__ import annotations

import torch

from pt_bench.reference.config import (
    TONEMAP_ACES,
    TONEMAP_FILMIC,
    TONEMAP_LOTTES,
    TONEMAP_NONE,
    TONEMAP_REINHARD,
    PostParams,
)
from pt_bench.reference.vmath import luminance

_ACES_IN = ((0.59719, 0.35458, 0.04823),
            (0.07600, 0.90834, 0.01566),
            (0.02840, 0.13383, 0.83777))
_ACES_OUT = ((1.60475, -0.53108, -0.07367),
             (-0.10208, 1.10813, -0.00605),
             (-0.00327, -0.07276, 1.07602))


def _mat3(m, c: torch.Tensor) -> torch.Tensor:
    """``c @ m.T`` for a row-major 3x3 ``m``, one channel at a time."""
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([x * m[r][0] + y * m[r][1] + z * m[r][2] for r in range(3)], dim=-1)


def linear_to_srgb(rgb: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB OETF (``tonemap.hlsl:6-11``)."""
    safe = torch.clamp_min(rgb, 0.0)
    low = safe * 12.92
    high = torch.pow(safe, 1.0 / 2.4) * 1.055 - 0.055
    return torch.where(safe > 0.0031308, high, low)


def srgb_to_linear(rgb: torch.Tensor) -> torch.Tensor:
    safe = torch.clamp_min(rgb, 0.0)
    low = safe / 12.92
    high = torch.pow((safe + 0.055) / 1.055, 2.4)
    return torch.where(safe > 0.04045, high, low)


def aces(color: torch.Tensor) -> torch.Tensor:
    """ACES RRT+ODT fit (``tonemap.hlsl:21-45``)."""
    c = _mat3(_ACES_IN, color)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    return _mat3(_ACES_OUT, a / b)


def filmic(x: torch.Tensor) -> torch.Tensor:
    """Hejl/Burgess-Dawson filmic (``tonemap.hlsl:48-53``)."""
    xx = torch.clamp_min(x - 0.004, 0.0)
    r = (xx * (6.2 * xx + 0.5)) / (xx * (6.2 * xx + 1.7) + 0.06)
    return torch.pow(r, 2.2)


def lottes(x: torch.Tensor) -> torch.Tensor:
    """Lottes 2016 HDR curve (``tonemap.hlsl:56-72``)."""
    a, d = 1.6, 0.977
    hdr_max, mid_in, mid_out = 8.0, 0.18, 0.267
    b = (-(mid_in ** a) + (hdr_max ** a) * mid_out) / (
        ((hdr_max ** (a * d)) - (mid_in ** (a * d))) * mid_out)
    c = ((hdr_max ** (a * d)) * (mid_in ** a) - (hdr_max ** a) * (mid_in ** (a * d)) * mid_out) / (
        ((hdr_max ** (a * d)) - (mid_in ** (a * d))) * mid_out)
    xs = torch.clamp_min(x, 0.0)
    return torch.pow(xs, a) / (torch.pow(xs, a * d) * b + c)


def reinhard(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.clamp_min(x, 0.0))


_OPERATORS = {
    TONEMAP_NONE: lambda x: x,
    TONEMAP_ACES: aces,
    TONEMAP_FILMIC: filmic,
    TONEMAP_REINHARD: reinhard,
    TONEMAP_LOTTES: lottes,
}


def present(color: torch.Tensor, post: PostParams) -> torch.Tensor:
    """The presentation chain (``Presentation.shader:36-73``): linear mean
    radiance (H, W, 3) to display values in [0, 1], on ``color``'s device.
    The vignette's uv follows the array (row 0 = bottom of the frame)."""
    c = color * post.exposure
    c = _OPERATORS[post.mode](c)
    if post.srgb:
        c = linear_to_srgb(c)
    c = torch.clamp(0.5 + (c - 0.5) * post.contrast, 0.0, 1.0)
    c = torch.pow(c, 1.0 / post.brightness)
    lum = luminance(c)[..., None]
    c = lum + (c - lum) * post.saturation
    if post.vignette != 0.0:
        h, w = color.shape[0], color.shape[1]
        ys = (torch.arange(h, dtype=c.dtype, device=c.device) + 0.5) / h
        xs = (torch.arange(w, dtype=c.dtype, device=c.device) + 0.5) / w
        cy = (ys - 0.5)[:, None] * 2.0
        cx = (xs - 0.5)[None, :] * 2.0
        c = c * (1.0 - (cx * cx + cy * cy) * post.vignette)[..., None]
    return torch.clamp(c, 0.0, 1.0)

