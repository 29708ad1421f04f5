"""Equirectangular HDRI environment (``scene/envmap.py`` of the reference).

Host side (numpy): the Vose alias table and the merged per-texel rows
``[alias_row (8) | 2x2 bilinear footprint (12)]``.  Device side (torch):
``sample_env_transition``, the fused transition's whole environment
interaction in one row gather — miss lanes read the bilinear footprint at
their direction's texel, env-NEE lanes the alias row of their sampled bin.
``acos``/``atan2`` run here, outside the transition kernel, as in the
reference.  The megakernel integrator reads the environment as the
reference's does: ``eval_env_map`` (the bilinear sky and its pdf) and
``sample_env_map`` (the inverse-CDF sample, one uniform a lane).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.math import INV_PI, INV_TWO_PI, PI, TWO_PI, luminance

QUAD_ROWS_MAX_TEXELS = 2_000_000


class EnvMap(NamedTuple):
    """Environment tables (numpy from ``build_envmap``, tensors after
    ``to_tensors``); the same fields as the reference's ``EnvMap``."""

    image: object        # (H, W, 3) float32 linear radiance
    cdf: object          # (H*W,) inclusive prefix sum of luminance
    cdf_sum: object      # () total luminance
    alias_prob: object   # (H*W,)
    alias_idx: object    # (H*W,) int32
    alias_row: object    # (H*W, 8) [prob, alias idx bits, self rgb, alias rgb]
    quad_rows: object    # (H*W, 12) 2x2 wrap footprint [p00|p10|p01|p11]
    merged_rows: object  # (H*W, 20) [alias_row | quad_rows]

    def to_tensors(self, device) -> "EnvMap":
        return EnvMap(*(torch.from_numpy(np.array(a, order="C")).to(device)
                        for a in self))


def _build_alias(weights: np.ndarray):
    """Vose alias table for O(1) categorical sampling."""
    k = weights.size
    p = weights.astype(np.float64)
    total = p.sum()
    if total <= 0 or k == 0:
        return np.ones(max(k, 1), np.float32), np.zeros(max(k, 1), np.int32)
    p = p * (k / total)
    prob = np.ones(k, np.float64)
    alias = np.arange(k, dtype=np.int32)
    small = [i for i in range(k) if p[i] < 1.0]
    large = [i for i in range(k) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias


def build_envmap(image: np.ndarray) -> EnvMap:
    """Luminance CDF, alias table and merged rows of an equirect image.

    Above ``QUAD_ROWS_MAX_TEXELS`` texels the footprint and merged rows
    are the reference's one-row placeholders: kernel K2 then stays off
    and the transition samples the image through ``sample_env_map_alias``
    and the bilinear lookup."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[0], img.shape[1]
    lum = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    flat = lum.reshape(-1)
    cdf = np.cumsum(flat, dtype=np.float64).astype(np.float32)
    prob, alias = _build_alias(flat)

    texels = img.reshape(-1, 3)
    alias_row = np.zeros((h * w, 8), np.float32)
    alias_row[:, 0] = prob
    alias_row[:, 1] = alias.view(np.float32)
    alias_row[:, 2:5] = texels
    alias_row[:, 5:8] = texels[alias]

    if h * w <= QUAD_ROWS_MAX_TEXELS:
        right = np.roll(img, -1, axis=1)
        down = np.roll(img, -1, axis=0)       # wrap in v, as the reference does
        downright = np.roll(right, -1, axis=0)
        quad_rows = np.concatenate([img, right, down, downright],
                                   axis=-1).reshape(-1, 12).astype(np.float32)
        merged = np.concatenate([alias_row, quad_rows], axis=1)
    else:
        quad_rows = np.zeros((1, 12), np.float32)
        merged = np.zeros((1, 20), np.float32)
    return EnvMap(
        image=img, cdf=cdf, cdf_sum=np.float32(cdf[-1]),
        alias_prob=prob, alias_idx=alias, alias_row=alias_row,
        quad_rows=quad_rows, merged_rows=merged,
    )


def empty_envmap() -> EnvMap:
    """Placeholder tables of a scene with no HDRI (the reference's
    ``empty_envmap``); only the constant, basic and no-sky modes read
    such a scene."""
    alias_row = np.zeros((1, 8), np.float32)
    alias_row[0, 0] = 1.0
    return EnvMap(
        image=np.zeros((1, 1, 3), np.float32), cdf=np.ones((1,), np.float32),
        cdf_sum=np.float32(1.0), alias_prob=np.ones((1,), np.float32),
        alias_idx=np.zeros((1,), np.int32), alias_row=alias_row,
        quad_rows=np.zeros((1, 12), np.float32), merged_rows=np.zeros((1, 20), np.float32),
    )


def _bilerp_coords(h: int, w: int, uv: torch.Tensor):
    """Bilinear footprint with wrap addressing: (x0i, y0i, fx, fy)."""
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    return x0i, y0i, fx, fy


def _bilinear_wrap(image: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """GPU-style bilinear sample with wrap addressing, texel centres at .5."""
    h, w = image.shape[0], image.shape[1]
    x0i, y0i, fx, fy = _bilerp_coords(h, w, uv)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    y0l, y1l, x0l, x1l = y0i.long(), y1i.long(), x0i.long(), x1i.long()
    p00, p10 = image[y0l, x0l], image[y0l, x1l]
    p01, p11 = image[y1l, x0l], image[y1l, x1l]
    return (p00 * (1 - fx) + p10 * fx) * (1 - fy) + (p01 * (1 - fx) + p11 * fx) * fy


def _bilinear_quad(env: EnvMap, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sky lookup through the pre-baked 2x2 footprint rows."""
    h, w = env.image.shape[0], env.image.shape[1]
    x0i, y0i, fx, fy = _bilerp_coords(h, w, uv)
    row = env.quad_rows[y0i * w + x0i]
    p00, p10 = row[..., 0:3], row[..., 3:6]
    p01, p11 = row[..., 6:9], row[..., 9:12]
    return (p00 * (1 - fx) + p10 * fx) * (1 - fy) + (p01 * (1 - fx) + p11 * fx) * fy


def env_bilinear(env: EnvMap, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear env fetch (B, 3) through the footprint rows when built."""
    h, w = env.image.shape[0], env.image.shape[1]
    if env.quad_rows.shape[0] == h * w:
        return _bilinear_quad(env, uv)
    return _bilinear_wrap(env.image, uv)


def eval_env_map(env: EnvMap, directions: torch.Tensor, intensity, rotation):
    """Radiance and pdf of (B, 3) directions that reach the sky
    (``sky.hlsl:43-64``): ``(color * intensity (B, 3), pdf (B,))``."""
    h, w = env.image.shape[0], env.image.shape[1]
    d = directions
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi_atan = torch.atan2(d[..., 2], d[..., 0])
    uv = torch.stack([(PI + phi_atan) * INV_TWO_PI + rotation, 1.0 - theta * INV_PI], dim=-1)
    color = env_bilinear(env, uv)
    sin_theta = torch.sin(theta)
    pdf = (luminance(color) / torch.clamp_min(env.cdf_sum, 1e-20) * (w * h)
           / torch.clamp_min((TWO_PI * PI) * sin_theta, 1e-8))
    pdf = torch.where(sin_theta <= 0.0, torch.zeros_like(pdf), pdf)
    return color * torch.as_tensor(intensity)[..., None], pdf


def sample_env_map(env: EnvMap, rotation, state: torch.Tensor):
    """Inverse-CDF direction sample (``sky.hlsl:66-88``): one uniform a
    lane, the first texel whose inclusive luminance prefix exceeds it.
    Returns ``(direction (B, 3), color (B, 3), pdf (B,), state)``."""
    h, w = env.image.shape[0], env.image.shape[1]
    u, state = urng.random_float(state)
    target = u * env.cdf_sum
    idx = torch.clamp(torch.searchsorted(env.cdf, target, right=True), 0, w * h - 1)
    x = (idx % w).to(torch.float32)
    y = (idx // w).to(torch.float32)
    uv = torch.stack([(x + 0.5) / w, (y + 0.5) / h], dim=-1)
    color = _bilinear_wrap(env.image, uv)
    pdf = luminance(color) / torch.clamp_min(env.cdf_sum, 1e-20)
    theta = (1.0 - uv[..., 1]) * PI
    phi = (uv[..., 0] - rotation) * TWO_PI
    sin_theta = torch.sin(theta)
    direction = torch.stack(
        [-sin_theta * torch.cos(phi), torch.cos(theta), -sin_theta * torch.sin(phi)], dim=-1)
    pdf = pdf * (w * h) / torch.clamp_min((TWO_PI * PI) * sin_theta, 1e-8)
    pdf = torch.where(sin_theta <= 0.0, torch.zeros_like(pdf), pdf)
    return direction, color, pdf, state


def _texel_direction(h: int, w: int, idx: torch.Tensor, rotation):
    """Texel index -> (world direction (B, 3), sin(theta))."""
    x = (idx % w).to(torch.float32)
    y = (idx // w).to(torch.float32)
    uv0 = (x + 0.5) / w
    uv1 = (y + 0.5) / h
    theta = (1.0 - uv1) * PI
    phi = (uv0 - rotation) * TWO_PI
    sin_theta = torch.sin(theta)
    direction = torch.stack(
        [-sin_theta * torch.cos(phi), torch.cos(theta), -sin_theta * torch.sin(phi)],
        dim=-1)
    return direction, sin_theta


def _solid_angle_pdf(color, cdf_sum, k: int, sin_theta):
    pdf = luminance(color) / torch.clamp_min(cdf_sum, 1e-20)
    pdf = pdf * k / torch.clamp_min((TWO_PI * PI) * sin_theta, 1e-8)
    return torch.where(sin_theta <= 0.0, torch.zeros_like(pdf), pdf)


def sample_env_map_alias(env: EnvMap, rotation, state: torch.Tensor):
    """The O(1) alias-method sample (the CDF sampler's distribution): one
    ``alias_row`` read a lane, two uniforms.  Returns ``(direction (B, 3),
    color (B, 3), pdf (B,), state)``."""
    h, w = env.image.shape[0], env.image.shape[1]
    k = h * w
    (u1, u2), state = urng.random_floats(state, 2)
    bin_ = torch.clamp((u1 * k).to(torch.int32), 0, k - 1)
    row = env.alias_row[bin_.long()]                            # (B, 8)
    take_alias = u2 >= row[:, 0]
    idx = torch.where(take_alias, row[:, 1].contiguous().view(torch.int32), bin_)
    color = torch.where(take_alias[:, None], row[:, 5:8], row[:, 2:5])
    direction, sin_theta = _texel_direction(h, w, idx, rotation)
    return direction, color, _solid_angle_pdf(color, env.cdf_sum, k, sin_theta), state


def sample_env_transition(env: EnvMap, rotation, directions: torch.Tensor,
                          want_alias: torch.Tensor, state: torch.Tensor,
                          need: torch.Tensor | None = None):
    """One merged-row gather serving both environment consumers.

    ``directions`` (B, 3) are the lanes' path directions (sky lookup on a
    miss); ``want_alias`` selects the lanes that take an env-NEE sample
    from the alias row instead.  Lanes outside ``need`` gather row 0 (their
    results are never consumed).  Every lane draws two uniforms.  When the
    merged rows do not cover the image (an environment past
    ``QUAD_ROWS_MAX_TEXELS``), the sky takes the bilinear lookup and the
    NEE sample ``sample_env_map_alias`` (two more uniforms), as in the
    reference.

    Returns ``(sky_color, sky_pdf, nee_dir, nee_color, nee_pdf, state)``,
    vectors as (B, 3)."""
    h, w = env.image.shape[0], env.image.shape[1]
    k = h * w
    (u1, u2), state = urng.random_floats(state, 2)
    bin_ = torch.clamp((u1 * k).to(torch.int32), 0, k - 1)

    d = directions
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi_atan = torch.atan2(d[..., 2], d[..., 0])
    uv = torch.stack([(PI + phi_atan) * INV_TWO_PI + rotation,
                      1.0 - theta * INV_PI], dim=-1)

    if env.merged_rows.shape[0] != k:
        sky_color = env_bilinear(env, uv)
        sky_pdf = _solid_angle_pdf(sky_color, env.cdf_sum, k, torch.sin(theta))
        nee_dir, nee_color, nee_pdf, state = sample_env_map_alias(env, rotation, state)
        return sky_color, sky_pdf, nee_dir, nee_color, nee_pdf, state

    x0i, y0i, fx, fy = _bilerp_coords(h, w, uv)
    idx = torch.where(want_alias, bin_, y0i * w + x0i)
    if need is not None:
        idx = torch.where(need, idx, torch.zeros_like(idx))
    row = env.merged_rows[idx]                                  # (B, 20)

    # NEE half (alias method).
    take_alias = u2 >= row[:, 0]
    alias_idx = env.merged_rows.view(torch.int32)[idx, 1]
    a_idx = torch.where(take_alias, alias_idx, bin_)
    nee_color = torch.where(take_alias[:, None], row[:, 5:8], row[:, 2:5])
    nee_dir, sin_a = _texel_direction(h, w, a_idx, rotation)
    nee_pdf = _solid_angle_pdf(nee_color, env.cdf_sum, k, sin_a)

    # Sky half (bilinear from the pre-baked footprint).
    p00, p10 = row[:, 8:11], row[:, 11:14]
    p01, p11 = row[:, 14:17], row[:, 17:20]
    sky_color = (p00 * (1 - fx) + p10 * fx) * (1 - fy) + (
        p01 * (1 - fx) + p11 * fx) * fy
    sky_pdf = _solid_angle_pdf(sky_color, env.cdf_sum, k, torch.sin(theta))
    return sky_color, sky_pdf, nee_dir, nee_color, nee_pdf, state
