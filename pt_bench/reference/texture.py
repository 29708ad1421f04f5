# Frozen copy of unity_webgpu_pathtracer_torch/scene/texture.py at commit 628fc1bc0151d37c4767d2275c25b153616afc0d,
# imports rewritten to this package; the benchmark's yardstick, not to be edited with the port.
"""Software texture atlas (``scene/texture.py`` of the reference): one flat
uint32 buffer of descriptors and RGBA8 texels, built on the host with
numpy and sampled per lane with torch.

The buffer contract is the reference's (``CopyTextureData.compute:21-35``
writes it, ``util/texture.hlsl`` reads it): 4-word descriptors
``[width, height, offset, 0]`` for every texture first, then each
texture's texels RGBA8-packed little-endian (r in the low byte).  On the
device the atlas is held as an int32 view of the same words (PyTorch has
little uint32 arithmetic): the descriptors are below 2^31, and each
channel is a shift and a mask of the texel word.
"""

from __future__ import annotations

import numpy as np
import torch


def build_atlas(textures: list[np.ndarray]) -> np.ndarray:
    """Pack (H, W, 3|4) uint8/float images into the flat uint32 atlas."""
    n = len(textures)
    if n == 0:
        return np.zeros((0,), np.uint32)
    descriptors = np.zeros((n, 4), np.uint32)
    blobs = []
    offset = n * 4  # texel data begins after the descriptor table
    for i, img in enumerate(textures):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None]
        h, w, c = img.shape
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[..., 3] = 255
        rgba[..., :c] = img[..., :4]
        packed = (
            rgba[..., 0].astype(np.uint32)
            | (rgba[..., 1].astype(np.uint32) << 8)
            | (rgba[..., 2].astype(np.uint32) << 16)
            | (rgba[..., 3].astype(np.uint32) << 24)
        ).reshape(-1)
        descriptors[i] = (w, h, offset, 0)
        blobs.append(packed)
        offset += w * h
    return np.concatenate([descriptors.reshape(-1)] + blobs)


def _fetch_texel(data: torch.Tensor, offset, width, height, x, y) -> torch.Tensor:
    """``GetTexturePixel`` (``texture.hlsl:6-23``): clamp, gather, unpack
    RGBA8.  ``x``, ``y`` (..., B) int32; returns (4, ..., B) channels in
    [0, 1]."""
    x = torch.minimum(x, width - 1)
    y = torch.minimum(y, height - 1)
    idx = torch.clamp(offset + y * width + x, 0, data.shape[0] - 1)
    px = data[idx.long()]
    inv = 1.0 / 255.0
    return torch.stack([(px & 0xFF).to(torch.float32) * inv,
                        ((px >> 8) & 0xFF).to(torch.float32) * inv,
                        ((px >> 16) & 0xFF).to(torch.float32) * inv,
                        ((px >> 24) & 0xFF).to(torch.float32) * inv])


def sample_texture(data: torch.Tensor, texture_index: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor, bilinear: bool = True) -> torch.Tensor:
    """Per-lane ``SampleTexture`` (``texture.hlsl:25-76``) at uv ``(u, v)``
    ((B,) planes) on the int32 atlas ``data``; returns (4, B) RGBA planes.

    Lanes whose ``texture_index`` is negative (unbound) return 0 and the
    caller keeps its constant.  The reference's mapping
    ``t = frac(uv) * (size - 1)`` and its 4-tap bilinear weights; the four
    taps are one gather."""
    if data.shape[0] == 0:
        return torch.zeros((4,) + u.shape, dtype=torch.float32, device=u.device)
    desc_base = torch.clamp_min(texture_index, 0) * 4
    n = data.shape[0]
    width = data[torch.clamp(desc_base, 0, n - 1).long()]
    height = data[torch.clamp(desc_base + 1, 0, n - 1).long()]
    offset = data[torch.clamp(desc_base + 2, 0, n - 1).long()]

    u = u - torch.floor(u)
    v = v - torch.floor(v)
    tu = u * (width.to(torch.float32) - 1.0)
    tv = v * (height.to(torch.float32) - 1.0)
    tx = tu.to(torch.int32)
    ty = tv.to(torch.int32)
    if not bilinear:
        out = _fetch_texel(data, offset, width, height, tx, ty)
    else:
        fu = tu - tx.to(torch.float32)
        fv = tv - ty.to(torch.float32)
        taps = _fetch_texel(data, offset, width, height,
                            torch.stack([tx, tx + 1, tx, tx + 1]),
                            torch.stack([ty, ty, ty + 1, ty + 1]))   # (4 ch, 4 taps, B)
        p1, p2, p3, p4 = taps[:, 0], taps[:, 1], taps[:, 2], taps[:, 3]
        out = (p1 * (1 - fu) + p2 * fu) * (1 - fv) + (p3 * (1 - fu) + p4 * fu) * fv
    return torch.where(texture_index >= 0, out, torch.zeros_like(out))
