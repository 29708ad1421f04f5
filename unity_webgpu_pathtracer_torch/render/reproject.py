"""Temporal reprojection: the accumulated film warped through a camera
move (``render/reproject.py`` of the reference).

The reference's renderer restarts accumulation on every camera change
(``PathTracer.cs:211-222``); this carries the converged history along, so
a fly camera keeps most of its samples and only disoccluded pixels
restart.  Backward reprojection in three steps:

1. ``primary_depth`` traces the hit distance ``t`` of every pixel's centre
   ray (no jitter, no lens) for both cameras, through
   ``ops.get_intersectors`` (wide16: kernel K1 on CUDA tensors, its plain
   twin on CPU tensors).  A miss keeps ``FAR_PLANE``, so the sky
   reprojects as a point at quasi-infinity.
2. Each new pixel's world point ``o + d * t`` is projected into the old
   camera (the inverse of ``camera.get_screen_ray``'s pinhole ray).
3. The old film is read by a 4-tap bilinear gather; a tap counts when it
   lies on the film and its depth agrees (``|t_old - |P - eye_old|| <=
   tol * dist``); the weights are renormalised and the surviving history
   count is carried per pixel, clamped to ``max_history``.

Steps 2 and 3 are plain PyTorch, as the reference's are XLA: about 120
elementwise launches a reprojection.  The vectors are (B, 3) rows, as in
the reference; the 3x3 products are written out in the reference's sum
order and every division has a tensor divisor, so the CPU and the card
round alike.  The result is a film with per-pixel counts
(``render/film.py``), read once on the host for the largest count.
"""

from __future__ import annotations

import torch

from unity_webgpu_pathtracer_torch.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_torch.ops import get_intersectors
from unity_webgpu_pathtracer_torch.render.film import Film
from unity_webgpu_pathtracer_torch.utils.math import sqrt

DEPTH_REL_TOL = 0.03


def _wh(config: RenderConfig, device) -> torch.Tensor:
    return torch.tensor([config.width, config.height], dtype=torch.float32, device=device)


def _times_rows(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``v @ m`` for (B, 3) rows and a 3x3 ``m``, summed k = 0, 1, 2."""
    return v[:, 0:1] * m[0] + v[:, 1:2] * m[1] + v[:, 2:3] * m[2]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])


def _center_rays(config: RenderConfig, params: RenderParams):
    """Pinhole rays through the exact pixel centres: ``(o, d)``, (B, 3)."""
    dev = params.cam_to_world.device
    pixels = torch.arange(config.pixel_count(), dtype=torch.int32, device=dev)
    x = (pixels % config.width).to(torch.float32) + 0.5
    y = (pixels // config.width).to(torch.float32) + 0.5
    uv = torch.stack([x, y], dim=-1) / _wh(config, dev) * 2.0 - 1.0
    ip = params.cam_inv_proj
    dir_cam = uv[:, 0:1] * ip[:3, 0] + uv[:, 1:2] * ip[:3, 1] + ip[:3, 3]
    c2w = params.cam_to_world
    d = _times_rows(dir_cam, c2w[:3, :3].T)
    d = d / _norm(d)[:, None]
    return c2w[:3, 3].expand(d.shape), d


def primary_depth(scene, config: RenderConfig, params: RenderParams) -> torch.Tensor:
    """(H * W,) primary hit distance at the pixel centres; misses keep
    ``FAR_PLANE``."""
    o, d = _center_rays(config, params)
    closest_fn, _ = get_intersectors(config)
    t, _bary, _row, _inst = closest_fn(scene, o, d)
    return t


def _warp(accum, count, t_new, t_old, o_new, d_new, old_c2w, old_ip, wh,
          depth_rel_tol, max_history):
    """The old film (``accum`` (H, W, 3), ``count`` (H * W,) float32) at
    the new pixels: ``(accum (H, W, 3), counts (H, W, 1) int32)``."""
    h, w = accum.shape[:2]
    flat = accum.reshape(h * w, 3)
    p = o_new + d_new * t_new[:, None]
    rel = p - old_c2w[:3, 3]
    cam = _times_rows(rel, old_c2w[:3, :3])
    z = -cam[:, 2]
    front = z > 1e-6
    zs = torch.where(front, z, torch.ones_like(z))
    u = cam[:, 0] / (zs * old_ip[0, 0])
    v = cam[:, 1] / (zs * old_ip[1, 1])
    coords = (torch.stack([u, v], dim=-1) + 1.0) * 0.5 * wh
    dist = _norm(rel)

    gx = coords[:, 0] - 0.5
    gy = coords[:, 1] - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    dx = gx - x0
    dy = gy - y0
    xi0, yi0 = x0.to(torch.int32), y0.to(torch.int32)

    acc = torch.zeros_like(flat)
    cnt = torch.zeros_like(count)
    wsum = torch.zeros_like(count)
    for ox, oy, wgt in ((0, 0, (1 - dx) * (1 - dy)), (1, 0, dx * (1 - dy)),
                        (0, 1, (1 - dx) * dy), (1, 1, dx * dy)):
        xi = xi0 + ox
        yi = yi0 + oy
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)).long()
        t_tap = t_old[idx]
        agree = torch.abs(t_tap - dist) <= depth_rel_tol * dist
        wt = wgt * (inb & agree & front).to(torch.float32)
        acc = acc + wt[:, None] * flat[idx]
        cnt = cnt + wt * count[idx]
        wsum = wsum + wt

    valid = wsum > 0.25
    ws = torch.where(valid, wsum, torch.ones_like(wsum))
    warped = torch.where(valid[:, None], acc / ws[:, None], torch.zeros_like(acc))
    hist = torch.where(valid, cnt / ws, torch.zeros_like(cnt))
    hist = torch.minimum(hist, max_history).to(torch.int32)
    return warped.reshape(h, w, 3), hist.reshape(h, w, 1)


def reproject_film(scene, config: RenderConfig, film: Film, old_params: RenderParams,
                   new_params: RenderParams, max_history: int | None = None,
                   depth_rel_tol: float = DEPTH_REL_TOL) -> Film:
    """``film``, accumulated under ``old_params``, warped to ``new_params``:
    a film with per-pixel counts (disoccluded and off-screen pixels drop
    to 0 and restart).  Two K1 traversals of every pixel, the warp, and
    one host read (the largest count)."""
    dev = film.accum.device
    t_new = primary_depth(scene, config, new_params)
    t_old = primary_depth(scene, config, old_params)
    o_new, d_new = _center_rays(config, new_params)
    if film.pixel_counts is None:
        count = torch.full((config.pixel_count(),), float(film.sample_count),
                           dtype=torch.float32, device=dev)
    else:
        count = film.pixel_counts.to(torch.float32).reshape(-1)
    mh = torch.tensor(float(max_history if max_history is not None else 2 ** 30),
                      dtype=torch.float32, device=dev)
    tol = torch.tensor(depth_rel_tol, dtype=torch.float32, device=dev)
    accum, hist = _warp(film.accum, count, t_new, t_old, o_new, d_new,
                        old_params.cam_to_world, old_params.cam_inv_proj, _wh(config, dev),
                        tol, mh)
    return Film(accum, int(hist.max()), hist)
