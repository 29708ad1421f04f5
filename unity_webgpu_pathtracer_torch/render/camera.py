"""Camera matrices and primary rays (``render/camera.py`` of the reference;
``camera.hlsl:13-42``).  Camera space looks down -Z; ``cam_to_world``
columns are (right, up, back, eye).  Pinhole only: the port's config
refuses depth of field.
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.config import RenderConfig, RenderParams, params_from_numpy
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.math import TWO_PI, normalize

# AA jitter stddev in pixels (PathTracer.compute:25-31).
ANTIALIASING_STD = 0.4246609


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix with -Z forward."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = eye
    return m.astype(np.float32)


def perspective_inverse(fov_y_deg: float, aspect: float) -> np.ndarray:
    """Inverse projection: NDC ``(u, v, 0, 1)`` -> -Z camera ray."""
    t = float(np.tan(np.radians(fov_y_deg) * 0.5))
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = t * aspect
    m[1, 1] = t
    m[2, 3] = -1.0
    m[3, 3] = 1.0
    return m


def make_camera_params(eye, target, fov_y_deg, width, height, up=(0, 1, 0),
                       device=None, **kw) -> RenderParams:
    """RenderParams on ``device`` (None: the CUDA device; ``"cpu"`` for
    the CPU) for a look-at pinhole camera; ``kw`` sets the other uniforms
    (environment intensity, seed_root, ...)."""
    return params_from_numpy(
        dict(cam_to_world=look_at(eye, target, up),
             cam_inv_proj=perspective_inverse(fov_y_deg, width / height), **kw),
        device)


def sample_gaussian(u: torch.Tensor, v: torch.Tensor):
    """Box-Muller 2D Gaussian (``PathTracer.compute:33-38``)."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u, 1e-38)))
    theta = TWO_PI * v
    return r * torch.cos(theta), r * torch.sin(theta)


def jittered_pixel_coords(pixel_index: torch.Tensor, config: RenderConfig,
                          state: torch.Tensor):
    """Pixel centers + Gaussian AA jitter; returns ``(coords (B, 2), state)``."""
    x = (pixel_index % config.width).to(torch.float32)
    y = (pixel_index // config.width).to(torch.float32)
    (u, v), state = urng.random_floats(state, 2)
    gx, gy = sample_gaussian(u, v)
    coords = torch.stack([x + 0.5 + ANTIALIASING_STD * gx,
                          y + 0.5 + ANTIALIASING_STD * gy], dim=-1)
    return coords, state


def get_screen_ray(pixel_coords: torch.Tensor, config: RenderConfig,
                   params: RenderParams):
    """World-space pinhole rays: ``(origin (B, 3), direction (B, 3))``."""
    c2w = params.cam_to_world
    origin = c2w[:3, 3].expand(pixel_coords.shape[0], 3)
    u = pixel_coords[:, 0:1] / config.width * 2.0 - 1.0
    v = pixel_coords[:, 1:2] / config.height * 2.0 - 1.0
    ip = params.cam_inv_proj
    dir_cam = u * ip[:3, 0] + v * ip[:3, 1] + ip[:3, 3]
    # dir_cam @ c2w[:3, :3].T, written out in the reference's sum order.
    r = c2w[:3, :3]
    d = (dir_cam[:, 0:1] * r[:, 0] + dir_cam[:, 1:2] * r[:, 1]
         + dir_cam[:, 2:3] * r[:, 2])
    return origin, normalize(d)
