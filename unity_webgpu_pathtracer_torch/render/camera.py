"""Camera matrices and primary rays (``render/camera.py`` of the reference;
``camera.hlsl:13-42``).  Camera space looks down -Z; ``cam_to_world``
columns are (right, up, back, eye).  With ``use_depth_of_field`` the rays
leave a thin lens of diameter ``aperture`` focused at ``focal_length``.
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.config import RenderConfig, RenderParams, params_from_numpy
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.math import TWO_PI, concentric_sample_disk, normalize, sqrt

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
                       aperture=0.0, focal_length=0.0, device=None, **kw) -> RenderParams:
    """RenderParams on ``device`` (None: the CUDA device; ``"cpu"`` for
    the CPU) for a look-at camera with a thin lens of diameter
    ``aperture`` focused at ``focal_length`` (either 0: a pinhole); ``kw``
    sets the other uniforms (environment intensity, seed_root, ...)."""
    return params_from_numpy(
        dict(cam_to_world=look_at(eye, target, up),
             cam_inv_proj=perspective_inverse(fov_y_deg, width / height),
             aperture=aperture, focal_length=focal_length, **kw),
        device)


def sample_gaussian(u: torch.Tensor, v: torch.Tensor):
    """Box-Muller 2D Gaussian (``PathTracer.compute:33-38``)."""
    r = sqrt(-2.0 * torch.log(torch.clamp_min(u, 1e-38)))
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
                   params: RenderParams, state: torch.Tensor):
    """World-space rays through the jittered pixel coordinates (B, 2):
    ``(origin (B, 3), direction (B, 3), state)``.  With
    ``use_depth_of_field`` a lens pair is drawn from ``state`` (after the
    jitter's, as in the reference) and the ray leaves a concentric disk
    sample on the lens toward the pinhole ray's point at ``focal_length``;
    a zero aperture or focal length keeps the pinhole ray."""
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
    direction = normalize(d)
    if config.use_depth_of_field:
        (u1, u2), state = urng.random_floats(state, 2)
        lens_u, lens_v = concentric_sample_disk(u1, u2)
        lens_radius = params.aperture * 0.5
        lens_u = lens_u * lens_radius
        lens_v = lens_v * lens_radius
        focal_point = origin + direction * params.focal_length
        lens_pos = lens_u[:, None] * c2w[:3, 0] + lens_v[:, None] * c2w[:3, 1] + c2w[:3, 3]
        dof_dir = normalize(focal_point - lens_pos)
        use = (params.aperture > 0.0) & (params.focal_length > 0.0)
        origin = torch.where(use, lens_pos, origin)
        direction = torch.where(use, dof_dir, direction)
    return origin, direction, state
