"""Microfacet distributions, Fresnel terms, hemisphere/sphere samplers and
the MIS weight (``render/sampling.py`` of the reference;
``sampling.hlsl``), on (B,) tensors; directions come back as planes
3-tuples (``utils/math.py``)."""

from __future__ import annotations

import torch

from unity_webgpu_pathtracer_torch.utils.math import (
    INV_PI,
    TWO_PI,
    build_onb,
    sqrt,
    to_world,
    vcross,
    vnormalize,
    vwhere,
)

_PI32 = 3.14159265358979323
INV_4_PI = 0.07957747154594766


def _nz(x: torch.Tensor) -> torch.Tensor:
    """``where(x == 0, 1, x)``: the reference's guarded denominators."""
    return torch.where(x == 0.0, torch.ones_like(x), x)


def gtr1(n_dot_h, a):
    """Berry/GTR1 NDF for clearcoat (``sampling.hlsl:6-18``); a >= 1 -> 1/pi."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    d = (a2 - 1.0) / (_PI32 * torch.log(a2) * t)
    return torch.where(a >= 1.0, torch.full_like(d, INV_PI), d)


def sample_gtr1(rgh, r1, r2) -> tuple:
    a = torch.clamp_min(rgh, 0.001)
    a2 = a * a
    phi = r1 * TWO_PI
    cos_theta = sqrt(torch.clamp_min(
        (1.0 - torch.pow(a2, 1.0 - r2)) / (1.0 - a2), 0.0))
    sin_theta = torch.clamp(sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0)),
                            0.0, 1.0)
    return (sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)


def gtr2(n_dot_h, a):
    """Isotropic GGX/GTR2 NDF (``sampling.hlsl:35-40``)."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    return a2 / (_PI32 * t * t)


def gtr2_aniso(n_dot_h, h_dot_x, h_dot_y, ax, ay):
    a = h_dot_x / ax
    b = h_dot_y / ay
    c = a * a + b * b + n_dot_h * n_dot_h
    return 1.0 / (_PI32 * ax * ay * c * c)


def sample_ggx_vndf(v, ax, ay, r1, r2) -> tuple:
    """Heitz's visible-normal sample of the anisotropic GGX lobe."""
    vh = vnormalize((ax * v[0], ay * v[1], v[2]))
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    inv_len = 1.0 / sqrt(torch.clamp_min(lensq, 1e-20))
    one, zero = torch.ones_like(lensq), torch.zeros_like(lensq)
    t1 = vwhere(lensq > 0.0, (-vh[1] * inv_len, vh[0] * inv_len, zero), (one, zero, zero))
    t2 = vcross(vh, t1)
    r = sqrt(r1)
    phi = TWO_PI * r2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[2])
    p2 = (1.0 - s) * sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = (p1 * t1[0] + p2 * t2[0] + p3 * vh[0],
          p1 * t1[1] + p2 * t2[1] + p3 * vh[1],
          p1 * t1[2] + p2 * t2[2] + p3 * vh[2])
    return vnormalize((ax * nh[0], ay * nh[1], torch.clamp_min(nh[2], 0.0)))


def smith_g(n_dot_v, alpha_g):
    a = alpha_g * alpha_g
    b = n_dot_v * n_dot_v
    return (2.0 * n_dot_v) / (n_dot_v + sqrt(torch.clamp_min(a + b - a * b, 0.0)))


def smith_g_aniso(n_dot_v, v_dot_x, v_dot_y, ax, ay):
    a = v_dot_x * ax
    b = v_dot_y * ay
    c = n_dot_v
    return (2.0 * n_dot_v) / (n_dot_v + sqrt(torch.clamp_min(a * a + b * b + c * c, 0.0)))


def schlick_weight(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def dielectric_fresnel(cos_theta_i, eta):
    sin2_t = eta * eta * (1.0 - cos_theta_i * cos_theta_i)
    cos_t = sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    rs = (eta * cos_t - cos_theta_i) / _nz(eta * cos_t + cos_theta_i)
    rp = (eta * cos_theta_i - cos_t) / _nz(eta * cos_theta_i + cos_t)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(sin2_t > 1.0, torch.ones_like(f), f)


def cosine_sample_hemisphere(r1, r2) -> tuple:
    r = sqrt(r1)
    phi = TWO_PI * r2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0))
    return (x, y, z)


def uniform_sample_hemisphere(r1, r2) -> tuple:
    """Uniform direction on the +z hemisphere, ``r1`` its cosine."""
    r = sqrt(torch.clamp_min(1.0 - r1 * r1, 0.0))
    phi = TWO_PI * r2
    return (r * torch.cos(phi), r * torch.sin(phi), r1)


def uniform_sample_sphere(r1, r2) -> tuple:
    z = 1.0 - 2.0 * r1
    r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * r2
    return (r * torch.cos(phi), r * torch.sin(phi), z)


def power_heuristic(a, b):
    """Beta=2 MIS weight (``sampling.hlsl:163-167``)."""
    t = a * a
    return t / _nz(b * b + t)


def sample_hg(v, g, r1, r2) -> tuple:
    """Henyey-Greenstein phase sample about the planes ``v``
    (``sampling.hlsl:169-191``); the reference's volumetric plumbing, which
    no integrator calls."""
    g = torch.as_tensor(g, dtype=torch.float32, device=r2.device)
    sqr_term = (1.0 - g * g) / torch.clamp_min(1.0 + g - 2.0 * g * r2, 1e-6)
    cos_aniso = -(1.0 + g * g - sqr_term * sqr_term) / torch.where(
        torch.abs(g) < 1e-6, torch.ones_like(g), 2.0 * g)
    cos_theta = torch.where(torch.abs(g) < 0.001, 1.0 - 2.0 * r2, cos_aniso)
    phi = r1 * TWO_PI
    sin_theta = torch.clamp(sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0)), 0.0, 1.0)
    local = (sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)
    return to_world(build_onb(v), local)


def phase_hg(cos_theta, g):
    """The Henyey-Greenstein phase function (``sampling.hlsl:193-197``)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4_PI * (1.0 - g * g) / (denom * sqrt(torch.clamp_min(denom, 1e-12)))
