# Frozen copy of unity_webgpu_pathtracer_torch/utils/math.py at commit 628fc1bc0151d37c4767d2275c25b153616afc0d,
# imports rewritten to this package; the benchmark's yardstick, not to be edited with the port.
"""Per-lane vector math (``utils/math.py`` of the reference).

Two dialects.  The first functions take the vector on the LAST axis, as in
the reference; dot products are written in component form in the
reference's order.  The ``v*`` functions take lane vectors as planes: any
``v`` with ``v[0]``, ``v[1]``, ``v[2]`` of shape (B,) (a 3-tuple of
tensors or a (3, B) tensor), and return 3-tuples.  The shading code (the
transitions and the BSDF) is written in planes, the layout the kernels
read.  The reference's ``gather_small`` (a one-hot matmul for small tables
on the TPU) is plain indexing here.
"""

from __future__ import annotations

import torch

EPSILON = 1.0e-4
PI = 3.14159265358979323
INV_PI = 0.31830988618379067
TWO_PI = 6.28318530717958648
INV_TWO_PI = 0.15915494309189533
FAR_PLANE = 1.0e5


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as the CUDA kernels' ``sqrtf``.

    On a CUDA tensor this is ``torch.sqrt``, which is IEEE there.  On a
    CPU tensor ``torch.sqrt`` of f32 is not correctly rounded on every
    host (its vectorised path can be an ulp off), so the root is taken
    in f64 and rounded once to the input's type: exact for f32, since
    53 >= 2 * 24 + 2."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def normalize(v: torch.Tensor, eps: float = 1.0e-20) -> torch.Tensor:
    """``v * (1 / sqrt(max(dot(v, v), eps)))`` over the last axis."""
    return v * (1.0 / sqrt(torch.clamp_min(dot(v, v), eps)))[..., None]


def luminance(color: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma (``common.hlsl:195-198``)."""
    return color[..., 0] * 0.299 + color[..., 1] * 0.587 + color[..., 2] * 0.114


def length(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis."""
    return sqrt(torch.clamp_min(dot(v, v), 0.0))


def concentric_sample_disk(u1: torch.Tensor, u2: torch.Tensor):
    """Concentric square -> disk map (``common.hlsl:285-341``), branch-free
    as in the reference; returns ``(dx, dy)`` on the unit disk (the thin
    lens's sample)."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    one = torch.ones_like(sx)

    def nz(r):
        return torch.where(r == 0, one, r)

    r1_cond = sx >= -sy
    r_a = torch.where(sx > sy, sx, sy)                     # regions 1/2
    theta_a = torch.where(sx > sy,
                          torch.where(sy > 0.0, sy / nz(r_a), 8.0 + sy / nz(r_a)),
                          2.0 - sx / nz(r_a))
    r_b = torch.where(sx <= sy, -sx, -sy)                  # regions 3/4
    theta_b = torch.where(sx <= sy, 4.0 - sy / nz(r_b), 6.0 + sx / nz(r_b))
    r = torch.where(r1_cond, r_a, r_b)
    theta = torch.where(r1_cond, theta_a, theta_b) * (PI / 4.0)
    degenerate = (sx == 0.0) & (sy == 0.0)
    zero = torch.zeros_like(sx)
    return (torch.where(degenerate, zero, r * torch.cos(theta)),
            torch.where(degenerate, zero, r * torch.sin(theta)))


def safe_rcp(v: torch.Tensor) -> torch.Tensor:
    """``1 / v`` with exact zeros nudged to 1e-30 (``common.hlsl:205``)."""
    return 1.0 / torch.where(v == 0.0, torch.full_like(v, 1.0e-30), v)


# ---- planes dialect ----

def vdot(a, b) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b) -> tuple:
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def vadd(a, b) -> tuple:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vscale(a, s) -> tuple:
    return (a[0] * s, a[1] * s, a[2] * s)


def vneg(a) -> tuple:
    return (-a[0], -a[1], -a[2])


def vwhere(m: torch.Tensor, a, b) -> tuple:
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]))


def vnormalize(v, eps: float = 1.0e-20) -> tuple:
    return vscale(v, 1.0 / sqrt(torch.clamp_min(vdot(v, v), eps)))


def vluminance(c) -> torch.Tensor:
    return c[0] * 0.299 + c[1] * 0.587 + c[2] * 0.114


def vreflect(i, n) -> tuple:
    d = vdot(i, n)
    return (i[0] - 2.0 * d * n[0], i[1] - 2.0 * d * n[1], i[2] - 2.0 * d * n[2])


def vrefract(i, n, eta) -> tuple:
    """Refracted direction, zero on total internal reflection."""
    cos_i = -vdot(i, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    coef = eta * cos_i - sqrt(torch.clamp_min(k, 0.0))
    refr = (eta * i[0] + coef * n[0], eta * i[1] + coef * n[1],
            eta * i[2] + coef * n[2])
    zero = torch.zeros_like(k)
    return vwhere(k < 0.0, (zero, zero, zero), refr)


def safe_div(a, b, eps: float = 1e-20):
    """``a / b`` with ``|b| < eps`` replaced by ``+-eps``."""
    return a / torch.where(torch.abs(b) < eps,
                           torch.where(b < 0, torch.full_like(b, -eps),
                                       torch.full_like(b, eps)), b)


def build_onb(z) -> tuple:
    """Orthonormal basis ``(x, y, z)`` around ``z`` (``common.hlsl``'s
    branch-free frame; a zero ``z`` gets the identity frame)."""
    len_sq = vdot(z, z)
    zn = vnormalize(z)
    zx, zy, zz = zn
    k = 1.0 / torch.clamp_min(1.0 + zz, 1.0e-5)
    a = zy * k
    b = zy * a
    c = -zx * a
    x = vnormalize((zz + b, c, -zx))
    y = vnormalize((c, 1.0 - b, -zy))
    deg = len_sq == 0.0
    one, zero = torch.ones_like(zx), torch.zeros_like(zx)
    return (vwhere(deg, (one, zero, zero), x), vwhere(deg, (zero, one, zero), y),
            vwhere(deg, (zero, zero, one), zn))


def to_local(onb, w) -> tuple:
    x, y, z = onb
    return (vdot(x, w), vdot(y, w), vdot(z, w))


def to_world(onb, local) -> tuple:
    x, y, z = onb
    return (x[0] * local[0] + y[0] * local[1] + z[0] * local[2],
            x[1] * local[0] + y[1] * local[1] + z[1] * local[2],
            x[2] * local[0] + y[2] * local[1] + z[2] * local[2])
