"""Per-lane vector math (``utils/math.py`` of the reference).

Functions take the vector on the LAST axis, as in the reference; dot
products are written in component form in the reference's order.  The
reference's ``gather_small`` (a one-hot matmul for small tables on the
TPU) is plain indexing here.
"""

from __future__ import annotations

import torch

EPSILON = 1.0e-4
PI = 3.14159265358979323
INV_PI = 0.31830988618379067
TWO_PI = 6.28318530717958648
INV_TWO_PI = 0.15915494309189533
FAR_PLANE = 1.0e5


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def normalize(v: torch.Tensor, eps: float = 1.0e-20) -> torch.Tensor:
    """``v * (1 / sqrt(max(dot(v, v), eps)))`` over the last axis."""
    return v * (1.0 / torch.sqrt(torch.clamp_min(dot(v, v), eps)))[..., None]


def luminance(color: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma (``common.hlsl:195-198``)."""
    return color[..., 0] * 0.299 + color[..., 1] * 0.587 + color[..., 2] * 0.114


def safe_rcp(v: torch.Tensor) -> torch.Tensor:
    """``1 / v`` with exact zeros nudged to 1e-30 (``common.hlsl:205``)."""
    return 1.0 / torch.where(v == 0.0, torch.full_like(v, 1.0e-30), v)
