"""Brute-force ray/triangle intersection (``ops/intersect.py`` of the
reference): every ray against every triangle, the oracle the wide16
traversal is tested against.

Triangles are ``(M, 9)`` records ``[e2, e1, v0]`` (``e2 = v2 - v0``,
``e1 = v1 - v0``); the test is the traversal's Möller-Trumbore with the
same determinant cut-off and minimum distance.
"""

from __future__ import annotations

import torch

from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import DET_EPS, T_MIN
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE


def moller_trumbore(tris: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor):
    """All pairs: ``(t, u, v)``, each (B, M), ``t = FAR_PLANE`` where there
    is no hit."""
    e2, e1, v0 = tris[None, :, 0:3], tris[None, :, 3:6], tris[None, :, 6:9]
    o, d = origins[:, None, :], directions[:, None, :]
    r = torch.linalg.cross(d, e2)                                # (B, M, 3)
    a = (e1 * r).sum(-1)
    f = 1.0 / torch.where(torch.abs(a) < DET_EPS, torch.ones_like(a), a)
    s = o - v0
    u = f * (s * r).sum(-1)
    q = torch.linalg.cross(s, e1)
    v = f * (d * q).sum(-1)
    t = f * (e2 * q).sum(-1)
    valid = ((torch.abs(a) > DET_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > T_MIN))
    return torch.where(valid, t, torch.full_like(t, FAR_PLANE)), u, v


def closest_hit_bruteforce(tris: torch.Tensor, origins: torch.Tensor,
                           directions: torch.Tensor):
    """Closest hit over all triangles: ``(t, bary (B, 2), triangle (B,),
    instance (B,))``, triangle -1 on a miss, instance always -1."""
    t, u, v = moller_trumbore(tris, origins, directions)
    slot = torch.argmin(t, dim=-1, keepdim=True)
    t_best = t.gather(1, slot)[:, 0]
    bary = torch.cat([u.gather(1, slot), v.gather(1, slot)], dim=-1)
    slot = torch.where(t_best < FAR_PLANE, slot[:, 0], -1).to(torch.int32)
    return t_best, bary, slot, torch.full_like(slot, -1)


def occluded_bruteforce(tris: torch.Tensor, origins: torch.Tensor,
                        directions: torch.Tensor, t_max: torch.Tensor) -> torch.Tensor:
    """Whether any triangle is hit before ``t_max`` (B,)."""
    t, _u, _v = moller_trumbore(tris, origins, directions)
    return (t < t_max[:, None]).any(dim=-1)
