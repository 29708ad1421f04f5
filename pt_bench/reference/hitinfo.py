# Frozen copy of unity_webgpu_pathtracer_torch/render/hitinfo.py at commit 628fc1bc0151d37c4767d2275c25b153616afc0d,
# imports rewritten to this package; the benchmark's yardstick, not to be edited with the port.
"""Hit records and shading preparation (``render/hitinfo.py`` of the
reference).

``HitInfo`` is the batched analogue of the reference's ``RayHit``
(``common.hlsl:173-193``); :func:`shade_prep` interpolates the triangle
attributes by barycentrics and face-forwards the normal
(``bvh.hlsl:201-212``), and :func:`intersect_analytic_lights` adds the
rect-light hits (``util/intersect.hlsl:29-54``).  A hit inside an
instance has its BLAS-local shading normal taken to world space, and the
instance's material, when it has one, replaces the triangle's.  Lane
vectors are planes (``utils/math.py``): 3-tuples of (B,) tensors or
(3, B) tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pt_bench.reference.vmath import (
    EPSILON,
    FAR_PLANE,
    vcross,
    vdot,
    vneg,
    vnormalize,
    vwhere,
)

INTERSECT_TRIANGLE = 0
INTERSECT_LIGHT = 1


class HitInfo(NamedTuple):
    t: torch.Tensor               # (B,)
    position: tuple               # planes
    normal: tuple                 # interpolated shading normal
    ffnormal: tuple               # face-forward normal
    tangent: tuple
    uv: tuple                     # 2 planes
    material: torch.Tensor        # (B,) int32
    intersect_type: torch.Tensor  # (B,) int32 (0 triangle, 1 light)
    light_index: torch.Tensor     # (B,) int32 (valid when intersect_type == 1)
    valid: torch.Tensor           # (B,) bool


def instance_normal_to_world(scene, inst: torch.Tensor, normal) -> tuple:
    """``normal`` through the instance's inverse transpose
    (``tlas.hlsl:223``: ``mul(float4(n, 0), worldToLocal)``); lanes with
    ``inst < 0`` keep theirs."""
    w = scene.inst_w2l[torch.clamp_min(inst, 0).long()].T      # (12, B)
    n = (w[0] * normal[0] + w[4] * normal[1] + w[8] * normal[2],
         w[1] * normal[0] + w[5] * normal[1] + w[9] * normal[2],
         w[2] * normal[0] + w[6] * normal[1] + w[10] * normal[2])
    return vwhere(inst >= 0, vnormalize(n), normal)


def instance_material_override(scene, inst: torch.Tensor,
                               material: torch.Tensor) -> torch.Tensor:
    """The instance's material wins over the triangle's when set
    (``tlas.hlsl:230``)."""
    override = scene.inst_offsets[torch.clamp_min(inst, 0).long(), 3]
    return torch.where((inst >= 0) & (override >= 0), override, material)


def _interp(bary: torch.Tensor, attr: torch.Tensor, width: int) -> tuple:
    """Barycentric interpolation of (B, 3 * width) rows of per-vertex
    attributes: ``width`` planes ``a0 * w0 + a1 * b0 + a2 * b1``."""
    a = attr.T
    b0, b1 = bary[:, 0], bary[:, 1]
    w0 = 1.0 - b0 - b1
    return tuple(a[c] * w0 + a[width + c] * b0 + a[2 * width + c] * b1 for c in range(width))


def _face_forward(normal, directions) -> tuple:
    return vwhere(vdot(normal, directions) <= 0.0, normal, vneg(normal))


def shade_prep(scene, origins, directions, t: torch.Tensor, bary: torch.Tensor,
               slot: torch.Tensor, inst: torch.Tensor | None = None) -> HitInfo:
    """Gather and interpolate the attributes of triangle hits; ``slot``
    indexes ``scene.tri_index`` (-1 on a miss)."""
    row = scene.tri_index[torch.clamp_min(slot, 0).long()].long()
    normal = vnormalize(_interp(bary, scene.attr_normals[row], 3))
    tangent = vnormalize(_interp(bary, scene.attr_tangents[row], 3))
    uv = _interp(bary, scene.attr_uvs[row], 2)
    material = scene.attr_material[row]
    if inst is not None and scene.inst_w2l.shape[0] > 0:
        normal = instance_normal_to_world(scene, inst, normal)
        tangent = instance_normal_to_world(scene, inst, tangent)
        material = instance_material_override(scene, inst, material)
    valid = (slot >= 0) & (t < FAR_PLANE)
    position = tuple(origins[c] + t * directions[c] for c in range(3))
    return HitInfo(t=t, position=position, normal=normal,
                   ffnormal=_face_forward(normal, directions), tangent=tangent, uv=uv,
                   material=material, intersect_type=torch.zeros_like(slot),
                   light_index=torch.full_like(slot, -1), valid=valid)


def _analytic_light_hit(lights: torch.Tensor, o, d, t: torch.Tensor):
    """The closest rect-light hit before ``t`` along ``(o, d)`` (planes)
    (``intersect.hlsl:29-54``): ``(hit (B,), t_light (B,), index (B,)
    int32)``.  The reference tests the lights in index order, each taking
    the lane when strictly nearer than the best so far; here every light
    is tested at once on (L, B) planes, and the first index of the
    nearest hit wins, which is the same light (the lowest index wins a
    tie, as there)."""
    b = t.shape[0]
    idx = torch.full((b,), -1, dtype=torch.int32, device=t.device)
    if lights.shape[0] == 0:
        return idx >= 0, t, idx
    rec = lights[:, :, None]                                     # (L, 16, 1)
    pos, u, v = (rec[:, 0], rec[:, 1], rec[:, 2]), (rec[:, 8], rec[:, 9], rec[:, 10]), \
        (rec[:, 12], rec[:, 13], rec[:, 14])
    n = vnormalize(vcross(u, v))
    dt = vdot(d, n)                                              # (L, B)
    tt = (vdot(n, pos) - vdot(o, n)) / torch.where(dt == 0, torch.full_like(dt, 1e-20), dt)
    vi = tuple(o[c] + d[c] * tt - pos[c] for c in range(3))
    uu, vv = torch.clamp_min(vdot(u, u), 1e-20), torch.clamp_min(vdot(v, v), 1e-20)
    a1 = vdot(tuple(u[c] / uu for c in range(3)), vi)
    a2 = vdot(tuple(v[c] / vv for c in range(3)), vi)
    hit = ((rec[:, 3] == 3.0) & (tt > EPSILON) & (tt < t) & (a1 >= 0) & (a1 <= 1)
           & (a2 >= 0) & (a2 <= 1) & (dt < 0))
    t_all = torch.where(hit, tt, torch.full_like(tt, float("inf")))
    t_min, first = torch.min(t_all, dim=0)    # ties: the first index (PyTorch's min)
    lhit = hit.any(dim=0)
    return lhit, torch.where(lhit, t_min, t), torch.where(lhit, first.to(torch.int32), idx)


def intersect_analytic_lights(scene, origins, directions, hit: HitInfo) -> HitInfo:
    """Rect lights nearer than the triangle hit take the lane
    (``intersect.hlsl:29-54``): its ``t``, the light's plane normal, type
    ``INTERSECT_LIGHT`` and index; the position and face-forward normal
    are recomputed for every lane, as in the reference."""
    lhit, t, idx = _analytic_light_hit(scene.lights, origins, directions, hit.t)
    normal = hit.normal
    if scene.lights.shape[0] > 0:
        rec = scene.lights[torch.clamp_min(idx, 0).long()].T    # (16, B)
        n = vnormalize(vcross((rec[8], rec[9], rec[10]), (rec[12], rec[13], rec[14])))
        normal = vwhere(lhit, n, normal)
    itype = torch.where(lhit, torch.full_like(hit.intersect_type, INTERSECT_LIGHT),
                        hit.intersect_type)
    position = tuple(origins[c] + t * directions[c] for c in range(3))
    return hit._replace(t=t, position=position, normal=normal,
                        ffnormal=_face_forward(normal, directions),
                        light_index=torch.where(lhit, idx, hit.light_index),
                        intersect_type=itype, valid=hit.valid | (itype == INTERSECT_LIGHT))
