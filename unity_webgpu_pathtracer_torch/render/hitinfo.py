"""Instance hooks of hit shading (``render/hitinfo.py`` of the reference):
a hit inside an instance has its BLAS-local shading normal taken to world
space, and the instance's material, when it has one, replaces the
triangle's.  Normals are planes (``utils/math.py``)."""

from __future__ import annotations

import torch

from unity_webgpu_pathtracer_torch.utils.math import vnormalize, vwhere


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
