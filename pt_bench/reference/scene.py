"""The reference's own tables, worked out from the benchmark's scene arrays
(``pt_bench.scenes.SceneSpec``): every placement flattened to world-space
triangles (a two-level scene too), their per-vertex shading attributes, the
packed materials, the texture atlas and the analytic lights' records, the
environment's sampling tables, and clusters of consecutive triangles with
their boxes for the intersector.  Nothing here reads a table of the
program."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pt_bench.reference.envmap import EnvMap, build_envmap
from pt_bench.reference.lightpack import LightDesc, pack_lights
from pt_bench.reference.material import MaterialDesc, pack_materials
from pt_bench.reference.texture import build_atlas

# Triangles a cluster (``intersect.py`` tests a ray against the clusters'
# boxes, then against every triangle of a cluster it enters).
CLUSTER = 128


class RefScene(NamedTuple):
    v0: torch.Tensor             # (T, 3) world-space triangle corners
    e1: torch.Tensor             # (T, 3) v1 - v0
    e2: torch.Tensor             # (T, 3) v2 - v0
    box_lo: torch.Tensor         # (K, 3) cluster boxes over CLUSTER triangles each
    box_hi: torch.Tensor
    # The attributes the frozen shading reads, under the port's field names.
    tri_index: torch.Tensor      # (T,) int32 identity
    attr_normals: torch.Tensor   # (T, 9)
    attr_tangents: torch.Tensor  # (T, 9)
    attr_uvs: torch.Tensor       # (T, 6)
    attr_material: torch.Tensor  # (T,) int32
    materials: torch.Tensor      # (M, 32)
    texture_data: torch.Tensor   # (K,) int32 view of the uint32 atlas; (0,) no textures
    lights: torch.Tensor         # (L, 16) light records; (0, 16) no analytic lights
    inst_w2l: torch.Tensor       # (0, 12): world-space triangles, no instances
    inst_offsets: torch.Tensor   # (0, 4)
    env: EnvMap


def flatten(spec) -> dict:
    """World-space per-triangle arrays of every placement (normals through
    the inverse transpose, renormalized)."""
    pos, nrm, uvs, mat = [], [], [], []
    for p in spec.placements:
        m = spec.meshes[p.mesh]
        xf = np.asarray(p.transform, np.float64)
        v = (m.vertices @ xf[:3, :3].T + xf[:3, 3]).astype(np.float32)
        n = m.normals @ np.linalg.inv(xf[:3, :3])
        n = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)).astype(np.float32)
        pos.append(v[m.indices])
        nrm.append(n[m.indices])
        uvs.append(m.uvs[m.indices])
        mat.append(np.full((m.indices.shape[0],), p.material, np.int32))
    return dict(positions=np.concatenate(pos), normals=np.concatenate(nrm),
                uvs=np.concatenate(uvs), material=np.concatenate(mat))


def build(spec, device) -> RefScene:
    flat = flatten(spec)
    p = torch.from_numpy(flat["positions"]).to(device)            # (T, 3, 3)
    t = p.shape[0]
    v0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    k = -(-t // CLUSTER)
    pad = k * CLUSTER - t
    corners = torch.cat([p, p[-1:].expand(pad, 3, 3)]).reshape(k, CLUSTER * 3, 3)
    tangents = torch.zeros((t, 3, 3), dtype=torch.float32, device=device)
    tangents[..., 0] = 1.0

    def desc(d):
        return {a: tuple(b) if isinstance(b, list) else b for a, b in d.items()}

    mats = [MaterialDesc(**desc(m)) for m in spec.materials]
    if spec.textures:
        atlas = torch.from_numpy(build_atlas(spec.textures).view(np.int32)).to(device)
    else:
        atlas = torch.zeros((0,), dtype=torch.float32, device=device)
    if spec.lights:
        lights = torch.from_numpy(pack_lights([LightDesc(**desc(x)) for x in spec.lights]))
    else:
        lights = torch.zeros((0, 16), dtype=torch.float32)
    return RefScene(
        v0=v0.contiguous(), e1=e1.contiguous(), e2=e2.contiguous(),
        box_lo=corners.amin(1), box_hi=corners.amax(1),
        tri_index=torch.arange(t, dtype=torch.int32, device=device),
        attr_normals=torch.from_numpy(flat["normals"].reshape(t, 9)).to(device),
        attr_tangents=tangents.reshape(t, 9),
        attr_uvs=torch.from_numpy(flat["uvs"].reshape(t, 6)).to(device),
        attr_material=torch.from_numpy(flat["material"]).to(device),
        materials=torch.from_numpy(pack_materials(mats)).to(device),
        texture_data=atlas,
        lights=lights.to(device),
        inst_w2l=torch.zeros((0, 12), dtype=torch.float32, device=device),
        inst_offsets=torch.zeros((0, 4), dtype=torch.int32, device=device),
        env=build_envmap(spec.env_image).to_tensors(device))
