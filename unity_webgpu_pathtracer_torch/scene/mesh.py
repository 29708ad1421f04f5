"""Triangle meshes and flattening (``scene/mesh.py`` of the reference).

Host-side numpy: flattening emits per-triangle vertex triples and
attributes, and ``tri_records`` the ``[e2, e1, v0]`` Möller-Trumbore
records the BVH builder and the leaf rows consume.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    """Host-side indexed triangle mesh."""

    vertices: np.ndarray                 # (V, 3) float32
    indices: np.ndarray                  # (F, 3) int32
    normals: np.ndarray | None = None    # (V, 3)
    tangents: np.ndarray | None = None   # (V, 3)
    uvs: np.ndarray | None = None        # (V, 2)
    material_index: int = 0

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, np.int32).reshape(-1, 3)
        if self.normals is not None:
            self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        if self.tangents is not None:
            self.tangents = np.asarray(self.tangents, np.float32).reshape(-1, 3)
        if self.uvs is not None:
            self.uvs = np.asarray(self.uvs, np.float32).reshape(-1, 2)

    @property
    def triangle_count(self) -> int:
        return self.indices.shape[0]

    def compute_vertex_normals(self) -> np.ndarray:
        """Area-weighted smooth normals for meshes that ship without them."""
        v = self.vertices
        f = self.indices
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        n = np.zeros_like(v)
        for k in range(3):
            np.add.at(n, f[:, k], fn)
        lens = np.linalg.norm(n, axis=-1, keepdims=True)
        return (n / np.maximum(lens, 1e-20)).astype(np.float32)


@dataclasses.dataclass
class FlatTriangles:
    """Flattened per-triangle arrays."""

    positions: np.ndarray   # (F, 3, 3) triangle vertices
    normals: np.ndarray     # (F, 3, 3)
    tangents: np.ndarray    # (F, 3, 3)
    uvs: np.ndarray         # (F, 3, 2)
    material: np.ndarray    # (F,) int32

    @property
    def count(self) -> int:
        return self.positions.shape[0]

    def tri_records(self) -> np.ndarray:
        """(F, 9) float32 ``[e2, e1, v0]`` intersection records."""
        v0 = self.positions[:, 0]
        e1 = self.positions[:, 1] - v0
        e2 = self.positions[:, 2] - v0
        return np.concatenate([e2, e1, v0], axis=-1).astype(np.float32)

    def permuted(self, order: np.ndarray) -> "FlatTriangles":
        """Rows in BVH reference order (repeats allowed)."""
        return FlatTriangles(
            positions=self.positions[order], normals=self.normals[order],
            tangents=self.tangents[order], uvs=self.uvs[order],
            material=self.material[order])


def flatten_mesh(mesh: Mesh, transform: np.ndarray | None = None) -> FlatTriangles:
    """Flatten one mesh, optionally transforming to world space (normals
    by the inverse transpose, ``MeshProcessing.compute:112-114``)."""
    f = mesh.indices
    v = mesh.vertices
    n = mesh.normals if mesh.normals is not None else mesh.compute_vertex_normals()
    t = mesh.tangents
    uv = mesh.uvs

    if transform is not None:
        m = np.asarray(transform, np.float64)
        v = (v @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
        nit = np.linalg.inv(m[:3, :3]).T
        n = n @ nit.T
        n = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)).astype(np.float32)
        if t is not None:
            t = (t @ m[:3, :3].T).astype(np.float32)

    fcount = f.shape[0]
    positions = v[f]
    normals = n[f]
    if t is None:
        tangents = np.zeros_like(normals)
        tangents[..., 0] = 1.0
    else:
        tangents = t[f]
    uvs = uv[f] if uv is not None else np.zeros((fcount, 3, 2), np.float32)
    return FlatTriangles(
        positions=positions.astype(np.float32),
        normals=normals.astype(np.float32),
        tangents=tangents.astype(np.float32),
        uvs=uvs.astype(np.float32),
        material=np.full((fcount,), mesh.material_index, np.int32),
    )


def concat_flat(parts: list[FlatTriangles]) -> FlatTriangles:
    return FlatTriangles(
        positions=np.concatenate([p.positions for p in parts], 0),
        normals=np.concatenate([p.normals for p in parts], 0),
        tangents=np.concatenate([p.tangents for p in parts], 0),
        uvs=np.concatenate([p.uvs for p in parts], 0),
        material=np.concatenate([p.material for p in parts], 0),
    )
