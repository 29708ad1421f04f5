"""Scene assembly: host meshes -> device tables (``scene/scene.py`` of the
reference, the non-instanced ``build("wide16")`` branch).

``SceneData`` holds only what the main path reads: the wide16 node table
and its root slot table, the stack depth, the paired-f16 attribute rows,
the material records and the environment tables.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.accel import wide16 as w16
from unity_webgpu_pathtracer_torch.scene import material as umaterial
from unity_webgpu_pathtracer_torch.scene.envmap import EnvMap, build_envmap
from unity_webgpu_pathtracer_torch.scene.mesh import FlatTriangles, Mesh, concat_flat, flatten_mesh


def _pack_attr_shade_c(normals9: np.ndarray, uvs6: np.ndarray,
                       material: np.ndarray) -> np.ndarray:
    """Compact 32-byte per-triangle shading rows: 15 f16 halfwords
    [normals 9 | uvs 6] + one u16 material index, little-endian-packed
    into 8 uint32 words, padded to a multiple of 6 triangles."""
    t = normals9.shape[0]
    h = np.zeros((((t + 5) // 6) * 6, 16), np.uint16)
    h[:t, 0:9] = normals9.astype(np.float16).view(np.uint16)
    h[:t, 9:15] = np.clip(uvs6, -65504, 65504).astype(np.float16).view(np.uint16)
    m = material.astype(np.int64)
    if m.size and (m.max() > 0xFFFF or m.min() < 0):
        raise ValueError("compact attribute rows hold at most 65536 materials")
    h[:t, 15] = m.astype(np.uint16)
    return np.ascontiguousarray(h).view(np.uint32)   # (T_pad, 8)


class SceneData(NamedTuple):
    """Device tables of the main path."""

    wide16_nodes: torch.Tensor   # (N16, 96) float32 (ints bitcast)
    wide16_top: torch.Tensor     # (16, 119) root slot table, or (1, 119) placeholder
    stack_depth: int             # register-stack planes (tree depth + 1)
    attr_shade_c: torch.Tensor   # (T_pad, 8) int32 view of the uint32 rows
    materials: torch.Tensor      # (NM, 32) float32
    env: EnvMap


@dataclasses.dataclass
class Scene:
    """Host-side scene under construction."""

    meshes: list = dataclasses.field(default_factory=list)      # (Mesh, transform|None)
    materials: list = dataclasses.field(default_factory=list)   # MaterialDesc
    env_image: np.ndarray | None = None

    def add_material(self, desc: umaterial.MaterialDesc) -> int:
        self.materials.append(desc)
        return len(self.materials) - 1

    def add_mesh(self, mesh: Mesh, transform: np.ndarray | None = None) -> int:
        self.meshes.append((mesh, transform))
        return len(self.meshes) - 1

    def set_environment(self, image: np.ndarray) -> None:
        self.env_image = np.asarray(image, np.float32)

    def flatten(self) -> FlatTriangles:
        """World-space flattened triangle soup."""
        if not self.meshes:
            raise ValueError("scene has no meshes")
        return concat_flat([flatten_mesh(m, xf) for m, xf in self.meshes])

    def build_arrays(self) -> dict:
        """Host build of the device tables as numpy arrays (the layout of
        ``scene_from_numpy``'s input)."""
        if self.env_image is None:
            raise ValueError("the main path needs an HDRI environment "
                             "(Scene.set_environment)")
        flat = self.flatten()
        w = w16.build_scene_wide16(flat.positions, flat.tri_records())
        top = w16.derive_top16(w.nodes)
        # Leaf rows index attributes by BVH reference position.
        flat = flat.permuted(w.order)
        m = flat.count
        return dict(
            wide16_nodes=w.nodes,
            wide16_top=top if top is not None else np.zeros((1, w16.TOP_COLS), np.float32),
            stack_levels=np.zeros((w.depth + 1,), np.int32),
            attr_shade_c=_pack_attr_shade_c(flat.normals.reshape(m, 9),
                                            flat.uvs.reshape(m, 6), flat.material),
            materials=umaterial.pack_materials(self.materials or [umaterial.MaterialDesc()]),
            env=dict(build_envmap(self.env_image)._asdict()),
        )

    def build(self, traversal: str = "wide16", device="cpu") -> SceneData:
        """Build the wide16 tables and move them to ``device``."""
        if traversal != "wide16":
            raise ValueError(f"the PyTorch port builds only 'wide16', not {traversal!r}")
        return scene_from_numpy(self.build_arrays(), device)


def scene_from_numpy(arrays: dict, device="cpu") -> SceneData:
    """``SceneData`` from numpy arrays keyed by the reference's
    ``SceneData`` field names: ``wide16_nodes``, ``wide16_top``,
    ``stack_levels`` (only its length is read), ``attr_shade_c``,
    ``materials`` and ``env``, a dict of the ``EnvMap`` fields.  Tests
    feed it ``np.asarray`` of the JAX fields, so both packages trace the
    same tables."""
    def t(a, dtype=None):
        a = np.asarray(a)
        a = np.array(a if dtype is None else a.view(dtype), order="C")
        return torch.from_numpy(a).to(device)

    env = EnvMap(**{f: arrays["env"][f] for f in EnvMap._fields}).to_tensors(device)
    return SceneData(
        wide16_nodes=t(arrays["wide16_nodes"]),
        wide16_top=t(arrays["wide16_top"]),
        stack_depth=int(np.asarray(arrays["stack_levels"]).shape[0]),
        attr_shade_c=t(arrays["attr_shade_c"], np.int32),
        materials=t(arrays["materials"]),
        env=env,
    )


def scene_to_numpy(scene: SceneData) -> dict:
    """Inverse of ``scene_from_numpy`` (attribute rows as uint32)."""
    def n(x):
        return x.detach().cpu().numpy()

    return dict(
        wide16_nodes=n(scene.wide16_nodes),
        wide16_top=n(scene.wide16_top),
        stack_levels=np.zeros((scene.stack_depth,), np.int32),
        attr_shade_c=n(scene.attr_shade_c).view(np.uint32),
        materials=n(scene.materials),
        env={f: n(getattr(scene.env, f)) for f in EnvMap._fields},
    )
