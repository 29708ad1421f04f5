"""Scene generators, one module a generator, named by a configuration's
``generator`` key; each ``generate(cfg)`` returns a :class:`SceneSpec`:
plain numpy arrays that the port (``pt_bench/port.py``) and the plain
reference (``pt_bench/reference/scene.py``) each turn into their own
tables."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass
class MeshSpec:
    vertices: np.ndarray            # (V, 3) float32
    indices: np.ndarray             # (F, 3) int32
    normals: np.ndarray             # (V, 3) float32
    uvs: np.ndarray                 # (V, 2) float32


@dataclasses.dataclass
class Placement:
    mesh: int                       # index into SceneSpec.meshes
    transform: np.ndarray           # (4, 4) float32, mesh -> world
    material: int                   # index into SceneSpec.materials


@dataclasses.dataclass
class SceneSpec:
    meshes: list
    placements: list
    materials: list                 # MaterialDesc keyword dicts
    env_image: np.ndarray           # (H, 2H, 3) float32 equirect
    camera: dict                    # eye, target, fov_y_deg
    instanced: bool                 # one BLAS a mesh and an instance a placement

    @property
    def triangle_count(self) -> int:
        return sum(self.meshes[p.mesh].indices.shape[0] for p in self.placements)


def generate(cfg: dict) -> SceneSpec:
    """The scene of a configuration, by its ``generator``."""
    return importlib.import_module(f"pt_bench.scenes.{cfg['generator']}").generate(cfg)
