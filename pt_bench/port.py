"""The system under test: the port (``unity_webgpu_pathtracer_torch``) driven
through its public API, from the benchmark's own scene arrays.

Nothing else in ``pt_bench`` imports the port, and the plain reference
(``pt_bench/reference``) never imports this module.
"""

from __future__ import annotations

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.api import Renderer
from unity_webgpu_pathtracer_torch.config import RenderConfig
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
from unity_webgpu_pathtracer_torch.scene.mesh import Mesh
from unity_webgpu_pathtracer_torch.scene.scene import Scene


def load_kernels(device: torch.device) -> None:
    """Build or load the CUDA kernel libraries and the native BVH builder
    (each is built once a checkout, in the package's own build directory)."""
    from unity_webgpu_pathtracer_torch.accel import native

    native.available()
    if device.type == "cuda":
        from unity_webgpu_pathtracer_torch.ops import cuda_build

        cuda_build.load()


def port_scene(spec) -> Scene:
    """The spec as the port's host ``Scene``: flat (every placement a mesh
    with its transform and material) or two-level (a mesh once, an instance
    a placement with its material)."""
    scene = Scene()
    for m in spec.materials:
        scene.add_material(MaterialDesc(**{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in m.items()}))
    if spec.instanced:
        first_mat = {}
        for p in spec.placements:
            first_mat.setdefault(p.mesh, p.material)
        ids = [scene.add_mesh(Mesh(vertices=m.vertices, indices=m.indices, normals=m.normals,
                                   uvs=m.uvs, material_index=first_mat.get(i, 0)))
               for i, m in enumerate(spec.meshes)]
        for p in spec.placements:
            scene.add_instance(ids[p.mesh], p.transform, p.material)
    else:
        for p in spec.placements:
            m = spec.meshes[p.mesh]
            scene.add_mesh(Mesh(vertices=m.vertices, indices=m.indices, normals=m.normals,
                                uvs=m.uvs, material_index=p.material), p.transform)
    scene.set_environment(spec.env_image)
    return scene


def render_config(cfg: dict, traffic: dict, width: int, height: int) -> RenderConfig:
    return RenderConfig(width=width, height=height,
                        samples_per_pass=traffic["samples_per_pass"],
                        integrator=traffic["integrator"],
                        pool_size=traffic.get("pool_size", 0),
                        **cfg["render"])


class PortRenderer:
    """The cell's renderer on one card, built in set-up and driven by the
    window: ``api.Renderer``."""

    def __init__(self, spec, cfg: dict, traffic: dict, width: int, height: int,
                 seed_root: int, device: torch.device):
        self.config = render_config(cfg, traffic, width, height)
        params = make_camera_params(width=width, height=height, seed_root=seed_root,
                                    device=device, **spec.camera)
        self.renderer = Renderer(port_scene(spec), self.config, params, device=device)

    def step(self) -> None:
        self.renderer.step()

    def image(self) -> np.ndarray:
        return self.renderer.image()

    def reset(self) -> None:
        self.renderer.reset()

    @property
    def film(self) -> torch.Tensor:
        return self.renderer.film.accum

    @property
    def scene(self):
        return self.renderer.scene

    @property
    def params(self):
        return self.renderer.params


def counters() -> dict:
    """The port's own counters: K1's multi-arrival launches and the
    megakernel traversals' host reads of their loop test."""
    from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_steps16_cuda
    from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import TRAVERSE_STATS

    return {"k1_launches": sum(arrival_steps16_cuda.launches.values()),
            "host_reads": TRAVERSE_STATS["host_reads"]}

