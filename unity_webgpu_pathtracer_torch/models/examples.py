"""Example scenes of the reference's ``models/examples.py`` that the port
renders beside the Cornell box (``models/cornell.py``): ``tlas_scene``,
instancing.
"""

from __future__ import annotations

import numpy as np

from unity_webgpu_pathtracer_torch.config import SKY_MODE_BASIC
from unity_webgpu_pathtracer_torch.models import primitives as prim
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
from unity_webgpu_pathtracer_torch.scene.scene import Scene


def tlas_scene(n=5, phase=0.0):
    """TLAS.unity + Bounce.cs: ``n`` instances of one sphere mesh, each with
    its own material, over an instanced floor; ``phase`` sets the bounce
    heights (``Renderer.update_instance_transform`` moves one).  Returns
    ``(scene, camera kwargs, config overrides)``."""
    scene = Scene()
    mats = [scene.add_material(MaterialDesc(
        base_color=tuple(np.append(np.random.default_rng(i).uniform(0.2, 0.9, 3), 1.0)),
        roughness=0.4)) for i in range(n)]
    mesh = scene.add_mesh(prim.uv_sphere(radius=0.4, stacks=16, slices=32))
    for i in range(n):
        y = 0.4 + abs(np.sin(phase + i)) * 1.2
        scene.add_instance(mesh, prim.transform_trs(translate=(i - n / 2, y, 0)), mats[i])
    floor = scene.add_material(MaterialDesc(base_color=(0.6, 0.6, 0.6, 1), roughness=1.0))
    fl = scene.add_mesh(prim.quad(size=(14, 14), material_index=floor))
    rx = np.eye(4, dtype=np.float32)
    c, s = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    rx[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    scene.add_instance(fl, rx, floor)
    cam = dict(eye=(0, 2.2, 7.0), target=(0, 0.8, 0), fov_y_deg=45.0)
    return scene, cam, dict(sky_mode=SKY_MODE_BASIC)
