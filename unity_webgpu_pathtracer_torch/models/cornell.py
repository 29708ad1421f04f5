"""Cornell box (``models/cornell.py`` of the reference; ``CornellBox.unity``).

White floor, ceiling and back, red left wall, green right wall, two boxes,
and an emissive ceiling quad (mesh emission: the scene needs no analytic
lights, and renders with ``sky_mode=2``, no sky).
"""

from __future__ import annotations

import numpy as np

from unity_webgpu_pathtracer_torch.models import primitives as prim
from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
from unity_webgpu_pathtracer_torch.scene.scene import Scene


def _wall(scene: Scene, mat: int, translate, rotate_y=0.0, rotate_x=0.0, size=2.0):
    m = prim.quad(size=(size, size), material_index=mat)
    t = prim.transform_trs(translate=translate, rotate_y=rotate_y)
    if rotate_x:
        c, s = np.cos(rotate_x), np.sin(rotate_x)
        rx = np.eye(4, dtype=np.float32)
        rx[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        t = t @ rx
    scene.add_mesh(m, t)


def cornell_box(light_emission=12.0) -> tuple[Scene, dict]:
    """Build the scene; returns ``(scene, camera_kwargs)``.

    Box interior spans [-1,1]^3 with the opening toward +Z (camera side).
    """
    scene = Scene()
    white = scene.add_material(MaterialDesc(base_color=(0.73, 0.73, 0.73, 1.0), roughness=1.0))
    red = scene.add_material(MaterialDesc(base_color=(0.65, 0.05, 0.05, 1.0), roughness=1.0))
    green = scene.add_material(MaterialDesc(base_color=(0.12, 0.45, 0.15, 1.0), roughness=1.0))
    light = scene.add_material(
        MaterialDesc(base_color=(0.0, 0.0, 0.0, 1.0), roughness=1.0,
                     emission=(light_emission,) * 3)
    )

    # Walls: quads face +Z pre-transform; rotate each inward.
    _wall(scene, white, (0, -1, 0), rotate_x=-np.pi / 2)          # floor (+Y normal)
    _wall(scene, white, (0, 1, 0), rotate_x=np.pi / 2)            # ceiling (-Y normal)
    _wall(scene, white, (0, 0, -1))                                # back (+Z normal)
    _wall(scene, red, (-1, 0, 0), rotate_y=np.pi / 2)              # left (+X normal)
    _wall(scene, green, (1, 0, 0), rotate_y=-np.pi / 2)            # right (-X normal)

    # Ceiling light (slightly below the ceiling, facing down).
    lm = prim.quad(size=(0.6, 0.6), material_index=light)
    lt = prim.transform_trs(translate=(0, 0.999, 0))
    c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
    rx = np.eye(4, dtype=np.float32)
    rx[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    scene.add_mesh(lm, lt @ rx)

    # Two boxes.
    tall = prim.box(size=(0.6, 1.2, 0.6), material_index=white)
    scene.add_mesh(tall, prim.transform_trs(translate=(-0.35, -0.4, -0.35), rotate_y=0.3))
    short = prim.box(size=(0.6, 0.6, 0.6), material_index=white)
    scene.add_mesh(short, prim.transform_trs(translate=(0.35, -0.7, 0.35), rotate_y=-0.25))

    camera = dict(eye=(0.0, 0.0, 3.8), target=(0.0, 0.0, 0.0), fov_y_deg=40.0)
    return scene, camera


def cornell_camera(width: int, height: int, **extra):
    _, cam = cornell_box()
    return make_camera_params(width=width, height=height, **cam, **extra)
