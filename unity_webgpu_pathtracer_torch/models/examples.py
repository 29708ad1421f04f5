"""Example scenes (``models/examples.py`` of the reference), the builtins of
``cli.py render builtin:<name>``.

Each function returns ``(scene, camera_kwargs, config_overrides)``:
CornellBox (``models/cornell.py``), Quad, Texture (alpha mask), Lights,
Hyperion_rect_lights, CameraAperture (depth of field), BRDFShader (one
material), TLAS (instancing), and a Sponza-like stress scene.  ``tlas`` is
the two-level wide16 build (the reference overrides its traversal to the
4-wide ``wide`` backend, which the port does not have).
"""

from __future__ import annotations

import numpy as np

from unity_webgpu_pathtracer_torch.config import (
    LIGHT_TYPE_POINT,
    LIGHT_TYPE_RECTANGLE,
    LIGHT_TYPE_SPOT,
    SKY_MODE_BASIC,
    SKY_MODE_ENVIRONMENT,
    SKY_MODE_NONE,
)
from unity_webgpu_pathtracer_torch.models import primitives as prim
from unity_webgpu_pathtracer_torch.models.benchmark import procedural_hdri
from unity_webgpu_pathtracer_torch.models.cornell import cornell_box
from unity_webgpu_pathtracer_torch.scene.lights import LightDesc
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
from unity_webgpu_pathtracer_torch.scene.scene import Scene


def quad_scene():
    """Minimal fixture (Quad.unity): one quad under the basic sky."""
    scene = Scene()
    m = scene.add_material(MaterialDesc(base_color=(0.8, 0.8, 0.8, 1.0), roughness=0.8))
    scene.add_mesh(prim.quad(size=(2, 2), material_index=m))
    cam = dict(eye=(0, 0.5, 3), target=(0, 0, 0), fov_y_deg=45.0)
    return scene, cam, dict(sky_mode=SKY_MODE_BASIC)


def _alpha_edge_texture(size=64):
    """Procedural stand-in for the reference's alpha_edge.png: opaque
    checker center, alpha-0 border."""
    img = np.zeros((size, size, 4), np.uint8)
    xx, yy = np.meshgrid(np.arange(size), np.arange(size))
    checker = ((xx // 8 + yy // 8) % 2) * 155 + 100
    img[..., 0] = checker
    img[..., 1] = 255 - checker
    img[..., 2] = 120
    border = (xx < 8) | (xx >= size - 8) | (yy < 8) | (yy >= size - 8)
    img[..., 3] = np.where(border, 0, 255)
    return img


def texture_scene():
    """Texture.unity: textured quad with an alpha-masked edge."""
    scene = Scene()
    tex = scene.add_texture(_alpha_edge_texture())
    m = scene.add_material(
        MaterialDesc(base_color=(1, 1, 1, 1), roughness=0.9,
                     base_color_texture=tex, alpha_mode=2, alpha_cutoff=0.5)
    )
    scene.add_mesh(prim.quad(size=(2, 2), material_index=m))
    floor = scene.add_material(MaterialDesc(base_color=(0.6, 0.6, 0.6, 1), roughness=1.0))
    g = prim.quad(size=(8, 8), material_index=floor)
    rx = prim.transform_trs(translate=(0, -1.05, 0))
    c, s = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    rx[:3, :3] = rx[:3, :3] @ np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    scene.add_mesh(g, rx)
    cam = dict(eye=(0.6, 0.6, 3.2), target=(0, 0, 0), fov_y_deg=45.0)
    return scene, cam, dict(sky_mode=SKY_MODE_BASIC, has_textures=True)


def lights_scene():
    """Lights.unity: point + spot + rect lights over a diffuse floor."""
    scene = Scene()
    floor = scene.add_material(MaterialDesc(base_color=(0.7, 0.7, 0.7, 1), roughness=1.0))
    ball = scene.add_material(MaterialDesc(base_color=(0.8, 0.4, 0.2, 1), roughness=0.4))
    g = prim.quad(size=(12, 12), material_index=floor)
    rx = np.eye(4, dtype=np.float32)
    c, s = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    rx[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    scene.add_mesh(g, rx)
    scene.add_mesh(prim.uv_sphere(radius=0.5, material_index=ball),
                   prim.transform_trs(translate=(0, 0.5, 0)))
    scene.add_light(LightDesc(type=LIGHT_TYPE_POINT, position=(-2, 2, 1),
                              color=(1.0, 0.8, 0.6), intensity=6.0, range=20))
    scene.add_light(LightDesc(type=LIGHT_TYPE_SPOT, position=(2, 3, 2),
                              forward=(-0.5, -0.8, -0.5), color=(0.4, 0.6, 1.0),
                              intensity=10.0, range=25, spot_angle=50, inner_spot_angle=30))
    scene.add_light(LightDesc(type=LIGHT_TYPE_RECTANGLE, position=(0, 3.0, -2),
                              right=(1, 0, 0), up=(0, 0.2, 1), size=(2.0, 1.0),
                              color=(1, 1, 1), intensity=8.0, range=30))
    cam = dict(eye=(0, 2.0, 6.0), target=(0, 0.5, 0), fov_y_deg=45.0)
    return scene, cam, dict(sky_mode=SKY_MODE_NONE, has_lights=True)


def rect_lights_scene():
    """Hyperion_rect_lights.unity: colored emissive panels around spheres."""
    scene = Scene()
    floor = scene.add_material(MaterialDesc(base_color=(0.6, 0.6, 0.6, 1), roughness=0.8))
    g = prim.quad(size=(20, 20), material_index=floor)
    rx = np.eye(4, dtype=np.float32)
    c, s = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    rx[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    scene.add_mesh(g, rx)
    for i, color in enumerate([(1, 0.2, 0.2), (0.2, 1, 0.2), (0.2, 0.4, 1)]):
        m = scene.add_material(MaterialDesc(base_color=(0.9, 0.9, 0.9, 1),
                                            roughness=0.15 + 0.3 * i, metallic=0.7))
        scene.add_mesh(prim.uv_sphere(radius=0.6, material_index=m),
                       prim.transform_trs(translate=((i - 1) * 1.8, 0.6, 0)))
        scene.add_light(LightDesc(type=LIGHT_TYPE_RECTANGLE,
                                  position=((i - 1) * 1.8, 2.6, -1.5),
                                  right=(1, 0, 0), up=(0, 1, 0), size=(1.2, 1.2),
                                  color=color, intensity=12.0, range=40))
    cam = dict(eye=(0, 2.2, 7.0), target=(0, 0.8, 0), fov_y_deg=40.0)
    return scene, cam, dict(sky_mode=SKY_MODE_NONE, has_lights=True)


def camera_aperture_scene():
    """CameraAperture.unity: depth-of-field over a row of spheres."""
    scene = Scene()
    for i in range(5):
        m = scene.add_material(MaterialDesc(
            base_color=(0.9 - i * 0.15, 0.3 + i * 0.15, 0.4, 1.0), roughness=0.3))
        scene.add_mesh(prim.uv_sphere(radius=0.4, material_index=m),
                       prim.transform_trs(translate=(i - 2.0, 0.0, -i * 1.2)))
    cam = dict(eye=(0, 0.8, 4.0), target=(0, 0, 0), fov_y_deg=40.0,
               aperture=0.25, focal_length=4.0)
    return scene, cam, dict(sky_mode=SKY_MODE_BASIC, use_depth_of_field=True)


def brdf_test_scene(metallic=0.0, roughness=0.5, clearcoat=0.0, sheen=0.0,
                    transmission=0.0, anisotropic=0.0, subsurface=0.0,
                    specular_tint=0.0, ior=1.5):
    """BRDFShader.unity + DisneyBRDFTest.cs: one sphere with adjustable
    material parameters (drive via Renderer.update_material)."""
    scene = Scene()
    m = scene.add_material(MaterialDesc(
        base_color=(0.7, 0.2, 0.2, 1.0 - transmission), metallic=metallic,
        roughness=roughness, clearcoat=clearcoat, sheen=sheen,
        transmission=transmission, anisotropic=anisotropic,
        subsurface=subsurface, specular_tint=specular_tint, ior=ior))
    scene.add_mesh(prim.uv_sphere(radius=1.0, stacks=32, slices=64, material_index=m))
    scene.set_environment(procedural_hdri(128))
    cam = dict(eye=(0, 0.4, 3.2), target=(0, 0, 0), fov_y_deg=45.0)
    return scene, cam, dict(sky_mode=SKY_MODE_ENVIRONMENT, has_environment_texture=True)


def tlas_scene(n=5, phase=0.0):
    """TLAS.unity + Bounce.cs: ``n`` instances of one sphere mesh, each with
    its own material, over an instanced floor; ``phase`` sets the bounce
    heights (``Renderer.update_instance_transform`` moves one)."""
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


def sponza_like(columns=6):
    """Sponza stand-in: a colonnaded hall (complex-content stress scene)."""
    scene = Scene()
    wall = scene.add_material(MaterialDesc(base_color=(0.75, 0.7, 0.6, 1), roughness=0.9))
    col = scene.add_material(MaterialDesc(base_color=(0.8, 0.78, 0.72, 1), roughness=0.7))
    floor = scene.add_material(MaterialDesc(base_color=(0.5, 0.45, 0.4, 1), roughness=0.6))
    g = prim.quad(size=(24, 10), material_index=floor)
    rx = np.eye(4, dtype=np.float32)
    c, s = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    rx[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    scene.add_mesh(g, rx)
    for side in (-1, 1):
        scene.add_mesh(prim.box(size=(24, 6, 0.4), material_index=wall),
                       prim.transform_trs(translate=(0, 3, side * 4.5)))
        for i in range(columns):
            x = (i - columns / 2 + 0.5) * 3.2
            scene.add_mesh(prim.uv_sphere(radius=0.35, stacks=24, slices=48,
                                          material_index=col),
                           prim.transform_trs(translate=(x, 3.2, side * 3.2)))
            scene.add_mesh(prim.box(size=(0.5, 3.2, 0.5), material_index=col),
                           prim.transform_trs(translate=(x, 1.6, side * 3.2)))
    scene.set_environment(procedural_hdri(128))
    cam = dict(eye=(-9, 2.4, 0.0), target=(4, 1.5, 0), fov_y_deg=55.0)
    return scene, cam, dict(sky_mode=SKY_MODE_ENVIRONMENT, has_environment_texture=True)


EXAMPLES = {
    "cornell": lambda: (*cornell_box(), dict(sky_mode=SKY_MODE_NONE)),
    "quad": quad_scene,
    "texture": texture_scene,
    "lights": lights_scene,
    "rect_lights": rect_lights_scene,
    "aperture": camera_aperture_scene,
    "brdf": brdf_test_scene,
    "tlas": tlas_scene,
    "sponza_like": sponza_like,
}
