"""The sphere-grid scene: a grid of smooth UV spheres over a ground quad under
a procedural HDRI, flat or as one sphere BLAS with an instance a cell.

Frozen from ``unity_webgpu_pathtracer_torch/models/benchmark.py``
(``million_triangle_scene``, ``instanced_million_triangle_scene``,
``procedural_hdri``) and ``models/primitives.py`` (``uv_sphere``, ``quad``,
``transform_trs``) at commit 628fc1bc0151d37c4767d2275c25b153616afc0d, in
numpy alone: the sizes come from the configuration's file, and the result is
a :class:`~pt_bench.scenes.SceneSpec` that the port and the plain reference
both read.
"""

from __future__ import annotations

import numpy as np

from pt_bench.scenes import MeshSpec, Placement, SceneSpec, textures


def procedural_hdri(height: int) -> np.ndarray:
    """Sky gradient + bright sun disc, equirect (H, 2H, 3) float32."""
    w = 2 * height
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(w) + 0.5) / w
    theta = (1.0 - v)[:, None] * np.pi
    phi = u[None, :] * 2 * np.pi
    y = np.cos(theta)
    horizon = np.exp(-np.abs(y) * 3.0)
    sky = np.stack(
        [0.2 + 0.3 * horizon, 0.35 + 0.3 * horizon, 0.7 + 0.25 * horizon], -1
    ) * np.maximum(y, 0.02)[..., None]
    sun_dir = np.array([np.sin(1.05) * np.cos(0.785), np.cos(1.05),
                        np.sin(1.05) * np.sin(0.785)])
    d = np.stack(
        [np.sin(theta) * np.cos(phi) * np.ones_like(phi),
         y * np.ones_like(phi),
         np.sin(theta) * np.sin(phi) * np.ones_like(phi)], -1)
    cosang = (d * sun_dir).sum(-1)
    sun = np.where(cosang > 0.9995, 500.0, 0.0)
    return (sky + sun[..., None] * np.array([1.0, 0.9, 0.7])).astype(np.float32)


def uv_sphere(radius: float, stacks: int, slices: int) -> MeshSpec:
    """UV sphere with smooth normals."""
    verts, normals, uvs = [], [], []
    for i in range(stacks + 1):
        theta = np.pi * i / stacks
        for j in range(slices + 1):
            phi = 2 * np.pi * j / slices
            n = np.array(
                [np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)],
                np.float32,
            )
            verts.append(n * radius)
            normals.append(n)
            uvs.append([j / slices, 1.0 - i / stacks])
    faces = []
    for i in range(stacks):
        for j in range(slices):
            a = i * (slices + 1) + j
            b = a + slices + 1
            if i > 0:
                faces.append([a, b, a + 1])
            if i < stacks - 1:
                faces.append([a + 1, b, b + 1])
    return MeshSpec(vertices=np.asarray(verts, np.float32),
                    indices=np.asarray(faces, np.int32),
                    normals=np.asarray(normals, np.float32),
                    uvs=np.asarray(uvs, np.float32))


def quad(size) -> MeshSpec:
    """Quad in the XY plane facing +Z, centred at the origin."""
    sx, sy = size[0] * 0.5, size[1] * 0.5
    v = np.array([[-sx, -sy, 0], [sx, -sy, 0], [sx, sy, 0], [-sx, sy, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return MeshSpec(vertices=v, indices=f, normals=n, uvs=uv)


def translate(x: float, y: float, z: float) -> np.ndarray:
    """``transform_trs(translate=(x, y, z))``: no rotation, unit scale."""
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def generate(cfg: dict) -> SceneSpec:
    """The scene of configuration ``cfg`` (its file's JSON object); its
    optional ``textures`` (procedural images, ``scenes/textures.py``) and
    ``lights`` (light keyword dicts) go into the scene as they are."""
    sph = cfg["sphere"]
    sphere = uv_sphere(sph["radius"], sph["stacks"], sph["slices"])
    grid = max(int(np.sqrt(cfg["target_tris"] / sphere.indices.shape[0])), 1)
    n_mats = len(cfg["materials"]) - 1             # the last one is the ground's
    rng = np.random.default_rng(cfg["layout_seed"])
    spacing, jitter, lift = cfg["spacing"], cfg["jitter"], sph["radius"]
    placements = []
    for i in range(grid):
        for j in range(grid):
            x = (i - grid / 2) * spacing + rng.uniform(-jitter, jitter)
            z = (j - grid / 2) * spacing + rng.uniform(-jitter, jitter)
            placements.append(Placement(0, translate(x, lift, z), (i * grid + j) % n_mats))
    ground_size = grid * cfg["ground_scale"]
    rx = np.eye(4, dtype=np.float32)
    c, s = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    rx[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    placements.append(Placement(1, rx, n_mats))
    cam = cfg["camera"]
    return SceneSpec(
        meshes=[sphere, quad((ground_size, ground_size))],
        placements=placements,
        materials=[dict(m) for m in cfg["materials"]],
        env_image=procedural_hdri(cfg["hdri_height"]),
        camera=dict(eye=tuple(grid * k for k in cam["eye_scale"]),
                    target=tuple(cam["target"]), fov_y_deg=cam["fov_y_deg"]),
        instanced=bool(cfg["instanced"]),
        textures=[textures.make(t) for t in cfg.get("textures", [])],
        lights=[dict(x) for x in cfg.get("lights", [])])
