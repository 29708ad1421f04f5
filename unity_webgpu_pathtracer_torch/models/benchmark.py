"""The benchmark scenes (``models/benchmark.py`` of the reference).

``million_triangle_scene``: a grid of smooth spheres over a ground plane
(~1M triangles at the default size) under a procedural HDRI;
``instanced_million_triangle_scene``: the same scene as a two-level one;
``beam_scene``: long thin beams crossing a cube, the tree-quality stress
case.
"""

from __future__ import annotations

import numpy as np

from unity_webgpu_pathtracer_torch.models import primitives as prim
from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
from unity_webgpu_pathtracer_torch.scene.mesh import Mesh
from unity_webgpu_pathtracer_torch.scene.scene import Scene


def procedural_hdri(height: int = 256) -> np.ndarray:
    """Sky gradient + bright sun disc, equirect (H, 2H, 3) float32."""
    w = 2 * height
    v = (np.arange(height) + 0.5) / height           # v=1 top (theta=0)
    u = (np.arange(w) + 0.5) / w
    theta = (1.0 - v)[:, None] * np.pi
    phi = u[None, :] * 2 * np.pi
    y = np.cos(theta)
    horizon = np.exp(-np.abs(y) * 3.0)
    sky = np.stack(
        [0.2 + 0.3 * horizon, 0.35 + 0.3 * horizon, 0.7 + 0.25 * horizon], -1
    ) * np.maximum(y, 0.02)[..., None]
    # Sun at theta=60deg, phi=45deg.
    sun_dir = np.array([np.sin(1.05) * np.cos(0.785), np.cos(1.05),
                        np.sin(1.05) * np.sin(0.785)])
    d = np.stack(
        [np.sin(theta) * np.cos(phi) * np.ones_like(phi),
         y * np.ones_like(phi),
         np.sin(theta) * np.sin(phi) * np.ones_like(phi)], -1)
    cosang = (d * sun_dir).sum(-1)
    sun = np.where(cosang > 0.9995, 500.0, 0.0)
    return (sky + sun[..., None] * np.array([1.0, 0.9, 0.7])).astype(np.float32)


def million_triangle_scene(target_tris: int = 1_000_000) -> tuple[Scene, dict]:
    """Sphere grid + ground, ~target_tris triangles, mixed materials.
    Returns ``(scene, camera kwargs for make_camera_params)``."""
    scene = Scene()
    mats = [
        scene.add_material(MaterialDesc(base_color=(0.8, 0.3, 0.2, 1.0), roughness=0.4)),
        scene.add_material(MaterialDesc(base_color=(0.9, 0.9, 0.9, 1.0),
                                        metallic=1.0, roughness=0.15)),
        scene.add_material(MaterialDesc(base_color=(0.2, 0.5, 0.8, 1.0), roughness=0.7)),
        scene.add_material(MaterialDesc(base_color=(0.95, 0.85, 0.5, 1.0),
                                        metallic=0.8, roughness=0.3)),
    ]
    ground = scene.add_material(MaterialDesc(base_color=(0.55, 0.55, 0.55, 1.0),
                                             roughness=0.9))

    # One sphere mesh (~5.1K tris), instanced-by-flattening over a grid.
    sphere = prim.uv_sphere(radius=0.45, stacks=36, slices=72)
    tris_per = sphere.triangle_count
    grid = max(int(np.sqrt(target_tris / tris_per)), 1)
    rng = np.random.default_rng(42)
    for i in range(grid):
        for j in range(grid):
            m = mats[(i * grid + j) % len(mats)]
            x = (i - grid / 2) * 1.1 + rng.uniform(-0.1, 0.1)
            z = (j - grid / 2) * 1.1 + rng.uniform(-0.1, 0.1)
            scene.add_mesh(sphere_copy(sphere, m),
                           prim.transform_trs(translate=(x, 0.45, z)))
    g = prim.quad(size=(grid * 1.4, grid * 1.4), material_index=ground)
    rx = np.eye(4, dtype=np.float32)
    c, s = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    rx[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    scene.add_mesh(g, rx)

    scene.set_environment(procedural_hdri(128))
    cam = dict(
        eye=(grid * 0.62, grid * 0.36, grid * 0.62),
        target=(0.0, 0.0, 0.0),
        fov_y_deg=45.0,
    )
    return scene, cam


def sphere_copy(mesh: Mesh, material_index: int) -> Mesh:
    """``mesh``'s arrays (shared, not copied) under ``material_index``."""
    return Mesh(vertices=mesh.vertices, indices=mesh.indices, normals=mesh.normals,
                tangents=mesh.tangents, uvs=mesh.uvs, material_index=material_index)


def beam_scene(target_tris: int = 400_000, extent: float = 5.0,
               seed: int = 7) -> tuple[Scene, dict]:
    """Long thin beams crossing a cube: the tree-quality stress case.

    Every beam's box spans a large share of the scene, so binned-SAH
    object splits make heavily overlapping nodes; spatial splits
    (``UWPT_BVH_QUALITY=1``) clip the references, as far as the native
    builder's reference budget (half the triangle count) lets them: at
    the default size the budget fills.  One quad (two triangles) a beam,
    ``target_tris // 2`` beams from ``seed``, split over three materials;
    the same procedural HDRI and a camera outside the cube.  Returns
    ``(scene, camera kwargs)``."""
    scene = Scene()
    mats = [
        scene.add_material(MaterialDesc(base_color=(0.75, 0.7, 0.6, 1.0), roughness=0.55)),
        scene.add_material(MaterialDesc(base_color=(0.4, 0.45, 0.55, 1.0),
                                        metallic=0.9, roughness=0.25)),
        scene.add_material(MaterialDesc(base_color=(0.6, 0.25, 0.2, 1.0), roughness=0.75)),
    ]
    n_beams = max(target_tris // 2, 1)
    rng = np.random.default_rng(seed)
    a = rng.uniform(-extent, extent, (n_beams, 3)).astype(np.float32)
    # Lengths U(0.5, extent): long enough that object splits overlap,
    # short of the full diagonal (which degrades both tree types alike).
    dirn = rng.normal(size=(n_beams, 3)).astype(np.float32)
    dirn /= np.maximum(np.linalg.norm(dirn, axis=1, keepdims=True), 1e-8)
    length = rng.uniform(0.5, extent, (n_beams, 1)).astype(np.float32)
    b = a + dirn * length
    d = b - a
    up = rng.normal(size=(n_beams, 3)).astype(np.float32)
    w = np.cross(d, up)
    w /= np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-8)
    half_w = rng.uniform(0.004, 0.02, (n_beams, 1)).astype(np.float32)
    w *= half_w
    # A quad a beam, A-w, A+w, B+w, B-w: two triangles.
    verts = np.stack([a - w, a + w, b + w, b - w], axis=1)       # (N, 4, 3)
    base = (np.arange(n_beams, dtype=np.int32) * 4)[:, None]
    tris = np.concatenate([base + np.array([[0, 1, 2]], np.int32),
                           base + np.array([[0, 2, 3]], np.int32)], axis=1).reshape(-1, 3)
    n = np.cross(d, w)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-8)
    normals = np.repeat(n[:, None, :], 4, axis=1)                # (N, 4, 3)
    third = n_beams // 3 or 1
    for mi, mat in enumerate(mats):
        lo, hi = mi * third, (mi + 1) * third if mi < 2 else n_beams
        if lo >= hi:
            continue
        scene.add_mesh(Mesh(vertices=verts[lo:hi].reshape(-1, 3),
                            indices=tris[: 2 * (hi - lo)].reshape(-1, 3),
                            normals=normals[lo:hi].reshape(-1, 3), material_index=mat))
    scene.set_environment(procedural_hdri(128))
    cam = dict(eye=(extent * 1.7, extent * 1.1, extent * 1.7), target=(0.0, 0.0, 0.0),
               fov_y_deg=45.0)
    return scene, cam


def instanced_million_triangle_scene() -> tuple[Scene, dict]:
    """``million_triangle_scene(1_000_000)`` as a two-level scene: the
    sphere mesh once as a BLAS, one instance per grid cell with the cell's
    transform and material, the ground quad as one more instance; same
    materials, HDRI and camera."""
    flat, cam = million_triangle_scene(1_000_000)
    scene = Scene(materials=list(flat.materials), env_image=flat.env_image)
    (sphere, _), (ground, ground_xf) = flat.meshes[0], flat.meshes[-1]
    sphere_id, ground_id = scene.add_mesh(sphere), scene.add_mesh(ground)
    for mesh, xf in flat.meshes[:-1]:
        scene.add_instance(sphere_id, xf, mesh.material_index)
    scene.add_instance(ground_id, ground_xf, ground.material_index)
    return scene, cam
