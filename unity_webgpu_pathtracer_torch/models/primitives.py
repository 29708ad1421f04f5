"""Procedural mesh primitives (``models/primitives.py`` of the reference)."""

from __future__ import annotations

import numpy as np

from unity_webgpu_pathtracer_torch.scene.mesh import Mesh


def quad(size=(1.0, 1.0), material_index=0) -> Mesh:
    """Unit quad in the XY plane facing +Z, centered at origin."""
    sx, sy = size[0] * 0.5, size[1] * 0.5
    v = np.array(
        [[-sx, -sy, 0], [sx, -sy, 0], [sx, sy, 0], [-sx, sy, 0]], np.float32
    )
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return Mesh(vertices=v, indices=f, normals=n, uvs=uv, material_index=material_index)


def box(size=(1.0, 1.0, 1.0), material_index=0) -> Mesh:
    """Axis-aligned box, outward normals, centered at origin."""
    sx, sy, sz = np.asarray(size, np.float32) * 0.5
    verts, faces, normals, uvs = [], [], [], []
    # (axis, sign): for each face build 4 verts.
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_axis = (axis + 1) % 3
            v_axis = (axis + 2) % 3
            if sign < 0:
                u_axis, v_axis = v_axis, u_axis
            n = np.zeros(3, np.float32)
            n[axis] = sign
            c = n * (sx, sy, sz)[axis] * 1.0
            base = len(verts)
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = c.copy()
                p[u_axis] = du * (sx, sy, sz)[u_axis]
                p[v_axis] = dv * (sx, sy, sz)[v_axis]
                verts.append(p)
                normals.append(n)
                uvs.append([(du + 1) / 2, (dv + 1) / 2])
            faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return Mesh(
        vertices=np.asarray(verts, np.float32),
        indices=np.asarray(faces, np.int32),
        normals=np.asarray(normals, np.float32),
        uvs=np.asarray(uvs, np.float32),
        material_index=material_index,
    )


def uv_sphere(radius=1.0, stacks=16, slices=32, material_index=0) -> Mesh:
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
    return Mesh(
        vertices=np.asarray(verts, np.float32),
        indices=np.asarray(faces, np.int32),
        normals=np.asarray(normals, np.float32),
        uvs=np.asarray(uvs, np.float32),
        material_index=material_index,
    )


def transform_trs(translate=(0, 0, 0), rotate_y=0.0, scale=1.0) -> np.ndarray:
    """Simple TRS matrix (rotation about Y, uniform or per-axis scale)."""
    s = np.asarray(scale, np.float32) * np.ones(3, np.float32)
    c, sn = np.cos(rotate_y), np.sin(rotate_y)
    r = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r * s[None, :]
    m[:3, 3] = translate
    return m
