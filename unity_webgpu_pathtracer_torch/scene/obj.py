"""Wavefront OBJ loader (+ minimal MTL) (``scene/obj.py`` of the
reference; host numpy, the port's PNG reader).

The reference consumes meshes through Unity's asset pipeline; the framework
needs standalone loaders.  Supports v/vn/vt, polygon triangulation (fan),
negative indices, usemtl grouping, and a pragmatic MTL subset mapped onto
the metallic-roughness material model (Kd -> baseColor, Ke -> emission,
Ns -> roughness, d -> opacity, Ni -> ior) plus texture maps (map_Kd ->
baseColor texture, map_d -> alpha mask merged into the baseColor alpha
channel, map_Ke -> emission texture) — the subset the reference's real
Sponza content uses (`Assets/Examples/Models/Sponza/sponza.mtl`, 3ds-Max
export: backslash paths, case-mismatched texture directory, per-material
map_Kd/map_d/map_bump).  Unresolvable or undecodable texture files degrade
to the factor constants (never an exception): asset trees with missing
textures must still render.
"""

from __future__ import annotations

import os

import numpy as np

from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
from unity_webgpu_pathtracer_torch.scene.mesh import Mesh
from unity_webgpu_pathtracer_torch.scene.scene import Scene


def load_mtl(path: str, maps: dict[str, dict[str, str]] | None = None
             ) -> dict[str, MaterialDesc]:
    """Parse an MTL file.  ``maps``, if given, collects per-material texture
    map references as ``{material: {"kd"|"d"|"ke"|"bump": raw_path}}``
    (raw as written in the file; resolve with :func:`resolve_map_path`)."""
    materials = {}
    cur = None
    cur_maps: dict[str, str] = {}
    if not os.path.exists(path):
        return materials
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = MaterialDesc()
                materials[parts[1]] = cur
                if maps is not None:
                    cur_maps = maps.setdefault(parts[1], {})
            elif cur is None:
                continue
            elif key == "Kd":
                kd = tuple(float(x) for x in parts[1:4])
                cur.base_color = (*kd, cur.base_color[3])
            elif key == "Ke":
                cur.emission = tuple(float(x) for x in parts[1:4])
            elif key == "Ns":
                # Phong exponent -> perceptual roughness.
                cur.roughness = float(np.clip(1.0 - np.sqrt(float(parts[1]) / 1000.0), 0.02, 1.0))
            elif key == "d":
                a = float(parts[1])
                cur.base_color = (*cur.base_color[:3], a)
                if a < 1.0:
                    cur.alpha_mode = 1  # blend
            elif key == "Ni":
                cur.ior = float(parts[1])
            elif key == "Pm":  # PBR extension: metallic
                cur.metallic = float(parts[1])
            elif key == "Pr":  # PBR extension: roughness
                cur.roughness = float(parts[1])
            elif key in ("map_Kd", "map_d", "map_Ke", "map_bump", "bump") \
                    and maps is not None and len(parts) > 1:
                # Map path = last token (options like -bm precede it).
                slot = {"map_Kd": "kd", "map_d": "d", "map_Ke": "ke",
                        "map_bump": "bump", "bump": "bump"}[key]
                cur_maps[slot] = parts[-1]
    return materials


def resolve_map_path(base_dir: str, raw: str) -> str | None:
    """Resolve an MTL texture reference to an existing file.

    Handles Windows backslash separators and case-mismatched path
    components (sponza.mtl says ``textures\\lion.png``; the directory on
    disk is ``Textures/``) by walking each component case-insensitively.
    Returns None when no file matches.
    """
    rel = raw.replace("\\", "/").strip()
    cand = os.path.join(base_dir, rel)
    if os.path.exists(cand):
        return cand
    cur = base_dir
    for comp in rel.split("/"):
        if not comp or not os.path.isdir(cur):
            return None
        entries = {e.lower(): e for e in os.listdir(cur)}
        match = entries.get(comp.lower())
        if match is None:
            return None
        cur = os.path.join(cur, match)
    return cur if os.path.exists(cur) else None


def _load_image_rgba(path: str) -> np.ndarray | None:
    """Decode PNG (native reader) or anything-Pillow-reads to RGBA8.
    Returns None on any failure (e.g. git-LFS pointer stubs, or a JPEG
    without Pillow: the material keeps its factor constants)."""
    try:
        with open(path, "rb") as f:
            head = f.read(8)
        if head == b"\x89PNG\r\n\x1a\n":
            from unity_webgpu_pathtracer_torch.utils.image import read_png

            img = read_png(path)
            if img.ndim == 2:
                img = np.stack([img] * 3 + [np.full_like(img, 255)], -1)
            if img.shape[-1] == 3:
                img = np.concatenate(
                    [img, np.full(img.shape[:2] + (1,), 255, img.dtype)], -1)
            return img
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGBA"), np.uint8)
    except Exception:
        return None


def load_obj(path: str, load_textures: bool = True) -> Scene:
    """Load an OBJ file into a Scene (one mesh per material group).

    ``load_textures`` resolves each material's map_Kd/map_d/map_Ke
    references into the scene texture atlas (map_d alpha masks merge into
    the baseColor texture's alpha channel, matching the renderer's
    single-texture opacity model — ``util/material.hlsl:95-105`` reads
    opacity from baseColor.a); unresolvable files fall back to factors.
    """
    positions, normals, uvs = [], [], []
    groups: dict[str, list] = {}
    current = "default"
    mtl: dict[str, MaterialDesc] = {}
    mtl_maps: dict[str, dict[str, str]] = {}
    mtl_dir = os.path.dirname(path)

    def resolve(idx, n):
        i = int(idx)
        return i - 1 if i > 0 else n + i

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif key == "mtllib":
                mtl.update(load_mtl(os.path.join(os.path.dirname(path), parts[1]),
                                    maps=mtl_maps))
            elif key == "usemtl":
                current = parts[1]
            elif key == "f":
                corners = []
                for vert in parts[1:]:
                    comps = vert.split("/")
                    vi = resolve(comps[0], len(positions))
                    ti = resolve(comps[1], len(uvs)) if len(comps) > 1 and comps[1] else -1
                    ni = resolve(comps[2], len(normals)) if len(comps) > 2 and comps[2] else -1
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    groups.setdefault(current, []).append(
                        (corners[0], corners[k], corners[k + 1])
                    )

    scene = Scene()
    positions = np.asarray(positions, np.float32)
    normals_a = np.asarray(normals, np.float32) if normals else None
    uvs_a = np.asarray(uvs, np.float32) if uvs else None

    # Resolve texture maps once per material (shared across groups).
    # Value: (texture_id, had_alpha_mask) — the mask bit must replay the
    # alpha_mode side effect on every material that binds the texture.
    tex_cache: dict[str, tuple[int, bool]] = {}

    def _tex_for(name: str, desc: MaterialDesc) -> None:
        refs = mtl_maps.get(name)
        if not refs or not load_textures:
            return
        kd_raw = refs.get("kd")
        if kd_raw is not None:
            if kd_raw not in tex_cache:
                p = resolve_map_path(mtl_dir, kd_raw)
                img = _load_image_rgba(p) if p else None
                if img is not None:
                    had_mask = False
                    d_raw = refs.get("d")
                    if d_raw is not None:
                        # Merge the standalone alpha mask into baseColor.a
                        dp = resolve_map_path(mtl_dir, d_raw)
                        mask = _load_image_rgba(dp) if dp else None
                        if mask is not None and mask.shape[:2] == img.shape[:2]:
                            img = img.copy()
                            img[..., 3] = mask[..., 0]
                            had_mask = True
                    tex_cache[kd_raw] = (scene.add_texture(img), had_mask)
            if kd_raw in tex_cache:
                # The binding side effects (factor white-out, alpha mode)
                # apply to EVERY material that binds the texture, not just
                # the one that loaded it — a second material sharing a
                # masked map_Kd must render masked and untinted too.
                tex_id, had_mask = tex_cache[kd_raw]
                desc.base_color_texture = tex_id
                desc.base_color = (1.0, 1.0, 1.0, desc.base_color[3])
                if had_mask:
                    desc.alpha_mode = 2  # mask
        ke_raw = refs.get("ke")
        if ke_raw is not None:
            p = resolve_map_path(mtl_dir, ke_raw)
            entry = tex_cache.get(ke_raw)
            if entry is None:
                decoded = _load_image_rgba(p) if p else None
                if decoded is not None:
                    entry = tex_cache[ke_raw] = (scene.add_texture(decoded),
                                                 False)
            if entry is not None:
                desc.emission_texture = entry[0]

    for name, faces in groups.items():
        desc = mtl.get(name, MaterialDesc())
        _tex_for(name, desc)
        mat_id = scene.add_material(desc)
        # Re-index per group: unique (v, t, n) corners become vertices.
        corner_map: dict[tuple, int] = {}
        verts, vnorms, vuvs, tris = [], [], [], []
        for tri in faces:
            idxs = []
            for corner in tri:
                if corner not in corner_map:
                    corner_map[corner] = len(verts)
                    vi, ti, ni = corner
                    verts.append(positions[vi])
                    vnorms.append(normals_a[ni] if (normals_a is not None and ni >= 0)
                                  else np.zeros(3, np.float32))
                    vuvs.append(uvs_a[ti] if (uvs_a is not None and ti >= 0)
                                else np.zeros(2, np.float32))
                idxs.append(corner_map[corner])
            tris.append(idxs)
        has_normals = normals_a is not None and any(np.any(n) for n in vnorms[:1])
        mesh = Mesh(
            vertices=np.asarray(verts, np.float32),
            indices=np.asarray(tris, np.int32),
            normals=np.asarray(vnorms, np.float32) if has_normals else None,
            uvs=np.asarray(vuvs, np.float32) if uvs_a is not None else None,
            material_index=mat_id,
        )
        scene.add_mesh(mesh)
    return scene
