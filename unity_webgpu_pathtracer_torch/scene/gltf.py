"""Minimal glTF 2.0 / GLB loader (dependency-free) (``scene/gltf.py`` of
the reference; host numpy, the port's PNG reader).

The reference loads glTF content through UnityGLTF (``Packages/manifest.json``,
e.g. the DamagedHelmet example scene).  This loader covers the subset the
renderer consumes: triangle primitives with POSITION/NORMAL/TEXCOORD_0,
uint16/uint32 indices, node hierarchy with TRS or matrix transforms,
pbrMetallicRoughness materials (factors + baseColor/metallicRoughness/
emissive/occlusion/normal textures), alphaMode/alphaCutoff, KHR_materials
transmission/ior factors, and PNG + JPEG images (JPEG — glTF's common
case, used by the reference's DamagedHelmet.glb — decodes via Pillow when
available; otherwise the atlas slot falls back to the factor constants).
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from unity_webgpu_pathtracer_torch.scene.material import MaterialDesc
from unity_webgpu_pathtracer_torch.scene.mesh import Mesh
from unity_webgpu_pathtracer_torch.scene.scene import Scene
from unity_webgpu_pathtracer_torch.utils.image import decode_png

_COMPONENT = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_SIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_glb(path: str):
    with open(path, "rb") as f:
        data = f.read()
    magic, _version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    pos = 12
    gltf, binary = None, b""
    while pos < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, pos)
        payload = data[pos + 8 : pos + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # JSON
            gltf = json.loads(payload)
        elif chunk_type == 0x004E4942:  # BIN
            binary = payload
        pos += 8 + chunk_len
    return gltf, binary


def _read_buffer(gltf, index, base_dir, binary):
    buf = gltf["buffers"][index]
    uri = buf.get("uri")
    if uri is None:
        return binary
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


class _Reader:
    def __init__(self, gltf, base_dir, binary):
        self.gltf = gltf
        self.buffers = [
            _read_buffer(gltf, i, base_dir, binary)
            for i in range(len(gltf.get("buffers", [])))
        ]

    def accessor(self, index) -> np.ndarray:
        acc = self.gltf["accessors"][index]
        view = self.gltf["bufferViews"][acc["bufferView"]]
        buf = self.buffers[view["buffer"]]
        dtype = _COMPONENT[acc["componentType"]]
        ncomp = _SIZE[acc["type"]]
        count = acc["count"]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or ncomp * np.dtype(dtype).itemsize
        itemsize = np.dtype(dtype).itemsize
        if stride == ncomp * itemsize:
            out = np.frombuffer(buf, dtype=dtype, count=count * ncomp, offset=offset)
            return out.reshape(count, ncomp)
        rows = np.zeros((count, ncomp), dtype)
        for i in range(count):
            rows[i] = np.frombuffer(buf, dtype=dtype, count=ncomp,
                                    offset=offset + i * stride)
        return rows

    def image(self, index):
        img = self.gltf["images"][index]
        if "bufferView" in img:
            view = self.gltf["bufferViews"][img["bufferView"]]
            blob = self.buffers[view["buffer"]][
                view.get("byteOffset", 0) : view.get("byteOffset", 0) + view["byteLength"]
            ]
        elif img.get("uri", "").startswith("data:"):
            blob = base64.b64decode(img["uri"].split(",", 1)[1])
        else:
            with open(os.path.join(self.base_dir, img["uri"]), "rb") as f:
                blob = f.read()
        if blob[:8] == b"\x89PNG\r\n\x1a\n":
            return decode_png(bytes(blob))
        if blob[:2] == b"\xff\xd8":
            # Baseline/progressive JPEG — glTF's common case (the reference's
            # flagship DamagedHelmet.glb uses JPEG, imported by Unity in
            # BVHScene.cs:284-426). Decoded via Pillow when present.
            try:
                import io

                from PIL import Image

                img_ = Image.open(io.BytesIO(blob)).convert("RGBA")
                return np.asarray(img_, np.uint8)
            except ImportError:
                import warnings

                warnings.warn(
                    "JPEG texture skipped: Pillow not available; "
                    "falling back to material factor constants",
                    stacklevel=2,
                )
                return None
        return None  # unknown format: fall back to factor constants


def _node_matrix(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        m[:3, :3] = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
    if "scale" in node:
        m[:3, :3] = m[:3, :3] * np.asarray(node["scale"], np.float32)[None, :]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def load_gltf(path: str, use_instancing: bool = False) -> Scene:
    """Load .glb or .gltf into a Scene.

    ``use_instancing=True`` keeps meshes local + adds TLAS instances (one
    per node reference); otherwise world transforms are baked in.
    """
    base_dir = os.path.dirname(path)
    if path.endswith(".glb"):
        gltf, binary = _load_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        binary = b""
    reader = _Reader(gltf, base_dir, binary)
    reader.base_dir = base_dir

    scene = Scene()

    # Textures -> atlas.
    tex_index = {}
    for i, tex in enumerate(gltf.get("textures", [])):
        img = reader.image(tex["source"]) if "source" in tex else None
        if img is not None:
            tex_index[i] = scene.add_texture(img)

    def tex_or(minfo, key, default=-1):
        t = minfo.get(key, {}).get("index", None)
        return tex_index.get(t, default) if t is not None else default

    # Materials.
    mat_ids = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        trans_ext = m.get("extensions", {}).get("KHR_materials_transmission", {})
        ior_ext = m.get("extensions", {}).get("KHR_materials_ior", {})
        desc = MaterialDesc(
            base_color=tuple(base),
            metallic=pbr.get("metallicFactor", 1.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            emission=tuple(m.get("emissiveFactor", [0, 0, 0])),
            alpha_mode={"OPAQUE": 0, "BLEND": 1, "MASK": 2}.get(m.get("alphaMode", "OPAQUE"), 0),
            alpha_cutoff=m.get("alphaCutoff", 0.5),
            transmission=trans_ext.get("transmissionFactor", 0.0),
            ior=ior_ext.get("ior", 1.5),
            base_color_texture=tex_or(pbr, "baseColorTexture"),
            metallic_roughness_texture=tex_or(pbr, "metallicRoughnessTexture"),
            normal_texture=tex_or(m, "normalTexture"),
            emission_texture=tex_or(m, "emissiveTexture"),
            occlusion_texture=tex_or(m, "occlusionTexture"),
        )
        mat_ids.append(scene.add_material(desc))
    if not mat_ids:
        mat_ids = [scene.add_material(MaterialDesc())]

    # Meshes -> primitives.
    mesh_prims: list[list[int]] = []
    for gm in gltf.get("meshes", []):
        prims = []
        for prim in gm.get("primitives", []):
            if prim.get("mode", 4) != 4:
                continue
            attrs = prim["attributes"]
            pos = reader.accessor(attrs["POSITION"]).astype(np.float32)
            nrm = (reader.accessor(attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else None)
            uv = (reader.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else None)
            if "indices" in prim:
                idx = reader.accessor(prim["indices"]).reshape(-1, 3).astype(np.int32)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int32).reshape(-1, 3)
            mat = mat_ids[prim["material"]] if "material" in prim else mat_ids[0]
            mesh = Mesh(vertices=pos, indices=idx, normals=nrm, uvs=uv,
                        material_index=mat)
            prims.append(scene.add_mesh(mesh))
        mesh_prims.append(prims)

    # Node hierarchy.
    scene_nodes = gltf.get("scenes", [{}])[gltf.get("scene", 0)].get("nodes", [])
    placed = []

    def walk(node_id, parent):
        node = gltf["nodes"][node_id]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            for mesh_id in mesh_prims[node["mesh"]]:
                placed.append((mesh_id, world.copy()))
        for child in node.get("children", []):
            walk(child, world)

    for root in scene_nodes:
        walk(root, np.eye(4, dtype=np.float32))

    if use_instancing:
        for mesh_id, world in placed:
            scene.add_instance(mesh_id, world, None)
    else:
        # Bake transforms: replace mesh list entries with placed copies.
        meshes = scene.meshes
        scene.meshes = []
        for mesh_id, world in placed:
            scene.meshes.append((meshes[mesh_id][0], world))
        if not placed:  # no node graph: keep meshes as-is
            scene.meshes = meshes
    return scene
