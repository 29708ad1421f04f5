"""Scene assembly: host meshes -> device tables (``scene/scene.py`` of the
reference, its ``build("wide16")`` branches).

A scene without instances is flattened to world space under one wide16
table.  A scene with instances (``Scene.add_instance``) builds one BLAS per
mesh in mesh space (cached on the ``Scene``) and a TLAS over the instance
boxes, joined in one table (``accel/wide16.py::build_tlas_wide16``);
moving an instance re-emits only the TLAS rows (``rebuild_tlas_rows``).
``leaf8`` builds every table with 48-float rows and 8-triangle leaves.

``build("wide8")`` builds the reference's 8-wide cross-check table
(``accel/wide8.py``) the same two ways, one level or two.

``SceneData`` holds what the integrators read: the wide16 node table
and its root slot table (or the wide8 table), the stack depth, the
packed attribute rows (f16, ``attr_compact`` 1 and 2; oct-encoded
normals, mode 3), the per-vertex tangents (normal maps), the material records, the texture
atlas, the analytic lights, the instance transforms and the environment
tables.  The megakernel and wavefront integrators (``render/integrator.py``)
read the f32 per-triangle tables instead of the packed rows: ``tris``
(``[e2, e1, v0]`` records, the brute-force backend's input), ``tri_index``
and ``attr_normals``/``attr_uvs``/``attr_material``, all in BVH order, as
the reference lays them out (``tri_index`` is the identity there).  The
fused integrator's ``attr_compact=0`` reads the last three too: they hold
the values of the reference's f32 ``attr_shade`` rows, which
``scene_to_numpy`` packs byte for byte (``_pack_attr_shade``) and the
device does not keep a second time.
``build("bruteforce")`` keeps the triangles in scene order and builds no
node table (a (1, 96) placeholder), as the reference's does.

A material index past 0xFFFF does not fit the compact rows' u16 field: the
build then warns and leaves those tables as the reference's placeholders
(``_pack_or_placeholder``), and a fused pass that would read them refuses
(``render/fused.py``); the f32 tables serve such scenes, in the megakernel
and in the fused integrator's mode 0.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.accel import wide8 as w8
from unity_webgpu_pathtracer_torch.accel import wide16 as w16
from unity_webgpu_pathtracer_torch.device import resolve_device
from unity_webgpu_pathtracer_torch.scene import lights as ulights
from unity_webgpu_pathtracer_torch.scene import material as umaterial
from unity_webgpu_pathtracer_torch.scene import texture as utexture
from unity_webgpu_pathtracer_torch.scene.envmap import EnvMap, build_envmap, empty_envmap
from unity_webgpu_pathtracer_torch.scene.mesh import FlatTriangles, Mesh, concat_flat, flatten_mesh


def _pack_attr_shade(normals9: np.ndarray, uvs6: np.ndarray,
                     material: np.ndarray) -> np.ndarray:
    """f32 per-triangle shading rows ``[normals 9 | uvs 6 | material (int
    bits) 1]``, three triangles to a 48-float row: triangle ``t`` is row
    ``t // 3``, sub-slot ``t % 3`` (``attr_compact=0``)."""
    t = normals9.shape[0]
    flat = np.zeros((t, 16), np.float32)
    flat[:, 0:9] = normals9
    flat[:, 9:15] = uvs6
    flat[:, 15] = material.astype(np.int32).view(np.float32)
    rows = (t + 2) // 3
    out = np.zeros((rows * 3, 16), np.float32)
    out[:t] = flat
    return out.reshape(rows, 48)


class _MaterialRangeError(ValueError):
    """A material index does not fit the u16 field of a compact row."""


def _check_u16_materials(m: np.ndarray) -> None:
    if m.size and (m.max() > 0xFFFF or m.min() < 0):
        raise _MaterialRangeError("attr_compact supports at most 65536 materials")


def _pack_or_placeholder(pack_fn, placeholder: np.ndarray, *args) -> np.ndarray:
    """``pack_fn(*args)``, or, when a material index does not fit its u16
    field, ``placeholder`` with the reference's warning: a scene that never
    reads the compact rows must not be refused for them."""
    try:
        return pack_fn(*args)
    except _MaterialRangeError as e:
        warnings.warn(f"{e}; compact attr table degraded to placeholder "
                      "(rendering with config.attr_compact set will fail)", stacklevel=2)
        return np.asarray(placeholder)


def _pack_attr_shade_c(normals9: np.ndarray, uvs6: np.ndarray,
                       material: np.ndarray) -> np.ndarray:
    """Compact 32-byte per-triangle shading rows: 15 f16 halfwords
    [normals 9 | uvs 6] + one u16 material index, little-endian-packed
    into 8 uint32 words, padded to a multiple of 6 triangles."""
    t = normals9.shape[0]
    h = np.zeros((((t + 5) // 6) * 6, 16), np.uint16)
    h[:t, 0:9] = normals9.astype(np.float16).view(np.uint16)
    h[:t, 9:15] = np.clip(uvs6, -65504, 65504).astype(np.float16).view(np.uint16)
    m = material.astype(np.int64)
    _check_u16_materials(m)
    h[:t, 15] = m.astype(np.uint16)
    return np.ascontiguousarray(h).view(np.uint32)   # (T_pad, 8)


def _oct_encode_u32(normals: np.ndarray) -> np.ndarray:
    """(N, 3) normals -> one u32 each: 16-bit octahedral ``x | y << 16``;
    zero vectors map to the +z pole."""
    n = np.asarray(normals, np.float32)
    denom = np.maximum(np.abs(n).sum(axis=1, keepdims=True), 1e-20)
    p = n[:, 0:2] / denom
    sign = np.where(p >= 0.0, 1.0, -1.0).astype(np.float32)
    folded = (1.0 - np.abs(p[:, ::-1])) * sign
    p = np.where((n[:, 2] < 0.0)[:, None], folded, p)
    q = np.clip(np.round((p * 0.5 + 0.5) * 65535.0), 0, 65535).astype(np.uint32)
    return q[:, 0] | (q[:, 1] << np.uint32(16))


def _pack_attr_shade_o(normals9: np.ndarray, material: np.ndarray) -> np.ndarray:
    """16-byte per-triangle rows for ``attr_compact=3``: three oct-encoded
    vertex normals and the material index, 4 uint32 words, padded to a
    multiple of 4 triangles.  No uv: the mode serves untextured scenes."""
    t = normals9.shape[0]
    out = np.zeros((((t + 3) // 4) * 4, 4), np.uint32)
    n = np.asarray(normals9, np.float32).reshape(t, 3, 3)
    for v in range(3):
        out[:t, v] = _oct_encode_u32(n[:, v])
    m = material.astype(np.int64)
    _check_u16_materials(m)
    out[:t, 3] = m.astype(np.uint32)
    return np.ascontiguousarray(out)   # (T_pad, 4)


def _attr_tables(flat: FlatTriangles) -> dict:
    """The packed rows of the fused integrator and the f32 tables of the
    megakernel (which the fused integrator's mode 0 reads too), from
    triangles already in the order the leaves index."""
    m = flat.count
    normals9, uvs6 = flat.normals.reshape(m, 9), flat.uvs.reshape(m, 6)
    return dict(attr_shade_c=_pack_or_placeholder(_pack_attr_shade_c,
                                                  np.zeros((2, 8), np.uint32),
                                                  normals9, uvs6, flat.material),
                attr_shade_o=_pack_or_placeholder(_pack_attr_shade_o,
                                                  np.zeros((4, 4), np.uint32),
                                                  normals9, flat.material),
                attr_tangents=flat.tangents.reshape(m, 9),
                tris=flat.tri_records(), tri_index=np.arange(m, dtype=np.int32),
                attr_normals=normals9, attr_uvs=uvs6,
                attr_material=flat.material)


class SceneData(NamedTuple):
    """Device tables of the integrators."""

    wide16_nodes: torch.Tensor   # (N16, 96), or leaf8 (N16, 48), float32 (ints bitcast)
    wide16_top: torch.Tensor     # (16, 119) root slot table, or (1, 119) placeholder
    wide8_nodes: torch.Tensor    # (N8, 48) float32 wide8 table; (1, 48) absent
    stack_depth: int             # register-stack planes (tree depth + 1; +4 instanced)
    attr_shade_c: torch.Tensor   # (T_pad, 8) int32 view of the uint32 rows; (2, 8) placeholder
    attr_shade_o: torch.Tensor   # (T_pad4, 4) int32 view of the oct rows; (0, 4) absent,
                                 # (4, 4) placeholder
    attr_tangents: torch.Tensor  # (T, 9) float32 per-vertex tangents; (0, 9) absent
    materials: torch.Tensor      # (NM, 32) float32
    texture_data: torch.Tensor   # (K,) int32 view of the uint32 atlas; (0,) none
    lights: torch.Tensor         # (L, 16) float32 light records; (0, 16) none
    env: EnvMap
    inst_l2w: torch.Tensor       # (I, 12) float32 row-major 3x4; (0, 12) flat
    inst_w2l: torch.Tensor       # (I, 12)
    inst_offsets: torch.Tensor   # (I, 4) int32, [:, 3] material override (-1 none)
    # The megakernel's tables (empty when absent).
    tris: torch.Tensor           # (T, 9) float32 [e2, e1, v0] records
    tri_index: torch.Tensor      # (T,) int32 triangle -> attribute row
    attr_normals: torch.Tensor   # (T, 9) float32 per-vertex normals
    attr_uvs: torch.Tensor       # (T, 6) float32 per-vertex uvs
    attr_material: torch.Tensor  # (T,) int32


def _env_arrays(image) -> dict:
    env = build_envmap(image) if image is not None else empty_envmap()
    return dict(env._asdict())


def light_table(lights: list) -> np.ndarray:
    """The (L, 16) light records of ``lights``; (0, 16) when there are none."""
    return ulights.pack_lights(lights) if lights else np.zeros((0, 16), np.float32)


@dataclasses.dataclass
class Scene:
    """Host-side scene under construction."""

    meshes: list = dataclasses.field(default_factory=list)      # (Mesh, transform|None)
    materials: list = dataclasses.field(default_factory=list)   # MaterialDesc
    lights: list = dataclasses.field(default_factory=list)      # LightDesc
    textures: list = dataclasses.field(default_factory=list)    # (H, W, 3|4) images
    env_image: np.ndarray | None = None
    # (mesh id, 4x4 transform, material index or None) per instance.
    instances: list = dataclasses.field(default_factory=list)
    # Per-mesh BLASes of the last instanced build (with its leaf8 flag)
    # and its TLAS layout.
    _blas16_cache: tuple | None = dataclasses.field(default=None, repr=False)
    _tlas16_layout: w16.TlasLayout | None = dataclasses.field(default=None, repr=False)
    # The same for the last instanced wide8 build.
    _blas8_cache: tuple | None = dataclasses.field(default=None, repr=False)
    _tlas8_layout: w8.TlasLayout | None = dataclasses.field(default=None, repr=False)

    def add_material(self, desc: umaterial.MaterialDesc) -> int:
        self.materials.append(desc)
        return len(self.materials) - 1

    def add_texture(self, image: np.ndarray) -> int:
        self.textures.append(image)
        return len(self.textures) - 1

    def add_mesh(self, mesh: Mesh, transform: np.ndarray | None = None) -> int:
        self.meshes.append((mesh, transform))
        return len(self.meshes) - 1

    def add_light(self, desc: ulights.LightDesc) -> int:
        self.lights.append(desc)
        return len(self.lights) - 1

    def add_instance(self, mesh_id: int, transform: np.ndarray,
                     material_index: int | None = None) -> int:
        """Place mesh ``mesh_id`` (its own transform is ignored) under
        ``transform``; ``material_index`` overrides the mesh's material."""
        self.instances.append((mesh_id, np.asarray(transform, np.float32), material_index))
        return len(self.instances) - 1

    def set_instance_transform(self, instance_id: int, transform: np.ndarray) -> None:
        """Move an instance; the next build reuses the cached BLASes."""
        mesh_id, _old, mat = self.instances[instance_id]
        self.instances[instance_id] = (mesh_id, np.asarray(transform, np.float32), mat)

    def set_environment(self, image: np.ndarray) -> None:
        self.env_image = np.asarray(image, np.float32)

    def world_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """World-space AABB over meshes and instances (camera framing)."""
        los, his = [], []

        def acc(mesh, xf):
            v = mesh.vertices
            if xf is not None:
                v = v @ np.asarray(xf, np.float32)[:3, :3].T + xf[:3, 3]
            los.append(v.min(axis=0))
            his.append(v.max(axis=0))

        for mesh, xf in self.meshes:
            acc(mesh, xf)
        for mesh_id, xf, _mat in self.instances:
            acc(self.meshes[mesh_id][0], xf)
        if not los:
            return np.zeros(3, np.float32), np.ones(3, np.float32)
        return (np.min(los, axis=0).astype(np.float32),
                np.max(his, axis=0).astype(np.float32))

    def _shading_arrays(self) -> dict:
        """Materials, texture atlas, lights and environment tables."""
        return dict(
            materials=umaterial.pack_materials(self.materials or [umaterial.MaterialDesc()]),
            texture_data=utexture.build_atlas(self.textures),
            lights=light_table(self.lights),
            env=_env_arrays(self.env_image),
        )

    def flatten(self) -> FlatTriangles:
        """World-space flattened triangle soup."""
        if not self.meshes:
            raise ValueError("scene has no meshes")
        return concat_flat([flatten_mesh(m, xf) for m, xf in self.meshes])

    def build_arrays(self, leaf8: bool | None = None, traversal: str = "wide16") -> dict:
        """Host build of the device tables as numpy arrays (the layout of
        ``scene_from_numpy``'s input); ``leaf8`` as in
        ``accel/wide16.py::build_scene_wide16``.  ``traversal="wide8"``
        builds the 8-wide table instead; ``"bruteforce"`` builds no node
        table and keeps the triangles in scene order."""
        if traversal not in ("wide16", "wide8", "bruteforce"):
            raise ValueError(f"the PyTorch port builds 'wide16', 'wide8' or 'bruteforce', "
                             f"not {traversal!r}")
        no16 = dict(wide16_nodes=np.zeros((1, w16.ROW), np.float32),
                    wide16_top=np.zeros((1, w16.TOP_COLS), np.float32))
        if traversal == "bruteforce":
            if self.instances:
                raise ValueError("instanced scenes need traversal='wide16' or 'wide8'")
            return dict(
                **no16,
                stack_levels=np.zeros((24,), np.int32),
                **_attr_tables(self.flatten()),
                **self._shading_arrays(),
            )
        if self.instances:
            if traversal == "wide8":
                return self._build_instanced_arrays(False, "wide8")
            return self._build_instanced_arrays(w16.resolve_leaf8(leaf8), "wide16")
        flat = self.flatten()
        if traversal == "wide8":
            w = w8.build_scene_wide8(flat.positions, flat.tri_records())
            return dict(
                **no16,
                wide8_nodes=w.nodes,
                stack_levels=np.zeros((w.depth + 1,), np.int32),
                **_attr_tables(flat.permuted(w.order)),
                **self._shading_arrays(),
            )
        w = w16.build_scene_wide16(flat.positions, flat.tri_records(), w16.resolve_leaf8(leaf8))
        top = w16.derive_top16(w.nodes)
        # Leaf rows index attributes by BVH reference position.
        flat = flat.permuted(w.order)
        return dict(
            wide16_nodes=w.nodes,
            wide16_top=top if top is not None else np.zeros((1, w16.TOP_COLS), np.float32),
            stack_levels=np.zeros((w.depth + 1,), np.int32),
            **_attr_tables(flat),
            **self._shading_arrays(),
        )

    def _build_instanced_arrays(self, leaf8: bool, fmt: str) -> dict:
        """Two-level build (``fmt`` "wide16" or "wide8"): cached per-mesh
        BLASes in mesh space and the TLAS over the instances (the
        reference's ``_build_instanced_quant``).  Attributes stay in mesh
        space; shading takes normals to world space per hit."""
        if fmt == "wide16":
            cache = self._blas16_cache
            fresh = cache is None or cache[4] != leaf8
        else:
            cache = self._blas8_cache
            fresh = cache is None
        if fresh:
            blas, bounds, parts, attr_bases = [], [], [], []
            attr_base = 0
            for mesh, _transform in self.meshes:
                flat = flatten_mesh(mesh, None)
                w = (w16.build_scene_wide16(flat.positions, flat.tri_records(), leaf8)
                     if fmt == "wide16" else
                     w8.build_scene_wide8(flat.positions, flat.tri_records()))
                blas.append(w)
                p = flat.positions.reshape(-1, 3)
                bounds.append((p.min(0), p.max(0)))
                # Leaf indices are mesh-local BVH reference positions.
                parts.append(flat.permuted(w.order))
                attr_bases.append(attr_base)
                attr_base += int(w.order.shape[0])
            cache = (blas, bounds, parts, attr_bases, leaf8)
            if fmt == "wide16":
                self._blas16_cache = cache
            else:
                self._blas8_cache = cache
        blas, bounds, parts, attr_bases, _leaf8 = cache
        flat = concat_flat(parts)
        if fmt == "wide16":
            w, l2w, w2l, self._tlas16_layout = w16.build_tlas_wide16(
                blas, bounds, self.instances, attr_bases)
            tables = dict(
                wide16_nodes=w.nodes,
                # No root slot table: the TLAS rows change under transform
                # updates, so the prestep runs its first level only.
                wide16_top=np.zeros((1, w16.TOP_COLS), np.float32))
        else:
            w, l2w, w2l, self._tlas8_layout = w8.build_tlas_wide8(
                blas, bounds, self.instances, attr_bases)
            tables = dict(wide16_nodes=np.zeros((1, w16.ROW), np.float32),
                          wide16_top=np.zeros((1, w16.TOP_COLS), np.float32),
                          wide8_nodes=w.nodes)
        offsets = np.zeros((len(self.instances), 4), np.int32)
        offsets[:, 3] = [-1 if mat is None else mat for _m, _t, mat in self.instances]
        return dict(
            **tables,
            # +4 planes: a TLAS-only refresh may deepen the tree a little.
            stack_levels=np.zeros((w.depth + 4,), np.int32),
            **_attr_tables(flat),
            **self._shading_arrays(),
            inst_l2w=l2w, inst_w2l=w2l, inst_offsets=offsets,
        )

    def build(self, traversal: str = "wide16", device=None,
              leaf8: bool | None = None) -> SceneData:
        """Build the tables of ``traversal`` (``"wide16"``, ``"wide8"`` or
        ``"bruteforce"``) and move them to ``device`` (None: the CUDA
        device; ``"cpu"`` for the CPU).  ``leaf8`` selects 48-float rows
        with 8-triangle leaves (``accel/wide16.py::resolve_leaf8``)."""
        arrays = self.build_arrays(leaf8, traversal)
        return scene_from_numpy(arrays, resolve_device(device))


def rebuild_tlas_rows(scene: Scene, fmt: str = "wide16"):
    """Transform-only refresh of an instanced scene's last ``fmt`` build
    ("wide16" or "wide8"): only the fixed-capacity TLAS rows are
    re-emitted, as wide as the built table's.  Returns ``(rows (cap, 96 or
    48), inst_l2w, inst_w2l)``; rows ``[0, cap)`` of the node table take
    ``rows``."""
    if fmt == "wide16":
        cache, layout = scene._blas16_cache, scene._tlas16_layout
    else:
        cache, layout = scene._blas8_cache, scene._tlas8_layout
    if cache is None or layout is None:
        raise ValueError(f"no cached instanced {fmt} build; build the scene first")
    if fmt == "wide16":
        rows, depth, l2w, w2l = w16.emit_tlas_rows16(
            list(scene.instances), cache[1], layout.blas_root, layout.tlas_cap,
            cache[0][0].nodes.shape[1])
    else:
        rows, depth, l2w, w2l = w8.emit_tlas_rows(
            list(scene.instances), cache[1], layout.blas_root, layout.tlas_cap)
    # The stack was sized at build time with 3 planes to spare.
    if depth > layout.tlas_depth0 + 3:
        raise ValueError(f"the TLAS deepened past the traversal stack (depth {depth} > "
                         f"{layout.tlas_depth0} + 3); rebuild the scene")
    return rows, l2w, w2l


def scene_from_numpy(arrays: dict, device=None) -> SceneData:
    """``SceneData`` on ``device`` (None: the CUDA device) from numpy
    arrays keyed by the reference's ``SceneData`` field names:
    ``wide16_nodes``, ``wide16_top``, ``stack_levels`` (only its length is
    read), ``attr_shade_c``, ``materials``, ``env`` (a dict of the
    ``EnvMap`` fields) and, optional, ``wide8_nodes``,
    ``attr_shade_o``, ``attr_tangents``,
    ``texture_data`` (the uint32 atlas), ``lights``, for instanced
    scenes ``inst_l2w``, ``inst_w2l`` and ``inst_offsets``, and the
    megakernel's ``tris``, ``tri_index``, ``attr_normals``, ``attr_uvs``
    and ``attr_material`` (each empty when absent; the fused mode 0 reads
    them in place of the f32 ``attr_shade`` rows, which are ignored here).
    Tests feed it ``np.asarray`` of the JAX fields, so both packages trace
    the same tables."""
    device = resolve_device(device)

    def t(a, dtype=None):
        a = np.asarray(a)
        a = np.array(a if dtype is None else a.view(dtype), order="C")
        return torch.from_numpy(a).to(device)

    env = EnvMap(**{f: arrays["env"][f] for f in EnvMap._fields}).to_tensors(device)
    return SceneData(
        wide16_nodes=t(arrays["wide16_nodes"]),
        wide16_top=t(arrays["wide16_top"]),
        wide8_nodes=t(arrays.get("wide8_nodes", np.zeros((1, w8.ROW), np.float32))),
        stack_depth=int(np.asarray(arrays["stack_levels"]).shape[0]),
        attr_shade_c=t(arrays["attr_shade_c"], np.int32),
        attr_shade_o=t(arrays.get("attr_shade_o", np.zeros((0, 4), np.uint32)), np.int32),
        attr_tangents=t(arrays.get("attr_tangents", np.zeros((0, 9), np.float32))),
        materials=t(arrays["materials"]),
        texture_data=t(arrays.get("texture_data", np.zeros((0,), np.uint32)), np.int32),
        lights=t(arrays.get("lights", np.zeros((0, 16), np.float32))),
        env=env,
        inst_l2w=t(arrays.get("inst_l2w", np.zeros((0, 12), np.float32))),
        inst_w2l=t(arrays.get("inst_w2l", np.zeros((0, 12), np.float32))),
        inst_offsets=t(arrays.get("inst_offsets", np.zeros((0, 4), np.int32))),
        tris=t(arrays.get("tris", np.zeros((0, 9), np.float32))),
        tri_index=t(arrays.get("tri_index", np.zeros((0,), np.int32))),
        attr_normals=t(arrays.get("attr_normals", np.zeros((0, 9), np.float32))),
        attr_uvs=t(arrays.get("attr_uvs", np.zeros((0, 6), np.float32))),
        attr_material=t(arrays.get("attr_material", np.zeros((0,), np.int32))),
    )


def scene_to_numpy(scene: SceneData) -> dict:
    """Inverse of ``scene_from_numpy`` (attribute rows and the atlas as
    uint32), with the reference's f32 ``attr_shade`` rows packed from the
    per-triangle tables."""
    def n(x):
        return x.detach().cpu().numpy()

    return dict(
        wide16_nodes=n(scene.wide16_nodes),
        wide16_top=n(scene.wide16_top),
        wide8_nodes=n(scene.wide8_nodes),
        stack_levels=np.zeros((scene.stack_depth,), np.int32),
        attr_shade=_pack_attr_shade(n(scene.attr_normals), n(scene.attr_uvs),
                                    n(scene.attr_material)),
        attr_shade_c=n(scene.attr_shade_c).view(np.uint32),
        attr_shade_o=n(scene.attr_shade_o).view(np.uint32),
        attr_tangents=n(scene.attr_tangents),
        materials=n(scene.materials),
        texture_data=n(scene.texture_data).view(np.uint32),
        lights=n(scene.lights),
        env={f: n(getattr(scene.env, f)) for f in EnvMap._fields},
        inst_l2w=n(scene.inst_l2w), inst_w2l=n(scene.inst_w2l),
        inst_offsets=n(scene.inst_offsets),
        tris=n(scene.tris), tri_index=n(scene.tri_index), attr_normals=n(scene.attr_normals),
        attr_uvs=n(scene.attr_uvs), attr_material=n(scene.attr_material),
    )
