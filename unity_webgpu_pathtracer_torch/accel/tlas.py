"""Two-level fat-row table (``accel/tlas.py`` of the reference): a TLAS
over instance boxes and each mesh's BLAS, in one ``accel/wide.py`` table,
for the ``wide`` and ``wide2`` traversals.

* rows ``[0, tlas_len)``: the TLAS, 4-ary inner rows over instance boxes
  and one *instance row* per instance;
* rows ``[tlas_len, ...)``: each mesh's BLAS once, its DFS indices offset
  by its place.

An instance row has count ``-(instance + 1)``, the BLAS's first row and
length in child lanes 0-1, the instance's material override (-1 none) in
lane 2, and a skip.  A TLAS row whose subtree ends the TLAS skips to the
end of the table (the reference's skips to the first BLAS row, so its
lanes go on through every BLAS in world space: the one difference from
its table).  Arriving at it, a lane takes the ray into the
instance's space with an unnormalized direction, so ``t`` is the same in
both spaces and hits of different instances compare directly; when the
lane's pointer leaves the BLAS region it resumes at the instance row's
skip, in world space.

``export_aila_laine`` writes the 2-wide Aila-Laine TLAS the original
renderer uploads (64-byte nodes and an instance index array), a format
check only: no traversal reads it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from unity_webgpu_pathtracer_torch.accel import bvh2 as ubvh2

ROW = 48
OFF_PTRS = 24       # inner: child indices; instance: blas row, length, material
OFF_SKIP = 44
OFF_KIND = 45       # 0 inner, > 0 leaf count, < 0 -(instance + 1)


@dataclasses.dataclass
class TlasScene:
    """A two-level build."""

    nodes: np.ndarray          # (1, N, 48) the joined table
    inst_l2w: np.ndarray       # (I, 12) row-major 3x4
    inst_w2l: np.ndarray       # (I, 12)
    inst_material: np.ndarray  # (I,) int32, -1 = the triangles' own


def _i32(v: int) -> np.float32:
    return np.asarray([v], np.int32).view(np.float32)[0]


def _affine_rows(m: np.ndarray) -> np.ndarray:
    return np.asarray(m, np.float32)[:3, :4].reshape(-1)


def transform_aabb(lo, hi, m):
    """The world box of a transformed local box (its 8 corners)."""
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    w = corners @ np.asarray(m)[:3, :3].T + np.asarray(m)[:3, 3]
    return w.min(axis=0), w.max(axis=0)


def _instance_bvh(instances: list[tuple], blas_bounds: list[tuple], leaf_size: int):
    """A BVH2 over the instances' world boxes (each a degenerate
    'triangle' of its two corners and its centre)."""
    n_inst = len(instances)
    lo = np.zeros((n_inst, 3), np.float32)
    hi = np.zeros((n_inst, 3), np.float32)
    for i, (mesh_id, m, _mat) in enumerate(instances):
        lo[i], hi[i] = transform_aabb(*blas_bounds[mesh_id], m)
    centers = ((lo + hi) * 0.5).reshape(n_inst, 1, 3)
    fake = np.concatenate([lo.reshape(n_inst, 1, 3), hi.reshape(n_inst, 1, 3), centers], axis=1)
    return ubvh2.build_bvh2(fake, leaf_size=leaf_size)


def build_tlas_wide(blas_tables: list[np.ndarray], blas_bounds: list[tuple],
                    instances: list[tuple]) -> TlasScene:
    """Join the TLAS and the BLASes.

    ``blas_tables``: per mesh, its ``(1, Nk, 48)`` table in mesh space;
    ``blas_bounds``: per mesh, its (lo, hi) box; ``instances``: ``(mesh_id,
    4x4 transform, material override or None)`` each."""
    # Leaf size 1: one instance row per instance; one fixed child order.
    tl = _instance_bvh(instances, blas_bounds, 1)
    rows_out: list[np.ndarray] = []
    inst_rows = []   # (row index, mesh id)

    def children4(node):
        l = tl.left[node]
        out = []
        for c in (l, l + 1):
            if tl.count[c] > 0:
                out.append(c)
            else:
                cl = tl.left[c]
                out.extend([cl, cl + 1])
        return out

    def emit(node) -> int:
        my = len(rows_out)
        row = np.zeros(ROW, np.float32)
        rows_out.append(row)
        if tl.count[node] > 0:
            inst_id = int(tl.order[tl.start[node]])
            mesh_id, _m, mat = instances[inst_id]
            row[OFF_KIND] = _i32(-(inst_id + 1))
            row[OFF_PTRS + 2] = _i32(mat if mat is not None else -1)
            inst_rows.append((my, mesh_id))
        else:
            kids = children4(node)
            ptrs = np.zeros(4, np.int32)
            boxes = np.zeros((6, 4), np.float32)
            boxes[0:3] = np.inf
            boxes[3:6] = -np.inf
            for k, c in enumerate(kids):
                boxes[0:3, k] = tl.nmin[c]
                boxes[3:6, k] = tl.nmax[c]
                ptrs[k] = emit(c)
            row[0:24] = boxes.reshape(-1)
            row[OFF_PTRS:OFF_PTRS + 4] = ptrs.view(np.float32)
        row[OFF_SKIP] = _i32(len(rows_out))
        return my

    emit(0)
    tlas_len = len(rows_out)

    # Each mesh's BLAS once, its row indices offset by its place.
    mesh_offset = {}
    appended = []
    cursor = tlas_len
    for mesh_id, table in enumerate(blas_tables):
        t = np.array(table[0], np.float32)
        ints = t[:, 44:46].view(np.int32)
        kinds = ints[:, 1]
        t[:, 44] = (ints[:, 0] + cursor).view(np.float32)
        ptrs = t[:, 24:28].view(np.int32)
        adj = np.where((ptrs > 0) & (kinds == 0)[:, None], ptrs + cursor, ptrs)
        t[:, 24:28] = adj.view(np.float32)
        mesh_offset[mesh_id] = (cursor, t.shape[0])
        cursor += t.shape[0]
        appended.append(t)

    for row_idx, mesh_id in inst_rows:
        off, ln = mesh_offset[mesh_id]
        rows_out[row_idx][OFF_PTRS + 0] = _i32(off)
        rows_out[row_idx][OFF_PTRS + 1] = _i32(ln)

    table = np.concatenate([np.stack(rows_out)] + appended, axis=0)
    # The TLAS rows whose subtree ends the TLAS skip to the table's end.
    # The reference leaves them at the TLAS's end, which is the first BLAS
    # row: a lane that has walked the TLAS then walks every BLAS in world
    # space and meets each mesh untransformed (at its mesh-space place).
    tlas_skips = table[:tlas_len, OFF_SKIP:OFF_SKIP + 1].view(np.int32)
    tlas_skips[tlas_skips == tlas_len] = table.shape[0]

    n_inst = len(instances)
    inst_l2w = np.zeros((n_inst, 12), np.float32)
    inst_w2l = np.zeros((n_inst, 12), np.float32)
    inst_material = np.full((n_inst,), -1, np.int32)
    for i, (_mesh_id, m, mat) in enumerate(instances):
        m = np.asarray(m, np.float64)
        inst_l2w[i] = _affine_rows(m.astype(np.float32))
        inst_w2l[i] = _affine_rows(np.linalg.inv(m).astype(np.float32))
        inst_material[i] = -1 if mat is None else mat
    return TlasScene(nodes=table[None], inst_l2w=inst_l2w, inst_w2l=inst_w2l,
                     inst_material=inst_material)


def export_aila_laine(instances: list[tuple], blas_bounds: list[tuple]):
    """The original renderer's TLAS: 2-wide Aila-Laine nodes (16 floats,
    ints bitcast: ``{lmin, left, lmax, right, rmin, instCount, rmax,
    firstInst}``) in DFS order, and the instance index array of the leaves.
    Returns ``(nodes (N, 16) float32, index (I,) int32)``."""
    tl = _instance_bvh(instances, blas_bounds, 2)
    nodes = np.zeros((tl.node_count, 16), np.float32)
    iv = nodes.view(np.int32)
    mapping = {}
    stack = [0]
    while stack:
        nd = stack.pop()
        mapping[nd] = len(mapping)
        if tl.count[nd] == 0:
            stack.append(tl.left[nd] + 1)
            stack.append(tl.left[nd])
    for nd, my in mapping.items():
        if tl.count[nd] > 0:
            iv[my, 11] = int(tl.count[nd])
            iv[my, 15] = int(tl.start[nd])
        else:
            l = tl.left[nd]
            nodes[my, 0:3] = tl.nmin[l]
            nodes[my, 4:7] = tl.nmax[l]
            nodes[my, 8:11] = tl.nmin[l + 1]
            nodes[my, 12:15] = tl.nmax[l + 1]
            iv[my, 3] = mapping[l]
            iv[my, 7] = mapping[l + 1]
    return nodes, tl.order.astype(np.int32)


def refit_tlas(tlas: TlasScene, blas_tables, blas_bounds, instances) -> TlasScene:
    """The table after transform changes: the TLAS is built anew (as the
    original renderer rebuilds its TLAS every dirty frame), the BLAS rows
    are reused."""
    del tlas
    return build_tlas_wide(blas_tables, blas_bounds, instances)
