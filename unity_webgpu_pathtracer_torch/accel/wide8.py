"""8-wide quantized BVH ("wide8"), the reference's cross-check traversal
format (``accel/wide8.py`` of the reference), in numpy.

Child boxes are 8-bit offsets from a per-node anchor with power-of-two
per-axis scales, leaf triangles f16 offsets from a per-leaf anchor.
Children take slots by the octant of their centroid relative to the
parent's (collisions go to the nearest free slot by XOR distance), and the
traversal (``ops/traverse_wide8.py``) visits slots in ``k ^ ray_octant``
order.  Tables are built natively when the library is there
(``accel/native.py::native_wide8_or_none``) and in numpy otherwise; both
emit the reference's bytes.

Row layout, unified ``(N, 48)`` float32 (ints bitcast). ``f[3]`` is the
row kind ``meta``: 0 = inner, 1..8 = leaf triangle count, <0 = TLAS
instance ``-(id+1)``.

====== ============================== ========================= ==================
floats  inner                          leaf                      instance
====== ============================== ========================= ==================
0:3     anchor (node AABB min)         anchor (leaf AABB min)    unused
3       meta = 0                       meta = count              meta = -(id+1)
4       exps ``ex|ey<<8|ez<<16``       tri f16 SoA (36 floats:   world→local 3x4
5:8     unused                         9 comps x 8 lanes, v0     (4:16)
8:20    q8 boxes ``[qlox·8|qloy·8|     anchor-relative)          blas root (16)
        qloz·8|qhix·8|qhiy·8|qhiz·8]``
20:28   child row ptrs (int, -1 empty) attr idx x8 (40:48, -1)
====== ============================== ========================= ==================

Children are assigned to slots by the octant of their centroid relative to
the parent centroid (greedy, collisions resolved to the nearest free slot
by XOR distance, mirroring ``tiny_bvh.h:5871-5906``); the traversal then
visits slots in ``k ^ ray_octant`` order, which is near-to-far without any
per-octant table duplication (the 4-ary format needed 8 copies of the
whole table for this).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from unity_webgpu_pathtracer_torch.accel.bvh2 import BVH2, build_bvh2
from unity_webgpu_pathtracer_torch.accel.native import native_wide8_or_none
from unity_webgpu_pathtracer_torch.accel.wide16 import _canon_f16, _f32, _subtree_ranges

ROW = 48
MAX_LEAF = 8
MAX_DEPTH = 24   # traversal stack entries; the build refuses a deeper tree

OFF_META = 3
OFF_EXPS = 4
OFF_QBOX = 8
OFF_PTRS = 20
OFF_TRIS = 4
OFF_IDX = 40
OFF_W2L = 4
OFF_BLAS = 16


def _collapse8(bvh: BVH2, node: int, counts: np.ndarray) -> list[int]:
    """Greedy 2-wide -> up-to-8-wide collapse: repeatedly expand the child
    with the largest surface area; subtrees with <= MAX_LEAF triangles stay
    whole (they become one leaf row)."""

    def area(c):
        d = np.maximum(bvh.nmax[c] - bvh.nmin[c], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    l = bvh.left[node]
    kids = [l, l + 1]
    while len(kids) < MAX_LEAF:
        expandable = [
            (area(c), i)
            for i, c in enumerate(kids)
            if bvh.left[c] >= 0 and counts[c] > MAX_LEAF
        ]
        if not expandable:
            break
        _, i = max(expandable)
        c = kids.pop(i)
        cl = bvh.left[c]
        kids.extend([cl, cl + 1])
    return kids


def _assign_slots(bvh: BVH2, node: int, kids: list[int]) -> list[int | None]:
    """Octant-coded slot assignment (``tiny_bvh.h:5871-5906`` in spirit):
    slot bit b set when the child centroid is on the +b side of the parent
    centroid; collisions go to the nearest free slot by XOR distance."""
    pc = (bvh.nmin[node] + bvh.nmax[node]) * 0.5
    slots: list[int | None] = [None] * 8
    # Deterministic order: biggest children pick their slot first.
    def sa(c):
        d = np.maximum(bvh.nmax[c] - bvh.nmin[c], 0.0)
        return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    for c in sorted(kids, key=sa, reverse=True):
        cc = (bvh.nmin[c] + bvh.nmax[c]) * 0.5
        code = int((cc[0] > pc[0]) | ((cc[1] > pc[1]) << 1) | ((cc[2] > pc[2]) << 2))
        for dist in sorted(range(8), key=lambda d: (bin(d).count("1"), d)):
            s = code ^ dist
            if slots[s] is None:
                slots[s] = c
                break
    return slots


def _pack_u8x8(vals: np.ndarray) -> np.ndarray:
    """(8,) uint8 -> (2,) float32 (little-endian byte packing)."""
    b = np.asarray(vals, np.uint8).reshape(2, 4)
    words = (
        b[:, 0].astype(np.uint32)
        | (b[:, 1].astype(np.uint32) << 8)
        | (b[:, 2].astype(np.uint32) << 16)
        | (b[:, 3].astype(np.uint32) << 24)
    )
    return words.view(np.int32).view(np.float32)


def _pack_f16x8(vals: np.ndarray) -> np.ndarray:
    """(8,) float -> (4,) float32 carrying 8 packed float16 (canonicalized
    to the no-subnormal/no-inf table contract, see wide16._canon_f16)."""
    h = _canon_f16(np.asarray(vals, np.float16)).reshape(4, 2)
    words = h[:, 0].astype(np.uint32) | (h[:, 1].astype(np.uint32) << 16)
    return words.view(np.int32).view(np.float32)


def _quantize_node(row: np.ndarray, nmin: np.ndarray, nmax: np.ndarray,
                   boxes: list[tuple[np.ndarray, np.ndarray] | None]):
    """Write anchor + exponents + conservative 8-bit child boxes."""
    anchor = np.asarray(nmin, np.float32)
    extent = np.maximum(np.asarray(nmax, np.float32) - anchor, 0.0)
    # Power-of-two scale covering extent/255 (conservative upward). log2 can
    # round down at exact power-of-two boundaries, which would clip qhi to
    # 255 and shrink the box below the child's true bounds — bump e until
    # 255 * 2^e covers the extent.
    e = np.ceil(np.log2(np.maximum(extent / 255.0, 1e-30))).astype(np.int32)
    e = np.clip(e, -126, 127)
    scale = np.ldexp(np.ones(3, np.float32), e)
    short = 255.0 * scale < extent
    e = np.clip(e + short.astype(np.int32), -126, 127)
    scale = np.ldexp(np.ones(3, np.float32), e)
    row[0:3] = anchor
    row[OFF_EXPS] = _f32(
        int(e[0] + 127) | (int(e[1] + 127) << 8) | (int(e[2] + 127) << 16)
    )
    qlo = np.full((8, 3), 255, np.uint8)
    qhi = np.zeros((8, 3), np.uint8)
    for k, b in enumerate(boxes):
        if b is None:
            continue
        lo, hi = b
        ql = np.floor((np.asarray(lo, np.float32) - anchor) / scale)
        qh = np.ceil((np.asarray(hi, np.float32) - anchor) / scale)
        qlo[k] = np.clip(ql, 0, 255).astype(np.uint8)
        qhi[k] = np.clip(qh, 0, 255).astype(np.uint8)
    # comp-major: qlox·8, qloy·8, qloz·8, qhix·8, qhiy·8, qhiz·8
    out = []
    for arr in (qlo, qhi):
        for c in range(3):
            out.append(_pack_u8x8(arr[:, c]))
    row[OFF_QBOX : OFF_QBOX + 12] = np.concatenate(out)


def _leaf_row(row: np.ndarray, nmin, recs: np.ndarray, idx: np.ndarray):
    """recs: (cnt, 9) [e2,e1,v0] float32; v0 stored anchor-relative f16."""
    cnt = recs.shape[0]
    anchor = np.asarray(nmin, np.float32)
    row[0:3] = anchor
    row[OFF_META] = _f32(cnt)
    comps = np.zeros((9, 8), np.float32)
    comps[:, :cnt] = recs.T
    comps[6:9, :cnt] -= anchor[:, None]          # v0 relative to anchor
    packed = [_pack_f16x8(comps[c]) for c in range(9)]
    row[OFF_TRIS : OFF_TRIS + 36] = np.concatenate(packed)
    ints = np.full(8, -1, np.int32)
    ints[:cnt] = idx
    row[OFF_IDX : OFF_IDX + 8] = ints.view(np.float32)


@dataclasses.dataclass
class Wide8:
    nodes: np.ndarray      # (N, 48) float32
    depth: int             # max stack depth observed (pushes per path)
    # Triangle permutation: leaf rows index attributes by BVH-order
    # position, so the host must permute the attribute tables by `order`
    # (spatially adjacent leaves then read adjacent attr rows).
    order: np.ndarray | None = None


def build_wide8(bvh: BVH2, tri_records: np.ndarray,
                attr_index: np.ndarray) -> Wide8:
    """Emit the quantized 8-wide table from a BVH2 (single mesh/scene)."""
    starts, counts = _subtree_ranges(bvh)
    rows: list[np.ndarray] = []
    max_depth = 0

    def emit_leaf(node: int) -> int:
        my = len(rows)
        row = np.zeros(ROW, np.float32)
        rows.append(row)
        lo, cnt = int(starts[node]), int(counts[node])
        sel = bvh.order[lo : lo + cnt]
        _leaf_row(row, bvh.nmin[node], tri_records[sel],
                  attr_index[lo : lo + cnt])
        return my

    def emit(node: int, depth: int) -> int:
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        if counts[node] <= MAX_LEAF:
            return emit_leaf(node)
        my = len(rows)
        row = np.zeros(ROW, np.float32)
        rows.append(row)
        kids = _collapse8(bvh, node, counts)
        slots = _assign_slots(bvh, node, kids)
        boxes = [
            None if c is None else (bvh.nmin[c], bvh.nmax[c]) for c in slots
        ]
        _quantize_node(row, bvh.nmin[node], bvh.nmax[node], boxes)
        ptrs = np.full(8, -1, np.int32)
        for k, c in enumerate(slots):
            if c is not None:
                ptrs[k] = emit(c, depth + 1)
        row[OFF_PTRS : OFF_PTRS + 8] = ptrs.view(np.float32)
        return my

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        emit(0, 1)
    finally:
        sys.setrecursionlimit(old)
    if not (max_depth < MAX_DEPTH):
        raise ValueError(f"tree depth {max_depth} >= {MAX_DEPTH}")
    return Wide8(nodes=np.stack(rows), depth=max_depth,
                 order=np.array(bvh.order, np.int32))


def build_scene_wide8(positions: np.ndarray, tri_records: np.ndarray,
                      leaf_size: int = 4) -> Wide8:
    native = native_wide8_or_none(positions, tri_records, leaf_size)
    if native is not None:
        rows, depth, order = native
        if not (depth < MAX_DEPTH):
            raise ValueError(f"tree depth {depth} >= {MAX_DEPTH}")
        return Wide8(nodes=rows, depth=depth, order=order)
    bvh = build_bvh2(positions, leaf_size=leaf_size)
    # Leaf rows store BVH-order positions; callers permute attrs by order.
    attr_index = np.arange(positions.shape[0], dtype=np.int32)
    return build_wide8(bvh, tri_records, attr_index)


# ---------------------------------------------------------------------- TLAS
@dataclasses.dataclass
class TlasLayout:
    """Fixed device layout of the unified two-level table: the TLAS owns
    rows [0, tlas_cap); BLAS tables sit at immutable offsets after it, so a
    transform-only update re-emits ONLY the TLAS rows (the reference's
    per-frame path uploads only the small TLAS, ``BVHScene.cs:823-838``)."""

    tlas_cap: int
    blas_root: dict          # mesh_id -> absolute root row
    blas_depth: int
    tlas_depth0: int = 0     # TLAS depth at build time (stack was sized +4)


def emit_tlas_rows(instances, blas_bounds, blas_root: dict, tlas_cap: int):
    """Emit the 8-wide TLAS rows (instance rows point into fixed BLAS
    roots), zero-padded to ``tlas_cap``. Returns (rows, depth, l2w, w2l)."""
    ni = len(instances)
    inst_aabb_min = np.zeros((ni, 3), np.float32)
    inst_aabb_max = np.zeros((ni, 3), np.float32)
    l2w = np.zeros((ni, 12), np.float32)
    w2l = np.zeros((ni, 12), np.float32)
    for i, (mesh_id, transform, _mat) in enumerate(instances):
        t = np.asarray(transform, np.float32).reshape(4, 4)
        lo, hi = blas_bounds[mesh_id]
        corners = np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])], np.float32)
        wc = corners @ t[:3, :3].T + t[:3, 3]
        inst_aabb_min[i] = wc.min(0)
        inst_aabb_max[i] = wc.max(0)
        l2w[i] = t[:3, :4].reshape(-1)
        w2l[i] = np.linalg.inv(t)[:3, :4].reshape(-1)

    # BVH2 over instance AABBs (leaf_size=1 -> one instance row per leaf).
    fake_tris = np.stack(
        [inst_aabb_min, inst_aabb_max, (inst_aabb_min + inst_aabb_max) * 0.5],
        axis=1,
    )
    tb = build_bvh2(fake_tris, leaf_size=1)
    starts, counts = _subtree_ranges(tb)

    rows: list[np.ndarray] = []
    max_depth = [0]

    def emit_inst(inst_i: int) -> int:
        my = len(rows)
        row = np.zeros(ROW, np.float32)
        rows.append(row)
        mesh_id = instances[inst_i][0]
        row[OFF_META] = _f32(-(inst_i + 1))
        row[OFF_W2L : OFF_W2L + 12] = w2l[inst_i]
        row[OFF_BLAS] = _f32(blas_root[mesh_id])
        return my

    def emit(node: int, depth: int) -> int:
        max_depth[0] = max(max_depth[0], depth)
        if counts[node] == 1:
            return emit_inst(int(tb.order[starts[node]]))
        my = len(rows)
        row = np.zeros(ROW, np.float32)
        rows.append(row)
        kids = _collapse8(tb, node, counts)
        # _collapse8 keeps subtrees with <= MAX_LEAF prims whole; for the
        # TLAS every instance must get its own row, so expand fully.
        changed = True
        while changed:
            changed = False
            for i, c in enumerate(list(kids)):
                if tb.left[c] >= 0 and len(kids) < 8:
                    kids.pop(i)
                    kids.extend([tb.left[c], tb.left[c] + 1])
                    changed = True
                    break
        slots = _assign_slots(tb, node, kids)
        boxes = [None if c is None else (tb.nmin[c], tb.nmax[c]) for c in slots]
        _quantize_node(row, tb.nmin[node], tb.nmax[node], boxes)
        ptrs = np.full(8, -1, np.int32)
        for k, c in enumerate(slots):
            if c is not None:
                ptrs[k] = emit(c, depth + 1)
        row[OFF_PTRS : OFF_PTRS + 8] = ptrs.view(np.float32)
        return my

    emit(0, 1)
    if not (len(rows) <= tlas_cap):
        raise ValueError(f"TLAS rows {len(rows)} > cap {tlas_cap}")
    out = np.zeros((tlas_cap, ROW), np.float32)
    out[: len(rows)] = np.stack(rows)
    return out, max_depth[0], l2w, w2l


def tlas_capacity(n_instances: int) -> int:
    """Row capacity covering any tree shape over n instances (1 instance
    row each + at most one inner row per instance + slack)."""
    return 2 * max(n_instances, 1) + 8


def build_tlas_wide8(blas: list[Wide8], blas_bounds, instances,
                     attr_bases: list[int] | None = None):
    """Two-level table: 8-wide TLAS over instance AABBs (zero-padded to a
    fixed capacity), instance rows jumping into rebased BLAS tables at
    immutable offsets after it (``BVHScene.cs:671-757`` role; one unified
    device table). Returns ``(Wide8, l2w, w2l, TlasLayout)``."""
    cap = tlas_capacity(len(instances))
    ref_meshes = []
    for mesh_id, _t, _m in instances:
        if mesh_id not in ref_meshes:
            ref_meshes.append(mesh_id)
    blas_root: dict[int, int] = {}
    offset = cap
    blas_depth = 0
    tables = []
    for mesh_id in ref_meshes:
        t = np.array(blas[mesh_id].nodes)
        meta = t[:, OFF_META].view(np.int32)
        inner = meta == 0
        ptrs = t[:, OFF_PTRS : OFF_PTRS + 8].view(np.int32)
        ptrs[inner] = np.where(ptrs[inner] >= 0, ptrs[inner] + offset, -1)
        t[:, OFF_PTRS : OFF_PTRS + 8] = ptrs.view(np.float32)
        if attr_bases is not None:
            idx = t[:, OFF_IDX : OFF_IDX + 8].view(np.int32)
            leaf = meta > 0
            idx[leaf] = np.where(
                idx[leaf] >= 0, idx[leaf] + attr_bases[mesh_id], -1
            )
            t[:, OFF_IDX : OFF_IDX + 8] = idx.view(np.float32)
        blas_root[mesh_id] = offset
        blas_depth = max(blas_depth, blas[mesh_id].depth)
        tables.append(t)
        offset += t.shape[0]

    tlas_rows, tdepth, l2w, w2l = emit_tlas_rows(
        instances, blas_bounds, blas_root, cap)
    nodes = np.concatenate([tlas_rows] + tables, axis=0)
    depth = tdepth + blas_depth + 1
    if not (depth < MAX_DEPTH):
        raise ValueError(f"TLAS+BLAS depth {depth} >= {MAX_DEPTH}")
    layout = TlasLayout(tlas_cap=cap, blas_root=blas_root,
                        blas_depth=blas_depth, tlas_depth0=tdepth)
    return Wide8(nodes=nodes, depth=depth), l2w, w2l, layout


# ----------------------------------------------------------------- validation
def decode_leaf_tris(row: np.ndarray):
    """Host-side decode of one leaf row -> (cnt, recs (cnt,9), idx (cnt,))."""
    cnt = int(row[OFF_META : OFF_META + 1].view(np.int32)[0])
    words = row[OFF_TRIS : OFF_TRIS + 36].view(np.uint32).reshape(9, 4)
    halves = np.stack(
        [(words & 0xFFFF).astype(np.uint16), (words >> 16).astype(np.uint16)],
        axis=-1,
    ).reshape(9, 8)
    comps = halves.view(np.float16).astype(np.float32)
    comps[6:9] += row[0:3][:, None]
    idx = row[OFF_IDX : OFF_IDX + 8].view(np.int32)
    return cnt, comps[:, :cnt].T, idx[:cnt]


def validate_wide8(w: Wide8, tri_count: int):
    """Raise ``ValueError`` unless every triangle is in exactly one leaf,
    every leaf lies in its quantized box and the depth is below the bound."""
    nodes = w.nodes
    meta = nodes[:, OFF_META].view(np.int32)
    seen = np.zeros(tri_count, np.int32)
    stack = [(0, 0)]
    max_sp = 0
    while stack:
        max_sp = max(max_sp, len(stack))
        r, _ = stack.pop()
        m = meta[r]
        if m > 0:
            cnt, _recs, idx = decode_leaf_tris(nodes[r])
            seen[idx] += 1
        elif m < 0:
            blas = int(nodes[r, OFF_BLAS].view(np.int32))
            stack.append((blas, 0))
        else:
            anchor = nodes[r, 0:3]
            e = int(nodes[r, OFF_EXPS : OFF_EXPS + 1].view(np.int32)[0])
            ex = np.array([e & 255, (e >> 8) & 255, (e >> 16) & 255]) - 127
            scale = np.ldexp(np.ones(3, np.float32), ex)
            words = nodes[r, OFF_QBOX : OFF_QBOX + 12].view(np.uint32)
            ptrs = nodes[r, OFF_PTRS : OFF_PTRS + 8].view(np.int32)
            for k in range(8):
                if ptrs[k] < 0:
                    continue
                # comp-major packing: comp c child k = word 2c + k//4, byte k%4
                lo = np.zeros(3, np.float32)
                hi = np.zeros(3, np.float32)
                for c in range(3):
                    wlo = words[2 * c + k // 4]
                    whi = words[6 + 2 * c + k // 4]
                    lo[c] = anchor[c] + ((wlo >> (8 * (k % 4))) & 255) * scale[c]
                    hi[c] = anchor[c] + ((whi >> (8 * (k % 4))) & 255) * scale[c]
                child = ptrs[k]
                cm = meta[child]
                if cm > 0:
                    _cnt, recs, _idx = decode_leaf_tris(nodes[child])
                    v0 = recs[:, 6:9]
                    v1 = v0 + recs[:, 3:6]
                    v2 = v0 + recs[:, 0:3]
                    pts = np.concatenate([v0, v1, v2])
                    if not ((pts >= lo - 1e-2 - 1e-3 * np.abs(pts)).all()):
                        raise ValueError("leaf not contained")
                    if not ((pts <= hi + 1e-2 + 1e-3 * np.abs(pts)).all()):
                        raise ValueError("leaf not contained")
                stack.append((child, 0))
    if not ((seen == 1).all()):
        raise ValueError("leaf coverage broken")
    if w.depth >= MAX_DEPTH:
        raise ValueError(f"tree depth {w.depth} >= {MAX_DEPTH}")
