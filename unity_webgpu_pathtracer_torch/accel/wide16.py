"""The 16-wide quantized BVH table: layout, root slot table and the
content-keyed build cache (``accel/wide16.py`` of the reference).

Row layout, ``(N, 96)`` float32 with integers bitcast; ``f[3]`` (meta) is
0 for an inner row, the triangle count (1..16) for a leaf row and
``-(id + 1)`` for a TLAS instance row:

======= =========================== ====================== ==================
floats  inner                        leaf                   instance
======= =========================== ====================== ==================
0:3     anchor (node AABB min)       anchor (leaf AABB min) unused
3       meta = 0                     meta = count           meta = -(id+1)
4       exponents                    f16 triangle SoA (72   world->local 3x4
        ``ex | ey<<8 | ez<<16``      floats, 9 comps x 16   (4:16)
8:32    u8 child boxes ``[qlo x,y,z  slots, SPLIT order,    BLAS root row (16)
        | qhi x,y,z]``, 16 slots     4:76)
        each, SPLIT order
32:48   child row pointers (-1)      attr index x16 (76:92)
======= =========================== ====================== ==================

SPLIT orders: byte j of child-box word w holds slot ``4j + w``
(``PERM_Q``); the low half of leaf word w holds slot w and the high half
slot ``w + 8`` (``PERM_H_POS``).

leaf8 tables (``build_scene_wide16(..., leaf8=True)``) have ``(N, 48)``
rows: inner and instance rows are the words below 48 of the layout above
(they use no others), and a leaf holds up to 8 triangles, 9 comps x 8 f16
at 4:40 (word w = slot w low, slot ``w + 4`` high: ``PERM_H8_POS``) and
8 attribute indices at 40:48.  Every consumer reads the width from
``nodes.shape[1]``.

Tables are built by the native SBVH builder and cached on disk under
``UWPT_BVH_CACHE_DIR`` (default: the repository's ``.bvh_cache``), keyed
exactly as the reference keys them, so a table committed there for the
benchmark scene is loaded instead of rebuilt.  When the native library
cannot be built or loaded, ``build_wide16`` emits the table in numpy from
a binned-SAH BVH2 (no spatial splits), with a warning, and the cache
stores it under the same key, as the reference does.

Two-level (instanced) tables put a 16-wide TLAS over the instance boxes in
rows ``[0, tlas_cap)`` and the per-mesh BLAS tables at fixed offsets after
it, so moving an instance re-emits only the TLAS rows
(``emit_tlas_rows16``).  The TLAS is emitted in numpy exactly as the
reference emits it (``accel/bvh2.py`` + ``_collapse16`` +
``_quantize_node``), byte for byte.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import tempfile
import warnings

import numpy as np

from unity_webgpu_pathtracer_torch.accel import native
from unity_webgpu_pathtracer_torch.accel.bvh2 import BVH2, build_bvh2

ROW = 96
WIDTH = 16
MAX_LEAF = 16
MAX_DEPTH = 20   # the builder's stack-depth bound

OFF_META = 3
OFF_EXPS = 4
OFF_QBOX = 8     # 24 floats: 96 bytes comp-major
OFF_PTRS = 32    # 16 ints
OFF_TRIS = 4     # 72 floats: 9 comps x 16 f16
OFF_IDX = 76     # 16 ints
OFF_W2L = 4      # instance rows: 12 floats
OFF_BLAS = 16    # instance rows: BLAS root row (int)
# leaf8 rows: 48 floats, 8 triangles per leaf, attr indices at 40:48.
ROW8 = 48
LEAF8 = 8
OFF_IDX8 = 40

# Slot -> leaf halfword position (16-slot and leaf8 rows), and the
# child-box byte involution.
PERM_H_POS = np.array([2 * s if s < 8 else 2 * (s - 8) + 1
                       for s in range(16)])
PERM_H8_POS = np.array([2 * s if s < 4 else 2 * (s - 4) + 1
                        for s in range(8)])
PERM_Q = np.array([4 * (s % 4) + s // 4 for s in range(16)])

TOP_COLS = 119  # anchor 3 | scale 3 | qlo 48 | qhi 48 | ptrs 16 | meta 1

# Build options the main path uses: SBVH spatial splits, greedy collapse,
# leaf size 4 (the reference's defaults).
QUALITY = 1
LEAF_SIZE = 4
# Bump with the reference's _BVH_CACHE_VERSION (shared cache files).
_BVH_CACHE_VERSION = 1

# Disk-cache hits/misses of build_scene_wide16 in this process, and the
# misses that the numpy builder served (the native library missing).
CACHE_STATS = {"hit": 0, "miss": 0, "numpy": 0}


@dataclasses.dataclass
class Wide16:
    nodes: np.ndarray      # (N, 96) or leaf8 (N, 48) float32
    depth: int             # max stack depth (pushes per path)
    order: np.ndarray      # BVH reference order -> original triangle id


def _decode_top_row(nodes: np.ndarray, p: int, out: np.ndarray) -> None:
    """Decode inner row ``p`` into a slot-ordered (TOP_COLS,) row of
    plain f32 fields; ``out[118]`` (meta) is left to the caller."""
    row = nodes[p]
    out[0:3] = row[0:3]
    eword = int(row[OFF_EXPS : OFF_EXPS + 1].view(np.int32)[0])
    for c in range(3):
        out[3 + c] = np.ldexp(np.float32(1.0), ((eword >> (8 * c)) & 0xFF) - 127)
    qbytes = (row[OFF_QBOX : OFF_QBOX + 24].view(np.uint8)
              .reshape(6, 16)[:, PERM_Q].reshape(96).astype(np.float32))
    out[6:54] = qbytes[:48]
    out[54:102] = qbytes[48:]
    out[102:118] = row[OFF_PTRS : OFF_PTRS + 16].view(np.int32)


def derive_top16(nodes: np.ndarray) -> np.ndarray | None:
    """The root's 16 child rows decoded into a slot-indexed (16, 119)
    table for the traversal prestep's second level; None when the root is
    not an inner row.  Absent or non-inner slots get meta = 1, so the
    prestep never descends them."""
    if nodes.shape[0] < 2 or int(nodes[0, OFF_META : OFF_META + 1].view(np.int32)[0]) != 0:
        return None
    if nodes.shape[0] >= (1 << 24):   # ptrs must stay exact as f32
        return None
    root_ptrs = nodes[0, OFF_PTRS : OFF_PTRS + 16].view(np.int32)
    top = np.zeros((WIDTH, TOP_COLS), np.float32)
    top[:, 118] = 1.0
    for k in range(WIDTH):
        p = int(root_ptrs[k])
        if p < 0:
            continue
        meta = int(nodes[p, OFF_META : OFF_META + 1].view(np.int32)[0])
        top[k, 118] = float(meta)
        if meta != 0:
            continue
        _decode_top_row(nodes, p, top[k])
    return top


def bvh_cache_path(positions: np.ndarray, tri_records: np.ndarray,
                   leaf8: bool = False, native_built: bool = True) -> str:
    """Content-keyed cache path, computed exactly as the reference's
    ``_bvh_cache_path``: geometry bytes, build options (leaf8 among them),
    the builder's ``UWPT_COLLAPSE_CNODE`` knob and the builder's identity,
    the sha1 of ``native/bvh_builder.cpp`` or, for a table the numpy
    builder made (``native_built`` False), ``numpy-fallback``.  So a numpy
    table never answers for the native builder, nor the other way round."""
    c_node = os.environ.get("UWPT_COLLAPSE_CNODE", "")
    cache_dir = os.environ.get("UWPT_BVH_CACHE_DIR") or os.path.join(
        os.path.dirname(native.NATIVE_DIR), ".bvh_cache")
    if native_built:
        with open(native.SRC_PATH, "rb") as f:
            lib_id = "src:" + hashlib.sha1(f.read()).hexdigest()[:16]
    else:
        lib_id = "numpy-fallback"
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(positions, np.float32).tobytes())
    h.update(np.ascontiguousarray(tri_records, np.float32).tobytes())
    h.update(f"v{_BVH_CACHE_VERSION}|{LEAF_SIZE}|{QUALITY}|{int(leaf8)}|"
             f"cnode={c_node}|{lib_id}".encode())
    return os.path.join(cache_dir, f"wide16-{h.hexdigest()}.npz")


def resolve_leaf8(leaf8: bool | None) -> bool:
    """``leaf8``, or for None the reference's switch ``UWPT_WIDE16_LEAF8``
    (``1`` = leaf8 rows)."""
    return os.environ.get("UWPT_WIDE16_LEAF8", "0") == "1" if leaf8 is None else bool(leaf8)


def build_scene_wide16(positions: np.ndarray, tri_records: np.ndarray,
                       leaf8: bool | None = None) -> Wide16:
    """Load the table from the disk cache, or build it and store it there:
    natively, or in numpy with a warning when the native library cannot be
    built or loaded (each builder under its own key, ``bvh_cache_path``).
    ``leaf8`` selects 48-float rows with 8-triangle leaves
    (``resolve_leaf8``)."""
    leaf8 = resolve_leaf8(leaf8)
    native_ok = native.available()
    path = bvh_cache_path(positions, tri_records, leaf8, native_ok)
    if os.path.exists(path):
        with np.load(path) as z:
            w = Wide16(nodes=z["nodes"], depth=int(z["depth"]), order=z["order"])
        CACHE_STATS["hit"] += 1
        return w
    CACHE_STATS["miss"] += 1
    if native_ok:
        rows, depth, order = native.native_wide16(positions, tri_records, LEAF_SIZE, QUALITY,
                                                  leaf8)
        if depth >= MAX_DEPTH:
            raise ValueError(f"tree depth {depth} >= {MAX_DEPTH}")
        w = Wide16(nodes=rows, depth=depth, order=order)
    else:
        warnings.warn("the native BVH builder is unavailable (native/libtpubvh.so could not "
                      "be built or loaded); building the wide16 table in numpy (binned SAH, "
                      "no spatial splits)", stacklevel=2)
        CACHE_STATS["numpy"] += 1
        bvh = build_bvh2(positions, leaf_size=LEAF_SIZE)
        w = build_wide16(bvh, tri_records, np.arange(positions.shape[0], dtype=np.int32),
                         leaf8=leaf8)
    _cache_store(path, w)
    return w


def _cache_store(path: str, w: Wide16) -> None:
    """Write atomically (temp file + rename); a failed write only costs a
    rebuild next time."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, nodes=w.nodes, depth=np.int32(w.depth), order=w.order)
        os.replace(tmp, path)
    except OSError:
        pass


# ---------------------------------------------------------------------- TLAS

def _f32(i) -> np.ndarray:
    return np.asarray(i, np.int32).view(np.float32)


def _subtree_ranges(bvh: BVH2) -> tuple[np.ndarray, np.ndarray]:
    """(start, count) triangle range per node (subtrees are contiguous)."""
    start = np.array(bvh.start, np.int64)
    count = np.array(bvh.count, np.int64)
    # Children always follow their parent in the arrays; sweep backwards.
    for ni in range(bvh.node_count - 1, -1, -1):
        li = bvh.left[ni]
        if li >= 0:
            start[ni] = min(start[li], start[li + 1])
            count[ni] = count[li] + count[li + 1]
    return start.astype(np.int32), count.astype(np.int32)


def _area(bvh: BVH2, c: int) -> float:
    d = np.maximum(bvh.nmax[c] - bvh.nmin[c], 0.0)
    return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def _collapse16(bvh: BVH2, node: int, counts: np.ndarray, max_leaf: int = 16) -> list:
    """Greedy 2-wide -> up-to-16-wide collapse: repeatedly expand the child
    with the largest surface area; subtrees with <= max_leaf primitives
    stay whole."""
    l = bvh.left[node]
    kids = [l, l + 1]
    while len(kids) < WIDTH:
        expandable = [(_area(bvh, c), i) for i, c in enumerate(kids)
                      if bvh.left[c] >= 0 and counts[c] > max_leaf]
        if not expandable:
            break
        _, i = max(expandable)
        c = kids.pop(i)
        cl = bvh.left[c]
        kids.extend([cl, cl + 1])
    return kids


def _pack_u8_t(vals16: np.ndarray) -> np.ndarray:
    """(16,) uint8 slots -> (4,) float32 words in SPLIT order: byte j of
    word w = slot 4j + w."""
    s = np.asarray(vals16, np.uint8).astype(np.uint32)
    words = (s[0:4] | (s[4:8] << 8) | (s[8:12] << 16) | (s[12:16] << 24))
    return words.view(np.int32).view(np.float32)


def _quantize_node(row: np.ndarray, nmin, nmax, boxes: list) -> None:
    """Anchor, power-of-two exponents and conservative 8-bit child boxes."""
    anchor = np.asarray(nmin, np.float32)
    extent = np.maximum(np.asarray(nmax, np.float32) - anchor, 0.0)
    e = np.ceil(np.log2(np.maximum(extent / 255.0, 1e-30))).astype(np.int32)
    e = np.clip(e, -126, 127)
    scale = np.ldexp(np.ones(3, np.float32), e)
    short = 255.0 * scale < extent
    e = np.clip(e + short.astype(np.int32), -126, 127)
    scale = np.ldexp(np.ones(3, np.float32), e)
    row[0:3] = anchor
    row[OFF_EXPS] = _f32(int(e[0] + 127) | (int(e[1] + 127) << 8) | (int(e[2] + 127) << 16))
    qlo = np.full((WIDTH, 3), 255, np.uint8)
    qhi = np.zeros((WIDTH, 3), np.uint8)
    for k, b in enumerate(boxes):
        if b is None:
            continue
        lo, hi = b
        qlo[k] = np.clip(np.floor((np.asarray(lo, np.float32) - anchor) / scale), 0, 255)
        qhi[k] = np.clip(np.ceil((np.asarray(hi, np.float32) - anchor) / scale), 0, 255)
    # comp-major: qlo x, y, z then qhi x, y, z, SPLIT byte order in each.
    row[OFF_QBOX : OFF_QBOX + 24] = np.concatenate(
        [_pack_u8_t(arr[:, c]) for arr in (qlo, qhi) for c in range(3)])


def _canon_f16(h: np.ndarray) -> np.ndarray:
    """f16 bit patterns under the table contract: subnormals and -0 flush
    to +0, inf and nan clamp to +-65504 (the native builder's ``f2h``)."""
    hb = h.view(np.uint16)
    hb = np.where((hb & 0x7C00) == 0, np.uint16(0), hb)
    hb = np.where((hb & 0x7C00) == 0x7C00, (hb & np.uint16(0x8000)) | np.uint16(0x7BFF), hb)
    return hb


def _pack_f16_split(vals: np.ndarray) -> np.ndarray:
    """(2k,) floats -> (k,) f32 words in SPLIT order: word w = slot w (low
    half) | slot w + k (high half); k = 8 for 16-slot leaves, 4 for leaf8."""
    h = _canon_f16(np.asarray(vals, np.float16))
    k = h.shape[0] // 2
    words = h[0:k].astype(np.uint32) | (h[k:2 * k].astype(np.uint32) << 16)
    return words.view(np.int32).view(np.float32)


def _leaf_row(row: np.ndarray, nmin, recs: np.ndarray, idx: np.ndarray,
              slots: int = WIDTH) -> None:
    """A leaf of ``recs`` ((cnt, 9) [e2, e1, v0] f32; v0 stored relative
    to the anchor) with attribute indices ``idx``, in f16."""
    cnt = recs.shape[0]
    anchor = np.asarray(nmin, np.float32)
    row[0:3] = anchor
    row[OFF_META] = _f32(cnt)
    comps = np.zeros((9, slots), np.float32)
    comps[:, :cnt] = recs.T
    comps[6:9, :cnt] -= anchor[:, None]
    nw = 9 * slots // 2
    row[OFF_TRIS : OFF_TRIS + nw] = np.concatenate([_pack_f16_split(comps[c])
                                                    for c in range(9)])
    ints = np.full(slots, -1, np.int32)
    ints[:cnt] = idx
    off_idx = OFF_IDX if slots == WIDTH else OFF_IDX8
    row[off_idx : off_idx + slots] = ints.view(np.float32)


def build_wide16(bvh: BVH2, tri_records: np.ndarray, attr_index: np.ndarray,
                 leaf8: bool = False) -> Wide16:
    """The numpy emitter (the reference's ``build_wide16``): the quantized
    16-wide table of a BVH2, 96-float rows with 16-triangle leaves, or
    48-float rows with 8-triangle leaves for ``leaf8``.  Children take
    slots in decreasing surface area."""
    row_f = ROW8 if leaf8 else ROW
    max_leaf = LEAF8 if leaf8 else MAX_LEAF
    starts, counts = _subtree_ranges(bvh)
    rows: list[np.ndarray] = []
    max_depth = 0

    def emit(node: int, depth: int) -> int:
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        my = len(rows)
        row = np.zeros(row_f, np.float32)
        rows.append(row)
        if counts[node] <= max_leaf:
            lo, cnt = int(starts[node]), int(counts[node])
            _leaf_row(row, bvh.nmin[node], tri_records[bvh.order[lo : lo + cnt]],
                      attr_index[lo : lo + cnt], slots=max_leaf)
            return my
        kids = _collapse16(bvh, node, counts, max_leaf)
        slots = (sorted(kids, key=lambda c: _area(bvh, c), reverse=True)
                 + [None] * (WIDTH - len(kids)))
        _quantize_node(row, bvh.nmin[node], bvh.nmax[node],
                       [None if c is None else (bvh.nmin[c], bvh.nmax[c]) for c in slots])
        ptrs = np.full(WIDTH, -1, np.int32)
        for k, c in enumerate(slots):
            if c is not None:
                ptrs[k] = emit(c, depth + 1)
        row[OFF_PTRS : OFF_PTRS + 16] = ptrs.view(np.float32)
        return my

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        emit(0, 1)
    finally:
        sys.setrecursionlimit(old)
    if max_depth >= MAX_DEPTH:
        raise ValueError(f"tree depth {max_depth} >= {MAX_DEPTH}")
    return Wide16(nodes=np.stack(rows), depth=max_depth, order=np.array(bvh.order, np.int32))


@dataclasses.dataclass
class TlasLayout:
    """Fixed layout of a two-level table: the TLAS owns rows
    ``[0, tlas_cap)``, the BLAS tables sit at immutable offsets after it."""

    tlas_cap: int
    blas_root: dict          # mesh id -> absolute root row
    blas_depth: int
    tlas_depth0: int = 0     # TLAS depth at build time (the stack has +3 spare)


def tlas_capacity(n_instances: int) -> int:
    """Rows covering any TLAS over n instances: one instance row each, at
    most one inner row per instance, and slack."""
    return 2 * max(n_instances, 1) + 8


def emit_tlas_rows16(instances, blas_bounds, blas_root: dict, tlas_cap: int,
                     row_f: int = ROW):
    """The 16-wide TLAS rows over ``instances`` ((mesh id, 4x4 transform,
    material) triples), ``row_f`` floats wide (96, or 48 for leaf8 BLAS
    tables; TLAS rows use only words below 48), zero-padded to
    ``tlas_cap``.  Returns ``(rows, depth, l2w (I, 12), w2l (I, 12))``."""
    ni = len(instances)
    inst_aabb_min = np.zeros((ni, 3), np.float32)
    inst_aabb_max = np.zeros((ni, 3), np.float32)
    l2w = np.zeros((ni, 12), np.float32)
    w2l = np.zeros((ni, 12), np.float32)
    for i, (mesh_id, transform, _mat) in enumerate(instances):
        t = np.asarray(transform, np.float32).reshape(4, 4)
        lo, hi = blas_bounds[mesh_id]
        corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])], np.float32)
        wc = corners @ t[:3, :3].T + t[:3, 3]
        inst_aabb_min[i] = wc.min(0)
        inst_aabb_max[i] = wc.max(0)
        l2w[i] = t[:3, :4].reshape(-1)
        w2l[i] = np.linalg.inv(t)[:3, :4].reshape(-1)

    # BVH2 over the instance boxes, one instance per leaf.
    fake_tris = np.stack([inst_aabb_min, inst_aabb_max,
                          (inst_aabb_min + inst_aabb_max) * 0.5], axis=1)
    tb = build_bvh2(fake_tris, leaf_size=1)
    starts, counts = _subtree_ranges(tb)
    rows: list[np.ndarray] = []
    max_depth = 0

    def emit_inst(inst_i: int) -> int:
        row = np.zeros(row_f, np.float32)
        rows.append(row)
        row[OFF_META] = _f32(-(inst_i + 1))
        row[OFF_W2L : OFF_W2L + 12] = w2l[inst_i]
        row[OFF_BLAS] = _f32(blas_root[instances[inst_i][0]])
        return len(rows) - 1

    def emit(node: int, depth: int) -> int:
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        if counts[node] == 1:
            return emit_inst(int(tb.order[starts[node]]))
        my = len(rows)
        row = np.zeros(row_f, np.float32)
        rows.append(row)
        kids = _collapse16(tb, node, counts)
        # Every instance needs its own row: expand inner children while
        # slots remain.
        changed = True
        while changed:
            changed = False
            for i, c in enumerate(list(kids)):
                if tb.left[c] >= 0 and len(kids) < WIDTH:
                    kids.pop(i)
                    kids.extend([tb.left[c], tb.left[c] + 1])
                    changed = True
                    break
        slots = (sorted(kids, key=lambda c: _area(tb, c), reverse=True)
                 + [None] * (WIDTH - len(kids)))
        _quantize_node(row, tb.nmin[node], tb.nmax[node],
                       [None if c is None else (tb.nmin[c], tb.nmax[c]) for c in slots])
        ptrs = np.full(WIDTH, -1, np.int32)
        for k, c in enumerate(slots):
            if c is not None:
                ptrs[k] = emit(c, depth + 1)
        row[OFF_PTRS : OFF_PTRS + 16] = ptrs.view(np.float32)
        return my

    emit(0, 1)
    if len(rows) > tlas_cap:
        raise ValueError(f"TLAS rows {len(rows)} > capacity {tlas_cap}")
    out = np.zeros((tlas_cap, row_f), np.float32)
    out[: len(rows)] = np.stack(rows)
    return out, max_depth, l2w, w2l


def build_tlas_wide16(blas: list, blas_bounds, instances, attr_bases: list):
    """Two-level table: the TLAS rows, then each referenced mesh's BLAS
    (``blas[mesh_id]``, a ``Wide16``; all of one row width) rebased to its
    offset, its leaf attribute indices shifted by ``attr_bases[mesh_id]``.
    Returns ``(Wide16 (order None), l2w, w2l, TlasLayout)``."""
    cap = tlas_capacity(len(instances))
    ref_meshes = list(dict.fromkeys(mesh_id for mesh_id, _t, _m in instances))
    row_f = blas[ref_meshes[0]].nodes.shape[1]
    if any(blas[m].nodes.shape[1] != row_f for m in ref_meshes):
        raise ValueError("every BLAS of a two-level table must have the same row width")
    slots, off_idx = (WIDTH, OFF_IDX) if row_f == ROW else (LEAF8, OFF_IDX8)
    blas_root: dict[int, int] = {}
    offset = cap
    blas_depth = 0
    tables = []
    for mesh_id in ref_meshes:
        t = np.array(blas[mesh_id].nodes)
        meta = t[:, OFF_META].view(np.int32)
        inner = meta == 0
        ptrs = t[:, OFF_PTRS : OFF_PTRS + 16].view(np.int32)
        ptrs[inner] = np.where(ptrs[inner] >= 0, ptrs[inner] + offset, -1)
        idx = t[:, off_idx : off_idx + slots].view(np.int32)
        leaf = meta > 0
        idx[leaf] = np.where(idx[leaf] >= 0, idx[leaf] + attr_bases[mesh_id], -1)
        blas_root[mesh_id] = offset
        blas_depth = max(blas_depth, blas[mesh_id].depth)
        tables.append(t)
        offset += t.shape[0]

    tlas_rows, tdepth, l2w, w2l = emit_tlas_rows16(instances, blas_bounds, blas_root, cap,
                                                   row_f)
    depth = tdepth + blas_depth + 1
    if depth >= MAX_DEPTH:
        raise ValueError(f"TLAS+BLAS depth {depth} >= {MAX_DEPTH}")
    layout = TlasLayout(tlas_cap=cap, blas_root=blas_root, blas_depth=blas_depth,
                        tlas_depth0=tdepth)
    return (Wide16(nodes=np.concatenate([tlas_rows] + tables, axis=0), depth=depth,
                   order=None), l2w, w2l, layout)


# ---------------------------------------------------------------- validation

def decode_leaf_tris(row: np.ndarray):
    """One leaf row (96 or 48 floats) -> ``(count, records (count, 9),
    attribute indices (count,))``, the records in world space."""
    slots, off_idx = (WIDTH, OFF_IDX) if row.shape[0] == ROW else (LEAF8, OFF_IDX8)
    cnt = int(row[OFF_META : OFF_META + 1].view(np.int32)[0])
    words = row[OFF_TRIS : OFF_TRIS + 9 * slots // 2].view(np.uint32).reshape(9, slots // 2)
    # SPLIT order: word w = slot w (low half) | slot w + slots/2 (high half).
    halves = np.concatenate([(words & 0xFFFF).astype(np.uint16),
                             (words >> 16).astype(np.uint16)], axis=-1)
    comps = halves.view(np.float16).astype(np.float32)            # (9, slots)
    comps[6:9] += row[0:3][:, None]
    idx = row[off_idx : off_idx + slots].view(np.int32)
    return cnt, comps[:, :cnt].T, idx[:cnt]


def validate_wide16(w: Wide16, tri_count: int) -> None:
    """Raise ``ValueError`` unless every triangle is covered by a leaf
    (at least once for SBVH tables, whose ``order`` is longer than
    ``tri_count``; exactly once otherwise), every leaf's triangles lie in
    its quantized child box (not checked for SBVH tables, whose leaf boxes
    bound clipped fragments), and the depth is below ``MAX_DEPTH``."""
    spatial = w.order is not None and w.order.shape[0] != tri_count
    nodes = w.nodes
    meta = nodes[:, OFF_META].view(np.int32)
    seen = np.zeros(tri_count, np.int32)
    stack = [0]
    while stack:
        r = stack.pop()
        m = meta[r]
        if m > 0:
            _cnt, _recs, idx = decode_leaf_tris(nodes[r])
            np.add.at(seen, w.order[idx] if spatial else idx, 1)
        elif m < 0:
            stack.append(int(nodes[r, OFF_BLAS : OFF_BLAS + 1].view(np.int32)[0]))
        else:
            anchor = nodes[r, 0:3]
            e = int(nodes[r, OFF_EXPS : OFF_EXPS + 1].view(np.int32)[0])
            ex = np.array([e & 255, (e >> 8) & 255, (e >> 16) & 255]) - 127
            scale = np.ldexp(np.ones(3, np.float32), ex)
            qb = (nodes[r, OFF_QBOX : OFF_QBOX + 24].view(np.uint8)
                  .reshape(6, 16)[:, PERM_Q])                    # slot order
            ptrs = nodes[r, OFF_PTRS : OFF_PTRS + 16].view(np.int32)
            for k in range(WIDTH):
                child = int(ptrs[k])
                if child < 0:
                    continue
                if meta[child] > 0 and not spatial:
                    lo = anchor + qb[0:3, k] * scale
                    hi = anchor + qb[3:6, k] * scale
                    _cnt, recs, _idx = decode_leaf_tris(nodes[child])
                    v0 = recs[:, 6:9]
                    pts = np.concatenate([v0, v0 + recs[:, 3:6], v0 + recs[:, 0:3]])
                    tol = 1e-2 + 1e-3 * np.abs(pts)
                    if not ((pts >= lo - tol) & (pts <= hi + tol)).all():
                        raise ValueError(f"leaf row {child} is not inside its box in row {r}")
                stack.append(child)
    if not ((seen >= 1) if spatial else (seen == 1)).all():
        raise ValueError(f"leaf coverage broken: {int((seen == 0).sum())} triangles in no "
                         f"leaf, {int((seen > 1).sum())} in several")
    if w.depth >= MAX_DEPTH:
        raise ValueError(f"tree depth {w.depth} >= {MAX_DEPTH}")
