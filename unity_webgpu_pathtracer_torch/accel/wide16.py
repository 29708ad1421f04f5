"""The 16-wide quantized BVH table: layout, root slot table and the
content-keyed build cache (``accel/wide16.py`` of the reference).

Row layout, ``(N, 96)`` float32 with integers bitcast; ``f[3]`` (meta) is
0 for an inner row and the triangle count (1..16) for a leaf row:

======= ======================================= ==========================
floats  inner                                    leaf
======= ======================================= ==========================
0:3     anchor (node AABB min)                   anchor (leaf AABB min)
3       meta = 0                                 meta = count
4       exponents ``ex | ey<<8 | ez<<16``        f16 triangle SoA (72
8:32    u8 child boxes ``[qlo x,y,z | qhi        floats, 9 comps x 16
        x,y,z]``, 16 slots each, SPLIT order     slots, SPLIT order, 4:76)
32:48   child row pointers (-1 empty)            attr index x16 (76:92)
======= ======================================= ==========================

SPLIT orders: byte j of child-box word w holds slot ``4j + w``
(``PERM_Q``); the low half of leaf word w holds slot w and the high half
slot ``w + 8`` (``PERM_H_POS``).

Tables are built by the native SBVH builder and cached on disk under
``UWPT_BVH_CACHE_DIR`` (default: the repository's ``.bvh_cache``), keyed
exactly as the reference keys them, so a table committed there for the
benchmark scene is loaded instead of rebuilt.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile

import numpy as np

from unity_webgpu_pathtracer_torch.accel import native

ROW = 96
WIDTH = 16
MAX_DEPTH = 20   # the builder's stack-depth bound

OFF_META = 3
OFF_EXPS = 4
OFF_QBOX = 8     # 24 floats: 96 bytes comp-major
OFF_PTRS = 32    # 16 ints
OFF_TRIS = 4     # 72 floats: 9 comps x 16 f16
OFF_IDX = 76     # 16 ints

# Slot -> leaf halfword position, and the child-box byte involution.
PERM_H_POS = np.array([2 * s if s < 8 else 2 * (s - 8) + 1
                       for s in range(16)])
PERM_Q = np.array([4 * (s % 4) + s // 4 for s in range(16)])

TOP_COLS = 119  # anchor 3 | scale 3 | qlo 48 | qhi 48 | ptrs 16 | meta 1

# Build options the main path uses: SBVH spatial splits, greedy collapse,
# 96-float rows, leaf size 4 (the reference's defaults).
QUALITY = 1
LEAF_SIZE = 4
# Bump with the reference's _BVH_CACHE_VERSION (shared cache files).
_BVH_CACHE_VERSION = 1

# Disk-cache hits/misses of build_scene_wide16 in this process.
CACHE_STATS = {"hit": 0, "miss": 0}


@dataclasses.dataclass
class Wide16:
    nodes: np.ndarray      # (N, 96) float32
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


def bvh_cache_path(positions: np.ndarray, tri_records: np.ndarray) -> str:
    """Content-keyed cache path, computed exactly as the reference's
    ``_bvh_cache_path`` with the native builder present: geometry bytes,
    build options, the builder's ``UWPT_COLLAPSE_CNODE`` knob and the sha1
    of ``native/bvh_builder.cpp``."""
    c_node = os.environ.get("UWPT_COLLAPSE_CNODE", "")
    cache_dir = os.environ.get("UWPT_BVH_CACHE_DIR") or os.path.join(
        os.path.dirname(native.NATIVE_DIR), ".bvh_cache")
    with open(native.SRC_PATH, "rb") as f:
        lib_id = "src:" + hashlib.sha1(f.read()).hexdigest()[:16]
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(positions, np.float32).tobytes())
    h.update(np.ascontiguousarray(tri_records, np.float32).tobytes())
    h.update(f"v{_BVH_CACHE_VERSION}|{LEAF_SIZE}|{QUALITY}|0|"
             f"cnode={c_node}|{lib_id}".encode())
    return os.path.join(cache_dir, f"wide16-{h.hexdigest()}.npz")


def build_scene_wide16(positions: np.ndarray, tri_records: np.ndarray) -> Wide16:
    """Load the table from the disk cache, or build it natively and store
    it there."""
    path = bvh_cache_path(positions, tri_records)
    if os.path.exists(path):
        with np.load(path) as z:
            w = Wide16(nodes=z["nodes"], depth=int(z["depth"]), order=z["order"])
        CACHE_STATS["hit"] += 1
        return w
    CACHE_STATS["miss"] += 1
    rows, depth, order = native.native_wide16(positions, tri_records,
                                              LEAF_SIZE, QUALITY)
    if depth >= MAX_DEPTH:
        raise ValueError(f"tree depth {depth} >= {MAX_DEPTH}")
    w = Wide16(nodes=rows, depth=depth, order=order)
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
