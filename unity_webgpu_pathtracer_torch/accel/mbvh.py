"""The 8-wide MBVH that the CWBVH exporter quantizes (``accel/mbvh.py``
of the reference): ``collapse_to_mbvh8`` and its child encoding.  The
reference's ``mbvh`` traversal backend is frozen and not ported; this
module serves ``accel/cwbvh.py`` only.

Child slot encoding (``child[n, k]``): ``0`` an empty slot; ``c > 0`` the
inner child node ``c - 1``; ``c < 0`` a leaf of triangles ``order[off :
off + cnt]`` with ``off, cnt = divmod(-c, LEAF_CNT_BITS)``.  Bounds rows
(``bounds[n]``, 48 floats) are ``[lox 8 | loy 8 | loz 8 | hix 8 | hiy 8 |
hiz 8]``; empty slots hold inverted boxes.
"""

from __future__ import annotations

import numpy as np

from unity_webgpu_pathtracer_torch.accel.bvh2 import BVH2

WIDTH = 8
LEAF_CNT_BITS = 16


def encode_inner(node_index: int) -> int:
    return node_index + 1


def encode_leaf(offset: int, count: int) -> int:
    assert 0 < count < LEAF_CNT_BITS
    return -(offset * LEAF_CNT_BITS + count)


def decode_leaf(code: int):
    v = -code
    return v // LEAF_CNT_BITS, v % LEAF_CNT_BITS


def collapse_to_mbvh8(bvh: BVH2):
    """Collapse to 8-wide by repeatedly expanding the largest-area inner child.

    Returns ``(bounds (N, 48) f32, child (N, 8) i32, order (F,) i32)``.
    """
    area = _surface_area(bvh.nmin, bvh.nmax)

    bounds_rows: list[np.ndarray] = []
    child_rows: list[np.ndarray] = []

    def emit(children2: list[int]) -> int:
        """Create an MBVH node from a list of BVH2 node ids; returns index."""
        my_index = len(child_rows)
        bounds_rows.append(None)  # placeholder, filled below
        child_rows.append(None)

        kids = list(children2)
        # Grow to up to WIDTH children, expanding the largest-SA inner child.
        while len(kids) < WIDTH:
            inner = [k for k in kids if bvh.count[k] == 0]
            if not inner:
                break
            grow = max(inner, key=lambda k: area[k])
            kids.remove(grow)
            li = bvh.left[grow]
            kids.extend([li, li + 1])

        codes = np.zeros(WIDTH, np.int64)
        lo = np.full((WIDTH, 3), np.inf, np.float32)
        hi = np.full((WIDTH, 3), -np.inf, np.float32)
        for slot, k in enumerate(kids):
            lo[slot] = bvh.nmin[k]
            hi[slot] = bvh.nmax[k]
            if bvh.count[k] > 0:
                codes[slot] = encode_leaf(int(bvh.start[k]), int(bvh.count[k]))
            else:
                li = bvh.left[k]
                codes[slot] = encode_inner(emit([li, li + 1]))
        row = np.concatenate([lo.T.reshape(-1), hi.T.reshape(-1)])  # (48,)
        bounds_rows[my_index] = row.astype(np.float32)
        child_rows[my_index] = codes
        return my_index

    if bvh.count[0] > 0:
        # Degenerate single-leaf scene: one node whose slot 0 is the leaf.
        codes = np.zeros(WIDTH, np.int64)
        codes[0] = encode_leaf(int(bvh.start[0]), int(bvh.count[0]))
        lo = np.full((WIDTH, 3), np.inf, np.float32)
        hi = np.full((WIDTH, 3), -np.inf, np.float32)
        lo[0], hi[0] = bvh.nmin[0], bvh.nmax[0]
        bounds_rows.append(np.concatenate([lo.T.reshape(-1), hi.T.reshape(-1)]).astype(np.float32))
        child_rows.append(codes)
    else:
        li = bvh.left[0]
        emit([li, li + 1])

    bounds = np.stack(bounds_rows).astype(np.float32)
    child = np.stack(child_rows)
    if np.abs(child).max() >= 2**31:
        raise ValueError("scene too large for 32-bit child codes")
    return bounds, child.astype(np.int32), bvh.order.copy()


def _surface_area(nmin, nmax):
    d = np.maximum(nmax - nmin, 0.0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
