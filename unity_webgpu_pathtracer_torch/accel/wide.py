"""Fat-row 4-ary BVH (``accel/wide.py`` of the reference), the table of
the ``wide`` traversal (``ops/traverse_wide.py``).

Every arrival reads one 48-float row: an inner row holds its (up to) four
children's boxes and DFS indices, a leaf row its (up to) four triangle
records inline with their attribute indices, so a leaf needs no second
read.  The traversal is stackless: rows are in depth-first order, one
order per ray octant (near child first) or one in all, with skip pointers,
and a lane's state is one row pointer.

Row layout, ``(N, 48)`` float32 (ints bitcast):

======  ==========================  ==================================
floats  inner                       leaf
======  ==========================  ==================================
0:24    child boxes SoA             triangles SoA ``[e2x 4 | e2y 4 |
        ``[lox 4 | loy 4 | loz 4 |  e2z 4 | e1x 4 | ... | v0z 4]``
        hix 4 | hiy 4 | hiz 4]``    (9 components x 4 lanes, 0:36)
24:28   child DFS indices (int)
36:40   unused                      attribute index x 4 (int)
44      skip (int)                  skip (int)
45      count 0                     count 1..4 (int)
======  ==========================  ==================================

Empty child slots hold inverted boxes and index 0 (the root, never a
child).  ``accel/tlas.py`` adds instance rows (count < 0).
"""

from __future__ import annotations

import sys

import numpy as np

from unity_webgpu_pathtracer_torch.accel.bvh2 import BVH2
from unity_webgpu_pathtracer_torch.accel.linearize import split_axes

ROW = 48
OFF_PTRS = 24
OFF_IDX = 36
OFF_SKIP = 44
OFF_COUNT = 45
MAX_LEAF = 4


def _children4(bvh: BVH2, node: int, octant: int, axis: np.ndarray) -> list[int]:
    """Two BVH2 levels collapsed into up to 4 children, near first for
    ``octant``."""
    l = bvh.left[node]
    pair = [l, l + 1]
    if (octant >> axis[node]) & 1:
        pair.reverse()
    out = []
    for c in pair:
        if bvh.count[c] > 0:
            out.append(c)
        else:
            cl = bvh.left[c]
            sub = [cl, cl + 1]
            if (octant >> axis[c]) & 1:
                sub.reverse()
            out.extend(sub)
    return out


def _leaf_row(row: np.ndarray, bvh: BVH2, node: int, tri_records: np.ndarray,
              attr_index: np.ndarray) -> None:
    start = int(bvh.start[node])
    cnt = int(bvh.count[node])
    block = np.zeros((9, MAX_LEAF), np.float32)
    block[:, :cnt] = tri_records[start:start + cnt].T         # (9, cnt) [e2, e1, v0]
    row[0:36] = block.reshape(-1)
    ints = np.zeros(MAX_LEAF, np.int32)
    ints[:cnt] = attr_index[start:start + cnt]
    row[OFF_IDX:OFF_IDX + 4] = ints.view(np.float32)
    row[OFF_COUNT] = np.asarray([cnt], np.int32).view(np.float32)[0]


def build_wide(bvh: BVH2, tri_records: np.ndarray, attr_index: np.ndarray,
               octant_orders: bool = True) -> np.ndarray:
    """The fat rows, ``(O, N, 48)`` float32 with O = 8 (``octant_orders``)
    or 1; ``tri_records`` in the BVH's leaf order, ``attr_index`` each
    record's attribute row."""
    axis = split_axes(bvh)
    outs = []
    for octant in (range(8) if octant_orders else (0,)):
        rows: list[np.ndarray] = []

        def emit(node: int) -> int:
            """Emit ``node``'s subtree; returns its DFS index."""
            my = len(rows)
            row = np.zeros(ROW, np.float32)
            rows.append(row)
            if bvh.count[node] > 0:
                _leaf_row(row, bvh, node, tri_records, attr_index)
            else:
                kids = _children4(bvh, node, octant, axis)
                ptrs = np.zeros(4, np.int32)
                boxes = np.zeros((6, 4), np.float32)
                boxes[0:3, :] = np.inf
                boxes[3:6, :] = -np.inf
                for k, c in enumerate(kids):
                    boxes[0:3, k] = bvh.nmin[c]
                    boxes[3:6, k] = bvh.nmax[c]
                    ptrs[k] = emit(c)
                row[0:24] = boxes.reshape(-1)
                row[OFF_PTRS:OFF_PTRS + 4] = ptrs.view(np.float32)
            # Every descendant was emitted in between: the subtree's end.
            row[OFF_SKIP] = np.asarray([len(rows)], np.int32).view(np.float32)[0]
            return my

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            emit(0)
        finally:
            sys.setrecursionlimit(old)
        outs.append(np.stack(rows))
    return np.stack(outs)


def validate_wide(nodes: np.ndarray, tri_count: int) -> None:
    """Every triangle in exactly one leaf of each order; skips move forward."""
    for oi in range(nodes.shape[0]):
        seen = np.zeros(tri_count, np.int32)
        rows = nodes[oi]
        n = rows.shape[0]
        for i in range(n):
            cnt = rows[i, OFF_COUNT:OFF_COUNT + 1].view(np.int32)[0]
            skip = rows[i, OFF_SKIP:OFF_SKIP + 1].view(np.int32)[0]
            assert i < skip <= n
            if cnt > 0:
                seen[rows[i, OFF_IDX:OFF_IDX + 4].view(np.int32)[:cnt]] += 1
        assert (seen == 1).all(), "leaf coverage broken"
