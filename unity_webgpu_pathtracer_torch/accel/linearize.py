"""Skip-pointer rows of a BVH2 (``accel/linearize.py`` of the reference),
the table of the ``skip`` traversal (``ops/traverse_skip.py``).

The nodes are laid out in depth-first order and each stores where to go
when its subtree is skipped, so a ray's whole traversal state is one row
pointer: it reads ``nodes[octant, ptr]`` and goes to ``ptr + 1`` (enter)
or ``skip`` (miss, or a leaf done).

Row layout, ``(N, 8)`` float32 with ints bitcast into the last two::

    [lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, leaf_code, skip]

``leaf_code`` is 0 for an inner node, else ``offset * 16 + count`` (the
leaf packing of ``accel/mbvh.py``); ``skip`` is the next DFS index when
the subtree is skipped, ``N`` at the end.  Each of the 8 ray octants gets
its own order, with the near child of every split first for rays of that
octant (the child whose centroid is greater along the split's dominant
axis comes first where the octant's direction is negative on it).
"""

from __future__ import annotations

import numpy as np

from unity_webgpu_pathtracer_torch.accel.bvh2 import BVH2

LEAF_CNT_BITS = 16


def split_axes(bvh: BVH2) -> np.ndarray:
    """Per node, the axis of the largest separation of its two children's
    centroids (0 for leaves): the octant bit that picks the near child."""
    axis = np.zeros(bvh.node_count, np.int32)
    inner = bvh.left >= 0
    li = bvh.left[inner]
    c_l = (bvh.nmin[li] + bvh.nmax[li]) * 0.5
    c_r = (bvh.nmin[li + 1] + bvh.nmax[li + 1]) * 0.5
    axis[inner] = np.argmax(np.abs(c_r - c_l), axis=-1)
    return axis


def linearize_bvh2(bvh: BVH2, octant_orders: bool = True) -> np.ndarray:
    """The skip rows: ``(8, N, 8)`` float32 with ``octant_orders`` (one DFS
    order per ray octant), else ``(1, N, 8)``."""
    n = bvh.node_count
    axis = split_axes(bvh)
    octants = range(8) if octant_orders else (0,)
    out = np.zeros((len(octants), n, 8), np.float32)
    for oi, octant in enumerate(octants):
        rows = np.zeros((n, 8), np.float32)
        ints = np.zeros((n, 2), np.int32)
        # DFS indices first, subtree sizes on the way out; skip = index +
        # subtree size.
        dfs_index = np.zeros(n, np.int32)
        subtree = np.zeros(n, np.int32)
        cursor = 0
        stack = [(0, False)]
        seq = []
        while stack:
            node, done = stack.pop()
            if done:
                if bvh.count[node] > 0:
                    subtree[node] = 1
                else:
                    l = bvh.left[node]
                    subtree[node] = 1 + subtree[l] + subtree[l + 1]
                continue
            dfs_index[node] = cursor
            cursor += 1
            seq.append(node)
            stack.append((node, True))
            if bvh.count[node] == 0:
                l = bvh.left[node]
                first, second = l, l + 1
                if (octant >> axis[node]) & 1:
                    first, second = second, first
                stack.append((second, False))
                stack.append((first, False))
        for node in seq:
            i = dfs_index[node]
            rows[i, 0:3] = bvh.nmin[node]
            rows[i, 3:6] = bvh.nmax[node]
            if bvh.count[node] > 0:
                ints[i, 0] = bvh.start[node] * LEAF_CNT_BITS + bvh.count[node]
            ints[i, 1] = i + subtree[node]
        rows[:, 6:8] = ints.view(np.float32)
        out[oi] = rows
    return out
