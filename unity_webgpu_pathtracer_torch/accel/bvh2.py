"""Binned-SAH BVH2 builder in numpy (``accel/bvh2.py`` of the reference).

8 bins on the centroid extent, per-axis SAH sweep, in-place partition,
leaves capped at ``leaf_size``.  The port builds the TLAS over instance
boxes with it (``accel/wide16.py::emit_tlas_rows16``); mesh BVHs come
from the native SBVH builder.  The arithmetic is the reference's, so the
TLAS rows are byte-identical to its build.
"""

from __future__ import annotations

import dataclasses

import numpy as np

N_BINS = 8


@dataclasses.dataclass
class BVH2:
    """Flat BVH2. Leaf nodes have ``count > 0`` and index ``order``."""

    nmin: np.ndarray    # (N, 3)
    nmax: np.ndarray    # (N, 3)
    left: np.ndarray    # (N,) int32, right = left + 1; -1 for leaves
    start: np.ndarray   # (N,) int32 first triangle (into order)
    count: np.ndarray   # (N,) int32 0 for inner nodes
    order: np.ndarray   # (F,) int32 triangle permutation

    @property
    def node_count(self) -> int:
        return self.nmin.shape[0]


def build_bvh2(positions: np.ndarray, leaf_size: int = 4) -> BVH2:
    positions = np.asarray(positions, np.float32)
    f = positions.shape[0]
    tmin = positions.min(axis=1)
    tmax = positions.max(axis=1)
    centroids = (tmin + tmax) * 0.5

    order = np.arange(f, dtype=np.int32)
    nmin, nmax, left, start, count = [], [], [], [], []

    def new_node():
        nmin.append(None); nmax.append(None)
        left.append(-1); start.append(0); count.append(0)
        return len(left) - 1

    root = new_node()
    # Worklist of (node_index, lo, hi) ranges over `order`.
    stack = [(root, 0, f)]
    while stack:
        ni, lo, hi = stack.pop()
        idx = order[lo:hi]
        bmin = tmin[idx].min(axis=0)
        bmax = tmax[idx].max(axis=0)
        nmin[ni] = bmin
        nmax[ni] = bmax
        n = hi - lo
        if n <= leaf_size:
            start[ni] = lo
            count[ni] = n
            continue

        # Binned SAH over the centroid extent.
        cmin = centroids[idx].min(axis=0)
        cmax = centroids[idx].max(axis=0)
        extent = cmax - cmin
        best = None  # (cost, axis, split_bin, scale, centroid origin)
        for axis in range(3):
            if extent[axis] <= 1e-12:
                continue
            scale = N_BINS * (1.0 - 1e-6) / extent[axis]
            bins = np.minimum(
                ((centroids[idx, axis] - cmin[axis]) * scale).astype(np.int32),
                N_BINS - 1,
            )
            cnt = np.bincount(bins, minlength=N_BINS)
            # Per-bin AABBs.
            bminb = np.full((N_BINS, 3), np.inf, np.float32)
            bmaxb = np.full((N_BINS, 3), -np.inf, np.float32)
            np.minimum.at(bminb, bins, tmin[idx])
            np.maximum.at(bmaxb, bins, tmax[idx])
            # Sweep: left/right cumulative areas & counts.
            lmin = np.minimum.accumulate(bminb, axis=0)
            lmax = np.maximum.accumulate(bmaxb, axis=0)
            rmin = np.minimum.accumulate(bminb[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmaxb[::-1], axis=0)[::-1]
            lcnt = np.cumsum(cnt)
            rcnt = np.cumsum(cnt[::-1])[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            sal = area(lmin, lmax)[: N_BINS - 1]
            sar = area(rmin, rmax)[1:]
            nl = lcnt[: N_BINS - 1]
            nr = rcnt[1:]
            cost = sal * nl + sar * nr
            cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
            k = int(np.argmin(cost))
            if best is None or cost[k] < best[0]:
                best = (float(cost[k]), axis, k, scale, cmin[axis])

        if best is None or not np.isfinite(best[0]):
            # Degenerate centroids: median split keeps the tree balanced.
            mid = lo + n // 2
            sel = np.argsort(centroids[idx, int(np.argmax(extent))], kind="stable")
            order[lo:hi] = idx[sel]
        else:
            # Leaves are hard-capped at leaf_size (downstream formats pack
            # exactly leaf_size triangle lanes), so an unprofitable split
            # still splits; the SAH cost is advisory only for ordering.
            _, axis, k, scale, corig = best
            bins_ax = np.minimum(
                ((centroids[idx, axis] - corig) * scale).astype(np.int32), N_BINS - 1
            )
            go_left = bins_ax <= k
            mid = lo + int(go_left.sum())
            order[lo:hi] = np.concatenate([idx[go_left], idx[~go_left]])
        li = new_node()
        ri = new_node()
        left[ni] = li
        stack.append((li, lo, mid))
        stack.append((ri, mid, hi))

    return BVH2(
        nmin=np.asarray(nmin, np.float32),
        nmax=np.asarray(nmax, np.float32),
        left=np.asarray(left, np.int32),
        start=np.asarray(start, np.int32),
        count=np.asarray(count, np.int32),
        order=order,
    )


def validate_bvh2(bvh: BVH2, positions: np.ndarray) -> None:
    """Raise ``ValueError`` unless ``order`` is a permutation, every
    triangle lies in exactly one leaf and inside its box, and every child
    box lies inside its parent's (the reference's invariants, 1e-4
    slack)."""
    f = positions.shape[0]
    if sorted(bvh.order.tolist()) != list(range(f)):
        raise ValueError("order is not a permutation")
    tmin, tmax = positions.min(axis=1), positions.max(axis=1)
    covered = np.zeros(f, bool)
    stack = [0]
    while stack:
        ni = stack.pop()
        if bvh.count[ni] > 0:
            idx = bvh.order[bvh.start[ni] : bvh.start[ni] + bvh.count[ni]]
            if covered[idx].any():
                raise ValueError(f"leaf {ni}: a triangle in two leaves")
            covered[idx] = True
            if not ((tmin[idx] >= bvh.nmin[ni] - 1e-4).all()
                    and (tmax[idx] <= bvh.nmax[ni] + 1e-4).all()):
                raise ValueError(f"leaf {ni}: a triangle outside its box")
        else:
            li = bvh.left[ni]
            for c in (li, li + 1):
                if not ((bvh.nmin[c] >= bvh.nmin[ni] - 1e-4).all()
                        and (bvh.nmax[c] <= bvh.nmax[ni] + 1e-4).all()):
                    raise ValueError(f"node {c} outside its parent {ni}")
                stack.append(c)
    if not covered.all():
        raise ValueError(f"{int((~covered).sum())} triangles in no leaf")

