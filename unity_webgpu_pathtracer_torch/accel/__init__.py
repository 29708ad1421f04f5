"""Acceleration structures, built on the host (``accel/__init__.py`` of
the reference): the 8-wide MBVH (``mbvh``), the skip rows (``skip``,
``linearize.py``) and the fat rows (``wide``, ``wide.py``; split for
``wide2`` by ``wide2.py``), besides the wide16 and wide8 tables
(``wide16.py``, ``wide8.py``) and the CWBVH export (``cwbvh.py``).

Each builder runs the native C++ builder (``native.py``) when the library
loads and the numpy one otherwise, as the reference's do; like the
reference's, these three builds are not cached on disk.
"""

from __future__ import annotations

import numpy as np


def build_scene_bvh(positions: np.ndarray, leaf_size: int = 4):
    """The 8-wide MBVH of (F, 3, 3) triangles: ``(bounds (N, 48) f32, child
    (N, 8) i32, order (F,) i32)``, ``order`` the triangle permutation its
    leaves index."""
    from unity_webgpu_pathtracer_torch.accel import bvh2, mbvh
    from unity_webgpu_pathtracer_torch.accel.native import native_build_or_none

    native = native_build_or_none(positions, leaf_size)
    if native is not None:
        return native
    return mbvh.collapse_to_mbvh8(bvh2.build_bvh2(positions, leaf_size=leaf_size))


def build_scene_skip_bvh(positions: np.ndarray, leaf_size: int = 4):
    """The skip rows, one order per ray octant: ``(nodes (8, N, 8) f32,
    order (F,) i32)``."""
    from unity_webgpu_pathtracer_torch.accel import bvh2, linearize
    from unity_webgpu_pathtracer_torch.accel.native import native_linearize_or_none

    native = native_linearize_or_none(positions, leaf_size)
    if native is not None:
        return native
    nodes = bvh2.build_bvh2(positions, leaf_size=leaf_size)
    return linearize.linearize_bvh2(nodes), nodes.order.copy()


def build_scene_wide_bvh(positions: np.ndarray, tri_records: np.ndarray,
                         leaf_size: int = 4, octants: int = 1) -> np.ndarray:
    """The fat rows, ``(octants, N, 48)`` f32; ``tri_records`` are the
    (F, 9) ``[e2, e1, v0]`` records in scene order, which the leaves inline
    with their scene index.  ``octants`` is 1 (one order) or 8 (one per
    ray octant, near child first: fewer arrivals a ray, 8x the table)."""
    from unity_webgpu_pathtracer_torch.accel import bvh2, wide
    from unity_webgpu_pathtracer_torch.accel.native import native_wide_or_none

    native = native_wide_or_none(positions, tri_records, leaf_size, octants)
    if native is not None:
        return native
    nodes = bvh2.build_bvh2(positions, leaf_size=leaf_size)
    return wide.build_wide(nodes, tri_records[nodes.order], nodes.order,
                           octant_orders=octants == 8)
