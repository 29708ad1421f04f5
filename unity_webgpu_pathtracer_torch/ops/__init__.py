"""Intersection and traversal backends (``ops/__init__.py`` of the
reference).

``get_intersectors(config)`` dispatches on ``RenderConfig.traversal`` and
returns ``(closest, occluded)`` with the reference's signatures::

    closest(scene, origins (B, 3), directions (B, 3), live=None)
        -> (t, bary (B, 2), slot (B,) int32, instance (B,) int32)
    occluded(scene, origins, directions, t_max (B,), live=None) -> bool (B,)

``slot`` indexes ``scene.tri_index``, which maps it to the hit's attribute
row, -1 on a miss, where ``t`` is the far plane.  On mbvh/bvh2 and skip
the slot is a row of ``scene.tris`` in the leaves' order and ``tri_index``
that permutation; on wide and wide2 it is the attribute row itself (the
leaves inline it), on wide16, wide8 and the brute force the row of the
tables in BVH (or scene) order, and ``tri_index`` is the identity on all
of those.  ``live`` (None: every lane) names the lanes whose result is
read: the others may come back as misses.  ``wide16`` runs kernel K1
(``ops/cuda_arrival.py``) through ``traverse_wide16.closest_hit``/
``occluded`` on CUDA tensors and its plain twin on CPU tensors; the
reference's other backends run in plain PyTorch, no kernel: ``wide8``
(``traverse_wide8``), ``mbvh`` and ``bvh2`` (``traverse_mbvh``), ``skip``
(``traverse_skip``), ``wide`` (``traverse_wide``), ``wide2``
(``traverse_wide2``); ``bruteforce`` tests every ray against every
triangle (``ops/intersect.py``).
"""

from __future__ import annotations


def _closest_wide16(scene, origins, directions, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as tw16

    return tw16.closest_hit(scene.wide16_nodes, origins, directions, scene.stack_depth,
                            scene.inst_w2l.shape[0] > 0, live)


def _occluded_wide16(scene, origins, directions, t_max, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as tw16

    return tw16.occluded(scene.wide16_nodes, origins, directions, t_max, scene.stack_depth,
                         scene.inst_w2l.shape[0] > 0, live)


def _closest_wide8(scene, origins, directions, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_wide8 as tw8

    return tw8.closest_hit(scene.wide8_nodes, origins, directions, scene.stack_depth,
                           scene.inst_w2l.shape[0] > 0, live)


def _occluded_wide8(scene, origins, directions, t_max, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_wide8 as tw8

    return tw8.occluded(scene.wide8_nodes, origins, directions, t_max, scene.stack_depth,
                        scene.inst_w2l.shape[0] > 0, live)


def _closest_bruteforce(scene, origins, directions, live=None):
    from unity_webgpu_pathtracer_torch.ops import intersect

    return intersect.closest_hit_bruteforce(scene.tris, origins, directions)


def _occluded_bruteforce(scene, origins, directions, t_max, live=None):
    from unity_webgpu_pathtracer_torch.ops import intersect

    return intersect.occluded_bruteforce(scene.tris, origins, directions, t_max)


def _closest_mbvh(scene, origins, directions, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_mbvh

    return traverse_mbvh.closest_hit(scene.bvh_bounds, scene.bvh_child, scene.tris, origins,
                                     directions, live)


def _occluded_mbvh(scene, origins, directions, t_max, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_mbvh

    return traverse_mbvh.occluded(scene.bvh_bounds, scene.bvh_child, scene.tris, origins,
                                  directions, t_max, live)


def _closest_skip(scene, origins, directions, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_skip

    return traverse_skip.closest_hit(scene.skip_nodes, scene.tris, origins, directions, live)


def _occluded_skip(scene, origins, directions, t_max, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_skip

    return traverse_skip.occluded(scene.skip_nodes, scene.tris, origins, directions, t_max,
                                  live)


def _closest_wide(scene, origins, directions, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_wide

    return traverse_wide.closest_hit(scene.wide_nodes, scene.inst_w2l, origins, directions,
                                     live)


def _occluded_wide(scene, origins, directions, t_max, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_wide

    return traverse_wide.occluded(scene.wide_nodes, scene.inst_w2l, origins, directions,
                                  t_max, live)


def _closest_wide2(scene, origins, directions, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_wide2

    return traverse_wide2.closest_hit(scene, origins, directions, live)


def _occluded_wide2(scene, origins, directions, t_max, live=None):
    from unity_webgpu_pathtracer_torch.ops import traverse_wide2

    return traverse_wide2.occluded(scene, origins, directions, t_max, live)


_BACKENDS = {
    "bruteforce": (_closest_bruteforce, _occluded_bruteforce),
    "bvh2": (_closest_mbvh, _occluded_mbvh),
    "mbvh": (_closest_mbvh, _occluded_mbvh),
    "skip": (_closest_skip, _occluded_skip),
    "wide": (_closest_wide, _occluded_wide),
    "wide2": (_closest_wide2, _occluded_wide2),
    "wide8": (_closest_wide8, _occluded_wide8),
    "wide16": (_closest_wide16, _occluded_wide16),
}


def get_intersectors(config):
    if config.traversal not in _BACKENDS:
        raise ValueError(f"unknown traversal backend {config.traversal!r}")
    return _BACKENDS[config.traversal]


def pass_counters() -> tuple[int, int, int]:
    """``(K1's multi-arrival launches, host reads of the traversal loops'
    test, the shading kernel's launches)`` so far in this process:
    ``arrival_steps16_cuda.launches`` (CUDA tensors only; the plain twin on
    the CPU counts none), every backend's ``TRAVERSE_STATS`` and
    ``cuda_shade.shade16_cuda.launches`` (both entries); a pass's counts
    are the difference of two readings."""
    from unity_webgpu_pathtracer_torch.ops import (
        traverse_mbvh,
        traverse_skip,
        traverse_wide,
        traverse_wide2,
        traverse_wide8,
        traverse_wide16,
    )
    from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_steps16_cuda
    from unity_webgpu_pathtracer_torch.ops.cuda_shade import shade16_cuda

    reads = sum(m.TRAVERSE_STATS["host_reads"] for m in (
        traverse_mbvh, traverse_skip, traverse_wide, traverse_wide2, traverse_wide8,
        traverse_wide16))
    return (sum(arrival_steps16_cuda.launches.values()), reads,
            sum(shade16_cuda.launches.values()))
