"""Intersection and traversal backends (``ops/__init__.py`` of the
reference).

``get_intersectors(config)`` dispatches on ``RenderConfig.traversal`` and
returns ``(closest, occluded)`` with the reference's signatures::

    closest(scene, origins (B, 3), directions (B, 3), live=None)
        -> (t, bary (B, 2), row (B,) int32, instance (B,) int32)
    occluded(scene, origins, directions, t_max (B,), live=None) -> bool (B,)

``row`` indexes ``scene.tri_index`` (the identity on every table the port
builds), -1 on a miss, where ``t`` is the far plane.  ``live`` (None: every
lane) names the lanes whose result is read: the others may come back as
misses.  ``wide16`` runs kernel K1 (``ops/cuda_arrival.py``) through
``traverse_wide16.closest_hit``/``occluded`` on CUDA tensors and its
plain twin on CPU tensors; ``bruteforce`` tests every ray against every
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


def _closest_bruteforce(scene, origins, directions, live=None):
    from unity_webgpu_pathtracer_torch.ops import intersect

    return intersect.closest_hit_bruteforce(scene.tris, origins, directions)


def _occluded_bruteforce(scene, origins, directions, t_max, live=None):
    from unity_webgpu_pathtracer_torch.ops import intersect

    return intersect.occluded_bruteforce(scene.tris, origins, directions, t_max)


def get_intersectors(config):
    if config.traversal == "wide16":
        return _closest_wide16, _occluded_wide16
    if config.traversal == "bruteforce":
        return _closest_bruteforce, _occluded_bruteforce
    raise ValueError(f"the PyTorch port has no traversal backend {config.traversal!r}")
