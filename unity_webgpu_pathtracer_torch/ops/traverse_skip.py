"""Stackless skip-pointer traversal in plain PyTorch
(``ops/traverse_skip.py`` of the reference), over ``accel/linearize.py``
rows.

A lane's state is one DFS pointer into the rows of its ray's octant
order: a node step reads ``nodes[octant, ptr]``, enters (``ptr + 1``) on a
box hit, else jumps to the row's skip; a hit leaf *parks* the lane (its
leaf code in ``pending``, the pointer already at the skip), and every
``LEAF_EVERY`` node steps one leaf step intersects the parked lanes'
leaves (up to 4 triangles of ``tris``, in the leaves' order) and unparks
them.  The loop test is read on the host every ``CHECK_EVERY`` rounds
(counted in ``TRAVERSE_STATS``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from unity_webgpu_pathtracer_torch.accel.linearize import LEAF_CNT_BITS
from unity_webgpu_pathtracer_torch.ops.traverse_mbvh import leaf_hits, take_best
from unity_webgpu_pathtracer_torch.ops.traverse_wide8 import octant_index
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import CHECK_EVERY
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE, safe_rcp
from unity_webgpu_pathtracer_torch.utils.profiling import span

LEAF_EVERY = 4   # node steps per leaf step

TRAVERSE_STATS = {"calls": 0, "host_reads": 0}


class SkipState(NamedTuple):
    ptr: torch.Tensor       # (B,) int32 DFS position (N = done)
    pending: torch.Tensor   # (B,) int32 parked leaf code (0 = none)
    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    slot: torch.Tensor      # (B,) int32 best row of ``tris`` (-1 none)
    found: torch.Tensor


def node_step(nodes_flat: torch.Tensor, n_nodes: int, base: torch.Tensor, o: torch.Tensor,
              inv: torch.Tensor, s: SkipState) -> SkipState:
    """One skip-pointer step of the lanes not parked at a leaf."""
    stepping = (s.ptr < n_nodes) & (s.pending == 0)
    row = nodes_flat[(base + torch.clamp_max(s.ptr, n_nodes - 1)).long()]   # (B, 8)
    row_i = row.view(torch.int32)
    leaf_code, skip = row_i[:, 6], row_i[:, 7]
    t0 = (row[:, 0:3] - o) * inv
    t1 = (row[:, 3:6] - o) * inv
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    box_hit = torch.maximum(t_near, torch.zeros_like(t_near)) <= torch.minimum(t_far, s.t)
    is_leaf = leaf_code != 0
    enter = box_hit & ~is_leaf
    park = box_hit & is_leaf
    new_ptr = torch.where(enter, s.ptr + 1, skip)
    return s._replace(ptr=torch.where(stepping, new_ptr, s.ptr),
                      pending=torch.where(stepping & park, leaf_code, s.pending))


def leaf_step(tris: torch.Tensor, o: torch.Tensor, d: torch.Tensor, s: SkipState) -> SkipState:
    """Intersect the parked lanes' leaves, then unpark them."""
    has_leaf = s.pending != 0
    tt, uu, vv, tri_idx = leaf_hits(
        tris, torch.div(s.pending, LEAF_CNT_BITS, rounding_mode="floor"),
        torch.remainder(s.pending, LEAF_CNT_BITS), has_leaf, o, d, s.t)
    out, _better = take_best(s, tt, uu, vv, tri_idx)
    return out._replace(found=s.found | (out.t < s.t), pending=torch.zeros_like(s.pending))


def _traverse(nodes: torch.Tensor, tris: torch.Tensor, origins: torch.Tensor,
              directions: torch.Tensor, t_max, any_hit: bool,
              live: torch.Tensor | None = None) -> SkipState:
    """Rounds of ``LEAF_EVERY`` node steps and a leaf step until no lane of
    ``live`` (None: every lane) is left (or, with ``any_hit``, all have a
    hit); lanes outside ``live`` start at the end."""
    b, dev = origins.shape[0], origins.device
    n_orders, n_nodes = nodes.shape[0], nodes.shape[1]
    nodes_flat = nodes.reshape(n_orders * n_nodes, 8)
    base = torch.remainder(octant_index(directions), n_orders) * n_nodes
    inv = safe_rcp(directions)
    ptr = torch.zeros((b,), dtype=torch.int32, device=dev)
    if live is not None:
        ptr = torch.where(live, ptr, torch.full_like(ptr, n_nodes))
    s = SkipState(
        ptr=ptr, pending=torch.zeros((b,), dtype=torch.int32, device=dev),
        t=torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev),
                             (b,)).clone(),
        u=torch.zeros((b,), dtype=torch.float32, device=dev),
        v=torch.zeros((b,), dtype=torch.float32, device=dev),
        slot=torch.full((b,), -1, dtype=torch.int32, device=dev),
        found=torch.zeros((b,), dtype=torch.bool, device=dev))
    TRAVERSE_STATS["calls"] += 1
    while True:
        for _ in range(CHECK_EVERY):
            for _ in range(LEAF_EVERY):
                s = node_step(nodes_flat, n_nodes, base, origins, inv, s)
            s = leaf_step(tris, origins, directions, s)
        running = (s.ptr < n_nodes) | (s.pending != 0)
        if any_hit:
            running = running & ~s.found
        TRAVERSE_STATS["host_reads"] += 1
        with span("sync.loop_test"):
            if not bool(running.any()):
                return s


def closest_hit(nodes: torch.Tensor, tris: torch.Tensor, origins: torch.Tensor,
                directions: torch.Tensor, live: torch.Tensor | None = None):
    """Closest hit of (B, 3) rays against (O, N, 8) skip rows: ``(t, bary
    (B, 2), slot (-1 miss), instance (-1))``; lanes outside ``live`` come
    back as misses."""
    s = _traverse(nodes, tris, origins, directions, FAR_PLANE, False, live)
    return s.t, torch.stack([s.u, s.v], dim=-1), s.slot, torch.full_like(s.slot, -1)


def occluded(nodes: torch.Tensor, tris: torch.Tensor, origins: torch.Tensor,
             directions: torch.Tensor, t_max: torch.Tensor,
             live: torch.Tensor | None = None) -> torch.Tensor:
    """Whether each ray hits anything before its ``t_max`` (B,)."""
    return _traverse(nodes, tris, origins, directions, t_max, True, live).found
