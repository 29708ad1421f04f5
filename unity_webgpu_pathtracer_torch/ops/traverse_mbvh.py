"""8-wide MBVH stack traversal in plain PyTorch (``ops/traverse_mbvh.py``
of the reference), over ``accel/mbvh.py`` tables, for the ``mbvh`` and
``bvh2`` backends.

Each lane keeps a stack of child codes (``accel/mbvh.py``: ``c > 0`` the
inner node ``c - 1``, ``c < 0`` a leaf ``-(offset * 16 + count)``).  One
step pops an entry per lane and either slab-tests the 8 children of an
inner node, pushing the hit ones far to near (a stable descending sort of
their entry distances, so ties keep slot order, as the reference's), or
intersects the up to 4 triangles of a leaf (Möller-Trumbore; ``slot``
indexes ``tris``, in the leaves' order).  No kernel serves this backend:
each step is a few dozen PyTorch operations, the loop test read on the
host every ``CHECK_EVERY`` steps (counted in ``TRAVERSE_STATS``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from unity_webgpu_pathtracer_torch.accel.mbvh import LEAF_CNT_BITS, WIDTH
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import CHECK_EVERY, DET_EPS, T_MIN
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE, dot, safe_rcp
from unity_webgpu_pathtracer_torch.utils.profiling import span

STACK_DEPTH = 64
MAX_LEAF = 4

TRAVERSE_STATS = {"calls": 0, "host_reads": 0}


class MbvhState(NamedTuple):
    stack: torch.Tensor   # (B, STACK_DEPTH + 1) int32 child codes; the last
                          # column takes the pushes the reference drops
    sp: torch.Tensor      # (B,) int32 stack height
    t: torch.Tensor       # (B,) float32 best distance
    u: torch.Tensor
    v: torch.Tensor
    slot: torch.Tensor    # (B,) int32 best row of ``tris`` (-1 none)
    found: torch.Tensor   # (B,) bool


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, each component a difference of two
    products as ``jnp.cross`` computes it (``torch.linalg.cross`` rounds
    otherwise on the CPU)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def leaf_hits(tris: torch.Tensor, off: torch.Tensor, cnt: torch.Tensor,
              is_leaf: torch.Tensor, o: torch.Tensor, d: torch.Tensor, t_cur: torch.Tensor):
    """Möller-Trumbore of (B, 3) rays against ``tris`` rows ``off + k``,
    ``k < cnt`` (up to ``MAX_LEAF``), on the lanes in ``is_leaf``.
    Returns ``(tt, uu, vv, tri_idx)``, each (B, MAX_LEAF), ``tt`` the far
    plane where there is no hit before ``t_cur``."""
    lanes = torch.arange(MAX_LEAF, dtype=torch.int32, device=tris.device)[None, :]
    tri_idx = torch.clamp(off[:, None] + lanes, 0, tris.shape[0] - 1)
    lane_ok = (lanes < cnt[:, None]) & is_leaf[:, None]
    recs = tris[tri_idx.long()]                                  # (B, 4, 9)
    e2, e1, v0 = recs[..., 0:3], recs[..., 3:6], recs[..., 6:9]
    d4, o4 = d[:, None, :], o[:, None, :]
    r = _cross(d4, e2)
    a = dot(e1, r)
    finv = 1.0 / torch.where(torch.abs(a) < DET_EPS, torch.ones_like(a), a)
    sv = o4 - v0
    uu = finv * dot(sv, r)
    q = _cross(sv, e1)
    vv = finv * dot(d4, q)
    tt = finv * dot(e2, q)
    valid = (lane_ok & (torch.abs(a) > DET_EPS)
             & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0) & (uu + vv <= 1.0)
             & (tt > T_MIN) & (tt < t_cur[:, None]))
    return torch.where(valid, tt, torch.full_like(tt, FAR_PLANE)), uu, vv, tri_idx


def take_best(s, tt, uu, vv, ids, id_field: str = "slot"):
    """The reference's select chain over the leaf lanes (the first lane
    with the smallest ``tt`` wins if it beats ``s.t``): returns ``(s with
    t, u, v and the id field updated, improved)``."""
    best = torch.argmin(tt, dim=1, keepdim=True)
    t_cand = tt.gather(1, best)[:, 0]
    better = t_cand < s.t
    return s._replace(**{
        "t": torch.where(better, t_cand, s.t),
        "u": torch.where(better, uu.gather(1, best)[:, 0], s.u),
        "v": torch.where(better, vv.gather(1, best)[:, 0], s.v),
        id_field: torch.where(better, ids.gather(1, best)[:, 0], getattr(s, id_field)),
    }), better


def step(bounds: torch.Tensor, child: torch.Tensor, tris: torch.Tensor, o: torch.Tensor,
         d: torch.Tensor, inv: torch.Tensor, s: MbvhState, any_hit: bool) -> MbvhState:
    """One pop for every lane with a stack (and, with ``any_hit``, no hit
    yet); ``o``/``d``/``inv`` (B, 3)."""
    b = o.shape[0]
    zi = torch.zeros_like(s.sp)
    active = s.sp > 0
    if any_hit:
        active = active & ~s.found
    sp_pop = torch.where(active, s.sp - 1, zi)
    code = torch.where(active, s.stack.gather(1, sp_pop.long()[:, None])[:, 0], zi)
    is_inner = code > 0
    is_leaf = code < 0

    # ---- inner: 8-wide slab test, hits pushed far to near ----
    node = torch.where(is_inner, code - 1, zi).long()
    bb = bounds[node].view(b, 6, WIDTH)                          # [lo xyz | hi xyz] x 8
    kids = child[node]                                           # (B, 8)
    ov, invv = o[:, :, None], inv[:, :, None]
    t_lo = (bb[:, 0:3] - ov) * invv
    t_hi = (bb[:, 3:6] - ov) * invv
    t_near = torch.amax(torch.minimum(t_lo, t_hi), dim=1)       # (B, 8)
    t_far = torch.amin(torch.maximum(t_lo, t_hi), dim=1)
    t_near = torch.maximum(t_near, torch.zeros_like(t_near))
    t_far = torch.minimum(t_far, s.t[:, None])
    hitmask = (t_near <= t_far) & (kids != 0) & is_inner[:, None]
    sort_key = torch.where(hitmask, t_near, torch.full_like(t_near, float("-inf")))
    order = torch.argsort(sort_key, dim=-1, descending=True, stable=True)
    kids_sorted = kids.gather(1, order)
    hit_sorted = hitmask.gather(1, order)
    push_pos = sp_pop[:, None] + torch.cumsum(hit_sorted.to(torch.int32), dim=-1) - 1
    drop = torch.full_like(push_pos, STACK_DEPTH)
    push_pos = torch.where(hit_sorted, torch.minimum(push_pos, drop), drop)
    stack = s.stack.scatter(1, push_pos.long(), kids_sorted)
    sp_inner = torch.clamp_max(sp_pop + hit_sorted.sum(dim=-1, dtype=torch.int32), STACK_DEPTH)

    # ---- leaf: up to 4 triangles ----
    neg = torch.where(is_leaf, -code, zi)
    tt, uu, vv, tri_idx = leaf_hits(tris, torch.div(neg, LEAF_CNT_BITS, rounding_mode="floor"),
                                    torch.remainder(neg, LEAF_CNT_BITS), is_leaf, o, d, s.t)
    out, _better = take_best(s, tt, uu, vv, tri_idx)
    sp = torch.where(active & is_inner, sp_inner, sp_pop)
    return out._replace(stack=stack, sp=torch.where(active, sp, s.sp),
                        found=s.found | (is_leaf & (out.t < s.t)))


def _traverse(bounds, child, tris, origins, directions, t_max, any_hit: bool,
              live: torch.Tensor | None = None) -> MbvhState:
    """Steps until no lane of ``live`` (None: every lane) has a stack (or,
    with ``any_hit``, all have a hit); lanes outside ``live`` start done."""
    b, dev = origins.shape[0], origins.device
    inv = safe_rcp(directions)
    stack = torch.zeros((b, STACK_DEPTH + 1), dtype=torch.int32, device=dev)
    stack[:, 0] = 1                                              # the root's inner code
    sp = torch.ones((b,), dtype=torch.int32, device=dev)
    if live is not None:
        sp = sp * live.to(torch.int32)
    s = MbvhState(
        stack=stack, sp=sp,
        t=torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev),
                             (b,)).clone(),
        u=torch.zeros((b,), dtype=torch.float32, device=dev),
        v=torch.zeros((b,), dtype=torch.float32, device=dev),
        slot=torch.full((b,), -1, dtype=torch.int32, device=dev),
        found=torch.zeros((b,), dtype=torch.bool, device=dev))
    TRAVERSE_STATS["calls"] += 1
    while True:
        for _ in range(CHECK_EVERY):
            s = step(bounds, child, tris, origins, directions, inv, s, any_hit)
        running = s.sp > 0
        if any_hit:
            running = running & ~s.found
        TRAVERSE_STATS["host_reads"] += 1
        with span("sync.loop_test"):
            if not bool(running.any()):
                return s


def closest_hit(bounds: torch.Tensor, child: torch.Tensor, tris: torch.Tensor,
                origins: torch.Tensor, directions: torch.Tensor,
                live: torch.Tensor | None = None):
    """Closest hit of (B, 3) rays: ``(t, bary (B, 2), slot (-1 miss),
    instance (-1))``; lanes outside ``live`` come back as misses."""
    s = _traverse(bounds, child, tris, origins, directions, FAR_PLANE, False, live)
    return s.t, torch.stack([s.u, s.v], dim=-1), s.slot, torch.full_like(s.slot, -1)


def occluded(bounds: torch.Tensor, child: torch.Tensor, tris: torch.Tensor,
             origins: torch.Tensor, directions: torch.Tensor, t_max: torch.Tensor,
             live: torch.Tensor | None = None) -> torch.Tensor:
    """Whether each ray hits anything before its ``t_max`` (B,)."""
    return _traverse(bounds, child, tris, origins, directions, t_max, True, live).found
