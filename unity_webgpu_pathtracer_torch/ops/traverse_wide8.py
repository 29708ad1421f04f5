"""8-wide quantized stack traversal in plain PyTorch
(``ops/traverse_wide8.py`` of the reference), over ``accel/wide8.py``
tables.

The cross-check backend: no kernel serves it, on the card or off it.  Each
arrival reads the row ``nodes[ptr]``.  An inner row slab-tests its 8
quantized child boxes and descends to the first hit child in ``k ^
ray_octant`` slot order (the builder put children in octant slots); the
rest go on the lane's stack as one entry ``(row << 8) | remaining-mask``,
or, when one child is left, as ``child << 8`` (mask 0), which a pop takes
as a fresh row.  A leaf row runs Möller-Trumbore on its up to 8 f16
triangles.  With ``has_instances`` an instance row takes the lane into the
instance's space, as ``ops/traverse_wide16.py`` does.  The state keeps the
field names of ``Wide16State`` (``FULL`` is 0xFF here), so the fused
integrator's lane bookkeeping serves both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from unity_webgpu_pathtracer_torch.accel.wide8 import MAX_DEPTH
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import CHECK_EVERY, DET_EPS, T_MIN
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE, safe_rcp
from unity_webgpu_pathtracer_torch.utils.profiling import span

DONE = -1
FULL = 0xFF
# Traversals run by ``closest_hit``/``occluded`` and host reads of their
# loop test in this process (reset by the caller).
TRAVERSE_STATS = {"calls": 0, "host_reads": 0}


class Wide8State(NamedTuple):
    ptr: torch.Tensor         # (B,) int32 current row; DONE when finished
    pend: torch.Tensor        # (B,) int32 pending-children mask (FULL = fresh)
    sp: torch.Tensor          # (B,) int32 stack height
    stack: torch.Tensor       # (D, B) int32 (row << 8) | mask
    t: torch.Tensor           # (B,) float32 best hit distance
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor         # (B,) int32 attribute row of the best hit (-1 none)
    found: torch.Tensor       # (B,) bool
    inst: torch.Tensor        # (B,) int32 current instance (-1 = world space)
    hit_inst: torch.Tensor    # (B,) int32 instance of the best hit
    sp_enter: torch.Tensor    # (B,) int32 stack height at instance entry
    local_o: torch.Tensor     # (3, B) float32 instance-local ray planes
    local_d: torch.Tensor
    local_inv: torch.Tensor


def init_state8(b: int, t_max: float, ptr0: int = 0, depth: int = MAX_DEPTH, *,
                device) -> Wide8State:
    """``depth`` stack planes: the scene's tree depth (``stack_depth``)."""
    i32 = dict(dtype=torch.int32, device=device)
    z3 = torch.zeros((3, b), dtype=torch.float32, device=device)
    return Wide8State(
        ptr=torch.full((b,), ptr0, **i32),
        pend=torch.full((b,), FULL, **i32),
        sp=torch.zeros((b,), **i32),
        stack=torch.zeros((depth, b), **i32),
        t=torch.full((b,), t_max, dtype=torch.float32, device=device),
        u=torch.zeros((b,), dtype=torch.float32, device=device),
        v=torch.zeros((b,), dtype=torch.float32, device=device),
        tri=torch.full((b,), -1, **i32),
        found=torch.zeros((b,), dtype=torch.bool, device=device),
        inst=torch.full((b,), -1, **i32),
        hit_inst=torch.full((b,), -1, **i32),
        sp_enter=torch.zeros((b,), **i32),
        local_o=z3, local_d=z3.clone(), local_inv=z3.clone(),
    )


def octant_index(d: torch.Tensor) -> torch.Tensor:
    """(B, 3) directions -> (B,) int32 octant, bit c set where d[c] < 0."""
    neg = (d < 0).to(torch.int32)
    return neg[:, 0] + 2 * neg[:, 1] + 4 * neg[:, 2]


def arrival_step8(nodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor, inv: torch.Tensor,
                  s: Wide8State, active: torch.Tensor | None = None,
                  has_instances: bool = True) -> Wide8State:
    """One arrival for every lane on (N, 48) rows; ``o``/``d``/``inv`` are
    the world ray, (B, 3)."""
    nodes_i = nodes.view(torch.int32)
    live = s.ptr >= 0
    if active is not None:
        live = live & active
    idx = torch.where(live, s.ptr, torch.zeros_like(s.ptr))
    row = nodes[idx.long()]                                      # (B, 48)
    row_i = nodes_i[idx.long()]
    meta = row_i[:, 3]
    is_leaf = live & (meta > 0)
    is_inst = live & (meta < 0)
    is_inner = live & (meta == 0)
    if has_instances:
        in_blas = (s.inst >= 0)[:, None]
        o_ = torch.where(in_blas, s.local_o.T, o)
        d_ = torch.where(in_blas, s.local_d.T, d)
        inv_ = torch.where(in_blas, s.local_inv.T, inv)
    else:
        o_, d_, inv_ = o, d, inv
    oct_ = octant_index(d_)
    anchor = row[:, 0:3]
    iota = torch.arange(8, dtype=torch.int32, device=nodes.device)[None, :]
    zero8 = torch.zeros_like(row_i[:, 20:28])

    # ---- inner: decode 8 quantized child boxes, slab-test, mask ----
    eword = row_i[:, 4]
    scale = torch.stack([(((eword >> (8 * c)) & 0xFF) << 23).view(torch.float32)
                         for c in range(3)], dim=-1)             # (B, 3)
    qbytes = row_i[:, 8:20].contiguous().view(torch.uint8).to(torch.float32)  # (B, 48)
    t_near = torch.zeros_like(zero8, dtype=torch.float32)
    t_far = s.t[:, None].expand(t_near.shape)
    for c in range(3):
        lo = anchor[:, c:c + 1] + qbytes[:, 8 * c:8 * c + 8] * scale[:, c:c + 1]
        hi = anchor[:, c:c + 1] + qbytes[:, 24 + 8 * c:32 + 8 * c] * scale[:, c:c + 1]
        tl = (lo - o_[:, c:c + 1]) * inv_[:, c:c + 1]
        th = (hi - o_[:, c:c + 1]) * inv_[:, c:c + 1]
        t_near = torch.maximum(t_near, torch.minimum(tl, th))
        t_far = torch.minimum(t_far, torch.maximum(tl, th))
    ptrs = row_i[:, 20:28]
    # Empty slots are masked explicitly: the slab test is symmetric, so an
    # inverted sentinel box would test like a full one.
    hit = (t_near <= t_far) & (ptrs >= 0)
    mask = torch.where(hit, 1 << iota, zero8).sum(dim=1, dtype=torch.int32) & s.pend

    # Nearest-first: slots in (k ^ octant) order, k = 0 wins.
    first_slot = torch.full_like(s.ptr, -1)
    for k in range(7, -1, -1):
        slot = k ^ oct_
        first_slot = torch.where(((mask >> slot) & 1) > 0, slot, first_slot)
    found_child = is_inner & (first_slot >= 0)
    onehot_first = iota == first_slot[:, None]
    child_ptr = torch.where(onehot_first, ptrs, zero8).sum(dim=1, dtype=torch.int32)
    remaining = mask & ~(1 << torch.clamp_min(first_slot, 0))

    # One stack entry: the row and its remaining mask, or, with one child
    # left, that child's row and mask 0 (a pop takes it as a fresh row).
    push = found_child & (remaining > 0)
    bits = (remaining[:, None] >> iota) & 1
    one_left = bits.sum(dim=1) == 1
    direct_ptr = (ptrs * bits).sum(dim=1, dtype=torch.int32)
    entry = torch.where(one_left, direct_ptr << 8, (idx << 8) | remaining)
    levels = torch.arange(s.stack.shape[0], device=nodes.device)[:, None]
    stack = torch.where((levels == s.sp[None, :]) & push[None, :], entry[None, :], s.stack)
    sp = s.sp + push.to(torch.int32)

    # ---- leaf: f16 anchored triangles, Möller-Trumbore ----
    halves = row[:, 4:40].contiguous().view(torch.float16).to(torch.float32)  # (B, 72)
    comp = [halves[:, 8 * c:8 * c + 8] for c in range(9)]
    e2x, e2y, e2z, e1x, e1y, e1z = comp[:6]
    v0x = comp[6] + anchor[:, 0:1]
    v0y = comp[7] + anchor[:, 1:2]
    v0z = comp[8] + anchor[:, 2:3]
    dx, dy, dz = d_[:, 0:1], d_[:, 1:2], d_[:, 2:3]
    ox, oy, oz = o_[:, 0:1], o_[:, 1:2], o_[:, 2:3]
    rx = dy * e2z - dz * e2y
    ry = dz * e2x - dx * e2z
    rz = dx * e2y - dy * e2x
    a = e1x * rx + e1y * ry + e1z * rz
    finv = 1.0 / torch.where(torch.abs(a) < DET_EPS, torch.ones_like(a), a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    uu = finv * (sx * rx + sy * ry + sz * rz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = finv * (dx * qx + dy * qy + dz * qz)
    tt = finv * (e2x * qx + e2y * qy + e2z * qz)
    valid = (
        is_leaf[:, None] & (iota < meta[:, None])
        & (torch.abs(a) > DET_EPS)
        & (uu >= 0.0) & (uu <= 1.0)
        & (vv >= 0.0) & (uu + vv <= 1.0)
        & (tt > T_MIN) & (tt < s.t[:, None])
    )
    tt = torch.where(valid, tt, torch.full_like(tt, FAR_PLANE))
    best = torch.argmin(tt, dim=1, keepdim=True)
    t_cand = tt.gather(1, best)[:, 0]
    improved = t_cand < s.t
    t_new = torch.where(improved, t_cand, s.t)
    u_new = torch.where(improved, uu.gather(1, best)[:, 0], s.u)
    v_new = torch.where(improved, vv.gather(1, best)[:, 0], s.v)
    tri_new = torch.where(improved, row_i[:, 40:48].gather(1, best)[:, 0], s.tri)
    found_new = s.found | improved

    # ---- pop ----
    need_pop = (is_inner & ~found_child) | is_leaf
    has = sp > 0
    top = stack.gather(0, (sp - 1).clamp_min(0).long()[None, :])[0]
    top = torch.where(has, top, torch.zeros_like(top))
    full = torch.full_like(top, FULL)
    pop_ptr = torch.where(has, top >> 8, torch.full_like(top, DONE))
    pop_pend = torch.where((top & 0xFF) == 0, full, top & 0xFF)
    sp_after = torch.where(need_pop & has, sp - 1, sp)
    new_ptr = torch.where(found_child, child_ptr, torch.where(need_pop, pop_ptr, s.ptr))
    new_pend = torch.where(found_child, full,
                           torch.where(need_pop, torch.where(has, pop_pend, full), s.pend))
    out = s._replace(stack=stack, t=t_new, u=u_new, v=v_new, tri=tri_new, found=found_new)
    if not has_instances:
        return out._replace(ptr=torch.where(live, new_ptr, s.ptr),
                            pend=torch.where(live, new_pend, s.pend),
                            sp=torch.where(live, sp_after, s.sp))

    # ---- instance row: enter instance space, jump to the BLAS root ----
    w2l = row[:, 4:16]
    lo3 = torch.stack([w2l[:, 4 * c] * o[:, 0] + w2l[:, 4 * c + 1] * o[:, 1]
                       + w2l[:, 4 * c + 2] * o[:, 2] + w2l[:, 4 * c + 3]
                       for c in range(3)])                       # (3, B)
    ld3 = torch.stack([w2l[:, 4 * c] * d[:, 0] + w2l[:, 4 * c + 1] * d[:, 1]
                       + w2l[:, 4 * c + 2] * d[:, 2] for c in range(3)])
    e3 = is_inst[None, :]
    inst = torch.where(is_inst, -meta - 1, s.inst)
    sp_enter = torch.where(is_inst, sp, s.sp_enter)
    # Popping below the instance-entry height returns the lane to world
    # space (every entry at or above it is BLAS-local).
    exited = need_pop & (s.inst >= 0) & (sp_after < sp_enter)
    inst = torch.where(exited | (need_pop & ~has), torch.full_like(inst, -1), inst)
    new_ptr = torch.where(is_inst, row_i[:, 16], new_ptr)
    new_pend = torch.where(is_inst, full, new_pend)
    return out._replace(
        ptr=torch.where(live, new_ptr, s.ptr),
        pend=torch.where(live, new_pend, s.pend),
        sp=torch.where(live, sp_after, s.sp),
        inst=torch.where(live, inst, s.inst),
        hit_inst=torch.where(improved, s.inst, s.hit_inst),
        sp_enter=torch.where(live, sp_enter, s.sp_enter),
        local_o=torch.where(e3, lo3, s.local_o),
        local_d=torch.where(e3, ld3, s.local_d),
        local_inv=torch.where(e3, safe_rcp(ld3), s.local_inv),
    )


def arrival_steps8(nodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor, inv: torch.Tensor,
                   s: Wide8State, steps: int, live: torch.Tensor | None = None,
                   stop_on_found: torch.Tensor | None = None,
                   has_instances: bool = False) -> Wide8State:
    """``steps`` calls of ``arrival_step8``, each with ``active = live &
    ~(stop_on_found & found)`` from the state before it (the fused
    integrator's arrivals, ``arrival_steps16``'s contract)."""
    for _ in range(steps):
        active = live
        if stop_on_found is not None:
            running = ~(stop_on_found & s.found)
            active = running if active is None else active & running
        s = arrival_step8(nodes, o, d, inv, s, active, has_instances)
    return s


def _traverse(nodes: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor, t_max,
              depth: int, has_instances: bool, any_hit: bool,
              live: torch.Tensor | None = None) -> Wide8State:
    """Arrivals until every lane in ``live`` (None: every lane) is done, or,
    with ``any_hit``, has found a hit; the loop test is read on the host
    every ``CHECK_EVERY`` arrivals (counted in ``TRAVERSE_STATS``)."""
    b, dev = origins.shape[0], origins.device
    inv = safe_rcp(directions)
    s = init_state8(b, 0.0, depth=depth, device=dev)
    s = s._replace(t=torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                                        device=dev), (b,)).clone())
    stop = torch.ones((b,), dtype=torch.bool, device=dev) if any_hit else None
    TRAVERSE_STATS["calls"] += 1
    while True:
        s = arrival_steps8(nodes, origins, directions, inv, s, CHECK_EVERY, live, stop,
                           has_instances)
        running = s.ptr >= 0
        if any_hit:
            running = running & ~s.found
        if live is not None:
            running = running & live
        TRAVERSE_STATS["host_reads"] += 1
        with span("sync.loop_test"):
            if not bool(running.any()):
                return s


def closest_hit(nodes: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor,
                depth: int, has_instances: bool = False, live: torch.Tensor | None = None):
    """Closest hit of (B, 3) rays against a wide8 table with ``depth``
    stack planes: ``(t, bary (B, 2), attribute row (-1 miss), instance)``;
    lanes outside ``live`` come back as misses."""
    s = _traverse(nodes, origins, directions, FAR_PLANE, depth, has_instances, False, live)
    return s.t, torch.stack([s.u, s.v], dim=-1), s.tri, s.hit_inst


def occluded(nodes: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor,
             t_max: torch.Tensor, depth: int, has_instances: bool = False,
             live: torch.Tensor | None = None) -> torch.Tensor:
    """Whether each ray hits anything before its ``t_max`` (B,)."""
    return _traverse(nodes, origins, directions, t_max, depth, has_instances, True, live).found
