"""wide16 stack traversal in plain PyTorch (``ops/traverse_wide16.py`` of
the reference).

``arrival_step16`` is one traversal step per lane on the row ``nodes[ptr]``:
an inner row slab-tests its 16 quantized child boxes, descends to the
nearest hit child and pushes the rest as (row, remaining-mask) on the
lane's register stack (a single survivor is pushed as a direct pointer,
mask 0); a leaf row runs Möller-Trumbore on its up to 16 f16 triangles (8
on the 48-float rows of leaf8 tables) and keeps the closest hit; then the
lane pops.  With ``has_instances`` an instance row (two-level tables)
takes the lane into the instance's space: the ray goes through the row's
world-to-local 3x4 (unnormalized direction, so ``t`` stays in world
units, ``tlas.hlsl:131-135``), the lane jumps to the BLAS root and
records the stack height; popping below that height returns it to world
space.  It is the independent plain twin of the CUDA arrival kernels
(``ops/cuda_arrival.py``).  ``arrival_steps16`` applies it a number of
times, each arrival on the lanes still running, and writes the result
into the state's tensors: the plain version of the multi-arrival kernels.

``prestep16`` runs the first two inner levels of fresh segments from the
root row and the host slot table, without row gathers.  It reads only
words below 48 of the rows, so it serves both row widths.

``closest_hit`` and ``occluded`` trace whole rays to the end with the
multi-arrival wrapper (the kernel on CUDA tensors, the plain version on
the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from unity_webgpu_pathtracer_torch.accel.wide16 import LEAF8, OFF_IDX, OFF_IDX8, ROW, WIDTH
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE, safe_rcp
from unity_webgpu_pathtracer_torch.utils.profiling import span

DONE = -1
FULL = 0xFFFF
# Möller-Trumbore determinant cut-off and minimum hit distance
# (ops/intersect.py of the reference).
DET_EPS = 1e-7
T_MIN = 1e-4
# Arrivals between two host reads of the loop test in ``closest_hit`` and
# ``occluded``.
CHECK_EVERY = 8


class Wide16State(NamedTuple):
    ptr: torch.Tensor         # (B,) int32 current row; DONE when finished
    pend: torch.Tensor        # (B,) int32 pending-children mask (FULL = fresh)
    sp: torch.Tensor          # (B,) int32 stack height
    stack_row: torch.Tensor   # (D, B) int32 row (or direct child pointer)
    stack_mask: torch.Tensor  # (D, B) int32 remaining mask (0 = direct)
    t: torch.Tensor           # (B,) float32 best hit distance
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor         # (B,) int32 attribute row of the best hit (-1 none)
    found: torch.Tensor       # (B,) bool
    # Instance registers, read and written only with has_instances.
    inst: torch.Tensor        # (B,) int32 current instance (-1 = world space)
    hit_inst: torch.Tensor    # (B,) int32 instance of the best hit
    sp_enter: torch.Tensor    # (B,) int32 stack height at instance entry
    local_o: torch.Tensor     # (3, B) float32 instance-local ray planes
    local_d: torch.Tensor
    local_inv: torch.Tensor


def init_state16(b: int, t_max: float, ptr0: int = 0, depth: int = 20, *,
                 device) -> Wide16State:
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    z3 = torch.zeros((3, b), **f32)
    return Wide16State(
        ptr=torch.full((b,), ptr0, **i32),
        pend=torch.full((b,), FULL, **i32),
        sp=torch.zeros((b,), **i32),
        stack_row=torch.zeros((depth, b), **i32),
        stack_mask=torch.zeros((depth, b), **i32),
        t=torch.full((b,), t_max, **f32),
        u=torch.zeros((b,), **f32),
        v=torch.zeros((b,), **f32),
        tri=torch.full((b,), -1, **i32),
        found=torch.zeros((b,), dtype=torch.bool, device=device),
        inst=torch.full((b,), -1, **i32),
        hit_inst=torch.full((b,), -1, **i32),
        sp_enter=torch.zeros((b,), **i32),
        local_o=z3, local_d=z3.clone(), local_inv=z3.clone(),
    )


def _perm_q(device) -> torch.Tensor:
    """accel.wide16.PERM_Q (slot -> child-box byte position) on ``device``."""
    s = torch.arange(16, device=device)
    return 4 * (s % 4) + s // 4


def _perm_h(slots: int, device) -> torch.Tensor:
    """accel.wide16.PERM_H_POS (16 slots) or PERM_H8_POS (8): slot -> leaf
    halfword position."""
    s = torch.arange(slots, device=device)
    half = slots // 2
    return torch.where(s < half, 2 * s, 2 * (s - half) + 1)


def _scales(eword: torch.Tensor) -> torch.Tensor:
    """Per-axis power-of-two box scales from the exponent word (B, 3)."""
    return torch.stack([(((eword >> (8 * c)) & 0xFF) << 23).view(torch.float32)
                        for c in range(3)], dim=-1)


def _slab(anchor, scale, qlo, qhi, o, inv, t_cap):
    """Slab test of 16 boxes ``anchor + q * scale``: (t_near, t_far)."""
    t_near = torch.zeros((o.shape[0], 16), dtype=torch.float32, device=o.device)
    t_far = t_cap[:, None].expand(o.shape[0], 16)
    for c in range(3):
        lo = anchor[..., c:c + 1] + qlo[..., 16 * c:16 * c + 16] * scale[..., c:c + 1]
        hi = anchor[..., c:c + 1] + qhi[..., 16 * c:16 * c + 16] * scale[..., c:c + 1]
        tl = (lo - o[:, c:c + 1]) * inv[:, c:c + 1]
        th = (hi - o[:, c:c + 1]) * inv[:, c:c + 1]
        t_near = torch.maximum(t_near, torch.minimum(tl, th))
        t_far = torch.minimum(t_far, torch.maximum(tl, th))
    return t_near, t_far


def _pick(hit: torch.Tensor, t_near: torch.Tensor, ptrs: torch.Tensor):
    """Nearest hit child (first minimum) and the push entry for the rest:
    ``(first_slot, any_hit, child_ptr, remaining_mask, one_left,
    direct_ptr)``."""
    iota = torch.arange(16, dtype=torch.int32, device=hit.device)[None, :]
    tn = torch.where(hit, t_near, torch.full_like(t_near, float("inf")))
    first = torch.argmin(tn, dim=1).to(torch.int32)
    onehot = iota == first[:, None]
    zero = torch.zeros_like(ptrs)
    child_ptr = torch.where(onehot, ptrs, zero).sum(dim=1, dtype=torch.int32)
    rembits = hit & ~onehot
    remaining = torch.where(rembits, 1 << iota, zero).sum(dim=1, dtype=torch.int32)
    one_left = rembits.sum(dim=1) == 1
    direct_ptr = torch.where(rembits, ptrs, zero).sum(dim=1, dtype=torch.int32)
    return first, hit.any(dim=1), child_ptr, remaining, one_left, direct_ptr


def _bf16_halves(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 words as (B, 2W) f32, each halfword (low first) the
    top half of an f32: a bf16 decode of the bits."""
    return torch.stack([(words << 16).view(torch.float32),
                        (words & -65536).view(torch.float32)], -1).flatten(1)


def _push(stack_row, stack_mask, level, do_push, entry_row, entry_mask):
    levels = torch.arange(stack_row.shape[0], device=level.device)[:, None]
    at = (levels == level[None, :]) & do_push[None, :]
    return (torch.where(at, entry_row[None, :], stack_row),
            torch.where(at, entry_mask[None, :], stack_mask))


def arrival_step16(nodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                   inv: torch.Tensor, s: Wide16State,
                   active: torch.Tensor | None = None,
                   has_instances: bool = False, *, rows: torch.Tensor | None = None,
                   bf16_leaf: bool = False) -> Wide16State:
    """One arrival for every lane; ``o``/``d``/``inv`` are the world ray,
    (B, 3).  ``nodes`` is (N, 96) or leaf8 (N, 48).  The bf16 leaf probe
    alone sets ``rows``, the (B,) row each live lane reads in place of
    ``s.ptr``, and ``bf16_leaf``, which decodes the leaf halfwords as the
    top half of an f32 instead of as f16."""
    nodes_i = nodes.view(torch.int32)
    live = s.ptr >= 0
    if active is not None:
        live = live & active
    idx = torch.where(live, s.ptr, torch.zeros_like(s.ptr)).long()
    at = idx if rows is None else torch.where(live, rows, torch.zeros_like(rows)).long()
    row = nodes[at]                                              # (B, 96 or 48)
    row_i = nodes_i[at]
    meta = row_i[:, 3]
    is_leaf = live & (meta > 0)
    is_inner = live & (meta == 0)
    anchor = row[:, 0:3]
    o_w, d_w = o, d
    if has_instances:
        # Lanes inside a BLAS trace their instance-local ray.
        in_blas = (s.inst >= 0)[:, None]
        o = torch.where(in_blas, s.local_o.T, o)
        d = torch.where(in_blas, s.local_d.T, d)
        inv = torch.where(in_blas, s.local_inv.T, inv)

    # ---- inner: decode 16 quantized child boxes, slab-test ----
    qbytes = row_i[:, 8:32].contiguous().view(torch.uint8).to(torch.float32)  # (B, 96)
    perm_q = _perm_q(nodes.device)
    qlo = torch.cat([qbytes[:, 16 * c:16 * c + 16][:, perm_q] for c in range(3)], 1)
    qhi = torch.cat([qbytes[:, 48 + 16 * c:64 + 16 * c][:, perm_q] for c in range(3)], 1)
    t_near, t_far = _slab(anchor, _scales(row_i[:, 4]), qlo, qhi, o, inv, s.t)
    ptrs = row_i[:, 32:48]
    iota = torch.arange(16, dtype=torch.int32, device=nodes.device)[None, :]
    pbits = (s.pend[:, None] >> iota) & 1
    hit = (t_near <= t_far) & (ptrs >= 0) & (pbits > 0)
    _, any_hit, child_ptr, remaining, one_left, direct_ptr = _pick(hit, t_near, ptrs)
    found_child = is_inner & any_hit
    push = found_child & (remaining > 0)
    entry_row = torch.where(one_left, direct_ptr, idx.to(torch.int32))
    entry_mask = torch.where(one_left, torch.zeros_like(remaining), remaining)
    stack_row, stack_mask = _push(s.stack_row, s.stack_mask, s.sp, push,
                                  entry_row, entry_mask)
    sp = s.sp + push.to(torch.int32)

    # ---- leaf: f16 anchored triangles, Möller-Trumbore ----
    slots, off_idx = (WIDTH, OFF_IDX) if nodes.shape[1] == ROW else (LEAF8, OFF_IDX8)
    if bf16_leaf:
        halves = _bf16_halves(row_i[:, 4:4 + 9 * slots // 2])
    else:
        halves = (row[:, 4:4 + 9 * slots // 2].contiguous().view(torch.float16)
                  .to(torch.float32))                            # (B, 9 * slots)
    perm_h = _perm_h(slots, nodes.device)
    comp = [halves[:, slots * c:slots * c + slots][:, perm_h] for c in range(9)]
    e2x, e2y, e2z, e1x, e1y, e1z = comp[:6]
    v0x = comp[6] + anchor[:, 0:1]
    v0y = comp[7] + anchor[:, 1:2]
    v0z = comp[8] + anchor[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
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
        is_leaf[:, None] & (iota[:, :slots] < meta[:, None])
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
    tri_new = torch.where(improved, row_i[:, off_idx:off_idx + slots].gather(1, best)[:, 0],
                          s.tri)
    found_new = s.found | improved

    # ---- pop ----
    need_pop = (is_inner & ~found_child) | is_leaf
    has = sp > 0
    top = (sp - 1).clamp_min(0).long()[None, :]
    top_row = stack_row.gather(0, top)[0]
    top_mask = stack_mask.gather(0, top)[0]
    pop_ptr = torch.where(has, top_row, torch.full_like(top_row, DONE))
    full = torch.full_like(top_mask, FULL)
    pop_pend = torch.where(top_mask == 0, full, top_mask)
    sp_after = torch.where(need_pop & has, sp - 1, sp)
    new_ptr = torch.where(found_child, child_ptr,
                          torch.where(need_pop, pop_ptr, s.ptr))
    new_pend = torch.where(found_child, full,
                           torch.where(need_pop, torch.where(has, pop_pend, full),
                                       s.pend))
    out = s._replace(stack_row=stack_row, stack_mask=stack_mask,
                     t=t_new, u=u_new, v=v_new, tri=tri_new, found=found_new)
    if not has_instances:
        return out._replace(ptr=torch.where(live, new_ptr, s.ptr),
                            pend=torch.where(live, new_pend, s.pend),
                            sp=torch.where(live, sp_after, s.sp))

    # ---- instance row: enter instance space, jump to the BLAS root ----
    is_inst = live & (meta < 0)
    w2l = row[:, 4:16]
    lo3 = torch.stack([w2l[:, 4 * c] * o_w[:, 0] + w2l[:, 4 * c + 1] * o_w[:, 1]
                       + w2l[:, 4 * c + 2] * o_w[:, 2] + w2l[:, 4 * c + 3]
                       for c in range(3)])                       # (3, B)
    ld3 = torch.stack([w2l[:, 4 * c] * d_w[:, 0] + w2l[:, 4 * c + 1] * d_w[:, 1]
                       + w2l[:, 4 * c + 2] * d_w[:, 2] for c in range(3)])
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
        hit_inst=torch.where(improved, s.inst, s.hit_inst),   # the instance before entry
        sp_enter=torch.where(live, sp_enter, s.sp_enter),
        local_o=torch.where(e3, lo3, s.local_o),
        local_d=torch.where(e3, ld3, s.local_d),
        local_inv=torch.where(e3, safe_rcp(ld3), s.local_inv),
    )


def arrival_steps16(nodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                    inv: torch.Tensor, s: Wide16State, steps: int,
                    live: torch.Tensor | None = None,
                    stop_on_found: torch.Tensor | None = None,
                    has_instances: bool = False) -> Wide16State:
    """``steps`` calls of ``arrival_step16``, each with ``active = live &
    ~(stop_on_found & found)`` taken from the state before it (``live``
    None: every lane; ``stop_on_found`` None: no lane stops), written into
    ``s``'s tensors, which are returned.  ``o``/``d``/``inv`` are (B, 3)."""
    cur = s
    for _ in range(steps):
        active = live
        if stop_on_found is not None:
            running = ~(stop_on_found & cur.found)
            active = running if active is None else active & running
        cur = arrival_step16(nodes, o, d, inv, cur, active, has_instances)
    for name in s._fields:
        if getattr(cur, name) is not getattr(s, name):
            getattr(s, name).copy_(getattr(cur, name))
    return s


def prestep16(nodes: torch.Tensor, top: torch.Tensor, o: torch.Tensor,
              d: torch.Tensor, inv: torch.Tensor, s: Wide16State,
              mask: torch.Tensor) -> Wide16State:
    """Gather-free first one or two arrivals for fresh lanes.

    ``mask`` selects fresh lanes (ptr == 0, pend == FULL, sp == 0, world
    space).  Level 1 slab-tests the root's children from the root row;
    level 2 takes the chosen child's decoded fields from the slot table
    ``top`` (skipped when ``top`` is the (1, 119) placeholder, as for
    instanced scenes, whose level-1 children may be instance rows: the
    next arrival enters them).  Lanes with no grandchild
    hit stay at the child row, where the next arrival repeats the test.
    ``o``/``d``/``inv`` are (B, 3)."""
    b = s.ptr.shape[0]
    dev = nodes.device
    row0 = nodes[0]
    row0_i = row0.view(torch.int32)
    mask = mask & (row0_i[3] == 0)
    qb0 = torch.stack([(row0_i[8:32] >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    qb0 = qb0.reshape(6, 16)[:, _perm_q(dev)]
    qb0 = qb0.reshape(96).to(torch.float32)
    ptrs0 = row0_i[32:48][None, :].expand(b, 16)

    t_near, t_far = _slab(row0[None, 0:3], _scales(row0_i[4:5]),
                          qb0[None, :48], qb0[None, 48:], o, inv, s.t)
    hit = (t_near <= t_far) & (ptrs0 >= 0)
    slot1, any1, child_ptr, remaining, one_left, direct_ptr = _pick(hit, t_near, ptrs0)
    found1 = mask & any1
    push1 = found1 & (remaining > 0)
    entry_row = torch.where(one_left, direct_ptr, torch.zeros_like(direct_ptr))
    entry_mask = torch.where(one_left, torch.zeros_like(remaining), remaining)
    zero = torch.zeros_like(s.sp)
    stack_row, stack_mask = _push(s.stack_row, s.stack_mask, zero, push1,
                                  entry_row, entry_mask)
    sp = torch.where(mask, push1.to(torch.int32), s.sp)
    ptr = torch.where(mask, torch.where(found1, child_ptr,
                                        torch.full_like(child_ptr, DONE)), s.ptr)

    if top.shape[0] == 16:
        acc = top[slot1.long()]                                         # (B, 119)
        l2 = found1 & (acc[:, 118] == 0.0)
        t_near, t_far = _slab(acc[:, 0:3], acc[:, 3:6], acc[:, 6:54],
                              acc[:, 54:102], o, inv, s.t)
        cptrs = acc[:, 102:118].to(torch.int32)
        hit2 = (t_near <= t_far) & (cptrs >= 0)
        _, any2, gchild, remaining2, one_left2, direct2 = _pick(hit2, t_near, cptrs)
        found2 = l2 & any2
        push2 = found2 & (remaining2 > 0)
        entry_row2 = torch.where(one_left2, direct2, child_ptr)
        entry_mask2 = torch.where(one_left2, torch.zeros_like(remaining2), remaining2)
        stack_row, stack_mask = _push(stack_row, stack_mask, sp, push2 & l2,
                                      entry_row2, entry_mask2)
        sp = sp + (push2 & l2).to(torch.int32)
        ptr = torch.where(l2 & found2, gchild, ptr)

    return s._replace(ptr=ptr, sp=sp, stack_row=stack_row, stack_mask=stack_mask)


def _traverse(nodes: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor,
              t_max, depth: int, has_instances: bool, any_hit: bool,
              live: torch.Tensor | None = None) -> Wide16State:
    """Arrivals until every lane in ``live`` (None: every lane) is done
    (or, with ``any_hit``, has found a hit), ``CHECK_EVERY`` to a launch,
    the test read on the host after each (counted in ``TRAVERSE_STATS``);
    the arrivals past a lane's end leave it unchanged, and lanes outside
    ``live`` keep their initial registers (a miss)."""
    from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_steps16_cuda

    b, dev = origins.shape[0], origins.device
    oT, dT = origins.T.contiguous(), directions.T.contiguous()
    invT = safe_rcp(dT)
    s = init_state16(b, 0.0, depth=depth, device=dev)
    s.t.copy_(torch.as_tensor(t_max, dtype=torch.float32, device=dev))
    stop = torch.ones((b,), dtype=torch.bool, device=dev) if any_hit else None
    TRAVERSE_STATS["calls"] += 1
    while True:
        arrival_steps16_cuda(nodes, oT, dT, invT, s, CHECK_EVERY, live, stop, has_instances)
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
    """Closest hit of (B, 3) rays against a wide16 table with ``depth``
    stack planes: ``(t, bary (B, 2), attribute row (-1 miss), instance)``
    (the reference's ``traverse_wide16.closest_hit``); lanes outside
    ``live`` (None: every lane) are not traced and come back as misses."""
    s = _traverse(nodes, origins, directions, FAR_PLANE, depth, has_instances, False, live)
    return s.t, torch.stack([s.u, s.v], dim=-1), s.tri, s.hit_inst


def occluded(nodes: torch.Tensor, origins: torch.Tensor, directions: torch.Tensor,
             t_max: torch.Tensor, depth: int, has_instances: bool = False,
             live: torch.Tensor | None = None) -> torch.Tensor:
    """Whether each ray hits anything before its ``t_max`` (B,); lanes
    outside ``live`` are not traced (False)."""
    return _traverse(nodes, origins, directions, t_max, depth, has_instances, True, live).found


# Traversals run by ``closest_hit``/``occluded`` and host reads of their
# loop test in this process (reset by the caller).
TRAVERSE_STATS = {"calls": 0, "host_reads": 0}
