"""Plain wide16 arrivals, the yardstick's count of K1's work.

Frozen copy of ``unity_webgpu_pathtracer_torch/ops/traverse_wide16.py``
(``Wide16State``, ``init_state16``, ``arrival_step16`` and its helpers)
at commit 628fc1bc0151d37c4767d2275c25b153616afc0d:
the plain twin that kernel K1 is exact against.  ``roofline.py`` runs it on
the inputs of K1's launches to count their rows, lanes and stack traffic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# accel/wide16.py's row layout.
ROW, WIDTH, OFF_IDX, LEAF8, OFF_IDX8 = 96, 16, 76, 8, 40
from pt_bench.reference.vmath import FAR_PLANE, safe_rcp

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
