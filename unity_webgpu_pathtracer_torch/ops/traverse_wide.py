"""Fat-row 4-ary stackless traversal in plain PyTorch
(``ops/traverse_wide.py`` of the reference), over ``accel/wide.py`` and
``accel/tlas.py`` tables.

A lane's state is one row pointer into its ray's octant order.  An
arrival reads one 48-float row: at an inner row it slab-tests the four
children and jumps to the first hit one in stored (near-first) order, or
to the row's skip; at a leaf it intersects the inline triangles and jumps
to the skip.  Siblings hit at an arrival are reached later through the
skip chain.  ``ptr >= N`` is done.  On a two-level table an instance row
(count < 0) takes the lane into the instance's space (world-to-local
origin, unnormalized direction, so ``t`` holds in both spaces) and into
the BLAS rows; leaving the BLAS region returns it to world space at the
instance row's skip.

``arrival_step`` is one arrival, the fused integrator's; ``closest_hit``
and ``occluded`` loop it, the test read on the host every
``CHECK_EVERY`` arrivals (counted in ``TRAVERSE_STATS``).  ``tri`` is the
attribute row itself (the leaves inline it), which ``tri_index`` (the
identity on these tables) maps to itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from unity_webgpu_pathtracer_torch.ops.traverse_mbvh import take_best
from unity_webgpu_pathtracer_torch.ops.traverse_wide8 import octant_index
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import CHECK_EVERY, DET_EPS, T_MIN
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE, safe_rcp
from unity_webgpu_pathtracer_torch.utils.profiling import span

TRAVERSE_STATS = {"calls": 0, "host_reads": 0}


class WideState(NamedTuple):
    ptr: torch.Tensor        # (B,) int32 row in the lane's order; >= N done
    t: torch.Tensor          # (B,) float32 best distance
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor        # (B,) int32 attribute row of the best hit (-1 none)
    found: torch.Tensor      # (B,) bool
    inst: torch.Tensor       # (B,) int32 current instance (-1 = world space)
    hit_inst: torch.Tensor   # (B,) int32 instance of the best hit
    resume: torch.Tensor     # (B,) int32 TLAS row to resume at
    blas_end: torch.Tensor   # (B,) int32 end of the current BLAS region
    local_o: torch.Tensor    # (B, 3) instance-local ray
    local_d: torch.Tensor
    local_inv: torch.Tensor


def init_state(b: int, t_max: float, ptr0: int = 0, *, device) -> WideState:
    i32 = dict(dtype=torch.int32, device=device)
    z3 = torch.zeros((b, 3), dtype=torch.float32, device=device)
    return WideState(
        ptr=torch.full((b,), ptr0, **i32),
        t=torch.full((b,), t_max, dtype=torch.float32, device=device),
        u=torch.zeros((b,), dtype=torch.float32, device=device),
        v=torch.zeros((b,), dtype=torch.float32, device=device),
        tri=torch.full((b,), -1, **i32),
        found=torch.zeros((b,), dtype=torch.bool, device=device),
        inst=torch.full((b,), -1, **i32),
        hit_inst=torch.full((b,), -1, **i32),
        resume=torch.zeros((b,), **i32),
        blas_end=torch.zeros((b,), **i32),
        local_o=z3, local_d=z3.clone(), local_inv=z3.clone(),
    )


def slab4(row: torch.Tensor, o: torch.Tensor, inv: torch.Tensor, t_cur: torch.Tensor):
    """Hits of four SoA child boxes ``row[:, 0:24]`` before ``t_cur``."""
    t_near = torch.zeros_like(row[:, 0:4])
    t_far = t_cur[:, None].expand(t_near.shape)
    for ax in range(3):
        lo = (row[:, 4 * ax:4 * ax + 4] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        hi = (row[:, 12 + 4 * ax:16 + 4 * ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t_near = torch.maximum(t_near, torch.minimum(lo, hi))
        t_far = torch.minimum(t_far, torch.maximum(lo, hi))
    return t_near <= t_far


def leaf4(row: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """Möller-Trumbore of (B, 3) rays against the four SoA triangles of
    ``row[:, 0:36]``: ``(tt, uu, vv, a)``, each (B, 4), unmasked."""
    comp = [row[:, 4 * i:4 * i + 4] for i in range(9)]
    e2x, e2y, e2z, e1x, e1y, e1z, v0x, v0y, v0z = comp
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
    return tt, uu, vv, a


def leaf4_hits(row: torch.Tensor, row_i: torch.Tensor, cnt: torch.Tensor, lanes_ok: torch.Tensor,
               o: torch.Tensor, d: torch.Tensor, t_cur: torch.Tensor):
    """``leaf4`` masked to the row's first ``cnt`` triangles on the lanes in
    ``lanes_ok`` and to hits before ``t_cur``: ``(tt, uu, vv, attribute
    rows)``, ``tt`` the far plane where there is none."""
    tt, uu, vv, a = leaf4(row, o, d)
    k = torch.arange(4, dtype=torch.int32, device=row.device)[None, :]
    valid = (lanes_ok[:, None] & (k < cnt[:, None]) & (torch.abs(a) > DET_EPS)
             & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0) & (uu + vv <= 1.0)
             & (tt > T_MIN) & (tt < t_cur[:, None]))
    return torch.where(valid, tt, torch.full_like(tt, FAR_PLANE)), uu, vv, row_i[:, 36:40]


def to_instance(w2l: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """World (B, 3) rays into instance space by (B, 12) row-major 3x4
    world-to-local rows; the direction unnormalized."""
    lo3 = torch.stack([w2l[:, 4 * c] * o[:, 0] + w2l[:, 4 * c + 1] * o[:, 1]
                       + w2l[:, 4 * c + 2] * o[:, 2] + w2l[:, 4 * c + 3] for c in range(3)], dim=-1)
    ld3 = torch.stack([w2l[:, 4 * c] * d[:, 0] + w2l[:, 4 * c + 1] * d[:, 1]
                       + w2l[:, 4 * c + 2] * d[:, 2] for c in range(3)], dim=-1)
    return lo3, ld3


def arrival_step(nodes_flat: torch.Tensor, n_nodes: int, base: torch.Tensor, o: torch.Tensor,
                 d: torch.Tensor, inv: torch.Tensor, s: WideState,
                 active: torch.Tensor | None = None,
                 inst_w2l: torch.Tensor | None = None) -> WideState:
    """One arrival for every lane (masked by ``active`` and the pointer's
    bound) on ``(O * N, 48)`` rows, ``base`` each lane's order's first row;
    ``o``/``d``/``inv`` the world ray (B, 3).  With ``inst_w2l`` (two-level
    tables) instance rows switch lanes into instance space."""
    live = s.ptr < n_nodes
    if active is not None:
        live = live & active
    row = nodes_flat[(base + torch.where(live, s.ptr, torch.zeros_like(s.ptr))).long()]
    row_i = row.view(torch.int32)
    skip, cnt = row_i[:, 44], row_i[:, 45]
    is_leaf = cnt > 0
    if inst_w2l is not None:
        in_blas = (s.inst >= 0)[:, None]
        o = torch.where(in_blas, s.local_o, o)
        d = torch.where(in_blas, s.local_d, d)
        inv = torch.where(in_blas, s.local_inv, inv)

    # ---- inner: the first hit child in stored order, else the skip ----
    hit = slab4(row, o, inv, s.t)
    ptrs = row_i[:, 24:28]
    nxt = skip
    for k in (3, 2, 1, 0):
        nxt = torch.where(hit[:, k] & (ptrs[:, k] > 0), ptrs[:, k], nxt)

    # ---- leaf: the inline triangles ----
    tt, uu, vv, attrs = leaf4_hits(row, row_i, cnt, is_leaf & live, o, d, s.t)
    out, improved = take_best(s, tt, uu, vv, attrs, "tri")
    out = out._replace(found=s.found | improved)
    new_ptr = torch.where(is_leaf, skip, nxt)
    if inst_w2l is None:
        return out._replace(ptr=torch.where(live, new_ptr, s.ptr))

    # ---- instance row: into instance space and the BLAS ----
    is_inst = cnt < 0
    inst_id = torch.where(is_inst, -cnt - 1, torch.zeros_like(cnt))
    blas_ptr, blas_len = row_i[:, 24], row_i[:, 25]
    lo3, ld3 = to_instance(inst_w2l[inst_id.long()], o, d)
    enter = live & is_inst
    e3 = enter[:, None]
    inst = torch.where(enter, inst_id, s.inst)
    resume = torch.where(enter, skip, s.resume)
    blas_end = torch.where(enter, blas_ptr + blas_len, s.blas_end)
    new_ptr = torch.where(is_inst, blas_ptr, new_ptr)
    # ---- the pointer left the BLAS region: back to the TLAS ----
    exited = live & (inst >= 0) & (new_ptr >= blas_end)
    new_ptr = torch.where(exited, resume, new_ptr)
    inst = torch.where(exited, torch.full_like(inst, -1), inst)
    return out._replace(
        ptr=torch.where(live, new_ptr, s.ptr),
        inst=torch.where(live, inst, s.inst),
        hit_inst=torch.where(improved, s.inst, s.hit_inst),
        resume=resume, blas_end=blas_end,
        local_o=torch.where(e3, lo3, s.local_o),
        local_d=torch.where(e3, ld3, s.local_d),
        local_inv=torch.where(e3, safe_rcp(ld3), s.local_inv),
    )


def _traverse(nodes: torch.Tensor, inst_w2l: torch.Tensor, origins: torch.Tensor,
              directions: torch.Tensor, t_max, any_hit: bool,
              live: torch.Tensor | None = None) -> WideState:
    """Arrivals until no lane of ``live`` (None: every lane) is left (or,
    with ``any_hit``, all have a hit); lanes outside ``live`` start done."""
    b, dev = origins.shape[0], origins.device
    n_orders, n_nodes = nodes.shape[0], nodes.shape[1]
    nodes_flat = nodes.reshape(n_orders * n_nodes, nodes.shape[2])
    base = torch.remainder(octant_index(directions), n_orders) * n_nodes
    inv = safe_rcp(directions)
    w2l = inst_w2l if inst_w2l.shape[0] > 0 else None
    s = init_state(b, 0.0, device=dev)
    s = s._replace(t=torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev),
                                        (b,)).clone())
    if live is not None:
        s = s._replace(ptr=torch.where(live, s.ptr, torch.full_like(s.ptr, n_nodes)))
    TRAVERSE_STATS["calls"] += 1
    while True:
        for _ in range(CHECK_EVERY):
            s = arrival_step(nodes_flat, n_nodes, base, origins, directions, inv, s,
                             ~s.found if any_hit else None, w2l)
        running = s.ptr < n_nodes
        if any_hit:
            running = running & ~s.found
        TRAVERSE_STATS["host_reads"] += 1
        with span("sync.loop_test"):
            if not bool(running.any()):
                return s


def closest_hit(nodes: torch.Tensor, inst_w2l: torch.Tensor, origins: torch.Tensor,
                directions: torch.Tensor, live: torch.Tensor | None = None):
    """Closest hit of (B, 3) rays against (O, N, 48) rows: ``(t, bary (B,
    2), attribute row (-1 miss), instance)``; lanes outside ``live`` come
    back as misses."""
    s = _traverse(nodes, inst_w2l, origins, directions, FAR_PLANE, False, live)
    return s.t, torch.stack([s.u, s.v], dim=-1), s.tri, s.hit_inst


def occluded(nodes: torch.Tensor, inst_w2l: torch.Tensor, origins: torch.Tensor,
             directions: torch.Tensor, t_max: torch.Tensor,
             live: torch.Tensor | None = None) -> torch.Tensor:
    """Whether each ray hits anything before its ``t_max`` (B,)."""
    return _traverse(nodes, inst_w2l, origins, directions, t_max, True, live).found
