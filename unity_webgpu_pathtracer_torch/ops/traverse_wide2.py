"""Split-table stackless traversal in plain PyTorch
(``ops/traverse_wide2.py`` of the reference), over ``accel/wide2.py``
tables.

The ``wide`` walk over the split tables: node steps read 32-float rows of
the inner table; a lane whose next code is a leaf *parks* (the leaf in
``pending``, the pointer 0), and a leaf step, one every ``LEAF_EVERY``
node steps, intersects the parked lanes' leaf rows and moves them on by
the leaf's continuation in their order (``leaf_skip``).  Position codes
are signed: ``c > 0`` inner row ``c - 1``, ``c < 0`` leaf ``-c - 1``, 0
the end.  An instance row (kind < 0) holds its BLAS region as (entry code,
inner end, leaf end), so a lane leaves the BLAS, in either index space,
at the first code past it.  The loop test is read on the host every
``CHECK_EVERY`` rounds (counted in ``TRAVERSE_STATS``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from unity_webgpu_pathtracer_torch.ops.traverse_mbvh import take_best
from unity_webgpu_pathtracer_torch.ops.traverse_wide8 import octant_index
from unity_webgpu_pathtracer_torch.ops.traverse_wide import leaf4_hits, slab4, to_instance
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import CHECK_EVERY
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE, safe_rcp
from unity_webgpu_pathtracer_torch.utils.profiling import span

LEAF_EVERY = 4

TRAVERSE_STATS = {"calls": 0, "host_reads": 0}


class Wide2State(NamedTuple):
    ptr: torch.Tensor            # (B,) int32 signed position code
    pending: torch.Tensor        # (B,) int32 parked leaf + 1 (0 = none)
    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor
    found: torch.Tensor
    inst: torch.Tensor
    hit_inst: torch.Tensor
    resume: torch.Tensor         # (B,) int32 code to resume at after the BLAS
    blas_inner_end: torch.Tensor  # (B,) int32 exclusive inner bound + 1 (code space)
    blas_leaf_end: torch.Tensor   # (B,) int32 exclusive leaf bound + 1
    local_o: torch.Tensor        # (B, 3)
    local_d: torch.Tensor
    local_inv: torch.Tensor


def entry_registers(entry: int) -> tuple[int, int]:
    """``(ptr, pending)`` of a lane at the root code ``entry``: a root leaf
    (``entry < 0``, a table of at most 4 triangles) starts parked.  The
    reference starts it at ``ptr = entry`` unparked, where neither step
    moves it, and its loop never ends."""
    return (entry, 0) if entry >= 0 else (0, -entry)


def init_state2(b: int, t_max: float, entry: int, *, device) -> Wide2State:
    i32 = dict(dtype=torch.int32, device=device)
    z3 = torch.zeros((b, 3), dtype=torch.float32, device=device)
    ptr0, pending0 = entry_registers(entry)
    return Wide2State(
        ptr=torch.full((b,), ptr0, **i32), pending=torch.full((b,), pending0, **i32),
        t=torch.full((b,), t_max, dtype=torch.float32, device=device),
        u=torch.zeros((b,), dtype=torch.float32, device=device),
        v=torch.zeros((b,), dtype=torch.float32, device=device),
        tri=torch.full((b,), -1, **i32),
        found=torch.zeros((b,), dtype=torch.bool, device=device),
        inst=torch.full((b,), -1, **i32), hit_inst=torch.full((b,), -1, **i32),
        resume=torch.zeros((b,), **i32), blas_inner_end=torch.zeros((b,), **i32),
        blas_leaf_end=torch.zeros((b,), **i32),
        local_o=z3, local_d=z3.clone(), local_inv=z3.clone(),
    )


def live2(s: Wide2State) -> torch.Tensor:
    return (s.ptr != 0) | (s.pending != 0)


def _beyond(s: Wide2State, code: torch.Tensor) -> torch.Tensor:
    """Whether ``code`` is past the lane's BLAS region (in its space)."""
    return torch.where(code > 0, code >= s.blas_inner_end,
                       torch.where(code < 0, -code >= s.blas_leaf_end,
                                   torch.ones_like(code, dtype=torch.bool)))


def _apply_exit(s: Wide2State, in_blas: torch.Tensor, code: torch.Tensor):
    exited = in_blas & _beyond(s, code)
    return (torch.where(exited, s.resume, code),
            torch.where(exited, torch.full_like(s.inst, -1), s.inst))


def node_step2(inner_flat: torch.Tensor, base: torch.Tensor, o: torch.Tensor,
               d: torch.Tensor, inv: torch.Tensor, s: Wide2State,
               active: torch.Tensor | None = None,
               inst_w2l: torch.Tensor | None = None) -> Wide2State:
    """One node step of the lanes not parked (``o``/``d``/``inv`` (B, 3))."""
    stepping = (s.ptr > 0) & (s.pending == 0)
    if active is not None:
        stepping = stepping & active
    if inst_w2l is not None:
        in_blas = (s.inst >= 0)[:, None]
        o = torch.where(in_blas, s.local_o, o)
        d = torch.where(in_blas, s.local_d, d)
        inv = torch.where(in_blas, s.local_inv, inv)
    row = inner_flat[(base + torch.where(stepping, s.ptr - 1, torch.zeros_like(s.ptr))).long()]
    row_i = row.view(torch.int32)
    skip, kind = row_i[:, 28], row_i[:, 29]
    ptrs = row_i[:, 24:28]
    hit = slab4(row, o, inv, s.t)
    nxt = skip
    for k in (3, 2, 1, 0):
        nxt = torch.where(hit[:, k] & (ptrs[:, k] != 0), ptrs[:, k], nxt)
    is_inst_row = kind < 0

    inst, resume = s.inst, s.resume
    bie, ble = s.blas_inner_end, s.blas_leaf_end
    local_o, local_d, local_inv = s.local_o, s.local_d, s.local_inv
    if inst_w2l is not None:
        inst_id = torch.where(is_inst_row, -kind - 1, torch.zeros_like(kind))
        lo3, ld3 = to_instance(inst_w2l[inst_id.long()], o, d)
        enter = stepping & is_inst_row
        e3 = enter[:, None]
        local_o = torch.where(e3, lo3, local_o)
        local_d = torch.where(e3, ld3, local_d)
        local_inv = torch.where(e3, safe_rcp(ld3), local_inv)
        inst = torch.where(enter, inst_id, inst)
        resume = torch.where(enter, skip, resume)
        bie = torch.where(enter, ptrs[:, 1], bie)
        ble = torch.where(enter, ptrs[:, 2], ble)
        nxt = torch.where(is_inst_row, ptrs[:, 0], nxt)
        nxt, inst = _apply_exit(s._replace(resume=resume, blas_inner_end=bie,
                                           blas_leaf_end=ble, inst=inst),
                                stepping & (inst >= 0), nxt)

    park = stepping & (nxt < 0)
    pending = torch.where(park, -nxt, s.pending)
    new_ptr = torch.where(stepping & ~park, nxt, s.ptr)
    new_ptr = torch.where(park, torch.zeros_like(new_ptr), new_ptr)
    return s._replace(ptr=new_ptr, pending=pending, inst=inst, resume=resume,
                      blas_inner_end=bie, blas_leaf_end=ble,
                      local_o=local_o, local_d=local_d, local_inv=local_inv)


def leaf_step2(leaf_geo: torch.Tensor, leaf_skip_flat: torch.Tensor, skip_base: torch.Tensor,
               o: torch.Tensor, d: torch.Tensor, s: Wide2State,
               active: torch.Tensor | None = None,
               inst_w2l: torch.Tensor | None = None) -> Wide2State:
    """Intersect the parked lanes' leaves and move them on by each leaf's
    continuation in the lane's order (``skip_base + leaf``)."""
    has = s.pending > 0
    if active is not None:
        has = has & active
    leaf = torch.where(has, s.pending - 1, torch.zeros_like(s.pending))
    row = leaf_geo[leaf.long()]                                  # (B, 48)
    row_i = row.view(torch.int32)
    if inst_w2l is not None:
        in_blas = (s.inst >= 0)[:, None]
        o = torch.where(in_blas, s.local_o, o)
        d = torch.where(in_blas, s.local_d, d)
    tt, uu, vv, attrs = leaf4_hits(row, row_i, row_i[:, 45], has, o, d, s.t)
    out, improved = take_best(s, tt, uu, vv, attrs, "tri")
    cont = leaf_skip_flat[(skip_base + leaf).long()]
    inst = s.inst
    if inst_w2l is not None:
        cont, inst = _apply_exit(s, has & (s.inst >= 0), cont)
    park_again = has & (cont < 0)
    zero = torch.zeros_like(cont)
    return out._replace(
        ptr=torch.where(has, torch.where(park_again, zero, cont), s.ptr),
        pending=torch.where(has, torch.where(park_again, -cont, zero), s.pending),
        found=s.found | improved,
        hit_inst=torch.where(improved, s.inst, s.hit_inst),
        inst=inst,
    )


def tables(scene):
    """``(inner_flat (O * Ni, 32), n_inner, n_orders, leaf_geo, leaf_skip
    flat (O * Nl,))`` of a scene's wide2 tables."""
    inner = scene.wide2_inner
    n_orders, n_inner = inner.shape[0], inner.shape[1]
    return (inner.reshape(n_orders * n_inner, 32), n_inner, n_orders, scene.wide2_leaf,
            scene.wide2_leaf_skip.reshape(-1))


def _traverse(scene, origins: torch.Tensor, directions: torch.Tensor, t_max, any_hit: bool,
              live: torch.Tensor | None = None) -> Wide2State:
    """Rounds of ``LEAF_EVERY`` node steps and a leaf step until no lane of
    ``live`` (None: every lane) is left (or, with ``any_hit``, all have a
    hit); lanes outside ``live`` start at the end."""
    b, dev = origins.shape[0], origins.device
    inner_flat, n_inner, n_orders, leaf_geo, skip_flat = tables(scene)
    oct_ = torch.remainder(octant_index(directions), n_orders)
    base = oct_ * n_inner
    skip_base = oct_ * leaf_geo.shape[0]
    inv = safe_rcp(directions)
    w2l = scene.inst_w2l if scene.inst_w2l.shape[0] > 0 else None
    s = init_state2(b, 0.0, scene.wide2_entry, device=dev)
    s = s._replace(t=torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=dev),
                                        (b,)).clone())
    if live is not None:
        s = s._replace(ptr=torch.where(live, s.ptr, torch.zeros_like(s.ptr)),
                       pending=torch.where(live, s.pending, torch.zeros_like(s.pending)))
    TRAVERSE_STATS["calls"] += 1
    while True:
        for _ in range(CHECK_EVERY):
            active = ~s.found if any_hit else None
            for _ in range(LEAF_EVERY):
                s = node_step2(inner_flat, base, origins, directions, inv, s, active, w2l)
            s = leaf_step2(leaf_geo, skip_flat, skip_base, origins, directions, s,
                           active, w2l)
        running = live2(s)
        if any_hit:
            running = running & ~s.found
        TRAVERSE_STATS["host_reads"] += 1
        with span("sync.loop_test"):
            if not bool(running.any()):
                return s


def closest_hit(scene, origins: torch.Tensor, directions: torch.Tensor,
                live: torch.Tensor | None = None):
    """Closest hit of (B, 3) rays against ``scene``'s wide2 tables: ``(t,
    bary (B, 2), attribute row (-1 miss), instance)``; lanes outside
    ``live`` come back as misses."""
    s = _traverse(scene, origins, directions, FAR_PLANE, False, live)
    return s.t, torch.stack([s.u, s.v], dim=-1), s.tri, s.hit_inst


def occluded(scene, origins: torch.Tensor, directions: torch.Tensor, t_max: torch.Tensor,
             live: torch.Tensor | None = None) -> torch.Tensor:
    """Whether each ray hits anything before its ``t_max`` (B,)."""
    return _traverse(scene, origins, directions, t_max, True, live).found
