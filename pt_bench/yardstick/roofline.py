"""Peaks, bounds and K1's work: the yardstick of the roofline metrics.

Frozen from ``unity_webgpu_pathtracer_torch/experiments/_common.py``
(``PEAK_BYTES``, ``PEAK_F32``, ``PEAK_BF16``, ``K1_OPS_*``, ``bound``,
``_k1_ops``, ``running``, ``arrivals_work``) and
``ops/cuda_arrival.py`` (``_FLAT_FIELDS``, ``_INST_FIELDS``) at commit
628fc1bc0151d37c4767d2275c25b153616afc0d.  ``traversal_work`` is the
benchmark's own: the launches of one ``closest_hit`` traversal, each
counted by ``arrivals_work``.
"""

from __future__ import annotations

import torch

from pt_bench.reference.vmath import FAR_PLANE, safe_rcp
from pt_bench.yardstick.wide16_plain import arrival_step16, init_state16

# H100 SXM rates: HBM bytes/s (NVIDIA's data sheet); f32 and packed bf16
# operations without tensor cores at the card's issue rate, 132 SMs x 128
# lanes x 1.98 GHz.  Every kernel is built with -fmad=false, so an add and
# a multiply are one instruction each, not one FMA counted as two
# operations (the data sheet's 67 TFLOP/s).
PEAK_BYTES = 3.35e12
PEAK_F32 = 132 * 128 * 1.98e9
PEAK_BF16 = 2 * PEAK_F32
# f32 operations per lane of K1, counted from csrc/arrival16.cu: the 16
# slab tests of an inner row (36 each), one Moller-Trumbore test per leaf
# triangle, the world-to-local transform of an instance row.
K1_OPS_INNER, K1_OPS_TRI, K1_OPS_INST = 576, 55, 30
# The state K1 reads and writes (ops/cuda_arrival.py).
_FLAT_FIELDS = ("ptr", "pend", "sp", "stack_row", "stack_mask", "t", "u", "v", "tri",
                "found")
_INST_FIELDS = ("inst", "hit_inst", "sp_enter", "local_o", "local_d", "local_inv")
# Arrivals a K1 launch in closest_hit/occluded (traverse_wide16.CHECK_EVERY).
CHECK_EVERY = 8


def bound(nbytes: float, ops: float, bf16_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of traffic, ``ops`` f32
    operations and ``bf16_ops`` bf16 lane-operations on an H100, and which
    of bytes and operations binds."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (ops / PEAK_F32 + bf16_ops / PEAK_BF16) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _k1_ops(meta: torch.Tensor, slots: int, has_instances: bool) -> int:
    return (K1_OPS_INNER * int((meta == 0).sum())
            + K1_OPS_TRI * int(meta[meta > 0].clamp(max=slots).sum())
            + (K1_OPS_INST * int((meta < 0).sum()) if has_instances else 0))


def running(live, stop_on_found, s):
    """The ``active`` mask of the next arrival."""
    if stop_on_found is None:
        return live
    go = ~(stop_on_found & s.found)
    return go if live is None else live & go


def arrivals_work(nodes, oT, dT, invT, s, steps: int, live=None, stop_on_found=None,
                  has_instances: bool = False):
    """(bytes, f32 operations, the state after, counts) of one
    multi-arrival launch on state ``s``, found by running the one-arrival
    plain version on its own outputs.  Bytes: ``ptr`` and the masks of
    every lane; for each lane that steps, its scalar state read once and
    written once and its world ray planes read once (the instance-local
    planes read if it starts inside a BLAS, written if it enters one); each
    distinct row the lanes load over the ``steps`` arrivals; 8 bytes per
    stack push and per pop that reads memory (a pop right after a push
    takes its entry from registers).  Operations: K1's, summed over the
    arrivals."""
    nodes_i = nodes.view(torch.int32)
    slots = 16 if nodes.shape[1] == 96 else 8

    def stepping(st):
        act = running(live, stop_on_found, st)
        return st.ptr >= 0 if act is None else (st.ptr >= 0) & act

    start = stepping(s)
    cached = torch.zeros_like(start)
    entered = torch.zeros_like(start)
    loaded, ops, pushes, pops = [], 0, 0, 0
    cur = s
    for _ in range(steps):
        act = stepping(cur)
        r = cur.ptr[act].long()
        loaded.append(r)
        meta = nodes_i[r, 3]
        ops += _k1_ops(meta, slots, has_instances)
        nxt = arrival_step16(nodes, oT.T, dT.T, invT.T, cur, act, has_instances)
        pushed = act & (nxt.sp > cur.sp)
        popped = act & (nxt.sp < cur.sp)
        pushes += int(pushed.sum())
        pops += int((popped & ~cached).sum())
        cached = pushed | (cached & ~popped)
        if has_instances:
            entered[act] |= meta < 0
        cur = nxt
    distinct = int(torch.unique(torch.cat(loaded)).numel())
    n = int(start.sum())
    scalar = sum(getattr(s, f).element_size() for f in _FLAT_FIELDS if getattr(s, f).dim() == 1)
    nbytes = (s.ptr.nbytes + sum(m.nbytes for m in (live, stop_on_found) if m is not None)
              + n * (2 * scalar - 4 + 36) + distinct * nodes.shape[1] * 4 + 8 * (pushes + pops))
    if has_instances:
        nbytes += n * 2 * 12 + 36 * int((start & (s.inst >= 0)).sum() + entered.sum())
    return nbytes, ops, cur, dict(lanes=n, pushes=pushes, pops=pops, rows=distinct)


def traversal_work(nodes, origins, directions, depth: int, has_instances: bool):
    """Bound (ms) of each K1 launch of one ``closest_hit`` over every lane
    of (B, 3) rays (``traverse_wide16._traverse``: CHECK_EVERY arrivals a
    launch until no lane runs), and what binds each."""
    b, dev = origins.shape[0], origins.device
    oT, dT = origins.T.contiguous(), directions.T.contiguous()
    invT = safe_rcp(dT)
    s = init_state16(b, FAR_PLANE, depth=depth, device=dev)
    live = torch.ones((b,), dtype=torch.bool, device=dev)
    out = []
    while True:
        nbytes, ops, s, _counts = arrivals_work(nodes, oT, dT, invT, s, CHECK_EVERY, live,
                                                None, has_instances)
        out.append(bound(nbytes, ops))
        if not bool((s.ptr >= 0).any()):
            return out
