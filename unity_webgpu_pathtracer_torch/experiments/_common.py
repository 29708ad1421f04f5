"""Timing, bounds and result rows shared by the probes; the bounds of K1
and K2 (``arrival_work``, ``arrivals_work``, ``transition_work``); the
capture of K1's and K2's inputs from a real pass (``capture_inputs``,
``arrival_state``) that ``chip_smoke.py``, ``k1_variants`` and
``k2_variants`` use; and the one-arrival loop (``one_step_loop``) that the
multi-arrival kernel replaced."""

from __future__ import annotations

import re
from typing import NamedTuple

import torch

from unity_webgpu_pathtracer_torch.device import resolve_device
from unity_webgpu_pathtracer_torch.ops.cuda_arrival import _FLAT_FIELDS, _INST_FIELDS

# H100 SXM rates: HBM bytes/s (NVIDIA's data sheet); f32 and packed bf16
# operations without tensor cores at the card's issue rate, 132 SMs x 128
# lanes x 1.98 GHz.  Every kernel is built with -fmad=false
# (ops/cuda_build.py), so an add and a multiply are one instruction each,
# not one FMA counted as two operations (the data sheet's 67 TFLOP/s).  A
# packed bf16x2 add, mul, min or max does two lanes' operations in one
# instruction: 66.9e12 lane-operations/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 132 * 128 * 1.98e9
PEAK_BF16 = 2 * PEAK_F32
# f32 operations per lane of K1, counted from csrc/arrival16.cu: the 16
# slab tests of an inner row (36 each), one Moller-Trumbore test per leaf
# triangle, the world-to-local transform of an instance row.
K1_OPS_INNER, K1_OPS_TRI, K1_OPS_INST = 576, 55, 30
# f32 operations of K2 (csrc/transition16.cu) by lane case, counted from
# its source (each add, multiply, divide, square root and transcendental
# one; selects and integer work none): every lane at a finished segment
# (its uniforms and radiance updates); a miss (the sky footprint, its pdf,
# the MIS weight); a shaded hit (the alias sample, its direction and pdf,
# the NEE contribution); the attribute row's normal by attr_compact (f16
# or oct decode, interpolation, normalize); the material and hit frame;
# one BSDF evaluation with its frame and lobe probabilities; the lobe
# sample; the throughput update and RR.  A lane between segments does
# integer work only (its PCG steps).
K2_OPS = dict(lane=40, miss=68, hit=50, normal={2: 36, 3: 93}, material=43, eval=622,
              sample=219, rr=14)
# f32 operations of the megakernel's shading kernel (csrc/shade16.cu) by
# lane case, counted from its source as K2_OPS is (each add, multiply,
# divide, square root, transcendental, floor, minimum and maximum one;
# selects, comparisons and integer work none), with K2's counts for the
# BSDF code the two kernels share (shade_common.cuh): every lane alive at
# the bounce's start (its uniforms, the radiance sums the plain code adds,
# zeros included); a lane not shaded (its zero NEE sum); a miss (the sky's
# direction, bilinear lookup, pdf and MIS); a hit (the normal's
# interpolation and normalize, the position, the material, the emission);
# a hit inside an instance (the normal's transform and normalize); a shaded
# lane (the env sample's texel, direction and pdf, the shadow ray, one BSDF
# evaluation with its frame and lobe probabilities, the NEE terms, the lobe
# sample, a second evaluation (K2_OPS["eval"] less its frame, its
# probabilities and its two local transforms, 453), the world direction,
# the throughput, the continued ray and Russian roulette).
SHADE_OPS = dict(lane=13, unshaded=3, miss=74, hit=61, inst=26, shade=1446)


# Calls of the timed function captured back to back in one CUDA graph.
CALLS = 20


def cuda_device(device=None) -> torch.device:
    """The CUDA device a probe runs on; raises without one (a probe
    measures the card and never falls back to the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probes measure a CUDA device, not {dev}")
    return dev


def time_ms(fn, reps: int = 100) -> float:
    """Device time of one call of ``fn``: ``CALLS`` calls are captured
    back to back in one CUDA graph, and the graph is replayed between two
    CUDA events until ``reps`` calls have run.  One call a graph would
    time the host's replay, which takes longer than most probe kernels;
    ``CALLS`` a graph keep the device busy.  The capture runs on the
    stream of the warm-up calls, so what a wrapper keeps by stream (the
    scan's scratch) is made before the capture, not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    replays = max(1, reps // CALLS)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * CALLS)


def launch_floor_ms(device=None, reps: int = 100) -> float:
    """``time_ms`` of the least kernel: one element incremented in place.
    What a probe takes above it is what its own work costs."""
    one = torch.zeros(1, device=cuda_device(device))
    return time_ms(lambda: one.add_(1.0), reps)


def time_ms_out(fn, reps: int = 100) -> tuple[float, object]:
    """``time_ms`` of ``fn``, and the output of the last captured call as
    the last replay left it: a check of it finds what one call leaves
    wrong for the next (every call has the same arguments).  Each call
    drops the last output before it runs, so the captured calls reuse one
    output's memory, as they do in ``time_ms``."""
    last = []

    def call():
        last.clear()
        last.append(fn())

    ms = time_ms(call, reps)
    return ms, last[0]


def time_in_place_ms(fn, restore, reps: int = 100,
                     cold: bool = False) -> tuple[float, float, float]:
    """Device time of ``fn``, which updates its inputs in place: a graph of
    ``restore(); fn()`` (``restore`` copies the inputs back from a saved
    clone) minus a graph of ``restore()`` alone.  ``cold``: the L2 is
    flushed (``flush_l2``) after each restore, which warms it, in both
    graphs.  Warm, a kernel that evicts the restore's sources from the L2
    is also charged the next restore's misses, which the graph of restores
    alone does not have (``restore_penalty`` measures that); cold, both
    graphs restore after the same flush.  Returns (ms, ms of the pair, ms
    of the restore)."""
    def before():
        restore()
        if cold:
            flush_l2()

    def both():
        before()
        fn()

    t_restore = time_ms(before, reps)
    t_both = time_ms(both, reps)
    return t_both - t_restore, t_both, t_restore


# Bytes written between calls to evict the L2 (50 MB on an H100).
FLUSH_BYTES = 128 << 20
_FLUSH = {}


def flush_l2() -> None:
    """Write a buffer of FLUSH_BYTES on the current CUDA device, which
    evicts what the L2 held (made once per device, outside any capture)."""
    dev = torch.cuda.current_device()
    if dev not in _FLUSH:
        _FLUSH[dev] = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=f"cuda:{dev}")
    _FLUSH[dev].fill_(1)


def time_cold_ms(fn, reps: int = 100) -> float:
    """Device time of ``fn`` with a cold L2: a graph of ``flush_l2();
    fn()`` minus a graph of ``flush_l2()`` alone."""
    def both():
        flush_l2()
        fn()

    flush_l2()
    return time_ms(both, reps) - time_ms(flush_l2, reps)


def restore_penalty(restore, nbytes: int = 55 << 20, reps: int = 100) -> dict:
    """Whether ``time_in_place_ms`` charges a kernel for its restore's L2
    misses, asked of a stand-in: ``read`` sums an unrelated buffer of
    ``nbytes`` (more than the L2) and changes no state, so as an in-place
    call it should take what it takes alone.  Returns the reader alone
    (``read_ms`` warm, ``read_cold_ms`` after a flush), the reader as an
    in-place call (``in_place_ms``, ``in_place_cold_ms``), and the restore
    alone (``restore_ms``) and after a flush (``restore_cold_ms``).  If the
    penalty is the restore's misses, ``in_place_ms - read_ms`` is about
    ``restore_cold_ms - restore_ms`` and ``in_place_cold_ms`` about
    ``read_cold_ms``."""
    buf = torch.ones(nbytes // 4, device=f"cuda:{torch.cuda.current_device()}")

    def read():
        buf.sum()

    return dict(read_ms=time_ms(read, reps), read_cold_ms=time_cold_ms(read, reps),
                in_place_ms=time_in_place_ms(read, restore, reps)[0],
                in_place_cold_ms=time_in_place_ms(read, restore, reps, cold=True)[0],
                restore_ms=time_ms(restore, reps), restore_cold_ms=time_cold_ms(restore, reps))


def ptxas_registers(log_text: str, kernel: str = "arrival16") -> dict:
    """The kernels whose names hold ``kernel`` (K1's by default) in an
    ``nvcc -Xptxas -v`` log: mangled name (up to its template arguments)
    -> "N regs, S B spill"."""
    out, cur = {}, None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"'_Z\d+(\w+?)Ev", ln)
            cur = m.group(1) if m and kernel in m.group(1) else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            out[cur] = f"{m.group(1)} B spill"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur] = f"{m.group(1)} regs, " + out.get(cur, "0 B spill")
    return out


def bound(nbytes: float, ops: float, bf16_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of traffic, ``ops`` f32
    operations and ``bf16_ops`` bf16 lane-operations in packed bf16x2
    instructions on an H100 (the two kinds share the same units, so their
    times add), and which of bytes and operations binds."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (ops / PEAK_F32 + bf16_ops / PEAK_BF16) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def arrival_work(nodes, rows, oT, dT, invT, s, active, has_instances: bool = False):
    """(bytes, f32 operations, distinct rows) of one K1 arrival out of
    place (``cuda_arrival.arrival_step16_cuda``) in which live lane i reads
    row ``rows[i]`` (``s.ptr``): each distinct row the live lanes load,
    each distinct ray plane and the active mask read once, and the state
    planes read and written once (the new state is a copy).  An arrival in
    place is ``arrivals_work``'s."""
    live = s.ptr >= 0 if active is None else (s.ptr >= 0) & active
    r = rows[live].long()
    distinct = int(torch.unique(r).numel())
    meta = nodes.view(torch.int32)[r, 3]
    ops = _k1_ops(meta, 16 if nodes.shape[1] == 96 else 8, has_instances)
    rays = sum(x.nbytes for x in {x.data_ptr(): x for x in (oT, dT, invT)}.values())
    fields = _FLAT_FIELDS + (_INST_FIELDS if has_instances else ())
    state = sum(getattr(s, f).nbytes for f in fields)
    return (distinct * nodes.shape[1] * 4 + rays + (0 if active is None else active.nbytes)
            + 2 * state, ops, distinct)


def diet_work(nodes, rows, oT, dT, invT, s, active, mode: str):
    """(bytes, f32 operations, counts) of one in-place launch of the kernel
    diet's ``mode`` (``arrival16_diet_kernel``) on state ``s``, found by
    running its plain version on ``s`` (``s`` is left as it is).  Bytes, as
    the kernel moves them: ptr and t of every lane, ``active`` of every lane
    with ptr >= 0; rows, pend and sp of the live lanes; 12 bytes a ray plane
    triple a lane reads (inv and o for the slab test, o alone not in
    no_inner; o and d for the leaf section or, in no_leaf, its kept loads);
    each distinct 16-byte word group of a row the lanes load (a dead lane's
    on row 0); t, u, v and tri written and found read where a lane
    improves, found written where it turns true; each ptr, pend and sp that
    changes written; 8 bytes a stack push and a pop (none in no_stack).
    Operations: 576 a slab test (none in no_inner), 55 a triangle slot, 1 a
    no_leaf lane.  ``counts``: lanes by kind, distinct row groups."""
    from unity_webgpu_pathtracer_torch.experiments.round14_kernel_diet import diet_step16
    from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE

    tr = {}
    out = diet_step16(nodes, rows, oT.T, dT.T, invT.T, s, active, mode, tr)
    b, depth = s.ptr.shape[0], s.stack_row.shape[0]
    live, inner, leaf, meta = tr["live"], tr["is_inner"], tr["is_leaf"], tr["meta"]
    no_leaf = mode == "no_leaf"
    far = torch.zeros_like(live) if no_leaf else s.t > FAR_PLANE
    slab = inner | (live if mode == "no_stack" else torch.zeros_like(live))
    leaf_sec = torch.zeros_like(live) if no_leaf else leaf | far
    kept = leaf & no_leaf                         # no_leaf's kept loads
    cnt = torch.where(leaf, meta.clamp(max=16), torch.ones_like(meta))
    improved = tr["improved"]
    push = tr["push"] & (s.sp < depth)
    pop = tr["pop"] & (s.sp - 1 < depth)

    # Row word groups by lane: bit g for words 4g..4g+3.
    comp0 = sum(1 << (1 + 2 * k) for k in range(9))      # comp words 0-3
    comp1 = comp0 << 1                                   # comp words 4-7
    two = cnt > (4 if mode == "leaf_noint" else 8)
    g = torch.zeros(b, dtype=torch.int64, device=s.ptr.device)
    g |= (live | far).long()                             # anchor, meta
    g |= slab.long() * (((1 << 12) - 1) & ~1)            # groups 1-11
    g |= (leaf_sec | kept).long() * comp0
    g |= ((leaf_sec | kept) & two).long() * comp1
    if no_leaf:
        g |= 1 << 1                                      # row[5], every lane
    g |= improved.long() << (19 + (tr["best"] >> 2)).clamp(max=22)
    row_of = torch.where(live, rows, torch.zeros_like(rows)).long()
    keys = [row_of[(g >> k) & 1 == 1] * 24 + k for k in range(24)]
    groups = int(torch.unique(torch.cat(keys)).numel())

    o_read = leaf_sec | kept | (slab if mode != "no_inner" else torch.zeros_like(slab))
    nbytes = (8 * b + int((s.ptr >= 0).sum()) * (0 if active is None else 1)
              + 12 * int(live.sum()) + 16 * groups
              + 12 * int(o_read.sum() + (leaf_sec | kept).sum() + slab.sum())
              + 17 * int(improved.sum()) + int((improved & ~s.found).sum())
              + 8 * int(((push | pop) if mode != "no_stack" else torch.zeros_like(push)).sum()))
    for f in ("ptr", "pend", "sp"):
        nbytes += 4 * int((getattr(out, f) != getattr(s, f)).sum())
    ops = (576 * int(slab.sum()) * (mode != "no_inner") + 55 * int(cnt[leaf_sec].sum())
           + (b if no_leaf else 0))
    counts = dict(live=int(live.sum()), inner=int(inner.sum()), leaf=int(leaf.sum()),
                  improved=int(improved.sum()), row_groups=groups)
    return nbytes, ops, counts


def _k1_ops(meta: torch.Tensor, slots: int, has_instances: bool) -> int:
    return (K1_OPS_INNER * int((meta == 0).sum())
            + K1_OPS_TRI * int(meta[meta > 0].clamp(max=slots).sum())
            + (K1_OPS_INST * int((meta < 0).sum()) if has_instances else 0))


def arrivals_work(nodes, oT, dT, invT, s, steps: int, live=None, stop_on_found=None,
                  has_instances: bool = False, rows=None):
    """(bytes, f32 operations, distinct rows, counts) of one multi-arrival
    launch (``cuda_arrival.arrival_steps16_cuda``) on state ``s``, found by
    running the one-arrival plain version on its own outputs (``s`` is left
    as it is).  Bytes: ``ptr`` and the ``live``/``stop_on_found`` masks of
    every lane; for each lane that steps, its scalar state read once and
    written once and its world ray planes read once (the instance-local
    planes read if it starts inside a BLAS, written if it enters one); each
    distinct row the lanes load over the ``steps`` arrivals; 8 bytes per
    stack push and per pop that reads memory (a pop right after a push
    takes its entry from registers).  ``rows`` (int32 (B,)), a probe's row
    plane: lane i loads row ``rows[i]`` where the render path loads ``ptr``
    (the leaf-decode probes, ``cuda_arrival.arrival_probe_cuda``), and
    each lane that steps reads it, 4 bytes; the render path passes none.
    Operations: K1's, summed over the arrivals.  ``counts``: lanes that
    step, pushes, pops from memory."""
    from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import arrival_step16

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
        r = (cur.ptr if rows is None else rows)[act].long()
        loaded.append(r)
        meta = nodes_i[r, 3]
        ops += _k1_ops(meta, slots, has_instances)
        nxt = arrival_step16(nodes, oT.T, dT.T, invT.T, cur, act, has_instances, rows=rows)
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
              + n * (2 * scalar - 4 + 36 + (0 if rows is None else 4))
              + distinct * nodes.shape[1] * 4 + 8 * (pushes + pops))
    if has_instances:
        nbytes += n * 2 * 12 + 36 * int((start & (s.inst >= 0)).sum() + entered.sum())
    return nbytes, ops, distinct, dict(lanes=n, pushes=pushes, pops=pops)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the elements finite in both (0.0
    for integers that are equal)."""
    a, b = got.double(), want.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def row(name: str, kernel: str, ms: float, plain_ms: float, per: float, per_what: str,
        nbytes: float, ops: float, err: float, ok: bool, tol: str,
        library_ms: float | None = None, bf16_ops: float = 0.0, **extra) -> dict:
    """One measurement: ``kernel`` is the launch counter's name, ``per``
    the ns per lane or row (``per_what``), ``ok`` whether the kernel held
    against its plain version at ``tol``; ``ops`` f32 and ``bf16_ops``
    packed bf16 operations (``bound``)."""
    b_ms, b_by = bound(nbytes, ops, bf16_ops)
    return dict(name=name, kernel=kernel, ms=ms, plain_ms=plain_ms, ns_per=per,
                per=per_what, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
                bf16_ops=bf16_ops, library_ms=library_ms, max_abs_err=err, ok=ok, tol=tol,
                **extra)


def check(rows: list[dict]) -> list[dict]:
    """Raise if any kernel disagreed with its plain version."""
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return rows


class _Captured(Exception):
    pass


class K1Launch(NamedTuple):
    """The inputs of one multi-arrival launch (a super-iteration's start)."""
    nodes: object
    oT: object
    dT: object
    invT: object
    s: object
    steps: int
    live: object
    stop: object
    has_instances: bool


def clone_state(s):
    return s._replace(**{f: getattr(s, f).clone() for f in s._fields})


class K2Launch(NamedTuple):
    """The inputs of one transition (``cuda_transition.transition16_cuda``)."""
    scene: object
    config: object
    params: object
    st: object


def capture_inputs(sd, cfg, params, k1_calls: tuple, k2_calls: tuple = ()):
    """Clone the inputs of the multi-arrival launches numbered ``k1_calls``
    (the lane state at the start of those super-iterations, before the
    update in place) and of the transitions numbered ``k2_calls`` (the
    state after the arrivals, before the env draw) of a real pass, then
    stop the pass; returns the K1Launch and K2Launch lists in call order."""
    from unity_webgpu_pathtracer_torch.render import fused

    got = {"k1": [], "k2": []}
    arrive, trans = fused.arrival_steps16_cuda, fused.transition16_cuda
    n = {"k1": 0, "k2": 0}

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def done():
        return len(got["k1"]) == len(k1_calls) and len(got["k2"]) == len(k2_calls)

    def k1(nodes, oT, dT, invT, s, steps, live=None, stop_on_found=None, has_instances=False):
        n["k1"] += 1
        if n["k1"] in k1_calls:
            got["k1"].append(K1Launch(nodes, oT.clone(), dT.clone(), invT.clone(),
                                      clone_state(s), steps, clone(live), clone(stop_on_found),
                                      has_instances))
            if done():
                raise _Captured
        return arrive(nodes, oT, dT, invT, s, steps, live, stop_on_found, has_instances)

    def k2(scene, config, params_, st):
        n["k2"] += 1
        if n["k2"] in k2_calls:
            got["k2"].append(K2Launch(scene, config, params_, clone_state(st)))
            if done():
                raise _Captured
        return trans(scene, config, params_, st)

    fused.arrival_steps16_cuda, fused.transition16_cuda = k1, k2
    try:
        fused.fused_pass_with_stats(sd, cfg, params, 0)
    except _Captured:
        pass
    finally:
        fused.arrival_steps16_cuda, fused.transition16_cuda = arrive, trans
    if not done():
        raise RuntimeError(f"pass ended before the capture: {len(got['k1'])} launches, "
                           f"{len(got['k2'])} transitions")
    return got["k1"], got["k2"]


def transition_work(cap: K2Launch, after, died):
    """(bytes, f32 operations, counts) of one K2 launch on ``cap.st``, where
    ``after`` is the state it leaves and ``died`` its died plane (from the
    plain version on a clone).  Bytes: mode, ptr, found and rng of every
    lane read, rng and died written; for each lane at a finished segment
    the state its case reads, read once; each field element whose value
    changes written once, rad_out of the lanes that die, the ray counter;
    each distinct attribute row (32 or 16 bytes), material row (22 words)
    and env row half (the 32-byte alias half on a hit, the 48-byte
    footprint on a miss) once.  Operations: ``K2_OPS`` by lane case.
    ``counts``: lanes by case and distinct rows."""
    from unity_webgpu_pathtracer_torch.ops import cuda_transition as ct
    from unity_webgpu_pathtracer_torch.scene.envmap import _bilerp_coords
    from unity_webgpu_pathtracer_torch.utils import rng as urng
    from unity_webgpu_pathtracer_torch.utils.math import INV_PI, INV_TWO_PI, PI

    scene, cfg, st = cap.scene, cap.config, cap.st
    trav_done = st.ptr < 0
    a = (st.mode == ct.MODE_PRIMARY) & trav_done
    hit, miss = a & (st.tri >= 0), a & (st.tri < 0)
    shadow = (st.mode == ct.MODE_SHADOW_ENV) & (trav_done | st.found)
    need = hit | shadow
    b = st.mode.shape[0]

    attr = ct.attr_index(a, need, st.tri, st.hit_tri)[need]
    mats = ct.shade_rows(scene, cfg.attr_compact, attr)[1]
    row_bytes = 16 if cfg.attr_compact == 3 else 32
    h, w = scene.env.image.shape[0], scene.env.image.shape[1]
    u1 = urng.random_float(st.rng[hit])[0]
    bins = torch.clamp((u1 * (h * w)).to(torch.int32), 0, h * w - 1)
    d = st.path_d[:, miss]
    theta = torch.acos(torch.clamp(d[1], -1.0, 1.0))
    uv = torch.stack([(PI + torch.atan2(d[2], d[0])) * INV_TWO_PI
                      + cap.params.environment_rotation, 1.0 - theta * INV_PI], dim=-1)
    x0i, y0i, _fx, _fy = _bilerp_coords(h, w, uv)
    counts = dict(idle=int((~(a | shadow)).sum()), miss=int(miss.sum()), hit=int(hit.sum()),
                  shadow=int(shadow.sum()), attr_rows=int(torch.unique(attr).numel()),
                  material_rows=int(torch.unique(mats).numel()),
                  alias_rows=int(torch.unique(bins).numel()),
                  footprint_rows=int(torch.unique(y0i * w + x0i).numel()))
    proc = counts["miss"] + counts["hit"] + counts["shadow"]

    reads = (17 * b + 52 * proc + 4 * (counts["miss"] + counts["hit"]) + 24 * counts["hit"]
             + 40 * counts["shadow"] + row_bytes * counts["attr_rows"]
             + 88 * counts["material_rows"] + 32 * counts["alias_rows"]
             + 48 * counts["footprint_rows"] + 16)
    writes = 9 * b + 12 * int(died.sum()) + 8
    for f in ct.TransitionState._fields:
        if f in ("rng", "rays"):
            continue
        x, y = getattr(st, f), getattr(after, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        writes += int((x != y).sum()) * x.element_size()
    ops = (K2_OPS["lane"] * proc + K2_OPS["miss"] * counts["miss"]
           + (K2_OPS["hit"] + K2_OPS["normal"][cfg.attr_compact] + K2_OPS["material"]
              + K2_OPS["eval"]) * counts["hit"]
           + (K2_OPS["normal"][cfg.attr_compact] + K2_OPS["material"] + K2_OPS["eval"]
              + K2_OPS["sample"] + K2_OPS["rr"]) * counts["shadow"])
    return reads + writes, ops, counts


def shade_work(sd, before, after, hit, shade):
    """(bytes, f32 operations, counts) of the shading kernel's first entry
    on the path state ``before`` with the closest hit ``hit`` (``after`` the
    state it leaves, ``shade`` the lanes it shaded; from a run on a clone).
    Bytes: the alive flag and RNG state of every lane read, the RNG state
    and shade flag written; for each lane alive at the start its state and
    hit read once (the barycentrics, and the instance of a two-level table,
    where it hit); each state element whose value changes written once;
    the shadow ray and the unoccluded radiance of each shaded lane; each
    distinct ``tri_index`` entry, attribute row (normals and material),
    material row (24 words) and instance row (its 3x4 and override) once;
    the environment's image and CDF once.  Operations: ``SHADE_OPS`` by
    lane case.  ``counts``: lanes by case and distinct rows."""
    import dataclasses

    from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE

    t, _bary, slot, inst = hit
    b = before.alive.shape[0]
    live = before.alive
    valid = live & (slot >= 0) & (t < FAR_PLANE)
    rows = sd.tri_index[slot[valid].long()].long()
    mats = sd.attr_material[rows]
    n_inst = sd.inst_w2l.shape[0]
    in_inst = valid & (inst >= 0) if n_inst else torch.zeros_like(valid)
    if n_inst:
        iv = inst[valid]
        over = sd.inst_offsets[iv.clamp_min(0).long(), 3]
        mats = torch.where((iv >= 0) & (over >= 0), over, mats)
    counts = dict(lanes=b, live=int(live.sum()), miss=int((live & ~valid).sum()),
                  hit=int(valid.sum()), inst=int(in_inst.sum()), shade=int(shade.sum()),
                  slots=int(torch.unique(slot[valid]).numel()),
                  attr_rows=int(torch.unique(rows).numel()),
                  material_rows=int(torch.unique(mats).numel()),
                  instance_rows=int(torch.unique(inst[in_inst]).numel()))
    k = sd.env.image.shape[0] * sd.env.image.shape[1]
    reads = (9 * b + 68 * counts["live"] + (8 + 4 * bool(n_inst)) * counts["hit"]
             + 4 * counts["slots"] + 40 * counts["attr_rows"] + 96 * counts["material_rows"]
             + 52 * counts["instance_rows"] + 16 * k + 12)
    writes = 9 * b + 36 * counts["shade"]
    for f in dataclasses.fields(before):
        if f.name in ("rng", "alive"):
            continue
        x, y = getattr(before, f.name), getattr(after, f.name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        writes += int((x != y).sum()) * x.element_size()
    writes += int((before.alive != after.alive).sum())
    ops = (SHADE_OPS["lane"] * counts["live"]
           + SHADE_OPS["unshaded"] * (counts["live"] - counts["shade"])
           + SHADE_OPS["miss"] * counts["miss"] + SHADE_OPS["hit"] * counts["hit"]
           + SHADE_OPS["inst"] * counts["inst"] + SHADE_OPS["shade"] * counts["shade"])
    return reads + writes, ops, counts


def running(live, stop_on_found, s):
    """The ``active`` mask of the next arrival: ``live`` and not
    (``stop_on_found`` and ``found``), ``found`` as it stands in ``s``, as
    the pass computes it before each arrival (``live`` None: every lane;
    ``stop_on_found`` None: no lane stops; both None: None)."""
    if stop_on_found is None:
        return live
    go = ~(stop_on_found & s.found)
    return go if live is None else live & go


def one_step_loop(nodes, oT, dT, invT, s, steps, live=None, stop_on_found=None,
                  has_instances=False):
    """``steps`` arrivals as the pass ran them before the multi-arrival
    kernel: one ``arrival_step16_cuda`` each (on CUDA tensors a copy of the
    state and one launch at ``steps=1``), a new state each time, ``s``
    untouched.  It
    takes ``arrival_steps16_cuda``'s arguments, so a caller can put it in
    that function's place."""
    from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_step16_cuda

    for _ in range(steps):
        s = arrival_step16_cuda(nodes, oT, dT, invT, s, running(live, stop_on_found, s),
                                has_instances)
    return s


def arrival_state(cap: K1Launch, k: int):
    """The one-arrival inputs ``(nodes, oT, dT, invT, state, active)`` of the
    k-th arrival (from 1) of a captured super-iteration: its start state
    after k - 1 calls of the one-arrival wrapper."""
    s = one_step_loop(cap.nodes, cap.oT, cap.dT, cap.invT, cap.s, k - 1, cap.live, cap.stop,
                      cap.has_instances)
    return cap.nodes, cap.oT, cap.dT, cap.invT, s, running(cap.live, cap.stop, s)
