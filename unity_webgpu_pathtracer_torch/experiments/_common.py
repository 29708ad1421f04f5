"""Timing, bounds and result rows shared by the probes."""

from __future__ import annotations

import torch

from unity_webgpu_pathtracer_torch.device import resolve_device
from unity_webgpu_pathtracer_torch.ops.cuda_arrival import _FLAT_FIELDS, _INST_FIELDS

# H100 SXM peaks (NVIDIA's data sheet and H100 whitepaper): HBM bytes/s; f32
# FLOP/s without tensor cores; bf16 FLOP/s without tensor cores, twice the
# f32 rate because a packed bf16x2 instruction does two lanes' operations.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 133.8e12
# f32 operations per lane of K1, counted from csrc/arrival16.cu: the 16
# slab tests of an inner row (36 each), one Moller-Trumbore test per leaf
# triangle, the world-to-local transform of an instance row.
K1_OPS_INNER, K1_OPS_TRI, K1_OPS_INST = 576, 55, 30


def cuda_device(device=None) -> torch.device:
    """The CUDA device a probe runs on; raises without one (a probe
    measures the card and never falls back to the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probes measure a CUDA device, not {dev}")
    return dev


def time_ms(fn, reps: int = 100) -> float:
    """Device time of one call of ``fn``: the call is captured once in a
    CUDA graph and the graph replayed ``reps`` times between two CUDA
    events, so the host's per-call work is not what is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, bf16_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of traffic, ``ops`` f32
    operations and ``bf16_ops`` packed bf16 operations on an H100 (the two
    kinds share the same units, so their times add), and which of bytes
    and operations binds."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (ops / PEAK_F32 + bf16_ops / PEAK_BF16) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def arrival_work(nodes, rows, oT, dT, invT, s, active, has_instances: bool = False):
    """(bytes, f32 operations, distinct rows) of one K1 arrival in which
    live lane i reads row ``rows[i]`` (``s.ptr`` on the render path): each
    distinct row the live lanes load, each distinct ray plane and the
    active mask read once, and the state planes read and written once."""
    live = s.ptr >= 0 if active is None else (s.ptr >= 0) & active
    r = rows[live].long()
    distinct = int(torch.unique(r).numel())
    meta = nodes.view(torch.int32)[r, 3]
    slots = 16 if nodes.shape[1] == 96 else 8
    ops = (K1_OPS_INNER * int((meta == 0).sum())
           + K1_OPS_TRI * int(meta[meta > 0].clamp(max=slots).sum())
           + (K1_OPS_INST * int((meta < 0).sum()) if has_instances else 0))
    rays = sum(x.nbytes for x in {x.data_ptr(): x for x in (oT, dT, invT)}.values())
    fields = _FLAT_FIELDS + (_INST_FIELDS if has_instances else ())
    state = sum(getattr(s, f).nbytes for f in fields)
    return (distinct * nodes.shape[1] * 4 + rays + (0 if active is None else active.nbytes)
            + 2 * state, ops, distinct)


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
