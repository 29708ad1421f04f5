"""The measurement probes of ``csrc/probes.cu`` and their plain versions.

Each wrapper replaces one Pallas probe of the reference's ``experiments/``
(file:line in ``csrc/probes.cu``).  It checks its tensors against the
kernel's contract on either device (``cuda_build.check_tensor``); tensors
on the CPU run the plain PyTorch version beside it, tensors on a CUDA
device launch the kernel (or raise: there is no fallback), and each launch
adds one to ``LAUNCHES[name]``.  The K1 probes (the kernel diet and the
bf16 leaf decode) are ``cuda_arrival.arrival_probe_cuda``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from unity_webgpu_pathtracer_torch.ops import cuda_build
from unity_webgpu_pathtracer_torch.utils import math as umath

# Ops of ``intrinsic`` (round18_mosaic_probe.py), in the numbers the kernel
# takes (``cuda_build`` passes them as UWPT_OP_* macros).
INTRINSICS = ("pcg_uint32", "u32_to_f32", "sin", "cos", "log", "exp", "sqrt", "arccos",
              "arctan", "arctan2", "power", "cumsum_i32")
RING_W, RING_SLOTS = 128, 16          # P1: row floats, the original's ring slots
SCAN_TILE = 8192                      # P8 cumsum: elements a block scans
SUM_THREADS, SUM_VEC = 256, 4         # P9: a block's threads, 16-byte vectors a thread a round
SUM_MAX_BLOCKS = 1024                 # P9: blocks a call, beyond which a block takes more rounds
SUM_SLICE = SUM_THREADS * SUM_VEC * 4   # P9: elements a block reads a round
TABLE_W = 48                          # P2: row floats
TABLE_THREADS = 128                   # P2 in device memory: a block's threads, one index each a round
TABLE_MAX_BLOCKS = 1024               # P2 in device memory: blocks a call, beyond which more rounds
# P2 on chip: a cluster of 8 blocks (the portable maximum), or 16 (a
# non-portable size) where 8 cannot hold the table; each rank stages its
# rows in at most TABLE_SMEM bytes of dynamic shared memory (the 232,448
# bytes a block can use, less 1 KB for its static shared memory).
TABLE_CLUSTERS = (8, 16)
TABLE_SMEM = 232_448 - 1024
TABLE_ROWS_MAX = TABLE_CLUSTERS[-1] * (TABLE_SMEM // (TABLE_W * 4))   # rows on chip at most
# P3's remainder by 0.9f (csrc/probes.cu ``rem09``): the f32 divisor, its
# f32-rounded reciprocal, and the dividend below which the short form runs.
REM_DIVISOR = float(np.float32(0.9))
REM_INV = float(np.float32(1.0) / np.float32(0.9))
REM_LIMIT = 2048.0
TREE_ROWS, TREE_COLS = 4096, 96       # P7: the table held on chip
SCHLICK_BLOCKS, LOBE_REPEATS, STEPS = 40, 64, 32

KERNELS = ("ring_gather", "table_sum_smem", "table_sum_global", "schlick_chain",
           "lobe_chain_f32", "lobe_chain_bf16", "tree_gather",
           *(f"intrinsic_{op}" for op in INTRINSICS), "sum_scalar", "step_chain")
# Launch count of each kernel.
LAUNCHES = dict.fromkeys(KERNELS, 0)

_M32 = 0xFFFFFFFF


def _launch(name: str, entry: str, x: torch.Tensor, *args) -> None:
    lib = cuda_build.load()["probes"]
    err = getattr(lib, entry)(*args, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, err, name)
    LAUNCHES[name] += 1


def _device(x: torch.Tensor) -> torch.device:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device


def _check_aligned(x: torch.Tensor, name: str) -> None:
    """The kernel copies or loads ``x`` in 16-byte pieces."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (data_ptr % 16 = "
                         f"{x.data_ptr() % 16})")


# ---- P1: ring gather (round2_probe.py:125) ----

def ring_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx[-RING_SLOTS:].long()].sum(0, keepdim=True)


def ring_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(1, 128): the sum of the rows ``table[idx[k]]`` of the last 16 k.
    Every row is gathered by its own bulk copy through a ring of slots, on
    blocks over every SM."""
    dev = _device(table)
    cuda_build.check_tensor(table, "table", torch.float32, (table.shape[0], RING_W), dev)
    cuda_build.check_tensor(idx, "idx", torch.int32, (idx.shape[0],), dev)
    _check_aligned(table, "table")
    if dev.type == "cpu":
        return ring_gather_plain(table, idx)
    out = torch.empty((1, RING_W), dtype=torch.float32, device=dev)
    _launch("ring_gather", "ring_gather_launch", table, table.data_ptr(), idx.data_ptr(),
            idx.shape[0], out.data_ptr())
    return out


# ---- P2: row reads from a table on chip (round2_probe.py:177) ----

def table_sum_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long(), 0].sum().reshape(1, 1)


def table_plan(n_idx: int) -> tuple[int, int]:
    """(blocks, rounds) of P2 in device memory over n_idx indices: slices
    of ``TABLE_THREADS`` indices, at most ``TABLE_MAX_BLOCKS`` blocks of
    whole rounds."""
    slices = max(1, -(-n_idx // TABLE_THREADS))
    rounds = -(-slices // TABLE_MAX_BLOCKS)
    return -(-slices // rounds), rounds


def table_cluster_plan(n_rows: int) -> tuple[int, int]:
    """(blocks of the cluster, rows a rank stages) of P2 on chip: the first
    cluster size of ``TABLE_CLUSTERS`` whose ranks hold the table in
    ``TABLE_SMEM`` bytes each; raises if none does."""
    for c in TABLE_CLUSTERS:
        per = max(1, -(-n_rows // c))
        if per * TABLE_W * 4 <= TABLE_SMEM:
            return c, per
    raise ValueError(f"a table of {n_rows} rows ({n_rows * TABLE_W * 4} bytes) does not fit "
                     f"a cluster's shared memory ({TABLE_ROWS_MAX} rows at most)")


def table_sum(table: torch.Tensor, idx: torch.Tensor, on_chip: bool) -> torch.Tensor:
    """(1, 1): the sum of ``table[idx[k], 0]`` (indices in [0, N)) in one
    launch, the (N, 48) table held in a cluster's distributed shared memory
    (``on_chip``; N at most ``TABLE_ROWS_MAX``, the table on a 16-byte
    boundary) or read from device memory by blocks whose sums meet in the
    last one; the same bits on every call."""
    dev = _device(table)
    n = table.shape[0]
    cuda_build.check_tensor(table, "table", torch.float32, (n, TABLE_W), dev)
    cuda_build.check_tensor(idx, "idx", torch.int32, (idx.shape[0],), dev)
    if n < 1:
        raise ValueError("table_sum: an empty table")
    if on_chip:
        blocks, per = table_cluster_plan(n)
        _check_aligned(table, "table")
    else:
        blocks, per = table_plan(idx.shape[0])
    if dev.type == "cpu":
        return table_sum_plain(table, idx)
    out = torch.empty((1, 1), dtype=torch.float32, device=dev)
    scratch = None if on_chip else _scratch("table", dev, 1 + blocks)
    _launch("table_sum_smem" if on_chip else "table_sum_global", "table_sum_launch", table,
            table.data_ptr(), n, idx.data_ptr(), idx.shape[0], out.data_ptr(), int(on_chip),
            blocks, per, 0 if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel())
    return out


def table_max_clusters(n_rows: int, device=None) -> tuple[int, int, int]:
    """(cluster size, rows a rank, clusters the card can hold at once) for
    P2 on chip over an n_rows table: ``cudaOccupancyMaxActiveClusters`` of
    the on-chip kernel at ``table_cluster_plan(n_rows)``; 0 clusters means
    the card cannot place one."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"table_max_clusters asks a CUDA device, not {dev}")
    c, per = table_cluster_plan(n_rows)
    lib = cuda_build.load()["probes"]
    count = ctypes.c_int(0)
    with torch.cuda.device(dev):
        cuda_build.check(lib, lib.table_sum_max_clusters(c, per, ctypes.byref(count)),
                         "table_sum_max_clusters")
    return c, per, count.value


# ---- P3: Schlick-like chain (round2_probe.py:271) ----

def schlick_chain_plain(x: torch.Tensor) -> torch.Tensor:
    v, acc = x, torch.zeros_like(x)
    for _ in range(SCHLICK_BLOCKS):
        w = 1.0 - v
        w2 = w * w
        f = w2 * w2 * w
        g = umath.sqrt(torch.abs(v * 0.9 + 0.05))
        acc = acc + f * g + v * (1.0 - f)
        v = torch.fmod(torch.abs(acc * 0.3 + 0.1), 0.9) + 0.05
    return acc


def schlick_chain(x: torch.Tensor) -> torch.Tensor:
    dev = _device(x)
    cuda_build.check_tensor(x, "x", torch.float32, x.shape, dev)
    if dev.type == "cpu":
        return schlick_chain_plain(x)
    out = torch.empty_like(x)
    _launch("schlick_chain", "schlick_chain_launch", x, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def rem09_plain(a: torch.Tensor) -> torch.Tensor:
    """csrc/probes.cu ``rem09`` of non-negative f32 ``a`` op for op: below
    ``REM_LIMIT`` q = (a * INV + 1.5 * 2^23) - 1.5 * 2^23 in f32, the fma
    a - q * 0.9f in float64 (exact for these operands) rounded once to
    f32, one correction; at or above it, and for Inf and NaN,
    ``torch.fmod``."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    d, m = f32(REM_DIVISOR), f32(1.5 * 2**23)
    q = (a * f32(REM_INV) + m) - m
    r = (a.double() - q.double() * REM_DIVISOR).float()
    r = torch.where(r < 0.0, r + d, r)
    return torch.where(a < REM_LIMIT, r, torch.fmod(a, d))


def remainder_check(first: int = 0, count: int = 2**31, device=None,
                    chunk: int = 1 << 22) -> int:
    """Mismatches between P3's remainder ``rem09`` and fmod by 0.9f over
    the ``count`` f32 bit patterns from ``first`` (as uint32; by default
    every non-negative float, Inf and NaN included): bits equal or both
    NaN.  On a CUDA device one launch of ``remainder_check_kernel``; on the
    CPU ``rem09_plain`` against ``torch.fmod``, ``chunk`` patterns at a
    time."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if first < 0 or count < 0 or first + count > 2**32:
        raise ValueError(f"remainder_check: patterns [{first}, {first + count}) outside uint32")
    if dev.type == "cpu":
        bad = 0
        d = torch.tensor(REM_DIVISOR, dtype=torch.float32)
        for lo in range(first, first + count, chunk):
            bits = torch.arange(lo, min(lo + chunk, first + count), dtype=torch.int64)
            a = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)
            r, f = rem09_plain(a), torch.fmod(a, d)
            same = (r.view(torch.int32) == f.view(torch.int32)) | (r.isnan() & f.isnan())
            bad += int((~same).sum())
        return bad
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    got = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = cuda_build.load()["probes"]
    cuda_build.check(lib, lib.remainder_check_launch(first, count, got.data_ptr(),
                                                     torch.cuda.current_stream(dev).cuda_stream),
                     "remainder_check")
    return int(got.item())


# ---- P6: Disney lobe chain, f32 or bf16 (round18_bf16_shade_probe.py:78) ----

def _lobe_step(x, y, z, c):
    """round18_bf16_shade_probe.py::_chain; ``c`` makes a constant of the
    working type."""
    one, zero = c(1.0), c(0.0)
    m = torch.minimum(torch.maximum(one - x, zero), one)
    m2 = m * m
    fh = m2 * m2 * m
    a = x * c(0.3) + c(0.001)
    b = y * c(0.7) + c(0.001)
    cc = a * a + b * b + z * z
    d = one / (c(3.14159265) * a * b * cc * cc)
    g1 = (c(2.0) * z) / (z + umath.sqrt(torch.maximum(a * a + z * z - a * a * z * z, zero)))
    eta = c(1.5)
    s2 = eta * eta * (one - x * x)
    ct = umath.sqrt(torch.maximum(one - s2, zero))
    rs = (eta * ct - x) / (eta * ct + x + c(1e-6))
    rp = (eta * x - ct) / (eta * x + ct + c(1e-6))
    fres = c(0.5) * (rs * rs + rp * rp)
    f = d * g1 * (fres + (one - fres) * fh)
    return f * c(0.25) + x * c(0.125), y * f + c(0.01), z + f * c(1e-3)


def lobe_chain_plain(xin: torch.Tensor, dtype: torch.dtype,
                     repeats: int = LOBE_REPEATS) -> torch.Tensor:
    def c(v):   # a CPU scalar of the working type (no copy to the card)
        return torch.tensor(v, dtype=dtype)

    x, y, z = xin.to(dtype), (xin * 0.5).to(dtype), (xin * 0.25 + 0.1).to(dtype)
    acc = torch.zeros_like(xin)
    for _ in range(repeats):
        x, y, z = _lobe_step(x, y, z, c)
        acc = acc + x.to(torch.float32)
    return acc


def lobe_chain(xin: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """64 repeats of the lobe chain computed in ``dtype`` (float32 or
    bfloat16, one lane a thread), accumulated in f32."""
    dev = _device(xin)
    cuda_build.check_tensor(xin, "x", torch.float32, xin.shape, dev)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lobe_chain: float32 or bfloat16, got {dtype}")
    if dev.type == "cpu":
        return lobe_chain_plain(xin, dtype)
    out = torch.empty_like(xin)
    bf16 = dtype == torch.bfloat16
    _launch("lobe_chain_bf16" if bf16 else "lobe_chain_f32", "lobe_chain_launch", xin,
            xin.data_ptr(), out.data_ptr(), xin.numel(), int(bf16))
    return out


# ---- P7: the upper tree held on chip (round18_vmem_tree_probe.py:63) ----

def tree_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table.float()[idx]``, and a row of zeros where ``idx`` lies outside
    [0, TREE_ROWS), as the reference's one-hot product gives."""
    inside = (idx >= 0) & (idx < TREE_ROWS)
    rows = table.float()[torch.where(inside, idx, 0).long()]
    return torch.where(inside[:, None], rows, torch.zeros_like(rows))


def tree_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, 96) f32 rows ``table[idx]`` of a (4096, 96) bf16 table on an
    8-byte boundary (a row of zeros for an index outside [0, 4096)), the
    table read through the L2 with an evict-last policy by blocks over
    every SM."""
    dev = _device(table)
    cuda_build.check_tensor(table, "table", torch.bfloat16, (TREE_ROWS, TREE_COLS), dev)
    cuda_build.check_tensor(idx, "idx", torch.int32, (idx.shape[0],), dev)
    if table.data_ptr() % 8:
        raise ValueError(f"table must start on an 8-byte boundary (data_ptr % 8 = "
                         f"{table.data_ptr() % 8})")
    if dev.type == "cpu":
        return tree_gather_plain(table, idx)
    out = torch.empty((idx.shape[0], TREE_COLS), dtype=torch.float32, device=dev)
    _launch("tree_gather", "tree_gather_launch", table, table.data_ptr(), idx.data_ptr(),
            idx.shape[0], out.data_ptr())
    return out


# ---- P8: intrinsics (round18_mosaic_probe.py:35) ----

def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as their uint32 values, in int64."""
    return x.to(torch.int64) & _M32


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 as int32 bit patterns."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


_INV_U32 = torch.tensor(1.0 / 4294967295.0, dtype=torch.float32).item()
_UNARY = {"sin": torch.sin, "cos": torch.cos, "log": torch.log, "exp": torch.exp,
          "sqrt": umath.sqrt, "arccos": torch.acos, "arctan": torch.atan}


def intrinsic_plain(op: str, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    if op == "pcg_uint32":
        old = (_u32(a) + 747796405 + 2891336453) & _M32
        shift = (old >> 28) + 4
        word = (((old >> shift) ^ old) * 277803737) & _M32
        return _i32_bits((word >> 22) ^ word)
    if op == "u32_to_f32":
        return _u32(a).to(torch.float32) * _INV_U32
    if op == "cumsum_i32":
        return torch.cumsum(a, 0, dtype=torch.int32)
    if op == "arctan2":
        return torch.atan2(a, b)
    if op == "power":
        return torch.pow(a, b)
    return _UNARY[op](a)


def intrinsic(op: str, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """One op of ``INTRINSICS`` over (B,), each operand on a 16-byte
    boundary (the scan and the unary ops load 16-byte vectors; ``arctan2``
    and ``power`` one element a thread, under the same rule): uint32 operands and the
    PCG result travel as int32 bit patterns; ``cumsum_i32`` takes int32 (a
    one-pass scan, its own kernel); ``arctan2`` (a = y, b = x) and
    ``power`` take two f32 operands."""
    if op not in INTRINSICS:
        raise ValueError(f"unknown op {op!r}")
    dev = _device(a)
    n = a.shape[0]
    dtype = torch.int32 if op in ("pcg_uint32", "u32_to_f32", "cumsum_i32") else torch.float32
    cuda_build.check_tensor(a, "a", dtype, (n,), dev)
    _check_aligned(a, "a")
    if op in ("arctan2", "power"):
        cuda_build.check_tensor(b, "b", torch.float32, (n,), dev)
        _check_aligned(b, "b")
    if dev.type == "cpu":
        return intrinsic_plain(op, a, b)
    out = torch.empty((n,), dtype=torch.float32 if op == "u32_to_f32" else dtype, device=dev)
    if op == "cumsum_i32":
        scratch = _scratch("scan", dev, 1 + max(1, -(-n // SCAN_TILE)))
        _launch("intrinsic_cumsum_i32", "cumsum_i32_launch", a, a.data_ptr(), out.data_ptr(), n,
                scratch.data_ptr(), scratch.numel())
    else:
        _launch(f"intrinsic_{op}", "intrinsic_launch", a, INTRINSICS.index(op), a.data_ptr(),
                0 if b is None else b.data_ptr(), out.data_ptr(), n)
    return out


# The scratch of the one-launch kernels (the scan, the sum, P2 in device
# memory) by kernel, device and stream: an int64 control word (the ticket
# and the call's epoch), then a word a tile or block.  Zeroed once; every
# call leaves it ready for the next (csrc/probes.cu).  Calls on one stream
# are ordered by it, so they may share a scratch; calls on two streams may
# run at once, so they must not; each kernel has its own, since one call's
# words must never read as another kernel's.  A scratch outgrown by a
# larger call is kept, never freed: a CUDA graph that captured a call holds
# its address for as long as it replays.
_SCRATCH: dict[tuple[str, torch.device, int], torch.Tensor] = {}
_OUTGROWN: list[torch.Tensor] = []


def _scratch(kind: str, dev: torch.device, words: int) -> torch.Tensor:
    key = (kind, dev, torch.cuda.current_stream(dev).cuda_stream)
    s = _SCRATCH.get(key)
    if s is None or s.numel() < words:
        if s is not None:
            _OUTGROWN.append(s)
        s = _SCRATCH[key] = torch.zeros(words, dtype=torch.int64, device=dev)
    return s


# ---- P9: sum to one scalar (round18_mosaic_probe.py:111) ----

def sum_plan(n: int) -> tuple[int, int]:
    """(blocks, rounds) of the sum over n elements: slices of
    ``SUM_SLICE``, at most ``SUM_MAX_BLOCKS`` blocks of whole rounds."""
    slices = max(1, -(-n // SUM_SLICE))
    rounds = -(-slices // SUM_MAX_BLOCKS)
    return -(-slices // rounds), rounds


def _sum_tree(v: torch.Tensor) -> torch.Tensor:
    """csrc/probes.cu ``block_tree`` over the last dimension (a block's
    threads): lane l adds lane l + off within each warp, then the same
    over the warps' sums."""
    v = v.reshape(*v.shape[:-1], -1, 32)
    for width in (v.shape[-1], v.shape[-2]):
        off = width // 2
        while off:
            v = v[..., :off] + v[..., off:2 * off]
            off //= 2
        v = v[..., 0]
    return v


def sum_scalar_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's sum in its order: each thread's vectors of each round
    in turn, the block's tree, then the blocks' partials in block order
    (thread t of the last block adds partials t, t + SUM_THREADS, ...) and
    the tree again.  Zeros pad the input and the partials: a thread's sum
    starts at +0.0 and never becomes -0.0, so adding +0.0 changes no bit."""
    n = x.shape[0]
    blocks, rounds = sum_plan(n)
    xp = torch.zeros(blocks * rounds * SUM_SLICE, dtype=torch.float32, device=x.device)
    xp[:n] = x
    q = xp.view(blocks, rounds, SUM_VEC, SUM_THREADS, 4)
    acc = torch.zeros((blocks, SUM_THREADS), dtype=torch.float32, device=x.device)
    for r in range(rounds):
        for v in range(SUM_VEC):
            for c in range(4):
                acc = acc + q[:, r, v, :, c]
    parts = torch.zeros(-(-blocks // SUM_THREADS) * SUM_THREADS, dtype=torch.float32,
                        device=x.device)
    parts[:blocks] = _sum_tree(acc)
    part = torch.zeros(SUM_THREADS, dtype=torch.float32, device=x.device)
    for k in range(parts.shape[0] // SUM_THREADS):
        part = part + parts[k * SUM_THREADS:(k + 1) * SUM_THREADS]
    return _sum_tree(part).reshape(1)


def sum_scalar(x: torch.Tensor) -> torch.Tensor:
    """(1,) f32: the sum of the (B,) plane, on a 16-byte boundary, in one
    launch over every SM; the same bits on every call."""
    dev = _device(x)
    cuda_build.check_tensor(x, "x", torch.float32, (x.shape[0],), dev)
    _check_aligned(x, "x")
    if dev.type == "cpu":
        return sum_scalar_plain(x)
    out = torch.empty((1,), dtype=torch.float32, device=dev)
    blocks, rounds = sum_plan(x.shape[0])
    scratch = _scratch("sum", dev, 1 + blocks)
    _launch("sum_scalar", "sum_scalar_launch", x, x.data_ptr(), x.shape[0], blocks, rounds,
            out.data_ptr(), scratch.data_ptr(), scratch.numel())
    return out


# ---- P10: 32 steps of x * 1.000001 + 0.000001 (round20_tile3d_probe.py:58) ----

def step_chain_plain(x: torch.Tensor) -> torch.Tensor:
    for _ in range(STEPS):
        x = x * 1.000001 + 0.000001
    return x


def step_chain(x: torch.Tensor) -> torch.Tensor:
    """Any layout of the lanes (the kernel sees the bytes); the count must
    be a multiple of 4."""
    dev = _device(x)
    cuda_build.check_tensor(x, "x", torch.float32, x.shape, dev)
    if x.numel() % 4:
        raise ValueError(f"step_chain: {x.numel()} lanes, not a multiple of 4")
    if dev.type == "cpu":
        return step_chain_plain(x)
    out = torch.empty_like(x)
    _launch("step_chain", "step_chain_launch", x, x.data_ptr(), out.data_ptr(), x.numel())
    return out
