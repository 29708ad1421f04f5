"""ctypes binding to the repository's C++ BVH builder (``native/``).

Seven entries are bound: ``build_wide16_ex`` (96-float rows, 16-triangle
leaves) and ``build_wide16l8_ex`` (48-float leaf8 rows, 8-triangle
leaves), with the same arguments, ``build_wide8`` (the 48-float wide8
rows), the reference's first three formats, with its argument lists:
``build_mbvh8`` (the 8-wide MBVH of ``accel/mbvh.py``), ``build_skip_bvh``
(the skip rows of ``accel/linearize.py``) and ``build_wide_bvh`` (the
fat rows of ``accel/wide.py``), and ``f2h_batch``, the builder's f32 ->
f16 conversion (``native_f2h_or_none``).  The library is built with ``make -C
native`` when it is missing.  When it cannot be built or loaded, the
builders here return None and the callers build in numpy
(``accel/wide16.py::build_wide16``, ``accel/wide8.py::build_wide8``,
``accel/__init__.py``), as the reference's binding does; no device path
depends on it.  ``disabled()`` makes the library count as
missing for a block (the fallback's test and its chip phase).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import time

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libtpubvh.so")
SRC_PATH = os.path.join(NATIVE_DIR, "bvh_builder.cpp")

_LIB = None
_TRIED = False
_DISABLED = False


@contextlib.contextmanager
def disabled():
    """Within the block the library counts as missing."""
    global _DISABLED
    old, _DISABLED = _DISABLED, True
    try:
        yield
    finally:
        _DISABLED = old


def _load() -> ctypes.CDLL | None:
    """The library, built first when missing; None when it cannot be built
    or loaded (the attempt is made once a process)."""
    global _LIB, _TRIED
    if _DISABLED:
        return None
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(LIB_PATH):
        try:
            subprocess.run(["make", "-C", NATIVE_DIR, "-s"], capture_output=True,
                           text=True, timeout=600)
        except (OSError, subprocess.SubprocessError):
            return None
        if not os.path.exists(LIB_PATH):
            return None
    # Another process (the JAX package builds the same file in place) may
    # still be writing the library: retry the load for a while.
    deadline = time.monotonic() + 120.0
    while True:
        try:
            lib = ctypes.CDLL(LIB_PATH)
            break
        except OSError:
            if time.monotonic() > deadline:
                return None
            time.sleep(1.0)
    for fn in (lib.build_wide16_ex, lib.build_wide16l8_ex):
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,       # positions, tri records
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # tris, leaf size, quality
            ctypes.c_void_p, ctypes.c_int,          # out rows, row capacity
            ctypes.POINTER(ctypes.c_int),           # out depth
            ctypes.c_void_p, ctypes.c_int,          # out order, order capacity
            ctypes.POINTER(ctypes.c_int),           # out reference count
        ]
    lib.build_wide8.restype = ctypes.c_int
    lib.build_wide8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,           # positions, tri records
        ctypes.c_int, ctypes.c_int,                 # tris, leaf size
        ctypes.c_void_p, ctypes.c_int,              # out rows, row capacity
        ctypes.POINTER(ctypes.c_int),               # out depth
        ctypes.c_void_p,                            # out order (tris)
    ]
    lib.build_mbvh8.restype = ctypes.c_int
    lib.build_mbvh8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # positions, tris, leaf size
        ctypes.c_void_p, ctypes.c_void_p,           # out bounds (cap, 48), child (cap, 8)
        ctypes.c_void_p, ctypes.c_int,              # out order (tris), node capacity
    ]
    lib.build_skip_bvh.restype = ctypes.c_int
    lib.build_skip_bvh.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # positions, tris, leaf size
        ctypes.c_void_p, ctypes.c_void_p,           # out nodes (8, cap, 8), order (tris)
        ctypes.c_int,                               # per-octant node capacity
    ]
    lib.build_wide_bvh.restype = ctypes.c_int
    lib.build_wide_bvh.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # positions, tris, leaf size
        ctypes.c_void_p,                            # tri records, original order
        ctypes.c_void_p, ctypes.c_int,              # out nodes (octants, cap, 48), capacity
        ctypes.c_int,                               # octants (1 or 8)
    ]
    lib.f2h_batch.restype = None
    lib.f2h_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # in, out, n
    _LIB = lib
    return lib


def available() -> bool:
    """The library can be used (built first when missing)."""
    return _load() is not None


def _soup(positions: np.ndarray, tri_records: np.ndarray):
    pos = np.ascontiguousarray(np.asarray(positions, np.float32).reshape(-1, 9))
    recs = np.ascontiguousarray(np.asarray(tri_records, np.float32).reshape(-1, 9))
    return pos, recs


def wide16_capacity(tri_count: int, leaf8: bool = False) -> tuple[int, int]:
    """The wide16 build's buffers, as the reference's binding sizes them:
    ``(row capacity, order capacity)``.  The order holds the SBVH's
    references (the builder's budget is ``f + f // 2 + 64``); leaf8 leaves
    hold half the triangles, so up to about twice the rows."""
    order_cap = tri_count + tri_count // 2 + 128
    return max(order_cap // 2 + order_cap // 8 + 64, 16) * (2 if leaf8 else 1), order_cap


def native_wide16(positions: np.ndarray, tri_records: np.ndarray,
                  leaf_size: int, quality: int, leaf8: bool = False):
    """Native wide16 build: ``(rows (N, 96) f32, depth, order)``, or
    ``(N, 48)`` leaf8 rows with ``leaf8``; None when the library is
    unavailable.

    ``quality`` bit 0: SBVH spatial splits (else binned SAH); bit 1: the
    SAH-optimal DP collapse (else the greedy one).  With SBVH, ``order`` is
    a reference list (original triangle ids, length >= the triangle count,
    repeats allowed).  Raises ``RuntimeError`` when the builder refuses
    (no triangles, a leaf size outside [1, leaf slots], a full buffer),
    where the reference's binding returns None."""
    lib = _load()
    if lib is None:
        return None
    fn = lib.build_wide16l8_ex if leaf8 else lib.build_wide16_ex
    pos, recs = _soup(positions, tri_records)
    f = pos.shape[0]
    cap, order_cap = wide16_capacity(f, leaf8)
    rows = np.empty((cap, 48 if leaf8 else 96), np.float32)
    order = np.empty((order_cap,), np.int32)
    depth = ctypes.c_int(0)
    nrefs = ctypes.c_int(0)
    n = fn(pos.ctypes.data, recs.ctypes.data, f, leaf_size, quality,
           rows.ctypes.data, cap, ctypes.byref(depth),
           order.ctypes.data, order_cap, ctypes.byref(nrefs))
    if n <= 0:
        raise RuntimeError(f"native wide16 build failed (returned {n})")
    return (np.ascontiguousarray(rows[:n]), int(depth.value),
            order[: nrefs.value].copy())


def native_wide8_or_none(positions: np.ndarray, tri_records: np.ndarray,
                         leaf_size: int = 4):
    """Native wide8 build: ``(rows (N, 48) f32, depth, order)``, or None
    when the library is unavailable or the build fails (as the
    reference's binding answers)."""
    lib = _load()
    if lib is None:
        return None
    pos, recs = _soup(positions, tri_records)
    f = pos.shape[0]
    cap = max(f // 2 + f // 8 + 64, 16)
    rows = np.empty((cap, 48), np.float32)
    order = np.empty((f,), np.int32)
    depth = ctypes.c_int(0)
    n = lib.build_wide8(pos.ctypes.data, recs.ctypes.data, f, leaf_size,
                        rows.ctypes.data, cap, ctypes.byref(depth), order.ctypes.data)
    if n <= 0:
        return None
    return np.ascontiguousarray(rows[:n]), int(depth.value), order


def native_build_or_none(positions: np.ndarray, leaf_size: int = 4):
    """Native 8-wide MBVH: ``(bounds (N, 48) f32, child (N, 8) i32, order
    (F,) i32)``, or None when the library is unavailable or the build
    fails."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(np.asarray(positions, np.float32).reshape(-1, 9))
    f = pos.shape[0]
    cap = max(2 * f, 16)
    bounds = np.empty((cap, 48), np.float32)
    child = np.empty((cap, 8), np.int32)
    order = np.empty((f,), np.int32)
    n = lib.build_mbvh8(pos.ctypes.data, f, leaf_size, bounds.ctypes.data, child.ctypes.data,
                        order.ctypes.data, cap)
    if n <= 0:
        return None
    return bounds[:n].copy(), child[:n].copy(), order


def native_linearize_or_none(positions: np.ndarray, leaf_size: int = 4):
    """Native skip rows: ``(nodes (8, N, 8) f32, order (F,) i32)``, or None
    when the library is unavailable or the build fails."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(np.asarray(positions, np.float32).reshape(-1, 9))
    f = pos.shape[0]
    cap = max(2 * f + 8, 16)
    nodes = np.empty((8, cap, 8), np.float32)
    order = np.empty((f,), np.int32)
    n = lib.build_skip_bvh(pos.ctypes.data, f, leaf_size, nodes.ctypes.data,
                           order.ctypes.data, cap)
    if n <= 0:
        return None
    return np.ascontiguousarray(nodes[:, :n]), order


def native_wide_or_none(positions: np.ndarray, tri_records: np.ndarray,
                        leaf_size: int = 4, octants: int = 1):
    """Native fat rows: ``(octants, N, 48)`` f32, or None when the library
    is unavailable or the build fails."""
    lib = _load()
    if lib is None:
        return None
    pos, recs = _soup(positions, tri_records)
    f = pos.shape[0]
    cap = max(f + f // 2 + 8, 16)
    nodes = np.empty((octants, cap, 48), np.float32)
    n = lib.build_wide_bvh(pos.ctypes.data, f, leaf_size, recs.ctypes.data,
                           nodes.ctypes.data, cap, octants)
    if n <= 0:
        return None
    return np.ascontiguousarray(nodes[:, :n])


def native_f2h_or_none(vals: np.ndarray) -> np.ndarray | None:
    """The builder's f32 -> canonical f16 conversion (``f2h``) of ``vals``,
    as uint16 bits, or None when the library is unavailable.  The numpy
    builders' ``accel/wide16.py::_canon_f16`` (after numpy's f16 rounding)
    must give the same bits on every input, or tables of one builder break
    the kernels' f16 decode contract (no subnormals or -0, no inf or
    nan)."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(np.asarray(vals, np.float32).ravel())
    out = np.empty(x.size, np.uint16)
    lib.f2h_batch(x.ctypes.data, out.ctypes.data, x.size)
    return out
