"""ctypes binding to the repository's C++ BVH builder (``native/``).

Seven entries are bound: ``build_wide16_ex`` (96-float rows, 16-triangle
leaves) and ``build_wide16l8_ex`` (48-float leaf8 rows, 8-triangle
leaves), with the same arguments, ``build_wide8`` (the 48-float wide8
rows), the reference's first three formats, with its argument lists:
``build_mbvh8`` (the 8-wide MBVH of ``accel/mbvh.py``), ``build_skip_bvh``
(the skip rows of ``accel/linearize.py``) and ``build_wide_bvh`` (the
fat rows of ``accel/wide.py``), and ``f2h_batch``, the builder's f32 ->
f16 conversion (``native_f2h_or_none``).

The package builds its own copy of the library at first use:
``native/bvh_builder.cpp`` compiled by ``g++`` with ``native/Makefile``'s
flags into ``_build/libtpubvh-<key>.so``, the key a hash of the source
and the flags.  The compiler writes a temporary file that is renamed into
place, under a lock on ``_build/libtpubvh.lock``, so processes started
together compile once and none opens a partial file.  When ``g++`` is
missing or the compile fails, the builders here return None and the
callers build in numpy (``accel/wide16.py::build_wide16``,
``accel/wide8.py::build_wide8``, ``accel/__init__.py``), as the
reference's binding does; no device path depends on it.  ``disabled()``
makes the library count as missing for a block (the fallback's test and
its chip phase).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
SRC_PATH = os.path.join(NATIVE_DIR, "bvh_builder.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
# ``native/Makefile``'s flags: other flags would make another builder.
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_LIB = None
_TRIED = False
_DISABLED = False
# The library this process loaded (``path``), whether this process
# compiled it (``compiled``, else it was reused), the seconds to build and
# load it, and why it could not be built or loaded (``error``, with the
# compiler's stderr).
BUILD_INFO = {"path": None, "compiled": False, "seconds": 0.0, "error": ""}


@contextlib.contextmanager
def disabled():
    """Within the block the library counts as missing."""
    global _DISABLED
    old, _DISABLED = _DISABLED, True
    try:
        yield
    finally:
        _DISABLED = old


def lib_path() -> str:
    """Where the library for the current source and flags is built."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SRC_PATH, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtpubvh-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile the library into ``path`` unless another process has; the
    file appears whole, by a rename, or not at all.  Raises
    ``RuntimeError`` with the reason when it cannot be built."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libtpubvh.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC_PATH],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        BUILD_INFO["compiled"] = True


def _load() -> ctypes.CDLL | None:
    """The library, built first when missing; None when it cannot be built
    or loaded (the attempt is made once a process)."""
    global _LIB, _TRIED
    if _DISABLED:
        return None
    if _TRIED:
        return _LIB
    _TRIED = True
    t0 = time.perf_counter()
    try:
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        BUILD_INFO["error"] = str(e)
        return None
    BUILD_INFO.update(path=path, seconds=time.perf_counter() - t0)
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
