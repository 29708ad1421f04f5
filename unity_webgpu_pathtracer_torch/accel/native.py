"""ctypes binding to the repository's C++ BVH builder (``native/``).

Three entries are bound: ``build_wide16_ex`` (96-float rows, 16-triangle
leaves) and ``build_wide16l8_ex`` (48-float leaf8 rows, 8-triangle
leaves), with the same arguments, and ``build_wide8`` (the 48-float wide8
rows).  The library is built with ``make -C native`` when it is missing.
When it cannot be built or loaded, the builders here return None and the
callers build in numpy (``accel/wide16.py::build_wide16``,
``accel/wide8.py::build_wide8``), as the reference's binding does; no
device path depends on it.  ``disabled()`` makes the library count as
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
    _LIB = lib
    return lib


def available() -> bool:
    """The library can be used (built first when missing)."""
    return _load() is not None


def _soup(positions: np.ndarray, tri_records: np.ndarray):
    pos = np.ascontiguousarray(np.asarray(positions, np.float32).reshape(-1, 9))
    recs = np.ascontiguousarray(np.asarray(tri_records, np.float32).reshape(-1, 9))
    return pos, recs


def native_wide16(positions: np.ndarray, tri_records: np.ndarray,
                  leaf_size: int, quality: int, leaf8: bool = False):
    """Native wide16 build: ``(rows (N, 96) f32, depth, order)``, or
    ``(N, 48)`` leaf8 rows with ``leaf8``; None when the library is
    unavailable.

    ``quality`` 1 = SBVH spatial splits, 0 = binned SAH.  With SBVH,
    ``order`` is a reference list (original triangle ids, length >= the
    triangle count, repeats allowed)."""
    lib = _load()
    if lib is None:
        return None
    fn = lib.build_wide16l8_ex if leaf8 else lib.build_wide16_ex
    pos, recs = _soup(positions, tri_records)
    f = pos.shape[0]
    # Same buffer bounds as the reference binding (SBVH ref budget).
    order_cap = f + f // 2 + 128
    # leaf8 leaves hold half the triangles: up to ~2x the rows.
    cap = max(order_cap // 2 + order_cap // 8 + 64, 16) * (2 if leaf8 else 1)
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
