"""ctypes binding to the repository's C++ BVH builder (``native/``).

Two entries are bound: ``build_wide16_ex`` (96-float rows, 16-triangle
leaves) and ``build_wide16l8_ex`` (48-float leaf8 rows, 8-triangle
leaves), with the same arguments.  The library is
built with ``make -C native`` when it is missing; if it cannot be built or
loaded this raises: the port has no numpy SBVH fallback.
"""

from __future__ import annotations

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


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(LIB_PATH):
        proc = subprocess.run(["make", "-C", NATIVE_DIR, "-s"],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 and not os.path.exists(LIB_PATH):
            raise RuntimeError(
                f"building {LIB_PATH} with make failed:\n{proc.stderr}")
    # Another process (the JAX package builds the same file in place) may
    # still be writing the library: retry the load for a while.
    deadline = time.monotonic() + 120.0
    while True:
        try:
            lib = ctypes.CDLL(LIB_PATH)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
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
    _LIB = lib
    return lib


def native_wide16(positions: np.ndarray, tri_records: np.ndarray,
                  leaf_size: int, quality: int, leaf8: bool = False):
    """Native wide16 build: ``(rows (N, 96) f32, depth, order)``, or
    ``(N, 48)`` leaf8 rows with ``leaf8``.

    ``quality`` 1 = SBVH spatial splits, 0 = binned SAH.  With SBVH,
    ``order`` is a reference list (original triangle ids, length >= the
    triangle count, repeats allowed)."""
    lib = _load()
    fn = lib.build_wide16l8_ex if leaf8 else lib.build_wide16_ex
    pos = np.ascontiguousarray(np.asarray(positions, np.float32).reshape(-1, 9))
    recs = np.ascontiguousarray(np.asarray(tri_records, np.float32).reshape(-1, 9))
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
