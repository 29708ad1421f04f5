"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled by ``nvcc`` into ``_build/libuwpt_kernels.so``, a
shared library with a plain C interface, and loaded with ctypes.  The
build is keyed by the sha1 of the sources and the compiler flags, so an
edit rebuilds and an unchanged checkout reuses the library.  Flags:
``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that every kernel
rounds op for op like its plain PyTorch twin; never ``--use_fast_math``,
which flushes denormals and approximates division and square roots.

Constants both sides must agree on (lane modes, traversal sentinels,
epsilons) are defined once in Python and passed as ``-D`` macros.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libuwpt_kernels.so")
SOURCES = ("arrival16.cu", "transition16.cu")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC"]

_LIB = None
# Seconds the last build took in this process (0.0 when the library was
# already built for these sources) and the compiler's output.
BUILD_INFO = {"seconds": 0.0, "log": ""}


def _defines() -> list[str]:
    from unity_webgpu_pathtracer_torch.ops import cuda_transition as ct
    from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as tw
    from unity_webgpu_pathtracer_torch.utils.math import EPSILON, FAR_PLANE

    ints = dict(MODE_PRIMARY=ct.MODE_PRIMARY, MODE_SHADOW_ENV=ct.MODE_SHADOW_ENV,
                MODE_DEAD=ct.MODE_DEAD, TRAV_DONE=tw.DONE, TRAV_FULL=tw.FULL)
    floats = dict(FAR_PLANE=FAR_PLANE, DET_EPS=tw.DET_EPS, T_MIN=tw.T_MIN,
                  SURF_EPSILON=EPSILON)
    return ([f"-DUWPT_{k}={v}" for k, v in ints.items()]
            # double literal cast to float: the rounding numpy's float32() does
            + [f"-DUWPT_{k}=((float){float(v)!r})" for k, v in floats.items()])


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the GPU")
    return found


def _source_key(flags: list[str]) -> str:
    h = hashlib.sha1(" ".join(flags).encode())
    for name in sorted(os.listdir(SRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(SRC_DIR, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def _build(flags: list[str], key: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [nvcc, *flags, "-o", tmp, *(os.path.join(SRC_DIR, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = proc.stdout + proc.stderr
    os.replace(tmp, LIB_PATH)
    with open(LIB_PATH + ".sha1", "w") as f:
        f.write(key)


def load() -> ctypes.CDLL:
    """The kernel library, built first if the sources changed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    flags = NVCC_FLAGS + _defines()
    key = _source_key(flags)
    try:
        with open(LIB_PATH + ".sha1") as f:
            fresh = f.read() == key and os.path.exists(LIB_PATH)
    except OSError:
        fresh = False
    if not fresh:
        _build(flags, key)
    lib = ctypes.CDLL(LIB_PATH)
    for name in ("arrival16_launch", "transition16_launch"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]   # args struct, stream
    lib.arrival16_inst_launch.restype = ctypes.c_int
    lib.arrival16_inst_launch.argtypes = [ctypes.c_void_p] * 3   # args, instance args, stream
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    _LIB = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
