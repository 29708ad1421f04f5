"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc``, all started together, into
``_build/lib<source>.so``, a shared library with a plain C interface,
loaded with ctypes.  Each build is keyed by the sha1 of its source and the
compiler flags, so an edit rebuilds and an unchanged checkout reuses the
library.  Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that
every kernel rounds op for op like its plain PyTorch twin; never
``--use_fast_math``, which flushes denormals and approximates division and
square roots.

Constants both sides must agree on (lane modes, traversal sentinels,
epsilons) are defined once in Python and passed as ``-D`` macros.  A
source's key also covers the headers of ``csrc/`` it includes
(``shade_common.cuh``: the device BSDF that K2 and the shading kernel
share).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C entry points of each source and their argument types; every entry
# returns a CUDA error code, and every library has ``cuda_error_string``.
ENTRIES = {
    "arrival16": {
        "arrival16_run_launch": [_P, _P],                # run args struct, stream
        "arrival16_leaf8_run_launch": [_P, _P],
        "arrival16_inst_run_launch": [_P, _P, _P],       # run args, instance args, stream
        "arrival16_inst_leaf8_run_launch": [_P, _P, _P],
        "arrival16_run_probe_launch": [_I, _P, _P, _P],  # mode, run args (in place), rows, stream
        "arrival16_diet_launch": [_I, _P, _P, _P],       # mode, run args (in place), rows, stream
    },
    "transition16": {
        "transition16_launch": [_P, _P],                 # args struct, stream
        "transition16_oct_launch": [_P, _P],
        "transition16_decode_check": [_P, _P, _I, _P, _P, _I, _P],
    },
    "shade16": {
        "shade16_launch": [_P, _P],                      # args struct, stream
        "shade16_nee_launch": [_P, _P],
    },
    "probes": {                                          # the experiments/ probes
        "ring_gather_launch": [_P, _P, _I, _P, _P],      # table, idx, chunk, out, stream
        # table, rows, idx, n_idx, out, on_chip, blocks, per, scratch, its words, stream
        "table_sum_launch": [_P, _I, _P, _I, _P, _I, _I, _I, _P, _I, _P],
        "table_sum_max_clusters": [_I, _I, _P],          # cluster, rows a rank, count out
        "schlick_chain_launch": [_P, _P, _I, _P],
        "remainder_check_launch": [_L, _L, _P, _P],      # first, count, mismatches, stream
        "lobe_chain_launch": [_P, _P, _I, _I, _P],
        "tree_gather_launch": [_P, _P, _I, _P, _P],       # table, idx, n, out, stream
        "intrinsic_launch": [_I, _P, _P, _P, _I, _P],    # op, a, b, out, n, stream
        "cumsum_i32_launch": [_P, _P, _I, _P, _I, _P],   # a, out, n, scratch, its words, stream
        # x, n, blocks, rounds, out, scratch, its words, stream
        "sum_scalar_launch": [_P, _I, _I, _I, _P, _P, _I, _P],
        "step_chain_launch": [_P, _P, _I, _P],
    },
}
SOURCES = tuple(f"{name}.cu" for name in ENTRIES)

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
# Wall seconds the last build took in this process (0.0 when every
# library was already built for its source) and the compilers' output.
BUILD_INFO = {"seconds": 0.0, "log": ""}


def _defines() -> list[str]:
    from unity_webgpu_pathtracer_torch.config import ALPHA_MODE_BLEND, ALPHA_MODE_MASK
    from unity_webgpu_pathtracer_torch.ops import cuda_arrival as ca
    from unity_webgpu_pathtracer_torch.ops import cuda_probes as cp
    from unity_webgpu_pathtracer_torch.ops import cuda_shade as cs
    from unity_webgpu_pathtracer_torch.ops import cuda_transition as ct
    from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as tw
    from unity_webgpu_pathtracer_torch.utils.math import EPSILON, FAR_PLANE

    ints = dict(MODE_PRIMARY=ct.MODE_PRIMARY, MODE_SHADOW_ENV=ct.MODE_SHADOW_ENV,
                MODE_DEAD=ct.MODE_DEAD, TRAV_DONE=tw.DONE, TRAV_FULL=tw.FULL, PROBE_PROD=0,
                K1_MIN_BLOCKS=ca.K1_MIN_BLOCKS, K2_THREADS=ct.K2_THREADS,
                SHADE_THREADS=cs.SHADE_THREADS, ALPHA_MODE_MASK=ALPHA_MODE_MASK,
                ALPHA_MODE_BLEND=ALPHA_MODE_BLEND,
                SCAN_TILE=cp.SCAN_TILE, SUM_THREADS=cp.SUM_THREADS, SUM_VEC=cp.SUM_VEC,
                SUM_MAX_BLOCKS=cp.SUM_MAX_BLOCKS, TABLE_THREADS=cp.TABLE_THREADS,
                TABLE_MAX_BLOCKS=cp.TABLE_MAX_BLOCKS, TABLE_SMEM=cp.TABLE_SMEM,
                **{f"PROBE_{m.upper()}": k for m, k in ca.PROBE_NUMBERS.items()},
                **{f"OP_{op.upper()}": k for k, op in enumerate(cp.INTRINSICS)})
    floats = dict(FAR_PLANE=FAR_PLANE, DET_EPS=tw.DET_EPS, T_MIN=tw.T_MIN,
                  SURF_EPSILON=EPSILON, REM_DIVISOR=cp.REM_DIVISOR, REM_INV=cp.REM_INV,
                  REM_LIMIT=cp.REM_LIMIT)
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


def _source_key(name: str, flags: list[str]) -> str:
    """sha1 of the flags, the source and the ``csrc/`` headers it includes."""
    h = hashlib.sha1(" ".join(flags).encode())
    with open(os.path.join(SRC_DIR, f"{name}.cu"), "rb") as f:
        text = f.read()
    h.update(text)
    for header in re.findall(rb'#include "([^"]+)"', text):
        with open(os.path.join(SRC_DIR, header.decode()), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _fresh(name: str, key: str) -> bool:
    try:
        with open(lib_path(name) + ".sha1") as f:
            return f.read() == key and os.path.exists(lib_path(name))
    except OSError:
        return False


def _build(stale: dict[str, str], flags: list[str]) -> None:
    """Compile every stale source (name -> key), one nvcc each, all at
    once; raise if any fails."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name in stale:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        cmd = [nvcc, *flags, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
        jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in jobs.items():
        out, err = proc.communicate()
        logs.append(f"{name}.cu:\n{out}{err}")
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, lib_path(name))
        with open(lib_path(name) + ".sha1", "w") as f:
            f.write(stale[name])
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = "\n".join(logs)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load() -> dict[str, ctypes.CDLL]:
    """The kernel libraries by source name (``"arrival16"``,
    ``"transition16"``, ``"shade16"``, ``"probes"``), built first where a
    source or a header it includes changed."""
    if _LIBS:
        return _LIBS
    flags = NVCC_FLAGS + _defines()
    keys = {name: _source_key(name, flags) for name in ENTRIES}
    stale = {name: key for name, key in keys.items() if not _fresh(name, key)}
    if stale:
        _build(stale, flags)
    libs = {}
    for name, entries in ENTRIES.items():
        lib = ctypes.CDLL(lib_path(name))
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
    _LIBS.update(libs)
    return _LIBS


def check_tensor(x, name: str, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels' contract, checked on either device."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}"
                         f"{'' if x.is_contiguous() else ' (non-contiguous)'}")


def check_in_place(state, fields, inputs: dict) -> None:
    """Raise unless each of ``fields`` of ``state`` (the tensors a kernel
    updates in place) has a storage of its own, shared with no other field
    and no input: an update through one would change the other."""
    owner = {}
    for name in fields:
        key = getattr(state, name).untyped_storage().data_ptr()
        if key in owner:
            raise ValueError(f"{name} shares its storage with {owner[key]}; the kernel "
                             "updates the state in place, so each field needs its own")
        owner[key] = name
    for name, x in inputs.items():
        if x is not None and x.untyped_storage().data_ptr() in owner:
            raise ValueError(f"{name} shares its storage with the state field "
                             f"{owner[x.untyped_storage().data_ptr()]}")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher of ``lib`` returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
