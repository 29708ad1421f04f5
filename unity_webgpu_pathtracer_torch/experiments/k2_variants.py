"""K2 built for several block sizes and register limits, on the H100.

``csrc/transition16.cu`` is built once per pair of its build constant
``UWPT_K2_THREADS`` (threads a block; the package builds
``cuda_transition.K2_THREADS``) and a register limit (nvcc's
``-maxrregcount``; the package leaves the registers to nvcc).  Each build
is launched through ``cuda_transition.launch`` on states captured before
the transition of super-iterations 4, 150 and 151 of the 1080p main path,
of super-iteration 4 of path C (leaf8 tables, ``attr_in_kernel``) and of
the main path with ``attr_compact=3``, held to the plain version exactly
and timed as a graph of restore + launch minus the restore.  It picks
nothing: it prints the times beside the registers.

    python -m unity_webgpu_pathtracer_torch.experiments.k2_variants
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess

import torch

from unity_webgpu_pathtracer_torch.experiments._common import (capture_inputs, clone_state,
                                                               cuda_device, ptxas_registers,
                                                               time_in_place_ms)
from unity_webgpu_pathtracer_torch.ops import cuda_build, cuda_transition

# (threads a block, registers a thread at most; None: nvcc's choice, as the
# package builds).  128 registers let 4 blocks of 128 share an SM.
SHAPES = ((128, None), (64, None), (256, None), (128, 128))


def build() -> dict[tuple, tuple[ctypes.CDLL, dict]]:
    """(threads, registers) -> (library, K2's registers), one nvcc each,
    all at once, under ``_build/k2_variants``."""
    flags = cuda_build.NVCC_FLAGS + [f for f in cuda_build._defines()
                                     if not f.startswith("-DUWPT_K2_THREADS=")]
    src = os.path.join(cuda_build.SRC_DIR, "transition16.cu")
    out_dir = os.path.join(cuda_build.BUILD_DIR, "k2_variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for threads, regs in SHAPES:
        so = os.path.join(out_dir, f"libtransition16_t{threads}_r{regs}.so")
        limit = [] if regs is None else [f"-maxrregcount={regs}"]
        jobs[(threads, regs)] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *flags, *limit, f"-DUWPT_K2_THREADS={threads}", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for shape, (so, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {shape}:\n{err}")
        lib = ctypes.CDLL(so)
        for entry, argtypes in cuda_build.ENTRIES["transition16"].items():
            getattr(lib, entry).restype = ctypes.c_int
            getattr(lib, entry).argtypes = argtypes
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        libs[shape] = (lib, ptxas_registers(out + err, "transition16"))
    return libs


def states(dev) -> list[tuple[str, object]]:
    """(label, K2Launch) in ``chip_smoke.py``'s configurations."""
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    cfg = RenderConfig(width=1920, height=1080, samples_per_pass=4, max_bounces=5,
                       transition_every=8, pool_size=98_304)
    scene, cam = million_triangle_scene(1_000_000)
    params = make_camera_params(width=1920, height=1080, device=dev, **cam)
    out = []
    for label, leaf8, c, calls in (
            ("main", False, cfg, (4, 150, 151)),
            ("path C", True, dataclasses.replace(cfg, attr_in_kernel=True), (4,)),
            ("main attr_compact=3", False, dataclasses.replace(cfg, attr_compact=3), (4,))):
        sd = scene.build("wide16", device=dev, leaf8=leaf8)
        _k1, caps = capture_inputs(sd, c, params, (), calls)
        out += [(f"{label} SI {si}", cap) for si, cap in zip(calls, caps)]
    return out


def run(device=None) -> list[dict]:
    dev = cuda_device(device)
    libs = build()
    rows = []
    for label, cap in states(dev):
        sc, cfg, pr, st0 = cap
        ref = clone_state(st0)
        died_r, rad_r = cuda_transition.transition16_plain(sc, cfg, pr, ref)
        for shape, (lib, regs) in libs.items():
            work = clone_state(st0)
            name, died, rad = cuda_transition.launch(lib, sc, cfg, pr, work)
            exact = (all(torch.equal(getattr(work, f), getattr(ref, f)) for f in st0._fields)
                     and torch.equal(died, died_r)
                     and torch.equal(rad[:, died], rad_r[:, died_r]))

            def restore(work=work):
                for f in work._fields:
                    getattr(work, f).copy_(getattr(st0, f))

            ms = time_in_place_ms(
                lambda lib=lib, work=work: cuda_transition.launch(lib, sc, cfg, pr, work),
                restore)[0]
            key = next(k for k in regs if k.endswith(f"ILi{cfg.attr_compact}E"))
            rows.append(dict(threads=shape[0], max_regs=shape[1], state=label, kernel=name,
                             lanes=st0.mode.shape[0], ms=ms, exact=exact, regs=regs[key]))
        del ref
    bad = [(r["threads"], r["max_regs"], r["state"]) for r in rows if not r["exact"]]
    if bad:
        raise AssertionError(f"builds differ from the plain version: {bad}")
    return rows


def main() -> None:
    dev = cuda_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    for r in run(dev):
        print(f"t{r['threads']} maxrreg {r['max_regs']} {r['state']:24s} {r['kernel']:18s} "
              f"B={r['lanes']}: {r['ms']:.4f} ms/launch; exact {r['exact']}; {r['regs']}",
              flush=True)


if __name__ == "__main__":
    main()
