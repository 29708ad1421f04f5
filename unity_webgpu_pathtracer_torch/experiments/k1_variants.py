"""K1's multi-arrival kernel built for 2, 3 and 4 blocks per SM, on every
render path's states, on the H100.

``csrc/arrival16.cu`` is built once per value of its one build constant,
``K1_MIN_BLOCKS`` (``lbN``: K1 and the diet must fit N blocks of 256
threads on an SM, so at most 65,536 / (256 N) registers a thread; the
package builds ``cuda_arrival.K1_MIN_BLOCKS``).  Each build's multi-arrival
entry is launched through ``cuda_arrival.launch_steps`` on the start state
of a super-iteration captured from each path ``chip_smoke.py`` drives
(main path early and deep, path B's Cornell box with its larger pool,
path A's instanced grid, path C's leaf8 table, instanced leaf8), held to
the plain version exactly and timed as a graph of restore + launch minus
the restore.  The kernel diet (``arrival16_diet_kernel``, built for the
same blocks per SM) runs in each build too (``diet``): its ``full`` and
``no_inner`` modes on the diet's synthetic input and on the main path's
27th and 1,203rd arrivals, held exact against ``diet_step16``, timed
with a warm and a cold L2.  It picks nothing: it prints the times beside
the registers.

    python -m unity_webgpu_pathtracer_torch.experiments.k1_variants
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from unity_webgpu_pathtracer_torch.experiments._common import (capture_inputs, clone_state,
                                                               cuda_device, ptxas_registers,
                                                               time_in_place_ms)
from unity_webgpu_pathtracer_torch.ops import cuda_arrival, cuda_build
from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import arrival_steps16

BLOCKS = (2, 3, 4)


def build() -> dict[int, tuple[ctypes.CDLL, dict]]:
    """blocks per SM -> (library, K1's registers), one nvcc each, all at
    once, under ``_build/k1_variants``."""
    flags = cuda_build.NVCC_FLAGS + [f for f in cuda_build._defines()
                                     if not f.startswith("-DUWPT_K1_MIN_BLOCKS=")]
    src = os.path.join(cuda_build.SRC_DIR, "arrival16.cu")
    out_dir = os.path.join(cuda_build.BUILD_DIR, "k1_variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for blocks in BLOCKS:
        so = os.path.join(out_dir, f"libarrival16_lb{blocks}.so")
        jobs[blocks] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *flags, f"-DUWPT_K1_MIN_BLOCKS={blocks}", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for blocks, (so, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {blocks} blocks per SM:\n{err}")
        lib = ctypes.CDLL(so)
        for entry, argtypes in cuda_build.ENTRIES["arrival16"].items():
            getattr(lib, entry).restype = ctypes.c_int
            getattr(lib, entry).argtypes = argtypes
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        regs = ptxas_registers(out + err)
        libs[blocks] = (lib, {k: v for k, v in regs.items()
                              if "run_kernel" in k or "diet_kernel" in k})
    return libs


def diet(libs, inputs, label: str, modes=("full", "no_inner")) -> list[dict]:
    """The diet's ``modes`` from each build on one input (``(nodes, rows,
    oT, dT, invT, state, active)``): exact against ``diet_step16``, (warm,
    cold) ms, registers."""
    from unity_webgpu_pathtracer_torch.experiments import round14_kernel_diet as d

    nodes, rows, oT, dT, invT, s, active = inputs
    out = []
    for mode in modes:
        ref = d.diet_step16(nodes, rows, oT.T, dT.T, invT.T, s, active, mode)
        for blocks, (lib, regs) in libs.items():
            def launch(w, lib=lib):
                cuda_arrival.launch_probe(lib, nodes, rows, oT, dT, invT, w, active, mode)

            work = clone_state(s)
            launch(work)
            warm, cold = d.in_place_times(inputs, launch)
            name = f"diet_kernelILi{cuda_arrival.PROBE_NUMBERS[mode]}E"
            out.append(dict(blocks=blocks, state=label, mode=mode, ms=warm, cold_ms=cold,
                            exact=d._same(work, ref, True)[0],
                            regs=regs[next(k for k in regs if name in k)]))
    return out


def states(dev) -> list[tuple[str, object]]:
    """(label, K1Launch) at super-iteration starts of each path, in
    ``chip_smoke.py``'s configurations."""
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.benchmark import (
        instanced_million_triangle_scene, million_triangle_scene)
    from unity_webgpu_pathtracer_torch.models.cornell import cornell_box
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    hd = dict(width=1920, height=1080, max_bounces=5, transition_every=8, pool_size=98_304)
    scene, cam = million_triangle_scene(1_000_000)
    params = make_camera_params(width=1920, height=1080, device=dev, **cam)
    iscene, icam = instanced_million_triangle_scene()
    iparams = make_camera_params(width=1920, height=1080, device=dev, **icam)
    cscene, ccam = cornell_box()
    cparams = make_camera_params(width=256, height=256, device=dev, **ccam)
    out = []
    for label, sc, pr, cfg, leaf8, calls in (
            ("main", scene, params, RenderConfig(samples_per_pass=4, **hd), False, (4, 151)),
            ("Cornell", cscene, cparams,
             RenderConfig(width=256, height=256, samples_per_pass=64, max_bounces=4,
                          sky_mode=2, pool_size=1 << 17), False, (4,)),
            ("instanced", iscene, iparams, RenderConfig(samples_per_pass=2, **hd), False, (4,)),
            ("leaf8", scene, params, RenderConfig(samples_per_pass=4, attr_in_kernel=True, **hd),
             True, (4,)),
            ("instanced leaf8", iscene, iparams, RenderConfig(samples_per_pass=2, **hd), True,
             (4,))):
        sd = sc.build("wide16", device=dev, leaf8=leaf8)
        caps, _ = capture_inputs(sd, cfg, pr, calls)
        out += [(f"{label} SI {si}", cap) for si, cap in zip(calls, caps)]
    return out


def run(device=None) -> list[dict]:
    from unity_webgpu_pathtracer_torch.experiments._common import arrival_state
    from unity_webgpu_pathtracer_torch.experiments.round14_kernel_diet import synthetic_inputs

    dev = cuda_device(device)
    libs = build()
    rows = diet(libs, synthetic_inputs(dev), "synthetic")
    for label, cap in states(dev):
        if label in ("main SI 4", "main SI 151"):   # its 3rd arrival: 27 or 1,203
            nodes, oT, dT, invT, s, active = arrival_state(cap, 3)
            rows += diet(libs, (nodes, s.ptr.clone(), oT, dT, invT, s, active),
                         f"{label} arrival 3")
        nodes, oT, dT, invT, s0, steps, live, stop, hi = cap
        ref = arrival_steps16(nodes, oT.T, dT.T, invT.T, clone_state(s0), steps, live, stop, hi)
        fields = cuda_arrival._FLAT_FIELDS + (cuda_arrival._INST_FIELDS if hi else ())
        for blocks, (lib, regs) in libs.items():
            work = clone_state(s0)
            name = cuda_arrival.launch_steps(lib, nodes, oT, dT, invT, work, steps, live, stop,
                                             hi)
            exact = all(torch.equal(getattr(work, f), getattr(ref, f)) for f in s0._fields)

            def restore(work=work):
                for f in fields:
                    getattr(work, f).copy_(getattr(s0, f))

            ms = time_in_place_ms(
                lambda lib=lib, work=work: cuda_arrival.launch_steps(
                    lib, nodes, oT, dT, invT, work, steps, live, stop, hi), restore)[0]
            mangled = next(k for k in regs if k.endswith(f"Lb{int(hi)}ELi{nodes.shape[1]}E"))
            rows.append(dict(blocks=blocks, state=label, kernel=name, lanes=s0.ptr.shape[0],
                             steps=steps, ms=ms, exact=exact, regs=regs[mangled]))
        del ref
    bad = [(r["blocks"], r["state"]) for r in rows if not r["exact"]]
    if bad:
        raise AssertionError(f"builds differ from the plain version: {bad}")
    return rows


def main() -> None:
    dev = cuda_device()
    print(f"device={torch.cuda.get_device_name(dev)}")
    for r in run(dev):
        if "mode" in r:
            print(f"lb{r['blocks']} {r['state']:20s} diet {r['mode']:8s}: {r['ms']:.4f} ms warm, "
                  f"{r['cold_ms']:.4f} cold; exact {r['exact']}; {r['regs']}")
            continue
        print(f"lb{r['blocks']} {r['state']:20s} {r['kernel']:24s} B={r['lanes']} "
              f"te={r['steps']}: {r['ms']:.4f} ms/launch; exact {r['exact']}; {r['regs']}")


if __name__ == "__main__":
    main()
