#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU, the
CUDA toolkit and PyTorch built for CUDA; it imports nothing of JAX.
Phases, each printing one line:

1. build the CUDA kernels from ``unity_webgpu_pathtracer_torch/csrc``;
2. kernel K1 (wide16 arrival) against its plain twin, on the card, on a
   lane state captured from a real 1920x1080 pass over the 1M-triangle
   benchmark scene (pool 98,304);
3. kernel K2 (transition) against its twin on a pre-transition state of
   the same pass;
4. the main path through ``Renderer``: that scene (tables from the
   committed ``.bvh_cache``), 1920x1080, 5 bounces, HDRI NEE,
   ``transition_every=8``, two passes, with the kernels' launch counts;
5. the whole slice with kernels against the slice with twins on the
   card, and against the twins on the CPU, on a 2,000-triangle scene.

Every failure raises (non-zero exit).  The last two lines are the
kernels' JSON summary line and the device line; without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SPP = 4          # samples per pass in phase 4 (two passes)
POOL = 98_304
TE = 8
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class _Captured(Exception):
    pass


def capture_inputs(fused, sd, cfg, params, k1_call: int, k2_call: int):
    """Clone the inputs of the ``k1_call``-th arrival and the ``k2_call``-th
    transition of a real pass, then stop the pass."""
    import torch

    got = {}
    arrive, trans = fused.arrival_step16_cuda, fused.transition_step16_cuda
    n = {"k1": 0, "k2": 0}

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def k1(nodes, oT, dT, invT, s, active=None):
        n["k1"] += 1
        if n["k1"] == k1_call:
            got["k1"] = (nodes, oT.clone(), dT.clone(), invT.clone(),
                         s._replace(**{f: clone(getattr(s, f)) for f in s._fields}),
                         clone(active))
        return arrive(nodes, oT, dT, invT, s, active)

    def k2(**kw):
        n["k2"] += 1
        if n["k2"] == k2_call:
            got["k2"] = {k: clone(v) for k, v in kw.items()}
            raise _Captured
        return trans(**kw)

    fused.arrival_step16_cuda, fused.transition_step16_cuda = k1, k2
    try:
        fused.fused_pass_with_stats(sd, cfg, params, 0)
    except _Captured:
        pass
    finally:
        fused.arrival_step16_cuda, fused.transition_step16_cuda = arrive, trans
    if set(got) != {"k1", "k2"}:
        raise RuntimeError(f"pass ended before the capture: {sorted(got)}")
    return got["k1"], got["k2"]


def time_ms(fn, reps: int = 100) -> float:
    """Device time of one call of ``fn``: the call is captured once in a
    CUDA graph and the graph replayed ``reps`` times between two CUDA
    events, so the host's per-call Python work (checks, allocation,
    ctypes; slower than the kernels themselves) is not what is timed."""
    import torch

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


def compare(out, ref, what: str) -> float:
    """Integer fields equal, float fields within FLOAT_TOL; returns the
    largest absolute float deviation."""
    import torch

    worst = 0.0
    for name in out._fields:
        a, b = getattr(out, name), getattr(ref, name)
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, equal_nan=True, **FLOAT_TOL,
                                       msg=lambda m: f"{what}.{name}: {m}")
            fin = torch.isfinite(a) & torch.isfinite(b)
            if fin.any():
                worst = max(worst, float((a[fin] - b[fin]).abs().max()))
        elif not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{what}.{name}: {bad} lanes differ")
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    from unity_webgpu_pathtracer_torch.accel import wide16 as w16
    from unity_webgpu_pathtracer_torch.api import Renderer
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
    from unity_webgpu_pathtracer_torch.ops import cuda_arrival, cuda_build, cuda_transition
    from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import arrival_step16
    from unity_webgpu_pathtracer_torch.render import fused
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    dev = torch.device("cuda")
    card = gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ----
    t0 = time.perf_counter()
    cuda_build.load()
    regs = [ln.strip() for ln in cuda_build.BUILD_INFO["log"].splitlines()
            if "registers" in ln]
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{cuda_build.BUILD_INFO['seconds']:.2f} s); ptxas: {regs}; card: {card}")

    # ---- 2./3. kernels against twins on a real 1080p state ----
    w, h = 1920, 1080
    t0 = time.perf_counter()
    scene, cam = million_triangle_scene(1_000_000)
    sd = scene.build("wide16", device=dev)
    params = make_camera_params(width=w, height=h, device=dev, **cam)
    cfg = RenderConfig(width=w, height=h, samples_per_pass=SPP, max_bounces=5,
                       transition_every=TE, pool_size=POOL)
    log(f"scene: {sd.wide16_nodes.shape[0]} rows, depth {sd.stack_depth}, "
        f"bvh cache {w16.CACHE_STATS}, set-up {time.perf_counter() - t0:.1f} s")
    k1_in, k2_in = capture_inputs(fused, sd, cfg, params, k1_call=3 * TE + 3, k2_call=4)
    nodes, oT, dT, invT, s, active = k1_in
    out = cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active)
    ref = arrival_step16(nodes, oT.T, dT.T, invT.T, s, active)
    torch.cuda.synchronize()
    k1_err = compare(out, ref, "arrival16")
    k1_ms = time_ms(lambda: cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active))
    k1_plain = time_ms(lambda: arrival_step16(nodes, oT.T, dT.T, invT.T, s, active))
    live = int(((s.ptr >= 0) & active).sum())
    log(f"phase 2 K1 arrival16: B={s.ptr.shape[0]} live={live} max_abs_err={k1_err:g} "
        f"(tol {FLOAT_TOL}); {k1_ms:.4f} ms vs plain {k1_plain:.4f} ms")

    out = cuda_transition.transition_step16_cuda(**k2_in)
    ref = cuda_transition.transition_step16_plain(**k2_in)
    torch.cuda.synchronize()
    k2_err = compare(out, ref, "transition16")
    k2_ms = time_ms(lambda: cuda_transition.transition_step16_cuda(**k2_in))
    k2_plain = time_ms(lambda: cuda_transition.transition_step16_plain(**k2_in))
    died = int(out.died.sum())
    log(f"phase 3 K2 transition16: B={k2_in['mode'].shape[0]} died={died} "
        f"max_abs_err={k2_err:g} (tol {FLOAT_TOL}); {k2_ms:.4f} ms vs plain {k2_plain:.4f} ms")
    del k1_in, k2_in, out, ref, s, sd

    # ---- 4. the main path through Renderer ----
    scene, cam = million_triangle_scene(1_000_000)
    t0 = time.perf_counter()
    hits = w16.CACHE_STATS["hit"]
    r = Renderer(scene, cfg, make_camera_params(width=w, height=h, **cam), device="cuda")
    setup = time.perf_counter() - t0
    log(f"phase 4 set-up: {setup:.1f} s, bvh cache "
        f"{'hit' if w16.CACHE_STATS['hit'] > hits else 'miss'}, spp/pass {SPP}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_arrival.arrival_step16_cuda.launches = 0
    cuda_transition.transition_step16_cuda.launches = 0
    total_iters = 0
    for p in range(2):
        t0 = time.perf_counter()
        r.render(passes=1)
        dt = time.perf_counter() - t0
        st = r.stats()
        total_iters += st["super_iterations"]
        log(f"phase 4 pass {p}: {dt:.3f} s/pass, {st['rays'] / dt / 1e6:.3f} Mrays/s, "
            f"rays {st['rays']}, arrivals {st['arrivals']}, occupancy "
            f"{st['occupancy']:.4f}, super-iterations {st['super_iterations']}")
    k1_launches = cuda_arrival.arrival_step16_cuda.launches
    k2_launches = cuda_transition.transition_step16_cuda.launches
    img = r.film.accum
    if not (tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError(f"film not finite/positive: shape {tuple(img.shape)}, "
                             f"mean {float(img.mean())}")
    if not (k1_launches == TE * total_iters > 0 and k2_launches == total_iters > 0):
        raise AssertionError(f"launch counts K1 {k1_launches} K2 {k2_launches} vs "
                             f"{total_iters} super-iterations")
    log(f"phase 4 main path: film mean {float(img.mean()):.6f}, launches K1 "
        f"{k1_launches} K2 {k2_launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card: {card}")
    del r

    # ---- 5. slice with kernels vs slice with twins (CUDA) and CPU twins ----
    scene, cam = million_triangle_scene(2000)
    small = RenderConfig(width=40, height=24, samples_per_pass=4, max_bounces=5,
                         transition_every=4, pool_size=1024)
    films = {}
    for name, device in (("kernels", dev), ("twins", dev), ("cpu", torch.device("cpu"))):
        sd = scene.build("wide16", device=device)
        pr = make_camera_params(width=40, height=24, device=device, **cam)
        arrive, trans = fused.arrival_step16_cuda, fused.transition_step16_cuda
        if name == "twins":
            fused.arrival_step16_cuda = (
                lambda n, o, d, i, s, a=None: arrival_step16(n, o.T, d.T, i.T, s, a))
            fused.transition_step16_cuda = cuda_transition.transition_step16_plain
        try:
            film, _occ, rays, arr, _it = fused.fused_pass_with_stats(sd, small, pr, 0)
        finally:
            fused.arrival_step16_cuda, fused.transition_step16_cuda = arrive, trans
        films[name] = (film.cpu().numpy(), int(rays), int(arr))
    import numpy as np

    # Same card: counters equal.  Against the CPU (other sin/cos/log
    # builds): counters within 0.5%, as the CPU tests hold the port to JAX.
    fk, rk, ak = films["kernels"]
    for other, count_tol in (("twins", 0.0), ("cpu", 0.005)):
        fo, ro, ao = films[other]
        close = np.isclose(fk, fo, rtol=1e-4, atol=1e-6).all(-1).mean()
        mean_rel = abs(fk.mean() - fo.mean()) / abs(fo.mean())
        counts_ok = abs(rk - ro) <= count_tol * ro and abs(ak - ao) <= count_tol * ao
        if not counts_ok or close < 0.99 or mean_rel > 0.01:
            raise AssertionError(f"slice vs {other}: rays {rk}/{ro} arrivals {ak}/{ao} "
                                 f"pixels close {close:.4f} mean rel {mean_rel:g}")
        log(f"phase 5 kernels vs {other}: rays {rk}/{ro} arrivals {ak}/{ao}; pixels "
            f"within rtol 1e-4: {close:.4f}; mean rel diff {mean_rel:g}")

    kernels = [
        {"name": "arrival16", "route": "cuda",
         "source": "unity_webgpu_pathtracer_torch/csrc/arrival16.cu",
         "replaces": "unity_webgpu_pathtracer_tpu/ops/pallas_arrival.py:85",
         "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "transition16", "route": "cuda",
         "source": "unity_webgpu_pathtracer_torch/csrc/transition16.cu",
         "replaces": "unity_webgpu_pathtracer_tpu/ops/pallas_transition.py:579",
         "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
