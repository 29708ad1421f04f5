#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU, the
CUDA toolkit and PyTorch built for CUDA; it imports nothing of JAX.
Phases, each printing one or more lines:

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
   card, and against the twins on the CPU: a 2,000-triangle scene (K2
   path), ``tlas_scene(n=4)`` at 48x48 (instanced path) and the Cornell
   box at 32x32 (no sky, general transition);
6. K1's instanced kernel against its twin on a lane state captured from
   a 1920x1080 pass over the instanced copy of the benchmark grid (one
   5,040-triangle sphere BLAS, 196 sphere instances and the ground as one
   more, 987,842 instanced triangles, same HDRI and camera);
7. path A through ``Renderer``: that instanced scene at 1920x1080, 5
   bounces, HDRI, pool 98,304, te=8, two passes of 2 spp, held against
   the flat film of phase 4 (global mean within 3%; 32x32-pixel tiles,
   mean |difference| / (flat + 0.05) below 5%);
8. path B, the Cornell box at the reference bench's configuration
   (256x256, 64 spp per pass, 4 bounces, no sky, pool 131,072): K1
   against its twin on a lane state captured from that pass, then two
   passes through ``Renderer``.

The ``arrival16`` entry of the kernels' line carries phase 2's times and
the larger of the errors of phases 2 and 8.

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
SPP_INST = 2     # samples per pass in phase 7 (two passes)
POOL = 98_304
TE = 8
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
TILE = 32        # phase 7 tile statistic


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class _Captured(Exception):
    pass


def capture_inputs(fused, sd, cfg, params, k1_call: int, k2_call: int | None):
    """Clone the inputs of the ``k1_call``-th arrival and the ``k2_call``-th
    transition of a real pass (the arrival alone when ``k2_call`` is
    None), then stop the pass."""
    import torch

    got = {}
    arrive, trans = fused.arrival_step16_cuda, fused.transition_step16_cuda
    n = {"k1": 0, "k2": 0}

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def k1(nodes, oT, dT, invT, s, active=None, has_instances=False):
        n["k1"] += 1
        if n["k1"] == k1_call:
            got["k1"] = (nodes, oT.clone(), dT.clone(), invT.clone(),
                         s._replace(**{f: clone(getattr(s, f)) for f in s._fields}),
                         clone(active))
            if k2_call is None:
                raise _Captured
        return arrive(nodes, oT, dT, invT, s, active, has_instances)

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
    want = {"k1"} if k2_call is None else {"k1", "k2"}
    if set(got) != want:
        raise RuntimeError(f"pass ended before the capture: {sorted(got)}")
    return got["k1"], got.get("k2")


def instanced_bench_scene():
    """``million_triangle_scene(1_000_000)`` as a two-level scene: the
    sphere mesh once as a BLAS, one instance per grid cell with the cell's
    transform and material, the ground quad as one more instance; same
    materials, HDRI and camera."""
    from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
    from unity_webgpu_pathtracer_torch.scene.scene import Scene

    flat, cam = million_triangle_scene(1_000_000)
    scene = Scene(materials=list(flat.materials), env_image=flat.env_image)
    (sphere, _), (ground, ground_xf) = flat.meshes[0], flat.meshes[-1]
    sphere_id, ground_id = scene.add_mesh(sphere), scene.add_mesh(ground)
    for mesh, xf in flat.meshes[:-1]:
        scene.add_instance(sphere_id, xf, mesh.material_index)
    scene.add_instance(ground_id, ground_xf, ground.material_index)
    return scene, cam


def run_passes(r, passes: int, label: str) -> tuple[float, int]:
    """Render ``passes`` passes through ``r``, one line each; returns the
    total seconds and super-iterations."""
    total_s, total_iters = 0.0, 0
    for p in range(passes):
        t0 = time.perf_counter()
        r.render(passes=1)
        dt = time.perf_counter() - t0
        st = r.stats()
        total_s += dt
        total_iters += st["super_iterations"]
        log(f"{label} pass {p}: {dt:.3f} s/pass, {st['rays'] / dt / 1e6:.3f} Mrays/s, "
            f"rays {st['rays']}, arrivals {st['arrivals']}, occupancy "
            f"{st['occupancy']:.4f}, super-iterations {st['super_iterations']}")
    return total_s, total_iters


def check_film(img, shape, what: str) -> None:
    import torch

    if not (tuple(img.shape) == shape and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError(f"{what}: film not finite/positive: shape {tuple(img.shape)}, "
                             f"mean {float(img.mean())}")


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

    import numpy as np

    from unity_webgpu_pathtracer_torch.accel import wide16 as w16
    from unity_webgpu_pathtracer_torch.api import Renderer
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
    from unity_webgpu_pathtracer_torch.models.cornell import cornell_box
    from unity_webgpu_pathtracer_torch.models.examples import tlas_scene
    from unity_webgpu_pathtracer_torch.ops import cuda_arrival, cuda_build, cuda_transition
    from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import arrival_step16
    from unity_webgpu_pathtracer_torch.render import fused
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    dev = torch.device("cuda")
    card = gpu_line()

    def reset_counts():
        cuda_arrival.arrival_step16_cuda.launches = 0
        cuda_arrival.arrival_step16_cuda.launches_inst = 0
        cuda_transition.transition_step16_cuda.launches = 0

    def counts():
        return (cuda_arrival.arrival_step16_cuda.launches,
                cuda_arrival.arrival_step16_cuda.launches_inst,
                cuda_transition.transition_step16_cuda.launches)

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
    reset_counts()
    _s, total_iters = run_passes(r, 2, "phase 4")
    k1_launches, k1i, k2_launches = counts()
    flat_img = r.film.accum
    check_film(flat_img, (h, w, 3), "phase 4")
    if not (k1_launches == TE * total_iters > 0 and k2_launches == total_iters > 0
            and k1i == 0):
        raise AssertionError(f"launch counts K1 {k1_launches} K1 inst {k1i} K2 "
                             f"{k2_launches} vs {total_iters} super-iterations")
    log(f"phase 4 main path: film mean {float(flat_img.mean()):.6f}, launches K1 "
        f"{k1_launches} K2 {k2_launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card: {card}")
    del r

    # ---- 5. slice with kernels vs slice with twins (CUDA) and CPU twins ----
    def twin_arrival(n, o, d, i, s, a=None, has_instances=False):
        return arrival_step16(n, o.T, d.T, i.T, s, a, has_instances)

    scene, cam = million_triangle_scene(2000)
    tscene, tcam, tover = tlas_scene(n=4)
    cscene, ccam = cornell_box()
    cases = (
        ("bench2k", scene, cam, RenderConfig(width=40, height=24, samples_per_pass=4,
                                             max_bounces=5, transition_every=4,
                                             pool_size=1024)),
        ("tlas", tscene, tcam, RenderConfig(width=48, height=48, samples_per_pass=2,
                                            max_bounces=4, transition_every=4,
                                            pool_size=1024, **tover)),
        ("cornell", cscene, ccam, RenderConfig(width=32, height=32, samples_per_pass=4,
                                               max_bounces=4, transition_every=4,
                                               pool_size=1024, sky_mode=2)),
    )
    for case, sc, cm, small in cases:
        films = {}
        for name, device in (("kernels", dev), ("twins", dev), ("cpu", torch.device("cpu"))):
            sd = sc.build("wide16", device=device)
            pr = make_camera_params(width=small.width, height=small.height, device=device, **cm)
            arrive, trans = fused.arrival_step16_cuda, fused.transition_step16_cuda
            if name == "twins":
                fused.arrival_step16_cuda = twin_arrival
                fused.transition_step16_cuda = cuda_transition.transition_step16_plain
            try:
                film, _occ, rays, arr, _it = fused.fused_pass_with_stats(sd, small, pr, 0)
            finally:
                fused.arrival_step16_cuda, fused.transition_step16_cuda = arrive, trans
            films[name] = (film.cpu().numpy(), int(rays), int(arr))

        # Same card: counters equal.  Against the CPU (other sin/cos/log
        # builds): counters within 0.5%, as the CPU tests hold the port to JAX.
        fk, rk, ak = films["kernels"]
        for other, count_tol in (("twins", 0.0), ("cpu", 0.005)):
            fo, ro, ao = films[other]
            close = np.isclose(fk, fo, rtol=1e-4, atol=1e-6).all(-1).mean()
            mean_rel = abs(fk.mean() - fo.mean()) / abs(fo.mean())
            counts_ok = abs(rk - ro) <= count_tol * ro and abs(ak - ao) <= count_tol * ao
            if not counts_ok or close < 0.99 or mean_rel > 0.01:
                raise AssertionError(f"{case} slice vs {other}: rays {rk}/{ro} arrivals "
                                     f"{ak}/{ao} pixels close {close:.4f} mean rel {mean_rel:g}")
            log(f"phase 5 {case} kernels vs {other}: rays {rk}/{ro} arrivals {ak}/{ao}; "
                f"pixels within rtol 1e-4: {close:.4f}; mean rel diff {mean_rel:g}")

    # ---- 6. K1's instanced kernel against its twin on a real 1080p state ----
    t0 = time.perf_counter()
    iscene, icam = instanced_bench_scene()
    isd = iscene.build("wide16", device=dev)
    icfg = RenderConfig(width=w, height=h, samples_per_pass=SPP_INST, max_bounces=5,
                        transition_every=TE, pool_size=POOL)
    iparams = make_camera_params(width=w, height=h, device=dev, **icam)
    log(f"phase 6 scene: {len(iscene.instances)} instances, {isd.wide16_nodes.shape[0]} rows, "
        f"depth {isd.stack_depth}, set-up {time.perf_counter() - t0:.1f} s")
    (nodes, oT, dT, invT, s, active), _ = capture_inputs(fused, isd, icfg, iparams,
                                                          k1_call=3 * TE + 3, k2_call=None)
    out = cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active, has_instances=True)
    ref = arrival_step16(nodes, oT.T, dT.T, invT.T, s, active, has_instances=True)
    torch.cuda.synchronize()
    k1i_err = compare(out, ref, "arrival16_inst")
    k1i_ms = time_ms(lambda: cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active,
                                                              has_instances=True))
    k1i_plain = time_ms(lambda: arrival_step16(nodes, oT.T, dT.T, invT.T, s, active,
                                               has_instances=True))
    live = int(((s.ptr >= 0) & active).sum())
    in_blas = int(((s.inst >= 0) & (s.ptr >= 0) & active).sum())
    log(f"phase 6 K1 arrival16_inst: B={s.ptr.shape[0]} live={live} in_blas={in_blas} "
        f"max_abs_err={k1i_err:g} (tol {FLOAT_TOL}); {k1i_ms:.4f} ms vs plain "
        f"{k1i_plain:.4f} ms")
    del out, ref, s, nodes

    # ---- 7. path A: the instanced scene through Renderer ----
    r = Renderer(isd, icfg, iparams, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _s, iters_a = run_passes(r, 2, "phase 7")
    k1_a, k1i_launches, k2_a = counts()
    img = r.film.accum
    check_film(img, (h, w, 3), "phase 7")
    if not (k1i_launches == TE * iters_a > 0 and k1_a == 0 and k2_a == 0):
        raise AssertionError(f"phase 7 launch counts K1 inst {k1i_launches} K1 {k1_a} K2 "
                             f"{k2_a} vs {iters_a} super-iterations")
    mean_rel = abs(float(img.mean()) - float(flat_img.mean())) / float(flat_img.mean())
    rows = (h // TILE) * TILE

    def tiles(x):
        return x[:rows].reshape(rows // TILE, TILE, w // TILE, TILE, 3).mean(dim=(1, 3))

    a_t, f_t = tiles(img), tiles(flat_img)
    tile_stat = float(((a_t - f_t).abs() / (f_t + 0.05)).mean())
    if mean_rel > 0.03 or tile_stat > 0.05:
        raise AssertionError(f"phase 7 film vs flat: mean rel {mean_rel:g}, tile "
                             f"statistic {tile_stat:g}")
    log(f"phase 7 path A: film mean {float(img.mean()):.6f} (flat {float(flat_img.mean()):.6f}, "
        f"rel {mean_rel:.5f}), {TILE}x{TILE} tile statistic {tile_stat:.5f}, launches K1 "
        f"inst {k1i_launches} K1 {k1_a} K2 {k2_a}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card: {card}")
    del r, isd, flat_img, img

    # ---- 8. path B: the Cornell box at the bench's configuration ----
    cscene, ccam = cornell_box()
    ccfg = RenderConfig(width=256, height=256, samples_per_pass=64, max_bounces=4,
                        sky_mode=2, pool_size=1 << 17)
    csd = cscene.build("wide16", device=dev)
    cparams = make_camera_params(width=256, height=256, device=dev, **ccam)
    # The first arrival of a super-iteration: the box's shallow tree ends
    # most traversals within two arrivals.
    cte = ccfg.transition_every
    (nodes, oT, dT, invT, s, active), _ = capture_inputs(fused, csd, ccfg, cparams,
                                                          k1_call=3 * cte + 1, k2_call=None)
    out = cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active)
    ref = arrival_step16(nodes, oT.T, dT.T, invT.T, s, active)
    torch.cuda.synchronize()
    k1c_err = compare(out, ref, "arrival16 (Cornell)")
    k1c_ms = time_ms(lambda: cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active))
    k1c_plain = time_ms(lambda: arrival_step16(nodes, oT.T, dT.T, invT.T, s, active))
    live = int(((s.ptr >= 0) & active).sum())
    log(f"phase 8 K1 arrival16 (Cornell): B={s.ptr.shape[0]} live={live} "
        f"max_abs_err={k1c_err:g} (tol {FLOAT_TOL}); {k1c_ms:.4f} ms vs plain "
        f"{k1c_plain:.4f} ms")
    del out, ref, s, nodes
    r = Renderer(csd, ccfg, cparams, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    secs_b, iters_b = run_passes(r, 2, "phase 8")
    k1_b, k1i_b, k2_b = counts()
    img = r.film.accum
    check_film(img, (256, 256, 3), "phase 8")
    if not (k1_b == ccfg.transition_every * iters_b > 0 and k1i_b == 0 and k2_b == 0):
        raise AssertionError(f"phase 8 launch counts K1 {k1_b} K1 inst {k1i_b} K2 {k2_b} "
                             f"vs {iters_b} super-iterations")
    log(f"phase 8 path B: {r.sample_count} spp in {secs_b:.3f} s, film mean "
        f"{float(img.mean()):.6f}, launches K1 {k1_b} K2 {k2_b}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card: {card}")
    del r

    kernels = [
        {"name": "arrival16", "route": "cuda",
         "source": "unity_webgpu_pathtracer_torch/csrc/arrival16.cu",
         "replaces": "unity_webgpu_pathtracer_tpu/ops/pallas_arrival.py:85",
         "launches": k1_launches, "max_abs_err": max(k1_err, k1c_err), "ms": k1_ms,
         "plain_ms": k1_plain},
        {"name": "arrival16_inst", "route": "cuda",
         "source": "unity_webgpu_pathtracer_torch/csrc/arrival16.cu",
         "replaces": "unity_webgpu_pathtracer_tpu/ops/pallas_arrival.py:85",
         "launches": k1i_launches, "max_abs_err": k1i_err, "ms": k1i_ms,
         "plain_ms": k1i_plain},
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
