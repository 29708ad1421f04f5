#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU, the
CUDA toolkit and PyTorch built for CUDA; it imports nothing of JAX.
Phases, each printing one or more lines:

1. build the CUDA kernels from ``unity_webgpu_pathtracer_torch/csrc``
   (one nvcc per source, all at once);
2. kernel K1 (wide16 arrival) against its plain twin, on the card, on a
   lane state captured from a real 1920x1080 pass over the 1M-triangle
   benchmark scene (pool 98,304): one arrival out of place on the state
   of the pass's 27th arrival (``arrival_step16_cuda``: a copy of the
   state and one launch of the multi-arrival kernel at steps = 1), and the
   multi-arrival kernel (the one the render paths launch: te arrivals, the
   state updated in place) on the start state of super-iteration 4, max
   abs error 0 on every field;
3. kernel K2 (``transition16``: the env sample, the attribute and
   material fetch and the transition, in place) against its plain version
   on the states before the transitions of super-iterations 4, 150 and 151
   of the same pass, max abs error 0 on every field the pass reads; its
   time beside the transition span's (``experiments/k2_span.py``: the
   transition without its record append and regeneration, device and
   host), registers and bound;
4. the main path through ``Renderer``: that scene (tables from the
   committed ``.bvh_cache``), 1920x1080, 5 bounces, HDRI NEE,
   ``transition_every=8``, two passes, with the kernels' launch counts
   (K1 and K2 once per super-iteration) and the kernel launches per
   super-iteration that ``torch.profiler`` counts over three of them;
   then one pass at a time with the
   one-arrival loop and with the multi-arrival kernel in turns (one-step,
   new, new, one-step) through a local hook, for s/pass and Mrays/s;
5. the whole slice with kernels against the slice with twins on the
   card, and against the twins on the CPU, on seven small cases: a
   2,000-triangle scene (K2 path; on leaf8 rows with ``attr_in_kernel``;
   with ``attr_compact=3``, K2's oct entry ``transition16_oct``),
   ``tlas_scene(n=4)`` at 48x48 (instanced path;
   on leaf8 BLAS rows) and the Cornell box at 32x32 (no sky, general
   transition; with ``attr_compact=3``);
6. K1's instanced kernels against their twins on lane states captured
   from a 1920x1080 pass over the instanced copy of the benchmark grid
   (one 5,040-triangle sphere BLAS, 196 sphere instances and the ground
   as one more, 987,842 instanced triangles, same HDRI and camera);
7. path A through ``Renderer``: that instanced scene at 1920x1080, 5
   bounces, HDRI, pool 98,304, te=8, one pass of 2 spp, held against
   the flat film of phase 4 (global mean within 3%; 32x32-pixel tiles,
   mean |difference| / (flat + 0.05) below 5%); then the turns;
8. path B, the Cornell box at the reference bench's configuration
   (256x256, 64 spp per pass, 4 bounces, no sky, pool 131,072, te=4):
   K1's kernels against their twins on the start state of super-iteration
   4 of that pass, then two passes through ``Renderer``;
9. K1 on leaf8 rows (``arrival16_leaf8``, ``arrival16_leaf8_run``)
   against its twins on lane states captured from a 1080p pass over the
   benchmark scene built as a leaf8 table (natively, at first use: the
   build seconds are printed);
10. K2 against its plain version on a pre-transition state of the same
    pass (path C's ``attr_in_kernel``: the same ``transition16``), and
    ``transition16_oct`` on a state of that pass with ``attr_compact=3``;
    the kernels' f16 decode over all 65,536 halfwords and their uint32 ->
    uniform conversion at the uint32 edges;
11. path C through ``Renderer``: the leaf8 benchmark scene with
    ``attr_in_kernel``, as phase 4 otherwise (K2 ``transition16`` once per
    super-iteration), held against phase 4's film as path A is, with its
    kernel launches per super-iteration; then the turns;
12. K1's instanced leaf8 kernels against their twins on the instanced
    grid with leaf8 BLAS rows, then one pass of 2 spp of that scene
    through ``Renderer``, held against phase 4's film; then the turns;
13. the probes of ``experiments/`` (``unity_webgpu_pathtracer_torch/
    experiments``, this slice's path): each module's ``run`` at its
    probe's sizes, every probe kernel held against its plain version (the
    counts set to 0 before and read after: every probe kernel must have
    launched; the ring gather, P2, the one-pass scan, the sum and every
    op of P8 also after their timed graph replays, the ops and the sum at
    the pool's 98,304 too, the scan and the sum at ragged sizes and at
    4,194,304; P3 bit for bit; the kernels line gives a kernel's last row:
    ring_gather at 8,192 rows of the 232 MB table, P2 on chip at 2 MB on a
    cluster of 16 and in device memory at 24 MB, the scan and the sum at
    the pool's 98,304), a line with P3's remainder against fmodf over all
    2^31 non-negative f32 bit patterns (0 mismatches, or the phase
    fails), P2's cluster sizes with the clusters of them the card can hold
    (``cudaOccupancyMaxActiveClusters``), each P2 row beside the launch
    floor (a graph-replayed one-element add), PyTorch's reductions of the
    pool as a super-iteration calls
    them (``round18_mosaic_probe.reductions``, priced a super-iteration by
    the calls phase 4's profile counted), then K1's probe
    modes (in place, timed with the L2 flushed after each restore and
    warm: the kernel diet, each mode bounded by its own bytes; and the
    bf16 leaf decode, one arrival of the multi-arrival kernel on the row
    plane, bounded by its in-place bytes, the out-of-place yardstick
    logged beside it) on states of phase 2's pass at its 27th arrival (the third of
    super-iteration 4), its 1,200th (the last of super-iteration 150,
    about halfway, when most lanes have ended their segment) and its
    1,203rd (the third of super-iteration 151), each reached from the
    captured start state of its super-iteration by the one-arrival
    wrapper, with its time, distinct rows and bound on each;
    and the multi-arrival kernel on the start states of super-iterations
    4, 150 and 151; P8's and P10's rows beside the launch floor;
14. the renderer's user surface: (a) phase 4's film through
    ``Renderer.save_png`` into ``chiprun_out/phase14/``, read back with the
    port's ``read_png`` and held equal to ``Renderer.image()``, with the
    write's seconds; (b) ``cli.main(["render", "builtin:<name>", ...])`` in
    process for each of the nine builtins at the cli's defaults (512x512,
    passes of 4 spp, 5 bounces, ACES) but 16 spp, each pass timed by a
    local hook around ``Renderer.step``, K1 launched once a super-iteration on
    every scene and K2 on ``brdf`` and ``sponza_like`` only, the PNG read
    back equal to ``Renderer.image()``; (c) the benchmark grid at 1920x1080
    with the HDRI and ``lights_scene``'s three lights (``has_lights``: env
    NEE and light NEE through the general transition's merged evaluation),
    one pass of 2 spp through ``Renderer``, its launches per
    super-iteration, a PNG; (d) every builtin but ``tlas`` (whose committed
    golden saw only the sky) rendered on the card at the golden
    configuration and held to its golden by
    ``tests/golden_common.py::compare_to_golden``, loaded with
    ``UWPT_GOLDEN_NATIVE_BACKEND=1`` so that it imports only numpy; JAX
    must not have been imported;
15. the reference's other integrators, loaders and checkpoints: (a) the
    megakernel (``integrator="megakernel"``) on phase 4's scene at
    1920x1080, 1 spp (2,073,600 lanes a bounce), 5 bounces, the HDRI,
    two passes through ``Renderer``, only K1 launched (its flat kernel,
    through ``closest_hit``/``occluded``), each pass's s/pass, rays (a hook
    around ``integrator.render_pass`` passes ``trace_bounce``'s
    ``with_stats`` counts), K1 launches and host reads, peak memory; the
    film held to phase 4's as path A is; K1's first launch of the pass
    (every lane at the root) against its twin, timed, at that width;
    (f) a checkpoint after pass 1, loaded into a new ``Renderer``: pass 2
    gives the uninterrupted film bit for bit; (b) the wavefront
    (``integrator="wavefront"``, pool 65,536) on the same scene, twice with
    one seed (bit-equal films; at 1 spp it equals the megakernel's first
    pass), held to phase 4's film; (e) the grid written as OBJ + MTL (a
    PNG ``map_Kd``, floats as ``%.9g``) and as GLB (an embedded PNG) into
    ``chiprun_out/phase15/``, loaded by the port's loaders (the flattened
    positions equal the written ones bit for bit) and rendered by
    ``cli.main(["render", <file>, "--size", "512", "--spp", "8"])``, with
    the seconds to load, build and render (the model files are deleted
    after, keeping the output directory small); (d) the
    megakernel on the goldens of every builtin but ``tlas`` under
    ``tests/golden_gen.py``'s cross-check gate (four passes,
    ``golden_common.dual_flags`` at z 8: bad fraction below 1%, or below
    3% with the mean within 0.5%, and the mean within 2%), and Cornell on
    the brute-force oracle.  Phase 5 also holds a megakernel and a
    wavefront slice of the 2,000-triangle grid;
16. the interactive surface: (a) phase 4's film (1920x1080, 8 spp)
    reprojected on phase 4's ``Renderer``: the identity (exact: counts 8,
    accum within rtol/atol 1e-5), ``update_camera(reproject=True)`` on a
    move of 0.2% of the view distance (> 70% of pixels kept), the camera
    turned round (> 90% dropped), each timed, with their K1 launches (one
    per host read of the two traversals) and the warp's PyTorch launches
    (``torch.profiler``); the next pass from the per-pixel film, its
    checkpoint round trip bit for bit; K1 on ``primary_depth``'s first
    launch against its twin (max abs error 0); ``reproject_film`` on the
    card against the CPU on Cornell at 128x128 (counts equal, accum within
    1e-6); (b) ``preview`` at 1080p (seconds, K1 launches, a finite image,
    a PNG), K1 on its first launch against its twin, Cornell at 128x128
    against the CPU (>= 99% of pixels within rtol/atol 1e-4); (c) ``cli
    view builtin:cornell --port 0`` in a thread (256x256), driven over HTTP
    (``GET /``, ``/state``, ``/frame.png``, ``POST /camera`` without and
    with reprojection, ``POST /material``), then ``builtin:tlas`` with
    ``POST /bounce``: passes per second, seconds per request, K1 launches
    equal to the loop's super-iterations plus the reprojection's host
    reads (counted from the render and handler threads); it fails if the
    loop died; (d) ``cli animate builtin:cornell --orbit``, ``builtin:tlas
    --orbit --bounce`` (8 frames each) and ``builtin:brdf --orbit`` (2
    frames, K2) at 256x256: seconds per frame, launches, consecutive
    frames differing (two unlit frames of the box's outside excepted);
17. multi-GPU (``parallel/film_tiling.py``): two rank processes of
    ``unity_webgpu_pathtracer_torch/experiments/multigpu.py`` share the
    card over gloo (NCCL refuses two ranks on one device, so this measures
    the program, not scaling), started with ``subprocess`` after phase 1
    built the kernels (they only load them), with a ``file://``
    rendezvous in a temporary directory outside the repository and a
    process-group timeout; each builds the benchmark scene from the
    ``.bvh_cache`` and runs (a) the main path sharded, 1920x1080, 4 spp,
    on a (tile=2, spp=1) and a (tile=1, spp=2) grid, (b) the megakernel on
    the tile grid at 1 spp, (c) BASELINE's config 5 at 3840x2160 (a
    sharded pass of 1 spp a rank, ``reproject_film`` across a move of
    0.2% of the view distance, a second sharded pass), (d) the 1080p and
    4K films' all-reduce and all-gather alone; each rank reports its
    seconds, super-iterations, K1/K2 launches (counts set to 0 before
    each step and read after), peak memory and collective seconds, and
    rank 0 holds every film against one rank's pass of the same samples
    (rtol 1e-6, atol 1e-7, rays equal; the share bitwise equal printed).
    A rank that exits non-zero or outlives ``RANK_LIMIT_S`` fails the
    phase with its stderr, and the other is killed;
18. the rest of the reference: (a) ``utils/math.py::sqrt`` on the card
    equals the correctly rounded f32 root of the CPU helper bit for bit
    on 2^24 values over [0, 1e6] with 0, -0, subnormals, inf and NaN;
    (b) the main path's scene and settings (1080p, 4 spp, one pass each)
    at ``attr_compact=0`` and at
    ``attr_compact=1``: the general transition, so K1 once a
    super-iteration and K2 never; mode 1 against the mode-2 pass of the
    same samples (K2; >= 99% of pixels within rtol 1e-3 / atol 1e-5, mean
    within 0.5%) and, with mode 0, against phase 4's film
    (``film_vs_flat``); (c) the grid with 65,537 materials (the five
    repeated round-robin; the meshes' indices reach 65,536): the build
    warns with the reference's text, the megakernel renders it bit for bit
    as it renders the grid's own materials, the fused pass at mode 0
    renders it bit for bit as (b)'s mode-0 pass, and a mode-2 pass is refused with
    the reference's message; (d) one pass each of the legacy film, the
    sorted film at ``film_k_shift`` 0 and 1 (the general transition) and
    the record film at shift 1 (K2): rays and arrivals equal, and films
    within rtol 3e-7 / atol 1e-7 of, the record film at shift 0 on the
    same transition (mode 1's pass of (b), the mode-2 pass); launches;
    whether two legacy passes (480x270) are bitwise equal (their adds are
    atomic); (e) wide8: the megakernel (480x270, 1 spp) on the grid's wide8
    table, the 1080p primary rays' hits held to K1's on the wide16 table (the
    share with the same triangle record, and t), a fused pass at 480x270
    held to the wide16 one (film means within 2%), and the instanced grid's wide8 megakernel
    render held to its two-level wide16 render at 640x360, each timed; (f)
    with the
    native library disabled, the numpy wide16 build of an 80,642-triangle
    grid (timed, validated, the only numpy build of the smoke; the
    scene build, also with the library disabled, loads it from the numpy
    builder's own cache key, which the native key does not name), one fused
    pass on it through K1 and K2, and K1 on a captured state against its
    twin (``check_run``).

Every kernel's line gives its launches on its path, its largest error
against its twin, its device time and its twin's, and its bound: the
least time an H100 could take for the same work, the larger of the bytes
it must move (each input read once, each output written once; for K1 the
distinct node rows the live lanes load) over 3.35 TB/s and its
operations at the card's issue rate for their type: unfused f32 (the
kernels are built with -fmad=false) at 132 SMs x 128 lanes x 1.98 GHz =
33.45e12/s, packed bf16 (the bf16 lobe chain) at 66.9e12
lane-operations/s.  The multi-arrival kernels
update their state in place, so a CUDA graph replays a restore of the
captured state (``copy_`` from a clone), a write of 128 MB that flushes
the L2, and the launch, and the graph of the restore and the flush alone
is subtracted (``ms``; the reading without the flush, which also charges
the kernel for the next restore's L2 misses, is logged beside it, and
``_common.restore_penalty`` prices those misses on phase 13's states);
their bound is
``experiments/_common.py::arrivals_work`` (the state of the lanes that
step, read and written once a launch; the rows of every arrival; 8 bytes
a stack push or a pop from memory), and so does K2, whose bound is
``experiments/_common.py::transition_work`` (the state each lane's case
reads, the field elements that change, each distinct attribute, material
and env row once; operations counted from its source).  The one-arrival
entries (``arrival16``, ...) are the multi-arrival kernel at steps = 1
on a copy of the state (K1's and K2's rows name their CUDA kernel as
``kernel``); no render path
calls them: their ``launches`` are 0, and their launches in the one-step
turns stand in ``turn_launches``.  No
single PyTorch call computes an arrival or a transition, so
``library_ms`` is null for K1 and K2; for a probe it
is the one PyTorch call that computes the same function where there is
one (``table[idx]`` for P1's and P7's gathers, ``embedding_bag`` for P2,
whose two calls ``tab[li, 0].sum()`` are logged beside it,
``torch.sum``, ``torch.sin`` and the others); a probe measured at
several sizes reports its last row.  ``arrival16_run``'s ``launches``
sums its launches on the render paths that use it whole (phase 4's
fused pass, 15a's megakernel, 15b's wavefront), given one by one in
``launches_by_path``, with phase 16's ``reproject``, ``preview``,
``viewer`` and ``animate`` and phase 17's ``multigpu`` (both ranks'
launches) (``arrival16_inst_run`` and ``transition16`` likewise add the
viewer's and animate's launches, and ``transition16`` phase 17's);
``megakernel_launch`` gives its time, bound and error on 15a's first
launch (B = 2,073,600), ``primary_depth_launch`` and ``preview_launch``
on 16a's and 16b's.

Every failure raises (non-zero exit).  The last two lines are the
kernels' JSON summary line and the device line; without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

SPP = 4          # samples per pass in phases 4 and 11 (two passes)
SPP_INST = 2     # samples per pass in phases 7 and 12
POOL = 98_304
TE = 8
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
TILE = 32        # film tile statistic of phases 7, 11 and 12
K2_AT = (4, 150, 151)   # super-iterations whose transition state phase 3 captures
# Phase 14b's cli render: the cli's defaults (512x512, passes of 4 spp, ACES)
# but 16 spp, not 64: four passes a builtin keep the smoke within half its
# time limit since phase 15 joined it.
CLI_ARGS = ("--spp", "16")
RANKS = 2           # phase 17's rank processes, sharing the one card over gloo
RANK_LIMIT_S = 420  # phase 17 fails if a rank has not ended by then


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_ranks(world: int, limit: float) -> list[dict]:
    """Start ``world`` rank processes of ``experiments/multigpu.py`` on the
    card (gloo, a ``file://`` rendezvous in a temporary directory outside
    the repository) and wait for them at most ``limit`` seconds.  A rank
    that exits non-zero, or outlives the limit, fails the phase with its
    stderr, and every rank still running is killed.  Returns the ranks'
    reports, by rank."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory(prefix="uwpt_multigpu_") as tmp:
        procs = []
        try:
            for rank in range(world):
                err = open(os.path.join(tmp, f"rank{rank}.err"), "w+")
                procs.append((subprocess.Popen(
                    [sys.executable, "-m", "unity_webgpu_pathtracer_torch.experiments.multigpu",
                     "--rank", str(rank), "--world", str(world), "--backend", "gloo",
                     "--init", f"file://{tmp}/rendezvous", "--out", tmp],
                    cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err), err))
            deadline = time.monotonic() + limit
            while True:
                codes = [p.poll() for p, _ in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                late = time.monotonic() > deadline and None in codes
                if bad or late:
                    rank = bad[0] if bad else codes.index(None)
                    why = f"exited {codes[rank]}" if bad else f"still running after {limit} s"
                    err = procs[rank][1]
                    err.seek(0)
                    raise AssertionError(f"phase 17: rank {rank} {why}; its stderr:\n"
                                         f"{err.read()[-6000:]}")
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.5)
            reports = []
            for rank in range(world):
                with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                    reports.append(json.load(f))
            return reports
        finally:
            for p, err in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                err.close()


def run_passes(r, passes: int, label: str) -> tuple[float, int, int, int]:
    """Render ``passes`` passes through ``r``, one line each; returns the
    total seconds, super-iterations, rays and arrivals."""
    total_s, total_iters, rays, arrivals = 0.0, 0, 0, 0
    for p in range(passes):
        t0 = time.perf_counter()
        r.render(passes=1)
        dt = time.perf_counter() - t0
        st = r.stats()
        total_s += dt
        total_iters += st["super_iterations"]
        rays += st["rays"]
        arrivals += st["arrivals"]
        log(f"{label} pass {p}: {dt:.3f} s/pass, {st['rays'] / dt / 1e6:.3f} Mrays/s, "
            f"rays {st['rays']}, arrivals {st['arrivals']}, occupancy "
            f"{st['occupancy']:.4f}, super-iterations {st['super_iterations']}")
    return total_s, total_iters, rays, arrivals


def check_film(img, shape, what: str) -> None:
    import torch

    if not (tuple(img.shape) == shape and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError(f"{what}: film not finite/positive: shape {tuple(img.shape)}, "
                             f"mean {float(img.mean())}")


def film_vs_flat(img, flat_img, what: str) -> tuple[float, float]:
    """Hold a film of the benchmark grid against phase 4's: global mean
    within 3%, 32x32-pixel tiles' mean |difference| / (flat + 0.05) below
    5%; returns (relative mean difference, tile statistic)."""
    h, w = flat_img.shape[:2]
    mean_rel = abs(float(img.mean()) - float(flat_img.mean())) / float(flat_img.mean())
    rows = (h // TILE) * TILE

    def tiles(x):
        return x[:rows].reshape(rows // TILE, TILE, w // TILE, TILE, 3).mean(dim=(1, 3))

    a_t, f_t = tiles(img), tiles(flat_img)
    tile_stat = float(((a_t - f_t).abs() / (f_t + 0.05)).mean())
    if mean_rel > 0.03 or tile_stat > 0.05:
        raise AssertionError(f"{what} film vs flat: mean rel {mean_rel:g}, tile "
                             f"statistic {tile_stat:g}")
    return mean_rel, tile_stat


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


def write_obj_model(path: str, positions, indices, normals, uvs, texture) -> None:
    """Write one indexed mesh as ``path`` (OBJ, 1-based ``v/vt/vn``
    corners, floats as ``%.9g`` so the text round trip of every float32 is
    exact) with a ``.mtl`` beside it whose one material binds ``texture``
    ((H, W, 3|4) uint8) as a PNG ``map_Kd``."""
    import numpy as np

    from unity_webgpu_pathtracer_torch.utils.image import write_png

    base = os.path.splitext(path)[0]
    stem = os.path.basename(base)
    write_png(base + "_kd.png", texture)
    with open(base + ".mtl", "w") as f:
        f.write(f"newmtl grid\nKd 1 1 1\nNs 250\nmap_Kd {stem}_kd.png\n")

    def rows(tag, a):
        a = np.asarray(a, np.float32)
        fmt = " ".join(["%.9g"] * a.shape[1])
        return "\n".join(f"{tag} " + fmt % tuple(r) for r in a.tolist()) + "\n"

    idx = np.asarray(indices, np.int64) + 1
    faces = "\n".join(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}" for a, b, c in idx.tolist())
    with open(path, "w") as f:
        f.write(f"mtllib {stem}.mtl\n")
        f.write(rows("v", positions))
        f.write(rows("vt", uvs))
        f.write(rows("vn", normals))
        f.write("usemtl grid\n" + faces + "\n")


def write_glb_model(path: str, positions, indices, normals, uvs, texture) -> None:
    """Write one indexed mesh as a binary glTF: float32 POSITION, NORMAL
    and TEXCOORD_0, uint32 indices, one node without a transform, one
    material whose base colour texture is ``texture`` embedded as PNG."""
    import struct

    import numpy as np

    from unity_webgpu_pathtracer_torch.utils.image import encode_png

    parts = [np.ascontiguousarray(positions, np.float32).tobytes(),
             np.ascontiguousarray(normals, np.float32).tobytes(),
             np.ascontiguousarray(uvs, np.float32).tobytes(),
             np.ascontiguousarray(indices, np.uint32).tobytes(), encode_png(texture)]
    views, blob = [], b""
    for p in parts:
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(p)})
        blob += p + b"\x00" * ((4 - len(p) % 4) % 4)
    n, m = len(positions), len(indices)
    pos = np.asarray(positions, np.float32)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                   "TEXCOORD_0": 2},
                                    "indices": 3, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                "roughnessFactor": 0.6}}],
        "textures": [{"source": 0}], "images": [{"bufferView": 4, "mimeType": "image/png"}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": n, "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": n, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": n, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5125, "count": 3 * m, "type": "SCALAR"}],
        "bufferViews": views, "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    with open(path, "wb") as f:
        f.write(b"glTF" + struct.pack("<II", 2, 28 + len(js) + len(blob)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)


def model_of(scene):
    """One indexed mesh of a flat scene's meshes in world space, in the
    order ``Scene.flatten`` emits their triangles: ``(positions, indices,
    normals, uvs)``."""
    import numpy as np

    from unity_webgpu_pathtracer_torch.scene.mesh import flatten_mesh

    pos, idx, nrm, uv, base = [], [], [], [], 0
    for mesh, xf in scene.meshes:
        flat = flatten_mesh(mesh, xf)
        p = mesh.vertices
        n = mesh.normals if mesh.normals is not None else mesh.compute_vertex_normals()
        if xf is not None:
            m = np.asarray(xf, np.float64)
            p = (p @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
            n = n @ np.linalg.inv(m[:3, :3])
            n = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20))
        if not np.array_equal(p[mesh.indices], flat.positions):
            raise AssertionError("model_of: world positions differ from Scene.flatten's")
        pos.append(p)
        nrm.append(np.asarray(n, np.float32))
        uv.append(mesh.uvs if mesh.uvs is not None else np.zeros((len(p), 2), np.float32))
        idx.append(mesh.indices + base)
        base += len(p)
    return (np.concatenate(pos), np.concatenate(idx), np.concatenate(nrm),
            np.concatenate(uv).astype(np.float32))


def checker_texture(size: int = 64):
    """(size, size, 4) uint8 checker: the model files' base colour map."""
    import numpy as np

    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    c = (((xx // 8) + (yy // 8)) % 2 * 120 + 100).astype(np.uint8)
    return np.stack([c, 255 - c, np.full_like(c, 140), np.full_like(c, 255)], -1)


def golden_passes(name: str, golden_common):
    """The per-pass mean images of builtin ``name`` rendered on the card at
    the golden configuration (``golden_common.build_scene``'s: 64x64, 32
    spp, 4 bounces, pool 4096, the firefly clamp at luminance 2), one pass
    for each seed of the test family."""
    import numpy as np

    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.examples import EXAMPLES
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
    from unity_webgpu_pathtracer_torch.render.fused import fused_pass_with_stats

    scene, cam, over = EXAMPLES[name]()
    over = dict(over)
    over.setdefault("has_lights", bool(scene.lights))
    over.setdefault("has_textures", bool(scene.textures))
    size, spp = golden_common.SIZE, golden_common.SPP
    cfg = RenderConfig(width=size, height=size, samples_per_pass=spp, max_bounces=4,
                       pool_size=4096, use_firefly_filter=True, **over)
    sd = scene.build()
    out = []
    for seed in golden_common.seed_roots(golden_common.TEST_SEED_BASE,
                                         golden_common.N_TEST_PASSES):
        params = make_camera_params(width=size, height=size, **cam, seed_root=np.uint32(seed),
                                    max_firefly_luminance=np.float32(2.0))
        film, *_ = fused_pass_with_stats(sd, cfg, params, 0)
        out.append(film.cpu().numpy().reshape(size, size, 3) / spp)
    return np.stack(out)


def golden_megakernel_passes(name: str, golden_common, traversal: str = "wide16"):
    """``tests/golden_gen.py``'s megakernel cross-check passes of builtin
    ``name`` rendered on the card: the golden configuration (64x64, 32 spp,
    4 bounces, the firefly clamp at luminance 2) with the megakernel on
    ``traversal``, one pass for each of its four seeds (``GEN_SEED_BASE +
    100 + i * 1000003``), as per-pass mean images."""
    import numpy as np

    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.examples import EXAMPLES
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
    from unity_webgpu_pathtracer_torch.render.integrator import render_pass

    scene, cam, over = EXAMPLES[name]()
    over = dict(over)
    over.setdefault("has_lights", bool(scene.lights))
    over.setdefault("has_textures", bool(scene.textures))
    size, spp = golden_common.SIZE, golden_common.SPP
    cfg = RenderConfig(width=size, height=size, samples_per_pass=spp, max_bounces=4,
                       pool_size=4096, use_firefly_filter=True, integrator="megakernel",
                       traversal=traversal, **over)
    sd = scene.build(traversal)
    out = []
    for i in range(4):
        params = make_camera_params(
            width=size, height=size, **cam, max_firefly_luminance=np.float32(2.0),
            seed_root=np.uint32(golden_common.GEN_SEED_BASE + 100 + i * 1000003))
        out.append(render_pass(sd, cfg, params, 0).cpu().numpy().reshape(size, size, 3) / spp)
    return np.stack(out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    import numpy as np

    from unity_webgpu_pathtracer_torch import api, cli
    from unity_webgpu_pathtracer_torch.accel import wide16 as w16
    from unity_webgpu_pathtracer_torch.api import Renderer
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.experiments import k2_span
    from unity_webgpu_pathtracer_torch.experiments._common import (K1Launch, K2Launch,
                                                                   arrival_state, arrival_work,
                                                                   arrivals_work, bound,
                                                                   capture_inputs, clone_state,
                                                                   launch_floor_ms, one_step_loop,
                                                                   ptxas_registers,
                                                                   restore_penalty, running,
                                                                   time_in_place_ms, time_ms,
                                                                   transition_work)
    from unity_webgpu_pathtracer_torch.models.benchmark import (
        instanced_million_triangle_scene, million_triangle_scene)
    from unity_webgpu_pathtracer_torch.models.cornell import cornell_box
    from unity_webgpu_pathtracer_torch.models.examples import EXAMPLES, lights_scene, tlas_scene
    from unity_webgpu_pathtracer_torch.ops import cuda_arrival, cuda_build, cuda_transition
    from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as tw16
    from unity_webgpu_pathtracer_torch.ops.traverse_wide16 import arrival_step16, arrival_steps16
    from unity_webgpu_pathtracer_torch.render import fused, integrator, wavefront
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
    from unity_webgpu_pathtracer_torch.utils import rng as urng
    from unity_webgpu_pathtracer_torch.utils.image import read_png

    dev = torch.device("cuda")
    card = gpu_line()
    arrivals_n = cuda_arrival.arrival_step16_cuda.launches
    runs_n = cuda_arrival.arrival_steps16_cuda.launches
    transitions_n = cuda_transition.transition16_cuda.launches

    def reset_counts():
        for counter in (arrivals_n, runs_n, transitions_n):
            for k in counter:
                counter[k] = 0

    def counts() -> dict:
        return {**arrivals_n, **runs_n, **transitions_n}

    def expect_only(got: dict, want: dict, what: str) -> None:
        """Exactly the kernels in ``want`` launched, that many times."""
        full = dict.fromkeys(got, 0) | want
        if got != full or not all(v > 0 for v in want.values()):
            raise AssertionError(f"{what} launch counts {got}, expected {full}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {}

    def record(name, source, replaces, err, ms, plain, work_bytes, ops, kernel):
        b_ms, b_by = bound(work_bytes, ops)
        kernels[name] = {"name": name, "route": "cuda",
                         "source": f"unity_webgpu_pathtracer_torch/csrc/{source}",
                         "kernel": kernel, "replaces": replaces, "launches": 0,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None}
        return f"bound {b_ms:.4f} ms ({b_by}, {work_bytes / 1e6:.2f} MB, {ops / 1e6:.2f} Mflop)"

    K1_SRC, K1_TPU = "arrival16.cu", "unity_webgpu_pathtracer_tpu/ops/pallas_arrival.py:85"
    K2_SRC, K2_TPU = "transition16.cu", "unity_webgpu_pathtracer_tpu/ops/pallas_transition.py:579"
    ONE_ARRIVAL = "arrival16_run_kernel (steps = 1, on a copy of the state)"

    def check_arrival(name, k1_in, has_instances, label):
        """K1 against its twin on a captured state; timing and bound."""
        nodes, oT, dT, invT, s, active = k1_in
        out = cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active, has_instances)
        ref = arrival_step16(nodes, oT.T, dT.T, invT.T, s, active, has_instances)
        torch.cuda.synchronize()
        err = compare(out, ref, name)
        ms = time_ms(lambda: cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active,
                                                              has_instances))
        plain = time_ms(lambda: arrival_step16(nodes, oT.T, dT.T, invT.T, s, active,
                                               has_instances))
        nbytes, ops, rows = arrival_work(nodes, s.ptr, oT, dT, invT, s, active, has_instances)
        live = int(((s.ptr >= 0) & active).sum())
        b = record(name, K1_SRC, K1_TPU, err, ms, plain, nbytes, ops, ONE_ARRIVAL)
        log(f"{label} K1 {name}: B={s.ptr.shape[0]} live={live} distinct rows={rows} "
            f"max_abs_err={err:g} (tol {FLOAT_TOL}); {ms:.4f} ms vs plain {plain:.4f} ms; {b}")

    def log_penalty(restore, label):
        p = restore_penalty(restore)
        log(f"{label} restore penalty (a 55 MB read as the in-place call): "
            + ", ".join(f"{k} {v:.4f}" for k, v in p.items())
            + f"; in place - alone {p['in_place_ms'] - p['read_ms']:.4f} ms warm, "
            f"{p['in_place_cold_ms'] - p['read_cold_ms']:.4f} cold; restore cold - warm "
            f"{p['restore_cold_ms'] - p['restore_ms']:.4f} ms; card: {card}")

    def k1_exact(cap: K1Launch, name) -> float:
        """The multi-arrival kernel against its plain version on a captured
        start state: max abs error 0 on every field, or it raises."""
        nodes, oT, dT, invT, s0, steps, live, stop, hi = cap
        out, ref = clone_state(s0), clone_state(s0)
        cuda_arrival.arrival_steps16_cuda(nodes, oT, dT, invT, out, steps, live, stop, hi)
        arrival_steps16(nodes, oT.T, dT.T, invT.T, ref, steps, live, stop, hi)
        torch.cuda.synchronize()
        err = compare(out, ref, name)
        if err != 0.0:
            raise AssertionError(f"{name}: max abs error {err:g}, expected 0")
        return err

    @contextlib.contextmanager
    def first_k1(caps: list):
        """Keep the inputs of the first K1 launch made through
        ``cuda_arrival.arrival_steps16_cuda`` (``closest_hit``/``occluded``
        read it at call time) in ``caps``."""
        arrive = cuda_arrival.arrival_steps16_cuda

        def capture(nodes, oT, dT, invT, s, steps, live=None, stop=None, hi=False):
            if not caps:
                caps.append(K1Launch(nodes, oT.clone(), dT.clone(), invT.clone(), clone_state(s),
                                     steps, None if live is None else live.clone(),
                                     None if stop is None else stop.clone(), hi))
            return arrive(nodes, oT, dT, invT, s, steps, live, stop, hi)

        capture.launches = arrive.launches   # the wrapper counts through its module name
        cuda_arrival.arrival_steps16_cuda = capture
        try:
            yield caps
        finally:
            cuda_arrival.arrival_steps16_cuda = arrive

    def check_run(name, cap: K1Launch, label, record_it=True, penalty=False):
        """The multi-arrival kernel against its plain version on a captured
        super-iteration start state, max abs error 0 on every field; its
        time per launch (a graph of restore + flush + launch, minus a graph
        of restore + flush; warm: without the flush), the one-arrival
        wrapper's on the same arrivals, the plain version's, and the bound of
        ``arrivals_work``; ``penalty``: ``restore_penalty`` of its restore."""
        nodes, oT, dT, invT, s0, steps, live, stop, hi = cap
        err = k1_exact(cap, name)
        fields = cuda_arrival._FLAT_FIELDS + (cuda_arrival._INST_FIELDS if hi else ())
        work = clone_state(s0)

        def restore():
            for f in fields:
                getattr(work, f).copy_(getattr(s0, f))

        def launch():
            cuda_arrival.arrival_steps16_cuda(nodes, oT, dT, invT, work, steps, live, stop, hi)

        ms, t_run, t_restore = time_in_place_ms(launch, restore, cold=True)
        warm = time_in_place_ms(launch, restore)[0]
        plain_ms = time_in_place_ms(
            lambda: arrival_steps16(nodes, oT.T, dT.T, invT.T, work, steps, live, stop, hi),
            restore, cold=True)[0]
        if penalty:
            log_penalty(restore, f"{label} K1 {name}")
        one, st = [], s0   # the one-arrival wrapper on each of the same arrivals
        for _ in range(steps):
            act = running(live, stop, st)
            one.append(time_ms(lambda st=st, act=act: cuda_arrival.arrival_step16_cuda(
                nodes, oT, dT, invT, st, act, hi)))
            st = cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, st, act, hi)
        nbytes, ops, rows, n = arrivals_work(nodes, oT, dT, invT, s0, steps, live, stop, hi)
        b_ms, b_by = bound(nbytes, ops)
        if record_it:
            record(name, K1_SRC, K1_TPU, err, ms, plain_ms, nbytes, ops, "arrival16_run_kernel")
        result = {"lanes": s0.ptr.shape[0], "max_abs_err": err, "ms": ms, "warm_ms": warm,
                  "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        log(f"{label} K1 {name} ({steps} arrivals, in place): B={s0.ptr.shape[0]} lanes "
            f"stepping={n['lanes']} distinct rows={rows} pushes={n['pushes']} pops from "
            f"memory={n['pops']} max_abs_err={err:g} (every field, stack planes included); "
            f"{ms:.4f} ms per launch (graph of restore + flush + launch {t_run:.4f} ms, "
            f"restore + flush {t_restore:.4f} ms; warm {warm:.4f} ms); one-arrival wrapper {steps} x {one[0]:.4f} = "
            f"{steps * one[0]:.4f} ms on the start state, {sum(one):.4f} ms summed over the "
            f"{steps} arrivals; plain {plain_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}, "
            f"{nbytes / 1e6:.3f} MB, {ops / 1e6:.2f} Mflop); card: {card}")
        return result

    def check_transition(name, k2: K2Launch, label, record_it=True):
        """K2 against its plain version on a captured pre-transition state,
        max abs error 0 on every state field, on died, and on rad_out where
        a lane died; its time (a graph of restore + flush + launch, minus a
        graph of restore + flush; warm: without the flush), the plain
        version's, and the bound of ``transition_work``."""
        sc, kcfg, kpr, st0 = k2
        out, ref = clone_state(st0), clone_state(st0)
        died, rad = cuda_transition.transition16_cuda(sc, kcfg, kpr, out)
        died_r, rad_r = cuda_transition.transition16_plain(sc, kcfg, kpr, ref)
        torch.cuda.synchronize()
        err = compare(out, ref, name)
        if not torch.equal(died, died_r):
            raise AssertionError(f"{name}.died: {int((died != died_r).sum())} lanes differ")
        torch.testing.assert_close(rad[:, died], rad_r[:, died], rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"{name}.rad_out: {m}")
        if err != 0.0:
            raise AssertionError(f"{name}: max abs error {err:g}, expected 0")
        work = clone_state(st0)

        def restore():
            for f in work._fields:
                getattr(work, f).copy_(getattr(st0, f))

        def launch():
            cuda_transition.transition16_cuda(sc, kcfg, kpr, work)

        ms, t_run, t_restore = time_in_place_ms(launch, restore, cold=True)
        warm = time_in_place_ms(launch, restore)[0]
        plain_ms = time_in_place_ms(
            lambda: cuda_transition.transition16_plain(sc, kcfg, kpr, work), restore,
            cold=True)[0]
        nbytes, ops, n = transition_work(k2, ref, died_r)
        b_ms, b_by = bound(nbytes, ops)
        if record_it:
            record(name, K2_SRC, K2_TPU, err, ms, plain_ms, nbytes, ops, "transition16_kernel")
        log(f"{label} K2 {name} (in place): B={st0.mode.shape[0]} lanes {n} died="
            f"{int(died.sum())} max_abs_err={err:g} (every field; rad_out where died); "
            f"{ms:.4f} ms per launch (graph of restore + flush + launch {t_run:.4f} ms, "
            f"restore + flush {t_restore:.4f} ms; warm {warm:.4f} ms); plain {plain_ms:.4f} ms; "
            f"bound {b_ms:.5f} ms ({b_by}, "
            f"{nbytes / 1e6:.3f} MB, {ops / 1e6:.2f} Mflop); card: {card}")

    def launches_per_si(sd_, cfg_, params_, label):
        c = k2_span.launches_per_si(sd_, cfg_, params_)
        if c["kernels"] <= 0:
            raise AssertionError(f"{label}: torch.profiler saw no device kernel: {c}")
        log(f"{label} kernel launches per super-iteration (torch.profiler, super-iterations "
            f"{k2_span.PROFILE_SI[0]}-{k2_span.PROFILE_SI[1] - 1}): {c['kernels_per_si']:.1f} "
            f"kernels, {c['memcpy_memset_per_si']:.1f} memcpy/memset; {c}; card: {card}")
        return c

    def turns(r, label, one_name, run_name, te):
        """One pass at a time from a reset film (the same work each time)
        with the one-arrival loop and with the multi-arrival kernel, in
        turns (one-step, new, new, one-step); records the one-arrival
        kernel's launches over its two passes as its ``turn_launches``."""
        arrive = fused.arrival_steps16_cuda
        secs, one_launches = {"one-step": [], "new": []}, 0
        for mode in ("one-step", "new", "new", "one-step"):
            r.reset()
            torch.cuda.synchronize()
            reset_counts()
            if mode == "one-step":
                fused.arrival_steps16_cuda = one_step_loop
            try:
                t0 = time.perf_counter()
                r.render(passes=1)   # ends in a synchronize
                dt = time.perf_counter() - t0
            finally:
                fused.arrival_steps16_cuda = arrive
            st = r.stats()
            got = {k: v for k, v in counts().items() if k.startswith("arrival16")}
            want = ({one_name: te * st["super_iterations"]} if mode == "one-step"
                    else {run_name: st["super_iterations"]})
            expect_only(got, want, f"{label} {mode} turn")
            one_launches += got[one_name]
            secs[mode].append(dt)
            log(f"{label} turn {mode}: {dt:.3f} s/pass, {st['rays'] / dt / 1e6:.3f} Mrays/s, "
                f"rays {st['rays']}, arrivals {st['arrivals']}, super-iterations "
                f"{st['super_iterations']}, K1 launches {want}")
        log(f"{label} turns: one-step {[round(x, 3) for x in secs['one-step']]} s/pass, "
            f"multi-arrival {[round(x, 3) for x in secs['new']]} s/pass; card: {card}")
        kernels[one_name]["turn_launches"] = one_launches

    # ---- 1. build ----
    t0 = time.perf_counter()
    cuda_build.load()
    regs = [ln.strip() for ln in cuda_build.BUILD_INFO["log"].splitlines()
            if "registers" in ln]
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s (nvcc, all sources at once, "
        f"{cuda_build.BUILD_INFO['seconds']:.2f} s); ptxas: {regs}; card: {card}")
    log(f"phase 1 K1 registers: {ptxas_registers(cuda_build.BUILD_INFO['log'])}; K2 "
        f"registers: {ptxas_registers(cuda_build.BUILD_INFO['log'], 'transition16')}")

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
    (cap,), k2caps = capture_inputs(sd, cfg, params, k1_calls=(4,), k2_calls=K2_AT)
    check_arrival("arrival16", arrival_state(cap, 3), False, "phase 2")
    check_run("arrival16_run", cap, "phase 2")
    for si, k2 in zip(K2_AT, k2caps):
        check_transition("transition16", k2, f"phase 3 super-iteration {si}",
                         record_it=si == K2_AT[0])
    span, restore = k2_span._span_fns(k2_span.capture_spans(sd, cfg, params, at=(4,))[0])
    restore()
    sp_ms, sp_both, sp_restore = time_in_place_ms(span, restore)
    log(f"phase 3 transition span at super-iteration 4 (the transition without its record "
        f"append and regeneration, experiments/k2_span.py): device {sp_ms:.4f} ms (graph of "
        f"restore + span {sp_both:.4f}, restore {sp_restore:.4f}); host wall eager "
        f"{k2_span.host_ms(span, restore):.4f} ms; card: {card}")
    del cap, k2caps, span, restore, sd

    # ---- 4. the main path through Renderer ----
    scene, cam = million_triangle_scene(1_000_000)
    t0 = time.perf_counter()
    hits = w16.CACHE_STATS["hit"]
    r = Renderer(scene, cfg, make_camera_params(width=w, height=h, **cam))
    setup = time.perf_counter() - t0
    log(f"phase 4 set-up: {setup:.1f} s, bvh cache "
        f"{'hit' if w16.CACHE_STATS['hit'] > hits else 'miss'}, spp/pass {SPP}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    secs_4, iters_4, rays_4, arr_4 = run_passes(r, 2, "phase 4")
    got = counts()
    expect_only(got, {"arrival16_run": iters_4, "transition16": iters_4}, "phase 4")
    kernels["arrival16_run"]["launches"] = got["arrival16_run"]
    kernels["transition16"]["launches"] = got["transition16"]
    flat_img = r.film.accum.clone()
    main_film, flat_mean = r.film, float(flat_img.mean())   # presented in phase 14a
    check_film(flat_img, (h, w, 3), "phase 4")
    log(f"phase 4 main path: film mean {float(flat_img.mean()):.6f}, launches {got}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card: {card}")
    main_si = launches_per_si(r.scene, cfg, r.params, "phase 4 main path")
    if main_si["reductions_per_si"]["any"] < 1:   # the loop's test, once a super-iteration
        raise AssertionError(f"phase 4: the profile saw no reduction: {main_si}")
    turns(r, "phase 4", "arrival16", "arrival16_run", TE)
    main_r, main_cam = r, dict(cam)   # phase 16 reprojects phase 4's film
    del r

    # ---- 5. slice with kernels vs slice with twins (CUDA) and CPU twins ----
    def twin_arrivals(n, o, d, i, s, steps, live=None, stop=None, has_instances=False):
        return arrival_steps16(n, o.T, d.T, i.T, s, steps, live, stop, has_instances)

    def run_slice(sd, cfg_, pr):
        """One pass of ``cfg_``'s integrator: (film, rays, arrivals); the
        megakernel and the wavefront count the host reads of their
        traversals' loop test (8 arrivals each) for arrivals."""
        if cfg_.integrator == "fused":
            film, _occ, rays, arr, _it = fused.fused_pass_with_stats(sd, cfg_, pr, 0)
            return film, rays, arr
        tw16.TRAVERSE_STATS.update(calls=0, host_reads=0)
        if cfg_.integrator == "megakernel":
            st = {}
            film = integrator.render_pass(sd, cfg_, pr, 0, stats=st)
            rays = st["closest"] + st["shadow"]
        else:
            film, _occ, closest, shadow = wavefront.wavefront_pass_with_stats(sd, cfg_, pr, 0)
            rays = closest + shadow
        return film, rays, tw16.TRAVERSE_STATS["host_reads"]

    scene, cam = million_triangle_scene(2000)
    tscene, tcam, tover = tlas_scene(n=4)
    cscene, ccam = cornell_box()
    bench = dict(width=40, height=24, samples_per_pass=4, max_bounces=5, transition_every=4,
                 pool_size=1024)
    tlas = dict(width=48, height=48, samples_per_pass=2, max_bounces=4, transition_every=4,
                pool_size=1024, **tover)
    box = dict(width=32, height=32, samples_per_pass=4, max_bounces=4, transition_every=4,
               pool_size=1024, sky_mode=2)
    cases = (  # (name, scene, camera, config, leaf8, kernels the case must launch)
        ("bench2k", scene, cam, RenderConfig(**bench), False, ("arrival16_run", "transition16")),
        ("bench2k leaf8 attr_in_kernel", scene, cam, RenderConfig(**bench, attr_in_kernel=True),
         True, ("arrival16_leaf8_run", "transition16")),
        ("bench2k attr_compact=3", scene, cam, RenderConfig(**bench, attr_compact=3), False,
         ("arrival16_run", "transition16_oct")),
        ("tlas", tscene, tcam, RenderConfig(**tlas), False, ("arrival16_inst_run",)),
        ("tlas leaf8", tscene, tcam, RenderConfig(**tlas), True, ("arrival16_inst_leaf8_run",)),
        ("cornell", cscene, ccam, RenderConfig(**box), False, ("arrival16_run",)),
        ("cornell attr_compact=3", cscene, ccam, RenderConfig(**box, attr_compact=3), False,
         ("arrival16_run",)),
        ("bench2k megakernel", scene, cam, RenderConfig(**dict(bench, samples_per_pass=2),
                                                        integrator="megakernel"),
         False, ("arrival16_run",)),
        ("bench2k wavefront", scene, cam, RenderConfig(**dict(bench, pool_size=333),
                                                       integrator="wavefront"),
         False, ("arrival16_run",)),
    )
    for case, sc, cm, small, leaf8, used in cases:
        films = {}
        for name, device in (("kernels", dev), ("twins", dev), ("cpu", torch.device("cpu"))):
            sd = sc.build("wide16", device=device, leaf8=leaf8)
            pr = make_camera_params(width=small.width, height=small.height, device=device, **cm)
            arrive, trans = fused.arrival_steps16_cuda, fused.transition16_cuda
            if name == "twins":
                fused.arrival_steps16_cuda = twin_arrivals
                fused.transition16_cuda = cuda_transition.transition16_plain
                cuda_arrival.arrival_steps16_cuda = twin_arrivals
            reset_counts()
            try:
                film, rays, arr = run_slice(sd, small, pr)
            finally:
                fused.arrival_steps16_cuda, fused.transition16_cuda = arrive, trans
                cuda_arrival.arrival_steps16_cuda = arrive
            if name == "kernels":
                launched = {k for k, v in counts().items() if v > 0}
                if launched != set(used):
                    raise AssertionError(f"{case}: kernels launched {launched}, expected {used}")
                if "transition16_oct" in used:
                    oct_launches = counts()["transition16_oct"]
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
    iscene, icam = instanced_million_triangle_scene()
    isd = iscene.build("wide16", device=dev)
    icfg = RenderConfig(width=w, height=h, samples_per_pass=SPP_INST, max_bounces=5,
                        transition_every=TE, pool_size=POOL)
    iparams = make_camera_params(width=w, height=h, device=dev, **icam)
    log(f"phase 6 scene: {len(iscene.instances)} instances, {isd.wide16_nodes.shape[0]} rows, "
        f"depth {isd.stack_depth}, set-up {time.perf_counter() - t0:.1f} s")
    (cap,), _ = capture_inputs(isd, icfg, iparams, k1_calls=(4,))
    k1_in = arrival_state(cap, 3)
    check_arrival("arrival16_inst", k1_in, True, "phase 6")
    s = k1_in[4]
    log(f"phase 6 lanes inside a BLAS: "
        f"{int(((s.inst >= 0) & (s.ptr >= 0) & k1_in[5]).sum())}")
    check_run("arrival16_inst_run", cap, "phase 6")
    del k1_in, s, cap

    # ---- 7. path A: the instanced scene through Renderer ----
    r = Renderer(isd, icfg, iparams)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # One pass (two before phase 17 joined the smoke): its 2 spp hold
    # the flat film within the same bounds as phase 12's one pass.
    _s, iters_a, _rays, _arr = run_passes(r, 1, "phase 7")
    got = counts()
    expect_only(got, {"arrival16_inst_run": iters_a}, "phase 7")
    kernels["arrival16_inst_run"]["launches"] = got["arrival16_inst_run"]
    img = r.film.accum
    check_film(img, (h, w, 3), "phase 7")
    mean_rel, tile_stat = film_vs_flat(img, flat_img, "phase 7")
    log(f"phase 7 path A: film mean {float(img.mean()):.6f} (flat {float(flat_img.mean()):.6f}, "
        f"rel {mean_rel:.5f}), {TILE}x{TILE} tile statistic {tile_stat:.5f}, launches {got}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card: {card}")
    turns(r, "phase 7", "arrival16_inst", "arrival16_inst_run", TE)
    del r, isd, img

    # ---- 8. path B: the Cornell box at the bench's configuration ----
    cscene, ccam = cornell_box()
    ccfg = RenderConfig(width=256, height=256, samples_per_pass=64, max_bounces=4,
                        sky_mode=2, pool_size=1 << 17)
    csd = cscene.build("wide16", device=dev)
    cparams = make_camera_params(width=256, height=256, device=dev, **ccam)
    # The first arrival of a super-iteration: the box's shallow tree ends
    # most traversals within two arrivals.
    (cap,), _ = capture_inputs(csd, ccfg, cparams, k1_calls=(4,))
    nodes, oT, dT, invT, s, active = arrival_state(cap, 1)
    out = cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active)
    ref = arrival_step16(nodes, oT.T, dT.T, invT.T, s, active)
    torch.cuda.synchronize()
    k1c_err = compare(out, ref, "arrival16 (Cornell)")
    k1c_ms = time_ms(lambda: cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active))
    k1c_plain = time_ms(lambda: arrival_step16(nodes, oT.T, dT.T, invT.T, s, active))
    kernels["arrival16"]["max_abs_err"] = max(kernels["arrival16"]["max_abs_err"], k1c_err)
    live = int(((s.ptr >= 0) & active).sum())
    log(f"phase 8 K1 arrival16 (Cornell): B={s.ptr.shape[0]} live={live} "
        f"max_abs_err={k1c_err:g} (tol {FLOAT_TOL}); {k1c_ms:.4f} ms vs plain "
        f"{k1c_plain:.4f} ms")
    check_run("arrival16_run", cap, "phase 8 (Cornell)", record_it=False)
    del out, ref, s, nodes, cap
    r = Renderer(csd, ccfg, cparams)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    secs_b, iters_b, _rays, _arr = run_passes(r, 2, "phase 8")
    got = counts()
    expect_only(got, {"arrival16_run": iters_b}, "phase 8")
    img = r.film.accum
    check_film(img, (256, 256, 3), "phase 8")
    log(f"phase 8 path B: {r.sample_count} spp in {secs_b:.3f} s, film mean "
        f"{float(img.mean()):.6f}, launches {got}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card: {card}")
    del r, img

    # ---- 9./10. leaf8 K1 and raw-row K2 against twins on a 1080p state ----
    scene, cam = million_triangle_scene(1_000_000)
    lcfg = RenderConfig(width=w, height=h, samples_per_pass=SPP, max_bounces=5,
                        transition_every=TE, pool_size=POOL, attr_in_kernel=True)
    t0 = time.perf_counter()
    misses = w16.CACHE_STATS["miss"]
    lsd = scene.build("wide16", device=dev, leaf8=True)
    built = "built natively" if w16.CACHE_STATS["miss"] > misses else "from the cache"
    log(f"phase 9 leaf8 scene: {lsd.wide16_nodes.shape[0]} rows of "
        f"{lsd.wide16_nodes.shape[1]} floats ({lsd.wide16_nodes.nbytes / 2**20:.1f} MiB), depth "
        f"{lsd.stack_depth}, table {built} in {time.perf_counter() - t0:.1f} s")
    (cap,), (k2,) = capture_inputs(lsd, lcfg, params, k1_calls=(4,), k2_calls=(4,))
    check_arrival("arrival16_leaf8", arrival_state(cap, 3), False, "phase 9")
    check_run("arrival16_leaf8_run", cap, "phase 9")
    del cap

    check_transition("transition16", k2, "phase 10 (path C, attr_in_kernel)", record_it=False)
    ocfg = dataclasses.replace(lcfg, attr_compact=3, attr_in_kernel=False)
    _, (k2o,) = capture_inputs(lsd, ocfg, params, k1_calls=(), k2_calls=(4,))
    check_transition("transition16_oct", k2o, "phase 10 (attr_compact=3)")
    kernels["transition16_oct"]["launches"] = oct_launches
    del k2, k2o
    halves = torch.arange(65536, dtype=torch.int32, device=dev)
    k = np.arange(-4, 5)
    u32 = np.concatenate([[0, 1, 2, 0xFFFFFFFE, 0xFFFFFFFF], 2**31 + k, 2**24 + k, 2**32 - 2**7 + k,
                          np.random.default_rng(0).integers(0, 2**32, 1 << 16)]).astype(np.int64)
    got_h, got_u = cuda_transition.decode_check_cuda(halves, torch.from_numpy(u32).to(dev))
    want_h = np.arange(65536).astype(np.uint16).view(np.float16).astype(np.float32)
    want_u = torch.from_numpy(u32).to(dev).to(torch.float32) * urng._INV_U32
    if not (np.array_equal(got_h.cpu().numpy().view(np.uint32), want_h.view(np.uint32))
            and torch.equal(got_u.view(torch.int32), want_u.view(torch.int32))):
        raise AssertionError("the kernels' f16 decode or uint32 -> f32 uniform differs")
    log(f"phase 10 decode check: f16 decode bit-exact against numpy over 65536 halfwords; "
        f"uint32 -> uniform bit-exact against PyTorch's int64 -> f32 on {u32.size} states "
        f"(0, 2^31+-4, 2^24+-4, 2^32-2^7+-4, 0xFFFFFFFF, random)")

    # ---- 11. path C: the leaf8 scene with attr_in_kernel through Renderer ----
    r = Renderer(lsd, lcfg, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _s, iters_c, rays_c, arr_c = run_passes(r, 2, "phase 11")
    got = counts()
    expect_only(got, {"arrival16_leaf8_run": iters_c, "transition16": iters_c}, "phase 11")
    kernels["arrival16_leaf8_run"]["launches"] = got["arrival16_leaf8_run"]
    img = r.film.accum
    check_film(img, (h, w, 3), "phase 11")
    mean_rel, tile_stat = film_vs_flat(img, flat_img, "phase 11")
    log(f"phase 11 path C: rays {rays_c} (phase 4: {rays_4}), arrivals {arr_c} (phase 4: "
        f"{arr_4}), super-iterations {iters_c} (phase 4: {iters_4}); film mean "
        f"{float(img.mean()):.6f} (flat {float(flat_img.mean()):.6f}, rel {mean_rel:.5f}), "
        f"{TILE}x{TILE} tile statistic {tile_stat:.5f}, launches {got}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card: {card}")
    launches_per_si(lsd, lcfg, params, "phase 11 path C")
    turns(r, "phase 11", "arrival16_leaf8", "arrival16_leaf8_run", TE)
    del r, lsd, img

    # ---- 12. K1's instanced leaf8 kernel, and one pass of that scene ----
    t0 = time.perf_counter()
    isd = iscene.build("wide16", device=dev, leaf8=True)
    log(f"phase 12 scene: {isd.wide16_nodes.shape[0]} rows of {isd.wide16_nodes.shape[1]} "
        f"floats, depth {isd.stack_depth}, set-up {time.perf_counter() - t0:.1f} s")
    (cap,), _ = capture_inputs(isd, icfg, iparams, k1_calls=(4,))
    check_arrival("arrival16_inst_leaf8", arrival_state(cap, 3), True, "phase 12")
    check_run("arrival16_inst_leaf8_run", cap, "phase 12")
    del cap
    r = Renderer(isd, icfg, iparams)
    reset_counts()
    _s, iters_d, _rays, _arr = run_passes(r, 1, "phase 12")
    got = counts()
    expect_only(got, {"arrival16_inst_leaf8_run": iters_d}, "phase 12")
    kernels["arrival16_inst_leaf8_run"]["launches"] = got["arrival16_inst_leaf8_run"]
    img = r.film.accum
    check_film(img, (h, w, 3), "phase 12")
    mean_rel, tile_stat = film_vs_flat(img, flat_img, "phase 12")
    log(f"phase 12 instanced leaf8: film mean {float(img.mean()):.6f} (rel {mean_rel:.5f}), "
        f"{TILE}x{TILE} tile statistic {tile_stat:.5f}, launches {got}; card: {card}")
    turns(r, "phase 12", "arrival16_inst_leaf8", "arrival16_inst_leaf8_run", TE)
    del r, isd, img   # flat_img: phases 15 and 18 hold their films to it

    # ---- 13. the probes of experiments/ ----
    from unity_webgpu_pathtracer_torch.experiments import (round2_probe, round14_kernel_diet,
                                                           round16_bf16leaf_probe,
                                                           round18_bf16_shade_probe,
                                                           round18_mosaic_probe,
                                                           round18_vmem_tree_probe,
                                                           round20_tile3d_probe)
    from unity_webgpu_pathtracer_torch.ops import cuda_probes
    from unity_webgpu_pathtracer_torch.ops.cuda_arrival import DIET_MODES

    probe_counts = (cuda_probes.LAUNCHES, cuda_arrival.arrival_probe_cuda.launches)
    for counter in probe_counts:
        for k in counter:
            counter[k] = 0
    t0 = time.perf_counter()
    rows = []
    for mod in (round2_probe, round14_kernel_diet, round16_bf16leaf_probe,
                round18_bf16_shade_probe, round18_vmem_tree_probe, round18_mosaic_probe,
                round20_tile3d_probe):
        got_rows = mod.run(dev)
        rows += got_rows
        for r in got_rows:
            lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
            if "cold_ms" in r:
                lib += f", cold L2 {r['cold_ms']:.4f} ms"
            if "warm_ms" in r:
                lib += f", warm L2 {r['warm_ms']:.4f} ms (ms: cold L2)"
            if "old_bound_ms" in r:
                lib += f", out-of-place bound {r['old_bound_ms']:.5f} ms"
            if "two_calls_ms" in r:
                lib += f", two calls {r['two_calls_ms']:.4f} ms"
            if "floor_ms" in r:
                lib += (f", launch floor {r['floor_ms']:.4f} ms, "
                        + (f"cluster of {r['cluster']}" if "cluster" in r
                           else f"{r['blocks']} blocks"))
            log(f"phase 13 {mod.__name__.rsplit('.', 1)[1]} {r['name']}: {r['ms']:.4f} ms "
                f"({r['ns_per']:.4f} ns/{r['per']}), plain {r['plain_ms']:.4f} ms{lib}; bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {r['bytes'] / 1e6:.3f} MB, "
                f"{r['ops'] / 1e6:.2f} Mflop f32"
                + (f" + {r['bf16_ops'] / 1e6:.2f} Mflop bf16" if r["bf16_ops"] else "")
                + f"); max_abs_err {r['max_abs_err']:g} ({r['tol']})"
                + (f"; ulps {r['ulps']}, exact {r['exact']}" if "ulps" in r else ""))
    got = {k: v for counter in probe_counts for k, v in counter.items()}
    if not all(v > 0 for v in got.values()):
        raise AssertionError(f"phase 13: probe kernels never launched: "
                             f"{[k for k, v in got.items() if v == 0]}")
    log(f"phase 13 probes: {len(rows)} measurements in {time.perf_counter() - t0:.1f} s, "
        f"launches {got}")
    shade = next(r for r in rows if r["kernel"] == "schlick_chain")
    log(f"phase 13 P3 remainder by 0.9f against fmodf over all 2^31 non-negative f32 bit "
        f"patterns: {shade['remainder_mismatches']} mismatches")
    row_bytes = cuda_probes.TABLE_W * 4
    for label, n in (("192 KB", 192 * 1024 // row_bytes), ("2 MB", int(2e6 / row_bytes))):
        c, per, fit = cuda_probes.table_max_clusters(n, dev)
        log(f"phase 13 P2 on chip, {label} table: a cluster of {c} blocks, {per} rows "
            f"({per * row_bytes} bytes) a block; cudaOccupancyMaxActiveClusters {fit}")
    red = round18_mosaic_probe.reductions(dev, main_si["reductions_per_si"])
    log(f"phase 13 reductions of {POOL} lanes (ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in red.items())
        + f" ({main_si['reductions_per_si']} calls a super-iteration, phase 4's profile); "
        f"card: {card}")
    diet_rows = [r for r in rows if r["kernel"].startswith("arrival16_diet")]
    for key, l2 in (("ms", "cold"), ("warm_ms", "warm")):
        for mode, (dt, share) in round14_kernel_diet.savings(diet_rows, key=key).items():
            log(f"phase 13 synthetic diet ({l2} L2): {mode} saves {dt:.4f} ms "
                f"({share * 100:.1f}%)")
    log_penalty(round14_kernel_diet.restorer(round14_kernel_diet.synthetic_inputs(dev))[1],
                "phase 13 synthetic diet")
    log(f"phase 13 lobe chain: bf16 / f32 time {round18_bf16_shade_probe.ratio(rows):.3f}; "
        f"card: {card}")
    replaces = {  # kernel name prefix -> the Pallas probe it replaces
        "ring_gather": "round2_probe.py:125", "table_sum": "round2_probe.py:177",
        "schlick_chain": "round2_probe.py:271", "arrival16_diet": "round14_kernel_diet.py:260",
        "arrival16_f16leaf": "round16_bf16leaf_probe.py:75",
        "arrival16_bf16leaf": "round16_bf16leaf_probe.py:75",
        "lobe_chain": "round18_bf16_shade_probe.py:78",
        "tree_gather": "round18_vmem_tree_probe.py:63",
        "intrinsic": "round18_mosaic_probe.py:35", "sum_scalar": "round18_mosaic_probe.py:111",
        "step_chain": "round20_tile3d_probe.py:58"}
    probe_order = []
    for r in rows:
        name = r["kernel"]
        if name not in probe_order:
            probe_order.append(name)
        prev = kernels.get(name, {}).get("max_abs_err", 0.0)
        where = next(v for k, v in replaces.items() if name.startswith(k))
        src = "arrival16.cu" if name.startswith("arrival16") else "probes.cu"
        kernels[name] = {"name": name, "route": "cuda",
                         "source": f"unity_webgpu_pathtracer_torch/csrc/{src}",
                         "replaces": f"experiments/{where}", "launches": got[name],
                         "max_abs_err": max(prev, r["max_abs_err"]), "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    floor = launch_floor_ms(dev)
    last = {r["kernel"]: r for r in rows
            if r["kernel"] == "step_chain" or r["kernel"].startswith("intrinsic")}
    log(f"phase 13 launch floor (a graph-replayed one-element add) {floor:.4f} ms; P8 and P10 "
        f"beside it (their last rows): " + ", ".join(
            f"{k} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f}, {r['bound_by']})"
            for k, r in last.items()) + f"; card: {card}")

    # K1's probe modes on real states, early and deep in phase 2's pass: the
    # starts of super-iterations 4, 150 and 151, and arrivals 27 (the third
    # of 4), 1,200 (the last of 150) and 1,203 (the third of 151).
    scene, cam = million_triangle_scene(1_000_000)
    sd = scene.build("wide16", device=dev)
    caps, _ = capture_inputs(sd, cfg, params, k1_calls=(4, 150, 151))
    for cap, si in zip(caps, (4, 150, 151)):
        check_run("arrival16_run", cap, f"phase 13 super-iteration {si}", record_it=False,
                  penalty=si == 4)
    for call, cap, k in ((3 * TE + 3, caps[0], 3), (1200, caps[1], TE), (150 * TE + 3, caps[2], 3)):
        nodes, oT, dT, invT, s, active = arrival_state(cap, k)
        out = cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active)
        err = compare(out, arrival_step16(nodes, oT.T, dT.T, invT.T, s, active), "arrival16")
        k1_ms = time_ms(lambda: cuda_arrival.arrival_step16_cuda(nodes, oT, dT, invT, s, active))
        state = (nodes, s.ptr, oT, dT, invT, s, active)
        mrows = round14_kernel_diet.modes_on_state(state, f"arrival {call}",
                                                   DIET_MODES + ("f16leaf", "bf16leaf"))
        k1_bound = bound(*arrival_work(*state)[:2])
        bad = [r["name"] for r in mrows if not r["ok"]]
        if bad:
            raise AssertionError(f"phase 13: probe modes disagree with their twins: {bad}")
        for r in mrows:
            kernels[r["kernel"]]["max_abs_err"] = max(kernels[r["kernel"]]["max_abs_err"],
                                                      r["max_abs_err"])
        live = int(((s.ptr >= 0) & active).sum())
        meta = nodes.view(torch.int32)[s.ptr[(s.ptr >= 0) & active].long(), 3]
        log(f"phase 13 K1 state at arrival {call}: B={s.ptr.shape[0]} live={live} (inner "
            f"{int((meta == 0).sum())}, leaf {int((meta > 0).sum())}), distinct rows "
            f"{mrows[0]['distinct_rows']}; arrival16 {k1_ms:.4f} ms (max_abs_err {err:g}); bound "
            f"{k1_bound[0]:.4f} ms ({k1_bound[1]})")
        diet = [r for r in mrows if r["mode"] in DIET_MODES]
        for line in round14_kernel_diet.report(diet):
            log(f"phase 13 K1 arrival {call} diet {line.strip()}")
        for r in mrows:
            if r["mode"] not in DIET_MODES:
                log(f"phase 13 K1 arrival {call} {r['mode']} (in place): {r['ms']:.4f} ms cold, "
                    f"{r['warm_ms']:.4f} warm, plain {r['plain_ms']:.4f} ms, bound "
                    f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {r['bytes'] / 1e6:.3f} MB; out of "
                    f"place {r['old_bound_ms']:.5f}), max_abs_err {r['max_abs_err']:g}")
        dt, share = round14_kernel_diet.savings(mrows, "f16leaf")["bf16leaf"]
        log(f"phase 13 K1 arrival {call}: bf16 leaf decode saves {dt:.4f} ms cold "
            f"({share * 100:.1f}%); card: {card}")
        del nodes, oT, dT, invT, s, active, out, state
    del sd, caps

    # ---- 14. the renderer's user surface: PNGs, the cli, lights, goldens ----
    t14 = time.perf_counter()
    out_dir = os.path.join("chiprun_out", "phase14")
    os.makedirs(out_dir, exist_ok=True)

    # 14a: phase 4's film through Renderer.save_png, read back.
    main_r.film = main_film
    png = os.path.join(out_dir, "main_path_1080p.png")
    t0 = time.perf_counter()
    main_r.save_png(png)
    png_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shown = main_r.image()
    image_s = time.perf_counter() - t0
    back = read_png(png)
    if not np.array_equal(back, shown) or back.shape != (h, w, 3):
        raise AssertionError(f"phase 14a: {png} read back differs from Renderer.image()")
    log(f"phase 14a main path film ({main_r.sample_count} spp, {w}x{h}) -> {png}: save_png "
        f"{png_s:.3f} s (Renderer.image {image_s:.3f} s, {os.path.getsize(png)} bytes), read "
        f"back equal to Renderer.image(), PNG mean {back.mean():.3f}; card: {card}")
    del main_film, shown, back

    # 14b: cli render of every builtin at the cli's defaults but 16 spp, each pass
    # timed by a local hook around Renderer.step.
    passes = []
    step = api.Renderer.step

    def timed_step(self):
        t0 = time.perf_counter()
        step(self)
        st = self.stats()   # reads device scalars, so the pass has ended
        passes.append((time.perf_counter() - t0, st["super_iterations"]))

    api.Renderer.step = timed_step
    try:
        for name in EXAMPLES:
            passes.clear()
            reset_counts()
            png = os.path.join(out_dir, f"{name}.png")
            t0 = time.perf_counter()
            r = cli.main(["render", f"builtin:{name}", "--out", png, *CLI_ARGS])
            wall = time.perf_counter() - t0
            iters = sum(n for _, n in passes)
            k1 = "arrival16_inst_run" if name == "tlas" else "arrival16_run"
            want = {k1: iters, **({"transition16": iters} if name in ("brdf", "sponza_like")
                                  else {})}
            got = counts()
            expect_only(got, want, f"phase 14b {name}")
            back = read_png(png)
            size = r.config.width
            if back.shape != (size, size, 3) or not np.array_equal(back, r.image()) \
                    or back.max() == 0:
                raise AssertionError(f"phase 14b {name}: PNG {back.shape}, max {back.max()}, "
                                     "or not Renderer.image()")
            secs = [round(x, 3) for x, _ in passes]
            log(f"phase 14b cli render builtin:{name} ({size}x{size}, {r.sample_count} spp, "
                f"{len(passes)} passes of {r.config.samples_per_pass}): {wall:.2f} s in all, "
                f"s/pass {min(secs)}-{max(secs)} (mean {sum(secs) / len(secs):.3f}), "
                f"super-iterations {iters}, launches K1 {got[k1]}, K2 "
                f"{got['transition16']}, PNG mean {back.mean():.3f}; card: {card}")
    finally:
        api.Renderer.step = step
    del r

    # 14c: the benchmark grid at 1080p with the HDRI and lights_scene's
    # three lights: env NEE and light NEE through the merged evaluation.
    scene, cam = million_triangle_scene(1_000_000)
    for light in lights_scene()[0].lights:
        scene.add_light(light)
    lit_cfg = RenderConfig(width=w, height=h, samples_per_pass=SPP_INST, max_bounces=5,
                           transition_every=TE, pool_size=POOL, has_lights=True)
    t0 = time.perf_counter()
    r = Renderer(scene, lit_cfg, make_camera_params(width=w, height=h, **cam))
    setup = time.perf_counter() - t0
    if fused._kernel_transition_supported(r.scene, lit_cfg):
        raise AssertionError("phase 14c: a lit scene must take the general transition")
    reset_counts()
    _s, iters_l, _rays, _arr = run_passes(r, 1, "phase 14c")
    got = counts()
    expect_only(got, {"arrival16_run": iters_l}, "phase 14c")
    img = r.film.accum
    check_film(img, (h, w, 3), "phase 14c")
    if not float(img.mean()) > flat_mean:
        raise AssertionError(f"phase 14c: lights added no light ({float(img.mean())} against "
                             f"phase 4's {flat_mean})")
    launches_per_si(r.scene, lit_cfg, r.params, "phase 14c lit grid")
    png = os.path.join(out_dir, "lit_grid_1080p.png")
    t0 = time.perf_counter()
    r.save_png(png)
    log(f"phase 14c lit grid ({len(r.scene.lights)} lights + HDRI, {w}x{h}, "
        f"{r.sample_count} spp): set-up {setup:.1f} s, film mean {float(img.mean()):.6f} "
        f"(phase 4 without lights {flat_mean:.6f}), launches {got}, save_png "
        f"{time.perf_counter() - t0:.3f} s -> {png}; card: {card}")
    del r, img, scene

    # 14d: the builtins' goldens on the card (tests/golden_common.py loads
    # only numpy with the flag set; loaded from its file, since an
    # installed package may own the name ``tests``); tlas's golden saw only
    # the sky.
    os.environ["UWPT_GOLDEN_NATIVE_BACKEND"] = "1"
    spec = importlib.util.spec_from_file_location(
        "golden_common", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                      "golden_common.py"))
    golden_common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden_common)

    for name in golden_common.SCENES:
        if name == "tlas":
            continue
        reset_counts()
        t0 = time.perf_counter()
        ok, stats = golden_common.compare_to_golden(golden_passes(name, golden_common), name)
        launched = {k for k, v in counts().items() if v > 0}
        want = {"arrival16_run"} | ({"transition16"} if name in ("brdf", "sponza_like")
                                    else set())
        if not ok or launched != want:
            raise AssertionError(f"phase 14d {name}: golden {ok} {stats}, kernels {launched}")
        log(f"phase 14d golden {name}: {stats}, kernels {sorted(launched)}, "
            f"{time.perf_counter() - t0:.1f} s")
    if "jax" in sys.modules:
        raise AssertionError("phase 14d: jax was imported")
    log(f"phase 14: {time.perf_counter() - t14:.1f} s; card: {card}")

    # ---- 15. the megakernel and wavefront integrators, loaders, checkpoints ----
    t15 = time.perf_counter()
    out15 = os.path.join("chiprun_out", "phase15")
    os.makedirs(out15, exist_ok=True)
    path_launches = {"fused": kernels["arrival16_run"]["launches"]}

    def k1_only(label):
        """K1's flat kernel, and only it, launched since the last reset."""
        got = counts()
        expect_only(got, {"arrival16_run": got["arrival16_run"]}, label)
        return got["arrival16_run"]

    # 15a: the megakernel at full width through Renderer, each pass's rays
    # counted by trace_bounce(with_stats=True) through a local hook.
    render_pass = integrator.render_pass
    pass_stats = {}

    def counted_pass(*a, **k):
        return render_pass(*a, stats=pass_stats, **k)

    scene, cam = million_triangle_scene(1_000_000)
    mk_cfg = RenderConfig(width=w, height=h, samples_per_pass=1, max_bounces=5,
                          integrator="megakernel")
    mk_params = make_camera_params(width=w, height=h, **cam)
    t0 = time.perf_counter()
    r = Renderer(scene, mk_cfg, mk_params)
    log(f"phase 15a set-up: {time.perf_counter() - t0:.1f} s ({r.scene.tris.shape[0]} "
        f"triangles, megakernel tables {sum(t.nbytes for t in (r.scene.tris, r.scene.tri_index, r.scene.attr_normals, r.scene.attr_uvs, r.scene.attr_material)) / 2**20:.1f} MiB)")
    ckpt = os.path.join(out15, "megakernel_pass1.npz")
    # The first K1 launch of the first pass (every lane at the root of its
    # closest-hit traversal), kept to time K1 at B = 2,073,600.
    k1_caps = []
    integrator.render_pass = counted_pass
    mk_launches, mk_rows = 0, []
    try:
        with first_k1(k1_caps):
            for p in range(2):
                pass_stats.clear()
                tw16.TRAVERSE_STATS.update(calls=0, host_reads=0)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                r.render(passes=1)   # ends in a synchronize
                dt = time.perf_counter() - t0
                launches = k1_only(f"phase 15a pass {p}")
                mk_launches += launches
                closest, shadow = int(pass_stats["closest"]), int(pass_stats["shadow"])
                bounces = pass_stats["bounces"]
                mk_rows.append((dt, closest + shadow))
                log(f"phase 15a megakernel pass {p} ({w}x{h}, 1 spp, {w * h} lanes): {dt:.3f} "
                    f"s/pass, {(closest + shadow) / dt / 1e6:.3f} Mrays/s, rays {closest + shadow} "
                    f"(closest {closest}, shadow {shadow}), bounces {bounces}, K1 launches "
                    f"{launches} ({launches / bounces:.2f} a bounce), traversals "
                    f"{tw16.TRAVERSE_STATS['calls']}, host reads {tw16.TRAVERSE_STATS['host_reads']} "
                    f"+ {bounces} loop tests, peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card: {card}")
                if p == 0:
                    r.save_checkpoint(ckpt)
                    mk_first = r.film.accum.clone()
    finally:
        integrator.render_pass = render_pass
    if r.stats() != {}:
        raise AssertionError(f"phase 15a: stats after a megakernel pass {r.stats()}")
    img = r.film.accum
    check_film(img, (h, w, 3), "phase 15a")
    mean_rel, tile_stat = film_vs_flat(img, flat_img, "phase 15a")
    log(f"phase 15a megakernel: {r.sample_count} spp, film mean {float(img.mean()):.6f} (phase "
        f"4 {float(flat_img.mean()):.6f}, rel {mean_rel:.5f}), {TILE}x{TILE} tile statistic "
        f"{tile_stat:.5f}, K1 launches {mk_launches}; card: {card}")
    path_launches["megakernel"] = mk_launches
    k1_mk = check_run("arrival16_run", k1_caps[0], "phase 15a (the megakernel's first launch)",
                      record_it=False)
    kernels["arrival16_run"]["megakernel_launch"] = k1_mk
    del k1_caps

    # 15f: checkpoint after pass 1, resumed in a new Renderer: pass 2 gives
    # the uninterrupted run's film bit for bit.
    r2 = Renderer(r.scene, mk_cfg, mk_params)
    r2.load_checkpoint(ckpt)
    if r2.sample_count != 1 or not torch.equal(r2.film.accum, mk_first):
        raise AssertionError("phase 15f: the checkpoint did not load the pass-1 film")
    r2.render(passes=1)
    if not torch.equal(r2.film.accum, r.film.accum):
        bad = int((r2.film.accum != r.film.accum).sum())
        raise AssertionError(f"phase 15f: resumed film differs in {bad} values")
    log(f"phase 15f checkpoint {ckpt} ({os.path.getsize(ckpt)} bytes) after pass 1, loaded "
        f"into a new Renderer, pass 2: film equal to the uninterrupted run's bit for bit")
    os.remove(ckpt)   # 25 MB: the output directory stays small
    del r2

    # 15b: the wavefront on the same scene, pool on auto, twice with one
    # seed: bit-equal films.  At 1 spp its work items carry the
    # megakernel's first-pass seeds, so its film is that pass's film.
    wf_cfg = dataclasses.replace(mk_cfg, integrator="wavefront")
    films = []
    for run in range(2):
        rw = Renderer(r.scene, wf_cfg, mk_params)
        tw16.TRAVERSE_STATS.update(calls=0, host_reads=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        total, occ, closest, shadow = wavefront.wavefront_pass_with_stats(
            rw.scene, wf_cfg, rw.params, 0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = k1_only(f"phase 15b run {run}")
        rays = int(closest) + int(shadow)
        films.append(total.reshape(h, w, 3).clone())
        log(f"phase 15b wavefront run {run} ({w}x{h}, 1 spp, pool {min(w * h, 1 << 16)}): "
            f"{dt:.3f} s/pass, {rays / dt / 1e6:.3f} Mrays/s, rays {rays} (closest "
            f"{int(closest)}, shadow {int(shadow)}), occupancy {float(occ):.4f}, K1 launches "
            f"{launches}, traversals {tw16.TRAVERSE_STATS['calls']}, host reads "
            f"{tw16.TRAVERSE_STATS['host_reads']}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; card: {card}")
    path_launches["wavefront"] = launches
    if not torch.equal(films[0], films[1]):
        raise AssertionError(f"phase 15b: two runs differ in "
                             f"{int((films[0] != films[1]).sum())} values")
    # The same film through Renderer.step.
    rw.step()
    if not torch.equal(rw.film.accum, films[0]) or rw.stats() != {}:
        raise AssertionError("phase 15b: Renderer's wavefront pass differs from the pass")
    check_film(films[0], (h, w, 3), "phase 15b")
    mean_rel, tile_stat = film_vs_flat(films[0], flat_img, "phase 15b")
    vs_mk = float((films[0] - mk_first).abs().max())
    log(f"phase 15b wavefront: two runs bit-equal; film mean {float(films[0].mean()):.6f} "
        f"(phase 4 rel {mean_rel:.5f}), {TILE}x{TILE} tile statistic {tile_stat:.5f}; max abs "
        f"difference from the megakernel's first pass {vs_mk:g}; card: {card}")
    del r, rw, films, total, mk_first, img

    # 15e: the benchmark mesh written as OBJ + MTL (PNG map_Kd) and as GLB
    # (embedded PNG), loaded by the port's loaders (positions exact), and
    # rendered by the cli (512x512, 8 spp), load, build and passes timed.
    t0 = time.perf_counter()
    model = model_of(scene)
    want_pos = model[0][model[1]]
    files = {"obj": os.path.join(out15, "grid.obj"), "glb": os.path.join(out15, "grid.glb")}
    write_obj_model(files["obj"], *model, checker_texture())
    write_glb_model(files["glb"], *model, checker_texture())
    log(f"phase 15e wrote {len(model[0])} vertices, {len(model[1])} triangles: "
        + ", ".join(f"{k} {os.path.getsize(v) / 2**20:.1f} MiB" for k, v in files.items())
        + f" in {time.perf_counter() - t0:.1f} s")
    del scene
    load_scene, init = cli._load_scene, api.Renderer.__init__
    timing = {}

    def timed_load(spec):
        t0 = time.perf_counter()
        out = load_scene(spec)
        timing["load"], timing["scene"] = time.perf_counter() - t0, out[0]
        return out

    def timed_init(self, *a, **k):
        t0 = time.perf_counter()
        init(self, *a, **k)
        timing["build"] = time.perf_counter() - t0

    passes = []
    cli._load_scene, api.Renderer.__init__, api.Renderer.step = timed_load, timed_init, timed_step
    try:
        for fmt, path in files.items():
            passes.clear()
            reset_counts()
            png = os.path.join(out15, f"grid_{fmt}.png")
            t0 = time.perf_counter()
            r = cli.main(["render", path, "--size", "512", "--spp", "8", "--out", png])
            wall = time.perf_counter() - t0
            got_pos = timing.pop("scene").flatten().positions
            if got_pos.tobytes() != want_pos.tobytes():
                raise AssertionError(f"phase 15e {fmt}: loaded positions differ from the written")
            launches = k1_only(f"phase 15e {fmt}")
            back = read_png(png)
            if back.shape != (512, 512, 3) or not np.array_equal(back, r.image()) \
                    or back.max() == 0:
                raise AssertionError(f"phase 15e {fmt}: PNG {back.shape} or not Renderer.image()")
            log(f"phase 15e cli render {path} (512x512, {r.sample_count} spp, textures "
                f"{len(r._host_scene.textures)}): load {timing['load']:.2f} s, build "
                f"{timing['build']:.2f} s, passes {[round(x, 3) for x, _ in passes]} s, "
                f"{wall:.2f} s in all; positions equal to the written bit for bit; K1 launches "
                f"{launches}; PNG mean {back.mean():.3f}; card: {card}")
    finally:
        cli._load_scene, api.Renderer.__init__, api.Renderer.step = load_scene, init, step
        # The model files (~140 MB) do not stay in the output directory.
        for name in ("grid.obj", "grid.mtl", "grid_kd.png", "grid.glb"):
            if os.path.exists(os.path.join(out15, name)):
                os.remove(os.path.join(out15, name))
    del r, model, want_pos, got_pos

    # 15d: the megakernel on the goldens under golden_gen's cross-check gate
    # (tests/golden_gen.py: four passes, dual flags at z 8 against the
    # fixture), and Cornell on the brute-force oracle.
    for name, trav in [(n, "wide16") for n in golden_common.SCENES if n != "tlas"] \
            + [("cornell", "bruteforce")]:
        reset_counts()
        t0 = time.perf_counter()
        mk = golden_megakernel_passes(name, golden_common, trav)
        g = golden_common.load_golden(name)
        bad, mk_mean = golden_common.dual_flags(mk, g, z_thresh=8.0)
        bad_frac = float(bad.mean())
        shift = abs(float(mk_mean.mean() - g["mean"].mean())) / max(float(g["mean"].mean()),
                                                                    1e-6)
        ok = (bad_frac < 0.01 or (bad_frac < 0.03 and shift < 0.005)) and shift < 0.02
        launched = {k for k, v in counts().items() if v > 0}
        want = {"arrival16_run"} if trav == "wide16" else set()
        if not ok or launched != want:
            raise AssertionError(f"phase 15d {name} ({trav}): bad_frac {bad_frac:.4%} shift "
                                 f"{shift:.4%}, kernels {launched}")
        log(f"phase 15d golden {name} megakernel ({trav}): bad_frac {bad_frac:.4%} mean_shift "
            f"{shift:.4%} (golden_gen's gate), kernels {sorted(launched)}, "
            f"{time.perf_counter() - t0:.1f} s")
    if "jax" in sys.modules:
        raise AssertionError("phase 15: jax was imported")
    kernels["arrival16_run"]["launches_by_path"] = path_launches
    kernels["arrival16_run"]["launches"] = sum(path_launches.values())
    log(f"phase 15: {time.perf_counter() - t15:.1f} s; K1 launches by path {path_launches}; "
        f"card: {card}")

    # ---- 16. the interactive surface: reprojection, preview, viewer, animate ----
    t16 = time.perf_counter()
    out16 = os.path.join("chiprun_out", "phase16")
    os.makedirs(out16, exist_ok=True)
    from unity_webgpu_pathtracer_torch import viewer as uviewer
    from unity_webgpu_pathtracer_torch.render import film as ufilm
    from unity_webgpu_pathtracer_torch.render.preview import preview
    from unity_webgpu_pathtracer_torch.config import PostParams
    from unity_webgpu_pathtracer_torch.post.tonemap import present
    from unity_webgpu_pathtracer_torch.render.reproject import primary_depth, reproject_film
    from unity_webgpu_pathtracer_torch.utils.image import decode_png, write_png

    def traversal_launches(label):
        """K1's flat kernel launched once per host read of the traversals
        since the last reset, and nothing else."""
        reads = tw16.TRAVERSE_STATS["host_reads"]
        expect_only(counts(), {"arrival16_run": reads}, label)
        return reads

    def reset_all():
        torch.cuda.synchronize()
        reset_counts()
        tw16.TRAVERSE_STATS.update(calls=0, host_reads=0)

    def local_range(accum):
        """Each pixel's 3x3 neighbourhood's max - min, per channel."""
        planes = accum.permute(2, 0, 1)[None]
        return (torch.nn.functional.max_pool2d(planes, 3, 1, 1)
                + torch.nn.functional.max_pool2d(-planes, 3, 1, 1))[0].permute(1, 2, 0)

    def cam_params(cam_, width, height, device=dev, **kw):
        return make_camera_params(width=width, height=height, device=device, **dict(cam_, **kw))

    # 16a: reprojection of phase 4's film (1080p, 8 spp) on phase 4's scene.
    r = main_r
    eye, target = (np.asarray(main_cam[k], np.float64) for k in ("eye", "target"))
    right = np.cross(target - eye, (0.0, 1.0, 0.0))
    right /= np.linalg.norm(right)
    moved_eye = tuple(eye + right * 0.002 * np.linalg.norm(target - eye))
    p_id, p_move = r.params, cam_params(main_cam, w, h, eye=moved_eye)
    # Turned round: the same eye looking away from the grid.
    p_away = cam_params(main_cam, w, h, target=tuple(2 * eye - target))
    n0 = r.sample_count
    reset_all()
    t0 = time.perf_counter()
    same = reproject_film(r.scene, r.config, r.film, p_id, p_id)
    torch.cuda.synchronize()
    id_s = time.perf_counter() - t0
    id_k1 = traversal_launches("phase 16a identity")
    id_diff = (same.accum - r.film.accum).abs()
    # A pixel centre projects a few ulps of ~1000 off itself, so its
    # neighbour taps leak that share of the 3x3 neighbourhood's range:
    # held to 1e-3 of the range + 1e-5 (tests/test_reproject.py: 1e-5 at
    # 24x24, where the ulps are ~50x smaller).
    span = local_range(r.film.accum)
    id_err, id_far = float(id_diff.max()), int((id_diff.amax(-1) > 1e-5).sum())
    leak = id_diff > 1e-5
    id_share = float((id_diff[leak] / span[leak]).max()) if bool(leak.any()) else 0.0
    if not (int(same.pixel_counts.min()) == same.sample_count == n0
            and bool((id_diff <= 1e-5 + 1e-3 * span).all())
            and tw16.TRAVERSE_STATS["calls"] == 2):
        raise AssertionError(f"phase 16a identity: counts {int(same.pixel_counts.min())}-"
                             f"{same.sample_count} (film {n0}), max abs {id_err:g}, "
                             f"{id_far} pixels beyond 1e-5, worst leak / range {id_share:g}")
    away = reproject_film(r.scene, r.config, r.film, p_id, p_away)
    dropped = float((away.pixel_counts == 0).float().mean())
    del same, away
    reset_all()
    prof = k2_span._profile(lambda: reproject_film(r.scene, r.config, r.film, p_id, p_move))
    prof_k1 = counts()["arrival16_run"]
    reset_all()
    t0 = time.perf_counter()
    r.update_camera(p_move, reproject=True)
    torch.cuda.synchronize()
    move_s = time.perf_counter() - t0
    reproj_k1 = traversal_launches("phase 16a update_camera(reproject=True)")
    kept = float((r.film.pixel_counts > 0).float().mean())
    if kept <= 0.7 or dropped <= 0.9:
        raise AssertionError(f"phase 16a: small move kept {kept:.4f}, turned round dropped "
                             f"{dropped:.4f}")
    before = r.sample_count
    reset_counts()
    t0 = time.perf_counter()
    r.step()
    st = r.stats()   # reads device scalars: the pass has ended
    step_s = time.perf_counter() - t0
    expect_only(counts(), {"arrival16_run": st["super_iterations"],
                           "transition16": st["super_iterations"]}, "phase 16a step")
    check_film(r.film.accum, (h, w, 3), "phase 16a step")
    if r.sample_count != before + SPP or int(r.film.pixel_counts.max()) != before + SPP:
        raise AssertionError(f"phase 16a: {r.sample_count} spp after a pass from {before}")
    ckpt = os.path.join(out16, "reprojected.npz")
    r.save_checkpoint(ckpt)
    r2 = Renderer(r.scene, r.config, r.params)
    r2.load_checkpoint(ckpt)
    if not (torch.equal(r2.film.accum, r.film.accum)
            and torch.equal(r2.film.pixel_counts, r.film.pixel_counts)
            and r2.sample_count == r.sample_count):
        raise AssertionError("phase 16a: the per-pixel checkpoint did not round-trip")
    ckpt_bytes = os.path.getsize(ckpt)
    os.remove(ckpt)
    del r2
    log(f"phase 16a reprojection of phase 4's film ({w}x{h}, {n0} spp): identity "
        f"{id_s:.3f} s, counts all {n0}, accum max abs {id_err:g} ({id_far} pixels beyond "
        f"1e-5, film max {float(r.film.accum.max()):g}; leak at most {id_share:.3g} of the "
        f"3x3 range), K1 launches {id_k1} (2 "
        f"traversals); update_camera(reproject=True) on a move of 0.2% of the view distance "
        f"{move_s:.3f} s, K1 launches {reproj_k1}, PyTorch launches {prof['kernels'] - prof_k1} "
        f"(+ {prof['memcpy_memset']} memcpy/memset; torch.profiler, K1 excluded), pixels kept "
        f"{kept:.4f}; turned round: dropped {dropped:.4f}; the next pass {step_s:.3f} s "
        f"({st['super_iterations']} super-iterations) -> {r.sample_count} spp at most; "
        f"per-pixel checkpoint ({ckpt_bytes} bytes) round trip bit for bit; card: {card}")
    with first_k1([]) as caps:
        primary_depth(r.scene, r.config, p_move)
    kernels["arrival16_run"]["primary_depth_launch"] = check_run(
        "arrival16_run", caps[0], "phase 16a (primary_depth's first launch)", record_it=False)
    del caps

    # The reprojection on the card against the CPU: Cornell at 128x128.
    scene_c, cam_c = cornell_box()
    cfg_c = RenderConfig(width=128, height=128, samples_per_pass=4, max_bounces=3, sky_mode=2,
                         pool_size=16384)
    rc = Renderer(scene_c, cfg_c, cam_params(cam_c, 128, 128))
    rc.render(passes=2)
    sd_cpu = cornell_box()[0].build("wide16", device="cpu")
    c_eye = np.asarray(cam_c["eye"], np.float64)
    c_move = dict(eye=tuple(c_eye + np.array([0.02, 0.01, 0.0])))
    on_card = reproject_film(rc.scene, cfg_c, rc.film, rc.params,
                             cam_params(cam_c, 128, 128, **c_move))
    on_cpu = reproject_film(sd_cpu, cfg_c, ufilm.Film(rc.film.accum.cpu(), rc.sample_count),
                            cam_params(cam_c, 128, 128, device="cpu"),
                            cam_params(cam_c, 128, 128, device="cpu", **c_move))
    c_diff = (on_card.accum.cpu() - on_cpu.accum).abs()
    c_err, c_span = float(c_diff.max()), local_range(on_cpu.accum)
    c_share = float((c_diff / (c_span + 1e-30))[c_diff > 1e-6].max()) \
        if bool((c_diff > 1e-6).any()) else 0.0
    c_bad = int((on_card.pixel_counts.cpu() != on_cpu.pixel_counts).sum())
    t_card = primary_depth(rc.scene, cfg_c, cam_params(cam_c, 128, 128, **c_move)).cpu()
    t_cpu = primary_depth(sd_cpu, cfg_c, cam_params(cam_c, 128, 128, device="cpu", **c_move))
    # K1 equals its twin on the card; the twin on the CPU rounds a few
    # lanes' t differently (phase 5's tolerance), which moves a pixel's
    # taps by ~1e-5 pixel and so its value by that share of its
    # neighbourhood's range: held to 1e-4 of the range + 1e-6.
    if c_bad or not bool((c_diff <= 1e-6 + 1e-4 * c_span).all()):
        raise AssertionError(f"phase 16a Cornell card vs CPU: {c_bad} counts differ, max abs "
                             f"{c_err:g}, worst difference / range {c_share:g}")
    log(f"phase 16a reproject_film on the card against the CPU (Cornell 128x128, 8 spp, a "
        f"move): counts equal, accum max abs {c_err:g}, at most {c_share:.3g} of the 3x3 "
        f"range (bound 1e-4 + 1e-6); t differs in "
        f"{int((t_card != t_cpu).sum())} of {t_cpu.numel()} lanes, max rel "
        f"{float(((t_card - t_cpu).abs() / t_cpu).max()):g}; kept "
        f"{float((on_cpu.pixel_counts > 0).float().mean()):.4f}")

    # 16b: the preview at 1080p on phase 4's scene; Cornell against the CPU.
    reset_all()
    with first_k1([]) as caps:
        t0 = time.perf_counter()
        img = preview(r.scene, r.config, p_id)
        torch.cuda.synchronize()
        prev_s = time.perf_counter() - t0
    prev_k1 = traversal_launches("phase 16b preview")
    check_film(img, (h, w, 3), "phase 16b")
    t0 = time.perf_counter()
    img2 = preview(r.scene, r.config, p_id)
    torch.cuda.synchronize()
    prev2_s = time.perf_counter() - t0
    if not torch.equal(img, img2):
        raise AssertionError("phase 16b: two previews differ")
    shown = (torch.clamp(present(img, PostParams()), 0, 1) * 255 + 0.5).to(torch.uint8)
    write_png(os.path.join(out16, "preview_1080p.png"), shown.flip(0).cpu().numpy())
    # Held exact, untimed: its state is primary_depth's but for the jitter.
    prev_err = k1_exact(caps[0], "phase 16b K1 (the preview's first launch)")
    kernels["arrival16_run"]["preview_launch"] = {"lanes": caps[0].s.ptr.shape[0],
                                                  "max_abs_err": prev_err}
    del caps
    c_card = preview(rc.scene, cfg_c, rc.params).cpu()
    c_cpu = preview(sd_cpu, cfg_c, cam_params(cam_c, 128, 128, device="cpu"))
    close = torch.isclose(c_card, c_cpu, rtol=1e-4, atol=1e-4).all(-1)
    rel = abs(float(c_card.mean()) - float(c_cpu.mean())) / float(c_cpu.mean())
    if float(close.float().mean()) < 0.99 or rel > 1e-4:
        raise AssertionError(f"phase 16b Cornell card vs CPU: {int((~close).sum())} pixels "
                             f"beyond 1e-4, mean rel {rel:g}")
    log(f"phase 16b preview ({w}x{h}): {prev_s:.3f} s (again {prev2_s:.3f} s, equal), K1 "
        f"launches {prev_k1} (the first against its twin: max abs error {prev_err:g}), "
        f"image mean {float(img.mean()):.6f}, finite; Cornell 128x128 on "
        f"the card against the CPU: {int((~close).sum())} of {close.numel()} pixels beyond "
        f"rtol/atol 1e-4, max abs {float((c_card - c_cpu).abs().max()):g}, mean rel {rel:g}; "
        f"card: {card}")
    del img, img2, shown, rc, sd_cpu, on_card, on_cpu
    path_launches.update(reproject=reproj_k1, preview=prev_k1)

    # 16c: the viewer on the card, through cli view and HTTP.
    serve, made = uviewer.serve, {}

    def spy(v, **kw):
        made["server"] = serve(v, **kw)
        made["viewer"] = v
        return made["server"]

    def request(base, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(
                base + path, data=data, method="GET" if body is None else "POST"),
                timeout=300) as resp:
            out = resp.read()
        return out, time.perf_counter() - t0

    def until(v, cond, what, timeout=120):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if v.error is not None:
                raise AssertionError(f"phase 16c: the render loop died: {v.error!r}")
            with v.lock:
                if cond():
                    return
            time.sleep(0.02)
        raise AssertionError(f"phase 16c: timed out waiting for {what}")

    def view(spec, drive):
        """``cli view <spec> --port 0`` in a thread, driven by ``drive(v,
        base, secs)``; returns (viewer, seconds per request, passes/s)."""
        made.clear()
        box = {}

        def run():
            try:
                box["v"] = cli.main(["view", spec, "--port", "0"])
            except BaseException as e:   # re-raised below
                box["error"] = e

        reset_all()
        th = threading.Thread(target=run, daemon=True)
        th.start()
        deadline = time.time() + 300
        while "viewer" not in made and "error" not in box and time.time() < deadline:
            time.sleep(0.02)
        if "viewer" not in made:
            raise AssertionError(f"phase 16c {spec}: the viewer did not start: {box}")
        v = made["viewer"]
        base = f"http://127.0.0.1:{made['server'].server_address[1]}"
        secs = {}
        until(v, lambda: v.passes >= 2, "two passes")
        p0, t0 = v.passes, time.perf_counter()
        until(v, lambda: v.passes >= p0 + 5, "five more passes")
        rate = (v.passes - p0) / (time.perf_counter() - t0)
        drive(v, base, secs)
        if v.error is not None or not v._thread.is_alive():
            raise AssertionError(f"phase 16c {spec}: the render loop died: {v.error!r}")
        v.stop()
        th.join(timeout=60)
        if th.is_alive() or box.get("v") is not v:
            raise AssertionError(f"phase 16c {spec}: cli view did not end: {box}")
        return v, secs, rate

    def drive_cornell(v, base, secs):
        page, secs["GET /"] = request(base, "/")
        state, secs["GET /state"] = request(base, "/state")
        png, secs["GET /frame.png"] = request(base, "/frame.png")
        frame = decode_png(png)
        if b"tpu pathtracer" not in page or frame.shape != (256, 256, 3) or frame.max() == 0 \
                or "tier" not in json.loads(state)["stats"]:
            raise AssertionError(f"phase 16c: page, state or frame wrong ({frame.shape})")
        c = np.asarray(v.cam["eye"], np.float64)
        _, secs["POST /camera"] = request(base, "/camera", {"eye": list(c + [0.05, 0, 0])})
        until(v, lambda: v.passes >= 1 and v.r.sample_count >= 2, "a pass after the move")
        with v.lock:
            v.reproject = True
        _, secs["POST /camera (reproject)"] = request(base, "/camera",
                                                      {"eye": list(c + [0.06, 0, 0])})
        with v.lock:
            if v.r.film.pixel_counts is None:
                raise AssertionError("phase 16c: the reprojecting move left no per-pixel film")
            kept_v = float((v.r.film.pixel_counts > 0).float().mean())
        secs["kept"] = kept_v
        _, secs["POST /material"] = request(base, "/material", {"id": 0, "roughness": 0.3})
        p = v.passes
        until(v, lambda: v.passes >= p + 2, "two passes after the edits")
        if abs(v.r._host_scene.materials[0].roughness - 0.3) > 1e-6:
            raise AssertionError("phase 16c: the material edit did not reach the scene")

    def drive_tlas(v, base, secs):
        y0 = float(v.r._host_scene.instances[0][1][1, 3])
        _, secs["POST /bounce"] = request(base, "/bounce", {"on": True})
        p = v.passes
        until(v, lambda: v.passes >= p + 3, "three bouncing passes")
        _, secs["POST /bounce (off)"] = request(base, "/bounce", {"on": False})
        with v.lock:
            if float(v.r._host_scene.instances[0][1][1, 3]) == y0:
                raise AssertionError("phase 16c: the bounce moved no instance")
        _, secs["GET /frame.png"] = request(base, "/frame.png")

    uviewer.serve = spy
    try:
        viewer_rows = {}
        for spec, drive, k1 in (("builtin:cornell", drive_cornell, "arrival16_run"),
                                ("builtin:tlas", drive_tlas, "arrival16_inst_run")):
            v, secs, rate = view(spec, drive)
            got = counts()
            reads = tw16.TRAVERSE_STATS["host_reads"]
            # The fused pass launches K1 once a super-iteration; the
            # reprojection once a host read of its traversals.
            expect_only(got, {k1: v.super_iterations + (reads if k1 == "arrival16_run" else 0)},
                        f"phase 16c {spec}")
            viewer_rows[spec] = got[k1]
            log(f"phase 16c cli view {spec} (256x256, passes of 2 spp, 4 bounces): "
                f"{rate:.2f} passes/s ({v.pass_s:.3f} s/pass EMA, "
                f"{v.rays_per_s / 1e6:.2f} Mrays/s), {v.passes} passes, "
                f"{v.super_iterations} super-iterations, K1 launches {got[k1]} "
                f"({reads} by the reprojection), K2 {got['transition16']}; seconds per "
                f"request {({k: round(x, 4) for k, x in secs.items()})}; loop alive until "
                f"stop(); card: {card}")
    finally:
        uviewer.serve = serve
    path_launches["viewer"] = viewer_rows["builtin:cornell"]

    # 16d: cli animate, each pass timed by a local hook on Renderer.render.
    render, frame_rows = api.Renderer.render, []

    def timed_render(self, passes=1):
        t0 = time.perf_counter()
        out = render(self, passes)
        frame_rows.append((time.perf_counter() - t0, self.stats()["super_iterations"]))
        return out

    anim = {}
    api.Renderer.render = timed_render
    try:
        for spec, extra, want_k in (
                ("builtin:cornell", ["--orbit"], ("arrival16_run",)),
                ("builtin:tlas", ["--orbit", "--bounce"], ("arrival16_inst_run",)),
                ("builtin:brdf", ["--orbit", "--frames", "2"], ("arrival16_run", "transition16"))):
            name = spec.split(":")[1]
            frame_rows.clear()
            reset_counts()
            stem = os.path.join(out16, f"{name}.png")
            t0 = time.perf_counter()
            r = cli.main(["animate", spec, *extra, "--out", stem])
            wall = time.perf_counter() - t0
            iters = sum(n for _, n in frame_rows)
            got = counts()
            expect_only(got, dict.fromkeys(want_k, iters), f"phase 16d {spec}")
            frames = [read_png(os.path.join(out16, f"{name}-{i:04d}.png"))
                      for i in range(len(frame_rows))]
            lit = [f.max() > 0 for f in frames]
            differ = [not np.array_equal(a, b) for a, b in zip(frames, frames[1:])]
            # Under sky mode none the Cornell box's outside is black: two
            # unlit frames in a row are equal.
            if not all(d or not (la or lb) for d, la, lb in zip(differ, lit, lit[1:])) \
                    or not any(lit):
                raise AssertionError(f"phase 16d {spec}: consecutive frames equal {differ}, "
                                     f"lit {lit}")
            anim[name] = {k: got[k] for k in want_k}
            secs = [round(x, 3) for x, _ in frame_rows]
            log(f"phase 16d cli animate {spec} {' '.join(extra)} (256x256, 8 spp a frame): "
                f"{len(frames)} frames in {wall:.2f} s, s/frame {secs}, super-iterations "
                f"{iters}, launches {anim[name]}, lit frames {sum(lit)}, consecutive frames "
                f"differ {sum(differ)} of {len(differ)}; card: {card}")
            for i in range(len(frames)):
                os.remove(os.path.join(out16, f"{name}-{i:04d}.png"))
    finally:
        api.Renderer.render = render
    del r, main_r
    path_launches["animate"] = anim["cornell"]["arrival16_run"] + anim["brdf"]["arrival16_run"]
    kernels["arrival16_run"]["launches_by_path"] = path_launches
    kernels["arrival16_run"]["launches"] = sum(path_launches.values())
    inst = kernels["arrival16_inst_run"]
    inst["launches_by_path"] = {"path_a": inst["launches"],
                                "viewer": viewer_rows["builtin:tlas"],
                                "animate": anim["tlas"]["arrival16_inst_run"]}
    inst["launches"] = sum(inst["launches_by_path"].values())
    k2 = kernels["transition16"]
    k2["launches_by_path"] = {"fused": k2["launches"], "animate": anim["brdf"]["transition16"]}
    k2["launches"] = sum(k2["launches_by_path"].values())
    if "jax" in sys.modules:
        raise AssertionError("phase 16: jax was imported")
    log(f"phase 16: {time.perf_counter() - t16:.1f} s; K1 launches by path {path_launches}; "
        f"card: {card}")

    # ---- 17. multi-GPU: two gloo ranks share the card ----
    # NCCL refuses two ranks on one device, so the ranks share it over
    # gloo: this measures the program (sharding, collectives, the film's
    # assembly), not scaling.  They start after phase 1 built the kernels,
    # so they only load them.
    from unity_webgpu_pathtracer_torch.experiments import multigpu as multigpu_exp

    t17 = time.perf_counter()
    reports = run_ranks(RANKS, RANK_LIMIT_S)
    multigpu = {"arrival16_run": 0, "transition16": 0}
    for rep in reports:
        if rep["build_s"] != 0.0 or rep["jax_imported"]:
            raise AssertionError(f"phase 17 rank {rep['rank']}: built kernels for "
                                 f"{rep['build_s']} s, or imported jax")
        for k in multigpu:
            multigpu[k] += rep["launches"][k]
        log(f"phase 17 rank {rep['rank']} of {rep['world']} on {rep['device']} ({rep['card']}): "
            f"set-up {rep['setup_s']:.1f} s (kernels loaded, not built); launches "
            f"{rep['launches']}; gloo took CUDA tensors for {rep['collectives_on_device']}")
        for step in ("fused_tile", "fused_spp", "megakernel_tile", "config5_pass0",
                     "config5_reproject", "config5_pass1"):
            row = rep[step]
            extra = {k: v for k, v in row.items()
                     if k not in ("s", "local_pass_s", "collectives_s", "peak_gib")}
            log(f"phase 17 rank {rep['rank']} {step}: {row['s']:.3f} s (local pass "
                f"{row['local_pass_s']:.3f} s, collectives {row['collectives_s']:.4f} s with the "
                f"wait for the slower rank), peak {row['peak_gib']:.3f} GiB; {extra}")
        for size in ("1080p", "4k"):
            c = rep[f"collectives_{size}"]
            log(f"phase 17 rank {rep['rank']} collectives alone, {size} film ({c['bytes']} "
                f"bytes): all_reduce {c['all_reduce_s']:.4f} s, all_gather of the tiles "
                f"{c['all_gather_s']:.4f} s")
    r0 = reports[0]
    for step in ("fused_tile", "fused_spp", "megakernel_tile", "config5_pass0"):
        v = r0[step]["vs_single"]
        log(f"phase 17 {step} against one rank's pass: within rtol/atol "
            f"{multigpu_exp.FILM_TOL}, bitwise equal {v['bitwise_share']:.6f}, max abs "
            f"{v['max_abs']:g}"
            + (f"; rays {r0[step]['rays']} (single {v['single_rays']}), arrivals "
               f"{r0[step]['arrivals']} (single {v['single_arrivals']})"
               if "single_rays" in v else ""))
    log(f"phase 17 one rank's passes (rank 0 alone, after the others ended): 1080p "
        f"{r0['single_1080p']['s']:.3f} s ({r0['single_1080p']['super_iterations']} "
        f"super-iterations), 4K {r0['single_4k']['s']:.3f} s "
        f"({r0['single_4k']['super_iterations']})")
    log(f"phase 17: {time.perf_counter() - t17:.1f} s; config 5 at 3840x2160 kept "
        f"{r0['config5_reproject']['kept']:.4f} of the pixels, film {r0['config5_film']}; "
        f"phase 4's single-rank passes {secs_4 / 2:.3f} s/pass; K1/K2 launches of the ranks "
        f"{multigpu}; card: {card}")
    if not all(multigpu.values()):
        raise AssertionError(f"phase 17: the ranks launched {multigpu}")
    for k in multigpu:
        kernels[k]["launches_by_path"]["multigpu"] = multigpu[k]
        kernels[k]["launches"] += multigpu[k]

    # ---- 18. the rest of the reference: attribute modes, materials past
    # 65,536, the three films, wide8, the numpy builder ----
    import tempfile
    import warnings

    from unity_webgpu_pathtracer_torch.accel import native
    from unity_webgpu_pathtracer_torch.ops import traverse_wide8 as tw8
    from unity_webgpu_pathtracer_torch.render import camera as ucamera
    from unity_webgpu_pathtracer_torch.scene.scene import scene_from_numpy
    from unity_webgpu_pathtracer_torch.utils import math as umath

    t18 = time.perf_counter()
    # launches by path of this phase
    p18 = {"arrival16_run": {}, "arrival16_inst_run": {}, "transition16": {}}
    if w16.CACHE_STATS["numpy"] != 0:
        raise AssertionError(f"phase 18: a numpy BVH build before 18f: {w16.CACHE_STATS}")

    def path_pass(label, fn, want, path):
        """Run ``fn`` with the counts at 0 and read them after: exactly the
        kernels of ``want(result, counts)`` launched, that many times."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        want = want(out, got)
        expect_only(got, want, label)
        for k, v in want.items():
            p18[k][path] = p18[k].get(path, 0) + v
        return out, dt, got

    def fused_18(sd_, cfg_, params_, label, path, k2=False):
        (film, _occ, rays, arr, iters), dt, got = path_pass(
            label, lambda: fused.fused_pass_with_stats(sd_, cfg_, params_, 0),
            lambda o, _g: ({} if cfg_.traversal == "wide8"      # plain PyTorch, no kernel
                           else {"arrival16_run": o[4], "transition16": o[4]} if k2
                           else {"arrival16_run": o[4]}), path)
        img = film.reshape(cfg_.height, cfg_.width, 3) / cfg_.samples_per_pass
        check_film(img, (cfg_.height, cfg_.width, 3), label)
        log(f"{label}: {dt:.3f} s/pass, {int(rays) / dt / 1e6:.3f} Mrays/s, rays {int(rays)}, "
            f"arrivals {int(arr)}, super-iterations {iters}, launches {got} "
            f"({sum(got.values()) / iters:.2f} kernel launches a super-iteration); card: {card}")
        return img, int(rays), int(arr)

    # 18a: the premise of the plain twins' sqrt: the card's IEEE sqrtf is
    # the root the CPU helper rounds from f64.
    xs = torch.cat([torch.linspace(0.0, 1e6, 1 << 24, device=dev),
                    torch.tensor([0.0, -0.0, 1e-45, 1e-40, 1.1754942e-38, 3e-39,
                                  float("inf"), float("nan"), -1.0], device=dev)])
    on_card, on_cpu = umath.sqrt(xs).cpu(), umath.sqrt(xs.cpu())
    nan = on_cpu.isnan()
    if not (torch.equal(on_card.isnan(), nan)
            and torch.equal(on_card.view(torch.int32)[~nan], on_cpu.view(torch.int32)[~nan])):
        bad = int((on_card.view(torch.int32)[~nan] != on_cpu.view(torch.int32)[~nan]).sum())
        raise AssertionError(f"phase 18a: sqrt on the card differs from the CPU helper in "
                             f"{bad} of {xs.numel()} values")
    log(f"phase 18a sqrt: the card's torch.sqrt equals utils/math.py::sqrt on the CPU (f64, "
        f"rounded once) bit for bit on {xs.numel()} f32 values over [0, 1e6] with 0, -0, "
        f"subnormals, inf and NaN")
    del xs, on_card, on_cpu

    # 18b: the main path's scene and settings on the f32 rows and mode 1.
    scene, cam = million_triangle_scene(1_000_000)
    sd = scene.build("wide16", device=dev)
    pr18 = make_camera_params(width=w, height=h, device=dev, **cam)
    imgs, stats18 = {}, {}
    for label, over in (("mode2", {}), ("mode0", dict(attr_compact=0)),
                        ("mode1", dict(attr_compact=1))):
        img, rays, arr = fused_18(sd, dataclasses.replace(cfg, **over), pr18,
                                  f"phase 18b {label}", "attr_modes", k2=label == "mode2")
        imgs[label], stats18[label] = img, (rays, arr)

    def share_close(a, b, rtol, atol):
        return float(torch.isclose(a, b, rtol=rtol, atol=atol).all(-1).float().mean())

    m1_share = share_close(imgs["mode1"], imgs["mode2"], 1e-3, 1e-5)
    m1_mean = abs(float(imgs["mode1"].mean()) / float(imgs["mode2"].mean()) - 1.0)
    m0_mean = abs(float(imgs["mode0"].mean()) / float(imgs["mode2"].mean()) - 1.0)
    if m1_share < 0.99 or m1_mean > 0.005:
        raise AssertionError(f"phase 18b: mode 1 against mode 2 (K2): {m1_share:.6f} of pixels "
                             f"within rtol 1e-3 / atol 1e-5, mean rel {m1_mean:g}")
    flat_rel = {k: film_vs_flat(imgs[k], flat_img, f"phase 18b {k}")
                for k in ("mode0", "mode1")}
    log(f"phase 18b: mode 1 against the mode-2 pass "
        f"of the same samples (K2): {m1_share:.6f} of pixels within rtol 1e-3 / atol 1e-5, "
        f"bitwise {share_close(imgs['mode1'], imgs['mode2'], 0, 0):.6f}, mean rel {m1_mean:.3e}, "
        f"rays {stats18['mode1'][0]} / {stats18['mode2'][0]}; mode 0 (f32 normals) against "
        f"mode 2: mean rel {m0_mean:.3e}; against phase 4's film (mean rel, tile statistic): "
        f"{flat_rel}")

    # 18c: 65,537 materials, the five repeated round-robin (index 65,536 is
    # the first mesh's); each mesh keeps its material's record under an
    # index near the top, the first mesh's 65,536.
    mscene, _mcam = million_triangle_scene(1_000_000)
    five = list(mscene.materials)
    m0 = mscene.meshes[0][0].material_index
    mscene.materials = [five[(j + m0 - 65_536) % len(five)] for j in range(65_537)]
    for k, (mesh, _xf) in enumerate(mscene.meshes):
        m = mesh.material_index
        mesh.material_index = 65_536 - (m0 - m) % len(five) - len(five) * (k % 97)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        msd = mscene.build("wide16", device=dev)
    placeholder = [str(c.message) for c in caught
                   if "attr_compact supports at most 65536 materials; compact attr table "
                      "degraded to placeholder" in str(c.message)]
    top_index = int(msd.attr_material.max())
    if len(placeholder) != 2 or top_index != 65_536 or msd.attr_shade_c.shape[0] != 2:
        raise AssertionError(f"phase 18c: warnings {[str(c.message) for c in caught]}, top "
                             f"index {top_index}, attr_shade_c {tuple(msd.attr_shade_c.shape)}")
    log(f"phase 18c build of the grid with {msd.materials.shape[0]} materials (indices to "
        f"{top_index}): {time.perf_counter() - t0:.1f} s; it warned {placeholder[0]!r} for "
        f"the f16 and the oct rows")
    mk1 = RenderConfig(width=w, height=h, samples_per_pass=1, max_bounces=5,
                       integrator="megakernel")
    films_mk = {}
    for label, sd_ in (("grid", sd), ("65537", msd)):
        films_mk[label], dt, got = path_pass(
            f"phase 18c megakernel {label}", lambda sd_=sd_: integrator.render_pass(
                sd_, mk1, pr18, 0), lambda o, g: {"arrival16_run": g["arrival16_run"]},
            "many_materials")
        log(f"phase 18c megakernel on the {label} materials: {dt:.3f} s/pass (1080p, 1 spp), "
            f"launches {got}")
    if not torch.equal(films_mk["grid"], films_mk["65537"]):
        raise AssertionError("phase 18c: the megakernel renders the 65,537 materials "
                             "differently")
    # 18b's mode-0 pass on these tables: its film is 18b's (the grid's five
    # materials) bit for bit.
    img_m, _rays, _arr = fused_18(
        msd, dataclasses.replace(cfg, attr_compact=0), pr18,
        "phase 18c fused mode 0, 65,537 materials", "attr_modes")
    if not torch.equal(img_m, imgs["mode0"]):
        raise AssertionError("phase 18c: the mode-0 film on the 65,537 materials differs from "
                             "18b's on the grid's five")
    try:
        fused.fused_pass_with_stats(msd, cfg, pr18, 0)
        raise AssertionError("phase 18c: a mode-2 pass on 65,537 materials was not refused")
    except ValueError as e:
        if "config.attr_compact requires <= 65536 materials" not in str(e):
            raise
        refusal = str(e)
    log(f"phase 18c: the megakernel and fused mode 0 render the 65,537 materials bit for bit "
        f"as the grid's five; mode 2 refused: {refusal!r}")
    del msd, mscene, films_mk

    # 18d: the films.  The legacy and sorted films take the general
    # transition (K2 serves the record film only), so they are held to the
    # record film on it (18b's mode 1: the same f16 bytes as mode 2); the
    # record film at shift 1 takes K2 and is held to 18b's mode-2 pass.
    legacy = dict(use_record_film=False, use_sorted_film=False)
    film_cases = (("legacy", legacy, "mode1"),
                  ("sorted_k0", dict(use_record_film=False, film_k_shift=0), "mode1"),
                  ("sorted_k1", dict(use_record_film=False, film_k_shift=1), "mode1"),
                  ("record_k1", dict(film_k_shift=1), "mode2"))
    for label, over, ref in film_cases:
        img, rays, arr = fused_18(sd, dataclasses.replace(cfg, **over), pr18,
                                  f"phase 18d {label}", "films", k2=ref == "mode2")
        imgs[label] = img
        if (rays, arr) != stats18[ref]:
            raise AssertionError(f"phase 18d {label}: rays/arrivals {(rays, arr)}, the record "
                                 f"film's {stats18[ref]}")
        torch.testing.assert_close(img * SPP, imgs[ref] * SPP, rtol=3e-7, atol=1e-7,
                                   msg=lambda m, label=label: f"phase 18d {label}: {m}")
    small = dataclasses.replace(cfg, width=480, height=270, **legacy)
    twice = [fused_18(sd, small, make_camera_params(width=480, height=270, device=dev, **cam),
                      f"phase 18d legacy 480x270 ({k})", "films")[0] for k in ("a", "b")]
    log(f"phase 18d films: legacy, sorted (shift 0, 1) and record (shift 1) within rtol 3e-7 "
        f"/ atol 1e-7 of the record film at shift 0, rays and arrivals equal; two legacy "
        f"passes (480x270) bitwise equal: {torch.equal(twice[0], twice[1])} (share "
        f"{float((twice[0] == twice[1]).float().mean()):.6f}); card: {card}")

    # 18e: wide8, the cross-check backend (plain PyTorch, no kernel).
    t0 = time.perf_counter()
    sd8 = scene.build("wide8", device=dev)
    log(f"phase 18e wide8 table: {sd8.wide8_nodes.shape[0]} rows, depth {sd8.stack_depth}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    # The megakernel renders 480x270 (plain PyTorch, 13 s a pass at 1080p);
    # the hits are held to K1's on the 1080p primary rays.
    small = dataclasses.replace(cfg, width=480, height=270)
    ps = make_camera_params(width=480, height=270, device=dev, **cam)
    mk8 = dataclasses.replace(mk1, width=480, height=270, traversal="wide8")
    (film8, dt8, _got) = path_pass("phase 18e megakernel wide8",
                                   lambda: integrator.render_pass(sd8, mk8, ps, 0),
                                   lambda o, g: {}, "wide8")
    img8 = film8.reshape(270, 480, 3)
    check_film(img8, (270, 480, 3), "phase 18e megakernel wide8")
    pix = torch.arange(w * h, device=dev, dtype=torch.int64)
    rng0 = urng.seed(pix, torch.zeros_like(pix), pr18.seed_root)
    coords, rng0 = ucamera.jittered_pixel_coords(pix, mk1, rng0)
    o, d, _ = ucamera.get_screen_ray(coords, mk1, pr18, rng0)
    t8, _b8, tri8, _i8 = tw8.closest_hit(sd8.wide8_nodes, o, d, sd8.stack_depth)
    (hit16, _dt, got16) = path_pass(
        "phase 18e K1 primary rays", lambda: tw16.closest_hit(sd.wide16_nodes, o, d,
                                                              sd.stack_depth),
        lambda o_, g: {"arrival16_run": g["arrival16_run"]}, "wide8_check")
    t16, _b16, tri16, _i16 = hit16
    h8, h16 = tri8 >= 0, tri16 >= 0
    same_rec = (sd8.tris[tri8.clamp_min(0).long()] == sd.tris[tri16.clamp_min(0).long()]).all(-1)
    same = (h8 == h16) & (~h8 | same_rec)
    both = h8 & h16 & same_rec
    t_rel = ((t8 - t16).abs() / t16.clamp_min(1e-3))[both]
    share = float(same.float().mean())
    if share < 0.99:
        raise AssertionError(f"phase 18e: wide8 and K1 agree on {share:.6f} of primary rays")
    log(f"phase 18e megakernel wide8 (480x270, 1 spp): {dt8:.3f} s/pass, film mean "
        f"{float(img8.mean()):.6f}; 1080p primary rays: {share:.6f} of {w * h} with the same hit "
        f"(triangle record, or miss) on wide8 and on wide16 (K1, {got16['arrival16_run']} "
        f"launches), t rel diff on the same hits max {float(t_rel.max()):.3e}, median "
        f"{float(t_rel.median()):.3e}, bitwise share {float((t8 == t16)[both].float().mean()):.6f}")
    img_s8, rays_s8, _ = fused_18(sd8, dataclasses.replace(small, traversal="wide8"), ps,
                                  "phase 18e fused wide8 480x270", "wide8")
    img_s16, rays_s16, _ = fused_18(sd, small, ps, "phase 18e fused wide16 480x270",
                                    "wide8_check", k2=True)
    rel_s = abs(float(img_s8.mean()) / float(img_s16.mean()) - 1.0)
    if rel_s > 0.02:
        raise AssertionError(f"phase 18e: fused wide8 film mean off wide16's by {rel_s:g}")
    log(f"phase 18e fused 480x270 4 spp: wide8 film mean within {rel_s:.3e} of wide16's "
        f"(rays {rays_s8} / {rays_s16}; the traversals finish segments on other "
        f"super-iterations, so the samples pair otherwise)")
    del sd8, film8, img8, o, d, t8, t16, tri8, tri16, hit16
    iscene, icam = instanced_million_triangle_scene()
    ipr = make_camera_params(width=640, height=360, device=dev, **icam)
    imk = RenderConfig(width=640, height=360, samples_per_pass=1, max_bounces=5,
                       integrator="megakernel")
    inst_imgs = {}
    for trav in ("wide8", "wide16"):
        t0 = time.perf_counter()
        isd_ = iscene.build(trav, device=dev)
        setup = time.perf_counter() - t0
        film_i, dt_i, got_i = path_pass(
            f"phase 18e instanced {trav}",
            lambda isd_=isd_, trav=trav: integrator.render_pass(
                isd_, dataclasses.replace(imk, traversal=trav), ipr, 0),
            lambda o_, g, trav=trav: ({} if trav == "wide8" else
                                      {"arrival16_inst_run": g["arrival16_inst_run"]}),
            "wide8" if trav == "wide8" else "wide8_check")
        inst_imgs[trav] = film_i.reshape(360, 640, 3)
        check_film(inst_imgs[trav], (360, 640, 3), f"phase 18e instanced {trav}")
        log(f"phase 18e instanced grid on {trav} (megakernel, 640x360, 1 spp): set-up "
            f"{setup:.1f} s, {dt_i:.3f} s/pass, launches {got_i}")
        del isd_
    a, b = inst_imgs["wide8"], inst_imgs["wide16"]
    rel_i = abs(float(a.mean()) / float(b.mean()) - 1.0)
    close_i = share_close(a, b, 0.05, 0.02)
    if rel_i > 0.02 or close_i < 0.95:
        raise AssertionError(f"phase 18e: instanced wide8 against two-level wide16: mean rel "
                             f"{rel_i:g}, {close_i:.4f} of pixels within rtol 0.05 / atol 0.02")
    log(f"phase 18e instanced: wide8 against the two-level wide16 render: mean rel "
        f"{rel_i:.3e}, {close_i:.6f} of pixels within rtol 0.05 / atol 0.02, bitwise "
        f"{share_close(a, b, 0, 0):.6f}")
    del iscene, inst_imgs, a, b

    # 18f: the numpy wide16 build, with the native library disabled for
    # this build only, into a cache of its own.
    nscene, ncam = million_triangle_scene(100_000)
    flat = nscene.flatten()
    cache_env = os.environ.get("UWPT_BVH_CACHE_DIR")
    with tempfile.TemporaryDirectory() as cache_dir:
        os.environ["UWPT_BVH_CACHE_DIR"] = cache_dir
        try:
            with native.disabled(), warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                wn = w16.build_scene_wide16(flat.positions, flat.tri_records(), False)
                build_s = time.perf_counter() - t0
            if w16.CACHE_STATS["numpy"] != 1 or not any(
                    "native BVH builder is unavailable" in str(c.message) for c in caught):
                raise AssertionError(f"phase 18f: numpy builds {w16.CACHE_STATS}, warnings "
                                     f"{[str(c.message) for c in caught]}")
            w16.validate_wide16(wn, flat.count)
            # The scene build loads that table from the numpy builder's key;
            # the native builder's key does not name it.
            hits = w16.CACHE_STATS["hit"]
            with native.disabled():
                nsd = nscene.build("wide16", device=dev)
            native_key = os.path.exists(w16.bvh_cache_path(
                flat.positions, flat.tri_records(), False, native_built=True))
        finally:
            if cache_env is None:
                os.environ.pop("UWPT_BVH_CACHE_DIR", None)
            else:
                os.environ["UWPT_BVH_CACHE_DIR"] = cache_env
    if (w16.CACHE_STATS["numpy"] != 1 or w16.CACHE_STATS["hit"] != hits + 1 or native_key
            or nsd.wide16_nodes.shape[0] != wn.nodes.shape[0]):
        raise AssertionError(f"phase 18f: the scene build did not load the numpy table from "
                             f"its own key: {w16.CACHE_STATS}, native key present {native_key}")
    log(f"phase 18f numpy wide16 build of {flat.count} triangles (native library disabled): "
        f"{build_s:.2f} s, {wn.nodes.shape[0]} rows, depth {wn.depth}, validated; warned "
        f"{[str(c.message) for c in caught][0]!r}")
    ncfg = dataclasses.replace(cfg, width=960, height=540)
    npr = make_camera_params(width=960, height=540, device=dev, **ncam)
    fused_18(nsd, ncfg, npr, "phase 18f fused pass on the numpy tables (960x540, 4 spp)",
             "numpy_build", k2=True)
    (ncap,), _ = capture_inputs(nsd, ncfg, npr, k1_calls=(4,))
    check_run("arrival16_run", ncap, "phase 18f (numpy tables)", record_it=False)
    del nsd, nscene, ncap, sd, flat_img
    for k, by_path in p18.items():
        for path, n in by_path.items():
            kernels[k]["launches_by_path"][path] = n
            kernels[k]["launches"] += n
    log(f"phase 18: {time.perf_counter() - t18:.1f} s; K1/K2 launches by path {p18}; numpy BVH "
        f"builds {w16.CACHE_STATS['numpy']}; card: {card}")

    order = ("arrival16_run", "arrival16_inst_run", "arrival16_leaf8_run",
             "arrival16_inst_leaf8_run", "arrival16", "arrival16_inst", "arrival16_leaf8",
             "arrival16_inst_leaf8", "transition16", "transition16_oct", *probe_order)
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
