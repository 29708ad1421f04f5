"""Sharded passes on the card over ``torch.distributed``
(``parallel/film_tiling.py``), each held against one rank's pass.

One rank per card, NCCL, under ``torchrun``:

    torchrun --standalone --nproc_per_node=4 -m unity_webgpu_pathtracer_torch.experiments.multigpu

Several ranks on one card share it over gloo (NCCL refuses two ranks on
one device); ``chip_smoke.py`` phase 17 starts two:

    python -m unity_webgpu_pathtracer_torch.experiments.multigpu --rank 0 --world 2 \\
        --backend gloo --init file:///tmp/dir/rendezvous --out /tmp/dir   # and rank 1

Rank ``r`` runs on ``cuda:(LOCAL_RANK or r) % device_count``.  On the
1M-triangle benchmark scene (its table from the ``.bvh_cache``), every
rank runs:

a. the main path sharded (``multichip_fused_pass``): 1920x1080, 5
   bounces, HDRI NEE, te=8, pool 98,304, 4 samples a pixel, on a
   (tile=world, spp=1) grid and on a (tile=1, spp=world) grid;
b. the megakernel sharded (``multichip_render_pass``), 1 spp on the
   (tile=world) grid;
c. BASELINE's config 5: ``multichip_fused_pass`` at 3840x2160, 1 spp a
   rank on the (tile=world) grid, accumulated into a film,
   ``reproject_film`` across a move of 0.2% of the view distance, a second
   sharded pass accumulated;
d. the all-reduce of a 1080p and a 4K film and the all-gather of their
   tiles, alone, after a barrier; and which collectives the backend takes
   on the card (``collectives_on_device``: each one's result checked,
   a refusal raises).

Each step's seconds, the rank's super-iterations, its K1/K2 launches (K1
once a super-iteration of a fused pass and once a host read of a
traversal; K2 once a super-iteration), its peak device memory, and the
seconds of the local pass and of the collectives inside the sharded passes
(``film_tiling``'s own functions timed through a hook, each between two
synchronizes: a collective's seconds include the wait for the slower
rank).  Then rank 0 holds every film against one rank's pass of the same
samples (rtol 1e-6, atol 1e-7; rays equal), printing the share of values
bitwise equal and the arrivals beside the single pass's; it raises on a
mismatch, and times those single passes.  Each rank prints its report as
one JSON line and writes it to ``--out``/rank<r>.json.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

W, H = 1920, 1080
W4K, H4K = 3840, 2160
SPP, POOL, TE, BOUNCES = 4, 98_304, 8, 5
FILM_TOL = dict(rtol=1e-6, atol=1e-7)
PG_TIMEOUT_S = 300
TIMED = ("fused_pass_with_stats", "render_pass", "_sum_over", "_gather_tiles")


@contextlib.contextmanager
def timed_film_tiling(box: dict):
    """Add the seconds of each of ``film_tiling``'s local passes and
    collectives (between two synchronizes) to ``box[name]``."""
    from unity_webgpu_pathtracer_torch.parallel import film_tiling as ft

    saved = {n: getattr(ft, n) for n in TIMED}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            box[name] = box.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    for name in TIMED:
        setattr(ft, name, timed(name, saved[name]))
    try:
        yield box
    finally:
        for name in TIMED:
            setattr(ft, name, saved[name])


def _compare(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """``got`` within ``FILM_TOL`` of ``want``, or raise; the share of
    values bitwise equal and the largest difference."""
    torch.testing.assert_close(got, want, **FILM_TOL, msg=lambda m: f"{what}: {m}")
    return {"bitwise_share": float((got == want).float().mean()),
            "max_abs": float((got - want).abs().max())}


def collectives_on_device(rank: int, world: int, dev: torch.device) -> list[str]:
    """Run each collective on small tensors on ``dev`` over the world group
    and check its result; returns their names (a backend that refuses
    one raises)."""
    x = torch.full((4,), float(rank + 1), device=dev)
    total = float(world * (world + 1) // 2)
    y = x.clone()
    dist.all_reduce(y)
    ok = bool((y == total).all())
    y = x.clone()
    dist.broadcast(y, 0)
    ok &= bool((y == 1.0).all())
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    ok &= all(bool((p == r + 1).all()) for r, p in enumerate(parts))
    flat = torch.empty(world * 4, device=dev)
    dist.all_gather_into_tensor(flat, x)
    ok &= torch.equal(flat, torch.cat(parts))
    out = torch.empty(4, device=dev)
    dist.reduce_scatter_tensor(out, torch.arange(4.0 * world, device=dev))
    ok &= torch.equal(out, world * torch.arange(4.0 * rank, 4.0 * rank + 4, device=dev))
    if not ok:
        raise AssertionError(f"rank {rank}: a collective on {dev} gave a wrong result")
    return ["all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
            "reduce_scatter_tensor"]


def _rank(rank: int, world: int, dev: torch.device) -> dict:
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene
    from unity_webgpu_pathtracer_torch.ops import cuda_arrival, cuda_build, cuda_transition
    from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as tw16
    from unity_webgpu_pathtracer_torch.parallel import film_tiling as ft
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params
    from unity_webgpu_pathtracer_torch.render.film import accumulate, new_film
    from unity_webgpu_pathtracer_torch.render.fused import fused_pass_with_stats
    from unity_webgpu_pathtracer_torch.render.integrator import render_pass
    from unity_webgpu_pathtracer_torch.render.reproject import reproject_film

    if SPP % world:
        raise ValueError(f"{SPP} samples a pixel do not split over {world} ranks")
    t0 = time.perf_counter()
    cuda_build.load()
    build_s = cuda_build.BUILD_INFO["seconds"]
    scene, cam = million_triangle_scene(1_000_000)
    sd = scene.build("wide16", device=dev)
    rep = {"rank": rank, "world": world, "device": str(dev),
           "card": torch.cuda.get_device_name(dev), "build_s": build_s,
           "setup_s": time.perf_counter() - t0}
    k1, k2 = cuda_arrival.arrival_steps16_cuda.launches, cuda_transition.transition16_cuda.launches

    def reset():
        torch.cuda.synchronize()
        for counter in (k1, k2):
            for k in counter:
                counter[k] = 0
        tw16.TRAVERSE_STATS.update(calls=0, host_reads=0)
        torch.cuda.reset_peak_memory_stats()

    def launches() -> dict:
        return {k: v for k, v in {**k1, **k2}.items() if v}

    def expect(want: dict, what: str) -> dict:
        got = launches()
        if got != want:
            raise AssertionError(f"rank {rank} {what}: launches {got}, expected {want}")
        return got

    def cfg_at(width, height, spp):
        return RenderConfig(width=width, height=height, samples_per_pass=spp,
                            max_bounces=BOUNCES, transition_every=TE, pool_size=POOL)

    def cam_at(width, height, **kw):
        return make_camera_params(width=width, height=height, device=dev, **dict(cam, **kw))

    # The first call of each PyTorch op in a process loads its module:
    # one small pass of each integrator first, uncounted.
    fused_pass_with_stats(sd, cfg_at(64, 36, 1), cam_at(64, 36), 0)
    render_pass(sd, cfg_at(64, 36, 1), cam_at(64, 36), 0)
    params = cam_at(W, H)
    grids = {"tile": ft.make_mesh(world, 1), "spp": ft.make_mesh(1, world)}

    def step(label, fn):
        """``fn()`` from counts at 0, timed to a synchronize: (result,
        its row of the report)."""
        reset()
        box = {}
        with timed_film_tiling(box):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        row = {"s": wall, "local_pass_s": box.get("fused_pass_with_stats", 0.0)
               + box.get("render_pass", 0.0),
               "collectives_s": box.get("_sum_over", 0.0) + box.get("_gather_tiles", 0.0),
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        rep[label] = row
        return out, row

    # a. The main path on both grids.
    films = {}
    for name, grid in grids.items():
        cfg = cfg_at(W, H, SPP // grid.shape["spp"])
        (film, occ, rays, arr, iters), row = step(
            f"fused_{name}", lambda: ft.multichip_fused_pass(sd, cfg, params, 0, grid))
        row.update(grid=grid.shape, coords=(grid.tile, grid.spp), super_iterations=iters,
                   rays=int(rays), arrivals=int(arr), occupancy=float(occ),
                   launches=expect({"arrival16_run": iters, "transition16": iters}, name))
        films[name] = film

    # b. The megakernel on the tile grid.
    cfg1 = cfg_at(W, H, 1)
    film_mk, row = step("megakernel_tile", lambda: ft.multichip_render_pass(
        sd, cfg1, params, 0, grids["tile"]))
    row["launches"] = expect({"arrival16_run": tw16.TRAVERSE_STATS["host_reads"]}, "megakernel")

    # c. BASELINE's config 5 at 4K: pass, reprojection, pass.
    cfg4k, tile = cfg_at(W4K, H4K, 1), grids["tile"]
    eye, target = (np.asarray(cam[k], np.float64) for k in ("eye", "target"))
    right = np.cross(target - eye, (0.0, 1.0, 0.0))
    right /= np.linalg.norm(right)
    p0 = cam_at(W4K, H4K)
    p1 = cam_at(W4K, H4K, eye=tuple(eye + right * 0.002 * np.linalg.norm(target - eye)))
    spp_pass = ft.multichip_samples_per_pass(cfg4k, tile)
    (film4k, _occ, rays4k, arr4k, it0), row0 = step(
        "config5_pass0", lambda: ft.multichip_fused_pass(sd, cfg4k, p0, 0, tile))
    row0.update(super_iterations=it0, rays=int(rays4k), arrivals=int(arr4k),
                launches=expect({"arrival16_run": it0, "transition16": it0}, "config 5 pass 0"))
    film = accumulate(new_film(H4K, W4K, dev), film4k.reshape(H4K, W4K, 3), spp_pass)
    warped, row = step("config5_reproject", lambda: reproject_film(sd, cfg4k, film, p0, p1))
    row.update(kept=float((warped.pixel_counts > 0).float().mean()),
               launches=expect({"arrival16_run": tw16.TRAVERSE_STATS["host_reads"]},
                               "config 5 reprojection"))
    (film1, _occ, _rays, _arr, it1), row = step(
        "config5_pass1", lambda: ft.multichip_fused_pass(sd, cfg4k, p1, warped.sample_count,
                                                         tile))
    row.update(super_iterations=it1,
               launches=expect({"arrival16_run": it1, "transition16": it1}, "config 5 pass 1"))
    final = accumulate(warped, film1.reshape(H4K, W4K, 3), spp_pass)
    if not bool(torch.isfinite(final.accum).all()) or final.sample_count != 2 * spp_pass:
        raise AssertionError(f"rank {rank}: config 5 film not finite or "
                             f"{final.sample_count} spp")
    rep["config5_film"] = {"mean": float(final.accum.mean()), "spp": final.sample_count,
                           "finite": True}

    # d. The collectives alone, after a barrier, at both film sizes.
    rep["collectives_on_device"] = collectives_on_device(rank, world, dev)
    for label, npix in (("1080p", W * H), ("4k", W4K * H4K)):
        x = torch.ones((npix, 3), dtype=torch.float32, device=dev)
        dist.barrier()
        box = {}
        with timed_film_tiling(box):
            ft._sum_over(x, dist.group.WORLD)
            ft._gather_tiles(x[:npix // world], tile.tile_group)
        rep[f"collectives_{label}"] = {"all_reduce_s": box["_sum_over"],
                                       "all_gather_s": box["_gather_tiles"],
                                       "bytes": x.numel() * 4}
        del x

    rep["launches"] = {k: sum(rep[s]["launches"].get(k, 0) for s in (
        "fused_tile", "fused_spp", "megakernel_tile", "config5_pass0", "config5_reproject",
        "config5_pass1")) for k in ("arrival16_run", "transition16")}
    rep["jax_imported"] = "jax" in sys.modules
    if rep["jax_imported"]:
        raise AssertionError(f"rank {rank}: jax was imported")
    if rank != 0:
        return rep

    # Rank 0 holds every film against one rank's pass of the same samples
    # (timed too: the other ranks have ended).
    def single_pass(label, cfg, p):
        t0 = time.perf_counter()
        out = fused_pass_with_stats(sd, cfg, p, 0)
        torch.cuda.synchronize()
        rep[f"single_{label}"] = {"s": time.perf_counter() - t0, "super_iterations": out[4]}
        return out

    reset()
    single, _occ, rays1, arr1, _it = single_pass("1080p", cfg_at(W, H, SPP), params)
    for name, film_g in films.items():
        row = rep[f"fused_{name}"]
        row["vs_single"] = dict(_compare(film_g, single, f"fused {name} grid"),
                                single_arrivals=int(arr1), single_rays=int(rays1))
        if row["rays"] != int(rays1):
            raise AssertionError(f"fused {name} grid: rays {row['rays']}, single {int(rays1)}")
    rep["megakernel_tile"]["vs_single"] = _compare(film_mk, render_pass(sd, cfg1, params, 0),
                                                   "megakernel tile grid")
    single4k, _occ, rays1, arr1, _it = single_pass("4k", cfg4k, p0)
    rep["config5_pass0"]["vs_single"] = dict(_compare(film4k, single4k, "config 5 pass 0"),
                                             single_arrivals=int(arr1), single_rays=int(rays1))
    if rep["config5_pass0"]["rays"] != int(rays1):
        raise AssertionError(f"config 5 pass 0: rays {rep['config5_pass0']['rays']}, single "
                             f"{int(rays1)}")
    return rep


def run(rank: int, world: int, init: str, backend: str, out: str | None) -> dict:
    """One rank: join the process group, run the steps, report."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    torch.cuda.set_device(local % torch.cuda.device_count())
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        rep = _rank(rank, world, dev)
    finally:
        dist.destroy_process_group()
    line = json.dumps(rep)
    if out is not None:
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            f.write(line)
    print(line, flush=True)
    return rep


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("multigpu: no CUDA device (the sharded passes run on the card)")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, default=int(os.environ.get("RANK", 0)))
    ap.add_argument("--world", type=int, default=int(os.environ.get("WORLD_SIZE", 1)))
    ap.add_argument("--init", default="env://", help="init_method of the process group")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--out", default=None, help="directory for rank<r>.json")
    a = ap.parse_args(argv)
    run(a.rank, a.world, a.init, a.backend, a.out)


if __name__ == "__main__":
    main()
