"""One rank of ``tests/test_torch_parallel.py``'s gloo runs on the CPU.

    python tests/torch_parallel_worker.py RANK WORLD INIT_METHOD OUT_DIR

It imports torch and the port only (never JAX or the reference, so a rank
starts in a few seconds): it joins the gloo process group at
``INIT_METHOD`` (a ``file://`` rendezvous), builds the Cornell box, runs
the sharded passes of ``parallel/film_tiling.py`` and saves what they
return to ``OUT_DIR/rank<RANK>.pt``; the test holds them against the
single-device passes.
"""

from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist

SIZE = 16          # Cornell at SIZE x SIZE, 3 bounces, no sky
POOL = 1024


def cornell(size: int = SIZE, traversal: str = "wide16"):
    """(SceneData, camera dict) of the Cornell box on the CPU."""
    from unity_webgpu_pathtracer_torch.models.cornell import cornell_box

    scene, cam = cornell_box()
    return scene.build(traversal, device="cpu"), cam


def config(spp: int, size: int = SIZE, traversal: str = "wide16"):
    from unity_webgpu_pathtracer_torch.config import RenderConfig

    return RenderConfig(width=size, height=size, samples_per_pass=spp, max_bounces=3,
                        sky_mode=2, pool_size=POOL, traversal=traversal)


def camera(cam: dict, moved: bool = False, size: int = SIZE):
    """The Cornell camera, or the config-5 flow's small move of its eye."""
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    if moved:
        eye = cam["eye"]
        cam = dict(cam, eye=(eye[0] + 0.02, eye[1] + 0.01, eye[2]))
    return make_camera_params(width=size, height=size, device="cpu", **cam)


def config5_flow(sd, cfg, p0, p1, pass_fn, spp_pass: int):
    """BASELINE's config 5 composed (``tests/test_config5.py::_flow``): one
    pass at ``p0``, the film reprojected to ``p1``, one more pass."""
    from unity_webgpu_pathtracer_torch.render.film import accumulate, new_film
    from unity_webgpu_pathtracer_torch.render.reproject import reproject_film

    h, w = cfg.height, cfg.width
    film = accumulate(new_film(h, w, "cpu"), pass_fn(p0, 0).reshape(h, w, 3), spp_pass)
    warped = reproject_film(sd, cfg, film, p0, p1)
    return accumulate(warped, pass_fn(p1, spp_pass).reshape(h, w, 3), spp_pass)


def main(rank: int, world: int, init: str, out_dir: str) -> None:
    from unity_webgpu_pathtracer_torch.parallel import film_tiling as ft

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        sd, cam = cornell()
        p0, p1 = camera(cam), camera(cam, moved=True)
        mesh22, mesh41, mesh21 = ft.make_mesh(2, 2), ft.make_mesh(4, 1), ft.make_mesh(2, 1)
        cfg2 = config(2)
        out = {"coords": (mesh22.tile, mesh22.spp, mesh41.tile, mesh21 is None)}
        out["fused"] = ft.multichip_fused_pass(sd, cfg2, p0, 0, mesh22, pool_size=POOL)
        sd8, _ = cornell(traversal="wide8")
        out["fused_wide8"] = ft.multichip_fused_pass(sd8, config(2, traversal="wide8"), p0, 0,
                                                     mesh22, pool_size=POOL)
        out["megakernel_tile_spp"] = ft.multichip_render_pass(sd, config(1), p0, 0, mesh22)
        out["megakernel_tile"] = ft.multichip_render_pass(sd, config(1), p0, 0, mesh41)
        spp_pass = ft.multichip_samples_per_pass(cfg2, mesh22)

        def sharded(p, cur):
            return ft.multichip_fused_pass(sd, cfg2, p, cur, mesh22, pool_size=POOL)[0]

        film = config5_flow(sd, cfg2, p0, p1, sharded, spp_pass)
        out["config5"] = (film.accum, film.pixel_counts, film.sample_count, spp_pass)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
