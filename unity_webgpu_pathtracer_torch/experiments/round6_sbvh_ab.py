"""Tree quality A/B on the benchmark grid (``experiments/round6_sbvh_ab.py``
of the reference: SBVH spatial splits against binned SAH).

One process, full 1920x1080 passes of the fused main path (K1 + K2),
the grid's wide16 table built at each quality (``Scene.build`` under
``UWPT_BVH_QUALITY``, so ``UWPT_COLLAPSE=dp`` turns qualities 0 and 1
into 2 and 3, as in the reference), one throwaway pass first, the seed
varied per pass, the qualities alternated A/B/A/B and the minimum of the
timed passes kept.  Per quality: rows, references, depth, build seconds,
table MiB, s/pass, Mrays/s, occupancy, arrivals per ray, the film's sum
and the K1 and K2 launches (counted on the card), beside the
super-iterations of the quality's passes, the throwaway one included.

    python -m unity_webgpu_pathtracer_torch.experiments.round6_sbvh_ab

Env, as the reference reads them: PROBE_TRIS (default 1M), SWEEP_SPP
(16), TE (10), POOL (262,144).  The reference's PAL picks its Pallas or
XLA arrival; the port's fused pass always launches K1, so it is not
read.  ``ab`` is the A/B itself on any scene and device;
``round9_sbvh_beams`` runs it on the beams.
"""

from __future__ import annotations

import os
import subprocess
import time

import torch

from unity_webgpu_pathtracer_torch.experiments._common import cuda_device

TRIS = int(os.environ.get("PROBE_TRIS", 1_000_000))
SPP = int(os.environ.get("SWEEP_SPP", 16))
TE = int(os.environ.get("TE", 10))
POOL = int(os.environ.get("POOL", 262_144))
SEED = 0x9E3779B9


def _launches() -> tuple[int, int]:
    """K1's and K2's launches so far (the render paths' counters)."""
    from unity_webgpu_pathtracer_torch.ops import cuda_arrival, cuda_transition

    return (sum(cuda_arrival.arrival_steps16_cuda.launches.values()),
            sum(cuda_transition.transition16_cuda.launches.values()))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tables(scene, qualities, device: torch.device, leaf8: bool | None = None) -> dict:
    """``scene.build("wide16")`` with ``UWPT_BVH_QUALITY`` set to each of
    ``qualities`` in turn (the reference's loop; the variable is restored
    after): ``{resolved quality: (SceneData, build seconds)}``, the
    seconds to a synchronize (a load when the table is in the cache)."""
    from unity_webgpu_pathtracer_torch.accel import wide16 as w16

    out = {}
    old = os.environ.get("UWPT_BVH_QUALITY")
    try:
        for q in qualities:
            os.environ["UWPT_BVH_QUALITY"] = str(q)
            t0 = time.perf_counter()
            sd = scene.build("wide16", device=device, leaf8=leaf8)
            _sync(device)
            out[w16.resolve_quality(None)] = (sd, time.perf_counter() - t0)
    finally:
        if old is None:
            os.environ.pop("UWPT_BVH_QUALITY", None)
        else:
            os.environ["UWPT_BVH_QUALITY"] = old
    return out


def ab(scene, cam: dict, qualities, device: torch.device, width: int = 1920,
       height: int = 1080, spp: int = SPP, te: int = TE, pool: int = POOL, reps: int = 3,
       seed: int = SEED, leaf8: bool | None = None, log=print) -> dict:
    """The A/B: the tables of ``tables``, one throwaway pass on the first,
    then ``reps`` rounds of one pass per table in ``qualities`` order,
    each from a seed of its own (``seed + 10 + rep * len + index``; the
    reference's for two qualities).  Returns ``rows`` (one dict per
    quality, in order), ``tables`` (quality -> SceneData), ``films``
    (quality -> the last pass's film sum, (H*W, 3)), ``config`` and
    ``params`` (the passes' settings, the throwaway pass's seed)."""
    from unity_webgpu_pathtracer_torch.config import RenderConfig
    from unity_webgpu_pathtracer_torch.render import fused
    from unity_webgpu_pathtracer_torch.render.camera import make_camera_params

    built = tables(scene, qualities, device, leaf8)
    qs = list(built)
    cfg = RenderConfig(width=width, height=height, samples_per_pass=spp, max_bounces=5,
                       transition_every=te, pool_size=pool)

    def params(i):
        return make_camera_params(width=width, height=height, device=device,
                                  seed_root=(seed + i) % 2**32, **cam)

    rows = {}
    for q, (sd, build_s) in built.items():
        nodes = sd.wide16_nodes
        rows[q] = dict(quality=q, rows=int(nodes.shape[0]), refs=int(sd.tris.shape[0]),
                       depth=sd.stack_depth - 1, build_s=build_s,
                       table_mib=nodes.numel() * nodes.element_size() / 2**20, times=[],
                       si_total=0, k1_launches=0, k2_launches=0)
        log(f"quality={q}: {rows[q]['rows']:,} rows, attr rows {rows[q]['refs']:,}, depth "
            f"{rows[q]['depth']}, table {rows[q]['table_mib']:.1f} MiB, build {build_s:.2f} s")

    def one(q, i):
        k1, k2 = _launches()
        _sync(device)
        t0 = time.perf_counter()
        out = fused.fused_pass_with_stats(built[q][0], cfg, params(i), 0)
        _sync(device)
        dt = time.perf_counter() - t0
        k1_after, k2_after = _launches()
        rows[q]["k1_launches"] += k1_after - k1
        rows[q]["k2_launches"] += k2_after - k2
        rows[q]["si_total"] += out[4]
        return out, dt

    one(qs[0], 0)   # throwaway: the first pass of a process pays the set-up
    films = {}
    for rep in range(reps):
        for i, q in enumerate(qs):
            (film, occ, rays, arr, iters), dt = one(q, 10 + rep * len(qs) + i)
            r = rows[q]
            r["times"].append(dt)
            r.update(rays=int(rays), arrivals=int(arr), occupancy=float(occ),
                     super_iterations=iters, film_sum=float(film.sum()),
                     film_mean=float(film.mean()) / spp)
            films[q] = film
    for r in rows.values():
        dt = min(r["times"])
        r.update(s_pass=dt, mrays=r["rays"] / dt / 1e6,
                 arrivals_per_ray=r["arrivals"] / max(r["rays"], 1))
        log(f"quality={r['quality']}: {dt:6.3f} s/pass, {r['mrays']:6.3f} Mrays/s, occ "
            f"{r['occupancy']:.3f}, arr/ray {r['arrivals_per_ray']:5.2f}, film "
            f"{r['film_sum']:.6g}, super-iterations {r['super_iterations']}, K1/K2 launches "
            f"{r['k1_launches']}/{r['k2_launches']} (times "
            f"{[round(t, 3) for t in r['times']]})")
    return dict(rows=[rows[q] for q in qs], tables={q: built[q][0] for q in qs}, films=films,
                config=cfg, params=params(0))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def run(qualities=(0, 1), device=None, **kw) -> dict:
    """``ab`` on ``million_triangle_scene(TRIS)`` on the card."""
    from unity_webgpu_pathtracer_torch.models.benchmark import million_triangle_scene

    dev = cuda_device(device)
    scene, cam = million_triangle_scene(TRIS)
    return ab(scene, cam, qualities, dev, **kw)


def main() -> None:
    from unity_webgpu_pathtracer_torch.ops import cuda_build

    cuda_build.load()
    print(f"PROBE_TRIS={TRIS} SWEEP_SPP={SPP} TE={TE} POOL={POOL}; card: {card()}", flush=True)
    run(log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
