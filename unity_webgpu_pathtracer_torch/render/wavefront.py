"""Wavefront path tracing with path regeneration (``render/wavefront.py``
of the reference).

A fixed pool of lanes steps through bounces with the megakernel's
``trace_bounce``; every iteration, lanes whose path ended splat their
radiance into the film and are reloaded with the next (pixel, sample)
work item of the pass's queue, so the pool stays full until the tail of
the pass.  Radiometry is the megakernel's; renders differ from it only in
RNG pairing.

The splat is deterministic: each work item (``sample * pixels + pixel``)
dies once and writes its radiance to its own row of a pass-lifetime
record buffer (no two lanes write one row), and the film sums each
pixel's rows in sample order.  (The reference's scatter-add sums them in
the order they die, which differs by rounding only.)  The loop test reads
two device values a bounce, in one host read.
"""

from __future__ import annotations

import dataclasses

import torch

from unity_webgpu_pathtracer_torch.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_torch.ops import cuda_shade, get_intersectors
from unity_webgpu_pathtracer_torch.render import camera as ucamera
from unity_webgpu_pathtracer_torch.render import film as ufilm
from unity_webgpu_pathtracer_torch.render.integrator import (
    ALPHA_SLACK,
    PathState,
    _nee_branches,
    check_tables,
    firefly_clamp,
    trace_bounce,
)
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.profiling import span


@dataclasses.dataclass
class PoolState:
    path: PathState
    pixel: torch.Tensor           # (P,) int32 film pixel of each lane's path
    work: torch.Tensor            # (P,) int64 work item of each lane's path
    lane_depth_cap: torch.Tensor  # (P,) int32 loop-iteration guard per path
    records: torch.Tensor         # (budget + P, 3) radiance of each finished work item
    queue_head: torch.Tensor      # () int64 next work item
    alive_ticks: torch.Tensor     # () int64 occupancy numerator (= closest rays)
    shade_ticks: torch.Tensor     # () int64 lanes that ran NEE
    ticks: int                    # occupancy denominator (iterations * P)


def _splat(s: PoolState, radiance: torch.Tensor, mask: torch.Tensor,
           config: RenderConfig, params: RenderParams) -> None:
    """Write the finished paths' radiance (3, P), firefly-clamped, to
    their work items' rows; other lanes write to rows past the budget."""
    if config.use_firefly_filter:
        radiance = firefly_clamp(radiance, params)
    budget = s.records.shape[0] - s.work.shape[0]
    lane = torch.arange(s.work.shape[0], device=s.work.device)
    row = torch.where(mask, s.work, budget + lane)
    s.records[row] = radiance.T


def _regenerate(s: PoolState, config: RenderConfig, params: RenderParams, budget: int,
                current_sample: int) -> None:
    """Reload dead lanes with the next (pixel, sample) work items (updates
    ``s`` in place)."""
    npix = config.pixel_count()
    p = s.path
    dead = ~p.alive
    remaining = budget - s.queue_head
    rank = torch.cumsum(dead.to(torch.int64), 0) - 1      # rank among dead lanes
    work_id = s.queue_head + rank
    take = dead & (rank < remaining)
    pixel_new = torch.remainder(work_id, npix)
    sample_new = torch.div(work_id, npix, rounding_mode="floor") + current_sample

    rng_new = urng.seed(pixel_new, sample_new, params.seed_root)
    coords, rng_new = ucamera.jittered_pixel_coords(pixel_new, config, rng_new)
    o_new, d_new, rng_new = ucamera.get_screen_ray(coords, config, params, rng_new)

    zf = torch.zeros_like(p.prev_pdf)
    # Contiguous (3, P) planes, each of its own storage: the shading
    # kernel's layout (``cuda_shade.check_state``).
    s.path = PathState(
        origin=torch.where(take, o_new.T.contiguous(), p.origin),
        direction=torch.where(take, d_new.T.contiguous(), p.direction),
        radiance=torch.where(take, zf, p.radiance),
        throughput=torch.where(take, torch.ones_like(zf), p.throughput),
        rng=torch.where(take, rng_new, p.rng),
        alive=p.alive | take,
        prev_pdf=torch.where(take, zf, p.prev_pdf),
        max_roughness=torch.where(take, zf, p.max_roughness),
        depth=torch.where(take, torch.zeros_like(p.depth), p.depth),
    )
    s.pixel = torch.where(take, pixel_new.to(torch.int32), s.pixel)
    s.work = torch.where(take, work_id, s.work)
    s.lane_depth_cap = torch.where(
        take, torch.full_like(s.lane_depth_cap, config.max_bounces + 1 + ALPHA_SLACK),
        s.lane_depth_cap)
    s.queue_head = s.queue_head + torch.minimum(dead.sum(), remaining)


def wavefront_pass(scene, config: RenderConfig, params: RenderParams, current_sample: int,
                   pool_size: int | None = None):
    """One pass of ``samples_per_pass`` spp over the whole film:
    ``(film_sum (npix, 3), occupancy)``."""
    film_sum, occupancy, _, _ = wavefront_pass_with_stats(
        scene, config, params, current_sample, pool_size)
    return film_sum, occupancy


def wavefront_pass_with_stats(scene, config: RenderConfig, params: RenderParams,
                              current_sample: int, pool_size: int | None = None):
    """Like :func:`wavefront_pass`, with ray counts: ``(film_sum,
    occupancy, closest_rays, shadow_rays)``, the last three device
    scalars; ``shadow_rays`` counts the NEE branches the config enables."""
    check_tables(scene)
    closest_fn, occluded_fn = get_intersectors(config)
    npix = config.pixel_count()
    spp = config.samples_per_pass
    budget = npix * spp
    p = pool_size or config.pool_size or min(npix, 1 << 16)
    dev = scene.attr_normals.device

    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    zeros3 = torch.zeros((3, p), **f32)
    direction = zeros3.clone()
    direction[2] = 1.0
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    s = PoolState(
        path=PathState(origin=zeros3, direction=direction, radiance=zeros3, throughput=zeros3,
                       rng=torch.zeros((p,), dtype=torch.int64, device=dev),
                       alive=torch.zeros((p,), dtype=torch.bool, device=dev),
                       prev_pdf=torch.zeros((p,), **f32),
                       max_roughness=torch.zeros((p,), **f32), depth=torch.zeros((p,), **i32)),
        pixel=torch.zeros((p,), **i32), work=torch.zeros((p,), dtype=torch.int64, device=dev),
        lane_depth_cap=torch.zeros((p,), **i32),
        records=torch.zeros((budget + p, 3), **f32),
        queue_head=zero.clone(), alive_ticks=zero.clone(), shade_ticks=zero.clone(), ticks=0)
    # The shading kernel's work planes, where it shades: one set for the pass.
    work = cuda_shade.new_work(p, dev) if cuda_shade.covers(config, scene) else None

    while True:
        with span("sync.queue"):
            if not bool((s.path.alive.any() | (s.queue_head < budget)).item()):
                break
        _regenerate(s, config, params, budget, current_sample)
        # A copy: on the shading kernel's route trace_bounce updates the
        # path state in place.
        was_alive = s.path.alive.clone()
        path, shade = trace_bounce(scene, config, params, s.path, closest_fn, occluded_fn,
                                   with_stats=True, work=work)
        s.lane_depth_cap = s.lane_depth_cap - 1
        path.alive = path.alive & (s.lane_depth_cap > 0)
        _splat(s, path.radiance, was_alive & ~path.alive, config, params)
        s.path = path
        s.alive_ticks = s.alive_ticks + was_alive.sum()
        s.shade_ticks = s.shade_ticks + shade.sum()
        s.ticks += p

    rec = s.records[:budget].view(spp, npix, 3)
    film_sum = rec[0]
    for k in range(1, spp):
        film_sum = film_sum + rec[k]
    occupancy = s.alive_ticks.to(torch.float32) / max(float(s.ticks), 1.0)
    return (film_sum, occupancy, s.alive_ticks,
            s.shade_ticks * _nee_branches(scene, config))


def wavefront_pass_and_accumulate(scene, config: RenderConfig, params: RenderParams,
                                  film: ufilm.Film) -> ufilm.Film:
    """One wavefront pass accumulated into ``film``, seeded from its
    largest sample count (per-pixel counts after a reprojection)."""
    total, _occ = wavefront_pass(scene, config, params, film.sample_count)
    total = total.reshape(config.height, config.width, 3)
    return ufilm.accumulate(film, total, config.samples_per_pass)
