"""Fused wavefront integrator, wide16 + record-film main path
(``render/fused.py`` of the reference).

One pass is a loop of super-iterations over a pool of B lanes.  Each
super-iteration runs ``transition_every`` arrivals (kernel K1,
``ops/cuda_arrival.py``), one transition (the env sample and the
attribute/material gathers in PyTorch, then kernel K2,
``ops/cuda_transition.py``, then the record-film append and work-queue
regeneration in PyTorch), and the gather-free prestep on fresh lanes,
in the reference's order: the RNG stream depends on it.

Dead lanes pull (pixel, sample) work items off a pixel-major queue.  Each
path's radiance is appended once, keyed by pixel, to a pass-lifetime
record buffer; the end-of-pass stable sort groups the records by pixel
and a reshape-sum resolves the film, so each pixel's samples are summed
in the reference's order.

The loop test reads two device values per super-iteration (one
device->host sync), and the pass returns its super-iteration count.
Lane vectors are kept as (3, B) planes, the layout the kernels read.
"""

from __future__ import annotations

import dataclasses

import torch

from unity_webgpu_pathtracer_torch.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as tw16
from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_step16_cuda
from unity_webgpu_pathtracer_torch.ops.cuda_transition import (
    MODE_DEAD,
    MODE_PRIMARY,
    MODE_SHADOW_ENV,
    transition_step16_cuda,
)
from unity_webgpu_pathtracer_torch.render import camera as ucamera
from unity_webgpu_pathtracer_torch.render import film as ufilm
from unity_webgpu_pathtracer_torch.scene.envmap import sample_env_transition
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.math import FAR_PLANE, safe_rcp

# Sort key of record rows never written in a pass (behind every pixel).
_UNWRITTEN_KEY = 1 << 30


@dataclasses.dataclass
class FusedState:
    mode: torch.Tensor            # (B,) int32
    trav: tw16.Wide16State        # active traversal registers
    trav_o: torch.Tensor          # (3, B) active ray origin
    trav_d: torch.Tensor          # (3, B) active ray direction
    # Primary-path registers (survive across shadow traversals).
    path_o: torch.Tensor          # (3, B)
    path_d: torch.Tensor          # (3, B)
    hit_t: torch.Tensor           # (B,)
    hit_uv_bary: torch.Tensor     # (2, B)
    hit_tri: torch.Tensor         # (B,) int32 attribute row (-1 = miss)
    pending: torch.Tensor         # (3, B) NEE contribution awaiting its shadow ray
    throughput: torch.Tensor      # (3, B)
    radiance: torch.Tensor        # (3, B)
    rng: torch.Tensor             # (B,) int64 holding uint32
    pixel: torch.Tensor           # (B,) int32
    depth: torch.Tensor           # (B,) int32
    max_roughness: torch.Tensor   # (B,)
    prev_pdf: torch.Tensor        # (B,)
    lane_cap: torch.Tensor        # (B,) int32 transition budget
    # Counters (device scalars, int64).
    queue_head: torch.Tensor      # work items started
    arrivals: torch.Tensor        # lane-arrivals on live segments
    rays: torch.Tensor            # closest + shadow rays started
    busy: torch.Tensor            # busy lane-ticks
    ticks: torch.Tensor           # lane-ticks
    # Record film: (budget + B) rows of (pixel key, rgb) and the cursor.
    rec_keys: torch.Tensor        # (C,) int32
    rec_rgb: torch.Tensor         # (3, C) float32
    rec_cursor: torch.Tensor      # () int64


def _set_trav(s: FusedState, mask: torch.Tensor) -> None:
    """Point masked lanes' traversal at their path ray, registers reset."""
    tr = s.trav
    zi = torch.zeros_like(tr.ptr)
    zf = torch.zeros_like(tr.t)
    s.trav = tr._replace(
        ptr=torch.where(mask, zi, tr.ptr),
        pend=torch.where(mask, torch.full_like(tr.pend, tw16.FULL), tr.pend),
        sp=torch.where(mask, zi, tr.sp),
        t=torch.where(mask, torch.full_like(tr.t, FAR_PLANE), tr.t),
        u=torch.where(mask, zf, tr.u),
        v=torch.where(mask, zf, tr.v),
        tri=torch.where(mask, torch.full_like(tr.tri, -1), tr.tri),
        found=tr.found & ~mask,
    )
    s.trav_o = torch.where(mask, s.path_o, s.trav_o)
    s.trav_d = torch.where(mask, s.path_d, s.trav_d)


def _transition_kernel_path(scene, config: RenderConfig, params: RenderParams,
                            s: FusedState, budget: int, current_sample: int,
                            trav_done: torch.Tensor) -> None:
    """One transition: env sample and gathers, kernel K2, record-film
    append and work-queue regeneration (updates ``s`` in place)."""
    b = s.mode.shape[0]
    npix = config.pixel_count()
    dev = s.mode.device
    tr = s.trav

    a = (s.mode == MODE_PRIMARY) & trav_done
    hit_valid = tr.tri >= 0
    sky_raw, sky_pdf, env_dir, env_col, env_pdf, rng_state = sample_env_transition(
        scene.env, params.environment_rotation, s.path_d.T, a & hit_valid, s.rng,
        need=a)
    intensity = torch.where(s.depth > 0, params.environment_intensity,
                            torch.ones_like(sky_pdf))
    sky_color = sky_raw * intensity[:, None]
    env_li = env_col * params.environment_intensity

    # Attribute row of this lane's hit: 15 f16 halfwords + a u16 material
    # index.  Lanes that consume no attributes this transition read row 0.
    shadow_done = trav_done | tr.found
    need_mat = (a & hit_valid) | ((s.mode == MODE_SHADOW_ENV) & shadow_done)
    attr = torch.where(need_mat, torch.clamp_min(torch.where(a, tr.tri, s.hit_tri), 0),
                       torch.zeros_like(tr.tri)).long()
    rows = scene.attr_shade_c[attr]                              # (B, 8) int32
    shade_rowT = rows.view(torch.float16)[:, 0:15].to(torch.float32).T.contiguous()
    mat_idx = ((rows[:, 7] >> 16) & 0xFFFF).long()
    mdataT = scene.materials[mat_idx, 0:22].T.contiguous()

    k = transition_step16_cuda(
        mode=s.mode, trav_done=trav_done, ptr=tr.ptr, pend=tr.pend, sp=tr.sp,
        t=tr.t, u=tr.u, v=tr.v, tri=tr.tri, found=tr.found,
        trav_oT=s.trav_o, trav_dT=s.trav_d, path_oT=s.path_o, path_dT=s.path_d,
        hit_t=s.hit_t, hit_baryT=s.hit_uv_bary, hit_tri=s.hit_tri,
        pendingT=s.pending, throughputT=s.throughput, radianceT=s.radiance,
        rng=rng_state, depth=s.depth, max_rough=s.max_roughness,
        prev_pdf=s.prev_pdf, lane_cap=s.lane_cap,
        shade_rowT=shade_rowT, mdataT=mdataT,
        sky_colT=sky_color.T.contiguous(), sky_pdf=sky_pdf,
        env_dirT=env_dir.T.contiguous(), env_liT=env_li.T.contiguous(),
        env_pdf=env_pdf,
        use_rr=config.use_russian_roulette, max_bounces=config.max_bounces,
        firefly=config.use_firefly_filter,
        firefly_max=params.max_firefly_luminance.reshape(1),
        nan_canary=config.debug_nan_canary)

    # ---- record-film append: every lane's record, keyed by its pixel if
    # the lane died and past every pixel otherwise, stably sorted (each
    # pixel keeps its order) and written at the cursor; only the dead
    # lanes' records advance it, the tail is overwritten by the next
    # append.  All deaths are taken at once (the reference's default
    # film_k_shift = 0), so no lane ever waits with a pending record. ----
    lane = torch.arange(b, device=dev)
    key = torch.where(k.died, s.pixel, (npix + lane).to(torch.int32))
    ks, perm = torch.sort(key, stable=True)
    at = s.rec_cursor + lane
    s.rec_keys[at] = ks
    s.rec_rgb[:, at] = k.rad_outT[:, perm]
    s.rec_cursor = s.rec_cursor + k.died.sum()

    # ---- work-queue regeneration into dead lanes ----
    avail = k.mode == MODE_DEAD
    remaining = budget - s.queue_head
    rank = torch.cumsum(avail.to(torch.int64), 0) - 1
    work_id = s.queue_head + rank
    take = avail & (rank < remaining)
    pixel_new = torch.remainder(work_id, npix)
    sample_new = torch.div(work_id, npix, rounding_mode="floor") + current_sample
    s.queue_head = s.queue_head + torch.minimum(avail.sum(), remaining)
    radiance = torch.where(k.died | take, torch.zeros_like(k.radianceT), k.radianceT)

    rng_new = urng.seed(pixel_new, sample_new, params.seed_root)
    coords, rng_new = ucamera.jittered_pixel_coords(pixel_new, config, rng_new)
    o_new, d_new = ucamera.get_screen_ray(coords, config, params)
    o_new, d_new = o_new.T.contiguous(), d_new.T.contiguous()   # (3, B) planes

    s.mode = torch.where(take, torch.full_like(k.mode, MODE_PRIMARY), k.mode)
    s.trav = tw16.Wide16State(ptr=k.ptr, pend=k.pend, sp=k.sp,
                              stack_row=tr.stack_row, stack_mask=tr.stack_mask,
                              t=k.t, u=k.u, v=k.v, tri=k.tri, found=k.found)
    s.trav_o, s.trav_d = k.trav_oT, k.trav_dT
    s.path_o = torch.where(take, o_new, k.path_oT)
    s.path_d = torch.where(take, d_new, k.path_dT)
    _set_trav(s, take)
    s.hit_t, s.hit_uv_bary, s.hit_tri = k.hit_t, k.hit_baryT, k.hit_tri
    s.pending = k.pendingT
    s.throughput = torch.where(take, torch.ones_like(k.throughputT), k.throughputT)
    s.radiance = radiance
    s.rng = torch.where(take, rng_new, k.rng)
    s.pixel = torch.where(take, pixel_new.to(torch.int32), s.pixel)
    s.depth = torch.where(take, torch.zeros_like(k.depth), k.depth)
    s.max_roughness = torch.where(take, torch.zeros_like(k.max_rough), k.max_rough)
    s.prev_pdf = torch.where(take, torch.zeros_like(k.prev_pdf), k.prev_pdf)
    s.lane_cap = torch.where(take, torch.full_like(k.lane_cap, 3 * (config.max_bounces + 2) + 32),
                             k.lane_cap)
    # Bounce and shadow starts are counted in-kernel (nray); regens here.
    s.rays = s.rays + k.nray.sum() + take.sum()


def _initial_state(b: int, depth: int, budget: int, dev) -> FusedState:
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    z3 = torch.zeros((3, b), **f32)
    dz = torch.zeros((3, b), **f32)
    dz[2] = 1.0
    zf = torch.zeros((b,), **f32)
    zi = torch.zeros((b,), **i32)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    # budget rows of records + one pool-sized block for the last append's
    # garbage tail; never-written rows sort behind every pixel.
    cap = budget + b
    return FusedState(
        mode=torch.full((b,), MODE_DEAD, **i32),
        trav=tw16.init_state16(b, 0.0, ptr0=tw16.DONE, depth=depth, device=dev),
        trav_o=z3.clone(), trav_d=dz.clone(), path_o=z3.clone(), path_d=dz.clone(),
        hit_t=zf.clone(), hit_uv_bary=torch.zeros((2, b), **f32),
        hit_tri=torch.full((b,), -1, **i32),
        pending=z3.clone(), throughput=z3.clone(), radiance=z3.clone(),
        rng=torch.zeros((b,), dtype=torch.int64, device=dev),
        pixel=zi.clone(), depth=zi.clone(), max_roughness=zf.clone(),
        prev_pdf=zf.clone(), lane_cap=zi.clone(),
        queue_head=zero.clone(), arrivals=zero.clone(), rays=zero.clone(),
        busy=zero.clone(), ticks=zero.clone(),
        rec_keys=torch.full((cap,), _UNWRITTEN_KEY, **i32),
        rec_rgb=torch.zeros((3, cap), **f32),
        rec_cursor=zero.clone(),
    )


def fused_pass_with_stats(scene, config: RenderConfig, params: RenderParams,
                          current_sample: int):
    """Render one pass of ``samples_per_pass`` samples per pixel.

    Returns ``(film_sum (npix, 3), occupancy, rays, arrivals,
    super_iterations)``: the first four as in the reference (device
    tensors), the last a host int."""
    npix = config.pixel_count()
    spp = config.samples_per_pass
    budget = npix * spp
    # Pool: configured or min(budget, 96K) lanes, rounded up to a multiple
    # of 1024 as the reference does whenever its kernels run.
    b = ((config.pool_size or min(budget, 3 << 15)) + 1023) & ~1023
    dev = scene.wide16_nodes.device
    nodes = scene.wide16_nodes
    te = config.transition_every
    s = _initial_state(b, scene.stack_depth, budget, dev)

    iters = 0
    while bool(((s.mode != MODE_DEAD).any() | (s.queue_head < budget)).item()):
        iters += 1
        inv = safe_rcp(s.trav_d)
        live = s.mode != MODE_DEAD
        shadowing = s.mode == MODE_SHADOW_ENV
        trav = s.trav
        for _ in range(te):
            trav = arrival_step16_cuda(nodes, s.trav_o, s.trav_d, inv, trav,
                                       live & ~(shadowing & trav.found))
        stepping = live & (s.trav.ptr >= 0)
        trav_done = trav.ptr < 0
        s.trav = trav
        s.arrivals = s.arrivals + te * stepping.sum()
        s.busy = s.busy + live.sum()
        s.ticks = s.ticks + b
        _transition_kernel_path(scene, config, params, s, budget, current_sample,
                                trav_done)
        fresh = ((s.trav.ptr == 0) & (s.trav.pend == tw16.FULL)
                 & (s.trav.sp == 0) & (s.mode != MODE_DEAD))
        s.trav = tw16.prestep16(nodes, scene.wide16_top, s.trav_o.T, s.trav_d.T,
                                safe_rcp(s.trav_d).T, s.trav, fresh)

    # Resolve: one stable sort by pixel; every pixel owns exactly spp
    # records, so a reshape-sum makes the film.
    _, order = torch.sort(s.rec_keys, stable=True)
    film = s.rec_rgb[:, order[:budget]].reshape(3, npix, spp).sum(dim=2).T
    occupancy = s.busy.to(torch.float32) / torch.clamp_min(s.ticks.to(torch.float32), 1.0)
    return film, occupancy, s.rays, s.arrivals, iters


def fused_pass_and_accumulate(scene, config: RenderConfig, params: RenderParams,
                              film: ufilm.Film):
    """One progressive pass accumulated into ``film``; returns
    ``(film, occupancy, rays, arrivals, super_iterations)``."""
    total, occ, rays, arr, iters = fused_pass_with_stats(
        scene, config, params, film.sample_count)
    total = total.reshape(config.height, config.width, 3)
    return ufilm.accumulate(film, total, config.samples_per_pass), occ, rays, arr, iters
