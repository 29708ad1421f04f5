"""Fused wavefront integrator (``render/fused.py`` of the reference).

One pass is a loop of super-iterations over a pool of B lanes.  Each
super-iteration runs ``transition_every`` arrivals, one transition, and on
wide16 the gather-free prestep on fresh lanes, in the reference's order:
the RNG stream depends on it.  The arrivals take the route of
``config.traversal``, as the reference's do: on wide16 tables kernel K1
(``ops/cuda_arrival.py``, one launch that updates the traversal state in
place, its instanced variant on two-level tables); on the reference's
other tables its traversals in plain PyTorch: wide8 (its cross-check),
wide (fat rows, ``ops/traverse_wide.py::arrival_step``) and wide2 (split
fat rows: ``transition_every`` node steps and one leaf step,
``ops/traverse_wide2.py``), flat or two-level.

The transition is routed per pass as the reference routes it
(``_pallas_transition_supported``): the HDRI configuration on a flat
scene without analytic lights, textures or normal maps runs kernel K2
(``ops/cuda_transition.py``), one launch that samples the environment,
reads each lane's attribute and material rows and updates the lane state
in place (``_transition_kernel_path``), on wide16 tables with the f16 or
oct rows (``attr_compact`` 2 or 3) and the record film; every other
configuration the port admits (the constant environment, the basic sky,
no sky, instanced scenes, analytic lights, textures and normal maps, the
f32 rows of mode 0 and the f16 rows of mode 1, wide8, wide and wide2
tables, the sorted and legacy films, scenes past 65,536 materials) runs the general
transition (``_transition``), plain PyTorch like the reference's XLA one.
Both end in the same film append and work-queue regeneration (with the
thin lens's sample when ``use_depth_of_field``).  ``attr_in_kernel``
changes nothing here, since K2 reads and decodes the rows itself on
either setting.

Dead lanes pull (pixel, sample) work items off a pixel-major queue, over
the whole film or over a shard of its pixels and samples (the multi-GPU
passes of ``parallel/film_tiling.py``).  With the record film each path's
radiance is appended once, keyed by pixel, to a pass-lifetime record
buffer; the end-of-pass stable sort groups the records by pixel and a
reshape-sum resolves the film, so each pixel's samples are summed in the
reference's order.  The sorted-prefix film scatter-adds the accepted
records, sorted by pixel, each transition, and the legacy film every
dying lane's; on the card those adds are atomic, so their order, and the
film's last bits, may change from run to run.  With ``film_k_shift > 0``
a transition accepts at most K = B >> shift records: the others stay in
their lanes, dead with their radiance, and retry before the lane takes new
work; the pass flushes the last of them after the loop.

The loop test reads two device values per super-iteration (one
device->host sync), and the pass returns its super-iteration count.
Lane vectors are kept as (3, B) planes, the layout the kernels read.
"""

from __future__ import annotations

import dataclasses

import torch

from unity_webgpu_pathtracer_torch.config import (
    ALPHA_MODE_BLEND,
    ALPHA_MODE_MASK,
    FUSED_TRAVERSALS,
    LIGHT_TYPE_POINT,
    LIGHT_TYPE_RECTANGLE,
    LIGHT_TYPE_SPOT,
    SKY_MODE_ENVIRONMENT,
    RenderConfig,
    RenderParams,
)
from unity_webgpu_pathtracer_torch.ops import traverse_wide as tw
from unity_webgpu_pathtracer_torch.ops import traverse_wide2 as tw2
from unity_webgpu_pathtracer_torch.ops import traverse_wide8 as tw8
from unity_webgpu_pathtracer_torch.ops import traverse_wide16 as tw16
from unity_webgpu_pathtracer_torch.ops.cuda_arrival import arrival_steps16_cuda
from unity_webgpu_pathtracer_torch.ops.cuda_transition import (
    MODE_DEAD,
    MODE_PRIMARY,
    MODE_SHADOW_ENV,
    MODE_SHADOW_LIGHT,
    TransitionState,
    attr_index,
    shade_rows,
    transition16_cuda,
)
from unity_webgpu_pathtracer_torch.render import bsdf
from unity_webgpu_pathtracer_torch.render import camera as ucamera
from unity_webgpu_pathtracer_torch.render import film as ufilm
from unity_webgpu_pathtracer_torch.render.hitinfo import (
    _analytic_light_hit,
    instance_material_override,
    instance_normal_to_world,
)
from unity_webgpu_pathtracer_torch.render.lights import _unity_falloff, spot_cone_fade
from unity_webgpu_pathtracer_torch.render.sampling import power_heuristic, uniform_sample_sphere
from unity_webgpu_pathtracer_torch.render.sky import sample_sky_radiance
from unity_webgpu_pathtracer_torch.scene.envmap import sample_env_transition
from unity_webgpu_pathtracer_torch.scene.material import apply_normal_map, derive_material
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.math import (
    EPSILON,
    FAR_PLANE,
    PI,
    safe_rcp,
    sqrt,
    vcross,
    vdot,
    vluminance,
    vneg,
    vnormalize,
    vscale,
    vwhere,
)
from unity_webgpu_pathtracer_torch.utils.profiling import span

# Sort key of record rows never written in a pass (behind every pixel).
_UNWRITTEN_KEY = 1 << 30


@dataclasses.dataclass
class FusedState:
    mode: torch.Tensor            # (B,) int32
    # Active traversal registers, the state of the pass's route.
    trav: tw16.Wide16State | tw8.Wide8State | tw.WideState | tw2.Wide2State
    trav_o: torch.Tensor          # (3, B) active ray origin
    trav_d: torch.Tensor          # (3, B) active ray direction
    # Primary-path registers (survive across shadow traversals).
    path_o: torch.Tensor          # (3, B)
    path_d: torch.Tensor          # (3, B)
    hit_t: torch.Tensor           # (B,)
    hit_uv_bary: torch.Tensor     # (2, B)
    hit_tri: torch.Tensor         # (B,) int32 attribute row (-1 = miss)
    hit_inst: torch.Tensor        # (B,) int32 instance of the hit (-1 = none)
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
    # Lanes whose record waits for a later transition (film_k_shift > 0).
    rec_pending: torch.Tensor     # (B,) bool
    # Sorted and legacy films: (npix_local + B, 3); rows past the film take
    # the adds of lanes that add nothing (one row each, dropped at the end).
    film: torch.Tensor
    # The work queue's share of the film and the samples, host ints:
    # (pixel_base, npix_l, sample_base, spp_l); the whole film is
    # (0, npix, 0, samples_per_pass).
    shard: tuple
    # The root's position: row 0, or wide2's signed entry code.
    trav_root: int = 0


def _stack(v) -> torch.Tensor:
    """Planes (a 3-tuple or a (3, B) tensor) as one (3, B) tensor."""
    return torch.stack([v[0], v[1], v[2]])


def _set_trav(s: FusedState, mask: torch.Tensor, o, d, t_max=None) -> None:
    """Start masked lanes on a fresh world-space segment along ``(o, d)``
    ((3, B) planes) at the root, registers reset; the segment ends at
    ``t_max`` ((B,), or the far plane when None).  The route's own
    registers are reset by the state's type: the stack of wide16 and wide8,
    the parked leaf of wide2 (a root leaf starts parked)."""
    tr = s.trav
    if t_max is None:
        t_max = torch.full_like(tr.t, FAR_PLANE)
    zi = torch.zeros_like(tr.ptr)
    zf = torch.zeros_like(tr.t)
    minus1 = torch.full_like(tr.tri, -1)
    extra = {}
    ptr0 = 0
    if isinstance(tr, (tw16.Wide16State, tw8.Wide8State)):
        full = tw8.FULL if isinstance(tr, tw8.Wide8State) else tw16.FULL
        extra = dict(pend=torch.where(mask, torch.full_like(tr.pend, full), tr.pend),
                     sp=torch.where(mask, zi, tr.sp))
    elif isinstance(tr, tw2.Wide2State):
        ptr0, pending0 = tw2.entry_registers(s.trav_root)
        extra = dict(pending=torch.where(mask, torch.full_like(tr.pending, pending0),
                                         tr.pending))
    s.trav = tr._replace(
        **extra,
        ptr=torch.where(mask, torch.full_like(zi, ptr0), tr.ptr),
        t=torch.where(mask, t_max, tr.t),
        u=torch.where(mask, zf, tr.u),
        v=torch.where(mask, zf, tr.v),
        tri=torch.where(mask, minus1, tr.tri),
        found=tr.found & ~mask,
        inst=torch.where(mask, minus1, tr.inst),
        hit_inst=torch.where(mask, minus1, tr.hit_inst),
    )
    s.trav_o = torch.where(mask, o, s.trav_o)
    s.trav_d = torch.where(mask, d, s.trav_d)


def _light_nee(scene, config: RenderConfig) -> bool:
    """Analytic-light NEE runs: the config asks for it and the scene has
    lights."""
    return config.has_lights and scene.lights.shape[0] > 0


def _kernel_transition_supported(scene, config: RenderConfig) -> bool:
    """The reference's ``_pallas_transition_supported``: wide16 tables,
    attribute rows of mode 2 or 3, the HDRI with its NEE over merged rows
    that cover the image, on a flat scene, with no analytic lights,
    textures or normal maps, the record film (at any ``film_k_shift``) and
    at most 65,536 materials."""
    env = scene.env
    return (config.traversal == "wide16" and config.attr_compact in (2, 3)
            and config.sky_mode == SKY_MODE_ENVIRONMENT and config.has_environment_texture
            and env.merged_rows.shape[0] == env.image.shape[0] * env.image.shape[1]
            and not _light_nee(scene, config)
            and not (config.has_textures or config.has_normal_maps)
            and scene.inst_w2l.shape[0] == 0
            and config.use_record_film
            and scene.materials.shape[0] <= 0x10000)


def _append_film(config: RenderConfig, s: FusedState, died: torch.Tensor,
                 rad_out: torch.Tensor) -> torch.Tensor | None:
    """The film half of the end of a transition: take the dying lanes'
    records (``rad_out`` (3, B)) into the pass's film, and return the lanes
    whose records wait, or None where no record ever waits (the legacy
    film, and ``film_k_shift`` 0) (updates ``s`` in place).

    The record and sorted films accept the dying and the waiting lanes up
    to K = B >> ``film_k_shift`` (all the dying ones at shift 0), key every
    lane by its shard-local pixel if accepted and past every pixel
    otherwise, and sort the keys stably (each pixel keeps its order).  The
    record film writes the first K sorted records at the cursor, which only
    the accepted advance, so the tail is overwritten by the next append;
    the sorted film adds them to its rows.  The legacy film adds every
    dying lane's record, the others going to rows past the film."""
    b = s.mode.shape[0]
    pixel_base, npix_l, _sample_base, _spp_l = s.shard
    lane = torch.arange(b, device=s.mode.device)
    pix_local = s.pixel - pixel_base
    if not (config.use_record_film or config.use_sorted_film):
        s.film.index_add_(0, torch.where(died, pix_local, (npix_l + lane).to(torch.int32)),
                          rad_out.T)
        return None
    k_slots = max(b >> config.film_k_shift, 1)
    if config.film_k_shift == 0:
        emit = accepted = died
    else:
        emit = died | s.rec_pending
        rank = torch.cumsum(emit.to(torch.int64), 0) - 1
        accepted = emit & (rank < k_slots)
    key = torch.where(accepted, pix_local, (npix_l + lane).to(torch.int32))
    ks, perm = torch.sort(key, stable=True)
    if config.use_record_film:
        at = s.rec_cursor + lane[:k_slots]
        s.rec_keys[at] = ks[:k_slots]
        s.rec_rgb[:, at] = rad_out[:, perm[:k_slots]]
        s.rec_cursor = s.rec_cursor + accepted.sum()
    else:
        s.film.index_add_(0, ks[:k_slots], rad_out[:, perm[:k_slots]].T)
    return None if config.film_k_shift == 0 else emit & ~accepted


def _record_and_regenerate(config: RenderConfig, params: RenderParams, s: FusedState,
                           budget: int, current_sample: int, died: torch.Tensor,
                           rad_out: torch.Tensor) -> None:
    """The end of every transition, on ``s`` already shaded: take the
    dying lanes' records into the film (``_append_film``), then start
    queued work items in the dead lanes whose records are taken (updates
    ``s`` in place); a lane whose record waits keeps it as its radiance.
    Work item ``i`` is the shard's pixel ``i % npix_l`` and sample
    ``i // npix_l``; its seed and camera ray are keyed by the global
    (pixel, sample), so a shard's samples are the single pass's."""
    pixel_base, npix_l, sample_base, _spp_l = s.shard
    rec_pending = _append_film(config, s, died, rad_out)
    avail = s.mode == MODE_DEAD
    if rec_pending is not None:
        taken = (died | s.rec_pending) & ~rec_pending
        avail = avail & ~rec_pending
    remaining = budget - s.queue_head
    rank = torch.cumsum(avail.to(torch.int64), 0) - 1
    work_id = s.queue_head + rank
    take = avail & (rank < remaining)
    pixel_new = torch.remainder(work_id, npix_l) + pixel_base
    sample_new = torch.div(work_id, npix_l, rounding_mode="floor") + (current_sample
                                                                      + sample_base)
    s.queue_head = s.queue_head + torch.minimum(avail.sum(), remaining)
    if rec_pending is None:
        s.radiance = torch.where(died | take, torch.zeros_like(s.radiance), s.radiance)
    else:
        s.radiance = torch.where(taken | take, torch.zeros_like(s.radiance),
                                 torch.where(rec_pending, rad_out, s.radiance))
        s.rec_pending = rec_pending

    rng_new = urng.seed(pixel_new, sample_new, params.seed_root)
    coords, rng_new = ucamera.jittered_pixel_coords(pixel_new, config, rng_new)
    o_new, d_new, rng_new = ucamera.get_screen_ray(coords, config, params, rng_new)
    s.mode = torch.where(take, torch.full_like(s.mode, MODE_PRIMARY), s.mode)
    # (3, B) planes: the kernels take contiguous planes, and torch.where
    # keeps a transposed operand's strides.
    s.path_o = torch.where(take, o_new.T.contiguous(), s.path_o)
    s.path_d = torch.where(take, d_new.T.contiguous(), s.path_d)
    _set_trav(s, take, s.path_o, s.path_d)
    s.throughput = torch.where(take, torch.ones_like(s.throughput), s.throughput)
    s.rng = torch.where(take, rng_new, s.rng)
    s.pixel = torch.where(take, pixel_new.to(torch.int32), s.pixel)
    s.depth = torch.where(take, torch.zeros_like(s.depth), s.depth)
    s.max_roughness = torch.where(take, torch.zeros_like(s.max_roughness), s.max_roughness)
    s.prev_pdf = torch.where(take, torch.zeros_like(s.prev_pdf), s.prev_pdf)
    s.lane_cap = torch.where(take, torch.full_like(s.lane_cap, 3 * (config.max_bounces + 2) + 32),
                             s.lane_cap)
    s.rays = s.rays + take.sum()


def transition_state(s: FusedState) -> TransitionState:
    """The tensors of ``s`` that K2 updates in place."""
    tr = s.trav
    return TransitionState(
        mode=s.mode, ptr=tr.ptr, pend=tr.pend, sp=tr.sp, t=tr.t, u=tr.u, v=tr.v, tri=tr.tri,
        found=tr.found, trav_o=s.trav_o, trav_d=s.trav_d, path_o=s.path_o, path_d=s.path_d,
        hit_t=s.hit_t, hit_bary=s.hit_uv_bary, hit_tri=s.hit_tri, pending=s.pending,
        throughput=s.throughput, radiance=s.radiance, rng=s.rng, depth=s.depth,
        max_rough=s.max_roughness, prev_pdf=s.prev_pdf, lane_cap=s.lane_cap, rays=s.rays)


def _transition_kernel_path(scene, config: RenderConfig, params: RenderParams,
                            s: FusedState, budget: int, current_sample: int) -> None:
    """One transition through kernel K2 (it reads ``trav_done`` from the
    arrivals' ``ptr`` and adds its ray starts to ``s.rays``), then the
    record-film append and regeneration (updates ``s`` in place)."""
    died, rad_out = transition16_cuda(scene, config, params, transition_state(s))
    if config.film_k_shift > 0:
        # K2 writes rad_out where a lane died; a waiting lane's record is
        # the radiance it keeps.
        rad_out = torch.where(died, rad_out, s.radiance)
    _record_and_regenerate(config, params, s, budget, current_sample, died, rad_out)


def _transition(scene, config: RenderConfig, params: RenderParams, s: FusedState,
                budget: int, current_sample: int,
                trav_done: torch.Tensor | None = None) -> None:
    """The general transition (the reference's ``_transition``): miss ->
    sky with MIS; a primary ray that meets an analytic light first ->
    the light's emission, and the path ends; hit -> shade (textured
    material and normal map, instance hooks), emission, alpha passthrough;
    shadow result -> pending contribution; environment NEE (HDRI or
    constant colour) for sky mode 0, then analytic-light NEE (one light
    picked uniformly); BSDF sample, Russian roulette, firefly clamp, NaN
    canary, lane cap; then the record-film append and regeneration.  The
    uniforms are drawn in the reference's order: the env sample, the alpha
    draw (every lane), the constant-env pair, the light pick, the light
    pair, the BSDF triple, the RR draw.  ``trav_done`` marks the lanes whose
    segment ended (None: ``ptr < 0``, the stack routes' end).  Updates
    ``s`` in place."""
    env_nee = config.sky_mode == SKY_MODE_ENVIRONMENT
    light_nee = _light_nee(scene, config)
    tr = s.trav
    if trav_done is None:
        trav_done = tr.ptr < 0
    shadow_done = trav_done | tr.found
    rng = s.rng
    a = (s.mode == MODE_PRIMARY) & trav_done
    hit_valid = tr.tri >= 0
    zero = torch.zeros_like(tr.t)
    z3 = (zero, zero, zero)
    path_o, path_d, throughput = s.path_o, s.path_d, s.throughput

    # --- analytic light interception (may be nearer than the triangle) ---
    if light_nee:
        lhit, _t_light, lidx = _analytic_light_hit(scene.lights, path_o, path_d, tr.t)
    else:
        lhit = torch.zeros_like(a)

    # --- miss -> sky with MIS (the HDRI's sky and NEE share one gather) ---
    if env_nee and config.has_environment_texture:
        sky_raw, sky_pdf, env_dir, env_col, env_pdf, rng = sample_env_transition(
            scene.env, params.environment_rotation, path_d.T, a & hit_valid, rng, need=a)
        intensity = torch.where(s.depth > 0, params.environment_intensity,
                                torch.ones_like(sky_pdf))
        sky_color = (sky_raw * intensity[:, None]).T
        env_dir = env_dir.T
        env_li = (env_col * params.environment_intensity).T
    else:
        sky_color, sky_pdf = sample_sky_radiance(config, params, path_d.T, s.depth)
        sky_color = sky_color.T
    mis = torch.where(s.depth > 0, power_heuristic(s.prev_pdf, sky_pdf), torch.ones_like(zero))
    miss = a & ~hit_valid & ~lhit
    g_miss = miss & (mis > 0)
    radiance = tuple(s.radiance[c] + torch.where(g_miss, mis * sky_color[c] * throughput[c],
                                                 zero) for c in range(3))

    # --- analytic light hit -> emission, the path ends ---
    light_hit = a & lhit
    if light_nee:
        l_em = scene.lights[torch.clamp_min(lidx, 0).long(), 4:7].T
        radiance = tuple(radiance[c] + torch.where(light_hit, l_em[c] * throughput[c], zero)
                         for c in range(3))
    shade = a & hit_valid & ~lhit

    # --- hit frame: one attribute + material fetch serves the lanes that
    # just hit (their fresh registers) and the shadow lanes (saved ones) ---
    b0 = torch.where(a, tr.u, s.hit_uv_bary[0])
    b1 = torch.where(a, tr.v, s.hit_uv_bary[1])
    sel_t = torch.where(a, tr.t, s.hit_t)
    env_done = (s.mode == MODE_SHADOW_ENV) & shadow_done
    light_done = (s.mode == MODE_SHADOW_LIGHT) & shadow_done
    attr = attr_index(a, (a & hit_valid) | env_done | light_done, tr.tri, s.hit_tri)
    sr, mat_idx = shade_rows(scene, config.attr_compact, attr)
    w0 = 1.0 - b0 - b1
    normal = vnormalize((sr[0] * w0 + sr[3] * b0 + sr[6] * b1,
                         sr[1] * w0 + sr[4] * b0 + sr[7] * b1,
                         sr[2] * w0 + sr[5] * b0 + sr[8] * b1))
    uv = (sr[9] * w0 + sr[11] * b0 + sr[13] * b1, sr[10] * w0 + sr[12] * b0 + sr[14] * b1)
    if config.has_normal_maps:
        tg = scene.attr_tangents[attr].T                         # (9, B)
        tangent = vnormalize((tg[0] * w0 + tg[3] * b0 + tg[6] * b1,
                              tg[1] * w0 + tg[4] * b0 + tg[7] * b1,
                              tg[2] * w0 + tg[5] * b0 + tg[8] * b1))
    if scene.inst_w2l.shape[0] > 0:
        sel_inst = torch.where(a, tr.hit_inst, s.hit_inst)
        normal = instance_normal_to_world(scene, sel_inst, normal)
        if config.has_normal_maps:
            tangent = instance_normal_to_world(scene, sel_inst, tangent)
        mat_idx = instance_material_override(scene, sel_inst, mat_idx)
    mdataT = scene.materials[torch.clamp_min(mat_idx, 0).long()].T
    if config.has_normal_maps:
        normal = apply_normal_map(mdataT, uv, normal, tangent, scene.texture_data,
                                  config.has_textures)
    mat = derive_material(mdataT, path_d, normal, uv, scene.texture_data, config.has_textures)
    max_roughness = torch.where(shade, torch.maximum(s.max_roughness, mat.roughness),
                                s.max_roughness)
    mat = bsdf.with_roughness(mat, max_roughness)
    ffnormal = vwhere(vdot(normal, path_d) <= 0.0, normal, vneg(normal))
    position = tuple(path_o[c] + sel_t * path_d[c] for c in range(3))
    scatter_pos = tuple(position[c] + normal[c] * EPSILON for c in range(3))

    radiance = tuple(radiance[c] + torch.where(shade, mat.emission[c] * throughput[c], zero)
                     for c in range(3))
    over_budget = s.depth >= config.max_bounces
    ended_budget = shade & over_budget
    shade = shade & ~over_budget

    # --- alpha passthrough (pathtrace.hlsl:84-89) ---
    u_alpha, rng = urng.random_float(rng)
    passthrough = shade & (
        ((mat.alpha_mode == ALPHA_MODE_MASK) & (mat.opacity < mat.alpha_cutoff))
        | ((mat.alpha_mode == ALPHA_MODE_BLEND) & (u_alpha > mat.opacity)))
    shade = shade & ~passthrough

    # --- shadow traversal finished -> apply the pending contribution ---
    g_app = (env_done | light_done) & ~tr.found
    radiance = tuple(radiance[c] + torch.where(g_app, s.pending[c] * throughput[c], zero)
                     for c in range(3))
    # Lanes entering each NEE stage, and those ready for the BSDF sample.
    to_env = shade if env_nee else torch.zeros_like(shade)
    to_light = (env_done if env_nee else shade) if light_nee else torch.zeros_like(shade)
    to_bsdf = light_done if light_nee else (env_done if env_nee else shade)
    pending = s.pending
    new_mode = s.mode

    # --- env NEE direction/Li (light.hlsl:125-158) ---
    if env_nee and not config.has_environment_texture:
        (r1, r2), rng = urng.random_floats(rng, 2)
        env_dir = uniform_sample_sphere(r1, r2)
        env_pdf = torch.full_like(zero, 1.0 / (4.0 * PI))
        env_li = (params.environment_color * params.environment_intensity)[:, None] \
            .expand(3, zero.shape[0])

    # --- analytic light NEE direction/Li (light.hlsl:117-173) ---
    if light_nee:
        lcount = scene.lights.shape[0]
        u_pick, rng = urng.random_float(rng)
        li_idx = torch.clamp((u_pick * lcount).to(torch.int32), 0, lcount - 1)
        rec = scene.lights[li_idx.long()].T                      # (16, B)
        ltype = rec[3].to(torch.int32)
        lpos, lu, lv = (rec[0], rec[1], rec[2]), (rec[8], rec[9], rec[10]), \
            (rec[12], rec[13], rec[14])
        emission = vscale((rec[4], rec[5], rec[6]), float(lcount))
        lrange, larea = rec[7], rec[11]
        (r1, r2), rng = urng.random_floats(rng, 2)
        to_rect = tuple(lpos[c] + lu[c] * r1 + lv[c] * r2 - scatter_pos[c] for c in range(3))
        rect_dist = sqrt(torch.clamp_min(vdot(to_rect, to_rect), 0.0))
        rect_den = torch.clamp_min(rect_dist, 1e-20)
        rect_dir = tuple(to_rect[c] / rect_den for c in range(3))
        rect_normal = vnormalize(vcross(lu, lv))
        rect_pdf = rect_dist * rect_dist / torch.clamp_min(
            larea * torch.abs(vdot(rect_normal, rect_dir)), 1e-20)
        to_l = tuple(lpos[c] - scatter_pos[c] for c in range(3))
        delta_dist = sqrt(torch.clamp_min(vdot(to_l, to_l), 0.0))
        delta_den = torch.clamp_min(delta_dist, 1e-20)
        delta_dir = tuple(to_l[c] / delta_den for c in range(3))
        is_rect = ltype == LIGHT_TYPE_RECTANGLE
        is_spot = ltype == LIGHT_TYPE_SPOT
        is_point = ltype == LIGHT_TYPE_POINT
        light_dir = vwhere(is_rect, rect_dir, delta_dir)
        ldist = torch.where(is_rect, rect_dist, delta_dist)
        lnormal = vwhere(is_rect, rect_normal, vwhere(is_spot, vnormalize(lu), vneg(delta_dir)))
        lpdf2 = torch.where(is_rect, rect_pdf, zero)
        falloff = _unity_falloff(ldist, lrange)
        cos_t = vdot(vneg(light_dir), vnormalize(lnormal))
        falloff = torch.where(is_rect & (cos_t < 0), zero, falloff)
        spot_fade = spot_cone_fade(cos_t, rec[12], rec[13])
        falloff = torch.where(is_spot, falloff * spot_fade, falloff)

    # --- NEE evaluation: the env and light lanes are disjoint, so one
    # eval_brdf serves both (env about ffnormal, lights about the raw
    # normal, the reference's asymmetry, light.hlsl:105/134) ---
    if env_nee and light_nee:
        f_u, bpdf_u = bsdf.eval_brdf(mat, vneg(path_d), vwhere(to_light, normal, ffnormal),
                                     vwhere(to_light, light_dir, env_dir))
    elif env_nee:
        f_u, bpdf_u = bsdf.eval_brdf(mat, vneg(path_d), ffnormal, env_dir)
    elif light_nee:
        f_u, bpdf_u = bsdf.eval_brdf(mat, vneg(path_d), normal, light_dir)

    if env_nee:
        mis_e = power_heuristic(env_pdf, bpdf_u)
        epdf_den = torch.clamp_min(env_pdf, 1e-20)
        contrib = tuple(mis_e * env_li[c] * f_u[c] / epdf_den for c in range(3))
        ok = (bpdf_u > 0) & (env_pdf > 0) & (mis_e > 0)
        pending = vwhere(to_env, vwhere(ok, contrib, z3), pending)
        new_mode = torch.where(to_env, torch.full_like(new_mode, MODE_SHADOW_ENV), new_mode)
    if light_nee:
        lpdf_den = torch.where(lpdf2 > 0, lpdf2, torch.ones_like(lpdf2))
        contrib_l = tuple(emission[c] * falloff * f_u[c] / lpdf_den for c in range(3))
        ok_l = (is_rect | is_spot | is_point) & (falloff > 0)
        pending = vwhere(to_light, vwhere(ok_l, contrib_l, z3), pending)
        new_mode = torch.where(to_light, torch.full_like(new_mode, MODE_SHADOW_LIGHT), new_mode)

    # --- BSDF sample + Russian roulette -> next bounce or death ---
    f_s, l_s, pdf_s, rng = bsdf.sample_brdf(mat, vneg(path_d), ffnormal, rng)
    nan_lane = ((f_s[0] != f_s[0]) | (f_s[1] != f_s[1])
                | (f_s[2] != f_s[2]) | (pdf_s != pdf_s))
    sample_ok = to_bsdf & ~nan_lane & (pdf_s > 0.0)
    pdf_den = torch.clamp_min(pdf_s, 1e-20)
    throughput = vwhere(sample_ok, tuple(throughput[c] * f_s[c] / pdf_den for c in range(3)),
                        throughput)
    continue_ray = sample_ok
    if config.use_russian_roulette:
        u_rr, rng = urng.random_float(rng)
        t_max3 = torch.maximum(torch.maximum(throughput[0], throughput[1]), throughput[2])
        p_cont = torch.clamp_max(t_max3 + 0.001, 0.95)
        rr_kill = continue_ray & (u_rr >= p_cont)
        throughput = vwhere(continue_ray & ~rr_kill,
                            tuple(throughput[c] / p_cont for c in range(3)), throughput)
        continue_ray = continue_ray & ~rr_kill

    # The lane cap counts processed stage transitions (it stops endless
    # alpha passthrough); lanes waiting in traversal spend none.
    processed = a | env_done | light_done
    cap_exhausted = processed & (s.lane_cap <= 0)
    died = miss | light_hit | ended_budget | (to_bsdf & ~continue_ray) | cap_exhausted
    rad_out = radiance
    if config.use_firefly_filter:
        lum = vluminance(rad_out)
        ffly = params.max_firefly_luminance
        rad_out = vscale(rad_out, torch.where(lum > ffly, ffly / torch.clamp_min(lum, 1e-20),
                                              torch.ones_like(lum)))
    if config.debug_nan_canary:
        g_nan = to_bsdf & nan_lane
        rad_out = (torch.where(g_nan, zero, rad_out[0]),
                   torch.where(g_nan, torch.ones_like(zero), rad_out[1]),
                   torch.where(g_nan, zero, rad_out[2]))

    # --- continuing bounce: the new primary ray starts at the hit ---
    new_dir = vwhere(passthrough, path_d, l_s)
    bounce = (continue_ray | passthrough) & ~died
    new_origin = tuple(position[c] + new_dir[c] * EPSILON for c in range(3))
    saved = shade | passthrough

    s.mode = torch.where(bounce, torch.full_like(new_mode, MODE_PRIMARY),
                         torch.where(died, torch.full_like(new_mode, MODE_DEAD), new_mode))
    s.path_o = _stack(vwhere(bounce, new_origin, path_o))
    s.path_d = _stack(vwhere(bounce, new_dir, path_d))
    s.hit_t = torch.where(saved, tr.t, s.hit_t)
    s.hit_uv_bary = torch.where(saved, torch.stack([tr.u, tr.v]), s.hit_uv_bary)
    s.hit_tri = torch.where(saved, tr.tri, s.hit_tri)
    s.hit_inst = torch.where(saved, tr.hit_inst, s.hit_inst)
    s.pending = _stack(pending)
    s.throughput = _stack(throughput)
    s.radiance = _stack(radiance)
    s.rng = rng
    s.depth = torch.where(continue_ray, s.depth + 1, s.depth)
    s.max_roughness = max_roughness
    s.prev_pdf = torch.where(to_bsdf, pdf_s, s.prev_pdf)
    s.lane_cap = torch.where(processed, s.lane_cap - 1, s.lane_cap)
    if env_nee:
        _set_trav(s, to_env, _stack(scatter_pos), _stack(env_dir))
    if light_nee:
        _set_trav(s, to_light, _stack(scatter_pos), _stack(light_dir), ldist - EPSILON)
    _set_trav(s, bounce, s.path_o, s.path_d)
    s.rays = s.rays + bounce.sum() + to_env.sum() + to_light.sum()
    _record_and_regenerate(config, params, s, budget, current_sample, died,
                           _stack(rad_out))


def _initial_trav(scene, traversal: str, b: int, dev):
    """Every lane's traversal registers at the end of a segment."""
    if traversal == "wide":
        return tw.init_state(b, 0.0, ptr0=scene.wide_nodes.shape[1], device=dev)
    if traversal == "wide2":
        return tw2.init_state2(b, 0.0, 0, device=dev)
    if traversal == "wide8":
        return tw8.init_state8(b, 0.0, ptr0=tw8.DONE, depth=scene.stack_depth, device=dev)
    return tw16.init_state16(b, 0.0, ptr0=tw16.DONE, depth=scene.stack_depth, device=dev)


def _initial_state(b: int, trav, shard: tuple, dev, scatter_film: bool = False,
                   trav_root: int = 0) -> FusedState:
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    z3 = torch.zeros((3, b), **f32)
    dz = torch.zeros((3, b), **f32)
    dz[2] = 1.0
    zf = torch.zeros((b,), **f32)
    zi = torch.zeros((b,), **i32)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    # Record film: budget rows of records + one pool-sized block for the
    # last append's garbage tail; never-written rows sort behind every
    # pixel.  The scatter films keep none.
    cap = 0 if scatter_film else shard[1] * shard[3] + b
    return FusedState(
        mode=torch.full((b,), MODE_DEAD, **i32),
        trav=trav,
        trav_o=z3.clone(), trav_d=dz.clone(), path_o=z3.clone(), path_d=dz.clone(),
        hit_t=zf.clone(), hit_uv_bary=torch.zeros((2, b), **f32),
        hit_tri=torch.full((b,), -1, **i32), hit_inst=torch.full((b,), -1, **i32),
        pending=z3.clone(), throughput=z3.clone(), radiance=z3.clone(),
        rng=torch.zeros((b,), dtype=torch.int64, device=dev),
        pixel=zi.clone(), depth=zi.clone(), max_roughness=zf.clone(),
        prev_pdf=zf.clone(), lane_cap=zi.clone(),
        queue_head=zero.clone(), arrivals=zero.clone(), rays=zero.clone(),
        busy=zero.clone(), ticks=zero.clone(),
        rec_keys=torch.full((cap,), _UNWRITTEN_KEY, **i32),
        rec_rgb=torch.zeros((3, cap), **f32),
        rec_cursor=zero.clone(),
        rec_pending=torch.zeros((b,), dtype=torch.bool, device=dev),
        film=torch.zeros((shard[1] + b, 3) if scatter_film else (0, 3), **f32),
        shard=shard,
        trav_root=trav_root,
    )


def fused_pass_with_stats(scene, config: RenderConfig, params: RenderParams,
                          current_sample: int, pool_size: int | None = None, shard=None):
    """Render one pass of ``samples_per_pass`` samples per pixel.

    ``pool_size`` overrides ``config.pool_size``.  ``shard`` (multi-GPU,
    ``parallel/film_tiling.py``): ``(pixel_base, npix_local, sample_base,
    spp_local)``, host ints; the pass renders pixels ``[pixel_base,
    pixel_base + npix_local)``, ``spp_local`` samples each, offset by
    ``sample_base``, and its film rows are shard-local.  Seeds stay keyed
    by the global (pixel, sample), so every sample is the single pass's.

    Returns ``(film_sum (npix_local, 3), occupancy, rays, arrivals,
    super_iterations)``: the first four as in the reference (device
    tensors), the last a host int.  Raises ``ValueError`` when the
    configuration samples the HDRI of a scene that has none (its 1x1
    placeholder table), reads oct attribute rows (``attr_compact=3``)
    that the scene does not have, reads compact rows (modes 1-3) of a
    scene past 65,536 materials (the reference's message), or gets a
    shard off the film."""
    if (config.sky_mode == SKY_MODE_ENVIRONMENT and config.has_environment_texture
            and tuple(scene.env.image.shape[:2]) == (1, 1)):
        raise ValueError("sky_mode 0 with has_environment_texture samples the scene's HDRI, "
                         "and this scene has none (Scene.set_environment); for the constant "
                         "environment set has_environment_texture=False")
    if config.attr_compact and scene.materials.shape[0] > 0x10000:
        raise ValueError("config.attr_compact requires <= 65536 materials (the compact rows "
                         "store a u16 index; the scene build degraded the table to a "
                         "placeholder)")
    if config.attr_compact == 3 and scene.attr_shade_o.shape[0] == 0:
        raise ValueError("attr_compact=3 reads the oct attribute rows, and this SceneData "
                         "has none (build it with Scene.build, or pass attr_shade_o)")
    if shard is None:
        shard = (0, config.pixel_count(), 0, config.samples_per_pass)
    pixel_base, npix_l, sample_base, spp_l = (int(x) for x in shard)
    if not (0 <= pixel_base and npix_l > 0 and pixel_base + npix_l <= config.pixel_count()
            and sample_base >= 0 and spp_l > 0):
        raise ValueError(f"shard {tuple(shard)} is off the film of {config.pixel_count()} "
                         "pixels: (pixel_base, npix_local, sample_base, spp_local)")
    shard = (pixel_base, npix_l, sample_base, spp_l)
    budget = npix_l * spp_l
    # Pool: given, configured or min(budget, 96K) lanes, rounded up to a
    # multiple of 1024 as the reference does whenever its kernels run.
    b = ((pool_size or config.pool_size or min(budget, 3 << 15)) + 1023) & ~1023
    route = config.traversal
    if route not in FUSED_TRAVERSALS:
        raise ValueError(f"the fused integrator runs on {', '.join(FUSED_TRAVERSALS)}, "
                         f"not {route!r}")
    dev = scene.materials.device
    te = config.transition_every
    has_instances = scene.inst_w2l.shape[0] > 0
    inst_w2l = scene.inst_w2l if has_instances else None
    transition = (_transition_kernel_path if _kernel_transition_supported(scene, config)
                  else _transition)
    record = config.use_record_film
    if route == "wide":
        n_orders, n_nodes = scene.wide_nodes.shape[0], scene.wide_nodes.shape[1]
        nodes_flat = scene.wide_nodes.reshape(n_orders * n_nodes, scene.wide_nodes.shape[2])
    elif route == "wide2":
        inner_flat, n_inner, n_orders, leaf_geo, skip_flat = tw2.tables(scene)
    s = _initial_state(b, _initial_trav(scene, route, b, dev), shard, dev,
                       scatter_film=not record,
                       trav_root=scene.wide2_entry if route == "wide2" else 0)

    iters = 0
    while True:
        with span("sync.queue"):
            if not bool(((s.mode != MODE_DEAD).any() | (s.queue_head < budget)).item()):
                break
        iters += 1
        inv = safe_rcp(s.trav_d)
        live = s.mode != MODE_DEAD
        shadowing = (s.mode == MODE_SHADOW_ENV) | (s.mode == MODE_SHADOW_LIGHT)
        # te arrivals; a shadow lane stops at its first hit.  ``stepping``
        # is read before the arrivals (K1 updates ptr in place).
        trav_done = None
        if route == "wide16":
            stepping = live & (s.trav.ptr >= 0)
            s.trav = arrival_steps16_cuda(scene.wide16_nodes, s.trav_o, s.trav_d, inv, s.trav,
                                          te, live, shadowing, has_instances)
        elif route == "wide8":
            stepping = live & (s.trav.ptr >= 0)
            s.trav = tw8.arrival_steps8(scene.wide8_nodes, s.trav_o.T, s.trav_d.T, inv.T,
                                        s.trav, te, live, shadowing, has_instances)
        elif route == "wide":
            stepping = live & (s.trav.ptr < n_nodes)
            base = torch.remainder(tw.octant_index(s.trav_d.T), n_orders) * n_nodes
            trav = s.trav
            for _ in range(te):
                trav = tw.arrival_step(nodes_flat, n_nodes, base, s.trav_o.T, s.trav_d.T, inv.T,
                                       trav, live & ~(shadowing & trav.found), inst_w2l)
            s.trav = trav
            trav_done = trav.ptr >= n_nodes
        else:
            stepping = live & tw2.live2(s.trav)
            oct_ = torch.remainder(tw.octant_index(s.trav_d.T), n_orders)
            base, skip_base = oct_ * n_inner, oct_ * leaf_geo.shape[0]
            trav = s.trav
            for _ in range(te):
                trav = tw2.node_step2(inner_flat, base, s.trav_o.T, s.trav_d.T, inv.T, trav,
                                      live & ~(shadowing & trav.found), inst_w2l)
            trav = tw2.leaf_step2(leaf_geo, skip_flat, skip_base, s.trav_o.T, s.trav_d.T, trav,
                                  live & ~(shadowing & trav.found), inst_w2l)
            s.trav = trav
            trav_done = ~tw2.live2(trav)
        s.arrivals = s.arrivals + te * stepping.sum()
        s.busy = s.busy + live.sum()
        s.ticks = s.ticks + b
        if trav_done is None:
            transition(scene, config, params, s, budget, current_sample)
        else:
            transition(scene, config, params, s, budget, current_sample, trav_done)
        if route == "wide16":
            fresh = ((s.trav.ptr == 0) & (s.trav.pend == tw16.FULL)
                     & (s.trav.sp == 0) & (s.mode != MODE_DEAD))
            s.trav = tw16.prestep16(scene.wide16_nodes, scene.wide16_top, s.trav_o.T,
                                    s.trav_d.T, safe_rcp(s.trav_d).T, s.trav, fresh)

    pix_local = s.pixel - pixel_base
    if record:
        # The records still waiting (film_k_shift > 0) go in behind the
        # cursor; then one stable sort by shard-local pixel, and since every
        # pixel owns exactly spp_l records, a reshape-sum makes the film.
        if config.film_k_shift > 0:
            key = torch.where(s.rec_pending, pix_local, torch.full_like(pix_local, _UNWRITTEN_KEY))
            ks, perm = torch.sort(key, stable=True)
            at = s.rec_cursor + torch.arange(b, device=dev)
            s.rec_keys[at] = ks
            s.rec_rgb[:, at] = s.radiance[:, perm]
        _, order = torch.sort(s.rec_keys, stable=True)
        film = s.rec_rgb[:, order[:budget]].reshape(3, npix_l, spp_l).sum(dim=2).T
    else:
        if config.use_sorted_film and config.film_k_shift > 0:
            # The waiting records, each to its pixel.
            lane = torch.arange(b, device=dev, dtype=torch.int32)
            s.film.index_add_(0, torch.where(s.rec_pending, pix_local, npix_l + lane),
                              s.radiance.T)
        film = s.film[:npix_l]
    occupancy = s.busy.to(torch.float32) / torch.clamp_min(s.ticks.to(torch.float32), 1.0)
    return film, occupancy, s.rays, s.arrivals, iters


def fused_pass_and_accumulate(scene, config: RenderConfig, params: RenderParams,
                              film: ufilm.Film):
    """One progressive pass accumulated into ``film``, seeded from its
    largest sample count (per-pixel counts after a reprojection); returns
    ``(film, occupancy, rays, arrivals, super_iterations)``."""
    total, occ, rays, arr, iters = fused_pass_with_stats(
        scene, config, params, film.sample_count)
    total = total.reshape(config.height, config.width, 3)
    return ufilm.accumulate(film, total, config.samples_per_pass), occ, rays, arr, iters
