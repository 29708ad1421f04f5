"""Megakernel-style batched integrator (``render/integrator.py`` of the
reference).

The reference's correctness integrator and its default: every lane of a
sample steps through the bounce loop together, masked by an ``alive``
predicate (``util/pathtrace.hlsl:10-131``).  ``render_pass`` traces every
pixel of a sample at once (at 1920x1080, 2,073,600 lanes).  Each bounce
traces the closest hit of the live lanes and the shadow rays of the
shaded ones through the intersectors of ``ops.get_intersectors`` (wide16:
kernel K1 on CUDA tensors).  Where ``ops/cuda_shade.py::covers`` holds
(CUDA tables, the HDRI environment, no analytic lights, textures or
normal maps, the NaN canary off) the CUDA kernel ``csrc/shade16.cu``
shades the bounce, in two launches around the shadow rays, on the path
state in place; everywhere else the bounce shades in plain PyTorch, as
the reference shades in XLA, and that plain code is the kernel's twin.
Every lane draws the same uniforms in the same order as the reference's,
so each lane's RNG stream is the reference's.  Lane vectors are (3, B)
planes; the loop test is read on the host once a bounce.  The pass's
layers are marked by ``utils.profiling.span`` ranges (``uwpt.mega.camera``,
``closest``, ``shade``, ``shadow``, ``accumulate``, ``uwpt.sync.alive``),
recorded while a profiler records.
"""

from __future__ import annotations

import dataclasses

import torch

from unity_webgpu_pathtracer_torch.config import (
    ALPHA_MODE_BLEND,
    ALPHA_MODE_MASK,
    SKY_MODE_ENVIRONMENT,
    RenderConfig,
    RenderParams,
)
from unity_webgpu_pathtracer_torch.ops import cuda_shade, get_intersectors, pass_counters
from unity_webgpu_pathtracer_torch.render import bsdf as ubsdf
from unity_webgpu_pathtracer_torch.render import camera as ucamera
from unity_webgpu_pathtracer_torch.render import film as ufilm
from unity_webgpu_pathtracer_torch.render.hitinfo import (
    INTERSECT_LIGHT,
    intersect_analytic_lights,
    shade_prep,
)
from unity_webgpu_pathtracer_torch.render.lights import direct_light
from unity_webgpu_pathtracer_torch.render.sampling import power_heuristic
from unity_webgpu_pathtracer_torch.render.sky import sample_sky_radiance
from unity_webgpu_pathtracer_torch.scene.material import apply_normal_map, derive_material
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.math import EPSILON, luminance, vdot, vneg, vwhere
from unity_webgpu_pathtracer_torch.utils.profiling import span

# Alpha passthrough re-continues a ray without consuming a bounce
# (pathtrace.hlsl:84-89); the loop runs at most max_bounces + 1 + this.
ALPHA_SLACK = 8


@dataclasses.dataclass
class PathState:
    """Per-lane path state shared by the megakernel and wavefront
    integrators; vectors are (3, B) planes."""

    origin: torch.Tensor
    direction: torch.Tensor
    radiance: torch.Tensor
    throughput: torch.Tensor
    rng: torch.Tensor          # (B,) int64 holding uint32
    alive: torch.Tensor        # (B,) bool
    prev_pdf: torch.Tensor
    max_roughness: torch.Tensor
    depth: torch.Tensor        # (B,) int32


def new_path_state(origins: torch.Tensor, directions: torch.Tensor,
                   rng_state: torch.Tensor) -> PathState:
    """Fresh paths along (3, B) ``origins``/``directions``."""
    b = origins.shape[1]
    f32 = dict(dtype=origins.dtype, device=origins.device)
    return PathState(origin=origins, direction=directions,
                     radiance=torch.zeros((3, b), **f32), throughput=torch.ones((3, b), **f32),
                     rng=rng_state, alive=torch.ones((b,), dtype=torch.bool,
                                                     device=origins.device),
                     prev_pdf=torch.zeros((b,), **f32), max_roughness=torch.zeros((b,), **f32),
                     depth=torch.zeros((b,), dtype=torch.int32, device=origins.device))


def _add(m: torch.Tensor, acc: torch.Tensor, term) -> torch.Tensor:
    """``acc + where(m, term, 0)`` on (3, B) planes."""
    return torch.stack([acc[c] + torch.where(m, term[c], torch.zeros_like(acc[c]))
                        for c in range(3)])


def _nee_branches(scene, config: RenderConfig) -> int:
    """Shadow rays a shaded lane fires: the environment's and a light's."""
    return (int(config.sky_mode == SKY_MODE_ENVIRONMENT)
            + int(config.has_lights and scene.lights.shape[0] > 0))


def trace_bounce(scene, config: RenderConfig, params: RenderParams, s: PathState,
                 closest_fn, occluded_fn, with_stats: bool = False,
                 work: cuda_shade.ShadeWork | None = None):
    """One bounce for all lanes (the body of ``pathtrace.hlsl:25-128``).
    Only live lanes are traced (a dead lane's hit is masked everywhere and
    moves no RNG).  With ``with_stats=True`` returns ``(state,
    shade_mask)``, the lanes that ran NEE this bounce (each fires one
    shadow ray per NEE branch).

    Where ``cuda_shade.covers(config, scene)`` the kernel shades the
    bounce into ``work`` (``cuda_shade.new_work``, allocated once by the
    caller and handed to every bounce; ``s`` as ``cuda_shade.check_state``
    holds it); elsewhere the plain code, its twin, does.  On either route
    the returned state is the only valid one: the kernel updates ``s`` in
    place and returns it, the plain code returns a new state, so a caller
    copies what it keeps of ``s`` before the call.  The shade mask is
    valid until the next bounce (the kernel's is ``work.shade``)."""
    if cuda_shade.covers(config, scene):
        return _trace_bounce_kernel(scene, config, params, s, closest_fn, occluded_fn,
                                    with_stats, work)
    return _trace_bounce_plain(scene, config, params, s, closest_fn, occluded_fn, with_stats)


def _trace_bounce_plain(scene, config: RenderConfig, params: RenderParams, s: PathState,
                        closest_fn, occluded_fn, with_stats: bool):
    """``trace_bounce`` in plain PyTorch: the reference's bounce, and the
    shading kernel's twin."""
    alive = s.alive
    d, tp = s.direction, s.throughput
    zero = torch.zeros_like(s.prev_pdf)

    with span("mega.closest"):
        t, bary, slot, inst = closest_fn(scene, s.origin.T, d.T, alive)
    with span("mega.shade"):
        hit = shade_prep(scene, s.origin, d, t, bary, slot, inst)
        if config.has_lights:
            hit = intersect_analytic_lights(scene, s.origin, d, hit)

        # --- Miss: sky radiance with MIS against the previous bounce's pdf.
        sky_color, sky_pdf = sample_sky_radiance(config, params, d.T, s.depth, scene.env)
        sky_color = sky_color.T
        mis = torch.where(s.depth > 0, power_heuristic(s.prev_pdf, sky_pdf), torch.ones_like(zero))
        miss = alive & ~hit.valid
        radiance = _add(miss & (mis > 0.0), s.radiance,
                        tuple(mis * sky_color[c] * tp[c] for c in range(3)))
        alive = alive & hit.valid

        # --- Analytic light hit: add emission, terminate (pathtrace.hlsl:42-47).
        if config.has_lights and scene.lights.shape[0] > 0:
            light_hit = alive & (hit.intersect_type == INTERSECT_LIGHT)
            l_em = scene.lights[torch.clamp_min(hit.light_index, 0).long(), 4:7].T
            radiance = _add(light_hit, radiance, tuple(l_em[c] * tp[c] for c in range(3)))
            alive = alive & ~light_hit

        # --- Material fetch + roughness regularisation (pathtrace.hlsl:63-68).
        md = scene.materials[torch.clamp_min(hit.material, 0).long()].T    # (32, B)
        if config.has_normal_maps:
            nm = apply_normal_map(md, hit.uv, hit.normal, hit.tangent, scene.texture_data,
                                  config.has_textures)
            hit = hit._replace(normal=nm, ffnormal=vwhere(vdot(nm, d) <= 0.0, nm, vneg(nm)))
        mat = derive_material(md, d, hit.normal, hit.uv, scene.texture_data, config.has_textures)
        max_roughness = torch.where(alive, torch.maximum(s.max_roughness, mat.roughness),
                                    s.max_roughness)
        mat = ubsdf.with_roughness(mat, max_roughness)

        # --- Mesh emission (not importance sampled, pathtrace.hlsl:78).
        radiance = _add(alive, radiance, tuple(mat.emission[c] * tp[c] for c in range(3)))

        # --- Bounce budget (pathtrace.hlsl:80-81).
        alive = alive & (s.depth < config.max_bounces)

        # --- Alpha passthrough (pathtrace.hlsl:84-89): every lane draws.
        u_alpha, rng = urng.random_float(s.rng)
        passthrough = alive & (
            ((mat.alpha_mode == ALPHA_MODE_MASK) & (mat.opacity < mat.alpha_cutoff))
            | ((mat.alpha_mode == ALPHA_MODE_BLEND) & (u_alpha > mat.opacity)))
        shade = alive & ~passthrough

        # --- NEE (pathtrace.hlsl:93).
        ld, rng = direct_light(scene, config, params, hit, mat, d, rng, occluded_fn, live=shade)
        radiance = _add(shade, radiance, tuple(ld[c] * tp[c] for c in range(3)))

        # --- BSDF sample (pathtrace.hlsl:98-113).
        f, l, pdf, rng = ubsdf.sample_brdf(mat, vneg(d), hit.ffnormal, rng)
        nan_lane = torch.isnan(f[0]) | torch.isnan(f[1]) | torch.isnan(f[2]) | torch.isnan(pdf)
        dead_sample = shade & (nan_lane | (pdf <= 0.0))
        if config.debug_nan_canary:
            # The NaN-BSDF canary (pathtrace.hlsl:100-104): pure green.
            green = torch.tensor([0.0, 1.0, 0.0], device=zero.device)[:, None]
            radiance = torch.where(shade & nan_lane, green, radiance)
        den = torch.clamp_min(pdf, 1e-20)
        throughput = torch.where(shade & ~dead_sample,
                                 torch.stack([tp[c] * f[c] / den for c in range(3)]), tp)
        alive = alive & ~dead_sample

        # --- Continue the ray (pathtrace.hlsl:116-118); passthrough keeps its
        # direction.
        new_dir = vwhere(passthrough, d, l)
        new_origin = torch.stack([hit.position[c] + new_dir[c] * EPSILON for c in range(3)])
        origin = torch.where(alive, new_origin, s.origin)
        direction = torch.where(alive, torch.stack(new_dir), d)
        depth = torch.where(alive, torch.where(passthrough, s.depth, s.depth + 1), s.depth)
        prev_pdf = torch.where(shade, pdf, s.prev_pdf)

        # --- Russian roulette (pathtrace.hlsl:121-127).
        if config.use_russian_roulette:
            u_rr, rng = urng.random_float(rng)
            p_cont = torch.clamp_max(
                torch.maximum(torch.maximum(throughput[0], throughput[1]), throughput[2]) + 0.001,
                0.95)
            killed = alive & ~passthrough & (u_rr >= p_cont)
            throughput = torch.where(alive & ~passthrough & ~killed, throughput / p_cont,
                                     throughput)
            alive = alive & ~killed

    out = PathState(origin=origin, direction=direction, radiance=radiance,
                    throughput=throughput, rng=rng, alive=alive, prev_pdf=prev_pdf,
                    max_roughness=max_roughness, depth=depth)
    if with_stats:
        return out, shade
    return out


def _trace_bounce_kernel(scene, config: RenderConfig, params: RenderParams, s: PathState,
                         closest_fn, occluded_fn, with_stats: bool,
                         work: cuda_shade.ShadeWork | None):
    """``trace_bounce`` on the kernel's route: the closest hit, the kernel's
    first launch, the shadow rays it wrote, its second launch."""
    with span("mega.closest"):
        hit = closest_fn(scene, s.origin.T, s.direction.T, s.alive)
    with span("mega.shade"):
        cuda_shade.shade16_cuda(scene, config, params, s, hit, work)
        with span("mega.shadow"):
            shadowed = occluded_fn(scene, work.shadow_o, work.shadow_d, work.far, work.shade)
        cuda_shade.nee16_cuda(s, work, shadowed)
    if with_stats:
        return s, work.shade
    return s


def path_trace(scene, config: RenderConfig, params: RenderParams, origins: torch.Tensor,
               directions: torch.Tensor, rng_state: torch.Tensor, stats: dict | None = None):
    """Trace (3, B) rays to completion: ``(radiance (3, B), rng)``.  The
    loop ends when no lane is alive (one host read a bounce) or after
    ``max_bounces + 1 + ALPHA_SLACK`` bounces.  ``stats`` (a dict, or
    None) gathers ``closest`` and ``shadow`` rays (device scalars: per-lane
    counts, one add a bounce each, summed once at the end; no host read),
    ``bounces`` and ``alive_tests`` (the host reads of the loop test).  On the
    shading kernel's route the state's planes are contiguous copies of the
    inputs, updated in place over the bounces, and the kernel's work planes
    are allocated here, once."""
    closest_fn, occluded_fn = get_intersectors(config)
    work = None
    if cuda_shade.covers(config, scene):
        origins, directions, rng_state = (x.clone(memory_format=torch.contiguous_format)
                                          for x in (origins, directions, rng_state))
        work = cuda_shade.new_work(origins.shape[1], origins.device)
    s = new_path_state(origins, directions, rng_state)
    n_iter = config.max_bounces + 1 + ALPHA_SLACK
    if stats is not None:
        # Bounces each lane was traced in (row 0) and shaded in (row 1).
        lanes = torch.zeros((2, origins.shape[1]), device=origins.device,
                            dtype=torch.uint8 if n_iter < 256 else torch.int32)
    for _ in range(n_iter):
        if stats is not None:
            stats["alive_tests"] = stats.get("alive_tests", 0) + 1
        with span("sync.alive"):
            if not bool(s.alive.any()):
                break
        if stats is None:
            s = trace_bounce(scene, config, params, s, closest_fn, occluded_fn, work=work)
            continue
        lanes[0] += s.alive
        s, shade = trace_bounce(scene, config, params, s, closest_fn, occluded_fn,
                                with_stats=True, work=work)
        lanes[1] += shade
        stats["bounces"] = stats.get("bounces", 0) + 1
    if stats is not None:
        closest, shaded = lanes.sum(dim=1)
        stats["closest"] = stats.get("closest", 0) + closest
        stats["shadow"] = stats.get("shadow", 0) + shaded * _nee_branches(scene, config)
    return s.radiance, s.rng


def firefly_clamp(radiance: torch.Tensor, params: RenderParams) -> torch.Tensor:
    """Scale (3, B) radiance down to ``max_firefly_luminance``
    (``PathTracer.compute:79-84``)."""
    lum = luminance(radiance.T)
    scale = torch.where(lum > params.max_firefly_luminance,
                        params.max_firefly_luminance / torch.clamp_min(lum, 1e-20),
                        torch.ones_like(lum))
    return radiance * scale


def check_tables(scene) -> None:
    if scene.attr_normals.shape[0] == 0:
        raise ValueError("the megakernel and wavefront integrators read the f32 triangle "
                         "tables (tris, tri_index, attr_normals, attr_uvs, attr_material), and "
                         "this SceneData has none (build it with Scene.build)")


def render_pass(scene, config: RenderConfig, params: RenderParams, current_sample: int,
                pixel_indices: torch.Tensor | None = None, stats: dict | None = None):
    """One progressive pass: ``samples_per_pass`` samples of every pixel
    (``PathTracer.compute:54-98``): seeds per (pixel, current_sample),
    Gaussian AA jitter, the optional firefly clamp.  Returns the radiance
    *sum* over the pass (B, 3); ``stats`` as in ``path_trace``."""
    check_tables(scene)
    dev = scene.attr_normals.device
    if pixel_indices is None:
        pixel_indices = torch.arange(config.pixel_count(), dtype=torch.int64, device=dev)
    state = urng.seed(pixel_indices, current_sample, params.seed_root)
    total = torch.zeros((3, pixel_indices.shape[0]), dtype=torch.float32, device=dev)
    for _ in range(config.samples_per_pass):
        with span("mega.camera"):
            coords, state = ucamera.jittered_pixel_coords(pixel_indices, config, state)
            o, d, state = ucamera.get_screen_ray(coords, config, params, state)
        radiance, state = path_trace(scene, config, params, o.T.contiguous(),
                                     d.T.contiguous(), state, stats)
        with span("mega.accumulate"):
            if config.use_firefly_filter:
                radiance = firefly_clamp(radiance, params)
            total = total + radiance
    return total.T


def megakernel_pass_and_accumulate(scene, config: RenderConfig, params: RenderParams,
                                   film: ufilm.Film, stats: dict) -> ufilm.Film:
    """One pass of ``render_pass`` accumulated into ``film``, seeded from
    its largest sample count (per-pixel counts after a reprojection).
    ``stats`` (an empty dict) gathers ``render_pass``'s counters, and K1's
    launches (``k1_launches``), the shading kernel's (``shade_launches``:
    two a bounce on its route, 0 on the plain one) and the host reads
    (``host_reads``: the traversal loops' tests and the bounces'
    ``alive_tests``)."""
    k1_before, reads_before, shade_before = pass_counters()
    total = render_pass(scene, config, params, film.sample_count, stats=stats)
    with span("mega.accumulate"):
        film = ufilm.accumulate(film, total.reshape(config.height, config.width, 3),
                                config.samples_per_pass)
    k1, reads, shade = pass_counters()
    stats["k1_launches"] = k1 - k1_before
    stats["shade_launches"] = shade - shade_before
    stats["host_reads"] = reads - reads_before + stats["alive_tests"]
    return film
