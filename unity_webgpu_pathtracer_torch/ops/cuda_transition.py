"""Fused-integrator transition: the CUDA kernel ``csrc/transition16.cu``
and its plain version.

``transition16_cuda(scene, config, params, st)`` runs one transition of
the HDRI kernel route on the pass's lane state ``st`` (a
``TransitionState``: the ``FusedState`` fields the transition reads and
writes, vectors as (3, B) planes), in place: the environment sample, the
attribute and material fetch and the shade / env-NEE / BSDF / Russian-
roulette step of the reference's ``render/fused.py::_transition_pallas``
up to, not including, its record append and regeneration.  It returns the
per-call outputs ``(died, rad_out)``; ``rad_out`` holds the radiance of the
lanes that died (other lanes' columns are undefined: the record append
never reads them).  Lanes that are neither at a finished primary segment
nor at a finished shadow segment change only their RNG state; the ray
starts are added to ``st.rays``.  Mode machine: PRIMARY -> SHADOW_ENV ->
PRIMARY or DEAD.

CUDA tensors launch one kernel, by attribute rows: ``transition16`` for
the f16 rows of ``attr_compact=2`` (``attr_in_kernel`` either way: the
port decodes in the kernel, which gives the bits a decode in PyTorch
gives), ``transition16_oct`` for the oct rows of ``attr_compact=3``;
launches are counted in ``transition16_cuda.launches[name]``.  CPU tensors
run the plain version ``transition16_plain``: the port's
``scene/envmap.py::sample_env_transition``, the attribute and material
gathers and ``transition_step16_plain`` (the per-lane body on pre-gathered
planes, a transcription of the reference kernel held against
``transition_step16_pallas``), composed in that order, with the same
in-place contract.  Every lane draws the same uniforms in the same order
(2 env + 1 alpha + 3 BSDF + 1 RR), so the RNG stream is the reference's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from unity_webgpu_pathtracer_torch.ops import cuda_build
from unity_webgpu_pathtracer_torch.render import bsdf
from unity_webgpu_pathtracer_torch.render.sampling import power_heuristic
from unity_webgpu_pathtracer_torch.scene.material import derive_material
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.math import (
    EPSILON,
    FAR_PLANE,
    build_onb,
    normalize,
    to_local,
    vluminance,
    vneg,
    vnormalize,
    vscale,
    vwhere,
)

# Lane modes: the one definition in the port (the kernel receives them as
# -D macros from ops/cuda_build.py).
MODE_PRIMARY = 0
MODE_SHADOW_ENV = 1
MODE_SHADOW_LIGHT = 2   # the general transition's light NEE; K2 never sees it
MODE_DEAD = 3

FULL16 = 0xFFFF


class TransitionOut(NamedTuple):
    """The outputs of ``transition_step16_plain``, the reference kernel's
    ``TransitionOut``."""

    mode: torch.Tensor
    ptr: torch.Tensor
    pend: torch.Tensor
    sp: torch.Tensor
    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor
    found: torch.Tensor        # bool
    trav_oT: torch.Tensor      # (3, B)
    trav_dT: torch.Tensor
    path_oT: torch.Tensor
    path_dT: torch.Tensor
    hit_t: torch.Tensor
    hit_baryT: torch.Tensor    # (2, B)
    hit_tri: torch.Tensor
    pendingT: torch.Tensor
    throughputT: torch.Tensor
    radianceT: torch.Tensor
    rad_outT: torch.Tensor
    rng: torch.Tensor          # int64 holding uint32
    depth: torch.Tensor
    max_rough: torch.Tensor
    prev_pdf: torch.Tensor
    lane_cap: torch.Tensor
    died: torch.Tensor         # bool
    nray: torch.Tensor         # int32 ray starts (bounce + shadow)


# Inputs of transition_step16_plain: (name, dtype, rows) with rows 0 = (B,).
_INPUTS = (
    ("mode", torch.int32, 0), ("trav_done", torch.bool, 0),
    ("ptr", torch.int32, 0), ("pend", torch.int32, 0), ("sp", torch.int32, 0),
    ("t", torch.float32, 0), ("u", torch.float32, 0), ("v", torch.float32, 0),
    ("tri", torch.int32, 0), ("found", torch.bool, 0),
    ("trav_oT", torch.float32, 3), ("trav_dT", torch.float32, 3),
    ("path_oT", torch.float32, 3), ("path_dT", torch.float32, 3),
    ("hit_t", torch.float32, 0), ("hit_baryT", torch.float32, 2),
    ("hit_tri", torch.int32, 0),
    ("pendingT", torch.float32, 3), ("throughputT", torch.float32, 3),
    ("radianceT", torch.float32, 3),
    ("rng", torch.int64, 0), ("depth", torch.int32, 0),
    ("max_rough", torch.float32, 0), ("prev_pdf", torch.float32, 0),
    ("lane_cap", torch.int32, 0), ("mdataT", torch.float32, 22),
    ("sky_colT", torch.float32, 3), ("sky_pdf", torch.float32, 0),
    ("env_dirT", torch.float32, 3), ("env_liT", torch.float32, 3),
    ("env_pdf", torch.float32, 0),
)


class TransitionState(NamedTuple):
    """The ``FusedState`` tensors a transition reads and updates in place
    (``render/fused.py::transition_state``), in the kernel struct's order;
    vectors as (3, B) planes."""

    mode: torch.Tensor
    ptr: torch.Tensor
    pend: torch.Tensor
    sp: torch.Tensor
    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor
    found: torch.Tensor        # bool
    trav_o: torch.Tensor       # (3, B)
    trav_d: torch.Tensor
    path_o: torch.Tensor
    path_d: torch.Tensor
    hit_t: torch.Tensor
    hit_bary: torch.Tensor     # (2, B)
    hit_tri: torch.Tensor
    pending: torch.Tensor
    throughput: torch.Tensor
    radiance: torch.Tensor
    rng: torch.Tensor          # int64 holding uint32
    depth: torch.Tensor
    max_rough: torch.Tensor
    prev_pdf: torch.Tensor
    lane_cap: torch.Tensor
    rays: torch.Tensor         # () int64 ray starts of the pass


# dtype and rows of each state field (0: (B,); None: a () counter).
_STATE = dict(
    mode=(torch.int32, 0), ptr=(torch.int32, 0), pend=(torch.int32, 0), sp=(torch.int32, 0),
    t=(torch.float32, 0), u=(torch.float32, 0), v=(torch.float32, 0), tri=(torch.int32, 0),
    found=(torch.bool, 0), trav_o=(torch.float32, 3), trav_d=(torch.float32, 3),
    path_o=(torch.float32, 3), path_d=(torch.float32, 3), hit_t=(torch.float32, 0),
    hit_bary=(torch.float32, 2), hit_tri=(torch.int32, 0), pending=(torch.float32, 3),
    throughput=(torch.float32, 3), radiance=(torch.float32, 3), rng=(torch.int64, 0),
    depth=(torch.int32, 0), max_rough=(torch.float32, 0), prev_pdf=(torch.float32, 0),
    lane_cap=(torch.int32, 0), rays=(torch.int64, None))
_TABLES = ("env_rows", "attr_rows", "materials")
_SCALARS = ("cdf_sum", "rotation", "intensity", "firefly_max")


class _TransitionArgs(ctypes.Structure):
    """Mirror of ``TransitionArgs`` in ``csrc/transition16.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in TransitionState._fields]
                + [(n, ctypes.c_void_p) for n in ("died", "rad_out", *_TABLES, *_SCALARS)]
                + [(n, ctypes.c_int) for n in ("b", "env_w", "env_h", "use_rr", "max_bounces",
                                               "firefly", "nan_canary")])


# Kernel name by attr_compact; its C entry is name + "_launch".
KERNELS = {2: "transition16", 3: "transition16_oct"}
# Threads per block (UWPT_K2_THREADS in csrc/transition16.cu; nvcc picks
# the registers).  experiments/k2_variants.py builds and times other values.
K2_THREADS = 128


def f16_decode(h: torch.Tensor) -> torch.Tensor:
    """f16 halfwords (integer tensor, values 0..65535) -> float32 in
    integer steps, the reference's ``ops/pallas_transition.py::_f16_decode``:
    exact for every pattern, NaN payloads included."""
    h = h.to(torch.int64)
    s, e, m = (h >> 15) & 1, (h >> 10) & 0x1F, h & 0x3FF
    bits = torch.where(e == 31, (s << 31) | (0xFF << 23) | (m << 13),
                       (s << 31) | ((e + 112) << 23) | (m << 13))
    # int64 -> int32 keeps the low 32 bits (two's complement).
    v = bits.to(torch.int32).view(torch.float32)
    m_f = m.to(torch.float32) * 2.0 ** -24                      # exact
    return torch.where(e == 0, torch.where(s != 0, -m_f, m_f), v)


def oct_decode(u: torch.Tensor) -> torch.Tensor:
    """16-bit octahedral words (int32 view of uint32, (B,)) -> unnormalized
    (B, 3) vectors (the reference's ``render/fused.py::_oct_decode``)."""
    k = torch.tensor(2.0 / 65535.0, dtype=torch.float32)   # f32, as the reference's
    x = (u & 0xFFFF).to(torch.float32) * k - 1.0
    y = ((u >> 16) & 0xFFFF).to(torch.float32) * k - 1.0
    z = 1.0 - torch.abs(x) - torch.abs(y)
    t_f = torch.clamp_min(-z, 0.0)
    x = x - torch.where(x >= 0, t_f, -t_f)
    y = y - torch.where(y >= 0, t_f, -t_f)
    return torch.stack([x, y, z], dim=-1)


def attr_index(a: torch.Tensor, need: torch.Tensor, tri: torch.Tensor,
               hit_tri: torch.Tensor) -> torch.Tensor:
    """The attribute row of each lane's hit, (B,) int64: the fresh hit
    ``tri`` where the primary segment just ended (``a``), the saved
    ``hit_tri`` elsewhere; lanes outside ``need`` (those that consume no
    attributes this transition) read row 0."""
    sel_tri = torch.where(a, tri, hit_tri)
    return torch.where(need, torch.clamp_min(sel_tri, 0), torch.zeros_like(sel_tri)).long()


def shade_rows(scene, attr_compact: int, attr: torch.Tensor):
    """Rows ``attr`` of the attribute table of ``attr_compact`` as (15, B)
    f32 planes (3 vertex normals, 3 uvs; mode 3 stores no uv, so those
    planes are 0 there, and its oct normals are normalized per vertex as in
    the reference) and their u16 material index."""
    if attr_compact == 3:
        rows = scene.attr_shade_o[attr]                          # (B, 4) int32
        normals = [normalize(oct_decode(rows[:, v])) for v in range(3)]
        zeros = torch.zeros((attr.shape[0], 6), dtype=torch.float32, device=attr.device)
        return torch.cat(normals + [zeros], dim=1).T.contiguous(), rows[:, 3]
    rows = scene.attr_shade_c[attr]                              # (B, 8) int32
    shade_rowT = rows.view(torch.float16)[:, 0:15].to(torch.float32).T.contiguous()
    return shade_rowT, (rows[:, 7] >> 16) & 0xFFFF


# ---------------------------------------------------------------------------
# The per-lane body on pre-gathered (B,) planes, vectors as 3-tuples of
# planes, a transcription of the reference kernel; the shading math is the
# port's shared BSDF (render/bsdf.py, render/sampling.py,
# scene/material.py).
# ---------------------------------------------------------------------------

def transition_step16_plain(*, mode, trav_done, ptr, pend, sp, t, u, v, tri, found,
                            trav_oT, trav_dT, path_oT, path_dT,
                            hit_t, hit_baryT, hit_tri,
                            pendingT, throughputT, radianceT,
                            rng, depth, max_rough, prev_pdf, lane_cap, mdataT,
                            sky_colT, sky_pdf, env_dirT, env_liT, env_pdf,
                            use_rr: bool, max_bounces: int,
                            shade_rowT=None, attr_table=None, attr=None,
                            firefly: bool = False, firefly_max=None,
                            nan_canary: bool = False) -> TransitionOut:
    """The reference transition kernel's body in plain PyTorch, on the
    inputs ``transition_step16_pallas`` takes: the attribute row comes as
    ``shade_rowT`` (15 decoded planes) or as ``attr_table`` and ``attr``,
    whose lane rows are gathered and decoded here."""
    if (attr_table is None) == (shade_rowT is None) or (attr_table is None) != (attr is None):
        raise ValueError("pass exactly one attribute form: shade_rowT, or attr_table "
                         "with attr")
    _w = torch.where

    def p3(x):
        return (x[0], x[1], x[2])

    t_in, u_in, v_in, tri_in = t, u, v, tri
    path_o, path_d = p3(path_oT), p3(path_dT)
    pending, throughput, radiance = p3(pendingT), p3(throughputT), p3(radianceT)
    zero = torch.zeros_like(t_in)
    z3 = (zero, zero, zero)

    shadow_done = trav_done | found
    a = (mode == MODE_PRIMARY) & trav_done
    hit_valid = tri_in >= 0

    # --- miss -> sky with MIS (env sample gathered outside) ---
    sky_col = p3(sky_colT)
    mis = _w(depth > 0, power_heuristic(prev_pdf, sky_pdf), torch.ones_like(zero))
    miss = a & ~hit_valid
    g_miss = miss & (mis > 0)
    radiance = tuple(radiance[c] + _w(g_miss, mis * sky_col[c] * throughput[c], zero)
                     for c in range(3))

    shade = a & hit_valid

    # --- hit frame: normal interpolated from the gathered attr row ---
    hit_bary = (hit_baryT[0], hit_baryT[1])
    b0 = _w(a, u_in, hit_bary[0])
    b1 = _w(a, v_in, hit_bary[1])
    sel_t = _w(a, t_in, hit_t)
    if attr_table is not None:
        words = attr_table[attr.long()]                          # (B, 8) int32
        sr = [f16_decode((words[:, k // 2] >> (16 * (k % 2))) & 0xFFFF) for k in range(9)]
    else:
        sr = [shade_rowT[k] for k in range(9)]
    w0 = 1.0 - b0 - b1
    normal = vnormalize((sr[0] * w0 + sr[3] * b0 + sr[6] * b1,
                         sr[1] * w0 + sr[4] * b0 + sr[7] * b1,
                         sr[2] * w0 + sr[5] * b0 + sr[8] * b1))

    # --- material derivation (material.hlsl:84-137, untextured) ---
    mat = derive_material(mdataT, path_d, normal)
    max_rough_o = _w(shade, torch.maximum(max_rough, mat.roughness), max_rough)
    mat = bsdf.with_roughness(mat, max_rough_o)
    nd = normal[0] * path_d[0] + normal[1] * path_d[1] + normal[2] * path_d[2]
    ffnormal = vwhere(nd <= 0.0, normal, vneg(normal))
    position = tuple(path_o[c] + sel_t * path_d[c] for c in range(3))
    scatter_pos = tuple(position[c] + normal[c] * EPSILON for c in range(3))

    radiance = tuple(radiance[c] + _w(shade, mat.emission[c] * throughput[c], zero)
                     for c in range(3))
    over_budget = depth >= max_bounces
    ended_budget = shade & over_budget
    shade = shade & ~over_budget

    # --- alpha passthrough (pathtrace.hlsl:84-89) ---
    u_alpha, rng = urng.random_float(rng)
    passthrough = shade & (((mat.alpha_mode == 2) & (mat.opacity < mat.alpha_cutoff))
                           | ((mat.alpha_mode == 1) & (u_alpha > mat.opacity)))
    shade = shade & ~passthrough

    # --- shadow traversal finished -> apply the pending contribution ---
    env_done = (mode == MODE_SHADOW_ENV) & shadow_done
    g_app = env_done & ~found
    radiance = tuple(radiance[c] + _w(g_app, pending[c] * throughput[c], zero)
                     for c in range(3))
    to_env = shade
    to_bsdf = env_done

    onb = build_onb(ffnormal)
    v_local = to_local(onb, vneg(path_d))
    probs = bsdf.lobe_probabilities(mat, v_local)

    # --- env NEE evaluation (light.hlsl:125-158) ---
    env_dir, env_li = p3(env_dirT), p3(env_liT)
    f_u, bpdf_u = bsdf.eval_brdf_local(mat, v_local, to_local(onb, env_dir), probs)
    mis_e = power_heuristic(env_pdf, bpdf_u)
    epdf_den = torch.clamp_min(env_pdf, 1e-20)
    contrib = tuple(mis_e * env_li[c] * f_u[c] / epdf_den for c in range(3))
    ok = (bpdf_u > 0) & (env_pdf > 0) & (mis_e > 0)
    pending = vwhere(to_env, vwhere(ok, contrib, z3), pending)

    # Fresh shadow segment at the root for to_env lanes.
    trav_o = vwhere(to_env, scatter_pos, p3(trav_oT))
    trav_d = vwhere(to_env, env_dir, p3(trav_dT))
    izero = torch.zeros_like(ptr)
    ptr_o = _w(to_env, izero, ptr)
    pend_o = _w(to_env, torch.full_like(pend, FULL16), pend)
    sp_o = _w(to_env, izero, sp)
    far = torch.full_like(t_in, FAR_PLANE)
    t_out = _w(to_env, far, t_in)
    u_out = _w(to_env, zero, u_in)
    v_out = _w(to_env, zero, v_in)
    minus1 = torch.full_like(tri_in, -1)
    tri_out = _w(to_env, minus1, tri_in)
    found_out = found & ~to_env
    new_mode = _w(to_env, torch.full_like(mode, MODE_SHADOW_ENV), mode)

    # --- BSDF sample + Russian roulette -> next bounce or death ---
    f_s, l_s, pdf_s, rng = bsdf.sample_brdf_local(mat, onb, v_local, probs, rng)
    nan_lane = ((f_s[0] != f_s[0]) | (f_s[1] != f_s[1])
                | (f_s[2] != f_s[2]) | (pdf_s != pdf_s))
    sample_ok = to_bsdf & ~nan_lane & (pdf_s > 0.0)
    pdf_den = torch.clamp_min(pdf_s, 1e-20)
    throughput = vwhere(sample_ok, tuple(throughput[c] * f_s[c] / pdf_den
                                         for c in range(3)), throughput)
    continue_ray = sample_ok
    if use_rr:
        u_rr, rng = urng.random_float(rng)
        t_max3 = torch.maximum(torch.maximum(throughput[0], throughput[1]), throughput[2])
        p_cont = torch.clamp_max(t_max3 + 0.001, 0.95)
        rr_kill = continue_ray & (u_rr >= p_cont)
        keep = continue_ray & ~rr_kill
        throughput = vwhere(keep, tuple(throughput[c] / p_cont for c in range(3)),
                            throughput)
        continue_ray = continue_ray & ~rr_kill

    processed = a | env_done
    cap_exhausted = processed & (lane_cap <= 0)
    died = miss | ended_budget | (to_bsdf & ~continue_ray) | cap_exhausted

    rad_out = radiance
    if firefly:
        lum = vluminance(rad_out)
        ffly = firefly_max.reshape(())
        scale = _w(lum > ffly, ffly / torch.clamp_min(lum, 1e-20), torch.ones_like(lum))
        rad_out = vscale(rad_out, scale)
    if nan_canary:
        g_nan = to_bsdf & nan_lane
        rad_out = (_w(g_nan, zero, rad_out[0]), _w(g_nan, torch.ones_like(zero), rad_out[1]),
                   _w(g_nan, zero, rad_out[2]))

    # --- continuing bounce: new primary ray ---
    new_dir = vwhere(passthrough, path_d, l_s)
    bounce = (continue_ray | passthrough) & ~died
    new_origin = tuple(position[c] + new_dir[c] * EPSILON for c in range(3))
    path_o = vwhere(bounce, new_origin, path_o)
    path_d = vwhere(bounce, new_dir, path_d)
    trav_o = vwhere(bounce, path_o, trav_o)
    trav_d = vwhere(bounce, path_d, trav_d)
    ptr_o = _w(bounce, izero, ptr_o)
    pend_o = _w(bounce, torch.full_like(pend, FULL16), pend_o)
    sp_o = _w(bounce, izero, sp_o)
    t_out = _w(bounce, far, t_out)
    u_out = _w(bounce, zero, u_out)
    v_out = _w(bounce, zero, v_out)
    tri_out = _w(bounce, minus1, tri_out)
    found_out = found_out & ~bounce
    new_mode = _w(bounce, torch.full_like(mode, MODE_PRIMARY),
                  _w(died, torch.full_like(mode, MODE_DEAD), new_mode))
    depth_o = _w(continue_ray, depth + 1, depth)
    prev_pdf_o = _w(to_bsdf, pdf_s, prev_pdf)

    saved = shade | passthrough
    return TransitionOut(
        mode=new_mode, ptr=ptr_o, pend=pend_o, sp=sp_o,
        t=t_out, u=u_out, v=v_out, tri=tri_out, found=found_out,
        trav_oT=torch.stack(trav_o), trav_dT=torch.stack(trav_d),
        path_oT=torch.stack(path_o), path_dT=torch.stack(path_d),
        hit_t=_w(saved, t_in, hit_t),
        hit_baryT=torch.stack([_w(saved, u_in, hit_bary[0]), _w(saved, v_in, hit_bary[1])]),
        hit_tri=_w(saved, tri_in, hit_tri),
        pendingT=torch.stack(pending), throughputT=torch.stack(throughput),
        radianceT=torch.stack(radiance), rad_outT=torch.stack(rad_out),
        rng=rng, depth=depth_o, max_rough=max_rough_o, prev_pdf=prev_pdf_o,
        lane_cap=_w(processed, lane_cap - 1, lane_cap),
        died=died, nray=bounce.to(torch.int32) + to_env.to(torch.int32),
    )


def transition16_plain(scene, config, params, st: TransitionState):
    """The plain version of ``transition16_cuda``, on either device: the
    env sample, the attribute and material gathers and
    ``transition_step16_plain``, then the in-place update (lanes that
    process nothing keep every field but ``rng``)."""
    from unity_webgpu_pathtracer_torch.scene.envmap import sample_env_transition

    trav_done = st.ptr < 0
    a = (st.mode == MODE_PRIMARY) & trav_done
    hit_valid = st.tri >= 0
    sky_raw, sky_pdf, env_dir, env_col, env_pdf, rng = sample_env_transition(
        scene.env, params.environment_rotation, st.path_d.T, a & hit_valid, st.rng, need=a)
    intensity = torch.where(st.depth > 0, params.environment_intensity,
                            torch.ones_like(sky_pdf))
    env_done = (st.mode == MODE_SHADOW_ENV) & (trav_done | st.found)
    shade_rowT, mat_idx = shade_rows(
        scene, config.attr_compact, attr_index(a, (a & hit_valid) | env_done, st.tri, st.hit_tri))
    k = transition_step16_plain(
        mode=st.mode, trav_done=trav_done, ptr=st.ptr, pend=st.pend, sp=st.sp, t=st.t,
        u=st.u, v=st.v, tri=st.tri, found=st.found, trav_oT=st.trav_o, trav_dT=st.trav_d,
        path_oT=st.path_o, path_dT=st.path_d, hit_t=st.hit_t, hit_baryT=st.hit_bary,
        hit_tri=st.hit_tri, pendingT=st.pending, throughputT=st.throughput,
        radianceT=st.radiance, rng=rng, depth=st.depth, max_rough=st.max_rough,
        prev_pdf=st.prev_pdf, lane_cap=st.lane_cap,
        mdataT=scene.materials[mat_idx.long(), 0:22].T, shade_rowT=shade_rowT,
        sky_colT=(sky_raw * intensity[:, None]).T, sky_pdf=sky_pdf, env_dirT=env_dir.T,
        env_liT=(env_col * params.environment_intensity).T, env_pdf=env_pdf,
        use_rr=config.use_russian_roulette, max_bounces=config.max_bounces,
        firefly=config.use_firefly_filter, firefly_max=params.max_firefly_luminance,
        nan_canary=config.debug_nan_canary)
    processed = a | env_done
    out = {name.rstrip("T"): x for name, x in k._asdict().items()}   # trav_oT -> trav_o
    for name in TransitionState._fields:
        dst = getattr(st, name)
        if name == "rng":
            dst.copy_(k.rng)
        elif name == "rays":
            dst.add_(k.nray.sum())
        else:
            dst.copy_(torch.where(processed, out[name], dst))
    return k.died, torch.where(k.died, k.rad_outT, torch.zeros_like(k.rad_outT))


def _scene_inputs(scene, config, params) -> dict:
    """The tables and device scalars the kernel reads."""
    return dict(env_rows=scene.env.merged_rows,
                attr_rows=scene.attr_shade_o if config.attr_compact == 3 else scene.attr_shade_c,
                materials=scene.materials, cdf_sum=scene.env.cdf_sum,
                rotation=params.environment_rotation, intensity=params.environment_intensity,
                firefly_max=params.max_firefly_luminance)


def _check(ins: dict, st: TransitionState, attr_compact: int, env_hw) -> None:
    """The kernel's contract, on either device: the state's fields of
    their dtypes and shapes, contiguous, each with a storage of its own
    that no table shares; the tables 16-byte aligned (rows are loaded as
    16-byte vectors); the scalars one float32 each."""
    dev = st.mode.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    b = st.mode.shape[0]
    for name, (dtype, rows) in _STATE.items():
        shape = () if rows is None else (b,) if rows == 0 else (rows, b)
        cuda_build.check_tensor(getattr(st, name), name, dtype, shape, dev)
    width = 4 if attr_compact == 3 else 8
    h, w = env_hw
    for name, (dtype, cols) in dict(env_rows=(torch.float32, 20),
                                    attr_rows=(torch.int32, width),
                                    materials=(torch.float32, 32)).items():
        x = ins[name]
        cuda_build.check_tensor(x, name, dtype, (x.shape[0], cols), dev)
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel loads rows as 16-byte vectors; pass a "
                             "16-byte-aligned table")
    if ins["env_rows"].shape[0] != h * w:
        raise ValueError(f"env_rows: expected the {h}x{w} environment's {h * w} merged rows, "
                         f"got {ins['env_rows'].shape[0]}")
    for name in _SCALARS:
        x = ins[name]
        if x.device != dev or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"{name}: expected one float32 on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    cuda_build.check_in_place(st, TransitionState._fields, ins)


def transition16_cuda(scene, config, params, st: TransitionState):
    """One transition of the HDRI kernel route on ``st``, in place (see
    the module doc); returns ``(died (B,) bool, rad_out (3, B))``.
    ``scene`` is the ``SceneData``, ``config`` the ``RenderConfig`` (its
    ``attr_compact``, RR, bounce, firefly and NaN-canary settings),
    ``params`` the ``RenderParams``.  The inputs are checked against the
    kernel's contract on either device; CUDA tensors launch the kernel."""
    _check(_scene_inputs(scene, config, params), st, config.attr_compact,
           tuple(scene.env.image.shape[:2]))
    if st.mode.device.type == "cpu":
        return transition16_plain(scene, config, params, st)
    name, died, rad_out = launch(cuda_build.load()["transition16"], scene, config, params, st)
    transition16_cuda.launches[name] += 1
    return died, rad_out


def launch(lib: ctypes.CDLL, scene, config, params, st: TransitionState):
    """Launch the entry of ``lib`` (a build of ``csrc/transition16.cu``) for
    ``config.attr_compact`` on CUDA inputs that ``transition16_cuda`` has
    checked; returns ``(kernel name, died, rad_out)``.  Counts nothing."""
    ins = _scene_inputs(scene, config, params)
    dev = st.mode.device
    b = st.mode.shape[0]
    died = torch.empty((b,), dtype=torch.bool, device=dev)
    rad_out = torch.empty((3, b), dtype=torch.float32, device=dev)
    args = _TransitionArgs(
        *(getattr(st, n).data_ptr() for n in TransitionState._fields),
        died.data_ptr(), rad_out.data_ptr(), *(ins[n].data_ptr() for n in _TABLES + _SCALARS),
        b, scene.env.image.shape[1], scene.env.image.shape[0],
        int(config.use_russian_roulette), int(config.max_bounces),
        int(config.use_firefly_filter), int(config.debug_nan_canary))
    name = KERNELS[config.attr_compact]
    err = getattr(lib, name + "_launch")(ctypes.byref(args),
                                         torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, name)
    return name, died, rad_out


# Launch count of each kernel entry.
transition16_cuda.launches = dict.fromkeys(KERNELS.values(), 0)


def decode_check_cuda(halfwords: torch.Tensor, states: torch.Tensor):
    """The kernels' f16 decode of ``halfwords`` ((n,) int32, 0..65535) and
    their uint32 -> uniform float of ``states`` ((m,) int64 holding
    uint32), computed on the card by the check entry of
    ``csrc/transition16.cu``: ``(floats (n,), uniforms (m,))``."""
    dev = halfwords.device
    cuda_build.check_tensor(halfwords, "halfwords", torch.int32, halfwords.shape, dev)
    cuda_build.check_tensor(states, "states", torch.int64, states.shape, dev)
    if dev.type != "cuda" or halfwords.dim() != 1 or states.dim() != 1:
        raise ValueError("decode_check_cuda takes 1-D CUDA tensors")
    half_out = torch.empty(halfwords.shape, dtype=torch.float32, device=dev)
    u_out = torch.empty(states.shape, dtype=torch.float32, device=dev)
    lib = cuda_build.load()["transition16"]
    err = lib.transition16_decode_check(
        halfwords.data_ptr(), half_out.data_ptr(), halfwords.shape[0],
        states.data_ptr(), u_out.data_ptr(), states.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, "transition16_decode_check")
    return half_out, u_out
