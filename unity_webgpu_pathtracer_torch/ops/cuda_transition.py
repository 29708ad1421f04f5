"""Fused-integrator transition step: the CUDA kernel
``csrc/transition16.cu`` and its plain twin.

The per-lane shade / env-NEE / BSDF / Russian-roulette step of the
reference's ``ops/pallas_transition.py::_transition_kernel`` on
pre-gathered inputs: the env sample, the attribute and material fetches,
the record-film append and the work-queue regeneration stay outside
(``render/fused.py``), as in the reference.  Mode machine: PRIMARY ->
SHADOW_ENV -> PRIMARY or DEAD.

``transition_step16_cuda`` takes and returns the tensors of the
reference's ``transition_step16_pallas``, vectors as (3, B) planes, with
the hit's attribute row in one of two forms: ``shade_rowT``, 15 decoded
f32 planes (kernel ``transition16``), or the raw form, the (T, 8) int32
attribute table and each lane's row index ``attr``, whose f16 normals are
decoded in the kernel (``transition16_attr_raw``, the reference's
``attr_raw``; its pair row and parity are one 32-byte row here).  CUDA
tensors launch a kernel, counted in
``transition_step16_cuda.launches[name]``; CPU tensors run the plain twin
``transition_step16_plain``, a transcription of the same kernel body in
the same operation order.  Every lane draws the same number of
uniforms in the same order (1 alpha + 3 BSDF + 1 RR), so the RNG stream
is the reference's.
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
MODE_DEAD = 3

FULL16 = 0xFFFF


class TransitionOut(NamedTuple):
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


# Inputs in kernel-struct order: (name, dtype, rows) with rows 0 = (B,).
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
_OUT_SPEC = {
    "mode": (torch.int32, 0), "ptr": (torch.int32, 0), "pend": (torch.int32, 0),
    "sp": (torch.int32, 0), "t": (torch.float32, 0), "u": (torch.float32, 0),
    "v": (torch.float32, 0), "tri": (torch.int32, 0), "found": (torch.bool, 0),
    "trav_oT": (torch.float32, 3), "trav_dT": (torch.float32, 3),
    "path_oT": (torch.float32, 3), "path_dT": (torch.float32, 3),
    "hit_t": (torch.float32, 0), "hit_baryT": (torch.float32, 2),
    "hit_tri": (torch.int32, 0), "pendingT": (torch.float32, 3),
    "throughputT": (torch.float32, 3), "radianceT": (torch.float32, 3),
    "rad_outT": (torch.float32, 3), "rng": (torch.int64, 0),
    "depth": (torch.int32, 0), "max_rough": (torch.float32, 0),
    "prev_pdf": (torch.float32, 0), "lane_cap": (torch.int32, 0),
    "died": (torch.bool, 0), "nray": (torch.int32, 0),
}


class _TransitionArgs(ctypes.Structure):
    """Mirror of ``TransitionArgs`` in ``csrc/transition16.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n, _, _ in _INPUTS]
                + [(n, ctypes.c_void_p) for n in ("shade_rowT", "attr_table", "attr")]
                + [("firefly_max", ctypes.c_void_p)]
                + [("o_" + n, ctypes.c_void_p) for n in TransitionOut._fields]
                + [(n, ctypes.c_int) for n in
                   ("b", "use_rr", "max_bounces", "firefly", "nan_canary")])


# Kernel name by attribute form (raw or not); its C entry is name + "_launch".
KERNELS = {False: "transition16", True: "transition16_attr_raw"}


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


# ---------------------------------------------------------------------------
# Plain twin: the kernel body on (B,) tensors, vectors as planes 3-tuples,
# in the kernel's operation order; the shading math is the port's shared
# BSDF (render/bsdf.py, render/sampling.py, scene/material.py).
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
    """The transition kernels' body in plain PyTorch (see module doc);
    the attribute row comes as ``shade_rowT`` or as ``attr_table`` and
    ``attr``, whose lane rows are gathered and decoded here."""
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


def transition_step16_cuda(*, use_rr: bool, max_bounces: int,
                           shade_rowT=None, attr_table=None, attr=None,
                           firefly: bool = False, firefly_max=None,
                           nan_canary: bool = False, **inputs) -> TransitionOut:
    """One transition on pre-gathered inputs (the keyword tensors of
    ``transition_step16_plain``; exactly one of ``shade_rowT`` or
    ``attr_table`` with ``attr``), checked against the kernel's contract
    on either device; CUDA tensors launch a kernel."""
    mode = inputs["mode"]
    dev = mode.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    b = mode.shape[0]
    if set(inputs) != {n for n, _, _ in _INPUTS}:
        raise ValueError(f"inputs differ from the kernel's: "
                         f"{sorted(set(inputs) ^ {n for n, _, _ in _INPUTS})}")
    for name, dtype, rows in _INPUTS:
        x = inputs[name]
        shape = (b,) if rows == 0 else (rows, b)
        cuda_build.check_tensor(x, name, dtype, shape, dev)
    raw = attr_table is not None
    if raw == (shade_rowT is not None) or raw != (attr is not None):
        raise ValueError("pass exactly one attribute form: shade_rowT, or attr_table "
                         "with attr")
    if raw:
        cuda_build.check_tensor(attr_table, "attr_table", torch.int32,
                                (attr_table.shape[0], 8), dev)
        cuda_build.check_tensor(attr, "attr", torch.int32, (b,), dev)
        if attr_table.data_ptr() % 16:
            raise ValueError("attr_table: the kernel loads rows as 16-byte vectors; "
                             "pass a 16-byte-aligned table")
        form = dict(attr_table=attr_table, attr=attr)
    else:
        cuda_build.check_tensor(shade_rowT, "shade_rowT", torch.float32, (15, b), dev)
        form = dict(shade_rowT=shade_rowT)
    if firefly:
        if firefly_max is None or firefly_max.device != dev \
                or firefly_max.dtype != torch.float32 or firefly_max.numel() != 1:
            raise ValueError("firefly needs firefly_max as a 1-element float32 "
                             f"tensor on {dev}")
    if dev.type == "cpu":
        return transition_step16_plain(use_rr=use_rr, max_bounces=max_bounces,
                                       firefly=firefly, firefly_max=firefly_max,
                                       nan_canary=nan_canary, **form, **inputs)
    out = TransitionOut(**{
        n: torch.empty((b,) if rows == 0 else (rows, b), dtype=dtype, device=dev)
        for n, (dtype, rows) in _OUT_SPEC.items()})
    args = _TransitionArgs(
        *(inputs[n].data_ptr() for n, _, _ in _INPUTS),
        *(form[n].data_ptr() if n in form else 0
          for n in ("shade_rowT", "attr_table", "attr")),
        firefly_max.data_ptr() if firefly else 0,
        *(getattr(out, n).data_ptr() for n in TransitionOut._fields),
        b, int(use_rr), int(max_bounces), int(firefly), int(nan_canary))
    lib = cuda_build.load()["transition16"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = KERNELS[raw]
    err = getattr(lib, name + "_launch")(ctypes.byref(args), stream)
    cuda_build.check(lib, err, name)
    transition_step16_cuda.launches[name] += 1
    return out


# Launch count of each kernel entry.
transition_step16_cuda.launches = dict.fromkeys(KERNELS.values(), 0)


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
