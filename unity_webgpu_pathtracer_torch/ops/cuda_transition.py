"""Fused-integrator transition step: the CUDA kernel
``csrc/transition16.cu`` and its plain twin.

The per-lane shade / env-NEE / BSDF / Russian-roulette step of the
reference's ``ops/pallas_transition.py::_transition_kernel`` on
pre-gathered inputs: the env sample, the attribute and material fetches,
the record-film append and the work-queue regeneration stay outside
(``render/fused.py``), as in the reference.  Mode machine: PRIMARY ->
SHADOW_ENV -> PRIMARY or DEAD.

``transition_step16_cuda`` takes and returns the tensors of the
reference's ``transition_step16_pallas`` (shade_row form), vectors as
(3, B) planes.  CUDA tensors launch the kernel; CPU tensors run the plain
twin ``transition_step16_plain``, a transcription of the same kernel body
in the same operation order.  Every lane draws the same number of
uniforms in the same order (1 alpha + 3 BSDF + 1 RR), so the RNG stream
is the reference's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from unity_webgpu_pathtracer_torch.ops import cuda_build
from unity_webgpu_pathtracer_torch.utils import rng as urng
from unity_webgpu_pathtracer_torch.utils.math import EPSILON, FAR_PLANE, INV_PI, TWO_PI

# Lane modes: the one definition in the port (the kernel receives them as
# -D macros from ops/cuda_build.py).
MODE_PRIMARY = 0
MODE_SHADOW_ENV = 1
MODE_DEAD = 3

FULL16 = 0xFFFF
_PI32 = 3.14159265358979323


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
    ("lane_cap", torch.int32, 0),
    ("shade_rowT", torch.float32, 15), ("mdataT", torch.float32, 22),
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
                + [("firefly_max", ctypes.c_void_p)]
                + [("o_" + n, ctypes.c_void_p) for n in TransitionOut._fields]
                + [(n, ctypes.c_int) for n in
                   ("b", "use_rr", "max_bounces", "firefly", "nan_canary")])


# ---------------------------------------------------------------------------
# Plain twin: the kernel body on (B,) tensors, vectors as 3-tuples of
# tensors, transcribed op for op from the reference's planes dialect.
# ---------------------------------------------------------------------------

def _w(m, a, b):
    return torch.where(m, a, b)


def _vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _vneg(a):
    return (-a[0], -a[1], -a[2])


def _vwhere(m, a, b):
    return (_w(m, a[0], b[0]), _w(m, a[1], b[1]), _w(m, a[2], b[2]))


def _vnormalize(v, eps=1.0e-20):
    return _vscale(v, 1.0 / torch.sqrt(torch.clamp_min(_vdot(v, v), eps)))


def _vreflect(i, n):
    d = _vdot(i, n)
    return (i[0] - 2.0 * d * n[0], i[1] - 2.0 * d * n[1], i[2] - 2.0 * d * n[2])


def _vrefract(i, n, eta):
    cos_i = -_vdot(i, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    coef = eta * cos_i - torch.sqrt(torch.clamp_min(k, 0.0))
    refr = (eta * i[0] + coef * n[0], eta * i[1] + coef * n[1],
            eta * i[2] + coef * n[2])
    zero = torch.zeros_like(k)
    bad = k < 0.0
    return (_w(bad, zero, refr[0]), _w(bad, zero, refr[1]), _w(bad, zero, refr[2]))


def _lum(c):
    return c[0] * 0.299 + c[1] * 0.587 + c[2] * 0.114


def _safe_div(a, b, eps=1e-20):
    return a / _w(torch.abs(b) < eps, _w(b < 0, torch.full_like(b, -eps),
                                         torch.full_like(b, eps)), b)


def _clip(x, lo, hi):
    return torch.clamp_max(torch.clamp_min(x, lo), hi)


def _schlick_weight(u):
    m = _clip(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _nz(x):
    """``where(x == 0, 1, x)``: the reference's guarded denominators."""
    return _w(x == 0.0, torch.ones_like(x), x)


def _dielectric_fresnel(cos_theta_i, eta):
    sin2_t = eta * eta * (1.0 - cos_theta_i * cos_theta_i)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    rs = (eta * cos_t - cos_theta_i) / _nz(eta * cos_t + cos_theta_i)
    rp = (eta * cos_theta_i - cos_t) / _nz(eta * cos_theta_i + cos_t)
    f = 0.5 * (rs * rs + rp * rp)
    return _w(sin2_t > 1.0, torch.ones_like(f), f)


def _smith_g(n_dot_v, alpha_g):
    a = alpha_g * alpha_g
    b = n_dot_v * n_dot_v
    return (2.0 * n_dot_v) / (n_dot_v + torch.sqrt(torch.clamp_min(a + b - a * b, 0.0)))


def _smith_g_aniso(n_dot_v, v_dot_x, v_dot_y, ax, ay):
    a = v_dot_x * ax
    b = v_dot_y * ay
    c = n_dot_v
    return (2.0 * n_dot_v) / (n_dot_v + torch.sqrt(torch.clamp_min(a * a + b * b + c * c, 0.0)))


def _gtr1(n_dot_h, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    d = (a2 - 1.0) / (_PI32 * torch.log(a2) * t)
    return _w(a >= 1.0, torch.full_like(d, INV_PI), d)


def _gtr2_aniso(n_dot_h, h_dot_x, h_dot_y, ax, ay):
    a = h_dot_x / ax
    b = h_dot_y / ay
    c = a * a + b * b + n_dot_h * n_dot_h
    return 1.0 / (_PI32 * ax * ay * c * c)


def _power_heuristic(a, b):
    t = a * a
    return t / _nz(b * b + t)


def _build_onb(z):
    len_sq = _vdot(z, z)
    zn = _vnormalize(z)
    zx, zy, zz = zn
    k = 1.0 / torch.clamp_min(1.0 + zz, 1.0e-5)
    a = zy * k
    b = zy * a
    c = -zx * a
    x = _vnormalize((zz + b, c, -zx))
    y = _vnormalize((c, 1.0 - b, -zy))
    deg = len_sq == 0.0
    one, zero = torch.ones_like(zx), torch.zeros_like(zx)
    return (_vwhere(deg, (one, zero, zero), x), _vwhere(deg, (zero, one, zero), y),
            _vwhere(deg, (zero, zero, one), zn))


def _to_local(onb, w):
    x, y, z = onb
    return (_vdot(x, w), _vdot(y, w), _vdot(z, w))


def _to_world(onb, local):
    x, y, z = onb
    return (x[0] * local[0] + y[0] * local[1] + z[0] * local[2],
            x[1] * local[0] + y[1] * local[1] + z[1] * local[2],
            x[2] * local[0] + y[2] * local[1] + z[2] * local[2])


def _cosine_sample_hemisphere(r1, r2):
    r = torch.sqrt(r1)
    phi = TWO_PI * r2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0))
    return (x, y, z)


def _sample_gtr1(rgh, r1, r2):
    a = torch.clamp_min(rgh, 0.001)
    a2 = a * a
    phi = r1 * TWO_PI
    cos_theta = torch.sqrt(torch.clamp_min(
        (1.0 - torch.pow(a2, 1.0 - r2)) / (1.0 - a2), 0.0))
    sin_theta = _clip(torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0)),
                      0.0, 1.0)
    return (sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)


def _sample_ggx_vndf(v, ax, ay, r1, r2):
    vh = _vnormalize((ax * v[0], ay * v[1], v[2]))
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    inv_len = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-20))
    has = lensq > 0.0
    one, zero = torch.ones_like(lensq), torch.zeros_like(lensq)
    t1 = _vwhere(has, (-vh[1] * inv_len, vh[0] * inv_len, zero), (one, zero, zero))
    t2 = _vcross(vh, t1)
    r = torch.sqrt(r1)
    phi = TWO_PI * r2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = (p1 * t1[0] + p2 * t2[0] + p3 * vh[0],
          p1 * t1[1] + p2 * t2[1] + p3 * vh[1],
          p1 * t1[2] + p2 * t2[2] + p3 * vh[2])
    return _vnormalize((ax * nh[0], ay * nh[1], torch.clamp_min(nh[2], 0.0)))


class _Mat(NamedTuple):
    bc: tuple
    roughness: torch.Tensor
    subsurface: torch.Tensor
    spec_tint: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    cc_rough: torch.Tensor
    spec_trans: torch.Tensor
    ior: torch.Tensor
    metallic: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    eta: torch.Tensor


def _lobe_probabilities(mat: _Mat, v):
    lum_bc = _lum(mat.bc)
    lum_den = torch.clamp_min(lum_bc, 1e-20)
    has = lum_bc > 0.0
    one = torch.ones_like(lum_bc)
    ctint = _vwhere(has, (mat.bc[0] / lum_den, mat.bc[1] / lum_den,
                          mat.bc[2] / lum_den), (one, one, one))
    f0r = (1.0 - mat.eta) / (1.0 + mat.eta)
    f0 = f0r * f0r
    cspec0 = tuple(f0 * (1.0 + (ctint[c] - 1.0) * mat.spec_tint) for c in range(3))
    csheen = tuple(1.0 + (ctint[c] - 1.0) * mat.sheen_tint for c in range(3))
    dielectric_wt = (1.0 - mat.metallic) * (1.0 - mat.spec_trans)
    metal_wt = mat.metallic
    glass_wt = (1.0 - mat.metallic) * mat.spec_trans
    sw = _schlick_weight(v[2])
    diff_pr = dielectric_wt * _lum(mat.bc)
    dielectric_pr = dielectric_wt * _lum(
        tuple(cspec0[c] + (1.0 - cspec0[c]) * sw for c in range(3)))
    metal_pr = metal_wt * _lum(
        tuple(mat.bc[c] + (1.0 - mat.bc[c]) * sw for c in range(3)))
    glass_pr = glass_wt
    clearcoat_pr = 0.25 * mat.clearcoat
    total = diff_pr + dielectric_pr + metal_pr + glass_pr + clearcoat_pr
    inv_total = _safe_div(torch.ones_like(total), total)
    return ((diff_pr * inv_total, dielectric_pr * inv_total,
             metal_pr * inv_total, glass_pr * inv_total,
             clearcoat_pr * inv_total),
            (dielectric_wt, metal_wt, glass_wt),
            (f0, csheen, cspec0))


def _gate3(gate, f, wt):
    zero = torch.zeros_like(f[0])
    return tuple(_w(gate, f[c] * wt, zero) for c in range(3))


def _vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _eval_diffuse(mat: _Mat, csheen, v, l, h):
    lz, vz = l[2], v[2]
    l_dot_h = _vdot(l, h)
    rr = 2.0 * mat.roughness * l_dot_h * l_dot_h
    fl = _schlick_weight(lz)
    fv = _schlick_weight(vz)
    fretro = rr * (fl + fv + fl * fv * (rr - 1.0))
    fd = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    fss90 = 0.5 * rr
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (_safe_div(torch.ones_like(lz), lz + vz) - 0.5) + 0.5)
    fh = _schlick_weight(l_dot_h)
    coef = (fd + fretro) + (ss - (fd + fretro)) * mat.subsurface
    f = tuple(INV_PI * mat.bc[c] * coef + fh * mat.sheen * csheen[c] for c in range(3))
    pdf = lz * INV_PI
    valid = lz > 0.0
    zero = torch.zeros_like(lz)
    return _vwhere(valid, f, (zero, zero, zero)), _w(valid, pdf, zero)


def _eval_microfacet_reflection(mat: _Mat, v, l, h, f_term):
    lz, vz = l[2], v[2]
    d = _gtr2_aniso(h[2], h[0], h[1], mat.ax, mat.ay)
    g1 = _smith_g_aniso(torch.abs(vz), v[0], v[1], mat.ax, mat.ay)
    g2 = g1 * _smith_g_aniso(torch.abs(lz), l[0], l[1], mat.ax, mat.ay)
    pdf = _safe_div(g1 * d, 4.0 * vz)
    coef = _safe_div(d * g2, 4.0 * lz * vz)
    f = (f_term[0] * coef, f_term[1] * coef, f_term[2] * coef)
    valid = lz > 0.0
    zero = torch.zeros_like(lz)
    return _vwhere(valid, f, (zero, zero, zero)), _w(valid, pdf, zero)


def _eval_microfacet_refraction(mat: _Mat, eta, v, l, h, f_term):
    lz, vz = l[2], v[2]
    l_dot_h = _vdot(l, h)
    v_dot_h = _vdot(v, h)
    d = _gtr2_aniso(h[2], h[0], h[1], mat.ax, mat.ay)
    g1 = _smith_g_aniso(torch.abs(vz), v[0], v[1], mat.ax, mat.ay)
    g2 = g1 * _smith_g_aniso(torch.abs(lz), l[0], l[1], mat.ax, mat.ay)
    dn = l_dot_h + v_dot_h * eta
    denom = dn * dn
    eta2 = eta * eta
    jacobian = _safe_div(torch.abs(l_dot_h), denom)
    pdf = _safe_div(g1 * torch.clamp_min(v_dot_h, 0.0) * d * jacobian, vz)
    coef1 = d * g2 * torch.abs(v_dot_h) * jacobian * eta2
    coef2 = _safe_div(torch.ones_like(lz), torch.abs(lz * vz))
    f = tuple(torch.sqrt(torch.clamp_min(mat.bc[c], 0.0)) * (1.0 - f_term) * coef1 * coef2
              for c in range(3))
    valid = lz < 0.0
    zero = torch.zeros_like(lz)
    return _vwhere(valid, f, (zero, zero, zero)), _w(valid, pdf, zero)


def _eval_clearcoat(mat: _Mat, v, l, h):
    lz, vz = l[2], v[2]
    v_dot_h = _vdot(v, h)
    f = 0.04 + 0.96 * _schlick_weight(v_dot_h)
    d = _gtr1(h[2], mat.cc_rough)
    quarter = torch.full_like(lz, 0.25)
    g = _smith_g(lz, quarter) * _smith_g(vz, quarter)
    jacobian = _safe_div(torch.ones_like(lz), 4.0 * v_dot_h)
    pdf = d * h[2] * jacobian
    valid = lz > 0.0
    zero = torch.zeros_like(lz)
    fo_s = _w(valid, f * d * g, zero)
    return (fo_s, fo_s, fo_s), _w(valid, pdf, zero)


def _eval_brdf_local(mat: _Mat, v, l, probs):
    lz, vz = l[2], v[2]
    h_refl = _vnormalize(_vadd(l, v))
    h_refr = _vnormalize((l[0] + v[0] * mat.eta, l[1] + v[1] * mat.eta,
                          l[2] + v[2] * mat.eta))
    h = _vwhere(lz > 0.0, h_refl, h_refr)
    h = _vwhere(h[2] < 0.0, _vneg(h), h)

    ((diff_pr, dielectric_pr, metal_pr, glass_pr, clearcoat_pr),
     (dielectric_wt, metal_wt, glass_wt), (f0, csheen, cspec0)) = probs

    reflect_side = lz * vz > 0.0
    v_dot_h = torch.abs(_vdot(v, h))
    zero = torch.zeros_like(lz)

    fd, pd = _eval_diffuse(mat, csheen, v, l, h)
    gate = (diff_pr > 0.0) & reflect_side
    f = _vadd((zero, zero, zero), _gate3(gate, fd, dielectric_wt))
    pdf = zero + _w(gate, pd * diff_pr, zero)

    inv_eta = _safe_div(torch.ones_like(lz), mat.ior)
    fres = _safe_div(_dielectric_fresnel(v_dot_h, inv_eta) - f0, 1.0 - f0)
    fres = _w((f0 != 1.0) & (mat.ior != 0.0), fres, zero)
    f_term = tuple(cspec0[c] + (1.0 - cspec0[c]) * fres for c in range(3))
    fr, pr = _eval_microfacet_reflection(mat, v, l, h, f_term)
    gate = (dielectric_pr > 0.0) & reflect_side
    f = _vadd(f, _gate3(gate, fr, dielectric_wt))
    pdf = pdf + _w(gate, pr * dielectric_pr, zero)

    sw_vh = _schlick_weight(v_dot_h)
    f_metal = tuple(mat.bc[c] + (1.0 - mat.bc[c]) * sw_vh for c in range(3))
    fm, pm = _eval_microfacet_reflection(mat, v, l, h, f_metal)
    gate = (metal_pr > 0.0) & reflect_side
    f = _vadd(f, _gate3(gate, fm, metal_wt))
    pdf = pdf + _w(gate, pm * metal_pr, zero)

    f_glass = _dielectric_fresnel(v_dot_h, mat.eta)
    fgr, pgr = _eval_microfacet_reflection(mat, v, l, h, (f_glass, f_glass, f_glass))
    fgt, pgt = _eval_microfacet_refraction(mat, mat.eta, v, l, h, f_glass)
    gate = glass_pr > 0.0
    fg = _vwhere(reflect_side, fgr, fgt)
    f = _vadd(f, _gate3(gate, fg, glass_wt))
    pdf = pdf + _w(gate, _w(reflect_side, pgr * glass_pr * f_glass,
                            pgt * glass_pr * (1.0 - f_glass)), zero)

    fc, pc = _eval_clearcoat(mat, v, l, h)
    gate = (clearcoat_pr > 0.0) & reflect_side
    f = _vadd(f, _gate3(gate, fc, 0.25 * mat.clearcoat))
    pdf = pdf + _w(gate, pc * clearcoat_pr, zero)

    alz = torch.abs(lz)
    return (f[0] * alz, f[1] * alz, f[2] * alz), pdf


def _sample_brdf(mat: _Mat, onb, v, probs, state):
    r1, state = urng.random_float(state)
    r2, state = urng.random_float(state)
    r3, state = urng.random_float(state)

    (diff_pr, dielectric_pr, metal_pr, glass_pr, _cc_pr), _, _ = probs
    cdf0 = diff_pr
    cdf1 = cdf0 + dielectric_pr
    cdf2 = cdf1 + metal_pr
    cdf3 = cdf2 + glass_pr

    l_diff = _cosine_sample_hemisphere(r1, r2)
    h_ggx = _sample_ggx_vndf(v, mat.ax, mat.ay, r1, r2)
    h_ggx = _vwhere(h_ggx[2] < 0.0, _vneg(h_ggx), h_ggx)
    l_spec = _vnormalize(_vreflect(_vneg(v), h_ggx))

    f_glass = _dielectric_fresnel(torch.abs(_vdot(v, h_ggx)), mat.eta)
    r3_rescaled = _safe_div(r3 - cdf2, cdf3 - cdf2)
    l_refr = _vnormalize(_vrefract(_vneg(v), h_ggx, mat.eta))
    l_glass = _vwhere(r3_rescaled < f_glass, l_spec, l_refr)

    h_cc = _sample_gtr1(mat.cc_rough, r1, r2)
    h_cc = _vwhere(h_cc[2] < 0.0, _vneg(h_cc), h_cc)
    l_cc = _vnormalize(_vreflect(_vneg(v), h_cc))

    l = _vwhere(r3 < cdf0, l_diff,
                _vwhere(r3 < cdf2, l_spec, _vwhere(r3 < cdf3, l_glass, l_cc)))
    f, pdf = _eval_brdf_local(mat, v, l, probs)
    return f, _to_world(onb, l), pdf, state


def transition_step16_plain(*, mode, trav_done, ptr, pend, sp, t, u, v, tri, found,
                            trav_oT, trav_dT, path_oT, path_dT,
                            hit_t, hit_baryT, hit_tri,
                            pendingT, throughputT, radianceT,
                            rng, depth, max_rough, prev_pdf, lane_cap,
                            shade_rowT, mdataT,
                            sky_colT, sky_pdf, env_dirT, env_liT, env_pdf,
                            use_rr: bool, max_bounces: int,
                            firefly: bool = False, firefly_max=None,
                            nan_canary: bool = False) -> TransitionOut:
    """The transition kernel's body in plain PyTorch (see module doc)."""
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
    mis = _w(depth > 0, _power_heuristic(prev_pdf, sky_pdf), torch.ones_like(zero))
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
    sr = [shade_rowT[k] for k in range(9)]
    w0 = 1.0 - b0 - b1
    normal = _vnormalize((sr[0] * w0 + sr[3] * b0 + sr[6] * b1,
                          sr[1] * w0 + sr[4] * b0 + sr[7] * b1,
                          sr[2] * w0 + sr[5] * b0 + sr[8] * b1))

    # --- material derivation (material.hlsl:84-137, untextured) ---
    md = [mdataT[k] for k in range(22)]
    opacity = md[3]
    rough_m = torch.clamp_min(md[9], 0.001)
    ior = _clip(md[11], 1.001, 2.0)
    aniso = _clip(md[13], -0.9, 0.9)
    aspect = torch.sqrt(1.0 - aniso * 0.9)
    entering = (path_d[0] * normal[0] + path_d[1] * normal[1]
                + path_d[2] * normal[2]) < 0.0
    max_rough_o = _w(shade, torch.maximum(max_rough, rough_m), max_rough)
    mat = _Mat(
        bc=(md[0], md[1], md[2]),
        roughness=max_rough_o,
        subsurface=md[18], spec_tint=md[15], sheen=md[16], sheen_tint=md[17],
        clearcoat=md[19],
        cc_rough=0.1 + (0.001 - 0.1) * md[20],
        spec_trans=1.0 - _clip(opacity, 0.0, 1.0),
        ior=ior, metallic=md[8],
        ax=torch.clamp_min(max_rough_o / aspect, 0.001),
        ay=torch.clamp_min(max_rough_o * aspect, 0.001),
        eta=_w(entering, 1.0 / ior, ior),
    )
    alpha_mode = md[12].to(torch.int32)
    alpha_cutoff = md[7]
    emission = (md[4], md[5], md[6])
    nd = normal[0] * path_d[0] + normal[1] * path_d[1] + normal[2] * path_d[2]
    ffnormal = _vwhere(nd <= 0.0, normal, _vneg(normal))
    position = tuple(path_o[c] + sel_t * path_d[c] for c in range(3))
    scatter_pos = tuple(position[c] + normal[c] * EPSILON for c in range(3))

    radiance = tuple(radiance[c] + _w(shade, emission[c] * throughput[c], zero)
                     for c in range(3))
    over_budget = depth >= max_bounces
    ended_budget = shade & over_budget
    shade = shade & ~over_budget

    # --- alpha passthrough (pathtrace.hlsl:84-89) ---
    u_alpha, rng = urng.random_float(rng)
    passthrough = shade & (((alpha_mode == 2) & (opacity < alpha_cutoff))
                           | ((alpha_mode == 1) & (u_alpha > opacity)))
    shade = shade & ~passthrough

    # --- shadow traversal finished -> apply the pending contribution ---
    env_done = (mode == MODE_SHADOW_ENV) & shadow_done
    g_app = env_done & ~found
    radiance = tuple(radiance[c] + _w(g_app, pending[c] * throughput[c], zero)
                     for c in range(3))
    to_env = shade
    to_bsdf = env_done

    onb = _build_onb(ffnormal)
    v_local = _to_local(onb, _vneg(path_d))
    probs = _lobe_probabilities(mat, v_local)

    # --- env NEE evaluation (light.hlsl:125-158) ---
    env_dir, env_li = p3(env_dirT), p3(env_liT)
    l_env = _to_local(onb, env_dir)
    f_u, bpdf_u = _eval_brdf_local(mat, v_local, l_env, probs)
    mis_e = _power_heuristic(env_pdf, bpdf_u)
    epdf_den = torch.clamp_min(env_pdf, 1e-20)
    contrib = tuple(mis_e * env_li[c] * f_u[c] / epdf_den for c in range(3))
    ok = (bpdf_u > 0) & (env_pdf > 0) & (mis_e > 0)
    pending = _vwhere(to_env, _vwhere(ok, contrib, z3), pending)

    # Fresh shadow segment at the root for to_env lanes.
    trav_o = _vwhere(to_env, scatter_pos, p3(trav_oT))
    trav_d = _vwhere(to_env, env_dir, p3(trav_dT))
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
    f_s, l_s, pdf_s, rng = _sample_brdf(mat, onb, v_local, probs, rng)
    nan_lane = ((f_s[0] != f_s[0]) | (f_s[1] != f_s[1])
                | (f_s[2] != f_s[2]) | (pdf_s != pdf_s))
    sample_ok = to_bsdf & ~nan_lane & (pdf_s > 0.0)
    pdf_den = torch.clamp_min(pdf_s, 1e-20)
    throughput = _vwhere(sample_ok, tuple(throughput[c] * f_s[c] / pdf_den
                                          for c in range(3)), throughput)
    continue_ray = sample_ok
    if use_rr:
        u_rr, rng = urng.random_float(rng)
        t_max3 = torch.maximum(torch.maximum(throughput[0], throughput[1]), throughput[2])
        p_cont = torch.clamp_max(t_max3 + 0.001, 0.95)
        rr_kill = continue_ray & (u_rr >= p_cont)
        keep = continue_ray & ~rr_kill
        throughput = _vwhere(keep, tuple(throughput[c] / p_cont for c in range(3)),
                             throughput)
        continue_ray = continue_ray & ~rr_kill

    processed = a | env_done
    cap_exhausted = processed & (lane_cap <= 0)
    died = miss | ended_budget | (to_bsdf & ~continue_ray) | cap_exhausted

    rad_out = radiance
    if firefly:
        lum = _lum(rad_out)
        ffly = firefly_max.reshape(())
        scale = _w(lum > ffly, ffly / torch.clamp_min(lum, 1e-20), torch.ones_like(lum))
        rad_out = _vscale(rad_out, scale)
    if nan_canary:
        g_nan = to_bsdf & nan_lane
        rad_out = (_w(g_nan, zero, rad_out[0]), _w(g_nan, torch.ones_like(zero), rad_out[1]),
                   _w(g_nan, zero, rad_out[2]))

    # --- continuing bounce: new primary ray ---
    new_dir = _vwhere(passthrough, path_d, l_s)
    bounce = (continue_ray | passthrough) & ~died
    new_origin = tuple(position[c] + new_dir[c] * EPSILON for c in range(3))
    path_o = _vwhere(bounce, new_origin, path_o)
    path_d = _vwhere(bounce, new_dir, path_d)
    trav_o = _vwhere(bounce, path_o, trav_o)
    trav_d = _vwhere(bounce, path_d, trav_d)
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
                           firefly: bool = False, firefly_max=None,
                           nan_canary: bool = False, **inputs) -> TransitionOut:
    """One transition on pre-gathered inputs (the keyword tensors of
    ``transition_step16_plain``); CUDA tensors launch the kernel."""
    mode = inputs["mode"]
    if mode.device.type == "cpu":
        return transition_step16_plain(use_rr=use_rr, max_bounces=max_bounces,
                                       firefly=firefly, firefly_max=firefly_max,
                                       nan_canary=nan_canary, **inputs)
    if mode.device.type != "cuda":
        raise ValueError(f"unsupported device {mode.device}")
    dev = mode.device
    b = mode.shape[0]
    if set(inputs) != {n for n, _, _ in _INPUTS}:
        raise ValueError(f"inputs differ from the kernel's: "
                         f"{sorted(set(inputs) ^ {n for n, _, _ in _INPUTS})}")
    for name, dtype, rows in _INPUTS:
        x = inputs[name]
        shape = (b,) if rows == 0 else (rows, b)
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if firefly:
        if firefly_max is None or firefly_max.device != dev \
                or firefly_max.dtype != torch.float32 or firefly_max.numel() != 1:
            raise ValueError("firefly needs firefly_max as a 1-element float32 "
                             f"tensor on {dev}")
    out = TransitionOut(**{
        n: torch.empty((b,) if rows == 0 else (rows, b), dtype=dtype, device=dev)
        for n, (dtype, rows) in _OUT_SPEC.items()})
    args = _TransitionArgs(
        *(inputs[n].data_ptr() for n, _, _ in _INPUTS),
        firefly_max.data_ptr() if firefly else 0,
        *(getattr(out, n).data_ptr() for n in TransitionOut._fields),
        b, int(use_rr), int(max_bounces), int(firefly), int(nan_canary))
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.transition16_launch(ctypes.byref(args), stream)
    cuda_build.check(lib, err, "transition16")
    transition_step16_cuda.launches += 1
    return out


transition_step16_cuda.launches = 0
