# Frozen copy of unity_webgpu_pathtracer_torch/render/bsdf.py at commit 628fc1bc0151d37c4767d2275c25b153616afc0d,
# imports rewritten to this package; the benchmark's yardstick, not to be edited with the port.
"""Disney-style 5-lobe BSDF (``render/bsdf.py`` of the reference;
``brdf.hlsl``): diffuse + retro + fake subsurface + sheen, dielectric GGX
reflection, metallic GGX reflection, glass reflect/refract, clearcoat GTR1.

Branch-free, in planes (``utils/math.py``): every lobe is evaluated for
every lane and gated with ``torch.where``, and every division is guarded,
so a masked lane cannot make a NaN that reaches a live one.  All lobe math
happens in the tangent frame of the shading normal (z = N); ``v`` points
away from the surface; ``eta`` is the relative IOR of the current
hemisphere.  The transition kernel's plain twin
(``ops/cuda_transition.py``) and the general transition
(``render/fused.py``) both shade through these functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pt_bench.reference.sampling import (
    cosine_sample_hemisphere,
    dielectric_fresnel,
    gtr1,
    gtr2_aniso,
    sample_ggx_vndf,
    sample_gtr1,
    schlick_weight,
    smith_g,
    smith_g_aniso,
)
from pt_bench.reference import rng as urng
from pt_bench.reference.vmath import (
    INV_PI,
    build_onb,
    safe_div,
    sqrt,
    to_local,
    to_world,
    vadd,
    vdot,
    vluminance,
    vneg,
    vnormalize,
    vreflect,
    vrefract,
    vscale,
    vwhere,
)


class Material(NamedTuple):
    """Runtime material record (``common.hlsl:106-135``), per lane; colours
    are planes 3-tuples.  ``occlusion`` is the occlusion texture's factor
    on ``f``; None (untextured) stands for 1."""

    base_color: tuple
    opacity: torch.Tensor
    emission: tuple
    alpha_mode: torch.Tensor       # int32
    alpha_cutoff: torch.Tensor
    anisotropic: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    subsurface: torch.Tensor
    specular_tint: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_roughness: torch.Tensor
    spec_trans: torch.Tensor
    ior: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    eta: torch.Tensor              # hemisphere-relative IOR
    occlusion: torch.Tensor | None = None


def with_roughness(mat: Material, roughness: torch.Tensor) -> Material:
    """``mat`` with its roughness (and the anisotropic ``ax``/``ay`` split)
    replaced, as the transitions do with the path's running maximum."""
    aspect = sqrt(1.0 - mat.anisotropic * 0.9)
    return mat._replace(roughness=roughness,
                        ax=torch.clamp_min(roughness / aspect, 0.001),
                        ay=torch.clamp_min(roughness * aspect, 0.001))


def _gate3(gate, f, wt):
    zero = torch.zeros_like(f[0])
    return tuple(torch.where(gate, f[c] * wt, zero) for c in range(3))


def lobe_probabilities(mat: Material, v):
    """Luminance-weighted lobe CDF (``brdf.hlsl:137-156``): ``(probs,
    weights, (f0, csheen, cspec0))``."""
    bc = mat.base_color
    lum_bc = vluminance(bc)
    lum_den = torch.clamp_min(lum_bc, 1e-20)
    one = torch.ones_like(lum_bc)
    ctint = vwhere(lum_bc > 0.0, (bc[0] / lum_den, bc[1] / lum_den, bc[2] / lum_den),
                   (one, one, one))
    f0r = (1.0 - mat.eta) / (1.0 + mat.eta)
    f0 = f0r * f0r
    cspec0 = tuple(f0 * (1.0 + (ctint[c] - 1.0) * mat.specular_tint) for c in range(3))
    csheen = tuple(1.0 + (ctint[c] - 1.0) * mat.sheen_tint for c in range(3))
    dielectric_wt = (1.0 - mat.metallic) * (1.0 - mat.spec_trans)
    metal_wt = mat.metallic
    glass_wt = (1.0 - mat.metallic) * mat.spec_trans
    sw = schlick_weight(v[2])
    diff_pr = dielectric_wt * vluminance(bc)
    dielectric_pr = dielectric_wt * vluminance(
        tuple(cspec0[c] + (1.0 - cspec0[c]) * sw for c in range(3)))
    metal_pr = metal_wt * vluminance(tuple(bc[c] + (1.0 - bc[c]) * sw for c in range(3)))
    glass_pr = glass_wt
    clearcoat_pr = 0.25 * mat.clearcoat
    total = diff_pr + dielectric_pr + metal_pr + glass_pr + clearcoat_pr
    inv_total = safe_div(torch.ones_like(total), total)
    return ((diff_pr * inv_total, dielectric_pr * inv_total,
             metal_pr * inv_total, glass_pr * inv_total,
             clearcoat_pr * inv_total),
            (dielectric_wt, metal_wt, glass_wt),
            (f0, csheen, cspec0))


def eval_diffuse(mat: Material, csheen, v, l, h):
    """Disney diffuse + retro + fake subsurface + sheen (``brdf.hlsl:25-54``)."""
    lz, vz = l[2], v[2]
    l_dot_h = vdot(l, h)
    rr = 2.0 * mat.roughness * l_dot_h * l_dot_h
    fl = schlick_weight(lz)
    fv = schlick_weight(vz)
    fretro = rr * (fl + fv + fl * fv * (rr - 1.0))
    fd = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    fss90 = 0.5 * rr
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (safe_div(torch.ones_like(lz), lz + vz) - 0.5) + 0.5)
    fh = schlick_weight(l_dot_h)
    coef = (fd + fretro) + (ss - (fd + fretro)) * mat.subsurface
    f = tuple(INV_PI * mat.base_color[c] * coef + fh * mat.sheen * csheen[c]
              for c in range(3))
    pdf = lz * INV_PI
    valid = lz > 0.0
    zero = torch.zeros_like(lz)
    return vwhere(valid, f, (zero, zero, zero)), torch.where(valid, pdf, zero)


def eval_microfacet_reflection(mat: Material, v, l, h, f_term):
    """Aniso GGX reflection with the VNDF pdf (``brdf.hlsl:56-70``)."""
    lz, vz = l[2], v[2]
    d = gtr2_aniso(h[2], h[0], h[1], mat.ax, mat.ay)
    g1 = smith_g_aniso(torch.abs(vz), v[0], v[1], mat.ax, mat.ay)
    g2 = g1 * smith_g_aniso(torch.abs(lz), l[0], l[1], mat.ax, mat.ay)
    pdf = safe_div(g1 * d, 4.0 * vz)
    coef = safe_div(d * g2, 4.0 * lz * vz)
    f = (f_term[0] * coef, f_term[1] * coef, f_term[2] * coef)
    valid = lz > 0.0
    zero = torch.zeros_like(lz)
    return vwhere(valid, f, (zero, zero, zero)), torch.where(valid, pdf, zero)


def eval_microfacet_refraction(mat: Material, eta, v, l, h, f_term):
    """Aniso GGX refraction with the eta^2 Jacobian (``brdf.hlsl:72-93``)."""
    lz, vz = l[2], v[2]
    l_dot_h = vdot(l, h)
    v_dot_h = vdot(v, h)
    d = gtr2_aniso(h[2], h[0], h[1], mat.ax, mat.ay)
    g1 = smith_g_aniso(torch.abs(vz), v[0], v[1], mat.ax, mat.ay)
    g2 = g1 * smith_g_aniso(torch.abs(lz), l[0], l[1], mat.ax, mat.ay)
    dn = l_dot_h + v_dot_h * eta
    denom = dn * dn
    eta2 = eta * eta
    jacobian = safe_div(torch.abs(l_dot_h), denom)
    pdf = safe_div(g1 * torch.clamp_min(v_dot_h, 0.0) * d * jacobian, vz)
    coef1 = d * g2 * torch.abs(v_dot_h) * jacobian * eta2
    coef2 = safe_div(torch.ones_like(lz), torch.abs(lz * vz))
    f = tuple(sqrt(torch.clamp_min(mat.base_color[c], 0.0)) * (1.0 - f_term)
              * coef1 * coef2 for c in range(3))
    valid = lz < 0.0
    zero = torch.zeros_like(lz)
    return vwhere(valid, f, (zero, zero, zero)), torch.where(valid, pdf, zero)


def eval_clearcoat(mat: Material, v, l, h):
    """GTR1 clearcoat lobe (``brdf.hlsl:95-112``)."""
    lz, vz = l[2], v[2]
    v_dot_h = vdot(v, h)
    f = 0.04 + 0.96 * schlick_weight(v_dot_h)
    d = gtr1(h[2], mat.clearcoat_roughness)
    quarter = torch.full_like(lz, 0.25)
    g = smith_g(lz, quarter) * smith_g(vz, quarter)
    jacobian = safe_div(torch.ones_like(lz), 4.0 * v_dot_h)
    pdf = d * h[2] * jacobian
    valid = lz > 0.0
    zero = torch.zeros_like(lz)
    fo_s = torch.where(valid, f * d * g, zero)
    return (fo_s, fo_s, fo_s), torch.where(valid, pdf, zero)


def eval_brdf_local(mat: Material, v, l, probs):
    """Lobe sum in tangent space (``brdf.hlsl:114-225``), ``probs`` from
    ``lobe_probabilities(mat, v)``; ``f`` comes multiplied by ``|l.z|``."""
    lz, vz = l[2], v[2]
    h_refl = vnormalize(vadd(l, v))
    h_refr = vnormalize((l[0] + v[0] * mat.eta, l[1] + v[1] * mat.eta,
                         l[2] + v[2] * mat.eta))
    h = vwhere(lz > 0.0, h_refl, h_refr)
    h = vwhere(h[2] < 0.0, vneg(h), h)

    ((diff_pr, dielectric_pr, metal_pr, glass_pr, clearcoat_pr),
     (dielectric_wt, metal_wt, glass_wt), (f0, csheen, cspec0)) = probs

    reflect_side = lz * vz > 0.0
    v_dot_h = torch.abs(vdot(v, h))
    zero = torch.zeros_like(lz)

    fd, pd = eval_diffuse(mat, csheen, v, l, h)
    gate = (diff_pr > 0.0) & reflect_side
    f = vadd((zero, zero, zero), _gate3(gate, fd, dielectric_wt))
    pdf = zero + torch.where(gate, pd * diff_pr, zero)

    inv_eta = safe_div(torch.ones_like(lz), mat.ior)
    fres = safe_div(dielectric_fresnel(v_dot_h, inv_eta) - f0, 1.0 - f0)
    fres = torch.where((f0 != 1.0) & (mat.ior != 0.0), fres, zero)
    f_term = tuple(cspec0[c] + (1.0 - cspec0[c]) * fres for c in range(3))
    fr, pr = eval_microfacet_reflection(mat, v, l, h, f_term)
    gate = (dielectric_pr > 0.0) & reflect_side
    f = vadd(f, _gate3(gate, fr, dielectric_wt))
    pdf = pdf + torch.where(gate, pr * dielectric_pr, zero)

    sw_vh = schlick_weight(v_dot_h)
    bc = mat.base_color
    f_metal = tuple(bc[c] + (1.0 - bc[c]) * sw_vh for c in range(3))
    fm, pm = eval_microfacet_reflection(mat, v, l, h, f_metal)
    gate = (metal_pr > 0.0) & reflect_side
    f = vadd(f, _gate3(gate, fm, metal_wt))
    pdf = pdf + torch.where(gate, pm * metal_pr, zero)

    f_glass = dielectric_fresnel(v_dot_h, mat.eta)
    fgr, pgr = eval_microfacet_reflection(mat, v, l, h, (f_glass, f_glass, f_glass))
    fgt, pgt = eval_microfacet_refraction(mat, mat.eta, v, l, h, f_glass)
    gate = glass_pr > 0.0
    fg = vwhere(reflect_side, fgr, fgt)
    f = vadd(f, _gate3(gate, fg, glass_wt))
    pdf = pdf + torch.where(gate, torch.where(reflect_side, pgr * glass_pr * f_glass,
                                              pgt * glass_pr * (1.0 - f_glass)), zero)

    fc, pc = eval_clearcoat(mat, v, l, h)
    gate = (clearcoat_pr > 0.0) & reflect_side
    f = vadd(f, _gate3(gate, fc, 0.25 * mat.clearcoat))
    pdf = pdf + torch.where(gate, pc * clearcoat_pr, zero)

    if mat.occlusion is not None:
        f = vscale(f, mat.occlusion)
    alz = torch.abs(lz)
    return (f[0] * alz, f[1] * alz, f[2] * alz), pdf


def sample_brdf_local(mat: Material, onb, v, probs, state):
    """Importance-sample a direction (``brdf.hlsl:240-340``) from the
    tangent-space ``v``; draws r1, r2, r3 in the reference's order.
    Returns ``(f, l_world, pdf, state)``."""
    (r1, r2, r3), state = urng.random_floats(state, 3)

    (diff_pr, dielectric_pr, metal_pr, glass_pr, _cc_pr), _, _ = probs
    cdf0 = diff_pr
    cdf1 = cdf0 + dielectric_pr
    cdf2 = cdf1 + metal_pr
    cdf3 = cdf2 + glass_pr

    l_diff = cosine_sample_hemisphere(r1, r2)
    h_ggx = sample_ggx_vndf(v, mat.ax, mat.ay, r1, r2)
    h_ggx = vwhere(h_ggx[2] < 0.0, vneg(h_ggx), h_ggx)
    l_spec = vnormalize(vreflect(vneg(v), h_ggx))

    f_glass = dielectric_fresnel(torch.abs(vdot(v, h_ggx)), mat.eta)
    r3_rescaled = safe_div(r3 - cdf2, cdf3 - cdf2)
    l_refr = vnormalize(vrefract(vneg(v), h_ggx, mat.eta))
    l_glass = vwhere(r3_rescaled < f_glass, l_spec, l_refr)

    h_cc = sample_gtr1(mat.clearcoat_roughness, r1, r2)
    h_cc = vwhere(h_cc[2] < 0.0, vneg(h_cc), h_cc)
    l_cc = vnormalize(vreflect(vneg(v), h_cc))

    l = vwhere(r3 < cdf0, l_diff,
               vwhere(r3 < cdf2, l_spec, vwhere(r3 < cdf3, l_glass, l_cc)))
    f, pdf = eval_brdf_local(mat, v, l, probs)
    return f, to_world(onb, l), pdf, state


def eval_brdf(mat: Material, v_world, n, l_world):
    """``(f, pdf)`` for world-space V/N/L (``brdf.hlsl:227-238``)."""
    onb = build_onb(n)
    v = to_local(onb, v_world)
    return eval_brdf_local(mat, v, to_local(onb, l_world), lobe_probabilities(mat, v))


def sample_brdf(mat: Material, v_world, n, state):
    """``(f, l_world, pdf, state)`` about the world-space normal ``n``."""
    onb = build_onb(n)
    v = to_local(onb, v_world)
    return sample_brdf_local(mat, onb, v, lobe_probabilities(mat, v), state)
