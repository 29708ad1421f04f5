// Device code shared by the transition kernel (transition16.cu) and the
// megakernel's shading kernel (shade16.cu): lane vectors, the NaN-propagating
// min/max of PyTorch and jnp, the Disney BSDF with its lobe pick, the
// orthonormal frame, PCG and the samplers, and the environment's
// solid-angle pdf.  Every function rounds as its plain PyTorch counterpart
// in render/bsdf.py, render/sampling.py, utils/math.py and utils/rng.py
// does under -fmad=false: numpy-rounded literals, the plain code's
// operation order.  Both kernels' plain twins shade through those modules,
// so a change here is a change to both kernels.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))
#define PI_D 3.14159265358979323
#define INV_PI_D 0.31830988618379067
#define TWO_PI_D 6.28318530717958648
#define INV_TWO_PI_D 0.15915494309189533

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
// jnp.minimum / jnp.maximum / jnp.clip: NaN-propagating.
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
__device__ __forceinline__ V3 vsel(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ float vdot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 vscale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 vneg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 vadd(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 vnormalize(V3 v) {
  return vscale(v, 1.0f / sqrtf(jmax(vdot(v, v), F(1.0e-20))));
}
__device__ __forceinline__ V3 vreflect(V3 i, V3 n) {
  const float d = vdot(i, n);
  return v3(i.x - 2.0f * d * n.x, i.y - 2.0f * d * n.y, i.z - 2.0f * d * n.z);
}
__device__ __forceinline__ V3 vrefract(V3 i, V3 n, float eta) {
  const float cos_i = -vdot(i, n);
  const float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  const float coef = eta * cos_i - sqrtf(jmax(k, 0.0f));
  const V3 refr = v3(eta * i.x + coef * n.x, eta * i.y + coef * n.y, eta * i.z + coef * n.z);
  return vsel(k < 0.0f, v3(0.0f, 0.0f, 0.0f), refr);
}
__device__ __forceinline__ float lum(V3 c) {
  return c.x * F(0.299) + c.y * F(0.587) + c.z * F(0.114);
}
__device__ __forceinline__ float safe_div(float a, float b) {
  const float eps = F(1e-20);
  return a / (fabsf(b) < eps ? (b < 0.0f ? -eps : eps) : b);
}
__device__ __forceinline__ float nz(float x) { return x == 0.0f ? 1.0f : x; }
__device__ __forceinline__ float schlick_weight(float u) {
  const float m = clip(1.0f - u, 0.0f, 1.0f);
  const float m2 = m * m;
  return m2 * m2 * m;
}
__device__ __forceinline__ float dielectric_fresnel(float cos_theta_i, float eta) {
  const float sin2_t = eta * eta * (1.0f - cos_theta_i * cos_theta_i);
  const float cos_t = sqrtf(jmax(1.0f - sin2_t, 0.0f));
  const float rs = (eta * cos_t - cos_theta_i) / nz(eta * cos_t + cos_theta_i);
  const float rp = (eta * cos_theta_i - cos_t) / nz(eta * cos_theta_i + cos_t);
  const float f = 0.5f * (rs * rs + rp * rp);
  return sin2_t > 1.0f ? 1.0f : f;
}
__device__ __forceinline__ float smith_g(float n_dot_v, float alpha_g) {
  const float a = alpha_g * alpha_g;
  const float b = n_dot_v * n_dot_v;
  return (2.0f * n_dot_v) / (n_dot_v + sqrtf(jmax(a + b - a * b, 0.0f)));
}
__device__ __forceinline__ float smith_g_aniso(float n_dot_v, float v_dot_x, float v_dot_y,
                                               float ax, float ay) {
  const float a = v_dot_x * ax;
  const float b = v_dot_y * ay;
  const float c = n_dot_v;
  return (2.0f * n_dot_v) / (n_dot_v + sqrtf(jmax(a * a + b * b + c * c, 0.0f)));
}
__device__ __forceinline__ float gtr1(float n_dot_h, float a) {
  const float a2 = a * a;
  const float t = 1.0f + (a2 - 1.0f) * n_dot_h * n_dot_h;
  const float d = (a2 - 1.0f) / (F(PI_D) * logf(a2) * t);
  return a >= 1.0f ? F(INV_PI_D) : d;
}
__device__ __forceinline__ float gtr2_aniso(float n_dot_h, float h_dot_x, float h_dot_y,
                                            float ax, float ay) {
  const float a = h_dot_x / ax;
  const float b = h_dot_y / ay;
  const float c = a * a + b * b + n_dot_h * n_dot_h;
  return 1.0f / (F(PI_D) * ax * ay * c * c);
}
__device__ __forceinline__ float power_heuristic(float a, float b) {
  const float t = a * a;
  return t / nz(b * b + t);
}

struct Onb {
  V3 x, y, z;
};

__device__ __forceinline__ Onb build_onb(V3 z) {
  const float len_sq = vdot(z, z);
  const V3 zn = vnormalize(z);
  const float k = 1.0f / jmax(1.0f + zn.z, F(1.0e-5));
  const float a = zn.y * k;
  const float b = zn.y * a;
  const float c = -zn.x * a;
  const V3 x = vnormalize(v3(zn.z + b, c, -zn.x));
  const V3 y = vnormalize(v3(c, 1.0f - b, -zn.y));
  const bool deg = len_sq == 0.0f;
  return Onb{vsel(deg, v3(1.0f, 0.0f, 0.0f), x), vsel(deg, v3(0.0f, 1.0f, 0.0f), y),
             vsel(deg, v3(0.0f, 0.0f, 1.0f), zn)};
}
__device__ __forceinline__ V3 to_local(const Onb& o, V3 w) {
  return v3(vdot(o.x, w), vdot(o.y, w), vdot(o.z, w));
}
__device__ __forceinline__ V3 to_world(const Onb& o, V3 l) {
  return v3(o.x.x * l.x + o.y.x * l.y + o.z.x * l.z,
            o.x.y * l.x + o.y.y * l.y + o.z.y * l.z,
            o.x.z * l.x + o.y.z * l.y + o.z.z * l.z);
}

// PCG (random.hlsl:5-16) in native uint32.
__device__ __forceinline__ uint32_t pcg_next(uint32_t state) {
  const uint32_t old = state + 747796405u + 2891336453u;
  const uint32_t shift = (old >> 28) + 4u;
  const uint32_t word = ((old >> shift) ^ old) * 277803737u;
  return (word >> 22) ^ word;
}
__device__ __forceinline__ float rand_f32(uint32_t& state) {
  state = pcg_next(state);
  return __uint2float_rn(state) * F(1.0 / 4294967295.0);
}

__device__ __forceinline__ V3 cosine_sample_hemisphere(float r1, float r2) {
  const float r = sqrtf(r1);
  const float phi = F(TWO_PI_D) * r2;
  const float x = r * cosf(phi);
  const float y = r * sinf(phi);
  const float z = sqrtf(jmax(1.0f - x * x - y * y, 0.0f));
  return v3(x, y, z);
}
__device__ __forceinline__ V3 sample_gtr1(float rgh, float r1, float r2) {
  const float a = jmax(rgh, F(0.001));
  const float a2 = a * a;
  const float phi = r1 * F(TWO_PI_D);
  const float cos_theta = sqrtf(jmax((1.0f - powf(a2, 1.0f - r2)) / (1.0f - a2), 0.0f));
  const float sin_theta = clip(sqrtf(jmax(1.0f - cos_theta * cos_theta, 0.0f)), 0.0f, 1.0f);
  return v3(sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta);
}
__device__ __forceinline__ V3 sample_ggx_vndf(V3 v, float ax, float ay, float r1, float r2) {
  const V3 vh = vnormalize(v3(ax * v.x, ay * v.y, v.z));
  const float lensq = vh.x * vh.x + vh.y * vh.y;
  const float inv_len = 1.0f / sqrtf(jmax(lensq, F(1e-20)));
  const V3 t1 = lensq > 0.0f ? v3(-vh.y * inv_len, vh.x * inv_len, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  const V3 t2 = vcross(vh, t1);
  const float r = sqrtf(r1);
  const float phi = F(TWO_PI_D) * r2;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.0f + vh.z);
  p2 = (1.0f - s) * sqrtf(jmax(1.0f - p1 * p1, 0.0f)) + s * p2;
  const float p3 = sqrtf(jmax(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const V3 nh = v3(p1 * t1.x + p2 * t2.x + p3 * vh.x, p1 * t1.y + p2 * t2.y + p3 * vh.y,
                   p1 * t1.z + p2 * t2.z + p3 * vh.z);
  return vnormalize(v3(ax * nh.x, ay * nh.y, jmax(nh.z, 0.0f)));
}

struct Mat {
  V3 bc;
  float roughness, subsurface, spec_tint, sheen, sheen_tint, clearcoat, cc_rough;
  float spec_trans, ior, metallic, ax, ay, eta;
};

struct Probs {
  float diff_pr, dielectric_pr, metal_pr, glass_pr, clearcoat_pr;
  float dielectric_wt, metal_wt, glass_wt;
  float f0;
  V3 csheen, cspec0;
};

__device__ __forceinline__ Probs lobe_probabilities(const Mat& m, V3 v) {
  Probs p;
  const float lum_bc = lum(m.bc);
  const float lum_den = jmax(lum_bc, F(1e-20));
  const V3 ctint = lum_bc > 0.0f ? v3(m.bc.x / lum_den, m.bc.y / lum_den, m.bc.z / lum_den)
                                 : v3(1.0f, 1.0f, 1.0f);
  const float f0r = (1.0f - m.eta) / (1.0f + m.eta);
  p.f0 = f0r * f0r;
  p.cspec0 = v3(p.f0 * (1.0f + (ctint.x - 1.0f) * m.spec_tint),
                p.f0 * (1.0f + (ctint.y - 1.0f) * m.spec_tint),
                p.f0 * (1.0f + (ctint.z - 1.0f) * m.spec_tint));
  p.csheen = v3(1.0f + (ctint.x - 1.0f) * m.sheen_tint, 1.0f + (ctint.y - 1.0f) * m.sheen_tint,
                1.0f + (ctint.z - 1.0f) * m.sheen_tint);
  p.dielectric_wt = (1.0f - m.metallic) * (1.0f - m.spec_trans);
  p.metal_wt = m.metallic;
  p.glass_wt = (1.0f - m.metallic) * m.spec_trans;
  const float sw = schlick_weight(v.z);
  const float diff_pr = p.dielectric_wt * lum(m.bc);
  const float dielectric_pr =
      p.dielectric_wt * lum(v3(p.cspec0.x + (1.0f - p.cspec0.x) * sw,
                               p.cspec0.y + (1.0f - p.cspec0.y) * sw,
                               p.cspec0.z + (1.0f - p.cspec0.z) * sw));
  const float metal_pr = p.metal_wt * lum(v3(m.bc.x + (1.0f - m.bc.x) * sw,
                                             m.bc.y + (1.0f - m.bc.y) * sw,
                                             m.bc.z + (1.0f - m.bc.z) * sw));
  const float glass_pr = p.glass_wt;
  const float clearcoat_pr = 0.25f * m.clearcoat;
  const float total = diff_pr + dielectric_pr + metal_pr + glass_pr + clearcoat_pr;
  const float inv_total = safe_div(1.0f, total);
  p.diff_pr = diff_pr * inv_total;
  p.dielectric_pr = dielectric_pr * inv_total;
  p.metal_pr = metal_pr * inv_total;
  p.glass_pr = glass_pr * inv_total;
  p.clearcoat_pr = clearcoat_pr * inv_total;
  return p;
}

__device__ __forceinline__ void eval_diffuse(const Mat& m, V3 csheen, V3 v, V3 l, V3 h,
                                             V3& f, float& pdf) {
  const float lz = l.z, vz = v.z;
  const float l_dot_h = vdot(l, h);
  const float rr = 2.0f * m.roughness * l_dot_h * l_dot_h;
  const float fl = schlick_weight(lz);
  const float fv = schlick_weight(vz);
  const float fretro = rr * (fl + fv + fl * fv * (rr - 1.0f));
  const float fd = (1.0f - 0.5f * fl) * (1.0f - 0.5f * fv);
  const float fss90 = 0.5f * rr;
  const float fss = (1.0f + (fss90 - 1.0f) * fl) * (1.0f + (fss90 - 1.0f) * fv);
  const float ss = 1.25f * (fss * (safe_div(1.0f, lz + vz) - 0.5f) + 0.5f);
  const float fh = schlick_weight(l_dot_h);
  const float coef = (fd + fretro) + (ss - (fd + fretro)) * m.subsurface;
  const float ip = F(INV_PI_D);
  const V3 fv3 = v3(ip * m.bc.x * coef + fh * m.sheen * csheen.x,
                    ip * m.bc.y * coef + fh * m.sheen * csheen.y,
                    ip * m.bc.z * coef + fh * m.sheen * csheen.z);
  const bool valid = lz > 0.0f;
  f = vsel(valid, fv3, v3(0.0f, 0.0f, 0.0f));
  pdf = valid ? lz * ip : 0.0f;
}

__device__ __forceinline__ void eval_microfacet_reflection(const Mat& m, V3 v, V3 l, V3 h,
                                                           V3 f_term, V3& f, float& pdf) {
  const float lz = l.z, vz = v.z;
  const float d = gtr2_aniso(h.z, h.x, h.y, m.ax, m.ay);
  const float g1 = smith_g_aniso(fabsf(vz), v.x, v.y, m.ax, m.ay);
  const float g2 = g1 * smith_g_aniso(fabsf(lz), l.x, l.y, m.ax, m.ay);
  const float p = safe_div(g1 * d, 4.0f * vz);
  const float coef = safe_div(d * g2, 4.0f * lz * vz);
  const bool valid = lz > 0.0f;
  f = vsel(valid, v3(f_term.x * coef, f_term.y * coef, f_term.z * coef), v3(0.0f, 0.0f, 0.0f));
  pdf = valid ? p : 0.0f;
}

__device__ __forceinline__ void eval_microfacet_refraction(const Mat& m, float eta, V3 v, V3 l,
                                                           V3 h, float f_term, V3& f,
                                                           float& pdf) {
  const float lz = l.z, vz = v.z;
  const float l_dot_h = vdot(l, h);
  const float v_dot_h = vdot(v, h);
  const float d = gtr2_aniso(h.z, h.x, h.y, m.ax, m.ay);
  const float g1 = smith_g_aniso(fabsf(vz), v.x, v.y, m.ax, m.ay);
  const float g2 = g1 * smith_g_aniso(fabsf(lz), l.x, l.y, m.ax, m.ay);
  const float dn = l_dot_h + v_dot_h * eta;
  const float denom = dn * dn;
  const float eta2 = eta * eta;
  const float jacobian = safe_div(fabsf(l_dot_h), denom);
  const float p = safe_div(g1 * jmax(v_dot_h, 0.0f) * d * jacobian, vz);
  const float coef1 = d * g2 * fabsf(v_dot_h) * jacobian * eta2;
  const float coef2 = safe_div(1.0f, fabsf(lz * vz));
  const V3 fv3 = v3(sqrtf(jmax(m.bc.x, 0.0f)) * (1.0f - f_term) * coef1 * coef2,
                    sqrtf(jmax(m.bc.y, 0.0f)) * (1.0f - f_term) * coef1 * coef2,
                    sqrtf(jmax(m.bc.z, 0.0f)) * (1.0f - f_term) * coef1 * coef2);
  const bool valid = lz < 0.0f;
  f = vsel(valid, fv3, v3(0.0f, 0.0f, 0.0f));
  pdf = valid ? p : 0.0f;
}

__device__ __forceinline__ void eval_clearcoat(const Mat& m, V3 v, V3 l, V3 h, float& fo,
                                               float& pdf) {
  const float lz = l.z, vz = v.z;
  const float v_dot_h = vdot(v, h);
  const float f = 0.04f + 0.96f * schlick_weight(v_dot_h);
  const float d = gtr1(h.z, m.cc_rough);
  const float g = smith_g(lz, 0.25f) * smith_g(vz, 0.25f);
  const float jacobian = safe_div(1.0f, 4.0f * v_dot_h);
  const float p = d * h.z * jacobian;
  const bool valid = lz > 0.0f;
  fo = valid ? f * d * g : 0.0f;
  pdf = valid ? p : 0.0f;
}

__device__ __forceinline__ V3 gate3(bool gate, V3 f, float wt) {
  return v3(gate ? f.x * wt : 0.0f, gate ? f.y * wt : 0.0f, gate ? f.z * wt : 0.0f);
}

__device__ __forceinline__ void eval_brdf_local(const Mat& m, V3 v, V3 l, const Probs& p,
                                                V3& f_out, float& pdf_out) {
  const float lz = l.z, vz = v.z;
  const V3 h_refl = vnormalize(vadd(l, v));
  const V3 h_refr = vnormalize(v3(l.x + v.x * m.eta, l.y + v.y * m.eta, l.z + v.z * m.eta));
  V3 h = vsel(lz > 0.0f, h_refl, h_refr);
  h = vsel(h.z < 0.0f, vneg(h), h);

  const bool reflect_side = lz * vz > 0.0f;
  const float v_dot_h = fabsf(vdot(v, h));

  V3 fl;
  float pl;
  eval_diffuse(m, p.csheen, v, l, h, fl, pl);
  bool gate = (p.diff_pr > 0.0f) && reflect_side;
  V3 f = vadd(v3(0.0f, 0.0f, 0.0f), gate3(gate, fl, p.dielectric_wt));
  float pdf = 0.0f + (gate ? pl * p.diff_pr : 0.0f);

  const float inv_eta = safe_div(1.0f, m.ior);
  float fres = safe_div(dielectric_fresnel(v_dot_h, inv_eta) - p.f0, 1.0f - p.f0);
  fres = ((p.f0 != 1.0f) && (m.ior != 0.0f)) ? fres : 0.0f;
  const V3 f_term = v3(p.cspec0.x + (1.0f - p.cspec0.x) * fres,
                       p.cspec0.y + (1.0f - p.cspec0.y) * fres,
                       p.cspec0.z + (1.0f - p.cspec0.z) * fres);
  eval_microfacet_reflection(m, v, l, h, f_term, fl, pl);
  gate = (p.dielectric_pr > 0.0f) && reflect_side;
  f = vadd(f, gate3(gate, fl, p.dielectric_wt));
  pdf = pdf + (gate ? pl * p.dielectric_pr : 0.0f);

  const float sw_vh = schlick_weight(v_dot_h);
  const V3 f_metal = v3(m.bc.x + (1.0f - m.bc.x) * sw_vh, m.bc.y + (1.0f - m.bc.y) * sw_vh,
                        m.bc.z + (1.0f - m.bc.z) * sw_vh);
  eval_microfacet_reflection(m, v, l, h, f_metal, fl, pl);
  gate = (p.metal_pr > 0.0f) && reflect_side;
  f = vadd(f, gate3(gate, fl, p.metal_wt));
  pdf = pdf + (gate ? pl * p.metal_pr : 0.0f);

  const float f_glass = dielectric_fresnel(v_dot_h, m.eta);
  V3 fgr, fgt;
  float pgr, pgt;
  eval_microfacet_reflection(m, v, l, h, v3(f_glass, f_glass, f_glass), fgr, pgr);
  eval_microfacet_refraction(m, m.eta, v, l, h, f_glass, fgt, pgt);
  gate = p.glass_pr > 0.0f;
  f = vadd(f, gate3(gate, vsel(reflect_side, fgr, fgt), p.glass_wt));
  pdf = pdf + (gate ? (reflect_side ? pgr * p.glass_pr * f_glass
                                    : pgt * p.glass_pr * (1.0f - f_glass))
                    : 0.0f);

  float fc;
  eval_clearcoat(m, v, l, h, fc, pl);
  gate = (p.clearcoat_pr > 0.0f) && reflect_side;
  f = vadd(f, gate3(gate, v3(fc, fc, fc), 0.25f * m.clearcoat));
  pdf = pdf + (gate ? pl * p.clearcoat_pr : 0.0f);

  const float alz = fabsf(lz);
  f_out = v3(f.x * alz, f.y * alz, f.z * alz);
  pdf_out = pdf;
}

// The lobe pick and direction of sample_brdf (render/bsdf.py), local frame.
__device__ __forceinline__ V3 sample_lobe(const Mat& m, V3 v, const Probs& p, float r1,
                                          float r2, float r3) {
  const float cdf0 = p.diff_pr;
  const float cdf1 = cdf0 + p.dielectric_pr;
  const float cdf2 = cdf1 + p.metal_pr;
  const float cdf3 = cdf2 + p.glass_pr;

  const V3 l_diff = cosine_sample_hemisphere(r1, r2);
  V3 h_ggx = sample_ggx_vndf(v, m.ax, m.ay, r1, r2);
  h_ggx = vsel(h_ggx.z < 0.0f, vneg(h_ggx), h_ggx);
  const V3 l_spec = vnormalize(vreflect(vneg(v), h_ggx));

  const float f_glass = dielectric_fresnel(fabsf(vdot(v, h_ggx)), m.eta);
  const float r3_rescaled = safe_div(r3 - cdf2, cdf3 - cdf2);
  const V3 l_refr = vnormalize(vrefract(vneg(v), h_ggx, m.eta));
  const V3 l_glass = vsel(r3_rescaled < f_glass, l_spec, l_refr);

  V3 h_cc = sample_gtr1(m.cc_rough, r1, r2);
  h_cc = vsel(h_cc.z < 0.0f, vneg(h_cc), h_cc);
  const V3 l_cc = vnormalize(vreflect(vneg(v), h_cc));

  return vsel(r3 < cdf0, l_diff, vsel(r3 < cdf2, l_spec, vsel(r3 < cdf3, l_glass, l_cc)));
}

// scene/envmap.py::_solid_angle_pdf.
__device__ __forceinline__ float solid_angle_pdf(V3 color, float cdf_den, int k,
                                                 float sin_theta) {
  float pdf = lum(color) / cdf_den;
  pdf = pdf * (float)k / jmax(F(TWO_PI_D * PI_D) * sin_theta, F(1e-8));
  return sin_theta <= 0.0f ? 0.0f : pdf;
}

__device__ __forceinline__ V3 ld3(const float* p, int i, int B) {
  return v3(p[i], p[B + i], p[2 * B + i]);
}
__device__ __forceinline__ void st3(float* p, int i, int B, V3 v) {
  p[i] = v.x;
  p[B + i] = v.y;
  p[2 * B + i] = v.z;
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
