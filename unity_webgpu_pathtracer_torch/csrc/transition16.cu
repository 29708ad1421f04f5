// Fused-integrator transition step (shade / env NEE / BSDF / Russian
// roulette), one thread per lane, in two instantiations:
// transition16_launch (the hit's attribute row given as 15 decoded f32
// planes, shade_row) and transition16_attr_raw_launch (the raw attribute
// table and each lane's row index: the kernel loads the lane's 32-byte row
// and decodes its f16 normals itself).
//
// Replaces: unity_webgpu_pathtracer_tpu/ops/pallas_transition.py::_transition_kernel
// (reached from transition_step16_pallas), shade_row form (attr_raw=False)
// and attr_raw form (attr_raw=True).  The reference's attr_raw input is a
// pre-gathered 64-byte pair of rows plus a parity plane; the port stores
// one triangle per 32-byte row, so the pair and the parity collapse to
// "row attr of the table", loaded here as K1 loads its node row.
//
// What bounds it on an H100: memory traffic.  Each lane reads ~95 words of
// state and pre-gathered inputs and writes ~50, all lane-contiguous
// (coalesced); the per-lane arithmetic (a Disney BSDF evaluated twice, a
// handful of sin/cos/log/pow) is a few hundred flops.  Branch divergence
// is the second cost: lanes sit in different modes.  The attr_raw form
// reads 1 index plane and a 32-byte row per lane in place of 15 planes.
//
// First design: a direct per-lane transcription of the reference kernel
// body, every branch evaluated and merged by selects exactly as the
// reference's planes code does, so the RNG stream (native uint32 PCG,
// five draws per lane and call with Russian roulette) and every rounding
// match the plain twin (ops/cuda_transition.py::transition_step16_plain)
// under -fmad=false.  Making it branch and skip dead work is later work.
//
// Constants come from the Python side as -D macros (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))

struct TransitionArgs {
  // inputs: (B,) columns and (R, B) planes
  const int* mode;
  const unsigned char* trav_done;
  const int* ptr;
  const int* pend;
  const int* sp;
  const float* t;
  const float* u;
  const float* v;
  const int* tri;
  const unsigned char* found;
  const float* trav_o;
  const float* trav_d;
  const float* path_o;
  const float* path_d;
  const float* hit_t;
  const float* hit_bary;   // (2, B)
  const int* hit_tri;
  const float* pending;
  const float* throughput;
  const float* radiance;
  const long long* rng;    // uint32 values
  const int* depth;
  const float* max_rough;
  const float* prev_pdf;
  const int* lane_cap;
  const float* mdata;      // (22, B)
  const float* sky_col;
  const float* sky_pdf;
  const float* env_dir;
  const float* env_li;
  const float* env_pdf;
  // the hit's attribute row: one of the two forms, the other null
  const float* shade_row;  // (15, B) decoded planes
  const int* attr_table;   // (T, 8) raw rows, 16-byte aligned
  const int* attr;         // (B,) row index of each lane
  const float* firefly_max;  // (1,) or null
  // outputs
  int* o_mode;
  int* o_ptr;
  int* o_pend;
  int* o_sp;
  float* o_t;
  float* o_u;
  float* o_v;
  int* o_tri;
  unsigned char* o_found;
  float* o_trav_o;
  float* o_trav_d;
  float* o_path_o;
  float* o_path_d;
  float* o_hit_t;
  float* o_hit_bary;
  int* o_hit_tri;
  float* o_pending;
  float* o_throughput;
  float* o_radiance;
  float* o_rad_out;
  long long* o_rng;
  int* o_depth;
  float* o_max_rough;
  float* o_prev_pdf;
  int* o_lane_cap;
  unsigned char* o_died;
  int* o_nray;
  int b;
  int use_rr;
  int max_bounces;
  int firefly;
  int nan_canary;
};

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
__device__ __forceinline__ float sel(bool m, float a, float b) { return m ? a : b; }
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
  const float d = (a2 - 1.0f) / (F(3.14159265358979323) * logf(a2) * t);
  return a >= 1.0f ? F(0.31830988618379067) : d;
}
__device__ __forceinline__ float gtr2_aniso(float n_dot_h, float h_dot_x, float h_dot_y,
                                            float ax, float ay) {
  const float a = h_dot_x / ax;
  const float b = h_dot_y / ay;
  const float c = a * a + b * b + n_dot_h * n_dot_h;
  return 1.0f / (F(3.14159265358979323) * ax * ay * c * c);
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
  const float phi = F(6.28318530717958648) * r2;
  const float x = r * cosf(phi);
  const float y = r * sinf(phi);
  const float z = sqrtf(jmax(1.0f - x * x - y * y, 0.0f));
  return v3(x, y, z);
}
__device__ __forceinline__ V3 sample_gtr1(float rgh, float r1, float r2) {
  const float a = jmax(rgh, F(0.001));
  const float a2 = a * a;
  const float phi = r1 * F(6.28318530717958648);
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
  const float phi = F(6.28318530717958648) * r2;
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
  const float ip = F(0.31830988618379067);
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

__device__ __forceinline__ void sample_brdf(const Mat& m, const Onb& onb, V3 v, const Probs& p,
                                            uint32_t& state, V3& f, V3& l_world, float& pdf) {
  const float r1 = rand_f32(state);
  const float r2 = rand_f32(state);
  const float r3 = rand_f32(state);
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

  const V3 l = vsel(r3 < cdf0, l_diff,
                    vsel(r3 < cdf2, l_spec, vsel(r3 < cdf3, l_glass, l_cc)));
  eval_brdf_local(m, v, l, p, f, pdf);
  l_world = to_world(onb, l);
}

// f16 halfword (0..65535) -> f32 in integer steps, the reference's
// _f16_decode: exact for every pattern, NaN payloads included.
__device__ __forceinline__ float f16_decode(unsigned int h) {
  const unsigned int s = (h >> 15) & 1u, e = (h >> 10) & 0x1Fu, m = h & 0x3FFu;
  const unsigned int bits = e == 31u ? (s << 31) | (0xFFu << 23) | (m << 13)
                                     : (s << 31) | ((e + 112u) << 23) | (m << 13);
  const float mf = (float)m * F(5.9604644775390625e-08);  // m * 2^-24, exact
  return e == 0u ? (s ? -mf : mf) : __uint_as_float(bits);
}

__device__ __forceinline__ V3 ld3(const float* p, int i, int B) {
  return v3(p[i], p[B + i], p[2 * B + i]);
}
__device__ __forceinline__ void st3(float* p, int i, int B, V3 v) {
  p[i] = v.x;
  p[B + i] = v.y;
  p[2 * B + i] = v.z;
}

template <bool ATTR_RAW>
__global__ void transition16_kernel(TransitionArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.b) return;
  const int B = A.b;

  const int mode = A.mode[i];
  const bool trav_done = A.trav_done[i] != 0;
  const bool found = A.found[i] != 0;
  const float t_in = A.t[i], u_in = A.u[i], v_in = A.v[i];
  const int tri_in = A.tri[i];
  V3 path_o = ld3(A.path_o, i, B);
  V3 path_d = ld3(A.path_d, i, B);
  V3 pending = ld3(A.pending, i, B);
  V3 throughput = ld3(A.throughput, i, B);
  V3 radiance = ld3(A.radiance, i, B);
  const int depth = A.depth[i];
  uint32_t rng = (uint32_t)A.rng[i];
  const float prev_pdf_in = A.prev_pdf[i];
  const float max_rough_in = A.max_rough[i];

  const bool shadow_done = trav_done || found;
  const bool a = (mode == UWPT_MODE_PRIMARY) && trav_done;
  const bool hit_valid = tri_in >= 0;

  // --- miss -> sky with MIS ---
  const V3 sky_col = ld3(A.sky_col, i, B);
  const float mis = depth > 0 ? power_heuristic(prev_pdf_in, A.sky_pdf[i]) : 1.0f;
  const bool miss = a && !hit_valid;
  const bool g_miss = miss && (mis > 0.0f);
  radiance = v3(radiance.x + (g_miss ? mis * sky_col.x * throughput.x : 0.0f),
                radiance.y + (g_miss ? mis * sky_col.y * throughput.y : 0.0f),
                radiance.z + (g_miss ? mis * sky_col.z * throughput.z : 0.0f));

  bool shade = a && hit_valid;

  // --- hit frame: normal interpolated from the gathered attr row ---
  const float hb0_in = A.hit_bary[i], hb1_in = A.hit_bary[B + i];
  const float b0 = a ? u_in : hb0_in;
  const float b1 = a ? v_in : hb1_in;
  const float sel_t = a ? t_in : A.hit_t[i];
  float sr[9];
  if (ATTR_RAW) {
    // The lane's 32-byte row: halfword k (k < 9) of word k / 2, low first.
    const int4* row = reinterpret_cast<const int4*>(A.attr_table) + (size_t)A.attr[i] * 2;
    const int4 q0 = __ldg(row), q1 = __ldg(row + 1);
    const unsigned int w[5] = {(unsigned int)q0.x, (unsigned int)q0.y, (unsigned int)q0.z,
                               (unsigned int)q0.w, (unsigned int)q1.x};
#pragma unroll
    for (int k = 0; k < 9; ++k) sr[k] = f16_decode((w[k >> 1] >> (16 * (k & 1))) & 0xFFFFu);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) sr[k] = A.shade_row[(size_t)k * B + i];
  }
  const float w0 = 1.0f - b0 - b1;
  const V3 normal = vnormalize(v3(sr[0] * w0 + sr[3] * b0 + sr[6] * b1,
                                  sr[1] * w0 + sr[4] * b0 + sr[7] * b1,
                                  sr[2] * w0 + sr[5] * b0 + sr[8] * b1));

  // --- material derivation (material.hlsl:84-137, untextured) ---
  float md[22];
#pragma unroll
  for (int k = 0; k < 22; ++k) md[k] = A.mdata[(size_t)k * B + i];
  const float opacity = md[3];
  const float rough_m = jmax(md[9], F(0.001));
  const float ior = clip(md[11], F(1.001), 2.0f);
  const float aniso = clip(md[13], F(-0.9), F(0.9));
  const float aspect = sqrtf(1.0f - aniso * F(0.9));
  const bool entering = (path_d.x * normal.x + path_d.y * normal.y + path_d.z * normal.z) < 0.0f;
  const float max_rough = shade ? jmax(max_rough_in, rough_m) : max_rough_in;
  Mat m;
  m.bc = v3(md[0], md[1], md[2]);
  m.roughness = max_rough;
  m.subsurface = md[18];
  m.spec_tint = md[15];
  m.sheen = md[16];
  m.sheen_tint = md[17];
  m.clearcoat = md[19];
  m.cc_rough = F(0.1) + F(0.001 - 0.1) * md[20];
  m.spec_trans = 1.0f - clip(opacity, 0.0f, 1.0f);
  m.ior = ior;
  m.metallic = md[8];
  m.ax = jmax(max_rough / aspect, F(0.001));
  m.ay = jmax(max_rough * aspect, F(0.001));
  m.eta = entering ? 1.0f / ior : ior;
  const int alpha_mode = (int)md[12];
  const float alpha_cutoff = md[7];
  const V3 emission = v3(md[4], md[5], md[6]);
  const float nd = normal.x * path_d.x + normal.y * path_d.y + normal.z * path_d.z;
  const V3 ffnormal = nd <= 0.0f ? normal : vneg(normal);
  const V3 position = v3(path_o.x + sel_t * path_d.x, path_o.y + sel_t * path_d.y,
                         path_o.z + sel_t * path_d.z);
  const V3 scatter_pos = v3(position.x + normal.x * UWPT_SURF_EPSILON,
                            position.y + normal.y * UWPT_SURF_EPSILON,
                            position.z + normal.z * UWPT_SURF_EPSILON);

  radiance = v3(radiance.x + (shade ? emission.x * throughput.x : 0.0f),
                radiance.y + (shade ? emission.y * throughput.y : 0.0f),
                radiance.z + (shade ? emission.z * throughput.z : 0.0f));
  const bool over_budget = depth >= A.max_bounces;
  const bool ended_budget = shade && over_budget;
  shade = shade && !over_budget;

  // --- alpha passthrough (pathtrace.hlsl:84-89) ---
  const float u_alpha = rand_f32(rng);
  const bool passthrough = shade && (((alpha_mode == 2) && (opacity < alpha_cutoff)) ||
                                     ((alpha_mode == 1) && (u_alpha > opacity)));
  shade = shade && !passthrough;

  // --- shadow traversal finished -> apply the pending contribution ---
  const bool env_done = (mode == UWPT_MODE_SHADOW_ENV) && shadow_done;
  const bool g_app = env_done && !found;
  radiance = v3(radiance.x + (g_app ? pending.x * throughput.x : 0.0f),
                radiance.y + (g_app ? pending.y * throughput.y : 0.0f),
                radiance.z + (g_app ? pending.z * throughput.z : 0.0f));
  const bool to_env = shade;
  const bool to_bsdf = env_done;

  const Onb onb = build_onb(ffnormal);
  const V3 v_local = to_local(onb, vneg(path_d));
  const Probs probs = lobe_probabilities(m, v_local);

  // --- env NEE evaluation (light.hlsl:125-158) ---
  const V3 env_dir = ld3(A.env_dir, i, B);
  const V3 env_li = ld3(A.env_li, i, B);
  const float env_pdf = A.env_pdf[i];
  const V3 l_env = to_local(onb, env_dir);
  V3 f_u;
  float bpdf_u;
  eval_brdf_local(m, v_local, l_env, probs, f_u, bpdf_u);
  const float mis_e = power_heuristic(env_pdf, bpdf_u);
  const float epdf_den = jmax(env_pdf, F(1e-20));
  const V3 contrib = v3(mis_e * env_li.x * f_u.x / epdf_den, mis_e * env_li.y * f_u.y / epdf_den,
                        mis_e * env_li.z * f_u.z / epdf_den);
  const bool ok = (bpdf_u > 0.0f) && (env_pdf > 0.0f) && (mis_e > 0.0f);
  pending = to_env ? (ok ? contrib : v3(0.0f, 0.0f, 0.0f)) : pending;

  // Fresh shadow segment at the root for to_env lanes.
  V3 trav_o = to_env ? scatter_pos : ld3(A.trav_o, i, B);
  V3 trav_d = to_env ? env_dir : ld3(A.trav_d, i, B);
  int ptr = to_env ? 0 : A.ptr[i];
  int pend = to_env ? UWPT_TRAV_FULL : A.pend[i];
  int sp = to_env ? 0 : A.sp[i];
  float t_out = to_env ? UWPT_FAR_PLANE : t_in;
  float u_out = to_env ? 0.0f : u_in;
  float v_out = to_env ? 0.0f : v_in;
  int tri_out = to_env ? -1 : tri_in;
  bool found_out = found && !to_env;
  int new_mode = to_env ? UWPT_MODE_SHADOW_ENV : mode;

  // --- BSDF sample + Russian roulette -> next bounce or death ---
  V3 f_s, l_s;
  float pdf_s;
  sample_brdf(m, onb, v_local, probs, rng, f_s, l_s, pdf_s);
  const bool nan_lane = (f_s.x != f_s.x) || (f_s.y != f_s.y) || (f_s.z != f_s.z) ||
                        (pdf_s != pdf_s);
  const bool sample_ok = to_bsdf && !nan_lane && (pdf_s > 0.0f);
  const float pdf_den = jmax(pdf_s, F(1e-20));
  if (sample_ok) {
    throughput = v3(throughput.x * f_s.x / pdf_den, throughput.y * f_s.y / pdf_den,
                    throughput.z * f_s.z / pdf_den);
  }
  bool continue_ray = sample_ok;
  if (A.use_rr) {
    const float u_rr = rand_f32(rng);
    const float t_max3 = jmax(jmax(throughput.x, throughput.y), throughput.z);
    const float p_cont = jmin(t_max3 + F(0.001), F(0.95));
    const bool rr_kill = continue_ray && (u_rr >= p_cont);
    if (continue_ray && !rr_kill) {
      throughput = v3(throughput.x / p_cont, throughput.y / p_cont, throughput.z / p_cont);
    }
    continue_ray = continue_ray && !rr_kill;
  }

  const bool processed = a || env_done;
  const int cap = A.lane_cap[i];
  const bool cap_exhausted = processed && (cap <= 0);
  const bool died = miss || ended_budget || (to_bsdf && !continue_ray) || cap_exhausted;

  V3 rad_out = radiance;
  if (A.firefly) {
    const float l = lum(rad_out);
    const float ffly = A.firefly_max[0];
    const float scale = l > ffly ? ffly / jmax(l, F(1e-20)) : 1.0f;
    rad_out = vscale(rad_out, scale);
  }
  if (A.nan_canary && to_bsdf && nan_lane) {
    rad_out = v3(0.0f, 1.0f, 0.0f);
  }

  // --- continuing bounce: new primary ray ---
  const V3 new_dir = passthrough ? path_d : l_s;
  const bool bounce = (continue_ray || passthrough) && !died;
  const V3 new_origin = v3(position.x + new_dir.x * UWPT_SURF_EPSILON,
                           position.y + new_dir.y * UWPT_SURF_EPSILON,
                           position.z + new_dir.z * UWPT_SURF_EPSILON);
  if (bounce) {
    path_o = new_origin;
    path_d = new_dir;
    trav_o = path_o;
    trav_d = path_d;
    ptr = 0;
    pend = UWPT_TRAV_FULL;
    sp = 0;
    t_out = UWPT_FAR_PLANE;
    u_out = 0.0f;
    v_out = 0.0f;
    tri_out = -1;
    found_out = false;
  }
  new_mode = bounce ? UWPT_MODE_PRIMARY : (died ? UWPT_MODE_DEAD : new_mode);

  const bool saved = shade || passthrough;
  A.o_mode[i] = new_mode;
  A.o_ptr[i] = ptr;
  A.o_pend[i] = pend;
  A.o_sp[i] = sp;
  A.o_t[i] = t_out;
  A.o_u[i] = u_out;
  A.o_v[i] = v_out;
  A.o_tri[i] = tri_out;
  A.o_found[i] = found_out ? 1 : 0;
  st3(A.o_trav_o, i, B, trav_o);
  st3(A.o_trav_d, i, B, trav_d);
  st3(A.o_path_o, i, B, path_o);
  st3(A.o_path_d, i, B, path_d);
  A.o_hit_t[i] = saved ? t_in : A.hit_t[i];
  A.o_hit_bary[i] = saved ? u_in : hb0_in;
  A.o_hit_bary[B + i] = saved ? v_in : hb1_in;
  A.o_hit_tri[i] = saved ? tri_in : A.hit_tri[i];
  st3(A.o_pending, i, B, pending);
  st3(A.o_throughput, i, B, throughput);
  st3(A.o_radiance, i, B, radiance);
  st3(A.o_rad_out, i, B, rad_out);
  A.o_rng[i] = (long long)rng;
  A.o_depth[i] = continue_ray ? depth + 1 : depth;
  A.o_max_rough[i] = max_rough;
  A.o_prev_pdf[i] = to_bsdf ? pdf_s : prev_pdf_in;
  A.o_lane_cap[i] = processed ? cap - 1 : cap;
  A.o_died[i] = died ? 1 : 0;
  A.o_nray[i] = (bounce ? 1 : 0) + (to_env ? 1 : 0);
}

template <bool ATTR_RAW>
static int launch(const TransitionArgs* args, void* stream) {
  const int threads = 128;
  const int blocks = (args->b + threads - 1) / threads;
  if (blocks > 0) {
    transition16_kernel<ATTR_RAW><<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int transition16_launch(const TransitionArgs* args, void* stream) {
  return launch<false>(args, stream);
}

extern "C" int transition16_attr_raw_launch(const TransitionArgs* args, void* stream) {
  return launch<true>(args, stream);
}

// Check entry: the kernel's f16 decode of n halfwords and its uint32 ->
// f32 uniform (rand_f32's conversion and scale) of m states, so both can
// be held against numpy over every f16 pattern and the uint32 edge cases.
__global__ void decode_check_kernel(const int* half, float* half_out, int n,
                                    const long long* u32, float* u32_out, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) half_out[i] = f16_decode((unsigned int)half[i] & 0xFFFFu);
  if (i < m) u32_out[i] = __uint2float_rn((uint32_t)u32[i]) * F(1.0 / 4294967295.0);
}

extern "C" int transition16_decode_check(const int* half, float* half_out, int n,
                                         const long long* u32, float* u32_out, int m,
                                         void* stream) {
  const int threads = 256;
  const int blocks = ((n > m ? n : m) + threads - 1) / threads;
  if (blocks > 0) {
    decode_check_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(half, half_out, n, u32,
                                                                        u32_out, m);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
