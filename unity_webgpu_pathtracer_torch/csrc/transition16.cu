// Fused-integrator transition (environment sample, attribute and material
// fetch, shade / env NEE / BSDF / Russian roulette), one thread per lane,
// in place on the pass's lane state, in two instantiations by attribute
// row: transition16_launch (32-byte rows of f16 normals and uvs,
// attr_compact=2) and transition16_oct_launch (16-byte rows of oct-encoded
// normals, attr_compact=3).
//
// Replaces: unity_webgpu_pathtracer_tpu/ops/pallas_transition.py::_transition_kernel
// (reached from transition_step16_pallas) together with what the
// reference's render/fused.py::_transition_pallas computes for it in XLA
// (:979-1095): scene/envmap.py::sample_env_transition (two uniforms, the
// merged env row, the alias pick, the texel direction, both solid-angle
// pdfs), the intensity scaling, the attribute-row fetch and decode (f16,
// or the oct decode with its per-vertex normalize) and the material
// gather.  The record append and regeneration stay outside.
//
// What bounds it on an H100: instruction issue in the BSDF, not memory.
// Cut by section on a 1080p main-path state (98,304 lanes, ~15 MB of
// traffic, a bytes bound of ~0.0045 ms; the readings are in PERF.md), the
// BSDF evaluation and lobe sample with their frame take over half of the
// ~0.03 ms: five lobes evaluated per lane with IEEE division and
// square roots and no FMA contraction (both needed to round as the plain
// version does), in warps whose lanes take different cases.  The design
// keeps that work to what each lane's case needs.  A lane between
// segments (mid-traversal) changes only its RNG state: it reads mode,
// ptr, found and rng and writes rng and died, 26 bytes.  A lane at a
// finished segment reads the state its case needs and the rows it uses
// (the 80-byte merged env row only at a finished primary segment: its
// alias half on a hit, its bilinear footprint on a miss; the attribute
// and 22-word material rows only where a hit is shaded or a shadow
// segment ends), as 16-byte __ldg vectors, and stores only the fields
// that change; the state is updated in place, so no output plane is
// allocated or copied.  The BSDF is evaluated once per lane, toward the
// env sample on a hit (NEE) or toward the sampled lobe at a finished
// shadow segment: the two lane sets never overlap, so a warp holding both
// runs one evaluation, not two.  The block size is the build constant
// UWPT_K2_THREADS (ops/cuda_transition.py) and nvcc picks the registers:
// the kernel is not bound by occupancy (experiments/k2_variants.py times
// other block sizes and register limits).
//
// Every lane advances its PCG state by every draw the reference makes, in
// its order, used or not: 2 env draws, 1 alpha, 3 BSDF, and 1 RR with
// Russian roulette.  Every rounding follows the plain version
// (ops/cuda_transition.py::transition16_plain: the port's env sample,
// gathers and transition_step16_plain) under -fmad=false: numpy-rounded
// literals, the twin's operation order, PyTorch's CUDA division of a
// tensor by a Python number (a multiply by the f32 reciprocal).
//
// Constants come from the Python side as -D macros (ops/cuda_build.py).

#include "shade_common.cuh"

struct TransitionArgs {
  // lane state, updated in place: (B,) columns and (R, B) planes
  int* mode;
  int* ptr;
  int* pend;
  int* sp;
  float* t;
  float* u;
  float* v;
  int* tri;
  unsigned char* found;
  float* trav_o;
  float* trav_d;
  float* path_o;
  float* path_d;
  float* hit_t;
  float* hit_bary;       // (2, B)
  int* hit_tri;
  float* pending;
  float* throughput;
  float* radiance;
  long long* rng;        // uint32 values
  int* depth;
  float* max_rough;
  float* prev_pdf;
  int* lane_cap;
  unsigned long long* rays;  // () ray starts of the pass, added to atomically
  // per-call outputs
  unsigned char* died;
  float* rad_out;        // (3, B), written where died
  // tables, 16-byte aligned
  const float* env_rows;   // (H*W, 20) [alias row 8 | 2x2 footprint 12]
  const int* attr_rows;    // (T, 8) f16 rows or (T, 4) oct rows
  const float* materials;  // (NM, 32), words 0-21 read
  // device scalars
  const float* cdf_sum;
  const float* rotation;
  const float* intensity;
  const float* firefly_max;
  int b;
  int env_w;
  int env_h;
  int use_rr;
  int max_bounces;
  int firefly;
  int nan_canary;
};

// f16 halfword (0..65535) -> f32 in integer steps, the reference's
// _f16_decode: exact for every pattern, NaN payloads included.
__device__ __forceinline__ float f16_decode(unsigned int h) {
  const unsigned int s = (h >> 15) & 1u, e = (h >> 10) & 0x1Fu, m = h & 0x3FFu;
  const unsigned int bits = e == 31u ? (s << 31) | (0xFFu << 23) | (m << 13)
                                     : (s << 31) | ((e + 112u) << 23) | (m << 13);
  const float mf = (float)m * F(5.9604644775390625e-08);  // m * 2^-24, exact
  return e == 0u ? (s ? -mf : mf) : __uint_as_float(bits);
}

// One 16-bit octahedral word pair -> unit vector (render/hitinfo.py::
// oct_decode, then utils/math.py::normalize).
__device__ __forceinline__ V3 oct_normal(unsigned int w) {
  const float kq = F(2.0 / 65535.0);
  float x = (float)(w & 0xFFFFu) * kq - 1.0f;
  float y = (float)((w >> 16) & 0xFFFFu) * kq - 1.0f;
  const float z = 1.0f - fabsf(x) - fabsf(y);
  const float tf = jmax(-z, 0.0f);
  x = x - (x >= 0.0f ? tf : -tf);
  y = y - (y >= 0.0f ? tf : -tf);
  const float inv = 1.0f / sqrtf(jmax(x * x + y * y + z * z, F(1.0e-20)));
  return v3(x * inv, y * inv, z * inv);
}


// The lane's attribute row: the three vertex normals and the material index.
template <int ATTR>
__device__ __forceinline__ void attr_row(const int* rows, int attr, V3 n[3], int& mat) {
  if (ATTR == 3) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(rows) + attr);
    n[0] = oct_normal((unsigned int)q.x);
    n[1] = oct_normal((unsigned int)q.y);
    n[2] = oct_normal((unsigned int)q.z);
    mat = q.w;
  } else {
    // Halfword k of word k / 2, low first; the material is halfword 15.
    const int4* row = reinterpret_cast<const int4*>(rows) + (size_t)attr * 2;
    const int4 q0 = __ldg(row), q1 = __ldg(row + 1);
    const unsigned int w[5] = {(unsigned int)q0.x, (unsigned int)q0.y, (unsigned int)q0.z,
                               (unsigned int)q0.w, (unsigned int)q1.x};
    float sr[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) sr[k] = f16_decode((w[k >> 1] >> (16 * (k & 1))) & 0xFFFFu);
    n[0] = v3(sr[0], sr[1], sr[2]);
    n[1] = v3(sr[3], sr[4], sr[5]);
    n[2] = v3(sr[6], sr[7], sr[8]);
    mat = (int)(((unsigned int)q1.w >> 16) & 0xFFFFu);
  }
}

template <int ATTR>
__global__ void __launch_bounds__(UWPT_K2_THREADS)
transition16_kernel(TransitionArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.b) return;
  const int B = A.b;

  const int mode = A.mode[i];
  const bool trav_done = A.ptr[i] < 0;
  const bool found = A.found[i] != 0;
  uint32_t rng = (uint32_t)A.rng[i];
  const bool a = (mode == UWPT_MODE_PRIMARY) && trav_done;
  const bool env_done = (mode == UWPT_MODE_SHADOW_ENV) && (trav_done || found);
  unsigned int nray = 0;

  if (!a && !env_done) {
    // Mid-traversal or dead: only the RNG advances, by every draw.
    const int draws = A.use_rr ? 7 : 6;
    for (int k = 0; k < draws; ++k) rng = pcg_next(rng);
    A.rng[i] = (long long)rng;
    A.died[i] = 0;
  } else {
    // --- env sample (scene/envmap.py::sample_env_transition) ---
    const float u1 = rand_f32(rng);
    const float u2 = rand_f32(rng);
    const int depth = A.depth[i];
    const V3 path_d = ld3(A.path_d, i, B);
    V3 throughput = ld3(A.throughput, i, B);
    V3 radiance = ld3(A.radiance, i, B);
    const float prev_pdf_in = A.prev_pdf[i];
    const int cap = A.lane_cap[i];
    const int tri_in = a ? A.tri[i] : -1;
    const bool miss = a && tri_in < 0;
    bool shade = a && tri_in >= 0;
    const int k_env = A.env_w * A.env_h;
    const float cdf_den = jmax(*A.cdf_sum, F(1e-20));
    const float rot = *A.rotation;
    const float inten = *A.intensity;

    // --- miss -> sky with MIS: the bilinear footprint at the direction ---
    V3 sky_col = v3(0.0f, 0.0f, 0.0f);
    float sky_pdf = 0.0f;
    if (miss) {
      const float theta = acosf(clip(path_d.y, -1.0f, 1.0f));
      const float phi_atan = atan2f(path_d.z, path_d.x);
      const float uv0 = (phi_atan + F(PI_D)) * F(INV_TWO_PI_D) + rot;
      const float uv1 = 1.0f - theta * F(INV_PI_D);
      const float x = (uv0 - floorf(uv0)) * (float)A.env_w - 0.5f;
      const float y = (uv1 - floorf(uv1)) * (float)A.env_h - 0.5f;
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = x - x0, fy = y - y0;
      int x0i = (int)x0 % A.env_w, y0i = (int)y0 % A.env_h;
      x0i += x0i < 0 ? A.env_w : 0;
      y0i += y0i < 0 ? A.env_h : 0;
      const float* row = A.env_rows + (size_t)(y0i * A.env_w + x0i) * 20;
      const float4 q2 = ldg4(row + 8), q3 = ldg4(row + 12), q4 = ldg4(row + 16);
      const V3 p00 = v3(q2.x, q2.y, q2.z), p10 = v3(q2.w, q3.x, q3.y);
      const V3 p01 = v3(q3.z, q3.w, q4.x), p11 = v3(q4.y, q4.z, q4.w);
      const float gx = 1.0f - fx, gy = 1.0f - fy;
      const V3 sky = v3((p00.x * gx + p10.x * fx) * gy + (p01.x * gx + p11.x * fx) * fy,
                        (p00.y * gx + p10.y * fx) * gy + (p01.y * gx + p11.y * fx) * fy,
                        (p00.z * gx + p10.z * fx) * gy + (p01.z * gx + p11.z * fx) * fy);
      sky_pdf = solid_angle_pdf(sky, cdf_den, k_env, sinf(theta));
      sky_col = vscale(sky, depth > 0 ? inten : 1.0f);
    }
    const float mis = depth > 0 ? power_heuristic(prev_pdf_in, sky_pdf) : 1.0f;
    const bool g_miss = miss && (mis > 0.0f);
    radiance = v3(radiance.x + (g_miss ? mis * sky_col.x * throughput.x : 0.0f),
                  radiance.y + (g_miss ? mis * sky_col.y * throughput.y : 0.0f),
                  radiance.z + (g_miss ? mis * sky_col.z * throughput.z : 0.0f));

    // --- hit: the alias-method env NEE sample from the bin's alias row ---
    V3 env_dir = v3(0.0f, 0.0f, 0.0f), env_li = env_dir;
    float env_pdf = 0.0f;
    if (shade) {
      int bin = (int)(u1 * (float)k_env);
      bin = bin < 0 ? 0 : (bin > k_env - 1 ? k_env - 1 : bin);
      const float* row = A.env_rows + (size_t)bin * 20;
      const float4 q0 = ldg4(row), q1 = ldg4(row + 4);
      const bool take_alias = u2 >= q0.x;
      const int a_idx = take_alias ? __float_as_int(q0.y) : bin;
      const V3 color = take_alias ? v3(q1.y, q1.z, q1.w) : v3(q0.z, q0.w, q1.x);
      const float xt = (float)(a_idx % A.env_w), yt = (float)(a_idx / A.env_w);
      const float tu = (xt + 0.5f) * (1.0f / (float)A.env_w);
      const float tv = (yt + 0.5f) * (1.0f / (float)A.env_h);
      const float theta = (1.0f - tv) * F(PI_D);
      const float phi = (tu - rot) * F(TWO_PI_D);
      const float sin_theta = sinf(theta);
      env_dir = v3(-sin_theta * cosf(phi), cosf(theta), -sin_theta * sinf(phi));
      env_pdf = solid_angle_pdf(color, cdf_den, k_env, sin_theta);
      env_li = vscale(color, inten);
    }

    // --- hit frame and material, where a hit is shaded or a shadow
    // segment ends: the attribute row (the saved hit for shadow lanes) ---
    const bool need = shade || env_done;
    float t_in = 0.0f, u_in = 0.0f, v_in = 0.0f, sel_t = 0.0f;
    V3 normal = v3(0.0f, 0.0f, 0.0f), path_o = normal, emission = normal;
    float md[24];
    int alpha_mode = 0;
    float opacity = 0.0f, alpha_cutoff = 0.0f;
    float max_rough = A.max_rough[i];
    const float max_rough_in = max_rough;
    Mat m;
    if (need) {
      float b0, b1;
      int sel_tri;
      if (a) {
        t_in = A.t[i];
        u_in = A.u[i];
        v_in = A.v[i];
        b0 = u_in;
        b1 = v_in;
        sel_t = t_in;
        sel_tri = tri_in;
      } else {
        b0 = A.hit_bary[i];
        b1 = A.hit_bary[B + i];
        sel_t = A.hit_t[i];
        sel_tri = A.hit_tri[i];
      }
      path_o = ld3(A.path_o, i, B);
      V3 n[3];
      int mat;
      attr_row<ATTR>(A.attr_rows, sel_tri < 0 ? 0 : sel_tri, n, mat);
      const float w0 = 1.0f - b0 - b1;
      normal = vnormalize(v3(n[0].x * w0 + n[1].x * b0 + n[2].x * b1,
                             n[0].y * w0 + n[1].y * b0 + n[2].y * b1,
                             n[0].z * w0 + n[1].z * b0 + n[2].z * b1));
      const float* mrow = A.materials + (size_t)(mat < 0 ? 0 : mat) * 32;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float4 q = ldg4(mrow + 4 * k);
        md[4 * k] = q.x;
        md[4 * k + 1] = q.y;
        md[4 * k + 2] = q.z;
        md[4 * k + 3] = q.w;
      }
      // material derivation (material.hlsl:84-137, untextured)
      opacity = md[3];
      const float rough_m = jmax(md[9], F(0.001));
      const float ior = clip(md[11], F(1.001), 2.0f);
      const float aniso = clip(md[13], F(-0.9), F(0.9));
      const float aspect = sqrtf(1.0f - aniso * F(0.9));
      const bool entering =
          (path_d.x * normal.x + path_d.y * normal.y + path_d.z * normal.z) < 0.0f;
      if (shade) max_rough = jmax(max_rough_in, rough_m);
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
      alpha_mode = (int)md[12];
      alpha_cutoff = md[7];
      emission = v3(md[4], md[5], md[6]);
    }
    const float nd = normal.x * path_d.x + normal.y * path_d.y + normal.z * path_d.z;
    const V3 ffnormal = nd <= 0.0f ? normal : vneg(normal);
    const V3 position = v3(path_o.x + sel_t * path_d.x, path_o.y + sel_t * path_d.y,
                           path_o.z + sel_t * path_d.z);

    radiance = v3(radiance.x + (shade ? emission.x * throughput.x : 0.0f),
                  radiance.y + (shade ? emission.y * throughput.y : 0.0f),
                  radiance.z + (shade ? emission.z * throughput.z : 0.0f));
    const bool shade0 = shade;
    const bool ended_budget = shade && depth >= A.max_bounces;
    shade = shade && !ended_budget;

    // --- alpha passthrough (pathtrace.hlsl:84-89) ---
    const float u_alpha = rand_f32(rng);
    const bool passthrough = shade && (((alpha_mode == 2) && (opacity < alpha_cutoff)) ||
                                       ((alpha_mode == 1) && (u_alpha > opacity)));
    shade = shade && !passthrough;

    // --- shadow traversal finished -> apply the pending contribution ---
    V3 pending = v3(0.0f, 0.0f, 0.0f);
    if (env_done) pending = ld3(A.pending, i, B);
    const bool g_app = env_done && !found;
    radiance = v3(radiance.x + (g_app ? pending.x * throughput.x : 0.0f),
                  radiance.y + (g_app ? pending.y * throughput.y : 0.0f),
                  radiance.z + (g_app ? pending.z * throughput.z : 0.0f));
    const bool to_env = shade;
    const bool to_bsdf = env_done;

    // --- one BSDF evaluation: toward the env sample (NEE, light.hlsl:
    // 125-158) or toward the sampled lobe (the BSDF sample) ---
    const float r1 = rand_f32(rng);
    const float r2 = rand_f32(rng);
    const float r3 = rand_f32(rng);
    V3 f_e = v3(0.0f, 0.0f, 0.0f), l_s = f_e;
    float pdf_e = 0.0f;
    if (to_env || to_bsdf) {
      const Onb onb = build_onb(ffnormal);
      const V3 v_local = to_local(onb, vneg(path_d));
      const Probs probs = lobe_probabilities(m, v_local);
      const V3 l = to_env ? to_local(onb, env_dir) : sample_lobe(m, v_local, probs, r1, r2, r3);
      eval_brdf_local(m, v_local, l, probs, f_e, pdf_e);
      l_s = to_world(onb, l);
    }
    if (to_env) {
      const float mis_e = power_heuristic(env_pdf, pdf_e);
      const float epdf_den = jmax(env_pdf, F(1e-20));
      const bool ok = (pdf_e > 0.0f) && (env_pdf > 0.0f) && (mis_e > 0.0f);
      pending = ok ? v3(mis_e * env_li.x * f_e.x / epdf_den, mis_e * env_li.y * f_e.y / epdf_den,
                        mis_e * env_li.z * f_e.z / epdf_den)
                   : v3(0.0f, 0.0f, 0.0f);
    }

    // --- BSDF sample + Russian roulette -> next bounce or death ---
    const bool nan_lane = to_bsdf && ((f_e.x != f_e.x) || (f_e.y != f_e.y) ||
                                      (f_e.z != f_e.z) || (pdf_e != pdf_e));
    const bool sample_ok = to_bsdf && !nan_lane && (pdf_e > 0.0f);
    if (sample_ok) {
      const float pdf_den = jmax(pdf_e, F(1e-20));
      throughput = v3(throughput.x * f_e.x / pdf_den, throughput.y * f_e.y / pdf_den,
                      throughput.z * f_e.z / pdf_den);
    }
    bool continue_ray = sample_ok;
    if (A.use_rr) {
      const float u_rr = rand_f32(rng);
      if (continue_ray) {
        const float t_max3 = jmax(jmax(throughput.x, throughput.y), throughput.z);
        const float p_cont = jmin(t_max3 + F(0.001), F(0.95));
        if (u_rr >= p_cont) {
          continue_ray = false;
        } else {
          throughput = v3(throughput.x / p_cont, throughput.y / p_cont, throughput.z / p_cont);
        }
      }
    }

    const bool died = miss || ended_budget || (to_bsdf && !continue_ray) || cap <= 0;
    const bool bounce = (continue_ray || passthrough) && !died;

    // --- stores: only the fields this lane's case changes ---
    A.mode[i] = bounce ? UWPT_MODE_PRIMARY
                       : (died ? UWPT_MODE_DEAD : (to_env ? UWPT_MODE_SHADOW_ENV : mode));
    if (to_env || bounce) {
      // A fresh segment at the root: the shadow ray toward the env sample,
      // or the continuing path (the sampled direction, or straight on).
      const V3 dir = bounce ? (passthrough ? path_d : l_s) : env_dir;
      const V3 org = bounce ? v3(position.x + dir.x * UWPT_SURF_EPSILON,
                                 position.y + dir.y * UWPT_SURF_EPSILON,
                                 position.z + dir.z * UWPT_SURF_EPSILON)
                            : v3(position.x + normal.x * UWPT_SURF_EPSILON,
                                 position.y + normal.y * UWPT_SURF_EPSILON,
                                 position.z + normal.z * UWPT_SURF_EPSILON);
      A.ptr[i] = 0;
      A.pend[i] = UWPT_TRAV_FULL;
      A.sp[i] = 0;
      A.t[i] = UWPT_FAR_PLANE;
      A.u[i] = 0.0f;
      A.v[i] = 0.0f;
      A.tri[i] = -1;
      A.found[i] = 0;
      st3(A.trav_o, i, B, org);
      st3(A.trav_d, i, B, dir);
      if (bounce) {
        st3(A.path_o, i, B, org);
        st3(A.path_d, i, B, dir);
      }
    }
    if (to_env || passthrough) {
      A.hit_t[i] = t_in;
      A.hit_bary[i] = u_in;
      A.hit_bary[B + i] = v_in;
      A.hit_tri[i] = tri_in;
    }
    if (to_env) st3(A.pending, i, B, pending);
    if (to_bsdf) {
      st3(A.throughput, i, B, throughput);
      A.prev_pdf[i] = pdf_e;
    }
    st3(A.radiance, i, B, radiance);
    A.rng[i] = (long long)rng;
    if (continue_ray) A.depth[i] = depth + 1;
    if (shade0) A.max_rough[i] = max_rough;
    A.lane_cap[i] = cap - 1;
    A.died[i] = died ? 1 : 0;
    if (died) {
      V3 rad_out = radiance;
      if (A.firefly) {
        const float l = lum(rad_out);
        const float ffly = *A.firefly_max;
        const float scale = l > ffly ? ffly / jmax(l, F(1e-20)) : 1.0f;
        rad_out = vscale(rad_out, scale);
      }
      if (A.nan_canary && nan_lane) rad_out = v3(0.0f, 1.0f, 0.0f);
      st3(A.rad_out, i, B, rad_out);
    }
    nray = (bounce ? 1u : 0u) + (to_env ? 1u : 0u);
  }

  // Ray starts: one exact integer atomic per group of converged lanes.
  const unsigned int mask = __activemask();
  const unsigned int total = __reduce_add_sync(mask, nray);
  if ((int)(threadIdx.x & 31u) == __ffs(mask) - 1 && total != 0u) {
    atomicAdd(A.rays, (unsigned long long)total);
  }
}

template <int ATTR>
static int launch(const TransitionArgs* args, void* stream) {
  const int threads = UWPT_K2_THREADS;
  const int blocks = (args->b + threads - 1) / threads;
  if (blocks > 0) {
    transition16_kernel<ATTR><<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int transition16_launch(const TransitionArgs* args, void* stream) {
  return launch<2>(args, stream);
}

extern "C" int transition16_oct_launch(const TransitionArgs* args, void* stream) {
  return launch<3>(args, stream);
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
