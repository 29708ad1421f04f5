// The megakernel's bounce shading (render/integrator.py::trace_bounce from
// the closest hit to Russian roulette), one thread per lane, in place on
// the path state's planes, in two entries split by the shadow ray:
//
//   shade16_launch      shade_prep's gathers and interpolation (with the
//                       instance normal transform and material override
//                       of two-level tables), the HDRI sky with its MIS on
//                       a miss, the material fetch and derivation with the
//                       path's roughness regularisation, mesh emission,
//                       the bounce budget, the alpha draw and passthrough,
//                       the environment NEE sample (sample_env_map's
//                       inverse-CDF search) and the BSDF toward it, the
//                       BSDF sample with the NaN / zero-pdf kill, the
//                       continued ray and Russian roulette.  It writes the
//                       shadow rays of the shaded lanes as (B, 3) rows, the
//                       rows the plain code hands its occlusion test, and
//                       each shaded lane's radiance twice: with the NEE
//                       term as an occluded shadow ray adds it (into the
//                       state) and as an unoccluded one adds it (into a
//                       scratch plane).
//   shade16_nee_launch  after the occlusion test of those rays: the
//                       unoccluded shaded lanes take the scratch radiance.
//
// Replaces, on the configurations ops/cuda_shade.py::covers admits (the
// HDRI environment, no analytic lights, no textures or normal maps, the
// NaN canary off), the ~2,300 PyTorch launches of a bounce's plain shading
// (render/hitinfo.py, render/sky.py, scene/envmap.py, scene/material.py,
// render/lights.py, render/bsdf.py).  The JAX package shades this bounce
// in XLA, with no Pallas kernel; the plain shading is this kernel's twin.
//
// What bounds it: each lane reads its state (69 bytes), its hit (20), its
// attribute and material rows and the environment texels it uses, and
// writes what changed, a few hundred bytes in all, against two BSDF
// evaluations (toward the env sample, and toward the sampled lobe), each
// the five lobes with IEEE division and square roots and no FMA
// contraction.  A lane that was dead at the start of the bounce reads its
// alive flag and RNG state and writes the RNG state and its shade flag.
//
// Every lane advances its PCG state by every draw the plain code makes,
// used or not: the alpha draw, the env sample's one, the BSDF's three and,
// with Russian roulette, one more.  Every rounding follows the plain code
// on CUDA tensors under -fmad=false: numpy-rounded literals, its operation
// order and its additions of masked-out zeros, PyTorch's division of a
// tensor by a Python number as a multiply by the f32 reciprocal, its
// NaN-propagating minimum and maximum, searchsorted's comparison.  The
// BSDF, the frame and the samplers are the transition kernel's
// (shade_common.cuh), which round as render/bsdf.py does.
//
// Constants come from the Python side as -D macros (ops/cuda_build.py).

#include "shade_common.cuh"

struct ShadeArgs {
  // path state (render/integrator.py::PathState), updated in place
  float* origin;           // (3, B)
  float* direction;        // (3, B)
  float* radiance;         // (3, B)
  float* throughput;       // (3, B)
  long long* rng;          // (B,) uint32 values
  unsigned char* alive;    // (B,) bool
  float* prev_pdf;
  float* max_rough;
  int* depth;
  // the closest hit of the live lanes
  const float* t;          // (B,)
  const float* bary;       // (B, 2)
  const int* slot;         // (B,) row of tri_index, -1 on a miss
  const int* inst;         // (B,) instance of the hit, read where n_inst > 0
  // the bounce's outputs
  unsigned char* shade;    // (B,) bool: the lanes that fire a shadow ray
  float* shadow_o;         // (B, 3) rows, written where shade
  float* shadow_d;         // (B, 3)
  float* nee_radiance;     // (3, B) radiance with an unoccluded NEE term, where shade
  const unsigned char* occluded;  // (B,) bool, read by shade16_nee_launch only
  // tables
  const int* tri_index;       // (T,)
  const float* attr_normals;  // (T, 9) per-vertex normals
  const int* attr_material;   // (T,)
  const float* materials;     // (NM, 32), 16-byte aligned, words 0-23 read
  const float* inst_w2l;      // (I, 12) row-major 3x4
  const int* inst_offsets;    // (I, 4), word 3 the material override (-1 none)
  const float* env_image;     // (H, W, 3)
  const float* env_cdf;       // (H * W,) inclusive luminance prefix sum
  // device scalars
  const float* cdf_sum;
  const float* rotation;
  const float* intensity;
  int b;
  int n_inst;
  int env_w;
  int env_h;
  int use_rr;
  int max_bounces;
};

// torch.remainder of an int by a positive int.
__device__ __forceinline__ int wrap(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// scene/envmap.py::_bilerp_coords and _bilinear_wrap: the image's bilinear
// sample at (uv0, uv1) with wrap addressing, texel centres at .5.  The
// footprint rows of _bilinear_quad hold the same texels, so this is also
// eval_env_map's lookup, bit for bit.
__device__ __forceinline__ V3 env_bilinear(const float* img, int w, int h, float uv0,
                                           float uv1) {
  const float u = uv0 - floorf(uv0);
  const float v = uv1 - floorf(uv1);
  const float x = u * (float)w - 0.5f;
  const float y = v * (float)h - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int x0i = wrap((int)x0, w), y0i = wrap((int)y0, h);
  const int x1i = wrap(x0i + 1, w), y1i = wrap(y0i + 1, h);
  const float* p00 = img + ((size_t)y0i * w + x0i) * 3;
  const float* p10 = img + ((size_t)y0i * w + x1i) * 3;
  const float* p01 = img + ((size_t)y1i * w + x0i) * 3;
  const float* p11 = img + ((size_t)y1i * w + x1i) * 3;
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = (__ldg(p00 + k) * gx + __ldg(p10 + k) * fx) * gy +
           (__ldg(p01 + k) * gx + __ldg(p11 + k) * fx) * fy;
  }
  return v3(c[0], c[1], c[2]);
}

// torch.searchsorted(cdf, target, right=True): the first index whose value
// is greater than the target, by PyTorch's comparison (!(x > target)).
__device__ __forceinline__ int upper_bound(const float* cdf, int n, float target) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(__ldg(cdf + mid) > target)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(UWPT_SHADE_THREADS) shade16_kernel(ShadeArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.b) return;
  const int B = A.b;
  uint32_t rng = (uint32_t)A.rng[i];

  if (A.alive[i] == 0) {
    // A dead lane: only the RNG advances, by every draw.
    const int draws = A.use_rr ? 6 : 5;
    for (int k = 0; k < draws; ++k) rng = pcg_next(rng);
    A.rng[i] = (long long)rng;
    A.shade[i] = 0;
    return;
  }

  const V3 o = ld3(A.origin, i, B);
  const V3 d = ld3(A.direction, i, B);
  V3 tp = ld3(A.throughput, i, B);
  V3 rad = ld3(A.radiance, i, B);
  const int depth = A.depth[i];
  const float prev_pdf = A.prev_pdf[i];
  const float t = A.t[i];
  const int slot = A.slot[i];
  const bool valid = (slot >= 0) && (t < UWPT_FAR_PLANE);
  const int k_env = A.env_w * A.env_h;
  const float cdf_den = jmax(*A.cdf_sum, F(1e-20));
  const float rot = *A.rotation;
  const float inten = *A.intensity;

  // --- Miss: sky radiance with MIS against the previous bounce's pdf
  // (render/sky.py::sample_sky_radiance, scene/envmap.py::eval_env_map).
  bool g_miss = false;
  V3 sky_term = v3(0.0f, 0.0f, 0.0f);
  if (!valid) {
    const float theta = acosf(clip(d.y, -1.0f, 1.0f));
    const float phi_atan = atan2f(d.z, d.x);
    const float uv0 = (phi_atan + F(PI_D)) * F(INV_TWO_PI_D) + rot;
    const float uv1 = 1.0f - theta * F(INV_PI_D);
    const V3 sky = env_bilinear(A.env_image, A.env_w, A.env_h, uv0, uv1);
    const float sky_pdf = solid_angle_pdf(sky, cdf_den, k_env, sinf(theta));
    const V3 sky_color = vscale(sky, depth > 0 ? inten : 1.0f);
    const float mis = depth > 0 ? power_heuristic(prev_pdf, sky_pdf) : 1.0f;
    g_miss = mis > 0.0f;
    sky_term = v3(mis * sky_color.x * tp.x, mis * sky_color.y * tp.y, mis * sky_color.z * tp.z);
  }
  rad = v3(rad.x + (g_miss ? sky_term.x : 0.0f), rad.y + (g_miss ? sky_term.y : 0.0f),
           rad.z + (g_miss ? sky_term.z : 0.0f));

  // --- The hit (render/hitinfo.py::shade_prep), its material
  // (scene/material.py::derive_material, untextured) and the path's
  // roughness regularisation (bsdf.with_roughness).
  V3 normal = v3(0.0f, 0.0f, 0.0f), position = normal, emission = normal;
  float md[24];
  float max_rough = A.max_rough[i];
  Mat m;
  if (valid) {
    const int row = __ldg(A.tri_index + slot);
    const float* an = A.attr_normals + (size_t)row * 9;
    const float b0 = A.bary[2 * i], b1 = A.bary[2 * i + 1];
    const float w0 = 1.0f - b0 - b1;
    normal = vnormalize(v3(__ldg(an + 0) * w0 + __ldg(an + 3) * b0 + __ldg(an + 6) * b1,
                           __ldg(an + 1) * w0 + __ldg(an + 4) * b0 + __ldg(an + 7) * b1,
                           __ldg(an + 2) * w0 + __ldg(an + 5) * b0 + __ldg(an + 8) * b1));
    int mat = __ldg(A.attr_material + row);
    if (A.n_inst > 0) {
      const int inst = A.inst[i];
      if (inst >= 0) {
        // hitinfo.py::instance_normal_to_world and instance_material_override.
        const float* w = A.inst_w2l + (size_t)inst * 12;
        normal = vnormalize(v3(__ldg(w + 0) * normal.x + __ldg(w + 4) * normal.y +
                                   __ldg(w + 8) * normal.z,
                               __ldg(w + 1) * normal.x + __ldg(w + 5) * normal.y +
                                   __ldg(w + 9) * normal.z,
                               __ldg(w + 2) * normal.x + __ldg(w + 6) * normal.y +
                                   __ldg(w + 10) * normal.z));
        const int over = __ldg(A.inst_offsets + (size_t)inst * 4 + 3);
        if (over >= 0) mat = over;
      }
    }
    position = v3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
    const float* mrow = A.materials + (size_t)(mat < 0 ? 0 : mat) * 32;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float4 q = ldg4(mrow + 4 * k);
      md[4 * k] = q.x;
      md[4 * k + 1] = q.y;
      md[4 * k + 2] = q.z;
      md[4 * k + 3] = q.w;
    }
    const float rough_m = jmax(md[9], F(0.001));
    const float ior = clip(md[11], F(1.001), 2.0f);
    const float aniso = clip(md[13], F(-0.9), F(0.9));
    const float aspect = sqrtf(1.0f - aniso * F(0.9));
    const bool entering = (d.x * normal.x + d.y * normal.y + d.z * normal.z) < 0.0f;
    max_rough = jmax(max_rough, rough_m);
    m.bc = v3(md[0], md[1], md[2]);
    m.roughness = max_rough;
    m.subsurface = md[18];
    m.spec_tint = md[15];
    m.sheen = md[16];
    m.sheen_tint = md[17];
    m.clearcoat = md[19];
    m.cc_rough = F(0.1) + F(0.001 - 0.1) * md[20];
    m.spec_trans = 1.0f - clip(md[3], 0.0f, 1.0f);
    m.ior = ior;
    m.metallic = md[8];
    m.ax = jmax(max_rough / aspect, F(0.001));
    m.ay = jmax(max_rough * aspect, F(0.001));
    m.eta = entering ? 1.0f / ior : ior;
    emission = v3(md[4], md[5], md[6]);
  }

  // --- Mesh emission, then the bounce budget (pathtrace.hlsl:78-81).
  rad = v3(rad.x + (valid ? emission.x * tp.x : 0.0f), rad.y + (valid ? emission.y * tp.y : 0.0f),
           rad.z + (valid ? emission.z * tp.z : 0.0f));
  bool alive = valid && depth < A.max_bounces;

  // --- Alpha passthrough (pathtrace.hlsl:84-89).
  const float u_alpha = rand_f32(rng);
  bool passthrough = false;
  if (alive) {
    const int alpha_mode = (int)md[12];
    const float opacity = md[3];
    passthrough = ((alpha_mode == UWPT_ALPHA_MODE_MASK) && (opacity < md[7])) ||
                  ((alpha_mode == UWPT_ALPHA_MODE_BLEND) && (u_alpha > opacity));
  }
  const bool shade = alive && !passthrough;

  // --- Environment NEE (render/lights.py::direct_light, sky mode 0 with
  // the HDRI): scene/envmap.py::sample_env_map's direction, colour and pdf.
  const float u_env = rand_f32(rng);
  V3 f_s = v3(0.0f, 0.0f, 0.0f), l_s = f_s;
  float pdf_s = 0.0f;
  V3 rad_unocc = rad;
  if (shade) {
    int idx = upper_bound(A.env_cdf, k_env, u_env * *A.cdf_sum);
    idx = idx > k_env - 1 ? k_env - 1 : idx;
    const float uv0 = ((float)(idx % A.env_w) + 0.5f) * (1.0f / (float)A.env_w);
    const float uv1 = ((float)(idx / A.env_w) + 0.5f) * (1.0f / (float)A.env_h);
    const V3 color = env_bilinear(A.env_image, A.env_w, A.env_h, uv0, uv1);
    const float theta = (1.0f - uv1) * F(PI_D);
    const float phi = (uv0 - rot) * F(TWO_PI_D);
    const float sin_theta = sinf(theta);
    const V3 light_dir = v3(-sin_theta * cosf(phi), cosf(theta), -sin_theta * sinf(phi));
    const float light_pdf = solid_angle_pdf(color, cdf_den, k_env, sin_theta);

    // The shadow ray from the shading normal's side of the surface.
    const V3 scatter = v3(position.x + normal.x * UWPT_SURF_EPSILON,
                          position.y + normal.y * UWPT_SURF_EPSILON,
                          position.z + normal.z * UWPT_SURF_EPSILON);
    A.shadow_o[3 * i] = scatter.x;
    A.shadow_o[3 * i + 1] = scatter.y;
    A.shadow_o[3 * i + 2] = scatter.z;
    A.shadow_d[3 * i] = light_dir.x;
    A.shadow_d[3 * i + 1] = light_dir.y;
    A.shadow_d[3 * i + 2] = light_dir.z;

    // The BSDF toward it, about the face-forward normal.
    const float nd = normal.x * d.x + normal.y * d.y + normal.z * d.z;
    const Onb onb = build_onb(nd <= 0.0f ? normal : vneg(normal));
    const V3 v_local = to_local(onb, vneg(d));
    const Probs probs = lobe_probabilities(m, v_local);
    V3 f_e;
    float pdf_e;
    eval_brdf_local(m, v_local, to_local(onb, light_dir), probs, f_e, pdf_e);
    const float mis = power_heuristic(light_pdf, pdf_e);
    const float den = jmax(light_pdf, F(1e-20));
    const bool use = (pdf_e > 0.0f) && (light_pdf > 0.0f) && (mis > 0.0f);
    const V3 ld = v3(0.0f + (use ? mis * color.x * f_e.x * inten / den : 0.0f),
                     0.0f + (use ? mis * color.y * f_e.y * inten / den : 0.0f),
                     0.0f + (use ? mis * color.z * f_e.z * inten / den : 0.0f));
    rad_unocc = v3(rad.x + ld.x * tp.x, rad.y + ld.y * tp.y, rad.z + ld.z * tp.z);
    // Occluded, the term is 0 + 0.
    rad = v3(rad.x + (0.0f + 0.0f) * tp.x, rad.y + (0.0f + 0.0f) * tp.y,
             rad.z + (0.0f + 0.0f) * tp.z);

    // --- BSDF sample (render/bsdf.py::sample_brdf, pathtrace.hlsl:98-113).
    const float r1 = rand_f32(rng);
    const float r2 = rand_f32(rng);
    const float r3 = rand_f32(rng);
    const V3 l = sample_lobe(m, v_local, probs, r1, r2, r3);
    eval_brdf_local(m, v_local, l, probs, f_s, pdf_s);
    l_s = to_world(onb, l);
  } else {
    rad = v3(rad.x + 0.0f, rad.y + 0.0f, rad.z + 0.0f);
    rng = pcg_next(pcg_next(pcg_next(rng)));
  }
  const bool nan_lane = (f_s.x != f_s.x) || (f_s.y != f_s.y) || (f_s.z != f_s.z) ||
                        (pdf_s != pdf_s);
  const bool dead_sample = shade && (nan_lane || pdf_s <= 0.0f);
  if (shade && !dead_sample) {
    const float den = jmax(pdf_s, F(1e-20));
    tp = v3(tp.x * f_s.x / den, tp.y * f_s.y / den, tp.z * f_s.z / den);
  }
  alive = alive && !dead_sample;

  // --- The continued ray (pathtrace.hlsl:116-118) of the lanes still
  // alive before Russian roulette: passthrough keeps its direction and
  // depth.
  if (alive) {
    const V3 dir = passthrough ? d : l_s;
    st3(A.origin, i, B, v3(position.x + dir.x * UWPT_SURF_EPSILON,
                           position.y + dir.y * UWPT_SURF_EPSILON,
                           position.z + dir.z * UWPT_SURF_EPSILON));
    st3(A.direction, i, B, dir);
    if (!passthrough) A.depth[i] = depth + 1;
  }

  // --- Russian roulette (pathtrace.hlsl:121-127).
  if (A.use_rr) {
    const float u_rr = rand_f32(rng);
    if (alive && !passthrough) {
      const float p_cont = jmin(jmax(jmax(tp.x, tp.y), tp.z) + F(0.001), F(0.95));
      if (u_rr >= p_cont) {
        alive = false;
      } else {
        tp = v3(tp.x / p_cont, tp.y / p_cont, tp.z / p_cont);
      }
    }
  }

  // --- Stores: only what this lane's case changes.
  st3(A.radiance, i, B, rad);
  if (shade) {
    st3(A.nee_radiance, i, B, rad_unocc);
    A.prev_pdf[i] = pdf_s;
    st3(A.throughput, i, B, tp);
  }
  if (valid) A.max_rough[i] = max_rough;
  A.rng[i] = (long long)rng;
  A.alive[i] = alive ? 1 : 0;
  A.shade[i] = shade ? 1 : 0;
}

// The NEE term where the shadow ray found nothing: the lane's radiance
// with the term added, as the first entry computed it.
__global__ void __launch_bounds__(UWPT_SHADE_THREADS) shade16_nee_kernel(ShadeArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.b || A.shade[i] == 0 || A.occluded[i] != 0) return;
  st3(A.radiance, i, A.b, ld3(A.nee_radiance, i, A.b));
}

extern "C" int shade16_launch(const ShadeArgs* args, void* stream) {
  const int threads = UWPT_SHADE_THREADS;
  const int blocks = (args->b + threads - 1) / threads;
  if (blocks > 0) {
    shade16_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int shade16_nee_launch(const ShadeArgs* args, void* stream) {
  const int threads = UWPT_SHADE_THREADS;
  const int blocks = (args->b + threads - 1) / threads;
  if (blocks > 0) {
    shade16_nee_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
