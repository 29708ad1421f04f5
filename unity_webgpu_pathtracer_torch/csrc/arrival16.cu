// wide16 BVH arrival step, one thread per lane, in four instantiations:
// arrival16_launch (flat tables), arrival16_inst_launch (two-level tables
// with TLAS instance rows), and the same two on leaf8 tables,
// arrival16_leaf8_launch and arrival16_inst_leaf8_launch; and the probe
// modes of the measurement probes behind arrival16_probe_launch (at the end).
//
// Replaces: unity_webgpu_pathtracer_tpu/ops/pallas_arrival.py::_arrival_kernel
// (reached from arrival_step16_pallas): has_inst off and on, leaf_slots
// 16 (96-float rows) and 8 (48-float leaf8 rows).
//
// What bounds it on an H100: memory latency.  Each live lane reads its own
// node row (384 bytes, 192 on leaf8 tables) at a data-dependent address (a
// gather with little coalescing across the warp), plus its register stack,
// which is copied in and out as (D, B) planes.  The arithmetic (16 slab
// tests or up to 16 Moller-Trumbore tests) is small next to the row fetch.
//
// First design: one thread per lane, the row loaded inside the kernel
// (the TPU version had XLA gather it first), the decode done from integer
// views of the same words, the stack planes kept lane-contiguous so the
// copy is coalesced, and lanes that do not run copied through unchanged.
// Compiled with -fmad=false so it rounds op for op like the plain twin
// (ops/traverse_wide16.py::arrival_step16).
//
// leaf8 tables (ROWF = 48): rows are 48 floats; inner and instance rows
// are unchanged (they use only words below 48), and a leaf holds up to 8
// triangles, 9 comps x 8 f16 at words 4:40 (word w = slot w low, slot
// w + 4 high) and 8 attribute indices at 40:48.
//
// Instanced tables (HAS_INST): a lane inside a BLAS (inst >= 0) tests
// boxes and triangles with its instance-local ray; an instance row
// (meta < 0) takes the world ray through the row's world-to-local 3x4 in
// the twin's order ((m0*o0 + m1*o1) + m2*o2) + m3, jumps to the BLAS root
// (word 16) and records the stack height; a pop below that height returns
// the lane to world space.  The instance state is six more planes
// (InstArgs), read and written only by this instantiation, so the flat
// kernel pays nothing for it.
//
// Probe modes, behind arrival16_probe_launch, on 96-float flat rows, with
// each lane's row index from a plane of its own (the lane index on a
// probe's synthetic rows, ptr on a captured state):
// - UWPT_PROBE_F16LEAF and UWPT_PROBE_BF16LEAF replace
//   experiments/round16_bf16leaf_probe.py: arrival16_kernel's third
//   template parameter (default UWPT_PROBE_PROD, the production code) reads
//   the row plane, and in BF16LEAF decodes the leaf halfwords as bf16,
//   __uint_as_float(h << 16), in place of __half2float;
// - the other six replace experiments/round14_kernel_diet.py::make_kernel
//   (full, no_leaf, no_inner, no_stack, leaf_bf16, leaf_noint): a kernel
//   of their own, arrival16_diet_kernel<MODE> at the end.  The diet is a
//   stripped copy of an older K1 whose child-box bytes and leaf halfwords
//   were stored interleaved (slot 4w + j in byte j of word w; slot 2w + h
//   in half h of word w), not in today's split order, so its "full" is
//   that older kernel; "leaf_noint" is the split order.  A stub keeps
//   every row load of the section it removes: the TPU loads the row as one
//   block, but nvcc would drop the loads of unused words, and the diet
//   would then price bytes, not arithmetic.  So a stub issues the same
//   loads as volatile inline-PTX ld.global.nc (keep_load), which nvcc
//   cannot remove, and drops only the arithmetic.
//
// Constants come from the Python side as -D macros (ops/cuda_build.py).

#include <cuda_fp16.h>
#include <cuda_runtime.h>

struct ArrivalArgs {
  const float* nodes;           // (N, ROWF)
  const float* o;               // (3, B) planes
  const float* d;
  const float* inv;
  const unsigned char* active;  // (B,) bool, or null
  // state in (Wide16State field order)
  const int* ptr;
  const int* pend;
  const int* sp;
  const int* stack_row;         // (D, B)
  const int* stack_mask;        // (D, B)
  const float* t;
  const float* u;
  const float* v;
  const int* tri;
  const unsigned char* found;
  // state out
  int* o_ptr;
  int* o_pend;
  int* o_sp;
  int* o_stack_row;
  int* o_stack_mask;
  float* o_t;
  float* o_u;
  float* o_v;
  int* o_tri;
  unsigned char* o_found;
  int b;
  int depth;
};

// Instance registers of two-level tables (Wide16State's instance fields).
struct InstArgs {
  const int* inst;              // (B,) -1 = world space
  const int* hit_inst;
  const int* sp_enter;
  const float* local_o;         // (3, B) planes
  const float* local_d;
  const float* local_inv;
  int* o_inst;
  int* o_hit_inst;
  int* o_sp_enter;
  float* o_local_o;
  float* o_local_d;
  float* o_local_inv;
};

// jnp.minimum / jnp.maximum: NaN-propagating.
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

template <bool HAS_INST, int ROWF, int MODE = UWPT_PROBE_PROD>
__global__ void arrival16_kernel(ArrivalArgs a, InstArgs n, const int* rowidx) {
  static_assert(ROWF == 96 || ROWF == 48, "wide16 rows are 96 or 48 floats");
  constexpr int SLOTS = ROWF == 96 ? 16 : 8;   // triangles per leaf
  constexpr int HALF = SLOTS / 2;              // f16 words per component
  constexpr int OFF_IDX = 4 + 9 * HALF;        // attribute indices: 76 or 40
  static_assert(MODE == UWPT_PROBE_PROD || (!HAS_INST && ROWF == 96 &&
                                            (MODE == UWPT_PROBE_F16LEAF ||
                                             MODE == UWPT_PROBE_BF16LEAF)),
                "the leaf-decode probes run on flat 96-float rows");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int B = a.b;
  const int ptr = a.ptr[i];
  const int pend = a.pend[i];
  const int sp = a.sp[i];
  const float t0 = a.t[i];
  float u = a.u[i], v = a.v[i];
  int tri = a.tri[i];
  bool found = a.found[i] != 0;
  const bool live = ptr >= 0 && (a.active == nullptr || a.active[i] != 0);

  // Instance registers (HAS_INST only).
  const int inst0 = HAS_INST ? n.inst[i] : -1;
  int inst = inst0;
  int hit_inst = HAS_INST ? n.hit_inst[i] : -1;
  int sp_enter = HAS_INST ? n.sp_enter[i] : 0;
  bool enter = false;
  float lo3[3] = {0.0f, 0.0f, 0.0f}, ld3[3] = {0.0f, 0.0f, 0.0f};

  int new_ptr = ptr, new_pend = pend, new_sp = sp;
  float t = t0;
  bool push = false;
  int entry_row = 0, entry_mask = 0;

  if (live) {
    const float* row = a.nodes + (size_t)(MODE == UWPT_PROBE_PROD ? ptr : rowidx[i]) * ROWF;
    const int* rowi = reinterpret_cast<const int*>(row);
    const int meta = rowi[3];
    // The ray this row is tested with: instance-local inside a BLAS.
    const bool in_blas = HAS_INST && inst0 >= 0;
    const float* ro = in_blas ? n.local_o : a.o;
    const float* rd = in_blas ? n.local_d : a.d;
    const float* ri = in_blas ? n.local_inv : a.inv;
    const float o0 = ro[i], o1 = ro[B + i], o2 = ro[2 * B + i];
    const float ax = row[0], ay = row[1], az = row[2];
    bool found_child = false;
    bool need_pop = false;

    if (meta == 0) {
      // ---- inner: 16 quantized child boxes, slab test ----
      const float i0 = ri[i], i1 = ri[B + i], i2 = ri[2 * B + i];
      const int eword = rowi[4];
      const float s0 = __int_as_float((eword & 0xFF) << 23);
      const float s1 = __int_as_float(((eword >> 8) & 0xFF) << 23);
      const float s2 = __int_as_float(((eword >> 16) & 0xFF) << 23);
      int hitbits = 0;
      int first = 0;
      float best = __int_as_float(0x7f800000);  // +inf
      for (int s = 0; s < 16; ++s) {
        // SPLIT byte order: byte j of word w holds slot 4j + w.
        const int w = s & 3, sh = 8 * (s >> 2);
        const float qlx = (float)((rowi[8 + w] >> sh) & 0xFF);
        const float qly = (float)((rowi[12 + w] >> sh) & 0xFF);
        const float qlz = (float)((rowi[16 + w] >> sh) & 0xFF);
        const float qhx = (float)((rowi[20 + w] >> sh) & 0xFF);
        const float qhy = (float)((rowi[24 + w] >> sh) & 0xFF);
        const float qhz = (float)((rowi[28 + w] >> sh) & 0xFF);
        float t_near = 0.0f, t_far = t0;
        {
          const float lo = ax + qlx * s0, hi = ax + qhx * s0;
          const float tl = (lo - o0) * i0, th = (hi - o0) * i0;
          t_near = jmax(t_near, jmin(tl, th));
          t_far = jmin(t_far, jmax(tl, th));
        }
        {
          const float lo = ay + qly * s1, hi = ay + qhy * s1;
          const float tl = (lo - o1) * i1, th = (hi - o1) * i1;
          t_near = jmax(t_near, jmin(tl, th));
          t_far = jmin(t_far, jmax(tl, th));
        }
        {
          const float lo = az + qlz * s2, hi = az + qhz * s2;
          const float tl = (lo - o2) * i2, th = (hi - o2) * i2;
          t_near = jmax(t_near, jmin(tl, th));
          t_far = jmin(t_far, jmax(tl, th));
        }
        const bool hit = (t_near <= t_far) && (rowi[32 + s] >= 0) && ((pend >> s) & 1);
        if (hit) {
          hitbits |= 1 << s;
          if (t_near < best) {  // strict: the first minimum, as argmin
            best = t_near;
            first = s;
          }
        }
      }
      found_child = hitbits != 0;
      need_pop = !found_child;
      if (found_child) {
        const int rem = hitbits & ~(1 << first);
        new_ptr = rowi[32 + first];
        new_pend = UWPT_TRAV_FULL;
        if (rem != 0) {
          push = true;
          if (__popc(rem) == 1) {
            entry_row = rowi[32 + (__ffs(rem) - 1)];
            entry_mask = 0;
          } else {
            entry_row = ptr;
            entry_mask = rem;
          }
        }
      }
    } else if (meta > 0) {
      // ---- leaf: up to SLOTS anchor-relative f16 triangles ----
      need_pop = true;
      const float d0 = rd[i], d1 = rd[B + i], d2 = rd[2 * B + i];
      float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
      int best_tri = 0;
      const int cnt = meta < SLOTS ? meta : SLOTS;
      for (int s = 0; s < cnt; ++s) {
        // SPLIT halfword order: word w holds slot w (low) and w + HALF (high).
        const int w = s % HALF, sh = (s / HALF) * 16;
        float c[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const unsigned short h =
              (unsigned short)((((unsigned int)rowi[4 + HALF * k + w]) >> sh) & 0xFFFFu);
          c[k] = MODE == UWPT_PROBE_BF16LEAF ? __uint_as_float((unsigned int)h << 16)
                                             : __half2float(__ushort_as_half(h));
        }
        const float e2x = c[0], e2y = c[1], e2z = c[2];
        const float e1x = c[3], e1y = c[4], e1z = c[5];
        const float v0x = c[6] + ax, v0y = c[7] + ay, v0z = c[8] + az;
        const float rx = d1 * e2z - d2 * e2y;
        const float ry = d2 * e2x - d0 * e2z;
        const float rz = d0 * e2y - d1 * e2x;
        const float det = e1x * rx + e1y * ry + e1z * rz;
        const float finv = 1.0f / (fabsf(det) < UWPT_DET_EPS ? 1.0f : det);
        const float sx = o0 - v0x, sy = o1 - v0y, sz = o2 - v0z;
        const float uu = finv * (sx * rx + sy * ry + sz * rz);
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float vv = finv * (d0 * qx + d1 * qy + d2 * qz);
        float tt = finv * (e2x * qx + e2y * qy + e2z * qz);
        const bool valid = fabsf(det) > UWPT_DET_EPS && uu >= 0.0f && uu <= 1.0f &&
                           vv >= 0.0f && uu + vv <= 1.0f && tt > UWPT_T_MIN && tt < t0;
        if (!valid) tt = UWPT_FAR_PLANE;
        if (s == 0 || tt < best_t) {  // first minimum, as argmin
          best_t = tt;
          best_u = uu;
          best_v = vv;
          best_tri = rowi[OFF_IDX + s];
        }
      }
      if (best_t < t0) {
        t = best_t;
        u = best_u;
        v = best_v;
        tri = best_tri;
        found = true;
        hit_inst = inst0;   // the instance of the best hit (pre-update)
      }
    } else if (HAS_INST) {
      // ---- instance row: enter instance space, jump to the BLAS root ----
      // (flat tables have no meta < 0 rows.)
      const float ow0 = a.o[i], ow1 = a.o[B + i], ow2 = a.o[2 * B + i];
      const float dw0 = a.d[i], dw1 = a.d[B + i], dw2 = a.d[2 * B + i];
      for (int c = 0; c < 3; ++c) {
        const float* m = row + 4 + 4 * c;
        lo3[c] = ((m[0] * ow0 + m[1] * ow1) + m[2] * ow2) + m[3];
        ld3[c] = (m[0] * dw0 + m[1] * dw1) + m[2] * dw2;
      }
      enter = true;
      inst = -meta - 1;
      sp_enter = sp;   // no push on an instance row
      new_ptr = rowi[16];
      new_pend = UWPT_TRAV_FULL;
    }

    if (need_pop) {
      if (sp > 0) {
        const int top_row = a.stack_row[(size_t)(sp - 1) * B + i];
        const int top_mask = a.stack_mask[(size_t)(sp - 1) * B + i];
        new_ptr = top_row;
        new_pend = top_mask == 0 ? UWPT_TRAV_FULL : top_mask;
        new_sp = sp - 1;
        // Popping below the entry height returns the lane to world space.
        if (HAS_INST && inst0 >= 0 && new_sp < sp_enter) inst = -1;
      } else {
        new_ptr = UWPT_TRAV_DONE;
        new_pend = UWPT_TRAV_FULL;
        if (HAS_INST) inst = -1;
      }
    } else if (push) {
      new_sp = sp + 1;
    }
  }

  for (int lev = 0; lev < a.depth; ++lev) {
    const size_t k = (size_t)lev * B + i;
    const bool at = push && lev == sp;
    a.o_stack_row[k] = at ? entry_row : a.stack_row[k];
    a.o_stack_mask[k] = at ? entry_mask : a.stack_mask[k];
  }
  a.o_ptr[i] = new_ptr;
  a.o_pend[i] = new_pend;
  a.o_sp[i] = new_sp;
  a.o_t[i] = t;
  a.o_u[i] = u;
  a.o_v[i] = v;
  a.o_tri[i] = tri;
  a.o_found[i] = found ? 1 : 0;
  if (HAS_INST) {
    n.o_inst[i] = inst;
    n.o_hit_inst[i] = hit_inst;
    n.o_sp_enter[i] = sp_enter;
    for (int c = 0; c < 3; ++c) {
      const size_t k = (size_t)c * B + i;
      const float ld = ld3[c];
      n.o_local_o[k] = enter ? lo3[c] : n.local_o[k];
      n.o_local_d[k] = enter ? ld : n.local_d[k];
      // utils/math.py::safe_rcp: exact zeros nudged to 1e-30.
      n.o_local_inv[k] = enter ? 1.0f / (ld == 0.0f ? 1.0e-30f : ld) : n.local_inv[k];
    }
  }
}

template <bool HAS_INST, int ROWF, int MODE = UWPT_PROBE_PROD>
static int launch(const ArrivalArgs* args, const InstArgs* inst, void* stream,
                  const int* rowidx = nullptr) {
  const int threads = 256;
  const int blocks = (args->b + threads - 1) / threads;
  if (blocks > 0) {
    arrival16_kernel<HAS_INST, ROWF, MODE>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(*args, *inst, rowidx);
  }
  return (int)cudaGetLastError();
}

extern "C" int arrival16_launch(const ArrivalArgs* args, void* stream) {
  const InstArgs none = {};
  return launch<false, 96>(args, &none, stream);
}

extern "C" int arrival16_inst_launch(const ArrivalArgs* args, const InstArgs* inst,
                                     void* stream) {
  return launch<true, 96>(args, inst, stream);
}

extern "C" int arrival16_leaf8_launch(const ArrivalArgs* args, void* stream) {
  const InstArgs none = {};
  return launch<false, 48>(args, &none, stream);
}

extern "C" int arrival16_inst_leaf8_launch(const ArrivalArgs* args, const InstArgs* inst,
                                           void* stream) {
  return launch<true, 48>(args, inst, stream);
}

// A load that nvcc keeps although its value is unused (probe stubs).
__device__ __forceinline__ void keep_load(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
}
__device__ __forceinline__ void keep_load4(const int* p) {  // 16-byte aligned
  int x, y, z, w;
  asm volatile("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(x), "=r"(y), "=r"(z), "=r"(w) : "l"(p));
}

// One arrival of round14_kernel_diet.py::make_kernel(mode), one thread per
// lane, on 96-float rows.  It computes what the diet computes for every
// lane: the TPU runs both sections on every lane and keeps results by
// selects, so a section that can change a lane that is not its row kind
// runs for it here too: no_stack pops every live lane to the entry the inner section
// would push (so leaf lanes run the slab test on their leaf words),
// no_leaf offers t = FAR_PLANE + row[5] to every lane, dead ones on row 0,
// and with t > FAR_PLANE the leaf section's first slot reaches every lane.
template <int MODE>
__global__ void arrival16_diet_kernel(ArrivalArgs a, const int* rowidx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int B = a.b;
  const int ptr = a.ptr[i], pend = a.pend[i], sp = a.sp[i];
  const float t0 = a.t[i];
  const bool live = ptr >= 0 && (a.active == nullptr || a.active[i] != 0);
  const int* rowi = reinterpret_cast<const int*>(a.nodes) + (size_t)(live ? rowidx[i] : 0) * 96;
  const float* row = reinterpret_cast<const float*>(rowi);
  const int meta = live ? rowi[3] : 0;
  const bool is_leaf = live && meta > 0, is_inner = live && meta == 0;

  // ---- inner: 16 child boxes (interleaved bytes), slab test ----
  int hitbits = 0, first = 0;
  float best = __int_as_float(0x7f800000);  // +inf
  if (is_inner || (MODE == UWPT_PROBE_NO_STACK && live)) {
    const float i0 = a.inv[i], i1 = a.inv[B + i], i2 = a.inv[2 * B + i];
    const float o0 = a.o[i], o1 = a.o[B + i], o2 = a.o[2 * B + i];
    const float ax = row[0], ay = row[1], az = row[2];
    if (MODE == UWPT_PROBE_NO_INNER) {   // the row words and ray planes of the slab test
      keep_load(rowi + 4);
      for (int w = 8; w < 32; w += 4) keep_load4(rowi + w);
      for (int c = 0; c < 3; ++c) keep_load(reinterpret_cast<const int*>(a.inv) + c * B + i);
    }
    const int eword = MODE == UWPT_PROBE_NO_INNER ? 0 : rowi[4];
    const float s0 = __int_as_float((eword & 0xFF) << 23);
    const float s1 = __int_as_float(((eword >> 8) & 0xFF) << 23);
    const float s2 = __int_as_float(((eword >> 16) & 0xFF) << 23);
    for (int s = 0; s < 16; ++s) {
      float t_near = 0.0f, t_far = t0;
      if (MODE == UWPT_PROBE_NO_INNER) {
        t_near = 0.0f + ax;
      } else {
        const int w = s >> 2, sh = 8 * (s & 3);
        const float ql[3] = {(float)((rowi[8 + w] >> sh) & 0xFF),
                             (float)((rowi[12 + w] >> sh) & 0xFF),
                             (float)((rowi[16 + w] >> sh) & 0xFF)};
        const float qh[3] = {(float)((rowi[20 + w] >> sh) & 0xFF),
                             (float)((rowi[24 + w] >> sh) & 0xFF),
                             (float)((rowi[28 + w] >> sh) & 0xFF)};
        const float an[3] = {ax, ay, az}, sc[3] = {s0, s1, s2};
        const float oo[3] = {o0, o1, o2}, ii[3] = {i0, i1, i2};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float lo = an[c] + ql[c] * sc[c], hi = an[c] + qh[c] * sc[c];
          const float tl = (lo - oo[c]) * ii[c], th = (hi - oo[c]) * ii[c];
          t_near = jmax(t_near, jmin(tl, th));
          t_far = jmin(t_far, jmax(tl, th));
        }
      }
      if ((t_near <= t_far) && (rowi[32 + s] >= 0) && ((pend >> s) & 1)) {
        hitbits |= 1 << s;
        if (t_near < best) {  // strict: the first minimum, as argmin
          best = t_near;
          first = s;
        }
      }
    }
  }
  const bool found_child = is_inner && best < __int_as_float(0x7f800000);
  const int rem = hitbits & ~(1 << first);
  const bool push = found_child && rem != 0;
  const bool one_left = __popc(rem) == 1;
  const int entry_row = one_left ? rowi[32 + (__ffs(rem) - 1)] : ptr;
  const int entry_mask = one_left ? 0 : rem;

  // ---- leaf: f16 triangles (interleaved halfwords), Moller-Trumbore ----
  float t = t0, u = a.u[i], v = a.v[i];
  int tri = a.tri[i];
  bool improved = false;
  if (MODE == UWPT_PROBE_NO_LEAF) {
    if (is_leaf) {
      const int cnt = meta < 16 ? meta : 16;
      for (int k = 0; k < 9; ++k)
        for (int w = 0; w < (cnt + 1) >> 1; ++w) keep_load(rowi + 4 + 8 * k + w);
      for (int c = 0; c < 3; ++c) {   // and the ray planes of Moller-Trumbore
        keep_load(reinterpret_cast<const int*>(a.o) + c * B + i);
        keep_load(reinterpret_cast<const int*>(a.d) + c * B + i);
      }
    }
    const float tt = UWPT_FAR_PLANE + row[5];   // equal in every slot: argmin 0
    improved = tt < t0;
    if (improved) {
      t = tt;
      u = 0.0f;
      v = 0.0f;
      tri = rowi[76];
    }
  } else if (is_leaf || t0 > UWPT_FAR_PLANE) {
    // Slots at or past meta are invalid (FAR_PLANE) and never beat slot 0.
    const int cnt = is_leaf ? (meta < 16 ? meta : 16) : 1;
    const float o0 = a.o[i], o1 = a.o[B + i], o2 = a.o[2 * B + i];
    const float d0 = a.d[i], d1 = a.d[B + i], d2 = a.d[2 * B + i];
    const float ax = row[0], ay = row[1], az = row[2];
    float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
    int best_s = 0;
    for (int s = 0; s < cnt; ++s) {
      const int w = MODE == UWPT_PROBE_LEAF_NOINT ? (s & 7) : (s >> 1);
      const int sh = MODE == UWPT_PROBE_LEAF_NOINT ? 16 * (s >> 3) : 16 * (s & 1);
      float c[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const unsigned int h = (((unsigned int)rowi[4 + 8 * k + w]) >> sh) & 0xFFFFu;
        c[k] = MODE == UWPT_PROBE_LEAF_BF16 ? __uint_as_float(h << 16)
                                            : __half2float(__ushort_as_half((unsigned short)h));
      }
      const float e2x = c[0], e2y = c[1], e2z = c[2];
      const float e1x = c[3], e1y = c[4], e1z = c[5];
      const float v0x = c[6] + ax, v0y = c[7] + ay, v0z = c[8] + az;
      const float rx = d1 * e2z - d2 * e2y;
      const float ry = d2 * e2x - d0 * e2z;
      const float rz = d0 * e2y - d1 * e2x;
      const float det = e1x * rx + e1y * ry + e1z * rz;
      const float finv = 1.0f / (fabsf(det) < UWPT_DET_EPS ? 1.0f : det);
      const float sx = o0 - v0x, sy = o1 - v0y, sz = o2 - v0z;
      const float uu = finv * (sx * rx + sy * ry + sz * rz);
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float vv = finv * (d0 * qx + d1 * qy + d2 * qz);
      float tt = finv * (e2x * qx + e2y * qy + e2z * qz);
      const bool valid = is_leaf && fabsf(det) > UWPT_DET_EPS && uu >= 0.0f && uu <= 1.0f &&
                         vv >= 0.0f && uu + vv <= 1.0f && tt > UWPT_T_MIN && tt < t0;
      if (!valid) tt = UWPT_FAR_PLANE;
      if (s == 0 || tt < best_t) {  // first minimum, as argmin
        best_t = tt;
        best_u = uu;
        best_v = vv;
        best_s = s;
      }
    }
    improved = best_t < t0;
    if (improved) {
      t = best_t;
      u = best_u;
      v = best_v;
      tri = rowi[76 + best_s];
    }
  }

  // ---- stack push (select chain over the D planes) + pop ----
  const int sp_pushed = sp + (push ? 1 : 0);
  int top_row = 0, top_mask = 0;
  if (MODE == UWPT_PROBE_NO_STACK) {
    for (int lev = 0; lev < a.depth; ++lev) {
      const size_t k = (size_t)lev * B + i;
      a.o_stack_row[k] = a.stack_row[k];
      a.o_stack_mask[k] = a.stack_mask[k];
    }
    top_row = entry_row;
    top_mask = entry_mask;
  } else {
    for (int lev = 0; lev < a.depth; ++lev) {
      const size_t k = (size_t)lev * B + i;
      const bool at = push && sp == lev;
      const int nr = at ? entry_row : a.stack_row[k];
      const int nm = at ? entry_mask : a.stack_mask[k];
      a.o_stack_row[k] = nr;
      a.o_stack_mask[k] = nm;
      if (sp_pushed - 1 == lev) {
        top_row = nr;
        top_mask = nm;
      }
    }
  }
  const bool need_pop = (is_inner && !found_child) || is_leaf;
  const bool has = sp_pushed > 0;
  const int pop_ptr = has ? top_row : UWPT_TRAV_DONE;
  const int pop_pend = top_mask == 0 ? UWPT_TRAV_FULL : top_mask;
  const int new_ptr = found_child ? rowi[32 + first] : (need_pop ? pop_ptr : ptr);
  const int new_pend = found_child ? UWPT_TRAV_FULL
                                   : (need_pop ? (has ? pop_pend : UWPT_TRAV_FULL) : pend);
  a.o_ptr[i] = live ? new_ptr : ptr;
  a.o_pend[i] = live ? new_pend : pend;
  a.o_sp[i] = live ? (need_pop && has ? sp_pushed - 1 : sp_pushed) : sp;
  a.o_t[i] = t;
  a.o_u[i] = u;
  a.o_v[i] = v;
  a.o_tri[i] = tri;
  a.o_found[i] = (a.found[i] != 0 || improved) ? 1 : 0;
}

template <int MODE>
static int launch_diet(const ArrivalArgs* args, const int* rowidx, void* stream) {
  const int threads = 256;
  const int blocks = (args->b + threads - 1) / threads;
  if (blocks > 0)
    arrival16_diet_kernel<MODE><<<blocks, threads, 0, (cudaStream_t)stream>>>(*args, rowidx);
  return (int)cudaGetLastError();
}

// A probe mode (the number of one of the probe macros) on 96-float flat rows;
// lane i reads row rowidx[i] (row 0 when it is not live).
extern "C" int arrival16_probe_launch(int mode, const ArrivalArgs* args, const int* rowidx,
                                      void* stream) {
  const InstArgs none = {};
  switch (mode) {
    case UWPT_PROBE_FULL: return launch_diet<UWPT_PROBE_FULL>(args, rowidx, stream);
    case UWPT_PROBE_NO_LEAF: return launch_diet<UWPT_PROBE_NO_LEAF>(args, rowidx, stream);
    case UWPT_PROBE_NO_INNER: return launch_diet<UWPT_PROBE_NO_INNER>(args, rowidx, stream);
    case UWPT_PROBE_NO_STACK: return launch_diet<UWPT_PROBE_NO_STACK>(args, rowidx, stream);
    case UWPT_PROBE_LEAF_BF16: return launch_diet<UWPT_PROBE_LEAF_BF16>(args, rowidx, stream);
    case UWPT_PROBE_LEAF_NOINT: return launch_diet<UWPT_PROBE_LEAF_NOINT>(args, rowidx, stream);
    case UWPT_PROBE_F16LEAF:
      return launch<false, 96, UWPT_PROBE_F16LEAF>(args, &none, stream, rowidx);
    case UWPT_PROBE_BF16LEAF:
      return launch<false, 96, UWPT_PROBE_BF16LEAF>(args, &none, stream, rowidx);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
