// wide16 BVH arrival steps on a lane state updated in place, one thread
// per lane, in four instantiations: arrival16_run_launch (flat tables),
// arrival16_inst_run_launch (two-level tables with TLAS instance rows), and
// the same two on leaf8 tables, arrival16_leaf8_run_launch and
// arrival16_inst_leaf8_run_launch; and the probe modes of the measurement
// probes behind arrival16_run_probe_launch and arrival16_diet_launch (at
// the end).
//
// Replaces: unity_webgpu_pathtracer_tpu/ops/pallas_arrival.py::_arrival_kernel
// (reached from arrival_step16_pallas): has_inst off and on, leaf_slots
// 16 (96-float rows) and 8 (48-float leaf8 rows).
//
// arrival16_run_kernel runs up to a.steps arrivals a lane.  The reference's
// one arrival out of place is this kernel at steps = 1 on a copy of the
// state (ops/cuda_arrival.py::arrival_step16_cuda clones, then launches).
// What bounds it on an H100 is the latency of each arrival's row load,
// which depends on the previous arrival's result.  The design removes the
// bytes around it: the lane state and rays are loaded into registers once
// per launch, the stack is updated in place (a push writes one entry, a
// pop reads one, and a pop that follows a push takes the entry from a
// register), lanes that do not step return before they touch their state,
// and a lane that steps writes its registers back once.  A lane leaves the
// loop when its traversal ends or, with stop_on_found, at its first hit.
//
// The per-arrival body (arrive) is compiled with -fmad=false so it rounds
// op for op like the plain twin (ops/traverse_wide16.py::arrival_step16).
// It reads the row as 16-byte vectors through the read-only path: the
// header (anchor, meta) first, then each word group of the section the row
// kind selects where that section uses it (the leaf's in 4-word chunks);
// the table keeps the reference's byte order.  The kernels are compiled for
// UWPT_K1_MIN_BLOCKS resident blocks of 256 threads per SM
// (ops/cuda_arrival.py); at 3, at most 80 registers and a few hundred bytes
// spilled, and 98,304 lanes fit the card in one wave.  Measured on the
// H100: loading words 0-31 or 0-47 before the branch on the row kind was
// slower than loading each group where it is used; the blocks per SM are
// compared by unity_webgpu_pathtracer_torch/experiments/k1_variants.py.

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
// Probe modes, on 96-float flat rows, with each lane's row index from a
// plane of its own (the lane index on a probe's synthetic rows, ptr on a
// captured state):
// - UWPT_PROBE_F16LEAF and UWPT_PROBE_BF16LEAF replace
//   experiments/round16_bf16leaf_probe.py: arrival16_run_kernel's third
//   template parameter (default UWPT_PROBE_PROD, the production code), behind
//   arrival16_run_probe_launch, one arrival in place; a lane loads row
//   rowidx[i] where the production kernel loads ptr, and BF16LEAF decodes
//   the leaf halfwords as bf16, __uint_as_float(h << 16), in place of
//   __half2float.  Bound: bytes, the production kernel's
//   (experiments/_common.py::arrivals_work with the row plane);
// - the other six replace experiments/round14_kernel_diet.py::make_kernel
//   (full, no_leaf, no_inner, no_stack, leaf_bf16, leaf_noint): a kernel
//   of their own, arrival16_diet_kernel<MODE> behind
//   arrival16_diet_launch, in place on the multi-arrival kernel's design.
//   The diet is a stripped copy of an older K1 whose child-box bytes and
//   leaf halfwords were stored interleaved (slot 4w + j in byte j of word
//   w; slot 2w + h in half h of word w), not in today's split order, so
//   its "full" is that older kernel; "leaf_noint" is the split order.  A
//   stub keeps every row load of the section it removes: the TPU loads the
//   row as one block, but nvcc would drop the loads of unused words, and
//   the diet would then price bytes, not arithmetic.  So a stub issues the
//   same loads as volatile inline-PTX ld.global.nc (keep_load4 for row
//   words, keep_load for ray planes), which nvcc cannot remove, and drops
//   only the arithmetic.
//
// Constants come from the Python side as -D macros (ops/cuda_build.py).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Instance registers of two-level tables (Wide16State's instance fields).
// The kernel is passed the same planes as input and output.
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

// Several arrivals on a state updated in place.
struct RunArgs {
  const float* nodes;                  // (N, ROWF), 16-byte aligned
  const float* o;                      // (3, B) planes
  const float* d;
  const float* inv;
  const unsigned char* live;           // (B,) bool, or null (every lane)
  const unsigned char* stop_on_found;  // (B,) bool, or null (no lane)
  // state, read and written in place (Wide16State field order)
  int* ptr;
  int* pend;
  int* sp;
  int* stack_row;                      // (D, B)
  int* stack_mask;                     // (D, B)
  float* t;
  float* u;
  float* v;
  int* tri;
  unsigned char* found;
  int b;
  int depth;
  int steps;                           // arrivals per lane, >= 1
};

// jnp.minimum / jnp.maximum: NaN-propagating.
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// Component k of a vector; k is a constant once the loops are unrolled.
__device__ __forceinline__ int lane4(const int4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// utils/math.py::safe_rcp: exact zeros nudged to 1e-30.
__device__ __forceinline__ float local_rcp(float x) { return 1.0f / (x == 0.0f ? 1.0e-30f : x); }

// A lane's scalar registers (Wide16State's (B,) fields).
struct Lane {
  int ptr, pend, sp;
  float t, u, v;
  int tri;
  bool found;
  int inst, hit_inst, sp_enter;   // HAS_INST only
};

// The rays held in registers across the arrivals of one launch.
struct RegRay {
  float o[3], d[3], inv[3], lo[3], ld[3], li[3];
  bool entered;
  __device__ float org(bool local, int c) const { return local ? lo[c] : o[c]; }
  __device__ float dir(bool local, int c) const { return local ? ld[c] : d[c]; }
  __device__ float rcp(bool local, int c) const { return local ? li[c] : inv[c]; }
  __device__ void enter(const float (&o3)[3], const float (&d3)[3]) {
    entered = true;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = o3[c];
      ld[c] = d3[c];
      li[c] = local_rcp(d3[c]);
    }
  }
};

// The stack planes updated in place: a push writes its level, a pop reads
// one; the entry of the last push stays in registers, so a pop right after
// it loads nothing.  (A push past the planes' depth is lost, as in the
// plain twin.)
struct RegStack {
  int *row, *mask;
  int i, b, depth;
  bool cached;
  int top_row, top_mask;
  __device__ void push(int lev, int r, int m) {
    cached = lev < depth;
    if (cached) {
      row[(size_t)lev * b + i] = r;
      mask[(size_t)lev * b + i] = m;
      top_row = r;
      top_mask = m;
    }
  }
  __device__ void pop(int lev, int& r, int& m) {
    if (cached) {
      r = top_row;
      m = top_mask;
    } else {
      r = row[(size_t)lev * b + i];
      m = mask[(size_t)lev * b + i];
    }
    cached = false;
  }
};

// One arrival of a live lane on its row: updates the lane's registers and
// pushes or pops the stack.
template <bool HAS_INST, int ROWF, int MODE>
__device__ __forceinline__ void arrive(Lane& L, const float* row, RegRay& R, RegStack& S) {
  static_assert(ROWF == 96 || ROWF == 48, "wide16 rows are 96 or 48 floats");
  constexpr int SLOTS = ROWF == 96 ? 16 : 8;   // triangles per leaf
  constexpr int HALF = SLOTS / 2;              // f16 words per component
  constexpr int OFF_IDX = 4 + 9 * HALF;        // attribute indices: 76 or 40
  // Word group k (words 4k..4k+3) is __ldg(r4 + k), loaded where it is used.
  const int4* r4 = reinterpret_cast<const int4*>(row);
  const int4 head = __ldg(r4);   // anchor, meta
  const int meta = head.w;
  const int ptr = L.ptr, pend = L.pend, sp = L.sp;
  const float t0 = L.t;
  // The ray this row is tested with: instance-local inside a BLAS.
  const int inst0 = L.inst;
  const bool in_blas = HAS_INST && inst0 >= 0;
  const float o0 = R.org(in_blas, 0), o1 = R.org(in_blas, 1), o2 = R.org(in_blas, 2);
  const float ax = __int_as_float(head.x), ay = __int_as_float(head.y),
              az = __int_as_float(head.z);
  bool need_pop = false, push = false;
  int entry_row = 0, entry_mask = 0;

  if (meta == 0) {
    // ---- inner: 16 quantized child boxes, slab test ----
    const float i0 = R.rcp(in_blas, 0), i1 = R.rcp(in_blas, 1), i2 = R.rcp(in_blas, 2);
    const int eword = __ldg(r4 + 1).x;
    const float s0 = __int_as_float((eword & 0xFF) << 23);
    const float s1 = __int_as_float(((eword >> 8) & 0xFF) << 23);
    const float s2 = __int_as_float(((eword >> 16) & 0xFF) << 23);
    int4 box[6], ptrs[4];   // the byte planes, words 8-31; the child pointers, 32-47
#pragma unroll
    for (int k = 0; k < 6; ++k) box[k] = __ldg(r4 + 2 + k);
#pragma unroll
    for (int k = 0; k < 4; ++k) ptrs[k] = __ldg(r4 + 8 + k);
    int hitbits = 0;
    int first = 0, first_ptr = 0;
    float best = __int_as_float(0x7f800000);  // +inf
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      // SPLIT byte order: byte j of word w holds slot 4j + w; the six
      // byte planes are words 8-31 (groups 2-7), the child pointers 32-47.
      const int wi = s & 3, sh = 8 * (s >> 2);
      const float qlx = (float)((lane4(box[0], wi) >> sh) & 0xFF);
      const float qly = (float)((lane4(box[1], wi) >> sh) & 0xFF);
      const float qlz = (float)((lane4(box[2], wi) >> sh) & 0xFF);
      const float qhx = (float)((lane4(box[3], wi) >> sh) & 0xFF);
      const float qhy = (float)((lane4(box[4], wi) >> sh) & 0xFF);
      const float qhz = (float)((lane4(box[5], wi) >> sh) & 0xFF);
      const int child = lane4(ptrs[s >> 2], s & 3);
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
      const bool hit = (t_near <= t_far) && (child >= 0) && ((pend >> s) & 1);
      if (hit) {
        hitbits |= 1 << s;
        if (t_near < best) {  // strict: the first minimum, as argmin
          best = t_near;
          first = s;
          first_ptr = child;
        }
      }
    }
    if (hitbits != 0) {
      const int rem = hitbits & ~(1 << first);
      L.ptr = first_ptr;
      L.pend = UWPT_TRAV_FULL;
      if (rem != 0) {
        push = true;
        if (__popc(rem) == 1) {
          int single = 0;
#pragma unroll
          for (int s = 0; s < 16; ++s)
            if (rem == (1 << s)) single = lane4(ptrs[s >> 2], s & 3);
          entry_row = single;
          entry_mask = 0;
        } else {
          entry_row = ptr;
          entry_mask = rem;
        }
      }
    } else {
      need_pop = true;
    }
  } else if (meta > 0) {
    // ---- leaf: up to SLOTS anchor-relative f16 triangles ----
    // SPLIT halfword order: word w of a component holds slot w (low half)
    // and w + HALF (high).  The words are read in 4-word chunks g: chunk g
    // holds slots 4g..4g+3 and HALF+4g..HALF+4g+3, so the slots are not
    // visited in order, and a tie keeps the lower slot (argmin's first
    // minimum).  tt is never NaN (the validity test sends NaN to FAR_PLANE).
    need_pop = true;
    const float d0 = R.dir(in_blas, 0), d1 = R.dir(in_blas, 1), d2 = R.dir(in_blas, 2);
    float best_t = __int_as_float(0x7f800000), best_u = 0.0f, best_v = 0.0f;
    int best_s = SLOTS, best_tri = 0;
    const int cnt = meta < SLOTS ? meta : SLOTS;
#pragma unroll
    for (int g = 0; g < HALF / 4; ++g) {
      if (4 * g >= cnt) continue;
      int4 comp[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) comp[k] = __ldg(r4 + 1 + (HALF / 4) * k + g);
      const int4 idx_lo = __ldg(r4 + (OFF_IDX + 4 * g) / 4);
      const int4 idx_hi = HALF + 4 * g < cnt
                              ? __ldg(r4 + (OFF_IDX + HALF + 4 * g) / 4)
                              : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * g + j + HALF * h;
          if (s >= cnt) continue;
          float c[9];
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const unsigned short hw =
                (unsigned short)((((unsigned int)lane4(comp[k], j)) >> (16 * h)) & 0xFFFFu);
            c[k] = MODE == UWPT_PROBE_BF16LEAF ? __uint_as_float((unsigned int)hw << 16)
                                               : __half2float(__ushort_as_half(hw));
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
          if (tt < best_t || (tt == best_t && s < best_s)) {
            best_t = tt;
            best_u = uu;
            best_v = vv;
            best_s = s;
            best_tri = lane4(h == 0 ? idx_lo : idx_hi, j);
          }
        }
      }
    }
    if (best_t < t0) {
      L.t = best_t;
      L.u = best_u;
      L.v = best_v;
      L.tri = best_tri;
      L.found = true;
      if (HAS_INST) L.hit_inst = inst0;   // the instance of the best hit (pre-update)
    }
  } else if (HAS_INST) {
    // ---- instance row: enter instance space, jump to the BLAS root ----
    // (flat tables have no meta < 0 rows.)  The 3x4 is words 4-15
    // (groups 1-3), the BLAS root word 16.
    const float ow0 = R.org(false, 0), ow1 = R.org(false, 1), ow2 = R.org(false, 2);
    const float dw0 = R.dir(false, 0), dw1 = R.dir(false, 1), dw2 = R.dir(false, 2);
    float lo3[3], ld3[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int4 m = __ldg(r4 + 1 + c);
      const float m0 = __int_as_float(m.x), m1 = __int_as_float(m.y),
                  m2 = __int_as_float(m.z), m3 = __int_as_float(m.w);
      lo3[c] = ((m0 * ow0 + m1 * ow1) + m2 * ow2) + m3;
      ld3[c] = (m0 * dw0 + m1 * dw1) + m2 * dw2;
    }
    R.enter(lo3, ld3);
    L.inst = -meta - 1;
    L.sp_enter = sp;   // no push on an instance row
    L.ptr = __ldg(r4 + 4).x;
    L.pend = UWPT_TRAV_FULL;
  }

  if (need_pop) {
    if (sp > 0) {
      int top_row, top_mask;
      S.pop(sp - 1, top_row, top_mask);
      L.ptr = top_row;
      L.pend = top_mask == 0 ? UWPT_TRAV_FULL : top_mask;
      L.sp = sp - 1;
      // Popping below the entry height returns the lane to world space.
      if (HAS_INST && inst0 >= 0 && sp - 1 < L.sp_enter) L.inst = -1;
    } else {
      L.ptr = UWPT_TRAV_DONE;
      L.pend = UWPT_TRAV_FULL;
      if (HAS_INST) L.inst = -1;
    }
  } else if (push) {
    S.push(sp, entry_row, entry_mask);
    L.sp = sp + 1;
  }
}

// Up to a.steps arrivals per lane, on the state in place.  Lane i runs
// arrival k while ptr >= 0, live[i] and not (stop_on_found[i] and found):
// the twin's one arrival (traverse_wide16.arrival_step16) applied a.steps
// times with that active mask.  MODE is UWPT_PROBE_PROD on every render
// path, where rowidx is unused and the lane loads row ptr; a leaf-decode
// probe mode (flat 96-float rows) loads row rowidx[i] instead.
template <bool HAS_INST, int ROWF, int MODE = UWPT_PROBE_PROD>
__global__ void __launch_bounds__(256, UWPT_K1_MIN_BLOCKS)
    arrival16_run_kernel(RunArgs a, InstArgs n, const int* __restrict__ rowidx) {
  static_assert(MODE == UWPT_PROBE_PROD || (!HAS_INST && ROWF == 96 &&
                                            (MODE == UWPT_PROBE_F16LEAF ||
                                             MODE == UWPT_PROBE_BF16LEAF)),
                "the leaf-decode probes run on flat 96-float rows");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int B = a.b;
  Lane L;
  L.ptr = a.ptr[i];
  if (L.ptr < 0 || (a.live != nullptr && a.live[i] == 0)) return;
  L.found = a.found[i] != 0;
  const bool stop = a.stop_on_found != nullptr && a.stop_on_found[i] != 0;
  if (stop && L.found) return;
  L.pend = a.pend[i];
  L.sp = a.sp[i];
  L.t = a.t[i];
  L.u = a.u[i];
  L.v = a.v[i];
  L.tri = a.tri[i];
  L.inst = HAS_INST ? n.inst[i] : -1;
  L.hit_inst = HAS_INST ? n.hit_inst[i] : -1;
  L.sp_enter = HAS_INST ? n.sp_enter[i] : 0;
  RegRay R;
  R.entered = false;
  // The local ray is read only by a lane already inside a BLAS; an
  // instance entry sets it otherwise.
  const bool local = HAS_INST && L.inst >= 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    R.o[c] = a.o[c * B + i];
    R.d[c] = a.d[c * B + i];
    R.inv[c] = a.inv[c * B + i];
    R.lo[c] = local ? n.local_o[c * B + i] : 0.0f;
    R.ld[c] = local ? n.local_d[c * B + i] : 0.0f;
    R.li[c] = local ? n.local_inv[c * B + i] : 0.0f;
  }
  RegStack S = {a.stack_row, a.stack_mask, i, B, a.depth, false, 0, 0};
  for (int k = 0; k < a.steps; ++k) {
    const int r = MODE == UWPT_PROBE_PROD ? L.ptr : rowidx[i];
    arrive<HAS_INST, ROWF, MODE>(L, a.nodes + (size_t)r * ROWF, R, S);
    if (L.ptr < 0 || (stop && L.found)) break;
  }
  a.ptr[i] = L.ptr;
  a.pend[i] = L.pend;
  a.sp[i] = L.sp;
  a.t[i] = L.t;
  a.u[i] = L.u;
  a.v[i] = L.v;
  a.tri[i] = L.tri;
  a.found[i] = L.found ? 1 : 0;
  if (HAS_INST) {
    n.o_inst[i] = L.inst;
    n.o_hit_inst[i] = L.hit_inst;
    n.o_sp_enter[i] = L.sp_enter;
    if (R.entered) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        n.o_local_o[c * B + i] = R.lo[c];
        n.o_local_d[c * B + i] = R.ld[c];
        n.o_local_inv[c * B + i] = R.li[c];
      }
    }
  }
}

template <bool HAS_INST, int ROWF, int MODE = UWPT_PROBE_PROD>
static int launch_run(const RunArgs* args, const InstArgs* inst, void* stream,
                      const int* rowidx = nullptr) {
  const int threads = 256;
  const int blocks = (args->b + threads - 1) / threads;
  if (args->steps < 1) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    arrival16_run_kernel<HAS_INST, ROWF, MODE>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(*args, *inst, rowidx);
  }
  return (int)cudaGetLastError();
}

extern "C" int arrival16_run_launch(const RunArgs* args, void* stream) {
  const InstArgs none = {};
  return launch_run<false, 96>(args, &none, stream);
}

extern "C" int arrival16_inst_run_launch(const RunArgs* args, const InstArgs* inst,
                                         void* stream) {
  return launch_run<true, 96>(args, inst, stream);
}

extern "C" int arrival16_leaf8_run_launch(const RunArgs* args, void* stream) {
  const InstArgs none = {};
  return launch_run<false, 48>(args, &none, stream);
}

extern "C" int arrival16_inst_leaf8_run_launch(const RunArgs* args, const InstArgs* inst,
                                               void* stream) {
  return launch_run<true, 48>(args, inst, stream);
}

// A load that nvcc keeps although its value is unused (probe stubs).
__device__ __forceinline__ void keep_load(const void* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
}
__device__ __forceinline__ void keep_load4(const int4* p) {
  int x, y, z, w;
  asm volatile("ld.global.nc.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(x), "=r"(y), "=r"(z), "=r"(w) : "l"(p));
}

constexpr int DIET_THREADS = 256;

// One arrival of round14_kernel_diet.py::make_kernel(mode), one thread per
// lane, on 96-float rows, in place, on arrival16_run_kernel's design: the
// lane's scalars live in registers, a push writes one stack entry and a pop
// reads one, a field is stored only where its value changes (found only
// where it turns true), and row words are loaded where they are used as
// 16-byte vectors.  It computes what the diet computes for every lane: the
// TPU runs both sections on every lane and keeps results by selects, so a
// section that can change a lane that is not its row kind runs for it here
// too: no_stack pops every live lane to the entry the inner section would
// push (so leaf lanes run the slab test on their leaf words), no_leaf
// offers t = FAR_PLANE + row[5] to every lane, dead ones on row 0, and with
// t > FAR_PLANE the leaf section's first slot reaches every lane.  A stub
// keeps its section's loads (keep_load4 for row words, keep_load for ray
// planes) and drops the arithmetic; no_stack reads and writes no stack
// plane.  Bound: bytes
// (experiments/_common.py::diet_work counts them by mode).  What bounds it
// on the card is the latency of the row loads, so occupancy: built, as K1
// is, for UWPT_K1_MIN_BLOCKS blocks of 256 an SM (at 3, 80 registers and at
// most 16 bytes spilled), it was faster than at 2 or 4 blocks
// (experiments/k1_variants.py), and faster than staging each warp's rows
// in shared memory by cp.async.bulk on the synthetic input and on 3 of 4
// real states (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).
template <int MODE>
__global__ void __launch_bounds__(DIET_THREADS, UWPT_K1_MIN_BLOCKS)
    arrival16_diet_kernel(RunArgs a, const int* __restrict__ rowidx) {
  constexpr bool NO_LEAF = MODE == UWPT_PROBE_NO_LEAF, NO_INNER = MODE == UWPT_PROBE_NO_INNER,
                 NO_STACK = MODE == UWPT_PROBE_NO_STACK, NOINT = MODE == UWPT_PROBE_LEAF_NOINT,
                 BF16 = MODE == UWPT_PROBE_LEAF_BF16;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = a.b;
  const bool in = i < B;
  const int ptr = in ? a.ptr[i] : UWPT_TRAV_DONE;
  const float t0 = in ? a.t[i] : 0.0f;
  const bool live = ptr >= 0 && (a.live == nullptr || a.live[i] != 0);
  // The leaf section runs on leaf lanes and, with t > FAR_PLANE, on every
  // lane (slot 0 only); a dead lane then reads row 0.
  const bool far = !NO_LEAF && in && t0 > UWPT_FAR_PLANE;
  const int4* grow =
      reinterpret_cast<const int4*>(a.nodes) + (size_t)(live ? rowidx[i] : 0) * 24;
  if (!in) return;
  const auto R = [grow](int k) { return __ldg(grow + k); };   // words 4k..4k+3
  const int4 head = (live || far) ? R(0) : make_int4(0, 0, 0, 0);   // anchor, meta
  const int meta = live ? head.w : 0;
  const bool is_leaf = live && meta > 0, is_inner = live && meta == 0;
  const float ax = __int_as_float(head.x), ay = __int_as_float(head.y),
              az = __int_as_float(head.z);
  const int pend = live ? a.pend[i] : 0, sp = live ? a.sp[i] : 0;

  // ---- inner: 16 child boxes (interleaved bytes), slab test ----
  int hitbits = 0, first = 0, first_ptr = 0;
  float best = __int_as_float(0x7f800000);  // +inf
  int4 ptrs[4] = {};
  if (is_inner || (NO_STACK && live)) {
    int4 box[6] = {};
    int eword = 0;
    float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, i0 = 0.0f, i1 = 0.0f, i2 = 0.0f;
    if (NO_INNER) {   // the row words and ray planes of the slab test
#pragma unroll
      for (int k = 1; k < 8; ++k) keep_load4(grow + k);
#pragma unroll
      for (int c = 0; c < 3; ++c) keep_load(a.inv + c * B + i);
    } else {
      i0 = a.inv[i];
      i1 = a.inv[B + i];
      i2 = a.inv[2 * B + i];
      o0 = a.o[i];
      o1 = a.o[B + i];
      o2 = a.o[2 * B + i];
      eword = R(1).x;
#pragma unroll
      for (int k = 0; k < 6; ++k) box[k] = R(2 + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) ptrs[k] = R(8 + k);
    const float s0 = __int_as_float((eword & 0xFF) << 23);
    const float s1 = __int_as_float(((eword >> 8) & 0xFF) << 23);
    const float s2 = __int_as_float(((eword >> 16) & 0xFF) << 23);
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      float t_near = 0.0f, t_far = t0;
      if (NO_INNER) {
        t_near = 0.0f + ax;
      } else {
        // INTERLEAVED byte order: slot s is byte s & 3 of word s >> 2 of
        // each 4-word byte plane (groups 2-7).
        const int w = s >> 2, sh = 8 * (s & 3);
        const float ql[3] = {(float)((lane4(box[0], w) >> sh) & 0xFF),
                             (float)((lane4(box[1], w) >> sh) & 0xFF),
                             (float)((lane4(box[2], w) >> sh) & 0xFF)};
        const float qh[3] = {(float)((lane4(box[3], w) >> sh) & 0xFF),
                             (float)((lane4(box[4], w) >> sh) & 0xFF),
                             (float)((lane4(box[5], w) >> sh) & 0xFF)};
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
      const int child = lane4(ptrs[s >> 2], s & 3);
      if ((t_near <= t_far) && (child >= 0) && ((pend >> s) & 1)) {
        hitbits |= 1 << s;
        if (t_near < best) {  // strict: the first minimum, as argmin
          best = t_near;
          first = s;
          first_ptr = child;
        }
      }
    }
  }
  const bool found_child = is_inner && best < __int_as_float(0x7f800000);
  const int rem = hitbits & ~(1 << first);
  const bool push = found_child && rem != 0;
  const bool one_left = __popc(rem) == 1;
  int entry_row = ptr;
  if (one_left) {
#pragma unroll
    for (int s = 0; s < 16; ++s)
      if (rem == (1 << s)) entry_row = lane4(ptrs[s >> 2], s & 3);
  }
  const int entry_mask = one_left ? 0 : rem;

  // ---- leaf: f16 triangles (interleaved halfwords), Moller-Trumbore ----
  bool improved = false;
  float t = t0, u = 0.0f, v = 0.0f;
  int best_s = 0;
  if (NO_LEAF) {
    if (is_leaf) {   // the leaf's comp words and the ray planes of Moller-Trumbore
      const int cnt = meta < 16 ? meta : 16;
      for (int g = 0; 8 * g < cnt; ++g)
#pragma unroll
        for (int k = 0; k < 9; ++k) keep_load4(grow + 1 + 2 * k + g);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        keep_load(a.o + c * B + i);
        keep_load(a.d + c * B + i);
      }
    }
    const float tt = UWPT_FAR_PLANE + __int_as_float(R(1).y);   // row[5] in every slot
    improved = tt < t0;
    t = tt;
  } else if (is_leaf || far) {
    // Slots at or past meta are invalid (FAR_PLANE) and never beat slot 0.
    // Component k of slot s is halfword s & 1 of word s >> 1 of its 8 words
    // (groups 1 + 2k and 2 + 2k); leaf_noint: halfword s >> 3 of word s & 7.
    // The slots are visited group by group, so a tie keeps the lower slot
    // (argmin's first minimum); tt is never NaN.
    const int cnt = is_leaf ? (meta < 16 ? meta : 16) : 1;
    const float o0 = a.o[i], o1 = a.o[B + i], o2 = a.o[2 * B + i];
    const float d0 = a.d[i], d1 = a.d[B + i], d2 = a.d[2 * B + i];
    float best_t = __int_as_float(0x7f800000), best_u = 0.0f, best_v = 0.0f;
    best_s = 16;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if ((NOINT ? 4 : 8) * g >= cnt) continue;
      int4 comp[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) comp[k] = R(1 + 2 * k + g);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = NOINT ? 4 * g + (j & 3) + 8 * (j >> 2) : 8 * g + j;
        const int w = NOINT ? (j & 3) : (j >> 1), sh = NOINT ? 16 * (j >> 2) : 16 * (j & 1);
        if (s >= cnt) continue;
        float c[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const unsigned int h = (((unsigned int)lane4(comp[k], w)) >> sh) & 0xFFFFu;
          c[k] = BF16 ? __uint_as_float(h << 16)
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
        if (tt < best_t || (tt == best_t && s < best_s)) {
          best_t = tt;
          best_u = uu;
          best_v = vv;
          best_s = s;
        }
      }
    }
    improved = best_t < t0;
    t = best_t;
    u = best_u;
    v = best_v;
  }
  if (improved) {
    // attribute indices: words 76-91 (groups 19-22)
    a.t[i] = t;
    a.u[i] = u;
    a.v[i] = v;
    a.tri[i] = lane4(R(19 + (best_s >> 2)), best_s & 3);
    if (a.found[i] == 0) a.found[i] = 1;
  }

  // ---- stack: a push writes its level, a pop reads one ----
  if (!live) return;
  const int sp_pushed = sp + (push ? 1 : 0);
  const bool need_pop = (is_inner && !found_child) || is_leaf;
  const bool has = sp_pushed > 0;
  int top_row = 0, top_mask = 0;
  if (NO_STACK) {
    top_row = entry_row;
    top_mask = entry_mask;
  } else if (push) {
    if (sp < a.depth) {
      a.stack_row[(size_t)sp * B + i] = entry_row;
      a.stack_mask[(size_t)sp * B + i] = entry_mask;
    }
  } else if (need_pop && has && sp - 1 < a.depth) {
    top_row = a.stack_row[(size_t)(sp - 1) * B + i];
    top_mask = a.stack_mask[(size_t)(sp - 1) * B + i];
  }
  const int pop_ptr = has ? top_row : UWPT_TRAV_DONE;
  const int pop_pend = top_mask == 0 ? UWPT_TRAV_FULL : top_mask;
  const int new_ptr = found_child ? first_ptr : (need_pop ? pop_ptr : ptr);
  const int new_pend = found_child ? UWPT_TRAV_FULL
                                   : (need_pop ? (has ? pop_pend : UWPT_TRAV_FULL) : pend);
  const int new_sp = need_pop && has ? sp_pushed - 1 : sp_pushed;
  if (new_ptr != ptr) a.ptr[i] = new_ptr;
  if (new_pend != pend) a.pend[i] = new_pend;
  if (new_sp != sp) a.sp[i] = new_sp;
}

template <int MODE>
static int launch_diet(const RunArgs* args, const int* rowidx, void* stream) {
  const int blocks = (args->b + DIET_THREADS - 1) / DIET_THREADS;
  if (blocks > 0)
    arrival16_diet_kernel<MODE><<<blocks, DIET_THREADS, 0, (cudaStream_t)stream>>>(*args, rowidx);
  return (int)cudaGetLastError();
}

// A kernel-diet mode (the number of one of the diet's probe macros) on
// 96-float flat rows, in place; lane i reads row rowidx[i] (row 0 where a
// dead lane reads one).
extern "C" int arrival16_diet_launch(int mode, const RunArgs* args, const int* rowidx,
                                     void* stream) {
  switch (mode) {
#define DIET_CASE(M) \
    case M: return launch_diet<M>(args, rowidx, stream);
    DIET_CASE(UWPT_PROBE_FULL)
    DIET_CASE(UWPT_PROBE_NO_LEAF)
    DIET_CASE(UWPT_PROBE_NO_INNER)
    DIET_CASE(UWPT_PROBE_NO_STACK)
    DIET_CASE(UWPT_PROBE_LEAF_BF16)
    DIET_CASE(UWPT_PROBE_LEAF_NOINT)
#undef DIET_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// A leaf-decode probe mode (UWPT_PROBE_F16LEAF or UWPT_PROBE_BF16LEAF): one
// arrival (args->steps must be 1) of the flat multi-arrival kernel on
// 96-float rows, in place; lane i reads row rowidx[i].
extern "C" int arrival16_run_probe_launch(int mode, const RunArgs* args, const int* rowidx,
                                          void* stream) {
  const InstArgs none = {};
  if (args->steps != 1 || rowidx == nullptr) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case UWPT_PROBE_F16LEAF:
      return launch_run<false, 96, UWPT_PROBE_F16LEAF>(args, &none, stream, rowidx);
    case UWPT_PROBE_BF16LEAF:
      return launch_run<false, 96, UWPT_PROBE_BF16LEAF>(args, &none, stream, rowidx);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
