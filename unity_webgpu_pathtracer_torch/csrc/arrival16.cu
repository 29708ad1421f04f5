// wide16 BVH arrival step, one thread per lane, in four instantiations:
// arrival16_launch (flat tables), arrival16_inst_launch (two-level tables
// with TLAS instance rows), and the same two on leaf8 tables,
// arrival16_leaf8_launch and arrival16_inst_leaf8_launch.
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

template <bool HAS_INST, int ROWF>
__global__ void arrival16_kernel(ArrivalArgs a, InstArgs n) {
  static_assert(ROWF == 96 || ROWF == 48, "wide16 rows are 96 or 48 floats");
  constexpr int SLOTS = ROWF == 96 ? 16 : 8;   // triangles per leaf
  constexpr int HALF = SLOTS / 2;              // f16 words per component
  constexpr int OFF_IDX = 4 + 9 * HALF;        // attribute indices: 76 or 40
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
    const float* row = a.nodes + (size_t)ptr * ROWF;
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
          c[k] = __half2float(__ushort_as_half(h));
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

template <bool HAS_INST, int ROWF>
static int launch(const ArrivalArgs* args, const InstArgs* inst, void* stream) {
  const int threads = 256;
  const int blocks = (args->b + threads - 1) / threads;
  if (blocks > 0) {
    arrival16_kernel<HAS_INST, ROWF>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(*args, *inst);
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

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
