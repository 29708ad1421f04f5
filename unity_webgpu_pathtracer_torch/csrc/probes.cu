// Hopper counterparts of the Pallas measurement probes in experiments/:
// each asks the H100 what one of them asked the TPU.  The K1 probes
// (round14_kernel_diet.py, round16_bf16leaf_probe.py) are probe modes of
// the arrival kernel in arrival16.cu.  Each kernel below names the probe
// it replaces, what bounds it on this card, and what its design does about
// that.  Built with -fmad=false (ops/cuda_build.py), so every float kernel
// rounds op for op like its plain PyTorch version (ops/cuda_probes.py).
//
// Entries (each returns a CUDA error code):
//   ring_gather_launch      P1 experiments/round2_probe.py:125
//   table_sum_launch        P2 experiments/round2_probe.py:177
//   table_sum_max_clusters  P2's cluster placement (cudaOccupancyMaxActiveClusters)
//   schlick_chain_launch    P3 experiments/round2_probe.py:271
//   remainder_check_launch  P3's remainder against fmodf over bit patterns
//   lobe_chain_launch       P6 experiments/round18_bf16_shade_probe.py:78
//   tree_gather_launch      P7 experiments/round18_vmem_tree_probe.py:63
//   intrinsic_launch        P8 experiments/round18_mosaic_probe.py:35
//   cumsum_i32_launch       P8 experiments/round18_mosaic_probe.py:35 (cumsum_i32)
//   sum_scalar_launch       P9 experiments/round18_mosaic_probe.py:111
//   step_chain_launch       P10 experiments/round20_tile3d_probe.py:58
//
// Constants shared with Python (the intrinsic op numbers, P8's scan tile,
// P9's and P2's plans, P3's remainder) come as -D macros (ops/cuda_build.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// jnp.minimum / jnp.maximum: NaN-propagating.
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The sum of a block's values v, in thread 0: a shuffle tree in each warp
// (lane l adds lane l + off), then one over the warps' sums in warp 0.
template <int THREADS>
__device__ __forceinline__ float block_tree(float v) {
  constexpr int WARPS = THREADS / 32;
  static_assert(THREADS % 32 == 0 && WARPS <= 32 && (WARPS & (WARPS - 1)) == 0,
                "whole warps, a power of two of them");
  __shared__ float warp_sum[WARPS];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < WARPS ? warp_sum[threadIdx.x] : 0.0f;
    for (int off = WARPS / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The end of a one-launch sum over blocks (P2 in device memory, P9): each
// block's threads hold their values `acc`, thread 0 the ticket it took from
// ctl at the start.  Each block publishes the tree of its values in one
// 64-bit word beside the call's tag, relaxed, with no fence: the block that
// took the last ticket waits on each word's tag instead, sums the partials
// in block order (thread t adds partials t, t + THREADS, ...; WORDS of
// them) and the tree again, and writes out[0].  It took its ticket last, so
// every block it waits on has started and waits on nothing.  The scratch
// (ops/cuda_probes.py, one per kernel, device and stream, zeroed once) is a
// control word (ticket low, epoch high), then a word a block.  It resets
// itself as the scan's does, and a word's tag is the epoch plus one, so a
// zeroed word never reads as published.  The order depends on the grid
// alone, so every call on the same inputs gives the same bits.
constexpr uint32_t SUM_EPOCH_MASK = 0x7FFFFFFFu;

template <int THREADS, int WORDS>
__device__ __forceinline__ void publish_and_sum(float acc, unsigned long long ticket,
                                                float* __restrict__ out, unsigned long long* ctl,
                                                unsigned long long* words) {
  __shared__ uint32_t s_tag, s_last;
  if (threadIdx.x == 0) {
    const uint32_t epoch = (uint32_t)(ticket >> 32);
    s_tag = epoch + 1;
    s_last = (uint32_t)ticket == gridDim.x - 1;
    // Every block has its ticket and epoch once the last ticket is taken.
    if (s_last) atomicExch(ctl, (unsigned long long)((epoch + 1) & SUM_EPOCH_MASK) << 32);
  }
  const float total = block_tree<THREADS>(acc);   // its barrier publishes s_tag and s_last
  const unsigned long long tag = s_tag;
  if (threadIdx.x == 0) st_relaxed(&words[blockIdx.x], tag << 32 | __float_as_uint(total));
  if (!s_last) return;
  __syncthreads();   // warp 0 is done with warp_sum before block_tree fills it again
  unsigned long long w[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int j = k * THREADS + threadIdx.x;
    w[k] = j < (int)gridDim.x ? ld_relaxed(&words[j]) : tag << 32;
  }
  float part = 0.0f;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int j = k * THREADS + threadIdx.x;
    while ((w[k] >> 32) != tag) w[k] = ld_relaxed(&words[j]);
    if (j < (int)gridDim.x) part += __uint_as_float((uint32_t)w[k]);
  }
  const float sum = block_tree<THREADS>(part);
  if (threadIdx.x == 0) out[0] = sum;
}

// ---------------------------------------------------------------- P1
// Per-row async gather through a ring (round2_probe.py dma_gather): out is
// the column sum of the rows table[idx[k]] of the last 16 k, the original's
// 16-slot ring (copy k lands in slot k % 16).  Every one of the chunk rows
// is brought into shared memory by its own TMA bulk copy (cp.async.bulk
// global -> shared, 512 bytes) that completes on its ring slot's mbarrier:
// Hopper's make_async_copy and DMA semaphore.  Bound: bytes (each row and
// index once), but a copy's round trip (~1.5 us) bounds any one issuer, so
// the card must hold about latency x bandwidth (~5 MB) in flight.  The
// design: a block on every SM, each over a contiguous slice of k of 16 to
// RING_MAX_ROWS (beyond that, more blocks than SMs), cut back from the end
// so the last block holds the last 16 k and writes out; the block stages
// its slice of idx in shared memory with one coalesced load, then one warp
// issues a copy per lane into a ring of RING_DEPTH slots and reissues a
// slot once its previous copy has landed.  132 blocks of 64 slots hold 4.3
// MB in flight: the whole of an 8,192-row chunk.
constexpr int RING_W = 128, RING_SLOTS = 16, RING_DEPTH = 64, RING_MAX_ROWS = 1024;
static_assert(RING_DEPTH % 32 == 0 && RING_DEPTH >= RING_SLOTS,
              "a warp's copies take distinct slots; the last 16 k stay in the ring");

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__global__ void __launch_bounds__(RING_W)
    ring_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx, int chunk,
                       int per, float* __restrict__ out) {
  __shared__ alignas(128) float ring[RING_DEPTH][RING_W];
  __shared__ alignas(8) uint64_t bars[RING_DEPTH];
  __shared__ int rows[RING_MAX_ROWS];
  // This block's k: [lo, hi), slices of `per` counted back from the end.
  const int hi = chunk - (int)(gridDim.x - 1 - blockIdx.x) * per;
  const int lo = max(hi - per, 0), n = hi - lo;
  for (int j = threadIdx.x; j < n; j += blockDim.x) rows[j] = idx[lo + j];
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_DEPTH; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bars[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // Row j goes to slot j % RING_DEPTH as that slot's use j / RING_DEPTH,
    // which is the barrier's phase of the same number: one arrival and
    // 512 bytes of transaction a phase.
    const int lane = threadIdx.x;
    for (int j = lane; j < n; j += 32) {
      const int s = j % RING_DEPTH;
      const uint32_t bar = smem_addr(&bars[s]);
      if (j >= RING_DEPTH) mbar_wait(bar, (j / RING_DEPTH - 1) & 1);   // the slot's last copy
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(RING_W * 4)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_addr(ring[s])),
          "l"(table + (size_t)rows[j] * RING_W), "r"(RING_W * 4), "r"(bar)
          : "memory");
    }
    // No copy may land after the block has left: wait for each slot's last
    // (every lane has issued its copies, so no slot is a phase behind).
    __syncwarp();
    for (int j = max(n - RING_DEPTH, 0) + lane; j < n; j += 32)
      mbar_wait(smem_addr(&bars[j % RING_DEPTH]), (j / RING_DEPTH) & 1);
  }
  if (blockIdx.x != gridDim.x - 1) return;
  __syncthreads();   // warp 0 has seen every slot's last copy land
  // The original's slot s holds k_s, the last k < chunk with k % 16 == s.
  // Every thread waits on that copy's phase (complete by now), so the async
  // write is visible to it.
  const int used = chunk < RING_SLOTS ? chunk : RING_SLOTS;
  float acc = 0.0f;
  for (int s = 0; s < used; ++s) {
    const int j = s + (chunk - 1 - s) / RING_SLOTS * RING_SLOTS - lo;
    mbar_wait(smem_addr(&bars[j % RING_DEPTH]), (j / RING_DEPTH) & 1);
    acc += ring[j % RING_DEPTH][threadIdx.x];
  }
  out[threadIdx.x] = acc;
}

extern "C" int ring_gather_launch(const float* table, const int* idx, int chunk, float* out,
                                  void* stream) {
  // A slice of k for each SM, 16 to RING_MAX_ROWS long; the slices tile
  // [0, chunk) from the end, the first one short if they do not divide it.
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (chunk < 0) return (int)cudaErrorInvalidValue;
  const int per = min(RING_MAX_ROWS, max(RING_SLOTS, (chunk + sms - 1) / sms));
  const int blocks = max(1, (chunk + per - 1) / per);
  ring_gather_kernel<<<blocks, RING_W, 0, (cudaStream_t)stream>>>(table, idx, chunk, per, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- P2
// Dynamic row reads from a table held on chip (round2_probe.py
// vmem_gather): out = sum_k table[idx[k], 0] over an (N, 48) f32 table.
// Bound: bytes (the distinct rows' column 0, the index, the output), a few
// kilobytes: far below what one launch costs, so what bounds a call on
// this card is latency, the round trips it waits on one after another.
// Both modes make one launch a call and put every row read of a thread in
// flight before its first add.
//
// In device memory (the TPU's 2-24 MB tables, held by the 50 MB L2):
// blocks of TABLE_THREADS, one index a thread a round, as many blocks as
// the plan (cuda_probes.table_plan, cut by n_idx alone) gives: 32 blocks
// at the probe's 4,096 indices.  A thread loads its index (coalesced),
// then its row's word, then adds; the blocks' sums meet in
// publish_and_sum (P9's design, its own scratch), so a call waits on an
// index trip, a row trip and the partials' trip.
constexpr int P2_W = 48;
constexpr int TABLE_THREADS = UWPT_TABLE_THREADS;
constexpr int TABLE_WORDS = UWPT_TABLE_MAX_BLOCKS / TABLE_THREADS;
static_assert(TABLE_WORDS >= 1 && TABLE_WORDS * TABLE_THREADS == UWPT_TABLE_MAX_BLOCKS,
              "the last block's threads read the partials in whole rounds");

__global__ void __launch_bounds__(TABLE_THREADS)
    table_sum_kernel(const float* __restrict__ table, const int* __restrict__ idx, int n_idx,
                     int rounds, float* __restrict__ out, unsigned long long* ctl,
                     unsigned long long* words) {
  unsigned long long ticket = 0;
  if (threadIdx.x == 0) ticket = atomicAdd(ctl, 1ull);   // comes back while the loads fly
  float acc = 0.0f;
  for (int r = 0; r < rounds; ++r) {
    const int i = (blockIdx.x * rounds + r) * TABLE_THREADS + threadIdx.x;
    const int k = i < n_idx ? __ldg(idx + i) : 0;
    const float v = __ldg(table + (size_t)k * P2_W);
    if (i < n_idx) acc += v;
  }
  publish_and_sum<TABLE_THREADS, TABLE_WORDS>(acc, ticket, out, ctl, words);
}

// On chip: the table lives in the distributed shared memory of one thread
// block cluster of C blocks (cuda_probes.table_cluster_plan: 8, the
// portable maximum, or 16 where 8 blocks cannot hold it), rank r holding
// rows [r * per, r * per + per).  A rank stages its rows with one bulk copy
// (cp.async.bulk global -> shared) that completes on an mbarrier armed
// with its bytes, while its threads load their indices.  After
// cluster.sync(), rank r takes the r-th of C slices of the indices and
// reads column 0 of each row from the owning rank (map_shared_rank), every
// read of a round in flight before the adds.  Each rank writes the tree of
// its values into rank 0's shared memory, and after a second cluster.sync()
// rank 0 adds the C partials in rank order and writes out.  No rank leaves
// before that barrier, so none leaves while another reads its rows; rank 0
// then reads only its own memory.  Staging falls C-fold a block against a
// one-block table (24 KB a block at 192 KB), and a 192-byte row keeps every
// copy a whole number of 16-byte granules.
constexpr int TABLE_CL_THREADS = 256, TABLE_CL_VEC = 2, TABLE_CL_MAX = 16;
constexpr int TABLE_CL_STEP = TABLE_CL_THREADS * TABLE_CL_VEC;

__global__ void __launch_bounds__(TABLE_CL_THREADS)
    table_sum_cluster_kernel(const float* __restrict__ table, int n_rows, int per,
                             const int* __restrict__ idx, int n_idx, float* __restrict__ out) {
  extern __shared__ __align__(16) float rows[];
  __shared__ alignas(8) uint64_t bar;
  __shared__ float partial[TABLE_CL_MAX];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), c = (int)cluster.num_blocks();
  const int mine = max(0, min(per, n_rows - rank * per));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (mine > 0) {
      const uint32_t bytes = (uint32_t)mine * P2_W * 4;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(&bar)),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_addr(rows)),
          "l"(table + (size_t)rank * per * P2_W), "r"(bytes), "r"(smem_addr(&bar))
          : "memory");
    }
  }
  // This rank's slice of the indices, [lo, hi), TABLE_CL_STEP a round;
  // the first round's indices are loaded while the rows land.  A slot past
  // hi reads row 0 and adds nothing.
  const int each = (n_idx + c - 1) / c, lo = min(n_idx, rank * each), hi = min(n_idx, lo + each);
  int k[TABLE_CL_VEC];
  auto load_idx = [&](int first) {
#pragma unroll
    for (int j = 0; j < TABLE_CL_VEC; ++j) {
      const int i = first + j * TABLE_CL_THREADS + (int)threadIdx.x;
      k[j] = i < hi ? __ldg(idx + i) : 0;
    }
  };
  load_idx(lo);
  __syncthreads();   // the barrier is initialised before any thread waits on it
  if (mine > 0) mbar_wait(smem_addr(&bar), 0);
  cluster.sync();    // every rank's rows have landed
  float acc = 0.0f;
  for (int first = lo; first < hi; first += TABLE_CL_STEP) {
    float v[TABLE_CL_VEC];
#pragma unroll
    for (int j = 0; j < TABLE_CL_VEC; ++j)
      v[j] = cluster.map_shared_rank(rows, k[j] / per)[(k[j] % per) * P2_W];
    if (first + TABLE_CL_STEP < hi) load_idx(first + TABLE_CL_STEP);
#pragma unroll
    for (int j = 0; j < TABLE_CL_VEC; ++j)
      if (first + j * TABLE_CL_THREADS + (int)threadIdx.x < hi) acc += v[j];
  }
  const float total = block_tree<TABLE_CL_THREADS>(acc);
  if (threadIdx.x == 0) *cluster.map_shared_rank(&partial[rank], 0) = total;
  cluster.sync();    // every partial is in rank 0; no rank reads another's rows after this
  if (rank == 0 && threadIdx.x == 0) {
    float sum = 0.0f;
    for (int q = 0; q < c; ++q) sum += partial[q];
    out[0] = sum;
  }
}

// Raised once, at the first call of either entry (before any graph
// capture): the largest staging a rank may take, and clusters of 16.
static cudaError_t table_cluster_ready() {
  static bool ready = false;
  if (ready) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(table_sum_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       UWPT_TABLE_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(table_sum_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  ready = e == cudaSuccess;
  return e;
}

static cudaLaunchConfig_t table_cluster_config(int c, int per, cudaLaunchAttribute* attr,
                                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, 1, 1);
  cfg.blockDim = dim3(TABLE_CL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)per * P2_W * 4;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// on_chip: blocks = the cluster's C, per = rows a rank (scratch unused);
// else: blocks and per = rounds a block, scratch the sum's (a control word,
// then a word a block).  The plan is cuda_probes.table_plan's or
// table_cluster_plan's; the entry checks that it covers the work.
extern "C" int table_sum_launch(const float* table, int n_rows, const int* idx, int n_idx,
                                float* out, int on_chip, int blocks, int per, void* scratch,
                                int scratch_words, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_rows < 1 || n_idx < 0 || blocks < 1 || per < 1) return (int)cudaErrorInvalidValue;
  if (on_chip) {
    if (blocks > TABLE_CL_MAX || (long long)blocks * per < n_rows ||
        (long long)per * P2_W * 4 > UWPT_TABLE_SMEM || (uintptr_t)table % 16)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = table_cluster_ready();
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = table_cluster_config(blocks, per, &attr, st);
    e = cudaLaunchKernelEx(&cfg, table_sum_cluster_kernel, table, n_rows, per, idx, n_idx, out);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (blocks > UWPT_TABLE_MAX_BLOCKS ||
      (long long)blocks * per * TABLE_THREADS < n_idx || scratch_words < 1 + blocks)
    return (int)cudaErrorInvalidValue;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  table_sum_kernel<<<blocks, TABLE_THREADS, 0, st>>>(table, idx, n_idx, per, out, words,
                                                     words + 1);
  return (int)cudaGetLastError();
}

// How many clusters of c blocks, each staging per rows, the card can hold
// at once (cudaOccupancyMaxActiveClusters), into *count; 0: none fits.
extern "C" int table_sum_max_clusters(int c, int per, int* count) {
  cudaError_t e = table_cluster_ready();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = table_cluster_config(c, per, &attr, 0);
  return (int)cudaOccupancyMaxActiveClusters(count, table_sum_cluster_kernel, &cfg);
}

// ---------------------------------------------------------------- P3
// A Schlick-like chain (round2_probe.py shade_pallas): 40 blocks of a pow
// chain, sqrt, abs and remainder per element, one thread per element,
// unrolled.  jnp.remainder of a non-negative value is fmodf.  Bound:
// operations (17 f32 operations a block at the issue rate, sqrt and the
// remainder one each): 262,144 lanes fill the card with ~62 warps an SM,
// so latency is hidden and instruction issue binds (two lanes a thread
// measured slower).  CUDA's fmodf is a general loop over the exponent
// difference with special cases; the chain only divides |acc * 0.3 + 0.1|
// by 0.9, so rem09_short takes a few instructions and is exact for
// 0 <= a < REM_LIMIT: q is the nearest integer to a * INV (INV the
// f32-rounded 1 / 0.9f; adding and taking away 1.5 * 2^23 rounds to an
// integer, exactly below 2^22), so |a / 0.9f - q| < 1/2 + 2^-12 and
// r = a - q * 0.9f lies in (-0.9f, 0.9f).  q = 0 gives r = a.  q >= 1
// needs a > 0.44, and there a and 0.9f are multiples of 2^-25, so r is
// too: where a >= 0.5 both are multiples of 2^-24 and |r| < 1, and where
// a < 0.5, q = 1 and |r| = 0.9f - a lies in (0.4, 0.46], below 0.5.
// Either way r is a float, which the explicit fma does not round.  One
// correction (r < 0: r + 0.9f, again exact) lands on
// fmod's result.  q = 0 gives a itself, denormals included (no flush to
// zero in this build).  rem09 adds the general case (at or above
// REM_LIMIT, Inf, NaN): fmodf, out of line (inlined in every block it
// slowed every block).  remainder_check_launch holds rem09 against fmodf
// on every non-negative bit pattern.
//
// The first block runs with rem09.  After it v lies in [0.05, 0.95), so
// each later block adds to acc between 0 and 1.7 (f <= 0.95^5, g < 0.952);
// where |acc| < REM_SAFE_ACC then, every later dividend stays below
// 0.3 * (REM_SAFE_ACC + 39 * 1.7) + 0.1 < 320 < REM_LIMIT, and the 39 later
// blocks take rem09_short with no test or branch.  Any other lane (an input
// far outside [0, 1], Inf or NaN) runs them with rem09.  IEEE sqrtf stays
// (torch.sqrt's rounding).
constexpr float REM_D = UWPT_REM_DIVISOR, REM_INV = UWPT_REM_INV, REM_LIMIT = UWPT_REM_LIMIT;
constexpr float REM_ROUND = 12582912.0f;   // 1.5 * 2^23
constexpr float REM_SAFE_ACC = 1000.0f;

__device__ __noinline__ float fmod_general(float a) { return fmodf(a, REM_D); }

__device__ __forceinline__ float rem09_short(float a) {
  const float q = (a * REM_INV + REM_ROUND) - REM_ROUND;
  float r = __fmaf_rn(-q, REM_D, a);   // -fmad=false stops only contraction
  if (r < 0.0f) r += REM_D;
  return r;
}

__device__ __forceinline__ float rem09(float a) {
  return a < REM_LIMIT ? rem09_short(a) : fmod_general(a);
}

// One block of the chain; CHECKED: its remainder by rem09, else by
// rem09_short.
template <bool CHECKED>
__device__ __forceinline__ void schlick_block(float& v, float& acc) {
  const float w = 1.0f - v;
  const float w2 = w * w;
  const float f = w2 * w2 * w;
  const float g = sqrtf(fabsf(v * 0.9f + 0.05f));
  acc = acc + f * g + v * (1.0f - f);
  const float a = fabsf(acc * 0.3f + 0.1f);
  v = (CHECKED ? rem09(a) : rem09_short(a)) + 0.05f;
}

__global__ void schlick_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i], acc = 0.0f;
  schlick_block<true>(v, acc);
  if (fabsf(acc) < REM_SAFE_ACC) {
#pragma unroll
    for (int k = 1; k < 40; ++k) schlick_block<false>(v, acc);
  } else {
#pragma unroll
    for (int k = 1; k < 40; ++k) schlick_block<true>(v, acc);
  }
  out[i] = acc;
}

extern "C" int schlick_chain_launch(const float* x, float* out, int n, void* stream) {
  const int threads = 256;
  if (n > 0)
    schlick_chain_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(x, out,
                                                                                           n);
  return (int)cudaGetLastError();
}

// rem09 against fmodf(a, 0.9f) on the count bit patterns first, first + 1,
// ... (as uint32; 2^31 from 0: every non-negative float, Inf and NaN
// included): bits equal, or both NaN.  Adds the mismatches to *mismatches.
constexpr int REM_CHECK_THREADS = 256, REM_CHECK_PER = 8;

__global__ void __launch_bounds__(REM_CHECK_THREADS)
    remainder_check_kernel(long long first, long long count,
                           unsigned long long* __restrict__ mismatches) {
  const long long start =
      ((long long)blockIdx.x * REM_CHECK_THREADS * REM_CHECK_PER) + threadIdx.x;
  unsigned bad = 0;
#pragma unroll
  for (int j = 0; j < REM_CHECK_PER; ++j) {
    const long long i = start + (long long)j * REM_CHECK_THREADS;
    if (i >= count) break;
    const float a = __uint_as_float((uint32_t)(first + i));
    const float r = rem09(a), f = fmodf(a, REM_D);
    bad += !(__float_as_uint(r) == __float_as_uint(f) || (r != r && f != f));
  }
  bad = __reduce_add_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(mismatches, (unsigned long long)bad);
}

extern "C" int remainder_check_launch(long long first, long long count, void* mismatches,
                                      void* stream) {
  if (first < 0 || count < 0 || first + count > (1ll << 32)) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)REM_CHECK_THREADS * REM_CHECK_PER;
  const long long blocks = (count + per_block - 1) / per_block;
  if (blocks > 0)
    remainder_check_kernel<<<(unsigned)blocks, REM_CHECK_THREADS, 0, (cudaStream_t)stream>>>(
        first, count, static_cast<unsigned long long*>(mismatches));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- P6
// A Disney lobe chain (round18_bf16_shade_probe.py): 64 repeats of the
// schlick + GTR2 + Smith + Fresnel mix, accumulated in f32, in f32 or in
// bf16.  The TPU's three layouts ((B,), (8, B/8), (16, B/16)) are the same
// bytes on the card, so one flat kernel serves all three.  One lane a
// thread in both dtypes: bf16 adds, subtracts, multiplies, takes min and
// max in scalar bf16 instructions (the .rn forms, never contracted into an
// fma); it divides and takes square roots as PyTorch does, by the IEEE f32
// division and sqrtf, rounded to bf16.  Bound: operations (f32: 68 a
// repeat; bf16: 61 lane-operations a repeat at the packed bf16 rate and 13
// at the f32 rate: the divisions, square roots, their roundings to bf16
// and the sum).  Each lane's chain is one long dependent sequence, so what
// bounds the kernel on the card is latency: how many independent chains
// each scheduler holds.  Blocks of LOBE_THREADS give 1,024 blocks at
// B = 65,536, all resident on 132 SMs.  Measured on an NVIDIA H100 80GB
// HBM3, 700.00 W (round18_bf16_shade_probe.py, PERF.md section 6), one
// lane a thread was faster in both dtypes than two lanes a thread (f32
// interleaved, bf16 packed in __nv_bfloat162), and IEEE division faster
// than an approximate reciprocal with a test for bf16 rounding midpoints;
// blocks of 32 to 256 threads were within 0.0006 ms.
constexpr int LOBE_THREADS = 64;

__device__ __forceinline__ unsigned short u16_of(__nv_bfloat16 a) {
  return *reinterpret_cast<unsigned short*>(&a);
}
__device__ __forceinline__ __nv_bfloat16 b1_of(unsigned short u) {
  return *reinterpret_cast<__nv_bfloat16*>(&u);
}
#define BF16_OP(fn, ptx)                                                     \
  __device__ __forceinline__ __nv_bfloat16 fn(__nv_bfloat16 a, __nv_bfloat16 b) { \
    unsigned short r;                                                        \
    asm(ptx " %0, %1, %2;" : "=h"(r) : "h"(u16_of(a)), "h"(u16_of(b)));      \
    return b1_of(r);                                                         \
  }
BF16_OP(vadd, "add.rn.bf16")
BF16_OP(vsub, "sub.rn.bf16")
BF16_OP(vmul, "mul.rn.bf16")
BF16_OP(vmin, "min.bf16")
BF16_OP(vmax, "max.bf16")
#undef BF16_OP
__device__ __forceinline__ __nv_bfloat16 vdiv(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) / __bfloat162float(b));
}
__device__ __forceinline__ __nv_bfloat16 vsqrt(__nv_bfloat16 a) {
  return __float2bfloat16_rn(sqrtf(__bfloat162float(a)));
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float vsub(float a, float b) { return a - b; }
__device__ __forceinline__ float vmul(float a, float b) { return a * b; }
__device__ __forceinline__ float vdiv(float a, float b) { return a / b; }
__device__ __forceinline__ float vmin(float a, float b) { return jmin(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return jmax(a, b); }
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }

template <typename T>
__device__ __forceinline__ T cst(float v);
template <>
__device__ __forceinline__ float cst<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cst<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float wide(float x) { return x; }
__device__ __forceinline__ float wide(__nv_bfloat16 x) { return __bfloat162float(x); }

// round18_bf16_shade_probe.py::_chain, in its expression order.
template <typename T>
__device__ __forceinline__ void lobe_chain(T& x, T& y, T& z) {
  const T one = cst<T>(1.0f), zero = cst<T>(0.0f);
  const T m = vmin(vmax(vsub(one, x), zero), one);
  const T m2 = vmul(m, m);
  const T fh = vmul(vmul(m2, m2), m);
  const T a = vadd(vmul(x, cst<T>(0.3f)), cst<T>(0.001f));
  const T b = vadd(vmul(y, cst<T>(0.7f)), cst<T>(0.001f));
  const T c = vadd(vadd(vmul(a, a), vmul(b, b)), vmul(z, z));
  const T d = vdiv(one, vmul(vmul(vmul(vmul(cst<T>(3.14159265f), a), b), c), c));
  const T g1 = vdiv(vmul(cst<T>(2.0f), z),
                    vadd(z, vsqrt(vmax(vsub(vadd(vmul(a, a), vmul(z, z)),
                                            vmul(vmul(vmul(a, a), z), z)),
                                       zero))));
  const T eta = cst<T>(1.5f);
  const T s2 = vmul(vmul(eta, eta), vsub(one, vmul(x, x)));
  const T ct = vsqrt(vmax(vsub(one, s2), zero));
  const T rs = vdiv(vsub(vmul(eta, ct), x), vadd(vadd(vmul(eta, ct), x), cst<T>(1e-6f)));
  const T rp = vdiv(vsub(vmul(eta, x), ct), vadd(vadd(vmul(eta, x), ct), cst<T>(1e-6f)));
  const T fres = vmul(cst<T>(0.5f), vadd(vmul(rs, rs), vmul(rp, rp)));
  const T f = vmul(vmul(d, g1), vadd(fres, vmul(vsub(one, fres), fh)));
  x = vadd(vmul(f, cst<T>(0.25f)), vmul(x, cst<T>(0.125f)));
  y = vadd(vmul(y, f), cst<T>(0.01f));
  z = vadd(z, vmul(f, cst<T>(1e-3f)));
}

constexpr int LOBE_REPEATS = 64;

// Lane i in thread i, in T.
template <typename T>
__global__ void lobe_chain_kernel(const float* __restrict__ xin, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = xin[i];
  T x = cst<T>(xi), y = cst<T>(xi * 0.5f), z = cst<T>(xi * 0.25f + 0.1f);
  float acc = 0.0f;
  for (int r = 0; r < LOBE_REPEATS; ++r) {
    lobe_chain(x, y, z);
    acc = acc + wide(x);
  }
  out[i] = acc;
}

extern "C" int lobe_chain_launch(const float* x, float* out, int n, int bf16, void* stream) {
  const int blocks = (n + LOBE_THREADS - 1) / LOBE_THREADS;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n > 0 && bf16)
    lobe_chain_kernel<__nv_bfloat16><<<blocks, LOBE_THREADS, 0, st>>>(x, out, n);
  else if (n > 0)
    lobe_chain_kernel<float><<<blocks, LOBE_THREADS, 0, st>>>(x, out, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- P7
// The upper tree held on chip (round18_vmem_tree_probe.py): out[k] =
// float(table[idx[k]]) for a (4096, 96) bf16 table, and a row of zeros
// where idx[k] lies outside [0, 4096), as the TPU's one-hot product gives.
// The TPU priced a one-hot MXU product from VMEM.  On Hopper the table
// (768 KB) stays in the 50 MB L2, which is on chip too: its loads carry an
// L2 evict-last policy, and the output (384 bytes a lane, 12.6 MB at the
// probe's 32,768 lanes) goes out by streaming stores, so that it does not
// push the table out.  Bound: bytes (the output, the index and the
// distinct rows), most of them the output.  The grid covers every SM: a
// warp takes TG_LANES lanes, loads their indices once (a thread a lane)
// and shuffles each to the threads that read its row; each thread has
// TG_PER 8-byte pieces (4 bf16) in flight before it widens them, and each
// piece leaves as one float4, so a warp's store writes 512 contiguous
// bytes.  No staging and no barrier.  On an H100 (NVIDIA H100 80GB HBM3,
// 700.00 W) it takes 0.0054-0.0056 ms with a cold L2 at the probe's size,
// against a bound of 0.0040 and a launch floor of 0.0013.  Slower there,
// in the same call: the previous design, the table in the distributed
// shared memory of 16 clusters of 4 blocks (0.0216-0.0218 cold), and
// clusters of 4, 8 or 16 over every SM staged by bulk copies
// (0.0112-0.0141), each cluster staging the whole table (PERF.md section 6).
constexpr int TG_ROWS = 4096, TG_COLS = 96, TG_PIECES = TG_COLS / 4;   // 8-byte pieces a row
constexpr int TG_LANES = 4, TG_THREADS = 256;
constexpr int TG_PER = TG_LANES * TG_PIECES / 32;                      // pieces a thread
static_assert(TG_LANES * TG_PIECES % 32 == 0, "a warp's pieces fill its threads evenly");

__device__ __forceinline__ uint2 ld_evict_last(const uint2* p, uint64_t policy) {
  uint2 v;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p), "l"(policy));
  return v;
}

// bf16 -> f32 is the halfword moved to the top; element 0 is the low half.
__device__ __forceinline__ float4 widen_bf16x4(uint2 q) {
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xFFFF0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xFFFF0000u));
}

__global__ void __launch_bounds__(TG_THREADS)
    tree_gather_kernel(const uint2* __restrict__ table, const int* __restrict__ idx, int n,
                       float4* __restrict__ out) {
  const int t = threadIdx.x & 31;
  const int first = (int)((blockIdx.x * TG_THREADS + threadIdx.x) >> 5) * TG_LANES;
  if (first >= n) return;   // the whole warp
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  const int mine = t < TG_LANES && first + t < n ? __ldg(idx + first + t) : -1;
  uint2 q[TG_PER];
#pragma unroll
  for (int k = 0; k < TG_PER; ++k) {
    const int e = 32 * k + t;   // piece e % TG_PIECES of lane first + e / TG_PIECES
    const int r = __shfl_sync(0xffffffffu, mine, e / TG_PIECES);
    q[k] = (unsigned)r < (unsigned)TG_ROWS
               ? ld_evict_last(table + (size_t)r * TG_PIECES + e % TG_PIECES, policy)
               : make_uint2(0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < TG_PER; ++k) {
    const int e = 32 * k + t;
    if (first + e / TG_PIECES < n) __stcs(out + (size_t)first * TG_PIECES + e, widen_bf16x4(q[k]));
  }
}

extern "C" int tree_gather_launch(const void* table, const int* idx, int n, float* out,
                                  void* stream) {
  if (n < 0 || (uintptr_t)table % 8 || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  const long long warps = ((long long)n + TG_LANES - 1) / TG_LANES;
  const int blocks = (int)((warps * 32 + TG_THREADS - 1) / TG_THREADS);
  if (blocks > 0)
    tree_gather_kernel<<<blocks, TG_THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const uint2*>(table), idx, n, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- P8
// The ops the TPU probe asked Mosaic for (round18_mosaic_probe.py), with
// CUDA's accurate library functions (never fast math): a uint32 PCG step,
// uint32 -> f32 times 1/4294967295, sin, cos, log, exp, sqrt, acos, atan,
// atan2, pow; cumsum over int32 is a kernel of its own (below).  Bound:
// bytes (one op per element).  One instantiation per op (the template
// parameter), so each carries only its own op's registers and no thread
// branches on the op.  The nine unary ops move 16-byte vectors of 4
// elements in a loop over blocks sized to the SMs, and block 0 takes the
// n % 4 tail element by element.  atan2 and pow, whose library functions
// branch and take longest, run one element a thread with 4-byte loads:
// a thread's 4 calls would run one after another, which measured slower.
// Every operand must start on a 16-byte boundary, the same rule for every
// op.  Every value passes as its 32 bits.
constexpr int INTR_THREADS = 256, INTR_BLOCKS_PER_SM = 8;

__host__ __device__ constexpr bool intrinsic_binary(int op) {
  return op == UWPT_OP_ARCTAN2 || op == UWPT_OP_POWER;
}

template <int OP>
__device__ __forceinline__ uint32_t intrinsic_op(uint32_t a, uint32_t b) {
  const float fa = __uint_as_float(a), fb = __uint_as_float(b);
  if constexpr (OP == UWPT_OP_PCG_UINT32) {
    const uint32_t old = a + 747796405u + 2891336453u;
    const uint32_t shift = (old >> 28) + 4u;
    const uint32_t word = ((old >> shift) ^ old) * 277803737u;
    return (word >> 22) ^ word;
  } else if constexpr (OP == UWPT_OP_U32_TO_F32) {
    return __float_as_uint(__uint2float_rn(a) * (float)(1.0 / 4294967295.0));
  } else if constexpr (OP == UWPT_OP_SIN) {
    return __float_as_uint(sinf(fa));
  } else if constexpr (OP == UWPT_OP_COS) {
    return __float_as_uint(cosf(fa));
  } else if constexpr (OP == UWPT_OP_LOG) {
    return __float_as_uint(logf(fa));
  } else if constexpr (OP == UWPT_OP_EXP) {
    return __float_as_uint(expf(fa));
  } else if constexpr (OP == UWPT_OP_SQRT) {
    return __float_as_uint(sqrtf(fa));
  } else if constexpr (OP == UWPT_OP_ARCCOS) {
    return __float_as_uint(acosf(fa));
  } else if constexpr (OP == UWPT_OP_ARCTAN) {
    return __float_as_uint(atanf(fa));
  } else if constexpr (OP == UWPT_OP_ARCTAN2) {
    return __float_as_uint(atan2f(fa, fb));
  } else {
    static_assert(OP == UWPT_OP_POWER, "an op of cuda_probes.INTRINSICS");
    return __float_as_uint(powf(fa, fb));
  }
}

template <int OP>
__global__ void __launch_bounds__(INTR_THREADS)
    intrinsic_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, int n) {
  const int first = blockIdx.x * INTR_THREADS + threadIdx.x, stride = gridDim.x * INTR_THREADS;
  if constexpr (intrinsic_binary(OP)) {
    for (int i = first; i < n; i += stride) out[i] = intrinsic_op<OP>(a[i], b[i]);
  } else {
    const int n4 = n >> 2;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int i = first; i < n4; i += stride) {
      const uint4 p = a4[i];
      o4[i] = make_uint4(intrinsic_op<OP>(p.x, 0u), intrinsic_op<OP>(p.y, 0u),
                         intrinsic_op<OP>(p.z, 0u), intrinsic_op<OP>(p.w, 0u));
    }
    if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
      const int i = (n4 << 2) + threadIdx.x;
      out[i] = intrinsic_op<OP>(a[i], 0u);
    }
  }
}

template <int OP>
int intrinsic_run(const void* a, const void* b, void* out, int n, cudaStream_t stream) {
  if (((uintptr_t)a | (uintptr_t)out | (intrinsic_binary(OP) ? (uintptr_t)b : 0)) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int threads = intrinsic_binary(OP) ? n : n / 4;
  const int blocks =
      max(1, min((threads + INTR_THREADS - 1) / INTR_THREADS, sms * INTR_BLOCKS_PER_SM));
  intrinsic_kernel<OP><<<blocks, INTR_THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" int intrinsic_launch(int op, const void* a, const void* b, void* out, int n,
                                void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
#define INTRINSIC_CASE(OP) \
  case OP: return intrinsic_run<OP>(a, b, out, n, s);
    INTRINSIC_CASE(UWPT_OP_PCG_UINT32)
    INTRINSIC_CASE(UWPT_OP_U32_TO_F32)
    INTRINSIC_CASE(UWPT_OP_SIN)
    INTRINSIC_CASE(UWPT_OP_COS)
    INTRINSIC_CASE(UWPT_OP_LOG)
    INTRINSIC_CASE(UWPT_OP_EXP)
    INTRINSIC_CASE(UWPT_OP_SQRT)
    INTRINSIC_CASE(UWPT_OP_ARCCOS)
    INTRINSIC_CASE(UWPT_OP_ARCTAN)
    INTRINSIC_CASE(UWPT_OP_ARCTAN2)
    INTRINSIC_CASE(UWPT_OP_POWER)
#undef INTRINSIC_CASE
    default: return (int)cudaErrorInvalidValue;   // the cumsum: cumsum_i32_launch
  }
}

// cumsum over int32 (the regeneration's work-queue ranks, the probe's
// "phase 2"): the inclusive prefix sum in one pass with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA, 2016).  Bound: bytes (each element read and
// written once).  Each block scans one tile of UWPT_SCAN_TILE elements held
// as 16-byte vectors (a warp's loads and stores coalesced), publishes the
// tile's aggregate and then its inclusive prefix as one 64-bit word
// (value, status and the call's epoch), and its warp 0 reads the
// predecessors' words back to the nearest inclusive prefix.  Tiles are
// numbered by an atomic ticket in the order blocks start, so every tile a
// block waits on has started.  What costs is latency a block waits out
// (its ticket, its loads, its look-back) rather than bytes, so a tile is
// large: at 4 blocks an SM, 528 tiles of 8,192 (4,194,304 elements) are
// all resident at once.  The look-back of tiles that start together waits
// for the prefixes to travel forward, a window of words a round trip, so
// a window is wide (SCAN_LOOK words a lane, 128 tiles) and its loads fly
// together.  The status and value travel in one word, so no other write
// needs ordering: the words are stored and loaded relaxed (a release store
// costs a fence on the publishing path).  The scratch (ops/cuda_probes.py
// keeps one per device and stream, zeroed once) is a control word, the
// ticket (low 32 bits) and the call's epoch (high), then a word a tile.
// It resets itself: the block that takes the last ticket sets the ticket
// to 0 and advances the epoch, so no word of an earlier call (or of a
// graph's earlier replay) reads as this call's.  Sums wrap in 32 bits, as
// torch.cumsum's int32 sums do.
constexpr int SCAN_THREADS = 256, SCAN_VEC = UWPT_SCAN_TILE / (SCAN_THREADS * 4), SCAN_LOOK = 4;
static_assert(SCAN_VEC >= 1 && SCAN_VEC * SCAN_THREADS * 4 == UWPT_SCAN_TILE,
              "a tile is a whole number of 16-byte vectors a thread");
constexpr uint32_t SCAN_AGGREGATE = 1, SCAN_PREFIX = 2, SCAN_EPOCH_MASK = 0x3FFFFFFFu;

// Bits 0-31 the value, 32-33 the status (0: not yet), 34-63 the epoch.
__device__ __forceinline__ unsigned long long scan_word(uint32_t epoch, uint32_t status,
                                                        uint32_t value) {
  return (unsigned long long)epoch << 34 | (unsigned long long)status << 32 | value;
}
__device__ __forceinline__ uint32_t scan_status(unsigned long long w, uint32_t epoch) {
  return (uint32_t)(w >> 34) == epoch ? (uint32_t)(w >> 32) & 3u : 0u;
}

__global__ void __launch_bounds__(SCAN_THREADS, 4)
    cumsum_kernel(const int* __restrict__ x, int* __restrict__ out, int n,
                  unsigned long long* ctl, unsigned long long* words) {
  __shared__ uint32_t warp_total[SCAN_THREADS / 32];
  __shared__ uint32_t s_tile, s_epoch, s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned long long c = atomicAdd(ctl, 1ull);
    s_tile = (uint32_t)c;
    s_epoch = (uint32_t)(c >> 32);
    // Every block has its ticket and epoch once the last ticket is taken.
    if (s_tile == gridDim.x - 1)
      atomicExch(ctl, (unsigned long long)((s_epoch + 1) & SCAN_EPOCH_MASK) << 32);
  }
  __syncthreads();
  const uint32_t tile = s_tile, epoch = s_epoch;
  // Vector v of a lane: elements base + v * 128 .. + 3, the warp's
  // SCAN_VEC * 128 elements in the order (v, lane).
  const size_t base =
      (size_t)tile * UWPT_SCAN_TILE + (size_t)warp * SCAN_VEC * 128 + (size_t)lane * 4;
  uint4 q[SCAN_VEC];
#pragma unroll
  for (int v = 0; v < SCAN_VEC; ++v) {
    const size_t i = base + (size_t)v * 128;
    if (i + 4 <= (size_t)n) {
      q[v] = *reinterpret_cast<const uint4*>(x + i);
    } else {
      q[v].x = i < (size_t)n ? x[i] : 0;
      q[v].y = i + 1 < (size_t)n ? x[i + 1] : 0;
      q[v].z = i + 2 < (size_t)n ? x[i + 2] : 0;
      q[v].w = 0;
    }
  }
  // Inclusive within the lane's 4, then across the warp's lanes, vector by
  // vector (carry: the warp's sum before vector v).
  uint32_t carry = 0;
#pragma unroll
  for (int v = 0; v < SCAN_VEC; ++v) {
    q[v].y += q[v].x;
    q[v].z += q[v].y;
    q[v].w += q[v].z;
    uint32_t incl = q[v].w;
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const uint32_t add = carry + incl - q[v].w;
    q[v].x += add;
    q[v].y += add;
    q[v].z += add;
    q[v].w += add;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) warp_total[warp] = carry;
  __syncthreads();
  uint32_t before = 0, aggregate = 0;   // the warps' sum before this one, the tile's
#pragma unroll
  for (int w = 0; w < SCAN_THREADS / 32; ++w) {
    const uint32_t t = warp_total[w];
    if (w < warp) before += t;
    aggregate += t;
  }
  if (warp == 0) {
    uint32_t prefix = 0;   // the sum of every tile before this one
    if (tile == 0) {
      if (lane == 0) st_relaxed(&words[0], scan_word(epoch, SCAN_PREFIX, aggregate));
    } else {
      if (lane == 0) st_relaxed(&words[tile], scan_word(epoch, SCAN_AGGREGATE, aggregate));
      for (int pred = (int)tile - 1;; pred -= 32 * SCAN_LOOK) {
        // Window position p = k * 32 + lane is tile pred - p; each lane waits
        // until its words are published in this epoch.  A position before
        // tile 0 stands for a prefix of 0.
        unsigned long long w[SCAN_LOOK];
#pragma unroll
        for (int k = 0; k < SCAN_LOOK; ++k) {
          const int t = pred - (k * 32 + lane);
          w[k] = t >= 0 ? ld_relaxed(&words[t]) : scan_word(epoch, SCAN_PREFIX, 0);
        }
#pragma unroll
        for (int k = 0; k < SCAN_LOOK; ++k)
          while (scan_status(w[k], epoch) == 0) w[k] = ld_relaxed(&words[pred - (k * 32 + lane)]);
        // Sum the aggregates up to and including the nearest prefix.
        int stop = 32 * SCAN_LOOK;
#pragma unroll
        for (int k = SCAN_LOOK - 1; k >= 0; --k) {
          const unsigned prefixes =
              __ballot_sync(0xffffffffu, scan_status(w[k], epoch) == SCAN_PREFIX);
          if (prefixes) stop = k * 32 + __ffs(prefixes) - 1;
        }
        uint32_t sum = 0;
#pragma unroll
        for (int k = 0; k < SCAN_LOOK; ++k)
          if (k * 32 + lane <= stop) sum += (uint32_t)w[k];
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        prefix += sum;
        if (stop < 32 * SCAN_LOOK) break;
      }
      if (lane == 0) st_relaxed(&words[tile], scan_word(epoch, SCAN_PREFIX, prefix + aggregate));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const uint32_t add = s_prefix + before;
#pragma unroll
  for (int v = 0; v < SCAN_VEC; ++v) {
    const size_t i = base + (size_t)v * 128;
    const uint4 r = make_uint4(q[v].x + add, q[v].y + add, q[v].z + add, q[v].w + add);
    if (i + 4 <= (size_t)n) {
      *reinterpret_cast<uint4*>(out + i) = r;
    } else {
      if (i < (size_t)n) out[i] = (int)r.x;
      if (i + 1 < (size_t)n) out[i + 1] = (int)r.y;
      if (i + 2 < (size_t)n) out[i + 2] = (int)r.z;
    }
  }
}

extern "C" int cumsum_i32_launch(const int* x, int* out, int n, void* scratch, int scratch_words,
                                 void* stream) {
  // scratch: int64 words, the control word then one a tile.
  const int tiles = n > 0 ? (int)(((long long)n + UWPT_SCAN_TILE - 1) / UWPT_SCAN_TILE) : 1;
  if (n < 0 || scratch_words < 1 + tiles || ((uintptr_t)x | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  cumsum_kernel<<<tiles, SCAN_THREADS, 0, (cudaStream_t)stream>>>(x, out, n, words, words + 1);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- P9
// (B,) f32 summed to one scalar (round18_mosaic_probe.py sum_k).  Bound:
// bytes (each element read once).  One launch over every SM: block b sums
// the b-th slice of the input, cut by n alone (cuda_probes.sum_plan): one
// round of SUM_VEC 16-byte vectors a thread (4,096 elements a block) up to
// UWPT_SUM_MAX_BLOCKS blocks, more rounds a block beyond that.  A thread
// issues a round's loads together, then adds them in order; the blocks'
// values are summed by publish_and_sum (above).  Tickets are taken at the
// start, while the loads fly.  The order depends on n alone, so the plain
// version (cuda_probes.sum_scalar_plain) follows it op for op.
constexpr int SUM_THREADS = UWPT_SUM_THREADS, SUM_VEC = UWPT_SUM_VEC;
constexpr int SUM_SLICE = SUM_THREADS * SUM_VEC * 4;
constexpr int SUM_WORDS = UWPT_SUM_MAX_BLOCKS / SUM_THREADS;   // the last block's, a thread
static_assert(SUM_WORDS >= 1 && SUM_WORDS * SUM_THREADS == UWPT_SUM_MAX_BLOCKS,
              "the last block's threads read the partials in whole rounds");

__device__ __forceinline__ float4 load4_or_zero(const float* x, size_t i, int n) {
  if (i + 4 <= (size_t)n) return *reinterpret_cast<const float4*>(x + i);
  return make_float4(i < (size_t)n ? x[i] : 0.0f, i + 1 < (size_t)n ? x[i + 1] : 0.0f,
                     i + 2 < (size_t)n ? x[i + 2] : 0.0f, 0.0f);
}

__global__ void __launch_bounds__(SUM_THREADS)
    sum_scalar_kernel(const float* __restrict__ x, int n, int rounds, float* __restrict__ out,
                      unsigned long long* ctl, unsigned long long* words) {
  unsigned long long ticket = 0;
  if (threadIdx.x == 0) ticket = atomicAdd(ctl, 1ull);   // comes back while the loads fly
  float acc = 0.0f;
  for (int r = 0; r < rounds; ++r) {
    const size_t base = ((size_t)blockIdx.x * rounds + r) * SUM_SLICE + (size_t)threadIdx.x * 4;
    float4 q[SUM_VEC];
#pragma unroll
    for (int v = 0; v < SUM_VEC; ++v)
      q[v] = load4_or_zero(x, base + (size_t)v * SUM_THREADS * 4, n);
#pragma unroll
    for (int v = 0; v < SUM_VEC; ++v) {
      acc += q[v].x;
      acc += q[v].y;
      acc += q[v].z;
      acc += q[v].w;
    }
  }
  publish_and_sum<SUM_THREADS, SUM_WORDS>(acc, ticket, out, ctl, words);
}

extern "C" int sum_scalar_launch(const float* x, int n, int blocks, int rounds, float* out,
                                 void* scratch, int scratch_words, void* stream) {
  // The plan is cuda_probes.sum_plan's; the entry checks that it covers n
  // and that the last block reads every partial.
  if (n < 0 || (uintptr_t)x % 16 || blocks < 1 || blocks > UWPT_SUM_MAX_BLOCKS || rounds < 1 ||
      (long long)blocks * rounds * SUM_SLICE < n || scratch_words < 1 + blocks)
    return (int)cudaErrorInvalidValue;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  sum_scalar_kernel<<<blocks, SUM_THREADS, 0, (cudaStream_t)stream>>>(x, n, rounds, out, words,
                                                                       words + 1);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- P10
// 32 steps of x = x * 1.000001 + 0.000001 (round20_tile3d_probe.py k1d).
// The TPU compared three operand layouts of the same (B,) lanes; on the
// card they are the same bytes, so one kernel serves them: one thread per
// 4 elements, loaded and stored 16 bytes at a time, the steps unrolled;
// -fmad=false keeps each step a multiply and an add like the plain loop.
// Bound: bytes.
__global__ void step_chain_kernel(const float4* __restrict__ x, float4* __restrict__ out, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 v = x[i];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    v.x = v.x * 1.000001f + 0.000001f;
    v.y = v.y * 1.000001f + 0.000001f;
    v.z = v.z * 1.000001f + 0.000001f;
    v.w = v.w * 1.000001f + 0.000001f;
  }
  out[i] = v;
}

extern "C" int step_chain_launch(const float* x, float* out, int n, void* stream) {
  if (n % 4) return (int)cudaErrorInvalidValue;
  const int threads = 256, n4 = n / 4;
  if (n4 > 0)
    step_chain_kernel<<<(n4 + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n4);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
