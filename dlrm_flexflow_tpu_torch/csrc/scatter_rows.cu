// Touched-rows scatter updates for Hopper (sm_90a): a pre-pass kernel
// and two update kernels behind three entry points.
//
// Replaces two Pallas TPU kernels of
// dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:
//   _scatter_unique_kernel (:289, behind scatter_add_rows and
//     _dedup_and_scatter): read-modify-write, table[row] += sum;
//   _scatter_write_kernel (:495, behind scatter_write_rows_packed):
//     write-only, table[row] = fwd_row + sum, where fwd_row is the value
//     the forward pass gathered for that row; and, through
//     scatter_write_tiles (:547), the weight and state-slab writes of the
//     stateful touched-rows update (_stateful_update_tiles_packed,
//     ops/embedding.py:460), where XLA computes each distinct tile's new
//     weight and state between the dedup and the writes. Here one kernel,
//     stateful_rows_kernel (item 3 below), does the row math and writes.
//
// Both apply n per-lookup updates to a (rows, dim) table. Lookup j
// targets row ids[j] and carries update row upd[j / div] (div > 1 lets a
// bag of `div` lookups share one cotangent row without repeating it in
// memory). Each update is scaled BEFORE the sum, as the JAX update
// computes -lr * upd and then segment-sums:
//   sum(row) = sum over lookups j with ids[j] == row, in ascending j, of
//              scale * upd[j / div], starting from 0.
// The multiply and the adds use __fmul_rn/__fadd_rn, so nvcc cannot
// contract them into an FMA that would round differently from the
// reference, and there are no atomics: the result is bitwise that of the
// plain version.
//
// The TPU kernels rely on an XLA pre-pass (_dedup_tile_updates: argsort,
// segment_sum, segment_max) to make every target distinct. Here:
//
// 1. scatter_rank_kernel, for n up to kBlockSortMax = 16,384 lookups:
//    the stable sorted order by rank. With keys (row id << 32 | lookup
//    position), all distinct, a lookup's place in the order is the
//    number of keys below its own; it is its row's first lookup when none
//    of them has its row, and the keys with its row count the row's
//    lookups. Each block holds all n keys in shared memory and ranks 16
//    lookups, a warp's lanes striding over the keys: n² compares spread
//    over the card with no barrier in the loop (at n = 2,048, 128 blocks
//    of 2 × 64 compares a thread). It writes the order and, for each
//    row's first lookup, where its segment starts in the order and how
//    long it is. Row ids must fit in 31 bits (the wrapper checks rows <
//    2^31). A one-block bitonic sort was tried first: its 66 dependent
//    stages on one SM made it slower than this whole call, however the
//    keys were spread over threads. Above the limit the wrapper sorts
//    int32 ids with torch.sort (stable) and derives the same segments
//    with tensor ops: the JAX pre-pass is XLA, not a Pallas kernel.
// 2. scatter_rows_kernel hands each segment whole to the group of dim/4
//    threads (one per 16-byte column chunk: d/4 neighbouring threads
//    cover a 256-byte row at d = 64, so every row read and write is a run
//    of float4s on neighbouring addresses) of its row's first lookup,
//    which also gives the row id and, write-only, the forward row. The
//    group walks the segment's sorted positions contiguously, eight
//    lookups' loads in flight at once, and adds them in lookup order: a
//    long segment (a hot row) is a serial chain of adds, which bitwise
//    equality with the sequential sum requires. The groups of the other
//    n - m lookups (m distinct rows) exit after one load: a grid sized
//    before m is known idles that many groups in any layout.
//
// 3. stateful_rows_kernel: the same owner groups and segment walk, the
//    updates summed unscaled (the RAW gradient: Adam and momentum are not
//    linear in it, so duplicates must be summed first, as _dedup_rows
//    does). The owner then reads its weight (forward row or table row)
//    and its row of each state slab (momentum's v; Adam's m and v), runs
//    the optimizer's row math (update_lane, JAX's operation order, one
//    rounding an operation) and writes the weight and each slab. Rows no
//    lookup names are never read or written: their weight and state stay
//    (lazy semantics; a dense update would decay them). Adam's alpha_t
//    is a 0-d fp32 tensor computed on the device from the step, read
//    here, so the step never travels to the host.
//
// Bound: memory. The function reads the ids (8 B a lookup), the updates
// (n/div rows), one table row (read-modify-write) or one forward row
// (write-only) per distinct row, and writes one row per distinct row: at
// the training shape (n = 2,048 lookups, d = 64) about 1.6 MB, 0.5 us at
// 3.35 TB/s, so a call is launch- and latency-bound: two launches, each
// a few dependent loads deep. The stateful update adds a read and a
// write of each slab row per distinct row (Adam: 4 more rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockSortMax = 16384;
constexpr int kRankThreads = 256;          // 8 warps
constexpr int kRankPerWarp = 2;            // lookups a warp ranks
constexpr int kRankPerBlock = kRankThreads / 32 * kRankPerWarp;
constexpr int kUnroll = 8;                 // a group's update loads in flight
// a pad slot's row key (row id < 0): after every real row (< 2^31)
constexpr uint32_t kPadRow = 0xFFFFFFFFu;

// The pre-pass: every lookup j's place p in the stable sorted order is
// the number of keys below its own, key = (row id << 32 | position), all
// keys distinct. A block copies the n keys into shared memory; each warp
// ranks kRankPerWarp lookups, its lanes striding over the keys and summing
// by shuffle. It writes order[p] = j and, for the first lookup of each
// row (no smaller key with its row), seg[j] = (p, the row's lookup
// count); (-1, 0) for every other lookup. A pad slot (row id < 0, which
// the Pallas kernels skip with @pl.when(row >= 0)) is keyed as row
// kPadRow, after every real row, and owns no segment, so the update
// kernel never reads or writes its row.
__global__ void __launch_bounds__(kRankThreads)
scatter_rank_kernel(const int64_t* __restrict__ ids, int n,
                    int* __restrict__ order, int2* __restrict__ seg) {
  extern __shared__ unsigned long long keys[];     // n keys
  for (int i = threadIdx.x; i < n; i += kRankThreads) {
    const int64_t id = ids[i];
    keys[i] = ((unsigned long long)(id < 0 ? kPadRow : (uint32_t)id) << 32)
              | (uint32_t)i;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * kRankPerBlock + warp * kRankPerWarp;
  unsigned long long mine[kRankPerWarp];
  int less[kRankPerWarp], same[kRankPerWarp], before[kRankPerWarp];
#pragma unroll
  for (int q = 0; q < kRankPerWarp; ++q) {
    mine[q] = j0 + q < n ? keys[j0 + q] : ~0ull;
    less[q] = same[q] = before[q] = 0;
  }
  for (int i = lane; i < n; i += 32) {
    const unsigned long long other = keys[i];
#pragma unroll
    for (int q = 0; q < kRankPerWarp; ++q) {
      const bool smaller = other < mine[q];
      const bool row = (uint32_t)(other >> 32) == (uint32_t)(mine[q] >> 32);
      less[q] += smaller;
      same[q] += row;
      before[q] += smaller && row;
    }
  }
#pragma unroll
  for (int q = 0; q < kRankPerWarp; ++q)
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      less[q] += __shfl_xor_sync(0xffffffffu, less[q], s);
      same[q] += __shfl_xor_sync(0xffffffffu, same[q], s);
      before[q] += __shfl_xor_sync(0xffffffffu, before[q], s);
    }
#pragma unroll
  for (int q = 0; q < kRankPerWarp; ++q)
    if (lane == q && j0 + q < n) {
      order[less[q]] = j0 + q;
      const bool pad = (uint32_t)(mine[q] >> 32) == kPadRow;
      seg[j0 + q] = before[q] == 0 && !pad ? make_int2(less[q], same[q])
                                           : make_int2(-1, 0);
    }
}

template <bool kScaled>
__device__ __forceinline__ void add_scaled(float4& acc, float scale,
                                           const float4 u) {
  if (kScaled) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(scale, u.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(scale, u.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(scale, u.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(scale, u.w));
  } else {
    acc.x = __fadd_rn(acc.x, u.x);
    acc.y = __fadd_rn(acc.y, u.y);
    acc.z = __fadd_rn(acc.z, u.z);
    acc.w = __fadd_rn(acc.w, u.w);
  }
}

// The sum over a row's segment s of the sorted order, in lookup order,
// from 0, of (scale times, with kScaled) upd[pos / div]'s chunk c: the
// loads of kUnroll lookups in flight, then their adds in order.
template <bool kScaled>
__device__ __forceinline__ float4 segment_sum(
    const int2 s, const int* __restrict__ order,
    const float4* __restrict__ upd, int vec, int c, int div, float scale) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int k = s.x;
  const int k1 = s.x + s.y;
  for (; k + kUnroll <= k1; k += kUnroll) {
    int pos[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) pos[i] = __ldg(order + k + i);
    float4 u[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      u[i] = __ldg(upd + (int64_t)(pos[i] / div) * vec + c);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) add_scaled<kScaled>(acc, scale, u[i]);
  }
  for (; k < k1; ++k)
    add_scaled<kScaled>(
        acc, scale, __ldg(upd + (int64_t)(__ldg(order + k) / div) * vec + c));
  return acc;
}

// Group g (vec threads, one per 16-byte chunk) serves the segment of row
// ids[g] when lookup g is that row's first; the others exit at once.
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(float4* __restrict__ table,
                    const int64_t* __restrict__ ids,
                    const int* __restrict__ order,
                    const int2* __restrict__ seg,
                    const float4* __restrict__ upd,
                    const float4* __restrict__ fwd, int n, int vec, int div,
                    float scale) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t g = t / vec;
  if (g >= n) return;
  const int2 s = __ldg(seg + g);
  if (s.x < 0) return;
  const int c = (int)(t - g * vec);
  const int64_t row = __ldg(ids + g);
  // write-only: lookup g's forward row (every duplicate's holds the same
  // pre-update value); its load overlaps the segment's
  const float4 base = fwd ? __ldg(fwd + g * vec + c) : table[row * vec + c];
  const float4 acc = segment_sum<true>(s, order, upd, vec, c, div, scale);
  table[row * vec + c] = make_float4(
      __fadd_rn(base.x, acc.x), __fadd_rn(base.y, acc.y),
      __fadd_rn(base.z, acc.z), __fadd_rn(base.w, acc.w));
}

// The optimizer's hyperparameters, fp32 as JAX's weak-typed Python
// floats round them (c1 = 1 - beta1 and c2 = 1 - beta2 computed in
// double first); momentum and wd are 0 where the optimizer has none.
struct OptParams {
  int adam, nesterov;
  float wd, lr, momentum, b1, c1, b2, c2, eps;
};

// One lane of a row: w and the state s0, s1 updated in place from the
// summed gradient g, in the order of row_update_reference (and of the
// JAX optimizers), one rounding an operation, never contracted:
//   gt = g + wd*w
//   SGD:  v = m*v + gt; d = gt + m*v (nesterov) | v | gt; w = w - lr*d
//   Adam: m = b1*m + c1*gt; v = b2*v + (c2*gt)*gt;
//         w = w - (alpha_t*m) / (sqrt(v) + eps)
__device__ __forceinline__ void update_lane(float& w, float g, float& s0,
                                            float& s1, const OptParams& p,
                                            float alpha_t) {
  const float gt = p.wd > 0.f ? __fadd_rn(g, __fmul_rn(p.wd, w)) : g;
  if (p.adam) {
    s0 = __fadd_rn(__fmul_rn(p.b1, s0), __fmul_rn(p.c1, gt));
    s1 = __fadd_rn(__fmul_rn(p.b2, s1), __fmul_rn(__fmul_rn(p.c2, gt), gt));
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(alpha_t, s0),
                               __fadd_rn(__fsqrt_rn(s1), p.eps)));
    return;
  }
  float d = gt;
  if (p.momentum > 0.f) {
    s0 = __fadd_rn(__fmul_rn(p.momentum, s0), gt);
    d = p.nesterov ? __fadd_rn(gt, __fmul_rn(p.momentum, s0)) : s0;
  }
  w = __fsub_rn(w, __fmul_rn(p.lr, d));
}

// Group g serves row ids[g] when lookup g is that row's first, as in
// scatter_rows_kernel: the row's summed gradient, then its weight and
// state-slab rows through update_lane, each written back. slab0 is
// Adam's m or momentum's v, slab1 Adam's v; either may be null.
__global__ void __launch_bounds__(kThreads)
stateful_rows_kernel(float4* __restrict__ table,
                     const int64_t* __restrict__ ids,
                     const int* __restrict__ order,
                     const int2* __restrict__ seg,
                     const float4* __restrict__ upd,
                     const float4* __restrict__ fwd,
                     float4* __restrict__ slab0, float4* __restrict__ slab1,
                     const float* __restrict__ alpha_t, int n, int vec,
                     int div, OptParams p) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t g = t / vec;
  if (g >= n) return;
  const int2 s = __ldg(seg + g);
  if (s.x < 0) return;
  const int c = (int)(t - g * vec);
  const int64_t at = __ldg(ids + g) * vec + c;
  // the weight, state and step loads overlap the segment's
  float4 w = fwd ? __ldg(fwd + g * vec + c) : table[at];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s0 = slab0 ? slab0[at] : zero;
  float4 s1 = slab1 ? slab1[at] : zero;
  const float a = alpha_t ? __ldg(alpha_t) : 0.f;
  const float4 acc = segment_sum<false>(s, order, upd, vec, c, div, 1.f);
  update_lane(w.x, acc.x, s0.x, s1.x, p, a);
  update_lane(w.y, acc.y, s0.y, s1.y, p, a);
  update_lane(w.z, acc.z, s0.z, s1.z, p, a);
  update_lane(w.w, acc.w, s0.w, s1.w, p, a);
  table[at] = w;
  if (slab0) slab0[at] = s0;
  if (slab1) slab1[at] = s1;
}

int launch(void* table, const void* ids, const void* order, const void* seg,
           const void* upd, const void* fwd, int n, int dim, int div,
           float scale, void* stream) {
  if (n <= 0) return 0;
  const int vec = dim / 4;
  const long long blocks = ((long long)n * vec + kThreads - 1) / kThreads;
  scatter_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (float4*)table, (const int64_t*)ids, (const int*)order,
      (const int2*)seg, (const float4*)upd, (const float4*)fwd, n, vec, div,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most lookups the pre-pass ranks (their keys fill a block's shared
// memory: 128 KB).
int ff_scatter_block_sort_max() { return kBlockSortMax; }

// ids: (n,) int64 row ids below 2^31, negative ones pads that own no
// segment; n <= kBlockSortMax. Writes
// order (n,) int32, the lookups in stable order of their rows, and seg
// (n, 2) int32: for the first lookup j of each row, (its place in order,
// the row's lookup count); (-1, 0) for the others and the pads. One
// launch on `stream`; returns cudaGetLastError().
int ff_scatter_presort(const void* ids, int n, void* order, void* seg,
                       void* stream) {
  if (n <= 0) return 0;
  if (n > kBlockSortMax) return (int)cudaErrorInvalidValue;
  static bool allowed[64] = {};      // the dynamic shared memory, set
  int dev = 0;                        // once per device
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute((const void*)scatter_rank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBlockSortMax * (int)sizeof(unsigned long long));
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = true;
  }
  scatter_rank_kernel<<<(n + kRankPerBlock - 1) / kRankPerBlock,
                        kRankThreads, n * sizeof(unsigned long long),
                        (cudaStream_t)stream>>>(
      (const int64_t*)ids, n, (int*)order, (int2*)seg);
  return (int)cudaGetLastError();
}

// table: (rows, dim) fp32, updated in place; ids: (n,) int64, the
// lookups' rows; order, seg: the pre-pass's outputs; upd: (n / div, dim)
// fp32. dim % 4 == 0 and 16-byte aligned pointers (the wrapper checks).
// Launches on `stream`; returns cudaGetLastError().
int ff_scatter_add_rows(void* table, const void* ids, const void* order,
                        const void* seg, const void* upd, int n, int dim,
                        int div, float scale, void* stream) {
  return launch(table, ids, order, seg, upd, nullptr, n, dim, div, scale,
                stream);
}

// As ff_scatter_add_rows, but writes fwd[first lookup] + sum without
// reading the table; fwd: (n, dim) fp32, the row each lookup read in the
// forward.
int ff_scatter_write_rows(void* table, const void* ids, const void* order,
                          const void* seg, const void* upd, const void* fwd,
                          int n, int dim, int div, float scale,
                          void* stream) {
  return launch(table, ids, order, seg, upd, fwd, n, dim, div, scale,
                stream);
}

// The stateful touched-rows update: table, ids, order, seg, upd and fwd
// as in ff_scatter_write_rows (fwd may be null: the table row is read),
// upd the raw gradient rows (no scale). slab0, slab1: (rows, dim) fp32
// state, updated in place, or null (see stateful_rows_kernel). alpha_t:
// a device pointer to Adam's fp32 step size (null for SGD). adam 0 runs
// SGD (lr, momentum, nesterov, wd), 1 Adam (wd, b1, c1, b2, c2, eps).
// Launches on `stream`; returns cudaGetLastError().
int ff_stateful_update_rows(void* table, const void* ids, const void* order,
                            const void* seg, const void* upd, const void* fwd,
                            void* slab0, void* slab1, const void* alpha_t,
                            int n, int dim, int div, int adam, int nesterov,
                            float wd, float lr, float momentum, float b1,
                            float c1, float b2, float c2, float eps,
                            void* stream) {
  if (n <= 0) return 0;
  const int vec = dim / 4;
  const OptParams p{adam, nesterov, wd, lr, momentum, b1, c1, b2, c2, eps};
  const long long blocks = ((long long)n * vec + kThreads - 1) / kThreads;
  stateful_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (float4*)table, (const int64_t*)ids, (const int*)order,
      (const int2*)seg, (const float4*)upd, (const float4*)fwd,
      (float4*)slab0, (float4*)slab1, (const float*)alpha_t, n, vec, div, p);
  return (int)cudaGetLastError();
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
