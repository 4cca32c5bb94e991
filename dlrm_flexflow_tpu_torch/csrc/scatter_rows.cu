// Touched-rows scatter updates for Hopper (sm_90a): a pre-pass kernel,
// two update kernels that run after it, and a stateful update kernel
// that needs none, behind seven entry points.
//
// Replaces three Pallas TPU kernels of
// dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:
//   _scatter_unique_kernel (:289, behind scatter_add_rows and
//     _dedup_and_scatter): read-modify-write, table[row] += sum;
//   sharded_scatter_add_packed (:584), a shard_map of it over a table
//     whose rows are split in blocks over the chips: each chip masks
//     the ids outside its block to pads (:621-632) and runs :289 on its
//     block. Here each rank's block is a table of its own and the ids
//     stay global: ff_scatter_presort_window and
//     ff_scatter_add_rows_window take the block's first row `lo` and
//     its `rows`; the window test and the shift happen in the kernels,
//     beside the pad test (an id outside [lo, lo + rows) is keyed and
//     skipped as a pad), so no masked copy of the ids is made;
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
//    here, so the step never travels to the host. The row math is
//    row_math.cuh's, which the dense update (dense_update.cu) shares.
// 4. stateful_fused_kernel: the stateful update in ONE launch, no
//    pre-pass, for n up to kFusedMax lookups (the wrapper's "fused"
//    route; "sort" above it). Each block stages the n ids as int32 keys
//    in shared memory (a pad as kPadKey32, which no real row id below
//    2^31 - 1 equals; kPadKey32 also fills the keys up to a whole scan
//    step, so a scan reads without bounds checks), and each of its warps
//    serves one lookup g at a time. The warp scans the keys below g,
//    kStep a step (every lane's kScan loads issued at once, one vote a
//    step), and leaves when one names g's row: g is not the row's first
//    lookup, so not its owner. The owner loads its weight and slab rows
//    (which only it may touch) and scans the keys above g, one vote a
//    step; in a step that holds lookups of its row, __ballot_sync and a
//    prefix count compact them, in order, into the warp's buffer in
//    shared memory as update-row indices, and every kUnroll of them are
//    loaded at once and added as soon as they are there. The sum runs
//    in ascending lookup order from 0, g's own update row first (loaded,
//    with its forward row, before the keys are staged): the same serial
//    chain per row as the segment walk, with no sort, no order and no
//    grid barrier. The warp's lanes hold one 16-byte column chunk each
//    (d = 64: 16 of 32 lanes; above d = 128 the owner repeats its scan
//    for each 32 chunks). The scans are n^2/32 shared-memory compares
//    over the card, which is why the route ends at kFusedMax, where it
//    still beats the pre-pass route. Tried first: the matches taken from
//    the ballot words one by one (slower on hot rows than the pre-pass
//    route), and a hash table of the rows in shared memory, built with
//    atomics, instead of the first scan (its build alone took longer
//    than the whole call).
//
// The window (item 1 and 2 with lo, rows): ids in [lo, lo + rows) are
// row id - lo of the block; any other id, and a pad, is keyed kPadRow,
// sorts last and owns no segment, so it is never read or written. The
// plain scatter is the window lo = 0, rows = 2^63 - 1.
//
// Bound: memory. The function reads the ids (8 B a lookup), the updates
// (n/div rows), one table row (read-modify-write) or one forward row
// (write-only) per distinct row, and writes one row per distinct row: at
// the training shape (n = 2,048 lookups, d = 64) about 1.6 MB, 0.5 us at
// 3.35 TB/s, so a call is launch- and latency-bound: two launches, each
// a few dependent loads deep (one on the stateful "fused" route). The
// stateful update adds a read and a write of each slab row per distinct
// row (Adam: 4 more rows).
//
// The guard: the four update entries take `ok`, a device pointer to the
// anomaly sentinel's int32 flag, or null. With a non-null `ok` whose
// value is 0, every thread of the update kernel returns before any load
// or store, so a non-finite step leaves the table and its state as they
// were (the JAX step keeps them with jnp.where(step_ok, new, old),
// dlrm_flexflow_tpu/core/model.py:1124-1130). The pre-pass writes no
// parameter and takes no flag.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "row_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockSortMax = 16384;
constexpr int kRankThreads = 256;          // 8 warps
constexpr int kRankPerWarp = 2;            // lookups a warp ranks
constexpr int kRankPerBlock = kRankThreads / 32 * kRankPerWarp;
constexpr int kUnroll = 8;                 // a group's update loads in flight
// a pad slot's row key (row id < 0): after every real row (< 2^31)
constexpr uint32_t kPadRow = 0xFFFFFFFFu;
// the one-launch stateful route: its lookups, warps a block, and a pad
// slot's int32 key (the wrapper keeps row ids below 2^31 - 1)
constexpr int kFusedMax = 16384;
constexpr int kFusedWarps = 8;
constexpr int kStage = 8;        // ids a thread loads at once into the keys
constexpr int kScan = 8;         // 32-key chunks a warp compares at once
constexpr int kStep = 32 * kScan;  // keys a scan step
constexpr int kPadKey32 = 0x7FFFFFFF;

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
// Only ids in the window [lo, lo + rows) are rows (id - lo); the
// others are keyed as pads too.
__global__ void __launch_bounds__(kRankThreads)
scatter_rank_kernel(const int64_t* __restrict__ ids, int n, int64_t lo,
                    int64_t rows, int* __restrict__ order,
                    int2* __restrict__ seg) {
  extern __shared__ unsigned long long keys[];     // n keys
  for (int i = threadIdx.x; i < n; i += kRankThreads) {
    const int64_t id = ids[i] - lo;
    const bool in = ids[i] >= 0 && id >= 0 && id < rows;
    keys[i] = ((unsigned long long)(in ? (uint32_t)id : kPadRow) << 32)
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
// ids[g] - lo when lookup g is that row's first; the others exit at once
// (the pre-pass gave no segment to a pad or an id outside the window).
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(float4* __restrict__ table,
                    const int64_t* __restrict__ ids,
                    const int* __restrict__ order,
                    const int2* __restrict__ seg,
                    const float4* __restrict__ upd,
                    const float4* __restrict__ fwd, int n, int vec, int div,
                    float scale, int64_t lo, const int* __restrict__ ok) {
  if (ok && __ldg(ok) == 0) return;       // the sentinel skips this step
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t g = t / vec;
  if (g >= n) return;
  const int2 s = __ldg(seg + g);
  if (s.x < 0) return;
  const int c = (int)(t - g * vec);
  const int64_t row = __ldg(ids + g) - lo;
  // write-only: lookup g's forward row (every duplicate's holds the same
  // pre-update value); its load overlaps the segment's
  const float4 base = fwd ? __ldg(fwd + g * vec + c) : table[row * vec + c];
  const float4 acc = segment_sum<true>(s, order, upd, vec, c, div, scale);
  table[row * vec + c] = make_float4(
      __fadd_rn(base.x, acc.x), __fadd_rn(base.y, acc.y),
      __fadd_rn(base.z, acc.z), __fadd_rn(base.w, acc.w));
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
                     int div, OptParams p, const int* __restrict__ ok) {
  if (ok && __ldg(ok) == 0) return;       // the sentinel skips this step
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
  update_chunk(w, acc, s0, s1, p, a);
  table[at] = w;
  if (slab0) slab0[at] = s0;
  if (slab1) slab1[at] = s1;
}

// Adds to acc, in order, the chunk c of the update rows rows[0, count),
// count <= kUnroll, all loads in flight first (warp-uniform; rows a
// warp's buffer in shared memory).
__device__ __forceinline__ void add_rows(float4& acc,
                                         const float4* __restrict__ upd,
                                         const int* rows, int count, int vec,
                                         int c, bool on) {
  int r[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) r[i] = i < count ? rows[i] : -1;
  float4 u[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i)
    if (on && r[i] >= 0) u[i] = __ldg(upd + (int64_t)r[i] * vec + c);
#pragma unroll
  for (int i = 0; i < kUnroll; ++i)
    if (on && r[i] >= 0) add_scaled<false>(acc, 1.f, u[i]);
}

// Warp-uniform: the warp's part of stateful_fused_kernel for lookup g,
// whose own update and forward rows are u0 and f0 (lane < vec). keys32
// holds the n keys and kPadKey32 after them up to a whole scan step;
// buf is the warp's 2 * kStep ints of shared memory.
__device__ __forceinline__ void fused_lookup(
    float4* __restrict__ table, const float4* __restrict__ upd,
    const float4* __restrict__ fwd, float4* __restrict__ slab0,
    float4* __restrict__ slab1, const float* __restrict__ alpha_t,
    const int* keys32, int* buf, int g, int lane, int n, int vec, int div,
    const OptParams& p, float4 u0, float4 f0) {
  const int key = keys32[g];
  if (key == kPadKey32) return;                       // pads own nothing
  for (int base = 0; base < g; base += kStep) {
    int kv[kScan];                                    // all loads at once
#pragma unroll
    for (int q = 0; q < kScan; ++q) kv[q] = keys32[base + 32 * q + lane];
    bool earlier = false;
#pragma unroll
    for (int q = 0; q < kScan; ++q)
      earlier |= (kv[q] == key) & (base + 32 * q + lane < g);
    if (__any_sync(0xffffffffu, earlier)) return;     // not the owner
  }
  const int64_t row = key;
  const float a = alpha_t ? __ldg(alpha_t) : 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const unsigned below = (1u << lane) - 1;
  for (int c0 = 0; c0 < vec; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < vec;
    const int64_t at = row * vec + c;
    float4 w = zero, s0 = zero, s1 = zero;
    if (on) {
      if (c0 > 0) {
        u0 = __ldg(upd + (int64_t)(g / div) * vec + c);
        if (fwd) f0 = __ldg(fwd + (int64_t)g * vec + c);
      }
      w = fwd ? f0 : table[at];
      if (slab0) s0 = slab0[at];
      if (slab1) s1 = slab1[at];
    }
    float4 acc = zero;
    add_scaled<false>(acc, 1.f, u0);                  // lookup g, first
    // the row's later lookups: each step's matches are compacted, in
    // order, into buf as update-row indices; every kUnroll of them are
    // added as soon as they are there, the rest carried to the next step
    int pend = 0;
    for (int base = g / kStep * kStep; base < n; base += kStep) {
      int kv[kScan];
#pragma unroll
      for (int q = 0; q < kScan; ++q) kv[q] = keys32[base + 32 * q + lane];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kScan; ++q)
        any |= (kv[q] == key) & (base + 32 * q + lane > g);
      if (!__any_sync(0xffffffffu, any)) continue;   // most steps
#pragma unroll
      for (int q = 0; q < kScan; ++q) {
        const int k = base + 32 * q + lane;
        const bool hit = (kv[q] == key) & (k > g);
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) buf[pend + __popc(m & below)] = k / div;
        pend += __popc(m);
      }
      if (pend >= kUnroll) {
        __syncwarp();
        int j = 0;
        for (; j + kUnroll <= pend; j += kUnroll)
          add_rows(acc, upd, buf + j, kUnroll, vec, c, on);
        const int rest = pend - j;
        const int carry = lane < rest ? buf[j + lane] : 0;
        __syncwarp();
        if (lane < rest) buf[lane] = carry;
        __syncwarp();
        pend = rest;
      }
    }
    __syncwarp();
    add_rows(acc, upd, buf, pend, vec, c, on);
    __syncwarp();
    if (on) {
      update_chunk(w, acc, s0, s1, p, a);
      table[at] = w;
      if (slab0) slab0[at] = s0;
      if (slab1) slab1[at] = s1;
    }
  }
}

// Warp w of the grid serves lookups w, w + the grid's warps, ... when
// each is its row's first (item 4 above); slabs and alpha_t as in
// stateful_rows_kernel. Shared memory: npad int32 keys, npad = n
// rounded up to a scan step, then each warp's buffer of 2 * kStep ints.
__global__ void __launch_bounds__(kFusedWarps * 32)
stateful_fused_kernel(float4* __restrict__ table,
                      const int64_t* __restrict__ ids,
                      const float4* __restrict__ upd,
                      const float4* __restrict__ fwd,
                      float4* __restrict__ slab0, float4* __restrict__ slab1,
                      const float* __restrict__ alpha_t, int n, int npad,
                      int vec, int div, OptParams p,
                      const int* __restrict__ ok) {
  if (ok && __ldg(ok) == 0) return;       // the sentinel skips this step
  extern __shared__ int keys32[];
  constexpr int kThreadsF = kFusedWarps * 32;
  const int lane = threadIdx.x % 32;
  int* buf = keys32 + npad + threadIdx.x / 32 * 2 * kStep;
  // the warp's first lookup's own update and forward rows (read-only),
  // in flight while the block stages the keys
  const int g0 = blockIdx.x * kFusedWarps + threadIdx.x / 32;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 u0 = zero, f0 = zero;
  if (g0 < n && lane < vec) {
    u0 = __ldg(upd + (int64_t)(g0 / div) * vec + lane);
    if (fwd) f0 = __ldg(fwd + (int64_t)g0 * vec + lane);
  }
  for (int i0 = 0; i0 < npad; i0 += kThreadsF * kStage) {
    int64_t id[kStage];                               // all loads in flight
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = i0 + q * kThreadsF + threadIdx.x;
      id[q] = i < n ? __ldg(ids + i) : -1;
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = i0 + q * kThreadsF + threadIdx.x;
      if (i < npad) keys32[i] = id[q] < 0 ? kPadKey32 : (int)id[q];
    }
  }
  __syncthreads();
  for (int g = g0; g < n; g += gridDim.x * kFusedWarps) {  // warp-uniform
    if (g != g0 && lane < vec) {
      u0 = __ldg(upd + (int64_t)(g / div) * vec + lane);
      if (fwd) f0 = __ldg(fwd + (int64_t)g * vec + lane);
    }
    fused_lookup(table, upd, fwd, slab0, slab1, alpha_t, keys32, buf, g,
                 lane, n, vec, div, p, u0, f0);
  }
}

int launch(void* table, const void* ids, const void* order, const void* seg,
           const void* upd, const void* fwd, int n, int dim, int div,
           float scale, int64_t lo, const void* ok, void* stream) {
  if (n <= 0) return 0;
  const int vec = dim / 4;
  const long long blocks = ((long long)n * vec + kThreads - 1) / kThreads;
  scatter_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (float4*)table, (const int64_t*)ids, (const int*)order,
      (const int2*)seg, (const float4*)upd, (const float4*)fwd, n, vec, div,
      scale, lo, (const int*)ok);
  return (int)cudaGetLastError();
}

// The pre-pass over the window [lo, lo + rows) (see ff_scatter_presort).
int presort(const void* ids, int n, int64_t lo, int64_t rows, void* order,
            void* seg, void* stream) {
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
      (const int64_t*)ids, n, lo, rows, (int*)order, (int2*)seg);
  return (int)cudaGetLastError();
}

// the plain scatter's window: every id >= 0
constexpr int64_t kAllRows = INT64_MAX;

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
  return presort(ids, n, 0, kAllRows, order, seg, stream);
}

// As ff_scatter_presort over the window [lo, lo + rows): an id in it is
// row id - lo, any other id is keyed and skipped as a pad.
int ff_scatter_presort_window(const void* ids, int n, long long lo,
                              long long rows, void* order, void* seg,
                              void* stream) {
  return presort(ids, n, lo, rows, order, seg, stream);
}

// table: (rows, dim) fp32, updated in place; ids: (n,) int64, the
// lookups' rows; order, seg: the pre-pass's outputs; upd: (n / div, dim)
// fp32. dim % 4 == 0 and 16-byte aligned pointers (the wrapper checks).
// ok: the sentinel's device int32 flag (0: change nothing), or null.
// Launches on `stream`; returns cudaGetLastError().
int ff_scatter_add_rows(void* table, const void* ids, const void* order,
                        const void* seg, const void* upd, int n, int dim,
                        int div, float scale, const void* ok, void* stream) {
  return launch(table, ids, order, seg, upd, nullptr, n, dim, div, scale, 0,
                ok, stream);
}

// As ff_scatter_add_rows on a block of a larger table: table holds its
// rows [lo, lo + rows), ids are rows of the whole table, and order and
// seg come from ff_scatter_presort_window over the same window, so an id
// outside it changes nothing. Lookup g of a segment updates table row
// ids[g] - lo.
int ff_scatter_add_rows_window(void* table, const void* ids,
                               const void* order, const void* seg,
                               const void* upd, int n, int dim, int div,
                               float scale, long long lo, const void* ok,
                               void* stream) {
  return launch(table, ids, order, seg, upd, nullptr, n, dim, div, scale, lo,
                ok, stream);
}

// As ff_scatter_add_rows, but writes fwd[first lookup] + sum without
// reading the table; fwd: (n, dim) fp32, the row each lookup read in the
// forward.
int ff_scatter_write_rows(void* table, const void* ids, const void* order,
                          const void* seg, const void* upd, const void* fwd,
                          int n, int dim, int div, float scale,
                          const void* ok, void* stream) {
  return launch(table, ids, order, seg, upd, fwd, n, dim, div, scale, 0, ok,
                stream);
}

// The stateful touched-rows update: table, ids, order, seg, upd and fwd
// as in ff_scatter_write_rows (fwd may be null: the table row is read),
// upd the raw gradient rows (no scale). slab0, slab1: (rows, dim) fp32
// state, updated in place, or null (see stateful_rows_kernel). alpha_t:
// a device pointer to Adam's fp32 step size (null for SGD). adam 0 runs
// SGD (lr, momentum, nesterov, wd), 1 Adam (wd, b1, c1, b2, c2, eps).
// ok as in ff_scatter_add_rows. Launches on `stream`; returns
// cudaGetLastError().
int ff_stateful_update_rows(void* table, const void* ids, const void* order,
                            const void* seg, const void* upd, const void* fwd,
                            void* slab0, void* slab1, const void* alpha_t,
                            int n, int dim, int div, int adam, int nesterov,
                            float wd, float lr, float momentum, float b1,
                            float c1, float b2, float c2, float eps,
                            const void* ok, void* stream) {
  if (n <= 0) return 0;
  const int vec = dim / 4;
  const OptParams p{adam, nesterov, wd, lr, momentum, b1, c1, b2, c2, eps};
  const long long blocks = ((long long)n * vec + kThreads - 1) / kThreads;
  stateful_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (float4*)table, (const int64_t*)ids, (const int*)order,
      (const int2*)seg, (const float4*)upd, (const float4*)fwd,
      (float4*)slab0, (float4*)slab1, (const float*)alpha_t, n, vec, div, p,
      (const int*)ok);
  return (int)cudaGetLastError();
}

// The most lookups the one-launch stateful route takes (their int32 keys
// and the warps' buffers fill 80 KB of a block's shared memory).
int ff_stateful_fused_max() { return kFusedMax; }

// As ff_stateful_update_rows, in one launch and without the pre-pass's
// order and seg: stateful_fused_kernel. n <= kFusedMax; row ids below
// 2^31 - 1, a negative one a pad.
int ff_stateful_update_fused(void* table, const void* ids, const void* upd,
                             const void* fwd, void* slab0, void* slab1,
                             const void* alpha_t, int n, int dim, int div,
                             int adam, int nesterov, float wd, float lr,
                             float momentum, float b1, float c1, float b2,
                             float c2, float eps, const void* ok,
                             void* stream) {
  if (n <= 0) return 0;
  if (n > kFusedMax) return (int)cudaErrorInvalidValue;
  const int npad = (n + kStep - 1) / kStep * kStep;
  const int bytes = (npad + kFusedWarps * 2 * kStep) * (int)sizeof(int);
  // per device: the shared memory allowed (set once), and the blocks
  // the card holds at once with the most of it
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int fit = dev < 64 ? resident[dev] : 0;
  if (!fit) {
    const int most = (kFusedMax + kFusedWarps * 2 * kStep) * (int)sizeof(int);
    err = cudaFuncSetAttribute((const void*)stateful_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, stateful_fused_kernel, kFusedWarps * 32, most);
    if (err != cudaSuccess) return (int)err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    fit *= sms;
    if (dev < 64) resident[dev] = fit;
  }
  // a warp a lookup, or as many blocks as the card holds at once, each
  // staging the keys once for several lookups a warp
  const int blocks = std::min((n + kFusedWarps - 1) / kFusedWarps, fit);
  const OptParams p{adam, nesterov, wd, lr, momentum, b1, c1, b2, c2, eps};
  stateful_fused_kernel<<<blocks, kFusedWarps * 32, bytes,
                          (cudaStream_t)stream>>>(
      (float4*)table, (const int64_t*)ids, (const float4*)upd,
      (const float4*)fwd, (float4*)slab0, (float4*)slab1,
      (const float*)alpha_t, n, npad, dim / 4, div, p, (const int*)ok);
  return (int)cudaGetLastError();
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
