// Touched-rows scatter updates for Hopper (sm_90a): a pre-pass kernel,
// two update kernels that run after it, and a stateful update kernel
// that needs none, behind five entry points.
//
// Replaces three Pallas TPU kernels of
// dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:
//   _scatter_unique_kernel (:289, behind scatter_add_rows and
//     _dedup_and_scatter): read-modify-write, table[row] += sum;
//   sharded_scatter_add_packed (:584), a shard_map of it over a table
//     whose rows are split in blocks over the chips: each chip masks
//     the ids outside its block to pads (:621-632) and runs :289 on its
//     block. Here each rank's block is a table of its own and the ids
//     stay global: ff_scatter_presort and ff_scatter_add_rows take the
//     block's first row `lo` and its `rows`; the window test and the
//     shift happen in the kernels, beside the pad test (an id outside
//     [lo, lo + rows) is keyed and skipped as a pad), so no masked copy
//     of the ids is made;
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
// 1. The pre-pass, for n up to kBlockSortMax = 16,384 lookups: the
//    stable sorted order of the keys (window row << 32 | position), all
//    distinct, so any correct sort gives the same (order, seg). Each
//    lookup's key is its window row, id - lo; a pad and an id outside
//    the window are keyed after every real row. One launch, of one of
//    two kernels (the wrapper picks: presort_cluster in scatter_rows.py,
//    from the crossover measured on an H100):
//    - scatter_rank_kernel, below the crossover (about 4,600 lookups):
//      a lookup's place is the number of keys below its own; it is its
//      row's first when none of them has its row, and the keys with its
//      row count the row's lookups. Each block holds all n keys in shared
//      memory and ranks 16 lookups, a warp's lanes striding over the
//      keys: n^2 compares spread over the card, with no barrier in the
//      loop (at n = 2,048, 128 blocks of 2 x 64 compares a thread).
//    - scatter_radix_kernel, from the crossover: a least-significant-
//      digit radix sort by ONE thread-block cluster of C = 8 blocks. The
//      keys take bits = the bit width of rows (the pad key is `rows`: 22
//      bits for a rank's 4M-row block, 23 for the 8M-row table), so
//      ceil(bits / 8) passes of 8-bit digits. Block r holds the places
//      [r S, (r + 1) S) of the order so far (S = ceil(n / C) <=
//      kSliceMax) in its shared memory. A pass: each warp ranks its
//      32-key steps in place order, a key's rank within its digit being
//      the warp's count so far (a counter a digit a warp) plus the lower
//      lanes that share its digit (8 ballots, one a digit bit: faster
//      than __match_any_sync here); the counters become offsets in warp
//      order; each block writes its digit counts into every block's
//      shared memory (distributed shared memory stores) and a cluster
//      barrier publishes them; each block places its digits after every
//      block's lower digits and the lower blocks' keys of the same digit
//      and writes each key straight into the block that holds its new
//      place; a second barrier ends the pass. No atomics, so the order
//      is stable. After the last pass each place is a head when its key
//      is not the pad key and differs from the place before; a block
//      max-scan gives each place its run's head, the blocks' ends (last
//      head, first and last rows) go to every block for the carry across
//      blocks, and each run's last place writes its head lookup's
//      segment. Every read is local: a block only ever writes into
//      another. Why a cluster: 3 passes of n / C keys a block, in place
//      of n^2 compares with every block copying all n keys (33 MB of L2
//      reads at n = 8,192). Why radix and not bitonic: a one-block
//      bitonic sort tried first needed 66 dependent stages on one SM and
//      was slower than a whole scatter call; a radix pass has two
//      cluster barriers and no data-dependent stage count. Each pass
//      costs about 4 us on an H100 at any n (its phases are latency
//      bound: 16 warps a block, a few hundred dependent cycles a phase),
//      which is why the rank kernel stays below the crossover. Tried
//      and measured (tools/presort_probe.py): __match_any_sync for the
//      digit groups (0.5 us a pass slower than the ballots), 11-bit
//      digits (2 passes over 22 bits, but 8x the counters: slower), 8
//      warps a block (no gain), clusters of 1-16 blocks (8 fastest or
//      within 3 %), split-phase cluster barriers with the counters'
//      offsets and clearing between arrive and wait (0.5 us slower).
//    Above 16,384 lookups the wrapper sorts int32 ids with torch.sort
//    (stable) and derives the same segments with tensor ops: the JAX
//    pre-pass is XLA, not a Pallas kernel.
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
//    beat the rank pre-pass route (the radix pre-pass route beats it
//    from about 8,192 lookups on an H100). Tried first: the matches taken from
//    the ballot words one by one (slower on hot rows than the pre-pass
//    route), and a hash table of the rows in shared memory, built with
//    atomics, instead of the first scan (its build alone took longer
//    than the whole call).
//
// The window (items 1-4 with lo, rows): ids in [lo, lo + rows) are
// row id - lo of the block; any other id, and a pad, is keyed `rows`
// (kPadKey32 in item 4's keys), sorts last and owns no segment, so it is
// never read or written. The plain scatter is the window lo = 0, rows =
// the table's rows. The stateful entries take the window as kernel 4
// does (the stateful update of a rank's block of a table split in row
// blocks or by table, sharded_scatter_add_packed's shard_map over the
// stateful tile writes in JAX): a lookup of a row no lookup in the
// window names keeps that row's weight and state, as on one card.
//
// The update kernel of item 2 is launched with programmatic dependent
// launch: the pre-pass lets it start at once, and it loads its lookup's
// id, its base row and its first update row (none of which the pre-pass
// writes) before griddepcontrol.wait, which waits for the pre-pass to
// finish, and only then reads order and seg.
//
// Bound: memory. The function reads the ids (8 B a lookup), the updates
// (n/div rows), one table row (read-modify-write) or one forward row
// (write-only) per distinct row, and writes one row per distinct row: at
// the training shape (n = 2,048 lookups, d = 64) about 1.6 MB, 0.5 us at
// 3.35 TB/s; at a rank's n = 8,192 about 6.4 MB, 1.9 us. So a call is
// launch- and latency-bound: two launches, the pre-pass n^2 compares or
// 3 radix passes of two cluster barriers each, the update a few
// dependent loads deep
// (one launch on the stateful "fused" route). The stateful update adds a
// read and a write of each slab row per distinct row (Adam: 4 more rows).
//
// The guard: the four update entries take `ok`, a device pointer to the
// anomaly sentinel's int32 flag, or null. With a non-null `ok` whose
// value is 0, every thread of the update kernel returns before any load
// or store, so a non-finite step leaves the table and its state as they
// were (the JAX step keeps them with jnp.where(step_ok, new, old),
// dlrm_flexflow_tpu/core/model.py:1124-1130). The pre-pass writes no
// parameter and takes no flag.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "row_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlockSortMax = 16384;
// the rank pre-pass: 8 warps a block, lookups a warp ranks; a pad's key
constexpr int kRankThreads = 256;
constexpr int kRankPerWarp = 2;
constexpr int kRankPerBlock = kRankThreads / 32 * kRankPerWarp;
constexpr uint32_t kPadRow = 0xFFFFFFFFu;
// the radix pre-pass: threads a block, keys a block holds, 32-key steps a
// warp takes a pass, the largest cluster, digit bits
constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSliceMax = 2048;
constexpr int kSortSteps = kSliceMax / kSortThreads;
constexpr int kClusterMax = 16;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kDigitsPerThread = (kDigits + kSortThreads - 1) / kSortThreads;
constexpr int kUnroll = 8;                 // a group's update loads in flight
// the one-launch stateful route: its lookups, warps a block, and a pad
// slot's int32 key (the wrapper keeps row ids below 2^31 - 1)
constexpr int kFusedMax = 16384;
constexpr int kFusedWarps = 8;
constexpr int kStage = 8;        // ids a thread loads at once into the keys
constexpr int kScan = 8;         // 32-key chunks a warp compares at once
constexpr int kStep = 32 * kScan;  // keys a scan step
constexpr int kPadKey32 = 0x7FFFFFFF;

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The exclusive scan of v over the block's threads in thread order (a
// sum, or with kMax a maximum from -1), and in `total` the whole block's.
// Every thread calls it; scratch holds 32 ints.
template <bool kMax>
__device__ __forceinline__ int block_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int none = kMax ? -1 : 0;
  int x = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, s);
    if (lane >= s) x = kMax ? max(x, y) : x + y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kSortWarps ? scratch[lane] : none;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, s);
      if (lane >= s) w = kMax ? max(w, y) : w + y;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before = none;
  const int lower = warp > 0 ? scratch[warp - 1] : none;
  total = scratch[kSortWarps - 1];
  __syncthreads();                       // scratch is free again
  return kMax ? max(before, lower) : before + lower;
}

// The rank pre-pass (item 1, below the crossover): every lookup j's
// place p in the stable sorted order is the number of keys below its
// own, key = (window row << 32 | position), all keys distinct, a pad and
// an id outside the window keyed kPadRow. A block copies the n keys into
// shared memory; each warp ranks kRankPerWarp lookups, its lanes striding
// over the keys and summing by shuffle. It writes order[p] = j and, for
// the first lookup of each row (no smaller key with its row), seg[j] =
// (p, the row's lookup count); (-1, 0) for every other lookup.
__global__ void __launch_bounds__(kRankThreads)
scatter_rank_kernel(const int64_t* __restrict__ ids, int n, int64_t lo,
                    int64_t rows, int* __restrict__ order,
                    int2* __restrict__ seg) {
  asm volatile("griddepcontrol.launch_dependents;");
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

// What each block of the radix pre-pass's cluster tells every other one
// after the last pass: its last head's place and lookup when it has one
// past its first place (-1 otherwise), and its first place's lookup and
// its first and last places' rows.
struct SliceEnds {
  int last_place, last_lookup, first_lookup;
  uint32_t first_row, last_row;
};

// The radix pre-pass (item 1): one cluster of C blocks, launched alone.
// Writes order[p] = j, the lookup at place p of the stable order of
// (window row, position), and seg[j] = (p, the row's lookup count) for
// each row's first lookup j, (-1, 0) for every other lookup, pad and id
// outside [lo, lo + rows). bits: the bit width of rows (the pad key).
// Everything a block tells another it writes into that block's shared
// memory (distributed shared memory stores, which need no round trip);
// a cluster barrier then makes it visible, and every read is local.
// Dynamic shared memory: S keys, kSortWarps x kDigits counters, C x
// kDigits digit counts (every block's), kDigits digit offsets.
__global__ void __launch_bounds__(kSortThreads)
scatter_radix_kernel(const int64_t* __restrict__ ids, int n, int64_t lo,
                     int64_t rows, int bits, int* __restrict__ order,
                     int2* __restrict__ seg) {
  // the update kernel may start now: it waits for this grid to finish
  // before it reads order and seg
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ unsigned long long keys[];
  __shared__ int scratch[32];
  __shared__ SliceEnds ends[kClusterMax];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int S = (n + nc - 1) / nc;              // places a block holds
  const int p0 = r * S;                         // the block's first place
  const int cnt = max(0, min(S, n - p0));
  int* counts = reinterpret_cast<int*>(keys + S);
  int* hists = counts + kSortWarps * kDigits;   // [block][digit]
  int* base = hists + nc * kDigits;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // warp w's places: [w span, (w + 1) span) of the block's, 32 a step
  const int span = (S + kSortThreads - 1) / kSortThreads * 32;
  const int first = warp * span;
  const uint32_t pad = (uint32_t)rows;
  unsigned long long key[kSortSteps];
  int rank[kSortSteps], digit[kSortSteps];
#pragma unroll
  for (int k = 0; k < kSortSteps; ++k) {
    const int l = first + k * 32 + lane;
    key[k] = 0;
    if (k * 32 < span && l < cnt) {
      const int64_t id = ids[p0 + l];
      const int64_t row = id - lo;
      const bool in = id >= 0 && row >= 0 && row < rows;
      key[k] = ((unsigned long long)(in ? (uint32_t)row : pad) << 32)
               | (uint32_t)(p0 + l);
    }
  }
  int* mine = counts + warp * kDigits;
  const int passes = max(1, (bits + kDigitBits - 1) / kDigitBits);
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 32 + pass * kDigitBits;
    if (pass > 0) {
#pragma unroll
      for (int k = 0; k < kSortSteps; ++k) {
        const int l = first + k * 32 + lane;
        if (k * 32 < span && l < cnt) key[k] = keys[l];
      }
    }
    for (int d = lane; d < kDigits; d += 32) mine[d] = 0;
    __syncwarp();
    // each key's rank among the warp's keys of its digit, in place order
#pragma unroll
    for (int k = 0; k < kSortSteps; ++k) {
      if (k * 32 >= span) break;                  // warp-uniform
      const bool on = first + k * 32 + lane < cnt;
      const int d = (int)(key[k] >> shift) & (kDigits - 1);
      // the active lanes of d's group: one ballot a digit bit (faster
      // than __match_any_sync on this card)
      unsigned peers = __ballot_sync(0xffffffffu, on);
#pragma unroll
      for (int b = 0; b < kDigitBits; ++b) {
        const unsigned set = __ballot_sync(0xffffffffu, (d >> b) & 1);
        peers &= (d >> b) & 1 ? set : ~set;
      }
      const int below = __popc(peers & lanes_below());
      const int seen = on ? mine[d] : 0;
      digit[k] = d;
      rank[k] = seen + below;
      __syncwarp();
      if (on && below == 0) mine[d] = seen + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // per digit: the warps' offsets in warp order; the block's count,
    // written into every block
    for (int d = threadIdx.x; d < kDigits; d += kSortThreads) {
      int c[kSortWarps];
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w) c[w] = counts[w * kDigits + d];
      int run = 0;
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w) {
        counts[w * kDigits + d] = run;
        run += c[w];
      }
      for (int b = 0; b < nc; ++b)
        cluster.map_shared_rank(hists, b)[r * kDigits + d] = run;
    }
    cluster.sync();                   // every block's counts are here
    // a digit's keys of this block go after every block's lower digits
    // and the lower blocks' keys of that digit
    int tot[kDigitsPerThread], lower[kDigitsPerThread], sum = 0;
#pragma unroll
    for (int q = 0; q < kDigitsPerThread; ++q) {
      const int d = threadIdx.x * kDigitsPerThread + q;
      tot[q] = lower[q] = 0;
      if (d < kDigits)
        for (int c = 0; c < nc; ++c) {
          const int h = hists[c * kDigits + d];
          tot[q] += h;
          if (c < r) lower[q] += h;
        }
      sum += tot[q];
    }
    int all;
    int at = block_scan<false>(sum, scratch, all);
#pragma unroll
    for (int q = 0; q < kDigitsPerThread; ++q) {
      const int d = threadIdx.x * kDigitsPerThread + q;
      if (d < kDigits) base[d] = at + lower[q];
      at += tot[q];
    }
    __syncthreads();
    // each key into the block that holds its new place
#pragma unroll
    for (int k = 0; k < kSortSteps; ++k) {
      if (k * 32 >= span) break;
      if (first + k * 32 + lane < cnt) {
        const int to = base[digit[k]] + mine[digit[k]] + rank[k];
        const int c = to / S;
        cluster.map_shared_rank(keys, c)[to - c * S] = key[k];
      }
    }
    cluster.sync();                   // the pass's keys are in place
  }
  // heads and counts: thread t holds the places [t per, (t + 1) per) of
  // the block's; a place is a head when its key is not the pad key and
  // differs from the place before. The block's first place waits for
  // the lower block's last row, so it stays out of the block's scan
  const int per = (S + kSortThreads - 1) / kSortThreads;   // <= kSortSteps
  const int l0 = threadIdx.x * per;
  auto row_at = [&](int l) { return (uint32_t)(keys[l] >> 32); };
  int last = -1;
  bool head[kSortSteps];
#pragma unroll
  for (int q = 0; q < kSortSteps; ++q) {
    const int l = l0 + q;
    head[q] = false;
    if (q < per && l < cnt && l > 0) {
      const uint32_t row = row_at(l);
      head[q] = row != pad && row != row_at(l - 1);
      if (head[q]) last = p0 + l;
    }
  }
  int block_last;
  int start = block_scan<true>(last, scratch, block_last);
  if (threadIdx.x < nc && cnt > 0) {
    const SliceEnds e{
        block_last,
        block_last >= 0 ? (int)(uint32_t)keys[block_last - p0] : -1,
        (int)(uint32_t)keys[0], row_at(0), row_at(cnt - 1)};
    *cluster.map_shared_rank(&ends[r], threadIdx.x) = e;
  }
  cluster.sync();                     // every block's ends are here
  // the last head before this block's places: this block's first place
  // when it is one, else the last head of the highest lower block that
  // has one (a block's first place is a head when its row is not the pad
  // key and differs from the lower block's last row)
  int carry = -1, carry_lookup = -1;
  for (int c = r; c >= 0 && carry < 0; --c) {
    if (c < r && ends[c].last_place >= 0) {
      carry = ends[c].last_place;
      carry_lookup = ends[c].last_lookup;
    } else if (c < nc && (c < r || cnt > 0)) {
      const uint32_t row = ends[c].first_row;
      if (row != pad && (c == 0 || row != ends[c - 1].last_row)) {
        carry = c * S;
        carry_lookup = ends[c].first_lookup;
      }
    }
  }
  const bool head0 = cnt > 0 && carry == p0;
  if (threadIdx.x == 0 && per > 0) head[0] = head0;
  start = max(start, carry);
  const uint32_t next_row =
      r + 1 < nc && p0 + cnt < n ? ends[r + 1].first_row : pad;
#pragma unroll
  for (int q = 0; q < kSortSteps; ++q) {
    const int l = l0 + q;
    if (q < per && l < cnt) {
      const unsigned long long kv = keys[l];
      const uint32_t row = (uint32_t)(kv >> 32);
      const int j = (int)(uint32_t)kv;
      const int p = p0 + l;
      order[p] = j;
      if (head[q]) start = p;
      else seg[j] = make_int2(-1, 0);            // pads too
      if (row == pad) continue;
      // the run's last place writes its head lookup's segment
      if ((l + 1 < cnt ? row_at(l + 1) : next_row) != row) {
        const int h = start >= p0 ? (int)(uint32_t)keys[start - p0]
                                  : carry_lookup;
        seg[h] = make_int2(start, p - start + 1);
      }
    }
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
// from 0, of (scale times, with kScaled) upd[pos / div]'s chunk c: u0,
// the chunk of the segment's first lookup (the owner itself, loaded
// before the pre-pass ended), then the loads of kUnroll lookups in
// flight and their adds in order. order is read with coherent loads
// (no __ldg, no __restrict__): the pre-pass may still have been writing
// it when this grid started.
template <bool kScaled>
__device__ __forceinline__ float4 segment_sum(
    const int2 s, const float4 u0, const int* order,
    const float4* __restrict__ upd, int vec, int c, int div, float scale) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  add_scaled<kScaled>(acc, scale, u0);
  int k = s.x + 1;
  const int k1 = s.x + s.y;
  for (; k + kUnroll <= k1; k += kUnroll) {
    int pos[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) pos[i] = order[k + i];
    float4 u[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      u[i] = __ldg(upd + (int64_t)(pos[i] / div) * vec + c);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) add_scaled<kScaled>(acc, scale, u[i]);
  }
  for (; k < k1; ++k)
    add_scaled<kScaled>(
        acc, scale, __ldg(upd + (int64_t)(order[k] / div) * vec + c));
  return acc;
}

// Waits for the grids this one depends on (the pre-pass, under
// programmatic dependent launch) to finish and their writes to show; a
// no-op in a grid launched without it.
__device__ __forceinline__ void wait_for_prepass() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Group g (vec threads, one per 16-byte chunk) serves the segment of row
// ids[g] - lo when lookup g is that row's first; the others exit once
// the pre-pass is done (it gave no segment to a pad or an id outside the
// window [lo, lo + rows)). Before that, the group loads what the
// pre-pass does not write: its id, its base row and its own update row.
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(float4* __restrict__ table,
                    const int64_t* __restrict__ ids, const int* order,
                    const int2* seg,
                    const float4* __restrict__ upd,
                    const float4* __restrict__ fwd, int n, int vec, int div,
                    float scale, int64_t lo, int64_t rows,
                    const int* __restrict__ ok) {
  if (ok && __ldg(ok) == 0) return;       // the sentinel skips this step
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t g = t / vec;
  if (g >= n) return;
  const int c = (int)(t - g * vec);
  const int64_t row = __ldg(ids + g) - lo;   // lo >= 0: a pad is < 0
  // write-only: lookup g's forward row (every duplicate's holds the same
  // pre-update value); read-modify-write: the table row, when g's id is
  // in the window at all
  const float4 base = fwd ? __ldg(fwd + g * vec + c)
                          : row >= 0 && row < rows
                                ? table[row * vec + c]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 u0 = __ldg(upd + (g / div) * vec + c);
  wait_for_prepass();
  const int2 s = seg[g];
  if (s.x < 0) return;
  const float4 acc = segment_sum<true>(s, u0, order, upd, vec, c, div, scale);
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
                     int div, int64_t lo, OptParams p,
                     const int* __restrict__ ok) {
  if (ok && __ldg(ok) == 0) return;       // the sentinel skips this step
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t g = t / vec;
  if (g >= n) return;
  const int2 s = __ldg(seg + g);
  if (s.x < 0) return;
  const int c = (int)(t - g * vec);
  const int64_t at = (__ldg(ids + g) - lo) * vec + c;
  // the weight, state and step loads overlap the segment's
  float4 w = fwd ? __ldg(fwd + g * vec + c) : table[at];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s0 = slab0 ? slab0[at] : zero;
  float4 s1 = slab1 ? slab1[at] : zero;
  const float a = alpha_t ? __ldg(alpha_t) : 0.f;
  const float4 u0 = __ldg(upd + (g / div) * vec + c);
  const float4 acc = segment_sum<false>(s, u0, order, upd, vec, c, div, 1.f);
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
// A key is the lookup's row in the window [lo, lo + rows), kPadKey32
// for a pad and for an id outside it.
__global__ void __launch_bounds__(kFusedWarps * 32)
stateful_fused_kernel(float4* __restrict__ table,
                      const int64_t* __restrict__ ids,
                      const float4* __restrict__ upd,
                      const float4* __restrict__ fwd,
                      float4* __restrict__ slab0, float4* __restrict__ slab1,
                      const float* __restrict__ alpha_t, int n, int npad,
                      int vec, int div, int64_t lo, int64_t rows,
                      OptParams p, const int* __restrict__ ok) {
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
      const int64_t w = id[q] - lo;             // lo >= 0: a pad is < 0
      if (i < npad)
        keys32[i] = id[q] < 0 || w < 0 || w >= rows ? kPadKey32 : (int)w;
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

// the update kernel starts under programmatic dependent launch
constexpr int kDependentLaunch = 1;

int launch(void* table, const void* ids, const void* order, const void* seg,
           const void* upd, const void* fwd, int n, int dim, int div,
           float scale, int64_t lo, int64_t rows, const void* ok,
           void* stream) {
  if (n <= 0) return 0;
  const int vec = dim / 4;
  const long long blocks = ((long long)n * vec + kThreads - 1) / kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = kDependentLaunch;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, scatter_rows_kernel, (float4*)table, (const int64_t*)ids,
      (const int*)order, (const int2*)seg, (const float4*)upd,
      (const float4*)fwd, n, vec, div, scale, lo, rows, (const int*)ok);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();              // clear the launch error
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// Sets a kernel's largest dynamic shared memory (at most what the card
// leaves beside its static shared memory) once per device, and allows
// clusters of more than 8 blocks.
cudaError_t allow_smem(const void* kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      std::min(bytes, optin - (int)fa.sharedSizeBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// The pre-pass over the window [lo, lo + rows) (see ff_scatter_presort):
// the rank kernel with cluster 0, else the radix kernel's one cluster.
int presort(const void* ids, int n, int64_t lo, int64_t rows, int bits,
            int cluster, void* order, void* seg, void* stream) {
  if (n <= 0) return 0;
  if (n > kBlockSortMax || cluster < 0 || cluster > kClusterMax
      || (cluster > 0 && (n + cluster - 1) / cluster > kSliceMax)
      || rows < 0 || rows > (int64_t(1) << 31) || bits < 0 || bits > 32
      || (bits < 32 && (rows >> bits) != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (cluster == 0) {
    static bool done[64] = {};
    err = allow_smem((const void*)scatter_rank_kernel,
                     kBlockSortMax * (int)sizeof(unsigned long long), done);
    if (err != cudaSuccess) return (int)err;
    scatter_rank_kernel<<<(n + kRankPerBlock - 1) / kRankPerBlock,
                          kRankThreads, n * sizeof(unsigned long long),
                          (cudaStream_t)stream>>>(
        (const int64_t*)ids, n, lo, rows, (int*)order, (int2*)seg);
    return (int)cudaGetLastError();
  }
  static bool done[64] = {};
  const auto smem = [](int slice, int blocks) {
    return slice * (int)sizeof(unsigned long long)
           + (kSortWarps + blocks + 1) * kDigits * (int)sizeof(int);
  };
  err = allow_smem((const void*)scatter_radix_kernel,
                   smem(kSliceMax, kClusterMax), done);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kSortThreads, 1, 1);
  cfg.dynamicSmemBytes = smem((n + cluster - 1) / cluster, cluster);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, scatter_radix_kernel, (const int64_t*)ids,
                           n, lo, rows, bits, (int*)order, (int2*)seg);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most lookups the pre-pass sorts (a cluster of kClusterMax / 2
// blocks of kSliceMax keys).
int ff_scatter_block_sort_max() { return kBlockSortMax; }

// ids: (n,) int64, n <= kBlockSortMax; the window [lo, lo + rows) of a
// table's rows, lo >= 0, rows <= 2^31, bits >= the bit width of rows;
// cluster: 0 for the rank kernel, else the radix kernel's blocks of its
// one cluster, 1..kClusterMax, with ceil(n / cluster) <= kSliceMax. An id in the window is row id - lo;
// any other id, and a pad (< 0), is keyed `rows`, last, and owns no
// segment. Writes order (n,) int32, the lookups in stable order of their
// rows, and seg (n, 2) int32: for the first lookup j of each row, (its
// place in order, the row's lookup count); (-1, 0) for the others. One
// launch on `stream`; returns its CUDA error.
int ff_scatter_presort(const void* ids, int n, long long lo, long long rows,
                       int bits, int cluster, void* order, void* seg,
                       void* stream) {
  return presort(ids, n, lo, rows, bits, cluster, order, seg, stream);
}

// table: the window [lo, lo + rows) of a table's rows, (rows, dim) fp32,
// updated in place; ids: (n,) int64, rows of the whole table; order,
// seg: ff_scatter_presort's outputs over the same window, so an id
// outside it changes nothing; upd: (n / div, dim) fp32. Lookup g of a
// segment updates table row ids[g] - lo. dim % 4 == 0 and 16-byte aligned
// pointers (the wrapper checks). ok: the sentinel's device int32 flag
// (0: change nothing), or null. Launches on `stream` (programmatic
// dependent launch after the pre-pass); returns its CUDA error.
int ff_scatter_add_rows(void* table, const void* ids, const void* order,
                        const void* seg, const void* upd, int n, int dim,
                        int div, float scale, long long lo, long long rows,
                        const void* ok, void* stream) {
  return launch(table, ids, order, seg, upd, nullptr, n, dim, div, scale, lo,
                rows, ok, stream);
}

// As ff_scatter_add_rows, but writes fwd[first lookup] + sum without
// reading the table; fwd: (n, dim) fp32, the row each lookup read in the
// forward.
int ff_scatter_write_rows(void* table, const void* ids, const void* order,
                          const void* seg, const void* upd, const void* fwd,
                          int n, int dim, int div, float scale,
                          const void* ok, void* stream) {
  return launch(table, ids, order, seg, upd, fwd, n, dim, div, scale, 0, 0,
                ok, stream);
}

// The stateful touched-rows update: table, ids, order, seg, upd and fwd
// as in ff_scatter_write_rows (fwd may be null: the table row is read),
// upd the raw gradient rows (no scale). slab0, slab1: (rows, dim) fp32
// state, updated in place, or null (see stateful_rows_kernel). alpha_t:
// a device pointer to Adam's fp32 step size (null for SGD). adam 0 runs
// SGD (lr, momentum, nesterov, wd), 1 Adam (wd, b1, c1, b2, c2, eps).
// table, slabs: the window [lo, lo + rows) of a table's rows, order and
// seg the pre-pass's over it (lo 0: the whole table). ok as in
// ff_scatter_add_rows. Launches on `stream`; returns cudaGetLastError().
int ff_stateful_update_rows(void* table, const void* ids, const void* order,
                            const void* seg, const void* upd, const void* fwd,
                            void* slab0, void* slab1, const void* alpha_t,
                            int n, int dim, int div, int adam, int nesterov,
                            float wd, float lr, float momentum, float b1,
                            float c1, float b2, float c2, float eps,
                            long long lo, const void* ok, void* stream) {
  if (n <= 0) return 0;
  const int vec = dim / 4;
  const OptParams p{adam, nesterov, wd, lr, momentum, b1, c1, b2, c2, eps};
  const long long blocks = ((long long)n * vec + kThreads - 1) / kThreads;
  stateful_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (float4*)table, (const int64_t*)ids, (const int*)order,
      (const int2*)seg, (const float4*)upd, (const float4*)fwd,
      (float4*)slab0, (float4*)slab1, (const float*)alpha_t, n, vec, div,
      (int64_t)lo, p, (const int*)ok);
  return (int)cudaGetLastError();
}

// The most lookups the one-launch stateful route takes (their int32 keys
// and the warps' buffers fill 80 KB of a block's shared memory).
int ff_stateful_fused_max() { return kFusedMax; }

// As ff_stateful_update_rows, in one launch and without the pre-pass's
// order and seg: stateful_fused_kernel. n <= kFusedMax; table and slabs
// the window [lo, lo + rows) of a table's rows, rows < 2^31 - 1; an id
// outside it, or a negative one (a pad), changes nothing.
int ff_stateful_update_fused(void* table, const void* ids, const void* upd,
                             const void* fwd, void* slab0, void* slab1,
                             const void* alpha_t, int n, int dim, int div,
                             int adam, int nesterov, float wd, float lr,
                             float momentum, float b1, float c1, float b2,
                             float c2, float eps, long long lo,
                             long long rows, const void* ok, void* stream) {
  if (n <= 0) return 0;
  if (n > kFusedMax || lo < 0 || rows < 0 || rows >= kPadKey32)
    return (int)cudaErrorInvalidValue;
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
      (const float*)alpha_t, n, npad, dim / 4, div, (int64_t)lo,
      (int64_t)rows, p, (const int*)ok);
  return (int)cudaGetLastError();
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
