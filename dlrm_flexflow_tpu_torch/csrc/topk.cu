// Int8 maximum-inner-product top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _topk_kernel
// (dlrm_flexflow_tpu/ops/pallas/topk_kernel.py:117), entered there through
// _pallas_topk and mips_topk.
//
// Computes, for every query b of B over the R rows of one index block:
//   dot[b, r]   = sum_k q[b, k] * codes[r, k]          (exact, int32)
//   comb[b, r]  = scale[r] * qscale[b]                 (fp32, first)
//   score[b, r] = (float)dot[b, r] * comb[b, r]        (fp32, then)
// and returns the K best (score, base + r) pairs of each query, ordered
// by score descending, ties by id ascending: bit for bit what the plain
// version (ops/kernels/topk.py, mips_topk_reference) and the JAX oracle
// compute. Scores are compared as floats, so -0.0 and +0.0 tie and fall
// to the id order, as in the oracle's lexsort (a radix key on the raw
// bits would not). No fast-math: the two multiplies are __fmul_rn.
//
// Bound: memory. Every row's d code bytes and 4 scale bytes are read
// once per call; the B query rows and the B*K results are small. At
// B = 64, R = 1M, d = 32 that is 36 MB, 10.7 us at 3.35 TB/s, against
// 2*B*R*d = 4.1 G int8 operations, 2.1 us at 1,979 TOPS.
//
// Design: select, then sort. The top K of a query are among the rows
// scoring at or above the K-th largest of its chunk maxima (each chunk
// maximum is a distinct row's score, so at least K rows reach it, and
// the true top K all do). So (ff_topk_select, then ff_topk_sort):
//   1. chunk_max_kernel: a block scores a chunk of c rows (c a power of
//      two from 32 to 2,048, the largest that leaves 4K chunks or more)
//      for a tile of QB queries (1, 4 or 16), each row's code words
//      loaded once for all of them, with __dp4a, and writes each query's
//      chunk maximum; with B·R small (B = 1 at 1M rows) it also keeps
//      every score in a scratch.
//   2. threshold_kernel: one block per query finds the K-th largest chunk
//      maximum by a 4-pass radix select over order-preserving keys;
//      -inf when there are fewer than K chunks.
//   3. compact_codes_kernel (rescoring the codes, which stay in the 50
//      MB L2) or compact_scores_kernel (reading the score scratch): rows
//      scoring >= the threshold are appended, a warp's at once, to the
//      query's buffer of kCap candidates; the count goes past kCap when
//      they do not fit.
//   4. sort_candidates: one block per query orders its candidates in
//      shared memory, by rank up to 2,048 of them (each one's place the
//      number that go before it), else by a bitonic sort padded to a
//      power of two the wrapper takes from the counts, and writes the
//      first K.
// Overflow route: when a query's candidates exceed kCap (many tied
// scores, or all R rows when there are fewer than K chunks and R >
// kCap) the wrapper runs the first design instead, which is bitwise the
// same: score_chunks, one block per (2,048-row chunk, query), scores with
// __dp4a and bitonic-sorts the chunk's (score, id) pairs, keeping its
// top K; merge_chunks repeats the sort over the partial top-Ks until one
// chunk remains. The (B, R) scores are never held at large B: the
// rescoring pass reads the codes again instead.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 2048;    // candidates one block sorts (overflow)
constexpr int kThreads = 512;
constexpr int kMaxK = 1024;     // K < kChunk keeps each pass shrinking
constexpr long long kPadId = 0x7fffffffffffffffLL;
// the select route
constexpr int kCap = 8192;               // candidates a query may keep
constexpr int kMaxChunkRows = 2048, kMinChunkRows = 32;
constexpr int kScanThreads = 256;
constexpr int kSortThreads = 1024;
constexpr int kRankSortMax = 2048;       // candidates sorted by rank
constexpr long long kScoresMax = 1LL << 22;   // B·R of the score scratch

// (score desc, id asc): true when a goes before b
__device__ __forceinline__ bool before(float sa, long long ia, float sb,
                                       long long ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Bitonic sort of n (a power of two) (score, id) pairs into (score
// desc, id asc) by the block's threads.
template <typename I>
__device__ void bitonic_sort(float* s, I* id, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const bool first_half = (i & k) == 0;
          // in a first-half run i goes before p; in the other, after
          const bool swap = first_half ? before(s[p], id[p], s[i], id[i])
                                       : before(s[i], id[i], s[p], id[p]);
          if (swap) {
            const float ts = s[i];
            s[i] = s[p];
            s[p] = ts;
            const I ti = id[i];
            id[i] = id[p];
            id[p] = ti;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
score_chunks(const int8_t* __restrict__ q, const float* __restrict__ qscale,
             const int8_t* __restrict__ codes,
             const float* __restrict__ scales, float* __restrict__ out_s,
             long long* __restrict__ out_i, long long R, int d, int K,
             long long base) {
  __shared__ float s[kChunk];
  __shared__ long long id[kChunk];
  extern __shared__ int qw[];   // the query's d/4 code words
  const int b = blockIdx.y;
  const long long chunk = blockIdx.x;
  const int words = d / 4;
  const int* qrow = reinterpret_cast<const int*>(q + (long long)b * d);
  for (int w = threadIdx.x; w < words; w += kThreads) qw[w] = qrow[w];
  __syncthreads();
  const float qs = qscale[b];
  for (int i = threadIdx.x; i < kChunk; i += kThreads) {
    const long long r = chunk * kChunk + i;
    if (r < R) {
      const int* crow = reinterpret_cast<const int*>(codes + r * d);
      int dot = 0;
      for (int w = 0; w < words; ++w) dot = __dp4a(__ldg(crow + w), qw[w], dot);
      const float comb = __fmul_rn(__ldg(scales + r), qs);
      s[i] = __fmul_rn((float)dot, comb);
      id[i] = base + r;
    } else {
      s[i] = -INFINITY;
      id[i] = kPadId;
    }
  }
  __syncthreads();
  bitonic_sort(s, id, kChunk);
  const long long o = ((long long)b * gridDim.x + chunk) * K;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    out_s[o + i] = s[i];
    out_i[o + i] = id[i];
  }
}

// in: (B, n) candidates per query; out: (B, gridDim.x, K), each chunk of
// kChunk candidates reduced to its top K
__global__ void __launch_bounds__(kThreads)
merge_chunks(const float* __restrict__ in_s,
             const long long* __restrict__ in_i, float* __restrict__ out_s,
             long long* __restrict__ out_i, long long n, int K) {
  __shared__ float s[kChunk];
  __shared__ long long id[kChunk];
  const int b = blockIdx.y;
  const long long chunk = blockIdx.x;
  for (int i = threadIdx.x; i < kChunk; i += kThreads) {
    const long long c = chunk * kChunk + i;
    if (c < n) {
      s[i] = in_s[(long long)b * n + c];
      id[i] = in_i[(long long)b * n + c];
    } else {
      s[i] = -INFINITY;
      id[i] = kPadId;
    }
  }
  __syncthreads();
  bitonic_sort(s, id, kChunk);
  const long long o = ((long long)b * gridDim.x + chunk) * K;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    out_s[o + i] = s[i];
    out_i[o + i] = id[i];
  }
}

// ---- the select route ----------------------------------------------

// a > b as floats (other than -0.0 against +0.0) iff key(a) > key(b)
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The query words qw (QB queries of `words` words, zero past the valid
// queries, 8 words of zero padding) of the block's tile, then its scales.
template <int QB>
__device__ void load_queries(const int8_t* __restrict__ q,
                             const float* __restrict__ qscale, int q0,
                             int nq, int words, int* qw, float* qs) {
  const int* src = reinterpret_cast<const int*>(q) + (size_t)q0 * words;
  for (int w = threadIdx.x; w < QB * words + 8; w += blockDim.x)
    qw[w] = w < nq * words ? src[w] : 0;
  if (threadIdx.x < QB)
    qs[threadIdx.x] = threadIdx.x < nq ? qscale[q0 + threadIdx.x] : 0.f;
  __syncthreads();
}

// dot[q] = the int32 code dot of row `crow` with query q of the tile: the
// row's words loaded once (16 bytes at a time when vec) for all QB
template <int QB>
__device__ __forceinline__ void row_dots(const int* __restrict__ crow,
                                         const int* qw, int words, bool vec,
                                         int (&dot)[QB]) {
#pragma unroll
  for (int q = 0; q < QB; ++q) dot[q] = 0;
  for (int w0 = 0; w0 < words; w0 += 8) {
    int cw[8];
    if (vec) {
#pragma unroll
      for (int h = 0; h < 8; h += 4) {
        int4 v = make_int4(0, 0, 0, 0);
        if (w0 + h < words)
          v = __ldg(reinterpret_cast<const int4*>(crow + w0 + h));
        cw[h] = v.x; cw[h + 1] = v.y; cw[h + 2] = v.z; cw[h + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cw[i] = w0 + i < words ? __ldg(crow + w0 + i) : 0;
    }
#pragma unroll
    for (int q = 0; q < QB; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dot[q] = __dp4a(cw[i], qw[q * words + w0 + i], dot[q]);
  }
}

// score = (float)dot * (row scale * query scale), as the oracle
__device__ __forceinline__ float score_of(int dot, float scale, float qs) {
  return __fmul_rn((float)dot, __fmul_rn(scale, qs));
}

// Pass 1: each query's maximum over chunk blockIdx.x of c rows, for the
// tile of QB queries blockIdx.y; every score into `scores` (B, R) too
// when it is not null.
template <int QB>
__global__ void __launch_bounds__(kScanThreads)
chunk_max_kernel(const int8_t* __restrict__ q,
                 const float* __restrict__ qscale,
                 const int8_t* __restrict__ codes,
                 const float* __restrict__ scales, float* __restrict__ cmax,
                 float* __restrict__ scores, long long R, int B, int d,
                 int c, long long nch, bool vec) {
  extern __shared__ int qw[];
  __shared__ float qs[QB];
  __shared__ float wmax[kScanThreads / 32][QB];
  const int words = d / 4, q0 = blockIdx.y * QB, nq = min(QB, B - q0);
  load_queries<QB>(q, qscale, q0, nq, words, qw, qs);
  float m[QB];
#pragma unroll
  for (int k = 0; k < QB; ++k) m[k] = -INFINITY;
  const long long r0 = (long long)blockIdx.x * c;
  for (int i = threadIdx.x; i < c && r0 + i < R; i += blockDim.x) {
    const long long r = r0 + i;
    int dot[QB];
    row_dots<QB>(reinterpret_cast<const int*>(codes + r * d), qw, words,
                 vec, dot);
    const float sc = __ldg(scales + r);
#pragma unroll
    for (int k = 0; k < QB; ++k) {
      if (k >= nq) break;
      const float v = score_of(dot[k], sc, qs[k]);
      m[k] = fmaxf(m[k], v);
      if (scores) scores[(size_t)(q0 + k) * R + r] = v;
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < QB; ++k) {
    float v = m[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) wmax[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    float v = -INFINITY;
    for (int w = 0; w < (int)blockDim.x / 32; ++w)
      v = fmaxf(v, wmax[w][threadIdx.x]);
    cmax[(size_t)(q0 + threadIdx.x) * nch + blockIdx.x] = v;
  }
}

// Pass 2: thr[b] = the K-th largest of query b's nch chunk maxima (-inf
// when nch < K), by a radix select over order keys, 8 bits a pass from
// the top; count[b] = 0 for pass 3.
__global__ void __launch_bounds__(kScanThreads)
threshold_kernel(const float* __restrict__ cmax, long long nch, int K,
                 float* __restrict__ thr, int* __restrict__ count) {
  __shared__ unsigned int hist[256];
  __shared__ uint32_t prefix_s;
  __shared__ int need_s;
  const int b = blockIdx.x;
  const float* row = cmax + (size_t)b * nch;
  if (threadIdx.x == 0) count[b] = 0;
  if (nch < K) {
    if (threadIdx.x == 0) thr[b] = -INFINITY;
    return;
  }
  uint32_t prefix = 0;    // the high bits of the K-th largest key found
  int need = K;           // its rank among the keys with that prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    const uint32_t mask = shift == 24 ? 0u : 0xFFFFFFFFu << (shift + 8);
    for (long long i = threadIdx.x; i < nch; i += blockDim.x) {
      const uint32_t key = order_key(row[i]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) {   // the bin holding it: a scan from the top
      const int lane = threadIdx.x;
      int c[8], sum = 0;      // lane l holds bins 255 - 8l down to 248 - 8l
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = (int)hist[255 - 8 * lane - j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int excl = incl - sum;
      const unsigned hit = __ballot_sync(0xffffffffu,
                                         excl < need && incl >= need);
      if (lane == __ffs(hit) - 1) {
        int above = excl, j = 0;
        for (; j < 7; ++j) {
          if (above + c[j] >= need) break;
          above += c[j];
        }
        need_s = need - above;
        prefix_s = prefix | ((uint32_t)(255 - 8 * lane - j) << shift);
      }
    }
    __syncthreads();
    prefix = prefix_s;
    need = need_s;
    __syncthreads();      // every thread has read them before the next pass
  }
  if (threadIdx.x == 0) thr[b] = key_float(prefix);
}

// The lanes with `take` append (s, r) to a query's candidates: one
// atomic a warp; past kCap only the count grows. Every lane calls it.
__device__ __forceinline__ void append(bool take, float s, int r,
                                       int* count, float* cs, int* cr) {
  const unsigned mask = __ballot_sync(0xffffffffu, take);
  if (!mask) return;
  const int lane = threadIdx.x % 32, leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (take) {
    const int pos = base + __popc(mask & ((1u << lane) - 1u));
    if (pos < kCap) {
      cs[pos] = s;
      cr[pos] = r;
    }
  }
}

// Pass 3, rescoring: chunk_max_kernel's grid and scores, each score >=
// its query's threshold appended.
template <int QB>
__global__ void __launch_bounds__(kScanThreads)
compact_codes_kernel(const int8_t* __restrict__ q,
                     const float* __restrict__ qscale,
                     const int8_t* __restrict__ codes,
                     const float* __restrict__ scales,
                     const float* __restrict__ thr, int* __restrict__ count,
                     float* __restrict__ cand_s, int* __restrict__ cand_r,
                     long long R, int B, int d, int c, bool vec) {
  extern __shared__ int qw[];
  __shared__ float qs[QB];
  __shared__ float th[QB];
  const int words = d / 4, q0 = blockIdx.y * QB, nq = min(QB, B - q0);
  if (threadIdx.x < QB)
    th[threadIdx.x] = threadIdx.x < nq ? thr[q0 + threadIdx.x] : 0.f;
  load_queries<QB>(q, qscale, q0, nq, words, qw, qs);
  const long long r0 = (long long)blockIdx.x * c;
  for (int i0 = 0; i0 < c; i0 += blockDim.x) {   // warp-uniform trips
    const long long r = r0 + i0 + threadIdx.x;
    const bool live = r < R;
    int dot[QB];
    float sc = 0.f;
    if (live) {
      row_dots<QB>(reinterpret_cast<const int*>(codes + r * d), qw, words,
                   vec, dot);
      sc = __ldg(scales + r);
    }
#pragma unroll
    for (int k = 0; k < QB; ++k) {
      if (k >= nq) break;
      const float v = live ? score_of(dot[k], sc, qs[k]) : 0.f;
      const size_t b = q0 + k;
      append(live && v >= th[k], v, (int)r, count + b, cand_s + b * kCap,
             cand_r + b * kCap);
    }
  }
}

// Pass 3 from the score scratch: block (chunk, query).
__global__ void __launch_bounds__(kScanThreads)
compact_scores_kernel(const float* __restrict__ scores,
                      const float* __restrict__ thr, int* __restrict__ count,
                      float* __restrict__ cand_s, int* __restrict__ cand_r,
                      long long R, int c) {
  const size_t b = blockIdx.y;
  const float t = thr[b];
  const long long r0 = (long long)blockIdx.x * c;
  for (int i0 = 0; i0 < c; i0 += blockDim.x) {
    const long long r = r0 + i0 + threadIdx.x;
    const bool live = r < R;
    const float v = live ? __ldcs(scores + b * R + r) : 0.f;
    append(live && v >= t, v, (int)r, count + b, cand_s + b * kCap,
           cand_r + b * kCap);
  }
}

// Pass 4: block b sorts query b's candidates and writes the first K
// with ids base + row: up to kRankSortMax by rank (n² compares spread
// over the threads, no barrier), above it by a bitonic sort padded to
// n2 with (-inf, INT_MAX).
__global__ void __launch_bounds__(kSortThreads)
sort_candidates(const float* __restrict__ cand_s,
                const int* __restrict__ cand_r,
                const int* __restrict__ count, int n2, int K,
                long long base, float* __restrict__ out_s,
                long long* __restrict__ out_i) {
  extern __shared__ float sm[];            // n2 scores, then n2 rows
  float* s = sm;
  int* id = reinterpret_cast<int*>(sm + n2);
  const size_t b = blockIdx.x;
  const int n = min(count[b], kCap);
  if (n2 <= kRankSortMax) {
    // few candidates: each one's place is the number that go before it
    // (all distinct: the ids differ), counted with no barrier in the loop
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s[i] = cand_s[b * kCap + i];
      id[i] = cand_r[b * kCap + i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float si = s[i];
      const int ii = id[i];
      int place = 0;
      for (int j = 0; j < n; ++j) place += before(s[j], id[j], si, ii);
      if (place < K) {
        out_s[b * K + place] = si;
        out_i[b * K + place] = base + ii;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    if (i < n) {
      s[i] = cand_s[b * kCap + i];
      id[i] = cand_r[b * kCap + i];
    } else {
      s[i] = -INFINITY;
      id[i] = 0x7fffffff;
    }
  }
  __syncthreads();
  bitonic_sort(s, id, n2);
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    out_s[b * K + i] = s[i];
    out_i[b * K + i] = base + id[i];
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Entries of each scratch buffer (scores, ids): the first pass's
// (B, ceil(R / kChunk), K) partials, then room for the second pass's;
// every later pass writes fewer than the pass two before it, and the last
// writes the outputs. 0 when one chunk holds all R rows.
long long scratch_entries(int B, long long R, int K) {
  const long long n0 = cdiv(R, kChunk);
  if (n0 <= 1) return 0;
  return (long long)B * K * (n0 + cdiv(n0 * K, kChunk));
}

// Rows of a select-route chunk for R rows and the top K: the largest
// power of two from kMinChunkRows to kMaxChunkRows that leaves at least
// 4K chunks, so that the K-th largest chunk maximum lies near the K-th
// largest score.
int chunk_rows(long long R, int K) {
  int c = kMaxChunkRows;
  while (c > kMinChunkRows && cdiv(R, c) < 4LL * K) c >>= 1;
  return c;
}

template <int QB>
cudaError_t launch_select(const void* q, const void* qscale,
                          const void* codes, const void* scales, int B,
                          long long R, int d, int K, void* cmax, void* thr,
                          void* count, void* scores, void* cand_s,
                          void* cand_r, cudaStream_t st) {
  const int c = chunk_rows(R, K);
  const long long nch = cdiv(R, c);
  const int threads = c < kScanThreads ? c : kScanThreads;
  const dim3 grid((unsigned)nch, (unsigned)cdiv(B, QB));
  const size_t qsm = (size_t)(QB * (d / 4) + 8) * sizeof(int);
  const bool vec = d % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  chunk_max_kernel<QB><<<grid, threads, qsm, st>>>(
      (const int8_t*)q, (const float*)qscale, (const int8_t*)codes,
      (const float*)scales, (float*)cmax, (float*)scores, R, B, d, c, nch,
      vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  threshold_kernel<<<B, kScanThreads, 0, st>>>((const float*)cmax, nch, K,
                                               (float*)thr, (int*)count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (scores)
    compact_scores_kernel<<<dim3((unsigned)nch, B), threads, 0, st>>>(
        (const float*)scores, (const float*)thr, (int*)count,
        (float*)cand_s, (int*)cand_r, R, c);
  else
    compact_codes_kernel<QB><<<grid, threads, qsm, st>>>(
        (const int8_t*)q, (const float*)qscale, (const int8_t*)codes,
        (const float*)scales, (const float*)thr, (int*)count,
        (float*)cand_s, (int*)cand_r, R, B, d, c, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ff_topk_max_k() { return kMaxK; }
int ff_topk_cap() { return kCap; }
int ff_topk_chunk_rows(long long R, int K) { return chunk_rows(R, K); }
long long ff_topk_scores_max() { return kScoresMax; }

// The select route's passes 1-3 (see the design above). q: (B, d) int8;
// qscale: (B,) fp32; codes: (R, d) int8; scales: (R,) fp32, R < 2^31;
// cmax: B · ceil(R / ff_topk_chunk_rows(R, K)) fp32 scratch; thr (B,)
// fp32 and count (B,) int32 out; scores: (B, R) fp32 scratch, or null to
// rescore the codes (the wrapper passes it when B · R <=
// ff_topk_scores_max()); cand_s (B, kCap) fp32 and cand_r (B, kCap)
// int32 out: query b's first min(count[b], kCap) candidates, in no
// order. 1 <= K <= min(R, kMaxK), d % 4 == 0, 4-byte aligned codes.
// Launches on `stream`; returns the first CUDA error.
int ff_topk_select(const void* q, const void* qscale, const void* codes,
                   const void* scales, int B, long long R, int d, int K,
                   void* cmax, void* thr, void* count, void* scores,
                   void* cand_s, void* cand_r, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      B >= 16 ? launch_select<16>(q, qscale, codes, scales, B, R, d, K, cmax,
                                  thr, count, scores, cand_s, cand_r, st)
      : B >= 4 ? launch_select<4>(q, qscale, codes, scales, B, R, d, K, cmax,
                                  thr, count, scores, cand_s, cand_r, st)
               : launch_select<1>(q, qscale, codes, scales, B, R, d, K, cmax,
                                  thr, count, scores, cand_s, cand_r, st);
  return (int)e;
}

// The select route's pass 4: every count[b] <= n2 <= kCap, n2 a power of
// two; out_s (B, K) fp32 and out_i (B, K) int64 as ff_mips_topk's.
int ff_topk_sort(const void* cand_s, const void* cand_r, const void* count,
                 int B, int K, int n2, long long base, void* out_s,
                 void* out_i, void* stream) {
  if (B <= 0) return 0;
  if (n2 < 1 || n2 > kCap || (n2 & (n2 - 1))) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n2 * 8;
  static bool allowed[64] = {};      // above 48 KB, set once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || !allowed[dev])) {
    err = cudaFuncSetAttribute((const void*)sort_candidates,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kCap * 8);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = true;
  }
  // a thread a candidate when ranking, one for two when bitonic sorting
  const int per = n2 <= kRankSortMax ? n2 : n2 / 2;
  const int threads = per < 32 ? 32 : per > kSortThreads ? kSortThreads : per;
  sort_candidates<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)cand_s, (const int*)cand_r, (const int*)count, n2, K,
      base, (float*)out_s, (long long*)out_i);
  return (int)cudaGetLastError();
}
long long ff_topk_scratch_entries(int B, long long R, int K) {
  return scratch_entries(B, R, K);
}

// The overflow route, the whole call. q: (B, d) int8; qscale: (B,)
// fp32; codes: (R, d) int8; scales: (R,) fp32; out_s (B, K) fp32, out_i
// (B, K) int64; scratch_s (fp32) and
// scratch_i (int64) of ff_topk_scratch_entries(B, R, K) entries each.
// 1 <= K <= min(R, kMaxK), d % 4 == 0, 4-byte aligned pointers (the
// wrapper checks). Launches on `stream`; returns the first CUDA error.
int ff_mips_topk(const void* q, const void* qscale, const void* codes,
                 const void* scales, void* out_s, void* out_i,
                 void* scratch_s, void* scratch_i, int B, long long R, int d,
                 int K, long long base, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  long long nch = cdiv(R, kChunk);
  // ping-pong halves of the scratch: the first pass's partials, then the
  // second's; the pass that leaves one chunk writes the outputs
  const long long n0 = (long long)B * nch * K;
  float* cur_s = nch == 1 ? (float*)out_s : (float*)scratch_s;
  long long* cur_i = nch == 1 ? (long long*)out_i : (long long*)scratch_i;
  float* nxt_s = (float*)scratch_s + n0;
  long long* nxt_i = (long long*)scratch_i + n0;
  score_chunks<<<dim3((unsigned)nch, B), kThreads, (size_t)(d / 4) * 4,
                 st>>>((const int8_t*)q, (const float*)qscale,
                       (const int8_t*)codes, (const float*)scales, cur_s,
                       cur_i, R, d, K, base);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  while (nch > 1) {
    const long long n = nch * K;
    nch = cdiv(n, kChunk);
    if (nch == 1) {
      nxt_s = (float*)out_s;
      nxt_i = (long long*)out_i;
    }
    merge_chunks<<<dim3((unsigned)nch, B), kThreads, 0, st>>>(
        cur_s, cur_i, nxt_s, nxt_i, n, K);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    float* ts = cur_s;
    cur_s = nxt_s;
    nxt_s = ts;
    long long* ti = cur_i;
    cur_i = nxt_i;
    nxt_i = ti;
  }
  return 0;
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
