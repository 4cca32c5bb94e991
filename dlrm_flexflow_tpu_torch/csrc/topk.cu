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
// Design (a first version, two passes):
//   1. score_chunks: one block per (chunk of kChunk rows, query). Its
//      threads score the chunk's rows with __dp4a over d/4 words of
//      codes against the query held in shared memory, bitonic-sort the
//      chunk's (score, id) pairs in shared memory and write the first
//      K: the chunk's top-K, in order. Rows past R are (-inf, INT64_MAX)
//      sentinels, which sort last.
//   2. merge_chunks: the same sort over kChunk candidates at a time,
//      repeated until one chunk remains (each pass divides the count by
//      kChunk / K). The passes ping-pong between two halves of one
//      scratch buffer, and the pass that leaves one chunk (the first,
//      when R <= kChunk) writes the outputs.
// The TPU kernel carries a running top-K across the sequential grid
// steps; on the card the chunks run in parallel, so their partial top-Ks
// meet in the second pass instead. The queries of one chunk do not share
// the code loads yet (the index, 36 MB, stays in the 50 MB L2 between
// them); int8 tensor cores are work for a later PR.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 2048;    // candidates one block sorts
constexpr int kThreads = 512;
constexpr int kMaxK = 1024;     // K < kChunk keeps each pass shrinking
constexpr long long kPadId = 0x7fffffffffffffffLL;

// (score desc, id asc): true when a goes before b
__device__ __forceinline__ bool before(float sa, long long ia, float sb,
                                       long long ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Bitonic sort of kChunk (score, id) pairs into (score desc, id asc).
__device__ void bitonic_sort(float* s, long long* id) {
  for (int k = 2; k <= kChunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kChunk; i += kThreads) {
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
            const long long ti = id[i];
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
  bitonic_sort(s, id);
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
  bitonic_sort(s, id);
  const long long o = ((long long)b * gridDim.x + chunk) * K;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    out_s[o + i] = s[i];
    out_i[o + i] = id[i];
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

}  // namespace

extern "C" {

int ff_topk_max_k() { return kMaxK; }
long long ff_topk_scratch_entries(int B, long long R, int K) {
  return scratch_entries(B, R, K);
}

// q: (B, d) int8; qscale: (B,) fp32; codes: (R, d) int8; scales: (R,)
// fp32; out_s (B, K) fp32, out_i (B, K) int64; scratch_s (fp32) and
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
