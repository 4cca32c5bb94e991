// Row-wise fake quantization in place: each fp32 row of a (rows, d)
// table is quantized to int8 / fp8 e4m3 codes with one symmetric scale
// (or rounded to bf16) and written back as the codes' fp32 image.
//
// Replaces: no Pallas kernel. It is XLA's fusion of the JAX codec's
// fake_quant / fake_quant_stochastic (dlrm_flexflow_tpu/quant/codec.py:
// 154, :176), run by the stochastic-rounding rule on every updated table
// in the training step (dlrm_flexflow_tpu/core/model.py:1110,
// _requant_sr_params :1235) and once at init (nearest).
//
// Bound: memory. A row is read once and written once (8 bytes a value;
// the "noise" entry reads its u too, 12); the arithmetic is a division,
// a rounding and a product a value, plus for the Philox entry 10 rounds
// of two 32-bit multiplies per 4 values, far under the card's integer
// rate. At random_benchmark()'s stacked "cat" table (8 x 1M x 64 fp32 =
// 2.048 GB) the bound is 2 x 2.048 GB / 3.35 TB/s = 1.22 ms.
//
// Design: a group of L lanes takes a row (L the power of two >= d/4, at
// most 32), each lane C consecutive-in-stride 4-value chunks held in
// registers, so the row is loaded once; the row's |x| max is a shuffle
// reduction inside the group (NaN-propagating, as torch's amax), then
// every lane scales, rounds and stores its chunks. float4 loads and
// stores where d % 4 == 0 and the rows are 16-byte aligned, else scalar
// ones. The arithmetic is the plain version's, one IEEE rounding an
// operation (__fdiv_rn, __fadd_rn, __fmul_rn, rintf half to even,
// __nv_cvt_float_to_fp8 with saturation after the clip), so the card
// is bitwise the plain version. The stochastic u comes from the caller
// (the "noise" entry) or from Philox4x32-10 keyed by (seed lo, seed hi)
// at counter (row0 + row, column / 4, step, salt): output column % 4,
// its top 24 bits times 2^-24. The sentinel's flag `ok` (device int32,
// may be null) set to 0 makes the launch return before any store.
//
// A row split by width over ranks (an Embedding's columns, the JAX op's
// (1, dc) layout) is rounded in two passes, since its scale is the
// |x| max of the WHOLE row (codec.py:154, :176): ff_row_amax writes each
// piece row's |x| max (the same lane-group reduction, one fp32 a row;
// bound: the piece read once), the caller takes the max over the width
// group, and ff_fake_quant_rows_amax rounds the piece with the scale of
// that max, its Philox counters at column col0 + column, so its draws
// and its values are the whole row's at those columns, bitwise.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_rows.cuh"

namespace {

constexpr int kBf16 = 3;       // beside quant_rows.cuh's kInt8, kFp8
constexpr int kThreads = 256;
constexpr int kMaxChunks = 8;  // chunks a lane holds: d <= 32 * 8 * 4

struct Philox {
  unsigned long long seed;
  unsigned step, salt, row0;
  unsigned col4;            // the first column's 4-value chunk
};

__device__ __forceinline__ uint4 philox10(uint4 c, unsigned k0,
                                          unsigned k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float bits_to_unit(unsigned b) {
  return (float)(b >> 8) * 0x1p-24f;
}

// |a| into a NaN-propagating running max
__device__ __forceinline__ float amax_step(float m, float a) {
  a = fabsf(a);
  return (a > m || a != a) ? a : m;
}

// clip to [-q, q], keeping NaN (fminf/fmaxf would drop it)
__device__ __forceinline__ float clip(float v, float q) {
  return v < -q ? -q : (v > q ? q : v);
}

template <int kDtype, bool kStochastic>
__device__ __forceinline__ float fq_one(float x, float safe, float scale,
                                        float u) {
  if constexpr (kDtype == kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else if constexpr (kDtype == kInt8) {
    const float y = __fdiv_rn(x, safe);
    const float q = kStochastic ? floorf(__fadd_rn(y, u)) : rintf(y);
    return __fmul_rn(clip(q, 127.f), scale);
  } else {
    const float y = clip(__fdiv_rn(x, safe), 448.f);
    const __nv_fp8_storage_t c =
        __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
    return __fmul_rn(code_to_float<kFp8>((uint8_t)c), scale);
  }
}

// kSrc: 0 no draws, 1 Philox, 2 the caller's u. kAmax: 0 the row's own
// |x| max, 1 only write it to amax (x untouched), 2 the scale from
// amax[row] (the whole row's, of which x holds some columns)
template <int kDtype, int kSrc, int kC, bool kVec, int kAmax>
__global__ void __launch_bounds__(kThreads)
    fake_quant_rows_kernel(float* __restrict__ x,
                           const float* __restrict__ u, long long rows,
                           int d, int lanes_log2, Philox ph,
                           float* __restrict__ amax,
                           const int* __restrict__ ok) {
  if (kAmax != 1 && ok != nullptr && *ok == 0) return;
  const int L = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (L - 1);
  const long long row =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> lanes_log2;
  const bool live = row < rows;
  const int chunks = (d + 3) >> 2;
  float* xr = x + (live ? row : 0) * (long long)d;
  float v[kC][4];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = sub + i * L;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[i][e] = 0.f;
    if (!live || c >= chunks) continue;
    if constexpr (kVec) {
      const float4 t = reinterpret_cast<const float4*>(xr)[c];
      v[i][0] = t.x;
      v[i][1] = t.y;
      v[i][2] = t.z;
      v[i][3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * c + e < d) v[i][e] = xr[4 * c + e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) m = amax_step(m, v[i][e]);
  }
  float scale = 0.f, safe = 1.f;
  if constexpr (kDtype != kBf16) {
    if constexpr (kAmax == 2) {
      m = live ? __ldg(amax + row) : 0.f;
    } else {
      // the row's max over its L lanes (every lane of the warp shuffles)
      for (int off = L >> 1; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, m, off);
        m = (o > m || o != o) ? o : m;
      }
    }
    if constexpr (kAmax == 1) {
      if (live && sub == 0) amax[row] = m;
      return;
    }
    const float qmax = kDtype == kInt8 ? 127.f : 448.f;
    scale = m > 0.f ? __fdiv_rn(m, qmax) : 0.f;
    safe = scale > 0.f ? scale : 1.f;
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = sub + i * L;
    if (c >= chunks) continue;
    float w[4];
    if constexpr (kSrc == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = fq_one<kDtype, false>(v[i][e], safe, scale, 0.f);
    } else {
      float r[4];
      if constexpr (kSrc == 1) {
        const uint4 b = philox10(
            make_uint4((unsigned)(ph.row0 + row), ph.col4 + (unsigned)c,
                       ph.step, ph.salt),
            (unsigned)ph.seed, (unsigned)(ph.seed >> 32));
        r[0] = bits_to_unit(b.x);
        r[1] = bits_to_unit(b.y);
        r[2] = bits_to_unit(b.z);
        r[3] = bits_to_unit(b.w);
      } else {
        const float* ur = u + row * (long long)d;
        if constexpr (kVec) {
          const float4 t = reinterpret_cast<const float4*>(ur)[c];
          r[0] = t.x;
          r[1] = t.y;
          r[2] = t.z;
          r[3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) r[e] = 4 * c + e < d ? ur[4 * c + e] : 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = fq_one<kDtype, true>(v[i][e], safe, scale, r[e]);
    }
    if constexpr (kVec) {
      reinterpret_cast<float4*>(xr)[c] = make_float4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * c + e < d) xr[4 * c + e] = w[e];
    }
  }
}

template <int kDtype, int kSrc, int kC, int kAmax>
cudaError_t launch_c(float* x, const float* u, long long rows, int d,
                     int lanes_log2, bool vec, Philox ph, float* amax,
                     const int* ok, cudaStream_t s) {
  const long long threads = rows << lanes_log2;
  const long long grid = (threads + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vec)
    fake_quant_rows_kernel<kDtype, kSrc, kC, true, kAmax>
        <<<(unsigned)grid, kThreads, 0, s>>>(x, u, rows, d, lanes_log2, ph,
                                             amax, ok);
  else
    fake_quant_rows_kernel<kDtype, kSrc, kC, false, kAmax>
        <<<(unsigned)grid, kThreads, 0, s>>>(x, u, rows, d, lanes_log2, ph,
                                             amax, ok);
  return cudaGetLastError();
}

template <int kDtype, int kSrc, int kAmax = 0>
int launch(float* x, const float* u, long long rows, int d, Philox ph,
           const void* ok, void* stream, float* amax = nullptr) {
  if (rows <= 0 || d <= 0) return 0;
  const int chunks = (d + 3) / 4;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < chunks && lanes_log2 < 5) ++lanes_log2;
  const int per_lane = (chunks + (1 << lanes_log2) - 1) >> lanes_log2;
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (u == nullptr || (uintptr_t)u % 16 == 0);
  const int* flag = (const int*)ok;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (per_lane <= 1)
    e = launch_c<kDtype, kSrc, 1, kAmax>(x, u, rows, d, lanes_log2, vec, ph,
                                         amax, flag, s);
  else if (per_lane <= 2)
    e = launch_c<kDtype, kSrc, 2, kAmax>(x, u, rows, d, lanes_log2, vec, ph,
                                         amax, flag, s);
  else if (per_lane <= 4)
    e = launch_c<kDtype, kSrc, 4, kAmax>(x, u, rows, d, lanes_log2, vec, ph,
                                         amax, flag, s);
  else if (per_lane <= kMaxChunks)
    e = launch_c<kDtype, kSrc, kMaxChunks, kAmax>(x, u, rows, d, lanes_log2,
                                                  vec, ph, amax, flag, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace

extern "C" {

// x: device fp32 (rows, d), updated in place; dtype 1 int8, 2 fp8, 3
// bf16; stochastic 1 draws u from Philox (int8 only: the others round to
// nearest) keyed by seed at counters (row0 + row, column / 4, step,
// salt); ok: device int32 flag (0: change nothing) or null. One launch
// on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for d >
// 1024 or an unknown dtype).
int ff_fake_quant_rows(void* x, long long rows, int d, int dtype,
                       int stochastic, unsigned long long seed,
                       unsigned step, unsigned salt, unsigned row0,
                       const void* ok, void* stream) {
  const Philox ph{seed, step, salt, row0, 0};
  float* xp = (float*)x;
  if (dtype == kInt8)
    return stochastic ? launch<kInt8, 1>(xp, nullptr, rows, d, ph, ok, stream)
                      : launch<kInt8, 0>(xp, nullptr, rows, d, ph, ok, stream);
  if (dtype == kFp8)
    return launch<kFp8, 0>(xp, nullptr, rows, d, ph, ok, stream);
  if (dtype == kBf16)
    return launch<kBf16, 0>(xp, nullptr, rows, d, ph, ok, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 stochastic rounding with the caller's draws: u device fp32
// (rows, d), each in [0, 1). Otherwise as ff_fake_quant_rows.
int ff_fake_quant_rows_noise(void* x, const void* u, long long rows, int d,
                             const void* ok, void* stream) {
  return launch<kInt8, 2>((float*)x, (const float*)u, rows, d,
                          Philox{0, 0, 0, 0, 0}, ok, stream);
}

// Pass 1 of a width-split row: amax (rows,) device fp32 gets each row of
// x (rows, d), the piece, its |x| max (NaN-propagating); x is only read.
int ff_row_amax(const void* x, long long rows, int d, void* amax,
                void* stream) {
  return launch<kInt8, 0, 1>((float*)x, nullptr, rows, d,
                             Philox{0, 0, 0, 0, 0}, nullptr, stream,
                             (float*)amax);
}

// Pass 2: as ff_fake_quant_rows on the piece x (rows, d), in place, the
// scale of row r from amax[r] (the whole row's |x| max) and the Philox
// counter of column c (col0 + c) / 4, col0 % 4 == 0 (the piece's first
// column in the whole row). int8 and fp8 only: bf16 rounds each value
// alone, so a piece of it goes through ff_fake_quant_rows.
int ff_fake_quant_rows_amax(void* x, const void* amax, long long rows, int d,
                            int dtype, int stochastic,
                            unsigned long long seed, unsigned step,
                            unsigned salt, unsigned row0, unsigned col0,
                            const void* ok, void* stream) {
  if (col0 % 4) return (int)cudaErrorInvalidValue;
  const Philox ph{seed, step, salt, row0, col0 / 4};
  float* xp = (float*)x;
  float* a = (float*)amax;
  if (dtype == kInt8)
    return stochastic
               ? launch<kInt8, 1, 2>(xp, nullptr, rows, d, ph, ok, stream, a)
               : launch<kInt8, 0, 2>(xp, nullptr, rows, d, ph, ok, stream, a);
  if (dtype == kFp8)
    return launch<kFp8, 0, 2>(xp, nullptr, rows, d, ph, ok, stream, a);
  return (int)cudaErrorInvalidValue;
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
