// Row loads shared by the gather kernels (embedding_bag.cu,
// interaction.cu): one 16-byte column chunk of a table row as fp32,
// from fp32 storage or from 1-byte codes with one fp32 scale per row.
//
// A quantized chunk is its 4 codes times the row's scale, each product
// rounded on its own (__fmul_rn: never contracted into an FMA with the
// caller's add), which is the plain versions' arithmetic.

#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Table storage: fp32 rows, or int8 / fp8 e4m3 codes with row scales.
enum Storage { kF32 = 0, kInt8 = 1, kFp8 = 2 };

template <int kMode>
__device__ __forceinline__ float code_to_float(uint8_t c) {
  if constexpr (kMode == kFp8) {
    __nv_fp8_e4m3 v;
    v.__x = c;
    return float(v);
  }
  return (float)(int8_t)c;
}

// Column chunk c (4 values) of row r of a table with vec chunks a row.
// scales is ignored for kF32.
template <int kMode>
__device__ __forceinline__ float4 load_row4(const void* __restrict__ table,
                                            const float* __restrict__ scales,
                                            int64_t r, int vec, int c) {
  if constexpr (kMode == kF32) {
    return __ldg(static_cast<const float4*>(table) + r * vec + c);
  } else {
    const uchar4 q = static_cast<const uchar4*>(table)[r * vec + c];
    const float s = __ldg(scales + r);
    return make_float4(__fmul_rn(code_to_float<kMode>(q.x), s),
                       __fmul_rn(code_to_float<kMode>(q.y), s),
                       __fmul_rn(code_to_float<kMode>(q.z), s),
                       __fmul_rn(code_to_float<kMode>(q.w), s));
  }
}

// acc += v, each lane rounded on its own
__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}
