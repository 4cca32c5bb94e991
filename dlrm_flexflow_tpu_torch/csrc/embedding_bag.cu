// Embedding-bag gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _bag_kernel
// (dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:55), entered there
// through embedding_bag and stacked_embedding_bag.
//
// Computes, for every output row r of n_out:
//   out[r] = sum over j < bag of table[ids[r, j]]   (mode sum)
//   out[r] = (that sum) / bag                       (mode mean)
// with the sum taken in fp32 in bag order. When rows_out is given, the
// kernel also writes every row it reads, rows_out[r * bag + j] =
// table[ids[r, j]]: the forward residual that lets the write-only
// sparse update (scatter_rows.cu) land new rows without reading the
// table again. The table is the T tables of
// a stacked op viewed as one (T*N, d) table; ids arrive already wrapped
// into [0, N) and offset by t*N (the wrapper does that), so every id is
// a row of the flat table.
//
// Bound: memory. Each output row reads bag random rows of d*4 bytes and
// writes d*4 bytes; there is one add per element read. On an H100 the
// least time is (n_out*bag*d*4 + n_out*d*4 + n_out*bag*8) / 3.35 TB/s,
// plus n_out*bag*d*4 written bytes when the residual is asked for.
//
// Design: one thread per 16-byte column chunk of an output row, so the
// d/4 neighbouring threads of a row load the row's d*4 bytes as float4s
// on neighbouring addresses (one 256-byte row at d=64 is 16 lanes, two
// rows per warp). The TPU kernel's deep DMA pipeline has no counterpart:
// many warps in flight on each SM hide the latency of the random row
// reads. Unlike the TPU kernel, which needs d % 128 == 0, any d that is
// a multiple of 4 works.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_rows.cuh"

namespace {

constexpr int kThreads = 256;

// bag_kernel<kF32> is the gather described above. Its quantized twin,
// bag_kernel<kInt8> or <kFp8>, replaces _bag_kernel_quant
// (dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:189, entered through
// embedding_bag_quant): the table holds 1-byte codes (int8, or fp8 e4m3)
// and one fp32 scale per row, and
//   out[r] = sum over j < bag of code(table[ids[r, j]]) * scale[ids[r, j]]
// accumulated from 0 in bag order as acc = acc + code * scale, each step
// rounded (no contraction into an FMA), then divided by bag for the
// mean: the plain version's arithmetic, so at bag 1 the two agree bit for
// bit. Its bound is a quarter of the fp32 gather's row bytes: each output
// row reads bag rows of d code bytes and bag 4-byte scales, and writes
// d*4 bytes; one thread takes 4 codes (a 4-byte load). The residual
// rows_out is fp32-only.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const void* __restrict__ table,
           const float* __restrict__ scales,
           const int64_t* __restrict__ ids,
           float4* __restrict__ out,
           float4* __restrict__ rows_out,
           int64_t n_out, int bag, int vec_per_row, int mean) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_out * vec_per_row) return;
  const int64_t row = g / vec_per_row;
  const int c = (int)(g - row * vec_per_row);
  const int64_t* rid = ids + row * bag;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < bag; ++j) {
    const float4 v = load_row4<kMode>(table, scales, rid[j], vec_per_row, c);
    if constexpr (kMode == kF32) {
      if (rows_out) rows_out[(row * bag + j) * vec_per_row + c] = v;
    }
    add4(acc, v);
  }
  if (mean) {
    const float n = (float)bag;
    acc.x /= n;
    acc.y /= n;
    acc.z /= n;
    acc.w /= n;
  }
  out[g] = acc;
}

template <int kMode>
int launch(const void* table, const void* scales, const void* ids, void* out,
           void* rows_out, long long n_out, int bag, int dim, int mean,
           void* stream) {
  if (n_out <= 0) return 0;
  const int vec = dim / 4;
  const long long blocks = (n_out * vec + kThreads - 1) / kThreads;
  bag_kernel<kMode><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, (const float*)scales, (const int64_t*)ids, (float4*)out,
      (float4*)rows_out, n_out, bag, vec, mean);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: (rows, dim) fp32; ids: (n_out, bag) int64 in [0, rows);
// out: (n_out, dim) fp32; rows_out: null, or (n_out * bag, dim) fp32 for
// the gathered rows. dim % 4 == 0 and 16-byte aligned pointers (the
// wrapper checks). Launches on `stream`; returns cudaGetLastError().
int ff_embedding_bag_forward(const void* table, const void* ids, void* out,
                             void* rows_out, long long n_out, int bag,
                             int dim, int mean, void* stream) {
  return launch<kF32>(table, nullptr, ids, out, rows_out, n_out, bag, dim,
                      mean, stream);
}

// codes: (rows, dim) int8 or e4m3 bytes (fp8 != 0); scales: (rows,)
// fp32; ids: (n_out, bag) int64 in [0, rows); out: (n_out, dim) fp32.
// dim % 4 == 0, 4-byte aligned codes and 16-byte aligned out (the
// wrapper checks). Launches on `stream`; returns cudaGetLastError().
int ff_embedding_bag_quant_forward(const void* codes, const void* scales,
                                   const void* ids, void* out,
                                   long long n_out, int bag, int dim,
                                   int mean, int fp8, void* stream) {
  if (fp8)
    return launch<kFp8>(codes, scales, ids, out, nullptr, n_out, bag, dim,
                        mean, stream);
  return launch<kInt8>(codes, scales, ids, out, nullptr, n_out, bag, dim,
                       mean, stream);
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
