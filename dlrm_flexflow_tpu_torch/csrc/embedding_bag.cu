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
// rows per warp). A call that reads 2 MB of rows or more reads them with
// non-allocating loads (ld.global.nc.L1::no_allocate: each is used
// once), a smaller one through L1 (__ldg), which measured faster at the
// "cat" step's n = 2,048 and slower at a full bucket's 16,384. The grid
// is at most the blocks the card holds at once (8 of 256 threads an SM),
// so up to 2^18 chunks (n = 16,896 at d = 64) every thread takes one
// chunk and all of the call's row loads are in flight together; a larger
// call loops. The TPU kernel's deep DMA pipeline has no counterpart:
// many warps in flight on each SM hide the latency of the random row
// reads.
// Measured on an H100 at the paths' shapes (n = 64 at d = 8, n = 2,048
// and 16,384 at d = 64), handing ids out by warp shuffles, 2 to 8 chunks
// a thread in flight and streaming stores (st.global.cs) were each
// slower.
// Unlike the TPU kernel, which needs d % 128 == 0, any d that is a
// multiple of 4 works.
// A negative id reads nothing and adds a zero row (its residual row is
// zero): the lookups outside a rank's row block of a table split in
// blocks over ranks, whose partial bags the ranks then sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // resident blocks an SM: the grid's cap
// rows read by a call from which they are read without allocating in L1
constexpr long long kStreamBytes = 2 << 20;

// Column chunk c of row r, as load_row4 (quant_rows.cuh) computes it;
// with kStream read without allocating in L1.
template <int kMode, bool kStream>
__device__ __forceinline__ float4 stream_row4(const void* __restrict__ table,
                                              const float* __restrict__ scales,
                                              int64_t r, int vec, int c) {
  if constexpr (!kStream) {
    return load_row4<kMode>(table, scales, r, vec, c);
  } else if constexpr (kMode == kF32) {
    const float4* p = static_cast<const float4*>(table) + r * vec + c;
    float4 v;
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p));
    return v;
  } else {
    const unsigned* p = static_cast<const unsigned*>(table) + r * vec + c;
    unsigned u;
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(u) : "l"(p));
    const float s = __ldg(scales + r);
    return make_float4(__fmul_rn(code_to_float<kMode>(u & 0xff), s),
                       __fmul_rn(code_to_float<kMode>((u >> 8) & 0xff), s),
                       __fmul_rn(code_to_float<kMode>((u >> 16) & 0xff), s),
                       __fmul_rn(code_to_float<kMode>(u >> 24), s));
  }
}

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
template <int kMode, bool kStream>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const void* __restrict__ table,
           const float* __restrict__ scales,
           const int64_t* __restrict__ ids,
           float4* __restrict__ out,
           float4* __restrict__ rows_out,
           int64_t n_out, int bag, int vec, int mean) {
  const int64_t total = n_out * vec;
  for (int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x; g < total;
       g += (int64_t)gridDim.x * kThreads) {
    const int64_t row = g / vec;
    const int c = (int)(g - row * vec);
    const int64_t* rid = ids + row * bag;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < bag; ++j) {
      const int64_t id = rid[j];
      const float4 v =
          id < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                 : stream_row4<kMode, kStream>(table, scales, id, vec, c);
      if constexpr (kMode == kF32) {
        if (rows_out) rows_out[(row * bag + j) * vec + c] = v;
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
}

template <int kMode>
int launch(const void* table, const void* scales, const void* ids, void* out,
           void* rows_out, long long n_out, int bag, int dim, int mean,
           void* stream) {
  if (n_out <= 0) return 0;
  static int sms = 0;  // the card's SM count, read once
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = dim / 4;
  long long blocks = (n_out * vec + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSm)
    blocks = (long long)sms * kBlocksPerSm;
  const long long row_bytes = (long long)n_out * bag * dim *
                              (kMode == kF32 ? (int)sizeof(float) : 1);
  auto kernel = row_bytes >= kStreamBytes ? bag_kernel<kMode, true>
                                          : bag_kernel<kMode, false>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      table, (const float*)scales, (const int64_t*)ids, (float4*)out,
      (float4*)rows_out, n_out, bag, vec, mean);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: (rows, dim) fp32; ids: (n_out, bag) int64 in [0, rows), or < 0
// for a lookup that adds nothing;
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
