// Fused gather -> dot interaction -> first top-MLP layer for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _interaction_kernel
// (dlrm_flexflow_tpu/ops/pallas/interaction_kernel.py:92), entered there
// through fused_interaction.
//
// Computes, for every sample b of B, with F = T + 1 and P = F(F-1)/2:
//   X[b]   = [bottom[b]; sum_j table[ids[b,0,j]]; ...; sum_j table[ids[b,T-1,j]]]  (F x d)
//   Z[b]   = X[b] X[b]^T, of which only the P strictly-lower entries
//            Z[i][j], i > j, are formed, in the order
//            for i in range(F) for j in range(i)
//   y[b,h] = act(sum_k feat[b][k] * W[k][h] + bias[h]),
//            feat[b] = [bottom[b], Z's lower entries]  (d + P values)
// with act relu or none. ids are rows of the flat (T*N, d) table,
// already offset by t*N. Neither X, Z nor the (B, F, F) tensor ever
// reaches device memory.
//
// Bound: operations. B * (2*P*d + 2*(d+P)*H) fp32 FLOPs against the
// bytes of the gather (B*T*bag*d*4), the bottom rows, W, bias and the
// output (B*H*4). At the DLRM serving shape (B=2048, T=8, d=64, H=1024)
// that is about 0.43 GFLOP, about 6.5 us at the H100's 67 TFLOP/s
// non-tensor fp32 rate, against about 4 us for the bytes.
//
// Design (a first version: fp32 FMAs, no tensor cores). A block takes a
// tile of kTileB samples and kThreads output columns:
//   1. its threads gather and bag-sum the tile's T rows per sample into
//      shared memory under the sample's bottom row, as float4 loads on
//      neighbouring addresses;
//   2. each warp forms whole dot products of the lower triangle, its
//      lanes splitting d and meeting in a shuffle reduction (no bank
//      conflicts: lanes read neighbouring words of one row);
//   3. each thread owns one output column h and keeps kTileB sums in
//      registers; every W[k][h] it loads serves kTileB FMAs, and the
//      feature values come from shared memory as broadcasts.
// The TPU kernel scatters the tril half of W into a zero-padded
// (F_pad^2, H) matrix so the MXU can take vec(Z) whole; here the rows of
// W are indexed directly and nothing is padded. Blocks of different
// column tiles of one sample tile each redo steps 1 and 2, which costs
// little beside step 3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_rows.cuh"

namespace {

constexpr int kTileB = 16;     // samples per block
constexpr int kThreads = 256;  // output columns per block
constexpr int kWarps = kThreads / 32;

// kMode is the table's storage (quant_rows.cuh): kF32 for this kernel,
// kInt8 or kFp8 for its quantized twin, replacing _interaction_kernel_quant
// (dlrm_flexflow_tpu/ops/pallas/interaction_kernel.py:324). The twin
// dequantizes X's rows as it gathers them: each bag row adds code * scale,
// each step rounded, from 0 in bag order. From X on the math is the fp32
// kernel's.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
interaction_kernel(const void* __restrict__ table_v,
                   const float* __restrict__ scales,
                   const int64_t* __restrict__ ids,
                   const float* __restrict__ bottom,
                   const float* __restrict__ w,
                   const float* __restrict__ bias,
                   float* __restrict__ out,
                   int B, int T, int bag, int d, int H, int relu) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int F = T + 1;
  const int P = F * (F - 1) / 2;
  const int K = d + P;
  const int vec = d / 4;
  float* xs = smem;                      // [kTileB][F][d]
  float* feat = smem + kTileB * F * d;   // [kTileB][K]
  const int s0 = blockIdx.x * kTileB;
  const int tid = threadIdx.x;

  // 1. X rows: row 0 the bottom-MLP output, rows 1..T the bag sums
  for (int e = tid; e < kTileB * F * vec; e += kThreads) {
    const int c = e % vec;
    const int sf = e / vec;
    const int f = sf % F;
    const int s = sf / F;
    const int gs = s0 + s;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gs < B) {
      if (f == 0) {
        acc = __ldg(reinterpret_cast<const float4*>(bottom + (int64_t)gs * d) + c);
      } else {
        const int64_t* rid = ids + ((int64_t)gs * T + (f - 1)) * bag;
        for (int j = 0; j < bag; ++j)
          add4(acc, load_row4<kMode>(table_v, scales, rid[j], vec, c));
      }
    }
    reinterpret_cast<float4*>(xs + (s * F + f) * d)[c] = acc;
  }
  __syncthreads();

  // 2. feat = [bottom, strictly-lower dots of X X^T]
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int q = warp; q < kTileB * P; q += kWarps) {
    const int s = q / P;
    const int p = q - s * P;
    int i = 1;
    int j = p;
    while (j >= i) {  // pair p -> (i, j), i > j, in row-major tril order
      j -= i;
      ++i;
    }
    const float* xi = xs + (s * F + i) * d;
    const float* xj = xs + (s * F + j) * d;
    float acc = 0.f;
    for (int k = lane; k < d; k += 32) acc = fmaf(xi[k], xj[k], acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) feat[s * K + d + p] = acc;
  }
  for (int e = tid; e < kTileB * d; e += kThreads) {
    const int s = e / d;
    const int k = e - s * d;
    feat[s * K + k] = xs[s * F * d + k];
  }
  __syncthreads();

  // 3. y = act(feat . W[:, h] + bias[h]) for this thread's column h
  const int h = blockIdx.y * kThreads + tid;
  if (h >= H) return;
  float acc[kTileB];
#pragma unroll
  for (int s = 0; s < kTileB; ++s) acc[s] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float wk = __ldg(w + (int64_t)k * H + h);
#pragma unroll
    for (int s = 0; s < kTileB; ++s) acc[s] = fmaf(feat[s * K + k], wk, acc[s]);
  }
  const float bh = __ldg(bias + h);
#pragma unroll
  for (int s = 0; s < kTileB; ++s) {
    if (s0 + s < B) {
      float y = acc[s] + bh;
      if (relu) y = fmaxf(y, 0.f);
      out[(int64_t)(s0 + s) * H + h] = y;
    }
  }
}

long long smem_bytes(int T, int dim) {
  const long long F = T + 1;
  const long long P = F * (F - 1) / 2;
  return (long long)sizeof(float) * kTileB * (F * dim + dim + P);
}

template <int kMode>
int launch(const void* table, const void* scales, const void* ids,
           const void* bottom, const void* w, const void* bias, void* out,
           int B, int T, int bag, int dim, int H, int relu, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const long long smem = smem_bytes(T, dim);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        interaction_kernel<kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kTileB - 1) / kTileB, (H + kThreads - 1) / kThreads);
  interaction_kernel<kMode>
      <<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
          table, (const float*)scales, (const int64_t*)ids,
          (const float*)bottom, (const float*)w, (const float*)bias,
          (float*)out, B, T, bag, dim, H, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the wrapper refuses shapes
// above the card's 227 KB per block).
long long ff_fused_interaction_smem_bytes(int T, int dim) {
  return smem_bytes(T, dim);
}

// table: (rows, dim) fp32; ids: (B, T, bag) int64 in [0, rows);
// bottom: (B, dim) fp32; w: (dim + P, H) fp32; bias: (H,) fp32;
// out: (B, H) fp32. dim % 4 == 0, 16-byte aligned pointers (the wrapper
// checks). Launches on `stream`; returns the first CUDA error, else
// cudaGetLastError().
int ff_fused_interaction_forward(const void* table, const void* ids,
                                 const void* bottom, const void* w,
                                 const void* bias, void* out, int B, int T,
                                 int bag, int dim, int H, int relu,
                                 void* stream) {
  return launch<kF32>(table, nullptr, ids, bottom, w, bias, out, B, T, bag,
                      dim, H, relu, stream);
}

// The quantized twin: codes (rows, dim) int8 or e4m3 bytes (fp8 != 0),
// scales (rows,) fp32, codes 4-byte aligned; the rest as above.
int ff_fused_interaction_quant_forward(const void* codes, const void* scales,
                                       const void* ids, const void* bottom,
                                       const void* w, const void* bias,
                                       void* out, int B, int T, int bag,
                                       int dim, int H, int relu, int fp8,
                                       void* stream) {
  if (fp8)
    return launch<kFp8>(codes, scales, ids, bottom, w, bias, out, B, T, bag,
                        dim, H, relu, stream);
  return launch<kInt8>(codes, scales, ids, bottom, w, bias, out, B, T, bag,
                       dim, H, relu, stream);
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
