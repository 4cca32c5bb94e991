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
//            feat[b] = [bottom[b], Z's lower entries]  (K = d + P values)
// with act relu or none. ids are rows of the flat (T*N, d) table,
// already offset by t*N. Neither X, Z nor the (B, F, F) tensor ever
// reaches device memory.
//
// Bound: operations. B * (2*P*d + 2*K*H) fp32 FLOPs against the bytes
// of the gather (B*T*bag*d*4), the bottom rows, W, bias and the output
// (B*H*4). At the DLRM serving shape (B=2048, T=8, d=64, H=1024) that is
// about 0.43 GFLOP, 6.4 us at the H100's 67 TFLOP/s fp32 rate outside the
// tensor cores, against about 4 us for the bytes; at the batches the
// paths launch (B <= 256) the bound is under 1 us and the time is
// latency: a chain of dependent loads, barriers and the launch.
//
// Design. The grid is sample tiles of sb samples (x) by column tiles of
// hc output columns (y); the wrapper chooses sb, hc and the samples a
// thread keeps (ss) from B and H (ops/kernels/interaction.py
// interaction_tiles), so that B >= 64 puts about two blocks on each SM.
// The cl blocks of one sample tile's column tiles form a thread-block
// cluster (cl <= 8), which does the gather and the dots once:
//   0. every block starts copying its W column tile (K x hc, fp32) into
//      shared memory: one TMA copy of a 2-D box (a tensor map of W made
//      on the host), which lands while 1-3 run;
//   1. block r of the cluster gathers and bag-sums X for the samples
//      r, r + cl, r + 2cl, ... of the tile, every thread keeping up to 8
//      independent row loads in flight;
//   2. each thread forms whole dots of those samples' lower triangle
//      from float4 reads of X, whose rows are padded to an odd number of
//      float4s so that the rows a quarter-warp reads fall in different
//      banks, and writes them into the feat rows of every block of the
//      cluster (distributed shared memory);
//   3. one cluster barrier, after which each block holds the tile's
//      feat rows in its own shared memory;
//   4. each thread computes ss samples x 4 columns of the layer from
//      float4 reads of the staged W tile and of feat (a warp's lanes
//      share their samples, so the feat read is a broadcast): 16*ss FMAs
//      for every 4 + ss shared-memory loads, in k order, then adds the
//      bias and applies relu.
// The TPU kernel scatters the tril half of W into a zero-padded
// (F_pad^2, H) matrix so the MXU can take vec(Z) whole; here the rows of
// W are indexed directly; K is padded only to a multiple of 4, with
// zeros in feat and in the staged W.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_rows.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kGatherLoads = 8;  // X chunks a thread loads before storing
// the card's 227 KB a block less room for the static mbarrier (the
// dynamic part starts 128-byte aligned after it)
constexpr int kMaxSmem = 232448 - 128;

// n rounded up to a multiple of 4 whose quarter is odd: a row stride, in
// floats, at which 8 rows read at one column fall in 8 different bank
// groups
__host__ __device__ inline int odd_quads(int n) {
  const int q = (n + 3) / 4;
  return 4 * (q + 1 - (q & 1));
}

// The block's shared memory: the W tile, feat, then X of its own samples
__host__ __device__ inline long long smem_floats(int T, int d, int sb,
                                                 int hc, int cl) {
  const int F = T + 1;
  const int K = d + F * (F - 1) / 2;
  return 4LL * ((K + 3) / 4) * hc + (long long)sb * odd_quads(K) +
         (long long)((sb + cl - 1) / cl) * F * odd_quads(d);
}

// One-shot mbarrier (phase 0) that counts the bytes of TMA copies.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar) {
  unsigned done = 0;
  // a copy that never lands (a bad tensor map) ends the kernel with an
  // error after some seconds instead of hanging the card
  for (long long tries = 0; !done; ++tries) {
    if (tries == (1LL << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// One TMA copy of the box at (column c0, row r0) of the tensor map's 2-D
// tensor into this block's shared memory at dst (128-byte aligned),
// completing on bar; the box's part past the tensor's edge reads as 0.
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int c0, int r0, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}

// A cluster barrier in two halves: arrive, work, wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The gather of X for a block's own samples r, r + cl, ...: chunk e is
// (own sample o, row f, float4 column c); a thread takes the chunks e0,
// e0 + nthreads, ... (kGatherLoads of them), loads them all, then stores
// them into xs.
struct Gather {
  const void* table;
  const float* scales;
  const int64_t* ids;
  const float* bottom;
  float* xs;
  int items, nthreads, vec, F, T, bag, d, DS, s0, rank, cl, B;

  __device__ __forceinline__ void at(int e, int& o, int& f, int& c,
                                     int64_t& gs) const {
    c = e % vec;
    const int of = e / vec;
    f = of % F;
    o = of / F;
    gs = (int64_t)s0 + rank + o * cl;
  }

  template <int kMode>
  __device__ __forceinline__ void load(int e0, float4 (&v)[kGatherLoads])
      const {
    int64_t row[kGatherLoads];
#pragma unroll
    for (int u = 0; u < kGatherLoads; ++u) {  // the ids first (bag 1)
      int o, f, c;
      int64_t gs;
      at(e0 + u * nthreads, o, f, c, gs);
      row[u] = (bag == 1 && e0 + u * nthreads < items && gs < B && f > 0)
                   ? __ldg(ids + gs * T + (f - 1))
                   : -1;
    }
#pragma unroll
    for (int u = 0; u < kGatherLoads; ++u) {
      int o, f, c;
      int64_t gs;
      at(e0 + u * nthreads, o, f, c, gs);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e0 + u * nthreads < items && gs < B) {
        if (f == 0) {
          acc = __ldg(reinterpret_cast<const float4*>(bottom + gs * d) + c);
        } else if (bag == 1) {
          add4(acc, load_row4<kMode>(table, scales, row[u], vec, c));
        } else {
          const int64_t* rid = ids + (gs * T + (f - 1)) * bag;
          for (int j = 0; j < bag; ++j)
            add4(acc, load_row4<kMode>(table, scales, rid[j], vec, c));
        }
      }
      v[u] = acc;
    }
  }

  __device__ __forceinline__ void store(int e0,
                                        const float4 (&v)[kGatherLoads])
      const {
#pragma unroll
    for (int u = 0; u < kGatherLoads; ++u) {
      if (e0 + u * nthreads < items) {
        int o, f, c;
        int64_t gs;
        at(e0 + u * nthreads, o, f, c, gs);
        reinterpret_cast<float4*>(xs + (o * F + f) * DS)[c] = v[u];
      }
    }
  }
};

// kMode is the table's storage (quant_rows.cuh): kF32 for this kernel,
// kInt8 or kFp8 for its quantized twin, replacing _interaction_kernel_quant
// (dlrm_flexflow_tpu/ops/pallas/interaction_kernel.py:324). The twin
// dequantizes X's rows as it gathers them: each bag row adds code * scale,
// each step rounded, from 0 in bag order. From X on the math is the fp32
// kernel's. kSS is the samples a thread keeps in the layer.
template <int kMode, int kSS>
__global__ void __launch_bounds__(512)
interaction_kernel(const void* __restrict__ table_v,
                   const float* __restrict__ scales,
                   const int64_t* __restrict__ ids,
                   const float* __restrict__ bottom,
                   const float* __restrict__ w,
                   const float* __restrict__ bias,
                   float* __restrict__ out, int B, int T, int bag, int d,
                   int H, int relu, int sb, int hc, int cl,
                   const __grid_constant__ CUtensorMap w_map, int tma) {
  extern __shared__ __align__(128) float4 smem4[];
  const int F = T + 1;
  const int P = F * (F - 1) / 2;
  const int K = d + P;
  const int K4 = (K + 3) / 4;
  const int KS = odd_quads(K);   // feat row stride
  const int DS = odd_quads(d);   // X row stride
  const int vec = d / 4;
  const int hc4 = hc / 4;
  float* ws = reinterpret_cast<float*>(smem4);  // [4*K4][hc]
  float* feat = ws + 4 * K4 * hc;               // [sb][KS]
  float* xs = feat + sb * KS;                   // [own][F][DS]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int s0 = blockIdx.x * sb;
  const int col0 = blockIdx.y * hc;
  const bool has_cols = col0 < H;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  __shared__ alignas(8) uint64_t w_bar_storage;  // W tile's arrival
  const unsigned w_bar = (unsigned)__cvta_generic_to_shared(&w_bar_storage);
  if (tid == 0) mbar_init(w_bar);
  __syncthreads();
  // a block may write into another's shared memory only once that block
  // runs: arrive now, wait before the first such write (step 2)
  cluster_arrive_relaxed();

  // 1. X rows of the own samples: row 0 the bottom-MLP output, rows
  //    1..T the bag sums; a pad sample's rows are 0. The first round's
  //    row loads are issued before the W tile's copies, so that they
  //    do not queue behind them
  const int n_own = rank < sb ? (sb - rank + cl - 1) / cl : 0;
  const int items = n_own * F * vec;
  const Gather g{table_v, scales, ids, bottom, xs, items, nthreads, vec,
                 F, T, bag, d, DS, s0, rank, cl, B};
  float4 v[kGatherLoads];
  g.load<kMode>(tid, v);

  // 0. stage W[:, col0:col0+hc]: one TMA copy of the (4*K4) x hc box of
  //    the tensor map (tma), whose rows past K and columns past H read as
  //    0, counted on an mbarrier; or, where the host made no map (W not
  //    16-byte aligned, H % 4 != 0, K > 256), element by element. The
  //    copy lands while 1-3 run
  const bool tma_w = has_cols && tma;
  if (tma_w) {
    if (tid == 0) {
      mbar_expect_tx(w_bar, (unsigned)(4 * K4 * hc * 4));
      tma_box(ws, &w_map, col0, 0, w_bar);
    }
  } else if (has_cols) {
    for (int e = tid; e < 4 * K4 * hc4; e += nthreads) {
      const int k = e / hc4;
      const int col = col0 + (e - k * hc4) * 4;
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      for (int q = 0; q < 4; ++q)
        if (k < K && col + q < H) u[q] = __ldg(w + (int64_t)k * H + col + q);
      reinterpret_cast<float4*>(ws + k * hc)[e - k * hc4] =
          make_float4(u[0], u[1], u[2], u[3]);
    }
  }

  g.store(tid, v);
  for (int e0 = tid + kGatherLoads * nthreads; e0 < items;
       e0 += kGatherLoads * nthreads) {
    g.load<kMode>(e0, v);
    g.store(e0, v);
  }
  __syncthreads();

  // 2. the own samples' feat rows, [bottom, lower dots of X X^T, 0 pad],
  //    written into every block of the cluster (distributed shared
  //    memory), so that no block reads another's after the barrier
  cluster_wait();
  for (int q = tid; q < n_own * P; q += nthreads) {
    const int o = q / P;
    const int p = q - o * P;
    int i = 1;
    int j = p;
    while (j >= i) {  // pair p -> (i, j), i > j, in row-major tril order
      j -= i;
      ++i;
    }
    const float4* xi = reinterpret_cast<const float4*>(xs + (o * F + i) * DS);
    const float4* xj = reinterpret_cast<const float4*>(xs + (o * F + j) * DS);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < vec; ++c) {
      const float4 x = xi[c];
      const float4 y = xj[c];
      a.x = fmaf(x.x, y.x, a.x);
      a.y = fmaf(x.y, y.y, a.y);
      a.z = fmaf(x.z, y.z, a.z);
      a.w = fmaf(x.w, y.w, a.w);
    }
    const float dot = (a.x + a.y) + (a.z + a.w);
    const int at = (rank + o * cl) * KS + d + p;
    for (int r = 0; r < cl; ++r) cluster.map_shared_rank(feat, r)[at] = dot;
  }
  const int tail = 4 * K4 - P;  // bottom, then the pad past K
  for (int e = tid; e < n_own * tail; e += nthreads) {
    const int o = e / tail;
    const int k = e - o * tail;
    const int at = (rank + o * cl) * KS + (k < d ? k : K + (k - d));
    const float v = k < d ? xs[o * F * DS + k] : 0.f;
    for (int r = 0; r < cl; ++r) cluster.map_shared_rank(feat, r)[at] = v;
  }

  // 3. every block's feat rows are in every block
  cluster.sync();
  if (tma_w) mbar_wait(w_bar);
  __syncthreads();

  // 4. y = act(feat . W[:, h] + bias[h]): ss samples x 4 columns a thread
  const int groups = sb / kSS;
  if (has_cols && tid < hc4 * groups) {
    const int ct = tid % hc4;
    const int sl = (tid / hc4) * kSS;
    const float4* w4 = reinterpret_cast<const float4*>(ws) + ct;
    const float4* f4 = reinterpret_cast<const float4*>(feat + sl * KS);
    const int ksq = KS / 4;
    float acc[kSS][4];
#pragma unroll
    for (int s = 0; s < kSS; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[s][q] = 0.f;
#pragma unroll 2
    for (int k4 = 0; k4 < K4; ++k4) {
      const float4 w0 = w4[(4 * k4 + 0) * hc4];
      const float4 w1 = w4[(4 * k4 + 1) * hc4];
      const float4 w2 = w4[(4 * k4 + 2) * hc4];
      const float4 w3 = w4[(4 * k4 + 3) * hc4];
#pragma unroll
      for (int s = 0; s < kSS; ++s) {
        const float4 f = f4[s * ksq + k4];
        const float wq[4][4] = {{w0.x, w1.x, w2.x, w3.x},
                                {w0.y, w1.y, w2.y, w3.y},
                                {w0.z, w1.z, w2.z, w3.z},
                                {w0.w, w1.w, w2.w, w3.w}};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float a = acc[s][q];
          a = fmaf(f.x, wq[q][0], a);
          a = fmaf(f.y, wq[q][1], a);
          a = fmaf(f.z, wq[q][2], a);
          a = fmaf(f.w, wq[q][3], a);
          acc[s][q] = a;
        }
      }
    }
    const int col = col0 + ct * 4;
    float bq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bq[q] = col + q < H ? __ldg(bias + col + q) : 0.f;
    const bool vec_out = (H & 3) == 0 && col + 3 < H;
#pragma unroll
    for (int s = 0; s < kSS; ++s) {
      const int64_t gs = (int64_t)s0 + sl + s;
      if (gs >= B) continue;
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        y[q] = acc[s][q] + bq[q];
        if (relu) y[q] = fmaxf(y[q], 0.f);
      }
      float* o = out + gs * H + col;
      if (vec_out) {
        *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
        for (int q = 0; q < 4; ++q)
          if (col + q < H) o[q] = y[q];
      }
    }
  }
}

// The launch of one tile choice: grid, block, shared memory, cluster.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[1];
};

template <int kSS>
void configure(Launch& l, int B, int T, int dim, int H, int sb, int hc,
               int cl, void* stream) {
  const int ny = (H + hc - 1) / hc;
  const int layer = (hc / 4) * (sb / kSS);
  l.cfg = cudaLaunchConfig_t{};
  l.cfg.gridDim = dim3((B + sb - 1) / sb, (ny + cl - 1) / cl * cl, 1);
  l.cfg.blockDim = dim3(layer > 128 ? (layer + 31) / 32 * 32 : 128, 1, 1);
  l.cfg.dynamicSmemBytes =
      (size_t)(sizeof(float) * smem_floats(T, dim, sb, hc, cl));
  l.cfg.stream = (cudaStream_t)stream;
  l.attrs[0].id = cudaLaunchAttributeClusterDimension;
  l.attrs[0].val.clusterDim.x = 1;
  l.attrs[0].val.clusterDim.y = cl;
  l.attrs[0].val.clusterDim.z = 1;
  l.cfg.attrs = l.attrs;
  l.cfg.numAttrs = 1;
}

template <int kMode, int kSS>
cudaError_t allow_smem() {
  // once per instantiation: allow the largest dynamic shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      interaction_kernel<kMode, kSS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return attr;
}

template <int kMode, int kSS>
int launch_ss(const void* table, const void* scales, const void* ids,
              const void* bottom, const void* w, const void* bias, void* out,
              int B, int T, int bag, int dim, int H, int relu, int sb,
              int hc, int cl, const CUtensorMap& w_map, int tma,
              void* stream) {
  const cudaError_t attr = allow_smem<kMode, kSS>();
  if (attr != cudaSuccess) return (int)attr;
  Launch l;
  configure<kSS>(l, B, T, dim, H, sb, hc, cl, stream);
  const cudaLaunchConfig_t& cfg = l.cfg;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, interaction_kernel<kMode, kSS>, table, (const float*)scales,
      (const int64_t*)ids, (const float*)bottom, (const float*)w,
      (const float*)bias, (float*)out, B, T, bag, dim, H, relu, sb, hc, cl,
      w_map, tma);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();  // clear the launch error
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// A tensor map of W (K rows of H fp32) whose box is one block's W tile,
// 4*ceil(K/4) rows by hc columns; 1 if made, 0 where TMA cannot take W
// (then the kernel stages it element by element).
int w_tensor_map(CUtensorMap& map, const void* w, int K, int H, int hc) {
  const int rows = 4 * ((K + 3) / 4);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || (H & 3) || rows > 256 || hc > 256 ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return 0;
  const cuuint64_t dims[2] = {(cuuint64_t)H, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)H * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)hc, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(w), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// sb, hc, ss, cl as interaction_tiles chooses them: ss in {1, 2, 4, 8}
// dividing sb, hc a multiple of 4, cl <= 8
template <int kMode>
int launch(const void* table, const void* scales, const void* ids,
           const void* bottom, const void* w, const void* bias, void* out,
           int B, int T, int bag, int dim, int H, int relu, int sb, int hc,
           int ss, int cl, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (sb < 1 || sb % ss || hc < 4 || hc % 4 || cl < 1 || cl > kMaxCluster ||
      (hc / 4) * (sb / ss) > 512 ||
      sizeof(float) * smem_floats(T, dim, sb, hc, cl) >
          (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  CUtensorMap w_map;
  const int tma = w_tensor_map(w_map, w, dim + (T + 1) * T / 2, H, hc);
  switch (ss) {
    case 1:
      return launch_ss<kMode, 1>(table, scales, ids, bottom, w, bias, out, B,
                                 T, bag, dim, H, relu, sb, hc, cl, w_map,
                                 tma, stream);
    case 2:
      return launch_ss<kMode, 2>(table, scales, ids, bottom, w, bias, out, B,
                                 T, bag, dim, H, relu, sb, hc, cl, w_map,
                                 tma, stream);
    case 4:
      return launch_ss<kMode, 4>(table, scales, ids, bottom, w, bias, out, B,
                                 T, bag, dim, H, relu, sb, hc, cl, w_map,
                                 tma, stream);
    case 8:
      return launch_ss<kMode, 8>(table, scales, ids, bottom, w, bias, out, B,
                                 T, bag, dim, H, relu, sb, hc, cl, w_map,
                                 tma, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int kSS>
int max_clusters_ss(int B, int T, int dim, int H, int sb, int hc, int cl) {
  const cudaError_t attr = allow_smem<kF32, kSS>();
  if (attr != cudaSuccess) return -(int)attr;
  Launch l;
  configure<kSS>(l, B, T, dim, H, sb, hc, cl, nullptr);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, (void*)interaction_kernel<kF32, kSS>, &l.cfg);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return -(int)e;
  }
  return n;
}

}  // namespace

extern "C" {

// How many clusters of the fp32 kernel fit on the card at once at the
// given tiles (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
int ff_fused_interaction_max_clusters(int B, int T, int dim, int H, int sb,
                                      int hc, int ss, int cl) {
  switch (ss) {
    case 1: return max_clusters_ss<1>(B, T, dim, H, sb, hc, cl);
    case 2: return max_clusters_ss<2>(B, T, dim, H, sb, hc, cl);
    case 4: return max_clusters_ss<4>(B, T, dim, H, sb, hc, cl);
    case 8: return max_clusters_ss<8>(B, T, dim, H, sb, hc, cl);
  }
  return -(int)cudaErrorInvalidValue;
}

// Shared memory one block needs, in bytes, at the given tiles (the
// wrapper's interaction_smem_bytes mirrors it).
long long ff_fused_interaction_smem_bytes(int T, int dim, int sb, int hc,
                                          int cl) {
  return (long long)sizeof(float) * smem_floats(T, dim, sb, hc, cl);
}

// table: (rows, dim) fp32; ids: (B, T, bag) int64 in [0, rows);
// bottom: (B, dim) fp32; w: (dim + P, H) fp32; bias: (H,) fp32;
// out: (B, H) fp32. dim % 4 == 0, 16-byte aligned table and bottom (the
// wrapper checks). sb, hc, ss, cl: the tiles (interaction_tiles).
// Launches on `stream`; returns the launch's CUDA error, else
// cudaGetLastError().
int ff_fused_interaction_forward(const void* table, const void* ids,
                                 const void* bottom, const void* w,
                                 const void* bias, void* out, int B, int T,
                                 int bag, int dim, int H, int relu, int sb,
                                 int hc, int ss, int cl, void* stream) {
  return launch<kF32>(table, nullptr, ids, bottom, w, bias, out, B, T, bag,
                      dim, H, relu, sb, hc, ss, cl, stream);
}

// The quantized twin: codes (rows, dim) int8 or e4m3 bytes (fp8 != 0),
// scales (rows,) fp32, codes 4-byte aligned; the rest as above.
int ff_fused_interaction_quant_forward(const void* codes, const void* scales,
                                       const void* ids, const void* bottom,
                                       const void* w, const void* bias,
                                       void* out, int B, int T, int bag,
                                       int dim, int H, int relu, int fp8,
                                       int sb, int hc, int ss, int cl,
                                       void* stream) {
  if (fp8)
    return launch<kFp8>(codes, scales, ids, bottom, w, bias, out, B, T, bag,
                        dim, H, relu, sb, hc, ss, cl, stream);
  return launch<kInt8>(codes, scales, ids, bottom, w, bias, out, B, T, bag,
                       dim, H, relu, sb, hc, ss, cl, stream);
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
