// LSTM forward and backward scans for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of
// dlrm_flexflow_tpu/ops/pallas/lstm_kernel.py:
//   _fwd_kernel (:44, behind _run_fwd and lstm_scan): the recurrence over
//     time, gates = xproj[t] + h_{t-1} @ wh, i, f, g, o, c and h;
//   _bwd_kernel (:95, behind _run_bwd and the VJP of lstm_scan): the
//     reverse scan that recomputes the gates from the stored h and c and
//     writes the gate cotangents dz[t] = [di, df, dg, do].
//
// Shapes, time-major as in the JAX kernels: xproj (T, b, 4H) fp32, the
// input projection x @ wx + bias hoisted by the caller; wh (H, 4H) in
// the compute dtype (fp32 or bf16), gate columns i, f, g, o; ys, cs
// (T, b, H) fp32; dys (T, b, H) and dzs (T, b, 4H) fp32. The initial h
// and c are zero. As JAX's h.astype(wh.dtype) and dz.astype(wh.dtype),
// the carried operand of each recurrent product is rounded to wh's type
// and the product accumulates in fp32.
//
// Bound: operations. Per call at the main path's shape (T = 40, b = 64,
// H = 1,024, bf16 wh) the forward does 2·b·H·4H·(T-1) = 20.9 GFLOP of
// recurrent products (21 us on the bf16 tensor cores) and moves 71 MB
// (21 us at 3.35 TB/s); the backward does twice the products (the gate
// recompute and dz @ whᵀ, 42 us) over 124 MB. The serial dependence is
// the real limit: each step's product needs the whole previous h (or
// dz), so a step cannot start before every part of the last one is done.
//
// Forward, resident route (bf16 wh, b <= 128, one block per group of 8
// units co-resident, the slice within shared memory; the wrapper chooses
// the route by shape): lstm_fwd_resident_kernel, one cooperative launch.
// The block copies its 32 columns of wh (the 4 gates of its 8 units over
// all H rows: an N = 32, K = H bf16 B operand, 64 KB at H = 1,024,
// padded against bank conflicts) into dynamic shared memory once. A
// step's gates for the block are one M = b, N = 32, K = H product on
// mma.sync.m16n8k16 bf16 with fp32 accumulators, its A operand
// round_bf16(h_{t-1}) read from a two-slot bf16 ring in fragment order,
// written once by the thread that computes h (as JAX's
// hprev.astype(wh.dtype)) and read with __ldcg, 16 fragments in flight.
// c stays in a register; xproj[t+1] is loaded before the barrier. Per
// step a block reads the 128 KB ring slot from L2 (16 MB for 128 blocks)
// and waits at one grid.sync.
//
// Forward, streaming route (fp32 wh, or a shape the resident route does
// not take), and the backward's streaming route: ONE cooperative launch
// per call, the
// time loop inside the kernel and a grid-wide barrier (cooperative_groups
// grid.sync) between steps. A block owns groups of kUnits hidden units j
// and all four gate columns of each (j, H+j, 2H+j, 3H+j), so the cell
// update and the carries stay with the thread that computes them. After
// the barrier a block reads the whole h_{t-1} (ys[t-1]) or, backward,
// the whole dz[t+1] from L2 (__ldcg, so no stale L1 line is read),
// staged in kChunk-wide slices through shared memory, and wh from L2
// too. The products are scalar fp32 FMAs (2 rows × 4 gates a thread).
// The streaming backward recomputes the gates inside the serial loop.
//
// Backward, resident route (bf16 wh, b <= 128, one block per group of 8
// units co-resident, the wh slice within shared memory; the wrapper
// chooses the route by shape): two launches.
//   1. The gate phase, a parallel GEMM before the time loop: the gate
//      pre-activations of every step, round_bf16(ys[t-1]) @ wh + xproj[t]
//      ((T·b, H) × (H, 4H), zero h at t = 0), into a (T, b, 4H) fp32
//      scratch. It replaces the gate recompute inside _bwd_kernel
//      (lstm_kernel.py:106, xp + dot(hprev.astype(bf16), wh)), which
//      needs no carry and so leaves the serial chain. Bound: bytes. At
//      NMT's shape (T·b = 2,560, H = 1,024) xproj in and the gates out
//      (83.9 MB), the ys rows used (10.2 MB) and wh (8.4 MB) are 102.5
//      MB, 0.0306 ms at 3.35 TB/s; the 20.9 GFLOP of bf16 products take
//      0.021 ms on the tensor cores. 82 % of the bytes are the
//      epilogue's. Two routes, by shape alone (ff_lstm_gates_route):
//      "wgmma" where TMA can describe ys (H % 4 == 0), else "mma".
//      "wgmma", lstm_gates_wgmma_kernel: persistent, as many clusters
//      of 2 × 2 CTAs as the card holds at once (one CTA an SM, at most
//      the tiles), each walking 256 × 512 supertiles, M fastest, so that
//      the clusters running together share wh's tiles in L2; CTA (i, j)
//      of a cluster takes the 128 × 256 tile (i, j) of its supertile.
//      Warp-specialised: one producer thread issues TMA copies into a
//      ring of kWgStages stages (7 × 32 KB), each with a full and an
//      empty mbarrier; two consumer warpgroups take 64 rows each, with
//      setmaxnreg's 232 registers (a 64 × 256 fp32 accumulator is 128 a
//      thread). A stage is a 32-deep k slice: ys as fp32, by a tensor
//      map over (T·b, H) read at row m0 - b, so TMA's zero fill gives
//      h_{-1} = 0 and the k tail and the main loop has no mask; a
//      consumer rounds its rows to bf16 (nearest even) as it moves them
//      from shared memory into wgmma's A registers, once per use as the
//      JAX kernel's astype; wh (bf16, N-contiguous: an MN-major B
//      operand) in 128-byte swizzled boxes of 64 columns, read by
//      descriptor with wgmma's transpose. wgmma.m64n256k16 accumulates
//      in fp32, one stage in flight. L2 to SM bytes, K·(M·⌈N/BN⌉·4/CN +
//      N·⌈M/BM⌉·2/CM) for clusters of CM × CN: the "mma" kernel's
//      128 × 128 tiles 500 MB; 128 × 256 tiles 336 MB; with the cluster,
//      whose two CTAs of an m-tile share its ys rows and two of an
//      n-tile its wh columns (each CTA loads half and multicasts it),
//      168 MB. The copies ask L2 to keep ys and wh, which every tile of
//      their row or column reads again, and to evict xproj first. The
//      epilogue is streamed: after a tile's last k slice the producer
//      lands its xproj in the ring, 64 columns a stage, while the
//      consumers finish; they write gates = xproj + acc (fp32, one add
//      at the end) over it in place, and a storer thread of the producer
//      warpgroup stores each stage by TMA (which clips the ragged M and
//      N edges, so no mask is needed anywhere) and releases it, while
//      the consumers start the next tile. Each output is summed by one
//      warpgroup in k order (no split-K, no atomics): two calls are
//      bitwise equal. tools/gates_probe.py times it cut after each
//      phase and at other tilings and clusters.
//      "mma", lstm_gates_kernel: 128 × 128 tiles, 8 warps of
//      mma.sync.m16n8k16 bf16 with fp32 accumulators fed by ldmatrix;
//      ys is read as float4 and rounded to bf16 as it is staged, the
//      next k tile's loads in flight during the current one's products.
//   2. lstm_bwd_resident_kernel, one cooperative launch of exactly one
//      block per group: the block copies its 8 rows of wh (8 × 4H bf16,
//      64 KB at H = 1,024, padded against bank conflicts) into dynamic
//      shared memory once, and keeps them for the whole call. A step's
//      carry dh = round_bf16(dz[t+1]) @ whᵀ is, for the block, an
//      M = b, N = 8, K = 4H product: each of 8 warps takes one 16-row
//      tile and a share of K and runs mma.sync.m16n8k16 with A read
//      straight from global memory and B from the resident slice; the
//      partial sums meet in shared memory. dz[t+1] is rounded to bf16
//      ONCE, by the thread that writes it, into a two-slot bf16 ring laid
//      out in mma fragment order, so a reader's A fragment is one 16-byte
//      __ldcg (L2, never a stale L1 line) and eight of them stay in
//      flight. A thread keeps its (row, unit) for the whole call, so c
//      and the dc carry stay in registers, and it loads the step's
//      carry-free inputs (gates[t], cs[t-1], dys[t]) before the barrier.
//      Per step a block reads the 512 KB ring slot from L2 (64 MB for
//      128 blocks) and waits at one grid.sync.
// lstm_barrier_kernel runs the serial phase's barriers alone, to measure
// their cost; no path calls it. A refused launch raises in the wrapper:
// there is no fallback between routes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 8;                   // hidden units of a group
constexpr int kLanes = kThreads / kUnits;   // 32 row lanes
constexpr int kRows = 2;                    // batch rows per thread
constexpr int kTile = kLanes * kRows;       // 64 batch rows per tile
constexpr int kChunk = 32;                  // k or columns per stage

template <typename W>
__device__ __forceinline__ float to_float(W v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x rounded to W, as JAX's astype(wh.dtype) on the carried operand
template <typename W>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

struct GateSmem {
  float4 w[kChunk][kUnits];       // wh[k, q·H + j] for the 4 gates q
  float h[kTile][kChunk + 1];     // h_{t-1}[row, k], rounded to W
};

struct CarrySmem {
  float dz[kTile][kChunk + 1];    // dz[t+1][row, col], rounded to W
  float w[kUnits][kChunk + 1];    // wh[j, col]
};

// acc[r][q] = sum over k of round_W(hprev[row, k]) · wh[k, q·H + j] for
// the thread's rows row = base + lane + r·kLanes and unit j = j0 + unit;
// hprev (b, H) was written by other blocks before the last barrier.
template <typename W>
__device__ void gate_product(const float* hprev, const W* __restrict__ wh,
                             int b, int H, int base, int j0, GateSmem& sm,
                             float acc[kRows][4]) {
  const int tid = threadIdx.x, unit = tid % kUnits, lane = tid / kUnits;
  const size_t H4 = 4 * (size_t)H;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int rr = e / kChunk, kk = e % kChunk;
      const int row = base + rr, k = k0 + kk;
      sm.h[rr][kk] = (row < b && k < H)
                         ? round_to<W>(__ldcg(hprev + (size_t)row * H + k))
                         : 0.f;
    }
    for (int e = tid; e < kChunk * 4 * kUnits; e += kThreads) {
      const int kk = e / (4 * kUnits), q = (e / kUnits) % 4, u = e % kUnits;
      const int k = k0 + kk, j = j0 + u;
      reinterpret_cast<float*>(&sm.w[kk][u])[q] =
          (k < H && j < H) ? to_float(wh[(size_t)k * H4 + (size_t)q * H + j])
                           : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 w = sm.w[kk][unit];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hv = sm.h[lane + r * kLanes][kk];
        acc[r][0] = fmaf(hv, w.x, acc[r][0]);
        acc[r][1] = fmaf(hv, w.y, acc[r][1]);
        acc[r][2] = fmaf(hv, w.z, acc[r][2]);
        acc[r][3] = fmaf(hv, w.w, acc[r][3]);
      }
    }
    __syncthreads();
  }
}

// acc[r] = sum over the 4H columns of round_W(dz[row, col]) · wh[j, col]:
// the thread's entry of dz @ whᵀ, read from wh's rows (no whᵀ is made);
// dz (b, 4H) was written by other blocks before the last barrier.
template <typename W>
__device__ void carry_product(const float* dz, const W* __restrict__ wh,
                              int b, int H, int base, int j0, CarrySmem& sm,
                              float acc[kRows]) {
  const int tid = threadIdx.x, unit = tid % kUnits, lane = tid / kUnits;
  const int H4 = 4 * H;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < H4; c0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int rr = e / kChunk, cc = e % kChunk;
      const int row = base + rr, col = c0 + cc;
      sm.dz[rr][cc] = (row < b && col < H4)
                          ? round_to<W>(__ldcg(dz + (size_t)row * H4 + col))
                          : 0.f;
    }
    for (int e = tid; e < kUnits * kChunk; e += kThreads) {
      const int u = e / kChunk, cc = e % kChunk;
      const int j = j0 + u, col = c0 + cc;
      sm.w[u][cc] = (j < H && col < H4)
                        ? to_float(wh[(size_t)j * H4 + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int cc = 0; cc < kChunk; ++cc) {
      const float w = sm.w[unit][cc];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(sm.dz[lane + r * kLanes][cc], w, acc[r]);
    }
    __syncthreads();
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads, 2)
lstm_fwd_kernel(const float* __restrict__ xproj, const W* __restrict__ wh,
                float* ys, float* cs, float* cbuf, int T, int b, int H) {
  __shared__ GateSmem sm;
  cg::grid_group grid = cg::this_grid();
  const int unit = threadIdx.x % kUnits, lane = threadIdx.x / kUnits;
  const int groups = (H + kUnits - 1) / kUnits;
  const size_t bh = (size_t)b * H, H4 = 4 * (size_t)H;
  for (int t = 0; t < T; ++t) {
    for (int g = blockIdx.x; g < groups; g += gridDim.x) {
      const int j0 = g * kUnits, j = j0 + unit;
      for (int base = 0; base < b; base += kTile) {
        float acc[kRows][4];
        if (t > 0) {
          gate_product<W>(ys + (t - 1) * bh, wh, b, H, base, j0, sm, acc);
        } else {   // h_{-1} = 0: the gates are xproj[0]
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
        }
        if (j >= H) continue;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = base + lane + r * kLanes;
          if (row >= b) continue;
          const float* xp = xproj + t * (b * H4) + row * H4;
          const float i = sigmoid(__ldg(xp + j) + acc[r][0]);
          const float f = sigmoid(__ldg(xp + H + j) + acc[r][1]);
          const float gg = tanhf(__ldg(xp + 2 * H + j) + acc[r][2]);
          const float o = sigmoid(__ldg(xp + 3 * H + j) + acc[r][3]);
          const size_t idx = (size_t)row * H + j;
          const float cprev = t > 0 ? cbuf[idx] : 0.f;
          const float c = f * cprev + i * gg;
          ys[t * bh + idx] = o * tanhf(c);
          if (cs) cs[t * bh + idx] = c;
          cbuf[idx] = c;
        }
      }
    }
    if (t + 1 < T) grid.sync();
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads, 2)
lstm_bwd_kernel(const float* __restrict__ xproj, const W* __restrict__ wh,
                const float* __restrict__ ys, const float* __restrict__ cs,
                const float* __restrict__ dys, float* dzs, float* dcbuf,
                int T, int b, int H) {
  __shared__ GateSmem gsm;
  __shared__ CarrySmem csm;
  cg::grid_group grid = cg::this_grid();
  const int unit = threadIdx.x % kUnits, lane = threadIdx.x / kUnits;
  const int groups = (H + kUnits - 1) / kUnits;
  const size_t bh = (size_t)b * H, H4 = 4 * (size_t)H;
  for (int t = T - 1; t >= 0; --t) {
    for (int g = blockIdx.x; g < groups; g += gridDim.x) {
      const int j0 = g * kUnits, j = j0 + unit;
      for (int base = 0; base < b; base += kTile) {
        float acc[kRows][4], dhc[kRows];
        if (t > 0) {
          gate_product<W>(ys + (t - 1) * bh, wh, b, H, base, j0, gsm, acc);
        } else {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
        }
        if (t + 1 < T) {   // dh carried from step t+1: dz[t+1] @ whᵀ
          carry_product<W>(dzs + (t + 1) * (b * H4), wh, b, H, base, j0,
                           csm, dhc);
        } else {
#pragma unroll
          for (int r = 0; r < kRows; ++r) dhc[r] = 0.f;
        }
        if (j >= H) continue;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = base + lane + r * kLanes;
          if (row >= b) continue;
          const float* xp = xproj + t * (b * H4) + row * H4;
          const float i = sigmoid(__ldg(xp + j) + acc[r][0]);
          const float f = sigmoid(__ldg(xp + H + j) + acc[r][1]);
          const float gg = tanhf(__ldg(xp + 2 * H + j) + acc[r][2]);
          const float o = sigmoid(__ldg(xp + 3 * H + j) + acc[r][3]);
          const size_t idx = (size_t)row * H + j;
          const float cprev = t > 0 ? __ldg(cs + (t - 1) * bh + idx) : 0.f;
          const float tanh_c = tanhf(__ldg(cs + t * bh + idx));
          const float dh = __ldg(dys + t * bh + idx) + dhc[r];
          const float dc = (t + 1 < T ? dcbuf[idx] : 0.f)
                           + dh * o * (1.f - tanh_c * tanh_c);
          float* dz = dzs + t * (b * H4) + row * H4;
          dz[j] = dc * gg * i * (1.f - i);
          dz[H + j] = dc * cprev * f * (1.f - f);
          dz[2 * H + j] = dc * i * (1.f - gg * gg);
          dz[3 * H + j] = dh * tanh_c * o * (1.f - o);
          dcbuf[idx] = dc * f;
        }
      }
    }
    if (t > 0) grid.sync();
  }
}

// ---- the backward's resident route (bf16 wh) --------------------------

// D += A·B on the bf16 tensor cores, one m16n8k16 tile, fp32 accumulate.
// A fragment: a0 = (row g, k 2t..2t+1), a1 = (g+8, 2t..), a2 = (g,
// 2t+8..), a3 = (g+8, 2t+8..); B fragment: b0 = (k 2t..2t+1, col g),
// b1 = (k 2t+8.., col g); D: d0,d1 = (g, 2t..2t+1), d2,d3 = (g+8, ..),
// for lane = 4g + t; the lower index in the lower 16 bits.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 × 8 bf16 matrices from shared memory into mma fragments; lane
// l gives the address of row l % 8 of matrix l / 8. With .trans each
// matrix is read transposed (a B fragment from a [k][n] tile).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

constexpr int kGateBM = 128, kGateBN = 128, kGateBK = 32;
constexpr int kGateThreads = 256;            // 8 warps, 2 × 4, 64 × 32 each
constexpr int kAStride = kGateBK + 8;        // bf16: 80 B rows, so the 8
constexpr int kBStride = kGateBN + 8;        // rows of an ldmatrix hit 8
                                             // different 16-byte bank groups
constexpr int kAVecs = kGateBM * kGateBK / 4 / kGateThreads;   // 4 float4
constexpr int kBVecs = kGateBK * kGateBN / 8 / kGateThreads;   // 2 × 8 bf16

// gates[r, n] = xproj[r, n] + Σ_k round_bf16(hp[r, k]) · wh[k, n] over
// the M = T·b rows r = t·b + row, with hp row r = ys row r - b (h_{t-1})
// and zero at t = 0; N = 4H columns, K = H. A 128 × 128 tile a block:
// ys and wh are each re-read from L2 N/128 and M/128 times.
__global__ void __launch_bounds__(kGateThreads, 1)
lstm_gates_kernel(const float* __restrict__ xproj,
                  const __nv_bfloat16* __restrict__ wh,
                  const float* __restrict__ ys, float* __restrict__ gates,
                  int M, int b, int H) {
  __shared__ __align__(16) __nv_bfloat16 As[kGateBM][kAStride];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[kGateBK][kBStride];  // [k][n]
  const int N = 4 * H;
  const int m0 = blockIdx.y * kGateBM, n0 = blockIdx.x * kGateBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const bool vec_a = H % 4 == 0, vec_b = N % 8 == 0;
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float4 ra[kAVecs];
  uint4 rb[kBVecs];
  // the next k tile into registers, while the current one is multiplied
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {
      const int e = tid + i * kGateThreads;
      const int r = m0 + e / (kGateBK / 4), k = k0 + (e % (kGateBK / 4)) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r >= b && r < M) {
        const float* p = ys + (size_t)(r - b) * H + k;
        if (vec_a && k + 3 < H) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(p));
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x) v[x] = k + x < H ? __ldg(p + x) : 0.f;
        }
      }
      ra[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int e = tid + i * kGateThreads;
      const int k = k0 + e / (kGateBN / 8), n = n0 + (e % (kGateBN / 8)) * 8;
      const __nv_bfloat16* p = wh + (size_t)k * N + n;
      if (k < H && vec_b && n + 7 < N) {
        rb[i] = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        unsigned short v[8];
#pragma unroll
        for (int x = 0; x < 8; ++x)
          v[x] = (k < H && n + x < N)
                     ? reinterpret_cast<const unsigned short*>(p)[x] : 0;
        rb[i] = make_uint4(v[0] | (uint32_t)v[1] << 16,
                           v[2] | (uint32_t)v[3] << 16,
                           v[4] | (uint32_t)v[5] << 16,
                           v[6] | (uint32_t)v[7] << 16);
      }
    }
  };
  load(0);
  for (int k0 = 0; k0 < H; k0 += kGateBK) {
#pragma unroll
    for (int i = 0; i < kAVecs; ++i) {   // ys rounded to bf16 as staged
      const int e = tid + i * kGateThreads;
      __nv_bfloat162 lo = __floats2bfloat162_rn(ra[i].x, ra[i].y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(ra[i].z, ra[i].w);
      *reinterpret_cast<uint2*>(&As[e / (kGateBK / 4)]
                                   [(e % (kGateBK / 4)) * 4]) =
          make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                     *reinterpret_cast<uint32_t*>(&hi));
    }
#pragma unroll
    for (int i = 0; i < kBVecs; ++i) {
      const int e = tid + i * kGateThreads;
      *reinterpret_cast<uint4*>(&Bs[e / (kGateBN / 8)]
                                   [(e % (kGateBN / 8)) * 8]) = rb[i];
    }
    __syncthreads();
    if (k0 + kGateBK < H) load(k0 + kGateBK);
#pragma unroll
    for (int ks = 0; ks < kGateBK; ks += 16) {
      uint32_t a[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], &As[wm + mi * 16 + lane % 16][ks + (lane / 16) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bf[nj], &Bs[ks + lane % 16]
                                     [wn + nj * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                   bf[ni / 2][(ni % 2) * 2], bf[ni / 2][(ni % 2) * 2 + 1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mi * 16 + g + half * 8;
        const int n = n0 + wn + ni * 8 + 2 * tg;
        if (r >= M) continue;
        const size_t idx = (size_t)r * N + n;
        if (n + 1 < N) {
          const float2 x = __ldg(reinterpret_cast<const float2*>(xproj + idx));
          *reinterpret_cast<float2*>(gates + idx) =
              make_float2(x.x + acc[mi][ni][2 * half],
                          x.y + acc[mi][ni][2 * half + 1]);
        } else if (n < N) {
          gates[idx] = __ldg(xproj + idx) + acc[mi][ni][2 * half];
        }
      }
}

// ---- The "wgmma" route of the gate phase: lstm_gates_wgmma_kernel ----
//
// A persistent, warp-specialised GEMM in clusters with a streamed
// epilogue (see the header comment). A tile is kWgBM = 128 rows by kWgBN
// columns; a ring stage holds one kWgBK-deep k slice of it (ys fp32, wh
// bf16), or, in the epilogue, kWgChunk columns of the tile's xproj and
// then of its gates.
constexpr int kWgBM = 128;                  // 2 consumer warpgroups × 64
constexpr int kWgBN = 256;
constexpr int kWgBK = 32;
constexpr int kWgThreads = 384;             // producer warpgroup + 2
// a cluster of kWgCM × kWgCN CTAs: the kWgCN CTAs of one m-tile share
// its ys tile and the kWgCM of one n-tile its wh tile, each CTA loading
// its part and multicasting it to the others
constexpr int kWgCM = 2, kWgCN = 2;
constexpr int kWgCS = kWgCM * kWgCN;
constexpr int kWgARows = kWgBM / kWgCN;     // ys rows a CTA loads a box
constexpr int kWgBox = 128 * 32 * 4;        // an fp32 box: 128 rows × 128 B
constexpr int kWgABoxes = kWgBK / 32;       // ys boxes a stage
constexpr int kWgBBox = kWgBK * 128;        // a bf16 box: kWgBK rows × 64
constexpr int kWgBBoxes = kWgBN / 64;       // wh boxes a stage
constexpr int kWgStage = kWgABoxes * kWgBox + kWgBBoxes * kWgBBox;
// the most xproj boxes (128 rows × 32 columns) a stage holds that divide
// the tile's kWgBN / 32
constexpr int xboxes(int most, int all) {
  return all % most == 0 ? most : xboxes(most - 1, all);
}
constexpr int kWgXBoxes = xboxes(kWgStage / kWgBox < kWgBN / 32
                                     ? kWgStage / kWgBox : kWgBN / 32,
                                 kWgBN / 32);
constexpr int kWgChunk = 32 * kWgXBoxes;    // columns an epilogue stage
constexpr int kWgChunks = kWgBN / kWgChunk;
// the card's 227 KB a block, less the 1,024-byte alignment of the ring
// and the static barriers
constexpr int kWgStages = (232448 - 1024 - 512) / kWgStage;
constexpr size_t kWgSmem = (size_t)kWgStages * kWgStage + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// an arrival on the barrier at this CTA's shared address bar, in CTA
// `cta` of the cluster. Its release is the CTA's, as a local arrival's:
// the arriving warp only read the stage, and a release at cluster scope
// (.release.cluster) slows the ring down by far (tools/gates_probe.py,
// "cluster-scope arrivals")
__device__ __forceinline__ void mbar_arrive_cta(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(bar),
      "r"(cta)
      : "memory");
}

// `count` arrivals at once, on this CTA's barrier or CTA `cta`'s
__device__ __forceinline__ void mbar_arrive_n(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_cta_n(uint32_t bar, uint32_t cta,
                                                  uint32_t count) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra], %2;\n}\n" ::"r"(bar),
      "r"(cta), "r"(count)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Waits until the barrier's phase of `parity` has completed. A copy that
// never lands (a bad tensor map) ends the kernel with an error after a
// few seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 33)) __trap();
}

// An L2 eviction policy for the copies and stores that name it.
__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// One TMA copy of the box at (column c0, row r0) of the map's 2-D tensor
// into shared memory at dst, completing on bar, under L2 policy `pol`;
// what lies outside the tensor, negative rows included, reads as zero.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int r0, uint32_t bar,
                                         uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar),
      "l"(pol)
      : "memory");
}

// tma_load into the same shared-memory offset, completing on the same
// barrier, of every CTA of the cluster in `mask`
__device__ __forceinline__ void tma_load_mc(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int r0, uint32_t bar,
                                            uint16_t mask, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster.L2::cache_hint"
      " [%0], [%1, {%2, %3}], [%4], %5, %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar),
      "h"(mask), "l"(pol)
      : "memory");
}


// One TMA copy of the box at (column c0, row r0) of the map's tensor
// from shared memory at src (the map's swizzled layout), in the thread's
// bulk group; what lies past the tensor's edge is not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int r0,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(r0), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void sts_f2(uint32_t addr, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y)
               : "memory");
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// two floats rounded to bf16 (nearest even), the lower in the low half
__device__ __forceinline__ uint32_t bf16x2(float2 v) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma's descriptor of an MN-major bf16 B operand (wh's rows are
// N-contiguous) in 128-byte swizzled boxes of 64 columns: 8-row k groups
// 1,024 bytes apart (the stride byte offset), the boxes kWgBBox bytes
// apart (the leading byte offset), layout 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)(kWgBBox >> 4) << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kLeft>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kLeft) : "memory");
}

// The accumulators as written by the last wgmma the wait retired: the
// compiler may not move a read of them above this point.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 × kN fp32, this warpgroup's) = A · B (+ D unless scale_d is 0),
// one m64nNk16 step: A from registers in mma.sync's m16n8k16 fragment
// order (warp w of the warpgroup rows 16w..16w+15), B by descriptor,
// transposed (MN-major). D: d[4j + 2h + e] is row 16w + g + 8h, column
// 8j + 2t + e, for lane = 4g + t.
template <int kN>
__device__ __forceinline__ void wgmma_rs(float (&d)[kN / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// A place in the ring: stage s at data + s·kWgStage, its full and empty
// barriers, and the parity of the stage's current use.
struct Ring {
  uint32_t data, full, empty;
  int s = 0;
  uint32_t phase = 0;
  __device__ uint32_t stage() const { return data + s * kWgStage; }
  __device__ uint32_t full_bar() const { return full + 8 * s; }
  __device__ uint32_t empty_bar(int at) const { return empty + 8 * at; }
  __device__ void next() {
    if (++s == kWgStages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// A consumer warp is done with stage `at`: one arrival a warp on the
// stage's empty barrier in every CTA of the cluster (a CTA's copies land
// in its peers' stages too), lane c arriving in CTA c.
__device__ __forceinline__ void release(const Ring& r, int at) {
  __syncwarp();
  const uint32_t lane = threadIdx.x % 32;
  if (kWgCS == 1) {
    if (lane == 0) mbar_arrive(r.empty_bar(at));
  } else if (lane < kWgCS) {
    mbar_arrive_cta(r.empty_bar(at), lane);
  }
}

// One k stage of a consumer warpgroup: A fragments of its 64 rows, the
// fp32 ys rounded to bf16 (nearest even) once per use, into `a`; the
// stage's wgmmas, one group; then the wait that retires the last stage's
// group, whose stage is released. `a` is read by the group until that
// wait in the NEXT stage: the caller alternates two arrays, so that no
// stage rewrites registers a group in flight still reads (one array in a
// loop body would be the same registers in every iteration).
__device__ __forceinline__ void gates_step(Ring& r, int& prev,
                                           float (&acc)[kWgBN / 2],
                                           uint32_t (&a)[kWgBK / 16][4],
                                           uint32_t row_off, int g, int tg,
                                           bool first) {
  mbar_wait(r.full_bar(), r.phase);
  const uint32_t st = r.stage();
  // a thread's rows r0 and r0 + 8 (row_off, + 1,024 bytes), its two words
  // of 16-byte chunk q at ((q ^ g) << 4): the 128-byte swizzle XORs the
  // chunk index with the row's index mod 8, which is g for both rows
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk) {
    const uint32_t base = st + (kk / 2) * kWgBox + row_off;
    const int q = 4 * (kk % 2) + tg / 2;
    a[kk][0] = bf16x2(lds_f2(base + ((q ^ g) << 4)));
    a[kk][1] = bf16x2(lds_f2(base + 1024 + ((q ^ g) << 4)));
    a[kk][2] = bf16x2(lds_f2(base + (((q + 2) ^ g) << 4)));
    a[kk][3] = bf16x2(lds_f2(base + 1024 + (((q + 2) ^ g) << 4)));
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk)
    wgmma_rs<kWgBN>(acc, a[kk], b_desc(st + kWgABoxes * kWgBox + kk * 2048),
                    !first || kk > 0);
  wgmma_commit();
  wgmma_wait<1>();
  if (!first) release(r, prev);
  prev = r.s;
  r.next();
}

// gates[r, n] = xproj[r, n] + Σ_k round_bf16(ys[r - b, k]) · wh[k, n],
// zero ys rows above the first (t = 0); M = T·b rows, N = 4H, K = H.
__global__ void __launch_bounds__(kWgThreads, 1)
lstm_gates_wgmma_kernel(const __grid_constant__ CUtensorMap ys_map,
                        const __grid_constant__ CUtensorMap wh_map,
                        const __grid_constant__ CUtensorMap xp_map,
                        const __grid_constant__ CUtensorMap gt_map, int M,
                        int b, int H) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ __align__(8) uint64_t full[kWgStages], empty[kWgStages],
      written[kWgStages];
  Ring r{(smem_addr(smem) + 1023) & ~1023u, smem_addr(full),
         smem_addr(empty)};
  const int N = 4 * H;
  // the cluster's tiles: kWgCM × kWgCN tiles, CTA (rm, rn) of the cluster
  // taking the one at (rm, rn), M fastest; a tile past M or N (where mt or
  // nt is not a multiple) is computed on zeros and stores nothing
  const int rank = kWgCS > 1 ? (int)cluster_rank() : 0;
  const int rm = rank % kWgCM, rn = rank / kWgCM;
  const int mts = ((M + kWgBM - 1) / kWgBM + kWgCM - 1) / kWgCM;
  const int tiles = mts * (((N + kWgBN - 1) / kWgBN + kWgCN - 1) / kWgCN);
  const int kbs = (H + kWgBK - 1) / kWgBK;
  const int cl = blockIdx.x / kWgCS, ncl = gridDim.x / kWgCS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(r.full + 8 * s, 1);     // the producer's expect_tx
      mbar_init(r.empty + 8 * s, 8 * kWgCS);   // the cluster's consumers
      mbar_init(smem_addr(&written[s]), 8);    // this CTA's consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kWgCS > 1)
    cluster_sync();       // no peer copies or arrives before the init
  else
    __syncthreads();
  if (threadIdx.x < 128) {
    // the producer warpgroup: thread 32 stores, thread 0 issues every
    // copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 32) {
      // the storer: each epilogue stage, once the consumers have written
      // the gates over its xproj, to global memory by TMA; then it
      // releases the stage for the consumers (8 arrivals in each CTA of
      // the cluster), so that they go on to the next tile meanwhile
      const uint64_t out = evict_first();     // the gates, written once
      uint32_t parity = 0;                    // written[s]'s, bit s
      for (int t = cl; t < tiles; t += ncl) {
        const int m0 = ((t % mts) * kWgCM + rm) * kWgBM;
        const int n0 = ((t / mts) * kWgCN + rn) * kWgBN;
        for (int kb = 0; kb < kbs; ++kb) r.next();
        for (int c = 0; c < kWgChunks; ++c) {
          const uint32_t st = r.stage();
          mbar_wait(smem_addr(&written[r.s]), (parity >> r.s) & 1);
          parity ^= 1u << r.s;
#pragma unroll
          for (int x = 0; x < kWgXBoxes; ++x)
            tma_store(&gt_map, st + x * kWgBox, n0 + c * kWgChunk + 32 * x,
                      m0, out);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          if (kWgCS == 1) {
            mbar_arrive_n(r.empty_bar(r.s), 8);
          } else {
            for (int cta = 0; cta < kWgCS; ++cta)
              mbar_arrive_cta_n(r.empty_bar(r.s), cta, 8);
          }
          r.next();
        }
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      return;
    }
    if (threadIdx.x != 0) return;
    // L2 keeps the operands, which every tile of their row or column
    // reads again, and evicts xproj, read once, first
    const uint64_t keep = evict_last(), once = evict_first();
    // the CTAs sharing this CTA's ys rows (its m-tile) and wh columns
    uint16_t a_mask = 0, b_mask = ((1 << kWgCM) - 1) << (kWgCM * rn);
    for (int j = 0; j < kWgCN; ++j) a_mask |= 1 << (rm + kWgCM * j);
    for (int t = cl; t < tiles; t += ncl) {
      const int m0 = ((t % mts) * kWgCM + rm) * kWgBM;
      const int n0 = ((t / mts) * kWgCN + rn) * kWgBN;
      for (int kb = 0; kb < kbs; ++kb) {
        const uint32_t st = r.stage(), bar = r.full_bar();
        mbar_wait(r.empty_bar(r.s), r.phase ^ 1);
        mbar_expect_tx(bar, kWgStage);
        // ys: rows [rn·kWgARows, + kWgARows) of each box, to the m-tile's
        // CTAs; wh: boxes [rm·kWgBBoxes/kWgCM, ...), to the n-tile's
#pragma unroll
        for (int a = 0; a < kWgABoxes; ++a) {
          const uint32_t dst = st + a * kWgBox + rn * kWgARows * 128;
          const int k0 = kb * kWgBK + 32 * a, r0 = m0 - b + rn * kWgARows;
          if (kWgCN > 1)
            tma_load_mc(dst, &ys_map, k0, r0, bar, a_mask, keep);
          else
            tma_load(dst, &ys_map, k0, r0, bar, keep);
        }
#pragma unroll
        for (int i = 0; i < kWgBBoxes / kWgCM; ++i) {
          const int j = rm * (kWgBBoxes / kWgCM) + i;
          const uint32_t dst = st + kWgABoxes * kWgBox + j * kWgBBox;
          if (kWgCM > 1)
            tma_load_mc(dst, &wh_map, n0 + 64 * j, kb * kWgBK, bar, b_mask,
                        keep);
          else
            tma_load(dst, &wh_map, n0 + 64 * j, kb * kWgBK, bar, keep);
        }
        r.next();
      }
      for (int c = 0; c < kWgChunks; ++c) {
        const uint32_t st = r.stage(), bar = r.full_bar();
        mbar_wait(r.empty_bar(r.s), r.phase ^ 1);
        mbar_expect_tx(bar, kWgXBoxes * kWgBox);
#pragma unroll
        for (int x = 0; x < kWgXBoxes; ++x)
          tma_load(st + x * kWgBox, &xp_map, n0 + c * kWgChunk + 32 * x, m0,
                   bar, once);
        r.next();
      }
    }
    // stay until the cluster's consumers have released every stage: they
    // arrive on this CTA's barriers, and its copies land in their stages
    for (int i = 0; i < kWgStages; ++i) {
      mbar_wait(r.empty_bar(r.s), r.phase ^ 1);
      r.next();
    }
  } else {
    // two consumer warpgroups, 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128, g = ct % 32 / 4, tg = ct % 4;
    const int r0 = 16 * (ct / 32) + g;      // rows r0 and r0 + 8 of the tile
    // the thread's row r0 in an fp32 box and its two words of a chunk
    const uint32_t row_off = r0 * 128 + (tg & 1) * 8;
    float acc[kWgBN / 2];
    uint32_t a0[kWgBK / 16][4], a1[kWgBK / 16][4];
    for (int t = cl; t < tiles; t += ncl) {
      const int m0 = ((t % mts) * kWgCM + rm) * kWgBM;
      const int n0 = ((t / mts) * kWgCN + rn) * kWgBN;
      int prev = 0, kb = 0;
      for (; kb + 1 < kbs; kb += 2) {
        gates_step(r, prev, acc, a0, row_off, g, tg, kb == 0);
        gates_step(r, prev, acc, a1, row_off, g, tg, false);
      }
      if (kb < kbs) gates_step(r, prev, acc, a0, row_off, g, tg, kb == 0);
      wgmma_wait<0>();
      fence_acc(acc);
      release(r, prev);
      // the streamed epilogue: xproj lands chunk by chunk in the ring;
      // gates = xproj + acc in fp32, written over it in place for the
      // storer, which stores the chunk and releases the stage
#pragma unroll
      for (int c = 0; c < kWgChunks; ++c) {
        const uint32_t st = r.stage();
        mbar_wait(r.full_bar(), r.phase);
#pragma unroll
        for (int x = 0; x < kWgXBoxes; ++x)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int jn = c * kWgChunk / 8 + 4 * x + j;
              const uint32_t at = st + x * kWgBox + row_off + h * 1024 +
                                  (((2 * j + tg / 2) ^ g) << 4);
              const float2 v = lds_f2(at);
              sts_f2(at, make_float2(v.x + acc[4 * jn + 2 * h],
                                     v.y + acc[4 * jn + 2 * h + 1]));
            }
        // the writes seen by TMA (the async proxy), then the storer told
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (ct % 32 == 0) mbar_arrive(smem_addr(&written[r.s]));
        r.next();
      }
    }
  }
}

constexpr int kResThreads = 256;             // 8 warps
constexpr int kResWarps = kResThreads / 32;
constexpr int kResUnits = 8;                 // hidden units of the block
constexpr int kResLanes = kResThreads / kResUnits;   // 32 row lanes
constexpr int kResRows = 4;                  // batch rows per thread
constexpr int kResMaxB = kResLanes * kResRows;       // 128
constexpr int kResUnroll = 8;                // ring loads in flight a warp
// partial carries: (K shares × 16-row tiles) <= 8 tiles of 16 × 8 fp32
constexpr int kDhpFloats = kResWarps * 16 * kResUnits;

// 4H padded to the product's depth of 16
__host__ __device__ __forceinline__ int padded_k(int H) {
  return (4 * H + 15) / 16 * 16;
}
// the slice's row stride in 32-bit words: 4 words of padding put the 8
// rows' fragments in 8 different bank quads
__host__ __device__ __forceinline__ int slice_stride(int H) {
  return padded_k(H) / 2 + 4;
}
size_t resident_smem(int H) {
  return (size_t)kResUnits * slice_stride(H) * 4 + kDhpFloats * 4;
}

// Where element (row, k) of dz[t] lives in a ring slot: 16-row tile rt,
// depth step s, then the 32 lanes' 16-byte A fragments (mma_bf16's
// layout), so a warp's fragment of one step is 512 contiguous bytes.
__device__ __forceinline__ size_t ring_index(int row, int k, int S) {
  const int rt = row >> 4, rr = row & 15, s = k >> 4, kk = k & 15;
  const int lane = (rr & 7) * 4 + ((kk & 7) >> 1);
  const int reg = (rr >> 3) + 2 * (kk >> 3);
  return (((size_t)rt * S + s) * 32 + lane) * 8 + reg * 2 + (kk & 1);
}

__global__ void __launch_bounds__(kResThreads, 1)
lstm_bwd_resident_kernel(const float* __restrict__ gates,
                         const __nv_bfloat16* __restrict__ wh,
                         const float* __restrict__ cs,
                         const float* __restrict__ dys,
                         float* __restrict__ dzs, __nv_bfloat16* ring,
                         int T, int b, int H) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int Kp = padded_k(H), S = Kp / 16, rs = slice_stride(H);
  uint32_t* slice = smem;                    // [kResUnits][rs] bf16 pairs
  float* dhp = reinterpret_cast<float*>(smem + kResUnits * rs);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, H4 = 4 * H, j0 = blockIdx.x * kResUnits;
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(wh);
  for (int e = tid; e < kResUnits * (Kp / 2); e += kResThreads) {
    const int u = e / (Kp / 2), c = 2 * (e % (Kp / 2)), j = j0 + u;
    const uint32_t lo = (j < H && c < H4) ? w16[(size_t)j * H4 + c] : 0u;
    const uint32_t hi = (j < H && c + 1 < H4) ? w16[(size_t)j * H4 + c + 1]
                                              : 0u;
    slice[u * rs + c / 2] = lo | (hi << 16);
  }
  const int mtiles = (b + 15) / 16;
  const int ksplit = mtiles >= kResWarps ? 1 : kResWarps / mtiles;
  const int unit = tid % kResUnits, lane = tid / kResUnits, j = j0 + unit;
  const int warp = tid / 32, wl = tid % 32, g = wl / 4, tg = wl % 4;
  const size_t bh = (size_t)b * H, bh4 = (size_t)b * H4;
  const size_t slot = (size_t)mtiles * 16 * Kp;
  float gz[kResRows][4], cprev[kResRows], dy[kResRows], c[kResRows],
      dcc[kResRows];
  // the carry-free inputs of step t
  auto load_step = [&](int t) {
#pragma unroll
    for (int r = 0; r < kResRows; ++r) {
      const int row = lane + r * kResLanes;
      if (row >= b || j >= H) continue;
      const float* gp = gates + t * bh4 + (size_t)row * H4 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) gz[r][q] = __ldg(gp + (size_t)q * H);
      const size_t idx = (size_t)row * H + j;
      cprev[r] = t > 0 ? __ldg(cs + (t - 1) * bh + idx) : 0.f;
      dy[r] = __ldg(dys + t * bh + idx);
    }
  };
#pragma unroll
  for (int r = 0; r < kResRows; ++r) {
    const int row = lane + r * kResLanes;
    c[r] = (row < b && j < H) ? __ldg(cs + (T - 1) * bh + (size_t)row * H + j)
                              : 0.f;
    dcc[r] = 0.f;
  }
  load_step(T - 1);
  __syncthreads();                           // the slice is in place
  for (int t = T - 1; t >= 0; --t) {
    const bool carry = t + 1 < T;
    if (carry) {   // dh = round_bf16(dz[t+1]) @ whᵀ for the block's units
      if (warp < mtiles * ksplit) {
        const int m = warp % mtiles, kh = warp / mtiles;
        const int s0 = kh * S / ksplit, s1 = (kh + 1) * S / ksplit;
        const uint4* A = reinterpret_cast<const uint4*>(
                             ring + ((t + 1) & 1) * slot) +
                         (size_t)m * S * 32 + wl;
        const uint32_t* Bp = slice + g * rs + tg;
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        int s = s0;
        for (; s + kResUnroll <= s1; s += kResUnroll) {
          uint4 a[kResUnroll];
#pragma unroll
          for (int u = 0; u < kResUnroll; ++u)
            a[u] = __ldcg(A + (size_t)(s + u) * 32);
#pragma unroll
          for (int u = 0; u < kResUnroll; ++u) {
            const uint32_t* bp = Bp + (s + u) * 8;
            mma_bf16(acc[u & 1], a[u].x, a[u].y, a[u].z, a[u].w, bp[0],
                     bp[4]);
          }
        }
        for (; s < s1; ++s) {
          const uint4 a = __ldcg(A + (size_t)s * 32);
          const uint32_t* bp = Bp + s * 8;
          mma_bf16(acc[0], a.x, a.y, a.z, a.w, bp[0], bp[4]);
        }
        float* out = dhp + (kh * mtiles + m) * 16 * kResUnits;
        out[g * kResUnits + 2 * tg] = acc[0][0] + acc[1][0];
        out[g * kResUnits + 2 * tg + 1] = acc[0][1] + acc[1][1];
        out[(g + 8) * kResUnits + 2 * tg] = acc[0][2] + acc[1][2];
        out[(g + 8) * kResUnits + 2 * tg + 1] = acc[0][3] + acc[1][3];
      }
      __syncthreads();
    }
    __nv_bfloat16* wr = ring + (t & 1) * slot;
#pragma unroll
    for (int r = 0; r < kResRows; ++r) {
      const int row = lane + r * kResLanes;
      if (row >= b || j >= H) continue;
      float dhc = 0.f;
      if (carry)
        for (int kh = 0; kh < ksplit; ++kh)
          dhc += dhp[((kh * mtiles + row / 16) * 16 + row % 16) * kResUnits
                     + unit];
      const float i = sigmoid(gz[r][0]), f = sigmoid(gz[r][1]);
      const float gg = tanhf(gz[r][2]), o = sigmoid(gz[r][3]);
      const float tanh_c = tanhf(c[r]);
      const float dh = dy[r] + dhc;
      const float dc = dcc[r] + dh * o * (1.f - tanh_c * tanh_c);
      const float d[4] = {dc * gg * i * (1.f - i),
                          dc * cprev[r] * f * (1.f - f),
                          dc * i * (1.f - gg * gg),
                          dh * tanh_c * o * (1.f - o)};
      float* dz = dzs + t * bh4 + (size_t)row * H4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dz[q * H + j] = d[q];
        wr[ring_index(row, q * H + j, S)] = __float2bfloat16_rn(d[q]);
      }
      dcc[r] = dc * f;
      c[r] = cprev[r];
    }
    if (t > 0) {
      load_step(t - 1);
      grid.sync();
    }
  }
}

// ---- the forward's resident route (bf16 wh) ---------------------------

constexpr int kFwdCols = 4 * kResUnits;      // 32: the 4 gates of 8 units
constexpr int kFwdUnroll = 16;               // ring loads in flight a warp
// a partial gate tile's row stride in floats: 8 words of padding put the
// 4 rows a warp's cell update reads in 4 different bank octets
constexpr int kGateStride = kFwdCols + 8;

// H padded to the product's depth of 16
__host__ __device__ __forceinline__ int fwd_padded_k(int H) {
  return (H + 15) / 16 * 16;
}
// the slice's column stride in 32-bit words: 4 words of padding put the
// 8 columns a B fragment reads in 8 different bank quads
__host__ __device__ __forceinline__ int fwd_slice_stride(int H) {
  return fwd_padded_k(H) / 2 + 4;
}
size_t fwd_resident_smem(int H) {
  return (size_t)kFwdCols * fwd_slice_stride(H) * 4 +
         (size_t)kResWarps * 16 * kGateStride * 4;
}

// The forward's serial scan with the block's 32 columns of wh resident.
// Block x owns units j0..j0+7 (j0 = 8x); column n = q·8 + u of its slice
// is wh[:, q·H + j0 + u], stored [n][k] as bf16 pairs along k, so a
// thread's mma D fragment holds all four gates of its two units. A step's
// gates for the block are one M = b, N = 32, K = H product: each of 8
// warps takes one 16-row tile and a share of K, reads A from the ring
// (round_bf16(h_{t-1}) in fragment order, one 16-byte __ldcg a fragment,
// kFwdUnroll in flight) and B from the slice; the partial tiles meet in
// shared memory. The thread that computes h[t][row, j] rounds it to bf16
// once and writes it to the ring (the even unit of a pair writes both
// halves of the 32-bit word). A thread keeps its (row, unit) for the
// whole call, so c stays in a register, and loads xproj[t+1]'s four gate
// entries before the barrier.
__global__ void __launch_bounds__(kResThreads, 1)
lstm_fwd_resident_kernel(const float* __restrict__ xproj,
                         const __nv_bfloat16* __restrict__ wh,
                         float* __restrict__ ys, float* __restrict__ cs,
                         __nv_bfloat16* ring, int T, int b, int H) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int Kp = fwd_padded_k(H), S = Kp / 16, rs = fwd_slice_stride(H);
  uint32_t* slice = smem;                    // [kFwdCols][rs] bf16 pairs
  float* part = reinterpret_cast<float*>(smem + kFwdCols * rs);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, H4 = 4 * H, j0 = blockIdx.x * kResUnits;
  unsigned short* s16 = reinterpret_cast<unsigned short*>(slice);
  const unsigned short* w16 = reinterpret_cast<const unsigned short*>(wh);
  if (H % 8 == 0 && reinterpret_cast<uintptr_t>(wh) % 16 == 0) {
    // (k, q): the 8 units' entries of gate q, one 16-byte load
    for (int e = tid; e < 4 * Kp; e += kResThreads) {
      const int k = e >> 2, q = e & 3;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < H && j0 < H)
        v = __ldg(reinterpret_cast<const uint4*>(
            w16 + (size_t)k * H4 + (size_t)q * H + j0));
      const unsigned short* p = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
      for (int u = 0; u < kResUnits; ++u)
        s16[(size_t)(q * kResUnits + u) * rs * 2 + k] = p[u];
    }
  } else {
    for (int e = tid; e < kFwdCols * Kp; e += kResThreads) {
      const int k = e / kFwdCols, n = e % kFwdCols;
      const int q = n / kResUnits, j = j0 + n % kResUnits;
      s16[(size_t)n * rs * 2 + k] =
          (k < H && j < H) ? w16[(size_t)k * H4 + (size_t)q * H + j] : 0;
    }
  }
  const int mtiles = (b + 15) / 16;
  const int ksplit = mtiles >= kResWarps ? 1 : kResWarps / mtiles;
  const int unit = tid % kResUnits, lane = tid / kResUnits, j = j0 + unit;
  const int warp = tid / 32, wl = tid % 32, g = wl / 4, tg = wl % 4;
  const size_t bh = (size_t)b * H, bh4 = (size_t)b * H4;
  const size_t slot = (size_t)mtiles * 16 * Kp;
  float xg[kResRows][4], c[kResRows];
  // xproj[t]'s four gate entries of the thread's rows: no carry
  auto load_x = [&](int t) {
#pragma unroll
    for (int r = 0; r < kResRows; ++r) {
      const int row = lane + r * kResLanes;
      if (row >= b || j >= H) continue;
      const float* xp = xproj + t * bh4 + (size_t)row * H4 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) xg[r][q] = __ldg(xp + (size_t)q * H);
    }
  };
#pragma unroll
  for (int r = 0; r < kResRows; ++r) c[r] = 0.f;
  load_x(0);
  __syncthreads();                           // the slice is in place
  for (int t = 0; t < T; ++t) {
    if (t > 0) {   // the gates' product round_bf16(h_{t-1}) @ wh[:, cols]
      if (warp < mtiles * ksplit) {
        const int m = warp % mtiles, kh = warp / mtiles;
        const int s0 = kh * S / ksplit, s1 = (kh + 1) * S / ksplit;
        const uint4* A = reinterpret_cast<const uint4*>(
                             ring + ((t - 1) & 1) * slot) +
                         (size_t)m * S * 32 + wl;
        const uint32_t* Bp = slice + g * rs + tg;
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
        int s = s0;
        for (; s + kFwdUnroll <= s1; s += kFwdUnroll) {
          uint4 a[kFwdUnroll];
#pragma unroll
          for (int u = 0; u < kFwdUnroll; ++u)
            a[u] = __ldcg(A + (size_t)(s + u) * 32);
#pragma unroll
          for (int u = 0; u < kFwdUnroll; ++u)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const uint32_t* bp = Bp + nt * kResUnits * rs + (s + u) * 8;
              mma_bf16(acc[nt], a[u].x, a[u].y, a[u].z, a[u].w, bp[0],
                       bp[4]);
            }
        }
        for (; s < s1; ++s) {
          const uint4 a = __ldcg(A + (size_t)s * 32);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t* bp = Bp + nt * kResUnits * rs + s * 8;
            mma_bf16(acc[nt], a.x, a.y, a.z, a.w, bp[0], bp[4]);
          }
        }
        float* out = part + (kh * mtiles + m) * 16 * kGateStride;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = nt * kResUnits + 2 * tg;
          out[g * kGateStride + n] = acc[nt][0];
          out[g * kGateStride + n + 1] = acc[nt][1];
          out[(g + 8) * kGateStride + n] = acc[nt][2];
          out[(g + 8) * kGateStride + n + 1] = acc[nt][3];
        }
      }
      __syncthreads();
    }
    __nv_bfloat16* wr = ring + (t & 1) * slot;
#pragma unroll
    for (int r = 0; r < kResRows; ++r) {
      const int row = lane + r * kResLanes;
      const bool live = row < b && j < H;
      float h = 0.f;
      if (live) {
        float z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float acc = 0.f;
          if (t > 0)
            for (int kh = 0; kh < ksplit; ++kh)
              acc += part[((kh * mtiles + row / 16) * 16 + row % 16) *
                              kGateStride + q * kResUnits + unit];
          z[q] = xg[r][q] + acc;
        }
        const float i = sigmoid(z[0]), f = sigmoid(z[1]);
        const float gg = tanhf(z[2]), o = sigmoid(z[3]);
        c[r] = f * c[r] + i * gg;
        h = o * tanhf(c[r]);
        const size_t idx = (size_t)row * H + j;
        ys[t * bh + idx] = h;
        if (cs) cs[t * bh + idx] = c[r];
      }
      // h[t] rounded once into the ring: the even unit of each pair
      // writes both halves of their 32-bit word
      const float h1 = __shfl_down_sync(0xffffffffu, h, 1);
      if (live && t + 1 < T && (unit & 1) == 0)
        *reinterpret_cast<__nv_bfloat162*>(wr + ring_index(row, j, S)) =
            __floats2bfloat162_rn(h, h1);
    }
    if (t + 1 < T) {
      load_x(t + 1);
      grid.sync();
    }
  }
}

// `steps` grid-wide barriers and nothing else: the resident route's
// serial phase with its work taken out.
__global__ void __launch_bounds__(kResThreads, 1)
lstm_barrier_kernel(int steps) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < steps; ++s) grid.sync();
}

// A refused launch (a grid the card cannot hold at once) never ran; its
// error is returned to the wrapper, which raises, and cleared from the
// runtime's last error so that the next launch of another kernel, ours
// or PyTorch's, does not report it as its own.
int refused_or_ok(cudaError_t err) {
  if (err != cudaSuccess) (void)cudaGetLastError();
  return (int)err;
}

template <typename W>
int launch_fwd(const void* xproj, const void* wh, void* ys, void* cs,
               void* cbuf, int T, int b, int H, int grid, void* stream) {
  const float* xp = (const float*)xproj;
  const W* w = (const W*)wh;
  float *y = (float*)ys, *c = (float*)cs, *cb = (float*)cbuf;
  void* args[] = {&xp, &w, &y, &c, &cb, &T, &b, &H};
  return refused_or_ok(cudaLaunchCooperativeKernel(
      (const void*)lstm_fwd_kernel<W>, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream));
}

template <typename W>
int launch_bwd(const void* xproj, const void* wh, const void* ys,
               const void* cs, const void* dys, void* dzs, void* dcbuf, int T,
               int b, int H, int grid, void* stream) {
  const float* xp = (const float*)xproj;
  const W* w = (const W*)wh;
  const float *y = (const float*)ys, *c = (const float*)cs,
              *dy = (const float*)dys;
  float *dz = (float*)dzs, *dcb = (float*)dcbuf;
  void* args[] = {&xp, &w, &y, &c, &dy, &dz, &dcb, &T, &b, &H};
  return refused_or_ok(cudaLaunchCooperativeKernel(
      (const void*)lstm_bwd_kernel<W>, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream));
}

// The kernel a capacity query is for: 0 the streaming forward, 1 the
// streaming backward, 2 the resident backward, 3 the resident forward
// (the resident ones bf16 only); 4, for allow_smem only, the wgmma gate
// GEMM.
const void* kernel_of(int kernel, int wh_bf16) {
  if (kernel == 0)
    return wh_bf16 ? (const void*)lstm_fwd_kernel<__nv_bfloat16>
                   : (const void*)lstm_fwd_kernel<float>;
  if (kernel == 1)
    return wh_bf16 ? (const void*)lstm_bwd_kernel<__nv_bfloat16>
                   : (const void*)lstm_bwd_kernel<float>;
  if (kernel == 2) return (const void*)lstm_bwd_resident_kernel;
  if (kernel == 4) return (const void*)lstm_gates_wgmma_kernel;
  return (const void*)lstm_fwd_resident_kernel;
}

// Dynamic shared memory of a resident kernel (2 or 3) at hidden size H.
size_t smem_of(int kernel, int H) {
  return kernel == 2 ? resident_smem(H)
                     : kernel == 3 ? fwd_resident_smem(H) : 0;
}

// Lets kernel 2, 3 or 4 take `smem` bytes of dynamic shared memory
// (above 48 KB only after this call); set once per device and kernel for
// the largest size asked.
cudaError_t allow_smem(int kernel, size_t smem) {
  static size_t allowed[5][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  size_t* done = dev < 64 ? &allowed[kernel][dev] : nullptr;
  if (done && smem <= *done) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_of(kernel, 1),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && done) *done = smem;
  return err;
}

// The wgmma route's tensor maps, each in 128-byte swizzled boxes: ys
// (M rows of H fp32, boxes of kWgARows rows × 32), wh (H rows of 4H bf16,
// kWgBK rows × 64), xproj and the gates (M rows of 4H fp32, 128 rows ×
// 32). 0, or a
// CUDA error code where CUDA has no encoder or refuses a map (a
// base not 16-byte aligned, a row stride not a multiple of 16 bytes).
int gates_maps(CUtensorMap (&maps)[4], const void* ys, const void* wh,
               const void* xproj, const void* gates, int M, int H) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t N = 4ull * (cuuint64_t)H;
  struct Map {
    const void* base;
    CUtensorMapDataType type;
    cuuint64_t cols, rows, bytes;
    cuuint32_t box_cols, box_rows;
  };
  const Map spec[4] = {
      {ys, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint64_t)H, (cuuint64_t)M, 4,
       32, kWgARows},
      {wh, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, (cuuint64_t)H, 2, 64, kWgBK},
      {xproj, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N, (cuuint64_t)M, 4, 32,
       128},
      {gates, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, N, (cuuint64_t)M, 4, 32,
       128}};
  const cuuint32_t step[2] = {1, 1};
  for (int i = 0; i < 4; ++i) {
    const Map& m = spec[i];
    const cuuint64_t dims[2] = {m.cols, m.rows};
    const cuuint64_t strides[1] = {m.cols * m.bytes};
    const cuuint32_t box[2] = {m.box_cols, m.box_rows};
    if (encode(&maps[i], m.type, 2, const_cast<void*>(m.base), dims, strides,
               box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// Hidden units a block owns per group: a call runs ceil(H / units)
// groups over its grid (both routes).
int ff_lstm_units() { return kUnits; }

// The largest batch the resident route takes (kResRows rows a thread).
int ff_lstm_resident_max_b() { return kResMaxB; }

// Dynamic shared memory of the resident route at hidden size H: the wh
// slice and the partial carries.
long long ff_lstm_resident_smem(int H) { return (long long)resident_smem(H); }

// Dynamic shared memory of the resident forward at hidden size H: the
// 32 columns of wh and the partial gate tiles.
long long ff_lstm_fwd_resident_smem(int H) {
  return (long long)fwd_resident_smem(H);
}

// How many blocks of a kernel (see kernel_of; H sizes the resident
// kernel's shared memory) can be resident at once on the current device:
// *blocks_per_sm on each of *sms multiprocessors. *cooperative is 0 when
// the device cannot take a cooperative launch. Returns a CUDA error code
// (the resident kernel's shared memory above the card's limit is one).
int ff_lstm_capacity(int kernel, int wh_bf16, int H, int* blocks_per_sm,
                     int* sms, int* cooperative) {
  int dev = 0;
  const bool resident = kernel >= 2;
  const size_t smem = smem_of(kernel, H);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch,
                                 dev);
  if (err == cudaSuccess && resident) err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel_of(kernel, wh_bf16),
        resident ? kResThreads : kThreads, smem);
  return refused_or_ok(err);
}

// xproj (T, b, 4H) fp32; wh (H, 4H) bf16 (wh_bf16 = 1) or fp32; ys
// (T, b, H) fp32 out; cs (T, b, H) fp32 out, or null when no gradient
// will be taken; cbuf (b, H) fp32 scratch. One cooperative launch of
// `grid` blocks on `stream`; returns its error code (the launch is
// refused when the grid cannot be co-resident).
int ff_lstm_fwd(const void* xproj, const void* wh, int wh_bf16, void* ys,
                void* cs, void* cbuf, int T, int b, int H, int grid,
                void* stream) {
  if (T <= 0 || b <= 0) return 0;
  return wh_bf16 ? launch_fwd<__nv_bfloat16>(xproj, wh, ys, cs, cbuf, T, b,
                                             H, grid, stream)
                 : launch_fwd<float>(xproj, wh, ys, cs, cbuf, T, b, H, grid,
                                     stream);
}

// The resident forward (bf16 wh): ys, cs as ff_lstm_fwd; ring: 2 ×
// ceil(b/16)·16 × H padded to 16 bf16 scratch, ZEROED (its padding is
// read). One cooperative launch of `grid` >= ceil(H / units) blocks,
// b <= ff_lstm_resident_max_b(); returns its error code.
int ff_lstm_fwd_resident(const void* xproj, const void* wh, void* ys,
                         void* cs, void* ring, int T, int b, int H, int grid,
                         void* stream) {
  if (T <= 0 || b <= 0) return 0;
  if (b > kResMaxB) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_resident_smem(H);
  cudaError_t err = allow_smem(3, smem);
  if (err != cudaSuccess) return refused_or_ok(err);
  const float* xp = (const float*)xproj;
  const __nv_bfloat16* w = (const __nv_bfloat16*)wh;
  float *y = (float*)ys, *c = (float*)cs;
  __nv_bfloat16* rg = (__nv_bfloat16*)ring;
  void* args[] = {&xp, &w, &y, &c, &rg, &T, &b, &H};
  return refused_or_ok(cudaLaunchCooperativeKernel(
      (const void*)lstm_fwd_resident_kernel, dim3(grid), dim3(kResThreads),
      args, smem, (cudaStream_t)stream));
}

// The streaming backward. ys, cs: the forward's outputs; dys (T, b, H)
// fp32; dzs (T, b, 4H) fp32 out, the gate cotangents; dcbuf (b, H) fp32
// scratch. As ff_lstm_fwd.
int ff_lstm_bwd(const void* xproj, const void* wh, int wh_bf16,
                const void* ys, const void* cs, const void* dys, void* dzs,
                void* dcbuf, int T, int b, int H, int grid, void* stream) {
  if (T <= 0 || b <= 0) return 0;
  return wh_bf16 ? launch_bwd<__nv_bfloat16>(xproj, wh, ys, cs, dys, dzs,
                                             dcbuf, T, b, H, grid, stream)
                 : launch_bwd<float>(xproj, wh, ys, cs, dys, dzs, dcbuf, T,
                                     b, H, grid, stream);
}

// The resident route's gate phase on the "mma" route: gates (T, b, 4H)
// fp32 out, from xproj (T, b, 4H) fp32, wh (H, 4H) bf16 and ys (T, b, H)
// fp32. One ordinary launch of lstm_gates_kernel on `stream`; returns
// cudaGetLastError().
int ff_lstm_gates(const void* xproj, const void* wh, const void* ys,
                  void* gates, int T, int b, int H, void* stream) {
  if (T <= 0 || b <= 0) return 0;
  const int M = T * b;
  const dim3 grid((4 * H + kGateBN - 1) / kGateBN,
                  (M + kGateBM - 1) / kGateBM);
  lstm_gates_kernel<<<grid, kGateThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xproj, (const __nv_bfloat16*)wh, (const float*)ys,
      (float*)gates, M, b, H);
  return (int)cudaGetLastError();
}

// The gate phase's route at hidden size H: 1 for "wgmma"
// (ff_lstm_gates_wgmma), where TMA can describe ys, whose rows of H fp32
// must be a multiple of 16 bytes apart; 0 for "mma" (ff_lstm_gates).
int ff_lstm_gates_route(int H) { return H % 4 == 0; }

// The gate phase on the "wgmma" route: as ff_lstm_gates, by
// lstm_gates_wgmma_kernel in clusters of kWgCS CTAs, as many as the card
// holds at once and at most the supertiles. Returns a CUDA error code:
// the launch's, or cudaErrorInvalidValue for an H of the "mma" route or a
// tensor map CUDA refuses.
int ff_lstm_gates_wgmma(const void* xproj, const void* wh, const void* ys,
                        void* gates, int T, int b, int H, void* stream) {
  if (T <= 0 || b <= 0) return 0;
  if (!ff_lstm_gates_route(H)) return (int)cudaErrorInvalidValue;
  const int M = T * b;
  CUtensorMap maps[4];
  const int bad = gates_maps(maps, ys, wh, xproj, gates, M, H);
  if (bad) return bad;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWgCS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kWgCS);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kWgSmem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the clusters the card holds at once, once per device
  static int resident[64] = {};
  int dev = 0, clusters = 0;
  cudaError_t err = allow_smem(4, kWgSmem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    clusters = dev < 64 ? resident[dev] : 0;
    if (clusters == 0) {
      err = cudaOccupancyMaxActiveClusters(
          &clusters, (void*)lstm_gates_wgmma_kernel, &cfg);
      if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidValue;
      if (err == cudaSuccess && dev < 64) resident[dev] = clusters;
    }
  }
  if (err != cudaSuccess) return refused_or_ok(err);
  const long long tiles =
      (long long)(((M + kWgBM - 1) / kWgBM + kWgCM - 1) / kWgCM) *
      (((4 * H + kWgBN - 1) / kWgBN + kWgCN - 1) / kWgCN);
  cfg.gridDim = dim3(kWgCS * (int)(tiles < clusters ? tiles : clusters));
  return refused_or_ok(cudaLaunchKernelEx(&cfg, lstm_gates_wgmma_kernel,
                                          maps[0], maps[1], maps[2], maps[3],
                                          M, b, H));
}

// The resident route's serial phase: dzs (T, b, 4H) fp32 out from the
// gate pre-activations (ff_lstm_gates), wh (H, 4H) bf16, cs and dys
// (T, b, H) fp32; ring: 2 × ceil(b/16)·16 × padded 4H bf16 scratch,
// ZEROED (its padding is read). One cooperative launch of `grid` >=
// ceil(H / units) blocks, b <= ff_lstm_resident_max_b(); returns its
// error code.
int ff_lstm_bwd_resident(const void* gates, const void* wh, const void* cs,
                         const void* dys, void* dzs, void* ring, int T,
                         int b, int H, int grid, void* stream) {
  if (T <= 0 || b <= 0) return 0;
  if (b > kResMaxB) return (int)cudaErrorInvalidValue;
  const size_t smem = resident_smem(H);
  cudaError_t err = allow_smem(2, smem);
  if (err != cudaSuccess) return refused_or_ok(err);
  const float* g = (const float*)gates;
  const __nv_bfloat16* w = (const __nv_bfloat16*)wh;
  const float *c = (const float*)cs, *dy = (const float*)dys;
  float* dz = (float*)dzs;
  __nv_bfloat16* rg = (__nv_bfloat16*)ring;
  void* args[] = {&g, &w, &c, &dy, &dz, &rg, &T, &b, &H};
  return refused_or_ok(cudaLaunchCooperativeKernel(
      (const void*)lstm_bwd_resident_kernel, dim3(grid), dim3(kResThreads),
      args, smem, (cudaStream_t)stream));
}

// `steps` grid-wide barriers over `grid` blocks of the resident kernel's
// size, nothing else: one cooperative launch; returns its error code.
int ff_lstm_barrier(int steps, int grid, void* stream) {
  void* args[] = {&steps};
  return refused_or_ok(cudaLaunchCooperativeKernel(
      (const void*)lstm_barrier_kernel, dim3(grid), dim3(kResThreads), args,
      0, (cudaStream_t)stream));
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
