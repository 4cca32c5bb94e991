// LSTM forward and backward scans for Hopper (sm_90a): one source, two
// kernels.
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
// recompute and dz @ whᵀ) over 124 MB. The serial dependence is the
// real limit: each step's product needs the whole previous h (or dz),
// so a step cannot start before every part of the last one is done.
//
// Design (a first version, right before fast): ONE cooperative launch
// per call, the time loop inside the kernel and a grid-wide barrier
// (cooperative_groups grid.sync) between steps, instead of the TPU's
// sequential grid of T steps. A block owns groups of kUnits hidden units
// j and all four gate columns of each (j, H+j, 2H+j, 3H+j), so the cell
// update, the c carry and the dc carry stay with the thread that computes
// them, in a (b, H) fp32 scratch that only that thread touches. After
// the barrier a block reads the whole h_{t-1} (ys[t-1]) or, backward,
// the whole dz[t+1] from global memory (L2; __ldcg so no stale L1 line
// is read), staged in kChunk-wide slices through shared memory. wh is
// read from global memory each step: at 8 MB (bf16) or 16 MB (fp32) it
// stays in the 50 MB L2 across steps. The products are scalar fp32 FMAs
// with a 2 rows × 4 gates register tile per thread: no wgmma, no TMA,
// no shared-memory residency of wh yet. The wrapper sizes the grid to
// what the occupancy query says can be co-resident and raises if the
// cooperative launch is refused: there is no fallback.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

const void* kernel_of(int backward, int wh_bf16) {
  if (backward)
    return wh_bf16 ? (const void*)lstm_bwd_kernel<__nv_bfloat16>
                   : (const void*)lstm_bwd_kernel<float>;
  return wh_bf16 ? (const void*)lstm_fwd_kernel<__nv_bfloat16>
                 : (const void*)lstm_fwd_kernel<float>;
}

}  // namespace

extern "C" {

// Hidden units a block owns per group: a call runs ceil(H / units)
// groups over its grid.
int ff_lstm_units() { return kUnits; }

// How many blocks of the forward (backward = 0) or backward kernel can be
// resident at once on the current device: *blocks_per_sm on each of
// *sms multiprocessors. *cooperative is 0 when the device cannot take a
// cooperative launch. Returns a CUDA error code.
int ff_lstm_capacity(int backward, int wh_bf16, int* blocks_per_sm,
                     int* sms, int* cooperative) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch,
                                 dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel_of(backward, wh_bf16), kThreads, 0);
  return (int)err;
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

// ys, cs: the forward's outputs; dys (T, b, H) fp32; dzs (T, b, 4H) fp32
// out, the gate cotangents; dcbuf (b, H) fp32 scratch. As ff_lstm_fwd.
int ff_lstm_bwd(const void* xproj, const void* wh, int wh_bf16,
                const void* ys, const void* cs, const void* dys, void* dzs,
                void* dcbuf, int T, int b, int H, int grid, void* stream) {
  if (T <= 0 || b <= 0) return 0;
  return wh_bf16 ? launch_bwd<__nv_bfloat16>(xproj, wh, ys, cs, dys, dzs,
                                             dcbuf, T, b, H, grid, stream)
                 : launch_bwd<float>(xproj, wh, ys, cs, dys, dzs, dcbuf, T,
                                     b, H, grid, stream);
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
