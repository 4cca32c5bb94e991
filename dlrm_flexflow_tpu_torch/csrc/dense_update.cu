// The optimizer's dense update for Hopper (sm_90a): every dense
// parameter of a step, with its gradient and state slabs, in one
// multi-tensor launch; and the anomaly sentinel's gradient norm over
// every gradient of a step, in one multi-tensor launch on the same
// launch plan (grad_sumsq_kernel, at the end of this comment).
//
// Replaces no Pallas kernel: in the JAX package XLA fuses the dense
// update (dlrm_flexflow_tpu/core/optimizers.py:93-114 SGD, :167-185
// Adam) into one pass over each parameter. The port ran it as eager
// PyTorch ops, two to twelve elementwise launches a tensor, each
// streaming whole tensors through device memory; here each element of w,
// g and the slabs is read once and w and the slabs written once. The
// arithmetic is row_math.cuh's update_lane, which the touched-rows
// kernels share, so the result is bitwise that of row_update_reference
// (ops/kernels/scatter_rows.py) on every tensor.
//
// Bound: memory. An element moves 12 B under SGD (w, g read, w
// written; weight decay reads the same), 20 B with momentum (v read and
// written), 28 B under Adam (m and v). The "dot" DLRM table alone is
// 512,000,000 elements (1.9 GiB) and a tensor may pass 2^31 bytes, so
// offsets are 64-bit throughout.
//
// Design. The host builds a launch plan (launch_plan in
// ops/kernels/dense_update.py, a pure function of the sizes and
// addresses): each tensor a descriptor with its pointers, its element
// count n, the float4 span [head, head + 4 * nvec) where w, g and every
// slab are 16-byte aligned at the same offset (nvec = 0 where they are
// not: a misaligned view runs scalar), and its first tile. A tensor's
// tiles are ceil(nvec / kTileVecs) vector tiles, kUnroll float4s a
// thread, then ceil(scalars / kThreads) scalar tiles for the elements
// outside the span (the head and tail of an aligned tensor, at most 6;
// all of a misaligned one); scalar s is element s, or s + 4 * nvec past
// the head. The descriptors travel BY VALUE as a __grid_constant__
// kernel argument (gradients are fresh tensors every step, so nothing
// on the device could be cached), at most kMaxTensors a launch within
// the 4 KB argument limit; the host splits a longer list into more
// launches. A persistent grid of the blocks the card holds at once
// strides over the tiles; a block finds its tile's tensor by walking
// the descriptors forward. The streams are read once, so loads and
// stores are streaming (__ldcs/__stcs: evict first, no reuse expected),
// and every thread issues all its loads before any arithmetic.
//
// The guard. The anomaly sentinel suppresses a non-finite step: the JAX
// package keeps the pre-step values with jnp.where(step_ok, new, old)
// inside its donated step (dlrm_flexflow_tpu/core/model.py:1111-1135);
// the port updates in place, and a copy of the old values would cost
// the "dot" table and its Adam state once more (5.7 GiB). So the update
// takes the flag: with a non-null `ok` every block reads the int32 at
// *ok first and returns before any load or store when it is 0.
//
// The gradient norm (grad_sumsq_kernel). The JAX step computes gsq, the
// fp32 sum of every gradient's squares (the dense gradients and the
// lookups' cotangents), its square root, and ok = isfinite(loss) &
// isfinite(norm), in XLA (core/model.py:1120-1123), not in Pallas. Here
// one launch reads each gradient once, on the dense update's launch
// plan (only the g pointers set): every tile writes the sum of its
// squares to partials[tile_base + tile], a block's tree in a fixed
// order, and the last block to finish (a counter the launch resets)
// adds the partials in a fixed order and writes gsq, the norm and the
// int32 ok. A tile's partial does not depend on which block ran it, so
// the result does not depend on the grid: a rerun gives the same bits.
// Bound: the gradients' bytes, read once (the "dot" step's 8M x 64
// table gradient, 2.06 GB, 0.615 ms at 3.35 TB/s).
//
// Across ranks the norm takes two launches a step. The first runs over
// what each rank holds of its own (its rows' cotangents, its pieces of
// the split parameters) and writes only its sum, into a slot of the
// buffer the dense gradients are all-reduced in; the second runs over
// the all-reduced (replicated) gradients and adds the all-reduced slot
// (`addend`) before the square root, so every rank computes the same
// gsq, norm and flag. One rank alone passes no addend: one launch, the
// same bits as before.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "row_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                       // float4s a thread a tile
constexpr int kTileVecs = kThreads * kUnroll;    // float4s a vector tile
constexpr int kMaxTensors = 48;

// One tensor of a launch. s0 is momentum's v or Adam's m, s1 Adam's v;
// null where the optimizer has fewer slabs. 64 bytes, all 8-byte fields
// (the host mirrors the layout with ctypes).
struct TensorDesc {
  float* w;
  const float* g;
  float* s0;
  float* s1;
  long long head, nvec, n, tile0;
};

struct DenseArgs {
  TensorDesc t[kMaxTensors];
  int ntensors;
  long long tiles;
};
static_assert(sizeof(DenseArgs) + sizeof(OptParams) + sizeof(void*) <= 4096,
              "kernel arguments exceed 4 KB");

template <int kSlabs>
__device__ __forceinline__ void vector_tile(const TensorDesc& d, long long k,
                                            const OptParams& p, float at) {
  float4* w = reinterpret_cast<float4*>(d.w + d.head);
  const float4* g = reinterpret_cast<const float4*>(d.g + d.head);
  float4* s0 = kSlabs > 0 ? reinterpret_cast<float4*>(d.s0 + d.head)
                          : nullptr;
  float4* s1 = kSlabs > 1 ? reinterpret_cast<float4*>(d.s1 + d.head)
                          : nullptr;
  const long long j0 = k * kTileVecs + threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 wv[kUnroll], gv[kUnroll], s0v[kUnroll], s1v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = j0 + (long long)u * kThreads;
    s0v[u] = s1v[u] = zero;
    if (j < d.nvec) {
      wv[u] = __ldcs(w + j);
      gv[u] = __ldcs(g + j);
      if (kSlabs > 0) s0v[u] = __ldcs(s0 + j);
      if (kSlabs > 1) s1v[u] = __ldcs(s1 + j);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = j0 + (long long)u * kThreads;
    if (j < d.nvec) {
      update_chunk(wv[u], gv[u], s0v[u], s1v[u], p, at);
      __stcs(w + j, wv[u]);
      if (kSlabs > 0) __stcs(s0 + j, s0v[u]);
      if (kSlabs > 1) __stcs(s1 + j, s1v[u]);
    }
  }
}

template <int kSlabs>
__device__ __forceinline__ void scalar_tile(const TensorDesc& d, long long k,
                                            const OptParams& p, float at) {
  const long long s = k * kThreads + threadIdx.x;
  if (s >= d.n - 4 * d.nvec) return;
  const long long e = s < d.head ? s : s + 4 * d.nvec;
  float w = __ldcs(d.w + e);
  const float g = __ldcs(d.g + e);
  float s0 = kSlabs > 0 ? __ldcs(d.s0 + e) : 0.f;
  float s1 = kSlabs > 1 ? __ldcs(d.s1 + e) : 0.f;
  update_lane(w, g, s0, s1, p, at);
  __stcs(d.w + e, w);
  if (kSlabs > 0) __stcs(d.s0 + e, s0);
  if (kSlabs > 1) __stcs(d.s1 + e, s1);
}

template <int kSlabs>
__global__ void __launch_bounds__(kThreads)
dense_update_kernel(const __grid_constant__ DenseArgs a,
                    const float* __restrict__ alpha_t, const OptParams p,
                    const int* __restrict__ ok) {
  if (ok && __ldg(ok) == 0) return;       // the sentinel skips this step
  const float at = alpha_t ? __ldg(alpha_t) : 0.f;
  int i = 0;
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    while (i + 1 < a.ntensors && t >= a.t[i + 1].tile0) ++i;
    const TensorDesc& d = a.t[i];
    const long long k = t - d.tile0;
    const long long vtiles = (d.nvec + kTileVecs - 1) / kTileVecs;
    if (k < vtiles)
      vector_tile<kSlabs>(d, k, p, at);
    else
      scalar_tile<kSlabs>(d, k - vtiles, p, at);
  }
}

// The sum of v over the block, in a fixed order (each warp's shuffle
// tree, then the warps' sums by warp 0's); valid in thread 0. red: the
// block's kThreads / 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  __syncthreads();                        // red may be written again
  return s;
}

// The sum of the squares of a tile's elements in this thread: a vector
// tile's kUnroll float4s (all loads first) or a scalar tile's one.
__device__ __forceinline__ float tile_squares(const TensorDesc& d,
                                              long long k) {
  const long long vtiles = (d.nvec + kTileVecs - 1) / kTileVecs;
  float acc = 0.f;
  if (k < vtiles) {
    const float4* g = reinterpret_cast<const float4*>(d.g + d.head);
    const long long j0 = k * kTileVecs + threadIdx.x;
    float4 gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + (long long)u * kThreads;
      gv[u] = j < d.nvec ? __ldcs(g + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc += gv[u].x * gv[u].x + gv[u].y * gv[u].y + gv[u].z * gv[u].z +
             gv[u].w * gv[u].w;
  } else {
    const long long s = (k - vtiles) * kThreads + threadIdx.x;
    if (s < d.n - 4 * d.nvec) {
      const float v = __ldcs(d.g + (s < d.head ? s : s + 4 * d.nvec));
      acc = v * v;
    }
  }
  return acc;
}

// Each tile's sum of squares into partials[tile_base + tile]; with
// `is_final`, the last block to finish adds partials[0, total) in a fixed
// order, adds *addend when it is given (another launch's sum, summed over
// the ranks), and writes *out_gsq = gsq and, where given, *out_norm =
// sqrt(gsq) and the int32 *out_ok = isfinite(*loss) && isfinite(norm),
// then resets *counter.
__global__ void __launch_bounds__(kThreads)
grad_sumsq_kernel(const __grid_constant__ DenseArgs a,
                  float* __restrict__ partials, long long tile_base,
                  long long total, int is_final, unsigned* counter,
                  const float* __restrict__ loss,
                  const float* __restrict__ addend, float* out_gsq,
                  float* __restrict__ out_norm, int* __restrict__ out_ok) {
  __shared__ float red[kThreads / 32];
  __shared__ bool last;
  int i = 0;
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    while (i + 1 < a.ntensors && t >= a.t[i + 1].tile0) ++i;
    const TensorDesc& d = a.t[i];
    const float s = block_sum(tile_squares(d, t - d.tile0), red);
    if (threadIdx.x == 0) partials[tile_base + t] = s;
  }
  if (!is_final) return;
  __threadfence();                        // the partials, before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc = 0.f;
  for (long long t = threadIdx.x; t < total; t += kThreads)
    acc += __ldcg(partials + t);          // L2: other blocks wrote them
  const float own = block_sum(acc, red);
  if (threadIdx.x == 0) {
    const float gsq = addend ? own + *addend : own;
    const float norm = __fsqrt_rn(gsq);
    *out_gsq = gsq;
    if (out_norm) *out_norm = norm;
    if (out_ok) *out_ok = isfinite(*loss) && isfinite(norm) ? 1 : 0;
    *counter = 0u;                        // for the next launch
  }
}

template <int kSlabs>
const void* kernel_of() {
  return (const void*)dense_update_kernel<kSlabs>;
}

const void* kernel_for(int slabs) {
  return slabs == 0 ? kernel_of<0>() : slabs == 1 ? kernel_of<1>()
                                                  : kernel_of<2>();
}

// The blocks of kernel_for(slabs) one SM holds at once, per device.
int blocks_per_sm(int slabs, int* out) {
  static int cached[64][3] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev][slabs]) {
    *out = cached[dev][slabs];
    return 0;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel_for(slabs),
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) cached[dev][slabs] = *out;
  return 0;
}

}  // namespace

extern "C" {

int ff_dense_update_max_tensors() { return kMaxTensors; }
int ff_dense_update_tile_vecs() { return kTileVecs; }
int ff_dense_update_threads() { return kThreads; }

// The blocks a launch with `slabs` state slabs puts on each SM (its
// grid is that many times the SMs, or the tiles where fewer): writes
// *out; returns a CUDA error.
int ff_dense_update_blocks_per_sm(int slabs, int* out) {
  if (slabs < 0 || slabs > 2) return (int)cudaErrorInvalidValue;
  return blocks_per_sm(slabs, out);
}

// descs: `ntensors` <= kMaxTensors TensorDesc (host memory, copied into
// the kernel's argument), `tiles` their tiles; slabs: 0, 1 (momentum's
// v) or 2 (Adam's m, v); alpha_t: a device pointer to Adam's fp32 step
// size, null otherwise; adam 0 runs SGD (lr, momentum, nesterov, wd), 1
// Adam (wd, b1, c1, b2, c2, eps); ok: a device pointer to the sentinel's
// int32 flag (0: change nothing), or null. One launch on `stream`;
// returns cudaGetLastError().
int ff_dense_update(const void* descs, int ntensors, long long tiles,
                    int slabs, const void* alpha_t, int adam, int nesterov,
                    float wd, float lr, float momentum, float b1, float c1,
                    float b2, float c2, float eps, const void* ok,
                    void* stream) {
  if (ntensors <= 0 || tiles <= 0) return 0;
  if (ntensors > kMaxTensors || slabs < 0 || slabs > 2)
    return (int)cudaErrorInvalidValue;
  DenseArgs a{};
  memcpy(a.t, descs, ntensors * sizeof(TensorDesc));
  a.ntensors = ntensors;
  a.tiles = tiles;
  int per_sm = 0, dev = 0, sms = 0;
  int err = blocks_per_sm(slabs, &per_sm);
  if (err) return err;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long most = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  const OptParams p{adam, nesterov, wd, lr, momentum, b1, c1, b2, c2, eps};
  const float* at = (const float*)alpha_t;
  const int* flag = (const int*)ok;
  cudaStream_t s = (cudaStream_t)stream;
  if (slabs == 0)
    dense_update_kernel<0><<<grid, kThreads, 0, s>>>(a, at, p, flag);
  else if (slabs == 1)
    dense_update_kernel<1><<<grid, kThreads, 0, s>>>(a, at, p, flag);
  else
    dense_update_kernel<2><<<grid, kThreads, 0, s>>>(a, at, p, flag);
  return (int)cudaGetLastError();
}

// The blocks of grad_sumsq_kernel one SM holds at once: writes *out;
// returns a CUDA error.
int ff_grad_sumsq_blocks_per_sm(int* out) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev]) {
    *out = cached[dev];
    return 0;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, grad_sumsq_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) cached[dev] = *out;
  return 0;
}

// descs, ntensors, tiles: as ff_dense_update's, only the g pointers
// read (tiles may be 0: no gradient elements). Each tile's sum of
// squares goes to partials[tile_base + tile] (device fp32, `total`
// long); with `is_final` the launch then writes *gsq = the sum of
// partials[0, total) in a fixed order, plus *addend where addend is not
// null (device fp32: another launch's sum, all-reduced over the ranks),
// and, where not null, *norm = sqrt(*gsq) (device fp32) and *ok (device
// int32) = isfinite(*loss) && isfinite(*norm); counter: a device uint32
// that is 0 before the launch and after it. A list of more than
// kMaxTensors gradients takes several launches on one stream, `is_final`
// on the last. One launch on `stream`; returns cudaGetLastError().
int ff_grad_sumsq(const void* descs, int ntensors, long long tiles,
                  void* partials, long long tile_base, long long total,
                  int is_final, void* counter, const void* loss,
                  const void* addend, void* gsq, void* norm, void* ok,
                  void* stream) {
  if (ntensors < 0 || ntensors > kMaxTensors || tiles < 0 ||
      tile_base + tiles > total)
    return (int)cudaErrorInvalidValue;
  if (tiles == 0 && !is_final) return 0;
  DenseArgs a{};
  if (ntensors > 0) memcpy(a.t, descs, ntensors * sizeof(TensorDesc));
  a.ntensors = ntensors;
  a.tiles = tiles;
  int per_sm = 0, dev = 0, sms = 0;
  int err = ff_grad_sumsq_blocks_per_sm(&per_sm);
  if (err) return err;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long most = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(tiles < 1 ? 1 : tiles < most ? tiles
                                                                : most);
  grad_sumsq_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, (float*)partials, tile_base, total, is_final, (unsigned*)counter,
      (const float*)loss, (const float*)addend, (float*)gsq, (float*)norm,
      (int*)ok);
  return (int)cudaGetLastError();
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
