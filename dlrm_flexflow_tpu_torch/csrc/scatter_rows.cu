// Touched-rows scatter updates for Hopper (sm_90a): one source, two
// kernels.
//
// Replaces two Pallas TPU kernels of
// dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:
//   _scatter_unique_kernel (:289, behind scatter_add_rows and
//     _dedup_and_scatter): read-modify-write, table[row] += sum;
//   _scatter_write_kernel (:495, behind scatter_write_rows_packed):
//     write-only, table[row] = fwd_row + sum, where fwd_row is the value
//     the forward pass gathered for that row.
//
// Both apply n per-lookup updates to a (rows, dim) table. Lookup j
// targets row ids[j] and carries update row upd[j / div] (div > 1 lets a
// bag of `div` lookups share one cotangent row without repeating it in
// memory). Each update is scaled BEFORE the sum, as the JAX update
// computes -lr * upd and then segment-sums:
//   sum(row) = sum over lookups j with ids[j] == row, in ascending j, of
//              scale * upd[j / div], starting from 0.
//
// The TPU kernels rely on an XLA pre-pass (_dedup_tile_updates: argsort,
// segment_sum, segment_max) to make every target distinct. Here the
// wrapper only sorts the ids stably (torch.sort); the kernel finds the
// segments itself: the thread group at sorted position k owns the
// segment if k is its first position, and walks forward while the id
// stays the same. One owner per distinct row, so no atomics, the sum
// order is the sorted (= original, the sort being stable) order of the
// JAX pre-pass, and the result is deterministic. The multiply and the
// adds use __fmul_rn/__fadd_rn so nvcc cannot contract them into an FMA
// that would round differently from the reference.
//
// Bound: memory. The kernels read the sorted ids and the order (16 B a
// lookup), the updates (n/div rows), one table row (read-modify-write)
// or one forward row (write-only) per distinct row, and write one row
// per distinct row: at the training shape (n = 2,048 lookups, d = 64)
// about 1.6 MB, 0.5 us at 3.35 TB/s, so one launch is launch-bound.
//
// Design: one thread per 16-byte column chunk of a sorted position, as
// the bag kernel; d/4 neighbouring threads cover a 256-byte row at
// d = 64, so every row read and write is a run of float4s on
// neighbouring addresses. Threads of non-head positions exit at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(float4* __restrict__ table,
                    const int64_t* __restrict__ sorted_ids,
                    const int64_t* __restrict__ order,
                    const float4* __restrict__ upd,
                    const float4* __restrict__ fwd,
                    int64_t n, int vec, int div, float scale) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n * vec) return;
  const int64_t k = g / vec;
  const int c = (int)(g - k * vec);
  const int64_t row = sorted_ids[k];
  if (k > 0 && sorted_ids[k - 1] == row) return;   // not a segment head
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t j = k;
  do {
    const float4 u = __ldg(upd + (order[j] / div) * vec + c);
    acc.x = __fadd_rn(acc.x, __fmul_rn(scale, u.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(scale, u.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(scale, u.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(scale, u.w));
    ++j;
  } while (j < n && sorted_ids[j] == row);
  // write-only: any duplicate's forward row holds the same pre-update
  // value, so the head's stands for the segment
  const float4 base = fwd ? __ldg(fwd + order[k] * vec + c)
                          : table[row * vec + c];
  table[row * vec + c] = make_float4(
      __fadd_rn(base.x, acc.x), __fadd_rn(base.y, acc.y),
      __fadd_rn(base.z, acc.z), __fadd_rn(base.w, acc.w));
}

int launch(void* table, const void* sorted_ids, const void* order,
           const void* upd, const void* fwd, long long n, int dim, int div,
           float scale, void* stream) {
  if (n <= 0) return 0;
  const int vec = dim / 4;
  const long long blocks = (n * vec + kThreads - 1) / kThreads;
  scatter_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (float4*)table, (const int64_t*)sorted_ids, (const int64_t*)order,
      (const float4*)upd, (const float4*)fwd, n, vec, div, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: (rows, dim) fp32, updated in place; sorted_ids, order: (n,)
// int64 from a stable sort of the lookups' row ids (sorted_ids =
// ids[order]); upd: (n / div, dim) fp32. dim % 4 == 0 and 16-byte
// aligned pointers (the wrapper checks). Launches on `stream`; returns
// cudaGetLastError().
int ff_scatter_add_rows(void* table, const void* sorted_ids,
                        const void* order, const void* upd, long long n,
                        int dim, int div, float scale, void* stream) {
  return launch(table, sorted_ids, order, upd, nullptr, n, dim, div, scale,
                stream);
}

// As ff_scatter_add_rows, but writes fwd[order[k]] + sum without reading
// the table; fwd: (n, dim) fp32, the row each lookup read in the forward.
int ff_scatter_write_rows(void* table, const void* sorted_ids,
                          const void* order, const void* upd,
                          const void* fwd, long long n, int dim, int div,
                          float scale, void* stream) {
  return launch(table, sorted_ids, order, upd, fwd, n, dim, div, scale,
                stream);
}

const char* ff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
