// The optimizer's row math, shared by the touched-rows update
// (scatter_rows.cu, stateful_rows_kernel and stateful_fused_kernel) and
// the dense update (dense_update.cu): both compile this one function, so
// a dense parameter and a table row take the same roundings.
//
// It repeats row_update_reference (ops/kernels/scatter_rows.py), the
// JAX optimizers' operation order, one rounding an operation: every
// multiply, add, quotient and square root is an __f*_rn intrinsic, which
// nvcc never contracts into an FMA and which rounds to nearest even as
// the plain version's separate PyTorch ops do.

#pragma once

#include <cuda_runtime.h>

// The optimizer's hyperparameters, fp32 as JAX's weak-typed Python
// floats round them (c1 = 1 - beta1 and c2 = 1 - beta2 computed in
// double first); momentum and wd are 0 where the optimizer has none.
struct OptParams {
  int adam, nesterov;
  float wd, lr, momentum, b1, c1, b2, c2, eps;
};

// One lane: w and the state s0, s1 updated in place from the gradient
// g (a touched row's summed gradient, or a dense parameter's):
//   gt = g + wd*w
//   SGD:  v = m*v + gt; d = gt + m*v (nesterov) | v | gt; w = w - lr*d
//   Adam: m = b1*m + c1*gt; v = b2*v + (c2*gt)*gt;
//         w = w - (alpha_t*m) / (sqrt(v) + eps)
// s0 is momentum's v or Adam's m, s1 Adam's v; a lane without state
// passes dummies, which SGD without momentum leaves alone.
__device__ __forceinline__ void update_lane(float& w, float g, float& s0,
                                            float& s1, const OptParams& p,
                                            float alpha_t) {
  const float gt = p.wd > 0.f ? __fadd_rn(g, __fmul_rn(p.wd, w)) : g;
  if (p.adam) {
    s0 = __fadd_rn(__fmul_rn(p.b1, s0), __fmul_rn(p.c1, gt));
    s1 = __fadd_rn(__fmul_rn(p.b2, s1), __fmul_rn(__fmul_rn(p.c2, gt), gt));
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(alpha_t, s0),
                               __fadd_rn(__fsqrt_rn(s1), p.eps)));
    return;
  }
  float d = gt;
  if (p.momentum > 0.f) {
    s0 = __fadd_rn(__fmul_rn(p.momentum, s0), gt);
    d = p.nesterov ? __fadd_rn(gt, __fmul_rn(p.momentum, s0)) : s0;
  }
  w = __fsub_rn(w, __fmul_rn(p.lr, d));
}

// update_lane on the four lanes of a 16-byte chunk.
__device__ __forceinline__ void update_chunk(float4& w, const float4 g,
                                             float4& s0, float4& s1,
                                             const OptParams& p,
                                             float alpha_t) {
  update_lane(w.x, g.x, s0.x, s1.x, p, alpha_t);
  update_lane(w.y, g.y, s0.y, s1.y, p, alpha_t);
  update_lane(w.z, g.z, s0.z, s1.z, p, alpha_t);
  update_lane(w.w, g.w, s0.w, s1.w, p, alpha_t);
}
