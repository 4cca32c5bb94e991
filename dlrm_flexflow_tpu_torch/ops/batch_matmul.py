"""BatchMatmul (3-D), the unfused "dot" interaction's product (the
counterpart of ``dlrm_flexflow_tpu.ops.batch_matmul``).

The reference's default contraction computes C = Aᵀ·B over the layouts
(d, k, m) × (d, k, n) → (d, m, n); ``trans_a`` and ``trans_b`` say
which operand contracts over its middle dim. The JAX op computes the
product with ``lax.dot_general`` outside any Pallas kernel, so here it
is ``torch.bmm`` (cuBLAS on the card; ``FFModel`` switches TF32 off):
both operands rounded to ``compute_dtype`` and upcast to fp32, an fp32
product (a product of two bf16 values is exact in fp32, so only the
fp32 accumulation remains, as with ``preferred_element_type=float32``),
and the result cast to the first operand's dtype. Both gradients come
from autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.op import Op


class BatchMatmul(Op):
    type_name = "BatchMatmul"

    def __init__(self, model, a, b, trans_a: bool = True,
                 trans_b: bool = False, name: Optional[str] = None):
        """Default (trans_a=True, trans_b=False): a (d,k,m), b (d,k,n) ->
        out (d,m,n)."""
        super().__init__(model, [a, b], name)
        if a.num_dims != 3 or b.num_dims != 3:
            raise ValueError("BatchMatmul expects rank-3 inputs")
        if a.shape[0] != b.shape[0]:
            raise ValueError("batch dim mismatch")
        self.trans_a, self.trans_b = bool(trans_a), bool(trans_b)
        d = a.shape[0]
        m = a.shape[2] if trans_a else a.shape[1]
        ka = a.shape[1] if trans_a else a.shape[2]
        kb = b.shape[2] if trans_b else b.shape[1]
        n = b.shape[1] if trans_b else b.shape[2]
        if ka != kb:
            raise ValueError(f"contraction dim mismatch {ka} vs {kb}")
        self.m, self.n, self.k = m, n, ka
        self.outputs = [self._make_output((d, m, n))]

    def apply(self, params, xs):
        a, b = xs
        cdt = self.model.compute_dtype
        x = a.to(cdt).float()
        y = b.to(cdt).float()
        if self.trans_a:
            x = x.transpose(1, 2)
        if self.trans_b:
            y = y.transpose(1, 2)
        return [torch.bmm(x, y).to(a.dtype)]
