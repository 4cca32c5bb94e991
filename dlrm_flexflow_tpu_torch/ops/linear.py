"""Linear (Dense) operator with a fused activation.

The counterpart of ``dlrm_flexflow_tpu.ops.linear.Linear``:
y = act(x @ W + b). The JAX package leaves the product to XLA; here it
is ``torch.matmul`` (cuBLAS on the card). TF32 is switched off by
``FFModel`` so a float32 product stays float32.

Under ``compute_dtype="bfloat16"`` the layer gives what JAX's
``preferred_element_type=float32`` gives: the fp32 product of the
bf16-rounded operands. The operands are rounded to bf16 and upcast to
fp32, and the product is an fp32 matmul: the product of two bf16 values
is exact in fp32, so only the fp32 accumulation remains, as in JAX.
Then the bias is added in fp32, the activation applied, and the result
cast to the input's dtype. The backward comes from autograd.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.initializers import DEFAULT_BIAS_INIT, DEFAULT_KERNEL_INIT
from ..core.op import Op, ParamDef
from .common import AC_MODE_NONE, apply_activation


class Linear(Op):
    type_name = "Dense"

    def __init__(self, model, input_tensor, out_dim: int,
                 activation=AC_MODE_NONE, use_bias: bool = True,
                 kernel_initializer=None, bias_initializer=None,
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        if input_tensor.num_dims < 2:
            raise ValueError("Linear expects rank>=2 input (sample dim first)")
        self.in_dim = int(input_tensor.shape[-1])
        self.out_dim = int(out_dim)
        self.activation = activation
        self.use_bias = bool(use_bias)
        self.kernel_initializer = kernel_initializer or DEFAULT_KERNEL_INIT()
        self.bias_initializer = bias_initializer or DEFAULT_BIAS_INIT()
        out_shape = tuple(input_tensor.shape[:-1]) + (self.out_dim,)
        self.outputs = [self._make_output(out_shape)]

    def param_defs(self) -> Dict[str, ParamDef]:
        defs = {"kernel": ParamDef((self.in_dim, self.out_dim),
                                   torch.float32, self.kernel_initializer)}
        if self.use_bias:
            defs["bias"] = ParamDef((self.out_dim,), torch.float32,
                                    self.bias_initializer)
        return defs

    def apply(self, params, xs):
        (x,) = xs
        cdt = self.model.compute_dtype
        y = torch.matmul(x.to(cdt).float(), params["kernel"].to(cdt).float())
        if self.use_bias:
            y = y + params["bias"]
        return [apply_activation(y, self.activation).to(x.dtype)]
