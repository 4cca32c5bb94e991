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

Split by channel across ranks (the JAX op's ``param_axes``, the
reference's linear.cu:188-293; ``_split``, a ``parallel.split.OpSplit``
of kind "channel" bound by compile): rank k, block c its index over the
mesh axes of the output's channel dim, holds the output columns
[c·out/dc, (c+1)·out/dc) of ``kernel`` and ``bias``. Each rank has its
rows of the batch: the forward gathers the global batch's input (one
all-gather), runs the same product on the rank's columns and hands each
rank its rows of every block's columns (one all-to-all); autograd runs
the reverse of each (``parallel.split.GatherBatch``, ``ToRows``): the
cotangent of the columns for the global batch comes back by the reverse
all-to-all, so ``dW`` and ``db`` are the whole batch's on each rank (and
never all-reduced), and the input's cotangent is the blocks' partial
products summed over the ranks of the other blocks (one all-reduce),
this rank's rows of it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.initializers import DEFAULT_BIAS_INIT, DEFAULT_KERNEL_INIT
from ..core.op import Op, ParamDef
from .common import AC_MODE_NONE, apply_activation


class Linear(Op):
    type_name = "Dense"

    _split = None

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

    def _defs(self, out_dim: int) -> Dict[str, ParamDef]:
        defs = {"kernel": ParamDef((self.in_dim, out_dim),
                                   torch.float32, self.kernel_initializer)}
        if self.use_bias:
            defs["bias"] = ParamDef((out_dim,), torch.float32,
                                    self.bias_initializer)
        return defs

    def param_defs(self) -> Dict[str, ParamDef]:
        if self._split is None:
            return self._defs(self.out_dim)
        return self._defs(self.out_dim // self._split.nblocks)

    def bind_split(self, split):
        """This rank's side of a split by channel (None: whole), bound by
        compile once the process group is there."""
        self._split = split

    def init_params(self, generator, device):
        if self._split is None:
            return super().init_params(generator, device)
        # the whole kernel and bias drawn as on one card, this rank's
        # columns kept
        cols = self._split.columns(self.out_dim)
        return {n: d.initializer(generator, d.shape, d.dtype,
                                 device)[..., cols].contiguous()
                for n, d in sorted(self._defs(self.out_dim).items())}

    def whole_params(self, params):
        """The kernel and bias as one card holds them, gathered from the
        ranks; None when this rank holds them whole."""
        if self._split is None:
            return None
        return {n: self._split.gather_pieces(v, -1)
                for n, v in params.items()}

    def apply(self, params, xs):
        (x,) = xs
        s = self._split
        if s is not None:
            from ..parallel.split import GatherBatch, ToRows
            x = GatherBatch.apply(x, s)
        cdt = self.model.compute_dtype
        y = torch.matmul(x.to(cdt).float(), params["kernel"].to(cdt).float())
        if self.use_bias:
            y = y + params["bias"]
        y = apply_activation(y, self.activation).to(x.dtype)
        return [y if s is None else ToRows.apply(y, s)]
