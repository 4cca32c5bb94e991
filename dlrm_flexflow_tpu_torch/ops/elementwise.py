"""Elementwise operators (the counterparts of
``dlrm_flexflow_tpu.ops.elementwise``): ``Softmax`` only so far; the
unary and binary ops and ``Dropout`` are not ported yet."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.op import Op


class Softmax(Op):
    """Softmax over the last axis, in fp32 whatever the input's dtype.
    Under a cross-entropy loss ``FFModel.compile`` takes the loss on
    this op's input (the logits) and the metrics on its output."""

    type_name = "Softmax"

    def __init__(self, model, input_tensor, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        self.outputs = [self._make_output(input_tensor.shape)]

    def apply(self, params, xs):
        return [torch.softmax(xs[0].float(), dim=-1)]
