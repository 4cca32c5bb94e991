"""Shape operators: Concat, Split, Reshape, Transpose, IndexSelect and
Reverse (the counterparts of ``dlrm_flexflow_tpu.ops.tensor_ops``; Flat
is not ported yet)."""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..core.op import Op


class Concat(Op):
    type_name = "Concat"

    def __init__(self, model, inputs, axis: int, name: Optional[str] = None):
        super().__init__(model, inputs, name)
        nd = inputs[0].num_dims
        self.axis = axis % nd
        for t in inputs[1:]:
            if t.num_dims != nd:
                raise ValueError("concat rank mismatch")
            for d in range(nd):
                if d != self.axis and t.shape[d] != inputs[0].shape[d]:
                    raise ValueError(f"concat shape mismatch on dim {d}")
        out_shape = list(inputs[0].shape)
        out_shape[self.axis] = sum(t.shape[self.axis] for t in inputs)
        self.outputs = [self._make_output(out_shape, inputs[0].dtype)]

    def apply(self, params, xs):
        return [torch.cat(xs, dim=self.axis)]


class Split(Op):
    """The inverse of concat: ``sizes`` along ``axis``, one output
    each (views of the input)."""

    type_name = "Split"

    def __init__(self, model, input_tensor, sizes: List[int], axis: int,
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        nd = input_tensor.num_dims
        self.axis = axis % nd
        self.sizes = [int(s) for s in sizes]
        if sum(self.sizes) != input_tensor.shape[self.axis]:
            raise ValueError("split sizes must sum to the axis extent")
        self.outputs = []
        for i, s in enumerate(self.sizes):
            shape = list(input_tensor.shape)
            shape[self.axis] = s
            self.outputs.append(
                self._make_output(shape, input_tensor.dtype, i))

    def apply(self, params, xs):
        (x,) = xs
        return list(torch.split(x, self.sizes, dim=self.axis))


class Reshape(Op):
    """Total element count must match."""

    type_name = "Reshape"

    def __init__(self, model, input_tensor, shape, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        shape = tuple(int(s) for s in shape)
        if math.prod(shape) != math.prod(input_tensor.shape):
            raise ValueError(
                f"reshape {input_tensor.shape} -> {shape}: element count "
                f"mismatch")
        self.outputs = [self._make_output(shape, input_tensor.dtype)]

    def apply(self, params, xs):
        (x,) = xs
        shape = self.outputs[0].shape
        if (x.shape[0] != shape[0]
                and math.prod(x.shape[1:]) == math.prod(shape[1:])):
            # sample-dim polymorphism: the graph bakes the build-time
            # batch into the target shape, but serving runs other batch
            # sizes; a reshape that keeps the per-sample element count
            # re-derives its target against the live batch
            shape = (x.shape[0],) + tuple(shape[1:])
        return [x.reshape(shape)]


class Transpose(Op):
    """Swap the innermost two dims; batch dims untouched."""

    type_name = "Transpose"

    def __init__(self, model, input_tensor, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        if input_tensor.num_dims < 2:
            raise ValueError("transpose needs rank >= 2")
        shape = list(input_tensor.shape)
        shape[-1], shape[-2] = shape[-2], shape[-1]
        self.outputs = [self._make_output(shape, input_tensor.dtype)]

    def apply(self, params, xs):
        return [xs[0].transpose(-1, -2)]


class IndexSelect(Op):
    """Static-index gather along one axis (``torch.index_select``
    semantics): the strictly-lower-triangle selection of the DLRM "dot"
    interaction."""

    type_name = "IndexSelect"

    def __init__(self, model, input_tensor, indices, axis: int,
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        self.axis = axis % input_tensor.num_dims
        self.indices = [int(i) for i in indices]
        ext = input_tensor.shape[self.axis]
        for i in self.indices:
            if not 0 <= i < ext:
                raise ValueError(f"index {i} out of range for dim {ext}")
        shape = list(input_tensor.shape)
        shape[self.axis] = len(self.indices)
        self.outputs = [self._make_output(shape, input_tensor.dtype)]
        self._idx = {}          # device -> the indices as a tensor there

    def apply(self, params, xs):
        (x,) = xs
        idx = self._idx.get(x.device)
        if idx is None:
            # a plain tensor even when made under inference mode: the
            # backward of a training step saves it
            with torch.inference_mode(False):
                idx = self._idx[x.device] = torch.tensor(
                    self.indices, dtype=torch.int64, device=x.device)
        return [torch.index_select(x, self.axis, idx)]


class Reverse(Op):
    """Reverse along one axis (NMT reverses its source sequences)."""

    type_name = "Reverse"

    def __init__(self, model, input_tensor, axis: int,
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        self.axis = axis % input_tensor.num_dims
        self.outputs = [self._make_output(input_tensor.shape,
                                          input_tensor.dtype)]

    def apply(self, params, xs):
        return [torch.flip(xs[0], dims=(self.axis,))]
