"""Operator base class.

The counterpart of ``dlrm_flexflow_tpu.core.op``: an op is named
``<Type>_<guid>`` unless the caller names it, owns its input and output
tensors, declares its parameters as ``ParamDef``s and computes its
outputs in ``apply(params, xs)``. Parameters live outside the op, in
``FFModel.params[op.name]``, as ``torch.Tensor``s keyed by parameter
name — the same ``{op_name: {param_name: array}}`` layout the JAX
package keeps, so weights cross between the two by name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from .initializers import Initializer
from .tensor import Tensor


@dataclass
class ParamDef:
    shape: tuple
    dtype: Any
    initializer: Initializer


class Op:
    """Base operator. Subclasses set ``type_name``, build
    ``self.outputs`` in ``__init__`` and implement ``apply``."""

    type_name: str = "Op"

    def __init__(self, model, inputs: Sequence[Tensor],
                 name: Optional[str] = None):
        self.model = model
        self.guid = model._next_op_guid()
        self.name = name or f"{self.type_name}_{self.guid}"
        self.inputs: List[Tensor] = list(inputs)
        self.outputs: List[Tensor] = []

    def _make_output(self, shape, dtype=torch.float32, idx: int = 0
                     ) -> Tensor:
        # registration happens on first output creation, AFTER the
        # subclass constructor validated its inputs — a throwing
        # constructor leaves no half-built op in the graph
        if not getattr(self, "_registered", False):
            self.model._register_op(self)
            self._registered = True
        return Tensor(tuple(shape), dtype, owner_op=self, owner_idx=idx,
                      name=f"{self.name}_out{idx}")

    def param_defs(self) -> Dict[str, ParamDef]:
        """Parameter name -> ParamDef. Empty for stateless ops."""
        return {}

    def init_params(self, generator: torch.Generator, device
                    ) -> Dict[str, torch.Tensor]:
        return {n: d.initializer(generator, d.shape, d.dtype, device)
                for n, d in sorted(self.param_defs().items())}

    def apply(self, params: Dict[str, torch.Tensor],
              xs: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    # ---- placement (compile(); parallel/) -------------------------------
    # an op whose table-dim degree is intent rather than an output split
    # (the concatenated-rows embedding) is clamped by compile() without a
    # warning, as in the JAX package
    raw_degree_semantics: bool = False

    def output_axes(self, pc, assigner, raw_pc=None):
        """The mesh axes of each output dim under config ``pc``: the
        degrees' positional axes (``raw_pc``, the unclamped strategy, is
        for ops that read their intent from it)."""
        return assigner.assign(pc.degrees)

    def default_parallel_config(self, num_devices: int):
        """Data parallelism over the sample dim (the reference's
        Op::get_data_parallel_config, model.cc:282-293)."""
        from ..parallel.pconfig import ParallelConfig
        return ParallelConfig.data_parallel(self.outputs[0].num_dims,
                                            num_devices)

    def __repr__(self):
        return (f"{type(self).__name__}(name={self.name!r}, "
                f"in={[t.shape for t in self.inputs]}, "
                f"out={[t.shape for t in self.outputs]})")


class InputOp(Op):
    """Placeholder op owning a model input tensor."""

    type_name = "Input"

    def __init__(self, model, shape, dtype, name=None):
        super().__init__(model, [], name)
        self.outputs = [self._make_output(shape, dtype)]

    def apply(self, params, xs):
        raise RuntimeError("InputOp is fed externally")
