"""FusedDotInteraction: gather -> X·Xᵀ -> tril -> first top-MLP layer
as one op (the counterpart of
``dlrm_flexflow_tpu.ops.interaction.FusedDotInteraction``).

The op owns the stacked embedding table and the first top-MLP layer's
weight and bias, and runs the chain through ``FusedInteractionFunction``:
the CUDA kernel for tensors on the card, its plain version on the CPU,
and the JAX custom VJP's backward (a dense table gradient, as the JAX
op: this op takes no touched-rows update). The
JAX op sends a sigmoid head through its unfused reference; here the
kernel runs with no activation and the sigmoid is applied after it —
the same math, still through the kernel.

Ids are offset into the stacked rows but NOT wrapped, as in the JAX op:
callers pass ids in [0, num_entries).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.initializers import (DEFAULT_BIAS_INIT, DEFAULT_KERNEL_INIT,
                                 GlorotUniform)
from ..core.op import Op, ParamDef
from .common import apply_activation
from .kernels.interaction import FusedInteractionFunction, tril_pairs


class FusedDotInteraction(Op):
    type_name = "FusedDotInteraction"

    def __init__(self, model, sparse_idx, bottom, num_entries: int,
                 out_dim: int, activation: str = "relu",
                 emb_initializer=None, kernel_initializer=None,
                 bias_initializer=None, name: Optional[str] = None):
        """sparse_idx: (batch, T, bag) int; bottom: (batch, d), the
        bottom-MLP output. ``num_entries`` is rows PER TABLE; ``out_dim``
        is the first top-MLP layer's width."""
        super().__init__(model, [sparse_idx, bottom], name)
        if sparse_idx.num_dims != 3:
            raise ValueError("FusedDotInteraction expects (batch, T, bag) "
                             "sparse indices")
        if bottom.num_dims != 2:
            raise ValueError("FusedDotInteraction expects a rank-2 "
                             "bottom-MLP input")
        batch, T, _ = sparse_idx.shape
        if bottom.shape[0] != batch:
            raise ValueError("batch dim mismatch between sparse and bottom")
        self.num_tables = int(T)
        self.num_entries = int(num_entries)
        self.in_dim = int(bottom.shape[1])
        self.out_dim = int(out_dim)
        self.activation = activation
        self.num_pairs = len(tril_pairs(self.num_tables + 1))
        self.emb_initializer = emb_initializer or GlorotUniform()
        self.kernel_initializer = kernel_initializer or DEFAULT_KERNEL_INIT()
        self.bias_initializer = bias_initializer or DEFAULT_BIAS_INIT()
        self.outputs = [self._make_output((batch, self.out_dim))]

    def param_defs(self) -> Dict[str, ParamDef]:
        return {
            "table": ParamDef(
                (self.num_tables * self.num_entries, self.in_dim),
                torch.float32, self.emb_initializer),
            "kernel": ParamDef(
                (self.in_dim + self.num_pairs, self.out_dim),
                torch.float32, self.kernel_initializer),
            "bias": ParamDef((self.out_dim,), torch.float32,
                             self.bias_initializer),
        }

    def apply(self, params, xs):
        idx, bottom = xs
        # per-table ids -> the stacked row space (table t's rows live at
        # [t*rows, (t+1)*rows))
        offs = torch.arange(self.num_tables, device=idx.device,
                            dtype=torch.int64) * self.num_entries
        gid = idx.long() + offs[None, :, None]
        in_kernel = self.activation in ("relu", "none", None)
        out = FusedInteractionFunction.apply(
            params["table"], gid, bottom.float(), params["kernel"],
            params["bias"], self.activation == "relu")
        if not in_kernel:
            out = apply_activation(out, self.activation)
        return [out.to(bottom.dtype)]
