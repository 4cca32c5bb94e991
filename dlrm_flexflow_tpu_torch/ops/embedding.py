"""Stacked embedding bags (the counterpart of
``dlrm_flexflow_tpu.ops.embedding.EmbeddingBagStacked``; ``Embedding``
and ``EmbeddingBagConcat`` are not ported yet).

The JAX op stores its T tables lane-packed as (T, rows/r, r·d) for the
TPU's 128-lane tiles. The port keeps them as (T, rows, d) in LOGICAL
table order: one GPU holds every table, so the storage permutation
``_table_order`` that the JAX op uses to place tables on devices has no
work to do in the forward. The op still records it, because
``utils.weights.params_from_jax`` reads it to undo the JAX storage
order when it carries weights across.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.initializers import GlorotUniform
from ..core.op import Op, ParamDef
from .kernels.embedding_bag import embedding_bag

AGGR_MODE_SUM = "sum"
AGGR_MODE_AVG = "avg"


class EmbeddingBagStacked(Op):
    """input: int (batch, num_tables, bag) -> (batch, num_tables, dim)."""

    type_name = "EmbedStack"

    def __init__(self, model, input_tensor, num_tables: int,
                 num_entries: int, out_dim: int, aggr: str = AGGR_MODE_SUM,
                 kernel_initializer=None, name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        if input_tensor.num_dims != 3 \
                or input_tensor.shape[1] != num_tables:
            raise ValueError(f"EmbeddingBagStacked expects (batch, "
                             f"{num_tables}, bag) ids, got "
                             f"{input_tensor.shape}")
        if aggr not in (AGGR_MODE_SUM, AGGR_MODE_AVG):
            raise ValueError(f"EmbeddingBagStacked aggr expects sum|avg, "
                             f"got {aggr!r}")
        self.num_tables = int(num_tables)
        self.num_entries = int(num_entries)
        self.out_dim = int(out_dim)
        self.aggr = aggr
        self.kernel_initializer = kernel_initializer or GlorotUniform()
        batch = input_tensor.shape[0]
        self.outputs = [self._make_output(
            (batch, self.num_tables, self.out_dim))]
        self._table_order = None

    def set_table_order(self, order):
        """Record the JAX op's storage order: stored slot s holds logical
        table ``order[s]``. The identity order is recorded as None."""
        order = tuple(int(t) for t in order)
        if sorted(order) != list(range(self.num_tables)):
            raise ValueError(f"not a table permutation: {order}")
        self._table_order = (None if order == tuple(range(self.num_tables))
                             else order)

    def param_defs(self):
        return {"kernel": ParamDef(
            (self.num_tables, self.num_entries, self.out_dim),
            torch.float32, self.kernel_initializer)}

    def init_params(self, generator, device):
        # each table at its own (rows, d) shape, so shape-dependent
        # initializers (Glorot fans) match the JAX op's per-table draws
        return {"kernel": torch.stack([
            self.kernel_initializer(generator,
                                    (self.num_entries, self.out_dim),
                                    torch.float32, device)
            for _ in range(self.num_tables)])}

    def apply(self, params, xs):
        (idx,) = xs                       # (batch, T, bag)
        table = params["kernel"]          # (T, rows, d)
        T, rows, d = table.shape
        batch, _, bag = idx.shape
        # ids wrap into each table as jnp's floor-mod % does (negative
        # ids too), then offset into the stacked (T*rows, d) view
        offs = torch.arange(T, device=idx.device, dtype=torch.int64) * rows
        flat = (torch.remainder(idx.long(), rows)
                + offs[None, :, None]).reshape(batch * T, bag)
        out = embedding_bag(table.reshape(T * rows, d), flat, self.aggr)
        return [out.reshape(batch, T, d)]
