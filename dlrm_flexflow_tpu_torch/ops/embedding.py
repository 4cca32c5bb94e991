"""Embedding bags: ``Embedding`` (one table) and ``EmbeddingBagStacked``
(the counterparts of ``dlrm_flexflow_tpu.ops.embedding``;
``EmbeddingBagConcat`` is not ported yet).

The JAX op stores its T tables lane-packed as (T, rows/r, r·d) for the
TPU's 128-lane tiles. The port keeps them as (T, rows, d) in LOGICAL
table order: one GPU holds every table, so the storage permutation
``_table_order`` that the JAX op uses to place tables on devices has no
work to do in the forward. The op still records it, because
``utils.weights.params_from_jax`` reads it to undo the JAX storage
order when it carries weights across.

For the delta publisher (``utils/delta.py``) both ops map a host batch's
ids to the rows of the JAX op's STORED kernel, flattened to 2-D
(``delta_touched_rows``: the rows a touched-rows update may change), and
to their flat lookup-id space (``flat_lookup_ids``, for the id-frequency
sketch), as the JAX ops do; a delta file's row indices are in that
stored layout, and ``utils.weights.rows_from_jax`` maps them back.

Both ops take the touched-rows update: ``sparse_sgd_update`` under
plain SGD, ``sparse_opt_update`` under a stateful optimizer (SGD with
momentum or weight decay, Adam), which updates the touched rows'
weights AND their optimizer state, and nothing else (lazy semantics, as
the JAX ops). Each takes ``ok``, the anomaly sentinel's 0-d int32 flag
(None: no sentinel), and hands it to its scatter: a step whose flag is 0
writes no row.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.initializers import GlorotUniform
from ..core.op import Op, ParamDef
from .kernels.embedding_bag import EmbeddingBagFunction, embedding_bag
from .kernels.scatter_rows import (scatter_add_rows, scatter_write_rows,
                                   stateful_update_rows)

AGGR_MODE_SUM = "sum"
AGGR_MODE_AVG = "avg"
AGGR_MODE_NONE = "none"


class Embedding(Op):
    """One table, (num_entries, out_dim). With ``aggr`` "sum" or "avg":
    int ids (batch, bag) -> (batch, out_dim), the sum or mean over the
    bag, gathered on the card by the embedding-bag kernel (any
    d % 4 == 0). With ``aggr="none"``: ids (batch, slots) -> (batch,
    slots, out_dim), one row per slot, gathered by plain torch indexing
    as the JAX op gathers it outside any Pallas kernel
    (``jnp.take(mode="wrap")``). Ids wrap ``% num_entries`` (floor-mod),
    as the JAX op's XLA path does; its Pallas path does not wrap, and
    the two agree on in-range ids. The row-sharded lookup and the
    hot/cold hybrid are not ported yet."""

    type_name = "Embed"

    def __init__(self, model, input_tensor, num_entries: int, out_dim: int,
                 aggr: str = AGGR_MODE_SUM, kernel_initializer=None,
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        if aggr not in (AGGR_MODE_SUM, AGGR_MODE_AVG, AGGR_MODE_NONE):
            raise ValueError(f"bad aggr mode {aggr!r}")
        if input_tensor.num_dims != 2:
            raise ValueError(f"Embedding expects (batch, bag) ids, got "
                             f"{input_tensor.shape}")
        self.num_entries = int(num_entries)
        self.out_dim = int(out_dim)
        self.aggr = aggr
        self.kernel_initializer = kernel_initializer or GlorotUniform()
        if aggr == AGGR_MODE_NONE:
            out_shape = tuple(input_tensor.shape) + (self.out_dim,)
        else:
            out_shape = (input_tensor.shape[0], self.out_dim)
        self.outputs = [self._make_output(out_shape)]

    def param_defs(self):
        return {"kernel": ParamDef((self.num_entries, self.out_dim),
                                   torch.float32, self.kernel_initializer)}

    def _ids(self, idx):
        return torch.remainder(idx.long(), self.num_entries)

    def apply(self, params, xs):
        (idx,) = xs                       # (batch, bag)
        if self.aggr == AGGR_MODE_NONE:
            return [params["kernel"][self._ids(idx)]]
        return [EmbeddingBagFunction.apply(params["kernel"], self._ids(idx),
                                           self.aggr)]

    # ---- delta publication (utils/delta.py) -------------------------
    def lookup_id_space(self) -> int:
        return self.num_entries

    def flat_lookup_ids(self, idx_np) -> np.ndarray:
        """Batch ids -> the flat lookup-id space (wrapped)."""
        return (np.asarray(idx_np).astype(np.int64).reshape(-1)
                % self.num_entries)

    def delta_touched_rows(self, idx_np) -> np.ndarray:
        """The table rows a touched-rows update of this batch may change
        (the JAX op stores the table unpacked, as the port does)."""
        return np.unique(self.flat_lookup_ids(idx_np))

    # ---- touched-rows updates -------------------------------------------
    def supports_sparse_update(self) -> bool:
        return self.aggr in (AGGR_MODE_SUM, AGGR_MODE_AVG, AGGR_MODE_NONE)

    def apply_with_fwd(self, params, xs):
        """apply() and no residual: the JAX op keeps the gathered rows
        only for 128-wide rows on its TPU path, so the update here always
        reads the table (the read-modify-write scatter)."""
        return self.apply(params, xs), None

    @torch.no_grad()
    def sparse_sgd_update(self, params, xs, out_ct, lr, fwd=None, ok=None):
        """table[row] -= lr * ct for the touched rows only, in place: with
        "none" each slot's cotangent row; with "sum"/"avg" the bag's
        cotangent (/ bag for "avg") for every row of the bag. A row's
        duplicates sum in lookup order before they land, on the
        read-modify-write scatter kernel on the card."""
        (idx,) = xs
        table = params["kernel"]
        ids = self._ids(idx).reshape(-1)
        ct = out_ct.to(table.dtype).reshape(-1, self.out_dim)
        div = 1
        if self.aggr != AGGR_MODE_NONE:
            div = idx.shape[-1]
            if self.aggr == AGGR_MODE_AVG:
                ct = ct / div
        scatter_add_rows(table, ids, ct, scale=-lr, div=div,
                         ids_in_range=True, ok=ok)   # wrapped by _ids
        return params

    @torch.no_grad()
    def sparse_opt_update(self, params, xs, out_ct, opt, slabs, step,
                          fwd=None, ok=None):
        """The stateful touched-rows update (lazy momentum, weight decay,
        Adam), in place on the table and on ``slabs`` ({slab name: the
        table's state}): each lookup's update is the RAW cotangent (its
        slot's with "none", its bag's, / bag for "avg", otherwise), a
        row's duplicates are summed in lookup order, and the optimizer's
        row math updates that row's weight and state, as the JAX op's
        ``_stateful_update_rows_xla``; untouched rows keep both. ``step``
        is the optimizer's step before this one (Adam's alpha_t). The
        table row is read (no residual: ``apply_with_fwd`` keeps none)."""
        (idx,) = xs
        table = params["kernel"]
        ids = self._ids(idx).reshape(-1)
        ct = out_ct.to(table.dtype).reshape(-1, self.out_dim)
        div = 1
        if self.aggr != AGGR_MODE_NONE:
            div = idx.shape[-1]
            if self.aggr == AGGR_MODE_AVG:
                ct = ct / div
        stateful_update_rows(table, ids, ct, None, slabs, opt.row_params(),
                             opt.alpha_t(step), div=div,
                             ids_in_range=True, ok=ok)   # wrapped by _ids
        return params


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

    def _global_ids(self, idx):
        """(batch, T, bag) ids -> (batch*T, bag) rows of the stacked
        (T*rows, d) view: ids wrap into each table as jnp's floor-mod %
        does (negative ids too), then offset by t*rows."""
        offs = torch.arange(self.num_tables, device=idx.device,
                            dtype=torch.int64) * self.num_entries
        flat = torch.remainder(idx.long(), self.num_entries) \
            + offs[None, :, None]
        return flat.reshape(-1, idx.shape[2])

    def _flat_table(self, params):
        return params["kernel"].reshape(self.num_tables * self.num_entries,
                                        self.out_dim)

    def apply(self, params, xs):
        (idx,) = xs                       # (batch, T, bag)
        out = EmbeddingBagFunction.apply(self._flat_table(params),
                                         self._global_ids(idx), self.aggr)
        return [out.reshape(idx.shape[0], self.num_tables, self.out_dim)]

    # ---- delta publication (utils/delta.py) -------------------------
    def lookup_id_space(self) -> int:
        return self.num_tables * self.num_entries

    def flat_lookup_ids(self, idx_np) -> np.ndarray:
        """(batch, T, bag) ids -> flat t*rows + ix lookup ids."""
        rows = self.num_entries
        g = np.asarray(idx_np).astype(np.int64) % rows
        offs = (np.arange(self.num_tables, dtype=np.int64)
                * rows)[None, :, None]
        return (g + offs).reshape(-1)

    def delta_touched_rows(self, idx_np) -> np.ndarray:
        """The rows of the JAX op's stored kernel, (T, rows/r, r*d)
        flattened to (T*rows/r, r*d), that this batch touches: logical
        table t lives at stored slot inv[t] (``_table_order``'s
        inverse), logical row ix at packed row ix // r of that slot."""
        from ..utils.weights import _pack_factor
        r, rows = _pack_factor(self.out_dim, self.num_entries), \
            self.num_entries
        g = np.asarray(idx_np).astype(np.int64) % rows   # (batch, T, bag)
        slot = np.arange(self.num_tables, dtype=np.int64)
        if self._table_order is not None:
            slot = np.argsort(np.asarray(self._table_order)).astype(np.int64)
        flat = slot[None, :, None] * (rows // r) + g // r
        return np.unique(flat.reshape(-1))

    # ---- touched-rows updates -------------------------------------------
    def supports_sparse_update(self) -> bool:
        return self.aggr in (AGGR_MODE_SUM, AGGR_MODE_AVG)

    def apply_with_fwd(self, params, xs):
        """apply() plus the forward residual: (global row ids (n,), the
        gathered rows (n, d)), both in (batch, T, bag) order — the order
        ``sparse_sgd_update`` applies its updates in."""
        (idx,) = xs
        gid = self._global_ids(idx)
        out, rows = embedding_bag(self._flat_table(params), gid, self.aggr,
                                  return_rows=True)
        out = out.reshape(idx.shape[0], self.num_tables, self.out_dim)
        return [out], (gid.reshape(-1), rows)

    @torch.no_grad()
    def sparse_sgd_update(self, params, xs, out_ct, lr, fwd=None, ok=None):
        """table[row] -= lr * ct, for the touched rows only, in place:
        each lookup's update is -lr * (its bag's cotangent, / bag for
        "avg"), and a row's duplicates sum in lookup order before they
        land. With the residual of ``apply_with_fwd`` the write-only
        kernel writes fwd_row + sum; without it the read-modify-write
        kernel adds the sum to the table."""
        (idx,) = xs
        bag = idx.shape[2]
        ct = out_ct.to(params["kernel"].dtype).reshape(-1, self.out_dim)
        if self.aggr == AGGR_MODE_AVG:
            ct = ct / bag
        table = self._flat_table(params)
        if fwd is not None:
            gid, rows = fwd
            scatter_write_rows(table, gid, ct, rows, scale=-lr, div=bag,
                               ids_in_range=True, ok=ok)   # wrapped ids
        else:
            gid = self._global_ids(idx).reshape(-1)
            scatter_add_rows(table, gid, ct, scale=-lr, div=bag,
                             ids_in_range=True, ok=ok)   # wrapped ids
        return params

    @torch.no_grad()
    def sparse_opt_update(self, params, xs, out_ct, opt, slabs, step,
                          fwd=None, ok=None):
        """The stateful touched-rows update, in place on the tables and on
        ``slabs`` ({slab name: (T, rows, d) state}): each lookup's update
        is its bag's RAW cotangent (/ bag for "avg"), a row's duplicates
        summed in lookup order, then the optimizer's row math on that
        row's weight (the residual of ``apply_with_fwd`` when given, else
        the table row) and state; untouched rows keep both. The JAX op
        permutes ids and cotangent into its storage order first; the
        port stores tables in logical order, and a row's lookups keep
        their relative order under that permutation (all of them lie in
        one table), so its sums, and the result, are the same. ``step``:
        the optimizer's step before this one."""
        (idx,) = xs
        bag = idx.shape[2]
        ct = out_ct.to(params["kernel"].dtype).reshape(-1, self.out_dim)
        if self.aggr == AGGR_MODE_AVG:
            ct = ct / bag
        if fwd is not None:
            gid, rows = fwd
        else:
            gid, rows = self._global_ids(idx).reshape(-1), None
        n = self.num_tables * self.num_entries
        stateful_update_rows(
            self._flat_table(params), gid, ct, rows,
            {k: v.reshape(n, self.out_dim) for k, v in slabs.items()},
            opt.row_params(), opt.alpha_t(step), div=bag,
            ids_in_range=True, ok=ok)   # wrapped ids
        return params
