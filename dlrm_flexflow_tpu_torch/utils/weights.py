"""Carry a JAX model's weights into the port.

JAX's threefry and torch's Philox never draw the same numbers, so the
two packages agree only when the port runs the JAX model's own weights.
``params_from_jax`` takes the JAX ``FFModel.params`` as numpy
(``{op_name: {param_name: array}}``) and returns the port's parameters
for ``model``, ready for ``model.swap_params``:

- Linear, FusedDotInteraction, Embedding (every ``aggr``, "none"
  included), LSTM and LSTMStack parameters carry over as they are: the
  JAX ``Embedding`` keeps its table unpacked, as (num_entries, out_dim),
  like the port, and the LSTM ops keep ``wx`` (d, 4h), ``wh`` (h, 4h)
  and ``bias`` (4h,) per layer in the same i, f, g, o column order;
- an EmbeddingBagStacked kernel is stored by the JAX op lane-packed as
  (T, N/r, r·d) in storage order: it is reshaped to (T, N, d) and the
  op's ``_table_order`` (stored slot s holds logical table order[s]) is
  undone, giving the port's logical layout. Set the same order on the
  port's op (``set_table_order``) that the JAX op carries;
- an EmbeddingBagConcat kernel is stored lane-packed as
  (total_rows/r, r·d): a reshape gives the port's (total_rows, d).

Under table parallelism (an ``op._split`` of kind "table") a rank
holds the storage slots ``local_slots()`` of the stacked kernel, in slot
order: ``params_from_jax`` takes those slots of the JAX stored kernel
(or keeps a block already of their number), and ``params_to_jax`` gives
them back in the JAX layout, (T/D, N/r, r·d), so the ranks' blocks in
rank order are the JAX kernel.

Row-sharded across ranks (``configure_row_shard``), a rank holds its
row block of each table: rows [H + s·rl, H + (s+1)·rl) of each logical
table, s the rank's shard, rl the plan's ``rows_local``, H the hybrid's
hot rows (0 without), which is the rows [s·rl/r, (s+1)·rl/r) of the JAX
stored cold kernel ((T, (N - H)/r, r·d) stacked, ((N - H), d) for an
``Embedding``, (total_rows/r, r·d) concatenated), and the replicated
``hot_kernel`` ((T, H/r, r·d) stacked, (H, d) per table). Both directions
carry the block, the hot head and, through ``opt_state_*``, their
slabs, bitwise; the stacked tables in logical order on the port's side,
in storage order on the JAX side, as unsharded.

The other splits across ranks (``parallel.split``, ``op._split``): a
rank of a concatenated table split in row blocks holds its equal block
of the logical rows, rows [k·R/W, (k+1)·R/W), which is the rows
[k·R/W/r, (k+1)·R/W/r) of the JAX stored kernel (R/r, r·d); a rank of
an ``Embedding`` split by width holds its columns of the kernel (rows,
d / dc), and a rank of a ``Linear`` split by channel its columns of the
kernel (in, out / dc) and of the bias. ``params_from_jax`` takes the
rank's piece from the whole JAX array (or keeps a piece already of its
shape) and ``params_to_jax`` gives the piece back in the JAX layout, so
the ranks' pieces, joined in block order (rank order where each block
has one rank), are the JAX stored array. A replicated table is carried
as on one card.

Host-resident tables are no parameters: the ops whose tables live on
the host (``model._host_resident_list``) have no entry in ``params``
here or in the JAX model, and ``host_param_shapes`` gives their host
tables' shapes, which both packages keep unpacked: (rows, d) for an
``Embedding``, (T, rows, d) for a stacked table, (total_rows, d) for a
concatenated one.

``params_to_jax`` is the inverse: the port's parameters as numpy in the
JAX layout (``_table_order`` re-applied, tables lane-packed to
(T, N/r, r·d) as the JAX op's ``_pack_factor`` packs them), so a test can
compare a trained port model with a trained JAX model array by array.

``param_from_jax`` carries one array across the same way (a delta's
whole-array update), and ``rows_from_jax`` maps rows of a JAX stored
array, flattened to 2-D over all but its last axis (a delta's row
update), to rows of the port's tensor flattened the same way.

``opt_state_from_jax`` and ``opt_state_to_jax`` carry an optimizer state
(``{slab: {op_name: {param_name: array}}}`` plus Adam's int32
``"step"``) across the same way: every slab mirrors the parameters and
takes their layout transform, the step becomes a 0-d int32 tensor on
the model's device and back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.embedding import (Embedding, EmbeddingBagConcat,
                             EmbeddingBagStacked)


def _device_ops(model):
    """The ops with parameters on the device: all but the host-resident
    tables."""
    host = {op.name for op in model._host_resident_list}
    return [op for op in model.ops
            if op.param_defs() and op.name not in host]


def host_param_shapes(model) -> Dict[str, Dict[str, tuple]]:
    """Every host-resident table's shape, {op name: {"kernel": shape}}."""
    out = {}
    for op in model._host_resident_list:
        if isinstance(op, EmbeddingBagStacked):
            shape = (op.num_tables, op.num_entries, op.out_dim)
        elif isinstance(op, EmbeddingBagConcat):
            shape = (op.total_rows, op.out_dim)
        elif isinstance(op, Embedding):
            shape = (op.num_entries, op.out_dim)
        else:
            raise TypeError(f"{op.name}: no host table layout for "
                            f"{type(op).__name__}")
        out[op.name] = {"kernel": shape}
    return out


def param_from_jax(model, op, pn: str, v) -> torch.Tensor:
    """One JAX parameter array -> the port's tensor of ``op.pn`` on the
    model's device (checked against the op's ParamDef)."""
    d = op.param_defs()[pn]
    v = np.array(v, dtype=np.float32)   # a writable copy
    if getattr(op, "_row_plan", None) is not None:
        v = _row_block_from_jax(op, pn, v)
    elif getattr(op, "_split", None) is not None \
            and op._split.kind != "replicated":
        v = _split_piece_from_jax(op, v, d.shape)
    elif isinstance(op, EmbeddingBagStacked) and pn == "kernel":
        v = v.reshape(-1, op.num_entries, op.out_dim)
        if op._table_order is not None:
            inv = np.argsort(np.asarray(op._table_order))
            v = v[inv]
    elif isinstance(op, EmbeddingBagConcat) and pn == "kernel":
        v = v.reshape(op.total_rows, op.out_dim)
    if tuple(v.shape) != tuple(d.shape):
        raise ValueError(f"{op.name}.{pn}: JAX array of shape "
                         f"{v.shape}, the port expects {d.shape}")
    return torch.from_numpy(np.ascontiguousarray(v)).to(
        device=model.device, dtype=d.dtype)


def _row_block_from_jax(op, pn: str, v):
    """A row-sharded op's ``pn`` from the JAX stored array (the whole
    cold kernel, or the rank's block of it as ``params_to_jax`` gives it;
    or the hot head): the rank's block, in the port's layout."""
    d, rl = op.out_dim, op._row_plan.rows_local
    if isinstance(op, EmbeddingBagStacked):
        v = v.reshape(op.num_tables, -1, d)
        if op._table_order is not None:
            v = v[np.argsort(np.asarray(op._table_order))]
    else:
        v = v.reshape(-1, d)
    if pn == "kernel" and v.shape[-2] == rl * op._row_plan.nshards:
        s = op._row_exchange().shard
        v = v[..., s * rl:(s + 1) * rl, :]
    return v


def _split_piece_from_jax(op, v, shape):
    """A split op's parameter from the JAX stored array (whole, or the
    rank's piece as ``params_to_jax`` gives it): the rank's piece, in the
    port's layout (a concatenated table's row block, or the columns of a
    width or channel split)."""
    s = op._split
    if s.kind == "table":
        v = v.reshape(-1, op.num_entries, op.out_dim)
        if v.shape[0] == op.num_tables:     # the whole stored kernel
            v = v[op.local_slots().start:op.local_slots().stop]
        return v
    if s.kind == "rows":
        v = v.reshape(-1, op.out_dim)
        if v.shape[0] == op.total_rows:
            rl = op.total_rows // s.nblocks
            v = v[s.block * rl:(s.block + 1) * rl]
        return v
    if v.shape[-1] != shape[-1]:
        v = v[..., s.columns(v.shape[-1])]
    return v


def _row_block_to_jax(op, pn: str, v, shape):
    if isinstance(op, EmbeddingBagStacked) and op._table_order is not None:
        v = v[np.asarray(op._table_order)]
    return v.reshape(shape)


def params_from_jax(model, params_np: Dict[str, Dict[str, np.ndarray]]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    out = {}
    for op in _device_ops(model):
        defs = op.param_defs()
        if op.name not in params_np:
            raise KeyError(f"JAX params hold no op {op.name!r}")
        src = params_np[op.name]
        out[op.name] = {pn: param_from_jax(model, op, pn, src[pn])
                        for pn in defs}
    return out


def rows_from_jax(op, pn: str, idx: np.ndarray, vals: np.ndarray):
    """Rows ``idx`` of the JAX stored array of ``op.pn`` (flattened to
    (rows, width) over all but the last axis) holding ``vals`` -> (the
    same rows' indices in the port's tensor flattened the same way, their
    values). A stacked table's packed row q of stored slot s holds the r
    logical rows q*r .. q*r+r-1 of logical table order[s]; every other
    parameter has one layout in both packages."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    vals = np.asarray(vals)
    if isinstance(op, EmbeddingBagConcat) and pn == "kernel":
        # packed row q holds the r logical rows q*r .. q*r+r-1
        r = _pack_factor(op.out_dim, op.total_rows)
        out = (idx[:, None] * r
               + np.arange(r, dtype=np.int64)[None, :]).reshape(-1)
        return out, vals.reshape(-1, op.out_dim)
    if not (isinstance(op, EmbeddingBagStacked) and pn == "kernel"):
        return idx, vals
    rows = op.num_entries
    r = _pack_factor(op.out_dim, rows)
    slot, q = np.divmod(idx, rows // r)
    t = (slot if op._table_order is None
         else np.asarray(op._table_order, dtype=np.int64)[slot])
    base = t * rows + q * r
    out = (base[:, None] + np.arange(r, dtype=np.int64)[None, :]).reshape(-1)
    return out, vals.reshape(-1, op.out_dim)


def _pack_factor(dim: int, rows: int) -> int:
    """Rows per 128-lane tile of the JAX op's packed storage (its
    ``_pack_factor``): 128 // dim for narrow rows dividing 128, else 1."""
    if dim < 128 and 128 % dim == 0 and rows % (128 // dim) == 0:
        return 128 // dim
    return 1


def piece_layout(op, pn: str):
    """How this rank's ``params_to_jax`` array of ``op.pn`` joins the
    other ranks' into the JAX stored array: (the mesh axes whose index is
    its block, the stored dim the blocks join along, in block order), or
    None when each rank holds the stored array whole (a replicated or
    data-parallel parameter, a hybrid's ``hot_kernel``)."""
    plan = getattr(op, "_row_plan", None)
    if plan is not None:
        return (tuple(plan.row_axes), -2) if pn == "kernel" else None
    split = getattr(op, "_split", None)
    if split is None or split.kind == "replicated":
        return None
    return tuple(split.axes), (0 if split.kind in ("table", "rows") else -1)


def _blocks(mesh, axes) -> int:
    return max(mesh.linear_index(r, axes) for r in mesh.ranks) + 1


def jax_param_shapes(model, whole: bool = False
                     ) -> Dict[str, Dict[str, tuple]]:
    """Every parameter's shape in the JAX layout, as ``params_to_jax``
    would give it, from the ops' definitions alone (no data moves):
    across ranks this rank's pieces, or with ``whole`` the JAX stored
    arrays the pieces join into (``piece_layout``), as the JAX model on
    a mesh of as many devices holds them."""
    out = _piece_shapes(model)
    if whole:
        for op in _device_ops(model):
            for pn, shape in out[op.name].items():
                lay = piece_layout(op, pn)
                if lay is not None:
                    shape = list(shape)
                    shape[lay[1]] *= _blocks(model.mesh, lay[0])
                    out[op.name][pn] = tuple(shape)
    return out


def _piece_shapes(model) -> Dict[str, Dict[str, tuple]]:
    out = {}
    for op in _device_ops(model):
        shapes = {pn: tuple(int(x) for x in d.shape)
                  for pn, d in op.param_defs().items()}
        if getattr(op, "_row_plan", None) is not None:
            # the rank's block, lane-packed as the JAX op stores it
            if isinstance(op, (EmbeddingBagStacked, EmbeddingBagConcat)):
                rows = (op.num_entries if isinstance(op, EmbeddingBagStacked)
                        else op.total_rows)
                r = _pack_factor(op.out_dim, rows)
                shapes = {pn: s[:-2] + (s[-2] // r, s[-1] * r)
                          for pn, s in shapes.items()}
        elif isinstance(op, EmbeddingBagStacked) and "kernel" in shapes:
            r = _pack_factor(op.out_dim, op.num_entries)
            shapes["kernel"] = (op.local_tables, op.num_entries // r,
                                op.out_dim * r)
        elif isinstance(op, EmbeddingBagConcat) and "kernel" in shapes:
            # the whole table, or a rank's row block of it
            r = _pack_factor(op.out_dim, op.total_rows)
            shapes["kernel"] = (shapes["kernel"][0] // r, op.out_dim * r)
        out[op.name] = shapes
    return out


def params_to_jax(model, params: Dict[str, Dict[str, torch.Tensor]]
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    shapes = jax_param_shapes(model)
    out = {}
    for op in _device_ops(model):
        mine = {}
        for pn, v in params[op.name].items():
            v = v.detach().cpu().numpy()
            if getattr(op, "_row_plan", None) is not None:
                v = _row_block_to_jax(op, pn, v, shapes[op.name][pn])
            elif isinstance(op, EmbeddingBagStacked) and pn == "kernel":
                if op._table_order is not None \
                        and op.local_tables == op.num_tables:
                    v = v[np.asarray(op._table_order)]
                v = v.reshape(shapes[op.name][pn])
            elif isinstance(op, EmbeddingBagConcat) and pn == "kernel":
                v = v.reshape(shapes[op.name][pn])
            mine[pn] = v
        out[op.name] = mine
    return out


def opt_state_from_jax(model, state_np) -> Dict[str, object]:
    """The port's optimizer state for ``model`` from the JAX optimizer
    state as numpy, ready for ``model.opt_state``."""
    out = {}
    for k, sub in state_np.items():
        if k == "step":
            out[k] = torch.tensor(int(np.asarray(sub)), dtype=torch.int32,
                                  device=model.device)
        else:
            out[k] = params_from_jax(model, sub)
    return out


def opt_state_to_jax(model, state) -> Dict[str, object]:
    """The port's optimizer state as numpy in the JAX layout."""
    out = {}
    for k, sub in state.items():
        if k == "step":
            out[k] = np.asarray(int(sub), dtype=np.int32)
        else:
            out[k] = params_to_jax(model, sub)
    return out
