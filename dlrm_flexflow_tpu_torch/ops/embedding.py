"""Embedding bags: ``Embedding`` (one table), ``EmbeddingBagStacked``
(T tables of one size) and ``EmbeddingBagConcat`` (T tables of one width
and different row counts, concatenated row-wise), the counterparts of
``dlrm_flexflow_tpu.ops.embedding``.

The JAX op stores its T tables lane-packed as (T, rows/r, r·d) for the
TPU's 128-lane tiles. On one card the port keeps them as (T, rows, d)
in LOGICAL table order: the storage permutation ``_table_order`` that
the JAX op uses to place tables on devices has no work to do there, and
``utils.weights.params_from_jax`` reads it to undo the JAX storage order
when it carries weights across. Split by table over ranks (an
``OpSplit`` of kind "table", ``parallel/split.py``), a rank holds its
block of the storage slots, in slot order, as the JAX op's devices do.

For the delta publisher (``utils/delta.py``) both ops map a host batch's
ids to the rows of the JAX op's STORED kernel, flattened to 2-D
(``delta_touched_rows``: the rows a touched-rows update may change), and
to their flat lookup-id space (``flat_lookup_ids``, for the id-frequency
sketch), as the JAX ops do; a delta file's row indices are in that
stored layout, and ``utils.weights.rows_from_jax`` maps them back.

The ops take the touched-rows update: ``sparse_sgd_update`` under
plain SGD, ``sparse_opt_update`` under a stateful optimizer (SGD with
momentum or weight decay, Adam), which updates the touched rows'
weights AND their optimizer state, and nothing else (lazy semantics, as
the JAX ops). Each takes ``ok``, the anomaly sentinel's 0-d int32 flag
(None: no sentinel), and hands it to its scatter: a step whose flag is 0
writes no row.

Row-sharded across ranks (a strategy's ``param_degree`` > 1,
``configure_row_shard``): each op holds its rank's row block of every
table (and, under the hot/cold hybrid, the replicated head of each as
``hot_kernel``), and its lookup and touched-rows updates route through
the all-to-all exchange of ``parallel/alltoall.py`` (``_RowShardHooks``).

The other splits across ranks (``parallel/split.py``, bound by compile
as ``op._split``, ``_SplitHooks``): the concatenated table in equal row
blocks over the whole mesh ("rows": each rank bags the lookups of the
global batch that fall in its block with the bag kernel, the others
masked, and the ranks' partial bags are summed into each rank's rows;
the SGD update runs kernel 4, ``sharded_scatter_add_rows``, on the block
with the global batch's ids, a stateful one kernel 2's stateful entry
over the block's window, ``stateful_update_rows(lo=)``), the stacked
tables split by table ("table", the same two entries on the rank's
block of slots), an ``Embedding`` split by width ("width": the bag
kernel on the rank's columns for the global batch, one all-to-all to
the rank's rows; the update the reverse all-to-all, then
``scatter_add_rows`` or ``stateful_update_rows`` on the columns: the
optimizer's row math is elementwise, so a column piece updates on its
own), and tables replicated on every rank ("replicated": the lookup as
on one card; the update, of any optimizer, from the whole global
batch's ids and cotangents, gathered, so that every copy stays bitwise
equal). Under a dense table update (``sparse_embedding_update`` off)
the step takes a split piece's gradient from ``split_dense_grad``, the
same exchange summed into a zero piece (kernel 4 at scale 1 on a block,
``segment_sum_rows`` on columns), since the split lookup's collectives
are no autograd graph. ``whole_params`` gathers a split op's parameters
as one card holds them (the route of a batch that does not divide over
the ranks).

Host-resident tables (``FFConfig.host_resident_tables``, the reference's
hetero placement that lets tables larger than the card's memory train):
each op's ``host_*`` methods keep its table in host RAM as numpy, in the
JAX op's host layout, and look it up and update its touched rows there
with the helpers below, which are the JAX package's (its
``_host_init_table`` draws from a seeded numpy ``RandomState``, so one
seed gives both packages the same host tables bit for bit). The bag
gather and the SGD scatter run on ``native/ffemb.cc``'s thread pool (the
port's own copy, built by g++ at first use; a failed build raises) or
on numpy, whichever was faster the first time a shape was gathered, as
in the JAX package: both compute the same results.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core import initializers as I
from ..core.initializers import GlorotUniform
from ..core.op import Op, ParamDef
from .kernels.embedding_bag import EmbeddingBagFunction, embedding_bag
from .kernels.scatter_rows import (scatter_add_rows, scatter_write_rows,
                                   segment_sum_rows,
                                   sharded_scatter_add_rows,
                                   stateful_update_rows)
from ..utils.logging import get_logger

log_emb = get_logger("embedding")

AGGR_MODE_SUM = "sum"
AGGR_MODE_AVG = "avg"
AGGR_MODE_NONE = "none"

# elements a host-table draw makes at once: the generator's float64
# draws for a chunk (8 MB) are a small fraction of a multi-GB table, so
# a table drawn on each core costs little RAM beside the tables
_HOST_INIT_CHUNK = 1 << 20


def _host_init_table(initializer, shape, seed: int,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """The JAX package's ``_host_init_table``: numpy draws for a host
    table from ``RandomState(seed & 0x7FFFFFFF)``, bit for bit, for the
    port's initializers (zeros, uniform, and Glorot uniform over the last
    two dims for any other). The draws are made a chunk of rows at a
    time (``_HOST_INIT_CHUNK`` elements) into ``out`` (a float32 array of ``shape``; a new one when
    None): a RandomState continues its stream from call to call, so the
    chunks hold what one draw of the whole shape would, without its
    float64 temporary."""
    shape = tuple(int(s) for s in shape)
    if out is None:
        out = np.empty(shape, np.float32)
    if isinstance(initializer, I.ZeroInitializer):
        out[...] = 0.0
        return out
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    if isinstance(initializer, I.UniformInitializer):
        lo, hi = initializer.min_val, initializer.max_val
    else:
        lim = float(np.sqrt(6.0 / (shape[-2] + shape[-1])))
        lo, hi = -lim, lim
    flat = out.reshape(-1, shape[-1])
    step = max(1, _HOST_INIT_CHUNK // shape[-1])
    for r0 in range(0, flat.shape[0], step):
        r1 = min(r0 + step, flat.shape[0])
        flat[r0:r1] = rng.uniform(lo, hi, (r1 - r0, shape[-1]))
    return out


# the gather route for each (table shape, ids shape, aggr), chosen by
# timing both once, as the JAX package chooses: the threaded native
# gather wins on many-core hosts, numpy's on small CPU quotas
_GATHER_CHOICE: Dict[tuple, str] = {}


def _native_gather(lib, table, g, aggr, d):
    import ctypes
    batch, T, bag = g.shape
    gf = np.ascontiguousarray(g.reshape(batch * T, bag), np.int64)
    out = np.empty((batch * T, d), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.ffemb_bag_gather(
        table.ctypes.data_as(fp), table.shape[0], d,
        gf.ctypes.data_as(ip), batch * T, bag,
        1 if aggr == AGGR_MODE_AVG else 0, out.ctypes.data_as(fp))
    return out.reshape(batch, T, d)


def _numpy_gather(table, g, aggr, d):
    rows = table[g.reshape(-1)].reshape(g.shape + (d,))
    out = rows.mean(axis=2) if aggr == AGGR_MODE_AVG else rows.sum(axis=2)
    return np.ascontiguousarray(out, np.float32)


def _native_ok(table) -> bool:
    return table.dtype == np.float32 and table.flags["C_CONTIGUOUS"]


def _host_bag_lookup(table, g, aggr):
    """table (rows, d) numpy; g (batch, T, bag) global rows ->
    (batch, T, d)."""
    import time

    from .. import native
    d = table.shape[-1]
    if not _native_ok(table):
        return _numpy_gather(table, g, aggr, d)
    lib = native.get_emb_lib()
    key = (table.shape, g.shape, aggr)
    choice = _GATHER_CHOICE.get(key)
    if choice is None:
        # warm both first (the pool's threads start, caches fill), then
        # time each once
        _native_gather(lib, table, g, aggr, d)
        _numpy_gather(table, g, aggr, d)
        t0 = time.perf_counter()
        out_n = _native_gather(lib, table, g, aggr, d)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_p = _numpy_gather(table, g, aggr, d)
        t_numpy = time.perf_counter() - t0
        choice = "native" if t_native <= t_numpy else "numpy"
        _GATHER_CHOICE[key] = choice
        return out_n if choice == "native" else out_p
    if choice == "native":
        return _native_gather(lib, table, g, aggr, d)
    return _numpy_gather(table, g, aggr, d)


def _host_bag_update(table, g, ct, lr, aggr):
    """In place, table[g] -= lr * d(out)/d(rows) · ct, duplicates
    adding up."""
    import ctypes

    from .. import native
    d = table.shape[-1]
    if _native_ok(table):
        lib = native.get_emb_lib()
        batch, T, bag = g.shape
        gf = np.ascontiguousarray(g.reshape(batch * T, bag), np.int64)
        cf = np.ascontiguousarray(ct.reshape(batch * T, d), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int64)
        lib.ffemb_bag_scatter(
            table.ctypes.data_as(fp), table.shape[0], d,
            gf.ctypes.data_as(ip), batch * T, bag,
            1 if aggr == AGGR_MODE_AVG else 0,
            cf.ctypes.data_as(fp), float(lr))
        return
    bag = g.shape[-1]
    c = ct / bag if aggr == AGGR_MODE_AVG else ct
    upd = np.broadcast_to(c[..., None, :], g.shape + (d,))
    np.add.at(table, g.reshape(-1), -lr * upd.reshape(-1, d))


def _host_dedup_rows(flat, upd):
    """Duplicate lookups summed into one gradient row each (stateful
    optimizers are nonlinear in the gradient): (distinct rows, sums)."""
    uniq, inv = np.unique(flat, return_inverse=True)
    summed = np.zeros((uniq.shape[0], upd.shape[-1]), np.float32)
    np.add.at(summed, inv, upd)
    return uniq, summed


def _host_stateful_update(table, g, ct, opt, slabs, step, aggr):
    """The lazy stateful touched-rows update on a host table: table
    (rows, d) and slabs {name: (rows, d)} updated in place on the rows g
    (batch, T, bag) names, from ct (batch, T, d)."""
    d = table.shape[-1]
    bag = g.shape[-1]
    c = ct / bag if aggr == AGGR_MODE_AVG else ct
    upd = np.broadcast_to(c[..., None, :],
                          g.shape + (d,)).reshape(-1, d)
    uniq, summed = _host_dedup_rows(g.reshape(-1), upd)
    slab_rows = {k: v[uniq] for k, v in slabs.items()}
    wn, sn = opt.sparse_row_update_np(table[uniq], summed, slab_rows, step)
    table[uniq] = wn
    for k in slabs:
        slabs[k][uniq] = sn[k]


# ---- row sharding across ranks (parallel/alltoall.py) -----------------
# ParallelConfig.param_degree > 1: each rank owns a row block of the
# whole table, and lookups route to owners and back through the
# all-to-all exchange. Set per op by compile() through
# configure_row_shard; every routed path below gates on ``op._row_plan``
# and runs on the exchange ``op._row_ex`` that compile binds once the
# process group is there.

# hot-row quantum, in lane-pack units: the hybrid hot count rounds to a
# multiple of HOT_QUANTUM_PACKS x pack (the JAX op's lane packing), so the
# same hot split serves every row-shard degree dividing 8
HOT_QUANTUM_PACKS = 8


def resolve_hot_rows(rows: int, pack: int, param_degree: int,
                     hot_fraction: float) -> int:
    """Replicated hot rows a table, H, for the hybrid placement:
    ``hot_fraction`` of ``rows`` rounded to the hot quantum, such that the
    cold tail (rows - H) still splits into ``param_degree`` equal blocks
    at the lane packing. 0: no hybrid (the caller degrades loudly to
    plain row sharding)."""
    if hot_fraction <= 0.0 or param_degree <= 1 or rows <= 0:
        return 0
    q = HOT_QUANTUM_PACKS * max(pack, 1)
    if q >= rows:
        return 0
    h = int(round(hot_fraction * rows / q)) * q
    h = max(h, q)
    h = min(h, rows - q)
    if (rows - h) % (param_degree * max(pack, 1)) != 0:
        return 0
    return h


def row_shard_structural_reason(op, raw_pc, axis_sizes) -> Optional[str]:
    """Why ``raw_pc.param_degree``-way row sharding of ``op`` cannot run
    over a mesh of ``axis_sizes``, or None when it can: the JAX package's
    rule set, word for word."""
    from ..parallel.sharding import assignable
    pd = getattr(raw_pc, "param_degree", 1) if raw_pc is not None else 1
    if pd <= 1:
        return None
    if not hasattr(op, "_row_shard_geometry"):
        return ("op has no row-shard support (no configure_row_shard "
                "hook)")
    rows, pack, _tables = op._row_shard_geometry()
    batch = op.inputs[0].shape[0]
    ndev = 1
    for a in axis_sizes:
        ndev *= int(a)
    aggr = getattr(op, "aggr", AGGR_MODE_SUM)
    if aggr not in (AGGR_MODE_SUM, AGGR_MODE_AVG):
        return f"aggr={aggr!r} has no routed bag aggregation"
    if len(raw_pc.degrees) > 1 and any(d > 1 for d in raw_pc.degrees[1:]):
        return (f"degrees {raw_pc.degrees} also request table/width "
                f"sharding — pick one axis for the table")
    if pd > ndev or not assignable((pd,), list(axis_sizes)):
        return (f"{pd} row shards do not factorize mesh axes "
                f"{[int(a) for a in axis_sizes]}")
    if rows % (pd * max(pack, 1)) != 0:
        return (f"{pd} row shards must divide the {rows} padded rows "
                f"(lane pack {pack})")
    if batch % ndev != 0:
        return (f"batch {batch} does not divide over the {ndev}-device "
                f"mesh (lookups route from batch shards)")
    frac = getattr(raw_pc, "hot_fraction", 0.0)
    if frac > 0 and not getattr(op, "_hot_split_ok", False):
        return (f"hot_fraction={frac:g} requested but this op has no "
                f"per-table hot/cold split (concatenated non-uniform "
                f"tables keep every row routed)")
    return None


def configure_row_shard(op, raw_pc) -> None:
    """Resolve the row-shard plan of ``op`` from its RAW strategy's
    ``param_degree`` (with ``exchange``, ``hot_fraction`` and
    ``overlap``): sets ``op._row_plan`` (None: off) and ``op._hot_rows``
    (replicated hot rows a table; 0: no hybrid). A request that cannot
    run degrades LOUDLY to replicated rows, with the JAX warning naming
    the reason (across ranks the table is then whole on every rank,
    ``_split`` "replicated")."""
    from ..parallel.alltoall import plan_row_shard
    op._row_plan = None
    op._hot_rows = 0
    op._row_ex = None
    pd = getattr(raw_pc, "param_degree", 1) if raw_pc is not None else 1
    if pd <= 1:
        return
    model = op.model
    mesh = getattr(model, "mesh", None)
    rows, pack, tables = op._row_shard_geometry()
    dedup = getattr(raw_pc, "exchange", "dense") == "dedup"
    frac = getattr(raw_pc, "hot_fraction", 0.0)
    host = {o.name for o in getattr(model, "_host_resident_list", ())}
    if mesh is None or mesh.size <= 1:
        reason = "needs a multi-device mesh"
    elif op.name in host:
        reason = "host-resident/offloaded tables cannot row-shard in HBM"
    else:
        reason = row_shard_structural_reason(op, raw_pc,
                                             list(mesh.axis_sizes))
    hot = 0
    if reason is None and frac > 0:
        hot = resolve_hot_rows(rows, pack, pd, frac)
        if hot <= 0:
            log_emb.warning(
                "hot_fraction=%g for %r resolves to no replicable hot "
                "block (rows=%d, lane pack %d, %d shards, quantum %d "
                "rows); executing plain row sharding", frac, op.name,
                rows, pack, pd, HOT_QUANTUM_PACKS * max(pack, 1))
    if reason is None:
        plan = plan_row_shard(mesh, pd, rows - hot, pack, tables,
                              dedup=dedup, hot_rows=hot,
                              overlap=bool(getattr(raw_pc, "overlap",
                                                   False)))
        if plan is not None:
            op._row_plan = plan
            op._hot_rows = hot
            return
        reason = (f"{pd} row shards must factorize mesh axes "
                  f"{list(mesh.axis_sizes)} and divide the {rows} padded "
                  f"rows (lane pack {pack})")
    log_emb.warning(
        "row sharding (param_degree=%d) requested for %r but %s; "
        "executing with replicated rows", pd, op.name, reason)


def _norm_slabs(slabs):
    """{slab: tensor} (the kernel's) or {slab: {param: tensor}} (the
    hybrid's kernel and hot_kernel) -> (kernel slabs, hot slabs or
    None)."""
    if any(isinstance(v, dict) for v in slabs.values()):
        hot = ({n: v["hot_kernel"] for n, v in slabs.items()}
               if any("hot_kernel" in v for v in slabs.values()) else None)
        return {n: v["kernel"] for n, v in slabs.items()}, hot
    return dict(slabs), None


class _RowShardHooks:
    """What the three ops share under row sharding: the plan's geometry
    (``_row_shard_geometry``: logical rows, the JAX op's lane pack,
    tables), the routing of flat global ids (``_row_route``), the routed
    lookup and the routed touched-rows updates. A subclass gives
    ``_row_ids`` (its lookups' flat global ids, (n, bag)) and, with a
    hot split, ``_hot_split_ok``."""

    _row_plan = None
    _hot_rows = 0
    _row_ex = None
    _hot_split_ok = False

    def bind_row_exchange(self, ex):
        """The exchange of this rank (``parallel.alltoall.RowExchange``),
        bound by compile once the process group is there."""
        self._row_ex = ex

    def _row_exchange(self):
        if self._row_ex is None:
            raise ValueError(
                f"{self.name}: a row-sharded table runs on the mesh's "
                f"process group: initialize_distributed() with "
                f"{self._row_plan.ndev} ranks before compile")
        return self._row_ex

    def _row_route(self, g):
        """Flat global ids t*rows + ix -> (owner, local, gid, hot_id), as
        the JAX op's: each shard owns the same cold row block of every
        table; under the hybrid the head of each table (ix < H) is looked
        up in the replicated hot block (owner nshards, gid in a disjoint
        key range, hot_id its flat hot row; hot_id the sentinel on cold
        slots)."""
        plan = self._row_plan
        rows = self.num_entries
        H = self._hot_rows
        rl = plan.rows_local
        ix = g % rows
        t = g // rows
        if H <= 0:
            return ix // rl, t * rl + ix % rl, g, None
        rc = rows - H
        is_hot = ix < H
        cix = (ix - H).clamp(min=0)
        owner = torch.where(is_hot, plan.nshards, cix // rl)
        local = torch.where(is_hot, plan.flat_rows_local, t * rl + cix % rl)
        hid = t * H + ix
        gid = torch.where(is_hot, plan.tables * rc + hid, t * rc + cix)
        hot_id = torch.where(is_hot, hid, plan.hot_rows_flat)
        return owner, local, gid, hot_id

    def _row_lookup(self, params, idx):
        """The routed bags of this rank's lookups: (n, d), n bags."""
        from ..parallel.alltoall import row_sharded_bag_lookup
        owner, local, gid, hot_id = self._row_route(self._row_ids(idx))
        return row_sharded_bag_lookup(
            self._row_exchange(), params["kernel"], owner, local,
            self.out_dim, self.aggr, gid=gid,
            hot_table=params.get("hot_kernel"), hot_id=hot_id)

    def _row_updates(self, idx, out_ct):
        """(route of each lookup, its RAW update row (n, d): its bag's
        cotangent, / bag under avg)."""
        from ..parallel.alltoall import _bag_cotangent_rows
        g = self._row_ids(idx)
        upd = _bag_cotangent_rows(out_ct, g.shape, self.out_dim, self.aggr)
        return self._row_route(g), upd

    def _row_sgd_update(self, params, idx, out_ct, lr, ok):
        from ..parallel.alltoall import row_sharded_sgd_update
        (owner, local, gid, hot_id), upd = self._row_updates(idx, out_ct)
        row_sharded_sgd_update(
            self._row_exchange(), params["kernel"], owner, local, upd, lr,
            gid=gid, hot_table=params.get("hot_kernel"), hot_id=hot_id,
            ok=ok)
        return params

    def _row_opt_update(self, params, idx, out_ct, opt, slabs, step, ok):
        from ..parallel.alltoall import row_sharded_opt_update
        (owner, local, gid, hot_id), upd = self._row_updates(idx, out_ct)
        kslabs, hslabs = _norm_slabs(slabs)
        row_sharded_opt_update(
            self._row_exchange(), params["kernel"], kslabs, owner, local,
            upd, opt, step, gid=gid, hot_table=params.get("hot_kernel"),
            hot_slabs=hslabs, hot_id=hot_id, ok=ok)
        return params

    def _row_block(self, logical):
        """This rank's parameters from the whole logical table (rows
        first on its last-but-one dim): the cold rows [H + s*rl, H +
        (s+1)*rl) and, under the hybrid, the head [0, H)."""
        plan, H = self._row_plan, self._hot_rows
        s = self._row_exchange().shard
        lo = H + s * plan.rows_local
        out = {"kernel": logical[..., lo:lo + plan.rows_local, :].clone()}
        if H > 0:
            out["hot_kernel"] = logical[..., :H, :].clone()
        return out

    def _row_whole(self, params):
        """The whole logical table from every shard's cold block (and the
        hot head): what one card holds."""
        from ..parallel.split import gather_pieces
        plan = self._row_plan
        out = gather_pieces(self._row_exchange().coll, plan.mesh,
                            plan.row_axes, params["kernel"], -2)
        if self._hot_rows > 0:
            out = torch.cat([params["hot_kernel"], out], dim=-2)
        return {"kernel": out}


class _SplitHooks:
    """What the three ops share when compile splits them across ranks
    other than by row shards (``parallel.split.OpSplit``, ``_split``):
    the kind and the replicated update's global batch."""

    _split = None

    def bind_split(self, split):
        """This rank's side of the op's split (None: whole on one card),
        bound by compile once the process group is there."""
        self._split = split

    def _split_kind(self):
        return None if self._split is None else self._split.kind

    def _global_batch(self, xs, out_ct):
        """A replicated table's update inputs: the ids and the cotangent
        of the whole global batch, in rank order (two all-gathers)."""
        s = self._split
        return ([s.gather_batch(xs[0].contiguous())],
                s.gather_batch(out_ct.contiguous()))


class Embedding(_RowShardHooks, _SplitHooks, Op):
    """One table, (num_entries, out_dim). With ``aggr`` "sum" or "avg":
    int ids (batch, bag) -> (batch, out_dim), the sum or mean over the
    bag, gathered on the card by the embedding-bag kernel (any
    d % 4 == 0). With ``aggr="none"``: ids (batch, slots) -> (batch,
    slots, out_dim), one row per slot, gathered by plain torch indexing
    as the JAX op gathers it outside any Pallas kernel
    (``jnp.take(mode="wrap")``). Ids wrap ``% num_entries`` (floor-mod),
    as the JAX op's XLA path does; its Pallas path does not wrap, and
    the two agree on in-range ids.

    Row-sharded across ranks (``configure_row_shard``): ``kernel`` is
    the rank's cold block, (rows_local, d), and under the hybrid
    ``hot_kernel`` the replicated head, (H, d); the lookup and the
    updates route through ``parallel.alltoall``. Split by width (the
    JAX op's ``(1, dc)``, its ``param_axes``): ``kernel`` is the rank's
    columns, (num_entries, d / dc); replicated: the whole table."""

    type_name = "Embed"
    _hot_split_ok = True

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
        plan, H = self._row_plan, self._hot_rows
        if plan is None:
            d = self.out_dim
            if self._split_kind() == "width":
                d //= self._split.nblocks
            return {"kernel": ParamDef((self.num_entries, d), torch.float32,
                                       self.kernel_initializer)}
        out = {"kernel": ParamDef((plan.rows_local, self.out_dim),
                                  torch.float32, self.kernel_initializer)}
        if H > 0:
            out["hot_kernel"] = ParamDef((H, self.out_dim), torch.float32,
                                         self.kernel_initializer)
        return out

    def init_params(self, generator, device):
        if self._split_kind() == "width":
            # the whole table drawn as on one card, this rank's columns
            # kept
            whole = self.kernel_initializer(
                generator, (self.num_entries, self.out_dim), torch.float32,
                device)
            return {"kernel": whole[:, self._split.columns(
                self.out_dim)].contiguous()}
        if self._row_plan is None:
            return super().init_params(generator, device)
        # the whole table drawn as on one card, this rank's rows kept
        return self._row_block(self.kernel_initializer(
            generator, (self.num_entries, self.out_dim), torch.float32,
            device))

    def _ids(self, idx):
        return torch.remainder(idx.long(), self.num_entries)

    # ---- row sharding hooks (see configure_row_shard) ---------------
    def _row_shard_geometry(self):
        return self.num_entries, 1, 1

    def _row_ids(self, idx):
        return self._ids(idx)

    def apply(self, params, xs):
        (idx,) = xs                       # (batch, bag)
        if self._row_plan is not None:
            return [self._row_lookup(params, idx)]
        if self._split_kind() == "width":
            return [self._width_lookup(params, idx)[0]]
        if self.aggr == AGGR_MODE_NONE:
            return [params["kernel"][self._ids(idx)]]
        return [EmbeddingBagFunction.apply(params["kernel"], self._ids(idx),
                                           self.aggr)]

    def _width_lookup(self, params, idx):
        """Split by width: (this rank's rows of the lookup, every column;
        the global batch's wrapped ids). The bag kernel (or, for "none",
        a gather) runs on the rank's columns for the global batch, and
        one all-to-all hands each rank its rows."""
        s = self._split
        ids = self._ids(s.gather_batch(idx.contiguous()))
        if self.aggr == AGGR_MODE_NONE:
            y = params["kernel"][ids]
        else:
            y = embedding_bag(params["kernel"], ids, self.aggr)
        return s.to_rows(y), ids

    def whole_params(self, params):
        """The op's parameters as one card holds them, gathered from the
        ranks; None when this rank holds them whole."""
        if self._row_plan is not None:
            return self._row_whole(params)
        if self._split_kind() == "width":
            return {"kernel": self._split.gather_pieces(params["kernel"],
                                                        -1)}
        return None

    # ---- delta publication (utils/delta.py) -------------------------
    def lookup_id_space(self) -> int:
        return self.num_entries

    def flat_lookup_ids(self, idx_np) -> np.ndarray:
        """Batch ids -> the flat lookup-id space (wrapped)."""
        return (np.asarray(idx_np).astype(np.int64).reshape(-1)
                % self.num_entries)

    def delta_touched_rows(self, idx_np) -> np.ndarray:
        """The table rows a touched-rows update of this batch may change
        (the JAX op stores the table unpacked, as the port does). Under
        the row-sharded hybrid ``kernel`` holds the cold rows only: the
        ids past the hot head, offset by it (the replicated ``hot_kernel``
        is diffed whole)."""
        g = self.flat_lookup_ids(idx_np)
        H = self._hot_rows
        if H > 0:
            g = g[g >= H] - H
        return np.unique(g)

    # ---- host-resident table (FFConfig.host_resident_tables) --------
    # per-slot (aggr="none") outputs work on the host path too
    host_aggr_none_ok = True

    def host_init(self, seed: int):
        return {"kernel": _host_init_table(
            self.kernel_initializer, (self.num_entries, self.out_dim), seed)}

    def host_delta_touched_rows(self, idx_np) -> np.ndarray:
        """The host table's rows this batch reads (and its update may
        change): the host table is (num_entries, out_dim), unpacked."""
        return np.unique(self.flat_lookup_ids(idx_np))

    def host_flat_indices(self, idx_np):
        """Per-sample flat row ids, (batch, 1, bag)."""
        g = np.asarray(idx_np).astype(np.int64) % self.num_entries
        if g.ndim == 1:
            g = g[:, None]
        return g[:, None, :]

    def host_lookup_rows(self, rows_2d, g3):
        """``host_lookup`` against a (rows, d) row matrix and flat ids."""
        if self.aggr == AGGR_MODE_NONE:
            # per-slot outputs: no reduction, (batch, bag, d)
            return np.ascontiguousarray(rows_2d[g3[:, 0]], np.float32)
        return _host_bag_lookup(rows_2d, g3, self.aggr)[:, 0]  # (batch,d)

    def host_lookup(self, host_params, idx_np):
        return self.host_lookup_rows(host_params["kernel"],
                                     self.host_flat_indices(idx_np))

    def host_sgd_update(self, host_params, idx_np, ct_np, lr):
        g = np.asarray(idx_np).astype(np.int64) % self.num_entries
        if g.ndim == 1:
            g = g[:, None]
        if self.aggr == AGGR_MODE_NONE:
            # ct (batch, bag, d): each slot's cotangent lands on its row
            np.add.at(host_params["kernel"], g.reshape(-1),
                      -lr * ct_np.reshape(-1, self.out_dim))
            return
        _host_bag_update(host_params["kernel"], g[:, None, :],
                         ct_np[:, None, :], lr, self.aggr)

    def host_opt_update(self, host_params, idx_np, ct_np, opt, slabs,
                        step):
        """The lazy stateful (momentum, Adam) host update."""
        g = np.asarray(idx_np).astype(np.int64) % self.num_entries
        if g.ndim == 1:
            g = g[:, None]
        if self.aggr == AGGR_MODE_NONE:
            uniq, summed = _host_dedup_rows(
                g.reshape(-1), ct_np.reshape(-1, self.out_dim))
            tbl = host_params["kernel"]
            slab_rows = {k: v[uniq] for k, v in slabs.items()}
            wn, sn = opt.sparse_row_update_np(tbl[uniq], summed,
                                              slab_rows, step)
            tbl[uniq] = wn
            for k in slabs:
                slabs[k][uniq] = sn[k]
            return
        _host_stateful_update(host_params["kernel"], g[:, None, :],
                              ct_np[:, None, :], opt, slabs, step,
                              self.aggr)

    # ---- touched-rows updates -------------------------------------------
    def supports_sparse_update(self) -> bool:
        return self.aggr in (AGGR_MODE_SUM, AGGR_MODE_AVG, AGGR_MODE_NONE)

    def apply_with_fwd(self, params, xs):
        """apply() and no residual: the JAX op keeps the gathered rows
        only for 128-wide rows on its TPU path, so the update here always
        reads the table (the read-modify-write scatter). Split by width:
        the global batch's ids, which the update takes."""
        if self._split_kind() == "width":
            out, ids = self._width_lookup(params, xs[0])
            return [out], ids
        return self.apply(params, xs), None

    def _update_inputs(self, params, xs, out_ct, fwd):
        """(each lookup's wrapped id (n,), the update rows (n / div, d of
        the kernel): a slot's cotangent with "none", a bag's, / bag for
        "avg", otherwise; div). Split by width: the global batch's ids
        (``fwd``) and its cotangent of the rank's columns (the reverse
        all-to-all); replicated: the global batch's ids and cotangent."""
        (idx,) = xs
        kind = self._split_kind()
        if kind == "width":
            if fwd is None:
                fwd = self._ids(self._split.gather_batch(idx.contiguous()))
            idx, out_ct = fwd, self._split.from_rows(out_ct)
        elif kind == "replicated":
            (idx,), out_ct = self._global_batch(xs, out_ct)
        table = params["kernel"]
        ct = out_ct.to(table.dtype).reshape(-1, table.shape[-1])
        div = 1
        if self.aggr != AGGR_MODE_NONE:
            div = idx.shape[-1]
            if self.aggr == AGGR_MODE_AVG:
                ct = ct / div
        return self._ids(idx).reshape(-1), ct, div

    @torch.no_grad()
    def sparse_sgd_update(self, params, xs, out_ct, lr, fwd=None, ok=None):
        """table[row] -= lr * ct for the touched rows only, in place: with
        "none" each slot's cotangent row; with "sum"/"avg" the bag's
        cotangent (/ bag for "avg") for every row of the bag. A row's
        duplicates sum in lookup order before they land, on the
        read-modify-write scatter kernel on the card. Split by width or
        replicated: ``_update_inputs``'s global batch."""
        if self._row_plan is not None:
            return self._row_sgd_update(params, xs[0], out_ct, lr, ok)
        ids, ct, div = self._update_inputs(params, xs, out_ct, fwd)
        scatter_add_rows(params["kernel"], ids, ct, scale=-lr, div=div,
                         ids_in_range=True, ok=ok)   # wrapped by _ids
        return params

    @torch.no_grad()
    def split_dense_grad(self, params, xs, out_ct, fwd=None):
        """Split by width, the gradient of the rank's columns for a dense
        table update: the global batch's update rows summed into a zero
        piece in sorted order (``segment_sum_rows``, kernel 3), as the
        bag's backward sums the whole table's on one card."""
        ids, ct, div = self._update_inputs(params, xs, out_ct, fwd)
        return {"kernel": segment_sum_rows(ids, ct, self.num_entries,
                                           div)}

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
        table row is read (no residual: ``apply_with_fwd`` keeps none).
        Row-sharded, ``slabs`` may nest {slab: {param: tensor}} to carry
        the hybrid's ``hot_kernel`` state. Split by width: the rank's
        columns and their state, from ``_update_inputs``' global batch
        (the row math is elementwise, so the piece takes the columns of
        the whole row's update); replicated: the global batch."""
        if self._row_plan is not None:
            return self._row_opt_update(params, xs[0], out_ct, opt, slabs,
                                        step, ok)
        ids, ct, div = self._update_inputs(params, xs, out_ct, fwd)
        stateful_update_rows(params["kernel"], ids, ct, None, slabs,
                             opt.row_params(), opt.alpha_t(step), div=div,
                             ids_in_range=True, ok=ok)   # wrapped by _ids
        return params


class _FlatTableBag(_RowShardHooks, _SplitHooks, Op):
    """What ``EmbeddingBagStacked`` and ``EmbeddingBagConcat`` share: T
    bags over one flat (rows, d) view of the tables, looked up by global
    row ids in one bag-kernel launch and updated in one scatter, on the
    card or, for a host-resident table, in host RAM; row-sharded across
    ranks, through the exchange of ``parallel.alltoall``. A subclass
    gives the ids (``_global_ids``, ``host_flat_indices``) and ``_flat``,
    the flat view of its kernel, of an optimizer slab shaped like it, and
    of its host table."""

    def _flat(self, t):
        raise NotImplementedError

    def _row_ids(self, idx):
        return self._global_ids(idx)

    def apply(self, params, xs):
        (idx,) = xs                       # (batch, T, bag)
        if self._row_plan is not None:
            return [self._row_lookup(params, idx).reshape(
                idx.shape[0], self.num_tables, self.out_dim)]
        out = EmbeddingBagFunction.apply(self._flat(params["kernel"]),
                                         self._global_ids(idx), self.aggr)
        return [out.reshape(idx.shape[0], self.num_tables, self.out_dim)]

    # ---- delta publication (utils/delta.py) -------------------------
    def flat_lookup_ids(self, idx_np) -> np.ndarray:
        """(batch, T, bag) ids -> flat lookup ids into the flat table."""
        return self.host_flat_indices(idx_np).reshape(-1)

    # ---- host-resident table (FFConfig.host_resident_tables) --------
    def host_delta_touched_rows(self, idx_np) -> np.ndarray:
        return np.unique(self.flat_lookup_ids(idx_np))

    def host_lookup_rows(self, rows_2d, g3):
        return _host_bag_lookup(rows_2d, g3, self.aggr)

    def host_lookup(self, host_params, idx_np):
        return self.host_lookup_rows(self._flat(host_params["kernel"]),
                                     self.host_flat_indices(idx_np))

    def host_sgd_update(self, host_params, idx_np, ct_np, lr):
        _host_bag_update(self._flat(host_params["kernel"]),
                         self.host_flat_indices(idx_np), ct_np, lr,
                         self.aggr)

    def host_opt_update(self, host_params, idx_np, ct_np, opt, slabs,
                        step):
        _host_stateful_update(
            self._flat(host_params["kernel"]), self.host_flat_indices(idx_np),
            ct_np, opt, {k: self._flat(v) for k, v in slabs.items()}, step,
            self.aggr)

    # ---- touched-rows updates -------------------------------------------
    def supports_sparse_update(self) -> bool:
        return True                       # sum and avg, the only aggrs

    def apply_with_fwd(self, params, xs):
        """apply() plus the forward residual: (global row ids (n,), the
        gathered rows (n, d)), both in (batch, T, bag) order — the order
        ``sparse_sgd_update`` applies its updates in. Row-sharded or
        replicated across ranks: no residual (the update routes its own
        rows, or takes the global batch's)."""
        if self._row_plan is not None or self._split is not None:
            return self.apply(params, xs), None
        (idx,) = xs
        gid = self._global_ids(idx)
        out, rows = embedding_bag(self._flat(params["kernel"]), gid,
                                  self.aggr, return_rows=True)
        out = out.reshape(idx.shape[0], self.num_tables, self.out_dim)
        return [out], (gid.reshape(-1), rows)

    def _update_rows(self, params, xs, out_ct, fwd):
        """(bag, each lookup's cotangent (n, d), / bag for "avg", and
        (global row ids (n,), the gathered rows or None))."""
        (idx,) = xs
        bag = idx.shape[2]
        ct = out_ct.to(params["kernel"].dtype).reshape(-1, self.out_dim)
        if self.aggr == AGGR_MODE_AVG:
            ct = ct / bag
        if fwd is None:
            fwd = (self._global_ids(idx).reshape(-1), None)
        return bag, ct, fwd

    @torch.no_grad()
    def sparse_sgd_update(self, params, xs, out_ct, lr, fwd=None, ok=None):
        """table[row] -= lr * ct, for the touched rows only, in place:
        each lookup's update is -lr * (its bag's cotangent, / bag for
        "avg"), and a row's duplicates sum in lookup order before they
        land. With the residual of ``apply_with_fwd`` the write-only
        kernel writes fwd_row + sum; without it the read-modify-write
        kernel adds the sum to the table. Row-sharded: the routed
        update (``parallel.alltoall.row_sharded_sgd_update``);
        replicated across ranks: the global batch's ids and cotangent,
        on the read-modify-write kernel."""
        if self._row_plan is not None:
            return self._row_sgd_update(params, xs[0], out_ct, lr, ok)
        if self._split_kind() == "replicated":
            xs, out_ct = self._global_batch(xs, out_ct)
            fwd = None
        bag, ct, (gid, rows) = self._update_rows(params, xs, out_ct, fwd)
        table = self._flat(params["kernel"])
        if rows is not None:
            scatter_write_rows(table, gid, ct, rows, scale=-lr, div=bag,
                               ids_in_range=True, ok=ok)   # wrapped ids
        else:
            scatter_add_rows(table, gid, ct, scale=-lr, div=bag,
                             ids_in_range=True, ok=ok)   # wrapped ids
        return params

    @torch.no_grad()
    def sparse_opt_update(self, params, xs, out_ct, opt, slabs, step,
                          fwd=None, ok=None):
        """The stateful touched-rows update, in place on the tables and on
        ``slabs`` ({slab name: state shaped as the kernel}): each
        lookup's update is its bag's RAW cotangent (/ bag for "avg"), a
        row's duplicates summed in lookup order, then the optimizer's row
        math on that row's weight (the residual of ``apply_with_fwd``
        when given, else the table row) and state; untouched rows keep
        both. ``step``: the optimizer's step before this one.
        Row-sharded: the routed update (``row_sharded_opt_update``);
        ``slabs`` may nest {slab: {param: tensor}} for the hybrid.
        Replicated across ranks: the global batch's ids and cotangent."""
        if self._row_plan is not None:
            return self._row_opt_update(params, xs[0], out_ct, opt, slabs,
                                        step, ok)
        if self._split_kind() == "replicated":
            xs, out_ct = self._global_batch(xs, out_ct)
            fwd = None
        bag, ct, (gid, rows) = self._update_rows(params, xs, out_ct, fwd)
        stateful_update_rows(
            self._flat(params["kernel"]), gid, ct, rows,
            {k: self._flat(v) for k, v in slabs.items()},
            opt.row_params(), opt.alpha_t(step), div=bag,
            ids_in_range=True, ok=ok)   # wrapped ids
        return params


class EmbeddingBagStacked(_FlatTableBag):
    """input: int (batch, num_tables, bag) -> (batch, num_tables, dim).

    The port stores the tables in logical order. The JAX op permutes ids
    and cotangent into its storage order before a touched-rows update; a
    row's lookups keep their relative order under that permutation (all
    of them lie in one table), so its sums, and the result, are the
    same.

    Table parallelism over D ranks (``bind_split`` with an ``OpSplit`` of
    kind "table", ``_tsplit``, set by ``compile``
    when the strategy splits the table dim over D of the mesh's ranks,
    the mesh axes of the output's table dim): block k holds the storage
    slots [k·T/D, (k+1)·T/D), slot s holding logical table ``order[s]``
    (``set_table_order``), as the JAX op's stored kernel split in D
    blocks; its ``kernel`` is (T/D, rows, d) in slot order. Each rank has
    its rows of the batch, all T tables. The forward sends each rank of
    its group (the D ranks that differ from it on the table axes alone,
    one a block) its tables' ids (one ``all_to_all_single``), looks them
    up for the group's rows with the bag kernel, and sends the bags back
    to the ranks whose rows they are (a second one). The touched-rows SGD
    update sends the cotangent the reverse way (a third); where D is
    less than the mesh, the copies of the block (the other axes) gather
    each other's ids and cotangents (two all-gathers), so that every
    copy takes the whole global batch. It then runs the windowed scatter
    (``sharded_scatter_add_rows``, kernel 4) on the rank's block with
    global stacked ids slot·rows + id, in the (batch, table, bag) order
    of the JAX op's ``gidx``, or under a stateful optimizer kernel 2's
    stateful entry over the same window (``stateful_update_rows(lo=)``)
    on the block and its state slabs, with the raw cotangent. The write
    route is closed there, as in the JAX op (``_fwd_residual_ok`` needs
    an unsharded table). With D = 1 the tables are replicated on every
    rank (``_split``).

    Row sharding across ranks (``configure_row_shard``) splits the rows
    of every table instead: ``kernel`` is the rank's cold block of each
    table, (T, rows_local, d) in logical table order, and under the
    hybrid ``hot_kernel`` the replicated head, (T, H, d). Lookup ids keep
    the logical table order (a row's lookups keep their relative order
    under the JAX storage permutation, so the canonical order, and the
    result, are the same)."""

    type_name = "EmbedStack"
    _hot_split_ok = True

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

    # ---- table parallelism across ranks -----------------------------
    def bind_split(self, split):
        """As ``_SplitHooks.bind_split``; a "table" split must divide the
        tables in equal blocks."""
        if split is not None and split.kind == "table" \
                and self.num_tables % split.nblocks:
            raise ValueError(f"{self.name}: {self.num_tables} tables do not "
                             f"split over {split.nblocks} ranks")
        super().bind_split(split)

    @property
    def _tsplit(self):
        """The table split (kind "table") when the op has one, else None."""
        return self._split if self._split_kind() == "table" else None

    @property
    def local_tables(self) -> int:
        """Tables this rank holds."""
        s = self._tsplit
        return self.num_tables // (s.nblocks if s is not None else 1)

    def local_slots(self) -> range:
        """The storage slots this rank holds (every table's, unsharded)."""
        s = self._tsplit
        if s is None:
            return range(self.num_tables)
        tl = self.local_tables
        return range(s.block * tl, (s.block + 1) * tl)

    def _order(self, device):
        """Storage slot -> logical table, as a tensor on ``device``."""
        order = self._table_order or tuple(range(self.num_tables))
        return torch.tensor(order, dtype=torch.int64, device=device)

    def param_defs(self):
        plan, H = self._row_plan, self._hot_rows
        if plan is not None:
            out = {"kernel": ParamDef(
                (self.num_tables, plan.rows_local, self.out_dim),
                torch.float32, self.kernel_initializer)}
            if H > 0:
                out["hot_kernel"] = ParamDef(
                    (self.num_tables, H, self.out_dim), torch.float32,
                    self.kernel_initializer)
            return out
        return {"kernel": ParamDef(
            (self.local_tables, self.num_entries, self.out_dim),
            torch.float32, self.kernel_initializer)}

    def _row_shard_geometry(self):
        from ..utils.weights import _pack_factor
        return (self.num_entries, _pack_factor(self.out_dim,
                                               self.num_entries),
                self.num_tables)

    def init_params(self, generator, device):
        if self._row_plan is not None:
            # every table drawn whole, in logical order, as on one card;
            # this rank's rows of each kept
            blocks = [self._row_block(self.kernel_initializer(
                generator, (self.num_entries, self.out_dim), torch.float32,
                device)) for _ in range(self.num_tables)]
            return {pn: torch.stack([b[pn] for b in blocks])
                    for pn in blocks[0]}
        # each table at its own (rows, d) shape, so shape-dependent
        # initializers (Glorot fans) match the JAX op's per-table draws;
        # a rank holding some tables draws them all, in logical order, and
        # keeps its own, so every rank and a single card agree
        if self._tsplit is None:       # every table, in logical order
            return {"kernel": torch.stack([
                self.kernel_initializer(generator,
                                        (self.num_entries, self.out_dim),
                                        torch.float32, device)
                for _ in range(self.num_tables)])}
        order = self._table_order or tuple(range(self.num_tables))
        mine = {order[s]: s for s in self.local_slots()}
        kept = {}
        for t in range(self.num_tables):
            table = self.kernel_initializer(
                generator, (self.num_entries, self.out_dim), torch.float32,
                device)
            if t in mine:
                kept[mine[t]] = table
        return {"kernel": torch.stack([kept[s] for s in self.local_slots()])}

    def _global_ids(self, idx):
        """(batch, T, bag) ids -> (batch*T, bag) rows of the stacked
        (T*rows, d) view: ids wrap into each table as jnp's floor-mod %
        does (negative ids too), then offset by t*rows."""
        offs = torch.arange(self.num_tables, device=idx.device,
                            dtype=torch.int64) * self.num_entries
        flat = torch.remainder(idx.long(), self.num_entries) \
            + offs[None, :, None]
        return flat.reshape(-1, idx.shape[2])

    def _flat(self, t):
        # (T, rows, d) -> the stacked (T*rows, d) view (the rank's tables
        # under table parallelism)
        return t.reshape(-1, self.out_dim)

    # ---- the table-parallel lookup and update ---------------------------
    def apply(self, params, xs):
        if self._tsplit is None:
            return super().apply(params, xs)
        return self.apply_with_fwd(params, xs)[0]

    def apply_with_fwd(self, params, xs):
        s = self._tsplit
        if s is None:
            return super().apply_with_fwd(params, xs)
        (idx,) = xs                        # this rank's rows, (b, T, bag)
        block, blocks, coll, group = s.block, s.nblocks, s.coll, s.group
        b, T, bag = idx.shape
        tl, rows, d = self.local_tables, self.num_entries, self.out_dim
        order = self._order(idx.device)
        # chunk j: this rank's ids of block j's slots
        send = idx.long().index_select(1, order).reshape(b, blocks, tl, bag)
        # (blocks, b, tl, bag)
        got = coll.all_to_all(send.transpose(0, 1), group)
        local = torch.remainder(got.reshape(blocks * b, tl, bag), rows) \
            + (torch.arange(tl, device=idx.device) * rows)[None, :, None]
        rows_out = embedding_bag(self._flat(params["kernel"]),
                                 local.reshape(-1, bag), self.aggr)
        # chunk j: the bags of rank j's rows, back to it
        back = coll.all_to_all(rows_out.reshape(blocks, b, tl, d), group)
        out = back.transpose(0, 1).reshape(b, T, d).index_select(
            1, torch.argsort(order))
        gid = local + block * tl * rows        # global stacked row ids
        return [out], (gid.reshape(-1), None)

    def _table_exchange(self, params, xs, out_ct, fwd):
        """The table split's update inputs: (the global stacked row ids of
        the lookups the block's copies take, (n,); their cotangent rows,
        (n / bag, d), / bag for "avg"; the block's first row lo; bag)."""
        s = self._tsplit
        if fwd is None:
            raise ValueError(f"{self.name}: the table-parallel update takes "
                             f"the ids of apply_with_fwd (fwd)")
        (idx,) = xs
        block, blocks, coll = s.block, s.nblocks, s.coll
        b, T, bag = idx.shape
        tl, d = self.local_tables, self.out_dim
        ct = out_ct.to(params["kernel"].dtype)
        if self.aggr == AGGR_MODE_AVG:
            ct = ct / bag
        # chunk j: this rank's cotangents of block j's slots
        send = ct.index_select(1, self._order(ct.device)).reshape(
            b, blocks, tl, d)
        # (blocks, b, tl, d)
        got = coll.all_to_all(send.transpose(0, 1), s.group)
        gid = fwd[0]
        if s.ncopies > 1:
            # the block's copies: every one takes the whole global batch,
            # its chunks put in rank order (the JAX op's gidx order)
            perm = torch.tensor(s.perm, device=got.device)
            got = coll.all_gather(got.contiguous(), s.copies,
                                  s.ncopies)[perm]
            gid = coll.all_gather(gid.reshape(blocks, -1), s.copies,
                                  s.ncopies)[perm]
        return (gid.reshape(-1), got.reshape(-1, d),
                block * tl * self.num_entries, bag)

    @torch.no_grad()
    def sparse_sgd_update(self, params, xs, out_ct, lr, fwd=None, ok=None):
        if self._tsplit is None:
            return super().sparse_sgd_update(params, xs, out_ct, lr, fwd, ok)
        gid, ct, lo, bag = self._table_exchange(params, xs, out_ct, fwd)
        sharded_scatter_add_rows(self._flat(params["kernel"]), gid, ct,
                                 lo=lo, scale=-lr, div=bag, ok=ok)
        return params

    @torch.no_grad()
    def sparse_opt_update(self, params, xs, out_ct, opt, slabs, step,
                          fwd=None, ok=None):
        if self._tsplit is None:
            return super().sparse_opt_update(params, xs, out_ct, opt, slabs,
                                             step, fwd, ok)
        gid, ct, lo, bag = self._table_exchange(params, xs, out_ct, fwd)
        stateful_update_rows(
            self._flat(params["kernel"]), gid, ct, None,
            {k: self._flat(v) for k, v in slabs.items()}, opt.row_params(),
            opt.alpha_t(step), div=bag, lo=lo, ok=ok)
        return params

    @torch.no_grad()
    def split_dense_grad(self, params, xs, out_ct, fwd=None):
        """Split by table, the gradient of the rank's block for a dense
        table update: the exchange's cotangent rows summed into a zero
        block by kernel 4 at scale 1."""
        gid, ct, lo, bag = self._table_exchange(params, xs, out_ct, fwd)
        kernel = params["kernel"]
        g = torch.zeros_like(kernel)
        sharded_scatter_add_rows(self._flat(g), gid, ct, lo=lo, div=bag)
        return {"kernel": g}

    def whole_params(self, params):
        """The op's parameters as one card holds them (every table, in
        logical order), gathered from the ranks; None when this rank
        holds them whole."""
        if self._row_plan is not None:
            return self._row_whole(params)
        if self._tsplit is None:
            return None
        slots = self._tsplit.gather_pieces(params["kernel"], 0)
        return {"kernel": slots.index_select(
            0, torch.argsort(self._order(slots.device)))}

    # ---- delta publication (utils/delta.py) -------------------------
    def lookup_id_space(self) -> int:
        return self.num_tables * self.num_entries

    def delta_touched_rows(self, idx_np) -> np.ndarray:
        """The rows of the JAX op's stored kernel, (T, rows/r, r*d)
        flattened to (T*rows/r, r*d), that this batch touches: logical
        table t lives at stored slot inv[t] (``_table_order``'s
        inverse), logical row ix at packed row ix // r of that slot.
        Under the row-sharded hybrid ``kernel`` holds the cold rows of
        each table only, (T, (rows - H)/r, r*d): the ids past the hot
        head H, offset by it (the replicated ``hot_kernel`` is diffed
        whole), as the JAX op maps them."""
        from ..utils.weights import _pack_factor
        r, rows = _pack_factor(self.out_dim, self.num_entries), \
            self.num_entries
        g = np.asarray(idx_np).astype(np.int64) % rows   # (batch, T, bag)
        slot = np.arange(self.num_tables, dtype=np.int64)
        if self._table_order is not None:
            slot = np.argsort(np.asarray(self._table_order)).astype(np.int64)
        H = self._hot_rows
        if H > 0:
            flat = slot[None, :, None] * ((rows - H) // r) + (g - H) // r
            return np.unique(flat.reshape(-1)[g.reshape(-1) >= H])
        flat = slot[None, :, None] * (rows // r) + g // r
        return np.unique(flat.reshape(-1))

    # ---- host-resident table (FFConfig.host_resident_tables) --------
    # the host table is (T, rows, d) in logical table order, unpacked
    def host_init(self, seed: int):
        return {"kernel": _host_init_table(
            self.kernel_initializer,
            (self.num_tables, self.num_entries, self.out_dim), seed)}

    def host_flat_indices(self, idx_np):
        """Per-sample flat row ids, (batch, T, bag), into the (T*rows, d)
        flattened table: t*rows + ix."""
        offs = (np.arange(self.num_tables, dtype=np.int64)
                * self.num_entries)[None, :, None]
        return np.asarray(idx_np).astype(np.int64) % self.num_entries + offs


class EmbeddingBagConcat(_FlatTableBag):
    """T tables of one width and different row counts, concatenated
    row-wise into one (total_rows, d) table: each lookup wraps into its
    table (``% table_sizes[t]``) and adds the table's row offset, so the
    T gathers are ONE bag-kernel launch over (batch·T, bag) global ids and
    the update one scatter (the non-uniform form of
    ``EmbeddingBagStacked``: Criteo-Kaggle's 26 tables of 4 to 3.2M
    rows).

    As in the JAX op, the total is padded up to a multiple of
    ``_ROW_PAD`` rows (the pad rows are zero and no id reaches them), the
    tables lie at ``_offsets`` in order, and each is initialized at its
    own (rows_t, d) shape, so a shape-dependent initializer scales each
    table as the per-table ops would. The JAX op stores the table
    lane-packed as (total_rows/r, r·d) (``_pack_factor``); the port keeps
    it logical, and ``utils.weights`` carries it across by a reshape.

    Row-sharded across ranks (``configure_row_shard``), ``kernel`` is the
    rank's block of the concatenated rows, (total_rows / degree, d),
    routed by concatenated row id; there is no hot split, as in the JAX
    op. Split in row blocks over the whole mesh (the strategy's table
    degree above 1, the JAX op's ``param_axes``; ``_split`` "rows"),
    ``kernel`` is the rank's equal block, (total_rows / W, d), rank k
    holding rows [k·total_rows/W, (k+1)·total_rows/W): with device groups
    (``set_device_groups``) block k is the k-th group's tables when the
    groups are as many as the ranks. Its output is batch-split over the
    whole mesh, as its data-parallel consumers'.

    input: int (batch, T, bag) -> (batch, T, d)."""

    type_name = "EmbedConcat"

    # the table-dim degree is intent ("split the concatenated rows"), not
    # an output split: compile() clamps it without a warning, as in JAX
    raw_degree_semantics = True

    # row padding so the concatenated row count divides any power-of-two
    # mesh (the JAX op shards it over one)
    _ROW_PAD = 8192

    def __init__(self, model, input_tensor, table_sizes, out_dim: int,
                 aggr: str = AGGR_MODE_SUM, kernel_initializer=None,
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        self.table_sizes = tuple(int(s) for s in table_sizes)
        self.num_tables = len(self.table_sizes)
        if input_tensor.num_dims != 3 \
                or input_tensor.shape[1] != self.num_tables:
            raise ValueError(f"EmbeddingBagConcat expects (batch, "
                             f"{self.num_tables}, bag) ids, got "
                             f"{input_tensor.shape}")
        if aggr not in (AGGR_MODE_SUM, AGGR_MODE_AVG):
            raise ValueError(f"EmbeddingBagConcat aggr expects sum|avg, "
                             f"got {aggr!r}")
        self.out_dim = int(out_dim)
        self.aggr = aggr
        self.kernel_initializer = kernel_initializer or GlorotUniform()
        total = sum(self.table_sizes)
        self.total_rows = -(-total // self._ROW_PAD) * self._ROW_PAD
        offs = [0]
        for s in self.table_sizes[:-1]:
            offs.append(offs[-1] + s)
        self._offsets = tuple(offs)
        self._consts = {}       # device -> (sizes, offsets) as tensors
        batch = input_tensor.shape[0]
        self.outputs = [self._make_output(
            (batch, self.num_tables, self.out_dim))]

    def set_device_groups(self, dev_of):
        """Group the tables by their strategy device (``dev_of[i]``, table
        i's), as the JAX op does: row block k holds exactly the tables the
        strategy places on the k-th named device, in table order, each
        block padded to one common size rounded up to ``_ROW_PAD``, so an
        equal split of the rows over as many ranks lands every table whole
        on its device (the reference's per-table placement,
        dlrm_strategy.cc:242-296). Recomputes ``_offsets`` and
        ``total_rows``; call it before the parameters are drawn (compile
        does)."""
        if len(dev_of) != self.num_tables:
            raise ValueError(f"{self.name}: {len(dev_of)} devices for "
                             f"{self.num_tables} tables")
        devs = sorted(set(dev_of))
        groups = [[i for i, dg in enumerate(dev_of) if dg == g]
                  for g in devs]
        block = max(sum(self.table_sizes[i] for i in grp)
                    for grp in groups)
        block = -(-block // self._ROW_PAD) * self._ROW_PAD
        offs = [0] * self.num_tables
        for k, grp in enumerate(groups):
            off = k * block
            for i in grp:
                offs[i] = off
                off += self.table_sizes[i]
        self._offsets = tuple(offs)
        self.total_rows = block * len(groups)
        self._device_groups = tuple(devs)
        self._consts = {}

    def output_axes(self, pc, assigner, raw_pc=None):
        """The JAX op's layout: under table parallelism (the RAW
        degrees[1] > 1) its rows split over the whole mesh and its output
        is batch-split over every axis, as its data-parallel consumers'
        (when the batch divides)."""
        raw = raw_pc or pc
        if len(raw.degrees) > 1 and raw.degrees[1] > 1 \
                and self.outputs[0].shape[0] % assigner.mesh.size == 0:
            return [tuple(assigner.axis_names), (), ()]
        return assigner.assign(pc.degrees)

    def param_defs(self):
        rows = self.total_rows
        if self._row_plan is not None:
            rows = self._row_plan.rows_local
        elif self._split_kind() == "rows":
            rows //= self._split.nblocks
        return {"kernel": ParamDef((rows, self.out_dim), torch.float32,
                                   self.kernel_initializer)}

    def init_params(self, generator, device):
        # each table at its own (rows_t, d) shape, at its offset; the pad
        # rows stay zero (row-sharded or split in row blocks: the rank's
        # block of that kernel)
        kernel = torch.zeros((self.total_rows, self.out_dim),
                             dtype=torch.float32, device=device)
        for off, rows in zip(self._offsets, self.table_sizes):
            kernel[off:off + rows] = self.kernel_initializer(
                generator, (rows, self.out_dim), torch.float32, device)
        if self._row_plan is not None:
            return self._row_block(kernel)
        if self._split_kind() == "rows":
            rl = self.total_rows // self._split.nblocks
            lo = self._split.block * rl
            return {"kernel": kernel[lo:lo + rl].clone()}
        return {"kernel": kernel}

    # ---- row blocks over the whole mesh (``_split`` "rows") ---------
    def _block_lookup(self, params, idx):
        """(this rank's rows of the lookup (b, T, d), the global batch's
        concatenated row ids (B·T·bag,)): the global batch's ids (one
        all-gather), the bags of the lookups in this rank's block on the
        bag kernel (the others a negative id, which adds nothing), and
        the ranks' partial bags summed into each rank's rows in rank
        order (one reduce-scatter). At bag 1 each lookup lies in one
        block, so the sum is that block's row, bitwise."""
        s = self._split
        b, T, bag = idx.shape
        gid = self._global_ids(s.gather_batch(idx.contiguous()))
        table = params["kernel"]
        rl = table.shape[0]
        local = gid - s.block * rl
        local = torch.where((local >= 0) & (local < rl), local, -1)
        part = embedding_bag(table, local, self.aggr)       # (B·T, d)
        out = s.coll.reduce_scatter_sum(
            part.reshape(s.world, b * T, self.out_dim))
        return out.reshape(b, T, self.out_dim), gid.reshape(-1)

    def apply(self, params, xs):
        if self._split_kind() == "rows":
            return [self._block_lookup(params, xs[0])[0]]
        return super().apply(params, xs)

    def apply_with_fwd(self, params, xs):
        if self._split_kind() == "rows":
            out, gid = self._block_lookup(params, xs[0])
            return [out], (gid, None)
        return super().apply_with_fwd(params, xs)

    def _block_update_inputs(self, params, xs, out_ct, fwd):
        """Split in row blocks: (the global batch's concatenated row ids
        (n,), from ``fwd`` when given; their cotangent rows (n / bag, d),
        / bag for "avg", one all-gather; the block's first row lo; bag),
        in the (batch, table, bag) order of the JAX op's
        ``g.reshape(-1)``."""
        (idx,) = xs
        s = self._split
        bag = idx.shape[2]
        table = params["kernel"]
        ct = out_ct.to(table.dtype)
        if self.aggr == AGGR_MODE_AVG:
            ct = ct / bag
        ct = s.gather_batch(ct.contiguous()).reshape(-1, self.out_dim)
        gid = (fwd[0] if fwd is not None else self._global_ids(
            s.gather_batch(idx.contiguous())).reshape(-1))
        return gid, ct, s.block * table.shape[0], bag

    @torch.no_grad()
    def sparse_sgd_update(self, params, xs, out_ct, lr, fwd=None, ok=None):
        """As ``_FlatTableBag.sparse_sgd_update``; split in row blocks,
        the global batch's cotangent lands on the rank's block through
        the windowed scatter (kernel 4) with the global batch's ids
        (``_block_update_inputs``)."""
        if self._split_kind() != "rows":
            return super().sparse_sgd_update(params, xs, out_ct, lr, fwd, ok)
        gid, ct, lo, bag = self._block_update_inputs(params, xs, out_ct, fwd)
        sharded_scatter_add_rows(params["kernel"], gid, ct, lo=lo,
                                 scale=-lr, div=bag, ok=ok)
        return params

    @torch.no_grad()
    def sparse_opt_update(self, params, xs, out_ct, opt, slabs, step,
                          fwd=None, ok=None):
        """As ``_FlatTableBag.sparse_opt_update``; split in row blocks,
        kernel 2's stateful entry over the rank's block's window, on the
        block and its state slabs, from ``_block_update_inputs``' raw
        cotangent."""
        if self._split_kind() != "rows":
            return super().sparse_opt_update(params, xs, out_ct, opt, slabs,
                                             step, fwd, ok)
        gid, ct, lo, bag = self._block_update_inputs(params, xs, out_ct, fwd)
        stateful_update_rows(params["kernel"], gid, ct, None, slabs,
                             opt.row_params(), opt.alpha_t(step), div=bag,
                             lo=lo, ok=ok)
        return params

    @torch.no_grad()
    def split_dense_grad(self, params, xs, out_ct, fwd=None):
        """Split in row blocks, the gradient of the rank's block for a
        dense table update: the global batch's cotangent rows summed into
        a zero block by kernel 4 at scale 1."""
        gid, ct, lo, bag = self._block_update_inputs(params, xs, out_ct, fwd)
        g = torch.zeros_like(params["kernel"])
        sharded_scatter_add_rows(g, gid, ct, lo=lo, div=bag)
        return {"kernel": g}

    def whole_params(self, params):
        """The op's parameters as one card holds them, gathered from the
        ranks; None when this rank holds them whole."""
        if self._row_plan is not None:
            return self._row_whole(params)
        if self._split_kind() == "rows":
            return {"kernel": self._split.gather_pieces(params["kernel"],
                                                        0)}
        return None

    # ---- row sharding hooks (see configure_row_shard) ---------------
    def _row_shard_geometry(self):
        from ..utils.weights import _pack_factor
        return self.total_rows, _pack_factor(self.out_dim,
                                             self.total_rows), 1

    def _row_route(self, g):
        """Concatenated rows -> (owner, local, gid, None): the dedup key
        is the concatenated row id; no hot split."""
        rl = self._row_plan.rows_local
        return g // rl, g % rl, g, None

    def _global_ids(self, idx):
        """(batch, T, bag) ids -> (batch*T, bag) rows of the concatenated
        table: each id wraps into its table as jnp's floor-mod % does
        (negative ids too), then its table's offset is added."""
        consts = self._consts.get(idx.device)
        if consts is None:
            with torch.inference_mode(False):   # plain tensors, kept
                consts = self._consts[idx.device] = tuple(
                    torch.tensor(v, dtype=torch.int64,
                                 device=idx.device)[None, :, None]
                    for v in (self.table_sizes, self._offsets))
        sizes, offs = consts
        flat = torch.remainder(idx.long(), sizes) + offs
        return flat.reshape(-1, idx.shape[2])

    def _flat(self, t):
        return t                          # stored as (total_rows, d)

    # ---- delta publication (utils/delta.py) -------------------------
    def lookup_id_space(self) -> int:
        return self.total_rows

    def delta_touched_rows(self, idx_np) -> np.ndarray:
        """Rows of the JAX op's stored kernel, (total_rows/r, r*d), that
        this batch touches: r logical rows a packed row."""
        from ..utils.weights import _pack_factor
        r = _pack_factor(self.out_dim, self.total_rows)
        return np.unique(self.flat_lookup_ids(idx_np) // r)

    # ---- host-resident table (FFConfig.host_resident_tables) --------
    # the host table is the unpacked (total_rows, d) concatenation
    def host_init(self, seed: int):
        """Table t drawn from ``seed + t`` into its rows, as the JAX op's;
        the tables are drawn on a thread each (a draw releases the
        interpreter lock; each table has its own generator, so the result
        does not depend on the order)."""
        from concurrent.futures import ThreadPoolExecutor
        logical = np.zeros((self.total_rows, self.out_dim), np.float32)

        def draw(i):
            off, rows = self._offsets[i], self.table_sizes[i]
            _host_init_table(self.kernel_initializer, (rows, self.out_dim),
                             seed + i, out=logical[off:off + rows])

        workers = max(1, min(self.num_tables, os.cpu_count() or 1))
        with ThreadPoolExecutor(workers) as pool:
            # largest first, so the longest draw starts at once
            order = sorted(range(self.num_tables),
                           key=lambda i: -self.table_sizes[i])
            for f in [pool.submit(draw, i) for i in order]:
                f.result()
        return {"kernel": logical}

    def host_flat_indices(self, idx_np):
        """Per-sample flat row ids, (batch, T, bag), into the
        (total_rows, d) concatenated table."""
        sizes = np.asarray(self.table_sizes, np.int64)[None, :, None]
        offs = np.asarray(self._offsets, np.int64)[None, :, None]
        return np.asarray(idx_np).astype(np.int64) % sizes + offs


def configure_quant(op, raw_pc) -> None:
    """Resolve ``op``'s quantized-storage policy (the JAX package's
    ``configure_quant``): its strategy entry's ``quant_dtype`` /
    ``quant_update`` win, then the model's ``--emb-dtype`` /
    ``--emb-update-rule``, then fp32. Sets ``op._quant_policy``, which
    ``quant.effective_policy`` reads, and registers a non-default
    policy in ``model._quant_policies`` for the training step, the
    publisher, the serving tier and the checkpoint manifest."""
    from ..quant.policy import FP32, policy_from_config, policy_from_pc
    pol = policy_from_pc(raw_pc) \
        or policy_from_config(op.model.config) or FP32
    op._quant_policy = pol
    reg = getattr(op.model, "_quant_policies", None)
    if reg is None:
        reg = op.model._quant_policies = {}
    if pol.is_default:
        reg.pop(op.name, None)
        return
    reg[op.name] = pol
    log_emb.info("quantized storage for %r: dtype=%s update_rule=%s",
                 op.name, pol.dtype, pol.update_rule)


def quant_row_width(op) -> int:
    """The width of the rows the quantization acts on: the rows of the
    JAX op's STORED table, lane-packed for a stacked or concatenated
    table (r logical rows of d a row, ``_pack_factor``), so a device
    table's row scales cover the same values in both packages."""
    from ..utils.weights import _pack_factor
    if isinstance(op, EmbeddingBagStacked):
        return _pack_factor(op.out_dim, op.num_entries) * op.out_dim
    if isinstance(op, EmbeddingBagConcat):
        return _pack_factor(op.out_dim, op.total_rows) * op.out_dim
    return op.out_dim
