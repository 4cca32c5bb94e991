"""Row-sharded embedding tables with explicit all-to-all lookup routing,
the counterpart of ``dlrm_flexflow_tpu.parallel.alltoall``.

Each rank owns a ROW block of every table (``ParallelConfig.
param_degree`` > 1, the mode that removes the ceiling of one device per
table) and its rows of the global batch. Where the JAX package runs the
exchange as one ``shard_map`` body over the mesh, the port runs the same
body on each rank, one process a rank, through ``parallel.distributed.
Collectives``:

  forward   bucket the rank's lookups by owning shard (a stable sort by
            owner, then the rank in the bucket), one all-to-all of the
            request ids over the row axes' group, the owner's gather
            (kernel 1, ``embedding_bag`` at bag 1, on its block), one
            all-to-all of the rows back, unpermute and the bag's sum
            (kernel 1 again, over the returned rows).
  backward  the gradient rows travel to their owners (one all-to-all of
            ids, global positions and fp32 rows packed in one int32
            buffer), are put into the canonical order and applied on the
            owner's block: summed into a zero block ("grad", the
            autograd backward of ``row_sharded_bag_lookup``) or into the
            table (SGD) by kernel 3, ``scatter_add_rows``, or through the
            optimizer's row math (``row_sharded_opt_update``) by kernel
            2's stateful entry, ``stateful_update_rows``, on the block and
            its state slabs. No table-sized gradient and no all-reduce of
            a table ever forms.

The skew refinements, as in the JAX package: ``dedup`` routes each
rank's DISTINCT ids only and pre-sums its gradient rows per id before
the exchange (capacity min(n_local, rows a shard owns) a peer); the
hot/cold hybrid (``hot_rows`` > 0) keeps the first rows of every table
on every rank, looked up locally and updated in lockstep from an
all-gather of every rank's per-id partial sums; ``overlap`` splits each
all-to-all into rounds (point-to-point over one row axis, capacity
chunks over several) that move the same blocks to the same slots.

Exactness, among the port's forms: forward outputs, gradients and
updates are BITWISE equal across the dense, dedup, hybrid and overlap
exchanges and across row-shard degrees on the same mesh, duplicates
included, because

- each rank's lookups keep their flatten order in every bucket, and a
  lookup's global position is ``dev * n + j`` (``dev`` the rank's index
  over every mesh axis, the order the batch splits in);
- every receiver puts the updates in CANONICAL order (``
  _combine_received``): a segment sum per (row, source rank) in
  ascending position, which is what the dedup sender computes with the
  same function, then the partial sums in ascending first-occurrence
  position;
- kernels 2 and 3 sum a row's partials in list order, from 0, and a
  segment sum is kernel 3 into a zero buffer.

Against the JAX package the forward is bitwise; an update is not where a
row has partials from more than one rank: JAX's CPU scatter adds them to
the row one after another, (t + u1) + u2, where the kernels form t + (u1
+ u2).

Sentinels: a pad slot of the send buffers carries the row id
``flat_rows_local`` (JAX's ``mode="drop"`` sentinel). Before a kernel
it becomes -1: the owner's gather (kernel 1) gives a zero row for it,
and the update kernels skip it. An id of a pad must never reach a
kernel in range.

Capacity, as in the JAX package: the dense exchange reserves ``n_local``
slots a peer, the dedup one min(n_local, flat_rows_local).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .mesh import Mesh
from .sharding import param_axis_indices

_INT_MAX = 2 ** 31 - 1
# capacity-dim chunks of the pipelined exchange over several row axes
# (JAX's _OVERLAP_CHUNKS)
_OVERLAP_CHUNKS = 4


@dataclass(frozen=True)
class RowShardPlan:
    """Resolved row-shard placement of one embedding op: the mesh axes of
    the row blocks (``row_axes``, taken leading-first like every other
    degree), the shard count, and the logical COLD (routed) rows each
    shard owns of each table. ``dedup`` selects the unique-ids exchange;
    ``hot_rows`` > 0 is the hybrid's replicated rows a table (the row
    geometry then describes the cold tail only); ``overlap`` the
    pipelined exchange."""

    mesh: Mesh
    row_axes: Tuple[str, ...]
    nshards: int
    rows_local: int
    flat_rows_local: int
    dedup: bool = False
    hot_rows: int = 0
    tables: int = 1
    overlap: bool = False

    @property
    def nonrow_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh.axis_names
                     if a not in self.row_axes)

    @property
    def hot_rows_flat(self) -> int:
        """Rows of the flat replicated hot block (all tables)."""
        return self.tables * self.hot_rows

    @property
    def ndev(self) -> int:
        return self.mesh.size

    def capacity(self, n_local: int) -> int:
        """Slots a peer of the id and row exchanges: every local lookup
        (dense), or at most the rows an owner has (dedup)."""
        if self.dedup:
            return max(min(int(n_local), self.flat_rows_local), 1)
        return int(n_local)

    def row_ranges(self) -> list:
        """The [lo, hi) flat-row block each shard owns, in shard order."""
        return shard_row_ranges(self.flat_rows_local * self.nshards,
                                self.nshards)


# ---- the owner math, shared with the serving shard tier ----------------


def shard_rows_local(rows: int, nshards: int) -> int:
    """Rows per shard (ceil-division block size)."""
    if nshards < 1:
        raise ValueError(f"nshards must be >= 1, got {nshards}")
    return -(-int(rows) // int(nshards))


def shard_row_ranges(rows: int, nshards: int) -> list:
    """[(lo, hi), ...] per shard, tiling [0, rows) exactly: contiguous
    equal blocks of ceil(rows / nshards), the last possibly short,
    possibly empty."""
    per = shard_rows_local(rows, nshards)
    return [(min(s * per, rows), min((s + 1) * per, rows))
            for s in range(nshards)]


def row_owners(ids, rows: int, nshards: int) -> np.ndarray:
    """Owning shard per flat row id: ``id // rows_local``, clamped into
    range (ids wrap ``% rows`` first, as every host lookup does)."""
    per = shard_rows_local(rows, nshards)
    g = np.asarray(ids, np.int64) % max(int(rows), 1)
    return np.minimum(g // per, nshards - 1).astype(np.int64)


def plan_row_shard(mesh: Optional[Mesh], param_degree: int, rows: int,
                   pack: int, tables: int = 1, dedup: bool = False,
                   hot_rows: int = 0, overlap: bool = False
                   ) -> Optional[RowShardPlan]:
    """The plan for ``param_degree`` row shards of a table whose COLD tail
    has ``rows`` logical rows, stored ``pack`` a lane tile by the JAX op
    (the blocks must hold whole packed rows there), or None when it
    cannot apply."""
    if mesh is None or param_degree <= 1 or mesh.size <= 1:
        return None
    idx = param_axis_indices(param_degree, list(mesh.axis_sizes))
    if idx is None or rows % (param_degree * max(pack, 1)) != 0:
        return None
    rows_local = rows // param_degree
    return RowShardPlan(mesh=mesh,
                        row_axes=tuple(mesh.axis_names[i] for i in idx),
                        nshards=param_degree, rows_local=rows_local,
                        flat_rows_local=tables * rows_local,
                        dedup=bool(dedup), hot_rows=int(hot_rows),
                        tables=int(tables), overlap=bool(overlap))


class RowExchange:
    """One rank's side of a plan: its index over every mesh axis (``dev``)
    and over the row axes (``shard``), and the groups of its collectives:
    the ranks of its row block's exchange (the row axes) and of its
    replicas (the other axes). ``Collectives.axis_groups`` makes the
    groups, once, in one order on every rank."""

    def __init__(self, plan: RowShardPlan, coll, rank: int):
        mesh = plan.mesh
        self.plan, self.coll = plan, coll
        self.dev = mesh.linear_index(rank, mesh.axis_names)
        self.shard = mesh.linear_index(rank, plan.row_axes)
        self.row_group, self.row_ranks = coll.axis_groups(
            mesh, plan.row_axes, rank)
        self.nonrow_group, self.nonrow_ranks = coll.axis_groups(
            mesh, plan.nonrow_axes, rank)

    def a2a(self, x: torch.Tensor) -> torch.Tensor:
        """THE exchange on one (S, C, ...) send buffer (block i to shard
        i; back, block j from shard j): the fused all-to-all, or under
        ``overlap`` its rounds (point-to-point over one row axis, capacity
        chunks over several): the same blocks in the same slots."""
        plan = self.plan
        if not plan.overlap:
            return self.coll.all_to_all(x, self.row_group)
        if len(plan.row_axes) == 1:
            return self.coll.ring_all_to_all(x, self.row_ranks, self.shard)
        C = x.shape[1]
        k = next((c for c in range(min(_OVERLAP_CHUNKS, C), 1, -1)
                  if C % c == 0), 1)
        if k <= 1:
            return self.coll.all_to_all(x, self.row_group)
        step = C // k
        return torch.cat([self.coll.all_to_all(
            x[:, i * step:(i + 1) * step], self.row_group)
            for i in range(k)], dim=1)

    def gather_replicas(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of every rank holding this row block (the non-row axes),
        concatenated; ``x`` itself when it is alone."""
        if len(self.nonrow_ranks) == 1:
            return x
        return self.coll.all_gather(x, self.nonrow_group,
                                    len(self.nonrow_ranks))

    def gather_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of every rank of the mesh, concatenated."""
        return self.coll.all_gather(x, None, self.plan.ndev)


# ---- routing pieces -----------------------------------------------------


def _arange(n, like):
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, num: int
                 ) -> torch.Tensor:
    """(num, d) sums of ``vals`` rows by segment id, each segment summed
    from 0 in list order: kernel 3 into a zero buffer on the card (its
    plain version, ``index_add_``, on the CPU). ``seg`` in [0, num)."""
    from ..ops.kernels.scatter_rows import segment_sum_rows
    return segment_sum_rows(seg, vals.contiguous(), num)


def _segment_min(vals: torch.Tensor, seg: torch.Tensor, num: int
                 ) -> torch.Tensor:
    return torch.full((num,), _INT_MAX, dtype=torch.int64,
                      device=vals.device).scatter_reduce_(
        0, seg, vals, "amin")


def _bucket_ranks(owner_f: torch.Tensor) -> torch.Tensor:
    """Rank of each lookup within its owner's bucket (stable: the local
    flatten order holds inside each bucket)."""
    so, order = torch.sort(owner_f, stable=True)
    start = torch.searchsorted(so, so, side="left")
    out = torch.empty_like(owner_f)
    out[order] = _arange(owner_f.shape[0], owner_f) - start
    return out


def _dedup_keys(gf: torch.Tensor):
    """Sort then unique over flat lookup keys ``gf`` (n,): (order, seg,
    rep, inv, nuniq): the stable sort's permutation, the unique segment of
    each SORTED position (positions ascend within a segment), each unique
    slot's first-occurrence position (pads: int32 max), each lookup's
    unique slot, and the live unique count (a 0-d tensor; slots >= it are
    pads)."""
    n = gf.shape[0]
    sg, order = torch.sort(gf, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=gf.device)
    first[1:] = sg[1:] != sg[:-1]
    seg = torch.cumsum(first, 0) - 1
    inv = torch.empty_like(seg)
    inv[order] = seg
    rep = _segment_min(order, seg, n)
    return order, seg, rep, inv, seg[-1] + 1


def _scatter_slots(size: int, slot, vals, fill):
    """A (size, ...) buffer of ``fill`` with vals[j] at slot[j]; a slot
    outside [0, size) drops its value (JAX's ``mode="drop"``)."""
    shape = (size + 1,) + tuple(vals.shape[1:])
    buf = torch.full(shape, fill, dtype=vals.dtype, device=vals.device)
    buf[torch.where(slot < size, slot, size)] = vals
    return buf[:size]


def _pack(ids, pos, upd):
    """One int32 buffer (..., 2 + d) of ids, positions and the fp32 rows'
    bits: three exchanges' bytes in one collective."""
    return torch.cat([ids.to(torch.int32)[..., None],
                      pos.to(torch.int32)[..., None],
                      upd.contiguous().view(torch.int32)], dim=-1)


def _unpack(buf):
    return (buf[..., 0].long(), buf[..., 1].long(),
            buf[..., 2:].contiguous().view(torch.float32))


def _route_ids(ex: RowExchange, owner_f, local_f, C: int):
    """Bucket and exchange the request ids at capacity ``C`` a peer.
    Slots with owner >= nshards (hot slots, dedup pads) are dropped from
    the send buffer. Returns (received ids (S*C,), their valid mask, each
    lookup's rank in its bucket)."""
    plan = ex.plan
    S = plan.nshards
    rank = _bucket_ranks(owner_f)
    send = _scatter_slots(S * C, owner_f * C + rank, local_f,
                          plan.flat_rows_local)
    recv = ex.a2a(send.to(torch.int32).reshape(S, C)).reshape(-1).long()
    return recv, recv < plan.flat_rows_local, rank


def _combine_received(rid, rpos, rupd, n_local: int, sentinel: int):
    """THE canonical combine: duplicate rows pre-sum per (row id, source
    rank), a segment sum in ascending position (bitwise what the dedup
    sender computes), and the partial sums come back sorted by their
    first-occurrence global position. Returns (ids (L,), partials (L,
    d)); a pad's id is -1, the kernels' pad."""
    L = rid.shape[0]
    rpos1, o1 = torch.sort(rpos, stable=True)
    rid1, rupd1 = rid[o1], rupd[o1]
    rid2, o2 = torch.sort(rid1, stable=True)  # within a row, by position
    rpos2, rupd2 = rpos1[o2], rupd1[o2]
    dev2 = rpos2 // max(int(n_local), 1)
    first = torch.ones(L, dtype=torch.bool, device=rid.device)
    first[1:] = (rid2[1:] != rid2[:-1]) | (dev2[1:] != dev2[:-1])
    seg = torch.cumsum(first, 0) - 1
    partial = _segment_sum(rupd2, seg, L)
    ppos = _segment_min(rpos2, seg, L)
    prid = torch.full((L,), -1, dtype=torch.int64,
                      device=rid.device).scatter_reduce_(0, seg, rid2, "amax")
    valid = _arange(L, rid) < seg[-1] + 1
    prid = torch.where(valid & (prid < sentinel), prid, -1)
    ppos = torch.where(valid, ppos, _INT_MAX)
    _, o3 = torch.sort(ppos, stable=True)
    return prid[o3], partial[o3]


def _positions(ex: RowExchange, n: int, like):
    """Global flatten positions of this rank's n lookups."""
    return ex.dev * n + _arange(n, like)


def _hot_combine(ex: RowExchange, hot_id, pos, upd, n_local: int):
    """Every rank's hot-row updates, gathered over the whole mesh (hot
    rows live on every rank and each rank saw its own rows of the batch)
    and put in canonical order, so every replica applies the same
    sequence. The sender pre-sums per hot id, so the gathered buffer
    holds distinct hot rows, at min(n_local, hot rows) slots."""
    plan = ex.plan
    n = hot_id.shape[0]
    sent = int(plan.hot_rows_flat)
    order, seg, rep, _inv, nuniq = _dedup_keys(hot_id)
    partial = _segment_sum(upd[order], seg, n)
    upos = _segment_min(pos[order], seg, n)
    valid = _arange(n, hot_id) < nuniq
    uid = torch.where(valid, hot_id[rep.clamp(max=n - 1)], sent)
    hotv = valid & (uid < sent)
    upos = torch.where(hotv, upos, _INT_MAX)
    uid = torch.where(hotv, uid, sent)
    # the sentinel sorts last: hot uniques fill the first slots
    C = max(min(n, sent), 1)
    got = ex.gather_all(_pack(uid[:C], upos[:C], partial[:C]))
    ids, ps, us = _unpack(got)
    return _combine_received(ids, ps, us, n_local, sent)


# ---- forward lookup -----------------------------------------------------


def _gather_rows(flat, ids):
    """Rows ``ids`` (n,) of ``flat`` (rows, d): kernel 1 at bag 1."""
    from ..ops.kernels.embedding_bag import embedding_bag
    return embedding_bag(flat, ids.reshape(-1, 1), "sum")


def _fwd_rows(ex: RowExchange, flat, of, lf, gf):
    """Routed per-lookup rows (n, d) from the owners' flat cold blocks.
    Slots with owner >= nshards (hot slots) come back zero. Under dedup
    only distinct ids travel, and the rows scatter back through the
    inverse map."""
    plan = ex.plan
    S, n, d = plan.nshards, of.shape[0], flat.shape[-1]
    C = plan.capacity(n)
    sentinel = plan.flat_rows_local
    if plan.dedup:
        _, _, rep, inv, nuniq = _dedup_keys(gf)
        safe_rep = rep.clamp(max=n - 1)
        valid_u = _arange(n, of) < nuniq
        uof = torch.where(valid_u, of[safe_rep], S)
        ulf = torch.where(valid_u, lf[safe_rep], sentinel)
    else:
        uof, ulf, inv = of, lf, None
    recv, valid, rank = _route_ids(ex, uof, ulf, C)
    # a pad's id -1: kernel 1 reads nothing for it and gives a zero row
    rows = _gather_rows(flat, torch.where(valid, recv, -1))
    back = ex.a2a(rows.reshape(S, C, d)).reshape(S * C, d)
    idx = (uof.clamp(max=S - 1) * C + rank).clamp(max=S * C - 1)
    mine = torch.where((uof < S)[:, None], back[idx], 0.0)
    return mine[inv] if inv is not None else mine


def _aggregate(rows, shape, aggr):
    """The bags' sum (or mean) of per-lookup rows (n, d), bag the last
    index dim: kernel 1 over the rows as a table, in the order the
    world-1 lookup sums them."""
    from ..ops.kernels.embedding_bag import embedding_bag
    bag = shape[-1]
    ids = _arange(rows.shape[0], rows).reshape(-1, bag)
    return embedding_bag(rows.contiguous(), ids, aggr)


def _lookup(ex, flat, hot_flat, owner, local, gid, hot_id, aggr):
    of = owner.reshape(-1)
    mine = _fwd_rows(ex, flat, of, local.reshape(-1), gid.reshape(-1))
    if hot_flat is not None:
        hrows = _gather_rows(hot_flat, hot_id.reshape(-1).clamp(
            max=ex.plan.hot_rows_flat - 1))
        mine = torch.where((of >= ex.plan.nshards)[:, None], hrows, mine)
    return _aggregate(mine, owner.shape, aggr)


def _bag_cotangent_rows(ct, idx_shape, d: int, aggr: str):
    """Output cotangent (..., d) -> per-lookup gradient rows (n, d): each
    bag slot takes its bag's cotangent (divided by the bag under avg)."""
    ct = ct.float()
    if aggr == "avg":
        ct = ct / idx_shape[-1]
    return ct.reshape(-1, 1, d).expand(-1, idx_shape[-1], d).reshape(-1, d)


class _RowShardedBag(torch.autograd.Function):
    """The routed lookup with the JAX custom VJP's backward: the output
    cotangent's rows travel to their owners and sum into a zero block
    there in canonical order ("grad"), and, under the hybrid, the hot
    rows' into a zero hot block from the all-gather."""

    @staticmethod
    def forward(ctx, table, hot_table, ex, owner, local, gid, hot_id, aggr,
                out_shape):
        d = table.shape[-1]
        flat = table.reshape(-1, d)
        hot_flat = None if hot_table is None else hot_table.reshape(-1, d)
        ctx.ex, ctx.aggr, ctx.shapes = ex, aggr, (
            table.shape, None if hot_table is None else hot_table.shape)
        ctx.save_for_backward(owner, local, gid,
                              owner if hot_id is None else hot_id)
        ctx.hot = hot_id is not None
        out = _lookup(ex, flat, hot_flat, owner, local, gid, hot_id, aggr)
        return out.reshape(out_shape)

    @staticmethod
    def backward(ctx, g):
        owner, local, gid, hot_id = ctx.saved_tensors
        tshape, hshape = ctx.shapes
        d = tshape[-1]
        upd = _bag_cotangent_rows(g, owner.shape, d, ctx.aggr)
        grads = _apply_routed(ctx.ex, owner, local, gid,
                              hot_id if ctx.hot else None, upd, "grad")
        cold = grads[0].reshape(tshape)
        hot = None if not ctx.hot else grads[1].reshape(hshape)
        return cold, hot, None, None, None, None, None, None, None


def row_sharded_bag_lookup(ex: RowExchange, table, owner, local, d: int,
                           aggr: str, gid=None, hot_table=None,
                           hot_id=None):
    """Forward lookup with explicit all-to-all routing, on this rank.

    table     : this rank's cold row block, any shape (rows, d) views
    owner     : (..., bag) int64, owning shard of each lookup; >= nshards
                marks a HOT slot (looked up locally)
    local     : (..., bag) int64, the row within the owner's flat block
                (the sentinel on hot slots)
    gid       : (..., bag) int64 flat global cold id, the dedup key
    hot_table : the replicated hot block (hybrid); hot_id the flat hot
                row of each lookup (the sentinel on cold slots)
    returns   : (..., d) aggregated bags of this rank's rows

    Differentiable in ``table`` and ``hot_table``: the backward routes
    the cotangent's rows to their owners, where they sum into the
    block's gradient."""
    if gid is None:
        if ex.plan.dedup:
            raise ValueError("the dedup exchange needs the flat global ids")
        gid = local
    out_shape = tuple(owner.shape[:-1]) + (d,)
    return _RowShardedBag.apply(table, hot_table, ex, owner, local, gid,
                                hot_id, aggr, out_shape)


# ---- update routing -----------------------------------------------------


def _route_updates(ex: RowExchange, of, lf, gf, uf):
    """-> (ids, partials) for THIS shard, in canonical order. Under dedup
    the sender pre-sums per distinct id (the segment sums the receiver's
    combine would form), so the exchange carries one slot an id."""
    plan = ex.plan
    S, n = plan.nshards, of.shape[0]
    sentinel = plan.flat_rows_local
    pos = _positions(ex, n, of)
    if plan.dedup:
        order, seg, rep, _inv, nuniq = _dedup_keys(gf)
        partial = _segment_sum(uf[order], seg, n)
        upos = _segment_min(pos[order], seg, n)
        safe_rep = rep.clamp(max=n - 1)
        valid_u = _arange(n, of) < nuniq
        s_of = torch.where(valid_u, of[safe_rep], S)
        s_lf = torch.where(valid_u, lf[safe_rep], sentinel)
        s_pos = torch.where(valid_u, upos, _INT_MAX)
        s_upd = partial
    else:
        s_of, s_lf, s_pos, s_upd = of, lf, pos, uf
    C = plan.capacity(n)
    slot = s_of * C + _bucket_ranks(s_of)
    pad = _pack(torch.full((1,), sentinel, device=of.device),
                torch.full((1,), _INT_MAX, device=of.device),
                torch.zeros((1, uf.shape[1]), device=of.device))
    buf = pad.expand(S * C + 1, -1).clone()
    buf[torch.where(slot < S * C, slot, S * C)] = _pack(s_lf, s_pos, s_upd)
    got = ex.a2a(buf[:S * C].reshape(S, C, -1)).reshape(S * C, -1)
    # a row block lives on every rank of the non-row axes, each of which
    # saw other rows of the batch: all of them apply every update
    rid, rpos, rupd = _unpack(ex.gather_replicas(got))
    return _combine_received(rid, rpos, rupd, n, sentinel)


def _apply_routed(ex, owner, local, gid, hot_id, upd, mode, lr=0.0,
                  table=None, hot_table=None, opt=None, slabs=None,
                  hot_slabs=None, step=None, ok=None):
    """Route per-lookup update rows ``upd`` (n, d) to their owners and
    apply them there in canonical order; hot slots (hybrid) through the
    all-gathered hot stream and the same combine.

    mode "grad": sum into zero blocks; returns (cold grad, hot grad).
    mode "sgd":  table[row] -= lr * partials, in place (kernel 3).
    mode "opt":  the stateful row math on the block and its ``slabs``
                 (kernel 2's stateful entry), in place."""
    from ..ops.kernels.scatter_rows import (scatter_add_rows,
                                            stateful_update_rows)
    plan = ex.plan
    of = owner.reshape(-1)
    n, d = of.shape[0], upd.shape[-1]
    uf = upd.reshape(n, d).float()
    streams = [(_route_updates(ex, of, local.reshape(-1), gid.reshape(-1),
                               uf), table, slabs, plan.flat_rows_local)]
    if hot_id is not None:
        pos = _positions(ex, n, of)
        is_hot = of >= plan.nshards
        hid = torch.where(is_hot, hot_id.reshape(-1), plan.hot_rows_flat)
        hpos = torch.where(is_hot, pos, _INT_MAX)
        hupd = torch.where(is_hot[:, None], uf, 0.0)
        streams.append((_hot_combine(ex, hid, hpos, hupd, n), hot_table,
                        hot_slabs, plan.hot_rows_flat))
    out = []
    for (rid, rupd), tbl, sl, rows in streams:
        if mode == "grad":
            zero = torch.zeros((rows, d), dtype=torch.float32,
                               device=uf.device)
            out.append(scatter_add_rows(zero, rid, rupd, ids_in_range=True))
        elif mode == "sgd":
            scatter_add_rows(tbl.reshape(-1, d), rid, rupd, scale=-lr,
                             ids_in_range=True, ok=ok)
        elif mode == "opt":
            stateful_update_rows(
                tbl.reshape(-1, d), rid, rupd, None,
                {k: v.reshape(-1, d) for k, v in sl.items()},
                opt.row_params(), opt.alpha_t(step), ids_in_range=True,
                ok=ok)
        else:
            raise ValueError(f"unknown scatter mode {mode!r}")
    return out


@torch.no_grad()
def row_sharded_sgd_update(ex: RowExchange, table, owner, local, upd,
                           lr: float, gid=None, hot_table=None, hot_id=None,
                           ok=None):
    """Touched-rows plain-SGD update with all-to-all routing, in place:
    each shard's block takes -lr * (its rows' partial sums), in canonical
    order, on kernel 3; the hybrid's hot block the same from the
    all-gathered hot stream. ``upd`` (n, d): RAW per-lookup rows."""
    _apply_routed(ex, owner, local, local if gid is None else gid, hot_id,
                  upd, "sgd", lr=float(lr), table=table,
                  hot_table=hot_table, ok=ok)


@torch.no_grad()
def row_sharded_opt_update(ex: RowExchange, table, slabs, owner, local, upd,
                           opt, step, gid=None, hot_table=None,
                           hot_slabs=None, hot_id=None, ok=None):
    """Stateful (lazy momentum, weight decay, Adam) touched-rows update
    with all-to-all routing, in place on the block and its state slabs
    ({name: tensor shaped as the block}, sharded as the block is, so
    state rows never leave their shard), on kernel 2's stateful entry;
    the hybrid's hot block and slabs the same, in lockstep. ``step``: the
    optimizer's step before this one."""
    _apply_routed(ex, owner, local, local if gid is None else gid, hot_id,
                  upd, "opt", table=table, hot_table=hot_table, opt=opt,
                  slabs=slabs, hot_slabs=hot_slabs, step=step, ok=ok)


# ---- accounting ---------------------------------------------------------


def _exchange_buffer_blocks(plan: RowShardPlan) -> int:
    """Blocks a peer of the buffers ONE rank sends: the fused all-to-all
    (and the capacity-chunked form) hands over all S, its own included;
    the point-to-point ring keeps its own block."""
    if plan.overlap and len(plan.row_axes) == 1 and plan.nshards > 1:
        return plan.nshards - 1
    return plan.nshards


def _hlo_exchange_bytes(plan: RowShardPlan, C: int, d: int,
                        table_itemsize: int) -> int:
    S = _exchange_buffer_blocks(plan)
    fwd = S * C * 4 + S * C * d * table_itemsize
    bwd = S * C * 4 + S * C * 4 + S * C * d * 4
    return int(fwd + bwd)


def dense_exchange_hlo_bytes(plan: RowShardPlan, lookups_global: int,
                             d: int, table_itemsize: int = 4) -> int:
    """Bytes ONE rank hands to the dense exchange's collectives a step
    (``Collectives.stats[...]["sent"]``): request ids out (S x C int32),
    rows back (S x C x d), then the gradient's ids, global positions and
    fp32 rows (S x C x (2 + d) int32, one packed buffer: the JAX
    package's three exchanges' bytes). C = n_local, the rank's lookups;
    S the row shards, S - 1 under the point-to-point ring. The JAX
    formula of the same name, for the buffers the port sends."""
    n_local = int(lookups_global) // max(plan.ndev, 1)
    return _hlo_exchange_bytes(plan, n_local, d, table_itemsize)


def dedup_exchange_hlo_bytes(plan: RowShardPlan, lookups_global: int,
                             d: int, table_itemsize: int = 4) -> int:
    """``dense_exchange_hlo_bytes`` of the dedup exchange: the same
    buffers at capacity C = min(n_local, flat_rows_local)."""
    n_local = int(lookups_global) // max(plan.ndev, 1)
    return _hlo_exchange_bytes(plan, plan.capacity(n_local), d,
                               table_itemsize)


def exchange_bytes_per_step(plan: RowShardPlan, lookups_global: int,
                            d: int, itemsize: int = 4,
                            backward: bool = True,
                            distinct_per_device: Optional[float] = None
                            ) -> int:
    """All-to-all bytes ONE rank moves a step under the BALANCED (ragged)
    exchange: ids out, rows back and (backward) gradient rows out again,
    each (P-1)/P of the rank's routed share. ``distinct_per_device``
    replaces the routed count (the dedup exchange routes distinct ids)."""
    n_dev = lookups_global / max(plan.ndev, 1)
    if distinct_per_device is not None:
        n_dev = float(distinct_per_device)
    frac = (plan.nshards - 1) / plan.nshards
    fwd = n_dev * frac * (4 + d * itemsize)
    bwd = n_dev * frac * (4 + d * 4) if backward else 0.0
    return int(fwd + bwd)
