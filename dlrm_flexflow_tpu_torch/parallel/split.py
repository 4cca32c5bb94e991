"""One op's parameters split over ranks, and the collectives that join
its pieces: the port's counterpart of the layouts GSPMD gives the JAX
package's ops over a mesh (its ``param_axes``), for what ``compile``
splits across ranks besides the row-sharded tables
(``parallel.alltoall``):

- "table": an ``EmbeddingBagStacked``'s storage slots in equal blocks
  over the mesh axes of its output's table dim (block k holds slots
  [k·T/D, (k+1)·T/D)); where D is less than the mesh, the ranks that
  differ on the other axes (``copies``) hold the same block;
- "rows": the concatenated table of an ``EmbeddingBagConcat`` in equal
  row blocks over the whole mesh (rank k holds rows [k·R/W, (k+1)·R/W));
- "width": an ``Embedding``'s columns over the mesh axes of its output's
  channel dim (rank k, block c = its index over those axes, holds
  columns [c·d/dc, (c+1)·d/dc) of every row);
- "channel": a ``Linear``'s output columns of ``kernel`` and ``bias``,
  the same way;
- "replicated": a table whole on every rank, updated by every rank from
  the whole global batch, so the copies stay bitwise equal.

Each rank holds its rows of the global batch, as every data-parallel op
does: rank r rows [r·b, (r+1)·b), b = B / W. ``OpSplit`` keeps one
rank's block and every rank's, and moves a tensor between the rank's
rows (b, ..., C) and its block's columns for the whole global batch
(B, ..., C / dc) through ``Collectives``, which counts every call. Where
blocks have several copies (dc < W), each copy takes the whole global
batch's cotangent and computes the same update.
"""

from __future__ import annotations

from typing import List

import torch


class OpSplit:
    """One rank's side of an op split over the mesh axes ``axes`` into
    ``nblocks`` blocks (``kind``: "table", "rows", "width", "channel" or
    "replicated"; ``axes`` empty for "replicated"). ``block``: this
    rank's block; ``blocks_of[i]``: the block of the mesh's i-th rank;
    ``group``/``peers``: the ranks that differ from this one only on
    ``axes`` (one rank a block, in block order; the group None for the
    whole process group or a rank alone); ``pos``: this rank's row block
    of the global batch. For "table" also ``copies``/``ncopies``, the
    group of the ranks that hold this block (those that differ on the
    other axes), and ``perm``: where the chunk of (copy j, block i),
    gathered over the copies after the group's all-to-all, comes in
    rank order."""

    def __init__(self, kind: str, mesh, axes, coll, rank: int):
        self.kind = kind
        self.coll = coll
        self.mesh = mesh
        self.world = mesh.size
        self.axes = tuple(axes)
        self.blocks_of: List[int] = [mesh.linear_index(r, self.axes)
                                     for r in mesh.ranks]
        self.nblocks = max(self.blocks_of) + 1
        self.pos = mesh.ranks.index(rank)
        self.block = self.blocks_of[self.pos]
        self.group, self.peers = coll.axis_groups(mesh, self.axes, rank)
        if kind == "table":
            others = tuple(a for a in mesh.axis_names if a not in self.axes)
            self.copies, held = coll.axis_groups(mesh, others, rank)
            self.ncopies = len(held)
            self.perm = [mesh.linear_index(r, others) * self.nblocks
                         + mesh.linear_index(r, self.axes)
                         for r in mesh.ranks]
        # a rank of each block, the first in rank order
        self.first = [self.blocks_of.index(k) for k in range(self.nblocks)]

    # ---- the batch -----------------------------------------------------
    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows (b, ...) -> the global batch (B, ...), in
        rank order (one all-gather over the process group)."""
        return self.coll.all_gather(x, None, self.world)

    def rows_of(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (B, ...)."""
        b = t.shape[0] // self.world
        return t[self.pos * b:(self.pos + 1) * b]

    def to_rows(self, y: torch.Tensor) -> torch.Tensor:
        """This block's columns for the global batch (B, ..., c) -> this
        rank's rows, every block's columns (b, ..., c·nblocks): one
        all-to-all (rank j gets its rows of every rank's block); block
        k's columns come from the first rank holding it."""
        b = y.shape[0] // self.world
        got = self.coll.all_to_all(y.reshape((self.world, b)
                                             + tuple(y.shape[1:])))
        return torch.cat([got[i] for i in self.first], dim=-1)

    def from_rows(self, g: torch.Tensor) -> torch.Tensor:
        """The reverse of ``to_rows``: this rank's rows, every column
        (b, ..., C) -> this block's columns for the global batch (B, ...,
        C / nblocks), rows in rank order (one all-to-all: rank i gets
        every rank's rows of its block's columns)."""
        c = g.shape[-1] // self.nblocks
        send = torch.stack([g[..., k * c:(k + 1) * c]
                            for k in self.blocks_of])
        got = self.coll.all_to_all(send)
        return got.reshape((-1,) + tuple(got.shape[2:]))

    def sum_peers(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks of the other blocks beside this
        one (``group``): a partial product of each block made whole."""
        if len(self.peers) == 1:
            return t
        return self.coll.all_reduce_sum_(t.contiguous(), self.group)

    # ---- the parameters ------------------------------------------------
    def columns(self, full: int) -> slice:
        """This block's columns of a dimension of ``full``."""
        c = full // self.nblocks
        return slice(self.block * c, (self.block + 1) * c)

    def gather_pieces(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every block's ``t`` (this rank's piece of a parameter), joined
        along ``dim`` in block order: the whole parameter."""
        return gather_pieces(self.coll, self.mesh, self.axes, t, dim)


def gather_pieces(coll, mesh, axes, t: torch.Tensor, dim: int
                  ) -> torch.Tensor:
    """Each rank's ``t``, its piece of a parameter split in blocks over
    the mesh axes ``axes`` (block: the rank's index over them), joined
    along ``dim`` in block order, a block's first rank's piece each: the
    whole parameter (one all-gather over the process group)."""
    blocks = [mesh.linear_index(r, tuple(axes)) for r in mesh.ranks]
    got = coll.all_gather(t.unsqueeze(0).contiguous(), None, mesh.size)
    return torch.cat([got[blocks.index(k)]
                      for k in range(max(blocks) + 1)], dim=dim)


class GatherBatch(torch.autograd.Function):
    """``OpSplit.gather_batch`` with its gradient: the cotangent of the
    global batch is this block's part of a product the other blocks
    complete, so it is summed over the peers (``sum_peers``) and this
    rank's rows of the sum are its input's cotangent."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.gather_batch(x)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return s.rows_of(s.sum_peers(g.contiguous())), None


class ToRows(torch.autograd.Function):
    """``OpSplit.to_rows`` with its gradient, ``from_rows``: every copy of
    a block takes the whole global batch's cotangent of its columns."""

    @staticmethod
    def forward(ctx, y, split):
        ctx.split = split
        return split.to_rows(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.from_rows(g.contiguous()), None


def join_pieces_host(coll, mesh, axes, a, dim: int, dst: int = 0):
    """Each rank's host array ``a``, its piece of an array split in
    blocks over the mesh axes ``axes``, joined along ``dim`` in block
    order, a block's first rank's piece each, on rank ``dst`` (one
    gather to it); None on the other ranks."""
    import numpy as np
    parts = coll.gather_host(a, dst)
    if parts is None:
        return None
    blocks = [mesh.linear_index(r, tuple(axes)) for r in mesh.ranks]
    return np.concatenate([parts[mesh.ranks[blocks.index(k)]]
                           for k in range(max(blocks) + 1)], axis=dim)
