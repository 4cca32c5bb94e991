"""Sharded MIPS index over the shard tier (the counterpart of
``dlrm_flexflow_tpu.retrieve.index``).

The index is item-tower output embeddings stored as an int8
``QuantTable`` (codes + fp32 row scales) on the device of the
embeddings it was built from, attached to an ``EmbeddingShardSet``:
each shard owns a contiguous row range and answers local top-k over it
(the top-k kernel on the card, its plain version on the CPU).

**The merge is exact.** The query is quantized once, on the index's
device; every shard scores the same codes with the same integer dot and
the same fixed-order fp32 rescale, so a row's score is the same wherever
it lives. Each partial is sorted (score desc, id asc) and the host
k-way heap-merges them on that key: the result equals a single-machine
exact scan over the same codes, bit for bit, ties included.

**Degradation drops, never invents.** A dead shard's candidates are
absent from the merge, flagged ``degraded`` with the dropped slots
named.

**One publish, both stages.** ``augment_delta`` folds re-encoded item
rows into a delta payload under ``hostparams/<op>/kernel``; the shard
set routes them through the same split, CRC and apply path as the
ranking tables' rows, so one publish advances ranking and retrieval
together, and each shard's top-k reads the one version its lookups do.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.topk import (mips_topk_reference, quantize_query,
                                topk_select)
from ..quant.store import QuantTable
from ..serve.shardtier import (EmbeddingShard, EmbeddingShardSet,
                               ShardReplica, ShardTierConfig,
                               as_device_table)

# the delta-payload key the index publishes under: the
# "hostparams/<op>/kernel" namespace split_host_rows_by_shard routes
INDEX_DELTA_KEY = "hostparams/{op}/kernel"


class RetrievalResult(NamedTuple):
    """One merged retrieval answer. ``ids``/``scores`` are (B, k'),
    ordered (score desc, id asc) per row; ``versions`` is the per-shard
    version vector read; ``dropped_slots`` names the shards whose
    candidates are absent (degraded)."""

    ids: np.ndarray                 # (B, k') int64
    scores: np.ndarray              # (B, k') float32
    versions: Dict[int, int]
    degraded: bool
    dropped_slots: List[int]
    latency_ms: float


def merge_partials(scores_by_slot: Dict[int, np.ndarray],
                   ids_by_slot: Dict[int, np.ndarray],
                   k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-way heap-merge of per-shard sorted partials on the key
    ``(-score, id)``: the first k popped are the global top-k in the
    order a single-machine sort gives (fp32 negation is exact)."""
    slots = sorted(scores_by_slot)
    if not slots:
        return (np.empty((0, 0), np.int64), np.empty((0, 0), np.float32))
    B = scores_by_slot[slots[0]].shape[0]
    avail = sum(scores_by_slot[s].shape[1] for s in slots)
    kk = min(int(k), avail)
    out_i = np.empty((B, kk), np.int64)
    out_s = np.empty((B, kk), np.float32)
    for b in range(B):
        streams = [zip(-scores_by_slot[s][b], ids_by_slot[s][b],
                       scores_by_slot[s][b]) for s in slots]
        for j, (_neg, rid, sc) in enumerate(heapq.merge(*streams)):
            if j >= kk:
                break
            out_i[b, j] = rid
            out_s[b, j] = sc
    return out_i, out_s


class ShardedMIPSIndex:
    """The retrieval index: quantized item embeddings attached to a
    shard set, queried by quantize-once -> per-shard local top-k ->
    exact merge."""

    def __init__(self, shard_set: EmbeddingShardSet, op_name: str,
                 n_items: int, dim: int,
                 table: Optional[QuantTable] = None,
                 device: Optional[torch.device] = None):
        self.shard_set = shard_set
        self.op_name = op_name
        self.n_items = int(n_items)
        self.dim = int(dim)
        # the full code table, kept for the exact-scan oracle
        self.table = table
        self.device = torch.device(
            device if device is not None
            else (table.device if table is not None else "cpu"))
        # read-modify-written by every querying thread
        self._lock = threading.Lock()
        self.queries = 0
        self.degraded_queries = 0

    # --- construction ---------------------------------------------------
    @classmethod
    def build(cls, shard_set: EmbeddingShardSet, embeddings,
              op_name: str = "retrieve_index",
              keep_table: bool = True,
              device="cuda") -> "ShardedMIPSIndex":
        """Quantize (n_items, d) fp32 item-tower outputs (a tensor or an
        array) to int8 codes on ``device`` and attach them to
        ``shard_set`` as the retrieval index. ``device`` defaults to the
        card, as ``FFConfig.device`` does; pass ``device="cpu"`` to run
        the top-k's plain version there."""
        table = as_device_table(embeddings, device)
        if table.dtype != "int8":
            raise ValueError("the MIPS index scores int8 codes; build the "
                             "QuantTable with dtype='int8'")
        shard_set.attach_index(op_name, table, device=table.device)
        return cls(shard_set, op_name, table.shape[0], table.shape[1],
                   table=table if keep_table else None,
                   device=table.device)

    @staticmethod
    def standalone_set(nshards: int,
                       config: Optional[ShardTierConfig] = None
                       ) -> EmbeddingShardSet:
        """An index-only shard set (no ranking tables behind it): the
        ``--retrieve-shards`` deployment. Attach the index with
        :meth:`build`."""
        config = config or ShardTierConfig(nshards=nshards)
        if config.nshards != nshards:
            config.nshards = nshards
        shards = [ShardReplica(EmbeddingShard(slot, slot, {}, {}))
                  for slot in range(nshards)]
        return EmbeddingShardSet(shards, config,
                                 fingerprint="retrieve-standalone")

    # --- the query path -------------------------------------------------
    def topk(self, user_emb, k: int, deadline_s: Optional[float] = None,
             degrade: Optional[str] = None) -> RetrievalResult:
        """Top-k MIPS over the sharded index for a (B, d) fp32 query
        batch, quantized once on the index's device."""
        t0 = time.perf_counter()
        q_codes, q_scales = quantize_query(
            torch.as_tensor(user_emb).to(self.device))
        if q_codes.shape[1] != self.dim:
            raise ValueError(f"query dim {q_codes.shape[1]} != index dim "
                             f"{self.dim}")
        parts = self.shard_set.topk_partials(
            q_codes, q_scales, int(k), deadline_s=deadline_s,
            degrade=degrade)
        ids, scores = merge_partials(parts.scores, parts.ids, int(k))
        if ids.shape[1] == 0 and q_codes.shape[0] and not parts.scores:
            ids = np.empty((q_codes.shape[0], 0), np.int64)
            scores = np.empty((q_codes.shape[0], 0), np.float32)
        with self._lock:
            self.queries += 1
            self.degraded_queries += int(parts.degraded)
        return RetrievalResult(ids, scores, parts.versions, parts.degraded,
                               parts.dropped_slots,
                               1e3 * (time.perf_counter() - t0))

    def exact_scan(self, user_emb, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Single-machine exact scan over the same codes, the plain
        version on the kept table's device: the golden twin of
        :meth:`topk`. Returns numpy (scores, ids)."""
        if self.table is None:
            raise ValueError("exact_scan needs the kept code table "
                             "(build(keep_table=True))")
        q_codes, q_scales = quantize_query(
            torch.as_tensor(user_emb).to(self.device))
        s, i = mips_topk_reference(q_codes, q_scales, self.table.q,
                                   self.table.scales, int(k))
        return s.cpu().numpy(), i.cpu().numpy()

    def exact_scan_fp32(self, user_emb, item_emb, k: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """fp32 exact scan over unquantized item embeddings: the
        recall@k reference. Returns numpy (scores, ids)."""
        items = torch.as_tensor(item_emb).to(torch.float32)
        users = torch.as_tensor(user_emb).to(
            device=items.device, dtype=torch.float32)
        ids = torch.arange(items.shape[0], dtype=torch.int64,
                           device=items.device)
        s, i = topk_select(users @ items.T, ids, int(k))
        return s.cpu().numpy(), i.cpu().numpy()

    # --- freshness (one publish, both stages) ---------------------------
    def delta_key(self) -> str:
        return INDEX_DELTA_KEY.format(op=self.op_name)

    def augment_delta(self, payload: Dict[str, Any], ids, embeddings
                      ) -> Dict[str, Any]:
        """Fold re-encoded item rows ((n,) ids, (n, d) fp32 embeddings)
        into a delta payload, so that ONE publish advances the ranking
        tables and the index: the shard set routes the added
        ``hostparams/<op>/kernel`` entry like every table row. The kept
        oracle table takes the same rows, so the exact scan keeps
        describing what the shards serve. Returns ``payload``."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        vals = np.asarray(embeddings, np.float32)
        if vals.shape != (ids.size, self.dim):
            raise ValueError(f"augment_delta: embeddings {vals.shape} != "
                             f"({ids.size}, {self.dim})")
        payload.setdefault("rows", {})[self.delta_key()] = (ids, vals)
        if self.table is not None:
            self.table.set_rows(ids, vals)
        return payload

    def stats(self) -> Dict[str, Any]:
        return {
            "op": self.op_name,
            "n_items": self.n_items,
            "dim": self.dim,
            "queries": self.queries,
            "degraded_queries": self.degraded_queries,
            "version_vector": self.shard_set.version_vector(),
        }
