"""LRU embedding-row cache for the serving read path (the counterpart of
``dlrm_flexflow_tpu.serve.cache``).

Host-resident tables (``--host-tables``) pay a numpy gather on the host
for every lookup, and recommendation traffic is skewed, so the serving
engine caches per-sample lookup RESULTS: a request whose index tuple was
seen recently skips the host gather, and only the cold samples touch the
table.

The key is (op, the sample's index row) and the value exactly
``op.host_lookup``'s output for that sample, so a hit is bitwise the
uncached lookup (the lookup is row-wise: a sample's bag never sees its
neighbours).

Invalidation has two granularities:

- a FULL hot reload (:meth:`EmbeddingCache.invalidate`) drops everything;
- a DELTA reload (:meth:`EmbeddingCache.invalidate_rows`) drops only the
  samples whose bag read a rewritten row: each entry records the host
  table rows it was gathered from (``op.host_delta_touched_rows``), so
  the hot working set survives a delta that rewrote cold rows.

Under a quantized storage policy (``quant``: {op name: "int8"|"fp8"})
an op's entries hold codes and row scales (about 4x more entries a MB)
and dequantize on every hit; ``insert`` returns the miss values through
the same codec, so a hit and the miss that filled it return the same
rows bitwise. The JAX package's ``make_lock`` (a checked lock) is
ROADMAP item 12, so the lock is a plain one.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


class EmbeddingCache:
    """Bounded LRU of per-sample host-table lookup results. Thread-safe
    (the batcher and a stats() reader race); the table gather itself
    also holds the model's table lock at the call site."""

    def __init__(self, capacity: int, quant: Optional[Dict[str, str]] = None):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        # key -> (value, the host-table rows it was gathered from | None);
        # a quantized op's value is (codes, scales, dtype)
        self._d: "OrderedDict[tuple, Tuple[object, object]]" = \
            OrderedDict()
        # op name -> storage dtype: those ops' entries store quantized
        self.quant = dict(quant or {})
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.row_invalidations = 0

    @staticmethod
    def _thaw(stored) -> np.ndarray:
        """A stored value as fp32 rows (dequantized when quantized)."""
        if isinstance(stored, tuple):
            from ..quant.codec import dequantize_rows_np
            return dequantize_rows_np(*stored)
        return stored

    def stored_bytes(self) -> int:
        """Bytes the cached values occupy (codes and scales when
        quantized)."""
        with self._lock:
            return int(sum(v[0].nbytes + v[1].nbytes
                           if isinstance(v, tuple) else v.nbytes
                           for v, _ in self._d.values()))

    def probe(self, op, idx_np: np.ndarray):
        """The read half of :meth:`lookup` over a batch: ``(vals, miss)``,
        the hit samples' cached values (None at miss positions) and the
        miss sample indices. Counts hits and misses. The shard tier probes
        every op first and batches all their misses into ONE fetch."""
        rows = int(idx_np.shape[0])
        vals = [None] * rows
        miss: list = []
        with self._lock:
            for i in range(rows):
                key = (op.name, idx_np[i].tobytes())
                hit = self._d.get(key)
                if hit is None:
                    miss.append(i)
                else:
                    self._d.move_to_end(key)
                    vals[i] = self._thaw(hit[0])
            self.hits += rows - len(miss)
            self.misses += len(miss)
        return vals, miss

    def insert(self, op, idx_np: np.ndarray, miss, sub: np.ndarray,
               ok=None) -> np.ndarray:
        """The write half of :meth:`lookup`: insert the miss samples'
        looked-up values ``sub``. ``ok`` (a bool per miss position) masks
        out samples that must NOT be cached: the shard tier passes False
        for samples assembled from degraded default rows, so an outage
        never outlives itself as cache entries. Returns the values
        callers hand out: under a quantized policy the codec's image of
        ``sub``, so a later hit returns the same rows bitwise."""
        sub = np.asarray(sub)
        dt = self.quant.get(op.name)
        if dt:
            from ..quant.codec import dequantize_rows_np, quantize_rows_np
            q_all, s_all = quantize_rows_np(np.asarray(sub, np.float32), dt)
            sub = dequantize_rows_np(q_all, s_all, dt)
        # the host rows each missed sample read, so a delta invalidates
        # only the samples a rewritten row feeds (None: drop on any)
        deps = {}
        if hasattr(op, "host_delta_touched_rows"):
            for j, i in enumerate(miss):
                if ok is None or ok[j]:
                    deps[i] = op.host_delta_touched_rows(idx_np[i:i + 1])
        with self._lock:
            for j, i in enumerate(miss):
                if ok is not None and not ok[j]:
                    continue
                key = (op.name, idx_np[i].tobytes())
                stored = ((np.ascontiguousarray(q_all[j]),
                           np.ascontiguousarray(s_all[j]), dt) if dt
                          else np.ascontiguousarray(sub[j]))
                self._d[key] = (stored, deps.get(i))
                self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
        return sub

    def lookup(self, op, table_params, idx_np: np.ndarray) -> np.ndarray:
        """The cached ``op.host_lookup(table_params, idx_np)``: hits from
        the cache, the misses through ONE sub-batch host lookup, then
        inserted."""
        vals, miss = self.probe(op, idx_np)
        if miss:
            sub = np.asarray(
                op.host_lookup(table_params, idx_np[np.asarray(miss)]))
            sub = self.insert(op, idx_np, miss, sub)
            for j, i in enumerate(miss):
                vals[i] = np.ascontiguousarray(sub[j])
        return np.stack(vals, axis=0)

    def prewarm(self, op, table_params, idx_np: np.ndarray) -> int:
        """Warm the cache with index rows drawn from the expected traffic
        (the engine samples them from a published id histogram): each row
        inserts exactly what a real request would. Returns how many NEW
        entries it inserted. Hits and misses keep counting real traffic
        only."""
        with self._lock:
            h0, m0 = self.hits, self.misses
        before = len(self)
        self.lookup(op, table_params, idx_np)
        with self._lock:
            self.hits, self.misses = h0, m0
        return len(self) - before

    def invalidate(self) -> None:
        """Drop everything (a hot reload replaced the tables)."""
        with self._lock:
            self._d.clear()
            self.invalidations += 1

    def invalidate_rows(self, op_name: str,
                        dirty_rows: Iterable[int]) -> int:
        """Drop the entries of ``op_name`` whose gathered bag intersects
        ``dirty_rows`` (host-table flat row ids, as a delta's
        ``hostparams`` row update carries them); entries with no recorded
        rows are dropped too. Returns how many were evicted."""
        dirty = np.unique(np.asarray(
            dirty_rows if isinstance(dirty_rows, np.ndarray)
            else list(dirty_rows)).reshape(-1))
        if dirty.size == 0:
            return 0
        with self._lock:
            doomed = [key for key, (_, deps) in self._d.items()
                      if key[0] == op_name and (
                          deps is None
                          or np.intersect1d(np.asarray(deps), dirty).size)]
            for key in doomed:
                del self._d[key]
            self.row_invalidations += len(doomed)
            return len(doomed)

    def __len__(self) -> int:
        return len(self._d)

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "size": len(self._d),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
            "invalidations": self.invalidations,
            "row_invalidations": self.row_invalidations,
        }
