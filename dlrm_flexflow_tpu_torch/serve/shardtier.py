"""Row-sharded serving tier: the retrieval-index surface (the counterpart
of ``dlrm_flexflow_tpu.serve.shardtier``).

An :class:`EmbeddingShardSet` of N :class:`EmbeddingShard` s, each
owning a contiguous row block (``shard_row_ranges``) of the retrieval
index and answering local MIPS top-k over it. Each shard sits behind the
serving tier's circuit breaker (:class:`ShardReplica`): a shard whose
top-k fails or misses its deadline ``eject_after`` times in a row is
ejected, and the fan-out then DROPS its candidates, flagged
(``degraded``, ``dropped_slots``), instead of failing the request;
``degrade="fail"`` raises :class:`ShardTierUnavailable` instead.

The index blocks are ``QuantTable`` s on the device of the table given
to ``attach_index``: on the card, each shard scores its block with the
top-k kernel and copies only its (B, k') answer to the host, which the
heap-merge (``retrieve.index.merge_partials``) needs there.

Not ported yet: ranking-table lookups (``fetch``), publishes and delta
chains, the warm cache and replace-dead, the wire transport, fault
hooks and the obs registry.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..quant.store import QuantTable
from ..utils.watchdog import Deadline
from .fleet import HEALTHY, CircuitBreaker


class ShardDown(RuntimeError):
    """This shard is gone: the circuit breaker refusing an ejected
    shard, or a crash."""

    def __init__(self, shard_id: Optional[int] = None, detail: str = ""):
        sid = "?" if shard_id is None else shard_id
        super().__init__(f"embedding shard {sid} is down"
                         + (f": {detail}" if detail else ""))
        self.shard_id = shard_id


class ShardLookupTimeout(TimeoutError):
    """A shard's top-k missed its deadline. Counts against the shard's
    circuit breaker like any other error."""


class ShardTierUnavailable(RuntimeError):
    """``degrade="fail"`` and a shard could not answer: the request
    cannot be answered at full fidelity."""


@dataclass
class ShardTierConfig:
    """Shard-tier knobs (the subset the index surface reads)."""

    nshards: int = 2
    lookup_deadline_ms: float = 50.0  # per-shard budget
    eject_after: int = 3              # consecutive errors -> ejection
    degrade: str = "cache"            # drop-and-flag | fail

    def __post_init__(self):
        if self.nshards < 1:
            raise ValueError(f"nshards must be >= 1, got {self.nshards}")
        if self.degrade not in ("cache", "fail"):
            raise ValueError(
                f"degrade must be 'cache' or 'fail', got {self.degrade!r}")


class TopKPartials(NamedTuple):
    """One retrieval fan-out's outcome: each answering shard's local
    top-k partial (global ids), the version vector read, and which slots
    degraded out (their candidates are absent)."""

    scores: Dict[int, np.ndarray]        # slot -> (B, k') float32
    ids: Dict[int, np.ndarray]           # slot -> (B, k') int64
    versions: Dict[int, int]             # shard slot -> version read
    degraded: bool
    dropped_slots: List[int]


def shard_row_ranges(rows: int, nshards: int) -> list:
    """[(lo, hi), ...] per shard, tiling [0, rows) exactly: contiguous
    equal blocks of ceil(rows / nshards), the last possibly short,
    possibly empty (a copy of
    ``dlrm_flexflow_tpu.parallel.alltoall.shard_row_ranges``)."""
    if nshards < 1:
        raise ValueError(f"nshards must be >= 1, got {nshards}")
    per = -(-int(rows) // int(nshards))
    return [(min(s * per, rows), min((s + 1) * per, rows))
            for s in range(nshards)]


def as_device_table(table, device) -> QuantTable:
    """The index as an int8 ``QuantTable`` on ``device``: a QuantTable
    moves there, fp32 rows (a tensor or an array) are quantized there.
    Asking for CUDA on a machine without a GPU raises, as
    ``FFConfig.device`` does: the index never lands on the CPU quietly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the retrieval index asks for {device} but no "
                           f"CUDA device is available; pass device='cpu' "
                           f"to run the top-k's plain version")
    if isinstance(table, QuantTable):     # .to() is free where it lies
        return QuantTable(table.q.to(device), table.scales.to(device),
                          table.dtype)
    return QuantTable.from_dense(table, "int8", device=device)


class EmbeddingShard:
    """One shard server: contiguous row blocks of the attached index.

    ``sid`` is the shard's identity, ``slot`` the row range it owns (the
    version vector is keyed by slot). Reads and writes serialize on the
    shard's lock, so an answer sees exactly one version."""

    def __init__(self, sid: int, slot: int,
                 blocks: Dict[str, QuantTable],
                 ranges: Dict[str, Tuple[int, int]],
                 version: int = 0):
        self.sid = int(sid)
        self.slot = int(slot)
        self._blocks = dict(blocks)
        self._ranges = {k: (int(lo), int(hi))
                        for k, (lo, hi) in ranges.items()}
        self._lock = threading.Lock()
        self._version = int(version)
        self._index_ops: set = set()
        self.lookups = 0
        self.rows_served = 0

    @property
    def version(self) -> int:
        return self._version

    def hbm_bytes(self) -> int:
        return int(sum(b.nbytes for b in self._blocks.values()))

    def attach_block(self, op_name: str, block: QuantTable, lo: int,
                     hi: int) -> None:
        """Install an index row block [lo, hi) on this shard."""
        if "/" in op_name:
            raise ValueError(f"attach_block: op name {op_name!r} may not "
                             f"contain '/' (publish keys split on it)")
        if not isinstance(block, QuantTable) or block.dtype != "int8":
            raise ValueError(
                f"attach_block: the index block for {op_name!r} must be "
                f"an int8 QuantTable (the MIPS kernel scores int8 codes), "
                f"got {type(block).__name__}")
        if block.shape[0] != int(hi) - int(lo):
            raise ValueError(f"attach_block: {op_name!r} block has "
                             f"{block.shape[0]} rows for range [{lo}, {hi})")
        with self._lock:
            self._blocks[op_name] = block
            self._ranges[op_name] = (int(lo), int(hi))
            self._index_ops.add(op_name)

    def topk(self, op_name: str, q_codes, q_scales, k: int
             ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Local MIPS top-k over this shard's [lo, hi) slice: ((B, k')
        fp32 scores, (B, k') int64 global ids, version) as numpy,
        ordered (score desc, id asc). The query codes are moved to the
        block's device; the answer's copy to the host is the one
        synchronisation."""
        from ..ops.kernels.topk import mips_topk
        with self._lock:
            blk = self._blocks.get(op_name)
            ver = self._version
            if op_name not in self._index_ops or blk is None:
                raise ValueError(f"shard {self.sid} has no retrieval "
                                 f"index {op_name!r} attached")
            lo, _hi = self._ranges[op_name]
            scores, ids = mips_topk(q_codes.to(blk.device),
                                    q_scales.to(blk.device), blk.q,
                                    blk.scales, k, base=lo)
            scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
            self.lookups += 1
            self.rows_served += int(ids.size)
        return scores, ids, ver

    def stats(self) -> Dict[str, Any]:
        return {"sid": self.sid, "slot": self.slot,
                "version": self._version, "lookups": self.lookups,
                "rows_served": self.rows_served,
                "hbm_bytes": self.hbm_bytes()}


class ShardReplica(CircuitBreaker):
    """One :class:`EmbeddingShard` behind the circuit breaker. ``rid``
    is the shard's sid."""

    KIND = "shard"

    def __init__(self, shard: EmbeddingShard, state: str = HEALTHY):
        super().__init__(shard.sid, state=state)
        self.shard = shard

    @property
    def sid(self) -> int:
        return self.shard.sid

    @property
    def slot(self) -> int:
        return self.shard.slot

    def stats(self) -> Dict[str, Any]:
        out = self.breaker_stats()
        out.update(self.shard.stats())
        return out


class EmbeddingShardSet:
    """N shards tiling the index's row space, plus the deadline-bounded
    fan-out and drop-and-flag degradation over them."""

    def __init__(self, shards: List[ShardReplica],
                 config: ShardTierConfig):
        if not shards:
            raise ValueError("a shard set needs at least one shard")
        self.config = config
        self.shards = shards
        self.nshards = len(shards)
        self._apply_lock = threading.Lock()
        self._m_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * self.nshards),
            thread_name_prefix="ff-shard-lookup")
        self._closed = False
        self._index_op: Optional[str] = None
        self._topk_queries = 0
        self._topk_degraded = 0
        self._timeouts = 0
        self._failed_fetches = 0

    # --- lifecycle -----------------------------------------------------
    def close(self) -> None:
        self._closed = True
        # wait=False: an abandoned (late) top-k must not wedge close
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "EmbeddingShardSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _by_slot(self) -> Dict[int, ShardReplica]:
        return {r.slot: r for r in self.shards}

    def degraded_now(self) -> bool:
        """True while any shard is out of the routable set."""
        return any(r.state != HEALTHY for r in self.shards)

    # --- the retrieval-index surface -----------------------------------
    def attach_index(self, op_name: str, table, device="cuda") -> None:
        """Attach the retrieval index: the full (n_items, d) int8
        ``QuantTable`` (or fp32 rows to quantize here), split over the
        slots by ``shard_row_ranges``. Each shard gets its own copy of
        its row block, on ``device`` (the card unless the caller asks
        for the CPU)."""
        table = as_device_table(table, device)
        ranges = shard_row_ranges(int(table.shape[0]), self.nshards)
        with self._apply_lock:
            by_slot = self._by_slot()
            for slot, (lo, hi) in enumerate(ranges):
                rep = by_slot.get(slot)
                if rep is None:
                    continue
                # clone, not a view: a shard owns its rows, and the
                # caller's full table must not bleed into shard state
                block = QuantTable(table.q[lo:hi].clone(),
                                   table.scales[lo:hi].clone(), "int8")
                rep.shard.attach_block(op_name, block, lo, hi)
            self._index_op = op_name

    def topk_partials(self, q_codes, q_scales, k: int,
                      deadline_s: Optional[float] = None,
                      degrade: Optional[str] = None) -> TopKPartials:
        """Fan one quantized query batch out to every healthy shard's
        local top-k (on the set's thread pool) and collect the partials.
        Each shard's answer waits under its own deadline; an error or a
        missed deadline feeds its breaker and drops its candidates
        (flagged), or raises under ``degrade="fail"``."""
        if self._index_op is None:
            raise ShardTierUnavailable(
                "no retrieval index attached (attach_index)")
        op_name = self._index_op
        cfg = self.config
        if deadline_s is None:
            deadline_s = cfg.lookup_deadline_ms / 1e3
        degrade = degrade or cfg.degrade
        scores: Dict[int, np.ndarray] = {}
        ids: Dict[int, np.ndarray] = {}
        versions: Dict[int, int] = {}
        dropped: List[int] = []
        futs = {}
        for rep in list(self.shards):
            if rep.state == HEALTHY and not self._closed:
                futs[rep.slot] = self._pool.submit(
                    rep.shard.topk, op_name, q_codes, q_scales, k)
        for rep in list(self.shards):
            slot = rep.slot
            got = None
            if slot in futs:
                dl = Deadline(deadline_s)
                fut = futs[slot]
                done, _ = wait([fut], timeout=max(dl.remaining(), 0.0))
                err: Optional[BaseException] = None
                if done:
                    err = fut.exception()
                    if err is None:
                        got = fut.result()
                        rep.record_success()
                else:
                    with self._m_lock:
                        self._timeouts += 1
                    err = ShardLookupTimeout(
                        f"shard {rep.sid} topk missed its "
                        f"{dl.seconds * 1e3:.0f} ms deadline")
                if err is not None:
                    if rep.record_error(err, cfg.eject_after):
                        rep.eject(f"{cfg.eject_after} consecutive lookup "
                                  f"errors, last: {err}")
                    if degrade == "fail":
                        with self._m_lock:
                            self._failed_fetches += 1
                        raise ShardTierUnavailable(
                            f"shard {rep.sid} (slot {slot}) topk failed "
                            f"and --serve-degrade=fail: "
                            f"{type(err).__name__}: {err}") from err
            elif degrade == "fail":
                with self._m_lock:
                    self._failed_fetches += 1
                raise ShardTierUnavailable(
                    f"shard slot {slot} is {rep.state} and "
                    f"--serve-degrade=fail")
            if got is not None:
                scores[slot], ids[slot], versions[slot] = got
            else:
                dropped.append(slot)
        with self._m_lock:
            self._topk_queries += 1
            if dropped:
                self._topk_degraded += 1
        return TopKPartials(scores, ids, versions, bool(dropped), dropped)

    def version_vector(self) -> Dict[int, int]:
        return {r.slot: r.shard.version for r in self.shards}

    def stats(self) -> Dict[str, Any]:
        with self._m_lock:
            out = {
                "nshards": self.nshards,
                "versions": self.version_vector(),
                "states": {r.slot: r.state for r in self.shards},
                "degraded_now": self.degraded_now(),
                "topk_queries": self._topk_queries,
                "topk_degraded": self._topk_degraded,
                "timeouts": self._timeouts,
                "failed_fetches": self._failed_fetches,
            }
        out["shards"] = {r.slot: r.stats() for r in self.shards}
        return out
