"""Row-sharded serving tier: lookup shards behind stateless rankers (the
counterpart of ``dlrm_flexflow_tpu.serve.shardtier``).

- **Ranker tier.** An :class:`~.engine.InferenceEngine` with a shard set
  attached holds the dense parameters and resolves every host-table id
  through the tier, fronted by its row cache (``serve/cache.py``).
  :meth:`EmbeddingShardSet.release_ranker_tables` frees the ranker's own
  host tables.
- **Lookup tier.** An :class:`EmbeddingShardSet` of N
  :class:`EmbeddingShard` s, each owning a contiguous row block
  (:func:`shard_row_ranges`, owner ``id // rows_local``) of every host
  table's flat row space, as host numpy arrays. A retrieval index rides
  the same shards as one more block (``attach_index``): an int8
  ``QuantTable`` on the device it was built on, scored there by the
  top-k kernel.

**Consistency is a version vector.** Each shard carries its own version
(the step of the last publish it applied), and every prediction carries
the per-shard versions its lookups read. A request's ops are batched
into ONE locked lookup per shard, and a publish applies to a shard
atomically under the same lock, so one request never sees two versions
of a shard. Delta publishes route per shard
(``utils.delta.split_host_rows_by_shard``): each slice carries a CRC the
owning shard recomputes before it applies the slice, and each shard
chains those CRCs (``shard_chain_crc``).

**Robustness.** Shard lookups run under a deadline with bounded retry,
exponential backoff and optional hedging, each shard behind the circuit
breaker (:class:`~.fleet.CircuitBreaker`). An ejected shard degrades the
response instead of failing it: cache hits plus each table's mean row
for the misses, flagged ``degraded`` and counted, and nothing degraded
is ever cached; ``degrade="fail"`` raises :class:`ShardTierUnavailable`
instead. Replace-dead boots a replacement from the warm cache
(``utils.warmcache.ShardCache``), replays the publishes it missed from
the set's history, and admits it only when its probe succeeds.

**The process boundary.** ``EmbeddingShard.serve`` puts a shard behind
a wire server (``serve/transport.py`` ``ShardServer``);
``serve_forever`` is the body of a shard process
(``python -m dlrm_flexflow_tpu_torch.serve.shard_server``, booted from
the warm cache :meth:`EmbeddingShardSet.seed_shard_cache` writes).
:meth:`EmbeddingShardSet.connect` builds the tier over such processes
(``transport="tcp"``): one ``RemoteShard`` a slot, driven by the same
breaker, degradation, publish fan-out and replace-dead as a local
shard; a killed process is replaced by an in-process shard booted from
the same warm cache.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs import metrics as obsm
# the owner math of the row-sharded training exchange, shared with it
from ..parallel.alltoall import (row_owners, shard_row_ranges,  # noqa: F401
                                 shard_rows_local)
from ..obs import trace as obstrace
from ..quant.store import QuantTable
from ..utils import faults
from ..utils.delta import (ChainError, shard_chain_crc, shard_slice_crc,
                           split_host_rows_by_shard)
from ..utils.logging import get_logger
from ..utils.watchdog import Deadline
from .fleet import EJECTED, HEALTHY, PROBING, CircuitBreaker

log_shard = get_logger("serve.shardtier")

class ShardDown(RuntimeError):
    """This lookup shard is gone: a crash (``FF_FAULT_SHARD_DOWN``) or
    the circuit breaker refusing an ejected shard. Retryable up to the
    lookup budget; exhaustion degrades the response (or fails it under
    ``degrade="fail"``)."""

    def __init__(self, shard_id: Optional[int] = None, detail: str = ""):
        sid = "?" if shard_id is None else shard_id
        super().__init__(f"embedding shard {sid} is down"
                         + (f": {detail}" if detail else ""))
        self.shard_id = shard_id


class ShardLookupTimeout(TimeoutError):
    """A shard lookup missed its deadline. Counts against the shard's
    circuit breaker like any other error."""


class ShardTierUnavailable(RuntimeError):
    """``degrade="fail"`` and a shard's lookup budget is spent: the
    request cannot be answered at full fidelity."""


@dataclass
class ShardTierConfig:
    """Lookup-tier knobs; ``from_config`` lifts the ``--serve-*``
    flags."""

    nshards: int = 2
    lookup_deadline_ms: float = 50.0  # per-shard-lookup budget
    #                                   (retries included)
    retries: int = 1                  # re-lookups after the first try
    backoff_ms: float = 2.0           # exponential retry backoff base
    hedge_ms: float = 0.0             # duplicate-after delay; 0 = off
    eject_after: int = 3              # consecutive errors -> ejection
    cooldown_s: float = 1.0           # ejection -> first probe
    probe_deadline_s: float = 5.0     # end-to-end probe budget
    replace_after: int = 2            # failed probes -> replace-dead
    degrade: str = "cache"            # cache (default rows) | fail
    failure_domains: int = 0          # spread shards over N domains
    transport: str = "inproc"         # inproc (method calls) | tcp

    def __post_init__(self):
        if self.nshards < 1:
            raise ValueError(f"nshards must be >= 1, got {self.nshards}")
        if self.degrade not in ("cache", "fail"):
            raise ValueError(
                f"degrade must be 'cache' or 'fail', got {self.degrade!r}")
        if self.transport not in ("inproc", "tcp"):
            raise ValueError(f"transport must be 'inproc' or 'tcp', got "
                             f"{self.transport!r}")

    @staticmethod
    def from_config(cfg) -> "ShardTierConfig":
        return ShardTierConfig(
            nshards=max(int(getattr(cfg, "serve_shards", 0)), 1),
            lookup_deadline_ms=float(
                getattr(cfg, "serve_lookup_deadline_ms", 50.0)),
            hedge_ms=float(getattr(cfg, "serve_hedge_ms", 0.0)),
            degrade=str(getattr(cfg, "serve_degrade", "cache")),
            transport=str(getattr(cfg, "serve_transport", "inproc")))


class FetchResult(NamedTuple):
    """One batched lookup's outcome: per-op row matrices aligned with the
    requested unique ids, which of those rows are degradation defaults,
    and the per-shard version vector read."""

    rows: Dict[str, np.ndarray]          # op -> (U, d) float32
    default_mask: Dict[str, np.ndarray]  # op -> (U,) bool
    versions: Dict[int, int]             # shard slot -> version read
    degraded: bool
    defaults_used: int


class TopKPartials(NamedTuple):
    """One retrieval fan-out's outcome: each answering shard's local
    top-k partial (global ids), the version vector read, and which slots
    degraded out (their candidates are absent)."""

    scores: Dict[int, np.ndarray]        # slot -> (B, k') float32
    ids: Dict[int, np.ndarray]           # slot -> (B, k') int64
    versions: Dict[int, int]             # shard slot -> version read
    degraded: bool
    dropped_slots: List[int]


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


def _table_bounds(op, flat_rows: int) -> List[Tuple[int, int]]:
    """Per-table [lo, hi) regions of the op's flat row space (the
    per-table default rows are means over these regions)."""
    sizes = getattr(op, "table_sizes", None)
    if sizes is not None:                       # concat: ragged tables
        return [(o, o + s) for o, s in zip(op._offsets, sizes)]
    tables = int(getattr(op, "num_tables", 1))
    rows = flat_rows // max(tables, 1)
    return [(t * rows, (t + 1) * rows) for t in range(tables)]


def _parse_address(addr) -> Tuple[str, int]:
    """``"host:port"`` or ``(host, port)`` -> ``(host, port)``."""
    if isinstance(addr, (tuple, list)) and len(addr) == 2:
        return str(addr[0]), int(addr[1])
    s = str(addr)
    host, sep, port = s.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"shard address {addr!r} is not host:port")
    return host, int(port)


def _tier_layout(model, nshards: int) -> Dict[str, Any]:
    """Slice ``model``'s host tables into the tier's static layout:
    per-op slot ranges, flat row counts, row widths, per-table bounds and
    default (mean) rows, the per-slot row blocks and the model's
    fingerprint, and the quantized-storage map: a policy op's tables are
    taken through the codec (``fake_quant_np``) first, so its defaults
    and blocks are the dequantized image every lookup serves, and its
    shards store the blocks as codes + row scales."""
    host_ops = model._host_resident_list
    if not host_ops:
        raise ValueError(
            "the shard tier serves host-resident embedding tables; "
            "compile the model with host_resident_tables=True "
            "(--host-tables)")
    from ..utils.checkpoint import config_fingerprint
    model._host_drain()
    ranges_by_op: Dict[str, list] = {}
    flat_rows: Dict[str, int] = {}
    defaults: Dict[str, np.ndarray] = {}
    bounds: Dict[str, List[Tuple[int, int]]] = {}
    dims: Dict[str, int] = {}
    slot_blocks: List[Dict[str, np.ndarray]] = [dict()
                                                for _ in range(nshards)]
    qmap = {name: pol.dtype for name, pol in model.quant_policies().items()
            if pol.is_quantized}
    from ..quant.codec import fake_quant_np
    for op in host_ops:
        kern = model.host_params[op.name]["kernel"]
        flat = np.ascontiguousarray(kern.reshape(-1, kern.shape[-1]),
                                    np.float32)
        if op.name in qmap:
            flat = fake_quant_np(flat, qmap[op.name])
        R = int(flat.shape[0])
        ranges = shard_row_ranges(R, nshards)
        ranges_by_op[op.name] = ranges
        flat_rows[op.name] = R
        dims[op.name] = int(flat.shape[1])
        tb = _table_bounds(op, R)
        bounds[op.name] = tb
        # the degradation fallback: each table's mean row (a neutral
        # answer; zeros would shift a trained model's scores far more)
        defaults[op.name] = np.stack(
            [flat[lo:hi].mean(axis=0) if hi > lo
             else np.zeros(flat.shape[1], np.float32)
             for lo, hi in tb]).astype(np.float32)
        for slot, (lo, hi) in enumerate(ranges):
            slot_blocks[slot][op.name] = flat[lo:hi].copy()
    return {
        "version": int(model._step),
        "ranges_by_op": ranges_by_op,
        "flat_rows": flat_rows,
        "defaults": defaults,
        "bounds": bounds,
        "dims": dims,
        "slot_blocks": slot_blocks,
        "qmap": qmap,
        "fingerprint": config_fingerprint(model),
    }


def _layout_meta(layout: Dict[str, Any], nshards: int,
                 domains: List[str]) -> Dict[str, Any]:
    """The JSON-safe tier geometry the warm cache's sidecar persists
    (float32 values survive the JSON double round trip exactly)."""
    return {
        "nshards": int(nshards),
        "version": int(layout["version"]),
        "fingerprint": layout["fingerprint"],
        "flat_rows": {k: int(v) for k, v in layout["flat_rows"].items()},
        "dims": {k: int(v) for k, v in layout["dims"].items()},
        "ranges": {k: [[int(lo), int(hi)] for lo, hi in v]
                   for k, v in layout["ranges_by_op"].items()},
        "bounds": {k: [[int(lo), int(hi)] for lo, hi in v]
                   for k, v in layout["bounds"].items()},
        "defaults": {k: [[float(x) for x in row] for row in v]
                     for k, v in layout["defaults"].items()},
        "quant": dict(layout["qmap"]),
        "domains": list(domains),
    }


def _domains(config: ShardTierConfig, nshards: int) -> List[str]:
    n = max(int(config.failure_domains), 0)
    return [f"fd{slot % n}" if n else "" for slot in range(nshards)]


class EmbeddingShard:
    """One lookup server: a contiguous row block of every table, and of
    the retrieval index when one is attached.

    ``sid`` is the shard's identity (fault hooks and logs key on it; a
    replacement gets a new one), ``slot`` the row range it owns (the
    version vector is keyed by slot). Every read and write holds the
    shard's lock, so a lookup sees exactly one version and a publish
    lands entirely between two lookups."""

    def __init__(self, sid: int, slot: int, blocks: Dict[str, Any],
                 ranges: Dict[str, Tuple[int, int]], version: int = 0,
                 chain_crc: int = 0, domain: str = "",
                 quant: Optional[Dict[str, str]] = None):
        self.sid = int(sid)
        self.slot = int(slot)
        self.domain = domain
        # ops whose block is a QuantTable (codes + row scales: a table
        # under a quantized storage policy, the index's "int8"); their
        # lookups ship the codes and the ranker dequantizes
        self.quant = dict(quant or {})
        self._blocks = {k: self._wrap_block(k, v)
                        for k, v in blocks.items()}
        self._ranges = {k: (int(lo), int(hi))
                        for k, (lo, hi) in ranges.items()}
        self._lock = threading.Lock()
        self._version = int(version)
        self._chain_crc = int(chain_crc) & 0xFFFFFFFF
        self.lookups = 0
        self.rows_served = 0
        self.publishes_applied = 0
        self.apply_rejects = 0
        self.last_reject = ""
        # retrieval-index blocks riding this shard, and the (block,
        # version) each one's last publish displaced: what the
        # FF_FAULT_INDEX_STALE drill serves
        self._index_ops: set = set()
        self._prev_index: Dict[str, Tuple[QuantTable, int]] = {}

    def _wrap_block(self, op_name: str, arr):
        """A QuantTable stays as it is (a warm-cache boot); a policy op's
        fp32 rows are quantized on the CPU; other rows become fp32
        numpy."""
        if isinstance(arr, QuantTable):
            return arr
        dt = self.quant.get(op_name)
        if dt:
            return QuantTable.from_dense(np.asarray(arr, np.float32), dt)
        return np.ascontiguousarray(arr, np.float32)

    @property
    def version(self) -> int:
        return self._version

    @property
    def chain_crc(self) -> int:
        return self._chain_crc

    def hbm_bytes(self) -> int:
        """The bytes the shard holds (the JAX name; table blocks are in
        host RAM here, index blocks on their device)."""
        return int(sum(b.nbytes for b in self._blocks.values()))

    def owned_range(self, op_name: str) -> Tuple[int, int]:
        return self._ranges[op_name]

    # --- read path -----------------------------------------------------
    def lookup(self, requests: Dict[str, np.ndarray]
               ) -> Tuple[Dict[str, Any], int]:
        """Serve every op's requested rows in ONE locked read; returns
        ``({op: (k, d) rows}, version)``. A quantized (index) block
        answers its (codes, scales, dtype) payload."""
        # fault hooks outside the lock: an injected slow lookup stalls
        # this caller, never a concurrent publish
        faults.maybe_lookup_delay(self.sid)
        if faults.take_shard_down(self.sid):
            raise ShardDown(self.sid, "fault injection")
        out = {}
        served = 0
        with self._lock:
            ver = self._version
            for op_name, ids in requests.items():
                lo, hi = self._ranges[op_name]
                g = np.asarray(ids, np.int64)
                if g.size and (int(g.min()) < lo or int(g.max()) >= hi):
                    raise ValueError(
                        f"shard {self.sid} (slot {self.slot}) asked for "
                        f"rows outside its [{lo}, {hi}) range of "
                        f"{op_name!r}")
                blk = self._blocks[op_name]
                if isinstance(blk, QuantTable):
                    q, s = blk.take(g - lo)
                    out[op_name] = (q, s, blk.dtype)
                else:
                    out[op_name] = blk[g - lo]
                served += int(g.size)
            self.lookups += 1
            self.rows_served += served
        return out, ver

    # --- the retrieval-index surface (retrieve/index.py) ----------------
    def attach_block(self, op_name: str, block: QuantTable, lo: int,
                     hi: int) -> None:
        """Install an index row block [lo, hi) on this shard: addressed,
        published to and versioned like a table block (one lock, one
        version, one chain)."""
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
            self.quant[op_name] = "int8"

    def topk(self, op_name: str, q_codes, q_scales, k: int
             ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Local MIPS top-k over this shard's [lo, hi) slice: ((B, k')
        fp32 scores, (B, k') int64 global ids, version) as numpy,
        ordered (score desc, id asc), in one locked read. The query codes
        move to the block's device; the answer's copy to the host is the
        one synchronisation."""
        from ..ops.kernels.topk import mips_topk
        faults.maybe_lookup_delay(self.sid)
        if faults.take_shard_down(self.sid) or \
                faults.take_topk_drop(self.sid):
            raise ShardDown(self.sid, "fault injection")
        stale = faults.take_index_stale(self.sid)
        with self._lock:
            blk = self._blocks.get(op_name)
            ver = self._version
            if op_name not in self._index_ops or blk is None:
                raise ValueError(f"shard {self.sid} has no retrieval "
                                 f"index {op_name!r} attached")
            lo, _hi = self._ranges[op_name]
            if stale and op_name in self._prev_index:
                # the stale drill: the block the last publish displaced
                # (real rows, one version behind, reported as such)
                blk, ver = self._prev_index[op_name]
            scores, ids = mips_topk(q_codes.to(blk.device),
                                    q_scales.to(blk.device), blk.q,
                                    blk.scales, k, base=lo)
            scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
            self.lookups += 1
            self.rows_served += int(ids.size)
        return scores, ids, ver

    # --- write path (publishes) ----------------------------------------
    def apply_publish(self, sub: Optional[Dict[str, Any]], version: int,
                      expect_crc: Optional[int] = None) -> bool:
        """Apply one publish's slice for this shard atomically. ``sub``
        None = the publish touched no row this shard owns (a version bump
        and a chain link). The slice CRC is recomputed here and must
        equal ``expect_crc``: a mismatch raises ``ChainError`` and the
        shard keeps its old version (it lags, and the watcher's catch-up
        repairs it). A version at or below the shard's is a no-op."""
        slice_crc = 0
        if sub is not None:
            slice_crc = shard_slice_crc(sub)
            if expect_crc is not None and slice_crc != expect_crc:
                reason = (f"publish {version} slice CRC {slice_crc} != "
                          f"declared {expect_crc} (corrupt in transit)")
                with self._lock:
                    self.apply_rejects += 1
                    self.last_reject = reason
                raise ChainError(reason)
        with self._lock:
            if int(version) <= self._version:
                return False
            if sub is not None:
                self._validate_slice(sub, version)
                if self._index_ops:
                    # keep each touched index block as it was before the
                    # publish: the FF_FAULT_INDEX_STALE drill answers
                    # from it
                    touched = {key.split("/")[1]
                               for part in ("rows", "full")
                               for key in sub.get(part, {})}
                    for op_name in touched & self._index_ops:
                        self._prev_index[op_name] = (
                            self._blocks[op_name].copy(), self._version)
                for key, (idx, vals) in sub.get("rows", {}).items():
                    op_name = key.split("/")[1]
                    lo, _hi = self._ranges[op_name]
                    g = np.asarray(idx, np.int64) - lo
                    block = self._blocks[op_name]
                    if isinstance(block, QuantTable):
                        # re-quantized per row: the codec is idempotent
                        block.set_rows(g, np.asarray(vals, np.float32))
                    else:
                        block[g] = vals
                for key, arr in sub.get("full", {}).items():
                    block = self._blocks[key.split("/")[1]]
                    if isinstance(block, QuantTable):
                        block.set_all(np.asarray(arr, np.float32))
                    else:
                        block[...] = arr
            self._chain_crc = shard_chain_crc(self._chain_crc,
                                              int(version), slice_crc)
            self._version = int(version)
            self.publishes_applied += 1
        return True

    def _validate_slice(self, sub: Dict[str, Any], version: int) -> None:
        """Reject (``ChainError``, counted) a slice that routes rows
        outside this shard's ranges or ships a full block of the wrong
        shape, before any of it lands. Runs under the shard's lock."""
        reason = ""
        for key, (idx, _vals) in sub.get("rows", {}).items():
            op_name = key.split("/")[1]
            lo, hi = self._ranges[op_name]
            g = np.asarray(idx, np.int64)
            if g.size and (int(g.min()) < lo or int(g.max()) >= hi):
                reason = (f"publish {version} routes rows outside this "
                          f"shard's [{lo}, {hi}) range of {op_name!r}")
                break
        for key, arr in sub.get("full", {}).items():
            op_name = key.split("/")[1]
            block = self._blocks[op_name]
            if tuple(arr.shape) != tuple(block.shape):
                reason = (f"publish {version} full slice for {op_name!r} "
                          f"has shape {arr.shape}, shard block is "
                          f"{block.shape}")
                break
        if reason:
            self.apply_rejects += 1
            self.last_reject = reason
            raise ChainError(reason)

    def install_blocks(self, blocks: Dict[str, Any], version: int,
                       chain_crc: int = 0) -> bool:
        """Full replacement (a full-snapshot reload): new blocks, a new
        chain anchor. A no-op below the current version. An attached
        index the snapshot does not carry stays."""
        with self._lock:
            if int(version) < self._version:
                return False
            for k in blocks:
                if k not in self._ranges:
                    raise ValueError(f"shard {self.sid} owns no range "
                                     f"of {k!r}")
            new_blocks = {k: self._wrap_block(k, v)
                          for k, v in blocks.items()}
            for k in self._index_ops:
                if k not in new_blocks and k in self._blocks:
                    new_blocks[k] = self._blocks[k]
            self._blocks = new_blocks
            self._version = int(version)
            self._chain_crc = int(chain_crc) & 0xFFFFFFFF
        return True

    def blocks_copy(self) -> Tuple[Dict[str, Any], int, int]:
        """(blocks copy, version, chain crc): one consistent snapshot for
        the warm cache."""
        with self._lock:
            return ({k: v.copy() for k, v in self._blocks.items()},
                    self._version, self._chain_crc)

    def stats(self) -> Dict[str, Any]:
        return {
            "sid": self.sid,
            "slot": self.slot,
            "domain": self.domain,
            "version": self._version,
            "chain_crc": self._chain_crc,
            "lookups": self.lookups,
            "rows_served": self.rows_served,
            "publishes_applied": self.publishes_applied,
            "apply_rejects": self.apply_rejects,
            "last_reject": self.last_reject,
            "hbm_bytes": self.hbm_bytes(),
        }

    # --- the process boundary -------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """This shard's serving surface (lookup, publish, install, probe,
        stats) on a wire socket: the started
        :class:`~.transport.ShardServer` (its ``address`` holds the port
        the system chose for ``port=0``)."""
        from .transport import ShardServer
        return ShardServer(self, host=host, port=port).start()

    def serve_forever(self, host: str = "127.0.0.1",
                      port: int = 0) -> None:
        """This shard as a blocking socket server: the body of a shard
        process (``python -m dlrm_flexflow_tpu_torch.serve.
        shard_server``)."""
        from .transport import ShardServer
        ShardServer(self, host=host, port=port).serve_forever()


class ShardReplica(CircuitBreaker):
    """One :class:`EmbeddingShard` behind the circuit breaker: eject on
    consecutive errors, probe after the cooldown, re-admit only on probe
    success. ``rid`` is the shard's sid."""

    KIND = "shard"

    def __init__(self, shard: EmbeddingShard, state: str = HEALTHY):
        super().__init__(shard.sid, state=state)
        self.shard = shard
        # consecutive failed probes since ejection: the replace-dead
        # trigger (a shard that keeps failing probes is gone, not slow)
        self.probe_failures = 0

    @property
    def sid(self) -> int:
        return self.shard.sid

    @property
    def slot(self) -> int:
        return self.shard.slot

    def stats(self) -> Dict[str, Any]:
        out = self.breaker_stats()
        out["probe_failures"] = self.probe_failures
        out.update(self.shard.stats())
        return out


class EmbeddingShardSet:
    """The lookup tier: N shards tiling every host table's flat row
    space, with the routing, retry and hedging, degradation, publish
    fan-out and replace-dead machinery over them. One set serves every
    ranker of the process."""

    # publishes kept for a replacement's catch-up: a replacement booting
    # from a slightly stale warm-cache entry replays what it missed
    HISTORY = 64

    def __init__(self, shards: List[ShardReplica], config: ShardTierConfig,
                 ranges_by_op: Optional[Dict[str, list]] = None,
                 flat_rows: Optional[Dict[str, int]] = None,
                 defaults: Optional[Dict[str, np.ndarray]] = None,
                 bounds: Optional[Dict[str, List[Tuple[int, int]]]] = None,
                 dims: Optional[Dict[str, int]] = None,
                 fingerprint: str = "", cache=None):
        if not shards:
            raise ValueError("a shard set needs at least one shard")
        self.config = config
        self.shards = shards                 # copy-on-write list
        self.nshards = len(shards)
        self._ranges = dict(ranges_by_op or {})   # op -> [(lo, hi)]/slot
        self._flat_rows = dict(flat_rows or {})   # op -> total flat rows
        self._defaults = dict(defaults or {})     # op -> (tables, d)
        self._bounds = dict(bounds or {})         # op -> per-table [lo, hi)
        self._dims = dict(dims or {})             # op -> row width
        self._quant: Dict[str, str] = {
            k: v for r in shards for k, v in r.shard.quant.items()}
        self.fingerprint = fingerprint
        self._cache = cache                  # utils.warmcache.ShardCache
        self._set_lock = threading.Lock()
        # publishes serialize here, so every shard sees the same order
        # (the chain CRC is order-sensitive)
        self._apply_lock = threading.Lock()
        self._version = max(r.shard.version for r in shards)
        self._installed_any = False
        self._history: List[Tuple[int, Dict[int, Optional[dict]]]] = []
        self._next_sid = max(r.sid for r in shards) + 1
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * self.nshards),
            thread_name_prefix="ff-shard-lookup")
        self._closed = False
        self._m_lock = threading.Lock()
        # the lookup tier's own latency window (ff_shard_fetch_latency_ms
        # with --obs on), apart from the ranker's end-to-end one
        self._fetch_ms = obsm.latency_reservoir(
            "ff_shard_fetch_latency_ms",
            "one batched lookup round across the owning shards",
            maxlen=2048)
        obsm.register_collector(self._obs_collect)
        self._fetches = 0
        self._degraded_fetches = 0
        self._defaults_used = 0
        self._retries = 0
        self._hedges = 0
        self._timeouts = 0
        self._failed_fetches = 0
        self.replacements = 0
        self.replace_rejects = 0
        self.last_replace_reject = ""
        # the retrieval index riding the set (attach_index), and the
        # device its blocks live on (a replacement's cached blocks move
        # there)
        self._index_op: Optional[str] = None
        self._index_device: Optional[torch.device] = None
        self._topk_queries = 0
        self._topk_degraded = 0
        self._health_thread: Optional[threading.Thread] = None
        self._health_stop = threading.Event()

    # --- construction --------------------------------------------------
    @classmethod
    def build(cls, model, nshards: int,
              config: Optional[ShardTierConfig] = None,
              cache_dir: Optional[str] = None) -> "EmbeddingShardSet":
        """Slice ``model``'s host-resident tables into ``nshards`` row
        shards. The model keeps its tables until
        :meth:`release_ranker_tables` frees them."""
        config = config or ShardTierConfig(nshards=nshards)
        config.nshards = nshards
        lay = _tier_layout(model, nshards)
        ranges_by_op = lay["ranges_by_op"]
        cache = None
        if cache_dir:
            from ..utils.warmcache import ShardCache
            cache = ShardCache(cache_dir, fingerprint=lay["fingerprint"])
        domains = _domains(config, nshards)
        shards = []
        for slot in range(nshards):
            shard = EmbeddingShard(
                slot, slot, lay["slot_blocks"][slot],
                {name: ranges_by_op[name][slot] for name in ranges_by_op},
                version=lay["version"], domain=domains[slot],
                quant=lay["qmap"])
            shards.append(ShardReplica(shard))
        out = cls(shards, config, ranges_by_op, lay["flat_rows"],
                  lay["defaults"], lay["bounds"], lay["dims"],
                  fingerprint=lay["fingerprint"], cache=cache)
        out._persist_all()
        if cache is not None:
            cache.put_meta(nshards, _layout_meta(lay, nshards, domains))
        log_shard.info(
            "shard set built: %d shard(s) x %d table op(s), %.1f MB/shard "
            "(largest), version %d", nshards, len(ranges_by_op),
            max(r.shard.hbm_bytes() for r in shards) / 1e6, lay["version"])
        return out

    @staticmethod
    def seed_shard_cache(model, nshards: int, cache_dir: str,
                         config: Optional[ShardTierConfig] = None):
        """Slice ``model`` once and persist every slot's blocks and the
        tier-geometry sidecar into ``cache_dir``: the boot source of
        shard processes and of replacements. Returns the
        :class:`~..utils.warmcache.ShardCache`."""
        from ..utils.warmcache import ShardCache
        config = config or ShardTierConfig(nshards=nshards)
        lay = _tier_layout(model, nshards)
        cache = ShardCache(cache_dir, fingerprint=lay["fingerprint"])
        qmap = lay["qmap"]
        for slot in range(nshards):
            # the representation a live shard holds: a policy op's block
            # as codes + scales (the codes of the fake-quantized slice)
            blocks = {k: (QuantTable.from_dense(v, qmap[k]) if k in qmap
                          else v)
                      for k, v in lay["slot_blocks"][slot].items()}
            cache.put(nshards, slot, blocks, lay["version"], 0)
        cache.put_meta(nshards, _layout_meta(lay, nshards,
                                             _domains(config, nshards)))
        return cache

    @classmethod
    def connect(cls, addresses: List[Any],
                config: Optional[ShardTierConfig] = None,
                cache_dir: Optional[str] = None,
                meta: Optional[Dict[str, Any]] = None
                ) -> "EmbeddingShardSet":
        """The lookup tier over shard PROCESSES: one
        :class:`~.transport.RemoteShard` per ``host:port`` (or
        ``(host, port)``) address, slot = list position. The geometry
        comes from ``meta`` or the ``cache_dir`` sidecar
        (:meth:`seed_shard_cache`); each shard is probed once here, so an
        unreachable process fails now, naming its slot. With
        ``cache_dir`` a killed shard process is replaced by an in-process
        shard booted from the same warm cache."""
        from .transport import RemoteShard, WireClient, WireError
        if not addresses:
            raise ValueError("connect() needs at least one shard address")
        nshards = len(addresses)
        config = config or ShardTierConfig(nshards=nshards,
                                           transport="tcp")
        config.nshards = nshards
        cache = None
        if cache_dir:
            from ..utils.warmcache import ShardCache
            cache = ShardCache(cache_dir)
        if meta is None:
            if cache is None:
                raise ValueError(
                    "connect() needs the tier geometry: pass meta= or "
                    "cache_dir= (seed it with seed_shard_cache)")
            meta = cache.get_meta(nshards)
            if meta is None:
                raise ValueError(
                    f"no tier meta for {nshards} shard(s) in "
                    f"{cache_dir!r}: {cache.last_reject or 'missing'} — "
                    f"run seed_shard_cache first")
        if cache is not None:
            cache.fingerprint = str(meta.get("fingerprint", ""))
        ranges_by_op = {k: [(int(lo), int(hi)) for lo, hi in v]
                        for k, v in meta["ranges"].items()}
        flat_rows = {k: int(v) for k, v in meta["flat_rows"].items()}
        dims = {k: int(v) for k, v in meta["dims"].items()}
        bounds = {k: [(int(lo), int(hi)) for lo, hi in v]
                  for k, v in meta["bounds"].items()}
        defaults = {k: np.asarray(v, np.float32)
                    for k, v in meta["defaults"].items()}
        qmap = {str(k): str(v)
                for k, v in (meta.get("quant") or {}).items()}
        domains = list(meta.get("domains") or [""] * nshards)
        lookup_s = max(config.lookup_deadline_ms / 1e3, 0.001)
        shards = []
        try:
            for slot, addr in enumerate(addresses):
                host, port = _parse_address(addr)
                client = WireClient(
                    (host, port), seam="lookup", retries=config.retries,
                    backoff_ms=config.backoff_ms,
                    default_deadline_s=max(10.0, lookup_s),
                    name=f"shard{slot}")
                remote = RemoteShard(slot, slot, client,
                                     domain=domains[slot], quant=qmap,
                                     lookup_deadline_s=lookup_s)
                shards.append(ShardReplica(remote))
                try:
                    remote.refresh()   # fail fast on a dead process
                except WireError as e:
                    raise ShardDown(slot, f"slot {slot} at {host}:{port} "
                                          f"did not answer its probe: {e}"
                                    ) from e
        except BaseException:
            for rep in shards:
                rep.shard.close()
            raise
        out = cls(shards, config, ranges_by_op, flat_rows, defaults,
                  bounds, dims, fingerprint=str(meta.get("fingerprint", "")),
                  cache=cache)
        out._quant = qmap
        log_shard.info("shard set connected: %d remote shard(s) over tcp, "
                       "version %d", nshards, out.version)
        return out

    @staticmethod
    def release_ranker_tables(model) -> int:
        """Free a ranker model's host tables (tables live once, in the
        shard tier); returns the bytes released. Serving never reads
        ``host_params`` once a shard set is attached; training the model
        again needs a fresh restore."""
        model._host_drain()
        freed = 0
        for op in model._host_resident_list:
            tbl = model.host_params.get(op.name)
            if not tbl:
                continue
            for name, arr in list(tbl.items()):
                freed += int(arr.nbytes)
                tbl[name] = np.zeros((0,) + arr.shape[1:], arr.dtype)
        model._host_tables_released = True
        return freed

    # --- lifecycle -----------------------------------------------------
    def close(self) -> None:
        self.stop_health()
        self._closed = True
        obsm.unregister_collector(self._obs_collect)
        # wait=False: an abandoned (delayed) lookup must not wedge close
        self._pool.shutdown(wait=False)
        for rep in self.shards:
            closer = getattr(rep.shard, "close", None)
            if closer is not None:
                closer()   # a RemoteShard's connection pool

    def __enter__(self) -> "EmbeddingShardSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- routing helpers -----------------------------------------------
    def _by_slot(self) -> Dict[int, ShardReplica]:
        return {r.slot: r for r in self.shards}

    @property
    def version(self) -> int:
        return self._version

    def min_version(self) -> Optional[int]:
        """The oldest version among non-ejected shards: the serving
        version floor the watcher's catch-up keys on. None when every
        shard is ejected."""
        alive = [r.shard.version for r in self.shards if r.state != EJECTED]
        return min(alive) if alive else None

    def degraded_now(self) -> bool:
        """True while any shard is out of the routable set."""
        return any(r.state != HEALTHY for r in self.shards)

    def _default_rows(self, op_name: str, ids: np.ndarray) -> np.ndarray:
        """Per-table default rows for flat ids (the degradation fill)."""
        tb = self._bounds[op_name]
        starts = np.asarray([lo for lo, _ in tb], np.int64)
        t = np.clip(np.searchsorted(starts, np.asarray(ids, np.int64),
                                    side="right") - 1, 0, len(tb) - 1)
        return self._defaults[op_name][t]

    # --- the lookup path -----------------------------------------------
    def fetch(self, plan: Dict[str, np.ndarray],
              deadline_s: Optional[float] = None,
              degrade: Optional[str] = None) -> FetchResult:
        """Resolve every op's unique flat row ids in one round: group by
        owning shard, one deadline-bounded lookup per shard (all ops
        batched: the per-shard consistency unit), retry and hedge per
        policy, and degrade to per-table default rows where a shard's
        budget is spent. The deadline bounds EACH shard's lookup, retries
        included. ``plan`` maps op name -> 1-D unique flat ids."""
        cfg = self.config
        t_fetch = time.perf_counter()
        if deadline_s is None:
            deadline_s = cfg.lookup_deadline_ms / 1e3
        degrade = degrade or cfg.degrade
        rows: Dict[str, np.ndarray] = {}
        mask: Dict[str, np.ndarray] = {}
        per_slot: Dict[int, Dict[str, Tuple[np.ndarray, np.ndarray]]] = {}
        for op_name, u in plan.items():
            u = np.asarray(u, np.int64)
            rows[op_name] = np.empty((u.size, self._dims[op_name]),
                                     np.float32)
            mask[op_name] = np.zeros(u.size, bool)
            owners = row_owners(u, self._flat_rows[op_name], self.nshards)
            for slot in np.unique(owners):
                m = owners == slot
                per_slot.setdefault(int(slot), {})[op_name] = \
                    (np.flatnonzero(m), u[m])
        versions: Dict[int, int] = {}
        degraded = False
        defaults_used = 0
        by_slot = self._by_slot()
        # only a hedge (a duplicate racing the first lookup) is worth the
        # pool's hand-off; otherwise the lookups run inline (an
        # in-process gather is microseconds), under the same deadline
        use_pool = cfg.hedge_ms > 0
        first = {}
        if use_pool:
            for slot, reqs in per_slot.items():
                rep = by_slot.get(slot)
                if rep is not None and rep.state == HEALTHY \
                        and not self._closed:
                    first[slot] = self._pool.submit(
                        rep.shard.lookup,
                        {k: ids for k, (_, ids) in reqs.items()})
        for slot, reqs in per_slot.items():
            rep = by_slot.get(slot)
            got = None
            if rep is not None and rep.state == HEALTHY and not self._closed:
                dl = Deadline(deadline_s)
                try:
                    if use_pool:
                        got = self._await_lookup(rep, reqs, first.get(slot),
                                                 dl)
                    else:
                        got = self._lookup_inline(rep, reqs, dl)
                except Exception as e:   # noqa: BLE001 — budget spent
                    if degrade == "fail":
                        with self._m_lock:
                            self._failed_fetches += 1
                        raise ShardTierUnavailable(
                            f"shard {rep.sid} (slot {slot}, domain "
                            f"{rep.shard.domain or 'n/a'}) lookup failed "
                            f"and --serve-degrade=fail: "
                            f"{type(e).__name__}: {e}") from e
            elif degrade == "fail":
                with self._m_lock:
                    self._failed_fetches += 1
                raise ShardTierUnavailable(
                    f"shard slot {slot} is "
                    f"{rep.state if rep else 'missing'} and "
                    f"--serve-degrade=fail")
            if got is not None:
                resp, ver = got
                versions[slot] = ver
                for op_name, (pos, _ids) in reqs.items():
                    val = resp[op_name]
                    if isinstance(val, tuple):
                        from ..quant.codec import dequantize_rows
                        val = dequantize_rows(*val).cpu().numpy()
                    rows[op_name][pos] = val
            else:
                # graceful degradation: per-table default rows, flagged
                degraded = True
                for op_name, (pos, ids) in reqs.items():
                    rows[op_name][pos] = self._default_rows(op_name, ids)
                    mask[op_name][pos] = True
                    defaults_used += int(ids.size)
        with self._m_lock:
            self._fetches += 1
            if degraded:
                self._degraded_fetches += 1
                self._defaults_used += defaults_used
        self._fetch_ms.observe(1e3 * (time.perf_counter() - t_fetch))
        return FetchResult(rows, mask, versions, degraded, defaults_used)

    def _after_error(self, rep: ShardReplica, err: BaseException,
                     attempt: int, dl: Deadline) -> None:
        """Feed one failed attempt to the breaker (ejecting past the
        threshold); raise ``err`` when the budget is spent, else count a
        retry and back off."""
        cfg = self.config
        if rep.record_error(err, cfg.eject_after):
            rep.eject(f"{cfg.eject_after} consecutive lookup errors, "
                      f"last: {err}")
        if (attempt > cfg.retries or dl.expired()
                or rep.state != HEALTHY or self._closed):
            raise err
        with self._m_lock:
            self._retries += 1
        time.sleep(min((cfg.backoff_ms / 1e3) * (2 ** (attempt - 1)),
                       max(dl.remaining(), 0.0)))

    def _lookup_inline(self, rep: ShardReplica, reqs, dl: Deadline):
        """The no-hedge lookup: the shard is called on this thread, with
        the pooled path's deadline, retry and breaker semantics. A result
        that arrives after the deadline is discarded as a timeout."""
        request = {k: ids for k, (_, ids) in reqs.items()}
        attempt = 0
        while True:
            try:
                got = rep.shard.lookup(request)
                if not dl.expired():
                    rep.record_success()
                    return got
                with self._m_lock:
                    self._timeouts += 1
                err: BaseException = ShardLookupTimeout(
                    f"shard {rep.sid} lookup returned after its "
                    f"{dl.seconds * 1e3:.0f} ms deadline "
                    f"({dl.elapsed() * 1e3:.0f} ms)")
            except Exception as e:   # noqa: BLE001 — ShardDown etc.
                err = e
            attempt += 1
            self._after_error(rep, err, attempt, dl)

    def _await_lookup(self, rep: ShardReplica, reqs, fut, dl: Deadline):
        """Wait on one shard's lookup under its deadline, with bounded
        retry and hedging (a duplicate after ``hedge_ms``; the first
        result wins)."""
        cfg = self.config
        request = {k: ids for k, (_, ids) in reqs.items()}
        attempt = 0
        while True:
            futs = [fut] if fut is not None else \
                [self._pool.submit(rep.shard.lookup, request)]
            fut = None
            done, _ = wait(futs, timeout=min(cfg.hedge_ms / 1e3,
                                             max(dl.remaining(), 0.0)))
            if not done and not self._closed:
                futs.append(self._pool.submit(rep.shard.lookup, request))
                with self._m_lock:
                    self._hedges += 1
            done, _ = wait(futs, timeout=max(dl.remaining(), 0.0),
                           return_when=FIRST_COMPLETED)
            err: Optional[BaseException] = None
            for f in done:
                e = f.exception()
                if e is None:
                    rep.record_success()
                    return f.result()
                err = e
            if err is None:
                with self._m_lock:
                    self._timeouts += 1
                err = ShardLookupTimeout(
                    f"shard {rep.sid} lookup missed its "
                    f"{dl.seconds * 1e3:.0f} ms deadline (waited "
                    f"{dl.elapsed() * 1e3:.0f} ms)")
            attempt += 1
            self._after_error(rep, err, attempt, dl)

    # --- the retrieval-index surface (retrieve/index.py) ---------------
    def attach_index(self, op_name: str, table, device="cuda") -> None:
        """Attach the retrieval index as one more table: the full
        (n_items, d) int8 ``QuantTable`` (or fp32 rows to quantize here)
        split over the slots by the same owner math, published to through
        the same routing (key ``hostparams/<op_name>/kernel``) and
        versioned by the same per-shard chain. Each shard gets its own
        copy of its rows, on ``device`` (the card unless the caller asks
        for the CPU)."""
        table = as_device_table(table, device)
        rows, dim = int(table.shape[0]), int(table.shape[1])
        ranges = shard_row_ranges(rows, self.nshards)
        with self._apply_lock:
            by_slot = self._by_slot()
            for slot, (lo, hi) in enumerate(ranges):
                rep = by_slot.get(slot)
                if rep is None:
                    continue
                # clone, not a view: the caller's full table must not
                # bleed into published shard state
                block = QuantTable(table.q[lo:hi].clone(),
                                   table.scales[lo:hi].clone(), "int8")
                rep.shard.attach_block(op_name, block, lo, hi)
            self._ranges[op_name] = [(int(lo), int(hi))
                                     for lo, hi in ranges]
            self._flat_rows[op_name] = rows
            self._dims[op_name] = dim
            self._bounds[op_name] = [(0, rows)]
            self._defaults[op_name] = np.zeros((1, dim), np.float32)
            self._quant[op_name] = "int8"
            self._index_op = op_name
            self._index_device = table.device
            self._persist_all()

    def topk_partials(self, q_codes, q_scales, k: int,
                      deadline_s: Optional[float] = None,
                      degrade: Optional[str] = None) -> TopKPartials:
        """Fan one quantized query batch out to every healthy shard's
        local top-k (on the set's pool) and collect the partials. Each
        answer waits under its own deadline; an error or a missed
        deadline feeds the breaker and DROPS that shard's candidates
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

    # --- publish fan-out (driven by the rankers' install paths) --------
    def apply_delta(self, payload: Dict[str, Any], version: int) -> int:
        """Route one delta publish's host-table rows to their owning
        shards (``split_host_rows_by_shard``), each slice CRC-checked by
        its shard and applied atomically; the other shards get the
        version bump and chain link. Idempotent per shard (every ranker's
        watcher routes the same publish). Returns how many shards applied
        rows."""
        with obstrace.span("publish/shard-apply", version=int(version)), \
                self._apply_lock:
            if (int(version) <= self._version and self._installed_any
                    and not self.lagging_slots()):
                return 0     # another ranker routed it already
            subs = split_host_rows_by_shard(payload, self._ranges)
            applied = 0
            for rep in list(self.shards):
                if rep.state == EJECTED:
                    # a crashed shard receives nothing: it comes back
                    # stale and its probe refuses admission until
                    # catch-up or replace-dead brings it to the tip
                    continue
                sub = subs.get(rep.slot)
                try:
                    if rep.shard.apply_publish(
                            sub, version,
                            None if sub is None else sub.get("crc")):
                        applied += int(sub is not None)
                except ChainError as e:
                    # the shard keeps its old consistent version and
                    # lags; the watcher's catch-up replays the chain
                    log_shard.warning(
                        "shard %d rejected publish %d: %s — shard lags at "
                        "version %d", rep.sid, version, e,
                        rep.shard.version)
            self._version = max(self._version, int(version))
            self._installed_any = True
            self._history.append((int(version), subs))
            del self._history[:-self.HISTORY]
            self._persist_all()
        return applied

    def install_full(self, host_params: Dict[str, Dict[str, np.ndarray]],
                     version: int) -> bool:
        """Full-snapshot reload: re-slice every table onto its shards (a
        new chain anchor on each). Idempotent per version."""
        with self._apply_lock:
            if (int(version) <= self._version and self._installed_any
                    and not self.lagging_slots()):
                return False
            remote_blocks = {}
            for rep in list(self.shards):
                if rep.state == EJECTED:
                    continue   # as apply_delta
                blocks = {}
                for op_name, ranges in self._ranges.items():
                    tbl = host_params.get(op_name)
                    if tbl is None:
                        continue
                    kern = tbl["kernel"]
                    flat = np.asarray(kern).reshape(-1, kern.shape[-1])
                    if flat.shape[0] != self._flat_rows[op_name]:
                        # a released ranker's 0-row stub or a foreign
                        # geometry: never slice that over shard blocks
                        log_shard.warning(
                            "install_full: %r has %d flat rows, the shard "
                            "tier serves %d — table skipped", op_name,
                            flat.shape[0], self._flat_rows[op_name])
                        continue
                    lo, hi = ranges[rep.slot]
                    blocks[op_name] = flat[lo:hi].copy()
                if blocks:
                    rep.shard.install_blocks(blocks, version)
                    if getattr(rep.shard, "remote", False):
                        remote_blocks[rep.slot] = (blocks,
                                                   rep.shard.chain_crc)
                else:
                    rep.shard.apply_publish(None, version)
            self._version = max(self._version, int(version))
            self._installed_any = True
            self._history.clear()
            self._persist_all()
            if self._cache is not None:
                # a shard process's blocks live there, but this install's
                # are in hand: the warm cache a replacement boots from
                # stays at the chain anchor the history replays from
                for slot, (blocks, crc) in remote_blocks.items():
                    self._cache.put(self.nshards, slot, blocks,
                                    int(version), crc)
        return True

    def lagging_slots(self) -> List[int]:
        """Slots whose shard trails the set's tip (a rejected slice or a
        stale replacement): what the watcher's catch-up repairs."""
        return [r.slot for r in self.shards
                if r.state != EJECTED and r.shard.version < self._version]

    def _persist_all(self) -> None:
        """Warm-cache every live shard's blocks (the replace-dead boot
        source). Best-effort."""
        if self._cache is None:
            return
        for rep in self.shards:
            if rep.state == EJECTED:
                continue   # don't clobber the entry with stale blocks
            if getattr(rep.shard, "remote", False):
                # a shard process's blocks live there; its boot source,
                # the seeded cache, already covers a replacement
                continue
            blocks, ver, crc = rep.shard.blocks_copy()
            self._cache.put(self.nshards, rep.slot, blocks, ver, crc)

    # --- health: probe, re-admit, replace-dead -------------------------
    def probe(self, rep: ShardReplica) -> bool:
        """Admission probe: a real lookup of each op's first owned row
        under the probe deadline, plus freshness: a shard is re-admitted
        only at the set's current version."""
        cfg = self.config
        rep.begin_probe()
        request = {}
        for op_name, ranges in self._ranges.items():
            lo, hi = ranges[rep.slot]
            if hi > lo:
                request[op_name] = np.asarray([lo], np.int64)
        try:
            fut = self._pool.submit(rep.shard.lookup, request)
            _resp, ver = fut.result(cfg.probe_deadline_s)
            if ver < self._version:
                raise ChainError(
                    f"shard is at version {ver}, set tip is "
                    f"{self._version} (stale — needs catch-up before "
                    f"admission)")
        except Exception as e:   # noqa: BLE001 — stays ejected
            rep.probe_failed(f"{type(e).__name__}: {e}")
            rep.probe_failures += 1
            return False
        rep.readmit()
        rep.probe_failures = 0
        return True

    def replace(self, slot: int) -> Optional[int]:
        """Replace-dead: boot a new shard for ``slot`` from the warm
        cache, replay the publishes its blocks predate from the history,
        and swap it in born PROBING (it serves nothing until its probe
        succeeds). Returns the new sid, or None with the reason recorded
        (the set keeps degrading; nothing got worse)."""
        def _reject(reason: str) -> None:
            self.replace_rejects += 1
            self.last_replace_reject = reason
            log_shard.warning("shard replace(slot=%d) rejected: %s — "
                              "continuing degraded", slot, reason)

        if self._cache is None:
            _reject("no shard warm cache configured")
            return None
        got = self._cache.get(self.nshards, slot)
        if got is None:
            _reject(f"warm cache miss: "
                    f"{self._cache.last_reject or 'no entry'}")
            return None
        blocks, ver, chain_crc = got
        for op_name, ranges in self._ranges.items():
            lo, hi = ranges[slot]
            blk = blocks.get(op_name)
            if blk is None or blk.shape[0] != hi - lo:
                _reject(f"cached blocks have wrong geometry for {op_name!r}"
                        f" (got {None if blk is None else blk.shape}, want "
                        f"{hi - lo} rows)")
                return None
            if isinstance(blk, QuantTable) and self._index_device:
                blocks[op_name] = as_device_table(blk, self._index_device)
        with self._set_lock:
            sid = self._next_sid
            self._next_sid += 1
        old = self._by_slot().get(slot)
        shard = EmbeddingShard(
            sid, slot, blocks,
            {name: self._ranges[name][slot] for name in self._ranges},
            version=ver, chain_crc=chain_crc,
            domain=old.shard.domain if old is not None else "",
            quant=self._quant)
        if self._index_op is not None:
            shard._index_ops.add(self._index_op)
            shard.quant[self._index_op] = "int8"
        with self._apply_lock:
            # replay what the cached blocks missed; the slice CRCs check
            # each replayed publish again
            for v, subs in self._history:
                if v > shard.version:
                    sub = subs.get(slot)
                    try:
                        shard.apply_publish(
                            sub, v, None if sub is None else sub.get("crc"))
                    except ChainError as e:
                        _reject(f"catch-up replay of publish {v} failed: "
                                f"{e}")
                        return None
            if shard.version < self._version:
                _reject(f"cached blocks at version {shard.version} predate "
                        f"the retained history (tip {self._version}) — "
                        f"needs a full reload")
                return None
            fresh = ShardReplica(shard, state=PROBING)
            with self._set_lock:
                self.shards = [fresh if r.slot == slot else r
                               for r in self.shards]
                self.replacements += 1
        log_shard.warning(
            "shard slot %d replaced (%s -> sid %d) from the warm cache at "
            "version %d; awaiting admission probe", slot,
            f"sid {old.sid}" if old else "none", sid, shard.version)
        return sid

    def health_tick(self) -> List[Dict[str, Any]]:
        """One health pass: probe the shards due for one, replace those
        whose probes keep failing. Returns the actions taken."""
        cfg = self.config
        actions: List[Dict[str, Any]] = []
        for rep in list(self.shards):
            if rep.state == HEALTHY or not rep.due_for_probe(cfg.cooldown_s):
                continue
            if (rep.probe_failures >= cfg.replace_after
                    and not rep.awaiting_admission):
                new_sid = self.replace(rep.slot)
                actions.append({"action": "shard-replace", "slot": rep.slot,
                                "old_sid": rep.sid, "new_sid": new_sid})
                continue
            ok = self.probe(rep)
            actions.append({"action": "shard-probe", "slot": rep.slot,
                            "sid": rep.sid, "ok": ok})
        return actions

    def start_health(self, interval_s: float = 0.25
                     ) -> "EmbeddingShardSet":
        """The set's own health thread (the app's single-engine mode):
        daemon, stopped and joined by :meth:`stop_health`."""
        if self._health_thread is not None:
            return self
        self._health_stop.clear()

        def _loop():
            while not self._health_stop.wait(interval_s):
                try:
                    self.health_tick()
                except Exception:   # noqa: BLE001 — health must outlive
                    log_shard.exception("shard health tick failed")

        self._health_thread = threading.Thread(
            target=_loop, daemon=True, name="ff-shard-health")
        self._health_thread.start()
        return self

    def stop_health(self) -> None:
        t = self._health_thread
        if t is None:
            return
        self._health_stop.set()
        t.join(5.0)
        self._health_thread = None

    # --- plans + observability -----------------------------------------
    def serving_plan(self) -> Dict[str, Any]:
        """The static description of the tier: shard count, per-op flat
        row counts and ranges, the largest shard's bytes, the failure
        domains and the riding index."""
        out = {
            "nshards": self.nshards,
            "flat_rows": dict(self._flat_rows),
            "ranges": {k: list(v) for k, v in self._ranges.items()},
            "shard_hbm_bytes": max(r.shard.hbm_bytes()
                                   for r in self.shards),
            "domains": sorted({r.shard.domain for r in self.shards
                               if r.shard.domain}),
        }
        if self._index_op is not None:
            out["retrieve_index"] = {
                "op": self._index_op,
                "rows": int(self._flat_rows[self._index_op]),
                "dim": int(self._dims[self._index_op]),
                "quant": self._quant.get(self._index_op, "int8"),
                "sharded": True,
            }
        return out

    def version_vector(self) -> Dict[int, int]:
        return {r.slot: r.shard.version for r in self.shards}

    def _obs_collect(self):
        """Registry collector: the tier's counters and per-shard health
        as scrapeable samples (the numbers stats() reports)."""
        yield "ff_shard_fetches_total", {}, self._fetches
        yield "ff_shard_degraded_fetches_total", {}, self._degraded_fetches
        yield "ff_shard_defaults_used_total", {}, self._defaults_used
        yield "ff_shard_retries_total", {}, self._retries
        yield "ff_shard_timeouts_total", {}, self._timeouts
        yield "ff_shard_failed_fetches_total", {}, self._failed_fetches
        yield "ff_shard_replacements_total", {}, self.replacements
        yield "ff_shard_version_floor", {}, (self.min_version() or 0)
        for r in self.shards:
            yield ("ff_shard_healthy", {"slot": str(r.slot)},
                   1.0 if r.state == HEALTHY else 0.0)

    def stats(self) -> Dict[str, Any]:
        with self._m_lock:
            out = {
                "nshards": self.nshards,
                "version": self._version,
                "versions": self.version_vector(),
                "states": {r.slot: r.state for r in self.shards},
                "degraded_now": self.degraded_now(),
                "fetch_p50_ms": self._fetch_ms.percentile(50),
                "fetch_p99_ms": self._fetch_ms.percentile(99),
                "fetches": self._fetches,
                "degraded_fetches": self._degraded_fetches,
                "defaults_used": self._defaults_used,
                "topk_queries": self._topk_queries,
                "topk_degraded": self._topk_degraded,
                "retries": self._retries,
                "hedges": self._hedges,
                "timeouts": self._timeouts,
                "failed_fetches": self._failed_fetches,
                "replacements": self.replacements,
                "replace_rejects": self.replace_rejects,
                "last_replace_reject": self.last_replace_reject,
                "lagging_slots": self.lagging_slots(),
                "shards": {r.slot: r.stats() for r in self.shards},
            }
        domains: Dict[str, Dict[str, int]] = {}
        for r in self.shards:
            if r.shard.domain:
                d = domains.setdefault(r.shard.domain,
                                       {"shards": 0, "healthy": 0})
                d["shards"] += 1
                d["healthy"] += int(r.state == HEALTHY)
        if domains:
            out["failure_domains"] = domains
        if self._cache is not None:
            out["shard_cache"] = self._cache.stats()
        return out


# ---------------------------------------------------------------------
# feasibility accounting
# ---------------------------------------------------------------------
def _param_bytes(op) -> int:
    return sum(int(np.prod(d.shape)) * torch.empty((), dtype=d.dtype)
               .element_size() for d in op.param_defs().values())


def serving_footprint(model, replicas: int, nshards: int = 0,
                      ranker_holds_tables: Optional[bool] = None
                      ) -> Dict[str, Any]:
    """Static per-process residency of a serving deployment: what one
    ranker replica and (sharded) one lookup shard must hold. A replicated
    fleet's replicas each hold every table; the sharded tier's rankers
    hold the dense parameters, and each shard ~1/nshards of the tables.
    Tables count at their stored bytes under their storage policy
    (``quant.param_storage_bytes``: int8 rows and fp32 row scales, not
    the trainer's fp32 master), over the JAX op's stored (lane-packed)
    shapes, as the JAX package prices them."""
    from ..core.op import InputOp
    from ..ops.embedding import quant_row_width
    from ..quant.policy import param_storage_bytes
    dense = 0
    tables = 0
    for op in model.ops:
        if isinstance(op, InputOp) or not op.param_defs():
            continue
        if hasattr(op, "host_lookup"):
            # the stored rows: (numel / w, w), w the packed row width
            w = quant_row_width(op)
            shapes = {n: ((int(np.prod(d.shape)) // w, w)
                          if n == "kernel" else tuple(d.shape))
                      for n, d in op.param_defs().items()}
            tables += int(param_storage_bytes(op, None, shapes))
        else:
            dense += _param_bytes(op)
    if ranker_holds_tables is None:
        ranker_holds_tables = nshards <= 0 \
            and not getattr(model, "_host_tables_released", False)
    per_shard = (-(-int(tables) // nshards)) if nshards > 0 else 0
    ranker = dense + (tables if ranker_holds_tables else 0)
    return {
        "replicas": int(replicas),
        "nshards": int(nshards),
        "dense_bytes": int(dense),
        "table_bytes": int(tables),
        "ranker_bytes": int(ranker),
        "shard_bytes": int(per_shard),
        "fleet_table_bytes": int(tables * replicas
                                 if ranker_holds_tables else tables),
    }


def check_serving_feasible(model, replicas: int, hbm_bytes: float,
                           nshards: int = 0) -> Dict[str, Any]:
    """The admission check a serving launcher runs before boot: the
    footprint report plus ``feasible`` and ``reason``. A replicated fleet
    whose tables exceed the per-replica budget is refused; the sharded
    tier admits a model as long as its dense parameters and one shard's
    rows fit."""
    fp = serving_footprint(model, replicas, nshards)
    worst = max(fp["ranker_bytes"], fp["shard_bytes"])
    fp["hbm_bytes"] = int(hbm_bytes)
    fp["feasible"] = worst <= hbm_bytes
    if fp["feasible"]:
        fp["reason"] = ""
    elif nshards <= 0:
        fp["reason"] = (
            f"replicated fleet infeasible: each replica must hold "
            f"{fp['ranker_bytes'] / 1e6:.1f} MB (tables "
            f"{fp['table_bytes'] / 1e6:.1f} MB) against a "
            f"{hbm_bytes / 1e6:.1f} MB budget — shard the lookup tier "
            f"(--serve-shards)")
    else:
        fp["reason"] = (
            f"sharded tier infeasible at {nshards} shard(s): worst "
            f"process holds {worst / 1e6:.1f} MB against "
            f"{hbm_bytes / 1e6:.1f} MB — raise --serve-shards")
    return fp
