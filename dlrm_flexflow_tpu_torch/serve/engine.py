"""Online inference engine: dynamic batching over ``FFModel.forward_bucket``
(the counterpart of ``dlrm_flexflow_tpu.serve.engine``).

``InferenceEngine`` accepts per-request feature dicts from any number of
threads into a bounded queue, and one batcher thread forms dynamic
batches. Admission is **continuous** by default: the moment a dispatch
completes, everything that queued while it ran forms the next batch. The
**flush** mode (``continuous=False``) dispatches a batch only when it
reaches ``max_batch`` rows or its oldest request has waited
``max_delay_ms``. Every batch is zero-padded up to a power-of-two
bucket (all buckets are run once at ``start()``, so no live request
pays a first call) and the padding is sliced off before the response.

- **Backpressure**: a submit against a full queue raises a typed
  :class:`Overloaded` immediately.
- **Deadlines**: a request still queued past ``deadline_ms`` fails with
  :class:`DeadlineExceeded` instead of taking a batch slot.
- **Zero-downtime reload**: with ``checkpoint_dir``, a
  :class:`~.watcher.SnapshotWatcher` polls the trainer's directory and
  hands full snapshots to ``install_snapshot`` and delta snapshots to
  ``install_delta``. Both PARK the new state; the batcher thread applies
  it between dispatches (the model is only ever touched by that
  thread), so a batch runs entirely on the old weights or entirely on
  the new ones, and every response carries the version (checkpoint
  step) it was computed with. A delta is written in place
  (``FFModel.apply_delta``), which is safe only there: no other thread
  queues kernels that read the tables.
- **Host-resident tables**: with ``cache_rows`` the host gather goes
  through a per-sample LRU row cache (``serve/cache.py``), pre-warmed
  from a published id histogram (``cache_warm``); a full reload drops
  it, a delta drops only the samples whose rows it rewrote. With a
  shard set attached (``attach_shard_set``, ``serve/shardtier.py``) the
  engine is a stateless ranker: every op's cache misses go to the shard
  tier in one fetch, host-table rows of a publish route to the owning
  shards, and each response carries the per-shard version vector read
  and whether it was answered with default rows (``degraded``). Rows
  gathered on the host go to the card after the table lock is released.
- **Observability**: ``stats()`` (latency percentiles, batch fill,
  reload counters, the cache and the tier), ``healthz()`` for a load
  balancer, and with ``--obs on`` the JAX engine's ``ff_serve_*``
  series and ``serve/...`` spans.
- **Fleet hooks**: ``replica_id``, ``queue_depth``, ``alive()``, the
  batcher's :class:`~..utils.watchdog.Heartbeat` (``heartbeat_age``),
  ``drain_pending`` and ``state_snapshot``: what ``serve/fleet.py``'s
  ``Replica`` and ``serve/router.py``'s ``FleetRouter`` read.
  ``FF_FAULT_REPLICA_DOWN`` fails a replica's dispatches with
  :class:`ReplicaDown`; ``FF_FAULT_SERVE_DELAY`` slows them.
- **The process boundary**: ``serve()`` puts the engine behind a wire
  server (``serve/transport.py`` ``EngineServer``) and
  ``serve_forever()`` is the body of a ranker-replica process, which a
  router reaches through ``RemoteEngineClient``.

The batcher thread launches the model's kernels on its current CUDA
stream; copying the scores to the host is the synchronisation. Replicas
sharing a card each launch on their batcher thread's current stream.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..data.dataloader import coalesce_batches
from ..obs import metrics as obsm
from ..obs import trace as obstrace
from ..obs.metrics import percentile  # noqa: F401 — re-exported
from ..utils import faults
from ..utils.logging import get_logger
from ..utils.watchdog import Heartbeat
from .cache import EmbeddingCache

log_serve = get_logger("serve")


class Overloaded(RuntimeError):
    """The bounded request queue is full — typed backpressure. Callers
    shed or retry with backoff; the engine never buffers unboundedly."""

    def __init__(self, depth: int, capacity: int):
        super().__init__(
            f"serving queue full ({depth}/{capacity} requests) — "
            f"rejecting (backpressure); retry with backoff or raise "
            f"--serve-queue")
        self.depth = depth
        self.capacity = capacity


class DeadlineExceeded(TimeoutError):
    """A request missed its per-request deadline while queued."""


class ReplicaDown(RuntimeError):
    """This replica is gone: a crash (``FF_FAULT_REPLICA_DOWN``), a dead
    batcher or its process, or the router's circuit breaker draining an
    ejected replica's queue. Retryable: the fleet router re-routes the
    request to a surviving replica."""

    def __init__(self, replica_id: Optional[int] = None, detail: str = ""):
        rid = "?" if replica_id is None else replica_id
        super().__init__(f"serving replica {rid} is down"
                         + (f": {detail}" if detail else ""))
        self.replica_id = replica_id


class Prediction(NamedTuple):
    """Per-request result: model scores for the request's rows, the
    weight version that computed them, and the end-to-end latency.
    ``versions`` (the per-shard version vector read) and ``degraded``
    (default rows served for a dead shard) are the shard tier's; an
    engine without one answers None and False, as the JAX engine does."""

    scores: np.ndarray
    version: int
    latency_ms: float
    versions: Optional[Dict[int, int]] = None
    degraded: bool = False


@dataclass
class ServeConfig:
    """Engine knobs; ``from_config`` lifts the ``--serve-*`` flags."""

    max_batch: int = 64          # largest bucket / flush-on-size bound
    max_delay_ms: float = 5.0    # flush-mode deadline for a partial batch
    queue_capacity: int = 256    # bounded queue -> Overloaded past this
    deadline_ms: float = 0.0     # per-request budget; 0 = none
    cache_rows: int = 0          # embedding-row cache capacity; 0 = off
    cache_warm: str = ""         # id-histogram npz (or checkpoint dir)
    #                              to pre-warm the row cache from
    poll_s: float = 0.5          # snapshot-watcher poll interval
    warmup: bool = True          # run every bucket once at start()
    continuous: bool = True      # iteration-level admission; False =
    #                              pure size/deadline flush
    reshard: bool = False        # take snapshots written under another
    #                              mesh (a one-card replica following a
    #                              trainer across ranks)

    @staticmethod
    def from_config(cfg) -> "ServeConfig":
        return ServeConfig(
            max_batch=int(cfg.serve_max_batch),
            max_delay_ms=float(cfg.serve_max_delay_ms),
            queue_capacity=int(cfg.serve_queue),
            deadline_ms=float(cfg.serve_deadline_ms),
            cache_rows=int(cfg.serve_cache_rows),
            cache_warm=str(cfg.serve_cache_warm),
            poll_s=float(cfg.serve_poll_s),
            continuous=cfg.serve_batching != "flush",
            reshard=int(cfg.serve_replicas) > 1)


class _Request:
    __slots__ = ("features", "rows", "future", "t0", "deadline")

    def __init__(self, features, rows, deadline_s: float):
        self.features = features
        self.rows = rows
        self.future: Future = Future()
        self.t0 = time.monotonic()
        self.deadline = self.t0 + deadline_s if deadline_s > 0 else None


class InferenceEngine:
    """Thread-safe dynamic-batching server over a compiled FFModel.

    The model must be compiled and hold parameters. The engine owns the
    model's serving lifecycle from ``start()`` to ``close()``; its
    batcher thread is the only one that runs the model meanwhile. With
    ``checkpoint_dir`` it follows a trainer's published snapshots
    (:class:`~.watcher.SnapshotWatcher`, started by ``start()``). With
    ``shard_set`` (or :meth:`attach_shard_set` before ``start()``) it
    resolves host-table ids through that shard tier.
    """

    def __init__(self, model, config: Optional[ServeConfig] = None,
                 checkpoint_dir: Optional[str] = None,
                 replica_id: Optional[int] = None, shard_set=None):
        if model.params is None:
            raise ValueError("InferenceEngine needs an initialized model "
                             "(init_layers() or swap_params())")
        self._model = model
        # the fleet's name for this engine (None: a lone engine); fault
        # hooks, thread names and metric labels key on it
        self.replica_id = replica_id
        # the row-sharded lookup tier: when set, host-table ids resolve
        # through it (fronted by the row cache), publishes' host rows
        # route to its shards, and responses carry its version vector
        self._shard_set = shard_set
        self._lookup_meta = None   # the batcher's per-batch scratch
        self.config = config or ServeConfig.from_config(model.config)
        if self.config.max_batch < 1:
            raise ValueError("serve max_batch must be >= 1")
        self._buckets = tuple(model.bucket_sizes(self.config.max_batch))
        self.max_batch = self._buckets[-1]
        self._input_names = {t.name for t in model.input_tensors}
        # per-sample shapes for submit-time validation: a wrong-shaped
        # feature fails THERE as a ValueError, not at dispatch where it
        # would fail the whole batch
        self._input_sample_shapes = {t.name: tuple(t.shape[1:])
                                     for t in model.input_tensors}
        # the row cache applies to host-resident tables only
        self._cache: Optional[EmbeddingCache] = None
        if self.config.cache_rows > 0 and model._host_resident_list:
            # a quantized policy's entries hold codes + row scales
            quant = {name: pol.dtype
                     for name, pol in model.quant_policies().items()
                     if pol.is_quantized}
            self._cache = EmbeddingCache(self.config.cache_rows,
                                         quant=quant)
        self._checkpoint_dir = checkpoint_dir
        self._watcher = None
        self._q: "deque[_Request]" = deque()
        self._q_rows = 0
        self._cond = threading.Condition()
        self._closing = False
        self._started = False
        self._thread: Optional[threading.Thread] = None
        # parked installs, applied in order by the batcher between
        # dispatches: ("full", state, ...) replaces everything queued
        # before it, ("delta", payload, ...) and ("call", fn, ...)
        # append. The lock guards only the hand-off, never device work.
        self._swap_lock = threading.Lock()
        self._pending: List[tuple] = []
        self._version = int(model._step)
        # the version of the weights the batcher has applied: the tag
        # on each response (== _version once the parked install lands)
        self._applied_version = self._version
        # whether any install was applied: until then the engine serves
        # the model's own state, whose step can coincide with a
        # published step without being that state
        self._applied_any = False
        # stats have their own lock: stats() readers race the batcher
        self._stats_lock = threading.Lock()
        # the series carry the fleet replica id; a lone engine's is ""
        self._lat_ms = obsm.latency_reservoir(
            "ff_serve_request_latency_ms",
            "end-to-end request latency at the engine", maxlen=4096,
            replica="" if replica_id is None else str(replica_id))
        self._n_requests = 0
        self._n_responses = 0
        self._n_overloaded = 0
        self._n_timeouts = 0
        self._n_batches = 0
        self._rows_served = 0
        self._rows_padded = 0
        self._reloads = 0
        self._delta_reloads = 0
        self._reload_rejects = 0
        self._last_reject = ""
        self._n_degraded = 0
        self._last_versions: Dict[int, int] = {}
        self._warmup_s = 0.0
        self._flushes = {"continuous": 0, "size": 0, "deadline": 0}
        # the batcher beats once around its loop; the router ejects a
        # replica whose heartbeat goes stale (a wedged dispatch)
        self._heartbeat = Heartbeat(self._thread_name())

    def _thread_name(self) -> str:
        return ("ff-serve-batcher" if self.replica_id is None
                else f"ff-serve-batcher-{self.replica_id}")

    # --- lifecycle -----------------------------------------------------
    def start(self) -> "InferenceEngine":
        """Run every bucket once, start the batcher thread and, with a
        checkpoint directory, the snapshot watcher."""
        if self._started:
            return self
        self._started = True
        if self.config.warmup:
            self._warmup_s = self._model.warmup_buckets(
                self._buckets, **self._gather_kw())
        self._prewarm_cache()
        self._thread = threading.Thread(target=self._batcher, daemon=True,
                                        name=self._thread_name())
        self._thread.start()
        # the stats() counters as scrapeable series (no-op with obs off)
        obsm.register_collector(self._obs_collect)
        if self._checkpoint_dir:
            from .watcher import SnapshotWatcher
            self._watcher = SnapshotWatcher(
                self, self._checkpoint_dir, poll_s=self.config.poll_s,
                elastic=self.config.reshard)
            self._watcher.start()
        return self

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """This engine's dispatch surface (predict, health, stats, probe)
        on a wire socket: the started :class:`~.transport.EngineServer`
        (its ``address`` holds the port the system chose for
        ``port=0``). The engine must be started."""
        from .transport import EngineServer
        return EngineServer(self, host=host, port=port).start()

    def serve_forever(self, host: str = "127.0.0.1",
                      port: int = 0) -> None:
        """This engine as a blocking socket server: the body of a
        ranker-replica process, reached through
        :class:`~.transport.RemoteEngineClient`."""
        from .transport import EngineServer
        EngineServer(self, host=host, port=port).serve_forever()

    def close(self, deadline_s: float = 10.0) -> None:
        """Drain the queue (pending requests still get answers), stop
        the watcher and the batcher; raises TimeoutError if the batcher
        does not stop in time."""
        with self._cond:
            if not self._started or self._closing:
                self._closing = True
                return
            self._closing = True
            self._cond.notify_all()
        obsm.unregister_collector(self._obs_collect)
        if self._watcher is not None:
            self._watcher.stop()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(deadline_s if deadline_s > 0 else None)
            if t.is_alive():
                raise TimeoutError(
                    f"serving batcher did not drain within {deadline_s} s "
                    f"({len(self._q)} requests still queued)")

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # --- request path --------------------------------------------------
    def submit(self, features: Dict[str, Any]) -> Future:
        """Enqueue one request (1+ rows); returns a Future resolving to
        a :class:`Prediction`. Raises :class:`Overloaded` when the
        bounded queue is full, ValueError on malformed features."""
        feats = {}
        for k, v in features.items():
            if k not in self._input_names:
                raise ValueError(
                    f"unknown input {k!r}; model inputs are "
                    f"{sorted(self._input_names)}")
            arr = np.asarray(v)
            want = self._input_sample_shapes[k]
            if arr.ndim >= 1 and tuple(arr.shape[1:]) != want:
                if (arr.ndim and want
                        and math.prod(arr.shape[1:]) == math.prod(want)):
                    # same per-sample element count, other layout (e.g.
                    # sparse (n, T) for a (n, T, 1) bag input): the
                    # reshape is unambiguous
                    arr = arr.reshape((arr.shape[0],) + want)
                else:
                    raise ValueError(
                        f"input {k!r} rows have per-sample shape "
                        f"{tuple(arr.shape[1:])}; the model expects "
                        f"{want}")
            feats[k] = arr
        missing = self._input_names - set(feats)
        if missing:
            raise ValueError(f"request is missing inputs {sorted(missing)}")
        rows = {int(v.shape[0]) if v.ndim else -1 for v in feats.values()}
        if len(rows) != 1 or -1 in rows:
            raise ValueError(
                f"request inputs disagree on the sample dim: {rows}")
        n = rows.pop()
        if n < 1:
            raise ValueError("request must carry at least one row")
        if n > self.max_batch:
            raise ValueError(
                f"request rows {n} exceed serve max_batch "
                f"{self.max_batch}; split the request")
        req = _Request(feats, n, self.config.deadline_ms / 1e3)
        with obstrace.span("serve/enqueue", rows=n), self._cond:
            if self._closing:
                raise RuntimeError("engine is closed")
            if not self._started:
                raise RuntimeError("engine not started (call start())")
            if len(self._q) >= self.config.queue_capacity:
                self._n_overloaded += 1
                raise Overloaded(len(self._q), self.config.queue_capacity)
            self._q.append(req)
            self._q_rows += n
            self._n_requests += 1
            self._cond.notify_all()
        return req.future

    def predict(self, features: Dict[str, Any],
                timeout: Optional[float] = None) -> Prediction:
        """Synchronous submit+wait."""
        return self.submit(features).result(timeout)

    # --- batcher -------------------------------------------------------
    def _batcher(self) -> None:
        while True:
            # parked installs apply HERE, between dispatches: an idle
            # engine picks one up within a wakeup, a busy one between
            # batches
            self._apply_pending_swap()
            take: List[_Request] = []
            flush = "continuous"
            t_form = time.perf_counter()
            with self._cond:
                self._heartbeat.beat()
                while (not self._q and not self._closing
                        and not self._pending):
                    self._cond.wait(0.1)
                    self._heartbeat.beat()
                if not self._q and self._closing:
                    return
                if not self._q:   # woken only to apply a parked install
                    continue
                if not self.config.continuous:
                    # flush-cycle mode: a batch is open from the moment
                    # its OLDEST request arrived; flush on size or on
                    # that request's age
                    t_flush = (self._q[0].t0
                               + self.config.max_delay_ms / 1e3)
                    while (self._q_rows < self.max_batch
                           and not self._closing):
                        left = t_flush - time.monotonic()
                        if left <= 0:
                            break
                        self._cond.wait(left)
                        self._heartbeat.beat()
                    flush = ("size" if self._q_rows >= self.max_batch
                             else "deadline")
                rows = 0
                while self._q and rows + self._q[0].rows <= self.max_batch:
                    r = self._q.popleft()
                    self._q_rows -= r.rows
                    rows += r.rows
                    take.append(r)
            if take:
                obstrace.complete("serve/batch-form", t_form,
                                  requests=len(take), flush=flush)
                with self._stats_lock:
                    self._flushes[flush] += 1
                try:
                    self._dispatch(take)
                except Exception as e:   # noqa: BLE001 — a model error
                    # must fail THESE requests, not kill serving
                    for r in take:
                        if not r.future.done():
                            r.future.set_exception(e)

    def prewarm_cache_from(self, sketches) -> None:
        """Pre-warm the row cache from live sketches ({op name:
        IdFrequencySketch}) instead of a published file."""
        self._prewarm_cache(hists=sketches)

    def _prewarm_cache(self, hists=None) -> None:
        """Pre-warm the row cache from a published id histogram
        (``cache_warm``: the ``id_histogram.npz`` a DeltaPublisher writes
        beside its snapshots, or the directory holding it), or from
        ``hists``. Index tuples are drawn from each table's observed
        marginal (``sample_range``, one RandomState(0) stream, as the JAX
        engine draws them), so a fresh replica starts with the hot
        working set cached. A missing or unreadable histogram starts the
        cache cold."""
        if self._cache is None:
            return
        if hists is None and not self.config.cache_warm:
            return
        model = self._model
        if model._host_tables_released:
            log_serve.info("cache pre-warm skipped: ranker tables released "
                           "to the shard tier (warm hits come from live "
                           "traffic instead)")
            return
        if hists is None:
            import os

            from ..utils.histogram import HISTOGRAM_FILE, load_histograms
            path = self.config.cache_warm
            if os.path.isdir(path):
                path = os.path.join(path, HISTOGRAM_FILE)
            try:
                hists = load_histograms(path)
            except (IOError, OSError, ValueError, KeyError) as e:
                log_serve.warning("cache pre-warm skipped: cannot read id "
                                  "histogram %s (%s)", path, e)
                return
        else:
            path = "<live sketches>"
        rng = np.random.RandomState(0)
        n = max(min(self.config.cache_rows, 2048), 1)
        warmed = 0
        for op in model._host_resident_list:
            sk = hists.get(op.name)
            if sk is None:
                continue
            sample_shape = tuple(op.inputs[0].shape[1:])  # (T, bag)|(bag,)
            if hasattr(op, "table_sizes"):        # concat: offset ranges
                bag = sample_shape[-1]
                cols = [sk.sample_range(rng, off, off + sz, (n, bag))
                        for off, sz in zip(op._offsets, op.table_sizes)]
                idx = np.stack(cols, axis=1)
            elif len(sample_shape) == 2:          # stacked (T, bag)
                rows = op.num_entries
                cols = [sk.sample_range(rng, t * rows, (t + 1) * rows,
                                        (n, sample_shape[1]))
                        for t in range(sample_shape[0])]
                idx = np.stack(cols, axis=1)
            else:                                 # one table, (bag,)
                idx = sk.sample_range(rng, 0, op.num_entries,
                                      (n,) + sample_shape)
            idx = np.ascontiguousarray(idx, np.int32)
            with model._host_table_lock:
                warmed += self._cache.prewarm(
                    op, model.host_params[op.name], idx)
        if warmed:
            log_serve.info("pre-warmed %d embedding-cache entr%s from %s",
                           warmed, "y" if warmed == 1 else "ies", path)

    def _host_gather(self):
        """The host-table gather the dispatch passes the model: the
        shard-tier gather with a shard set, the cached gather with a
        cache, else None (the model's own)."""
        if self._shard_set is not None:
            return self._shard_gather()
        if self._cache is None:
            return None
        model = self._model
        cache = self._cache

        def gather(host_idx):
            # rows come out under the table lock (fresh arrays); their
            # copy to the card runs after it is released
            rows = {}
            with obstrace.span("host/gather", cat="host"), \
                    model._host_table_lock:
                for op in model._host_resident_list:
                    rows[op.name] = cache.lookup(
                        op, model.host_params[op.name], host_idx[op.name])
            with obstrace.span("host/h2d", cat="host"):
                return {k: torch.from_numpy(v).to(model.device)
                        for k, v in rows.items()}

        return gather

    def _gather_kw(self) -> Dict[str, Any]:
        """``host_gather=`` for the model's forward, when this engine has
        a gather of its own."""
        gather = self._host_gather()
        return {} if gather is None else {"host_gather": gather}

    def attach_shard_set(self, shard_set) -> "InferenceEngine":
        """Wire this ranker to a (shared) EmbeddingShardSet, before
        ``start()`` (the bucket warmup runs through the gather)."""
        if self._started:
            raise RuntimeError("attach_shard_set before start()")
        self._shard_set = shard_set
        return self

    @property
    def shard_set(self):
        return self._shard_set

    def _shard_gather(self):
        """The shard-tier gather: probe the cache per sample and op,
        batch EVERY op's misses into ONE ``EmbeddingShardSet.fetch`` (one
        locked read per shard: the version-vector consistency unit),
        assemble the miss samples through the op's ``host_lookup_rows``
        (bitwise the local host path), and cache only the samples no
        default row went into. The batch's version vector and per-row
        degraded marks are left for ``_dispatch`` to tag the responses
        with."""
        model = self._model
        cache = self._cache
        shard_set = self._shard_set

        def gather(host_idx):
            plan = {}
            per_op = {}
            n_rows = None
            for op in model._host_resident_list:
                idx = np.asarray(host_idx[op.name])
                n_rows = int(idx.shape[0])
                if cache is not None:
                    vals, miss = cache.probe(op, idx)
                else:
                    vals, miss = [None] * n_rows, list(range(n_rows))
                entry = {"idx": idx, "vals": vals, "miss": miss}
                if miss:
                    g3 = op.host_flat_indices(idx[np.asarray(miss)])
                    u, inv = np.unique(g3, return_inverse=True)
                    entry.update(g3=g3, u=u, inv=inv.reshape(-1))
                    plan[op.name] = u
                per_op[op] = entry
            with obstrace.span("serve/shard-fetch", cat="host"):
                fetch = shard_set.fetch(plan) if plan else None
            row_degraded = np.zeros(n_rows or 0, bool)
            out_rows = {}
            for op, entry in per_op.items():
                vals, miss = entry["vals"], entry["miss"]
                if miss:
                    g3, inv = entry["g3"], entry["inv"]
                    rows = fetch.rows[op.name]
                    local = inv.reshape(g3.shape).astype(np.int64)
                    sub = np.asarray(op.host_lookup_rows(rows, local))
                    # the miss samples assembled from default rows:
                    # flagged degraded, never cached
                    dm = fetch.default_mask[op.name][inv].reshape(g3.shape)
                    sample_deg = dm.reshape(dm.shape[0], -1).any(axis=1)
                    if cache is not None:
                        sub = cache.insert(op, entry["idx"], miss, sub,
                                           ok=~sample_deg)
                    for j, i in enumerate(miss):
                        vals[i] = np.ascontiguousarray(sub[j])
                    row_degraded[np.asarray(miss)[sample_deg]] = True
                out_rows[op.name] = np.stack(vals, axis=0)
            self._lookup_meta = {
                "versions": (dict(fetch.versions) if fetch
                             else shard_set.version_vector()),
                "row_degraded": row_degraded,
            }
            with obstrace.span("host/h2d", cat="host"):
                return {k: torch.from_numpy(v).to(model.device)
                        for k, v in out_rows.items()}

        return gather

    def _dispatch(self, reqs: List[_Request]) -> None:
        # expired requests fail instead of wasting a batch slot
        live: List[_Request] = []
        now = time.monotonic()
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                with self._stats_lock:
                    self._n_timeouts += 1
                r.future.set_exception(DeadlineExceeded(
                    f"request of {r.rows} row(s) waited "
                    f"{1e3 * (now - r.t0):.1f} ms, past its "
                    f"{self.config.deadline_ms} ms deadline"))
            else:
                live.append(r)
        if not live:
            return
        # a crashed replica answers nothing: ReplicaDown fails the whole
        # batch and the fleet router re-routes every request
        if faults.take_replica_down(self.replica_id):
            raise ReplicaDown(self.replica_id, "fault injection")
        faults.maybe_serve_delay(self.replica_id)
        batch = coalesce_batches([r.features for r in live])
        n = sum(r.rows for r in live)
        bucket = next(b for b in self._buckets if b >= n)
        # a parked install lands first; the batch then runs with no lock
        # held, entirely on the weights it tags
        self._apply_pending_swap()
        version = self._applied_version
        self._lookup_meta = None
        with obstrace.span("serve/dispatch", rows=n, bucket=bucket):
            out = self._model.forward_bucket(batch, bucket=bucket,
                                             **self._gather_kw())
            scores = out.cpu().numpy()      # device -> host: the sync
        # the shard tier's notes on THIS batch: the version vector read
        # and which rows took default rows (padding rows past n count
        # for nothing)
        meta, self._lookup_meta = self._lookup_meta, None
        versions = meta["versions"] if meta else None
        rowdeg = meta["row_degraded"] if meta else None
        t_done = time.monotonic()
        off = 0
        n_degraded = 0
        for r in live:
            deg = bool(rowdeg is not None
                       and rowdeg[off:off + r.rows].any())
            n_degraded += int(deg)
            r.future.set_result(Prediction(
                scores[off:off + r.rows], version,
                1e3 * (t_done - r.t0), versions=versions, degraded=deg))
            off += r.rows
        with self._stats_lock:
            for r in live:
                self._lat_ms.append(1e3 * (t_done - r.t0))
            self._n_responses += len(live)
            self._n_degraded += n_degraded
            self._n_batches += 1
            self._rows_served += n
            self._rows_padded += bucket - n
            if versions is not None:
                self._last_versions = versions

    # --- hot reload (called by SnapshotWatcher) ------------------------
    def install_snapshot(self, state: Dict[str, Any], version: int,
                         source: str = "") -> None:
        """Swap in a loaded snapshot state (``checkpoint.
        load_params_for_swap``: its parameters already on the device,
        read and copied outside any lock) between dispatches. The state
        is PARKED; the batcher applies it, and the call returns once it
        has been applied. A full install supersedes every install parked
        before it (their callers are released). On an engine with no
        running batcher the install applies inline."""
        applied = threading.Event()
        with self._swap_lock:
            superseded = self._pending
            self._pending = ([e for e in superseded if e[0] == "call"]
                             + [("full", dict(state), int(version),
                                 source, applied)])
            self._version = int(version)
            self._reloads += 1
            for entry in superseded:
                if entry[0] != "call":
                    entry[4].set()
        self._await_applied(applied)

    def install_delta(self, payload: Dict[str, Any], version: int,
                      source: str = "") -> None:
        """Park an incremental delta (a ``load_delta_file`` payload,
        its rows staged on the device by ``stage_delta_rows`` outside
        any lock). The batcher applies it between dispatches with
        ``FFModel.apply_delta``, which makes its stream wait on the
        staging event first. Deltas append to the queue (dropping one
        would corrupt the chain); the call returns once applied."""
        applied = threading.Event()
        with self._swap_lock:
            self._pending.append(("delta", dict(payload), int(version),
                                  source, applied))
            self._version = int(version)
            self._reloads += 1
            self._delta_reloads += 1
        self._await_applied(applied)

    def run_quiesced(self, fn, label: str = ""):
        """Run ``fn()`` on the batcher thread between dispatches and
        return its result: the batch in flight finishes before ``fn``
        runs and the next one starts after it, with no lock held across
        the call. A failed ``fn`` re-raises here and counts as a reload
        reject; the batcher lives on."""
        box: Dict[str, Any] = {}

        def call():
            try:
                box["result"] = fn()
            except BaseException as e:   # noqa: BLE001 — re-raised to
                box["error"] = e         # the run_quiesced caller below
                raise

        applied = threading.Event()
        with self._swap_lock:
            self._pending.append(
                ("call", call, self._version,
                 label or getattr(fn, "__name__", "call"), applied))
        self._await_applied(applied)
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _await_applied(self, applied: threading.Event) -> None:
        t = self._thread
        if (t is None or not t.is_alive()
                or t is threading.current_thread()):
            self._apply_pending_swap()
            return
        with self._cond:
            self._cond.notify_all()   # wake an idle batcher to apply now
        while not applied.wait(0.05):
            t = self._thread
            if t is None or not t.is_alive():   # batcher died mid-wait:
                self._apply_pending_swap()      # no dispatch racer left
                return

    def _apply_pending_swap(self) -> None:
        """Drain the parked installs in order into the model: on the
        batcher thread between dispatches (or inline without one). The
        model changes OUTSIDE the lock, which guards only the hand-off."""
        with self._swap_lock:
            pending, self._pending = self._pending, []
        for kind, state, version, source, applied in pending:
            t_swap = time.perf_counter()
            try:
                if kind == "call":
                    state()
                    obstrace.complete("serve/quiesced", t_swap,
                                      label=source)
                    continue
                if kind == "full":
                    host_params = state.get("host_params")
                    if self._shard_set is not None:
                        # the host tables belong to the shard set
                        # (idempotent per version: every ranker's watcher
                        # routes the same snapshot); the ranker swaps its
                        # dense parameters only
                        if host_params is not None:
                            self._shard_set.install_full(host_params,
                                                         int(version))
                        host_params = None
                    self._model.swap_params(
                        params=state["params"], host_params=host_params,
                        op_state=state.get("op_state"))
                    self._model._step = int(version)
                    if self._cache is not None:
                        # as cold as a fresh start: re-warm against the
                        # new tables (a no-op without cache_warm)
                        self._cache.invalidate()
                        self._prewarm_cache()
                elif self._shard_set is not None:
                    # host-table rows route to their owning shards; the
                    # ranker applies the dense rest
                    self._shard_set.apply_delta(state, int(version))
                    dense = dict(state)
                    for part in ("rows", "full"):
                        dense[part] = {k: v for k, v in
                                       (state.get(part) or {}).items()
                                       if not k.startswith("hostparams/")}
                    self._model.apply_delta(dense)
                    self._invalidate_cache_rows(state)
                else:
                    self._model.apply_delta(state)
                    self._invalidate_cache_rows(state)
                self._applied_version = version
                self._applied_any = True
                obstrace.complete("serve/swap", t_swap, kind=kind,
                                  version=version)
                log_serve.info("hot-%s weights to version %d%s",
                               "reloaded" if kind == "full"
                               else "delta-patched", version,
                               f" from {source}" if source else "")
            except BaseException as e:   # noqa: BLE001 — a failed apply
                # must release the installer and show in stats, not kill
                # the batcher; the version rolls back to what is applied
                # so the watcher retries or falls back
                with self._swap_lock:
                    if not self._pending:
                        self._version = self._applied_version
                self.record_reload_reject(
                    f"staged {kind} (version {version}) failed to "
                    f"apply: {e}")
            finally:
                applied.set()

    def _invalidate_cache_rows(self, payload: Dict[str, Any]) -> None:
        """After a delta: drop only the cached samples a rewritten host
        row feeds (a whole host array replaced drops everything)."""
        if self._cache is None:
            return
        if any(k.startswith("hostparams/")
               for k in (payload.get("full") or {})):
            self._cache.invalidate()
            return
        for key, (idx, _vals) in (payload.get("rows") or {}).items():
            if key.startswith("hostparams/"):
                self._cache.invalidate_rows(key.split("/")[1],
                                            np.asarray(idx))

    def state_snapshot(self) -> tuple:
        """(state, version) of what this engine serves: the newest parked
        FULL install when there is one (it is the next batch's weights),
        else the model's current parameters, by reference. The fleet's
        rollback capture and canary promotion read through this. With a
        shard set the host tables are the tier's, not the ranker's:
        ``host_params`` is None."""
        m = self._model
        host = None if self._shard_set is not None else m.host_params
        with self._swap_lock:
            pending = self._pending
            if pending and pending[-1][0] == "full":
                _, state, version, _, _ = pending[-1]
                if self._shard_set is None and \
                        state.get("host_params") is not None:
                    host = state["host_params"]
                return ({"params": state.get("params", m.params),
                         "host_params": host,
                         "op_state": state.get("op_state") or {}},
                        version)
        return ({"params": m.params, "host_params": host, "op_state": {}},
                self._applied_version)

    def record_reload_reject(self, reason: str) -> None:
        self._reload_rejects += 1
        self._last_reject = reason
        log_serve.warning("snapshot reload rejected: %s — continuing to "
                          "serve version %d", reason, self._version)

    @property
    def version(self) -> int:
        return self._version

    @property
    def has_applied_snapshot(self) -> bool:
        """True once any install (full or delta) has been applied."""
        return self._applied_any

    @property
    def version_floor(self) -> int:
        """The oldest version anywhere in this engine's serving path: its
        own and (with a shard set) the oldest live shard's. The watcher
        keys its catch-up on it, so a replacement shard that booted stale
        keeps the chain replaying (idempotent per shard) until the whole
        tier is at the tip."""
        if self._shard_set is None:
            return self._version
        floor = self._shard_set.min_version()
        return self._version if floor is None else min(self._version, floor)

    @property
    def model(self):
        return self._model

    # --- fleet hooks (serve/fleet.py, serve/router.py) -----------------
    @property
    def queue_depth(self) -> int:
        """Requests queued now: the router's load-balancing signal."""
        return len(self._q)

    def alive(self) -> bool:
        """True while the batcher runs and the engine is started and not
        draining."""
        t = self._thread
        return bool(self._started and not self._closing
                    and t is not None and t.is_alive())

    def heartbeat_age(self) -> float:
        """Seconds since the batcher last went around its loop: past the
        dispatch latency only when it is wedged."""
        return self._heartbeat.age()

    @property
    def heartbeat(self) -> Heartbeat:
        return self._heartbeat

    def drain_pending(self, exc: Optional[BaseException] = None) -> int:
        """Fail every queued (not yet dispatched) request with ``exc``
        (default: this replica's ReplicaDown) and empty the queue: the
        router's ejection, whose retries re-route them to survivors.
        Returns how many were failed."""
        if exc is None:
            exc = ReplicaDown(self.replica_id, "queue drained on ejection")
        with self._cond:
            taken = list(self._q)
            self._q.clear()
            self._q_rows = 0
        n = 0
        for r in taken:
            if not r.future.done():
                r.future.set_exception(exc)
                n += 1
        return n

    def healthz(self) -> Dict[str, Any]:
        """Readiness for a /healthz endpoint: ``ok`` is False while the
        engine is draining (closing or never started), its batcher died,
        or the bounded queue is full (submits raise Overloaded now).
        ``degraded`` (with a shard set) is True while a shard is out of
        the routable set: answers are still served, flagged; degraded is
        not down."""
        depth = len(self._q)
        saturated = depth >= self.config.queue_capacity
        draining = self._closing or not self._started
        t = self._thread
        batcher_alive = bool(t is not None and t.is_alive())
        dead = self._started and not self._closing and not batcher_alive
        out = {
            "ok": not (saturated or draining or dead),
            "version": self._version,
            "draining": draining,
            "saturated": saturated,
            "batcher_alive": batcher_alive,
            "queue_depth": depth,
            "queue_capacity": self.config.queue_capacity,
        }
        if self._shard_set is not None:
            out["degraded"] = self._shard_set.degraded_now()
            out["shard_states"] = {r.slot: r.state
                                   for r in self._shard_set.shards}
        return out

    # --- observability -------------------------------------------------
    def _obs_collect(self):
        """Registry collector: the stats() counters as scrapeable
        samples, read through at scrape time."""
        lab = {"replica": ("" if self.replica_id is None
                           else str(self.replica_id))}
        yield "ff_serve_requests_total", lab, self._n_requests
        yield "ff_serve_responses_total", lab, self._n_responses
        yield "ff_serve_overloaded_total", lab, self._n_overloaded
        yield "ff_serve_timeouts_total", lab, self._n_timeouts
        yield "ff_serve_batches_total", lab, self._n_batches
        yield "ff_serve_queue_depth", lab, len(self._q)
        yield "ff_serve_reloads_total", lab, self._reloads
        yield "ff_serve_delta_reloads_total", lab, self._delta_reloads
        yield "ff_serve_reload_rejects_total", lab, self._reload_rejects
        yield "ff_serve_version", lab, self._version
        if self._shard_set is not None:
            yield "ff_serve_degraded_responses_total", lab, self._n_degraded
        if self._cache is not None:
            cs = self._cache.stats()
            yield "ff_serve_cache_hits_total", lab, cs["hits"]
            yield "ff_serve_cache_misses_total", lab, cs["misses"]

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            lat = sorted(self._lat_ms)
            flushes = dict(self._flushes)
            dispatched = self._rows_served + self._rows_padded
            out = {
                "requests": self._n_requests,
                "responses": self._n_responses,
                "overloaded": self._n_overloaded,
                "timeouts": self._n_timeouts,
                "batches": self._n_batches,
                "batch_fill": (self._rows_served / dispatched
                               if dispatched else 0.0),
            }
        out.update({
            "queue_depth": len(self._q),
            "p50_ms": percentile(lat, 50),
            "p99_ms": percentile(lat, 99),
            "version": self._version,
            "reloads": self._reloads,
            "full_reloads": self._reloads - self._delta_reloads,
            "delta_reloads": self._delta_reloads,
            "reload_rejects": self._reload_rejects,
            "last_reload_reject": self._last_reject,
            "buckets": list(self._buckets),
            "warmup_s": round(self._warmup_s, 4),
            "flushes": flushes,
            "continuous": self.config.continuous,
        })
        if self.replica_id is not None:
            out["replica_id"] = self.replica_id
        if self._shard_set is not None:
            out["degraded_responses"] = self._n_degraded
            out["shard_versions"] = dict(self._last_versions)
            out["shard_set"] = self._shard_set.stats()
        if self._cache is not None:
            out["embedding_cache"] = self._cache.stats()
        if self._watcher is not None:
            out["watcher"] = self._watcher.stats()
        return out
