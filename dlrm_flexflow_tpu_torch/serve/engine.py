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
- **Observability**: ``stats()`` (latency percentiles, batch fill,
  reload counters), ``healthz()`` for a load balancer, and with
  ``--obs on`` the JAX engine's ``ff_serve_*`` series and
  ``serve/...`` spans.

The batcher thread launches the model's kernels on its current CUDA
stream; copying the scores to the host is the synchronisation. The
JAX engine's embedding-row cache (ROADMAP queue 1 item 9.2, after 2.4),
fleet hooks (9.4), shard tier (9.3) and wire transport (``serve()``,
``serve_forever``: 9.4) are not ported yet and raise.
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

from ..data.dataloader import coalesce_batches
from ..obs import metrics as obsm
from ..obs import trace as obstrace
from ..obs.metrics import percentile  # noqa: F401 — re-exported
from ..utils.logging import get_logger

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
    poll_s: float = 0.5          # snapshot-watcher poll interval
    warmup: bool = True          # run every bucket once at start()
    continuous: bool = True      # iteration-level admission; False =
    #                              pure size/deadline flush

    @staticmethod
    def from_config(cfg) -> "ServeConfig":
        if cfg.serve_cache_rows > 0 or cfg.serve_cache_warm:
            raise NotImplementedError(
                "the serving row cache (--serve-cache-rows, "
                "--serve-cache-warm) caches host-resident tables and is "
                "not ported yet (ROADMAP queue 1 item 9.2, after 2.4)")
        if cfg.serve_replicas > 1:
            raise NotImplementedError(
                "the serving fleet (--serve-replicas) is not ported yet "
                "(ROADMAP queue 1 item 9.4)")
        return ServeConfig(
            max_batch=int(cfg.serve_max_batch),
            max_delay_ms=float(cfg.serve_max_delay_ms),
            queue_capacity=int(cfg.serve_queue),
            deadline_ms=float(cfg.serve_deadline_ms),
            poll_s=float(cfg.serve_poll_s),
            continuous=cfg.serve_batching != "flush")


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
    (:class:`~.watcher.SnapshotWatcher`, started by ``start()``).
    """

    def __init__(self, model, config: Optional[ServeConfig] = None,
                 checkpoint_dir: Optional[str] = None):
        if model.params is None:
            raise ValueError("InferenceEngine needs an initialized model "
                             "(init_layers() or swap_params())")
        self._model = model
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
        # the JAX engine's series carry its fleet replica id; a lone
        # engine's is ""
        self._lat_ms = obsm.latency_reservoir(
            "ff_serve_request_latency_ms",
            "end-to-end request latency at the engine", maxlen=4096,
            replica="")
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
        self._warmup_s = 0.0
        self._flushes = {"continuous": 0, "size": 0, "deadline": 0}

    # --- lifecycle -----------------------------------------------------
    def start(self) -> "InferenceEngine":
        """Run every bucket once, start the batcher thread and, with a
        checkpoint directory, the snapshot watcher."""
        if self._started:
            return self
        self._started = True
        if self.config.warmup:
            self._warmup_s = self._model.warmup_buckets(self._buckets)
        self._thread = threading.Thread(target=self._batcher, daemon=True,
                                        name="ff-serve-batcher")
        self._thread.start()
        # the stats() counters as scrapeable series (no-op with obs off)
        obsm.register_collector(self._obs_collect)
        if self._checkpoint_dir:
            from .watcher import SnapshotWatcher
            self._watcher = SnapshotWatcher(
                self, self._checkpoint_dir, poll_s=self.config.poll_s)
            self._watcher.start()
        return self

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """The JAX engine's wire server (predict / health / stats over a
        socket): not ported yet."""
        raise NotImplementedError(
            "InferenceEngine.serve(): the wire transport is not ported "
            "yet (ROADMAP queue 1 item 9.4); examples/native/serve_dlrm.py "
            "serves the engine over HTTP")

    def serve_forever(self, host: str = "127.0.0.1", port: int = 0):
        """The JAX ranker-replica process body: not ported yet."""
        raise NotImplementedError(
            "InferenceEngine.serve_forever(): the wire transport is not "
            "ported yet (ROADMAP queue 1 item 9.4)")

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
                while (not self._q and not self._closing
                        and not self._pending):
                    self._cond.wait(0.1)
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
        batch = coalesce_batches([r.features for r in live])
        n = sum(r.rows for r in live)
        bucket = next(b for b in self._buckets if b >= n)
        # a parked install lands first; the batch then runs with no lock
        # held, entirely on the weights it tags
        self._apply_pending_swap()
        version = self._applied_version
        with obstrace.span("serve/dispatch", rows=n, bucket=bucket):
            out = self._model.forward_bucket(batch, bucket=bucket)
            scores = out.cpu().numpy()      # device -> host: the sync
        t_done = time.monotonic()
        off = 0
        for r in live:
            r.future.set_result(Prediction(
                scores[off:off + r.rows], version,
                1e3 * (t_done - r.t0), versions=None, degraded=False))
            off += r.rows
        with self._stats_lock:
            for r in live:
                self._lat_ms.append(1e3 * (t_done - r.t0))
            self._n_responses += len(live)
            self._n_batches += 1
            self._rows_served += n
            self._rows_padded += bucket - n

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
                    self._model.swap_params(
                        params=state["params"],
                        host_params=state.get("host_params"),
                        op_state=state.get("op_state"))
                    self._model._step = int(version)
                else:
                    self._model.apply_delta(state)
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
        """The oldest version in this engine's serving path: its own
        (the JAX engine's shard tier, which can lag, is not ported)."""
        return self._version

    @property
    def model(self):
        return self._model

    def healthz(self) -> Dict[str, Any]:
        """Readiness for a /healthz endpoint: ``ok`` is False while the
        engine is draining (closing or never started), its batcher died,
        or the bounded queue is full (submits raise Overloaded now)."""
        depth = len(self._q)
        saturated = depth >= self.config.queue_capacity
        draining = self._closing or not self._started
        t = self._thread
        batcher_alive = bool(t is not None and t.is_alive())
        dead = self._started and not self._closing and not batcher_alive
        return {
            "ok": not (saturated or draining or dead),
            "version": self._version,
            "draining": draining,
            "saturated": saturated,
            "batcher_alive": batcher_alive,
            "queue_depth": depth,
            "queue_capacity": self.config.queue_capacity,
        }

    # --- observability -------------------------------------------------
    def _obs_collect(self):
        """Registry collector: the stats() counters as scrapeable
        samples, read through at scrape time."""
        lab = {"replica": ""}
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
        if self._watcher is not None:
            out["watcher"] = self._watcher.stats()
        return out
