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

The batcher thread launches the model's kernels on its current CUDA
stream; copying the scores to the host is the synchronisation. The
snapshot watcher, the embedding-row cache, the shard tier, fault
injection and the metrics registry of the JAX engine are not ported
yet.
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


def percentile(sorted_vals, p: float) -> Optional[float]:
    """Linear-interpolated percentile over an ASCENDING sequence
    (numpy's default method); None on an empty window, never a
    flawless p99 for a server that answered nothing."""
    n = len(sorted_vals)
    if n == 0:
        return None
    if n == 1:
        return float(sorted_vals[0])
    k = (p / 100.0) * (n - 1)
    f = int(k)
    c = min(f + 1, n - 1)
    return float(sorted_vals[f] + (k - f) * (sorted_vals[c] - sorted_vals[f]))


@dataclass
class ServeConfig:
    """Engine knobs; ``from_config`` lifts the ``--serve-*`` flags."""

    max_batch: int = 64          # largest bucket / flush-on-size bound
    max_delay_ms: float = 5.0    # flush-mode deadline for a partial batch
    queue_capacity: int = 256    # bounded queue -> Overloaded past this
    deadline_ms: float = 0.0     # per-request budget; 0 = none
    warmup: bool = True          # run every bucket once at start()
    continuous: bool = True      # iteration-level admission; False =
    #                              pure size/deadline flush

    @staticmethod
    def from_config(cfg) -> "ServeConfig":
        if cfg.serve_cache_rows > 0 or cfg.serve_cache_warm:
            raise NotImplementedError(
                "the serving row cache (--serve-cache-rows, "
                "--serve-cache-warm) is not ported yet (ROADMAP queue 1, "
                "item 9)")
        if cfg.serve_replicas > 1:
            raise NotImplementedError(
                "the serving fleet (--serve-replicas) is not ported yet "
                "(ROADMAP queue 1, item 9)")
        return ServeConfig(
            max_batch=int(cfg.serve_max_batch),
            max_delay_ms=float(cfg.serve_max_delay_ms),
            queue_capacity=int(cfg.serve_queue),
            deadline_ms=float(cfg.serve_deadline_ms),
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
    batcher thread is the only one that runs the model meanwhile.
    """

    def __init__(self, model, config: Optional[ServeConfig] = None):
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
        self._q: "deque[_Request]" = deque()
        self._q_rows = 0
        self._cond = threading.Condition()
        self._closing = False
        self._started = False
        self._thread: Optional[threading.Thread] = None
        self._version = int(model._step)
        # stats have their own lock: stats() readers race the batcher
        self._stats_lock = threading.Lock()
        self._lat_ms: "deque[float]" = deque(maxlen=4096)
        self._n_requests = 0
        self._n_responses = 0
        self._n_overloaded = 0
        self._n_timeouts = 0
        self._n_batches = 0
        self._rows_served = 0
        self._rows_padded = 0
        self._warmup_s = 0.0
        self._flushes = {"continuous": 0, "size": 0, "deadline": 0}

    # --- lifecycle -----------------------------------------------------
    def start(self) -> "InferenceEngine":
        """Run every bucket once, then start the batcher thread."""
        if self._started:
            return self
        self._started = True
        if self.config.warmup:
            self._warmup_s = self._model.warmup_buckets(self._buckets)
        self._thread = threading.Thread(target=self._batcher, daemon=True,
                                        name="ff-serve-batcher")
        self._thread.start()
        return self

    def close(self, deadline_s: float = 10.0) -> None:
        """Drain the queue (pending requests still get answers) and stop
        the batcher; raises TimeoutError if it does not stop in time."""
        with self._cond:
            if not self._started or self._closing:
                self._closing = True
                return
            self._closing = True
            self._cond.notify_all()
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
        with self._cond:
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
            take: List[_Request] = []
            flush = "continuous"
            with self._cond:
                while not self._q and not self._closing:
                    self._cond.wait(0.1)
                if not self._q and self._closing:
                    return
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
        out = self._model.forward_bucket(batch, bucket=bucket)
        scores = out.cpu().numpy()      # device -> host: the sync
        t_done = time.monotonic()
        off = 0
        for r in live:
            r.future.set_result(Prediction(
                scores[off:off + r.rows], self._version,
                1e3 * (t_done - r.t0), versions=None, degraded=False))
            off += r.rows
        with self._stats_lock:
            for r in live:
                self._lat_ms.append(1e3 * (t_done - r.t0))
            self._n_responses += len(live)
            self._n_batches += 1
            self._rows_served += n
            self._rows_padded += bucket - n

    # --- observability -------------------------------------------------
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
            "buckets": list(self._buckets),
            "warmup_s": round(self._warmup_s, 4),
            "flushes": flushes,
            "continuous": self.config.continuous,
        })
        return out
