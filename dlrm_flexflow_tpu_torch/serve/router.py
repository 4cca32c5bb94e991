"""Fleet router: SLO-aware request routing over N engine replicas (the
counterpart of ``dlrm_flexflow_tpu.serve.router``).

The Clipper insight is that a routing layer in front of model replicas
buys fault isolation the replicas cannot provide themselves; this module
is that layer for :class:`~.fleet.Fleet`:

- **Load balancing** — every request goes to the healthy replica with
  the shallowest queue (``InferenceEngine.queue_depth``), round-robin on
  ties, so one slow replica backs up its own queue and organically
  stops attracting traffic.
- **Bounded retry with backoff** — ``Overloaded`` (backpressure),
  ``DeadlineExceeded``, ``ReplicaDown`` and dispatch errors re-route to
  a different replica after an exponential backoff, up to ``retries``
  times; only malformed requests (``ValueError``) fail without retry.
  A request fails ONLY when every attempt is exhausted — the chaos bar
  is zero non-retried-to-success failures while a replica dies mid-load.
- **Circuit breaker** — ``eject_after`` consecutive dispatch errors (or
  a dead batcher thread, or a heartbeat older than
  ``heartbeat_deadline_s``) ejects the replica: no more traffic, queued
  futures drained onto survivors. After ``cooldown_s`` a real probe
  request runs end-to-end under ``probe_deadline_s``; success re-admits.
- **Tail-latency hedging** — optionally (``hedge_ms``) a request still
  unresolved after the hedge delay is duplicated to a second replica;
  first result wins. Classic p99 insurance against one slow dispatch.
- **Canary rollout** — ``start_canary(snapshot)`` installs a candidate
  snapshot on part of the fleet and routes ``canary_fraction`` of
  traffic there (deterministic credit pacing, not sampling). The health
  thread compares the canary cohort against the stable cohort and
  AUTO-ROLLS-BACK — reinstalling the captured pre-deploy params, which
  in-flight requests never observe mid-swap — when canary p99 exceeds
  ``canary_p99_ratio`` × stable p99 or the cohorts' mean scores diverge
  past ``canary_score_tol``. A bad deploy costs a log line, never an
  error.
- **Shadow traffic** — ``start_shadow(snapshot)`` installs a candidate
  on a replica that receives only DUPLICATED requests: clients are
  answered by the stable cohort, the shadow's scores are compared
  offline (``shadow_report()``), and shadow failures are swallowed.

Everything observable lands in ``stats()``: per-replica circuit-breaker
state, fleet-aggregated engine stats, client-observed p50/p99 (which
include retry/hedge time — the number a user actually feels), and the
canary/shadow controllers' verdicts.
"""

from __future__ import annotations

import heapq
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..obs import metrics as obsm
from ..obs import trace as obstrace
from ..utils import faults
from ..utils.checkpoint import load_params_for_swap
from ..utils.logging import get_logger
from .engine import Overloaded, Prediction, ReplicaDown, percentile
from .fleet import HEALTHY, Fleet, Replica, copy_state

log_router = get_logger("serve.router")


class FleetUnavailable(RuntimeError):
    """No healthy replica could serve the request within the retry
    budget — the fleet-level analogue of ``Overloaded``. Callers shed
    load or retry later; seeing this with zero healthy replicas means
    the whole fleet is down or ejected."""


@dataclass
class RouterConfig:
    """Routing/health/deployment knobs; ``from_config`` lifts the
    ``--serve-*`` flags."""

    retries: int = 2                   # re-dispatches after the first try
    backoff_ms: float = 5.0            # exponential retry backoff base
    hedge_ms: float = 0.0              # duplicate-after delay; 0 = off
    eject_after: int = 3               # consecutive errors -> ejection
    cooldown_s: float = 1.0            # ejection -> first probe
    probe_deadline_s: float = 5.0      # end-to-end probe budget
    heartbeat_deadline_s: float = 0.0  # stale-batcher ejection; 0 = off
    health_interval_s: float = 0.25    # health/canary evaluation period
    canary_fraction: float = 0.1       # share of traffic to the canary
    canary_p99_ratio: float = 2.0      # rollback past ratio x stable p99
    canary_score_tol: float = 0.5      # rollback past |mean score| gap
    canary_min_samples: int = 32       # per-cohort floor before judging
    shadow_sample: float = 1.0         # share of traffic duplicated
    window: int = 2048                 # cohort/client latency windows

    @staticmethod
    def from_config(cfg) -> "RouterConfig":
        return RouterConfig(
            retries=int(getattr(cfg, "serve_retries", 2)),
            hedge_ms=float(getattr(cfg, "serve_hedge_ms", 0.0)),
            canary_fraction=float(getattr(cfg, "serve_canary_fraction",
                                          0.1)))


class _Timer(threading.Thread):
    """Monotonic-deadline action queue for retries/hedges: callbacks
    from engine batcher threads must never sleep (that would stall the
    batcher), so delayed work is handed here instead."""

    def __init__(self, name: str):
        super().__init__(daemon=True, name=name)
        self._heap: list = []
        self._cond = threading.Condition()
        self._seq = 0
        self._stopped = False

    def call_later(self, delay_s: float, fn) -> None:
        with self._cond:
            if self._stopped:           # late scheduling after close():
                return                  # the action runs in close()'s
            heapq.heappush(self._heap,  # drain or not at all
                           (time.monotonic() + max(delay_s, 0.0),
                            self._seq, fn))
            self._seq += 1
            self._cond.notify()

    def run(self) -> None:
        while True:
            with self._cond:
                while not self._stopped:
                    if not self._heap:
                        self._cond.wait()
                        continue
                    left = self._heap[0][0] - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                if self._stopped:
                    return
                _, _, fn = heapq.heappop(self._heap)
            try:
                fn()
            except Exception:   # noqa: BLE001 — a failed retry action
                log_router.exception("router timer action failed")

    def close(self) -> None:
        """Stop the loop, then run whatever was still pending NOW: a
        scheduled retry holds a client future that would otherwise hang
        forever — running it against a closing fleet fails it fast."""
        with self._cond:
            self._stopped = True
            pending = [fn for _, _, fn in self._heap]
            self._heap.clear()
            self._cond.notify_all()
        self.join(5.0)
        for fn in pending:
            try:
                fn()
            except Exception:   # noqa: BLE001
                log_router.exception("router timer drain action failed")


class _Cohort:
    """Latency window + running score mean for one deployment cohort —
    plus, under the sharded serving tier, the newest per-shard VERSION
    VECTOR the cohort's responses read. Canary judgement compares
    vectors, not scalar versions: with tables split over shards there
    is no single "the version" anymore, and two cohorts mid-publish can
    legitimately read different shard versions for a tick — comparing
    their score means then would blame the deploy for a skew the
    publish caused."""

    def __init__(self, maxlen: int, name: str = ""):
        self._lock = threading.Lock()
        self.maxlen = maxlen
        self.name = name
        # bounded obs reservoir (scrapeable as
        # ff_router_cohort_latency_ms{cohort=...} when --obs on)
        self.lat_ms = obsm.latency_reservoir(
            "ff_router_cohort_latency_ms",
            "client-observed latency per deployment cohort",
            maxlen=maxlen, cohort=name)
        self.score_sum = 0.0
        self.score_n = 0
        self.versions: Optional[Dict[int, int]] = None
        self.degraded = 0

    def reset(self) -> None:
        with self._lock:
            self.lat_ms.clear()
            self.score_sum = 0.0
            self.score_n = 0
            self.versions = None
            self.degraded = 0

    def add(self, ms: float, scores: np.ndarray,
            versions: Optional[Dict[int, int]] = None,
            degraded: bool = False) -> None:
        with self._lock:
            self.lat_ms.append(ms)
            self.score_sum += float(np.sum(scores))
            self.score_n += int(scores.size)
            if versions is not None:
                self.versions = versions
            self.degraded += int(degraded)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = sorted(self.lat_ms)
            s, n = self.score_sum, self.score_n
            vv = dict(self.versions) if self.versions is not None \
                else None
            degraded = self.degraded
        return {
            "n": len(lat),
            "p50_ms": percentile(lat, 50),
            "p99_ms": percentile(lat, 99),
            "score_mean": (s / n) if n else None,
            "score_n": n,
            "versions": vv,
            "degraded": degraded,
        }


class _RouterReq:
    """One client request's routing state across attempts."""

    __slots__ = ("features", "future", "t0", "lock", "cohort", "tried",
                 "retry_no", "hedged", "primary_scores", "shadow_scores")

    def __init__(self, features):
        self.features = features
        self.future: Future = Future()
        self.t0 = time.monotonic()
        self.lock = threading.Lock()
        self.cohort: Optional[str] = None
        self.tried: set = set()
        self.retry_no = 0
        self.hedged = False
        self.primary_scores: Optional[np.ndarray] = None
        self.shadow_scores: Optional[np.ndarray] = None


class FleetRouter:
    """Spread requests over a :class:`Fleet`, keep serving through
    replica failures, and run canary/shadow deployments. See the module
    docstring for the full contract."""

    def __init__(self, fleet, config: Optional[RouterConfig] = None,
                 probe_features: Optional[Dict[str, np.ndarray]] = None):
        if isinstance(fleet, Fleet):
            self.fleet = fleet
        else:
            self.fleet = Fleet(list(fleet))
        self.config = config or RouterConfig()
        if self.config.retries < 0:
            raise ValueError("router retries must be >= 0")
        self._probe_features = probe_features
        self._started = False
        self._closed = False
        self._timer = _Timer("ff-router-timer")
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._rr_counter = 0
        # metrics (one lock: counters + windows; callbacks are cheap)
        self._m_lock = threading.Lock()
        # client-observed latency (includes retries/hedges — the number
        # an SLO is written against); the obs reservoir doubles as the
        # ff_router_client_latency_ms scrape when --obs on
        self._lat_ms = obsm.latency_reservoir(
            "ff_router_client_latency_ms",
            "client-observed latency incl. retries and hedges",
            maxlen=self.config.window)
        self._n_requests = 0
        self._n_responses = 0
        self._n_failed = 0
        self._n_retries = 0
        self._n_hedges = 0
        self._n_hedge_wins = 0
        self._cohorts = {"stable": _Cohort(self.config.window, "stable"),
                         "canary": _Cohort(self.config.window, "canary")}
        # deployment state (its own lock: install/rollback swap params
        # replica by replica and must not interleave). The deploy verbs
        # stage snapshot loads and copies OUTSIDE it and only flip
        # cohorts and install under it
        self._deploy_lock = threading.Lock()
        self._canary_active = False
        self._canary_fraction = self.config.canary_fraction
        self._canary_credit = 0.0
        self._rollbacks = 0
        self._promotions = 0
        self._last_rollback_reason = ""
        self._vv_skew_skips = 0
        self._shadow_rid: Optional[int] = None
        self._shadow_credit = 0.0
        self._shadow_n = 0
        self._shadow_sum_abs = 0.0
        self._shadow_max_abs = 0.0
        self._shadow_errors = 0

    # --- lifecycle -----------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._started:
            return self
        self._started = True
        self.fleet.start()
        obsm.register_collector(self._obs_collect)
        self._timer.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="ff-router-health")
        self._health_thread.start()
        return self

    def close(self, deadline_s: float = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        obsm.unregister_collector(self._obs_collect)
        self._health_stop.set()
        t = self._health_thread
        if t is not None:
            t.join(5.0)
        self.fleet.close(deadline_s)
        self._timer.close()

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # --- request path --------------------------------------------------
    def submit(self, features: Dict[str, np.ndarray]) -> Future:
        """Route one request; returns a Future resolving to a
        :class:`~.engine.Prediction`. The future only fails once the
        retry budget is spent (or the request is malformed)."""
        if self._closed:
            raise RuntimeError("router is closed")
        if not self._started:
            raise RuntimeError("router not started (call start())")
        rr = _RouterReq(features)
        with self._m_lock:
            self._n_requests += 1
        if self._probe_features is None:
            self._probe_features = features
        self._dispatch(rr)
        return rr.future

    def predict(self, features: Dict[str, np.ndarray],
                timeout: Optional[float] = None) -> Prediction:
        """Synchronous submit+wait."""
        return self.submit(features).result(timeout)

    def _choose_cohort(self) -> str:
        """Deterministic credit pacing: exactly `fraction` of fresh
        requests go canary (no RNG — tests and traffic splits are
        reproducible)."""
        if not self._canary_active:
            return "stable"
        with self._m_lock:
            self._canary_credit += self._canary_fraction
            if self._canary_credit >= 1.0:
                self._canary_credit -= 1.0
                return "canary"
        return "stable"

    def _pick(self, cohort: str, exclude: set) -> Optional[Replica]:
        """Shallowest-queue healthy replica of the cohort; falls back
        to the other cohort (availability beats cohort purity), then to
        already-tried replicas (retrying somewhere beats failing)."""
        for relax_exclude in (False, True):
            for want in (cohort, "canary" if cohort == "stable"
                         else "stable"):
                cands = [r for r in self.fleet.replicas
                         if r.state == HEALTHY and r.cohort == want
                         and (relax_exclude or r.rid not in exclude)]
                if cands:
                    self._rr_counter += 1
                    rr = self._rr_counter
                    return min(cands, key=lambda r: (
                        r.queue_depth, (r.rid + rr) % (len(cands) + 1)))
        return None

    def _dispatch(self, rr: _RouterReq, hedge: bool = False) -> None:
        if rr.future.done():
            return
        if self._closed:
            self._fail(rr, RuntimeError("router is closed"))
            return
        if rr.cohort is None:
            rr.cohort = self._choose_cohort()
        rep = self._pick(rr.cohort, rr.tried)
        if rep is None:
            self._attempt_failed(rr, None, FleetUnavailable(
                f"no healthy replica (states "
                f"{ {r.rid: r.state for r in self.fleet.replicas} })"))
            return
        try:
            fut = rep.engine.submit(rr.features)
        except ValueError as e:          # malformed request — no retry
            self._fail(rr, e)            # can fix a bad feature dict
            return
        except Exception as e:           # noqa: BLE001 — Overloaded,
            # closed engine, crashed submit: all retryable elsewhere
            self._attempt_failed(rr, rep, e)
            return
        rr.tried.add(rep.rid)
        if (not hedge and self.config.hedge_ms > 0
                and len(self.fleet) > 1):
            self._timer.call_later(self.config.hedge_ms / 1e3,
                                   lambda: self._hedge(rr))
        if not hedge:
            self._maybe_shadow(rr)
        fut.add_done_callback(
            lambda f: self._on_done(rr, rep, f, hedge))

    def _on_done(self, rr: _RouterReq, rep: Replica, fut: Future,
                 hedge: bool) -> None:
        if fut.cancelled():
            # a remote replica's client cancels the requests still queued
            # in it when the replica is ejected: re-route them as a
            # drained queue's
            exc = ReplicaDown(rep.rid, "request cancelled on ejection")
        else:
            exc = fut.exception()
        if exc is None:
            rep.record_success()
            self._complete(rr, fut.result(), rep, hedge)
        else:
            self._attempt_failed(rr, rep, exc)

    def _attempt_failed(self, rr: _RouterReq, rep: Optional[Replica],
                        exc: BaseException) -> None:
        # circuit breaker first — the replica's health is tracked even
        # when this particular request already succeeded via a hedge.
        # Overloaded is backpressure, not breakage: it steers the retry
        # elsewhere but never trips the breaker.
        if rep is not None and not isinstance(exc, Overloaded):
            if rep.record_error(exc, self.config.eject_after):
                rep.eject(f"{self.config.eject_after} consecutive "
                          f"errors, last: {exc}")
        if rr.future.done():
            return
        if isinstance(exc, ValueError):
            self._fail(rr, exc)          # malformed: retry can't help
            return
        if rr.retry_no < self.config.retries:
            delay = (self.config.backoff_ms / 1e3) * (2 ** rr.retry_no)
            rr.retry_no += 1
            with self._m_lock:
                self._n_retries += 1
            self._timer.call_later(delay, lambda: self._dispatch(rr))
        else:
            self._fail(rr, exc)

    def _fail(self, rr: _RouterReq, exc: BaseException) -> None:
        with rr.lock:
            if rr.future.done():
                return
            rr.future.set_exception(exc)
        with self._m_lock:
            self._n_failed += 1

    def _complete(self, rr: _RouterReq, pred: Prediction, rep: Replica,
                  hedge: bool) -> None:
        with rr.lock:
            if rr.future.done():
                return                   # the other attempt won
            rr.future.set_result(pred)
            rr.primary_scores = pred.scores
            shadow_scores = rr.shadow_scores
        ms = 1e3 * (time.monotonic() - rr.t0)
        with self._m_lock:
            self._n_responses += 1
            self._lat_ms.append(ms)
            if hedge:
                self._n_hedge_wins += 1
        # cohort metrics feed the canary judgement: client-observed
        # latency (what an SLO means) + the response score mass + the
        # shard version vector the response read (vector-mismatch gates
        # the score comparison under the sharded tier)
        cohort = rep.cohort if rep.cohort in self._cohorts else "stable"
        self._cohorts[cohort].add(
            ms, np.asarray(pred.scores),
            versions=getattr(pred, "versions", None),
            degraded=bool(getattr(pred, "degraded", False)))
        if shadow_scores is not None:
            self._shadow_compare(pred.scores, shadow_scores)

    def _hedge(self, rr: _RouterReq) -> None:
        with rr.lock:
            if rr.future.done() or rr.hedged:
                return
            rr.hedged = True
        with self._m_lock:
            self._n_hedges += 1
        self._dispatch(rr, hedge=True)

    # --- shadow traffic ------------------------------------------------
    def _maybe_shadow(self, rr: _RouterReq) -> None:
        rid = self._shadow_rid
        if rid is None:
            return
        with self._m_lock:
            self._shadow_credit += self.config.shadow_sample
            if self._shadow_credit < 1.0:
                return
            self._shadow_credit -= 1.0
        try:
            rep = self.fleet.get(rid)
            if rep.state != HEALTHY or rep.cohort != "shadow":
                return
            fut = rep.engine.submit(rr.features)
        except Exception:   # noqa: BLE001 — shadow failures are
            # interesting offline, invisible to the client
            with self._m_lock:
                self._shadow_errors += 1
            return
        fut.add_done_callback(lambda f: self._on_shadow_done(rr, f))

    def _on_shadow_done(self, rr: _RouterReq, fut: Future) -> None:
        exc = fut.exception()
        if exc is not None:
            with self._m_lock:
                self._shadow_errors += 1
            return
        scores = np.asarray(fut.result().scores)
        with rr.lock:
            rr.shadow_scores = scores
            primary = rr.primary_scores
        if primary is not None:   # else _complete compares when it runs
            self._shadow_compare(primary, scores)

    def _shadow_compare(self, primary, shadow) -> None:
        diff = np.abs(np.asarray(primary, np.float64)
                      - np.asarray(shadow, np.float64))
        with self._m_lock:
            self._shadow_n += int(diff.size)
            self._shadow_sum_abs += float(diff.sum())
            self._shadow_max_abs = max(self._shadow_max_abs,
                                       float(diff.max()))

    def shadow_report(self) -> Dict[str, Any]:
        with self._m_lock:
            n = self._shadow_n
            return {
                "replica": self._shadow_rid,
                "n": n,
                "mean_abs_diff": (self._shadow_sum_abs / n) if n else None,
                "max_abs_diff": self._shadow_max_abs if n else None,
                "errors": self._shadow_errors,
            }

    # --- deployments ---------------------------------------------------
    def _load_state(self, rep: Replica, snapshot,
                    version: Optional[int]):
        """Resolve a snapshot argument (path or preloaded state dict)
        into (state, version) for one replica's model. Path loads run
        the poison hook — a canary deploy IS a reload. A preloaded state
        is copied onto the replica's device: parameters are written in
        place, so two replicas never share one tensor."""
        if getattr(rep.engine, "remote", False):
            raise RuntimeError(
                f"replica {rep.rid} runs in another process; "
                f"canary/shadow deploys mutate replica state in-place "
                f"and are inproc-only — publish the candidate through "
                f"that process's own SnapshotWatcher instead")
        if isinstance(snapshot, str):
            state = load_params_for_swap(rep.engine.model, snapshot)
            state = faults.maybe_poison_reload(state)
            return state, int(state["step"] if version is None
                              else version)
        if version is None:
            version = int(snapshot.get("step", rep.engine.version + 1))
        return copy_state(snapshot, rep.engine.model.device), version

    def start_canary(self, snapshot, replica_ids: Optional[List[int]]
                     = None, fraction: Optional[float] = None,
                     version: Optional[int] = None) -> List[int]:
        """Install a candidate snapshot (path or
        ``load_params_for_swap`` state) on part of the fleet and start
        routing ``fraction`` of traffic there. Default cohort: the
        highest-rid healthy replica — one replica's blast radius.
        Returns the canary replica ids."""
        with self._deploy_lock:
            if self._canary_active:
                raise RuntimeError("a canary is already active — "
                                   "promote or roll back first")
            if replica_ids is None:
                healthy = self.fleet.healthy("stable")
                if len(healthy) < 2:
                    raise RuntimeError(
                        "canary needs >= 2 healthy replicas (one must "
                        "keep serving stable traffic)")
                reps = [healthy[-1]]
            else:
                reps = [self.fleet.get(r) for r in replica_ids]
        # slow part (snapshot read, CRC, copy to the card) OUTSIDE the
        # deploy lock: a multi-GB canary load must not block a
        # concurrent rollback or judgement
        staged = [(rep, self._load_state(rep, snapshot, version))
                  for rep in reps]
        with self._deploy_lock:
            if self._canary_active:
                raise RuntimeError("a canary is already active — "
                                   "promote or roll back first")
            for rep, (state, ver) in staged:
                rep.capture_rollback_state()
                rep.engine.install_snapshot(state, ver, source="canary")
                rep.cohort = "canary"
            self._canary_fraction = (self.config.canary_fraction
                                     if fraction is None else
                                     float(fraction))
            self._cohorts["stable"].reset()
            self._cohorts["canary"].reset()
            self._canary_active = True
            ids = [r.rid for r in reps]
            log_router.info(
                "canary started on replica(s) %s at %.0f%% of traffic",
                ids, 100 * self._canary_fraction)
            return ids

    def rollback_canary(self, reason: str = "manual") -> None:
        """Reinstall the captured pre-canary state on every canary
        replica and return it to the stable cohort. The swap is atomic
        per replica (between dispatches): in-flight requests finish on
        the canary weights with their version tag, later ones see
        stable — zero client-visible errors."""
        with self._deploy_lock:
            if not self._canary_active:
                return
            for rep in self.fleet.replicas:
                if rep.cohort == "canary":
                    rep.restore_rollback_state()
                    rep.cohort = "stable"
            self._canary_active = False
            self._rollbacks += 1
            self._last_rollback_reason = reason
            obstrace.instant("router/canary-rollback", cat="deploy",
                             reason=reason[:200])
            log_router.warning("canary rolled back: %s", reason)

    def promote_canary(self) -> None:
        """The candidate won: install its state on the REST of the
        fleet so every replica serves the new version, and retire the
        rollback capture."""
        with self._deploy_lock:
            if not self._canary_active:
                raise RuntimeError("no active canary to promote")
            canaries = [r for r in self.fleet.replicas
                        if r.cohort == "canary"]
            targets = [r for r in self.fleet.replicas
                       if r.cohort != "canary"]
            # pending-swap-aware read of the winner's state
            src_state, src_version = canaries[0].engine.state_snapshot()
        # the copies (one per target: each replica's parameters are its
        # own, written in place) run OUTSIDE the deploy lock: promoting a
        # large model must not freeze rollback or judgement meanwhile
        states = {rep.rid: copy_state(src_state, rep.engine.model.device)
                  for rep in targets}
        with self._deploy_lock:
            if not self._canary_active:
                raise RuntimeError(
                    "canary rolled back while its promotion staged — "
                    "the fleet keeps the stable version")
            for rep in canaries:
                rep.rollback_state = None
                rep.cohort = "stable"
            for rep in targets:
                rep.engine.install_snapshot(states[rep.rid], src_version,
                                            source="promote")
            self._canary_active = False
            self._promotions += 1
            log_router.info("canary promoted: fleet now serves "
                            "version %d", src_version)

    def start_shadow(self, snapshot, replica_id: Optional[int] = None,
                     version: Optional[int] = None) -> int:
        """Install a candidate on one replica as SHADOW: it leaves the
        routable set, receives only duplicated traffic, and its scores
        are compared against the primary responses offline."""
        with self._deploy_lock:
            if self._shadow_rid is not None:
                raise RuntimeError("a shadow is already active")
            if replica_id is None:
                healthy = self.fleet.healthy("stable")
                if len(healthy) < 2:
                    raise RuntimeError(
                        "shadow needs >= 2 healthy replicas (one must "
                        "keep serving client traffic)")
                rep = healthy[-1]
            else:
                rep = self.fleet.get(replica_id)
        # snapshot load outside the lock (same discipline as canary)
        state, ver = self._load_state(rep, snapshot, version)
        with self._deploy_lock:
            if self._shadow_rid is not None:
                raise RuntimeError("a shadow is already active")
            rep.capture_rollback_state()
            rep.engine.install_snapshot(state, ver, source="shadow")
            rep.cohort = "shadow"
            with self._m_lock:
                self._shadow_n = 0
                self._shadow_sum_abs = 0.0
                self._shadow_max_abs = 0.0
                self._shadow_errors = 0
            self._shadow_rid = rep.rid
            log_router.info("shadow started on replica %d", rep.rid)
            return rep.rid

    def stop_shadow(self, restore: bool = True) -> Dict[str, Any]:
        """Return the shadow replica to the stable cohort (reinstalling
        its pre-shadow state unless ``restore=False``) and hand back the
        final comparison report."""
        with self._deploy_lock:
            rid = self._shadow_rid
            if rid is None:
                return self.shadow_report()
            rep = self.fleet.get(rid)
            report = self.shadow_report()
            if restore:
                rep.restore_rollback_state()
            else:
                rep.rollback_state = None
            rep.cohort = "stable"
            self._shadow_rid = None
            log_router.info("shadow stopped on replica %d: %s", rid,
                            report)
            return report

    # --- health + canary judgement ------------------------------------
    def _health_loop(self) -> None:
        while not self._health_stop.wait(self.config.health_interval_s):
            try:
                self._health_check()
            except Exception:   # noqa: BLE001 — the health thread must
                log_router.exception("fleet health check failed")

    def _health_check(self) -> None:
        cfg = self.config
        for rep in self.fleet.replicas:
            if rep.state == HEALTHY:
                if not rep.engine.alive():
                    rep.eject("batcher thread dead")
                elif (cfg.heartbeat_deadline_s > 0
                      and rep.engine.heartbeat_age()
                      > cfg.heartbeat_deadline_s):
                    rep.eject("stale heartbeat: " + str(
                        rep.engine.heartbeat.report(
                            cfg.heartbeat_deadline_s,
                            "a batcher loop iteration",
                            detail=f"queue depth {rep.queue_depth}")))
            elif rep.due_for_probe(cfg.cooldown_s):
                self._probe(rep)
        self._judge_canary()

    def _probe(self, rep: Replica) -> None:
        """End-to-end liveness probe: a real request through the real
        dispatch path under the probe deadline. Success re-admits."""
        probe = self._probe_features
        if probe is None:
            return   # nothing ever submitted — no template to probe with
        rep.begin_probe()
        try:
            pred = rep.engine.submit(probe).result(
                self.config.probe_deadline_s)
            assert pred.scores is not None
        except Exception as e:   # noqa: BLE001 — stay ejected
            rep.probe_failed(f"{type(e).__name__}: {e}")
            return
        rep.readmit()

    def _judge_canary(self) -> None:
        if not self._canary_active:
            return
        cfg = self.config
        c = self._cohorts["canary"].snapshot()
        s = self._cohorts["stable"].snapshot()
        if (c["n"] < cfg.canary_min_samples
                or s["n"] < cfg.canary_min_samples):
            return
        if (c["p99_ms"] is not None and s["p99_ms"] is not None
                and s["p99_ms"] > 0
                and c["p99_ms"] > cfg.canary_p99_ratio * s["p99_ms"]):
            self.rollback_canary(
                f"p99 regression: canary {c['p99_ms']:.1f} ms > "
                f"{cfg.canary_p99_ratio:g}x stable {s['p99_ms']:.1f} ms")
            return
        if c["score_mean"] is not None and s["score_mean"] is not None:
            # version-vector gate (sharded tier): when the two cohorts'
            # responses read DIFFERENT shard versions — a publish
            # landing shard by shard, or one cohort degraded onto
            # default rows — their score means are not comparable this
            # tick. Skip the judgement (counted) rather than roll back
            # a healthy deploy for skew the embedding tier caused.
            c_vv, s_vv = c.get("versions"), s.get("versions")
            if (c_vv is not None and s_vv is not None and c_vv != s_vv):
                with self._m_lock:
                    self._vv_skew_skips += 1
                return
            gap = abs(c["score_mean"] - s["score_mean"])
            # NOT `gap > tol`: a truly garbage canary (params scaled to
            # overflow) scores inf/NaN, and `nan > tol` is False — the
            # worst deploy would be the one that never rolls back
            if not (gap <= cfg.canary_score_tol):
                self.rollback_canary(
                    f"score divergence: |canary mean "
                    f"{c['score_mean']:.4g} - stable mean "
                    f"{s['score_mean']:.4g}| = {gap:.4g} > "
                    f"{cfg.canary_score_tol:g}")

    # --- observability -------------------------------------------------
    def _obs_collect(self):
        """Registry collector: router totals + fleet shape as scrapeable
        samples (reads the same counters stats() reports)."""
        yield "ff_router_requests_total", {}, self._n_requests
        yield "ff_router_responses_total", {}, self._n_responses
        yield "ff_router_failed_total", {}, self._n_failed
        yield "ff_router_retries_total", {}, self._n_retries
        yield "ff_router_hedges_total", {}, self._n_hedges
        yield "ff_router_hedge_wins_total", {}, self._n_hedge_wins
        yield "ff_router_canary_rollbacks_total", {}, self._rollbacks
        yield "ff_router_canary_promotions_total", {}, self._promotions
        yield "ff_fleet_size", {}, len(self.fleet)
        yield "ff_fleet_healthy", {}, len(self.fleet.healthy())
        for rep in self.fleet.replicas:
            yield ("ff_fleet_replica_healthy",
                   {"replica": str(rep.rid)},
                   1.0 if rep.state == HEALTHY else 0.0)

    def healthz(self) -> Dict[str, Any]:
        """Fleet readiness: ok while at least one healthy replica can
        accept a request and the router is not draining. ``degraded``
        (sharded tier) means answers are being served from cache +
        default rows while a lookup shard is out — still ok: a load
        balancer must keep routing to a degraded-but-answering fleet
        (HTTP 200 with ``"degraded": true``), not starve it."""
        healthy = self.fleet.healthy()
        accepting = [r for r in healthy
                     if r.engine.healthz()["ok"]]
        out = {
            "ok": bool(accepting) and not self._closed,
            "draining": self._closed,
            "size": len(self.fleet),
            "healthy": len(healthy),
            "accepting": len(accepting),
            "states": {r.rid: r.state for r in self.fleet.replicas},
        }
        shard_set = getattr(self.fleet, "shard_set", None)
        if shard_set is not None:
            out["degraded"] = shard_set.degraded_now()
            out["shard_states"] = {r.slot: r.state
                                   for r in shard_set.shards}
        return out

    def stats(self) -> Dict[str, Any]:
        with self._m_lock:
            lat = sorted(self._lat_ms)
            out = {
                "requests": self._n_requests,
                "responses": self._n_responses,
                "failed": self._n_failed,
                "retries": self._n_retries,
                "hedges": self._n_hedges,
                "hedge_wins": self._n_hedge_wins,
            }
        out.update({
            # client-observed latency: includes queueing, retries and
            # hedges — the number an SLO is written against
            "p50_ms": percentile(lat, 50),
            "p99_ms": percentile(lat, 99),
            "canary": {
                "active": self._canary_active,
                "fraction": self._canary_fraction,
                "replicas": [r.rid for r in self.fleet.replicas
                             if r.cohort == "canary"],
                "rollbacks": self._rollbacks,
                "promotions": self._promotions,
                "last_rollback_reason": self._last_rollback_reason,
                "version_vector_skew_skips": self._vv_skew_skips,
            },
            "cohorts": {k: v.snapshot()
                        for k, v in self._cohorts.items()},
            "shadow": self.shadow_report(),
            "fleet": self.fleet.stats(),
        })
        return out
