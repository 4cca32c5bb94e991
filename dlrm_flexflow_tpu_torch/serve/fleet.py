"""Serving fleet: the replicas' lifecycle and the circuit-breaker state
machine (the counterpart of ``dlrm_flexflow_tpu.serve.fleet``).

One :class:`~.engine.InferenceEngine` is one card's worth of traffic and
a single point of failure. A fleet is N engines over data-parallel
parameters (in-process replicas sharing a card, or one per process
reached over the wire), each wrapped in a :class:`Replica` that tracks
its health::

    HEALTHY --(eject_after consecutive errors,
               stale heartbeat, dead batcher)--> EJECTED
    EJECTED --(cooldown elapsed)------------------> PROBING
    PROBING --(probe succeeds)--------------------> HEALTHY
    PROBING --(probe fails)-----------------------> EJECTED

An ejected replica stops receiving traffic, its queued futures are
drained (failed with ``ReplicaDown``, so the router's retries re-route
them to survivors), and only a successful end-to-end probe re-admits
it. The shard tier wraps each ``EmbeddingShard`` in the same
:class:`CircuitBreaker` (``ShardReplica``). Routing, retry, hedging and
the canary and shadow deployments live in :mod:`.router`; this module is
the per-replica truth the router acts on, plus ``Fleet.stats()``.

The port's parameters are tensors written in place (a delta's
``index_copy_``), where the JAX package's are immutable arrays: a
rollback capture here is a copy, not a reference.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.logging import get_logger
from .engine import InferenceEngine, ReplicaDown, percentile

log_fleet = get_logger("serve.fleet")

# unit states (plain strings: they go straight into stats())
HEALTHY = "healthy"
EJECTED = "ejected"
PROBING = "probing"


class CircuitBreaker:
    """The eject/probe/re-admit state machine, decoupled from what it
    guards: a fleet :class:`Replica` or a shard tier's ``ShardReplica``.
    All transitions happen under the breaker's own lock; ``_on_eject`` is
    the subclass hook for its isolation work (a replica drains its
    queue)."""

    KIND = "unit"

    def __init__(self, rid: int, state: str = HEALTHY):
        self.rid = rid
        self.state = state
        # a unit born PROBING (grown or replaced) takes no traffic until
        # its end-to-end admission probe succeeds
        self.awaiting_admission = state == PROBING
        self._lock = threading.Lock()
        self.consecutive_errors = 0
        self.ejected_at = 0.0
        self.last_error = ""
        # counters (monotonic, surfaced in stats)
        self.ejections = 0
        self.readmissions = 0
        self.probes = 0
        self.dispatch_errors = 0

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_errors = 0

    def record_error(self, err: BaseException, eject_after: int) -> bool:
        """Count one dispatch error; True when the consecutive-error
        threshold was just crossed and the caller should eject."""
        with self._lock:
            self.dispatch_errors += 1
            self.consecutive_errors += 1
            self.last_error = f"{type(err).__name__}: {err}"
            return (self.state == HEALTHY
                    and self.consecutive_errors >= eject_after)

    def _on_eject(self, reason: str) -> int:
        """The unit's isolation work after the state flip; returns a
        count for the log line (a replica: the requests drained)."""
        return 0

    def eject(self, reason: str) -> int:
        """HEALTHY/PROBING -> EJECTED: stop routing here and run the
        unit's isolation hook. Returns the hook's count."""
        with self._lock:
            if self.state == EJECTED:
                return 0
            self.state = EJECTED
            self.ejected_at = time.monotonic()
            self.ejections += 1
            self.last_error = reason
        drained = self._on_eject(reason)
        log_fleet.warning("ejected %s %d (%s) — drained %d queued "
                          "request(s) onto the survivors", self.KIND,
                          self.rid, reason, drained)
        return drained

    def due_for_probe(self, cooldown_s: float) -> bool:
        with self._lock:
            if self.awaiting_admission:     # born PROBING: at once
                return True
            return (self.state == EJECTED
                    and time.monotonic() - self.ejected_at >= cooldown_s)

    def begin_probe(self) -> None:
        with self._lock:
            if self.state == EJECTED:
                self.state = PROBING
            self.awaiting_admission = False
            self.probes += 1

    def probe_failed(self, reason: str) -> None:
        with self._lock:
            if self.state == PROBING:
                self.state = EJECTED
                self.ejected_at = time.monotonic()   # restart the cooldown
            self.last_error = f"probe failed: {reason}"

    def readmit(self) -> None:
        with self._lock:
            prev = self.state
            self.state = HEALTHY
            self.consecutive_errors = 0
            self.readmissions += 1
        log_fleet.info("re-admitted %s %d (was %s) after probe success",
                       self.KIND, self.rid, prev)

    def breaker_stats(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "consecutive_errors": self.consecutive_errors,
            "dispatch_errors": self.dispatch_errors,
            "ejections": self.ejections,
            "readmissions": self.readmissions,
            "probes": self.probes,
            "last_error": self.last_error,
        }


def copy_state(state: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A deep copy of an inference state (``params`` tensors, numpy
    ``host_params``), the tensors on ``device`` (default: where they
    are)."""
    params = {op: {n: v.detach().to(device if device is not None
                                     else v.device, copy=True)
                   for n, v in pd.items()}
              for op, pd in state["params"].items()}
    host = state.get("host_params")
    if host is not None:
        host = {op: {n: np.array(a, copy=True) for n, a in t.items()}
                for op, t in host.items()}
    return {"params": params, "host_params": host,
            "op_state": dict(state.get("op_state") or {})}


class Replica(CircuitBreaker):
    """One engine plus its circuit-breaker state, driven by the router
    (request callbacks and its health thread); the engine knows nothing
    of the fleet but its ``replica_id``."""

    KIND = "replica"

    def __init__(self, engine, rid: int, cohort: str = "stable",
                 state: str = HEALTHY):
        super().__init__(rid, state=state)
        self.engine = engine
        # "stable" serves normal traffic, "canary" the routed fraction on
        # a candidate snapshot, "shadow" only duplicated traffic
        self.cohort = cohort
        # the state kept while this replica runs a canary or shadow
        # snapshot: rollback installs it back
        self.rollback_state: Optional[Dict[str, Any]] = None
        self.rollback_version: int = 0

    # --- routing signals ----------------------------------------------
    @property
    def queue_depth(self) -> int:
        return self.engine.queue_depth

    def routable(self, cohort: str = "stable") -> bool:
        """Eligible for client traffic of the given cohort."""
        return self.state == HEALTHY and self.cohort == cohort

    def _on_eject(self, reason: str) -> int:
        """Drain the queue: every waiting future fails with ReplicaDown
        and the router retries it on a survivor."""
        return self.engine.drain_pending(
            ReplicaDown(self.rid, f"ejected: {reason}"))

    # --- deployment helpers (the router's canary and shadow) -----------
    def capture_rollback_state(self) -> None:
        """Copy what the engine serves (``state_snapshot``: a parked full
        install counts) before a candidate is installed."""
        state, version = self.engine.state_snapshot()
        self.rollback_state = copy_state(state)
        self.rollback_version = version

    def restore_rollback_state(self) -> None:
        if self.rollback_state is None:
            raise RuntimeError(
                f"replica {self.rid} has no captured rollback state")
        self.engine.install_snapshot(self.rollback_state,
                                     self.rollback_version,
                                     source="rollback")
        self.rollback_state = None

    def stats(self) -> Dict[str, Any]:
        out = self.breaker_stats()
        out.update({
            "cohort": self.cohort,
            "queue_depth": self.queue_depth,
            "heartbeat_age_s": round(self.engine.heartbeat_age(), 4),
            "engine": self.engine.stats(),
        })
        return out


class Fleet:
    """The replica set: lifecycle, elastic grow and shrink, and
    fleet-wide stats.

    Construct it from engines (``replica_id`` is assigned by position
    when an engine has none), with :meth:`build` from a model factory
    (each replica needs its OWN model: its own parameters to hot-swap),
    or with :meth:`connect` over ranker processes. A fleet built from a
    factory can :meth:`grow` (new replicas are born PROBING and admitted
    only after the router's probe) and :meth:`shrink`: the verbs the
    autoscaler drives. Growing builds from the factory; booting from a
    compile cache is ROADMAP queue 1 item 9.5."""

    # replicas start (and warm their buckets) concurrently, this many at
    # a time
    WARM_POOL = 4

    def __init__(self, engines: List[Any], model_factory=None, config=None,
                 checkpoint_dir: Optional[str] = None, shard_set=None):
        if not engines:
            raise ValueError("a fleet needs at least one replica")
        self._factory = model_factory
        self._config = config
        self._checkpoint_dir = checkpoint_dir
        # the shared lookup tier the rankers resolve host-table ids
        # through: one set serves every replica
        self.shard_set = shard_set
        # the replica list is copy-on-write under this lock: readers take
        # the current list without locking
        self._fleet_lock = threading.Lock()
        self.grows = 0
        self.shrinks = 0
        replicas: List[Replica] = []
        for i, eng in enumerate(engines):
            if eng.replica_id is None:
                eng.replica_id = i
            replicas.append(Replica(eng, eng.replica_id))
        rids = [r.rid for r in replicas]
        if len(set(rids)) != len(rids):
            raise ValueError(f"duplicate replica ids {rids}")
        self.replicas = replicas

    @classmethod
    def build(cls, model_factory, n: int, config=None,
              checkpoint_dir: Optional[str] = None,
              shard_set=None) -> "Fleet":
        """N engines over N models from ``model_factory(i)``, each with
        its own snapshot watcher when a checkpoint directory is given.
        The factory is kept so the autoscaler can :meth:`grow`."""
        engines = [InferenceEngine(model_factory(i), config,
                                   checkpoint_dir=checkpoint_dir,
                                   replica_id=i, shard_set=shard_set)
                   for i in range(n)]
        return cls(engines, model_factory=model_factory, config=config,
                   checkpoint_dir=checkpoint_dir, shard_set=shard_set)

    @classmethod
    def connect(cls, addresses, deadline_s: float = 30.0) -> "Fleet":
        """A fleet over ranker PROCESSES: one
        :class:`~.transport.RemoteEngineClient` per ``host:port`` (each
        a replica running ``engine.serve_forever()``). The router drives
        them as it drives in-process engines; canary and shadow installs
        are refused by the proxy. A fixed-size fleet: no grow()."""
        from .shardtier import _parse_address
        from .transport import RemoteEngineClient
        if not addresses:
            raise ValueError("connect() needs at least one replica "
                             "address")
        engines = [RemoteEngineClient(_parse_address(addr), rid=i,
                                      deadline_s=deadline_s)
                   for i, addr in enumerate(addresses)]
        return cls(engines)

    def __len__(self) -> int:
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    def get(self, rid: int) -> Replica:
        for r in self.replicas:
            if r.rid == rid:
                return r
        raise KeyError(f"no replica {rid} in fleet "
                       f"{[r.rid for r in self.replicas]}")

    def healthy(self, cohort: Optional[str] = None) -> List[Replica]:
        out = [r for r in self.replicas if r.state == HEALTHY
               and r.cohort != "shadow"]
        if cohort is not None:
            out = [r for r in out if r.cohort == cohort]
        return out

    # --- lifecycle -----------------------------------------------------
    def _start_engines(self, replicas: List[Replica]) -> None:
        """Start (and warm) engines concurrently on up to WARM_POOL
        threads, every one joined before this returns."""
        if len(replicas) == 1:
            replicas[0].engine.start()
            return
        errs: List[BaseException] = []
        todo = list(replicas)
        lock = threading.Lock()

        def worker():
            while True:
                with lock:
                    if not todo:
                        return
                    rep = todo.pop(0)
                try:
                    rep.engine.start()
                except BaseException as e:   # noqa: BLE001 — raised after
                    with lock:               # every join
                        errs.append(e)

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"ff-fleet-warm-{i}")
                   for i in range(min(self.WARM_POOL, len(replicas)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]

    def start(self) -> "Fleet":
        self._start_engines(self.replicas)
        return self

    # --- elastic size (driven by serve/autoscale.py) -------------------
    @property
    def can_grow(self) -> bool:
        return self._factory is not None

    def grow(self, n: int = 1) -> List[int]:
        """Provision ``n`` replicas from the kept factory, start and warm
        them, and add them PROBING: the router's next health tick runs
        their admission probe. Returns the new replica ids."""
        if self._factory is None:
            raise RuntimeError(
                "this fleet was not built with Fleet.build(model_factory"
                "=...); it has no recipe to provision new replicas from")
        if n < 1:
            raise ValueError(f"grow() needs n >= 1, got {n}")
        with self._fleet_lock:
            next_rid = max(r.rid for r in self.replicas) + 1
        fresh: List[Replica] = []
        for k in range(n):
            rid = next_rid + k
            eng = InferenceEngine(self._factory(rid), self._config,
                                  checkpoint_dir=self._checkpoint_dir,
                                  replica_id=rid, shard_set=self.shard_set)
            fresh.append(Replica(eng, rid, state=PROBING))
        self._start_engines(fresh)
        with self._fleet_lock:
            self.replicas = self.replicas + fresh
            self.grows += n
        ids = [r.rid for r in fresh]
        log_fleet.warning("fleet grew by %d replica(s) %s (now %d); "
                          "awaiting admission probes", n, ids,
                          len(self.replicas))
        return ids

    def shrink(self, n: int = 1, deadline_s: float = 10.0) -> List[int]:
        """Retire ``n`` healthy STABLE replicas (highest rid first; never
        a canary or shadow, never the last one). Their queues drain with
        ReplicaDown, so the router retries those requests on survivors;
        the engines then close. Returns the retired ids."""
        if n < 1:
            raise ValueError(f"shrink() needs n >= 1, got {n}")
        with self._fleet_lock:
            victims = [r for r in self.replicas
                       if r.state == HEALTHY and r.cohort == "stable"]
            victims = sorted(victims, key=lambda r: r.rid)[-n:]
            while len(self.replicas) - len(victims) < 1 and victims:
                victims.pop()
            if not victims:
                return []
            gone = {r.rid for r in victims}
            self.replicas = [r for r in self.replicas
                             if r.rid not in gone]
            self.shrinks += len(victims)
        for r in victims:
            r.eject("retired by autoscaler shrink")
            try:
                r.engine.close(deadline_s)
            except Exception as e:   # noqa: BLE001 — a wedged retiree
                log_fleet.warning("shrink: replica %d close failed (%s)",
                                  r.rid, e)
        ids = [r.rid for r in victims]
        log_fleet.warning("fleet shrank by %d replica(s) %s (now %d)",
                          len(ids), ids, len(self.replicas))
        return ids

    def close(self, deadline_s: float = 10.0) -> None:
        errs = []
        for r in self.replicas:
            try:
                r.engine.close(deadline_s)
            except Exception as e:   # noqa: BLE001 — close every replica
                errs.append(e)       # before reporting
        if errs:
            raise errs[0]

    # --- observability -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Totals across replicas and latency percentiles over every
        replica's window merged (percentiles do not average: merge the
        samples, then cut)."""
        per = {r.rid: r.stats() for r in self.replicas}
        lat: List[float] = []
        for r in self.replicas:
            lat.extend(r.engine._lat_ms.samples())
        lat.sort()
        totals = {k: sum(p["engine"].get(k, 0) for p in per.values())
                  for k in ("requests", "responses", "overloaded",
                            "timeouts", "batches", "queue_depth",
                            "reloads", "reload_rejects")}
        out = {
            "replicas": per,
            "size": len(self.replicas),
            "healthy": len(self.healthy()),
            "states": {r.rid: r.state for r in self.replicas},
            "p50_ms": percentile(lat, 50),
            "p99_ms": percentile(lat, 99),
            "totals": totals,
            "requests_dispatched": totals["requests"],
            "grows": self.grows,
            "shrinks": self.shrinks,
        }
        if self.shard_set is not None:
            out["shard_set"] = self.shard_set.stats()
        return out
