"""SLO-driven fleet autoscaler: grow under sustained load, shrink when
idle, replace dead replicas (the counterpart of
``dlrm_flexflow_tpu.serve.autoscale``).

The serving stack so far could only SHED load: a saturated engine raises
``Overloaded``, the router retries elsewhere, and when every replica is
saturated the client eats ``FleetUnavailable``. This module closes the
loop the other way — a policy thread reads ``FleetRouter.stats()`` every
``interval_s`` and drives :meth:`~.fleet.Fleet.grow` /
:meth:`~.fleet.Fleet.shrink`:

- **Grow** when the client-observed p99 exceeds ``slo_ms`` (or the mean
  queue depth per healthy replica exceeds ``queue_hwm``) for ``sustain``
  consecutive evaluation periods. New replicas are built from the
  fleet's model factory (booting from a compile cache is ROADMAP queue 1
  item 9.5), warm their buckets concurrently, enter PROBING, and are
  admitted only after the router's end-to-end probe succeeds — a grow
  can never inject a broken replica into the routable set.
- **Replace** immediately (no sustain debounce) when the healthy count
  falls below ``min_replicas`` — the chaos case: a replica crashes, the
  circuit breaker ejects it, and the autoscaler provisions a substitute
  while the survivors absorb the retried traffic (zero failed requests).
- **Shrink** when the fleet has been idle — p99 comfortably inside the
  SLO and queues near empty — for ``idle_sustain`` periods, never below
  ``min_replicas`` and never touching canary/shadow cohorts.

Every decision is debounced (``utils.watchdog.Sustained``), rate-limited
(``cooldown_s`` between actions), bounded (``min_replicas`` ..
``max_replicas``), and recorded in :meth:`stats` with its reason. The
policy thread is ff-named, daemon, stop-signalled and joined on
``close()``.

The policy reads nothing but ``router.stats()``, the fleet's size and
its replicas' queue depths, so a test can drive every decision from
injected stats, one ``_tick()`` at a time.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..obs import metrics as obsm
from ..obs import trace as obstrace
from ..utils.logging import get_logger
from ..utils.watchdog import Sustained

log_scale = get_logger("serve.autoscale")


@dataclass
class AutoscaleConfig:
    """Policy knobs; ``from_config`` lifts the ``--serve-*`` flags."""

    slo_ms: float = 0.0          # p99 objective; 0 = queue-depth only
    min_replicas: int = 1
    max_replicas: int = 8
    interval_s: float = 0.25     # evaluation period
    sustain: int = 3             # breach periods before a grow
    idle_sustain: int = 12       # idle periods before a shrink
    queue_hwm: float = 4.0       # mean queued reqs / healthy replica
    queue_lwm: float = 0.5       # below this counts as idle
    idle_p99_frac: float = 0.5   # idle also needs p99 < frac * slo
    grow_step: int = 1           # replicas added per grow action
    cooldown_s: float = 1.0      # min seconds between scaling actions
    replace_dead: bool = True    # heal below min_replicas immediately

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}")

    @staticmethod
    def from_config(cfg) -> "AutoscaleConfig":
        return AutoscaleConfig(
            slo_ms=float(getattr(cfg, "serve_slo_ms", 0.0)),
            min_replicas=int(getattr(cfg, "serve_min_replicas", 1)),
            max_replicas=int(getattr(cfg, "serve_max_replicas", 8)))


class Autoscaler:
    """The policy thread over a started :class:`~.router.FleetRouter`.

    The router keeps owning health/probing/ejection; this class only
    decides SIZE. It therefore composes with everything the router
    already does: a grown replica is admitted through the same probe
    machinery an ejected one is re-admitted through, and a shrink drains
    through the same typed-``ReplicaDown`` retry path a crash does.
    """

    def __init__(self, router, config: Optional[AutoscaleConfig] = None,
                 shard_set=None):
        self.router = router
        self.config = config or AutoscaleConfig()
        # the row-sharded lookup tier, when the fleet serves through one
        # (serve/shardtier.py): the autoscaler drives its health ticks —
        # probe/re-admit ejected shards and REPLACE the ones whose
        # probes keep failing (booted from the warm cache, admitted only
        # on probe success). Same replace-dead philosophy as replicas,
        # one tier down.
        self.shard_set = shard_set if shard_set is not None \
            else getattr(router.fleet, "shard_set", None)
        self._shard_replacements = 0
        self._shard_readmissions = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_lock = threading.Lock()
        self._breach = Sustained(self.config.sustain)
        self._idle = Sustained(self.config.idle_sustain)
        self._last_action_t = 0.0
        self._grows = 0
        self._shrinks = 0
        self._replacements = 0
        self._breaches = 0
        self._last_reason = ""
        self._decisions: List[Dict[str, Any]] = []
        if not router.fleet.can_grow:
            log_scale.warning(
                "fleet was not built via Fleet.build(model_factory=...): "
                "the autoscaler can observe but never grow it")

    # --- lifecycle -----------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._policy_loop,
                                        daemon=True,
                                        name="ff-autoscaler")
        self._thread.start()
        return self

    def close(self, deadline_s: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(deadline_s)
        self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # --- policy --------------------------------------------------------
    def _policy_loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self._tick()
            except Exception:   # noqa: BLE001 — the policy thread must
                # outlive a bad stats read; scaling just skips a beat
                log_scale.exception("autoscaler tick failed")

    def _record(self, action: str, reason: str, detail=None) -> None:
        with self._m_lock:
            self._last_reason = f"{action}: {reason}"
            self._decisions.append({"t": time.time(), "action": action,
                                    "reason": reason, "detail": detail})
            del self._decisions[:-64]
        # labeled decision counter + trace instant: chaos benches (and
        # a scraper) assert on WHICH actions fired, not just how many
        obsm.counter(
            "ff_autoscaler_decisions_total",
            "scaling decisions by action (grow/shrink/replace/"
            "shard-replace/shard-readmit)",
            labelnames=("action",)).inc(action=action)
        obstrace.instant(f"autoscaler/{action}", cat="autoscale",
                         reason=reason[:200])
        log_scale.warning("autoscaler %s (%s)", action, reason)

    def _cooldown_ok(self) -> bool:
        return (time.monotonic() - self._last_action_t
                >= self.config.cooldown_s)

    def _acted(self) -> None:
        self._last_action_t = time.monotonic()
        self._breach.reset()
        self._idle.reset()

    def _tick(self) -> None:
        """One evaluation: heal, grow or shrink (at most one action)."""
        cfg = self.config
        fleet = self.router.fleet
        self._shard_tick()
        st = self.router.stats()
        healthy = int(st["fleet"]["healthy"])
        size = len(fleet)
        p99 = st.get("p99_ms")
        depth = sum(r.queue_depth for r in fleet.healthy())
        q_per = depth / healthy if healthy else float("inf")

        # 1. heal: a fleet below its floor is not a load question — the
        #    chaos bar (replica dies, autoscaler replaces it, zero
        #    failed requests) keys on this firing without debounce
        if (cfg.replace_dead and fleet.can_grow
                and healthy < cfg.min_replicas
                and size < cfg.max_replicas):
            want = min(cfg.min_replicas - healthy,
                       cfg.max_replicas - size)
            ids = fleet.grow(want)
            with self._m_lock:
                self._replacements += len(ids)
            self._record("replace",
                         f"healthy {healthy} < min {cfg.min_replicas}",
                         {"new": ids})
            self._acted()
            return

        # 2. grow: sustained SLO breach or queue pressure
        over_slo = bool(cfg.slo_ms > 0 and p99 is not None
                        and p99 > cfg.slo_ms)
        over_q = q_per > cfg.queue_hwm
        breach = over_slo or over_q
        if breach:
            with self._m_lock:
                self._breaches += 1
        if (self._breach.observe(breach) and fleet.can_grow
                and self._cooldown_ok() and size < cfg.max_replicas):
            n = min(cfg.grow_step, cfg.max_replicas - size)
            reason = (f"p99 {p99:.1f} ms > SLO {cfg.slo_ms:g} ms"
                      if over_slo else
                      f"queue depth {q_per:.1f}/replica > "
                      f"{cfg.queue_hwm:g}")
            ids = fleet.grow(n)
            with self._m_lock:
                self._grows += len(ids)
            self._record("grow", reason, {"new": ids})
            self._acted()
            return

        # 3. shrink: sustained idle, never below the floor
        idle = (q_per < cfg.queue_lwm and not over_slo
                and (cfg.slo_ms <= 0 or p99 is None
                     or p99 < cfg.idle_p99_frac * cfg.slo_ms))
        if (self._idle.observe(idle) and self._cooldown_ok()
                and healthy > cfg.min_replicas):
            ids = fleet.shrink(1)
            if ids:
                with self._m_lock:
                    self._shrinks += len(ids)
                self._record("shrink",
                             f"idle: queue {q_per:.2f}/replica, p99 "
                             f"{p99 if p99 is None else round(p99, 1)}"
                             f" ms", {"retired": ids})
                self._acted()

    def _shard_tick(self) -> None:
        """Shard-tier health pass: probe shards due for one, replace
        shards whose probes keep failing. No debounce — a dark shard is
        degraded answers RIGHT NOW, the replica floor philosophy applied
        to the lookup tier."""
        if self.shard_set is None or not self.config.replace_dead:
            return
        for action in self.shard_set.health_tick():
            kind = action.get("action")
            if kind == "shard-replace":
                with self._m_lock:
                    self._shard_replacements += 1
                self._record("shard-replace",
                             f"slot {action['slot']} probes kept "
                             f"failing", action)
            elif kind == "shard-probe" and action.get("ok"):
                with self._m_lock:
                    self._shard_readmissions += 1
                self._record("shard-readmit",
                             f"slot {action['slot']} probe succeeded",
                             action)

    # --- observability -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._m_lock:
            return {
                "grows": self._grows,
                "shrinks": self._shrinks,
                "replacements": self._replacements,
                "shard_replacements": self._shard_replacements,
                "shard_readmissions": self._shard_readmissions,
                "breaches": self._breaches,
                "last_reason": self._last_reason,
                "decisions": list(self._decisions),
                "slo_ms": self.config.slo_ms,
                "min_replicas": self.config.min_replicas,
                "max_replicas": self.config.max_replicas,
                "size": len(self.router.fleet),
                "healthy": len(self.router.fleet.healthy()),
            }
