"""The circuit-breaker state machine of the serving tier (the
counterpart of ``CircuitBreaker`` in ``dlrm_flexflow_tpu.serve.fleet``;
the fleet's replicas and its router are not ported yet).

::

    HEALTHY --(eject_after consecutive errors)--> EJECTED
    EJECTED --(begin_probe)---------------------> PROBING
    PROBING --(readmit)-------------------------> HEALTHY

The shard tier wraps each ``EmbeddingShard`` in it (``ShardReplica``):
an ejected shard receives no traffic until its admission probe succeeds
(``EmbeddingShardSet.health_tick``, after ``cooldown_s``); a unit born
PROBING (a replacement) is probed at the next tick, and a failed probe
sends it back to EJECTED with its cooldown restarted.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict

log_fleet = logging.getLogger("dlrm_flexflow_tpu_torch.serve.fleet")

# unit states (plain strings: they go straight into stats())
HEALTHY = "healthy"
EJECTED = "ejected"
PROBING = "probing"


class CircuitBreaker:
    """The eject/probe/re-admit state machine, decoupled from what it
    guards. All transitions happen under the breaker's own lock."""

    KIND = "unit"

    def __init__(self, rid: int, state: str = HEALTHY):
        self.rid = rid
        self.state = state
        # a unit born PROBING (a replacement) takes no traffic until its
        # end-to-end admission probe succeeds
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

    def eject(self, reason: str) -> None:
        """HEALTHY/PROBING -> EJECTED: stop routing here."""
        with self._lock:
            if self.state == EJECTED:
                return
            self.state = EJECTED
            self.ejected_at = time.monotonic()
            self.ejections += 1
            self.last_error = reason
        log_fleet.warning("ejected %s %d (%s)", self.KIND, self.rid, reason)

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
