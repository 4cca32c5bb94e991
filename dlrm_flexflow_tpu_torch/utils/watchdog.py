"""Deadlines and stall reports (own copies of ``StallReport``,
``WorkerStalled``, ``Heartbeat``, ``Sustained`` and ``Deadline`` from
``dlrm_flexflow_tpu.utils.watchdog``): the serving path's deadlines,
the prefetch ring's liveness deadline, the serving batcher's heartbeat
(the fleet router ejects a replica whose heartbeat goes stale) and the
drift monitor's and autoscaler's debouncer. The JAX package's other worker
watchdogs, and the observability hooks of ``WorkerStalled``, wait with
the items that port those workers."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class StallReport:
    """What a deadline saw when it expired."""

    worker: str          # thread or stage name: ff-cascade, ...
    waiting_for: str     # what the consumer needed from it
    waited_s: float      # how long the consumer actually waited
    deadline_s: float    # the configured deadline
    detail: str = ""     # stage-specific context
    alive: bool = True   # False = the worker died rather than wedged

    def __str__(self) -> str:
        state = "alive but unresponsive" if self.alive else "dead"
        s = (f"worker {self.worker!r} ({state}) missed its "
             f"{self.deadline_s:.3g}s liveness deadline: waited "
             f"{self.waited_s:.3g}s for {self.waiting_for}")
        if self.detail:
            s += f" [{self.detail}]"
        return s


class WorkerStalled(RuntimeError):
    """A background worker missed its liveness deadline. Raised at the
    consumer's wait site, never from the worker thread, so a training
    loop sees it at a step boundary; ``report`` carries the
    :class:`StallReport`."""

    def __init__(self, report: StallReport):
        super().__init__(str(report))
        self.report = report


class Heartbeat:
    """Last sign of life of a long-lived worker: the worker calls
    :meth:`beat` each time around its loop, a monitor on another thread
    reads :meth:`age` and, past its deadline, builds a
    :class:`StallReport`. A float store and load are atomic under the
    interpreter lock, so neither side locks."""

    __slots__ = ("name", "_t")

    def __init__(self, name: str):
        self.name = name
        self._t = time.monotonic()

    def beat(self) -> None:
        self._t = time.monotonic()

    def age(self) -> float:
        """Seconds since the last beat."""
        return time.monotonic() - self._t

    def report(self, deadline_s: float, waiting_for: str,
               detail: str = "", alive: bool = True) -> StallReport:
        """StallReport for a monitor that found this heartbeat stale."""
        return StallReport(worker=self.name, waiting_for=waiting_for,
                           waited_s=self.age(), deadline_s=deadline_s,
                           detail=detail, alive=alive)


class Sustained:
    """Consecutive-observation debouncer: ``observe(breach)`` is True
    once the condition has held for ``periods`` observations in a row;
    any non-breach resets the count. Single-threaded by design (one
    loop owns each instance)."""

    __slots__ = ("periods", "count")

    def __init__(self, periods: int):
        if periods < 1:
            raise ValueError(f"periods must be >= 1, got {periods}")
        self.periods = int(periods)
        self.count = 0

    def observe(self, breach: bool) -> bool:
        self.count = self.count + 1 if breach else 0
        return self.count >= self.periods

    def reset(self) -> None:
        self.count = 0


@dataclass
class Deadline:
    """A wall-clock budget: construct when the wait begins, poll
    :meth:`remaining`, and hand :meth:`report` the description the typed
    error carries. ``seconds <= 0`` means no deadline (never expires)."""

    seconds: float
    t0: float = field(default_factory=time.monotonic)

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def remaining(self) -> float:
        """Seconds left (``inf`` when no deadline is configured)."""
        if self.seconds <= 0:
            return float("inf")
        return self.seconds - self.elapsed()

    def expired(self) -> bool:
        return self.seconds > 0 and self.remaining() <= 0

    def report(self, worker: str, waiting_for: str, detail: str = "",
               alive: bool = True) -> StallReport:
        """StallReport snapshot of this deadline's state."""
        return StallReport(worker=worker, waiting_for=waiting_for,
                           waited_s=self.elapsed(),
                           deadline_s=self.seconds, detail=detail,
                           alive=alive)
