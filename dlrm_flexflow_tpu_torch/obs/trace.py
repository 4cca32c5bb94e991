"""Structured tracing (own copy of ``dlrm_flexflow_tpu.obs.trace``):
named spans in a bounded in-memory ring, exported as Chrome-trace /
Perfetto JSON. The port emits the JAX package's span names:

- serving:  ``serve/enqueue`` -> ``serve/batch-form`` ->
  ``serve/dispatch`` -> ``serve/swap``
- freshness: ``publish/full`` / ``publish/delta`` ->
  ``publish/watcher-apply`` -> ``serve/swap``

Events land in a bounded ring (the oldest overwritten; ``dropped()``
counts them) tagged with the emitting thread, whose ``ff-*`` name labels
its lane. Off (the default) is free: :func:`span` returns a shared no-op
context manager and :func:`instant` returns at once.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

_ENABLED = False
_TRACE_DIR = ""
_CAPACITY = 65536

# the ring: plain deque — append on a maxlen deque is GIL-atomic, so
# emitters never take a lock; exporters snapshot with list(_RING)
_RING: "deque[Dict[str, Any]]" = deque(maxlen=_CAPACITY)
_APPENDED = 0                      # lifetime events (dropped = this - len)
_THREAD_NAMES: Dict[int, str] = {}  # tid -> last seen thread name
_PID = os.getpid()


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def set_trace_dir(path: str) -> None:
    global _TRACE_DIR
    _TRACE_DIR = str(path or "")


def trace_dir() -> str:
    return _TRACE_DIR


def set_capacity(n: int) -> None:
    """Resize the ring (keeps the newest events)."""
    global _RING, _CAPACITY
    if n < 1:
        raise ValueError(f"trace ring capacity must be >= 1, got {n}")
    _CAPACITY = int(n)
    _RING = deque(_RING, maxlen=_CAPACITY)


def clear() -> None:
    global _APPENDED
    _RING.clear()
    _THREAD_NAMES.clear()
    _APPENDED = 0


def events() -> List[Dict[str, Any]]:
    return list(_RING)


def dropped() -> int:
    """Events overwritten by the ring so far."""
    return max(0, _APPENDED - len(_RING))


def override(on: bool, trace_dir: Optional[str] = None,
             capacity: Optional[int] = None):
    """Context manager flipping tracing for tests; restores the ring
    contents, capacity, and trace dir on exit."""
    import contextlib

    @contextlib.contextmanager
    def _scope():
        global _ENABLED, _TRACE_DIR
        prev = (_ENABLED, _TRACE_DIR, _CAPACITY)
        _ENABLED = bool(on)
        if trace_dir is not None:
            _TRACE_DIR = trace_dir
        if capacity is not None:
            set_capacity(capacity)
        try:
            yield
        finally:
            _ENABLED, _TRACE_DIR, cap = prev
            set_capacity(cap)

    return _scope()


def _now_us() -> float:
    return time.perf_counter() * 1e6


def _emit(ev: Dict[str, Any]) -> None:
    global _APPENDED
    t = threading.current_thread()
    tid = t.ident or 0
    _THREAD_NAMES[tid] = t.name
    ev["pid"] = _PID
    ev["tid"] = tid
    _RING.append(ev)
    _APPENDED += 1


class _NullSpan:
    """Shared reusable no-op context manager — the obs-off fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One named duration. Records a complete ("X") event on exit, so
    an abandoned span (thread died mid-work) simply never lands — the
    instants around it still tell the story."""

    __slots__ = ("name", "cat", "args", "_t0")

    def __init__(self, name: str, cat: str, args: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self._t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = _now_us()
        args = self.args
        if exc_type is not None:
            args = dict(args)
            args["error"] = exc_type.__name__
        _emit({"name": self.name, "cat": self.cat or "ff", "ph": "X",
               "ts": self._t0, "dur": t1 - self._t0, "args": args})
        return False


def span(name: str, cat: str = "", **args):
    """Context manager timing one named unit of work. The shared no-op
    singleton when tracing is off — ``span(...) is NULL_SPAN``."""
    if not _ENABLED:
        return NULL_SPAN
    return Span(name, cat, args)


def complete(name: str, t0_s: float, cat: str = "", **args) -> None:
    """Record an already-timed duration: ``t0_s`` is the
    ``time.perf_counter()`` reading at its start. For call sites that
    cannot wrap their work in a ``with`` (a batch formed across a
    condition-variable wait, say)."""
    if not _ENABLED:
        return
    t0 = t0_s * 1e6
    _emit({"name": name, "cat": cat or "ff", "ph": "X", "ts": t0,
           "dur": _now_us() - t0, "args": args})


def instant(name: str, cat: str = "", **args) -> None:
    """Record a zero-duration marker (stall reports, anomaly sentinel
    fires, drift warnings): visible even when the
    subsystem that emitted it is wedged and will never close a span."""
    if not _ENABLED:
        return
    _emit({"name": name, "cat": cat or "ff", "ph": "i", "s": "t",
           "ts": _now_us(), "args": args})


# ---------------------------------------------------------------------
# export
# ---------------------------------------------------------------------
def chrome_trace() -> Dict[str, Any]:
    """The ring as a Chrome trace-event JSON object: thread-name
    metadata first (so Perfetto labels each lane with the ff-* worker
    name), then the events oldest-first."""
    evs = list(_RING)
    meta = [{"name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
             "args": {"name": name}}
            for tid, name in sorted(_THREAD_NAMES.items())]
    return {
        "traceEvents": meta + evs,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "dlrm_flexflow_tpu_torch.obs.trace",
            "dropped_events": dropped(),
        },
    }


def export(path: str) -> str:
    """Write the current ring as Chrome-trace JSON to ``path``."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(chrome_trace(), f)
    os.replace(tmp, path)
    return path


def export_to_dir(directory: Optional[str] = None) -> Optional[str]:
    """Export to the configured ``--obs-trace-dir`` (or an explicit
    directory); None when neither is set. File names are unique per
    (pid, monotonic-ns) so concurrent exporters never clobber."""
    d = directory or _TRACE_DIR
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    name = f"ff-trace-{_PID}-{time.monotonic_ns()}.json"
    return export(os.path.join(d, name))
