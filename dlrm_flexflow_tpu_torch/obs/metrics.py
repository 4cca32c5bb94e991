"""Process-wide metrics registry (own copy of
``dlrm_flexflow_tpu.obs.metrics``): Counter / Gauge / Histogram with
labels, bounded reservoir percentiles, and Prometheus-text exposition
(``GET /metrics`` of ``examples/native/serve_dlrm.py``). The metric
names, labels and text format are the JAX package's, so one scraper
reads both.

- **Off is free.** ``--obs off`` (the default) makes every module-level
  factory return a shared no-op singleton (``counter(...) is
  NULL_COUNTER``).
- **Stats never lie about silence.** An empty window cuts a ``None``
  percentile, never a flawless p99.
- **Bounded by construction.** Every sample window is a ring.

Naming scheme: ``ff_<subsystem>_<what>[_total]``: counters end in
``_total``, latencies are ``*_ms`` histograms, point-in-time values are
gauges. Labels are low-cardinality only.
"""

from __future__ import annotations

import re
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

_ENABLED = False

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Flip the process-wide obs switch (``--obs on``). Instruments are
    resolved at creation time: components built BEFORE enabling keep
    their no-op instruments (build the engine after configure, as
    serve_dlrm.py and fit() do)."""
    global _ENABLED
    _ENABLED = bool(on)


def override(on: bool):
    """Context manager flipping the switch for tests. Only affects
    instruments CREATED inside the scope."""
    import contextlib

    @contextlib.contextmanager
    def _scope():
        global _ENABLED
        prev = _ENABLED
        _ENABLED = bool(on)
        try:
            yield
        finally:
            _ENABLED = prev

    return _scope()


# ---------------------------------------------------------------------
# percentiles + the bounded sample window
# ---------------------------------------------------------------------
def percentile(sorted_vals, p: float) -> Optional[float]:
    """Linear-interpolated percentile over an ASCENDING sequence
    (numpy's default method), ``None`` on an empty window (0.0 ms would
    be a flawless p99 for a server that answered nothing).
    ``serve.engine`` re-exports it."""
    n = len(sorted_vals)
    if n == 0:
        return None
    if n == 1:
        return float(sorted_vals[0])
    k = (p / 100.0) * (n - 1)
    f = int(k)
    c = min(f + 1, n - 1)
    return float(sorted_vals[f] + (k - f) * (sorted_vals[c] - sorted_vals[f]))


class Reservoir:
    """Bounded sample window: a ring of the last ``maxlen`` observations
    plus lifetime count/sum. Deque-compatible (``append``, ``extend``,
    iteration), with the percentile cut built in, and registered as a
    Histogram child when obs is on, so the window behind the engine's
    ``stats()`` is scrapeable. Thread-safe; iteration and ``samples()``
    return copies."""

    __slots__ = ("maxlen", "_buf", "_head", "_lock", "count", "total")

    def __init__(self, maxlen: int = 2048):
        if maxlen < 1:
            raise ValueError(f"Reservoir maxlen must be >= 1, got {maxlen}")
        self.maxlen = int(maxlen)
        self._buf: List[float] = []
        self._head = 0          # ring insertion point once full
        self._lock = threading.Lock()
        self.count = 0          # lifetime observations
        self.total = 0.0        # lifetime sum

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if len(self._buf) < self.maxlen:
                self._buf.append(v)
            else:
                self._buf[self._head] = v
                self._head = (self._head + 1) % self.maxlen

    # deque-compatible verbs
    append = observe

    def extend(self, vals: Iterable[float]) -> None:
        for v in vals:
            self.observe(v)

    def samples(self) -> List[float]:
        with self._lock:
            return list(self._buf)

    def __iter__(self):
        return iter(self.samples())

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf = []
            self._head = 0

    def percentile(self, p: float) -> Optional[float]:
        return percentile(sorted(self.samples()), p)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            vals = sorted(self._buf)
            count, total = self.count, self.total
        return {
            "count": count,
            "sum": total,
            "window": len(vals),
            "min": vals[0] if vals else None,
            "max": vals[-1] if vals else None,
            "p50": percentile(vals, 50),
            "p99": percentile(vals, 99),
        }


# ---------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------
def _label_key(labelnames: Tuple[str, ...], kv: Dict[str, str]
               ) -> Tuple[str, ...]:
    if set(kv) != set(labelnames):
        raise ValueError(
            f"labels {sorted(kv)} do not match the instrument's "
            f"labelnames {sorted(labelnames)}")
    return tuple(str(kv[n]) for n in labelnames)


class _Bound:
    """One (instrument, label-values) pair: the object ``labels()``
    hands back for counters/gauges."""

    __slots__ = ("_inst", "_key")

    def __init__(self, inst, key):
        self._inst = inst
        self._key = key

    def inc(self, n: float = 1.0) -> None:
        self._inst._add(self._key, n)

    def dec(self, n: float = 1.0) -> None:
        self._inst._add(self._key, -n)

    def set(self, v: float) -> None:
        self._inst._set(self._key, v)


class Counter:
    """Monotonic counter with optional labels. ``inc(n, **labels)`` or
    ``labels(**kv).inc(n)``."""

    TYPE = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def _add(self, key, n: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(n)

    def _set(self, key, v: float) -> None:
        raise TypeError(f"counter {self.name} is monotonic; use inc()")

    def labels(self, **kv) -> _Bound:
        return _Bound(self, _label_key(self.labelnames, kv))

    def inc(self, n: float = 1.0, **kv) -> None:
        self._add(_label_key(self.labelnames, kv), n)

    def value(self, **kv) -> float:
        with self._lock:
            return self._values.get(_label_key(self.labelnames, kv), 0.0)

    def _samples(self):
        with self._lock:
            items = list(self._values.items())
        for key, v in items:
            yield dict(zip(self.labelnames, key)), v


class Gauge(Counter):
    """Point-in-time value; ``set`` and ``inc``/``dec`` both work."""

    TYPE = "gauge"

    def _set(self, key, v: float) -> None:
        with self._lock:
            self._values[key] = float(v)

    def set(self, v: float, **kv) -> None:
        self._set(_label_key(self.labelnames, kv), v)

    def dec(self, n: float = 1.0, **kv) -> None:
        self.inc(-n, **kv)


class Histogram:
    """Labeled family of bounded :class:`Reservoir` windows. Exposed in
    Prometheus text as a summary (count/sum + p50/p90/p99 quantiles cut
    from the ring — honest about being windowed, never averaged)."""

    TYPE = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = (), reservoir: int = 2048):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.reservoir = int(reservoir)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Reservoir] = {}

    def labels(self, **kv) -> Reservoir:
        key = _label_key(self.labelnames, kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = Reservoir(self.reservoir)
            return child

    def observe(self, v: float, **kv) -> None:
        self.labels(**kv).observe(v)

    def _samples(self):
        with self._lock:
            items = list(self._children.items())
        for key, res in items:
            yield dict(zip(self.labelnames, key)), res.snapshot()


# --- no-op twins (the --obs off fast path; type identity is pinned) ---
class NullInstrument:
    """Shared do-nothing instrument: every mutator is a no-op and
    ``labels()`` returns self."""

    __slots__ = ()

    def labels(self, **kv):
        return self

    def inc(self, n: float = 1.0, **kv) -> None:
        pass

    def dec(self, n: float = 1.0, **kv) -> None:
        pass

    def set(self, v: float, **kv) -> None:
        pass

    def observe(self, v: float, **kv) -> None:
        pass


class NullCounter(NullInstrument):
    __slots__ = ()


class NullGauge(NullInstrument):
    __slots__ = ()


class NullHistogram(NullInstrument):
    __slots__ = ()


NULL_COUNTER = NullCounter()
NULL_GAUGE = NullGauge()
NULL_HISTOGRAM = NullHistogram()


# ---------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------
class MetricsRegistry:
    """Name -> instrument map plus pull-time collectors.

    Two ways in:

    - **Instruments** (``counter``/``gauge``/``histogram``): created
      once, mutated on the hot path. Get-or-create by name; a name
      re-registered with a different type or label set raises.
    - **Collectors** (``register_collector``): a zero-arg callable
      yielding ``(name, labels_dict, value)`` tuples, run at
      ``collect()``/scrape time. This is how components with existing
      ``stats()`` counters expose them without double-counting — the
      stats dict stays the source of truth, the scrape reads through.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._collectors: List[Callable] = []

    def _get_or_make(self, kind, name, help, labelnames, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        # label NAMES are a set in the data model; normalize the order
        # so two call sites naming the same labels get the same
        # instrument regardless of spelling order
        labelnames = tuple(sorted(labelnames))
        with self._lock:
            inst = self._metrics.get(name)
            if inst is None:
                inst = self._metrics[name] = kind(
                    name, help, tuple(labelnames), **kw)
                return inst
        if type(inst) is not kind or \
                tuple(inst.labelnames) != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}{inst.labelnames}; cannot "
                f"re-register as {kind.__name__}{tuple(labelnames)}")
        return inst

    def counter(self, name: str, help: str = "",
                labelnames: Tuple[str, ...] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Tuple[str, ...] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Tuple[str, ...] = (),
                  reservoir: int = 2048) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames,
                                 reservoir=reservoir)

    def register_collector(self, fn: Callable) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn: Callable) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def reset(self) -> None:
        """Drop every instrument and collector (test isolation)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    # --- exposition ----------------------------------------------------
    def collect(self) -> Dict[str, Any]:
        """Structured snapshot: instruments plus collector output.
        Collector errors are swallowed per collector (a wedged
        subsystem must not take the metrics endpoint down with it)."""
        with self._lock:
            metrics = dict(self._metrics)
            collectors = list(self._collectors)
        out: Dict[str, Any] = {}
        for name, inst in sorted(metrics.items()):
            out[name] = {
                "type": inst.TYPE,
                "help": inst.help,
                "samples": [{"labels": lab, "value": v}
                            for lab, v in inst._samples()],
            }
        for fn in collectors:
            try:
                rows = list(fn())
            except Exception:   # noqa: BLE001 — scrape must survive a
                continue        # dying component's collector
            for name, labels, value in rows:
                entry = out.setdefault(
                    name, {"type": "gauge", "help": "", "samples": []})
                entry["samples"].append(
                    {"labels": dict(labels or {}), "value": float(value)})
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (version 0.0.4). Histograms emit
        as summaries (windowed quantiles + lifetime count/sum)."""
        lines: List[str] = []
        for name, entry in self.collect().items():
            if entry["help"]:
                lines.append(f"# HELP {name} {entry['help']}")
            kind = entry["type"]
            lines.append(f"# TYPE {name} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for sample in entry["samples"]:
                labels, value = sample["labels"], sample["value"]
                if kind == "histogram":
                    for q, key in (("0.5", "p50"), ("0.99", "p99")):
                        if value[key] is not None:
                            lines.append(
                                f"{name}{_fmt_labels(labels, quantile=q)}"
                                f" {_fmt_value(value[key])}")
                    lines.append(f"{name}_count{_fmt_labels(labels)} "
                                 f"{value['count']}")
                    lines.append(f"{name}_sum{_fmt_labels(labels)} "
                                 f"{_fmt_value(value['sum'])}")
                else:
                    lines.append(f"{name}{_fmt_labels(labels)} "
                                 f"{_fmt_value(value)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_value(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _fmt_labels(labels: Dict[str, str], **extra) -> str:
    kv = dict(labels)
    kv.update(extra)
    if not kv:
        return ""
    parts = []
    for k in sorted(kv):
        v = str(kv[k]).replace("\\", r"\\").replace('"', r"\"") \
            .replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


# ---------------------------------------------------------------------
# module-level factories (the component-facing API)
# ---------------------------------------------------------------------
def counter(name: str, help: str = "",
            labelnames: Tuple[str, ...] = ()):
    """A registry Counter when obs is on, the shared no-op otherwise."""
    if not _ENABLED:
        return NULL_COUNTER
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Tuple[str, ...] = ()):
    if not _ENABLED:
        return NULL_GAUGE
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "",
              labelnames: Tuple[str, ...] = (), reservoir: int = 2048):
    if not _ENABLED:
        return NULL_HISTOGRAM
    return _REGISTRY.histogram(name, help, labelnames, reservoir)


def latency_reservoir(name: str, help: str = "", maxlen: int = 2048,
                      **labels) -> Reservoir:
    """The serving engine's latency-window factory: always a live
    bounded :class:`Reservoir` (``stats()`` needs one); when obs is on
    it is also the Histogram child of ``name`` with the given labels."""
    if not _ENABLED:
        return Reservoir(maxlen)
    h = _REGISTRY.histogram(name, help,
                            labelnames=tuple(sorted(labels)),
                            reservoir=maxlen)
    return h.labels(**labels)


def register_collector(fn: Callable) -> None:
    """Register a pull-time collector iff obs is on (no-op otherwise,
    so components can call unconditionally)."""
    if _ENABLED:
        _REGISTRY.register_collector(fn)


def unregister_collector(fn: Callable) -> None:
    _REGISTRY.unregister_collector(fn)
