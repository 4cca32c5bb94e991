"""Observability for the port (the counterpart of
``dlrm_flexflow_tpu.obs``): the metrics registry, structured tracing and
the drift monitor, behind one switch.

- :mod:`.metrics` — Counter/Gauge/Histogram registry with labels,
  bounded-reservoir percentiles and Prometheus-text exposition
  (``GET /metrics`` in ``examples/native/serve_dlrm.py``);
- :mod:`.trace` — named spans in a bounded ring, exported as
  Chrome-trace JSON;
- :mod:`.drift` — measured step time against a self-calibrated
  baseline during ``fit`` / ``fit_stream``.

Everything is off by default and free when off. Turn it on with
``--obs on`` (plus ``--obs-trace-dir DIR`` to export traces) or
:func:`configure`, BEFORE building engines: instruments resolve at
creation time.
"""

from __future__ import annotations

from . import metrics, trace


def configure(cfg) -> bool:
    """Apply an FFConfig's ``--obs`` flags process-wide. Returns True
    when observability ended up enabled. Idempotent; never turns obs
    off (a second model with the default config must not disable the
    first one's instruments mid-run)."""
    if str(getattr(cfg, "obs", "off")) != "on":
        return metrics.enabled()
    metrics.set_enabled(True)
    trace.set_enabled(True)
    d = str(getattr(cfg, "obs_trace_dir", "") or "")
    if d:
        trace.set_trace_dir(d)
    return True


__all__ = ["metrics", "trace", "configure"]
