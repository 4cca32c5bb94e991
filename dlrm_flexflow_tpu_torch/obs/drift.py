"""Live drift monitor for a training loop (the counterpart of
``dlrm_flexflow_tpu.obs.drift``).

During ``fit`` / ``fit_stream`` with ``--obs on`` it compares each
measured step wall time against a baseline. The JAX package takes the
baseline from its strategy simulator when the model carries searched
strategies, and calibrates otherwise; the port has no strategies (ROADMAP
queue 1 items 7 and 8), so it always runs the self-calibrating mode: the
median of the first ``calibrate_steps`` steps becomes the baseline, and
drift is measured against the run's own steady state — quiet at
calibration, loud when the run later slows down.

The ratio lands on the gauge ``ff_drift_step_time_ratio{loop=...}``;
past ``threshold`` for ``sustain`` consecutive steps, ONE warning per
breach episode (``ff_drift_warnings_total``, a ``drift/step-time`` trace
instant). The collective-bytes audit needs a lowered multi-device
program and returns ``{}``, as the JAX monitor does when it cannot lower
(ROADMAP queue 1 item 12 brings the NCCL audit).
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, Optional

from ..utils.logging import get_logger
from ..utils.watchdog import Sustained
from . import metrics, trace

log_drift = get_logger("obs.drift")


class DriftMonitor:
    """Online measured/baseline comparison for one training loop. Not
    thread-safe by design: one loop owns one monitor."""

    def __init__(self, predicted_step_s: Optional[float] = None,
                 threshold: float = 1.5, calibrate_steps: int = 16,
                 sustain: int = 5, name: str = "fit"):
        if threshold <= 0:
            raise ValueError(f"drift threshold must be > 0, "
                             f"got {threshold}")
        self.name = name
        self.threshold = float(threshold)
        self.calibrate_steps = max(int(calibrate_steps), 1)
        self.predicted_step_s = (float(predicted_step_s)
                                 if predicted_step_s else None)
        self.baseline_source = ("simulator" if self.predicted_step_s
                                else None)
        self._model = None
        self._cal: list = []
        self._sustained = Sustained(max(int(sustain), 1))
        self._in_breach = False
        self.steps = 0
        self.fired = 0
        self.last_ratio: Optional[float] = None
        self.max_ratio: Optional[float] = None
        self.collective_drift: Dict[str, Any] = {}
        self._g_ratio = metrics.gauge(
            "ff_drift_step_time_ratio",
            "measured / predicted step wall time", labelnames=("loop",))
        self._c_warn = metrics.counter(
            "ff_drift_warnings_total",
            "sustained drift breaches (one per episode)",
            labelnames=("loop", "kind"))

    @classmethod
    def from_model(cls, model, name: str = "fit",
                   threshold: Optional[float] = None) -> "DriftMonitor":
        """A self-calibrating monitor for ``model`` at the config's
        ``--obs-drift-threshold``."""
        thr = (float(threshold) if threshold is not None
               else float(getattr(model.config, "obs_drift_threshold",
                                  1.5) or 1.5))
        mon = cls(predicted_step_s=None, threshold=thr, name=name)
        mon._model = model
        return mon

    def audit_collectives(self) -> Dict[str, Any]:
        """The collective-bytes audit: ``{}`` (nothing lowers to audit
        on one card; ROADMAP queue 1 item 12)."""
        return {}

    def observe_step(self, wall_s: float) -> Optional[float]:
        """Feed one measured step wall time. Returns the measured /
        baseline ratio, or None while calibrating."""
        self.steps += 1
        pred = self.predicted_step_s
        if pred is None:
            self._cal.append(float(wall_s))
            if len(self._cal) >= self.calibrate_steps:
                self.predicted_step_s = max(
                    statistics.median(self._cal), 1e-9)
                self.baseline_source = "calibration"
                log_drift.info(
                    "drift monitor [%s] calibrated: baseline step time "
                    "%.3f ms over %d steps", self.name,
                    1e3 * self.predicted_step_s, len(self._cal))
            return None
        ratio = float(wall_s) / pred
        self.last_ratio = ratio
        self.max_ratio = (ratio if self.max_ratio is None
                          else max(self.max_ratio, ratio))
        self._g_ratio.set(ratio, loop=self.name)
        breach = ratio > self.threshold
        if self._sustained.observe(breach):
            if not self._in_breach:
                # one loud report per episode, not one per step
                self._in_breach = True
                self.fired += 1
                self._c_warn.inc(loop=self.name, kind="step-time")
                trace.instant("drift/step-time", cat="drift",
                              loop=self.name, ratio=round(ratio, 3),
                              measured_ms=round(1e3 * wall_s, 3),
                              predicted_ms=round(1e3 * pred, 3),
                              baseline=self.baseline_source)
                log_drift.warning(
                    "DRIFT [%s] step time: measured %.3f ms is %.2fx "
                    "the %s baseline %.3f ms (> %.2gx for %d "
                    "consecutive steps)", self.name, 1e3 * wall_s, ratio,
                    self.baseline_source, 1e3 * pred, self.threshold,
                    self._sustained.periods)
        elif not breach:
            self._in_breach = False
        return ratio

    def report(self) -> Dict[str, Any]:
        return {
            "loop": self.name,
            "steps": self.steps,
            "threshold": self.threshold,
            "baseline_source": self.baseline_source,
            "predicted_step_ms": (None if self.predicted_step_s is None
                                  else round(1e3 * self.predicted_step_s,
                                             4)),
            "last_ratio": (None if self.last_ratio is None
                           else round(self.last_ratio, 4)),
            "max_ratio": (None if self.max_ratio is None
                          else round(self.max_ratio, 4)),
            "fired": self.fired,
            "in_breach": self._in_breach,
            "collective_drift": self.collective_drift,
        }
