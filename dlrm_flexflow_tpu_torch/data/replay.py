"""Trace-driven replay: realistic traffic for the closed serve->train loop
(the port's own copy of ``dlrm_flexflow_tpu.data.replay``: numpy and
threading only, drawing bitwise the same traces from the same spec).

Production recsys traffic is not one zipf(alpha) forever — it has diurnal
QPS cycles, flash crowds, a hot set that churns, and a skew exponent that
drifts (the FAE/Monolith observation: the distribution you searched your
placement with is not the one you serve an hour later). This module
extends the ``zipf_indices`` machinery into a deterministic open-loop
load generator plus the feedback half of the loop:

- :class:`ReplaySpec` / :func:`scenario_spec` — a named, seeded traffic
  shape: base QPS, diurnal amplitude/period, a flash-crowd window
  (multiplies QPS), a time-varying zipf alpha (drifting skew), and a
  hot-set churn point (an id-space rotation: the same zipf head lands on
  DIFFERENT rows, which is exactly what invalidates a searched hot/cold
  placement without changing the marginal skew).
- :class:`TraceReplay` — ``request(i)`` materializes the i-th trace step
  as a feature batch, deterministic per (spec.seed, i): the same spec
  replays bit-identically to the serving fleet and to any offline
  consumer. ``labels(i)`` is the simulated user: click probability is a
  fixed function of the request's ids (hot rows click more), so the
  ground truth is stationary and learnable while the TRAFFIC drifts —
  AUC measures whether the model keeps up, not whether the world moved.
- :class:`FeedbackSpool` — the bounded join between serving and
  training: served batches land (with their click labels and scores)
  append-only, and ``source(i)`` replays them to ``fit_stream`` so the
  model trains on exactly what it served. Bounded: past ``capacity``
  un-consumed batches, new offers are DROPPED and counted (feedback lag
  is a judged budget, not an unbounded queue); ``faults.
  take_feedback_loss`` drops records before they land
  (``FF_FAULT_FEEDBACK_LOSS``). Landed batches are immutable, so a
  re-read of ``source(i)`` is deterministic — the ``fit_stream``
  contract.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from .dataloader import zipf_indices
from ..utils import faults
from ..utils.logging import get_logger

log_replay = get_logger("replay")

SCENARIOS = ("diurnal", "flash_crowd", "drifting_zipf")


@dataclass
class ReplaySpec:
    """One named traffic shape, fully determined by its fields + seed."""

    name: str = "diurnal"
    steps: int = 240             # trace length (the compressed 24 h)
    batch: int = 8               # rows per request batch
    base_qps: float = 64.0       # open-loop arrival rate at the trough
    alpha0: float = 0.9          # zipf exponent at t=0
    alpha1: Optional[float] = None   # exponent at t=end (None = flat)
    diurnal_amp: float = 0.0     # QPS swing, 0..1 (0 = flat day)
    diurnal_period: int = 0      # steps per day; 0 = no cycle
    flash_at: float = -1.0       # burst start, as a fraction of steps
    flash_len: float = 0.0       # burst length, fraction of steps
    flash_mult: float = 1.0      # QPS multiplier inside the burst
    churn_at: float = -1.0       # hot-set rotation point, fraction
    churn_stride: int = 0        # id-space rotation applied at churn
    seed: int = 0

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError(f"replay needs >= 1 step, got {self.steps}")
        if self.batch < 1:
            raise ValueError(f"replay needs batch >= 1, got {self.batch}")

    def alpha_at(self, i: int) -> float:
        """Zipf exponent at trace step i (linear ramp alpha0->alpha1)."""
        if self.alpha1 is None or self.steps <= 1:
            return float(self.alpha0)
        f = min(max(i / (self.steps - 1), 0.0), 1.0)
        return float(self.alpha0 + f * (self.alpha1 - self.alpha0))

    def qps_at(self, i: int) -> float:
        """Arrival rate at trace step i: diurnal sinusoid x flash."""
        q = float(self.base_qps)
        if self.diurnal_amp > 0 and self.diurnal_period > 0:
            q *= 1.0 + self.diurnal_amp * 0.5 * (
                1.0 + math.sin(2.0 * math.pi * i / self.diurnal_period
                               - math.pi / 2.0))
        if self.in_flash(i):
            q *= float(self.flash_mult)
        return q

    def in_flash(self, i: int) -> bool:
        if self.flash_at < 0 or self.flash_len <= 0:
            return False
        lo = self.flash_at * self.steps
        return lo <= i < lo + self.flash_len * self.steps

    def churn_step(self) -> Optional[int]:
        """The trace step at which the hot set rotates (None = never)."""
        if self.churn_at < 0 or self.churn_stride == 0:
            return None
        return int(self.churn_at * self.steps)

    def interarrival_s(self, i: int) -> float:
        """Open-loop pacing: seconds until the next request batch."""
        return 1.0 / max(self.qps_at(i), 1e-9)


def scenario_spec(name: str, steps: int = 240, batch: int = 8,
                  seed: int = 0, rows: int = 64) -> ReplaySpec:
    """The three named scenarios the JAX package's scenario runner
    (``dlrm_flexflow_tpu/scenarios/runner.py``) judges.

    - ``diurnal``: flat skew, QPS swings 3x over one compressed day.
    - ``flash_crowd``: a 10%-of-trace burst at 5x QPS mid-day.
    - ``drifting_zipf``: the placement-invalidating one — skew ramps
      0.6 -> 1.1 AND the hot set rotates halfway through (the searched
      histogram's head ids go cold; a new head appears mid-table).
    """
    if name == "diurnal":
        return ReplaySpec(name=name, steps=steps, batch=batch, seed=seed,
                          alpha0=0.9, diurnal_amp=2.0,
                          diurnal_period=steps)
    if name == "flash_crowd":
        return ReplaySpec(name=name, steps=steps, batch=batch, seed=seed,
                          alpha0=0.9, diurnal_amp=1.0,
                          diurnal_period=steps, flash_at=0.45,
                          flash_len=0.1, flash_mult=5.0)
    if name == "drifting_zipf":
        return ReplaySpec(name=name, steps=steps, batch=batch, seed=seed,
                          alpha0=0.6, alpha1=1.1, churn_at=0.5,
                          churn_stride=max(rows // 2, 1))
    raise ValueError(
        f"unknown scenario {name!r} — valid scenarios are "
        f"{', '.join(SCENARIOS)}")


class TraceReplay:
    """Deterministic request/label stream over one :class:`ReplaySpec`.

    ``tables`` embedding tables of ``rows`` rows each, ``bag`` lookups
    per table per sample, ``dense_dim`` dense features — the shapes a
    DLRM's ``build_dlrm`` inputs expect (``dense`` float32
    ``(batch, dense_dim)``, ``sparse`` int32 ``(batch, tables, bag)``).
    """

    # an id is "hot" for the CLICK model when its within-table row falls
    # below rows/HOT_DIV — a fixed property of the id space, NOT of the
    # traffic, so the label function stays stationary under churn/drift
    HOT_DIV = 8

    def __init__(self, tables: int, rows: int, bag: int, dense_dim: int,
                 spec: ReplaySpec):
        self.tables = int(tables)
        self.rows = int(rows)
        self.bag = int(bag)
        self.dense_dim = int(dense_dim)
        self.spec = spec
        self._hot_cut = max(self.rows // self.HOT_DIV, 1)

    def _rng(self, i: int, salt: int = 0) -> np.random.RandomState:
        return np.random.RandomState(
            (self.spec.seed * 1000003 + i * 9176 + salt) % (2 ** 31 - 1))

    def _hot_frac(self, sparse: np.ndarray) -> np.ndarray:
        """Per-sample fraction of lookups that hit the hot head."""
        hot = (sparse % self.rows) < self._hot_cut
        return hot.reshape(sparse.shape[0], -1).mean(axis=1)

    def request(self, i: int) -> Dict[str, np.ndarray]:
        """The i-th trace step's feature batch, deterministic per
        (seed, i). Post-churn, drawn ids rotate by ``churn_stride``: the
        zipf head (low ids) lands on different rows, moving the hot set
        without changing the marginal skew."""
        spec = self.spec
        rng = self._rng(i)
        alpha = spec.alpha_at(i)
        sparse = np.stack(
            [zipf_indices(rng, self.rows, (spec.batch, self.bag), alpha)
             for _ in range(self.tables)], axis=1)
        churn = spec.churn_step()
        if churn is not None and i >= churn:
            sparse = (sparse + spec.churn_stride) % self.rows
        sparse = sparse.astype(np.int32)
        dense = rng.rand(spec.batch, self.dense_dim).astype(np.float32)
        # the first dense column carries the same hotness signal the
        # click model uses (noisy), so the bottom MLP can learn fast in
        # short smoke runs while the embeddings learn the id mapping
        hf = self._hot_frac(sparse).astype(np.float32)
        dense[:, 0] = hf - 0.5 + 0.3 * dense[:, 0]
        return {"dense": dense, "sparse": sparse}

    def labels(self, i: int,
               features: Optional[Dict[str, np.ndarray]] = None
               ) -> np.ndarray:
        """Simulated clicks for the i-th request batch, ``(batch, 1)``
        float32 — Bernoulli with p a fixed sigmoid of the sample's
        hot-lookup fraction. Stationary ground truth: drift moves WHICH
        ids are drawn, never what an id is worth."""
        feats = features if features is not None else self.request(i)
        hf = self._hot_frac(np.asarray(feats["sparse"]))
        p = 1.0 / (1.0 + np.exp(-(6.0 * hf - 1.5)))
        draws = self._rng(i, salt=7).random_sample(p.shape)
        return (draws < p).astype(np.float32).reshape(-1, 1)


class FeedbackSpool:
    """Bounded append-only join of served batches + click feedback, the
    training side of the closed loop (see module docstring).

    ``offer()`` is called by the serving driver (features + labels +
    optionally the served scores/step, kept for judging); ``source(i)``
    is handed to ``fit_stream`` and blocks until batch i lands (None
    once the spool is closed and drained — the stream's end). ``lag()``
    is landed-but-unconsumed batches, the freshness debt the scenarios
    budget."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"spool needs capacity >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._cond = threading.Condition()
        self._batches: list = []          # immutable landed batches
        self._closed = False
        self._consumed = 0
        self.offered = 0
        self.dropped_faults = 0
        self.dropped_overflow = 0

    def offer(self, features: Dict[str, np.ndarray],
              labels: np.ndarray, scores: Optional[np.ndarray] = None,
              step: Optional[int] = None) -> bool:
        """Join one served batch with its feedback; True when it landed.
        Dropped (and counted) on fault injection or when the spool is
        at capacity — feedback beyond the bound is lost, not queued
        forever, so a stalled trainer shows up as lag + loss, never as
        unbounded memory."""
        if faults.take_feedback_loss():
            with self._cond:
                self.offered += 1
                self.dropped_faults += 1
            return False
        batch = dict(features)
        batch["label"] = np.asarray(labels, np.float32)
        if scores is not None:
            batch["_served_scores"] = np.asarray(scores)
        if step is not None:
            batch["_trace_step"] = int(step)
        with self._cond:
            self.offered += 1
            if self._closed:
                self.dropped_overflow += 1
                return False
            if len(self._batches) - self._consumed >= self.capacity:
                self.dropped_overflow += 1
                return False
            self._batches.append(batch)
            self._cond.notify_all()
        return True

    def source(self, i: int, timeout_s: float = 30.0):
        """``fit_stream`` source: the i-th landed batch (training keys
        only), blocking until it lands; None ends the stream once the
        spool is closed and drained (or nothing landed for
        ``timeout_s`` — a wedged serving side must not hang the trainer
        forever)."""
        import time as _time
        deadline = _time.monotonic() + timeout_s
        with self._cond:
            while len(self._batches) <= i:
                if self._closed:
                    return None
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    log_replay.warning(
                        "feedback spool: batch %d never landed within "
                        "%.0fs; ending the training stream", i,
                        timeout_s)
                    return None
                self._cond.wait(min(remaining, 0.1))
            batch = self._batches[i]
            self._consumed = max(self._consumed, i + 1)
        return {k: v for k, v in batch.items()
                if not k.startswith("_")}

    def served(self, i: int) -> Optional[Dict[str, Any]]:
        """The i-th landed batch WITH its judge-only keys (scores,
        trace step), or None — the scenario judge reads AUC from these."""
        with self._cond:
            if i >= len(self._batches):
                return None
            return self._batches[i]

    def lag(self) -> int:
        with self._cond:
            return len(self._batches) - self._consumed

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {"offered": self.offered,
                    "landed": len(self._batches),
                    "consumed": self._consumed,
                    "lag": len(self._batches) - self._consumed,
                    "dropped_faults": self.dropped_faults,
                    "dropped_overflow": self.dropped_overflow}
