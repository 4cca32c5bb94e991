"""Retrieve -> rank cascade: two stages, one deadline budget (the
counterpart of ``dlrm_flexflow_tpu.retrieve.cascade``).

``CascadeEngine.predict`` encodes the user, takes the MIPS top-k over
the sharded index (``retrieve.index``), expands the k candidates into
ranker rows, scores them through the ranker (an ``InferenceEngine``:
dynamic batching, buckets) and re-ranks by the ranker's scores.

The retrieve stage gets ``min(retrieve_deadline_ms, what is left)``;
the ranker gets the rest; overrunning raises the serving tier's own
``DeadlineExceeded``. A dead index shard drops its candidates (flagged);
the cascade's ``degraded`` is the OR of both stages'.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np

from ..serve.engine import DeadlineExceeded
from ..utils.watchdog import Deadline
from .index import ShardedMIPSIndex


@dataclass
class CascadeConfig:
    """Cascade knobs; ``from_config`` lifts the ``--retrieve-*``
    flags."""

    k: int = 100                         # candidates out of retrieval
    retrieve_deadline_ms: float = 25.0   # retrieve-stage budget
    deadline_ms: float = 0.0             # end-to-end budget; 0 = none

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"retrieve k must be >= 1, got {self.k}")
        if self.retrieve_deadline_ms < 0:
            raise ValueError("retrieve deadline must be >= 0")

    @staticmethod
    def from_config(cfg) -> "CascadeConfig":
        return CascadeConfig(
            k=int(getattr(cfg, "retrieve_k", 100)),
            retrieve_deadline_ms=float(
                getattr(cfg, "retrieve_deadline_ms", 25.0)),
            deadline_ms=float(getattr(cfg, "serve_deadline_ms", 0.0)))


class CascadePrediction(NamedTuple):
    """One answered user request: the re-ranked candidate ids and both
    stages' receipts."""

    ids: np.ndarray                  # (B, k') int64, ranker order
    scores: np.ndarray               # (B, k') fp32 ranker scores, desc
    retrieve_scores: np.ndarray      # (B, k') fp32 MIPS scores, aligned
    #                                  with ids (NOT retrieval order)
    retrieve_versions: Dict[int, int]
    rank_version: int
    rank_versions: Optional[Dict[int, int]]
    degraded: bool
    dropped_slots: List[int]
    latency_ms: float
    stage_ms: Dict[str, float]       # {"retrieve": ..., "rank": ...}


def dlrm_candidate_features(n_tables: int, table_rows: List[int],
                            candidate_slot: int = 0
                            ) -> Callable[[Dict[str, np.ndarray],
                                           np.ndarray],
                                          Dict[str, np.ndarray]]:
    """Default candidate expansion for a DLRM ranker: tile each user's
    'dense'/'sparse' row k times and write the candidate id into sparse
    slot ``candidate_slot`` (mod that table's vocabulary)."""
    rows = int(table_rows[candidate_slot])

    def expand(features: Dict[str, np.ndarray], ids: np.ndarray
               ) -> Dict[str, np.ndarray]:
        B, k = ids.shape
        dense = np.repeat(np.asarray(features["dense"], np.float32),
                          k, axis=0)
        sparse = np.repeat(np.asarray(features["sparse"], np.int32),
                           k, axis=0).copy()
        sparse[:, candidate_slot, :] = (
            ids.reshape(B * k, 1) % rows).astype(np.int32)
        return {"dense": dense, "sparse": sparse}

    return expand


class CascadeEngine:
    """retrieve -> expand -> rank -> re-rank, behind one ``predict``.

    ``user_encoder`` maps the request's features to (B, d) fp32 user
    embeddings; ``ranker`` has the serving tier's ``predict(features,
    timeout=) -> Prediction`` shape; ``candidate_features`` expands
    (user features, (B, k) ids) into the ranker's B*k-row features."""

    def __init__(self, index: ShardedMIPSIndex,
                 user_encoder: Callable[[Dict[str, np.ndarray]], Any],
                 ranker: Any,
                 candidate_features: Callable[[Dict[str, np.ndarray],
                                               np.ndarray],
                                              Dict[str, np.ndarray]],
                 config: Optional[CascadeConfig] = None):
        self.index = index
        self.user_encoder = user_encoder
        self.ranker = ranker
        self.candidate_features = candidate_features
        self.config = config or CascadeConfig()
        # the counters are read-modify-written by every caller's thread
        self._lock = threading.Lock()
        self.requests = 0
        self.degraded_requests = 0
        self.deadline_misses = 0

    def _count(self, degraded: bool = False, miss: bool = False) -> None:
        with self._lock:
            if miss:
                self.deadline_misses += 1
                return
            self.requests += 1
            self.degraded_requests += int(degraded)

    def predict(self, features: Dict[str, np.ndarray],
                timeout: Optional[float] = None) -> CascadePrediction:
        """Answer one user batch end to end. ``timeout`` (seconds)
        overrides the configured end-to-end budget for this request."""
        t0 = time.perf_counter()
        budget_s = (timeout if timeout is not None
                    else (self.config.deadline_ms / 1e3
                          if self.config.deadline_ms > 0 else 0.0))
        dl = Deadline(budget_s)   # seconds <= 0 = never expires

        # --- stage 1: retrieve -----------------------------------------
        user_emb = self.user_encoder(features)
        stage_budget = self.config.retrieve_deadline_ms / 1e3
        rem = dl.remaining()
        if rem != float("inf"):
            if rem <= 0:
                self._count(miss=True)
                raise DeadlineExceeded(dl.report(
                    worker="ff-cascade",
                    waiting_for="the retrieve stage to start",
                    detail="budget spent encoding the user"))
            stage_budget = min(stage_budget, rem)
        r = self.index.topk(user_emb, self.config.k,
                            deadline_s=stage_budget)
        t_retrieve = time.perf_counter()
        if r.ids.shape[1] == 0:
            self._count(degraded=True)
            return CascadePrediction(
                r.ids, np.empty_like(r.scores), r.scores, r.versions,
                -1, None, True, r.dropped_slots,
                1e3 * (time.perf_counter() - t0),
                {"retrieve": 1e3 * (t_retrieve - t0), "rank": 0.0})

        # --- stage 2: rank ---------------------------------------------
        rem = dl.remaining()
        if rem <= 0:
            self._count(miss=True)
            raise DeadlineExceeded(dl.report(
                worker="ff-cascade",
                waiting_for="ranker budget after the retrieve stage",
                detail=f"retrieve took {r.latency_ms:.1f}ms"))
        cand = self.candidate_features(features, r.ids)
        pred = self.ranker.predict(
            cand, timeout=None if rem == float("inf") else rem)
        t_rank = time.perf_counter()

        # --- re-rank: ranker scores decide the final order --------------
        B, k = r.ids.shape
        # unit 0 of a multi-unit head is the ranking score
        flat = np.asarray(pred.scores, np.float32)
        flat = flat.reshape(B, k, -1)[:, :, 0]
        # (score desc, retrieval rank asc): deterministic on ranker ties
        order = np.lexsort((np.broadcast_to(np.arange(k), (B, k)),
                            -flat), axis=1)
        take = np.take_along_axis
        degraded = bool(r.degraded or pred.degraded)
        self._count(degraded=degraded)
        return CascadePrediction(
            take(r.ids, order, 1), take(flat, order, 1),
            take(r.scores, order, 1), r.versions,
            pred.version, pred.versions, degraded, r.dropped_slots,
            1e3 * (time.perf_counter() - t0),
            {"retrieve": 1e3 * (t_retrieve - t0),
             "rank": 1e3 * (t_rank - t_retrieve)})

    def stats(self) -> Dict[str, Any]:
        return {
            "requests": self.requests,
            "degraded_requests": self.degraded_requests,
            "deadline_misses": self.deadline_misses,
            "index": self.index.stats(),
        }
