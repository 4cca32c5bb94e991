"""Training metrics (the counterpart of ``dlrm_flexflow_tpu.core.metrics``).

``compute_metrics`` returns per-batch SUMS (plus the sample count
``train_all``) as 0-d tensors on the batch's device, so epochs
accumulate on the device without a host sync; ``PerfMetrics`` folds them
and syncs only in ``report``/``summary_line``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch

METRICS_ACCURACY = "accuracy"
METRICS_CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
METRICS_SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
METRICS_MEAN_SQUARED_ERROR = "mean_squared_error"
METRICS_ROOT_MEAN_SQUARED_ERROR = "root_mean_squared_error"
METRICS_MEAN_ABSOLUTE_ERROR = "mean_absolute_error"

_ALIASES = {
    "acc": METRICS_ACCURACY,
    "mse": METRICS_MEAN_SQUARED_ERROR,
    "rmse": METRICS_ROOT_MEAN_SQUARED_ERROR,
    "mae": METRICS_MEAN_ABSOLUTE_ERROR,
    "cce": METRICS_CATEGORICAL_CROSSENTROPY,
    "scce": METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
}

ALL_METRICS = (METRICS_ACCURACY, METRICS_CATEGORICAL_CROSSENTROPY,
               METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
               METRICS_MEAN_SQUARED_ERROR, METRICS_ROOT_MEAN_SQUARED_ERROR,
               METRICS_MEAN_ABSOLUTE_ERROR)


def canonical_metrics(names: List[str]) -> List[str]:
    out = []
    for n in names:
        n = _ALIASES.get(n.lower(), n.lower())
        if n not in ALL_METRICS:
            raise ValueError(f"unknown metric: {n}")
        out.append(n)
    return out


def compute_metrics(metrics: List[str], loss_type: str, preds,
                    labels) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    preds32 = preds.float()
    labels32 = labels.float()
    batch = preds.shape[0]
    # a fill on the device: a host tensor copied in would make the host
    # wait for the stream
    out["train_all"] = torch.full((), float(batch), device=preds.device)

    sparse = "sparse" in loss_type
    for m in metrics:
        if m == METRICS_ACCURACY:
            if sparse:
                lab = labels.long().reshape(-1)
                correct = preds32.reshape(-1, preds32.shape[-1]).argmax(-1) \
                    == lab
            elif preds32.shape[-1] == 1:
                # regression-style accuracy: the rounded prediction
                correct = (preds32 - labels32).abs().reshape(
                    batch, -1).amax(dim=-1) < 0.5
            else:
                correct = preds32.argmax(-1) == labels32.argmax(-1)
            out["train_correct"] = correct.float().sum()
        elif m == METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
            lab = labels.long().reshape(-1)
            logp = torch.log(preds32.reshape(-1, preds32.shape[-1])
                             .clamp_min(1e-12))
            out["sparse_cce"] = -logp.gather(1, lab[:, None]).sum()
        elif m == METRICS_CATEGORICAL_CROSSENTROPY:
            logp = torch.log(preds32.clamp_min(1e-12))
            out["cce"] = -(labels32 * logp).sum()
        elif m == METRICS_MEAN_SQUARED_ERROR:
            out["mse"] = ((preds32 - labels32) ** 2).reshape(
                batch, -1).sum(-1).sum()
        elif m == METRICS_ROOT_MEAN_SQUARED_ERROR:
            out["rmse"] = ((preds32 - labels32) ** 2).reshape(
                batch, -1).sum(-1).sqrt().sum()
        elif m == METRICS_MEAN_ABSOLUTE_ERROR:
            out["mae"] = (preds32 - labels32).abs().reshape(
                batch, -1).sum(-1).sum()
    return out


@dataclass
class PerfMetrics:
    """Host-side view of the running metric sums."""

    sums: Dict[str, torch.Tensor] = field(default_factory=dict)

    def reset(self):
        self.sums.clear()

    def _host_sums(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.sums.items()}

    def report(self) -> Dict[str, float]:
        sums = self._host_sums()
        n = max(sums.get("train_all", 0.0), 1.0)
        out = {}
        for k, v in sums.items():
            if k == "train_all":
                out[k] = v
            elif k == "train_correct":
                out["accuracy"] = v / n
            else:
                out[k] = v / n
        return out

    def summary_line(self) -> str:
        rep = self.report()
        sums = self._host_sums()
        parts = []
        if "accuracy" in rep:
            parts.append(f"accuracy={rep['accuracy'] * 100.0:.2f}%"
                         f" ({int(sums.get('train_correct', 0))}"
                         f"/{int(sums.get('train_all', 0))})")
        for k in ("cce", "sparse_cce", "mse", "rmse", "mae"):
            if k in rep:
                parts.append(f"{k}={rep[k]:.6f}")
        return "[Metrics] " + " ".join(parts)
