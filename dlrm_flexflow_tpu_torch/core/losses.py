"""Loss functions (the counterpart of ``dlrm_flexflow_tpu.core.losses``).

Sparse categorical cross-entropy, categorical cross-entropy and mean
squared error, each averaged over the batch, so the gradients carry the
reference's 1/batch scaling. MSE is the per-sample SUM of squared
errors, averaged over the batch (the reference's mseloss_backward
writes 2·(pred − label)/batch).
"""

from __future__ import annotations

import torch

LOSS_CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
LOSS_SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
LOSS_MEAN_SQUARED_ERROR = "mean_squared_error"
_ALIASES = {
    "mse": LOSS_MEAN_SQUARED_ERROR,
    "mean_squared_error_avg_reduce": LOSS_MEAN_SQUARED_ERROR,
    "cce": LOSS_CATEGORICAL_CROSSENTROPY,
    "scce": LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
}


def canonical_loss(name: str) -> str:
    name = name.lower()
    name = _ALIASES.get(name, name)
    if name not in (LOSS_CATEGORICAL_CROSSENTROPY,
                    LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                    LOSS_MEAN_SQUARED_ERROR):
        raise ValueError(f"unknown loss type: {name}")
    return name


def sparse_categorical_crossentropy(logits, labels):
    """labels: int, as many elements as logit rows; logits (..., C)."""
    logits2 = logits.reshape(-1, logits.shape[-1])
    labels = labels.long().reshape(-1)
    logp = torch.log_softmax(logits2.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    return nll.mean()


def categorical_crossentropy(logits, labels):
    """Dense one-hot labels (batch, C)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(labels * logp).sum(dim=-1).mean()


def mean_squared_error(preds, labels):
    d = preds.float() - labels.float()
    per_sample = (d * d).reshape(d.shape[0], -1).sum(dim=-1)
    return per_sample.mean()


def loss_fn(loss_type: str):
    return {
        LOSS_SPARSE_CATEGORICAL_CROSSENTROPY: sparse_categorical_crossentropy,
        LOSS_CATEGORICAL_CROSSENTROPY: categorical_crossentropy,
        LOSS_MEAN_SQUARED_ERROR: mean_squared_error,
    }[canonical_loss(loss_type)]
