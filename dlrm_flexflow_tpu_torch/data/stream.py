"""Streaming data sources for the continual-learning loop (the port's own
copy of ``dlrm_flexflow_tpu.data.stream``: numpy only, the same batches
for the same arguments).

``FFModel.fit_stream`` consumes a plain callable ``source(i) -> batch``
(a host feature dict including ``"label"``); this module provides the
common case. Sources are DETERMINISTIC in ``i`` — the prefetch ring
may re-produce an index after a drain, and a resumed stream re-enters
at a recorded position, so ``source(i)`` must return the same batch
both times.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ArrayStream:
    """An endless (or ``max_steps``-bounded) batch stream over in-memory
    arrays: epoch-wise shuffled passes, reshuffled per epoch from a
    fixed seed — batch ``i`` is a pure function of ``(seed, i)``, so the
    stream is exactly resumable at any position.
    """

    def __init__(self, inputs: Dict[str, np.ndarray], labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 max_steps: Optional[int] = None):
        self.inputs = {k: np.asarray(v) for k, v in inputs.items()}
        self.labels = np.asarray(labels)
        self.batch_size = int(batch_size)
        n = len(self.labels)
        if n < self.batch_size:
            raise ValueError(
                f"dataset has {n} samples < batch size {self.batch_size}")
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.max_steps = max_steps
        self._per_epoch = n // self.batch_size
        self._n = n
        # one epoch's permutation is cached; i is monotone in practice
        self._perm_epoch = -1
        self._perm: Optional[np.ndarray] = None

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if epoch != self._perm_epoch:
            if self.shuffle:
                rng = np.random.RandomState(
                    (self.seed + epoch) % (2 ** 31))
                self._perm = rng.permutation(self._n)
            else:
                self._perm = np.arange(self._n)
            self._perm_epoch = epoch
        return self._perm

    def __call__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        if self.max_steps is not None and i >= self.max_steps:
            return None
        epoch, b = divmod(int(i), self._per_epoch)
        sel = self._epoch_perm(epoch)[b * self.batch_size:
                                      (b + 1) * self.batch_size]
        batch = {k: v[sel] for k, v in self.inputs.items()}
        batch["label"] = self.labels[sel]
        return batch
