"""Host-side batch helpers (own copies of the helpers of
``dlrm_flexflow_tpu.data.dataloader`` that the serving path needs; the
port imports nothing of the JAX package)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def coalesce_batches(batches):
    """Concatenate a list of same-keyed host feature dicts along the
    sample dim into ONE batch — the serving engine's request
    coalescing. Ragged keys or per-sample shapes/dtypes fail here with
    the offending key."""
    if not batches:
        raise ValueError("coalesce_batches needs at least one batch")
    keys = set(batches[0])
    for i, b in enumerate(batches[1:], 1):
        if set(b) != keys:
            raise ValueError(
                f"batch {i} keys {sorted(b)} differ from batch 0 keys "
                f"{sorted(keys)}; coalesced requests must be homogeneous")
    out = {}
    for k in batches[0]:
        arrs = [np.asarray(b[k]) for b in batches]
        if any(a.shape[1:] != arrs[0].shape[1:] or a.dtype != arrs[0].dtype
               for a in arrs[1:]):
            raise ValueError(
                f"input {k!r} has ragged per-sample shapes/dtypes across "
                f"requests; cannot coalesce into one batch")
        out[k] = (arrs[0] if len(arrs) == 1
                  else np.concatenate(arrs, axis=0))
    return out


def pad_batch_rows(batch, rows: int):
    """Zero-pad every array's sample dim up to `rows` (the serving
    bucket). Zeros are in-domain: float features pad with 0.0, ids with
    row 0; the padded samples' outputs are discarded by
    ``FFModel.forward_bucket``."""
    n = int(next(iter(batch.values())).shape[0])
    if rows < n:
        raise ValueError(f"pad_batch_rows: target {rows} < batch rows {n}")
    if rows == n:
        return batch
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        pad = np.zeros((rows - n,) + v.shape[1:], v.dtype)
        out[k] = np.concatenate([v, pad], axis=0)
    return out


_ZIPF_CDF_CACHE: Dict[tuple, np.ndarray] = {}


def zipf_indices(rng: np.random.RandomState, rows: int, size,
                 alpha: float) -> np.ndarray:
    """Draw ids in [0, rows) with p(k) ∝ 1/(k+1)^alpha via the inverse
    CDF (cached per (rows, alpha)). alpha <= 0 draws uniformly with
    ``rng.randint``, so seeded data match the JAX package's draws."""
    if alpha <= 0.0:
        return rng.randint(0, rows, size=size)
    key = (int(rows), float(alpha))
    cdf = _ZIPF_CDF_CACHE.get(key)
    if cdf is None:
        p = 1.0 / np.power(np.arange(1, rows + 1, dtype=np.float64),
                           float(alpha))
        cdf = np.cumsum(p)
        cdf /= cdf[-1]
        _ZIPF_CDF_CACHE[key] = cdf
    n = int(np.prod(size))
    draws = np.searchsorted(cdf, rng.random_sample(n), side="right")
    return draws.reshape(size).astype(np.int64)
