"""Id-frequency sketches (own copy of
``dlrm_flexflow_tpu.utils.histogram``).

:class:`IdFrequencySketch` counts one embedding op's lookups over its
flat lookup-id space (table offset + row, the space
``op.flat_lookup_ids`` maps a batch into), exactly up to
``max_buckets`` ids and folded modulo the bucket count beyond. The
delta publisher's ``TouchedRowTracker`` observes every batch on the
staging thread, and a full publish writes the sketches as
``id_histogram.npz`` beside the manifest (:func:`save_histograms`). The
file is byte-for-byte the JAX package's layout (``<op>/counts`` int64,
``<op>/meta`` = [rows, buckets, total]), so the JAX package's
strategy search and serving cache warm-up read the port's file and
:func:`load_histograms` reads theirs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# beyond this many distinct ids the sketch folds (keeps memory ~8 MB per
# million tracked rows; DLRM-Terabyte's 40M-row tables fold 40x)
DEFAULT_MAX_BUCKETS = 1 << 20


class IdFrequencySketch:
    """Bounded exact-count histogram over one op's flat lookup-id space.
    Not thread-safe by itself; the ``TouchedRowTracker`` serializes
    ``observe`` on its own lock."""

    def __init__(self, rows: int, max_buckets: int = DEFAULT_MAX_BUCKETS,
                 counts: Optional[np.ndarray] = None, total: int = 0):
        self.rows = int(rows)
        self.buckets = min(self.rows, int(max_buckets))
        if self.buckets < 1:
            raise ValueError(f"sketch needs >= 1 row, got {rows}")
        self.counts = (np.zeros(self.buckets, np.int64) if counts is None
                       else np.asarray(counts, np.int64))
        if self.counts.shape != (self.buckets,):
            raise ValueError(
                f"counts shape {self.counts.shape} != ({self.buckets},)")
        self.total = int(total)

    @property
    def folded(self) -> bool:
        return self.buckets < self.rows

    def observe(self, flat_ids: np.ndarray) -> None:
        """Count one batch's flat lookup ids (any shape, wraps mod rows)."""
        f = np.asarray(flat_ids).reshape(-1).astype(np.int64) % self.rows
        if self.folded:
            f = f % self.buckets
        self.counts += np.bincount(f, minlength=self.buckets)
        self.total += int(f.size)

    def merge(self, other: "IdFrequencySketch") -> None:
        if (other.rows, other.buckets) != (self.rows, self.buckets):
            raise ValueError(
                f"cannot merge sketch over {other.rows}/{other.buckets} "
                f"into {self.rows}/{self.buckets}")
        self.counts += other.counts
        self.total += other.total

    def copy(self) -> "IdFrequencySketch":
        """Deep copy (the re-placement controller snapshots live
        sketches as the new search baseline at swap time)."""
        return IdFrequencySketch(self.rows, max_buckets=self.buckets,
                                 counts=self.counts.copy(),
                                 total=self.total)

    def reset(self) -> None:
        """Zero the observations in place (the live sketch rebases after
        an online re-placement so the drift gauge measures divergence
        from the NEW placement's baseline, not history)."""
        self.counts[:] = 0
        self.total = 0

    def _folded_probs(self, buckets: int) -> np.ndarray:
        """probs() folded down to ``buckets`` entries (mod fold, the
        same aliasing observe() applies) so two sketches over the same
        row space but different bucket budgets stay comparable."""
        p = self.probs()
        if p.size == buckets:
            return p
        if p.size < buckets or buckets < 1:
            raise ValueError(
                f"cannot fold {p.size} buckets down to {buckets}")
        idx = np.arange(p.size, dtype=np.int64) % buckets
        return np.bincount(idx, weights=p, minlength=buckets)

    def divergence(self, other: "IdFrequencySketch") -> float:
        """Total-variation distance between the two empirical
        distributions, in [0, 1] — THE online re-placement trigger: the
        live sketch diverging from the histogram the placement was
        searched with means the hot set moved. Zero while either side is
        unobserved (no evidence of drift is not drift: an empty live
        sketch reads uniform, and uniform-vs-zipf would otherwise fire
        the trigger before the first batch lands). Mismatched bucket
        budgets compare at the coarser fold; mismatched row spaces are
        structurally different ops and refuse."""
        if self.rows != other.rows:
            raise ValueError(
                f"cannot compare sketch over {self.rows} rows with one "
                f"over {other.rows}")
        if self.total <= 0 or other.total <= 0:
            return 0.0
        m = min(self.buckets, other.buckets)
        p = self._folded_probs(m)
        q = other._folded_probs(m)
        return float(0.5 * np.abs(p - q).sum())

    # --- the two quantities the cost model consumes --------------------
    def probs(self) -> np.ndarray:
        """Per-bucket empirical probabilities (uniform when unobserved —
        the structural default under which dedup ~= dense and hybrid
        never looks attractive, exactly right for unknown traffic)."""
        if self.total <= 0:
            return np.full(self.buckets, 1.0 / self.rows)
        return self.counts / float(self.total)

    def _hot_mask(self, hot_rows_per_table: int,
                  rows_per_table: Optional[int]) -> Optional[np.ndarray]:
        """Bucket mask of the hybrid placement's HOT set (within-table
        row < hot_rows_per_table), or None when no hot set applies."""
        h = int(hot_rows_per_table)
        if h <= 0:
            return None
        rpt = int(rows_per_table or self.rows)
        ids = np.arange(self.buckets, dtype=np.int64)
        return (ids % min(rpt, self.buckets)) < h

    def expected_distinct(self, n_draws: float,
                          hot_rows_per_table: int = 0,
                          rows_per_table: Optional[int] = None) -> float:
        """E[# distinct COLD ids among n iid draws] =
        sum_{i cold} 1 - (1 - p_i)^n.

        THE dedup quantity: the routed exchange carries one slot per
        distinct id, so its expected bytes scale with this, not with n.
        `hot_rows_per_table` excludes the hybrid placement's replicated
        head (those lookups never route at all). Computed with
        log1p/expm1 so million-row tails stay stable. Folded sketches
        under-count distinct ids (aliased rows merge) — the
        conservative direction would overprice dedup's win, so the
        estimate is clamped to at most n."""
        n = float(n_draws)
        if n <= 0:
            return 0.0
        hot = self._hot_mask(hot_rows_per_table, rows_per_table)
        if self.total <= 0:
            # uniform closed form over the true row count
            cold = self.rows
            if hot is not None:
                rpt = int(rows_per_table or self.rows)
                tables = max(self.rows // max(rpt, 1), 1)
                cold = self.rows - tables * int(hot_rows_per_table)
            per = -np.expm1(n * np.log1p(-1.0 / self.rows))
            return float(min(max(cold, 0) * per, n))
        p = self.probs()
        if hot is not None:
            p = np.where(hot, 0.0, p)
        nz = p[p > 0]
        e = float(np.sum(-np.expm1(n * np.log1p(-np.minimum(nz,
                                                            1.0 - 1e-12)))))
        return min(e, n)

    def hot_mass(self, hot_rows_per_table: int, rows_per_table: int,
                 tables: int = 1) -> float:
        """Probability mass of the HOT set: flat ids whose within-table
        row (id % rows_per_table) falls below ``hot_rows_per_table`` —
        the rows the hybrid placement actually replicates (the
        low-numbered ids; zipf generators and frequency-ordered
        preprocessed datasets put the hot ids there)."""
        h = int(hot_rows_per_table)
        if h <= 0:
            return 0.0
        if h >= rows_per_table:
            return 1.0
        ids = np.arange(self.buckets, dtype=np.int64)
        hot = (ids % rows_per_table) < h
        if self.total <= 0:
            return float(h) / float(rows_per_table)
        if self.folded:
            # folding aliases within-table positions only when the
            # bucket count is not a multiple of rows_per_table; the mask
            # over folded ids is the best available estimate
            hot = (ids % min(rows_per_table, self.buckets)) < h
        return float(self.counts[hot].sum()) / float(self.total)

    # --- serving / tests -----------------------------------------------
    def sample_range(self, rng: np.random.RandomState,
                     lo: int, hi: int, size) -> np.ndarray:
        """Draw table-LOCAL row ids in [0, hi-lo) from the observed
        distribution of the flat-id slice [lo, hi) — one table's range
        (the serving cache pre-warm builds likely request index tuples
        from these). Folded sketches whose fold cuts through the slice
        (and unobserved sketches) draw uniform."""
        lo, hi = int(lo), int(hi)
        span = max(hi - lo, 1)
        n = int(np.prod(size))
        c = None
        if self.total > 0 and hi <= self.buckets:
            c = self.counts[lo:hi].astype(np.float64)
            if c.sum() <= 0:
                c = None
        if c is None:
            return rng.randint(0, span, size=size).astype(np.int64)
        cdf = np.cumsum(c)
        cdf /= cdf[-1]
        out = np.searchsorted(cdf, rng.random_sample(n), side="right")
        return out.reshape(size).astype(np.int64)

    def sample(self, rng: np.random.RandomState, size) -> np.ndarray:
        """Draw flat ids from the empirical distribution (inverse CDF) —
        the serving cache pre-warm and the calibration harness use this.
        Unobserved sketches draw uniform."""
        n = int(np.prod(size))
        if self.total <= 0:
            out = rng.randint(0, self.rows, size=n)
        else:
            cdf = np.cumsum(self.counts.astype(np.float64))
            cdf /= cdf[-1]
            out = np.searchsorted(cdf, rng.random_sample(n), side="right")
        return out.reshape(size).astype(np.int64)


# --- persistence (the manifest's sidecar) -------------------------------

HISTOGRAM_FILE = "id_histogram.npz"


def save_histograms(path: str, sketches: Dict[str, IdFrequencySketch]
                    ) -> None:
    """Atomic npz of {op name -> sketch} (temp file, fsync,
    ``os.replace``, as every published file)."""
    import os
    flat: Dict[str, np.ndarray] = {}
    for name, sk in sketches.items():
        flat[f"{name}/counts"] = sk.counts
        flat[f"{name}/meta"] = np.asarray([sk.rows, sk.buckets, sk.total],
                                          np.int64)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def sketch_signature(sketches: Optional[Dict[str, IdFrequencySketch]]
                     ) -> str:
    """Short stable digest of a {op -> sketch} mapping (the JAX
    package's plan-cache key over observed traffic)."""
    import zlib
    if not sketches:
        return "none"
    crc = 0
    for name in sorted(sketches):
        sk = sketches[name]
        head = np.asarray([sk.rows, sk.buckets, sk.total], np.int64)
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(head.tobytes(), crc)
        crc = zlib.crc32(np.ascontiguousarray(sk.counts).tobytes(), crc)
    return f"{crc:08x}"


def load_histograms(path: str) -> Dict[str, IdFrequencySketch]:
    out: Dict[str, IdFrequencySketch] = {}
    with np.load(path) as data:
        for key in data.files:
            if not key.endswith("/meta"):
                continue
            name = key[:-len("/meta")]
            rows, buckets, total = (int(x) for x in data[key])
            out[name] = IdFrequencySketch(
                rows, max_buckets=buckets,
                counts=data[f"{name}/counts"], total=total)
    return out
