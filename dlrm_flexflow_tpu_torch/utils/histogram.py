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
