"""The serving shard tier's warm cache (the part of
``dlrm_flexflow_tpu.utils.warmcache`` the port needs so far).

:class:`ShardCache` persists each embedding shard's row blocks (one npz
per (nshards, slot)) on every publish, so the tier's replace-dead path
boots a replacement lookup shard warm, version and chain-CRC validated,
instead of re-slicing a full checkpoint. The npz layout is the JAX
package's, key for key (``block/<op>``, ``scale/``, ``qdt/`` and
``sbd/`` for a quantized block, ``meta/*`` and a ``meta/crc32`` over the
sorted members), so each package reads the other's entries. A tier
geometry sidecar (``shard-<n>x.meta.json``) sits beside them.

The cache fails OPEN with a named reason: a missing, torn, CRC-failing,
foreign (fingerprint) or wrong-geometry entry is a miss with
``last_reject`` set, and the caller rebuilds cold. ``FF_FAULT_CACHE_
CORRUPT=n`` truncates the next n entries as they are read;
``FF_FAULT_QUANT_SCALE=op:f`` scales a quantized block's scales as it
loads, which the scale check then rejects.

The JAX package's ``PlanCache`` and ``CompileCache`` (strategy plans and
serialized XLA executables) port with ROADMAP queue 1 items 8 and 9.5.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, Optional

import numpy as np

from .logging import get_logger

log_cache = get_logger("warmcache")

# the directory a checkpoint manager's warm caches live in, beside its
# manifest (the JAX ``CheckpointManager.CACHE_DIR``)
CACHE_DIR = "cache"


def _quant_parts(block):
    """A quantized block's npz parts (codes as stored, fp32 scales,
    dtype) as host arrays, or None for a dense fp32 block."""
    from ..quant.store import QuantTable
    if not isinstance(block, QuantTable):
        return None
    return (block.encoded().cpu().numpy(),
            block.scales.cpu().numpy().astype(np.float32), block.dtype)


class ShardCache:
    """Persisted embedding-shard row blocks for the serving shard tier:
    one npz per (nshards, slot) carrying the shard's per-op row blocks,
    its applied version and its publish chain CRC. Dense blocks come back
    as fp32 numpy arrays, quantized ones as a ``QuantTable`` on the CPU
    (the tier moves it to its device)."""

    def __init__(self, directory: str, fingerprint: str = ""):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.fingerprint = fingerprint
        self.hits = 0
        self.misses = 0
        self.rejects = 0
        self.puts = 0
        self.put_errors = 0
        self.last_reject = ""

    def _path(self, nshards: int, slot: int) -> str:
        return os.path.join(self.directory, f"shard-{nshards}x-{slot}.npz")

    def _reject(self, reason: str) -> None:
        self.rejects += 1
        self.last_reject = reason
        log_cache.warning("shard cache: %s — replacement shard must "
                          "rebuild cold", reason)

    def _write_atomic(self, path: str, write) -> bool:
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                write(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except Exception as e:   # noqa: BLE001 — full disk, permissions
            try:
                os.unlink(tmp)
            except OSError:
                pass
            self.put_errors += 1
            log_cache.warning("shard cache write failed (%s)", e)
            return False
        self.puts += 1
        return True

    def put(self, nshards: int, slot: int, blocks: Dict[str, Any],
            version: int, chain_crc: int) -> bool:
        """Atomically persist one shard's blocks (temp file, fsync,
        ``os.replace``). Best-effort: a failed put costs the next
        replacement a cold rebuild, nothing else."""
        flat: Dict[str, np.ndarray] = {}
        for k, v in blocks.items():
            parts = _quant_parts(v)
            if parts is not None:
                # codes + row scales + dtype, bit-exact; the max-scale
                # bound lets get() reject scale corruption the CRC of a
                # file written from corrupt memory cannot see
                codes, scales, dt = parts
                flat[f"block/{k}"] = codes
                flat[f"scale/{k}"] = scales
                flat[f"qdt/{k}"] = np.asarray(dt)
                flat[f"sbd/{k}"] = np.asarray(
                    float(scales.max()) if scales.size else 0.0, np.float32)
            else:
                flat[f"block/{k}"] = np.ascontiguousarray(v)
        flat["meta/version"] = np.asarray(version, np.int64)
        flat["meta/chain_crc"] = np.asarray(chain_crc & 0xFFFFFFFF, np.int64)
        flat["meta/nshards"] = np.asarray(nshards, np.int64)
        flat["meta/slot"] = np.asarray(slot, np.int64)
        if self.fingerprint:
            flat["meta/fingerprint"] = np.frombuffer(
                self.fingerprint.encode(), np.uint8)
        crc = 0
        for k in sorted(flat):
            crc = zlib.crc32(k.encode(), crc)
            crc = zlib.crc32(np.ascontiguousarray(flat[k]), crc)
        flat["meta/crc32"] = np.asarray(crc, np.int64)
        return self._write_atomic(self._path(nshards, slot),
                                  lambda f: np.savez(f, **flat))

    def get(self, nshards: int, slot: int):
        """(blocks, version, chain_crc), or None with the reason
        recorded. The corrupt-cache fault hook fires here."""
        from . import faults
        path = self._path(nshards, slot)
        if not os.path.isfile(path):
            self.misses += 1
            return None
        name = os.path.basename(path)
        try:
            faults.maybe_corrupt_cache(path)
            with np.load(path) as npz:
                data = {k: npz[k] for k in npz.files}
            files = set(data)
            stored_crc = int(data["meta/crc32"])
            crc = 0
            for k in sorted(files - {"meta/crc32"}):
                crc = zlib.crc32(k.encode(), crc)
                crc = zlib.crc32(np.ascontiguousarray(data[k]), crc)
            if crc != stored_crc:
                raise ValueError("entry CRC mismatch (torn write / bit rot)")
            if self.fingerprint and "meta/fingerprint" in files:
                fp = bytes(data["meta/fingerprint"]).decode()
                if fp != self.fingerprint:
                    raise ValueError(
                        f"foreign fingerprint {fp} != {self.fingerprint} "
                        f"(differently-built model)")
            if (int(data["meta/nshards"]) != nshards
                    or int(data["meta/slot"]) != slot):
                raise ValueError(
                    f"geometry mismatch: entry is shard "
                    f"{int(data['meta/slot'])}/{int(data['meta/nshards'])}, "
                    f"wanted {slot}/{nshards}")
            from ..quant.codec import validate_scales
            from ..quant.store import QuantTable
            blocks: Dict[str, Any] = {}
            for k in files:
                if not k.startswith("block/"):
                    continue
                op = k[len("block/"):]
                if f"scale/{op}" in files:
                    # a corrupt scale rejects the entry (a cold rebuild),
                    # never boots a shard serving amplified rows
                    scales = faults.maybe_corrupt_quant_scale(
                        op, np.array(data[f"scale/{op}"]))
                    bound = (float(data[f"sbd/{op}"])
                             if f"sbd/{op}" in files else None)
                    validate_scales(op, scales, bound)
                    blocks[op] = QuantTable.from_encoded(
                        np.array(data[k]), scales, str(data[f"qdt/{op}"]))
                else:
                    blocks[op] = np.array(data[k])
            version = int(data["meta/version"])
            chain_crc = int(data["meta/chain_crc"])
        except Exception as e:   # noqa: BLE001 — torn npz, bad meta
            self._reject(f"{name}: {e}")
            self.misses += 1
            return None
        self.hits += 1
        return blocks, version, chain_crc

    # --- the tier-geometry sidecar -------------------------------------
    def _meta_path(self, nshards: int) -> str:
        return os.path.join(self.directory, f"shard-{nshards}x.meta.json")

    def put_meta(self, nshards: int, meta: Dict[str, Any]) -> bool:
        """Atomically persist the tier geometry. Best-effort, as
        :meth:`put`."""
        doc = dict(meta)
        if self.fingerprint:
            doc.setdefault("fingerprint", self.fingerprint)
        blob = json.dumps(doc, sort_keys=True).encode()
        return self._write_atomic(self._meta_path(nshards),
                                  lambda f: f.write(blob))

    def get_meta(self, nshards: int) -> Optional[Dict[str, Any]]:
        """The tier geometry, or None with the reason recorded (torn
        JSON, foreign fingerprint, wrong shard count)."""
        path = self._meta_path(nshards)
        if not os.path.isfile(path):
            self.misses += 1
            return None
        name = os.path.basename(path)
        try:
            with open(path) as f:
                meta = json.load(f)
            if not isinstance(meta, dict):
                raise ValueError("meta is not a JSON object")
            if int(meta.get("nshards", nshards)) != nshards:
                raise ValueError(f"meta is for {meta.get('nshards')} "
                                 f"shard(s), wanted {nshards}")
            fp = str(meta.get("fingerprint", ""))
            if self.fingerprint and fp and fp != self.fingerprint:
                raise ValueError(
                    f"foreign fingerprint {fp} != {self.fingerprint} "
                    f"(differently-built model)")
        except Exception as e:   # noqa: BLE001 — torn or invalid JSON
            self._reject(f"{name}: {e}")
            self.misses += 1
            return None
        self.hits += 1
        return meta

    def stats(self) -> Dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "rejects": self.rejects, "puts": self.puts,
                "put_errors": self.put_errors,
                "last_reject": self.last_reject}


def cache_dir_for(checkpoint_dir: Optional[str],
                  configured: str = "") -> Optional[str]:
    """The warm-cache directory a config knob names: ``""`` is off,
    ``"auto"`` is ``<checkpoint_dir>/cache`` when there is a checkpoint
    directory (else off), anything else is that path."""
    if not configured:
        return None
    if configured == "auto":
        if not checkpoint_dir:
            return None
        return os.path.join(os.path.abspath(checkpoint_dir), CACHE_DIR)
    return os.path.abspath(configured)
