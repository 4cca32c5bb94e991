"""Crash-safe delta publication for the continual train -> serve loop
(the port of ``dlrm_flexflow_tpu.utils.delta``).

The trainer publishes **delta snapshots** — the table rows its batches
changed plus the small dense arrays — chained off a rolling full
checkpoint; the serving ``serve.watcher.SnapshotWatcher`` applies them
with ``FFModel.apply_delta`` instead of reloading every parameter.

Files and manifest entries are the JAX package's, key for key:

- a delta is one ``.npz`` with ``meta/step``, ``meta/prev_step``,
  ``meta/base_step``, ``idx/<key>`` (int64 row indices) and
  ``rows/<key>`` (their values) for each row-updated array, and
  ``full/<key>`` for each array shipped whole; keys and row indices are
  in the JAX stored layout (``params/<op>/<param>``, a stacked table
  lane-packed as (T, rows/r, r·d) and flattened to 2-D), which
  ``utils.weights.rows_from_jax`` maps back onto the port's tensors;
- the chain lives in the checkpoints' ``manifest.json`` under
  ``"deltas"``, each entry carrying its base snapshot's step and CRC-32,
  its own CRC-32, the previous chain step and per-array row counts, so
  each package's ``resolve_chain`` validates the other's chain;
- every file is written atomically and BEFORE its manifest entry;
- when the chain outgrows ``compact_frac`` of its base (or ``max_chain``
  links, or ``full_every`` deltas), the next publish is a full
  checkpoint that retires the chain (a compaction).

Touched-row tracking: ``fit_stream`` shows each batch to the
:class:`TouchedRowTracker` before staging it; the publisher diffs only
those candidate rows against the last published state, and diffs every
row where candidates are missing or incomplete (a table on the dense
update, a batch the tracker never saw), so a delta is always exact.

Across ranks (a trainer on a mesh of several ranks) every rank makes
the publisher over the same directory and calls it at the same steps:
``serving_flat`` joins each parameter from the ranks' pieces on rank 0
(``checkpoint.whole_jax``), which alone diffs, writes and keeps the
manifest, so the files, arrays and entries are the JAX package's mesh
run's; rank 0's choice between a delta and a full publish is broadcast.
A row-sharded table's candidates are its cold rows only (offset by the
hybrid's hot rows, packed), as the JAX op's; the hot head is diffed
whole.

Host-resident tables publish too: the tracker's candidates for a host
table are its ``hostparams/<op>/kernel`` rows (a host update is always
touched-rows-only), and ``FFModel.apply_delta`` writes them in place.
The serving shard tier routes a delta per shard
(:func:`split_host_rows_by_shard`, :func:`shard_slice_crc`,
:func:`shard_chain_crc`; the CRCs equal the JAX package's integer for
integer). Under a quantized storage policy (``quant/``) a table's row
payloads ship as codes and per-row fp32 scales (``rows/`` at one byte a
value, ``scl/``, ``qdt/`` the dtype, ``sbd/`` the publish-time bound of
the scales), as the JAX package writes them; the loader validates the
scales (a corrupt one is a ``ChainError``, never served; the
``FF_FAULT_QUANT_SCALE`` hook drills it) and dequantizes.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import metrics as obsm
from ..obs import trace as obstrace
from . import faults
from .checkpoint import (CheckpointManager, _file_crc32, _flatten,
                         _write_npz_atomic, config_fingerprint, mesh_meta,
                         read_npz, whole_jax)
from .logging import get_logger
from .weights import params_to_jax, rows_from_jax

log_delta = get_logger("delta")

# arrays below this element count are cheaper to ship whole than to
# row-diff and index; only arrays at or above it (with >= 2 dims) get
# the touched-rows treatment
ROW_DELTA_MIN_ELEMS = 16384

_SERVING_SECTIONS = ("params", "state", "hostparams")


class ChainError(ValueError):
    """A delta chain failed validation (gap, torn file, replaced or
    missing base, foreign fingerprint). The watcher rejects it with the
    reason and falls back to a full reload."""


def serving_flat(model) -> Optional[Dict[str, np.ndarray]]:
    """The serving state of a model (its parameters and host tables; the
    port has no op state) as host arrays keyed and laid out as in the
    checkpoint npz. The arrays own their bytes: the trainer keeps
    updating its tensors and host tables in place. Across ranks every
    rank calls it; rank 0 gets the whole arrays, the others None."""
    copy = model.device.type == "cpu"
    params = whole_jax(model, params_to_jax(model, model.params), copy)
    if params is None:
        return None
    out = {f"params/{k}": v for k, v in _flatten(params).items()}
    if model.host_params:
        model._host_drain()
        with model._host_table_lock:
            for k, v in _flatten(model.host_params).items():
                out[f"hostparams/{k}"] = np.array(v)
    return out


def _row_view(arr: np.ndarray) -> np.ndarray:
    """Stored array -> 2-D (rows, width) view over all-but-last axes."""
    return arr.reshape(-1, arr.shape[-1])


def _row_eligible(arr: np.ndarray, min_elems: int) -> bool:
    return arr.ndim >= 2 and arr.size >= min_elems and arr.shape[-1] > 0


def _sparse_update_active(op) -> bool:
    """Whether ``op``'s table takes the touched-rows update (as
    ``FFModel._select_sparse_update_ops`` decides; an optimizer not set
    yet counts as plain SGD)."""
    from ..core.optimizers import AdamOptimizer, SGDOptimizer
    if not op.model.config.sparse_embedding_update:
        return False
    if not op.supports_sparse_update():
        return False
    opt = op.model.optimizer
    return opt is None or isinstance(opt, (SGDOptimizer, AdamOptimizer))


class TouchedRowTracker:
    """Accumulates, per flat state key, the stored rows the training
    batches since the tracker started MAY have updated.

    ``observe(batch)`` runs on the staging thread (cheap numpy); the
    publisher calls ``snapshot()`` on the training thread. The set is
    cumulative over the tracker's life: the prefetch ring observes
    batches ahead of training, so a per-interval set could not tell
    which were trained; a cumulative set is a superset of the rows
    changed since any publish, the safe direction. Only tables on the
    touched-rows update are tracked; everything else is diffed whole.
    The same ``observe`` feeds one id-frequency sketch per embedding op
    (``utils/histogram.py``)."""

    def __init__(self, model):
        from .histogram import IdFrequencySketch
        self.model = model
        self._lock = threading.Lock()
        self._merged: Dict[str, np.ndarray] = {}
        self._pending: Dict[str, List[np.ndarray]] = {}
        self._batches = 0
        # (op, input name, flat key, host table?): a host table's update
        # is always touched-rows-only; a device table is tracked only on
        # the touched-rows update
        hres = {op.name for op in model._host_resident_list}
        self._tracked = []
        for op in model.ops:
            if not op.inputs or not hasattr(op, "delta_touched_rows"):
                continue
            if op.name in hres:
                self._tracked.append((op, op.inputs[0].name,
                                      f"hostparams/{op.name}/kernel", True))
            elif _sparse_update_active(op):
                self._tracked.append((op, op.inputs[0].name,
                                      f"params/{op.name}/kernel", False))
        self._sketch_ops = [(op, op.inputs[0].name) for op in model.ops
                            if op.inputs and hasattr(op, "flat_lookup_ids")]
        self._sketches = {op.name: IdFrequencySketch(op.lookup_id_space())
                          for op, _ in self._sketch_ops}

    def observe(self, batch: Dict[str, np.ndarray]) -> None:
        """Record one (about to be trained) host batch's candidates."""
        adds = [(key, op.host_delta_touched_rows(batch[name]) if host
                 else op.delta_touched_rows(batch[name]))
                for op, name, key, host in self._tracked if name in batch]
        flats = [(op.name, op.flat_lookup_ids(batch[name]))
                 for op, name in self._sketch_ops if name in batch]
        with self._lock:
            self._batches += 1
            for key, rows in adds:
                self._pending.setdefault(key, []).append(rows)
            for name, ids in flats:
                self._sketches[name].observe(ids)

    def id_histograms(self) -> Dict[str, Any]:
        """The per-op sketches observed so far (live references)."""
        with self._lock:
            return dict(self._sketches)

    def snapshot(self) -> Tuple[Dict[str, np.ndarray], int]:
        """Merge the pending observations; return a copy of the
        cumulative candidate sets and the batches observed. Nothing is
        cleared: a failed publish needs the same candidates again."""
        with self._lock:
            pending, self._pending = self._pending, {}
            batches = self._batches
        for k, v in pending.items():
            prev = self._merged.get(k)
            parts = ([prev] if prev is not None else []) + v
            self._merged[k] = np.unique(np.concatenate(parts))
        return dict(self._merged), batches


def _diff_flat(prev: Dict[str, np.ndarray], cur: Dict[str, np.ndarray],
               candidates: Optional[Dict[str, np.ndarray]],
               min_elems: int):
    """Exact diff of two ``serving_flat`` states: (rows, full, counts),
    ``rows[key] = (idx, vals)`` for row-eligible arrays (idx into the
    flattened 2-D stored layout), ``full[key]`` for every other array
    that changed, ``counts`` for the manifest. ``candidates[key]``
    restricts the rows compared; a candidate that did not change is
    never shipped."""
    rows: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    full: Dict[str, np.ndarray] = {}
    counts: Dict[str, int] = {}
    for key, cv in cur.items():
        pv = prev.get(key)
        if pv is None or pv.shape != cv.shape or pv.dtype != cv.dtype:
            full[key] = cv           # a new or reshaped array: whole
            continue
        if _row_eligible(cv, min_elems):
            p2, c2 = _row_view(pv), _row_view(cv)
            cand = candidates.get(key) if candidates else None
            if cand is not None:
                cand = cand[(cand >= 0) & (cand < c2.shape[0])]
                sub = np.any(p2[cand] != c2[cand], axis=1)
                idx = cand[sub]
            else:
                idx = np.flatnonzero(np.any(p2 != c2, axis=1))
            if idx.size:
                rows[key] = (idx.astype(np.int64),
                             np.ascontiguousarray(c2[idx]))
                counts[key] = int(idx.size)
        elif not np.array_equal(pv, cv):
            full[key] = cv
    return rows, full, counts


# ---------------------------------------------------------------------
# delta file round trip
# ---------------------------------------------------------------------
def write_delta_file(path: str, step: int, prev_step: int, base_step: int,
                     rows, full, quant: Optional[Dict[str, str]] = None,
                     timings: Optional[Dict[str, float]] = None) -> int:
    """Atomically write one delta npz; returns its CRC-32. The
    publish-abort injection fires before the rename (the mid-publish
    crash window), the torn-delta injection truncates after it.
    ``timings`` receives the write's and the checksum's seconds.

    ``quant`` maps flat keys to a quantized dtype: those keys' row
    payloads ship as codes + per-row fp32 scales (``rows/`` the codes,
    fp8 as uint8 bit patterns, ``scl/`` the scales, ``qdt/`` the dtype,
    ``sbd/`` the largest scale, the bound the loader checks). Other keys
    keep the fp32 layout, so an unquantized model writes the same file
    as before."""
    from ..quant.codec import quantize_rows_np
    flat: Dict[str, np.ndarray] = {
        "meta/step": np.asarray(step, np.int64),
        "meta/prev_step": np.asarray(prev_step, np.int64),
        "meta/base_step": np.asarray(base_step, np.int64),
    }
    for key, (idx, vals) in rows.items():
        flat[f"idx/{key}"] = idx
        dt = (quant or {}).get(key)
        if dt:
            q, scales = quantize_rows_np(vals, dt)
            flat[f"rows/{key}"] = q
            flat[f"scl/{key}"] = scales
            flat[f"qdt/{key}"] = np.asarray(dt)
            flat[f"sbd/{key}"] = np.asarray(
                float(scales.max()) if scales.size else 0.0, np.float32)
        else:
            flat[f"rows/{key}"] = vals
    for key, v in full.items():
        flat[f"full/{key}"] = v
    faults.maybe_abort_publish(path)
    crc = _write_npz_atomic(path, flat, timings)
    faults.maybe_torn_delta(path)
    return crc


def load_delta_file(path: str) -> Dict[str, Any]:
    """Read a delta npz (the port's or the JAX package's) into an
    ``apply_delta`` payload of host arrays.

    Quantized row payloads are validated first (scales finite,
    non-negative and within the publish-time bound: a corrupt scale is a
    :class:`ChainError`, and the watcher falls back to the newest valid
    full snapshot instead of serving amplified rows), then dequantized
    into ``rows``; the codes and scales stay under ``qrows`` ({key:
    (idx, codes, scales, dtype)}, fp8 codes as uint8 bit patterns) for
    the consumers that store them quantized."""
    from ..quant.codec import dequantize_rows_np, validate_scales
    rows: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    qrows: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, str]] = {}
    full: Dict[str, np.ndarray] = {}
    data = read_npz(path)
    for k in data:
        if k.startswith("idx/"):
            key = k[len("idx/"):]
            vals = data[f"rows/{key}"]
            if f"scl/{key}" in data:
                dt = str(data[f"qdt/{key}"])
                scales = faults.maybe_corrupt_quant_scale(
                    key, data[f"scl/{key}"])
                bound = (float(data[f"sbd/{key}"])
                         if f"sbd/{key}" in data else None)
                try:
                    validate_scales(key, scales, bound)
                except ValueError as e:
                    raise ChainError(str(e)) from None
                q = np.ascontiguousarray(vals).view(
                    np.uint8 if dt == "fp8" else np.int8)
                qrows[key] = (data[k], q, scales, dt)
                vals = dequantize_rows_np(q, scales, dt)
            rows[key] = (data[k], vals)
        elif k.startswith("full/"):
            full[k[len("full/"):]] = data[k]
    out = {"step": int(data["meta/step"]),
           "prev_step": int(data["meta/prev_step"]),
           "base_step": int(data["meta/base_step"]),
           "rows": rows, "full": full}
    if qrows:
        out["qrows"] = qrows
    return out


def stage_delta_rows(model, payload: Dict[str, Any]) -> Dict[str, Any]:
    """Copy a loaded delta's row payloads to the model's device in the
    port's layout: the slow half of an incremental reload, run on the
    watcher thread OUTSIDE any dispatch. On the card the rows go through
    pinned memory on a side stream, and ``"ready"`` is the event that
    ``FFModel.apply_delta`` makes its stream wait on. Returns a new
    payload (``"staged"``: key -> (row ids, rows), both tensors); the
    host ``"rows"`` stay for validation."""
    staged = dict(payload)
    ops = {op.name: op for op in model.ops}
    dev = model.device
    moved: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    stream = model._stage_stream      # the side stream (None on the CPU)
    for key, (idx, vals) in payload["rows"].items():
        parts = key.split("/")
        if parts[0] != "params" or len(parts) != 3 or parts[1] not in ops:
            continue       # apply_delta names the key when it rejects it
        pidx, pvals = rows_from_jax(ops[parts[1]], parts[2], idx, vals)
        i = torch.from_numpy(np.ascontiguousarray(pidx, np.int64))
        v = torch.from_numpy(np.ascontiguousarray(pvals, np.float32))
        if stream is not None:
            i, v = i.pin_memory(), v.pin_memory()
            with torch.cuda.stream(stream):
                i = i.to(dev, non_blocking=True)
                v = v.to(dev, non_blocking=True)
        moved[key] = (i, v)
    staged["staged"] = moved
    staged["ready"] = None
    if stream is not None:
        ev = torch.cuda.Event()
        ev.record(stream)
        staged["ready"] = ev
    return staged


# ---------------------------------------------------------------------
# per-shard routing (the serving shard tier, serve/shardtier.py)
# ---------------------------------------------------------------------
# A row-sharded serving tier splits every host table's flat row space
# over N lookup shards, so a delta publish touches only the shards that
# own its rows, and each shard validates exactly its own slice.
# ``split_host_rows_by_shard`` cuts a payload's ``hostparams/`` updates
# along the shard ranges and stamps each slice with a CRC the owning
# shard recomputes before it applies the slice. A shard the publish did
# not touch gets None (a version bump, no row work).


def shard_slice_crc(sub: Dict[str, Any]) -> int:
    """Deterministic CRC-32 over one shard's delta slice (sorted keys,
    index bytes, row bytes): computed at split time and again by the
    shard at apply time, so corruption between the two is a reject with
    its reason, never silently wrong rows."""
    import zlib
    crc = 0
    for key in sorted(sub.get("rows", {})):
        idx, vals = sub["rows"][key]
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(idx, np.int64), crc)
        crc = zlib.crc32(np.ascontiguousarray(vals), crc)
    for key in sorted(sub.get("full", {})):
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(sub["full"][key]), crc)
    return crc


def shard_chain_crc(prev_crc: int, step: int, slice_crc: int) -> int:
    """One link of a shard's publish chain: CRC over (previous link,
    step, this slice's CRC). Two shards that applied the same publishes
    in the same order agree on it."""
    import zlib
    blob = np.asarray([prev_crc, step, slice_crc], np.int64)
    return zlib.crc32(blob.tobytes())


def split_host_rows_by_shard(payload: Dict[str, Any],
                             ranges_by_op: Dict[str, list],
                             ) -> Dict[int, Optional[Dict[str, Any]]]:
    """Split an ``apply_delta`` payload's host-table updates into
    per-shard slices. ``ranges_by_op`` maps op name -> the tier's
    ``[(lo, hi), ...]`` flat-row ranges. Row updates
    (``rows["hostparams/<op>/kernel"]``) go to their owners; full-array
    host replacements are sliced along the same ranges. Returns ``{slot:
    slice | None}``, each slice with its ``crc``; other keys are the
    ranker's and are ignored here."""
    from ..serve.shardtier import row_owners
    nshards = max((len(r) for r in ranges_by_op.values()), default=0)
    subs: Dict[int, Dict[str, Any]] = {}

    def _sub(slot):
        return subs.setdefault(slot, {"rows": {}, "full": {}})

    for key, (idx, vals) in (payload.get("rows") or {}).items():
        if not key.startswith("hostparams/"):
            continue
        ranges = ranges_by_op.get(key.split("/")[1])
        if ranges is None:
            continue
        owners = row_owners(idx, ranges[-1][1], len(ranges))
        for slot in np.unique(owners):
            m = owners == slot
            _sub(int(slot))["rows"][key] = (np.asarray(idx)[m],
                                            np.asarray(vals)[m])
    for key, arr in (payload.get("full") or {}).items():
        if not key.startswith("hostparams/"):
            continue
        ranges = ranges_by_op.get(key.split("/")[1])
        if ranges is None:
            continue
        flat = np.asarray(arr).reshape(-1, arr.shape[-1])
        for slot, (lo, hi) in enumerate(ranges):
            if hi > lo:
                _sub(slot)["full"][key] = flat[lo:hi]
    out: Dict[int, Optional[Dict[str, Any]]] = {}
    for slot in range(nshards):
        sub = subs.get(slot)
        if sub is not None:
            sub["crc"] = shard_slice_crc(sub)
        out[slot] = sub
    return out


# ---------------------------------------------------------------------
# chain validation (the publisher's and the watcher's)
# ---------------------------------------------------------------------
def resolve_chain(manifest: Dict[str, Any], fingerprint: Optional[str],
                  directory: str,
                  check_files: bool = True
                  ) -> Optional[Tuple[Dict[str, Any], List[Dict[str, Any]]]]:
    """Validate the manifest's delta chain newest-tip-first.

    Returns ``(base_entry, ordered_delta_entries)`` for the newest tip,
    or None when no deltas are listed. Raises :class:`ChainError` with
    the reason on any inconsistency: a gap in the prev links, a delta or
    base written by a differently-built model, a base snapshot that was
    replaced (CRC mismatch) or is missing from the manifest, a listed
    delta file that is missing or fails its CRC-32."""
    deltas = manifest.get("deltas") or []
    if not deltas:
        return None
    entries = manifest.get("entries") or []
    tip = max(deltas, key=lambda e: e.get("step", -1))
    base_step = tip.get("base_step")
    chain = sorted((e for e in deltas
                    if e.get("base_step") == base_step),
                   key=lambda e: e.get("step", -1))
    if len(chain) != len(deltas):
        strays = [e.get("file") for e in deltas if e not in chain]
        raise ChainError(
            f"delta chain mixes bases: {strays} do not chain off base "
            f"step {base_step} (stale chain from a previous run)")
    base_entry = next((e for e in entries
                       if e.get("step") == base_step), None)
    if base_entry is None:
        raise ChainError(
            f"chain base snapshot (step {base_step}) is not in the "
            f"manifest (pruned or never published)")
    if (fingerprint is not None and base_entry.get("fingerprint")
            not in (None, fingerprint)):
        raise ChainError(
            f"chain base {base_entry.get('file')} fingerprint "
            f"{base_entry.get('fingerprint')} != this model's "
            f"{fingerprint} (differently-built model)")
    prev = base_step
    for e in chain:
        if e.get("prev_step") != prev:
            raise ChainError(
                f"chain gap: delta {e.get('file')} links to step "
                f"{e.get('prev_step')} but the chain is at step {prev} "
                f"(lost manifest entry / partial publish)")
        if (fingerprint is not None
                and e.get("fingerprint") not in (None, fingerprint)):
            raise ChainError(
                f"delta {e.get('file')} fingerprint "
                f"{e.get('fingerprint')} != this model's {fingerprint}")
        if (e.get("base_crc32") is not None
                and base_entry.get("crc32") is not None
                and e.get("base_crc32") != base_entry.get("crc32")):
            raise ChainError(
                f"delta {e.get('file')} was published against base "
                f"step {base_step} crc {e.get('base_crc32')}, but the "
                f"manifest's base {base_entry.get('file')} has crc "
                f"{base_entry.get('crc32')} (base was replaced)")
        if check_files:
            path = os.path.join(directory, e.get("file", ""))
            if not os.path.isfile(path):
                raise ChainError(
                    f"delta {e.get('file')} is listed in the manifest "
                    f"but missing on disk")
            crc = e.get("crc32")
            if crc is not None and _file_crc32(path) != crc:
                raise ChainError(
                    f"delta {e.get('file')} fails its CRC-32 (torn "
                    f"write / corruption)")
        prev = e.get("step")
    return base_entry, chain


# ---------------------------------------------------------------------
# publisher
# ---------------------------------------------------------------------
class DeltaPublisher:
    """Interleaves delta snapshots with rolling full checkpoints.

    Owns (or adopts) a :class:`CheckpointManager` on ``directory``. The
    first publish is always a FULL checkpoint (the chain base, and what
    ``fit_stream(resume=True)`` restores); later publishes are deltas
    until a compaction: the chain's bytes past ``compact_frac`` of its
    base file, ``max_chain`` links, or ``full_every`` deltas. A chain
    that a previous (crashed) trainer left behind is retired at
    construction: its base state is gone, so it cannot be extended.

    A failed delta publish (an IO error, an injected abort) is not
    fatal: the chain is untouched, the cumulative tracker keeps the
    candidates, and the next interval publishes the union.

    ``last_publish`` holds the last publish's kind, step, file bytes and
    seconds: the copy of the state to the host (``copy_s``), the diff
    (deltas), the file write with its fsync (``write_s``), the checksum
    pass (``crc_s``) and the whole call (``total_s``)."""

    def __init__(self, model, directory: str, keep_last: int = 3,
                 compact_frac: float = 0.5, full_every: int = 0,
                 max_chain: int = 64,
                 row_delta_min_elems: int = ROW_DELTA_MIN_ELEMS,
                 manager: Optional[CheckpointManager] = None):
        if compact_frac <= 0:
            raise ValueError(
                f"compact_frac must be > 0, got {compact_frac}")
        self.model = model
        self.mgr = manager or CheckpointManager(directory,
                                                keep_last=keep_last,
                                                model=model)
        # across ranks rank 0 writes; the others gather and keep count
        self._writer = model._is_rank0()
        self.compact_frac = float(compact_frac)
        self.full_every = int(full_every)
        self.max_chain = int(max_chain)
        self.row_delta_min_elems = int(row_delta_min_elems)
        self.tracker = TouchedRowTracker(model)
        # the flat keys whose row payloads publish as codes + row scales
        # (a quantized storage policy); empty for an unquantized model
        self._quant_keys: Dict[str, str] = {}
        for op_name, pol in model.quant_policies().items():
            if pol.is_quantized:
                for sec in ("params", "hostparams"):
                    for pname in ("kernel", "hot_kernel"):
                        self._quant_keys[f"{sec}/{op_name}/{pname}"] = \
                            pol.dtype
        # candidates are trustworthy only if the tracker saw every batch
        # trained after this point (fit_stream observes at staging time)
        self._track_origin = int(model._step)
        self._fingerprint = config_fingerprint(model)
        removed = self.mgr.reset_deltas() if self._writer else 0
        if removed:
            log_delta.info("retired %d stale delta(s) from a previous "
                           "run in %s", removed, self.mgr.directory)
        self._has_base = False
        self._last_flat: Optional[Dict[str, np.ndarray]] = None
        self._last_step = -1
        self._base_step = -1
        self._base_file = ""
        self._base_crc: Optional[int] = None
        self._base_bytes = 0
        self._chain_bytes = 0
        self._chain_len = 0
        self._deltas_since_full = 0
        self.publishes = 0
        self.full_publishes = 0
        self.delta_publishes = 0
        self.compactions = 0
        self.publish_errors = 0
        self.last_publish_error = ""
        self.last_publish: Dict[str, Any] = {}
        self._untracked_warned = False

    # --- tracking ------------------------------------------------------
    def observe_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """Show the tracker a host batch about to be staged/trained."""
        self.tracker.observe(batch)

    # --- publish decision ----------------------------------------------
    def _compaction_due(self) -> Optional[str]:
        if not self._has_base:
            return "no base yet"
        if self.full_every and self._deltas_since_full >= self.full_every:
            return f"full_every={self.full_every} cadence"
        if self._chain_len >= self.max_chain:
            return f"chain length {self._chain_len} >= {self.max_chain}"
        if (self._base_bytes
                and self._chain_bytes > self.compact_frac
                * self._base_bytes):
            return (f"chain bytes {self._chain_bytes} > "
                    f"{self.compact_frac:g} x base {self._base_bytes}")
        return None

    def publish(self, loader_state: Optional[Dict[str, Any]] = None
                ) -> Optional[Dict[str, Any]]:
        """Publish the model's current state: a delta when the live
        chain can take it, a full checkpoint otherwise. Returns the
        manifest entry, or None when a delta publish failed (retried
        next interval)."""
        reason = self._compaction_due()
        coll = self.model._dist()
        if coll is not None:
            # the two kinds gather different arrays: rank 0's choice
            reason = coll.broadcast_object(reason)
        if reason is None:
            return self.publish_delta(loader_state)
        if self._has_base:
            self.compactions += 1
            log_delta.info("compacting delta chain -> full checkpoint "
                           "(%s)", reason)
        return self.publish_full(loader_state)

    # --- full (chain base) publish --------------------------------------
    def publish_full(self, loader_state: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """Blocking full checkpoint; becomes the new chain base."""
        with obstrace.span("publish/full", step=int(self.model._step)):
            return self._publish_full(loader_state)

    def _publish_full(self, loader_state: Optional[Dict[str, Any]]
                      ) -> Dict[str, Any]:
        t0 = time.perf_counter()
        self.mgr.wait()
        model = self.model
        step = int(model._step)
        flat, stats = self.mgr._snapshot(model)
        if flat is None:
            # a rank that does not write: the gather was its part
            self._has_base = True
            self._last_step = self._base_step = step
            self._chain_len = self._deltas_since_full = 0
            self.publishes += 1
            self.full_publishes += 1
            self.last_publish = {"kind": "full", "step": step,
                                 "copy_s": stats["gather_s"],
                                 "total_s": time.perf_counter() - t0}
            return None
        entry = self.mgr._write_snapshot(
            flat, step, self._fingerprint, dict(loader_state or {}), stats,
            mesh_meta(model))
        removed = self.mgr.reset_deltas()
        if removed:
            log_delta.info("retired %d delta(s) of the previous chain",
                           removed)
        self._last_flat = {
            k: v for k, v in flat.items()
            if k.split("/", 1)[0] in _SERVING_SECTIONS}
        self._has_base = True
        self._last_step = step
        self._base_step = step
        self._base_file = entry["file"]
        self._base_crc = entry.get("crc32")
        self._base_bytes = int(self.mgr.last_save.get("file_bytes", 0))
        self._chain_bytes = 0
        self._chain_len = 0
        self._deltas_since_full = 0
        self.publishes += 1
        self.full_publishes += 1
        obsm.counter("ff_publishes_total",
                     "snapshot publications by kind",
                     labelnames=("kind",)).inc(kind="full")
        self._publish_histograms()
        ls = self.mgr.last_save
        self.last_publish = {
            "kind": "full", "step": step, "bytes": self._base_bytes,
            "copy_s": ls["gather_s"], "write_s": ls["file_write_s"],
            "crc_s": ls["crc_s"], "total_s": time.perf_counter() - t0}
        return entry

    def _publish_histograms(self) -> None:
        """Write the observed id-frequency sketches beside the chain
        base (``id_histogram.npz`` and a manifest pointer), as the JAX
        publisher does. Never fails a publish."""
        from .histogram import HISTOGRAM_FILE, save_histograms
        sketches = self.tracker.id_histograms()
        observed = {n: s for n, s in sketches.items() if s.total > 0}
        if not observed:
            return
        try:
            path = os.path.join(self.mgr.directory, HISTOGRAM_FILE)
            save_histograms(path, observed)
            self.mgr.set_manifest_extra("id_histogram", {
                "file": HISTOGRAM_FILE,
                "total_lookups": {n: int(s.total)
                                  for n, s in observed.items()}})
        except (IOError, OSError) as e:
            log_delta.warning("id-histogram publish failed (%s); "
                              "will retry at the next full publish", e)

    # --- delta publish ---------------------------------------------------
    def publish_delta(self, loader_state: Optional[Dict[str, Any]] = None
                      ) -> Optional[Dict[str, Any]]:
        step = int(self.model._step)
        if not self._has_base:
            return self.publish_full(loader_state)
        with obstrace.span("publish/delta", step=step):
            return self._publish_delta(loader_state, step)

    def _publish_delta(self, loader_state: Optional[Dict[str, Any]],
                       step: int) -> Optional[Dict[str, Any]]:
        if step <= self._last_step:
            return None           # nothing trained since the last publish
        t0 = time.perf_counter()
        cur = serving_flat(self.model)
        t_copy = time.perf_counter()
        if cur is None:
            # a rank that does not write: the gather was its part
            self._last_step = step
            self._chain_len += 1
            self._deltas_since_full += 1
            self.publishes += 1
            self.delta_publishes += 1
            self.last_publish = {"kind": "delta", "step": step,
                                 "copy_s": t_copy - t0,
                                 "total_s": t_copy - t0}
            return None
        cand, batches = self.tracker.snapshot()
        if batches < step - self._track_origin:
            # the tracker missed trained batches (a train_batch call
            # outside fit_stream): diff every row instead
            if cand and not self._untracked_warned:
                self._untracked_warned = True
                log_delta.warning(
                    "tracker observed %d batch(es) for %d trained "
                    "step(s); falling back to full-array row diffs",
                    batches, step - self._track_origin)
            cand = None
        parts: Dict[str, float] = {}
        try:
            rows, full, counts = _diff_flat(self._last_flat, cur, cand,
                                            self.row_delta_min_elems)
            t_diff = time.perf_counter()
            fname = f"delta-{step:08d}.npz"
            path = os.path.join(self.mgr.directory, fname)
            crc = write_delta_file(path, step, self._last_step,
                                   self._base_step, rows, full,
                                   quant=self._quant_keys, timings=parts)
        except (IOError, OSError) as e:
            # the atomic writer left no torn file and the manifest never
            # saw an entry; the next delta covers this interval's rows
            self.publish_errors += 1
            self.last_publish_error = str(e)
            log_delta.warning("delta publish at step %d failed (%s); "
                              "will retry next interval", step, e)
            return None
        entry = {
            "file": fname, "kind": "delta", "step": step,
            "prev_step": self._last_step, "base_step": self._base_step,
            "base_file": self._base_file, "base_crc32": self._base_crc,
            "fingerprint": self._fingerprint, "crc32": crc,
            "bytes": os.path.getsize(path),
            "touched_rows": counts, "full_arrays": sorted(full),
            "loader_state": dict(loader_state or {}),
            "time": time.time(),
        }
        if faults.take_delta_gap():
            log_delta.warning("injected delta gap: %s published without "
                              "a manifest entry", fname)
        else:
            self.mgr.append_delta_entry(entry)
        self._last_flat = cur
        self._last_step = step
        self._chain_bytes += entry["bytes"]
        self._chain_len += 1
        self._deltas_since_full += 1
        self.publishes += 1
        self.delta_publishes += 1
        obsm.counter("ff_publishes_total",
                     "snapshot publications by kind",
                     labelnames=("kind",)).inc(kind="delta")
        self.last_publish = {
            "kind": "delta", "step": step, "bytes": entry["bytes"],
            "copy_s": t_copy - t0, "diff_s": t_diff - t_copy,
            "write_s": parts.get("write_s", 0.0),
            "crc_s": parts.get("crc_s", 0.0),
            "total_s": time.perf_counter() - t0}
        return entry

    def stats(self) -> Dict[str, Any]:
        return {
            "publishes": self.publishes,
            "full_publishes": self.full_publishes,
            "delta_publishes": self.delta_publishes,
            "compactions": self.compactions,
            "publish_errors": self.publish_errors,
            "last_publish_error": self.last_publish_error,
            "base_step": self._base_step,
            "last_step": self._last_step,
            "chain_len": self._chain_len,
            "chain_bytes": self._chain_bytes,
            "base_bytes": self._base_bytes,
        }
