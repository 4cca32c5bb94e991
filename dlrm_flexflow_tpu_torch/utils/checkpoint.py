"""Checkpoint / resume (the port of ``dlrm_flexflow_tpu.utils.checkpoint``),
in the JAX package's own file format, so each package restores the
other's snapshots.

A snapshot is one ``.npz``: ``params/<op>/<param>`` in the JAX layout
(``utils.weights.params_to_jax``: stacked tables lane-packed to
(T, rows/r, r·d) in ``_table_order``), ``opt/<slab>/<op>/<param>`` and
Adam's ``opt/step`` (``opt_state_to_jax``), host-resident tables as
``hostparams/<op>/kernel`` and their optimizer slabs as
``hostopt/<op>/<slab>`` (unpacked, as both packages keep them on the
host), and ``meta/step``. A model on one rank writes no
``meta/mesh_axes`` or ``meta/num_devices``: the JAX package checks a
mesh only when a file records one, so any JAX mesh takes such a file.
Restoring goes back through ``params_from_jax``/``opt_state_from_jax``.

Across ranks (a mesh of several ranks, one process each) the file is
the one the JAX package writes from its host-gathered arrays: each
parameter and slab is joined from the ranks' pieces on rank 0, in the
JAX stored layout (``weights.piece_layout``: tables split by table, row
blocks, width pieces, a row-sharded table's cold blocks beside its hot
head, ``Linear`` channels), host tables from rank 0's copy (every rank
holds them whole), and only rank 0 writes, with ``meta/num_devices``
and ``meta/mesh_axes`` as JAX ``_model_flat`` records them. Every rank
reads the same file back and takes its own piece. A file recorded under
another mesh is rejected, before anything is applied, with the JAX
package's reason, by ``restore_checkpoint`` and, unless its ``elastic``
says otherwise (the serving fleet's ``ServeConfig.reshard``),
``load_params_for_swap``. Restoring a training run onto another mesh
(elastic restore) is ROADMAP queue 1 item 7.5.

Fault tolerance, as in the JAX package:

- every write is atomic — a temp file in the target directory, fsync,
  ``os.replace`` — so a crash mid-save never corrupts an existing
  snapshot (it leaves a ``*.tmp-<pid>`` orphan, which the manager
  sweeps);
- :class:`CheckpointManager` keeps the last K snapshots, with a JSON
  manifest carrying each one's step, the model's fingerprint
  (``config_fingerprint``, the JAX package's digest of the same graph),
  a CRC-32 of the file and an opaque ``loader_state`` (``fit()`` stores
  its epoch/batch position there);
- ``save_async`` copies the state to the host inline (it must, for
  consistency) and compresses nothing: the write, rename and manifest
  update run on a background thread;
- restore walks the manifest newest-first and skips corrupt, truncated,
  missing or foreign snapshots.

Across ranks the manager's directory work runs on rank 0: the sweep of
orphan temp files, the write, the manifest and its garbage collection;
``restore_latest`` chooses the entry on rank 0 (the file's presence,
fingerprint and CRC-32) and broadcasts it, so every rank resumes the
same step, and ``save_async`` gathers on the calling (main) thread, so
its writer thread issues no collective.

The manifest also carries the continual loop's delta chain
(``utils/delta.py``: ``delta_entries``, ``append_delta_entry``,
``reset_deltas``, a ``"deltas"`` list beside ``"entries"``) and sidecar
keys (``set_manifest_extra``: the id histogram), in the JAX manager's
layout, so each package's manager and watcher read the other's
manifest. ``load_params_for_swap`` reads a snapshot's parameters onto
the card without touching the model, for the serving hot reload.

Fault-injection hooks from ``utils.faults`` sit on the write path. The
JAX manager's warm-cache directory (``utils/warmcache.py``) is not
ported yet (ROADMAP queue 1 item 9.5).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import faults
from .logging import get_logger
from .weights import (host_param_shapes, jax_param_shapes,
                      opt_state_from_jax, opt_state_to_jax,
                      params_from_jax, params_to_jax)

log_ckpt = get_logger("checkpoint")


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def whole_jax(model, tree, copy: bool) -> Optional[Dict[str, Dict]]:
    """{op: {param: this rank's ``params_to_jax`` array}} -> the JAX
    stored arrays (``copy``: each a fresh copy). Across ranks each piece
    is joined from every rank's on rank 0 (one gather a piece, in op
    order on every rank), and the other ranks get None."""
    coll = model._dist()
    if coll is None:
        return {name: {pn: (np.array(v) if copy else v)
                       for pn, v in sub.items()}
                for name, sub in tree.items()}
    from ..parallel.distributed import rank
    from ..parallel.split import join_pieces_host
    from .weights import piece_layout
    ops = {op.name: op for op in model.ops}
    out = {}
    for name, sub in tree.items():
        out[name] = {}
        for pn, v in sub.items():
            lay = piece_layout(ops[name], pn)
            out[name][pn] = (np.array(v) if lay is None else
                             join_pieces_host(coll, model.mesh, lay[0], v,
                                              lay[1]))
    return out if rank() == 0 else None


def _model_flat(model, copy_host: bool = True
                ) -> Optional[Dict[str, np.ndarray]]:
    """A model's training state as npz-ready host arrays in the JAX
    layout, after the last host scatter landed. The arrays own their
    bytes: a background writer writes them while the training loop keeps
    updating the model's tensors in place (a copy from the card is fresh
    host memory; a CPU tensor is copied; the host tables are copied
    unless ``copy_host`` is False, for a write made before any other
    step). Across ranks every rank calls it (the pieces are gathered to
    rank 0, ``whole_jax``); rank 0 gets the state, with the mesh's
    ``meta/num_devices`` and ``meta/mesh_axes``, the others None."""
    model._host_drain()
    copy = model.device.type == "cpu"
    params = whole_jax(model, params_to_jax(model, model.params), copy)
    state = opt_state_to_jax(model, model.opt_state or {})
    slabs = {k: whole_jax(model, v, copy) for k, v in state.items()
             if k != "step"}
    if params is None:
        return None
    flat: Dict[str, np.ndarray] = {}
    for k, v in _flatten(params).items():
        flat[f"params/{k}"] = v
    if "step" in state:
        slabs["step"] = state["step"]
    for k, v in _flatten(slabs).items():
        flat[f"opt/{k}"] = v
    for sec, tree in (("hostparams", model.host_params),
                      ("hostopt", model.host_opt_state)):
        for k, v in _flatten(tree).items():
            flat[f"{sec}/{k}"] = np.array(v) if copy_host else v
    flat["meta/step"] = np.asarray(model._step)
    if model._dist() is not None:
        mesh = model.mesh
        flat["meta/mesh_axes"] = np.asarray(list(mesh.axis_sizes), np.int64)
        flat["meta/num_devices"] = np.asarray(mesh.size, np.int64)
    return flat


def check_mesh_meta(model, flat, path: str, elastic: bool = False) -> None:
    """Reject a file written under another mesh (non-elastic loads), with
    the JAX package's reason (its ``_check_mesh_meta``), before anything
    is applied. A file that records no mesh passes."""
    if "meta/num_devices" not in flat or model.mesh is None:
        return
    ck_ndev = int(flat["meta/num_devices"])
    ck_axes = ([int(x) for x in flat["meta/mesh_axes"]]
               if "meta/mesh_axes" in flat else None)
    cur_axes = [int(x) for x in model.mesh.axis_sizes]
    if not elastic and (ck_ndev != model.mesh.size
                        or (ck_axes is not None and ck_axes != cur_axes)):
        raise ValueError(
            f"checkpoint {path} was written under a {ck_ndev}-device "
            f"mesh (axes {ck_axes}) but this model is compiled for "
            f"{model.mesh.size} devices (axes {cur_axes}). Cross-mesh "
            f"restore needs elastic mode, which the port does not have "
            f"yet for training (ROADMAP queue 1 item 7.5); a serving "
            f"engine reshards with ServeConfig(reshard=True).")


def mesh_meta(model) -> Dict[str, Any]:
    """The manifest entry's ``"mesh"`` (the JAX manager's ``mesh_meta``
    key): ``"quant"``, the non-default storage policies ``compile``
    resolved ({op: {"dtype", "update_rule"}}), which the JAX package's
    shardcheck compares a strategy file against, and across ranks the
    mesh's ``"axes"`` and ``"num_devices"``; empty on one rank without a
    policy."""
    out: Dict[str, Any] = {}
    if model._dist() is not None:
        out["axes"] = {a: int(n) for a, n in model.mesh.shape.items()}
        out["num_devices"] = int(model.mesh.size)
    quant = {name: {"dtype": pol.dtype, "update_rule": pol.update_rule}
             for name, pol in model.quant_policies().items()}
    if quant:
        out["quant"] = quant
    return out


def _write_npz_atomic(path: str, flat: Dict[str, np.ndarray],
                      timings: Optional[Dict[str, float]] = None) -> int:
    """Write `flat` to `path` atomically; returns the file's CRC-32. The
    temp file lives in the same directory (``os.replace`` must not cross
    file systems) and is fsync'd before the rename, so a crash at any
    point leaves either the previous file or the complete new one.
    ``timings``, when given, receives the seconds of the write (with its
    fsync) as ``write_s`` and of the checksum pass as ``crc_s``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        t0 = time.perf_counter()
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        t1 = time.perf_counter()
        crc = _file_crc32(tmp)
        if timings is not None:
            timings["write_s"] = t1 - t0
            timings["crc_s"] = time.perf_counter() - t1
        faults.maybe_abort_write(path)   # injected save crash (pre-rename)
        faults.maybe_delay_write()       # injected kill window
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    faults.maybe_truncate_file(path)     # injected torn write / bit rot
    return crc


def _file_crc32(path: str) -> int:
    """The file's CRC-32, in 64 MB reads (few turns for the interpreter
    lock: a serving process's request threads hold it)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 26)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def read_npz(path: str, keep: Optional[Callable[[str], bool]] = None
             ) -> Dict[str, np.ndarray]:
    """The arrays of an ``np.savez`` file (``keep`` selects the keys),
    each read from the zip in ONE call into its array. ``np.load`` copies
    a member through the interpreter in 256 KB chunks, and each chunk
    then waits its turn for the interpreter lock: in a serving process
    whose request threads hold it, loading a 2 GB snapshot that way took
    tens of seconds instead of about one. A torn file raises as
    ``np.load`` does (``zipfile.BadZipFile``: not a zip, or a member
    failing its CRC-32)."""
    import zipfile
    fmt = np.lib.format
    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            key = name[:-len(".npy")] if name.endswith(".npy") else name
            if keep is not None and not keep(key):
                continue
            with zf.open(name) as f:
                major, _ = fmt.read_magic(f)
                if major not in (1, 2):
                    out[key] = fmt.read_array(f, allow_pickle=False)
                    continue
                shape, fortran, dtype = (
                    fmt.read_array_header_1_0 if major == 1
                    else fmt.read_array_header_2_0)(f)
                if dtype.hasobject:
                    raise ValueError(f"{path}: {key} holds Python objects")
                arr = np.empty(shape, dtype=dtype,
                               order="F" if fortran else "C")
                view = memoryview(arr.reshape(-1, order="A")).cast("B")
                if f.readinto(view) != arr.nbytes:
                    raise zipfile.BadZipFile(f"{path}: {key} is truncated")
            out[key] = arr
    return out


def config_fingerprint(model) -> str:
    """Short digest of what a checkpoint must agree with the model on:
    the op graph (names and JAX class names, which the port's ops
    share), every parameter's shape in the JAX layout (across ranks the
    whole stored array's, as the JAX model's on a mesh), and the compute
    dtype; the same digest as the JAX package's for the same graph, so
    neither package skips the other's snapshots as foreign."""
    desc: List[Any] = [str(model.config.compute_dtype)]
    desc.append(sorted((op.name, type(op).__name__) for op in model.ops))
    for tree in (jax_param_shapes(model, whole=True),
                 host_param_shapes(model)):
        desc.append(sorted(
            (f"{op}/{pn}", shape)
            for op, shapes in tree.items()
            for pn, shape in shapes.items()))
    blob = json.dumps(desc, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:12]


def save_checkpoint(model, path: str):
    """Save params, optimizer state and step to `path` (.npz),
    atomically. Across ranks every rank calls it and rank 0 writes."""
    if not path.endswith(".npz"):
        path += ".npz"   # np.savez would have appended it anyway
    flat = _model_flat(model, copy_host=False)
    if flat is not None:
        _write_npz_atomic(path, flat)


_SECTIONS = ("params", "opt", "hostparams", "hostopt")


def _split_sections(flat: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """A snapshot's flat arrays -> {section: its flat arrays} for the
    params, opt, hostparams and hostopt sections."""
    out: Dict[str, Dict] = {sec: {} for sec in _SECTIONS}
    for k, v in flat.items():
        sec, _, rest = k.partition("/")
        if sec in out:
            out[sec][rest] = v
        elif sec == "state":
            raise ValueError(
                f"checkpoint holds {k!r}: op state is not ported yet "
                f"(ROADMAP queue 1 item 11)")
    return out


def _host_tables(model, sections, opt: bool):
    """The snapshot's host tables (and, with ``opt``, their optimizer
    slabs), checked against the model's host-resident ops: a snapshot of
    device tables for a host-table model raises, as does the reverse."""
    host = _unflatten(sections["hostparams"])
    if set(host) != {op.name for op in model._host_resident_list}:
        raise ValueError(
            f"checkpoint has host-resident tables {sorted(host)} but the "
            f"model keeps {sorted(op.name for op in model._host_resident_list)}"
            f" on the host (--host-tables must match the writer's)")
    return host, (_unflatten(sections["hostopt"]) if opt else None)


def restore_checkpoint(model, path: str, params_only: bool = False):
    """Restore a snapshot (the port's or the JAX package's) into a built
    model: parameters, optimizer state and step. Every parameter is
    checked against the model's before anything is replaced, and a
    snapshot missing one of the model's ops raises.
    ``params_only=True`` loads the parameters and step and leaves the
    optimizer state as it is (serving). Across ranks every rank reads the
    file and takes its own piece; a file written under another mesh is
    rejected first (``check_mesh_meta``)."""
    path = path if path.endswith(".npz") else path + ".npz"
    flat = read_npz(path)
    check_mesh_meta(model, flat, path)
    return _apply_flat_state(model, _split_sections(flat),
                             int(flat["meta/step"]), opt=not params_only)


def load_params_for_swap(model, path: str, elastic: bool = False
                         ) -> Dict[str, Any]:
    """Read a snapshot's inference state (the port's or the JAX
    package's) WITHOUT touching the model: its parameters checked against
    the model's and copied to the model's device, returned for
    ``InferenceEngine.install_snapshot`` (which swaps them in between
    dispatches). Optimizer state is not read. Raises with a reason on a
    mismatch; the watcher rejects the snapshot and keeps serving. A file
    written under another mesh is rejected with the JAX package's reason
    unless ``elastic`` (``ServeConfig.reshard``: a one-card engine
    following a trainer across ranks takes the whole arrays)."""
    path = path if path.endswith(".npz") else path + ".npz"
    flat = read_npz(path,
                    keep=lambda k: not k.startswith(("opt/", "hostopt/")))
    check_mesh_meta(model, flat, path, elastic=elastic)
    sections = _split_sections(flat)
    host, _ = _host_tables(model, sections, opt=False)
    return {"params": _params_of(model, sections["params"]),
            "op_state": {}, "host_params": host or None,
            "step": int(flat["meta/step"])}


def _params_of(model, params_flat):
    params_np = _unflatten(params_flat)
    have = set(jax_param_shapes(model))
    extra = sorted(set(params_np) - have)
    if extra:
        raise ValueError(f"checkpoint has parameters for ops {extra} "
                         f"which this model does not have")
    return params_from_jax(model, params_np)   # raises on a mismatch


def restore_from_flat(model, flat: Dict[str, np.ndarray]):
    """Restore a ``_model_flat`` snapshot held in memory."""
    return _apply_flat_state(model, _split_sections(flat),
                             int(flat["meta/step"]))


def _apply_flat_state(model, sections, step: int, opt: bool = True):
    host, host_opt = _host_tables(model, sections, opt)
    params = _params_of(model, sections["params"])
    state = None
    if opt:
        state = opt_state_from_jax(model, _unflatten(sections["opt"]))
        optimizer = getattr(model, "optimizer", None)
        if optimizer is not None:
            want = set(optimizer.init_state({}))
            if set(state) != want:
                raise ValueError(
                    f"checkpoint optimizer state {sorted(state)} does not "
                    f"match this model's optimizer ({sorted(want)})")
    # swap_params lands an in-flight host scatter and drops a chained
    # gather before it installs
    model.swap_params(params, host_params=host or None)
    if state is not None:
        model.opt_state = state
    if host_opt is not None:
        model.host_opt_state = host_opt
    model._step = int(step)
    model._msums = None
    return model


class CheckpointManager:
    """Atomic rolling checkpoints in a directory, with a manifest, in the
    JAX package's layout::

        <dir>/ckpt-00000042.npz     keep-last-K snapshot files
        <dir>/manifest.json         entries, newest last (atomic writes)

    ``save``/``save_async`` copy the model's state to the host, then
    write, rename and update the manifest (on a background thread for
    ``save_async``). ``restore_latest`` walks the entries newest-first
    and restores the first whose file exists, passes its CRC-32 and
    matches the model's fingerprint. ``last_save`` holds the last
    snapshot's bytes, host-copy seconds and write seconds.

    A manager of a model across ranks (``model``, or the model a call
    passes, on a mesh of several ranks) is made and called on every rank
    in the same order: the snapshot's gather is a collective, and rank 0
    alone sweeps, writes and keeps the manifest (see the module's
    docstring)."""

    MANIFEST = "manifest.json"

    def __init__(self, directory: str, keep_last: int = 3, model=None):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = os.path.abspath(directory)
        self.keep_last = keep_last
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._thread_exc: Optional[BaseException] = None
        self._manifest_lock = threading.Lock()
        self.last_save: Dict[str, float] = {}
        if model is None or model._is_rank0():
            self._sweep_orphan_tmps()

    # --- manifest ------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, self.MANIFEST)

    def _read_manifest(self) -> Dict[str, Any]:
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
            if isinstance(m, dict) and isinstance(m.get("entries"), list):
                return m
        except FileNotFoundError:
            pass
        except (json.JSONDecodeError, OSError) as e:
            # a torn manifest must not kill resume: treat it as empty
            log_ckpt.warning("unreadable manifest %s (%s); treating as "
                             "empty", self._manifest_path(), e)
        return {"version": 1, "entries": []}

    def _write_manifest(self, manifest: Dict[str, Any]) -> None:
        path = self._manifest_path()
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _sweep_orphan_tmps(self) -> None:
        for name in os.listdir(self.directory):
            if ".tmp-" in name:
                try:
                    os.unlink(os.path.join(self.directory, name))
                    log_ckpt.info("removed orphan temp file %s (crashed "
                                  "writer)", name)
                except OSError:
                    pass

    # --- save ----------------------------------------------------------
    def _snapshot(self, model):
        """(the model's state on the host, or None on a rank that does
        not write; its bytes and the seconds of the copy, the gather
        across ranks included)."""
        t0 = time.perf_counter()
        flat = _model_flat(model)
        gather_s = time.perf_counter() - t0
        nbytes = (sum(int(v.nbytes) for v in flat.values())
                  if flat is not None else 0)
        return flat, {"bytes": nbytes, "gather_s": gather_s}

    def save(self, model, loader_state: Optional[Dict[str, Any]] = None):
        """Blocking snapshot of the model's current state."""
        self.wait()
        step = int(model._step)
        flat, stats = self._snapshot(model)
        if flat is None:
            self.last_save = dict(stats, step=step)
            return
        self._write_snapshot(flat, step, config_fingerprint(model),
                             dict(loader_state or {}), stats,
                             mesh_meta(model))

    def save_async(self, model,
                   loader_state: Optional[Dict[str, Any]] = None):
        """Snapshot now (the copy to the host inline, for consistency;
        across ranks the gather too, on this thread), write on a
        background thread. Joins any previous in-flight save first: at
        most one writer; its errors raise here or at wait()."""
        self.wait()
        step = int(model._step)
        flat, stats = self._snapshot(model)
        if flat is None:
            self.last_save = dict(stats, step=step)
            return
        fp = config_fingerprint(model)
        state = dict(loader_state or {})
        mmeta = mesh_meta(model)

        def work():
            try:
                self._write_snapshot(flat, step, fp, state, stats, mmeta)
            except BaseException as e:   # raised at wait()/next save
                self._thread_exc = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="ff-ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight async save and raise its error, if any."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        exc = self._thread_exc
        if exc is not None:
            self._thread_exc = None
            raise exc

    def _write_snapshot(self, flat, step: int, fingerprint: str,
                        loader_state: Dict[str, Any],
                        stats: Dict[str, float],
                        mesh: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
        fname = f"ckpt-{step:08d}.npz"
        path = os.path.join(self.directory, fname)
        t0 = time.perf_counter()
        parts: Dict[str, float] = {}
        crc = _write_npz_atomic(path, flat, parts)
        entry = {"file": fname, "step": step, "crc32": crc,
                 "fingerprint": fingerprint, "time": time.time(),
                 "loader_state": loader_state}
        if mesh:
            entry["mesh"] = mesh      # mesh_meta(): degrees, quant
        with self._manifest_lock:
            manifest = self._read_manifest()
            manifest["entries"] = [e for e in manifest["entries"]
                                   if e.get("file") != fname] + [entry]
            self._gc(manifest)
            self._write_manifest(manifest)
        write_s = time.perf_counter() - t0
        self.last_save = dict(stats, write_s=write_s, step=step,
                              file_write_s=parts.get("write_s", 0.0),
                              crc_s=parts.get("crc_s", 0.0),
                              file_bytes=os.path.getsize(path))
        log_ckpt.info("saved checkpoint %s (step %d, %.0f ms)",
                      fname, step, 1e3 * write_s)
        return entry

    def _gc(self, manifest: Dict[str, Any]) -> None:
        """Keep the newest `keep_last` entries and delete the rest's
        files; called under the manifest lock, before the manifest
        write (a crash in between only loses superseded snapshots). A
        snapshot that a live delta chain names as its base is kept
        beyond keep_last (watchers behind the chain still need it); it
        goes at the next chain reset."""
        entries = sorted(manifest["entries"], key=lambda e: e.get("step", -1))
        drop, keep = entries[:-self.keep_last], entries[-self.keep_last:]
        chained = {d.get("base_file") for d in manifest.get("deltas", [])}
        chained.discard(None)
        spared = [e for e in drop if e.get("file") in chained]
        for e in drop:
            if e.get("file") in chained:
                continue
            try:
                os.unlink(os.path.join(self.directory, e["file"]))
            except OSError:
                pass
        manifest["entries"] = sorted(spared + keep,
                                     key=lambda e: e.get("step", -1))

    def set_manifest_extra(self, key: str, value: Any) -> None:
        """Set one top-level manifest key (a sidecar pointer such as the
        id histogram's); "entries" and "deltas" are refused."""
        if key in ("entries", "deltas"):
            raise ValueError(f"manifest key {key!r} is reserved")
        with self._manifest_lock:
            manifest = self._read_manifest()
            manifest[key] = value
            self._write_manifest(manifest)

    # --- delta chain (utils/delta.py DeltaPublisher) -------------------
    def delta_entries(self) -> List[Dict[str, Any]]:
        with self._manifest_lock:
            return list(self._read_manifest().get("deltas", []))

    def append_delta_entry(self, entry: Dict[str, Any]) -> None:
        """Append one delta entry to the chain. The delta FILE must
        already be on disk: a crash between the two leaves an unlisted
        file, never a listed but missing one."""
        with self._manifest_lock:
            manifest = self._read_manifest()
            deltas = manifest.setdefault("deltas", [])
            manifest["deltas"] = [e for e in deltas
                                  if e.get("file") != entry.get("file")] \
                + [entry]
            self._write_manifest(manifest)

    def reset_deltas(self) -> int:
        """Retire the delta chain: drop every delta entry from the
        manifest, then delete the files (in that order: a crash between
        leaves orphan files, never dangling entries). Returns how many
        entries were retired."""
        with self._manifest_lock:
            manifest = self._read_manifest()
            retired = list(manifest.get("deltas", []))
            if retired:
                manifest["deltas"] = []
                self._write_manifest(manifest)
        for e in retired:
            try:
                os.unlink(os.path.join(self.directory, e.get("file", "")))
            except OSError:
                pass
        return len(retired)

    # --- restore -------------------------------------------------------
    def entries(self) -> List[Dict[str, Any]]:
        with self._manifest_lock:
            return list(self._read_manifest()["entries"])

    def _entry_valid(self, entry: Dict[str, Any],
                     fingerprint: Optional[str]) -> bool:
        path = os.path.join(self.directory, entry.get("file", ""))
        if not os.path.isfile(path):
            log_ckpt.warning("checkpoint %s listed in manifest but "
                             "missing on disk; skipping", entry.get("file"))
            return False
        if (fingerprint is not None
                and entry.get("fingerprint") not in (None, fingerprint)):
            log_ckpt.warning(
                "checkpoint %s was written by a differently-built model "
                "(fingerprint %s != %s); skipping", entry["file"],
                entry.get("fingerprint"), fingerprint)
            return False
        crc = entry.get("crc32")
        if crc is not None and _file_crc32(path) != crc:
            log_ckpt.warning("checkpoint %s fails its checksum (torn "
                             "write / corruption); skipping", entry["file"])
            return False
        return True

    def latest_valid(self, fingerprint: Optional[str] = None, model=None
                     ) -> Optional[Dict[str, Any]]:
        """Newest entry that exists, checksums clean and (when given)
        matches `fingerprint`; None when no snapshot survives. With a
        ``model`` across ranks, rank 0 decides and every rank gets its
        answer (a collective: every rank calls it)."""
        coll = model._dist() if model is not None else None
        entry = None
        if coll is None or model._is_rank0():
            for e in reversed(self.entries()):
                if self._entry_valid(e, fingerprint):
                    entry = e
                    break
        return entry if coll is None else coll.broadcast_object(entry)

    def restore_latest(self, model) -> Optional[Dict[str, Any]]:
        """Restore the newest valid snapshot into `model`; returns its
        manifest entry (step, loader_state, ...) or None when nothing
        restorable is left. Across ranks rank 0 chooses each candidate
        (present, this model's fingerprint, its CRC-32 clean) and
        broadcasts it, every rank restores it, and the ranks walk back
        together unless every one of them restored it."""
        fp = config_fingerprint(model)
        coll = model._dist()
        chooser = coll is None or model._is_rank0()
        candidates = iter(reversed(self.entries()) if chooser else ())
        while True:
            entry = next((e for e in candidates
                          if self._entry_valid(e, fp)), None)
            if coll is not None:
                entry = coll.broadcast_object(entry)
            if entry is None:
                return None
            path = os.path.join(self.directory, entry["file"])
            try:
                restore_checkpoint(model, path)
                ok = True
            except (ValueError, KeyError, OSError, zlib.error) as e:
                # the checksum passed but the content disagrees with
                # this model, or the zip is unreadable: walk back
                log_ckpt.warning("checkpoint %s did not restore (%s); "
                                 "trying an older snapshot",
                                 entry["file"], e)
                ok = False
            if coll is not None:
                ok = coll.all_true(ok)
            if ok:
                log_ckpt.info("resumed from %s (step %d)", entry["file"],
                              entry["step"])
                return entry


def get_weights(model, op_name: str) -> Dict[str, np.ndarray]:
    """One op's parameters as host arrays, in the port's layout."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.params[op_name].items()}


def set_weights(model, op_name: str, weights) -> None:
    """Write host arrays into one op's parameters (same shapes)."""
    cur = model.params[op_name]
    for k, v in weights.items():
        if k not in cur:
            raise KeyError(f"{op_name} has no parameter {k}")
        if tuple(v.shape) != tuple(cur[k].shape):
            raise ValueError(f"{op_name}.{k}: shape {tuple(v.shape)} != "
                             f"{tuple(cur[k].shape)}")
    for k, v in weights.items():
        with torch.no_grad():
            cur[k].copy_(torch.as_tensor(np.asarray(v)).to(cur[k].dtype))
