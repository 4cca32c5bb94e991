"""Zero-downtime snapshot hot reload for the serving engine (the port of
``dlrm_flexflow_tpu.serve.watcher``).

A trainer publishes rolling snapshots through ``CheckpointManager`` and,
in the continual loop, delta snapshots chained off them through
``utils.delta.DeltaPublisher``. The :class:`SnapshotWatcher` polls that
directory READ-ONLY from the serving process: it builds no
``CheckpointManager``, whose start-up sweep of ``*.tmp-*`` files would
race a live trainer's write.

Reload strategy, freshest first:

1. **Delta chain**: when the manifest lists a chain whose tip is newer
   than the served version, the whole chain is validated first
   (``resolve_chain``: links contiguous, every file present and its
   CRC-32 clean, fingerprints this model's, base unchanged). An engine
   already at a chain node loads only the deltas past it; a cold one
   loads the base snapshot and the whole chain. Files are read and the
   rows staged on the device (``stage_delta_rows``: pinned memory, a
   side stream, an event) on this thread, outside any dispatch; the
   engine applies them between dispatches.
2. **Fallback**: any chain problem — a gap, a torn or missing delta, a
   replaced base, a foreign fingerprint, a load or apply failure — is
   rejected with its reason (once per cause, ``record_reload_reject``)
   and the watcher falls back to the newest valid FULL snapshot. A
   request never fails for it.

Transient IO is retried by ``read_with_retries``; consecutive failing
polls back off exponentially with jitter up to ``backoff_max_s``, and a
poll that installs something returns to the base interval.
``stats()`` shows the polls, failures, delta installs and fallbacks.

**Wire mode** (``wire=`` a ``serve/transport.py``
``SnapshotWireSource``): the publish directory lives in another process
(a ``SnapshotServer``); manifest polls and file reads go over the wire
with their own retry and backoff, and fetched files spool into the
source's local directory, so the loaders' zip validation and chain CRCs
run unchanged on local paths.

**Reshard** (``elastic``, the engine's ``ServeConfig.reshard``): a full
snapshot records the mesh its trainer ran on; a one-card engine
following a trainer across ranks takes it only with ``elastic`` set
(the file's arrays are whole, so the engine's model takes them as they
are) and otherwise rejects it with the JAX package's reason
(``checkpoint.check_mesh_meta``). Deltas carry rows of the whole stored
arrays and record no mesh.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Dict, Optional

from ..data.dataloader import read_with_retries
from ..obs import metrics as obsm
from ..obs import trace as obstrace
from ..utils import faults
from ..utils.checkpoint import (_file_crc32, config_fingerprint,
                                load_params_for_swap)
from ..utils.delta import (ChainError, load_delta_file, resolve_chain,
                           stage_delta_rows)


class SnapshotWatcher:
    """Background poller installing newer valid snapshots (full or
    delta-chained) into an :class:`~.engine.InferenceEngine`."""

    MANIFEST = "manifest.json"

    def __init__(self, engine, directory: str, poll_s: float = 0.5,
                 backoff_max_s: float = 30.0, wire=None,
                 elastic: bool = False):
        self._engine = engine
        self.directory = os.path.abspath(directory)
        # wire mode: the files are read through ``wire`` and spooled to
        # its local directory, where the loaders find them
        self._wire = wire
        self._fs_dir = (self.directory if wire is None
                        else os.path.abspath(wire.spool_dir))
        self.poll_s = max(float(poll_s), 0.01)
        self.backoff_max_s = max(float(backoff_max_s), self.poll_s)
        # take full snapshots written under another mesh (reshard)
        self.elastic = bool(elastic)
        self._fingerprint = config_fingerprint(engine.model)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._polls = 0
        # causes already reported to the engine (a permanently bad
        # snapshot would otherwise re-report every poll)
        self._rejected: set = set()
        # every failed attempt, unlike the reject-once report
        self._reload_failures = 0
        self._last_reload_error = ""
        self._consecutive_failures = 0
        self._next_poll_s = self.poll_s
        self._jitter = random.Random(os.getpid() ^ id(self))
        self._delta_installs = 0
        self._chain_fallbacks = 0

    def _record_failure(self, reason: str) -> None:
        self._reload_failures += 1
        self._last_reload_error = reason

    def _reject_once(self, key: tuple, reason: str) -> None:
        self._record_failure(reason)
        if key in self._rejected:
            return
        self._rejected.add(key)
        self._engine.record_reload_reject(reason)

    # --- lifecycle -----------------------------------------------------
    def start(self) -> "SnapshotWatcher":
        if self._thread is not None:
            return self
        obsm.register_collector(self._obs_collect)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ff-serve-watcher")
        self._thread.start()
        return self

    def _obs_collect(self):
        """The freshness loop's health as scrapeable samples."""
        lab = {"replica": ""}
        yield "ff_watcher_polls_total", lab, self._polls
        yield "ff_watcher_reload_failures_total", lab, \
            self._reload_failures
        yield "ff_watcher_delta_installs_total", lab, \
            self._delta_installs
        yield "ff_watcher_chain_fallbacks_total", lab, \
            self._chain_fallbacks
        yield "ff_watcher_consecutive_failures", lab, \
            self._consecutive_failures
        if self._wire is not None:
            yield "ff_watcher_wire_retries_total", lab, \
                self._wire.wire_retries

    def stop(self) -> None:
        obsm.unregister_collector(self._obs_collect)
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            self._poll_tick()
            self._stop.wait(self._next_poll_s)

    def _poll_tick(self) -> bool:
        """One iteration: poll, then re-pace. A poll that installed
        something is a recovery even if it also recorded failures."""
        before = self._reload_failures
        reloaded = False
        try:
            reloaded = self.poll_once()
        except Exception as e:   # noqa: BLE001 — the watcher must
            # never die; a failed poll is a reject, not an outage
            self._record_failure(f"watcher poll error: {e}")
            self._engine.record_reload_reject(f"watcher poll error: {e}")
        if reloaded or self._reload_failures == before:
            self._consecutive_failures = 0
        else:
            self._consecutive_failures += 1
        self._next_poll_s = self._backoff_interval()
        return reloaded

    def _backoff_interval(self) -> float:
        """The base interval normally; exponential in the consecutive
        failures, jittered x0.5-1.0, capped at ``backoff_max_s``."""
        if self._consecutive_failures == 0:
            return self.poll_s
        k = min(self._consecutive_failures, 10)
        base = min(self.poll_s * (2.0 ** k), self.backoff_max_s)
        return max(base * (0.5 + 0.5 * self._jitter.random()),
                   self.poll_s)

    # --- manifest read -------------------------------------------------
    def _read_manifest(self) -> Optional[Dict[str, Any]]:
        if self._wire is not None:
            try:
                m = self._wire.read_manifest()
            except Exception as e:   # noqa: BLE001 — wire budget spent
                self._record_failure(
                    f"manifest unreadable over the wire: {e}")
                return None
            return m if isinstance(m, dict) else None
        path = os.path.join(self.directory, self.MANIFEST)
        if not os.path.isfile(path):
            return None   # nothing published yet, not a failure

        def load():
            with open(path) as f:
                return json.load(f)

        try:
            m = read_with_retries(load, site="snapshot_manifest")
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError) as e:
            self._record_failure(f"manifest unreadable: {e}")
            return None
        return m if isinstance(m, dict) else None

    def _fetch_local(self, name: str) -> Optional[str]:
        """A published file's local path: in the publish directory, or in
        wire mode the spooled copy (a failed fetch reads as a missing
        file, which the callers already skip)."""
        if not name:
            return None
        if self._wire is None:
            return os.path.join(self.directory, name)
        try:
            return self._wire.fetch_file(name)
        except Exception as e:   # noqa: BLE001 — wire budget spent
            self._record_failure(
                f"fetch of {name} over the wire failed: {e}")
            return None

    def _latest_valid(self, entries: list) -> Optional[Dict[str, Any]]:
        """The newest entry that exists, matches this model's
        fingerprint and checksums clean (read-only)."""
        for entry in sorted(entries,
                            key=lambda e: e.get("step", -1), reverse=True):
            path = self._fetch_local(entry.get("file", ""))
            if path is None or not os.path.isfile(path):
                continue
            fp = entry.get("fingerprint")
            if fp not in (None, self._fingerprint):
                self._reject_once(
                    (entry.get("file"), "fingerprint"),
                    f"snapshot {entry.get('file')} fingerprint {fp} != "
                    f"this model's {self._fingerprint} (differently-"
                    f"built model)")
                return None
            crc = entry.get("crc32")
            if crc is not None and _file_crc32(path) != crc:
                self._reject_once(
                    (entry.get("file"), "crc"),
                    f"snapshot {entry.get('file')} fails its CRC-32 "
                    f"(torn write / corruption)")
                continue   # an older snapshot may still be good
            return entry
        return None

    # --- one poll ------------------------------------------------------
    def poll_once(self) -> bool:
        """Check for newer servable state and install it: the delta
        chain first, the newest valid full snapshot otherwise. Returns
        True when a reload happened."""
        self._polls += 1
        manifest = self._read_manifest()
        if manifest is None:
            return False
        if self._try_delta_chain(manifest):
            return True
        return self._try_full(manifest)

    def _load_full(self, path: str) -> Dict[str, Any]:
        state = read_with_retries(
            lambda: load_params_for_swap(self._engine.model, path,
                                         elastic=self.elastic),
            site="snapshot_reload")
        return faults.maybe_poison_reload(state)

    # --- delta chain path ---------------------------------------------
    def _try_delta_chain(self, manifest: Dict[str, Any]) -> bool:
        deltas = manifest.get("deltas")
        if not isinstance(deltas, list) or not deltas:
            return False
        tip_step = max(int(e.get("step", -1)) for e in deltas)
        floor = self._engine.version_floor
        if tip_step <= floor:
            return False
        key = ("chain", tip_step)
        if key in self._rejected:
            return False   # already fell back for this tip
        if self._wire is not None:
            # spool every file the chain could touch (the deltas and the
            # candidate bases) so resolve_chain checks local copies; a
            # failed fetch falls back like any other chain problem
            try:
                for e in deltas:
                    if e.get("file"):
                        self._wire.fetch_file(e["file"])
                for e in (manifest.get("entries") or []):
                    if isinstance(e, dict) and e.get("file"):
                        self._wire.fetch_file(e["file"])
            except Exception as e:   # noqa: BLE001 — wire budget spent
                self._chain_fallbacks += 1
                self._reject_once(
                    key, f"delta chain fetch over the wire failed: {e} — "
                         f"falling back to full reload")
                return False
        try:
            base_entry, chain = resolve_chain(manifest, self._fingerprint,
                                              self._fs_dir)
        except ChainError as e:
            self._chain_fallbacks += 1
            self._reject_once(
                key, f"delta chain rejected: {e} — falling back to "
                     f"full reload")
            return False
        base_step = int(base_entry.get("step", -1))
        applied = self._engine.version
        on_chain = {base_step} | {int(e.get("step", -1)) for e in chain}
        # the engine's version names a chain node only once something
        # was INSTALLED from here: patching rows onto a constructor-time
        # state whose step happens to match would mix lineages
        if (self._engine.has_applied_snapshot and applied in on_chain
                and floor >= base_step and floor in on_chain):
            need_base = False
            pending = [e for e in chain if int(e.get("step", -1)) > floor]
        elif (not self._engine.has_applied_snapshot
                or applied < base_step or floor < base_step):
            need_base = True      # a cold engine: base and whole chain
            pending = chain
        else:
            # between base and tip but not on the chain (a retired
            # chain's snapshot): these deltas could mix lineages
            self._chain_fallbacks += 1
            self._reject_once(
                key, f"delta chain rejected: served version {applied} "
                     f"is not on the chain (base {base_step}, tip "
                     f"{tip_step}) — falling back to full reload")
            return False
        if not pending:
            return False
        t_apply = time.perf_counter()
        try:
            # the slow half on THIS thread: file reads, validation, the
            # rows' copy to the device
            payloads = []
            for e in pending:
                path = os.path.join(self._fs_dir, e["file"])
                payload = read_with_retries(
                    lambda p=path: load_delta_file(p), site="delta_reload")
                payloads.append(stage_delta_rows(self._engine.model,
                                                 payload))
            if need_base:
                base_path = os.path.join(self._fs_dir, base_entry["file"])
                faults.maybe_corrupt_reload(base_path)
                self._engine.install_snapshot(
                    self._load_full(base_path), base_step,
                    source=base_entry["file"])
            for e, payload in zip(pending, payloads):
                self._engine.install_delta(payload,
                                           int(e.get("step", -1)),
                                           source=e["file"])
            self._delta_installs += len(pending)
            obstrace.complete("publish/watcher-apply", t_apply,
                              kind="delta", installs=len(pending),
                              tip=tip_step)
        except Exception as e:   # noqa: BLE001
            self._chain_fallbacks += 1
            obstrace.instant("publish/chain-fallback",
                             reason=str(e)[:200])
            self._reject_once(
                key, f"delta chain failed to load/apply: {e} — falling "
                     f"back to full reload")
            return False
        if self._engine.version != tip_step:
            # an apply failed between dispatches (the engine rolled its
            # version back and recorded the reject): fall back
            self._chain_fallbacks += 1
            self._record_failure(
                f"delta chain applied partially (at version "
                f"{self._engine.version}, tip {tip_step})")
            self._rejected.add(key)
            return False
        return True

    # --- full-snapshot path ---------------------------------------------
    def _try_full(self, manifest: Dict[str, Any]) -> bool:
        entries = manifest.get("entries")
        entries = entries if isinstance(entries, list) else []
        if self._wire is not None:
            # spool only snapshots that could install: each wire fetch
            # reads the whole file again
            entries = [e for e in entries if isinstance(e, dict)
                       and int(e.get("step", -1)) > self._engine.version]
        entry = self._latest_valid(entries)
        if entry is None:
            return False
        step = int(entry.get("step", -1))
        if step <= self._engine.version:
            return False
        path = os.path.join(self._fs_dir, entry["file"])
        # fault window: the file torn AFTER the CRC check and BEFORE the
        # load below; the load must reject it
        faults.maybe_corrupt_reload(path)
        t_apply = time.perf_counter()
        try:
            state = self._load_full(path)
        except Exception as e:   # noqa: BLE001
            self._reject_once(
                (entry["file"], "load"),
                f"snapshot {entry['file']} failed to load: {e}")
            return False
        self._engine.install_snapshot(state, step, source=entry["file"])
        obstrace.complete("publish/watcher-apply", t_apply, kind="full",
                          step=step)
        return True

    def stats(self) -> Dict[str, Any]:
        return {"directory": self.directory, "polls": self._polls,
                "version_floor": self._engine.version_floor,
                "poll_s": self.poll_s,
                "next_poll_s": self._next_poll_s,
                "consecutive_failures": self._consecutive_failures,
                "delta_installs": self._delta_installs,
                "chain_fallbacks": self._chain_fallbacks,
                "reload_failures": self._reload_failures,
                "last_reload_error": self._last_reload_error,
                "wire_retries": (0 if self._wire is None
                                 else self._wire.wire_retries),
                "last_wire_error": ("" if self._wire is None
                                    else self._wire.last_wire_error)}
