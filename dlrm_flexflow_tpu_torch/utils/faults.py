"""Deterministic fault injection for resilience testing (own copy of the
part of ``dlrm_flexflow_tpu.utils.faults`` that the training step, the
checkpoint, data, prefetch, feedback-spool, delta-publish, hot-reload,
serving-fleet and wire-transport modules call).

Failures are injected at fixed, reproducible points so every recovery
branch runs under test:

- **NaN gradients** (`nan_grad_steps`): at the scheduled global steps the
  training step poisons its batch (``poison_batch``: the float label set
  to NaN), so the NaN flows through the real backward into the loss and
  the gradient norm the anomaly sentinel watches.
- **Checkpoint truncation** (`truncate_checkpoints`): truncate the next N
  checkpoint files right after their atomic rename — a torn write or bit
  rot — so ``CheckpointManager.latest_valid`` must fall back to the
  previous snapshot through the manifest's checksum.
- **Write aborts** (`abort_writes`): raise between the temp-file write
  and the ``os.replace``, proving a crashed save never corrupts the
  final path.
- **Write delays** (`write_delay_s`): stretch the window between the temp
  write and the rename, so a kill test can kill inside it.
- **Transient IO errors** (`io_errors`): raise ``IOError`` from reads for
  the first N attempts at a named site (``ffbin_read``, ``prefetch``),
  absorbed by ``data.dataloader.read_with_retries``.
- **Stalled workers** (`stall_s`): sleep a named site once
  (``"prefetch"`` wedges the prefetch ring's staging thread), so the
  ring's liveness deadline must fire.
- **Feedback loss** (`feedback_loss_p`): drop each record offered to the
  feedback spool (``data/replay.py``) with this probability, from a
  seeded generator, so the serve->train loop must train on what
  survives.
- **Torn deltas** (`torn_deltas`): truncate a published delta file
  right after its rename; the watcher's chain CRC check must reject the
  chain and fall back to a full snapshot.
- **Publish aborts** (`publish_aborts`): raise before a delta file's
  rename (a trainer crashing mid-publish); no torn file may appear and
  the manifest must not list it.
- **Delta gaps** (`delta_gaps`): drop a published delta's manifest
  entry, so the next delta's link points at an unlisted step.
- **Corrupt reloads** (`corrupt_reloads`): truncate a snapshot as the
  serving hot reload is about to load it; the reload must reject it.
- **Poisoned reloads** (`poison_reloads`): scale the float parameters
  of a loaded snapshot (a valid file, garbage weights).
- **Replica crash** (`replica_down`): every dispatch and probe of a
  serving replica raises ``ReplicaDown``; the fleet router must eject
  it, drain its queue onto the survivors and, with a finite budget,
  re-admit it. Not consume-once by default: a crashed process stays
  crashed until the budget (if any) runs out.
- **Serving delay** (`serve_delay_s`, per replica
  `serve_delay_replica`): sleep inside every batch dispatch, so one
  replica can be made slow while its siblings stay fast.
- **Network faults** (`net_drop`, `net_dup`, `net_reorder`,
  `net_slow_ms`), applied by ``serve/transport.py`` against real frames
  on a named seam (``lookup``, ``dispatch``, ``publish``, ``manifest``
  or ``any``): a dropped frame is a transient error the client's retry
  absorbs, a duplicated one must be answered from the server's
  request-id dedup window, a reordered one is held until a later frame
  is handled, a slow link sleeps before every frame.

Faults are consume-once: each injection decrements its budget. Activate
them programmatically::

    from dlrm_flexflow_tpu_torch.utils import faults
    with faults.active_plan(faults.FaultPlan(truncate_checkpoints=1)):
        model.fit(...)

or from the environment (read once, at the first hook call):

- ``FF_FAULT_NAN_STEPS=3,7``       NaN gradients at global steps 3 and 7
- ``FF_FAULT_TRUNCATE_CKPTS=1``    truncate the next 1 checkpoint file
- ``FF_FAULT_ABORT_WRITES=1``      abort the next 1 checkpoint save
- ``FF_FAULT_WRITE_DELAY=0.5``     sleep 0.5 s between temp write and rename
- ``FF_FAULT_IO_ERRORS=ffbin_read:2``  2 transient IOErrors at that site
- ``FF_FAULT_FEEDBACK_LOSS=0.2``   drop 20 % of feedback records
  (a probability in 0..1)
- ``FF_FAULT_DELTA_TORN=1``        truncate the next 1 published delta
- ``FF_FAULT_PUBLISH_ABORT=2``     abort the next 2 delta publishes
- ``FF_FAULT_DELTA_GAP=1``         drop the next 1 delta's manifest entry
- ``FF_FAULT_CORRUPT_RELOAD=1``    truncate the next 1 snapshot file as
  the serving hot reload opens it
- ``FF_FAULT_POISON_RELOAD=1``     scale the params of the next 1
  snapshot the hot reload loads
- ``FF_FAULT_CACHE_CORRUPT=1``     truncate the next 1 shard warm-cache
  entry as it is read
- ``FF_FAULT_SHARD_DOWN=1``        serving shard 1 is dead (every lookup
  and probe raises); ``1:8`` fails its next 8 attempts, then recovers
- ``FF_FAULT_LOOKUP_DELAY=0.05``   sleep 50 ms inside every shard lookup;
  ``1:0.2`` slows only shard 1
- ``FF_FAULT_INDEX_STALE=0:2``     shard 0 answers its next 2 top-k calls
  from the index block the last publish displaced (strictly ``sid:n``)
- ``FF_FAULT_TOPK_DROP=1``         shard 1's top-k raises for good;
  ``1:3`` fails its next 3, then recovers

- ``FF_FAULT_SERVE_DELAY=0.05``    sleep 50 ms inside every serving
  batch dispatch; ``1:0.2`` delays only replica 1, and ``0.05,1:0.2``
  combines them
- ``FF_FAULT_REPLICA_DOWN=1``      serving replica 1 is dead (every
  dispatch and probe raises); ``1:8`` fails its next 8 attempts, then
  recovers
- ``FF_FAULT_NET_DROP=lookup:0.3`` drop each lookup frame with
  probability 0.3 (a seeded draw); ``FF_FAULT_NET_DUP=seam:n``,
  ``FF_FAULT_NET_REORDER=seam:n`` duplicate or reorder the seam's next
  n frames; ``FF_FAULT_NET_SLOW=seam:ms`` adds ms to every frame
- ``FF_FAULT_QUANT_SCALE=emb:1e3`` multiply op ``emb``'s quantized-row
  scales by 1e3 as the next payload of it loads (a delta's rows, a warm
  cache entry; consume-once per op): the load must reject it

The JAX package's other hooks (device loss and return, the stalled
collective, sketch faults) wait for the modules they drive (ROADMAP
queue 1 items 7 and 8): their ``FF_FAULT_*`` keys, and unknown ones,
are a warning here, never a silent no-op. A malformed
value raises ``ValueError`` naming the variable.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .logging import get_logger

log_faults = get_logger("faults")


@dataclass
class FaultPlan:
    """A deterministic schedule of failures. Every budget is
    consume-once and guarded by a lock (checkpoint writes run on a
    background thread)."""

    # global step indices at which the train batch is poisoned to NaN
    nan_grad_steps: Set[int] = field(default_factory=set)
    # number of future checkpoint files to truncate after their rename
    truncate_checkpoints: int = 0
    # bytes to leave when truncating (small enough to corrupt the zip)
    truncate_bytes: int = 64
    # number of future checkpoint saves to abort before the rename
    abort_writes: int = 0
    # seconds to sleep between temp-file write and rename (kill window)
    write_delay_s: float = 0.0
    # site name -> number of transient IOErrors to raise there
    io_errors: Dict[str, int] = field(default_factory=dict)
    # site name ("prefetch") -> seconds to sleep there once
    stall_s: Dict[str, float] = field(default_factory=dict)
    # probability in 0..1 of dropping each record offered to the feedback
    # spool before it lands, drawn from a dedicated seeded generator
    feedback_loss_p: float = 0.0
    # hot-reload snapshot loads whose float params are scaled by
    # poison_reload_scale (a valid file, garbage weights)
    poison_reloads: int = 0
    poison_reload_scale: float = 1e3
    # hot-reload snapshot opens to truncate to corrupt_reload_bytes
    corrupt_reloads: int = 0
    corrupt_reload_bytes: int = 64
    # published delta files to truncate to torn_delta_bytes after their
    # rename
    torn_deltas: int = 0
    torn_delta_bytes: int = 64
    # delta publishes to abort before their rename
    publish_aborts: int = 0
    # delta publishes whose manifest entry is dropped after the file lands
    delta_gaps: int = 0
    # shard warm-cache (utils.warmcache.ShardCache) entry reads to
    # corrupt: the file is truncated to corrupt_cache_bytes as it is
    # read, and the read must reject it with its reason
    corrupt_cache_entries: int = 0
    corrupt_cache_bytes: int = 16
    # serving embedding-shard id -> failed lookups left: the shard raises
    # ShardDown from its lookup, top-k and probe; -1 = dead until the
    # plan clears, N > 0 = the next N attempts fail, then it recovers
    shard_down: Dict[int, int] = field(default_factory=dict)
    # seconds to sleep inside EVERY shard lookup (not consume-once: a
    # deadline test needs a steadily slow shard); per-shard entries
    # override the global one
    lookup_delay_s: float = 0.0
    lookup_delay_shard: Dict[int, float] = field(default_factory=dict)
    # shard id -> top-k answers left to serve from the index block the
    # last publish displaced (consume-once per answer; -1 = until the
    # plan clears)
    index_stale: Dict[int, int] = field(default_factory=dict)
    # shard id -> failed top-k calls left: only the retrieval surface
    # dies, lookups keep serving (budgets as shard_down)
    topk_drop: Dict[int, int] = field(default_factory=dict)
    # seconds to sleep inside EVERY serving batch dispatch (not
    # consume-once); per-replica entries override it for one replica
    serve_delay_s: float = 0.0
    serve_delay_replica: Dict[int, float] = field(default_factory=dict)
    # replica id -> failed dispatches left: the engine raises ReplicaDown
    # from its dispatch; -1 = dead until the plan clears, N > 0 = the
    # next N attempts fail, then it recovers
    replica_down: Dict[int, int] = field(default_factory=dict)
    # the wire transport's faults, by seam ("lookup", "dispatch",
    # "publish", "manifest" or "any"): the probability each frame is
    # dropped before it is sent; frames left to send twice under one
    # request id; frames left for the server to hold until a later one
    # is handled; milliseconds slept before every frame
    net_drop: Dict[str, float] = field(default_factory=dict)
    net_dup: Dict[str, int] = field(default_factory=dict)
    net_reorder: Dict[str, int] = field(default_factory=dict)
    net_slow_ms: Dict[str, float] = field(default_factory=dict)
    # op name -> scale factor: the next quantized payload of that op to
    # load has its row scales multiplied by it (consume-once per op);
    # quant.codec.validate_scales must reject it
    quant_scale: Dict[str, float] = field(default_factory=dict)
    # record of (hook, detail) actually fired, for test assertions
    fired: List[tuple] = field(default_factory=list)

    def __post_init__(self):
        self._lock = threading.Lock()
        # the feedback-loss draws: the same plan drops the same offers,
        # with the JAX package's seed
        self._fb_rng = random.Random(0xFEED)
        # the frame-drop draws, with the JAX package's seed: the same
        # plan drops the same frames in the same order
        self._net_rng = random.Random(0xF0F0)

    def _record(self, hook: str, detail) -> None:
        self.fired.append((hook, detail))
        log_faults.warning("injected fault %s (%s)", hook, detail)


_ACTIVE: Optional[FaultPlan] = None
_ENV_CHECKED = False

# the plan's integer budgets set from the environment
_ENV_BUDGETS = {"FF_FAULT_TRUNCATE_CKPTS": "truncate_checkpoints",
                "FF_FAULT_ABORT_WRITES": "abort_writes",
                "FF_FAULT_DELTA_TORN": "torn_deltas",
                "FF_FAULT_PUBLISH_ABORT": "publish_aborts",
                "FF_FAULT_DELTA_GAP": "delta_gaps",
                "FF_FAULT_CORRUPT_RELOAD": "corrupt_reloads",
                "FF_FAULT_POISON_RELOAD": "poison_reloads",
                "FF_FAULT_CACHE_CORRUPT": "corrupt_cache_entries"}
# the shard tier's per-shard lists ('sid:value,...')
_ENV_SHARD_KEYS = ("FF_FAULT_SHARD_DOWN", "FF_FAULT_LOOKUP_DELAY",
                   "FF_FAULT_INDEX_STALE", "FF_FAULT_TOPK_DROP")
# the fleet's per-replica lists and the wire's per-seam lists
_ENV_REPLICA_KEYS = ("FF_FAULT_SERVE_DELAY", "FF_FAULT_REPLICA_DOWN")
_ENV_NET_KEYS = ("FF_FAULT_NET_DROP", "FF_FAULT_NET_DUP",
                 "FF_FAULT_NET_REORDER", "FF_FAULT_NET_SLOW")
_ENV_KEYS = ("FF_FAULT_NAN_STEPS", "FF_FAULT_WRITE_DELAY",
             "FF_FAULT_IO_ERRORS", "FF_FAULT_FEEDBACK_LOSS",
             "FF_FAULT_QUANT_SCALE") \
    + tuple(_ENV_BUDGETS) + _ENV_SHARD_KEYS + _ENV_REPLICA_KEYS \
    + _ENV_NET_KEYS
# keys of the JAX package's plan whose hooks are not ported yet
_UNPORTED_ENV_KEYS = (
    "FF_FAULT_DROP_DEVICE", "FF_FAULT_RETURN_DEVICE",
    "FF_FAULT_STALL_COLLECTIVE", "FF_FAULT_SKETCH_SKEW")
# the serving seams the transport tags its frames with; an unknown seam
# head would parse and inject nothing, so the parser refuses it
NET_SEAMS = ("lookup", "dispatch", "publish", "manifest", "any")


def _env_int(key: str, raw: str) -> int:
    try:
        return int(raw.strip())
    except ValueError:
        raise ValueError(f"{key}={raw!r}: expected an integer "
                         f"(e.g. {key}=2)") from None


def _env_float(key: str, raw: str) -> float:
    try:
        return float(raw.strip())
    except ValueError:
        raise ValueError(f"{key}={raw!r}: expected a number of seconds "
                         f"(e.g. {key}=0.5)") from None


def _env_int_set(key: str, raw: str) -> Set[int]:
    return {_env_int(key, s) for s in raw.split(",") if s.strip()}


def _env_pairs(key: str, raw: str, val, bare=None) -> list:
    """Parse 'a:b,c:d' lists: each item is (int(a), val(b)); a bare item
    (no colon) maps through ``bare`` (None = reject it)."""
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            head, tail = part.split(":", 1)
            if ":" in tail:
                raise ValueError(
                    f"{key}={raw!r}: item {part!r} has more than one "
                    f"':' — expected 'id:value'")
            out.append((_env_int(key, head), val(key, tail)))
        elif bare is None:
            raise ValueError(
                f"{key}={raw!r}: item {part!r} is missing its ':' "
                f"(expected 'id:value')")
        else:
            out.append((None, bare(key, part)))
    return out


def _env_seam_pairs(key: str, raw: str, val) -> Dict[str, float]:
    """Parse the FF_FAULT_NET_* 'seam:value,...' lists: a missing ':',
    an empty seam or an unknown seam raises, naming the variable."""
    out: Dict[str, float] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(
                f"{key}={raw!r}: item {part!r} is missing its ':' "
                f"(expected 'seam:value', e.g. {key}=lookup:0.3)")
        seam, tail = part.rsplit(":", 1)
        seam = seam.strip()
        if not seam:
            raise ValueError(
                f"{key}={raw!r}: item {part!r} has an empty seam name "
                f"(expected 'seam:value', e.g. {key}=lookup:0.3)")
        if seam not in NET_SEAMS:
            raise ValueError(
                f"{key}={raw!r}: unknown seam {seam!r} — valid seams "
                f"are {', '.join(NET_SEAMS)}")
        out[seam] = val(key, tail)
    return out


def plan_from_env() -> Optional[FaultPlan]:
    """Build a plan from the ``FF_FAULT_*`` variables this module
    honours; None when none is set. The others warn."""
    for k in sorted(os.environ):
        if not k.startswith("FF_FAULT_") or k in _ENV_KEYS:
            continue
        if k in _UNPORTED_ENV_KEYS:
            log_faults.warning(
                "%s is set but its hook is not ported yet (ROADMAP queue "
                "1 items 7 and 8); it injects nothing here", k)
        else:
            log_faults.warning("unknown fault variable %s ignored; known: "
                               "%s", k, list(_ENV_KEYS))
    nan = os.environ.get("FF_FAULT_NAN_STEPS", "")
    delay = os.environ.get("FF_FAULT_WRITE_DELAY", "")
    ioerrs = os.environ.get("FF_FAULT_IO_ERRORS", "")
    feedback_loss = os.environ.get("FF_FAULT_FEEDBACK_LOSS", "")
    quant_scale = os.environ.get("FF_FAULT_QUANT_SCALE", "")
    budgets = {k: os.environ.get(k, "") for k in _ENV_BUDGETS}
    shard = {k: os.environ.get(k, "") for k in _ENV_SHARD_KEYS}
    replica = {k: os.environ.get(k, "") for k in _ENV_REPLICA_KEYS}
    net = {k: os.environ.get(k, "") for k in _ENV_NET_KEYS}
    if not any((nan, delay, ioerrs, feedback_loss, quant_scale,
                *budgets.values(),
                *shard.values(), *replica.values(), *net.values())):
        return None
    plan = FaultPlan()
    if nan:
        plan.nan_grad_steps = _env_int_set("FF_FAULT_NAN_STEPS", nan)
    for k, raw in budgets.items():
        if raw:
            setattr(plan, _ENV_BUDGETS[k], _env_int(k, raw))
    if delay:
        plan.write_delay_s = _env_float("FF_FAULT_WRITE_DELAY", delay)
    for part in ioerrs.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(
                f"FF_FAULT_IO_ERRORS={ioerrs!r}: item {part!r} is "
                f"missing its ':' (expected 'site:count', e.g. "
                f"ffbin_read:2)")
        site, n = part.rsplit(":", 1)
        plan.io_errors[site.strip()] = _env_int("FF_FAULT_IO_ERRORS", n)
    for sid, n in _env_pairs("FF_FAULT_SHARD_DOWN",
                             shard["FF_FAULT_SHARD_DOWN"], _env_int,
                             bare=_env_int):
        if sid is None:                       # bare sid: dead for good
            plan.shard_down[n] = -1
        else:                                 # "sid:N": N failed lookups
            plan.shard_down[sid] = n
    for sid, secs in _env_pairs("FF_FAULT_LOOKUP_DELAY",
                                shard["FF_FAULT_LOOKUP_DELAY"], _env_float,
                                bare=_env_float):
        if sid is None:                       # bare seconds: every shard
            plan.lookup_delay_s = secs
        else:                                 # "sid:secs": one shard
            plan.lookup_delay_shard[sid] = secs
    # strictly 'sid:n': a bare sid is ambiguous between "stale once" and
    # "stale for good"
    for sid, n in _env_pairs("FF_FAULT_INDEX_STALE",
                             shard["FF_FAULT_INDEX_STALE"], _env_int):
        plan.index_stale[sid] = n
    for sid, n in _env_pairs("FF_FAULT_TOPK_DROP",
                             shard["FF_FAULT_TOPK_DROP"], _env_int,
                             bare=_env_int):
        if sid is None:                       # bare sid: dropped for good
            plan.topk_drop[n] = -1
        else:                                 # "sid:N": N failed top-ks
            plan.topk_drop[sid] = n
    for rid, secs in _env_pairs("FF_FAULT_SERVE_DELAY",
                                replica["FF_FAULT_SERVE_DELAY"],
                                _env_float, bare=_env_float):
        if rid is None:                       # bare seconds: every replica
            plan.serve_delay_s = secs
        else:                                 # "rid:secs": one replica
            plan.serve_delay_replica[rid] = secs
    for rid, n in _env_pairs("FF_FAULT_REPLICA_DOWN",
                             replica["FF_FAULT_REPLICA_DOWN"], _env_int,
                             bare=_env_int):
        if rid is None:                       # bare rid: dead for good
            plan.replica_down[n] = -1
        else:                                 # "rid:N": N failures
            plan.replica_down[rid] = n
    raw = net["FF_FAULT_NET_DROP"]
    if raw:
        plan.net_drop = _env_seam_pairs("FF_FAULT_NET_DROP", raw,
                                        _env_float)
        for seam, p in plan.net_drop.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"FF_FAULT_NET_DROP={raw!r}: drop probability for "
                    f"seam {seam!r} is {p} (expected 0..1)")
    if net["FF_FAULT_NET_DUP"]:
        plan.net_dup = _env_seam_pairs(
            "FF_FAULT_NET_DUP", net["FF_FAULT_NET_DUP"], _env_int)
    if net["FF_FAULT_NET_REORDER"]:
        plan.net_reorder = _env_seam_pairs(
            "FF_FAULT_NET_REORDER", net["FF_FAULT_NET_REORDER"], _env_int)
    if net["FF_FAULT_NET_SLOW"]:
        plan.net_slow_ms = _env_seam_pairs(
            "FF_FAULT_NET_SLOW", net["FF_FAULT_NET_SLOW"], _env_float)
    for part in quant_scale.split(","):
        # 'op:factor': op names are strings, so not _env_pairs' int heads
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(
                f"FF_FAULT_QUANT_SCALE={quant_scale!r}: item {part!r} "
                f"is missing its ':' (expected 'op:factor', e.g. "
                f"emb_stack:1e3)")
        op_name, factor = part.rsplit(":", 1)
        plan.quant_scale[op_name.strip()] = _env_float(
            "FF_FAULT_QUANT_SCALE", factor)
    if feedback_loss:
        plan.feedback_loss_p = _env_float("FF_FAULT_FEEDBACK_LOSS",
                                          feedback_loss)
        if not 0.0 <= plan.feedback_loss_p <= 1.0:
            raise ValueError(
                f"FF_FAULT_FEEDBACK_LOSS={feedback_loss!r}: drop "
                f"probability is {plan.feedback_loss_p} (expected 0..1)")
    return plan


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Set (or clear, with None) the process-wide active plan."""
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = plan
    _ENV_CHECKED = True   # an explicit install overrides the environment
    return plan


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    """The active plan; adopts the ``FF_FAULT_*`` variables once."""
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        _ACTIVE = plan_from_env()
    return _ACTIVE


@contextlib.contextmanager
def active_plan(plan: FaultPlan):
    """Scoped installation for tests."""
    global _ACTIVE, _ENV_CHECKED
    prev, prev_checked = _ACTIVE, _ENV_CHECKED
    install(plan)
    try:
        yield plan
    finally:
        _ACTIVE, _ENV_CHECKED = prev, prev_checked


# ---------------------------------------------------------------------
# hooks: no-ops when no plan is active
# ---------------------------------------------------------------------
def take_nan_grad(step: int) -> bool:
    """True exactly once for each scheduled NaN-gradient step."""
    plan = active()
    if plan is None:
        return False
    with plan._lock:
        if step in plan.nan_grad_steps:
            plan.nan_grad_steps.discard(step)
            plan._record("nan_grad", step)
            return True
    return False


def take_feedback_loss() -> bool:
    """True when the next record offered to the feedback spool is to be
    dropped before it lands (``FF_FAULT_FEEDBACK_LOSS=p``): drawn per
    offer from the plan's seeded generator, so a run drops the same
    offers every time; recorded once in ``fired``."""
    plan = active()
    if plan is None or plan.feedback_loss_p <= 0:
        return False
    with plan._lock:
        if plan._fb_rng.random() >= plan.feedback_loss_p:
            return False
        if ("feedback_loss", "spool") not in plan.fired:
            plan._record("feedback_loss", "spool")
    return True


def poison_batch(device_batch: dict, row: Optional[int] = None) -> dict:
    """A copy of a staged batch whose float ``"label"`` (or, when the label
    is an integer one, the first float input) is NaN: a new tensor of the
    same shape, dtype and device, made on the current stream, so the NaN
    flows through the real backward. With ``row`` only that index of the
    leading axis is NaN. The other tensors are the batch's own."""
    import torch

    out = dict(device_batch)
    target = None
    lab = out.get("label")
    if lab is not None and lab.is_floating_point():
        target = "label"
    else:
        target = next((k for k, v in out.items()
                       if k != "label" and v.is_floating_point()), None)
    if target is None:
        raise ValueError("no float tensor in batch to poison with NaNs")
    v = out[target]
    if row is None:
        out[target] = torch.full_like(v, float("nan"))
    else:
        nan = v.clone()
        nan[row] = float("nan")
        out[target] = nan
    return out


def maybe_stall(site: str) -> None:
    """Sleep once at a named site (a wedged worker), outside the plan's
    lock."""
    plan = active()
    if plan is None:
        return
    with plan._lock:
        secs = plan.stall_s.pop(site, 0.0)
        if secs > 0:
            plan._record("stall", (site, secs))
    if secs > 0:
        time.sleep(secs)


def maybe_abort_write(path: str) -> None:
    """Raise IOError before the atomic rename (a save crash)."""
    plan = active()
    if plan is None:
        return
    with plan._lock:
        if plan.abort_writes > 0:
            plan.abort_writes -= 1
            plan._record("abort_write", path)
            raise IOError(f"injected checkpoint write abort: {path}")


def maybe_delay_write() -> None:
    """Sleep inside the temp-write -> rename window."""
    plan = active()
    if plan is not None and plan.write_delay_s > 0:
        time.sleep(plan.write_delay_s)


def maybe_truncate_file(path: str) -> bool:
    """Truncate a just-written checkpoint file (a torn write)."""
    plan = active()
    if plan is None:
        return False
    with plan._lock:
        if plan.truncate_checkpoints <= 0:
            return False
        plan.truncate_checkpoints -= 1
        plan._record("truncate", path)
    with open(path, "r+b") as f:
        f.truncate(plan.truncate_bytes)
    return True


def maybe_io_error(site: str) -> None:
    """Raise a transient IOError at a named read site while its budget
    lasts."""
    plan = active()
    if plan is None:
        return
    with plan._lock:
        left = plan.io_errors.get(site, 0)
        if left > 0:
            plan.io_errors[site] = left - 1
            plan._record("io_error", site)
            raise IOError(f"injected transient IO error at {site!r} "
                          f"({left - 1} left)")


def maybe_abort_publish(path: str) -> None:
    """Raise IOError before a delta file's atomic rename (the trainer
    crashing mid-publish): the writer removes its temp file, and the
    manifest never gains the entry."""
    plan = active()
    if plan is None:
        return
    with plan._lock:
        if plan.publish_aborts > 0:
            plan.publish_aborts -= 1
            plan._record("publish_abort", path)
            raise IOError(f"injected delta publish abort: {path}")


def maybe_torn_delta(path: str) -> bool:
    """Truncate a just-published delta file (a torn write after the
    rename): the watcher's chain CRC check must reject the chain."""
    plan = active()
    if plan is None:
        return False
    with plan._lock:
        if plan.torn_deltas <= 0:
            return False
        plan.torn_deltas -= 1
        plan._record("torn_delta", path)
    with open(path, "r+b") as f:
        f.truncate(plan.torn_delta_bytes)
    return True


def take_delta_gap() -> bool:
    """True once per budgeted gap: the publisher drops this delta's
    manifest entry after the file lands, so the next delta links to an
    unlisted step and the watcher must see the gap."""
    plan = active()
    if plan is None:
        return False
    with plan._lock:
        if plan.delta_gaps <= 0:
            return False
        plan.delta_gaps -= 1
        plan._record("delta_gap", None)
    return True


def maybe_corrupt_reload(path: str) -> bool:
    """Truncate a snapshot as the serving hot reload is about to load it
    (after the manifest listed it as valid): the load must reject it and
    the engine keep serving the old weights."""
    plan = active()
    if plan is None:
        return False
    with plan._lock:
        if plan.corrupt_reloads <= 0:
            return False
        plan.corrupt_reloads -= 1
        plan._record("corrupt_reload", path)
    try:
        with open(path, "r+b") as f:
            f.truncate(plan.corrupt_reload_bytes)
    except OSError:
        return False
    return True


def maybe_poison_reload(state: dict) -> dict:
    """Scale the float parameters of a loaded snapshot state (the output
    of ``checkpoint.load_params_for_swap``) while the budget lasts: a
    snapshot that passes every integrity check but computes garbage.
    Returns a new state; the tensors keep their device and dtype."""
    plan = active()
    if plan is None:
        return state
    with plan._lock:
        if plan.poison_reloads <= 0:
            return state
        plan.poison_reloads -= 1
        scale = plan.poison_reload_scale
        plan._record("poison_reload", scale)
    out = dict(state)
    if out.get("params") is not None:
        out["params"] = {
            op: {pn: (v * scale if v.is_floating_point() else v)
                 for pn, v in p.items()}
            for op, p in out["params"].items()}
    return out


def maybe_corrupt_cache(path: str) -> bool:
    """Truncate a shard warm-cache entry as it is about to be read (a
    torn write or bit rot): the read must reject it with its reason and
    the replacement shard boot cold, never load garbage."""
    plan = active()
    if plan is None:
        return False
    with plan._lock:
        if plan.corrupt_cache_entries <= 0:
            return False
        if not os.path.isfile(path):
            return False    # nothing to corrupt yet; keep the budget
        plan.corrupt_cache_entries -= 1
        plan._record("cache_corrupt", path)
    try:
        with open(path, "r+b") as f:
            f.truncate(plan.corrupt_cache_bytes)
    except OSError:
        return False
    return True


def _take_budget(table: str, hook: str,
                 shard_id: Optional[int]) -> bool:
    plan = active()
    if plan is None or shard_id is None:
        return False
    with plan._lock:
        left = getattr(plan, table).get(shard_id)
        if left is None or left == 0:
            return False
        if left > 0:
            getattr(plan, table)[shard_id] = left - 1
        if (hook, shard_id) not in plan.fired:
            plan._record(hook, shard_id)
    return True


def take_shard_down(shard_id: Optional[int]) -> bool:
    """True while a serving embedding shard is scheduled dead: it raises
    ``ShardDown`` from its lookup, top-k and probe, and the tier's
    circuit breaker must absorb that (the ranker degrades to cache hits
    plus default rows). ``-1`` = dead until the plan clears, ``N > 0`` =
    the next N attempts fail, then the shard recovers."""
    return _take_budget("shard_down", "shard_down", shard_id)


def take_topk_drop(shard_id: Optional[int]) -> bool:
    """True while a shard's retrieval surface is scheduled dead: its
    ``topk`` raises ``ShardDown`` while lookups keep serving, and the
    cascade must drop that shard's candidates, flagged."""
    return _take_budget("topk_drop", "topk_drop", shard_id)


def take_index_stale(shard_id: Optional[int]) -> bool:
    """True when this top-k answer comes from the index block the last
    publish displaced (consume-once per answer); the shard reports that
    block's version, so the version vector tells the truth."""
    return _take_budget("index_stale", "index_stale", shard_id)


def maybe_lookup_delay(shard_id: Optional[int] = None) -> None:
    """Sleep inside a shard lookup (every lookup while the plan is
    active); a per-shard entry overrides the global delay."""
    plan = active()
    if plan is None:
        return
    secs = plan.lookup_delay_s
    if shard_id is not None:
        secs = plan.lookup_delay_shard.get(shard_id, secs)
    if secs > 0:
        time.sleep(secs)


def maybe_serve_delay(replica_id: Optional[int] = None) -> None:
    """Sleep inside a serving batch dispatch (every dispatch while the
    plan is active); a per-replica entry overrides the global delay, so
    one replica of a fleet can be made slow."""
    plan = active()
    if plan is None:
        return
    secs = plan.serve_delay_s
    if replica_id is not None:
        secs = plan.serve_delay_replica.get(replica_id, secs)
    if secs > 0:
        time.sleep(secs)


def take_replica_down(replica_id: Optional[int]) -> bool:
    """True while a serving replica is scheduled dead: the engine raises
    ``ReplicaDown`` from its dispatch, which the router's circuit breaker
    must absorb. ``-1`` = dead until the plan clears, ``N > 0`` = the
    next N attempts fail, then the replica recovers."""
    return _take_budget("replica_down", "replica_down", replica_id)


def _net_value(table: Dict[str, float], seam: str):
    """A seam's entry, with ``any`` as the fallback (the exact seam
    wins)."""
    if seam in table:
        return seam, table[seam]
    if "any" in table:
        return "any", table["any"]
    return None, None


def take_net_drop(seam: str) -> bool:
    """True when this seam's next frame is dropped before it is sent
    (``FF_FAULT_NET_DROP=seam:p``, a draw per frame from the plan's
    seeded generator): the transport raises a transient error and its
    bounded retry must absorb it."""
    plan = active()
    if plan is None or not plan.net_drop:
        return False
    with plan._lock:
        key, p = _net_value(plan.net_drop, seam)
        if key is None or p <= 0:
            return False
        if plan._net_rng.random() >= p:
            return False
        if ("net_drop", seam) not in plan.fired:
            plan._record("net_drop", seam)
    return True


def _take_net(table: str, hook: str, seam: str) -> bool:
    plan = active()
    if plan is None or not getattr(plan, table):
        return False
    with plan._lock:
        key, left = _net_value(getattr(plan, table), seam)
        if key is None or not left:
            return False
        if left > 0:
            getattr(plan, table)[key] = left - 1
        plan._record(hook, seam)
    return True


def take_net_dup(seam: str) -> bool:
    """True when this seam's next frame is sent twice under one request
    id (``FF_FAULT_NET_DUP=seam:n``, consume-once): the server's dedup
    window must answer the second from its cache."""
    return _take_net("net_dup", "net_dup", seam)


def take_net_reorder(seam: str) -> bool:
    """True when this seam's next received frame is held until a later
    frame has been handled (``FF_FAULT_NET_REORDER=seam:n``,
    consume-once; bounded by a timeout so a lone frame cannot
    deadlock)."""
    return _take_net("net_reorder", "net_reorder", seam)


def maybe_net_slow(seam: str) -> None:
    """Sleep before sending a frame on this seam
    (``FF_FAULT_NET_SLOW=seam:ms``, every frame while the plan is
    active)."""
    plan = active()
    if plan is None or not plan.net_slow_ms:
        return
    _key, ms = _net_value(plan.net_slow_ms, seam)
    if ms and ms > 0:
        time.sleep(ms / 1e3)


def maybe_corrupt_quant_scale(key: str, scales):
    """Corrupt a quantized payload's row scales as it loads
    (``FF_FAULT_QUANT_SCALE=op:factor``): any key naming the op fires,
    once per op. The caller's ``quant.codec.validate_scales`` must
    reject the payload: a scaled-up scale serves amplified rows with no
    NaN for the sentinel to see."""
    plan = active()
    if plan is None or not plan.quant_scale:
        return scales
    with plan._lock:
        hit = None
        for op_name, factor in plan.quant_scale.items():
            if op_name and op_name in key:
                hit = (op_name, factor)
                break
        if hit is None:
            return scales
        del plan.quant_scale[hit[0]]
        plan._record("quant_scale", f"{key}:{hit[1]:g}")
    import numpy as np
    return np.asarray(scales, np.float32) * np.float32(hit[1])
