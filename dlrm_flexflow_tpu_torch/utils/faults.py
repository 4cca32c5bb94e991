"""Deterministic fault injection for resilience testing (own copy of the
part of ``dlrm_flexflow_tpu.utils.faults`` that the training step, the
checkpoint, data, prefetch and feedback-spool modules call).

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

The JAX package's other hooks (device loss and return, serving,
network, cache and shard faults) wait for the modules they drive
(ROADMAP queue 1 items 7 and 9): their ``FF_FAULT_*`` keys, and
unknown ones, are a warning here, never a silent no-op. A malformed
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
    # record of (hook, detail) actually fired, for test assertions
    fired: List[tuple] = field(default_factory=list)

    def __post_init__(self):
        self._lock = threading.Lock()
        # the feedback-loss draws: the same plan drops the same offers,
        # with the JAX package's seed
        self._fb_rng = random.Random(0xFEED)

    def _record(self, hook: str, detail) -> None:
        self.fired.append((hook, detail))
        log_faults.warning("injected fault %s (%s)", hook, detail)


_ACTIVE: Optional[FaultPlan] = None
_ENV_CHECKED = False

_ENV_KEYS = ("FF_FAULT_NAN_STEPS", "FF_FAULT_TRUNCATE_CKPTS",
             "FF_FAULT_ABORT_WRITES", "FF_FAULT_WRITE_DELAY",
             "FF_FAULT_IO_ERRORS", "FF_FAULT_FEEDBACK_LOSS")
# keys of the JAX package's plan whose hooks are not ported yet
_UNPORTED_ENV_KEYS = (
    "FF_FAULT_DROP_DEVICE", "FF_FAULT_RETURN_DEVICE",
    "FF_FAULT_STALL_COLLECTIVE", "FF_FAULT_SERVE_DELAY",
    "FF_FAULT_CORRUPT_RELOAD", "FF_FAULT_REPLICA_DOWN",
    "FF_FAULT_POISON_RELOAD", "FF_FAULT_DELTA_TORN",
    "FF_FAULT_PUBLISH_ABORT", "FF_FAULT_DELTA_GAP",
    "FF_FAULT_CACHE_CORRUPT", "FF_FAULT_SHARD_DOWN",
    "FF_FAULT_LOOKUP_DELAY", "FF_FAULT_QUANT_SCALE", "FF_FAULT_NET_DROP",
    "FF_FAULT_NET_DUP", "FF_FAULT_NET_REORDER", "FF_FAULT_NET_SLOW",
    "FF_FAULT_SKETCH_SKEW",
    "FF_FAULT_INDEX_STALE", "FF_FAULT_TOPK_DROP")


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


def plan_from_env() -> Optional[FaultPlan]:
    """Build a plan from the ``FF_FAULT_*`` variables this module
    honours; None when none is set. The others warn."""
    for k in sorted(os.environ):
        if not k.startswith("FF_FAULT_") or k in _ENV_KEYS:
            continue
        if k in _UNPORTED_ENV_KEYS:
            log_faults.warning(
                "%s is set but its hook is not ported yet (ROADMAP queue "
                "1 items 7 and 9); it injects nothing here", k)
        else:
            log_faults.warning("unknown fault variable %s ignored; known: "
                               "%s", k, list(_ENV_KEYS))
    nan = os.environ.get("FF_FAULT_NAN_STEPS", "")
    trunc = os.environ.get("FF_FAULT_TRUNCATE_CKPTS", "")
    aborts = os.environ.get("FF_FAULT_ABORT_WRITES", "")
    delay = os.environ.get("FF_FAULT_WRITE_DELAY", "")
    ioerrs = os.environ.get("FF_FAULT_IO_ERRORS", "")
    feedback_loss = os.environ.get("FF_FAULT_FEEDBACK_LOSS", "")
    if not any((nan, trunc, aborts, delay, ioerrs, feedback_loss)):
        return None
    plan = FaultPlan()
    if nan:
        plan.nan_grad_steps = _env_int_set("FF_FAULT_NAN_STEPS", nan)
    if trunc:
        plan.truncate_checkpoints = _env_int("FF_FAULT_TRUNCATE_CKPTS",
                                             trunc)
    if aborts:
        plan.abort_writes = _env_int("FF_FAULT_ABORT_WRITES", aborts)
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
