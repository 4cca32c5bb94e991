"""Pipelined input staging: a depth-K prefetch ring fed by a background
staging thread (the port of ``dlrm_flexflow_tpu.data.prefetch``).

A staging thread runs ``produce(i)`` for future step indices — slice the
host batch, copy it to the card — and parks the results in a bounded
ring while the consumer trains the current step.

Contracts (tests/test_torch_prefetch.py pins all three):

- **Order**: items are delivered strictly in produce order (i = 0, 1,
  2, ...), so a deterministic ``produce`` makes prefetched training
  bitwise equal to calling it inline.
- **Errors**: transient ``IOError``/``OSError`` from ``produce`` are
  first absorbed by ``dataloader.read_with_retries``; anything that
  survives is raised at the consumer's next :meth:`get` — the step
  boundary. The error is sticky: the producer is dead, and the pipeline
  must be rebuilt.
- **Drain**: :meth:`close` stops the producer, discards staged items and
  joins the thread. Call it before anything that invalidates staged
  work (a checkpoint restore, a loader state capture) and rebuild
  afterwards.

On the card a staged batch (:class:`StagedBatch`) is pinned host memory
copied ``non_blocking`` on a side CUDA stream, with an event recorded
after the copies. The consumer's :meth:`StagedBatch.wait` makes its own
stream wait on that event, so no kernel reads a batch still in flight,
and ``record_stream``-s each tensor to it, so the caching allocator does
not hand a staged buffer to the next copy while a step still reads it.
Neither takes a host synchronisation.

With ``--obs on`` each staging call is a ``prefetch/produce`` span on
the staging thread's lane, and the ring's ``stats()`` are scraped as the
JAX ring's ``ff_prefetch_*`` series.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..obs import metrics as obsm
from ..obs import trace as obstrace
from ..utils.watchdog import StallReport, WorkerStalled

# every staging thread in the process is distinguishable in a stack dump
# or stall report (ff-prefetch-0, ...)
_PIPE_SEQ = itertools.count()


def stack_batches(batches):
    """Stack a list of same-keyed host batches into one ``[K, ...]``
    megabatch dict. All batches must share keys, shapes and dtypes; a
    ragged list raises here."""
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    keys = set(batches[0])
    for i, b in enumerate(batches[1:], 1):
        if set(b) != keys:
            raise ValueError(
                f"batch {i} keys {sorted(b)} differ from batch 0 keys "
                f"{sorted(keys)}; superstep batches must be homogeneous")
    out = {}
    for k in batches[0]:
        arrs = [np.asarray(b[k]) for b in batches]
        if any(a.shape != arrs[0].shape or a.dtype != arrs[0].dtype
               for a in arrs[1:]):
            raise ValueError(
                f"input {k!r} has ragged shapes/dtypes across batches; "
                f"superstep batches must be homogeneous")
        out[k] = np.stack(arrs)
    return out


class StagedBatch:
    """A batch staged on its device by a staging thread: the tensors and,
    on a CUDA device, the event recorded on the staging stream after the
    last copy; ``host`` holds the inputs that stay on the host (CPU
    tensors: the ids only host-resident tables read)."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 event: Optional["torch.cuda.Event"] = None,
                 device: Optional[torch.device] = None,
                 host: Optional[Dict[str, torch.Tensor]] = None):
        self.tensors = tensors
        self.event = event
        self.device = device
        self.host = host or {}

    def wait(self) -> Dict[str, torch.Tensor]:
        """The tensors, ready for the calling thread's current stream:
        that stream waits on the staging event, and each tensor is
        recorded as used by it. The host inputs join them as they are."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
            self.event = None
        return {**self.tensors, **self.host} if self.host else self.tensors


def stage_batch(arrays: Dict[str, np.ndarray],
                dtypes: Dict[str, torch.dtype], device: torch.device,
                stream: Optional["torch.cuda.Stream"] = None) -> StagedBatch:
    """Copy host arrays to ``device`` as ``dtypes`` (a key -> dtype map).
    On a CUDA device each array is copied to pinned host memory, then to
    the card ``non_blocking`` on ``stream``, converted there, and one
    event marks the end; the caller's :meth:`StagedBatch.wait` orders
    its stream after it. On the CPU the arrays are copied at once."""
    if device.type != "cuda":
        return StagedBatch({k: torch.as_tensor(np.asarray(a)).to(
            dtype=dtypes[k]).clone() for k, a in arrays.items()})
    out = {}
    with torch.cuda.stream(stream):
        for k, a in arrays.items():
            host = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            out[k] = host.to(device, non_blocking=True).to(dtypes[k])
        event = torch.cuda.Event()
        event.record(stream)
    return StagedBatch(out, event, device)


class PrefetchPipeline:
    """Depth-K ring buffer fed by one background staging thread.

    produce    : callable(i) -> item, for i = 0, 1, 2, ...; runs on the
                 staging thread.
    depth      : ring capacity, how many items may be staged ahead.
    num_items  : total items to produce (None = unbounded); ``get()``
                 past the end raises IndexError.
    io_site    : fault-injection and retry site name for the
                 transient-error backoff around every produce call.
    deadline_s : liveness deadline for the staging thread: a ``get()``
                 that waits longer raises :class:`WorkerStalled` with a
                 stall report instead of hanging (None = wait forever).
    """

    def __init__(self, produce: Callable[[int], object], depth: int = 2,
                 num_items: Optional[int] = None, name: str = "prefetch",
                 io_site: str = "prefetch", io_retries: int = 3,
                 io_backoff_s: float = 0.05,
                 deadline_s: Optional[float] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._produce = produce
        self._depth = int(depth)
        self._num = num_items
        self._io_site = io_site
        self._io_retries = io_retries
        self._io_backoff_s = io_backoff_s
        self._deadline_s = deadline_s if deadline_s else None
        self._buf: deque = deque()
        self._cond = threading.Condition()
        self._stopped = False
        self._exc: Optional[BaseException] = None
        self._produced = 0
        self._consumed = 0
        self._produce_s = 0.0
        self._wait_s = 0.0
        self.name = name
        obsm.register_collector(self._obs_collect)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"ff-prefetch-{next(_PIPE_SEQ)}")
        self._thread.start()

    def _obs_collect(self):
        """Registry collector: the ring's ``stats()`` as samples."""
        s = self.stats()
        lab = {"pipeline": self.name}
        yield "ff_prefetch_items_total", lab, s["items"]
        yield "ff_prefetch_produce_seconds_total", lab, s["produce_s"]
        yield "ff_prefetch_wait_seconds_total", lab, s["wait_s"]
        yield "ff_prefetch_overlap_fraction", lab, s["overlap_fraction"]
        yield "ff_prefetch_ring_depth", lab, len(self._buf)

    # --- producer side -------------------------------------------------
    def _run(self):
        from ..utils import faults
        from .dataloader import read_with_retries
        i = 0
        while True:
            with self._cond:
                while len(self._buf) >= self._depth and not self._stopped:
                    self._cond.wait()
                if self._stopped or (self._num is not None
                                     and i >= self._num):
                    return
            t0 = time.perf_counter()
            try:
                faults.maybe_stall("prefetch")   # a wedged stager
                with obstrace.span("prefetch/produce", pipeline=self.name,
                                   item=i):
                    item = read_with_retries(lambda: self._produce(i),
                                             self._io_site,
                                             retries=self._io_retries,
                                             backoff_s=self._io_backoff_s)
            except BaseException as e:   # raised to the consumer at get()
                with self._cond:
                    self._exc = e
                    self._cond.notify_all()
                return
            dt = time.perf_counter() - t0
            with self._cond:
                if self._stopped:
                    return
                self._buf.append(item)
                self._produced += 1
                self._produce_s += dt
                self._cond.notify_all()
            i += 1

    # --- consumer side -------------------------------------------------
    def get(self):
        """Next staged item, in produce order; blocks until staged.

        Raises the staging thread's error (sticky: rebuild the pipeline
        after), IndexError past ``num_items``, or, with ``deadline_s``,
        :class:`WorkerStalled` when the staging thread misses it."""
        t0 = time.perf_counter()
        with self._cond:
            while not self._buf:
                if self._exc is not None:
                    raise self._exc
                if self._stopped:
                    raise RuntimeError("prefetch pipeline is closed")
                if self._num is not None and self._consumed >= self._num:
                    raise IndexError(
                        f"prefetch pipeline exhausted after {self._num} "
                        f"items")
                waited = time.perf_counter() - t0
                if (self._deadline_s is not None
                        and waited >= self._deadline_s):
                    raise WorkerStalled(StallReport(
                        worker=self._thread.name,
                        waiting_for=f"staged item {self._consumed}",
                        waited_s=waited, deadline_s=self._deadline_s,
                        detail=(f"pipeline {self.name!r}: produced "
                                f"{self._produced}, consumed "
                                f"{self._consumed}, depth {self._depth}"),
                        alive=self._thread.is_alive()))
                timeout = (None if self._deadline_s is None
                           else self._deadline_s - waited)
                self._cond.wait(timeout)
            item = self._buf.popleft()
            self._consumed += 1
            self._wait_s += time.perf_counter() - t0
            self._cond.notify_all()
        return item

    def close(self, join_timeout_s: float = 10.0):
        """Stop the producer, discard staged items, join the thread.
        Never raises: pending staging errors die with the pipeline. The
        join is bounded: a wedged staging thread is abandoned (it is a
        daemon) rather than waited on forever."""
        obsm.unregister_collector(self._obs_collect)
        with self._cond:
            self._stopped = True
            self._buf.clear()
            self._cond.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=join_timeout_s)
            if self._thread.is_alive():
                from ..utils.logging import get_logger
                get_logger("prefetch").warning(
                    "staging thread %s did not exit within %.3gs of "
                    "close(); abandoning it (daemon)",
                    self._thread.name, join_timeout_s)

    @property
    def closed(self) -> bool:
        return self._stopped

    def stats(self) -> dict:
        """Staging accounting: ``overlap_fraction`` is the share of the
        staging time hidden under the consumer's compute (1.0 = the
        consumer never waited on the ring)."""
        with self._cond:
            ps, ws = self._produce_s, self._wait_s
            items = self._consumed
        hidden = max(ps - min(ws, ps), 0.0)
        return {"items": items, "produce_s": ps, "wait_s": ws,
                "overlap_fraction": (hidden / ps) if ps > 0 else 1.0}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
