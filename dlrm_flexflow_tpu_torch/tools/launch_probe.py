#!/usr/bin/env python3
"""Development probe of the DLRM launcher's input staging on one GPU:
where a step's time goes when batches come from a ``.ffbin`` through the
prefetch ring, against the same run without it.

Run from the root of a checkout of the port, with one card visible:

    python3 -m dlrm_flexflow_tpu_torch.tools.launch_probe

The script writes a ``.ffbin`` of 256 batches of 256 synthetic samples
at the full width of ``DLRMConfig.random_benchmark()`` into
``build/probe/`` and runs ``python -m
dlrm_flexflow_tpu_torch.examples.native.dlrm``'s ``main`` on it (one
epoch) in several settings, each twice, in turns: no prefetch, the ring
at depth 2 and 8, and the ring at depth 2 with the interpreter's thread
switch interval at 0.1 ms instead of 5 ms; and the launcher's loop
written out here with the ring reading host batches only and the
training loop itself copying each batch to the card one step ahead
(pinned memory, the model's side stream, the same ``_stage_step``),
with ``torch.cuda.synchronize()`` ending it. First, the host's time per
batch of each piece of a staging call, over 500 batches of the
launcher's shapes on an idle card. For each setting: samples/s, the
ring's staging time and the training loop's waits for it per batch,
and the time per batch of the two halves of a staging call, the native
read (``FFBinDataLoader._read_host_batch``) and the copy to the card
(``FFModel._stage_step``), on whichever thread ran them.
"""

import shutil
import sys
import threading
import time
from pathlib import Path

import numpy as np

import torch

from ..core.model import FFModel
from ..data import dataloader as dl
from ..examples.native import dlrm
from ..models.dlrm import DLRMConfig, synthetic_batch

# the root of the checkout: the probe writes under its build/
HERE = Path(__file__).resolve().parents[2]

STEPS, BATCH, T, ROWS = 256, 256, 8, 1_000_000
ARGS = ["-b", str(BATCH), "-e", "1", "--arch-embedding-size",
        "-".join([str(ROWS)] * T), "--arch-sparse-feature-size", "64",
        "--arch-mlp-bot", "64-512-512-64",
        "--arch-mlp-top", "576-1024-1024-1024-1"]
VARIANTS = (("no prefetch", ["--no-prefetch"], None),
            ("depth 2", ["--prefetch-depth", "2"], None),
            ("depth 8", ["--prefetch-depth", "8"], None),
            ("depth 2, switch 0.1 ms", ["--prefetch-depth", "2"], 1e-4),
            ("host ring, copy one step ahead in the loop", None, None))


class Timed:
    """Accumulates the seconds and calls of one method, on any thread."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.real = getattr(owner, name)
        self.lock = threading.Lock()
        self.s, self.n = 0.0, 0

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return self.real(*a, **kw)
            finally:
                with self.lock:
                    self.s += time.perf_counter() - t0
                    self.n += 1

        setattr(owner, name, timed)

    def ms(self):
        return 1e3 * self.s / max(self.n, 1)

    def restore(self):
        setattr(self.owner, self.name, self.real)


def pieces(path):
    """Host ms per batch of the pieces of ``stage_batch`` and of the
    synchronous ``_device_batch``, over the launcher's batches."""
    from ..config import FFConfig
    from ..data.prefetch import stage_batch
    from ..models.dlrm import build_dlrm
    cfg = FFConfig.parse_args(ARGS)
    model = FFModel(cfg)
    build_dlrm(model, DLRMConfig.parse_args(cfg.unparsed))
    model.compile(None, "mean_squared_error", ["mse"])
    loader = dl.FFBinDataLoader(model, str(path), sparse_shape=(T, 1),
                                prefetch=False)
    hbs = [loader.next_host_batch() for _ in range(8)]
    loader.close()
    dev, stream = model.device, model._stage_stream
    dts = model._batch_dtypes(hbs[0])
    reps = 500

    def per_batch(fn):
        fn(hbs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(hbs[i % len(hbs)])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    def from_numpy(hb):
        return [torch.from_numpy(np.ascontiguousarray(a))
                for a in hb.values()]

    def pinned(hb):
        return [t.pin_memory() for t in from_numpy(hb)]

    def copies(hb):
        with torch.cuda.stream(stream):
            return [t.to(dev, non_blocking=True) for t in pinned(hb)]

    def event(hb):
        e = torch.cuda.Event()
        e.record(stream)
        return e

    rows = [("numpy to tensors", from_numpy),
            ("+ pin_memory", pinned),
            ("+ non-blocking copies on the side stream", copies),
            ("an event, recorded", event),
            ("stage_batch, all of it",
             lambda hb: stage_batch(hb, dts, dev, stream)),
            ("_device_batch (pageable, waits for the copies)",
             model._device_batch)]
    for name, fn in rows:
        print(f"launch_probe piece: {name}: {per_batch(fn):.4f} ms/batch",
              flush=True)


def copy_ahead_loop(path):
    """The launcher's flow over a ring that reads host batches only,
    each batch copied to the card one step ahead by the loop."""
    from ..config import FFConfig
    from ..core.optimizers import SGDOptimizer
    from ..models.dlrm import build_dlrm
    cfg = FFConfig.parse_args(ARGS)
    model = FFModel(cfg)
    build_dlrm(model, DLRMConfig.parse_args(cfg.unparsed))
    model.compile(SGDOptimizer(lr=cfg.learning_rate), "mean_squared_error",
                  ["mse"])
    model.init_layers()
    loader = dl.FFBinDataLoader(model, str(path), sparse_shape=(T, 1))
    try:
        nxt = model._stage_step(loader.next_host_batch())

        def next_batch():
            nonlocal nxt
            cur, nxt = nxt, model._stage_step(loader.next_host_batch())
            return cur

        float(model.train_batch_staged(next_batch())["loss"])
        t0 = time.perf_counter()
        for _ in range(loader.num_batches):
            mets = model.train_batch_staged(next_batch())
        float(mets["loss"])
        elapsed = time.perf_counter() - t0
        ring = loader._pipe.stats()
    finally:
        loader.close()
    steps = loader.num_batches
    return {"throughput": steps * BATCH / elapsed, "elapsed": elapsed,
            "steps": steps, "prefetch": ring}


def main():
    if not torch.cuda.is_available():
        print("launch_probe: no CUDA device is available", file=sys.stderr)
        return 1
    work = HERE / "build" / "probe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        x, y = synthetic_batch(DLRMConfig.random_benchmark(), STEPS * BATCH,
                               seed=5)
        path = work / "train.ffbin"
        dl.write_ffbin(str(path), x["dense"], x["sparse"], y)
        pieces(path)
        default_switch = sys.getswitchinterval()
        for rep in range(2):
            for label, flags, switch in VARIANTS:
                read = Timed(dl.FFBinDataLoader, "_read_host_batch")
                stage = Timed(FFModel, "_stage_step")
                sys.setswitchinterval(switch or default_switch)
                try:
                    out = (copy_ahead_loop(path) if flags is None else
                           dlrm.main(ARGS + ["--data-path", str(path)]
                                     + flags))
                finally:
                    sys.setswitchinterval(default_switch)
                    read.restore()
                    stage.restore()
                ring = out["prefetch"]
                ring_text = ("" if ring is None else
                             f"; ring: staging "
                             f"{1e3 * ring['produce_s'] / ring['items']:.3f} "
                             f"ms/batch, loop waited "
                             f"{1e3 * ring['wait_s'] / ring['items']:.3f} "
                             f"ms/batch, overlap "
                             f"{ring['overlap_fraction']:.2f}")
                print(f"launch_probe {rep} {label}: "
                      f"{out['throughput']:.1f} samples/s, "
                      f"{1e3 * out['elapsed'] / out['steps']:.3f} ms/step; "
                      f"read {read.ms():.3f} ms/batch, copy to the card "
                      f"{stage.ms():.3f} ms/batch ({stage.n} calls)"
                      + ring_text, flush=True)
                del out
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
