"""DLRM training app, the port of ``examples/native/dlrm.py``: the same
flag spellings, graph, optimizer, data sources and report line, on one
card (or, with ``--device cpu``, on the CPU). Run it as a module from the
root of a checkout::

    python -m dlrm_flexflow_tpu_torch.examples.native.dlrm -b 256 -e 1 \\
        --arch-embedding-size 1000000-1000000-1000000-1000000-1000000-1000000-1000000-1000000 \\
        --arch-sparse-feature-size 64 --arch-mlp-bot 64-512-512-64 \\
        --arch-mlp-top 576-1024-1024-1024-1 --data-path train.ffbin

Data: ``--data-path file.ffbin`` (``data.dataloader.write_ffbin``'s
format, read by the native loader and staged to the card by the prefetch
ring, ``--prefetch-depth N`` / ``--no-prefetch``), ``file.npz`` (arrays
``dense``, ``sparse``, ``label``), a Criteo ``file.h5`` / ``.hdf5``
(``load_dlrm_hdf5``; needs h5py, which raises ImportError where it is
missing), or, without it, one synthetic batch
staged once and trained 64 times per epoch. The graph is "cat" unless
``--arch-interaction-op dot`` asks for the unfused "dot" interaction, as
the JAX launcher builds it; non-uniform ``--arch-embedding-size`` tables
(Criteo's) are one concatenated-rows table. It trains with
``SGDOptimizer(lr=--lr)`` and the mean squared error. ``--host-tables``
keeps the tables in host RAM (``--host-tables-async``, the default,
overlaps their update with the card; ``--no-host-tables-async`` orders it
exactly), so Criteo-Terabyte's 96 GB of tables train on one card.
``--anomaly-policy`` guards each step (a non-finite step is skipped, or
raises ``AnomalyError``); ``--profile-dir DIR`` writes a
``torch.profiler`` trace of the timed loop into DIR; ``--stage-dataset``
is parsed for ``fit``, which this loop does not call, as are the
continual loop's ``--publish-every``, ``--delta-compact-frac``,
``--delta-full-every`` and ``--serve-poll`` (``fit_stream``, the serving
app) and ``--obs*`` (``fit``, ``fit_stream``), as in the JAX launcher.

What the port does not have yet raises, naming its ROADMAP item, rather
than being ignored: the strategy search and its files (item 8), a
multi-host or multi-device launch (item 7), supersteps, the per-op
profile and ``--debug-nans`` (item 6), and the other JAX runtime flags
below.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ...config import FFConfig
from ...core.model import FFModel
from ...core.optimizers import SGDOptimizer
from ...data.dataloader import (FFBinDataLoader, SingleDataLoader,
                                load_dlrm_hdf5)
from ...models.dlrm import DLRMConfig, build_dlrm, synthetic_batch
from ...utils.logging import get_logger
from ...utils.profiling import TraceContext

log_app = get_logger("dlrm")

# flags of the JAX package's FFConfig that the port does not parse, by
# the ROADMAP queue 1 item that ports what they drive
_UNPORTED = {
    **dict.fromkeys(("--budget", "--search-budget", "--alpha",
                     "--search-alpha", "--import", "--export",
                     "--measure-ops", "--simulation", "-dm:memorize",
                     "--strict-strategies"), "8 (strategy search)"),
    **dict.fromkeys(("--nodes", "--elastic", "--elastic-budget",
                     "--max-recoveries", "--elastic-expand",
                     "--worker-deadline"), "7 (multi-GPU)"),
    **dict.fromkeys(("--profiling", "--debug-nans"),
                    "6 (training runtime)"),
    **dict.fromkeys(("--emb-dtype", "--emb-update-rule"),
                    "5 (quantization in training)"),
    **dict.fromkeys(("--no-nhwc", "--conv-s2d"), "11 (the zoo)"),
    **dict.fromkeys(("--compile-cache-dir", "--eval-exec-cache"),
                    "9.5 (the warm executable caches)"),
    "--retrieve": "10 (retrieval)",
}


def _refuse_unported(rest):
    for i, a in enumerate(rest):
        if a in _UNPORTED:
            raise NotImplementedError(
                f"{a} is not ported yet (ROADMAP queue 1 item "
                f"{_UNPORTED[a]})")
        if a == "-ll:gpu" and rest[i + 1:i + 2] != ["1"]:
            raise NotImplementedError(
                "-ll:gpu: the port trains on one card; more devices are "
                "ROADMAP queue 1 item 7 (multi-GPU)")


def _check_sparse_bounds(sparse, dcfg):
    """Fail loudly when categorical indices exceed the configured table
    sizes: the lookups wrap ids modulo the table (silent row aliasing),
    so a --hash-size / --arch-embedding-size mismatch would otherwise
    train on wrong rows with a plausible-looking loss."""
    maxes = sparse.reshape(sparse.shape[0], sparse.shape[1], -1).max(
        axis=(0, 2))
    for t, (mx, rows) in enumerate(zip(maxes, dcfg.embedding_size)):
        if mx >= rows:
            raise ValueError(
                f"table {t}: max categorical index {int(mx)} >= configured "
                f"table size {rows}; regenerate the dataset with a matching "
                f"--hash-size or fix --arch-embedding-size")


def main(argv=None):
    """Train as the flags say; prints the metrics and the
    ``THROUGHPUT = ... samples/s`` line, and returns {"elapsed",
    "throughput", "num_samples", "steps", "model", "prefetch"} (the
    timed loop: every epoch's batches after one warm-up step;
    "prefetch" the ring's ``stats()``, None without a ring)."""
    if os.environ.get("NUM_PROCESSES") or os.environ.get(
            "COORDINATOR_ADDRESS"):
        raise NotImplementedError(
            "a multi-host launch (NUM_PROCESSES / COORDINATOR_ADDRESS) is "
            "not ported yet (ROADMAP queue 1 item 7)")
    cfg = FFConfig.parse_args(argv)
    dcfg = DLRMConfig.parse_args(cfg.unparsed)
    rest = cfg.unparsed
    _refuse_unported(rest)
    data_path = None
    if "--data-path" in rest:
        data_path = rest[rest.index("--data-path") + 1]
    log_app.info("device=%s batch=%d tables=%d zipf_alpha=%g", cfg.device,
                 cfg.batch_size, len(dcfg.embedding_size), dcfg.zipf_alpha)

    model = FFModel(cfg)
    build_dlrm(model, dcfg)
    model.compile(SGDOptimizer(lr=cfg.learning_rate), "mean_squared_error",
                  ["mse"])
    model.init_layers()

    loader = None
    if data_path and data_path.endswith(".ffbin"):
        loader = FFBinDataLoader(
            model, data_path,
            sparse_shape=(len(dcfg.embedding_size), dcfg.embedding_bag_size))
        num_batches = loader.num_batches
        next_batch = loader.next_batch
    elif data_path and data_path.endswith((".h5", ".hdf5")):
        x, y = load_dlrm_hdf5(data_path)
        _check_sparse_bounds(x["sparse"], dcfg)
        loader = SingleDataLoader(model, x, y)
        num_batches = loader.num_batches
        next_batch = loader.next_batch
    elif data_path:
        d = np.load(data_path)
        _check_sparse_bounds(d["sparse"], dcfg)
        loader = SingleDataLoader(
            model, {"dense": d["dense"], "sparse": d["sparse"]}, d["label"])
        num_batches = loader.num_batches
        next_batch = loader.next_batch
    else:   # synthetic, one batch staged once
        x, y = synthetic_batch(dcfg, cfg.batch_size)
        x["label"] = y
        staged = model._device_batch(x)
        num_batches = 64
        next_batch = lambda: staged  # noqa: E731

    ring = None
    try:
        # one warm-up step: the kernels' build and load, cuBLAS's
        # handle and workspace
        float(model.train_batch_device(next_batch())["loss"])
        t0 = time.perf_counter()
        mets = None
        with TraceContext(cfg.profile_dir or None):
            for _epoch in range(cfg.epochs):
                model.reset_metrics()
                for _ in range(num_batches):
                    mets = model.train_batch_device(next_batch())
            float(mets["loss"])   # the readback waits for the last step
            model._host_drain()   # and the last host-table scatter
        elapsed = time.perf_counter() - t0
        if getattr(loader, "_pipe", None) is not None:
            ring = loader._pipe.stats()
    finally:
        if loader is not None:
            loader.close()
    steps = cfg.epochs * num_batches
    n_samples = steps * cfg.batch_size
    print(f"{model.perf.summary_line()}")
    print(f"ELAPSED TIME = {elapsed:.4f}s, THROUGHPUT = "
          f"{n_samples / elapsed:.2f} samples/s")
    return {"elapsed": elapsed, "throughput": n_samples / elapsed,
            "num_samples": n_samples, "steps": steps, "model": model,
            "prefetch": ring}


if __name__ == "__main__":
    main(sys.argv[1:])
