"""DLRM training app, the port of ``examples/native/dlrm.py``: the same
flag spellings, graph, optimizer, data sources, strategies and report
line, on one card (or, with ``--device cpu``, on the CPU) or across
ranks. Run it as a module from the root of a checkout::

    python -m dlrm_flexflow_tpu_torch.examples.native.dlrm -b 256 -e 1 \\
        --arch-embedding-size 1000000-1000000-1000000-1000000-1000000-1000000-1000000-1000000 \\
        --arch-sparse-feature-size 64 --arch-mlp-bot 64-512-512-64 \\
        --arch-mlp-top 576-1024-1024-1024-1 --data-path train.ffbin

Across ranks, as ``run_random.sh`` launches the JAX app with ``-ll:gpu
$ndev -b $((256*ndev))``: one process a rank, under torchrun
(``torchrun --nproc-per-node N -m
dlrm_flexflow_tpu_torch.examples.native.dlrm -ll:gpu N ...``) or the JAX
package's environment (``COORDINATOR_ADDRESS`` host:port,
``NUM_PROCESSES``, ``PROCESS_ID``; ``parallel.distributed``). Each rank
trains on its rows of the synthetic global batch under the hand-written
``dlrm_strategy`` (the stacked tables split by table over the ranks,
Criteo-Kaggle's concatenated table in equal row blocks over them, every
other op data-parallel) or the strategy file ``--import`` names (``.pb``
or ``.json``: the reference's per-table files group the concatenated
table's rows by device; an embedding entry with ``param_dim`` > 1, and
its ``exchange``, ``hot_frac`` and ``overlap``, splits the table's rows
over the ranks with the all-to-all exchange of ``parallel/alltoall.py``),
and rank 0 prints the
report. Without a process
group the world is one rank, so ``-ll:gpu 8`` or ``--nodes 2`` trains on
one card, as the JAX app does on a host with one chip. Across ranks a
data file (``.ffbin``, ``.npz``, ``.h5``) hands each rank its rows of
each global batch (the native reader copies only those rows), and
``--host-tables`` (every rank keeps the tables whole on its host and
applies the global batch's update) and ``--anomaly-policy`` (one flag
for every rank) train as on one card.

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
than being ignored: the strategy search and ``--export`` (item 8), the
elastic runtime (item 7.5), supersteps, the per-op profile and
``--debug-nans`` (item 6), and the other JAX runtime flags below.
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
from ...models.dlrm import (DLRMConfig, build_dlrm, dlrm_strategy,
                            synthetic_batch)
from ...parallel import distributed
from ...parallel.mesh import make_mesh
from ...parallel.strategy_io import load_strategies
from ...utils.logging import get_logger
from ...utils.profiling import TraceContext

log_app = get_logger("dlrm")

# flags of the JAX package's FFConfig that the port does not parse, by
# the ROADMAP queue 1 item that ports what they drive
_UNPORTED = {
    **dict.fromkeys(("--budget", "--search-budget", "--alpha",
                     "--search-alpha", "--export", "--measure-ops",
                     "--simulation", "-dm:memorize"),
                    "8 (strategy search)"),
    **dict.fromkeys(("--elastic", "--elastic-budget", "--max-recoveries",
                     "--elastic-expand", "--worker-deadline"),
                    "7.5 (the elastic loop)"),
    **dict.fromkeys(("--profiling", "--debug-nans"),
                    "6 (training runtime)"),
    **dict.fromkeys(("--no-nhwc", "--conv-s2d"), "11 (the zoo)"),
    **dict.fromkeys(("--compile-cache-dir", "--eval-exec-cache"),
                    "9.5 (the warm executable caches)"),
    "--retrieve": "10 (retrieval)",
}


def _refuse_unported(rest):
    for a in rest:
        if a in _UNPORTED:
            raise NotImplementedError(
                f"{a} is not ported yet (ROADMAP queue 1 item "
                f"{_UNPORTED[a]})")


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
    """Train as the flags say; prints (rank 0) the metrics and the
    ``THROUGHPUT = ... samples/s`` line, and returns {"elapsed",
    "throughput", "num_samples", "steps", "model", "prefetch"} (the
    timed loop: every epoch's batches after one warm-up step, samples of
    the global batch; "prefetch" the ring's ``stats()``, None without a
    ring)."""
    if any(os.environ.get(k) for k in ("NUM_PROCESSES",
                                       "COORDINATOR_ADDRESS", "WORLD_SIZE")):
        # one process a rank (the reference's run_summit.sh over GASNet)
        distributed.initialize_distributed()
    cfg = FFConfig.parse_args(argv)
    dcfg = DLRMConfig.parse_args(cfg.unparsed)
    rest = cfg.unparsed
    _refuse_unported(rest)
    data_path = None
    if "--data-path" in rest:
        data_path = rest[rest.index("--data-path") + 1]
    world = distributed.world_size()
    if world > 1:
        # each rank computes on its card (its own under NCCL)
        cfg.device = str(distributed.local_device(cfg.device))
    ndev = min(cfg.num_devices, world)
    if ndev < world:
        raise ValueError(f"-ll:gpu x --nodes = {cfg.num_devices} device(s) "
                         f"for {world} ranks: every rank trains")
    mesh = make_mesh(num_devices=ndev)
    log_app.info("device=%s devices=%d batch=%d tables=%d zipf_alpha=%g",
                 cfg.device, ndev, cfg.batch_size, len(dcfg.embedding_size),
                 dcfg.zipf_alpha)

    model = FFModel(cfg)
    build_dlrm(model, dcfg)
    # strategy: --import file > the hand-written DLRM strategy
    if cfg.import_strategy_file:
        strategies = load_strategies(cfg.import_strategy_file)
        log_app.info("imported strategies from %s", cfg.import_strategy_file)
    else:
        strategies = dlrm_strategy(model, dcfg, ndev)
    model.compile(SGDOptimizer(lr=cfg.learning_rate), "mean_squared_error",
                  ["mse"], mesh=mesh, strategies=strategies)
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
        # each rank stages its rows of the global batch
        staged = distributed.global_batch_from_host_local(
            distributed.host_local_slice(x), model)
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
    if distributed.rank() == 0:
        print(f"{model.perf.summary_line()}")
        print(f"ELAPSED TIME = {elapsed:.4f}s, THROUGHPUT = "
              f"{n_samples / elapsed:.2f} samples/s")
    return {"elapsed": elapsed, "throughput": n_samples / elapsed,
            "num_samples": n_samples, "steps": steps, "model": model,
            "prefetch": ring}


if __name__ == "__main__":
    main(sys.argv[1:])
