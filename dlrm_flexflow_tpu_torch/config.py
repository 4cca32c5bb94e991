"""Run configuration and CLI parsing for the PyTorch/CUDA port.

A subset of ``dlrm_flexflow_tpu.config.FFConfig``: the fields the serving
and training slices read, under the same flag spellings
(``-e/--epochs``, ``-b/--batch-size``, ``--lr/--learning-rate``,
``--wd/--weight-decay``, ``--seed``, ``--compute-dtype``,
``--dense-embedding-update``, the ``--serve-*`` flags, ``--retrieve-k``,
``--retrieve-deadline-ms``, ``--retrieve-shards``, and the training
runtime's ``--checkpoint-dir``, ``--save-every``, ``--keep-last``,
``--prefetch-depth``, ``--no-prefetch``, ``--anomaly-policy``,
``--stage-dataset`` and ``--profile-dir``; the host-resident tables'
``--host-tables``, ``--host-tables-async`` and
``--no-host-tables-async``; the continual loop's
``--publish-every``, ``--delta-compact-frac``, ``--delta-full-every``
and ``--serve-poll``; observability's ``--obs``, ``--obs-trace-dir``
and ``--obs-drift-threshold``; the placement's ``-ll:gpu`` (devices a
node), ``--nodes``, ``--import`` (a strategy file) and
``--strict-strategies``), plus ``device``. Unknown
flags land in ``unparsed``, as in the JAX package. ``--superstep``, not
ported yet, raises ``NotImplementedError``, as does
``--no-pallas-lstm``: the port's LSTM always runs its scan kernels.

``device`` defaults to ``"cuda"``. A config that asks for CUDA on a
machine without a GPU raises at construction: the port never carries on
quietly on the CPU. Pass ``device="cpu"`` (``--device cpu``) to run the
plain PyTorch versions of the kernels there, as the tests do.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch


# flags of the JAX package's training runtime that the port refuses
_RUNTIME_FLAGS = ("--superstep",)
ANOMALY_POLICIES = ("none", "skip_step", "rollback", "raise")
STAGE_MODES = ("auto", "always", "never")


@dataclass
class FFConfig:
    epochs: int = 1
    batch_size: int = 64
    learning_rate: float = 0.01
    # the default optimizer's decay (compile() without an optimizer);
    # non-zero decay makes the touched-rows table update stateful (lazy
    # decay on the touched rows, ops/embedding.py sparse_opt_update)
    weight_decay: float = 0.0001
    seed: int = 0
    compute_dtype: str = "float32"     # or "bfloat16"
    # plain SGD updates only the gathered embedding rows (the touched-rows
    # scatter kernels) instead of a table-sized dense gradient; disable
    # with --dense-embedding-update
    sparse_embedding_update: bool = True
    # store every embedding table in host RAM (numpy), gathered and
    # updated there around each step, as the reference's hetero
    # placement (embedding_avx2.cc): tables larger than the card train.
    # The dense part still runs on the card. Set with --host-tables.
    host_resident_tables: bool = False
    # overlap the host-table work with the card (on by default, as in the
    # JAX package): the cotangent readback and the host scatter run on a
    # worker thread; when the next batch is known (fit passes it), the
    # worker first gathers the next step's rows, then scatters this
    # step's update. Bounded one-step staleness: step N+1's forward sees
    # every update through step N-1, maybe N (exactly N-1 when fit
    # chains the gather), and a racing gather sees a table before or
    # after a scatter, never torn. --no-host-tables-async gives exact
    # ordering; --host-tables-async sets the default again.
    host_tables_async: bool = True
    # model-wide default quantized STORAGE policy of the embedding tables
    # (quant/: "fp32" | "bf16" | "int8" | "fp8"): int8/fp8 rows store one
    # fp32 scale per row. A strategy entry's quant_dtype overrides it per
    # table. Set with --emb-dtype.
    emb_dtype: str = "fp32"
    # the update rule under it: "master_weight" trains the exact fp32
    # master (bitwise fp32 training; the quantized rows ship at storage
    # boundaries); "stochastic_rounding" re-quantizes every updated table
    # in the step (unbiased rounding, no master). Set with
    # --emb-update-rule.
    emb_update_rule: str = "master_weight"
    # ---- training runtime (FFModel.fit, data/) ------------------------
    # batches staged ahead of the step by the prefetch ring
    # (data/prefetch.py); 0 stages in the training loop. Set with
    # --prefetch-depth N / --no-prefetch.
    prefetch_depth: int = 2
    # rolling-checkpoint defaults for fit(); its arguments override.
    # save_every counts optimizer steps; 0 = only a final checkpoint.
    # Set with --checkpoint-dir / --save-every / --keep-last.
    checkpoint_dir: str = ""
    save_every: int = 0
    keep_last: int = 3
    # the anomaly sentinel: a finiteness check of each step's loss and
    # global gradient norm on the device, and what a non-finite step
    # does: "none" (no check), "skip_step" (its update is suppressed on
    # the device, no host sync), "rollback" (fit restores the last good
    # snapshot and rewinds; needs a checkpoint directory) or "raise"
    # (AnomalyError at the step's end). rollback and raise read the flag
    # back once a step. Set with --anomaly-policy.
    anomaly_policy: str = "none"
    # rollbacks a fit may make before the anomaly is raised
    max_rollbacks: int = 3
    # fit(): stage the whole dataset on the device once when it fits
    # ("auto"), always ("always": the caller vouches for the memory),
    # or never ("never": batches go through the prefetch ring). Set
    # with --stage-dataset.
    stage_dataset: str = "auto"
    # a torch.profiler trace of fit's loop (and the launcher's timed
    # loop) lands here as Chrome trace JSON; "" traces nothing. Set with
    # --profile-dir.
    profile_dir: str = ""
    # ---- continual learning (FFModel.fit_stream + utils/delta.py) -----
    # optimizer steps between snapshot publishes in fit_stream; 0 = no
    # periodic publication. Set with --publish-every N.
    publish_every: int = 0
    # compaction: when the live delta chain's bytes exceed this fraction
    # of its base checkpoint's, the next publish is a full checkpoint.
    # Set with --delta-compact-frac.
    delta_compact_frac: float = 0.5
    # a full checkpoint every N delta publishes whatever their size (0:
    # compaction by size only). Set with --delta-full-every N.
    delta_full_every: int = 0
    # ---- observability (obs/) -----------------------------------------
    # "on": the metrics registry (GET /metrics of the serving app), span
    # tracing and fit's / fit_stream's drift monitor; "off" keeps every
    # instrument a no-op. Set with --obs {off,on}.
    obs: str = "off"
    # where fit / fit_stream (and the serving app at shutdown) export the
    # span ring as Chrome-trace JSON; "" keeps it in memory. Set with
    # --obs-trace-dir DIR.
    obs_trace_dir: str = ""
    # the drift monitor's alarm ratio. Set with --obs-drift-threshold R.
    obs_drift_threshold: float = 1.5
    # ---- online serving (serve/engine.py InferenceEngine) -------------
    serve_max_batch: int = 64
    serve_max_delay_ms: float = 5.0
    serve_queue: int = 256
    serve_deadline_ms: float = 0.0
    # the host-table row cache's capacity in samples (0: off) and the
    # id histogram (or the directory holding it) it is pre-warmed from.
    # Set with --serve-cache-rows N and --serve-cache-warm PATH.
    serve_cache_rows: int = 0
    serve_cache_warm: str = ""
    serve_batching: str = "continuous"
    # ---- the serving fleet (serve/fleet.py, router.py, autoscale.py) --
    # ranker replicas behind a FleetRouter (1: one engine). Set with
    # --serve-replicas N.
    serve_replicas: int = 1
    # the router's re-dispatches after a failed attempt, and the share
    # of traffic a canary takes. --serve-retries N,
    # --serve-canary-fraction F.
    serve_retries: int = 2
    serve_canary_fraction: float = 0.1
    # the autoscaler's p99 objective (0: no autoscaler) and its replica
    # bounds. --serve-slo-ms MS, --serve-min-replicas N,
    # --serve-max-replicas N.
    serve_slo_ms: float = 0.0
    serve_min_replicas: int = 1
    serve_max_replicas: int = 8
    # ---- the serving shard tier (serve/shardtier.py) ------------------
    # lookup shards that row-shard the host tables (0: the ranker keeps
    # its tables). Set with --serve-shards N.
    serve_shards: int = 0
    # per-shard lookup budget, retries included; a spent budget degrades
    # per serve_degrade. Set with --serve-lookup-deadline-ms MS.
    serve_lookup_deadline_ms: float = 50.0
    # "cache": answer from cache hits and per-table default rows, flagged
    # degraded; "fail": raise. Set with --serve-degrade {cache,fail}.
    serve_degrade: str = "cache"
    # the tier's hedge: a duplicate lookup after this many ms, the first
    # answer wins (0: off). Set with --serve-hedge-ms MS.
    serve_hedge_ms: float = 0.0
    # "inproc" (method calls) or "tcp" (the wire protocol); with tcp,
    # --serve-shard-procs N spawns N shard processes. Set with
    # --serve-transport {inproc,tcp} and --serve-shard-procs N.
    serve_transport: str = "inproc"
    serve_shard_procs: int = 0
    # the snapshot watcher's poll interval (hot reload of a checkpoint
    # directory). Set with --serve-poll SECONDS.
    serve_poll_s: float = 0.5
    # ---- retrieval cascade (retrieve/) --------------------------------
    # candidates out of the retrieve stage per user. --retrieve-k N.
    retrieve_k: int = 100
    # retrieve-stage deadline: the MIPS fan-out gets min(this, what is
    # left of --serve-deadline-ms); the ranker gets the rest.
    # --retrieve-deadline-ms MS.
    retrieve_deadline_ms: float = 25.0
    # index shards of a standalone (index-only) shard set; 0 means one.
    # --retrieve-shards M.
    retrieve_shards: int = 0
    # ---- placement across ranks (parallel/) ---------------------------
    # devices a node (-ll:gpu; 0: every rank of the process group) and
    # nodes (--nodes): num_devices is their product, as in the JAX
    # package
    workers_per_node: int = 0
    num_nodes: int = 1
    # a strategy file (.pb or .json) compile() loads when it is given no
    # strategies (--import); with strict_strategies a config the shapes
    # or the mesh cannot take raises instead of being clamped with a
    # warning (--strict-strategies)
    import_strategy_file: str = ""
    strict_strategies: bool = False
    device: str = "cuda"
    unparsed: List[str] = field(default_factory=list)

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype expects float32|bfloat16, "
                             f"got {self.compute_dtype!r}")
        if self.anomaly_policy not in ANOMALY_POLICIES:
            raise ValueError(f"anomaly_policy must be "
                             f"{'|'.join(ANOMALY_POLICIES)}, got "
                             f"{self.anomaly_policy!r}")
        if self.stage_dataset not in STAGE_MODES:
            raise ValueError(f"stage_dataset must be "
                             f"{'|'.join(STAGE_MODES)}, got "
                             f"{self.stage_dataset!r}")
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FFConfig(device={self.device!r}) but no CUDA device is "
                f"available; pass device='cpu' (--device cpu) to run the "
                f"plain PyTorch path on the CPU")

    @property
    def num_devices(self) -> int:
        """Devices a node (``-ll:gpu``, else the process group's ranks)
        times the nodes, as the JAX package's property counts them."""
        from .parallel.distributed import world_size
        per_node = self.workers_per_node or world_size()
        return per_node * self.num_nodes

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)

    @staticmethod
    def parse_args(argv: Optional[List[str]] = None) -> "FFConfig":
        import sys
        argv = list(sys.argv[1:] if argv is None else argv)
        kw = {"unparsed": []}
        i = 0

        def take():
            nonlocal i
            i += 1
            if i >= len(argv):
                raise ValueError(f"flag {argv[i - 1]!r} requires a value")
            return argv[i]

        while i < len(argv):
            a = argv[i]
            if a in ("-e", "--epochs"):
                kw["epochs"] = int(take())
            elif a in ("-b", "--batch-size"):
                kw["batch_size"] = int(take())
            elif a in ("--lr", "--learning-rate"):
                kw["learning_rate"] = float(take())
            elif a in ("--wd", "--weight-decay"):
                kw["weight_decay"] = float(take())
            elif a == "--dense-embedding-update":
                kw["sparse_embedding_update"] = False
            elif a == "--host-tables":
                kw["host_resident_tables"] = True
            elif a == "--host-tables-async":
                kw["host_tables_async"] = True
            elif a == "--no-host-tables-async":
                kw["host_tables_async"] = False
            elif a == "--no-pallas-lstm":
                raise NotImplementedError(
                    "--no-pallas-lstm: the LSTM always runs its scan "
                    "kernels on the card; the JAX package's lax.scan "
                    "fallback is the TPU's answer to XLA streaming wh and "
                    "is not ported")
            elif a in _RUNTIME_FLAGS:
                raise NotImplementedError(
                    f"{a}: the fused supersteps are not ported yet "
                    f"(ROADMAP queue 1 item 6)")
            elif a == "--anomaly-policy":
                v = take()
                if v not in ANOMALY_POLICIES:
                    raise ValueError(
                        f"--anomaly-policy expects "
                        f"{'|'.join(ANOMALY_POLICIES)}, got {v!r}")
                kw["anomaly_policy"] = v
            elif a == "--emb-dtype":
                v = take()
                if v not in ("fp32", "bf16", "int8", "fp8"):
                    raise ValueError(
                        f"--emb-dtype expects fp32|bf16|int8|fp8, "
                        f"got {v!r}")
                kw["emb_dtype"] = v
            elif a == "--emb-update-rule":
                v = take()
                if v not in ("master_weight", "stochastic_rounding"):
                    raise ValueError(
                        f"--emb-update-rule expects "
                        f"master_weight|stochastic_rounding, got {v!r}")
                kw["emb_update_rule"] = v
            elif a == "--stage-dataset":
                v = take()
                if v not in STAGE_MODES:
                    raise ValueError(f"--stage-dataset expects "
                                     f"{'|'.join(STAGE_MODES)}, got {v!r}")
                kw["stage_dataset"] = v
            elif a == "--profile-dir":
                kw["profile_dir"] = take()
            elif a == "--checkpoint-dir":
                kw["checkpoint_dir"] = take()
            elif a == "--save-every":
                kw["save_every"] = int(take())
            elif a == "--keep-last":
                kw["keep_last"] = int(take())
            elif a == "--prefetch-depth":
                kw["prefetch_depth"] = int(take())
            elif a == "--no-prefetch":
                kw["prefetch_depth"] = 0
            elif a == "--seed":
                kw["seed"] = int(take())
            elif a == "--compute-dtype":
                kw["compute_dtype"] = take()
            elif a == "--device":
                kw["device"] = take()
            elif a == "-ll:gpu":       # the reference's devices a node
                kw["workers_per_node"] = int(take())
            elif a == "--nodes":
                kw["num_nodes"] = int(take())
            elif a == "--import":
                kw["import_strategy_file"] = take()
            elif a == "--strict-strategies":
                kw["strict_strategies"] = True
            elif a == "--serve-max-batch":
                kw["serve_max_batch"] = int(take())
            elif a == "--serve-max-delay-ms":
                kw["serve_max_delay_ms"] = float(take())
            elif a == "--serve-queue":
                kw["serve_queue"] = int(take())
            elif a == "--serve-deadline-ms":
                kw["serve_deadline_ms"] = float(take())
            elif a == "--serve-cache-rows":
                kw["serve_cache_rows"] = int(take())
            elif a == "--serve-cache-warm":
                kw["serve_cache_warm"] = take()
            elif a == "--serve-batching":
                v = take()
                if v not in ("continuous", "flush"):
                    raise ValueError(f"--serve-batching expects "
                                     f"continuous|flush, got {v!r}")
                kw["serve_batching"] = v
            elif a == "--serve-replicas":
                kw["serve_replicas"] = int(take())
                if kw["serve_replicas"] < 1:
                    raise ValueError(f"--serve-replicas expects N >= 1, "
                                     f"got {kw['serve_replicas']}")
            elif a == "--serve-retries":
                kw["serve_retries"] = int(take())
            elif a == "--serve-canary-fraction":
                kw["serve_canary_fraction"] = float(take())
            elif a == "--serve-slo-ms":
                kw["serve_slo_ms"] = float(take())
            elif a == "--serve-min-replicas":
                kw["serve_min_replicas"] = int(take())
                if kw["serve_min_replicas"] < 1:
                    raise ValueError(
                        f"--serve-min-replicas expects N >= 1, got "
                        f"{kw['serve_min_replicas']}")
            elif a == "--serve-max-replicas":
                kw["serve_max_replicas"] = int(take())
                if kw["serve_max_replicas"] < 1:
                    raise ValueError(
                        f"--serve-max-replicas expects N >= 1, got "
                        f"{kw['serve_max_replicas']}")
            elif a == "--serve-shards":
                kw["serve_shards"] = int(take())
                if kw["serve_shards"] < 0:
                    raise ValueError(f"--serve-shards expects N >= 0, got "
                                     f"{kw['serve_shards']}")
            elif a == "--serve-lookup-deadline-ms":
                kw["serve_lookup_deadline_ms"] = float(take())
            elif a == "--serve-degrade":
                v = take()
                if v not in ("cache", "fail"):
                    raise ValueError(f"--serve-degrade expects cache|fail, "
                                     f"got {v!r}")
                kw["serve_degrade"] = v
            elif a == "--serve-hedge-ms":
                kw["serve_hedge_ms"] = float(take())
            elif a == "--serve-transport":
                v = take()
                if v not in ("inproc", "tcp"):
                    raise ValueError(f"--serve-transport expects "
                                     f"inproc|tcp, got {v!r}")
                kw["serve_transport"] = v
            elif a == "--serve-shard-procs":
                kw["serve_shard_procs"] = int(take())
            elif a == "--serve-poll":
                kw["serve_poll_s"] = float(take())
            elif a == "--publish-every":
                kw["publish_every"] = int(take())
            elif a == "--delta-compact-frac":
                kw["delta_compact_frac"] = float(take())
            elif a == "--delta-full-every":
                kw["delta_full_every"] = int(take())
            elif a == "--obs":
                v = take()
                if v not in ("off", "on"):
                    raise ValueError(f"--obs expects off|on, got {v!r}")
                kw["obs"] = v
            elif a == "--obs-trace-dir":
                kw["obs_trace_dir"] = take()
            elif a == "--obs-drift-threshold":
                kw["obs_drift_threshold"] = float(take())
                if kw["obs_drift_threshold"] <= 0:
                    raise ValueError(
                        f"--obs-drift-threshold expects R > 0, got "
                        f"{kw['obs_drift_threshold']}")
            elif a == "--retrieve-k":
                kw["retrieve_k"] = int(take())
                if kw["retrieve_k"] < 1:
                    raise ValueError(f"--retrieve-k expects N >= 1, "
                                     f"got {kw['retrieve_k']}")
            elif a == "--retrieve-deadline-ms":
                kw["retrieve_deadline_ms"] = float(take())
                if kw["retrieve_deadline_ms"] < 0:
                    raise ValueError(
                        f"--retrieve-deadline-ms expects MS >= 0, got "
                        f"{kw['retrieve_deadline_ms']}")
            elif a == "--retrieve-shards":
                kw["retrieve_shards"] = int(take())
                if kw["retrieve_shards"] < 0:
                    raise ValueError(
                        f"--retrieve-shards expects N >= 0, got "
                        f"{kw['retrieve_shards']}")
            else:
                kw["unparsed"].append(a)
            i += 1
        return FFConfig(**kw)
