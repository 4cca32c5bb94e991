#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases:

1. device — the card's name and power limit, as nvidia-smi reports them;
2. build — every CUDA kernel of the serving, training, retrieval and
   NMT paths, compiled from ``dlrm_flexflow_tpu_torch/csrc`` with nvcc
   for sm_90a, one nvcc per source, all started together;
3. train — the full-width ``DLRMConfig.random_benchmark()`` model in the
   "cat" graph and in the fused "dot" graph, fp32, batch 256, timed
   first, before the process's first profiler session (a session leaves
   the host's launch path slower for the rest of the process), in six
   runs (TRAIN_RUNS): both graphs under
   ``compile(SGDOptimizer(lr=0.01), "mean_squared_error", ["mse"])``,
   then "cat" under ``compile()``'s default optimizer (SGD, weight decay
   1e-4), under ``SGDOptimizer(lr=0.01, momentum=0.9,
   weight_decay=1e-4)`` and under ``AdamOptimizer(alpha=0.001)``, and
   "dot" under Adam. Each: ``init_layers``, one staged
   ``synthetic_batch``, a few warmup steps, then 20
   ``train_batch_device`` steps back to back, timed as one window that
   ends in a synchronisation, with every launch count at 0 just before
   and read just after: exactly one dense update (``dense_update``,
   every dense parameter in one launch) and one scatter a step, and no
   other scatter: the write-only scatter on "cat" under plain SGD and
   the read-modify-write scatter on "dot" (its dense table gradient),
   each after one pre-pass on the pre-pass kernel's route; the stateful
   touched-rows update (``stateful_update_rows``) on "cat" under the
   other optimizers, on its one-launch route with no pre-pass; no plain
   version may run. On "dot" under Adam, TRAIN_STEPS steps with the
   dense update on its kernel and on its plain version (the eager
   passes), in turn, each with one step's peak device memory. The loss
   must be finite and fall; on "cat" a
   sample of untouched table rows must stay bitwise and their rows of
   every optimizer state slab zero. Ten steps run one at a time give a step's
   wall time alone, and a second window of 20 a second read of the
   back-to-back step (the host's speed drifts within a run); ten steps
   queued behind a spin on the device (see phase 7) give the device's
   time for a step that the host never holds back and its idle share of
   the back-to-back step, ten under the profiler its busy time and top
   kernels, and ten traced with the host the host's top ops. One step on
   the card must equal the same step on the CPU from the same weights,
   batch and non-zero optimizer state, at a reduced 8 × 65,536 rows
   (all widths full) so the CPU copy stays small;
   then NMT at full width as benchmarks/run_zoo.py's ``bench_nmt`` trains
   it (batch 64, sequences of 40, a 32k vocabulary, 2 x 1024 encoder and
   decoder LSTMs, bf16 compute, ``SGDOptimizer(lr=0.1)``, sparse
   categorical cross-entropy and accuracy), timed the same way: 20 steps
   back to back with every count at 0 just before and read just after
   (exactly 4 ``lstm_fwd`` and 4 ``lstm_bwd``, all on the resident
   route, 4 ``lstm_gates``, all on the "wgmma" route, 2
   ``scatter_presort``, 2 ``scatter_add_rows``
   and 1 ``dense_update`` launches a step, no plain version run, a
   finite loss that falls), ten
   steps alone and a second window. Its queued and profiled steps
   (device time, idle share, the host's top ops) and one fp32 step on the card against
   the same step on the CPU at vocab 4,096, 2 x 256, seq 12, batch 16 run
   last, after phase 8: in one run, profiler sessions begun after NMT's
   recorded no device time for the scatter kernels;
4. launch — the training runtime as users launch it, before any
   profiler session, in ``build/smoke`` of the checkout (removed at the
   end). (a) ``python -m dlrm_flexflow_tpu_torch.examples.native.dlrm``'s
   ``main`` with the full-width ``random_benchmark()`` flags, batch 256,
   from a ``.ffbin`` of 256 batches of synthetic samples written by the
   port's ``write_ffbin``, once through the prefetch ring (depth 2) and
   once with ``--no-prefetch``: every count at 0 just before and read
   just after, one bag, one pre-pass, one write-only scatter and one
   dense update a step and no plain version; samples/s, and ten steps
   queued behind a spin for the device's time a step and its idle
   share. (b) ``fit`` survives a restart, bitwise: "cat" at full width
   under momentum 0.9 with weight decay 1e-4, 24 steps in one epoch;
   uninterrupted, the dataset staged on the card (counts at 0 before,
   read after: one bag, one stateful update on its one-launch route and
   one dense update a step), then a fit through the prefetch ring with
   a snapshot every 12 steps (keep_last 1) stopped by an exception as
   step 13 begins, then a fresh model with other weights resumed from
   the directory through a rebuilt ring: its parameters and momentum
   must equal the uninterrupted fit's bitwise. The free disk space is checked
   first; one snapshot (4.1 GB) is then saved and restored into another
   model, bitwise, with its bytes, the copy to the host, the write and
   the restore timed;
5. resilience — training that survives bad steps and trains off a
   stream, at the full width of ``random_benchmark()``, batch 256, fp32,
   before any profiler session, in ``build/smoke`` (removed at the end).
   First the sentinel's kernels: the norm (``grad_sumsq``, one launch)
   over the "cat" and "dot" steps' gradient lists against its plain
   version (rtol 1e-5; the flag exact for NaN and ±Inf), timed beside
   its bound, its plain version and ``torch._foreach_norm``; and each
   guarded entry (the dense update under Adam and momentum, the add and
   write scatters, the stateful update on both routes) at its path's
   shape: the flag 0 leaves every output byte, 1 is bitwise the
   unguarded call. (a) "cat" and "dot" under Adam with ``skip_step``:
   24 steps with batch 10 poisoned by the NaN fault hook (counts at 0
   just before, read just after: one norm, one dense update and the
   graph's scatter a step, no plain version), bitwise a clean run over
   the same batches without batch 10, parameters and Adam's m, v and
   step; ``raise`` raises ``AnomalyError`` and leaves them bitwise; the
   step time under "none", "skip_step" and "raise", two windows of 20
   each. (b) ``fit`` of "cat" under plain SGD, 16 steps, ``rollback``
   with no rolling snapshots (the seed and the final one, 2.06 GB each),
   step 10 poisoned: one rollback, the parameters bitwise a clean
   fit's, the recovery (restore and rewind) timed. (c) ``fit`` of "cat"
   under plain SGD over 65,536 samples, staged on the card and through
   the prefetch ring in turn, twice each: bitwise alike, samples/s in
   fit's window (the staged one's starts after the staging, as the JAX
   fit's) and over the whole call, the staging timed apart (the first
   staged and the first ring fit counted, each: one bag, pre-pass,
   write-only scatter and dense update a step). (d)
   ``TraceReplay("drifting_zipf")`` at the model's shapes, 64 requests
   of 256 served by a "cat" ranker behind ``InferenceEngine`` into a
   ``FeedbackSpool`` while another "cat" model trains off it with
   ``fit_stream`` on a thread (counted: one write-only scatter and one
   dense update a trained step): all 64 trained, none dropped;
   ``fit_stream`` over an ``ArrayStream`` bitwise a ``train_batch``
   loop;
6. cascade — the retrieve -> rank cascade at full width, built as
   ``examples/native/serve_dlrm.py``'s ``_build_cascade`` builds it
   around ``random_benchmark()``: two-tower user and item heads, the 1M
   items encoded on the card and quantized into a 1-shard int8 MIPS
   index that stays there, the "cat" ranker behind an
   ``InferenceEngine``, ``CascadeEngine(...).predict`` with k=100 and a
   1,000 ms retrieve budget. The bag kernel is first held bitwise to its
   plain version on the towers' own tables and shapes (one 8,192-id
   item-head chunk at d=32, one request's ids of the 8 user tables at
   d=8). After a warmup, 64 one-user requests from 4 threads with every
   count at 0 just before and read just after: the top-k kernel must
   launch once per shard call and no plain version may run; no answer
   may be degraded or miss its deadline. The same 64 requests from one
   thread give the one-thread rate beside the 4 threads'. A sample's
   retrieval must equal ``exact_scan`` bitwise and its ranker scores
   ``forward_batch`` of the expanded rows; the same codes over 4 shards
   must answer as 1 shard does, bitwise. Runs before any profiler
   session, then traces 8 requests for the top-k kernel's device time;
7. kernels — each kernel at its path's full-width shapes against its
   plain PyTorch version on the same inputs, then timed beside its
   bound, the plain version and, where one PyTorch call computes the
   same function, that call: device time between two CUDA events around
   back-to-back calls all enqueued behind a spin on the device, so that
   no call waits for the host, and the same span without the spin, which
   the host's launch rate bounds. Calls that cannot be queued (the
   scatters' plain versions wait for the device, the plain LSTM backward
   fills the launch queue) take the summed kernel time of the profiler's
   trace instead, and their wall time where the trace holds no device
   time, as happens in some runs on a sandboxed card; a line says which.
   Otherwise the trace only splits a time into kernels (the scatter
   kernel against its sort, the top-k kernel's passes, the top kernels
   of a step), and prints "not measured" where it cannot. The bag and the interaction at the serving shape
   (B=2048, T=8, bag=1, d=64, 8M-row table; H=1024), then each at the
   shapes its paths launch it at, every one held to its plain version
   and timed beside its bound, its plain version and (the bag)
   ``F.embedding_bag``, one JSON line ``{"shapes": [...]}``: the
   interaction at B = 16, 64, 256 and 2,048, the bag at n = 64, d = 8
   over 8 x 1M-row tables (the cascade's user head), n = 2,048 and
   16,384 at d = 64 ("cat" training, a full bucket); the two scatter
   kernels and their pre-pass on the same table at the training step's
   n = 2,048 lookups, in uniform ids (the first 8 equal), all ids equal
   and Zipf-skewed ids, and at n = 16,384, held bitwise to their plain
   versions run on the CPU (on the card the plain version adds
   duplicates with atomics, in no fixed order), with the kernel launches
   a call and their split from the trace, timed as the ops call them
   (ids in range, no check) and with the wrapper's range check; then pad
   slots (-1 and -(rows + 1)) among the ids on both pre-pass routes
   (n = 2,048 and 16,385), held bitwise with only the real rows changed,
   and an id past the table raising; the stateful touched-rows update
   on the same table with state slabs of its size at n = 2,048, on its
   one-launch route and on the pre-pass route, for compile()'s default
   SGD, momentum with weight decay and Adam, in uniform, all-equal and
   Zipf ids and with pads, the touched rows and slab rows held bitwise
   to the plain version on the CPU (the same alpha_t), then both routes
   timed under Adam beside the bound and (n = 2,048) the plain version,
   at n = 2,048, 4,096, 8,192 and 16,384; the dense update over the
   full-width "dot" parameter set (the 8M x 64 table and the MLPs) and
   the "cat" set, held bitwise to its plain version on the card under
   plain SGD, compile()'s default, momentum with weight decay,
   nesterov, Adam and Adam with weight decay, and timed under Adam and
   SGD beside its bound, the plain version and one
   ``torch._fused_adam_`` / ``_fused_sgd_`` call; Adam's 0-d step size
   on the card against the CPU's, bitwise, for steps 0 to 99,999 (any
   step that differs fails the run); the quantized bag and
   interaction at the serving shape over the table quantized to int8
   (the bag also in fp8), which no path calls yet; the int8 MIPS top-k
   at B=64 and B=1 over a 1M x 32 index with planted duplicate rows,
   k=100, bitwise to its plain version on the card, and on one small
   shape where k exceeds the chunks and on an all-tied index (both on
   the overflow route) to the plain version on the CPU, with its bound
   at both, its routes, its device time split into score, select and
   sort from the trace and its median candidate count a query; the
   LSTM forward and backward scans at the NMT step's per-layer shape
   (T=40, b=64, h=1024) in bf16 and fp32 wh and at a ragged T=7, b=24,
   h=136, against their plain versions (ys, cs, dzs, and dxproj and dwh
   through the autograd Function), both kernels' routes checked
   (resident in bf16, streaming in fp32), the forward's serial step (the
   call over T) beside the barrier probe, timed beside cuDNN's LSTM
   layer (``torch.nn.LSTM``, which the port never calls) against "x·wx
   product + kernel"; the resident backward's gate phase
   (``lstm_gates``) on both its routes ("wgmma", the path's, and
   "mma"), each against its plain version, "wgmma" bitwise twice, timed
   in turns beside the plain version and ``torch.addmm``, the serial
   phase as the whole call less the "wgmma" gate phase, and its 39
   barriers alone (``grid_barrier``);
8. serve — the same model in both graphs, each behind
   ``InferenceEngine(ServeConfig(max_batch=256))`` taking a few dozen
   requests of 1-64 rows from 4 threads. Every kernel's launch count is
   set to 0 just before each run and read just after; the kernel of that
   graph must have launched and its plain version must not have run.
   Every response must equal ``forward_batch`` of its rows, and a small
   batch must agree with the same weights run on the CPU. One full
   bucket (256 rows) is timed and traced: its wall time against the
   device time of its kernels gives the device's idle share;
9. the online loop and the serving app — run after the cascade phase,
   before any profiler session, in ``build/smoke`` (removed at the end).
   (a) A full-width trainer of the unfused "dot" graph (as the app
   builds it from the same flags) at batch 2,048 under the launcher's
   SGD runs ``fit_stream`` over 48 batches of fresh samples with a
   ``DeltaPublisher`` publishing every 8 steps: a full base, four
   deltas (the fourth torn by ``FF_FAULT_DELTA_TORN=1``) and a
   compaction (``full_every`` 4). An in-process
   ``InferenceEngine(checkpoint_dir=...)`` and
   ``python -m dlrm_flexflow_tpu_torch.examples.native.serve_dlrm`` as a
   child process on 127.0.0.1 (``--obs on``, started on the empty
   directory; the kernels are built before it starts) poll every 50 ms.
   After each publish the training thread waits until both serve the
   version, or reject the torn delta with its CRC reason and keep
   serving: the engine's scores at 1, 64 and 256 rows BITWISE the
   trainer's ``forward_bucket`` on the same bucket, the app's /predict
   at 64 rows within rtol 1e-5, atol 1e-6 (the line says whether
   bitwise), each reaching every clean version (three by delta reload)
   and recovering at the compaction, while 4 client threads post
   /predict; then a 3 s window with no reload, /healthz 200, /metrics's
   reload series, and SIGTERM with exit 0. Every count at 0 just before
   the loop and read just after: bags on every forward, one write-only
   scatter with its pre-pass and one dense update a step, no plain
   version. Printed: each publish's split (the copy to
   the host, the diff, the write, the checksum), freshness (publish
   start to served, p50 and p99, delta and full, engine and app) and
   /predict requests/s with and without a reload in flight. (b) The
   app serving full-width "cat" with ``--retrieve on`` (1M items,
   k = 100), initialized weights, no checkpoint directory: /predict of
   two users answers 100 candidates each, /retrieve at k = 10 ids among
   them, SIGTERM exits 0.

10. criteo — Criteo's shapes, after phase 9. (0) Kernels 1-3 and the
   stateful entry at the Criteo-Kaggle step's shape: 6,656 lookups
   (batch 256 x 26 tables) at d = 16 into the 11,386,880-row
   concatenated table (``EmbeddingBagConcat``'s global ids of synthetic
   batches), the bag within 1e-6 of its plain version, the scatters and
   the stateful update (Adam) bitwise against theirs on the CPU, each
   timed beside its bound, its plain version and ``F.embedding_bag`` /
   ``index_add_``: one JSON line ``{"criteo_shapes": [...]}``. (a)
   Criteo-Kaggle (``DLRMConfig.criteo_kaggle()``, 26 tables of 4 to
   3,166,985 rows x 16, 0.73 GB) at batch 256 in the "cat" and the
   unfused "dot" graph under SGD and Adam: four steps on the kernels
   held against the same four steps, from the same weights and batches,
   on the plain versions of the bag, the scatters, the stateful entry
   and the dense update on the card (loss within rtol 1e-4; every
   parameter's and slab's change within 1e-3 of its largest change,
   1e-2 under Adam), counted (one bag, one scatter and one dense update
   a step; none in the plain run), then 20 steps timed:
   ms a step and samples/s. (c) The launcher with
   ``run_criteo_kaggle.sh``'s flags on the synthetic batch, on device
   tables and with ``--host-tables``, counted. (b) Criteo-Terabyte's
   widths with ``--host-tables``: the unfused "dot", 26 tables at d =
   128, bottom 13-512-256-128, top 479-1024-512-256-1, batch 2,048, SGD;
   the tables' rows are cut by one common factor (the tables of 1M rows
   or more) only as far as the host memory the process may still take
   (``MemAvailable``, and a memory cgroup's limit less its use where it
   has one) less 12 GiB forces, printed;
   the host init timed; the dense update over the model's dense set
   held bitwise to its plain version under every optimizer; a batch trained five times in exact mode must
   lower its loss; then 8 steps in exact and 8 in async mode (the next
   batch's ids passed, as ``fit`` passes them), each with samples/s and
   per step the host gather, the copy to the card, the cotangents'
   readback, the host scatter, the wall time, the device's busy time and
   idle share; one dense update a step and no bag or scatter on the
   card; untouched host rows unchanged. ``python3 chip_smoke.py
   --criteo`` runs only this phase (the kernels built first).

11. shard tier — serving host-resident tables, after phase 10:
   Criteo-Kaggle uncut with ``--host-tables``, the unfused "dot", 4
   in-process shards (``serve/shardtier.py``). (1) Freshness: a trainer
   at batch 2,048 runs ``fit_stream`` with a ``DeltaPublisher`` (a
   publish every 8 steps: a full base, deltas, the last torn, a
   compaction) into an in-process engine on the tier and the app as a
   child process (``--host-tables --serve-shards 4 --serve-cache-rows
   65536``); at every version the tier's blocks are bitwise the
   trainer's host table slot by slot, the engine bitwise the trainer,
   the app within 1e-5, version vectors never go back, the torn delta
   is rejected by both; freshness p50/p99, counted (one dense update a
   step). (2) The read path: 64 requests of 64 rows through the host
   gather, the row cache pre-warmed from the trainer's
   ``id_histogram.npz`` and 4 shards plus the cache, bitwise equal one
   request at a time, then requests/s and p50/p99 from 4 threads, the
   cache's hit rate and one tier gather's split. (3)
   ``FF_FAULT_SHARD_DOWN`` on slot 1 under traffic: no request fails,
   degraded answers flagged and counted, a publish lands meanwhile, the
   replacement boots from the shard warm cache, replays it from the
   history and is admitted by its probe; every outage request bitwise
   the trainer afterwards. (4) The cascade riding the tier: one publish
   moves ranking rows and ``augment_delta``'s item rows, the top-k
   kernel bitwise its plain version on every shard's rewritten block,
   the bag on the towers' tables, 32 users counted (top-k and bag); the
   app with ``--retrieve on --serve-shards 4``. ``python3 chip_smoke.py
   --shard-tier`` runs only this phase (the kernels built first).
12. fleet — serving across processes. (a) Shard processes over TCP,
   riding phase 11's loop: a ranker seeds the shard warm cache, 4
   ``serve.shard_server`` processes boot from it (none holds a CUDA
   context), an engine on the card reaches them through
   ``EmbeddingShardSet.connect`` and the app runs with
   ``--serve-transport tcp --serve-shard-procs 4 --compile-cache-dir``;
   at every version every process's block is bitwise the trainer's
   (read back over the wire), the engine bitwise the trainer, the app
   within 1e-5, the torn delta rejected by both. After the loop 64
   requests of 64 rows, each alone bitwise the in-process tier, timed
   from 4 threads through both; a shard process killed with SIGKILL
   under traffic (degraded, 0 failed, the slot replaced from the warm
   cache); ``FF_FAULT_NET_DROP``, ``DUP``, ``SLOW`` (this process) and
   ``REORDER`` (the shard processes) on the lookup seam, every answer
   bitwise. (b) Kaggle with device tables, 3 replicas behind a
   ``FleetRouter``: each request alone bitwise one engine, counted from
   4 threads (``embedding_bag`` once a dispatched batch, no plain
   version), the hedge, ``FF_FAULT_REPLICA_DOWN`` (0 failed, ejected,
   re-admitted), ``--retrieve on``'s cascade in front of the fleet
   bitwise the cascade in front of one engine (counted: ``mips_topk``
   once a user), shadow traffic never reaching a client, a poisoned
   canary rolled back and a good one promoted, the autoscaler growing 1
   to 2 replicas under a forced SLO breach and shrinking back when idle.
   (c) Two ranker processes (``chip_smoke.py --ranker-child``: the
   Kaggle ranker behind ``InferenceEngine.serve_forever()``) behind
   ``Fleet.connect`` and a router: bitwise (b)'s engine, one killed with
   SIGKILL under traffic, 0 failed. Requests/s and client p50/p99, each
   seam's RTT floor, eject and re-admit seconds and the autoscaler's
   grow time print, with a ``{"fleet": ...}`` line. ``python3
   chip_smoke.py --fleet`` runs phase 11's loop and phase 12 only.
13. ranks — DLRM trained across ranks as ``run_random.sh`` launches it:
   two ``chip_smoke.py --dist-rank`` processes on the one card (gloo:
   NCCL refuses two ranks on one GPU), each its own kernels, the full
   width of ``random_benchmark()``, 4 of the 8 tables (1.07 GB) a rank.
   Each rank trains 3 SGD steps of a global batch of 2,048 under
   ``dlrm_strategy`` and again under
   ``strategies/dlrm_strategy_8embs_8gpus.pb`` (loaded as ``--import``
   loads it), every count at 0 just before and read just after: one
   windowed scatter (``sharded_scatter_add_rows``, kernel 4), its 8,192
   lookups sorted by the radix pre-pass, and one ``dense_update`` a rank
   a step, no plain version. Each rank holds its
   tables and MLP weights to a world-1 run of the same steps from the
   same seed on the card: bitwise at the start, the losses within 1e-5,
   each update within 10 % of its parameter's largest (the
   card-versus-CPU step's bound: cuBLAS sums each rank's half of the
   batch, the world-1 call all of it, and a relu unit within that
   rounding of 0 can take the other branch), the weights' own error
   printed; the ranks' MLP weights are bitwise equal (their hashes). Then the launcher itself, ``run_random.sh``'s flags
   at 2 devices (``-ll:gpu 2 -b 512``) with ``--import``, counted the
   same way. The kernel is held bitwise to its plain version on the CPU
   at a rank's shape (8,192 ids on a 4M-row block, and with pads and
   ids outside the window) and timed with ``index_add_`` after a masked
   select beside it. The phase's seconds, each world's step time and
   every collective's bytes print, and, for each world, the first step's
   bias gradients (all-reduced across the ranks) against an fp64 sum of
   the per-sample cotangents of the whole batch (``BiasProbe``).
   ``python3 chip_smoke.py --dist`` runs only this phase.
14. quant — quantized tables and the two-tower train head, run after
   the cascade phase. (a) The two-tower "train" head at the cascade's own
   ``TwoTowerConfig`` (1M items, dim 32, 8 user tables of 1M x 8):
   ``fit`` over ``synthetic_two_tower_batch`` batches of 1,024 under the
   sparse softmax cross-entropy, every count at 0 just before and read
   just after (the bag and the touched-rows scatter of each table, one
   dense update a step, no plain version), the towers handed to the
   user and item heads by ``transfer_tower_params``, the catalog indexed
   and the cascade answering users, retrieval bitwise to ``exact_scan``.
   (b) ``random_benchmark()`` "cat" at full width, SGD, ``--emb-dtype
   int8 --emb-update-rule stochastic_rounding``: one ``fake_quant_rows``
   launch a step (route "philox") over the whole 2.05 GB table, counted
   the same way; every stored row a fixed point of nearest int8
   quantization; two runs from one seed bitwise; the drift from fp32
   training printed in code steps; the unfused "dot" re-quantized once
   a step, the fused "dot" (its table in the fused interaction, no
   embedding op) under no policy, as in the JAX package. (c) fp8 under
   stochastic rounding for a step (nearest), master_weight int8 bitwise
   fp32 training. (d) A delta publish from (b)'s trainer (a 2.05 GB full
   base in ``build/smoke/quant``, then int8 row payloads) reloaded by an
   engine: the served rows bitwise the dequantized payload, its scores
   the trainer's. (e) The kernel against its plain version at d = 8, 16,
   64, 128 with all-zero rows and rows at +-qmax codes: nearest (int8,
   fp8, bf16), the ``u``-tensor entry and the Philox entry bitwise; each
   Philox code floor or floor + 1 of x / s, 2,048 draws of a row
   unbiased within 6 standard errors; bitwise at the "cat" table's
   shape; timed there (Philox and nearest) and at Criteo-Kaggle's table
   beside the bound and the plain version. ``python3 chip_smoke.py
   --quant`` runs only this phase.

15. row shards — every table's rows split over the ranks (the
   all-to-all exchange of ``parallel/alltoall.py``), run after phase 13.
   The exchange's owner side at a rank's shape (2 peers x 8,192 slots, a
   4M-row block): the owner's gather (the bag kernel at bag 1, the
   sentinel clamped), the canonical combine (its segment sums on the
   scatter kernel), the routed SGD, gradient, momentum and Adam updates,
   each bitwise its plain version on the CPU. Then DIST_WORLD
   ``--rowshard-rank`` children on the card (gloo), each with half of
   every table of ``random_benchmark()`` at full width, a global batch of
   2,048, 3 steps a run, every count at 0 just before and read just
   after each split run: (a) the dense exchange under SGD and (c) under
   Adam, each held to a world-1 run from the same seed (bitwise at the
   start, the losses within DIST_LOSS_RTOL, each update within
   DIST_UPDATE_TOL of its parameter's largest), phase 13's split by table
   timed beside them; (b) on zipf(1.05) ids the dense, dedup, hybrid (hot
   head 0.05 of each table) and overlap exchanges under SGD, and (c) dedup
   under Adam, each BITWISE the dense exchange on the same ids (losses,
   MLPs, the bit sums of every table and slab, every touched row); the
   ranks' MLP weights bitwise equal; exact launch counts a step (the bag
   kernel 2, 3 with the hot head; the scatter kernel 2 to 6; the stateful
   entry 1 under Adam; no plain version). (d) The launcher with
   run_criteo_kaggle.sh's flags at 2 devices and an imported JSON
   strategy that splits the concatenated table's rows (``param_dim`` 2):
   the bag kernel and the scatter kernel twice a step. Each run's step
   ms, every collective's calls, bytes and host seconds a step beside the
   balanced and the padded exchange's bytes, and the distinct ids a rank
   under zipf print. ``python3 chip_smoke.py --rowshard`` runs only this
   phase.
16. tables split — DLRM across ranks under the rest of ``dlrm_strategy``
   and the reference's per-table files (``parallel/split.py``), run after
   phase 15. Kernel 4 at a Criteo-Kaggle row block's shape (13,312
   lookups of a global batch of 512, a block of 5,693,440 rows, d = 16)
   bitwise its plain version on the CPU, timed beside it and
   ``index_add_``. Then TP_WORLD ``--tablepar-rank`` children on the card
   (gloo): (a) the launcher with run_criteo_kaggle.sh's flags at
   ``-ll:gpu 2 -b 512``, no ``--import`` (the concatenated table, 0.73
   GB, in 2 row blocks); (b) the same under a per-table file (table i on
   device i % 2: 2 x 7,217,152 rows, each rank's block exactly its
   device's tables, the padding warned of); (c) ``build_dlrm(
   fuse_embeddings=False)`` at run_random.sh's widths, each of the 8
   Embeddings of 1M x 64 split by width. Then TP_WORLD4 children: (d)
   run_random.sh's stacked tables over 2 of the 4 ranks (a per-table
   file naming 2 devices) with the first top Linear split by channel
   [1, 2]. Each run TP_STEPS steps against a world-1 run from the same
   seed, every count at 0 just before and read just after its steps:
   bitwise at the start, the losses within DIST_LOSS_RTOL, each update
   within DIST_UPDATE_TOL of its parameter's largest, every copy of a
   piece bitwise equal across the ranks, exact launch counts a step and
   no plain version; (a) and (b) also through the launcher's 65 steps.
   Each run's step ms, every collective's calls, bytes and host seconds
   a step print. ``python3 chip_smoke.py --tablepar`` runs only this
   phase.
17. split tables under every optimizer — the stateful optimizers and
   the dense table update on tables split by table, row block or width
   (``stateful_update_rows(lo=)``, ``split_dense_grad``, the two-pass
   rounding of a width piece), run after phase 16. Kernel 2's windowed
   stateful entry at a Criteo-Kaggle row block's shape (13,312 lookups,
   rank 1's block of 5,693,440 rows, d = 16) and at the "cat" split's
   (4,096 lookups into a block of 4 tables of 1M x 64), Adam, and
   ``row_amax`` and ``fake_quant_rows_amax`` on a 1M x 32 width piece,
   each bitwise its plain version on the CPU and timed beside its bound.
   Then SO_WORLD ``--splitopt-rank`` children on the card (gloo): (a)
   ``random_benchmark()``'s "cat" split by table under Adam and under
   momentum with weight decay, global batch 1,024; (b) Criteo-Kaggle's
   concatenated table in 2 row blocks under Adam, global batch 512; (c)
   run_random.sh's 8 ``Embedding``s of 1M x 64 by width under Adam and
   under int8 stochastic rounding (``compile()``'s default optimizer);
   (d) the launcher with run_criteo_kaggle.sh's flags at ``-ll:gpu 2 -b
   512 --dense-embedding-update``; (e) the fused "dot" under Adam. Each
   run TP_STEPS steps against a world-1 run from the same seed, as
   phase 16 holds them, the optimizer's state slabs too: bitwise at the
   start, the losses within DIST_LOSS_RTOL, each update within
   DIST_UPDATE_TOL of its largest. Under Adam a gradient that the
   ranks' summation order moves across 0 flips a whole step of a value,
   and the later steps see it: there the first step's moments are held
   against world 1 (as phase 15 holds them); (b) every update and loss
   too; (e) every loss, and at most SO_FLIP_SHARE of a parameter's
   values off; (a) and (c) the losses up to the first update's, and
   every loss, weight and slab against a witness run on the same ranks
   with every op data-parallel (the tables whole on each rank: the
   ranks' order without the split). Under stochastic rounding each
   table value within one code of world 1's, and one more step's
   rounding bitwise one card's rounding of the gathered table. The
   share of values off by more printed, every copy
   bitwise equal across the ranks, exact launch counts a step (the
   stateful entry on its one-launch route) and no plain version. Each
   run's step ms, every collective's calls, bytes and host seconds a
   step print. ``python3 chip_smoke.py --splitopt`` runs only this
   phase.
18. training across ranks as ``fit`` runs it — checkpoints across ranks,
   a rank's share of an ``.ffbin``, ``fit``/``fit_stream``, the sentinel
   across ranks, host tables across ranks, delta publishes of
   row-sharded tables followed by a one-card engine, run after phase 17.
   First ``grad_sumsq``'s across-ranks form at the "cat" step's shapes:
   the first launch over a rank's own cotangent into a slot, the second
   over the MLP gradients adding the slot, bitwise the second list's
   own sum plus the slot and its root, within rtol 1e-5 of the plain
   version, one launch alone bitwise a rerun. Then FR_WORLD
   ``--fitranks-rank`` children on the card (gloo): (a) the launcher
   with run_criteo_kaggle.sh's flags at ``-ll:gpu 2 -b 512`` from an
   ``.ffbin`` of FR_KAGGLE_BATCHES synthetic Kaggle-shaped global
   batches (the native reader's row window), through the ring and with
   ``--no-prefetch``, every count at 0 just before and read just after,
   no plain version, the epoch's mse within DIST_LOSS_RTOL of world 1's
   launcher on the same file (run in this process); (b) "cat" at full
   width split by table under momentum with weight decay, global batch
   FR_B, a snapshot at step FR_FIT_STEPS // 2 (keep_last 1), stopped by
   an exception as the next step begins; (d) the Kaggle launcher with
   ``--host-tables --no-host-tables-async`` (its mse against world 1's
   host-table launcher; the ranks' copies' CRC-32 equal; a step's
   gather, copy, readback with the all-gather and scatter from the
   trace), then FR_HOST_STEPS momentum steps with Kaggle's table on the
   host against the same table on the card, bitwise (under plain SGD the
   host scatter applies a row's lookups one after another, as the JAX
   host path does, and the card sums them first). Then FR_WORLD fresh
   ``--fitranks-resume-rank`` children: (b) resumed from the snapshot
   by a model from other weights, every piece and slab bitwise the
   uninterrupted staged fit's (the snapshot's bytes, gather, write and
   restore seconds print); (c) Kaggle fits under ``skip_step`` and
   ``rollback`` with rank 1's share alone poisoned at FR_POISON: both
   ranks skip, or roll back once, at the same step, 2 ``grad_sumsq``
   launches a step and no plain version, the rollback fit and the
   no-anomaly ``skip_step`` fit bitwise the fit without the sentinel;
   (e) ``fit_stream`` of "cat" row-sharded (the dense exchange)
   publishing every FR_EVERY steps through a ``DeltaPublisher`` (a full
   snapshot every FR_FULL_EVERY + 1 publishes), followed from this
   process by a one-card engine with ``ServeConfig(reshard=True)``
   whose every install serves the trainer's gathered parameters
   (CRC-32 of each array), the freshness p50 printed; an engine without
   reshard rejects the full snapshot. ``python3 chip_smoke.py
   --fitranks`` runs only this phase.

The last two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": {...}}``. Without a GPU, or when any check
fails, the script exits non-zero and prints no result.

``python3 chip_smoke.py --serving-app`` runs only phase 9 (the kernels
built first).

``python3 chip_smoke.py --shapes`` runs only the per-shape timings of
the bag and the interaction (phase 7's ``{"shapes": [...]}``), with the
package of the directory the script lies in: a copy of the script placed
at the root of another tree of the port times that tree's kernels.
"""

import contextlib
import gc
import json
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from dlrm_flexflow_tpu_torch import FFConfig, FFModel
from dlrm_flexflow_tpu_torch.core.optimizers import (AdamOptimizer,
                                                     SGDOptimizer)
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.models.nmt import build_nmt
from dlrm_flexflow_tpu_torch.core import optimizers as opt_mod
from dlrm_flexflow_tpu_torch.ops.kernels import build
from dlrm_flexflow_tpu_torch.ops.kernels import dense_update as dense_mod
from dlrm_flexflow_tpu_torch.ops.kernels import embedding_bag as bag_mod
from dlrm_flexflow_tpu_torch.ops.kernels import interaction as inter_mod
from dlrm_flexflow_tpu_torch.ops.kernels import lstm as lstm_mod
from dlrm_flexflow_tpu_torch.ops.kernels import quant_rows as qr_mod
from dlrm_flexflow_tpu_torch.ops.kernels import scatter_rows as scat_mod
from dlrm_flexflow_tpu_torch.ops.kernels import topk as topk_mod
from dlrm_flexflow_tpu_torch.quant import quantize_rows
from dlrm_flexflow_tpu_torch.retrieve import (CascadeConfig, CascadeEngine,
                                              ShardedMIPSIndex,
                                              TwoTowerConfig,
                                              build_two_tower,
                                              dlrm_candidate_features,
                                              item_embeddings,
                                              synthetic_two_tower_batch,
                                              transfer_tower_params)
from dlrm_flexflow_tpu_torch.serve import (EmbeddingShardSet,
                                           InferenceEngine, ServeConfig,
                                           ShardTierConfig)
from dlrm_flexflow_tpu_torch.serve import shardtier as tier_mod
from dlrm_flexflow_tpu_torch.ops.rnn import lstm_layer
from dlrm_flexflow_tpu_torch.serve.engine import percentile

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the fp32
# rate outside the tensor cores and the dense bf16 and int8 tensor-core
# rates
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
# torch.cuda._sleep spins for a count of SM cycles: at most the H100's
# 1,980 MHz boost clock, so a spin lasts at least its nominal ms
SPIN_CYCLES_PER_MS = 1_980_000
SEED = 0
B, T, BAG, D, ROWS, H = 2048, 8, 1, 64, 1_000_000, 1024
ID_SETS = 20     # distinct id batches cycled while timing: 80 MB of rows,
#                  more than the 50 MB L2, as live traffic would touch
LR = 0.01            # the training step's SGD rate (examples/native/dlrm.py)
TRAIN_B = 256        # per-chip training batch (bench.py)
TRAIN_STEPS = 20
# the training runs' optimizers: bench.py's plain SGD; compile()'s
# default (SGD at the config's lr 0.01 with weight decay 1e-4); SGD with
# momentum and weight decay; Adam. All but plain SGD take the stateful
# touched-rows update on "cat" ("dot" keeps its table in the fused
# interaction, which takes the dense update)
TRAIN_OPTS = {
    "sgd": lambda: SGDOptimizer(lr=LR),
    "default": lambda: None,
    "momentum": lambda: SGDOptimizer(lr=LR, momentum=0.9, weight_decay=1e-4),
    "adam": lambda: AdamOptimizer(alpha=0.001),
}
TRAIN_RUNS = (("cat", "sgd"), ("dot", "sgd"), ("cat", "default"),
              ("cat", "momentum"), ("cat", "adam"), ("dot", "adam"))
# the settings the dense update is held to: the training runs' four,
# nesterov, and Adam with weight decay
DENSE_OPTS = {
    **TRAIN_OPTS,
    "default": lambda: SGDOptimizer(lr=LR, weight_decay=1e-4),
    "nesterov": lambda: SGDOptimizer(lr=LR, momentum=0.9, nesterov=True,
                                     weight_decay=1e-4),
    "adam_wd": lambda: AdamOptimizer(alpha=0.001, weight_decay=1e-4),
}
# the scatter kernels a training step may launch
SCATTERS = ("scatter_add_rows", "scatter_write_rows", "stateful_update_rows")
CHECK_ROWS = 65_536  # rows per table of the card-versus-CPU step check
# the retrieve -> rank cascade (examples/native/serve_dlrm.py
# _build_cascade around random_benchmark): a 1M-item index of width 32
N_ITEMS, TT_DIM, K = 1_000_000, 32, 100
TOPK_B = 64          # the query batch of benchmarks/bench_retrieve.py
ITEM_BATCH = 8192    # the item head's batch: 123 forward calls for 1M
CASCADE_REQUESTS = 64
# NMT training (benchmarks/run_zoo.py bench_nmt): batch 64, sequences of
# 40, a 32k vocabulary, 2 x 1024 encoder and decoder LSTMs, bf16 compute,
# SGD lr 0.1, sparse categorical cross-entropy
NMT_B, NMT_SEQ, NMT_VOCAB, NMT_DIM, NMT_LAYERS, NMT_LR = (
    64, 40, 32 * 1024, 1024, 2, 0.1)
# per step: 4 LSTM layers (encoder and decoder, 2 each) forward and
# backward, the gate phase of each resident backward (on the "wgmma"
# route: h = 1,024), and the two "none" embeddings' touched-rows
# updates, each sorted by the "block" pre-pass
NMT_LAUNCHES = {"lstm_fwd": 4, "lstm_fwd:resident": 4, "lstm_bwd": 4,
                "lstm_bwd:resident": 4,
                "lstm_gates": 4, "lstm_gates:wgmma": 4,
                "scatter_add_rows": 2,
                "scatter_add_rows:block": 2, "scatter_presort": 2,
                "dense_update": 1}
# Adam's step size is looked up on the device from the step: checked
# bitwise against the CPU's for steps 0 to ALPHA_STEPS - 1
ALPHA_STEPS = 100_000
# the launch phase: examples/native/dlrm.py's flow over the port, at the
# full width of random_benchmark(), batch 256, from a .ffbin of
# LAUNCH_STEPS batches (one epoch), with prefetch (depth 2) and without
LAUNCH_STEPS = 256
LAUNCH_ARGS = ["-b", str(TRAIN_B), "-e", "1", "--lr", str(LR),
               "--arch-embedding-size", "-".join([str(ROWS)] * T),
               "--arch-sparse-feature-size", str(D),
               "--arch-mlp-bot", "64-512-512-64",
               "--arch-mlp-top", "576-1024-1024-1024-1"]
LAUNCH_RUNS = (("prefetch, depth 2", ["--prefetch-depth", "2"]),
               ("no prefetch", ["--no-prefetch"]))
# fit's restart check: FIT_STEPS steps of "cat" under momentum 0.9 with
# weight decay 1e-4, a snapshot at FIT_STEPS // 2, keep_last 1
FIT_STEPS = 24
# the resilience phase: a skip_step run of SENTINEL_STEPS batches with
# batch POISON_AT poisoned, timed under SENTINEL_POLICIES; a rollback fit
# of ROLLBACK_STEPS steps with step POISON_AT poisoned; staged and ring
# fits over STAGE_SAMPLES samples; a served and trained trace of
# STREAM_STEPS requests, and fit_stream against a loop over
# STREAM_CHECK_STEPS steps
SENTINEL_STEPS = 24
POISON_AT = 10
SENTINEL_POLICIES = ("none", "skip_step", "raise")
ROLLBACK_STEPS = 16
STAGE_SAMPLES = 65_536
STREAM_STEPS = 64
STREAM_CHECK_STEPS = 16
# the continual loop: "dot" at full width, batch LOOP_B, a publish every
# LOOP_EVERY steps, a compaction after LOOP_DELTAS deltas (the last one
# torn), the bitwise checks at LOOP_SIZES rows, LOOP_CLIENTS /predict
# client threads, a LOOP_RATE_S window without a reload
LOOP_B = 2048
LOOP_EVERY = 8
LOOP_DELTAS = 4
LOOP_STEPS = LOOP_EVERY * (LOOP_DELTAS + 2)
LOOP_SIZES = (1, 64, 256)
LOOP_CLIENTS = 4
LOOP_RATE_S = 3.0
# the shard tier (phase 11): Criteo-Kaggle uncut with host tables, the
# unfused "dot", TIER_SHARDS in-process shards; a trainer at batch TIER_B
# publishing every TIER_EVERY steps (a full base, TIER_DELTAS deltas, the
# last torn, a compaction) on zipf(TIER_ZIPF) traffic; TIER_POOL
# requests of TIER_REQ_ROWS rows served TIER_PASSES times from
# TIER_CLIENTS threads per read path; TIER_OUTAGE_POOL new requests under
# the shard outage; TIER_CASCADE users through the cascade. Shard lookups
# get TIER_DEADLINE_MS (the app's default is 50 ms): a lookup that waits
# out the interpreter lock behind 4 client threads must not degrade an
# answer the bitwise checks read
TIER_SHARDS = 4
TIER_B = 2048
TIER_EVERY = 8
TIER_DELTAS = 4
TIER_STEPS = TIER_EVERY * (TIER_DELTAS + 2)
TIER_ZIPF = 1.05
TIER_CACHE = 65_536
TIER_REQ_ROWS = 64
TIER_POOL = 64
TIER_PASSES = 2
TIER_CLIENTS = 4
TIER_OUTAGE_POOL = 48
TIER_CASCADE = 32
TIER_DEADLINE_MS = 500.0
TIER_DEV = "cuda"
# serving across processes (phase 12): FLEET_SHARDS shard processes,
# FLEET_REPLICAS in-process replicas, RANKER_CHILDREN ranker processes;
# FLEET_POOL requests of TIER_REQ_ROWS rows from FLEET_CLIENTS threads;
# the lookup tier's re-lookups; the network drill's drop probability,
# duplicated frames, ms a frame and frames held a process, over
# FLEET_DRILL requests a fault; the hedge's delay; the failed attempts
# FF_FAULT_REPLICA_DOWN gives replica 1; FLEET_CASCADE users; an SLO
# every request misses
FLEET_SHARDS = 4
FLEET_REPLICAS = 3
RANKER_CHILDREN = 2
FLEET_POOL = 64
FLEET_CLIENTS = 4
FLEET_RETRIES = 3
FLEET_DROP = 0.2
FLEET_DUP = 8
FLEET_SLOW_MS = 2.0
FLEET_REORDER = 8
FLEET_DRILL = 16
FLEET_HEDGE_MS = 20.0
FLEET_DOWN_BUDGET = 6
FLEET_CASCADE = 16
FLEET_SLO_MS = 0.001
# the canary's score-divergence tolerance: a canary of the snapshot
# poisoned by FF_FAULT_POISON_RELOAD saturates Criteo-Kaggle's scores to
# 0 or 1 (their mean 0.5625 against 0.5005 on the CPU, 64 requests),
# one SGD step moves the mean by about 1e-3
FLEET_SCORE_TOL = 0.02
# training across ranks (phase 13): DIST_WORLD ranks on the card, a
# global batch of DIST_B, DIST_STEPS SGD steps a strategy; each update
# held to the world-1 run's within DIST_UPDATE_TOL of its parameter's
# largest (the card-versus-CPU step's bound: the ranks' cuBLAS calls sum
# half the batch each, the world-1 call all of it, and a relu unit within
# that rounding of 0 can take the other branch), the losses within
# DIST_LOSS_RTOL; run_random.sh's flags at DIST_WORLD devices for the
# launcher
DIST_WORLD = 2
DIST_B = 2048
DIST_STEPS = 3
DIST_UPDATE_TOL = 0.1
DIST_LOSS_RTOL = 1e-5
DIST_PB = "strategies/dlrm_strategy_8embs_8gpus.pb"
DIST_LAUNCH = ["-ll:gpu", str(DIST_WORLD), "-b", str(256 * DIST_WORLD),
               "-e", "1", "--lr", str(LR),
               "--arch-embedding-size", "-".join([str(ROWS)] * T),
               "--arch-sparse-feature-size", str(D),
               "--arch-mlp-bot", "64-512-512-64",
               "--arch-mlp-top", "576-1024-1024-1024-1"]
# row-sharded tables across ranks (phase 15): DIST_WORLD ranks on the
# card, every table's rows split over them (dlrm_strategy(row_shard=
# True)), a global batch of DIST_B, DIST_STEPS steps a run; the skew
# forms on zipf(RS_ZIPF) ids, the hybrid's hot head RS_HOT of each table;
# run_criteo_kaggle.sh's flags at DIST_WORLD devices for the launcher,
# the concatenated table split by rows (an imported JSON strategy)
RS_ZIPF = 1.05
RS_HOT = 0.05
RS_FORMS = (("dedup", dict(exchange="dedup")),
            ("hybrid", dict(exchange="dedup", hot_fraction=RS_HOT)),
            ("overlap", dict(overlap=True)))
# tables split across ranks (phase 16): run_criteo_kaggle.sh's flags at
# TP_WORLD devices (-b TP_KAGGLE_B) through the launcher, with no
# --import (the concatenated table in row blocks) and under a per-table
# file (table i on device i % TP_WORLD); the unfused "cat" at
# run_random.sh's widths, each Embedding split by width over TP_WORLD
# ranks; TP_WORLD4 ranks for run_random.sh's stacked tables over 2 of
# them (a per-table file naming 2 devices) with TP_LINEAR split by
# channel [1, 2]; each run TP_STEPS steps held to a world-1 run
TP_WORLD = 2
TP_WORLD4 = 4
TP_KAGGLE_B = 256 * TP_WORLD
TP_STEPS = 3
TP_LINEAR = "top_dense_0"
# the checkout's root, where the serving app runs as a module
REPO = Path(__file__).resolve().parent
# where the launch phase writes its .ffbin and checkpoints: the build
# directory of the checkout (git-ignored), removed at the end
WORK_DIR = REPO / "build" / "smoke"
# the card-versus-CPU step, at a reduced size in fp32
NMT_CHECK = dict(vocab=4096, dim=256, seq=12, batch=16, dtype="float32")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def queued_ms(fn, arg_sets, iters, host_ms):
    """(ms per call, why not) over up to `iters` calls cycling
    `arg_sets`, timed between two CUDA events behind a spin on the
    device, so that every call is enqueued before the device reaches the
    first event and the span holds no wait for the host: the device time
    of back-to-back calls. The spin lasts a few times what the host took
    to enqueue the calls (`host_ms` for `iters` of them). Where the device
    still overtook the host (a full launch queue blocks the host) the
    window shrinks. `why not` is None when the calls were queued, else
    why the span is their wall time instead, host waits included: a call
    that waits for the device (a data-dependent output size), or a device
    that overtook the host even one call at a time."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    n = iters
    while True:
        torch.cuda.synchronize()
        spin_ms = 4 * host_ms * n / iters + 5
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        t0.record()
        fn(*arg_sets[0])
        waits = t0.query()     # the first call waited for the spin
        for i in range(1, n):
            fn(*arg_sets[i % len(arg_sets)])
        t1.record()
        overtaken = t0.query()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / n
        if waits:
            return ms, ("the device reached the calls before the host had "
                        "enqueued one (a call waits for the device or fills "
                        "the launch queue)")
        if not overtaken:
            return ms, None
        if n == 1:
            return ms, "the device overtook the host"
        n = max(1, n // 8)


def time_ms(fn, arg_sets, iters=60, warmup=6, what="a call"):
    """(device ms, call ms) per call over `iters` calls cycling
    `arg_sets`, after a warmup. Device ms is ``queued_ms``'s; where the
    calls cannot be queued, the summed kernel time of the profiler's
    trace, and where that holds no device time either, the calls' wall
    time; a line says which. Call ms is the span of back-to-back calls
    between two CUDA events, which the host's launch rate bounds when the
    calls are short."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    t0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1.record()
    host_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    call_ms = t0.elapsed_time(t1) / iters
    dev_ms, why_not = queued_ms(fn, arg_sets, iters, host_ms)
    if why_not:
        traced = traced_device_us(fn, arg_sets, iters)
        if traced is None:
            print(f"  ({what}: {why_not}, and the trace holds no device "
                  f"time, so its device ms is the wall time of "
                  f"back-to-back calls)")
        else:
            dev_ms = sum(traced.values()) / 1e3
            print(f"  ({what}: {why_not}, so its device ms is the summed "
                  f"kernel time of the profiler's trace)")
    return dev_ms, call_ms


def traced_device_us(fn, arg_sets, reps):
    """Device microseconds per call by kernel name, from the profiler's
    CUPTI trace of `reps` calls cycling `arg_sets`; None when the trace
    holds no device time, as happens in some runs on a sandboxed card.
    What it gives are breakdowns printed beside the event timings, never
    those timings."""
    traced = traced_kernels(fn, arg_sets, reps)
    return traced and {k: us for k, (_, us) in traced.items()}


def traced_kernels(fn, arg_sets, reps):
    """{kernel name: (launches, device us) per call} from the profiler's
    trace, or None when the trace holds no device time."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    per = {e.key: (e.count / reps, e.self_device_time_total / reps)
           for e in prof.key_averages() if e.self_device_time_total > 0}
    return per or None


def traced_split(fn, arg_sets, reps=20):
    """The profiler's split of a call into its kernels, "name xN us"
    each per call, or "not measured" when the trace holds no device
    time."""
    traced = traced_kernels(fn, arg_sets, reps)
    if traced is None:
        return "not measured (no device time traced)"
    return ", ".join(f"{k[:40]} x{c:g} {us:.2f} us"
                     for k, (c, us) in traced.items())


def timed(prefix, fn, arg_sets):
    dev_ms, call_ms = time_ms(fn, arg_sets,
                              what=f"{prefix.rstrip('_') or 'kernel'} call")
    return {f"{prefix}ms": dev_ms, f"{prefix}call_ms": call_ms}


def bound(nbytes, flops=0, int8_ops=0, bf16_flops=0):
    """The least time in ms for the bytes (each input read once, each
    output written once) and the operations (fp32 outside the tensor
    cores, bf16 and int8 on them), and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (flops / PEAK_FP32_FLOPS + int8_ops / PEAK_INT8_OPS
             + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def print_row(r, extra=""):
    def fmt(key):
        v = r.get(key)
        return "n/a" if v is None else f"{v:.4f} ms"

    print(f"kernel {r['name']}: device {fmt('ms')} (call "
          f"{fmt('call_ms')}), plain {fmt('plain_ms')} (call "
          f"{fmt('plain_call_ms')}), library {fmt('library_ms')} (call "
          f"{fmt('library_call_ms')}), bound {1e3 * r['bound_ms']:.2f} us "
          f"({r['bound_by']}), max abs err {r['max_abs_err']:.3g}{extra}")


def stacked_ids(gen, batch, dev):
    ids = torch.randint(0, ROWS, (batch, T, BAG), device=dev, generator=gen)
    return ids + (torch.arange(T, device=dev) * ROWS)[None, :, None]


# the shapes the paths launch the bag and the interaction at: serving
# pads a batch to a power of two up to 256 and "dot" trains at 256; the
# cascade's user head looks up 64 rows at d = 8 in each of 8 1M-row
# tables, "cat" trains at 2,048 rows and a full bucket gathers 16,384
INTER_BATCHES = (16, 64, 256, 2048)
BAG_SHAPES = ((64, 8, "cascade user table"), (2048, 64, "\"cat\" step"),
              (16384, 64, "full bucket"))


def interaction_args(gen, dev, batch, d=D, h=H):
    """Bottom rows, weight and bias of the first top layer (Glorot
    uniform, as the model initialises it) for a batch of `batch`."""
    P = (T + 1) * T // 2
    bottom = torch.rand(batch, d, device=dev, generator=gen)
    lim = (6.0 / (d + P + h)) ** 0.5
    w = (torch.rand(d + P, h, device=dev, generator=gen) * 2 - 1) * lim
    bias = 0.01 * torch.randn(h, device=dev, generator=gen)
    return bottom, w, bias


def interaction_bound(batch, d=D, h=H, row_bytes=D * 4, ops_per_row=0):
    """bound() of one fused interaction call: the gathered rows and ids,
    the bottom rows, W, bias and the output against the dots' and the
    layer's fp32 operations."""
    P = (T + 1) * T // 2
    return bound(batch * T * BAG * (row_bytes + 8) + batch * d * 4
                 + (d + P) * h * 4 + h * 4 + batch * h * 4,
                 batch * T * BAG * ops_per_row
                 + batch * (2 * P * d + 2 * (d + P) * h))


def shape_phase(dev, gen, table):
    """The bag and the interaction at each shape their paths launch
    them at, each held to its plain version on the same inputs and
    timed beside its bound, the plain version and (for the bag)
    F.embedding_bag. Returns one row per shape."""
    out = []
    for batch in INTER_BATCHES:
        id_sets = [stacked_ids(gen, batch, dev) for _ in range(ID_SETS)]
        bottom, w, bias = interaction_args(gen, dev, batch)
        got = inter_mod.fused_interaction(table, id_sets[0], bottom, w, bias)
        want = inter_mod.fused_interaction_reference(table, id_sets[0],
                                                     bottom, w, bias)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"fused_interaction disagrees with its plain version at "
              f"B={batch}: {err}")
        b_ms, b_by = interaction_bound(batch)
        args = [(i,) for i in id_sets]
        out.append({
            "name": "fused_interaction", "shape": f"B={batch}",
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            **timed("", lambda i: inter_mod.fused_interaction(
                table, i, bottom, w, bias), args),
            **timed("plain_", lambda i: inter_mod.fused_interaction_reference(
                table, i, bottom, w, bias), args),
            "library_ms": None, "library_call_ms": None})
        print_row(out[-1], f" at B={batch}")
    print("  (the trace holds one fused kernel a call and cannot split it "
          "into gather, dots and layer: tools/kernel_probe.py times "
          "the kernel cut after each phase)")
    user_tables = None
    for n, d, what in BAG_SHAPES:
        if d == D:
            tab, nrows = table, T * ROWS
        else:
            if user_tables is None:
                user_tables = torch.randn(T * ROWS, d, device=dev,
                                          generator=gen)
            tab, nrows = user_tables, ROWS
        # each call looks up one table's rows, cycling the 8 tables
        args = [(torch.randint(0, nrows, (n, BAG), device=dev, generator=gen)
                 + (s % T) * ROWS * (d != D),) for s in range(ID_SETS)]
        got = bag_mod.embedding_bag(tab, args[0][0], "sum")
        want = bag_mod.embedding_bag_reference(tab, args[0][0], "sum")
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
              f"embedding_bag disagrees with its plain version at n={n}, "
              f"d={d}: {err}")
        b_ms, b_by = bound(n * BAG * d * 4 + n * d * 4 + n * BAG * 8,
                           n * BAG * d)
        out.append({
            "name": "embedding_bag", "shape": f"n={n} d={d} ({what})",
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            **timed("", lambda i: bag_mod.embedding_bag(tab, i, "sum"), args),
            **timed("plain_", lambda i: bag_mod.embedding_bag_reference(
                tab, i, "sum"), args),
            **timed("library_", lambda i: torch.nn.functional.embedding_bag(
                i, tab, mode="sum"), args)})
        print_row(out[-1], f" at n={n}, d={d} ({what})")
    del user_tables
    keys = ("name", "shape", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")
    print(json.dumps({"shapes": [{k: r[k] for k in keys} for r in out]}))
    return out


def kernel_phase(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = 0.5 * torch.randn(T * ROWS, D, device=dev, generator=gen)
    id_sets = [stacked_ids(gen, B, dev) for _ in range(ID_SETS)]
    rows = {}

    # -- kernel 1: embedding bag over the stacked table ----------------
    flat = [i.reshape(B * T, BAG) for i in id_sets]
    got = bag_mod.embedding_bag(table, flat[0], "sum")
    want = bag_mod.embedding_bag_reference(table, flat[0], "sum")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # same fp32 sum in bag order on both sides
    check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
          f"embedding_bag kernel disagrees with its plain version: {err}")
    n = B * T
    b_ms, b_by = bound(n * BAG * D * 4 + n * D * 4 + n * BAG * 8,
                       n * BAG * D)
    args = [(i,) for i in flat]
    rows["embedding_bag"] = {
        "name": "embedding_bag", "route": "cuda",
        "source": "dlrm_flexflow_tpu_torch/csrc/embedding_bag.cu",
        "replaces": "dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:55",
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        **timed("", lambda i: bag_mod.embedding_bag(table, i, "sum"), args),
        **timed("plain_", lambda i: bag_mod.embedding_bag_reference(
            table, i, "sum"), args),
        **timed("library_", lambda i: torch.nn.functional.embedding_bag(
            i, table, mode="sum"), args),
    }

    # -- kernel 2: fused gather -> X·Xᵀ -> tril -> first top layer -----
    bottom, w, bias = interaction_args(gen, dev, B)
    got = inter_mod.fused_interaction(table, id_sets[0], bottom, w, bias)
    want = inter_mod.fused_interaction_reference(table, id_sets[0], bottom,
                                                 w, bias)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # the dots and the layer's products sum in another fp32 order
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"fused_interaction kernel disagrees with its plain version: "
          f"{err}")
    b_ms, b_by = interaction_bound(B)
    args = [(i,) for i in id_sets]
    rows["fused_interaction"] = {
        "name": "fused_interaction", "route": "cuda",
        "source": "dlrm_flexflow_tpu_torch/csrc/interaction.cu",
        "replaces": "dlrm_flexflow_tpu/ops/pallas/interaction_kernel.py:92",
        "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        **timed("", lambda i: inter_mod.fused_interaction(
            table, i, bottom, w, bias), args),
        **timed("plain_", lambda i: inter_mod.fused_interaction_reference(
            table, i, bottom, w, bias), args),
        "library_ms": None, "library_call_ms": None,
    }
    for r in rows.values():
        print_row(r)
    rows.update(quant_kernels(dev, gen, table, id_sets, bottom, w, bias))
    rows.update(scatter_kernels(dev, gen, table))
    rows.update(stateful_kernel(dev, gen, table))
    shape_phase(dev, gen, table)
    return rows


def quant_kernels(dev, gen, table, id_sets, bottom, w, bias):
    """Kernels 5 and 6, the quantized bag and interaction, at the serving
    shape over the 8M-row table quantized to int8 (the bag also once in
    fp8). No path calls them yet (as in the JAX package): their rows
    carry 0 launches."""
    rows = {}
    src = "dlrm_flexflow_tpu_torch/csrc/"
    codes, scales = quantize_rows(table, "int8")
    flat = [i.reshape(B * T, BAG) for i in id_sets]
    n = B * T
    for dt in ("int8", "fp8"):
        c, sc = (codes, scales) if dt == "int8" else \
            quantize_rows(table, "fp8")
        got = bag_mod.embedding_bag_quant(c, sc, flat[0], "sum")
        want = bag_mod.embedding_bag_quant_reference(c, sc, flat[0], "sum")
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        # at bag 1 both compute code * scale and add nothing to it
        check(torch.equal(got, want), f"embedding_bag_quant ({dt}) kernel "
              f"disagrees with its plain version: {err}")
        print(f"kernel embedding_bag_quant ({dt}): bitwise equal to its "
              f"plain version at B*T={n}, bag {BAG}")
        del c, sc
    b_ms, b_by = bound(n * BAG * (D + 4 + 8) + n * D * 4, 2 * n * BAG * D)
    args = [(i,) for i in flat]
    r = {"name": "embedding_bag_quant", "route": "cuda",
         "source": src + "embedding_bag.cu",
         "replaces": "dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:189",
         "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
         **timed("", lambda i: bag_mod.embedding_bag_quant(
             codes, scales, i, "sum"), args),
         **timed("plain_", lambda i: bag_mod.embedding_bag_quant_reference(
             codes, scales, i, "sum"), args),
         "library_ms": None, "library_call_ms": None}
    rows[r["name"]] = r
    print_row(r, " (int8)")

    got = inter_mod.fused_interaction_quant(codes, scales, id_sets[0],
                                            bottom, w, bias)
    want = inter_mod.fused_interaction_quant_reference(
        codes, scales, id_sets[0], bottom, w, bias)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # X is bitwise at bag 1; the dots and the layer sum in another order
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"fused_interaction_quant kernel disagrees with its plain "
          f"version: {err}")
    b_ms, b_by = interaction_bound(B, row_bytes=D + 4, ops_per_row=2 * D)
    args = [(i,) for i in id_sets]
    r = {"name": "fused_interaction_quant", "route": "cuda",
         "source": src + "interaction.cu",
         "replaces": "dlrm_flexflow_tpu/ops/pallas/interaction_kernel.py:324",
         "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
         **timed("", lambda i: inter_mod.fused_interaction_quant(
             codes, scales, i, bottom, w, bias), args),
         **timed("plain_", lambda i:
                 inter_mod.fused_interaction_quant_reference(
                     codes, scales, i, bottom, w, bias), args),
         "library_ms": None, "library_call_ms": None}
    rows[r["name"]] = r
    print_row(r, " (int8)")
    return rows


def index_codes(gen, dev, rows=N_ITEMS, d=TT_DIM):
    """Random int8 item codes and scales with planted duplicate rows:
    exact score ties on distinct ids, which the order must break by id."""
    codes, scales = quantize_rows(
        torch.randn(rows, d, device=dev, generator=gen), "int8")
    dup = torch.randint(0, rows, (rows // 100,), device=dev, generator=gen)
    codes[dup] = codes[7].clone()
    scales[dup] = scales[7].clone()
    return codes, scales


TOPK_PHASES = (("score", ("chunk_max",)),
               ("select", ("threshold", "compact")),
               ("sort", ("sort_candidates",)),
               ("overflow", ("score_chunks", "merge_chunks")))


def topk_split(traced):
    """Text for a traced top-k call's device us by phase: score (the
    chunk maxima pass), select (threshold and compaction), sort, and the
    overflow route's passes where they ran."""
    if traced is None:
        return "not measured (no device time traced)"
    parts = []
    for phase, names in TOPK_PHASES:
        us = sum(v for k, v in traced.items() if any(n in k for n in names))
        if us or phase != "overflow":
            parts.append(f"{phase} {us:.2f} us")
    return ", ".join(parts)


def topk_kernel(dev):
    """Kernel 7, the int8 MIPS top-k, at the retrieval bench's query
    batch (B=64) over a 1M-row, d=32 index with k=100, and at B=1 (one
    user, as the cascade sends it): bitwise to its plain version on the
    card, on the select route (or the overflow route where a planted
    duplicate row reaches the top); one small shape, where k exceeds the
    chunks (the overflow route), and an index whose scores all tie, also
    against the plain version on the CPU. Each call's time is split into
    its phases from the trace, with the candidate counts of the select
    route."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    codes, scales = index_codes(gen, dev)
    qsets = [topk_mod.quantize_query(
        torch.randn(TOPK_B, TT_DIM, device=dev, generator=gen))
        for _ in range(8)]
    err = 0.0
    for b in (TOPK_B, 1):
        q, qs = qsets[0][0][:b], qsets[0][1][:b]
        got_s, got_i = topk_mod.mips_topk(q, qs, codes, scales, K)
        want_s, want_i = topk_mod.mips_topk_reference(q, qs, codes, scales,
                                                      K)
        torch.cuda.synchronize()
        err = max(err, float((got_s - want_s).abs().max()))
        check(torch.equal(got_i, want_i)
              and torch.equal(got_s.view(torch.int32),
                              want_s.view(torch.int32)),
              f"mips_topk kernel disagrees with its plain version at B={b}")
        check(bool((got_s[:, :-1] >= got_s[:, 1:]).all()),
              f"mips_topk scores not descending at B={b}")
    small = (qsets[1][0][:5], qsets[1][1][:5], codes[:20000],
             scales[:20000])
    tied = (qsets[2][0][:5], qsets[2][1][:5],
            codes[:50000].clone().copy_(codes[7]),
            scales[:50000].clone().fill_(float(scales[7])))
    for what, args, k, base in (("B=5, R=20000, k=1000, base=3", small, 1000,
                                 3),
                                ("an all-tied index, B=5, R=50000, k=100",
                                 tied, K, 0)):
        before = topk_mod.mips_topk.routes["overflow"]
        got_s, got_i = topk_mod.mips_topk(*args, k, base=base)
        want_s, want_i = topk_mod.mips_topk_reference(
            *(t.cpu() for t in args), k, base=base)
        check(topk_mod.mips_topk.routes["overflow"] == before + 1,
              f"mips_topk at {what} did not take the overflow route")
        check(torch.equal(got_i.cpu(), want_i)
              and torch.equal(got_s.cpu().view(torch.int32),
                              want_s.view(torch.int32)),
              f"mips_topk kernel disagrees with its plain version on the "
              f"CPU at {what}")
    print(f"kernel mips_topk: bitwise equal to its plain version at B=64 "
          f"and B=1 (R={N_ITEMS}, d={TT_DIM}, k={K}) and to the CPU's at "
          f"B=5, R=20000, k=1000, base=3 and on an all-tied index (both "
          f"on the overflow route)")
    # the index's codes and scales read once, the queries, the results
    R = N_ITEMS
    b_ms, b_by = bound(R * (TT_DIM + 4) + TOPK_B * (TT_DIM + 4)
                       + TOPK_B * K * 12,
                       2 * TOPK_B * R, int8_ops=2 * TOPK_B * R * TT_DIM)
    before = dict(topk_mod.mips_topk.routes)
    r = {"name": "mips_topk", "route": "cuda",
         "source": "dlrm_flexflow_tpu_torch/csrc/topk.cu",
         "replaces": "dlrm_flexflow_tpu/ops/pallas/topk_kernel.py:117",
         "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
         **timed("", lambda q, qs: topk_mod.mips_topk(
             q, qs, codes, scales, K), qsets),
         **timed("plain_", lambda q, qs: topk_mod.mips_topk_reference(
             q, qs, codes, scales, K), qsets),
         "library_ms": None, "library_call_ms": None}
    one = [(q[:1], qs[:1]) for q, qs in qsets]
    r["b1_ms"], r["b1_call_ms"] = time_ms(
        lambda q, qs: topk_mod.mips_topk(q, qs, codes, scales, K), one)
    r["b1_plain_ms"], r["b1_plain_call_ms"] = time_ms(
        lambda q, qs: topk_mod.mips_topk_reference(q, qs, codes, scales, K),
        one)
    routes = {k: v - before[k] for k, v in topk_mod.mips_topk.routes.items()}
    # at B = 1, as every cascade launch runs: the whole index and its
    # scales read once, one query, one result
    b1_bound, b1_by = bound(R * (TT_DIM + 4) + (TT_DIM + 4) + K * 12,
                            2 * R, int8_ops=2 * R * TT_DIM)
    print_row(r, f" (B=64); at B=1: device {r['b1_ms']:.4f} ms (call "
              f"{r['b1_call_ms']:.4f} ms), plain {r['b1_plain_ms']:.4f} ms "
              f"(call {r['b1_plain_call_ms']:.4f} ms), bound "
              f"{1e3 * b1_bound:.2f} us ({b1_by}); routes of the timed "
              f"calls {routes}")
    for b, sets in ((TOPK_B, qsets), (1, one)):
        counts = torch.cat([topk_mod.select_candidates(
            q, qs, codes, scales, K)[2] for q, qs in sets]).float()
        traced = traced_device_us(lambda q, qs: topk_mod.mips_topk(
            q, qs, codes, scales, K), sets, 16)
        print(f"mips_topk at B={b}: device per call by phase, traced: "
              f"{topk_split(traced)}; candidates a query: median "
              f"{float(counts.median()):g}, max {float(counts.max()):g} "
              f"(buffer {topk_mod.CAP}, k={K}, chunks of "
              f"{topk_mod.chunk_rows(R, K)} rows)")
    return {r["name"]: r}


def scatter_ids(gen, dev, n, kind):
    """n row ids of the 8M-row table: "uniform" (the first 8 equal),
    "equal" (every id the same row) or "zipf" (Zipf-skewed with exponent
    1.05, as hot embedding rows are, the ranks spread over the table)."""
    if kind == "equal":
        return torch.full((n,), 4_321_987, dtype=torch.int64, device=dev)
    if kind == "zipf":
        seed = int(torch.randint(0, 2 ** 31, (1,), device=dev,
                                 generator=gen))
        rank = np.random.RandomState(seed).zipf(1.05, n) - 1
        return torch.as_tensor((rank * 2_654_435_761) % (T * ROWS),
                               device=dev)
    ids = torch.randint(0, T * ROWS, (n,), device=dev, generator=gen)
    ids[:8] = ids[0].clone()
    return ids


def scatter_kernels(dev, gen, table):
    """Kernels 3 and 4 and the pre-pass on the 8M-row table at n = 2,048
    lookups (the training step's, whose numbers the kernels' rows carry)
    in three sets of ids (uniform, all equal, Zipf-skewed) and at
    n = 16,384 (the cluster pre-pass's limit, uniform), each held
    bitwise to the plain version on the CPU; then the pre-pass alone at
    the main path's other lookup counts (``presort_sizes``)."""
    rows = {}
    src = "dlrm_flexflow_tpu_torch/csrc/scatter_rows.cu"
    pallas = "dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py"
    # 60 sets of 2,048 (or 20 of 16,384) lookups: 90 (240) MB of rows,
    # updates and residuals cycled, more than the 50 MB L2
    for n, nsets, kind in ((TRAIN_B * T * BAG, 60, "uniform"),
                           (TRAIN_B * T * BAG, 60, "equal"),
                           (TRAIN_B * T * BAG, 60, "zipf"),
                           (B * T * BAG, ID_SETS, "uniform")):
        main = n == TRAIN_B * T * BAG and kind == "uniform"
        sets = []
        for _ in range(nsets):
            ids = scatter_ids(gen, dev, n, kind)
            upd = torch.randn(n, D, device=dev, generator=gen)
            sets.append((ids, upd, table[ids], -LR * upd))
        ids, upd, fwd, _ = sets[0]
        table_cpu = table.cpu()     # the timing below writes into table
        uniq = torch.unique(ids)
        m = int(uniq.numel())
        cpu_args = (ids.cpu(), upd.cpu(), fwd.cpu())
        # the pre-pass alone: bitwise to its plain version on the CPU
        got = scat_mod.scatter_presort(ids)
        want = scat_mod.presort_reference(ids.cpu())
        check(all(torch.equal(a.cpu(), w) for a, w in zip(got, want))
              and int((want[1][:, 0] >= 0).sum()) == m,
              f"scatter_presort kernel disagrees with its plain version at "
              f"n={n} ({kind} ids)")
        if main:
            i32 = [(s[0].to(torch.int32),) for s in sets]
            rows["scatter_presort"] = {
                "name": "scatter_presort", "route": "cuda", "source": src,
                "replaces": f"{pallas}:432", "max_abs_err": 0.0,
                # the ids read; the order (int32) and each lookup's
                # segment (two int32) written
                **dict(zip(("bound_ms", "bound_by"),
                           bound(n * 8 + n * 4 + n * 8))),
                **timed("", lambda i: scat_mod.scatter_presort(i),
                        [(s[0],) for s in sets]),
                **timed("plain_", lambda i: scat_mod.presort_reference(i),
                        [(s[0],) for s in sets]),
                **timed("library_", lambda i: torch.sort(i, stable=True),
                        i32)}
            print_row(rows["scatter_presort"], f" (n={n}; library: "
                      f"torch.sort of int32 ids, stable)")
        for name, with_fwd, line in (("scatter_add_rows", False, 289),
                                     ("scatter_write_rows", True, 495)):
            kern = getattr(scat_mod, name)
            plain = getattr(scat_mod, name + "_reference")

            def call(fn, t, ids, upd, fwd, *_, with_fwd=with_fwd, **kw):
                if with_fwd:
                    return fn(t, ids, upd, fwd, -LR, **kw)
                return fn(t, ids, upd, -LR, **kw)

            got = call(kern, table.clone(), ids, upd, fwd)
            want = call(plain, table_cpu.clone(), *cpu_args)
            got_rows, want_rows = got[uniq].cpu(), want[uniq.cpu()]
            err = float((got_rows - want_rows).abs().max())
            # both scale first, then sum a row's duplicates in lookup order
            check(torch.equal(got_rows, want_rows),
                  f"{name} kernel disagrees with its plain version at "
                  f"n={n} ({kind} ids): {err}")
            got[uniq] = table[uniq]
            check(torch.equal(got, table),
                  f"{name} kernel changed rows it was not given (n={n}, "
                  f"{kind} ids)")
            del got, want
            # the function reads the ids, the updates and one table (or
            # forward) row per distinct row, and writes that row
            b_ms, b_by = bound(n * 8 + n * D * 4 + 2 * m * D * 4, 2 * n * D)
            scratch = table        # timing only: its values no longer matter
            # as the ops call it (their ids wrapped into the table, so the
            # wrapper's range check, a wait for the device, is skipped)
            r = {"name": name, "route": "cuda", "source": src,
                 "replaces": f"{pallas}:{line}", "max_abs_err": err,
                 "bound_ms": b_ms, "bound_by": b_by,
                 **timed("", lambda *a: call(kern, scratch, *a,
                                             ids_in_range=True), sets)}
            if main:
                r.update(**timed("plain_", lambda *a: call(plain, scratch, *a),
                                 sets),
                         **timed("library_", lambda ids, _u, _f, scaled:
                                 scratch.index_add_(0, ids, scaled), sets),
                         **timed("checked_", lambda *a: call(kern, scratch,
                                                             *a), sets))
                split = traced_split(
                    lambda *a: call(kern, scratch, *a, ids_in_range=True),
                    sets)
                more = (f"; with the range check {r['checked_ms']:.4f} ms "
                        f"(call {r['checked_call_ms']:.4f} ms); plain "
                        f"{r['plain_ms']:.4f} ms (call "
                        f"{r['plain_call_ms']:.4f} ms); index_add_ "
                        f"{r['library_ms']:.4f} ms (call "
                        f"{r['library_call_ms']:.4f} ms); kernel launches a "
                        f"call, traced: {split}")
                rows[name] = r
            else:
                more = ""
            print(f"kernel {name} at n={n}, {kind} ids ({m} distinct rows): "
                  f"bitwise equal to its plain version; device "
                  f"{r['ms']:.4f} ms, pre-pass and update (call "
                  f"{r['call_ms']:.4f} ms){more}; bound "
                  f"{1e3 * b_ms:.2f} us ({b_by})")
        del sets
    presort_sizes(dev, gen, table.shape[0])
    scatter_pads(dev, gen, table)
    return rows


def presort_sizes(dev, gen, nrows):
    """The pre-pass's two kernels, the rank kernel and the cluster radix
    kernel, on uniform ids of a table of ``nrows`` rows at the main
    path's lookup counts (the "cat" step's 2,048, Criteo-Kaggle's step's
    6,656, a rank's share of a global batch of 2,048 on 4 tables, 8,192):
    each held bitwise to the plain version on the CPU and timed in turns
    (rank, radix, radix, rank) beside ``torch.sort`` of the int32 ids;
    the wrapper takes the rank kernel below RADIX_MIN lookups."""
    plan = scat_mod.presort_cluster
    for n in (TRAIN_B * T * BAG, TRAIN_B * KAGGLE_TABLES,
              DIST_B * (T // DIST_WORLD) * BAG):
        ids = [torch.randint(0, nrows, (n,), device=dev, generator=gen)
               for _ in range(ID_SETS)]
        want = scat_mod.presort_reference(ids[0].cpu())
        times = {"rank": [], "radix": []}
        try:
            for name in ("rank", "radix", "radix", "rank"):
                cluster = 0 if name == "rank" else scat_mod.RADIX_CLUSTER
                scat_mod.presort_cluster = lambda n_, c=cluster: c
                got = scat_mod.scatter_presort(ids[0], 0, nrows)
                check(all(torch.equal(a.cpu(), w)
                          for a, w in zip(got, want)),
                      f"scatter_presort's {name} kernel disagrees with its "
                      f"plain version at n={n}")
                times[name].append(timed(
                    "", lambda i: scat_mod.scatter_presort(i, 0, nrows),
                    [(i,) for i in ids])["ms"])
        finally:
            scat_mod.presort_cluster = plan
        lib = timed("", lambda i: torch.sort(i, stable=True),
                    [(i.to(torch.int32),) for i in ids])
        route = "radix" if plan(n) else "rank"
        print(f"kernel scatter_presort at n={n} on a {nrows:,}-row table: "
              f"both kernels bitwise equal to the plain version; device ms "
              f"rank {times['rank'][0]:.4f}, {times['rank'][1]:.4f}, radix "
              f"(C={scat_mod.RADIX_CLUSTER}) {times['radix'][0]:.4f}, "
              f"{times['radix'][1]:.4f}; the wrapper takes the {route} "
              f"kernel; torch.sort of int32 ids {lib['ms']:.4f} ms")


def stateful_ids(gen, dev, n, kind):
    """``scatter_ids``, or with kind "pads" uniform ids with pad slots
    among them (-1 in a run and alone, and -(rows + 1))."""
    if kind != "pads":
        return scatter_ids(gen, dev, n, kind)
    ids = scatter_ids(gen, dev, n, "uniform")
    ids[3] = -1
    ids[n // 2:n // 2 + n // 8] = -1
    ids[n // 4] = -(T * ROWS + 1)
    return ids


def stateful_check(table, slabs, gen, dev, n, kind, name, fused):
    """One ``stateful_update_rows`` call on its "fused" route (or on
    the pre-pass routes) against the plain version on the CPU over the
    same rows; returns the largest difference."""
    opt = TRAIN_OPTS[name]() or SGDOptimizer(lr=LR, weight_decay=1e-4)
    p = opt.row_params()
    alpha_t = opt.alpha_t(torch.tensor(4, dtype=torch.int32, device=dev))
    mine = {k: slabs[k] for k in opt.sparse_slab_names()}
    for v in mine.values():   # fresh state (momentum's v may be < 0)
        v.uniform_(0.0, 1e-3, generator=gen)
    ids = stateful_ids(gen, dev, n, kind)
    upd = torch.randn(n, D, device=dev, generator=gen)
    fwd = table[ids.clamp(min=0)]
    real = ids >= 0
    uniq, inv = torch.unique(ids[real], return_inverse=True)
    spare = torch.randint(0, T * ROWS, (4096,), device=dev, generator=gen)
    spare = spare[~torch.isin(spare, uniq)]
    spare_rows = [t[spare].clone() for t in (table, *mine.values())]
    # the plain version over the touched rows alone, on the CPU: a
    # compact table whose row i is uniq[i] (a monotone renaming, so each
    # row's lookups keep their order; pads stay pads)
    cids = ids.clone()
    cids[real] = inv
    want = table[uniq].cpu()
    want_s = {k: v[uniq].cpu() for k, v in mine.items()}
    scat_mod.stateful_update_rows_reference(
        want, cids.cpu(), upd.cpu(), fwd.cpu(), want_s, p,
        None if alpha_t is None else alpha_t.cpu())
    route = "fused" if fused else scat_mod.scatter_route(n, T * ROWS)
    before = scat_mod.stateful_update_rows.routes[route]
    scat_mod._stateful_kernels(table, ids, upd, fwd, mine, p, alpha_t, 1,
                               fused)
    check(scat_mod.stateful_update_rows.routes[route] == before + 1,
          f"stateful_update_rows did not take the {route} route")
    got = [table[uniq].cpu()] + [mine[k][uniq].cpu() for k in want_s]
    err = 0.0
    for a, b in zip(got, [want] + list(want_s.values())):
        err = max(err, float((a - b).abs().max()))
        check(torch.equal(a, b), f"stateful_update_rows kernel ({route} "
              f"route, {name}, n={n}, {kind} ids) disagrees with its "
              f"plain version")
    check(all(torch.equal(t[spare], r) for t, r in
              zip((table, *mine.values()), spare_rows)),
          f"stateful_update_rows kernel ({route} route, {name}) changed "
          f"rows it was not given")
    return err


def stateful_kernel(dev, gen, table):
    """Kernel 4's stateful entry, ``stateful_update_rows``, on the 8M-row
    table with state slabs of its size, at the "cat" step's n = 2,048
    lookups with the forward rows as the step passes them: on the
    one-launch "fused" route the step takes and on the pre-pass route
    the kernel had before it ("block", the one above BLOCK_SORT_MAX
    being "sort"), for each stateful optimizer of the
    training runs, in uniform (the first 8 equal), all-equal and Zipf
    ids and with pad slots, the touched rows and their slab rows held
    bitwise to the plain version run on the CPU over the same rows (the
    same alpha_t tensor), a sample of untouched rows unchanged; then,
    under Adam (two slabs), both routes timed beside the bound and the
    plain version at n = 2,048, and at 4,096, 8,192 and FUSED_MAX
    lookups (which set FUSED_MAX). No one PyTorch call computes a
    lazy row-wise optimizer step, so it has no library time."""
    src = "dlrm_flexflow_tpu_torch/csrc/scatter_rows.cu"
    pallas = "dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py"
    n = TRAIN_B * T * BAG
    slabs = {k: 1e-3 * torch.rand(T * ROWS, D, device=dev, generator=gen)
             for k in ("m", "v")}
    err = 0.0
    for kind in ("uniform", "equal", "zipf", "pads"):
        for name in ("default", "momentum", "adam"):
            for fused in (True, False):
                err = max(err, stateful_check(table, slabs, gen, dev, n,
                                              kind, name, fused))
    print(f"kernel stateful_update_rows at n={n}, on the fused and the "
          f"block route, in uniform, all-equal and Zipf ids and with pads: "
          f"bitwise equal to its plain version on the CPU under compile()'s "
          f"default SGD (weight decay), momentum with weight decay and "
          f"Adam; untouched rows kept")
    opt = TRAIN_OPTS["adam"]()
    p = opt.row_params()
    alpha_t = opt.alpha_t(torch.tensor(4, dtype=torch.int32, device=dev))
    row = None
    for n_ in (n, 4096, 8192, scat_mod.FUSED_MAX):
        # 90 MB of rows, updates and residuals at n = 2,048, cycled
        sets = []
        for _ in range(60 if n_ == n else 8):
            ids = scatter_ids(gen, dev, n_, "uniform")
            sets.append((ids, torch.randn(n_, D, device=dev, generator=gen),
                         table[ids]))
        m = int(torch.unique(sets[0][0]).numel())
        # Adam: the ids, the updates, per distinct row its weight (forward
        # row) read and written and its m and v rows read and written;
        # about 12 operations an element of a distinct row and one add a
        # lookup's
        b_ms, b_by = bound(n_ * 8 + n_ * D * 4 + m * D * 4 * (2 + 2 * 2),
                           n_ * D + 12 * m * D)

        def run(fused):
            return lambda i, u, f: scat_mod._stateful_kernels(
                table, i, u, f, slabs, p, alpha_t, 1, fused)

        r = {"name": "stateful_update_rows", "route": "cuda", "source": src,
             "replaces": f"{pallas}:495", "max_abs_err": err,
             "bound_ms": b_ms, "bound_by": b_by, **timed("", run(True), sets),
             **timed("block_", run(False), sets)}
        if n_ == n:
            r.update(**timed("plain_", lambda i, u, f:
                             scat_mod.stateful_update_rows_reference(
                                 table, i, u, f, slabs, p, alpha_t), sets),
                     library_ms=None, library_call_ms=None)
            row = r
            print_row(r, f" (n={n}, Adam, forward rows as residual, fused "
                      f"route; the block route {r['block_ms']:.4f} ms, call "
                      f"{r['block_call_ms']:.4f} ms; library: none)")
        else:
            print(f"kernel stateful_update_rows at n={n_} (Adam): fused "
                  f"{r['ms']:.4f} ms (call {r['call_ms']:.4f} ms), block "
                  f"{r['block_ms']:.4f} ms (call {r['block_call_ms']:.4f} "
                  f"ms); bound {1e3 * b_ms:.2f} us ({b_by}); the wrapper "
                  f"takes the {scat_mod.stateful_route(n_, T * ROWS)} route")
        del sets
    del slabs
    torch.cuda.empty_cache()
    return {row["name"]: row}


def scatter_pads(dev, gen, table):
    """Pad slots among the ids (-1 and -(rows + 1), which the Pallas
    kernels skip with ``@pl.when(row >= 0)``) on both pre-pass routes,
    n = 2,048 ("block") and 16,385 ("sort"), each scatter held bitwise to
    its plain version on the CPU with the last row (where -1 would wrap)
    and every row it was not given untouched; an id past the table
    raises."""
    rows = table.shape[0]
    table_cpu = table.cpu()
    for n, route in ((TRAIN_B * T * BAG, "block"),
                     (scat_mod.BLOCK_SORT_MAX + 1, "sort")):
        ids = torch.randint(0, rows - 1, (n,), device=dev, generator=gen)
        ids[100:300] = -1
        ids[torch.randperm(n, device=dev, generator=gen)[:n // 10]] = \
            -(rows + 1)
        upd = torch.randn(n, D, device=dev, generator=gen)
        fwd = table[ids.clamp(min=0)]
        real = torch.unique(ids[ids >= 0])
        for name, with_fwd in (("scatter_add_rows", False),
                               ("scatter_write_rows", True)):
            kern = getattr(scat_mod, name)
            plain = getattr(scat_mod, name + "_reference")
            extra = (fwd,) if with_fwd else ()
            before = kern.routes[route]
            got = kern(table.clone(), ids, upd, *extra, -LR)
            want = plain(table_cpu.clone(), ids.cpu(), upd.cpu(),
                         *(t.cpu() for t in extra), -LR)
            check(kern.routes[route] == before + 1,
                  f"{name} with pads did not take the {route} route")
            got_real, want_real = got[real].cpu(), want[real.cpu()]
            check(torch.equal(got_real, want_real),
                  f"{name} kernel disagrees with its plain version with "
                  f"pads (n={n}, {route} route)")
            got[real] = table[real]
            check(torch.equal(got, table),
                  f"{name} kernel changed a row it was not given, with "
                  f"pads (n={n}, {route} route)")
            bad = ids.clone()
            bad[7] = rows
            try:
                kern(table.clone(), bad, upd, *extra, -LR)
                raised = False
            except ValueError:
                raised = True
            check(raised, f"{name} took an id past the table")
        print(f"kernels scatter_add_rows/scatter_write_rows at n={n} with "
              f"{int((ids < 0).sum())} pad slots ({route} route): bitwise "
              f"equal to their plain versions on the CPU, only the "
              f"{real.numel()} real rows changed; an id past the table "
              f"raises")


def lstm_inputs(gen, dev, T, b, h, dtype):
    """xproj (T, b, 4h), wh (h, 4h) drawn as the LSTM ops draw it
    (Glorot), in `dtype`, and dys (T, b, h)."""
    lim = (6.0 / (5 * h)) ** 0.5
    xp = torch.randn(T, b, 4 * h, device=dev, generator=gen)
    wh = (torch.rand(h, 4 * h, device=dev, generator=gen) * 2 - 1) * lim
    dys = torch.randn(T, b, h, device=dev, generator=gen)
    return xp, wh.to(dtype), dys


def lstm_check(gen, dev, T, b, h, dtype):
    """Both LSTM kernels against their plain versions on the card: ys
    and cs of the forward, dzs of the backward (from the plain
    forward's residuals), and dxproj and dwh through the autograd
    Function. Returns the largest error of each."""
    xp, wh, dys = lstm_inputs(gen, dev, T, b, h, dtype)
    route = "resident" if dtype == torch.bfloat16 else "streaming"
    before = lstm_mod.lstm_fwd.routes[route]
    ys, cs = lstm_mod.lstm_fwd(xp, wh)
    check(lstm_mod.lstm_fwd.routes[route] == before + 1,
          f"lstm_fwd at T={T}, b={b}, h={h} did not take the {route} route")
    ys_r, cs_r = lstm_mod.lstm_fwd_reference(xp, wh)
    before = lstm_mod.lstm_bwd.routes[route]
    dzs = lstm_mod.lstm_bwd(xp, wh, ys_r, cs_r, dys)
    check(lstm_mod.lstm_bwd.routes[route] == before + 1,
          f"lstm_bwd at T={T}, b={b}, h={h} did not take the {route} route")
    dzs_r = lstm_mod.lstm_bwd_reference(xp, wh, ys_r, cs_r, dys)
    grads = []
    for fn in (lstm_mod.lstm_scan, lstm_mod.lstm_scan_reference):
        x, w = xp.clone().requires_grad_(), wh.clone().requires_grad_()
        fn(x, w).backward(dys)
        grads.append((x.grad, w.grad.float()))
    torch.cuda.synchronize()
    err = {k: float((a - r).abs().max()) for k, a, r in (
        ("ys", ys, ys_r), ("cs", cs, cs_r), ("dzs", dzs, dzs_r),
        ("dxproj", grads[0][0], grads[1][0]))}
    scale = float(grads[1][1].abs().max())
    err["dwh_rel"] = float((grads[0][1] - grads[1][1]).abs().max()) / scale
    # fp32: the same arithmetic, the recurrent products summed in another
    # order. bf16: the carried h (or dz) is rounded to bf16 before every
    # product, and a sum that lands near the midpoint of two bf16 values
    # can round the other way in one version, moving that operand by one
    # bf16 step (2^-8 of it) and the gates after it; dwh is rounded to
    # bf16 after an fp32 product of operands that differ so: two bf16
    # steps of its largest entry
    bf16 = dtype == torch.bfloat16
    tol, dwh_tol = (4e-3, 2 ** -6) if bf16 else (1e-5, 1e-5)
    what = f"T={T}, b={b}, h={h}, {str(dtype)[6:]} wh"
    for k, v in err.items():
        check(np.isfinite(v) and v <= (dwh_tol if k == "dwh_rel" else tol),
              f"LSTM kernels disagree with their plain versions at "
              f"{what}: {k} error {v:.3g}")
    print(f"kernels lstm_fwd/lstm_bwd ({route} route) at {what}: max abs "
          f"err "
          + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
          + f" (tolerance {tol:g}; dwh {dwh_tol:g} of its largest)")
    return err


def lstm_bwd_phases(sets, T, b, h):
    """The resident backward's gate phase (``lstm_gates``) at the NMT
    layer's shape on both its routes: each against its plain version,
    the "wgmma" route bitwise equal across two calls, the two timed in
    turns (wgmma, mma, mma, wgmma) beside the plain version and
    ``torch.addmm`` over the same bf16-rounded operands in fp32; and the
    serial phase's T-1 barriers alone, over one block per group: ({row
    name: row}, the barriers' ms)."""
    xp, wh, _, ys, _ = sets[0]
    want = lstm_mod.lstm_gates_reference(xp, wh, ys)
    err, got = {}, {}
    for route in ("wgmma", "mma"):
        before = lstm_mod.lstm_gates.routes[route]
        got[route] = lstm_mod.lstm_gates(xp, wh, ys, route=route)
        torch.cuda.synchronize()
        check(lstm_mod.lstm_gates.routes[route] == before + 1,
              f"lstm_gates did not take the {route} route")
        err[route] = float((got[route] - want).abs().max())
        # products of bf16 values are exact in fp32; the sums take
        # another order on the tensor cores than in cuBLAS's fp32 GEMM
        check(err[route] <= 1e-4, f"lstm_gates kernel ({route} route) "
              f"disagrees with its plain version: {err[route]}")
    # one warpgroup sums each output in k order: no split-K, no atomics
    check(torch.equal(got["wgmma"], lstm_mod.lstm_gates(
        xp, wh, ys, route="wgmma")), "two lstm_gates calls on the wgmma "
          "route differ")
    del got, want
    lib_args = []
    for xp, wh, _, ys, _ in sets:
        hp = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
        lib_args.append((xp.view(T * b, 4 * h),
                         hp.view(T * b, h).to(wh.dtype).float(), wh.float()))
    # xproj and the gates, ys and wh moved once; the products the data
    # needs (none at t = 0)
    b_ms, b_by = bound(2 * T * b * 4 * h * 4 + (T - 1) * b * h * 4
                       + h * 4 * h * 2,
                       bf16_flops=2 * (T - 1) * b * h * 4 * h)
    turns = {"wgmma": [], "mma": []}
    for route in ("wgmma", "mma", "mma", "wgmma"):
        turns[route].append(time_ms(
            lambda xp, wh, _d, ys, _c: lstm_mod.lstm_gates(
                xp, wh, ys, route=route), sets,
            what=f"lstm_gates {route} call"))
    plain = timed("plain_", lambda xp, wh, _d, ys, _c:
                  lstm_mod.lstm_gates_reference(xp, wh, ys), sets)
    library = timed("library_", torch.addmm, lib_args)
    rows = {}
    for route in ("wgmma", "mma"):
        (d0, c0), (d1, c1) = turns[route]
        r = {"name": f"lstm_gates:{route}", "route": "cuda",
             "source": "dlrm_flexflow_tpu_torch/csrc/lstm.cu",
             "replaces": "dlrm_flexflow_tpu/ops/pallas/lstm_kernel.py:106",
             "max_abs_err": err[route], "bound_ms": b_ms, "bound_by": b_by,
             "ms": (d0 + d1) / 2, "call_ms": (c0 + c1) / 2, **plain,
             **library}
        print_row(r, f" ({route} route, T={T}, b={b}, h={h}; its two "
                  f"turns {d0:.4f} / {d1:.4f} ms; library: torch.addmm "
                  f"of the bf16-rounded operands in fp32)")
        rows[r["name"]] = r
    groups = -(-h // lstm_mod.UNITS)
    barrier_ms, _ = time_ms(lambda: lstm_mod.grid_barrier(
        T - 1, groups, torch.device("cuda")), [()], iters=20, warmup=2,
        what="barrier probe")
    return rows, barrier_ms


def lstm_kernels(dev):
    """Kernels 8 and 9, the LSTM forward and backward scans, at the NMT
    training step's per-layer shape (T=40, b=64, h=1024) in bf16 wh (the
    path's) and in fp32, and at a ragged shape (T=7, b=24, h=136),
    against their plain versions; then timed beside their bounds, the
    plain versions and cuDNN's LSTM layer (``torch.nn.LSTM``), whose
    forward also computes the input product x·wx: it stands beside
    "x·wx product + kernel" at the encoder's input width d=1024."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    T, b, h, d = NMT_SEQ, NMT_B, NMT_DIM, NMT_DIM
    err = {}
    for dt in (torch.bfloat16, torch.float32):
        err[dt] = lstm_check(gen, dev, T, b, h, dt)
        lstm_check(gen, dev, 7, 24, 136, dt)
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        sets = []
        for _ in range(3):     # 3 x 134 MB of inputs: more than the L2
            xp, wh, dys = lstm_inputs(gen, dev, T, b, h, dt)
            sets.append((xp, wh, dys, *lstm_mod.lstm_fwd(xp, wh)))
        fwd = time_ms(lambda xp, wh, *_: lstm_mod.lstm_fwd(xp, wh), sets,
                      iters=20, warmup=2)
        bwd = time_ms(lambda xp, wh, dys, ys, cs: lstm_mod.lstm_bwd(
            xp, wh, ys, cs, dys), sets, iters=20, warmup=2)
        pfwd = time_ms(lambda xp, wh, *_: lstm_mod.lstm_fwd_reference(
            xp, wh), sets, iters=4, warmup=1, what="plain lstm_fwd")
        pbwd = time_ms(lambda xp, wh, dys, ys, cs:
                       lstm_mod.lstm_bwd_reference(xp, wh, ys, cs, dys),
                       sets, iters=4, warmup=1, what="plain lstm_bwd")
        if dt == torch.bfloat16:
            gate_rows, barrier_ms = lstm_bwd_phases(sets, T, b, h)
        # cuDNN's layer and the port's layer (product + kernel) on the
        # same weights: weight_ih = wxᵀ, weight_hh = whᵀ, bias_ih = bias
        x = torch.randn(b, T, d, device=dev, generator=gen)
        wx = (torch.rand(d, 4 * h, device=dev, generator=gen) * 2 - 1) \
            * (6.0 / (d + 4 * h)) ** 0.5
        bias = 0.01 * torch.randn(4 * h, device=dev, generator=gen)
        wh = sets[0][1].float()
        rnn = torch.nn.LSTM(d, h).to(dev)
        with torch.no_grad():
            rnn.weight_ih_l0.copy_(wx.t())
            rnn.weight_hh_l0.copy_(wh.t())
            rnn.bias_ih_l0.copy_(bias)
            rnn.bias_hh_l0.zero_()
        rnn = rnn.to(dt)
        rnn.flatten_parameters()
        xt = x.transpose(0, 1).contiguous().to(dt).requires_grad_()
        go = torch.randn(T, b, h, device=dev, generator=gen)
        leaves = [t.clone().requires_grad_() for t in (x, wx, wh, bias)]
        go_bt = go.transpose(0, 1).contiguous()
        mine = lstm_layer(*leaves, dt)
        theirs = rnn(xt)[0].float().transpose(0, 1)
        torch.cuda.synchronize()
        layer_err = float((mine.detach() - theirs.detach()).abs().max())
        lib_fwd = time_ms(lambda: rnn(xt), [()], iters=20, warmup=2)
        out = rnn(xt)[0]
        params = [xt] + list(rnn.parameters())
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            out, params, go.to(dt), retain_graph=True), [()], iters=20,
            warmup=2)
        lib_both = time_ms(lambda: torch.autograd.grad(
            rnn(xt)[0], params, go.to(dt)), [()], iters=20, warmup=2)
        my_fwd = time_ms(lambda: lstm_layer(*leaves, dt), [()], iters=20,
                         warmup=2)
        my_both = time_ms(lambda: torch.autograd.grad(
            lstm_layer(*leaves, dt), leaves, go_bt), [()], iters=20,
            warmup=2)
        name = str(dt)[6:]
        del sets, rnn, out, params, leaves, mine, theirs
        torch.cuda.empty_cache()
        # the bytes each function must move and the recurrent products
        # this run's data needs: none at the first step of the forward
        # (h = 0) nor at the last of the backward's carry (dz = 0)
        wb = h * 4 * h * (2 if dt == torch.bfloat16 else 4)
        tbh, prod = T * b * h * 4, 2 * b * h * 4 * h * (T - 1)
        ops = ({"bf16_flops": prod} if dt == torch.bfloat16
               else {"flops": prod})
        fb = bound(4 * tbh + wb + 2 * tbh, **ops)
        ops2 = {k: 2 * v for k, v in ops.items()}
        bb = bound(4 * tbh + wb + 3 * tbh + 4 * tbh, **ops2)
        print(f"kernel lstm_fwd ({name} wh): device {fwd[0]:.4f} ms (call "
              f"{fwd[1]:.4f} ms), plain {pfwd[0]:.4f} ms (call "
              f"{pfwd[1]:.4f} ms), bound {1e3 * fb[0]:.2f} us ({fb[1]}); "
              f"lstm_bwd: device {bwd[0]:.4f} ms (call {bwd[1]:.4f} ms), "
              f"plain {pbwd[0]:.4f} ms (call {pbwd[1]:.4f} ms), bound "
              f"{1e3 * bb[0]:.2f} us ({bb[1]})")
        print(f"layer d={d} ({name}): cuDNN LSTM forward {lib_fwd[0]:.4f} "
              f"ms, backward {lib_bwd[0]:.4f} ms, forward+backward "
              f"{lib_both[0]:.4f} ms; x·wx product + kernel forward "
              f"{my_fwd[0]:.4f} ms, forward+backward {my_both[0]:.4f} ms; "
              f"max abs difference of the outputs {layer_err:.3g}")
        froute = "resident" if dt == torch.bfloat16 else "streaming"
        print(f"lstm_fwd ({name} wh, {froute} route): serial step "
              f"{1e3 * fwd[0] / T:.2f} us (the call / T={T})"
              + (f", beside {1e3 * barrier_ms / (T - 1):.2f} us a barrier "
                 f"alone" if dt == torch.bfloat16 else ""))
        if dt == torch.bfloat16:
            gms = gate_rows["lstm_gates:wgmma"]["ms"]
            print(f"lstm_bwd split (bf16, resident route): gate phase "
                  f"(wgmma) {gms:.4f} ms, serial phase {bwd[0] - gms:.4f} "
                  f"ms (the "
                  f"whole call less the gate phase), of it {T - 1} "
                  f"barriers alone {barrier_ms:.4f} ms "
                  f"({1e3 * barrier_ms / (T - 1):.2f} us a "
                  f"barrier over {-(-h // lstm_mod.UNITS)} blocks)")
            rows.update(gate_rows)
            src = "dlrm_flexflow_tpu_torch/csrc/lstm.cu"
            pallas = "dlrm_flexflow_tpu/ops/pallas/lstm_kernel.py"
            for kname, line, t, p_, lib, bd, e in (
                    ("lstm_fwd", 44, fwd, pfwd, lib_fwd, fb,
                     max(err[dt]["ys"], err[dt]["cs"])),
                    ("lstm_bwd", 95, bwd, pbwd, lib_bwd, bb,
                     err[dt]["dzs"])):
                rows[kname] = {
                    "name": kname, "route": "cuda", "source": src,
                    "replaces": f"{pallas}:{line}", "max_abs_err": e,
                    "bound_ms": bd[0], "bound_by": bd[1],
                    "ms": t[0], "call_ms": t[1], "plain_ms": p_[0],
                    "plain_call_ms": p_[1], "library_ms": lib[0],
                    "library_call_ms": lib[1]}
    return rows


def dense_params(mode):
    """The dense parameters of the full-width model of one graph, as
    its training step hands them to the optimizer: every parameter on
    "dot" (its 8M x 64 table, 1.9 GiB, included), all but the table on
    "cat" (which takes the touched-rows update)."""
    model, _ = train_model(mode, "cuda")
    model.init_layers()
    sparse = {op.name for op in model._select_sparse_update_ops()}
    return [v for op, p in model.params.items() if op not in sparse
            for v in p.values()]


def dense_state(gen, ws, names):
    """Non-zero state for each weight: v positive, as a sum of squares
    is (momentum's v too, which does not matter)."""
    return [{k: 1e-3 * (torch.rand(w.shape, device=w.device, generator=gen)
                        if k == "v" else torch.randn(
                            w.shape, device=w.device, generator=gen))
             for k in names} for w in ws]


def library_update(opt, ws, gs, slabs, steps):
    """One PyTorch call that computes the optimizer step over the same
    tensor lists (``torch._fused_adam_`` / ``_fused_sgd_``, another
    operation order, so not bitwise), or None where this PyTorch lacks
    it. A yardstick only: the port never calls it."""
    p = opt.row_params()
    if p["kind"] == "adam" and hasattr(torch, "_fused_adam_"):
        ms, vs = [s["m"] for s in slabs], [s["v"] for s in slabs]
        return lambda: torch._fused_adam_(
            ws, gs, ms, vs, [], steps, lr=opt.alpha, beta1=p["beta1"],
            beta2=p["beta2"], weight_decay=p["weight_decay"],
            eps=p["epsilon"], amsgrad=False, maximize=False)
    if p["kind"] == "sgd" and hasattr(torch, "_fused_sgd_"):
        bufs = [s["v"] for s in slabs] if p["momentum"] > 0 else []
        return lambda: torch._fused_sgd_(
            ws, gs, bufs, weight_decay=p["weight_decay"],
            momentum=p["momentum"], lr=p["lr"], dampening=0.0,
            nesterov=p["nesterov"], maximize=False, is_first_step=False)
    return None


def dense_matches_plain(ws, gs, gen, what):
    """``dense_update`` over the weights `ws` and gradients `gs`, from
    non-zero state, in one launch, held BITWISE to its plain version on
    the card (``dense_update_reference``) under all of DENSE_OPTS; `ws`
    ends as the plain version left it. Returns the largest difference."""
    step = torch.tensor(4, dtype=torch.int32, device=ws[0].device)
    err = 0.0
    for name, make in DENSE_OPTS.items():
        opt = make()
        p, alpha_t = opt.row_params(), opt.alpha_t(step)
        slabs = dense_state(gen, ws, opt.sparse_slab_names())
        got_w = [w.clone() for w in ws]
        got_s = [{k: v.clone() for k, v in s.items()} for s in slabs]
        before = dense_mod.dense_update.launches
        dense_mod.dense_update(got_w, gs, got_s, p, alpha_t)
        made = dense_mod.dense_update.launches - before
        check(made == 1, f"dense_update made {made} launches for "
              f"{len(ws)} tensors")
        dense_mod.dense_update_reference(ws, gs, slabs, p, alpha_t)
        for a, b in zip(got_w + [t for s in got_s for t in s.values()],
                        ws + [t for s in slabs for t in s.values()]):
            err = max(err, float((a - b).abs().max()))
            check(torch.equal(a, b), f"dense_update kernel ({what}, "
                  f"{name}) disagrees with its plain version")
        del got_w, got_s, slabs
    print(f"kernel dense_update over {what} ({len(ws)} tensors, "
          f"{sum(w.numel() for w in ws)} elements): bitwise equal to its "
          f"plain version on the card under {', '.join(DENSE_OPTS)}")
    return err


def dense_kernel(dev):
    """The dense update (``dense_update``, one launch for every dense
    parameter of a step) over the full-width "dot" parameter set (the
    8M x 64 table and the MLPs, 15 tensors) and the "cat" set (its 14
    MLP tensors), from non-zero state, held BITWISE to its plain version
    on the card (``dense_update_reference``: the same row math as
    separate PyTorch ops, one rounding each) under all of DENSE_OPTS;
    then timed beside its bound, the plain version and one
    ``torch._fused_adam_`` / ``_fused_sgd_`` call over the same lists,
    under Adam (the row) and plain SGD, on both sets."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    step = torch.tensor(4, dtype=torch.int32, device=dev)
    print("kernel dense_update: blocks per SM "
          + ", ".join(f"{k} slabs {dense_mod.blocks_per_sm(k)}"
                      for k in range(3)))
    row = None
    for mode in ("dot", "cat"):
        ws = dense_params(mode)
        gs = [torch.randn(w.shape, device=dev, generator=gen) for w in ws]
        nel = sum(w.numel() for w in ws)
        err = dense_matches_plain(ws, gs, gen, f"the \"{mode}\" set")
        for name in ("adam", "sgd"):
            opt = DENSE_OPTS[name]()
            p, alpha_t = opt.row_params(), opt.alpha_t(step)
            names = opt.sparse_slab_names()
            slabs = dense_state(gen, ws, names)
            steps = [torch.tensor(5.0, device=dev) for _ in ws]
            lib = library_update(opt, ws, gs, slabs, steps)
            # each element of w, g and every slab read once, w and every
            # slab written once; Adam about 11 operations an element
            b_ms, b_by = bound(nel * 4 * (3 + 2 * len(names)),
                               nel * (11 if name == "adam" else 3))
            r = {"name": "dense_update", "route": "cuda",
                 "source": "dlrm_flexflow_tpu_torch/csrc/dense_update.cu",
                 "replaces": "dlrm_flexflow_tpu/core/optimizers.py:167",
                 "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                 **timed("", lambda: dense_mod.dense_update(
                     ws, gs, slabs, p, alpha_t), [()]),
                 **timed("plain_", lambda: dense_mod.dense_update_reference(
                     ws, gs, slabs, p, alpha_t), [()]),
                 **(timed("library_", lib, [()]) if lib else
                    {"library_ms": None, "library_call_ms": None})}
            what = ("torch._fused_adam_" if name == "adam"
                    else "torch._fused_sgd_")
            print_row(r, f" (\"{mode}\" set, {name}; library: {what}"
                      f"{'' if lib else ', which this PyTorch lacks'})")
            if (mode, name) == ("dot", "adam"):
                row = r
            del slabs, steps, lib
        del ws, gs
        torch.cuda.empty_cache()
    return {row["name"]: row}


def alpha_t_check(dev):
    """Adam's step size, the 0-d fp32 tensor the port looks up on the
    device from the int32 step (``AdamOptimizer.alpha_t``), against the
    same on the CPU (which tests/test_torch_optimizers.py holds bitwise
    to jitted JAX), for steps 0 to ALPHA_STEPS - 1, one 0-d call each as
    a training step makes it: any step that differs fails the run."""
    opt = AdamOptimizer(alpha=0.001)
    steps = torch.arange(ALPHA_STEPS, dtype=torch.int32)
    on_card = steps.to(dev)
    got = torch.stack([opt.alpha_t(on_card[i])
                       for i in range(ALPHA_STEPS)]).cpu()
    want = torch.stack([opt.alpha_t(steps[i]) for i in range(ALPHA_STEPS)])
    differ = torch.nonzero(got.view(torch.int32)
                           != want.view(torch.int32)).reshape(-1)
    print(f"alpha_t: card against cpu, bitwise, steps 0-{ALPHA_STEPS - 1}: "
          f"{differ.numel()} differ")
    check(differ.numel() == 0,
          f"alpha_t differs on the card at steps {differ[:100].tolist()} "
          f"(largest difference {float((got - want).abs().max()):.3g})")


# every kernel wrapper of the port, each counting its own launches (and
# those with several routes, each route's in ``routes``)
LAUNCHED = (bag_mod.embedding_bag, inter_mod.fused_interaction,
            scat_mod.scatter_add_rows, scat_mod.scatter_write_rows,
            scat_mod.stateful_update_rows, scat_mod.sharded_scatter_add_rows,
            scat_mod.scatter_presort, dense_mod.dense_update,
            dense_mod.grad_sumsq, topk_mod.mips_topk,
            bag_mod.embedding_bag_quant, inter_mod.fused_interaction_quant,
            lstm_mod.lstm_fwd, lstm_mod.lstm_gates, lstm_mod.lstm_bwd,
            qr_mod.fake_quant_rows, qr_mod.row_amax,
            qr_mod.fake_quant_rows_amax)


def zero_counts():
    for k in LAUNCHED:
        k.launches = 0
        for route in getattr(k, "routes", {}):
            k.routes[route] = 0


def read_counts():
    """{wrapper: launches} and {"wrapper:route": launches} for each
    route of a wrapper that has several."""
    counts = {k.__name__: k.launches for k in LAUNCHED}
    for k in LAUNCHED:
        for route, v in getattr(k, "routes", {}).items():
            counts[f"{k.__name__}:{route}"] = v
    return counts


# the kernels no path of the port calls yet, as in the JAX package
OFF_PATH = {"embedding_bag_quant", "fused_interaction_quant"}
# the kernels whose route no shape of this script's paths takes: the
# "mma" gate GEMM serves only an LSTM whose h % 4 != 0
OFF_SHAPE = {"lstm_gates:mma"}


class PlainCalls:
    """Counts calls of the kernels' plain versions while installed (the
    wrappers look them up as module globals at each call)."""

    def __init__(self):
        self.calls = 0
        self._saved = []

    def __enter__(self):
        for mod, name in ((bag_mod, "embedding_bag_reference"),
                          (inter_mod, "fused_interaction_reference"),
                          (scat_mod, "scatter_add_rows_reference"),
                          (scat_mod, "scatter_write_rows_reference"),
                          (scat_mod, "sharded_scatter_add_rows_reference"),
                          (scat_mod, "stateful_update_rows_reference"),
                          (scat_mod, "presort_reference"),
                          (scat_mod, "row_update_reference"),
                          (dense_mod, "dense_update_reference"),
                          (dense_mod, "grad_sumsq_reference"),
                          (topk_mod, "mips_topk_reference"),
                          (bag_mod, "embedding_bag_quant_reference"),
                          (inter_mod, "fused_interaction_quant_reference"),
                          (lstm_mod, "lstm_fwd_reference"),
                          (lstm_mod, "lstm_gates_reference"),
                          (lstm_mod, "lstm_bwd_reference"),
                          (qr_mod, "fake_quant_rows_reference"),
                          (qr_mod, "row_amax_reference")):
            real = getattr(mod, name)

            def counted(*a, _real=real, **kw):
                self.calls += 1
                return _real(*a, **kw)

            self._saved.append((mod, name, real))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self._saved:
            setattr(mod, name, real)


def serve_phase(mode):
    """Serve the full-width model of one graph; returns the kernels'
    launch counts over the run."""
    cfg = DLRMConfig.random_benchmark()
    fused = mode == "dot"
    if fused:
        cfg.arch_interaction_op = "dot"
        cfg.mlp_top = [D + (T + 1) * T // 2] + cfg.mlp_top[1:]
    model = FFModel(FFConfig(batch_size=256, seed=SEED, device="cuda"))
    build_dlrm(model, cfg, fuse_interaction=fused)
    model.compile()
    t0 = time.perf_counter()
    model.init_layers()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    rng = np.random.RandomState(SEED + 1)
    sizes = [int(s) for s in rng.randint(1, 65, size=48)]
    data, _ = synthetic_batch(cfg, sum(sizes), seed=SEED + 2)
    spans, off = [], 0
    for s in sizes:
        spans.append((off, off + s))
        off += s
    results = {}
    errors = []

    # the main path: every count at 0 just before, read just after
    zero_counts()
    with PlainCalls() as plain:
        engine = InferenceEngine(model, ServeConfig(max_batch=256))
        with engine:
            def client(k):
                try:
                    for i in range(k, len(spans), 4):
                        a, b = spans[i]
                        feats = {kk: v[a:b] for kk, v in data.items()}
                        results[i] = engine.predict(feats, timeout=120)
                except Exception as e:   # noqa: BLE001 — reported below
                    errors.append(repr(e))

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            wall = time.perf_counter() - t0
            stats = engine.stats()
    launches = read_counts()
    check(not errors and not any(t.is_alive() for t in threads),
          f"{mode}: requests failed: {errors[:3]}")
    check(len(results) == len(spans), f"{mode}: missing responses")
    kernel = "fused_interaction" if fused else "embedding_bag"
    check(launches[kernel] > 0,
          f"{mode}: the {kernel} kernel never launched on the serve path")
    check(plain.calls == 0,
          f"{mode}: a plain version ran {plain.calls} times on the card")

    # every response equals forward_batch of its rows (cuBLAS may reduce
    # in another order for another row count, hence the tolerance)
    worst = 0.0
    for i, (a, b) in enumerate(spans):
        feats = {k: v[a:b] for k, v in data.items()}
        want = model.forward_batch(feats).cpu().numpy()
        got = results[i].scores
        check(got.shape == (b - a, 1) and np.isfinite(got).all(),
              f"{mode}: bad scores for request {i}: {got.shape}")
        worst = max(worst, float(np.abs(got - want).max()))
        check(np.allclose(got, want, rtol=1e-5, atol=1e-6),
              f"{mode}: request {i} differs from forward_batch by "
              f"{np.abs(got - want).max()}")

    # where a full bucket's time goes: host wall clock per forward (to
    # the scores on the host) against the device time of its kernels
    full = {k: v[:256] for k, v in data.items()}
    model.forward_bucket(full, 256).cpu()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        model.forward_bucket(full, 256).cpu()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    traced = traced_device_us(
        lambda: model.forward_bucket(full, 256).cpu(), [()], reps)
    print(f"serve {mode}: forward_bucket(256 rows) wall {wall_ms:.3f} ms, "
          + device_share(traced, wall_ms, 4))

    # the same weights on the CPU (plain versions, MKL) on a small batch
    cpu = FFModel(FFConfig(batch_size=256, seed=SEED, device="cpu"))
    build_dlrm(cpu, cfg, fuse_interaction=fused)
    cpu.compile()
    cpu.swap_params({op: {n: v.cpu() for n, v in p.items()}
                     for op, p in model.params.items()})
    small = {k: v[:64] for k, v in data.items()}
    on_card = model.forward_batch(small).cpu().numpy()
    on_cpu = cpu.forward_batch(small).numpy()
    cpu_err = float(np.abs(on_card - on_cpu).max())
    check(np.allclose(on_card, on_cpu, rtol=1e-5, atol=1e-5),
          f"{mode}: card and CPU disagree by {cpu_err}")
    print(f"serve {mode}: {len(spans)} requests, {sum(sizes)} rows in "
          f"{wall:.3f} s ({len(spans) / wall:.1f} req/s, "
          f"{sum(sizes) / wall:.1f} rows/s), p50 {stats['p50_ms']:.3f} ms, "
          f"p99 {stats['p99_ms']:.3f} ms, {stats['batches']} batches, "
          f"fill {stats['batch_fill']:.3f}, warmup {stats['warmup_s']} s, "
          f"init {t_init:.2f} s; launches {launches}; max err vs "
          f"forward_batch {worst:.3g}, vs cpu {cpu_err:.3g}")
    del model, cpu, engine
    torch.cuda.empty_cache()
    return launches


def two_tower_config(dcfg):
    """The two-tower heads sized to the ranker's own inputs, as
    examples/native/serve_dlrm.py's ``_build_cascade`` sizes them."""
    return TwoTowerConfig(n_items=int(dcfg.embedding_size[0]), dim=TT_DIM,
                          user_dense_dim=int(dcfg.mlp_bot[0]),
                          user_embedding_size=list(dcfg.embedding_size),
                          user_sparse_dim=8,
                          user_bag_size=int(dcfg.embedding_bag_size))


def cascade_phase():
    """The retrieve -> rank cascade at full width, built as
    ``_build_cascade`` builds it around ``random_benchmark()``: the
    two-tower user head (batch 64) and item head (batch 8,192), the 1M
    items encoded on the card into a 1-shard int8 index, and the "cat"
    ranker behind ``InferenceEngine(ServeConfig(max_batch=256))``.
    Returns the kernels' launch counts over the main path."""
    dcfg = DLRMConfig.random_benchmark()
    cfg = FFConfig(batch_size=256, seed=SEED, device="cuda",
                   retrieve_deadline_ms=1000.0)
    tcfg = two_tower_config(dcfg)
    check(tcfg.n_items == N_ITEMS, f"index of {tcfg.n_items} items")
    t0 = time.perf_counter()
    ranker = FFModel(cfg)
    build_dlrm(ranker, dcfg)
    ranker.compile()
    ranker.init_layers()

    def head(name, batch):
        m = FFModel(FFConfig(batch_size=batch, seed=SEED, device="cuda"))
        build_two_tower(m, tcfg, head=name)
        m.compile()
        m.init_layers()
        return m

    user, item = head("user", FFConfig().batch_size), head("item", ITEM_BATCH)
    transfer_tower_params(user, item)
    torch.cuda.synchronize()
    t_models = time.perf_counter() - t0
    t0 = time.perf_counter()
    items = item_embeddings(item, tcfg)
    torch.cuda.synchronize()
    t_items = time.perf_counter() - t0
    check(items.shape == (N_ITEMS, TT_DIM)
          and bool(torch.isfinite(items).all()), "bad item embeddings")
    # the bag kernel at the towers' own shapes, on their own tables:
    # one 8,192-id chunk of the item head (d=32) and one request's ids of
    # the 8 user tables, padded to the user head's batch (d=8)
    one, _ = synthetic_batch(dcfg, 1, seed=SEED + 7)
    ub = user.config.batch_size
    user_ids = torch.zeros((ub, len(tcfg.user_embedding_size)),
                           dtype=torch.int64, device="cuda")
    user_ids[0] = torch.as_tensor(one["sparse"][0, :, 0])
    tower_bags = [(f"item head (d={tcfg.item_raw_dim}, {ITEM_BATCH} ids)",
                   item.params["item_emb"]["kernel"],
                   torch.arange(61 * ITEM_BATCH, 62 * ITEM_BATCH,
                                device="cuda")[:, None])]
    for t, rows in enumerate(tcfg.user_embedding_size):
        tower_bags.append((f"user table {t} (d={tcfg.user_sparse_dim}, "
                           f"{ub} ids)", user.params[f"user_emb_{t}"]["kernel"],
                           torch.remainder(user_ids[:, t:t + 1], rows)))
    for what, tab, ids in tower_bags:
        got = bag_mod.embedding_bag(tab, ids, "sum")
        want = bag_mod.embedding_bag_reference(tab, ids, "sum")
        # bag 1: both copy the one row
        check(torch.equal(got, want), f"embedding_bag kernel disagrees "
              f"with its plain version on the {what}")
    print(f"cascade: embedding_bag kernel bitwise equal to its plain "
          f"version on the item head's table (d={tcfg.item_raw_dim}, "
          f"{ITEM_BATCH} ids) and each of the {len(tower_bags) - 1} user "
          f"tables (d={tcfg.user_sparse_dim}, {ub} ids)")
    del item, tower_bags

    def encode(feats):
        """The user head over the request's users, in batches of its
        compiled batch, zero-padded: (n, dim) fp32 on the card."""
        dense = np.asarray(feats["dense"], np.float32)
        sparse = np.asarray(feats["sparse"], np.int64)
        n, ub = dense.shape[0], user.config.batch_size
        out = []
        for lo in range(0, n, ub):
            d, s = dense[lo:lo + ub], sparse[lo:lo + ub]
            pad = ub - d.shape[0]
            if pad:
                d = np.concatenate([d, np.zeros((pad,) + d.shape[1:],
                                                np.float32)])
                s = np.concatenate([s, np.zeros((pad,) + s.shape[1:],
                                                np.int64)])
            out.append(user.forward_batch({"user_dense": d,
                                           "user_sparse": s})[:ub - pad])
        return torch.cat(out)

    sset = ShardedMIPSIndex.standalone_set(max(1, cfg.retrieve_shards))
    t0 = time.perf_counter()
    index = ShardedMIPSIndex.build(sset, items)
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    check(index.table.q.is_cuda and all(
        r.shard._blocks[index.op_name].q.is_cuda for r in sset.shards),
        "the index does not lie on the card")
    expand = dlrm_candidate_features(T, list(dcfg.embedding_size))
    data, _ = synthetic_batch(dcfg, CASCADE_REQUESTS + 8, seed=SEED + 6)
    users = [{k: v[i:i + 1] for k, v in data.items()}
             for i in range(CASCADE_REQUESTS + 8)]
    warm, reqs = users[CASCADE_REQUESTS:], users[:CASCADE_REQUESTS]
    results, errors = {}, []
    engine = InferenceEngine(ranker, ServeConfig(max_batch=256))
    with engine:
        cascade = CascadeEngine(index, encode, engine, expand,
                                CascadeConfig.from_config(cfg))
        # warmup, one request at a time: the last six give a request's
        # latency alone, with no other request in flight
        alone = [cascade.predict(feats) for feats in warm][2:]
        lookups0 = sum(r.shard.lookups for r in sset.shards)
        # the main path: every count at 0 just before, read just after
        zero_counts()
        with PlainCalls() as plain:
            def client(c):
                try:
                    for i in range(c, len(reqs), 4):
                        results[i] = cascade.predict(reqs[i])
                except Exception as e:   # noqa: BLE001 — reported below
                    errors.append(repr(e))

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            wall = time.perf_counter() - t0
        launches = read_counts()
        shard_calls = sum(r.shard.lookups for r in sset.shards) - lookups0
        check(not errors and not any(t.is_alive() for t in threads),
              f"cascade: requests failed: {errors[:3]}")
        check(len(results) == len(reqs), "cascade: missing answers")
        check(cascade.deadline_misses == 0
              and not any(p.degraded for p in results.values()),
              f"cascade: {cascade.deadline_misses} deadline misses, "
              f"{sum(p.degraded for p in results.values())} degraded")
        check(launches["mips_topk"] == shard_calls == len(reqs)
              == launches["mips_topk:select"]
              + launches["mips_topk:overflow"],
              f"cascade: {launches['mips_topk']} top-k launches for "
              f"{shard_calls} shard top-k calls and {len(reqs)} requests")
        check(launches["embedding_bag"] > 0,
              "cascade: the user tower's bag kernel never launched")
        check(plain.calls == 0,
              f"cascade: a plain version ran {plain.calls} times")
        # the same requests again from one thread, timed the same way (all
        # requests over the window's wall time), beside the 4 threads' rate
        t0 = time.perf_counter()
        serial = [cascade.predict(feats) for feats in reqs]
        wall1 = time.perf_counter() - t0
        check(cascade.deadline_misses == 0
              and not any(p.degraded for p in serial),
              "cascade: a one-thread request degraded or missed its "
              "deadline")

        # a sample: retrieval bitwise equal to the exact scan, ranker
        # scores equal to forward_batch of the expanded rows
        worst = 0.0
        for i in range(0, len(reqs), 8):
            p, feats = results[i], reqs[i]
            check(p.ids.shape == (1, K) and np.isfinite(p.scores).all()
                  and bool(np.all(np.diff(p.scores[0]) <= 0)),
                  f"cascade: bad answer for request {i}")
            want_s, want_i = index.exact_scan(encode(feats), K)
            o = np.lexsort((p.ids[0], -p.retrieve_scores[0]))
            check(np.array_equal(p.ids[0][o], want_i[0])
                  and np.array_equal(
                      p.retrieve_scores[0][o].view(np.uint32),
                      want_s[0].view(np.uint32)),
                  f"cascade: request {i}'s retrieval differs from "
                  f"exact_scan")
            want = ranker.forward_batch(expand(feats, p.ids)).cpu().numpy()
            worst = max(worst, float(np.abs(p.scores[0] - want[:, 0]).max()))
            check(np.allclose(p.scores[0], want[:, 0], rtol=1e-5, atol=1e-6),
                  f"cascade: request {i}'s ranker scores differ from "
                  f"forward_batch by {worst}")

        # the same codes over 4 shards on the card: the same answers
        sset4 = ShardedMIPSIndex.standalone_set(4)
        index4 = ShardedMIPSIndex.build(sset4, index.table)
        with sset4:
            before = topk_mod.mips_topk.launches
            for i in range(0, len(reqs), 4):
                u = encode(reqs[i])
                r1 = index.topk(u, K, deadline_s=1.0)
                r4 = index4.topk(u, K, deadline_s=1.0)
                check(not r4.degraded and np.array_equal(r4.ids, r1.ids)
                      and np.array_equal(r4.scores.view(np.uint32),
                                         r1.scores.view(np.uint32)),
                      f"cascade: the 4-shard index differs from the "
                      f"1-shard one for request {i}")
            n4 = len(range(0, len(reqs), 4))
            check(topk_mod.mips_topk.launches - before == 5 * n4,
                  "cascade: the 4-shard index did not launch the top-k "
                  "kernel once per shard")

        # device time of one request, the top-k kernel's share of it
        reps = 8
        traced = traced_device_us(cascade.predict,
                                  [(f,) for f in reqs[:reps]], reps)
        if traced is None:
            device = "device not measured (no device time traced)"
        else:
            dev_ms = sum(traced.values()) / 1e3
            topk_ms = sum(us for k, us in traced.items() if any(
                n in k for _, names in TOPK_PHASES for n in names)) / 1e3
            device = (f"device per request {dev_ms:.3f} ms, of it the "
                      f"top-k kernels {topk_ms:.4f} ms "
                      f"({topk_split(traced)})")
        # where a request's host time goes (tracing inflates it)
        with profile(activities=[ProfilerActivity.CPU]) as hprof:
            for feats in reqs[:reps]:
                cascade.predict(feats)
        host = sorted(((e.self_cpu_time_total / reps, e.key)
                       for e in hprof.key_averages()), reverse=True)
        print("cascade: host per request, traced: " + ", ".join(
            f"{k[:32]} {us:.0f} us" for us, k in host[:8]))
        stats = engine.stats()
    sset.close()
    lat = sorted(p.latency_ms for p in results.values())
    ret = float(np.median([p.stage_ms["retrieve"] for p in results.values()]))
    rank = float(np.median([p.stage_ms["rank"] for p in results.values()]))
    a_lat = float(np.median([p.latency_ms for p in alone]))
    a_ret = float(np.median([p.stage_ms["retrieve"] for p in alone]))
    a_rank = float(np.median([p.stage_ms["rank"] for p in alone]))
    print(f"cascade: {len(reqs)} users (k={K}) from 4 threads in "
          f"{wall:.3f} s ({len(reqs) / wall:.1f} req/s), from one thread "
          f"in {wall1:.3f} s ({len(reqs) / wall1:.1f} req/s); 4 threads: "
          f"predict p50 "
          f"{percentile(lat, 50):.3f} ms, p99 {percentile(lat, 99):.3f} ms; "
          f"median stage retrieve {ret:.3f} ms, rank {rank:.3f} ms; one "
          f"request alone {a_lat:.3f} ms median (retrieve {a_ret:.3f} ms, "
          f"rank {a_rank:.3f} ms); {device}; ranker batches "
          f"{stats['batches']}, fill "
          f"{stats['batch_fill']:.3f}; build: models {t_models:.2f} s, "
          f"item embeddings {t_items:.2f} s, index {t_index:.2f} s; "
          f"launches {launches}; worst ranker error vs forward_batch "
          f"{worst:.3g}; retrieval bitwise to exact_scan, 4 shards "
          f"bitwise to 1")
    del ranker, user, items, index, index4, cascade, engine
    torch.cuda.empty_cache()
    return launches


class SimulatedCrash(Exception):
    """Raised inside a fit to stop it as a killed process would stop."""


def launch_runs(work):
    """The launcher as users run it (``python -m
    dlrm_flexflow_tpu_torch.examples.native.dlrm``), at full width from a
    .ffbin of LAUNCH_STEPS batches written by the port's ``write_ffbin``,
    with prefetch and without (LAUNCH_RUNS). Each run: every count at 0
    just before ``main`` and read just after (its warm-up step included):
    one bag, one pre-pass, one write-only scatter and one dense update a
    step, no plain version; then ten steps of its model queued behind a
    spin give the device's time for a step and its idle share of the
    launcher's step. Returns the launch counts."""
    from dlrm_flexflow_tpu_torch.data.dataloader import write_ffbin
    from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
    cfg = DLRMConfig.random_benchmark()
    x, y = synthetic_batch(cfg, LAUNCH_STEPS * TRAIN_B, seed=SEED + 5)
    path = work / "train.ffbin"
    write_ffbin(str(path), x["dense"], x["sparse"], y)
    batch = {k: v[:TRAIN_B] for k, v in x.items()}
    batch["label"] = y[:TRAIN_B]
    total = {}
    for label, flags in LAUNCH_RUNS:
        zero_counts()
        with PlainCalls() as plain:
            out = launcher.main(LAUNCH_ARGS + ["--data-path", str(path)]
                                + flags)
        launches = read_counts()
        model = out["model"]
        steps = out["steps"] + 1          # the warm-up step is counted
        check(out["steps"] == LAUNCH_STEPS,
              f"launch ({label}): {out['steps']} steps")
        check(all(launches[k] == steps for k in (
                  "embedding_bag", "scatter_presort", "scatter_write_rows",
                  "dense_update"))
              and launches["scatter_write_rows:block"] == steps
              and all(launches[k] == 0 for k in SCATTERS
                      if k != "scatter_write_rows"),
              f"launch ({label}): not one bag, pre-pass, write-only "
              f"scatter and dense update a step: {launches}")
        check(plain.calls == 0,
              f"launch ({label}): a plain version ran {plain.calls} times")
        check(np.isfinite(model.perf.report()["mse"]),
              f"launch ({label}): mse {model.perf.report()}")
        step_ms = out["elapsed"] * 1e3 / out["steps"]
        db = model._device_batch(batch)
        reps = 10
        queued, why_not = queued_ms(model.train_batch_device, [(db,)],
                                    reps, reps * step_ms)
        idle = (f"device {queued:.3f} ms/step queued, idle "
                f"{100 * (1 - queued / step_ms):.1f}% of the launcher's "
                f"step" if why_not is None
                else f"device not measured queued ({why_not})")
        per_step = {k: v / steps for k, v in launches.items() if v}
        print(f"launch ({label}): {out['steps']} steps of {TRAIN_B} from "
              f"{path.name}, {out['throughput']:.1f} samples/s, "
              f"{step_ms:.3f} ms/step; {idle}; launches per step "
              f"{per_step}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del out, model, db
        torch.cuda.empty_cache()
    return total


def _leaves(tree):
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _model_bytes(model):
    return sum(v.numel() * v.element_size()
               for v in _leaves(model.params)
               + _leaves(model.opt_state or {}))


def fit_restart(work):
    """``fit`` survives a restart, bitwise: full-width "cat" under SGD
    with momentum 0.9 and weight decay 1e-4, FIT_STEPS steps of batch
    256 in one epoch. One model fits them uninterrupted, the dataset
    staged on the card (every count at 0 just before, read just after);
    a second fits through the prefetch ring (``stage_dataset="never"``,
    depth 2) with a snapshot every FIT_STEPS // 2 steps (keep_last 1) and
    is stopped by an exception as the step after the snapshot begins; a
    third model, from other weights, resumes from the directory to the
    end through a ring rebuilt at the restored (epoch, batch). Its
    parameters and momentum must equal the first's bitwise. Then one
    snapshot of it is saved and restored into a fourth model, timed:
    bytes, the copy to the host and the write apart, the restore, GB/s.
    Free disk space is checked first. Returns the uninterrupted run's
    launch counts."""
    from dlrm_flexflow_tpu_torch.utils.checkpoint import CheckpointManager
    half = FIT_STEPS // 2
    cfg = train_config("cat")
    x, y = synthetic_batch(cfg, FIT_STEPS * TRAIN_B, seed=SEED + 6)
    kw = dict(epochs=1, batch_size=TRAIN_B, verbose=False)

    def model(seed, stage="auto"):
        m, _ = train_model("cat", "cuda", opt="momentum")
        m.config.stage_dataset = stage
        m.init_layers(seed=seed)
        return m

    whole = model(SEED)
    whole.opt_state = whole.optimizer.init_state(whole.params)
    nbytes = _model_bytes(whole)
    free = shutil.disk_usage(work).free
    check(free >= 3 * nbytes,
          f"fit restart: {free / 1e9:.1f} GB free under {work}, the check "
          f"needs {3 * nbytes / 1e9:.1f} GB (three snapshots' worth)")
    zero_counts()
    with PlainCalls() as plain:
        whole.fit(x, y, **kw)
    launches = read_counts()
    check(all(launches[k] == FIT_STEPS for k in (
              "embedding_bag", "stateful_update_rows", "dense_update"))
          and launches["stateful_update_rows:fused"] == FIT_STEPS
          and plain.calls == 0,
          f"fit restart: not one bag, stateful update and dense update a "
          f"step, or a plain version ran: {launches}, {plain.calls}")

    ckdir = work / "ckpt"
    broken = model(SEED, "never")
    real, calls = broken.train_batch_staged, []

    def crashing(staged, **kw):
        calls.append(1)
        if len(calls) == half + 1:
            raise SimulatedCrash()
        return real(staged, **kw)

    broken.train_batch_staged = crashing
    try:
        broken.fit(x, y, checkpoint_dir=str(ckdir), save_every=half,
                   keep_last=1, **kw)
        check(False, "fit restart: the interrupted fit did not stop")
    except SimulatedCrash:
        pass
    del broken
    torch.cuda.empty_cache()
    entries = json.loads((ckdir / "manifest.json").read_text())["entries"]
    check([e["step"] for e in entries] == [half]
          and entries[0]["loader_state"] == {"epoch": 0, "batch": half},
          f"fit restart: the interrupted run left {entries}")

    resumed = model(SEED + 1, "never")
    t0 = time.perf_counter()
    out = resumed.fit(x, y, checkpoint_dir=str(ckdir), keep_last=1, **kw)
    resume_s = time.perf_counter() - t0
    check(out["num_samples"] == half * TRAIN_B
          and resumed._step == whole._step == FIT_STEPS,
          f"fit restart: resumed {out['num_samples']} samples to step "
          f"{resumed._step}")

    def same(a, b):
        """Parameters and momentum, bitwise, on the card."""
        pairs = [(a.params, b.params), (a.opt_state["v"], b.opt_state["v"])]
        return all(set(ta) == set(tb) and all(
            torch.equal(v, tb[op][pn]) for op, p in ta.items()
            for pn, v in p.items()) for ta, tb in pairs)

    check(same(resumed, whole),
          "fit restart: the ring-resumed fit's parameters or momentum "
          "differ from the uninterrupted staged fit's")
    entries = json.loads((ckdir / "manifest.json").read_text())["entries"]
    check([e["step"] for e in entries] == [FIT_STEPS]
          and len(list(ckdir.glob("ckpt-*.npz"))) == 1,
          f"fit restart: keep_last 1 left {entries}")
    del whole
    torch.cuda.empty_cache()

    mgr = CheckpointManager(str(ckdir), keep_last=1)
    mgr.save(resumed, {"epoch": 1, "batch": 0})
    st = mgr.last_save
    fresh = model(SEED + 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    entry = mgr.restore_latest(fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(entry is not None and entry["step"] == FIT_STEPS
          and same(fresh, resumed),
          "fit restart: the timed snapshot did not restore bitwise")
    gb = st["bytes"] / 1e9
    print(f"fit restart: {FIT_STEPS} steps, stopped after the snapshot at "
          f"step {half} (through the ring), resumed by a fresh model "
          f"through a rebuilt ring in {resume_s:.2f} s (restore and {half} "
          f"steps and the final snapshot): parameters and momentum bitwise "
          f"equal to the uninterrupted staged fit; snapshot "
          f"{st['bytes']:,} bytes: copy to the host {st['gather_s']:.2f} s "
          f"({gb / st['gather_s']:.2f} GB/s), write {st['write_s']:.2f} s "
          f"({gb / st['write_s']:.2f} GB/s, checksum and fsync included), "
          f"restore {restore_s:.2f} s ({gb / restore_s:.2f} GB/s, checksum "
          f"included)")
    del resumed, fresh
    torch.cuda.empty_cache()
    return launches


def launch_phase():
    """The training runtime as users launch it: ``launch_runs``, then
    ``fit_restart``, in WORK_DIR, which is removed at the end whatever
    happens. Returns the launch counts of both main paths."""
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    WORK_DIR.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        counts = launch_runs(WORK_DIR)
        for k, v in fit_restart(WORK_DIR).items():
            counts[k] = counts.get(k, 0) + v
        print(f"launch phase: {time.perf_counter() - t0:.1f} s")
        return counts
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)


def _state_tensors(model):
    """Every parameter and optimizer-state tensor of a model (Adam's step
    included), in the order of their sorted names (a restore may rebuild
    the dicts in another order)."""
    def flat(tree):
        return [x for k in sorted(tree) for x in (
            flat(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]
    return flat(model.params) + flat(model.opt_state or {})


def _same_state(a, b):
    """Parameters and optimizer state, bitwise, on the card."""
    ta, tb = _state_tensors(a), _state_tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def sumsq_lists(dev, gen):
    """The gradient lists of the sentinel's norm at its paths' shapes:
    "cat" (its 14 dense MLP gradients and the lookups' 256 x 8 x 64
    cotangent) and "dot" (every parameter's gradient, the 8M x 64 table
    included), random normal."""
    out = {}
    for mode in ("cat", "dot"):
        model, _ = train_model(mode, "cuda")
        sparse = {op.name for op in model._select_sparse_update_ops()}
        shapes = [tuple(d.shape) for op in model.ops
                  if op.name not in sparse
                  for d in op.param_defs().values()]
        if mode == "cat":
            shapes.append((TRAIN_B, T, D))
        out[mode] = [torch.randn(s, device=dev, generator=gen)
                     for s in shapes]
        del model
    return out


def sumsq_kernel(dev):
    """The sentinel's norm (``grad_sumsq``, one launch over every
    gradient) on the "cat" and "dot" lists against its plain version on
    the card (rtol 1e-5, the fp32 sum of squares in another order): a
    rerun bitwise, the flag exactly for a NaN, +Inf or -Inf gradient and
    a NaN loss; then timed beside its bound (each gradient read once,
    two operations an element), the plain version and
    ``torch._foreach_norm`` (one call, per-tensor norms only), the
    "dot" list in the row."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    lists = sumsq_lists(dev, gen)
    loss = torch.tensor(0.5, device=dev)
    row = None
    for mode in ("cat", "dot"):
        gs = lists.pop(mode)
        nel = sum(g.numel() for g in gs)
        before = dense_mod.grad_sumsq.launches
        gsq, norm, ok = dense_mod.grad_sumsq(gs, loss)
        check(dense_mod.grad_sumsq.launches - before == 1,
              f"grad_sumsq ({mode}): not one launch")
        pgsq, pnorm, pok = dense_mod.grad_sumsq_reference(gs, loss)
        err = abs(float(norm) - float(pnorm))
        check(abs(float(gsq) - float(pgsq)) <= 1e-5 * abs(float(pgsq))
              and err <= 1e-5 * abs(float(pnorm)) and int(ok) == 1
              and int(pok) == 1,
              f"grad_sumsq ({mode}): {float(gsq)}, {float(norm)}, "
              f"{int(ok)} against the plain {float(pgsq)}, "
              f"{float(pnorm)}, {int(pok)}")
        again = dense_mod.grad_sumsq(gs, loss)
        check(float(again[0]) == float(gsq) and float(again[1])
              == float(norm), f"grad_sumsq ({mode}): a rerun differs")
        last = gs[-1].view(-1)
        keep = last[last.numel() // 3].clone()
        for bad in (float("nan"), float("inf"), -float("inf")):
            last[last.numel() // 3] = bad
            flags = (int(dense_mod.grad_sumsq(gs, loss)[2]),
                     int(dense_mod.grad_sumsq_reference(gs, loss)[2]))
            check(flags == (0, 0), f"grad_sumsq ({mode}): a {bad} "
                  f"gradient gives the flags {flags}")
        last[last.numel() // 3] = keep
        nan = torch.tensor(float("nan"), device=dev)
        check(int(dense_mod.grad_sumsq(gs, nan)[2]) == 0,
              f"grad_sumsq ({mode}): a NaN loss passes")
        b_ms, b_by = bound(nel * 4, 2 * nel)
        r = {"name": "grad_sumsq", "route": "cuda",
             "source": "dlrm_flexflow_tpu_torch/csrc/dense_update.cu",
             "replaces": "dlrm_flexflow_tpu/core/model.py:1120",
             "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
             **timed("", lambda: dense_mod.grad_sumsq(gs, loss), [()]),
             **timed("plain_", lambda: dense_mod.grad_sumsq_reference(
                 gs, loss), [()]),
             **timed("library_", lambda: torch._foreach_norm(gs), [()])}
        print_row(r, f" (\"{mode}\" list: {len(gs)} tensors, {nel} "
                  f"elements, {4 * nel / 1e6:.1f} MB; norm "
                  f"{float(norm):.6g}; library: torch._foreach_norm)")
        if mode == "dot":
            row = r
        del gs
        torch.cuda.empty_cache()
    return {row["name"]: row}


def guarded_entries(dev):
    """Each entry that writes a parameter or optimizer state, at its
    path's shape: with the flag at 0 every output byte stays, with 1 the
    result is bitwise the unguarded call's. The dense update over the
    "cat" set under Adam and momentum; the add and write scatters and
    the stateful update on both its routes over the 8M x 64 table at the
    step's 2,048 lookups."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    rows, n = T * ROWS, TRAIN_B * T
    table = 0.5 * torch.randn(rows, D, device=dev, generator=gen)
    slabs = {k: 1e-3 * torch.rand(rows, D, device=dev, generator=gen)
             for k in ("m", "v")}
    ids = torch.randint(0, rows, (n,), device=dev, generator=gen)
    ids[:8] = ids[0]
    upd = torch.randn(n, D, device=dev, generator=gen)
    fwd = table[ids]
    adam = AdamOptimizer(alpha=0.001)
    at = adam.alpha_t(torch.tensor(4, dtype=torch.int32, device=dev))
    mom = TRAIN_OPTS["momentum"]()
    ws = dense_params("cat")
    gs = [torch.randn(w.shape, device=dev, generator=gen) for w in ws]
    wst = dense_state(gen, ws, ("m", "v"))

    def dense(opt, alpha_t, names):
        def call(ok):
            w = [x.clone() for x in ws]
            s = [{k: st[k].clone() for k in names} for st in wst]
            dense_mod.dense_update(w, gs, s, opt.row_params(), alpha_t, ok)
            return w + [t for st in s for t in st.values()]
        return call, ws + [st[k] for st in wst for k in names]

    def scatter(fn):
        def call(ok):
            t = table.clone()
            s = {k: v.clone() for k, v in slabs.items()}
            fn(t, s, ok)
            return [t, *s.values()]
        return call, [table, *slabs.values()]

    entries = {
        "dense_update (Adam)": dense(adam, at, ("m", "v")),
        "dense_update (momentum)": dense(mom, None, ("v",)),
        "scatter_add_rows": scatter(lambda t, s, ok: scat_mod.scatter_add_rows(
            t, ids, upd, -LR, ids_in_range=True, ok=ok)),
        "scatter_write_rows": scatter(
            lambda t, s, ok: scat_mod.scatter_write_rows(
                t, ids, upd, fwd, -LR, ids_in_range=True, ok=ok)),
        "stateful_update_rows (fused)": scatter(
            lambda t, s, ok: scat_mod._stateful_kernels(
                t, ids, upd, None, s, adam.row_params(), at, 1, True, ok)),
        "stateful_update_rows (pre-pass)": scatter(
            lambda t, s, ok: scat_mod._stateful_kernels(
                t, ids, upd, None, s, adam.row_params(), at, 1, False, ok)),
    }
    flags = {v: torch.tensor(v, dtype=torch.int32, device=dev)
             for v in (0, 1)}
    for name, (call, before) in entries.items():
        skipped = call(flags[0])
        check(all(torch.equal(a, b) for a, b in zip(skipped, before)),
              f"{name}: the flag 0 did not leave every output as it was")
        del skipped
        plain, guarded = call(None), call(flags[1])
        check(all(torch.equal(a, b) for a, b in zip(plain, guarded))
              and not torch.equal(plain[0], before[0]),
              f"{name}: the flag 1 differs from the unguarded call")
        del plain, guarded
    print(f"sentinel guard: {', '.join(entries)}: the flag 0 leaves every "
          f"output bitwise, 1 equals the unguarded call bitwise")
    del table, slabs, ws, gs, wst, fwd
    torch.cuda.empty_cache()


def policy_windows(model, db):
    """The step time under the anomaly policies "none", "skip_step" and
    "raise" on one staged batch, each as two windows of TRAIN_STEPS
    steps back to back, in turn: {policy: [ms, ms]}."""
    out = {p: [] for p in SENTINEL_POLICIES}
    for _ in range(2):
        for p in SENTINEL_POLICIES:
            model.config.anomaly_policy = p
            model.train_batch_device(db)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                mets = model.train_batch_device(db)
            float(mets["loss"])
            out[p].append((time.perf_counter() - t0) * 1e3 / TRAIN_STEPS)
    model.config.anomaly_policy = "skip_step"
    return out


def sentinel_runs():
    """(a) The sentinel at full width under Adam, "cat" and "dot": a
    skip_step run over SENTINEL_STEPS batches whose batch POISON_AT is
    poisoned to NaN by the fault hook (every count at 0 just before and
    read just after: one norm launch and one dense update a step, the
    graph's scatter, no plain version) against a clean run over the same
    batches without batch POISON_AT, parameters and optimizer state
    (Adam's m, v and step) bitwise; then "raise": a poisoned step raises
    AnomalyError and leaves parameters and state bitwise; then the step
    time under "none", "skip_step" and "raise", two windows each.
    Returns the launch counts."""
    from dlrm_flexflow_tpu_torch.core.model import AnomalyError
    from dlrm_flexflow_tpu_torch.utils import faults
    total = {}
    for mode in ("cat", "dot"):
        cfg = train_config(mode)
        x, y = synthetic_batch(cfg, SENTINEL_STEPS * TRAIN_B,
                               seed=SEED + 7)

        def batch(i, x=x, y=y):
            b = {k: v[i * TRAIN_B:(i + 1) * TRAIN_B] for k, v in x.items()}
            b["label"] = y[i * TRAIN_B:(i + 1) * TRAIN_B]
            return b

        def model(policy):
            m, _ = train_model(mode, "cuda", opt="adam")
            m.config.anomaly_policy = policy
            m.init_layers()
            return m

        dbs = None
        skip = model("skip_step")
        dbs = [skip._device_batch(batch(i)) for i in range(SENTINEL_STEPS)]
        torch.cuda.synchronize()
        zero_counts()
        with PlainCalls() as plain, faults.active_plan(
                faults.FaultPlan(nan_grad_steps={POISON_AT})) as fplan:
            flags = [skip.train_batch_device(db)["anomaly"] for db in dbs]
        launches = read_counts()
        flags = [bool(f) for f in flags]
        check(fplan.fired == [("nan_grad", POISON_AT)]
              and flags == [i == POISON_AT for i in range(SENTINEL_STEPS)],
              f"sentinel {mode}: the anomalies {flags}")
        scatter = ("stateful_update_rows" if mode == "cat"
                   else "scatter_add_rows")
        check(all(launches[k] == SENTINEL_STEPS for k in (
                  "grad_sumsq", "dense_update", scatter))
              and plain.calls == 0,
              f"sentinel {mode}: not one norm, dense update and {scatter} "
              f"a step, or a plain version ran: {launches}, {plain.calls}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        clean = model("none")
        for i, db in enumerate(dbs):
            if i != POISON_AT:
                clean.train_batch_device(db)
        check(int(skip.opt_state["step"]) == SENTINEL_STEPS - 1
              and _same_state(skip, clean),
              f"sentinel {mode}: the skip_step run's parameters or state "
              f"differ from the clean run without batch {POISON_AT}")
        del clean
        torch.cuda.empty_cache()

        skip.config.anomaly_policy = "raise"
        before = [t.clone() for t in _state_tensors(skip)]
        raised = None
        with faults.active_plan(
                faults.FaultPlan(nan_grad_steps={skip._step})):
            try:
                skip.train_batch_device(dbs[0])
            except AnomalyError as e:
                raised = e
        check(raised is not None and raised.step == SENTINEL_STEPS
              and all(torch.equal(a, b) for a, b in zip(
                  before, _state_tensors(skip))),
              f"sentinel {mode}: raise did not raise ({raised}) or the "
              f"state moved")
        del before
        torch.cuda.empty_cache()
        win = policy_windows(skip, dbs[1])
        base = float(np.mean(win["none"]))
        print(f"sentinel {mode} (adam): {SENTINEL_STEPS} skip_step steps, "
              f"batch {POISON_AT} poisoned: parameters and m, v, step "
              f"bitwise the clean run without it; raise leaves them "
              f"bitwise; ms/step (two windows of {TRAIN_STEPS}): "
              + ", ".join(f"{p} {w[0]:.3f} / {w[1]:.3f}"
                          for p, w in win.items())
              + "; overhead " + ", ".join(
                  f"{p} {np.mean(win[p]) / base:.3f}"
                  for p in SENTINEL_POLICIES[1:])
              + f"; launches per step "
              f"{ {k: v / SENTINEL_STEPS for k, v in launches.items() if v} }")
        del skip, dbs
        torch.cuda.empty_cache()
    return total


def rollback_run(work):
    """(b) ``fit`` under "rollback", full-width "cat", plain SGD, ROLLBACK_
    STEPS steps in one epoch, save_every 0 (the snapshots: the seed of
    the initial state and the final one, 2.06 GB each), step POISON_AT
    poisoned: one rollback, to the seed, and the parameters bitwise a
    clean fit's. The recovery (the wait for the manager, the restore and
    the rewind) is timed from the failing step's end to the next step's
    start. Free disk space is checked first."""
    from dlrm_flexflow_tpu_torch.utils import faults
    cfg = train_config("cat")
    x, y = synthetic_batch(cfg, ROLLBACK_STEPS * TRAIN_B, seed=SEED + 8)
    kw = dict(epochs=1, batch_size=TRAIN_B, verbose=False)
    rb, _ = train_model("cat", "cuda")
    rb.config.anomaly_policy = "rollback"
    rb.init_layers()
    nbytes = _model_bytes(rb)
    free = shutil.disk_usage(work).free
    check(free >= 3 * nbytes,
          f"rollback: {free / 1e9:.1f} GB free under {work}, the check "
          f"needs {3 * nbytes / 1e9:.1f} GB")
    real, marks = rb.train_batch_device, []

    def marked(db, **kw):
        marks.append(("start", time.perf_counter()))
        try:
            return real(db, **kw)
        finally:
            marks.append(("end", time.perf_counter()))

    rb.train_batch_device = marked
    t0 = time.perf_counter()
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={POISON_AT})):
        out = rb.fit(x, y, checkpoint_dir=str(work / "rollback"), **kw)
    fit_s = time.perf_counter() - t0
    # the failing step is the (POISON_AT + 1)-th; its end, then the
    # restored run's first start
    k = 2 * POISON_AT + 1
    recovery_s = marks[k + 1][1] - marks[k][1]
    check(out["rollbacks"] == 1 and rb._step == ROLLBACK_STEPS
          and out["num_samples"] == (POISON_AT + ROLLBACK_STEPS) * TRAIN_B,
          f"rollback: {out['rollbacks']} rollbacks, step {rb._step}, "
          f"{out['num_samples']} samples")
    clean, _ = train_model("cat", "cuda")
    clean.init_layers()
    clean.fit(x, y, **kw)
    check(_same_state(rb, clean),
          "rollback: the parameters differ from a clean fit's")
    entries = json.loads((work / "rollback" / "manifest.json").read_text())
    steps = [e["step"] for e in entries["entries"]]
    check(steps == [0, ROLLBACK_STEPS], f"rollback: snapshots {steps}")
    print(f"rollback: fit of {ROLLBACK_STEPS} steps, step {POISON_AT} "
          f"poisoned: 1 rollback to the seed snapshot (step 0, "
          f"{nbytes:,} bytes), parameters bitwise a clean fit's; recovery "
          f"(restore and rewind) {recovery_s:.2f} s; the whole fit "
          f"{fit_s:.2f} s (seed and final snapshots included)")
    del rb, clean
    torch.cuda.empty_cache()


def staging_runs():
    """(c) ``fit`` on full-width "cat" under plain SGD over STAGE_SAMPLES
    samples in one epoch: the dataset staged on the card
    (``stage_dataset="auto"``) and through the prefetch ring ("never",
    depth 2), in turn, twice each, from the same weights: the fits'
    parameters bitwise alike; samples/s of each, in fit's own window
    (which, as the JAX fit's, starts after the one-off staging) and over
    the whole call (the staging included, timed apart). The first staged
    fit and the first ring fit are main paths (counts at 0 just before,
    read just after, each: one bag, one pre-pass, one write-only scatter
    and one dense update a step). Returns their launch counts, summed."""
    cfg = train_config("cat")
    x, y = synthetic_batch(cfg, STAGE_SAMPLES, seed=SEED + 9)
    steps = STAGE_SAMPLES // TRAIN_B
    model, _ = train_model("cat", "cuda")
    rates = {"auto": [], "never": []}
    walls = {"auto": [], "never": []}
    first, launches = None, {}
    for rep in range(2):
        for mode in ("auto", "never"):
            model.config.stage_dataset = mode
            model.init_layers(SEED)
            counted = rep == 0
            if counted:
                zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with PlainCalls() as plain:
                out = model.fit(x, y, epochs=1, batch_size=TRAIN_B,
                                verbose=False)
            wall_s = time.perf_counter() - t0   # fit ends on a readback
            if counted:
                got = read_counts()
                check(all(got[k] == steps for k in (
                          "embedding_bag", "scatter_presort",
                          "scatter_write_rows", "dense_update"))
                      and plain.calls == 0,
                      f"staging ({mode}): not one bag, pre-pass, write-only "
                      f"scatter and dense update a step: {got}, "
                      f"{plain.calls}")
                for k, v in got.items():
                    launches[k] = launches.get(k, 0) + v
            if first is None:
                first = [v.clone() for v in _leaves(model.params)]
            else:
                check(all(torch.equal(a, b) for a, b in zip(
                          first, _leaves(model.params))),
                      f"staging: the {mode} fit differs from the staged one")
            check(out["num_samples"] == STAGE_SAMPLES,
                  f"staging: {out['num_samples']} samples")
            rates[mode].append(out["throughput"])
            walls[mode].append((wall_s, wall_s - out["elapsed"]))
    (wa, sa), (wb, sb) = walls["auto"]
    (wr, _), (wq, _) = walls["never"]
    print(f"staging: fit of {STAGE_SAMPLES} samples ({steps} steps of "
          f"{TRAIN_B}), parameters bitwise alike; staged on the card "
          f"{rates['auto'][0]:.1f} / {rates['auto'][1]:.1f} samples/s in "
          f"fit's window (the staging excluded, as the JAX fit's clock), "
          f"{STAGE_SAMPLES / wa:.1f} / {STAGE_SAMPLES / wb:.1f} samples/s "
          f"over the whole call (the staging of {steps} batches, "
          f"{sa:.3f} / {sb:.3f} s, included); through the ring (depth 2) "
          f"{rates['never'][0]:.1f} / {rates['never'][1]:.1f} samples/s "
          f"in fit's window, {STAGE_SAMPLES / wr:.1f} / "
          f"{STAGE_SAMPLES / wq:.1f} over the whole call")
    del model, first
    torch.cuda.empty_cache()
    return launches


def stream_runs():
    """(d) The serve -> train loop at full width: ``TraceReplay`` of
    "drifting_zipf" at the model's shapes (8 tables of 1M rows, bag 1,
    dense 64, batch 256, STREAM_STEPS steps); each request served by a
    "cat" ranker behind ``InferenceEngine`` and offered with its labels
    and scores to a ``FeedbackSpool``, while a second "cat" model (plain
    SGD) trains on ``spool.source`` with ``fit_stream`` on a thread, as
    the JAX scenario runner drives it (every count at 0 just before, read
    just after): every step trained, nothing dropped. Then
    ``fit_stream`` over an ``ArrayStream`` against a ``train_batch``
    loop over the same batches, bitwise. Returns the launch counts."""
    from dlrm_flexflow_tpu_torch.data.replay import (FeedbackSpool,
                                                     TraceReplay,
                                                     scenario_spec)
    from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
    cfg = train_config("cat")
    spec = scenario_spec("drifting_zipf", steps=STREAM_STEPS, batch=TRAIN_B,
                         seed=SEED, rows=ROWS)
    rp = TraceReplay(T, ROWS, BAG, cfg.mlp_bot[0], spec)
    t0 = time.perf_counter()
    trace = [rp.request(i) for i in range(STREAM_STEPS)]
    labels = [rp.labels(i, f) for i, f in enumerate(trace)]
    trace_s = time.perf_counter() - t0
    ranker = FFModel(FFConfig(batch_size=TRAIN_B, seed=SEED, device="cuda"))
    build_dlrm(ranker, cfg)
    ranker.compile()
    ranker.init_layers()
    trainer, _ = train_model("cat", "cuda")
    trainer.init_layers(SEED + 1)
    spool = FeedbackSpool(capacity=2 * STREAM_STEPS)
    result, errors = {}, []

    def train():
        try:
            result.update(trainer.fit_stream(spool.source, steps=None,
                                             verbose=False))
        except BaseException as e:   # noqa: BLE001 — reported below
            errors.append(repr(e))

    zero_counts()
    with PlainCalls() as plain:
        with InferenceEngine(ranker, ServeConfig(max_batch=TRAIN_B)) as eng:
            th = threading.Thread(target=train, name="stream-trainer")
            t0 = time.perf_counter()
            th.start()
            for i, f in enumerate(trace):
                scores = eng.predict(f, timeout=120).scores
                check(scores.shape == (TRAIN_B, 1)
                      and np.isfinite(scores).all(),
                      f"stream: bad scores for request {i}")
                spool.offer(f, labels[i], scores=scores, step=i)
            spool.close()
            th.join(600)
            wall = time.perf_counter() - t0
    launches = read_counts()
    st = spool.stats()
    check(not errors and not th.is_alive()
          and result.get("steps") == STREAM_STEPS
          and trainer._step == STREAM_STEPS
          and st["landed"] == st["consumed"] == STREAM_STEPS
          and st["dropped_faults"] == st["dropped_overflow"] == 0,
          f"stream: {errors}, {result}, {st}")
    check(plain.calls == 0 and launches["embedding_bag"] > 0
          and launches["scatter_write_rows"] == STREAM_STEPS
          and launches["dense_update"] == STREAM_STEPS,
          f"stream: launches {launches}, plain calls {plain.calls}")
    check(np.isfinite(trainer.perf.report()["mse"]),
          f"stream: mse {trainer.perf.report()}")
    del ranker, trainer
    torch.cuda.empty_cache()

    x, y = synthetic_batch(cfg, 8 * TRAIN_B, seed=SEED + 10)
    streamed, _ = train_model("cat", "cuda")
    looped, _ = train_model("cat", "cuda")
    for m in (streamed, looped):
        m.init_layers(SEED)
    out = streamed.fit_stream(ArrayStream(x, y, TRAIN_B, seed=1),
                              steps=STREAM_CHECK_STEPS, verbose=False)
    src = ArrayStream(x, y, TRAIN_B, seed=1)
    for i in range(STREAM_CHECK_STEPS):
        looped.train_batch(src(i))
    check(out["steps"] == STREAM_CHECK_STEPS
          and _same_state(streamed, looped),
          "stream: fit_stream over an ArrayStream differs from the "
          "train_batch loop")
    print(f"stream: drifting_zipf trace of {STREAM_STEPS} requests of "
          f"{TRAIN_B} (made in {trace_s:.2f} s) served and trained off the "
          f"spool on a thread in {wall:.2f} s: {result['throughput']:.1f} "
          f"samples/s trained, {STREAM_STEPS / wall:.1f} requests/s "
          f"served; spool {st}; fit_stream over an ArrayStream "
          f"({STREAM_CHECK_STEPS} steps, {out['throughput']:.1f} samples/s) "
          f"bitwise the train_batch loop")
    del streamed, looped
    torch.cuda.empty_cache()
    return launches


def resilience_phase():
    """The anomaly sentinel, rollback, whole-dataset staging and the
    stream, in WORK_DIR (removed at the end whatever happens): (a)
    ``sentinel_runs`` with the guarded entries and the norm kernel held
    to their plain versions first, (b) ``rollback_run``, (c)
    ``staging_runs``, (d) ``stream_runs``. Returns ({"grad_sumsq": its
    kernel row}, the main paths' launch counts)."""
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    WORK_DIR.mkdir(parents=True)
    dev = torch.device("cuda", 0)
    try:
        t0 = time.perf_counter()
        row = sumsq_kernel(dev)
        guarded_entries(dev)
        counts = sentinel_runs()
        rollback_run(WORK_DIR)
        for part in (staging_runs(), stream_runs()):
            for k, v in part.items():
                counts[k] = counts.get(k, 0) + v
        print(f"resilience phase: {time.perf_counter() - t0:.1f} s")
        return row, counts
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)


# ---------------------------------------------------------------------
# the continual loop and the serving app (phases 9 and 10)
# ---------------------------------------------------------------------
def app_flags(cfg, extra):
    """The serving app's argv for a DLRMConfig, on 127.0.0.1 at a port
    the OS picks."""
    return ["--arch-embedding-size", "-".join(map(str, cfg.embedding_size)),
            "--arch-sparse-feature-size", str(cfg.sparse_feature_size),
            "--arch-mlp-bot", "-".join(map(str, cfg.mlp_bot)),
            "--arch-mlp-top", "-".join(map(str, cfg.mlp_top)),
            "--arch-interaction-op", cfg.arch_interaction_op,
            "--lr", str(LR), "--host", "127.0.0.1", "--port", "0"] + extra


class AppProcess:
    """``python -m dlrm_flexflow_tpu_torch.examples.native.serve_dlrm`` as
    a child process of the checkout (its kernels already built by this
    process), its stderr in ``log``; ``call`` speaks HTTP to it and
    ``stop`` sends SIGTERM and checks a clean exit."""

    def __init__(self, argv, log):
        import os
        import queue
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("FF_FAULT_")}
        env["PYTHONPATH"] = str(REPO)
        self.log = log
        self._err = open(log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "dlrm_flexflow_tpu_torch.examples.native.serve_dlrm", *argv],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=self._err,
            text=True, start_new_session=True)
        self._lines = queue.Queue()
        threading.Thread(target=lambda: [self._lines.put(ln) for ln in
                                         self.proc.stdout],
                         daemon=True).start()
        self.url = None
        self.t0 = time.perf_counter()

    def wait_ready(self, timeout=600):
        """Block until the app prints its address; returns the seconds
        since the process started."""
        import queue
        try:
            line = self._lines.get(timeout=timeout)
        except queue.Empty:
            line = ""
        if not line.startswith("serving DLRM on http://"):
            self.kill()
            tail = Path(self.log).read_text()[-3000:]
            raise SmokeFailure(f"the serving app did not start (exit "
                               f"{self.proc.poll()}): {line!r}\n{tail}")
        self.url = line.split(" on ", 1)[1].strip()
        return time.perf_counter() - self.t0

    def call(self, path, body=None):
        """(status, parsed JSON or text) of one request."""
        import urllib.error
        import urllib.request
        data = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode())
        req = urllib.request.Request(self.url + path, data=data,
                                     method="GET" if data is None
                                     else "POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                code, text = r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            code, text = e.code, e.read().decode()
        try:
            return code, json.loads(text)
        except ValueError:
            return code, text

    def kill(self):
        """SIGKILL to the app and everything it started (its shard
        processes share its process group)."""
        import os
        import signal
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(30)

    def stop(self, timeout=120):
        """SIGTERM, then the exit code (must be 0)."""
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            rc = self.proc.wait(30)
        finally:
            self._err.close()
        return rc


class Clients:
    """LOOP_CLIENTS threads posting one /predict body back to back; each
    ``window`` counts the answers between its start and its stop."""

    def __init__(self, app, body, n=None):
        self.app, self.body = app, json.dumps(body).encode()
        self.n = n or LOOP_CLIENTS
        self.errors = []

    def start(self):
        self._stop = threading.Event()
        self._done = [0] * self.n
        self._threads = [threading.Thread(target=self._run, args=(i,))
                         for i in range(self.n)]
        self._t0 = time.perf_counter()
        for t in self._threads:
            t.start()

    def _run(self, i):
        while not self._stop.is_set():
            code, out = self.app.call("/predict", self.body)
            if code != 200:
                self.errors.append((code, str(out)[:200]))
                return
            self._done[i] += 1

    def stop(self):
        """(answers, seconds) of the window."""
        self._stop.set()
        for t in self._threads:
            t.join(300)
        return sum(self._done), time.perf_counter() - self._t0


def wait_for(cond, what, timeout=300):
    """Poll ``cond`` every 5 ms; returns the perf_counter when it held."""
    t_end = time.perf_counter() + timeout
    while not cond():
        check(time.perf_counter() < t_end, f"loop: {what} within "
              f"{timeout} s")
        time.sleep(0.005)
    return time.perf_counter()


def _loop(work, app_holder):
    """(a) The continual loop at full width: a "dot" trainer (batch
    LOOP_B, the launcher's SGD) runs ``fit_stream`` over an
    ``ArrayStream`` with a ``DeltaPublisher`` (a publish every LOOP_EVERY
    steps, a compaction after LOOP_DELTAS deltas, the last of them torn
    by FF_FAULT_DELTA_TORN=1), followed by an in-process
    ``InferenceEngine(checkpoint_dir=...)`` and by the serving app as a
    child process on 127.0.0.1 (``--obs on``), both polling every 50 ms.
    After each publish the training thread waits until both reach the
    version (or reject the torn delta with its reason): the engine's
    scores at 1, 64 and 256 rows must be BITWISE the trainer's
    ``forward_bucket`` on the same bucket, the app's /predict at 64 rows
    within rtol 1e-5, atol 1e-6 of it (the line says whether bitwise),
    while LOOP_CLIENTS client threads post /predict (requests/s with a
    reload in flight; then a LOOP_RATE_S window without). Every count at
    0 just before the loop and read just after. Returns the counts."""
    import os
    from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
    from dlrm_flexflow_tpu_torch.utils import faults
    from dlrm_flexflow_tpu_torch.utils.delta import DeltaPublisher
    cfg = train_config("dot")
    ckdir = work / "loop"
    ckdir.mkdir()
    # this phase's own memory: its peak over what earlier phases hold
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    torn_step = LOOP_EVERY * (LOOP_DELTAS + 1)
    app = AppProcess(app_flags(cfg, [
        "-b", str(LOOP_B), "--seed", str(SEED + 2),
        "--checkpoint-dir", str(ckdir), "--serve-poll", "0.05",
        "--serve-max-batch", "256", "--obs", "on"]), work / "loop_app.log")
    app_holder.append(app)

    def model(seed, batch):
        # the unfused "dot", as the app builds it from the same flags
        m = FFModel(FFConfig(batch_size=batch, seed=seed, device="cuda"))
        build_dlrm(m, cfg)
        m.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"])
        m.init_layers()
        return m

    trainer, server = model(SEED, LOOP_B), model(SEED + 1, 256)
    nbytes = _model_bytes(trainer)
    free = shutil.disk_usage(work).free
    check(free >= 4 * nbytes, f"loop: {free / 1e9:.1f} GB free under "
          f"{work}, the loop keeps up to 3 snapshots of "
          f"{nbytes / 1e9:.2f} GB")
    x, y = synthetic_batch(cfg, LOOP_B * LOOP_STEPS, seed=SEED + 20)
    queries = {n: synthetic_batch(cfg, n, seed=SEED + 30 + n)[0]
               for n in LOOP_SIZES}
    q_app = queries[64]
    pub = DeltaPublisher(trainer, str(ckdir), keep_last=2,
                         full_every=LOOP_DELTAS)
    published = []
    publish = pub.publish

    def timed_publish(loader_state):
        t0 = time.perf_counter()
        entry = publish(loader_state)
        published.append((int(trainer._step), t0, time.perf_counter(),
                          dict(pub.last_publish)))
        return entry

    pub.publish = timed_publish
    engine = InferenceEngine(server, ServeConfig(max_batch=256, poll_s=0.05),
                             checkpoint_dir=str(ckdir))
    t_ready = app.wait_ready()
    clients = Clients(app, {k: v.tolist() for k, v in q_app.items()})
    rows, rejects, app_exact = [], {}, []

    def app_version():
        return app.call("/stats")[1]

    def on_step(m, k, mets):
        if k == torn_step - 1:
            rejects["engine"] = engine.stats()["reload_rejects"]
            rejects["app"] = app_version()["reload_rejects"]
            os.environ["FF_FAULT_DELTA_TORN"] = "1"
            faults.install(faults.plan_from_env())
        if k % LOOP_EVERY:
            return
        step, t0, t1, split = published[-1]
        check(step == k, f"loop: published step {step} at step {k}")
        torn = k == torn_step
        if torn:
            plan = faults.active()
            faults.clear()
            del os.environ["FF_FAULT_DELTA_TORN"]
            check(plan.fired and plan.fired[0][0] == "torn_delta",
                  f"loop: the torn-delta fault did not fire: {plan.fired}")
        clients.start()
        if torn:
            t_eng = wait_for(lambda: engine.stats()["reload_rejects"]
                             > rejects["engine"], "the engine's reject")
            t_app = wait_for(lambda: app_version()["reload_rejects"]
                             > rejects["app"], "the app's reject")
        else:
            t_eng = wait_for(lambda: engine.version == k,
                             f"the engine at version {k}")
            t_app = wait_for(lambda: app_version()["version"] == k,
                             f"the app at version {k}")
        n, dt = clients.stop()
        rows.append((split["kind"] if not torn else "torn", k, t1 - t0,
                     t_eng - t0, t_app - t0, n, dt, split))
        if torn:
            st, ast = engine.stats(), app_version()
            for who, s in (("engine", st), ("app", ast)):
                check("fails its CRC-32" in s["last_reload_reject"]
                      and s["version"] == k - LOOP_EVERY,
                      f"loop: the {who} did not reject the torn delta "
                      f"with its reason: {s['last_reload_reject']!r}, "
                      f"version {s['version']}")
            p = engine.predict(queries[1], timeout=120)
            check(p.version == k - LOOP_EVERY and np.isfinite(
                p.scores).all(), "loop: the engine stopped serving after "
                "the torn delta")
            return
        for n_rows, q in queries.items():
            got = engine.predict(q, timeout=120)
            want = trainer.forward_bucket(q, n_rows).cpu().numpy()
            check(got.version == k and np.array_equal(got.scores, want),
                  f"loop: the engine at version {k} is not bitwise the "
                  f"trainer on {n_rows} rows (largest difference "
                  f"{float(np.abs(got.scores - want).max()):.3g})")
        code, out = app.call("/predict", {kk: v.tolist()
                                          for kk, v in q_app.items()})
        want = trainer.forward_bucket(q_app, 64).cpu().numpy().reshape(-1)
        got = np.asarray(out["scores"], np.float32) if code == 200 else None
        check(code == 200 and out["version"] == k
              and np.allclose(got, want, rtol=1e-5, atol=1e-6),
              f"loop: the app at version {k} answered {code} "
              f"{str(out)[:200]}")
        app_exact.append(bool(np.array_equal(got, want)))

    zero_counts()
    with PlainCalls() as plain:
        with engine:
            t0 = time.perf_counter()
            out = trainer.fit_stream(ArrayStream(x, y, LOOP_B, seed=1),
                                     steps=LOOP_STEPS, publisher=pub,
                                     publish_every=LOOP_EVERY,
                                     callbacks=[on_step], verbose=False)
            wall = time.perf_counter() - t0
            est = engine.stats()
    launches = read_counts()
    check(not clients.errors, f"loop: /predict failed: {clients.errors[:3]}")
    check(out["steps"] == LOOP_STEPS and len(rows) == LOOP_DELTAS + 2,
          f"loop: {out['steps']} steps, {len(rows)} publishes")
    kinds = [r[0] for r in rows]
    check(kinds == ["full"] + ["delta"] * (LOOP_DELTAS - 1)
          + ["torn", "full"], f"loop: publishes {kinds}")
    check(est["delta_reloads"] == LOOP_DELTAS - 1
          and est["full_reloads"] == 2 and est["reload_rejects"] == 1,
          f"loop: engine reloads {est}")
    check(plain.calls == 0 and launches["embedding_bag"] > 0
          and launches["scatter_write_rows"] == LOOP_STEPS
          and launches["scatter_presort"] == LOOP_STEPS
          and launches["dense_update"] == LOOP_STEPS,
          f"loop: launches {launches}, plain calls {plain.calls}")

    # the app at the last version: requests/s with no reload in flight,
    # /healthz, /metrics, then a clean exit
    clients.start()
    time.sleep(LOOP_RATE_S)
    n_idle, dt_idle = clients.stop()
    check(not clients.errors, f"loop: /predict failed: {clients.errors[:3]}")
    ast = app_version()
    code, hz = app.call("/healthz")
    mcode, metrics = app.call("/metrics")
    mem = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rc = app.stop()
    check(ast["version"] == LOOP_STEPS
          and ast["delta_reloads"] == LOOP_DELTAS - 1
          and ast["full_reloads"] == 2 and ast["reload_rejects"] == 1,
          f"loop: the app's reloads {ast}")
    check(code == 200 and hz["ok"], f"loop: /healthz {code} {hz}")
    check(mcode == 200 and f'ff_serve_delta_reloads_total{{replica=""}} '
          f'{LOOP_DELTAS - 1}' in metrics
          and "ff_watcher_polls_total" in metrics
          and f'ff_serve_version{{replica=""}} {LOOP_STEPS}' in metrics,
          f"loop: /metrics {str(metrics)[:300]}")
    check(rc == 0, f"loop: the app exited {rc}: "
          f"{Path(app.log).read_text()[-2000:]}")

    def pct(vals):
        s = sorted(vals)
        return f"p50 {percentile(s, 50):.3f} s, p99 {percentile(s, 99):.3f} s"

    for kind, k, pub_s, eng_s, app_s, n, dt, split in rows:
        extra = "" if kind == "torn" else (
            f"; split: copy to host {split['copy_s']:.3f} s"
            + (f", diff {split['diff_s']:.3f} s" if "diff_s" in split
               else "")
            + f", write {split['write_s']:.3f} s, checksum "
            f"{split['crc_s']:.3f} s, {split['bytes'] / 1e6:.1f} MB "
            f"({split['bytes'] / 1e9 / max(split['write_s'], 1e-9):.2f} "
            f"GB/s written)")
        print(f"loop: step {k} {kind} publish {pub_s:.3f} s{extra}; "
              f"publish to served: engine {eng_s:.3f} s, app {app_s:.3f} s; "
              f"{n} /predict in {dt:.3f} s meanwhile "
              f"({n / max(dt, 1e-9):.1f} req/s)")
    for kind in ("delta", "full"):
        sel = [r for r in rows if r[0] == kind]
        print(f"loop: freshness ({kind}, {len(sel)} publishes): engine "
              f"{pct([r[3] for r in sel])}; app {pct([r[4] for r in sel])}; "
              f"/predict with a {kind} reload in flight "
              f"{sum(r[5] for r in sel) / sum(r[6] for r in sel):.1f} "
              f"req/s")
    print(f"loop: {LOOP_STEPS} steps of {LOOP_B} in {wall:.1f} s "
          f"({out['throughput']:.1f} samples/s with the publishes and "
          f"waits); app ready {t_ready:.1f} s after its start; /predict "
          f"({LOOP_CLIENTS} clients, 64 rows) with no reload "
          f"{n_idle / dt_idle:.1f} req/s; the app's answers "
          f"{'bitwise' if all(app_exact) else 'within 1e-5 but not bitwise'}"
          f" the trainer at {len(app_exact)} versions; the engine's "
          f"bitwise at {LOOP_SIZES} rows; card memory in use (every "
          f"process, earlier phases' cache included) {mem}; the trainer's "
          f"and the engine's peak "
          f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.2f} GB; engine "
          f"reloads {est['full_reloads']} full, {est['delta_reloads']} "
          f"delta, {est['reload_rejects']} reject; launches {launches}")
    del trainer, server, engine
    torch.cuda.empty_cache()
    return launches


def loop_phase(work):
    """See ``_loop``; the app's process is stopped and the torn-delta
    fault cleared whatever happens."""
    import os
    from dlrm_flexflow_tpu_torch.utils import faults
    apps = []
    try:
        return _loop(work, apps)
    finally:
        os.environ.pop("FF_FAULT_DELTA_TORN", None)
        faults.clear()
        for app in apps:
            app.kill()


def app_phase(work):
    """(b) The app's other paths: "cat" at full width with ``--retrieve
    on`` (1M items, k=100, one index shard), from initialized weights and
    no checkpoint directory. /predict of two users answers 100 re-ranked
    candidates each, none degraded; /retrieve at k=10 answers ids among
    them. The bag (ranker and user head) and the top-k run on the card in
    the child process: a wrapper given a CUDA tensor launches its kernel
    or raises, so an answer is the kernels' (their counts live in that
    process)."""
    cfg = train_config("cat")
    app = AppProcess(app_flags(cfg, [
        "-b", str(ITEM_BATCH), "--seed", str(SEED), "--retrieve", "on",
        "--retrieve-k", str(K), "--retrieve-deadline-ms", "5000",
        "--serve-max-batch", "256"]), work / "retrieve_app.log")
    try:
        t_ready = app.wait_ready()
        users = synthetic_batch(cfg, 2, seed=SEED + 40)[0]
        body = {k: v.tolist() for k, v in users.items()}
        t0 = time.perf_counter()
        code, out = app.call("/predict", body)
        t_pred = time.perf_counter() - t0
        check(code == 200, f"app: /predict {code} {str(out)[:300]}")
        cand = np.asarray(out["candidates"])
        check(cand.shape == (2, K) and not out["degraded"]
              and np.isfinite(np.asarray(out["scores"])).all()
              and set(out) == {"candidates", "scores", "version",
                               "retrieve_versions", "degraded",
                               "latency_ms", "stage_ms"},
              f"app: /predict answered {str(out)[:300]}")
        code, r = app.call("/retrieve", dict(body, k=10))
        check(code == 200, f"app: /retrieve {code} {str(r)[:300]}")
        ids = np.asarray(r["ids"])
        check(ids.shape == (2, 10) and not r["degraded"] and all(
            set(ids[i]) <= set(cand[i]) for i in range(2)),
            f"app: /retrieve answered {str(r)[:300]}")
        code, st = app.call("/stats")
        check(code == 200 and st["cascade"]["requests"] == 1,
              f"app: /stats {str(st)[:300]}")
    finally:
        rc = app.stop()
    check(rc == 0, f"app: exited {rc}: {Path(app.log).read_text()[-2000:]}")
    print(f"app: \"cat\" with --retrieve on (1M items, k={K}) ready "
          f"{t_ready:.1f} s after its start; /predict of 2 users "
          f"{t_pred * 1e3:.1f} ms (stages {out['stage_ms']} ms), /retrieve "
          f"k=10 {r['latency_ms']} ms, ids among the candidates; exit 0")


def serving_app_phase():
    """Phase 9, (a) and (b), in WORK_DIR (removed at the end whatever happens).
    Returns the loop's launch counts."""
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    WORK_DIR.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        counts = loop_phase(WORK_DIR)
        app_phase(WORK_DIR)
        print(f"serving app phases: {time.perf_counter() - t0:.1f} s")
        return counts
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)


def train_config(mode, rows=ROWS):
    cfg = DLRMConfig.random_benchmark()
    cfg.embedding_size = [rows] * T
    if mode == "dot":
        cfg.arch_interaction_op = "dot"
        cfg.mlp_top = [D + (T + 1) * T // 2] + cfg.mlp_top[1:]
    return cfg


def train_model(mode, device, rows=ROWS, opt="sgd"):
    cfg = train_config(mode, rows)
    model = FFModel(FFConfig(batch_size=TRAIN_B, seed=SEED, device=device))
    build_dlrm(model, cfg, fuse_interaction=mode == "dot")
    model.compile(TRAIN_OPTS[opt](), "mean_squared_error", ["mse"])
    return model, cfg


def train_name(mode, opt):
    return mode if opt == "sgd" else f"{mode} ({opt})"


def timed_steps(model, db, losses):
    """The main path of a training loop: TRAIN_STEPS steps back to back
    on the staged batch ``db``, timed as one window that ends in a
    synchronisation, with every launch count at 0 just before and read
    just after and the plain versions counted; then ten steps alone, each
    from an idle device to its end (what a step costs when nothing
    overlaps it with the next one's launches), and a second window (the
    host's speed drifts within a run). Appends each step's loss to
    ``losses``."""
    def window():
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            losses.append(model.train_batch_device(db)["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS

    zero_counts()
    with PlainCalls() as plain:
        windows = [window()]
    launches = read_counts()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        model.train_batch_device(db)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    windows.append(window())
    return {"launches": launches, "plain_calls": plain.calls,
            "windows": windows, "walls": walls}


def device_share(traced, wall_ms, ntop):
    """Text for the device's busy ms out of `wall_ms` and its top
    kernels, from ``traced_device_us``'s per-kernel microseconds."""
    if traced is None:
        return "device busy not measured (no device time traced)"
    busy = sum(traced.values()) / 1e3
    top = sorted(((us, k) for k, us in traced.items()), reverse=True)
    return (f"device busy {busy:.3f} ms, idle "
            f"{100 * (1 - busy / wall_ms):.1f}%; top: "
            + ", ".join(f"{k[:40]} {us:.1f} us" for us, k in top[:ntop]))


def profiled_steps(model, db, what, ntop, step_ms, host_reps=10):
    """Text for where a step's device time goes: ten steps queued behind
    a spin (the device's time for a step when the host never holds it
    back), ten traced by the profiler (its busy ms and top kernels) and
    ``step_ms``, the back-to-back step, beside both; then ``host_reps``
    steps with the host traced too, whose top ops are printed (tracing
    slows the host, so these times are inflated)."""
    reps = 10
    queued, why_not = queued_ms(model.train_batch_device, [(db,)], reps,
                                reps * step_ms)
    traced = traced_device_us(model.train_batch_device, [(db,)], reps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as hprof:
        for _ in range(host_reps):
            model.train_batch_device(db)
        torch.cuda.synchronize()
    host = sorted(((e.self_cpu_time_total / host_reps, e.key)
                   for e in hprof.key_averages()), reverse=True)
    print(f"train {what}: host per step, traced: " + ", ".join(
        f"{k[:32]} {us:.0f} us" for us, k in host[:8]))
    spent = (f"device {queued:.3f} ms/step queued (idle "
             f"{100 * (1 - queued / step_ms):.1f}% of the back-to-back "
             f"step)" if why_not is None else f"device not measured "
             f"queued ({why_not})")
    return f"{spent}; traced: " + device_share(traced, step_ms, ntop)


def train_timed(mode, opt):
    """Build, stage and time the full-width model of one graph under one
    of TRAIN_OPTS. Runs before the process's first profiler session: a
    session leaves the host's launch path slower for the rest of the
    process (see PERF.md), and this timing is the host's. Returns the
    run's state for ``train_report``."""
    model, cfg = train_model(mode, "cuda", opt=opt)
    model.init_layers()
    x, y = synthetic_batch(cfg, TRAIN_B, seed=SEED + 3)
    x["label"] = y
    run = {"mode": mode, "opt": opt, "model": model,
           "db": model._device_batch(x)}
    db = run["db"]
    if mode == "cat":
        # a sample of table rows the batch never looks up
        table = model.params["emb_stack"]["kernel"].view(T * ROWS, D)
        gids = (torch.as_tensor(x["sparse"][:, :, 0], device="cuda")
                + torch.arange(T, device="cuda") * ROWS).reshape(-1)
        sample = torch.randint(0, T * ROWS, (4096,), device="cuda",
                               generator=torch.Generator(
                                   device="cuda").manual_seed(SEED))
        sample = sample[~torch.isin(sample, gids)]
        run["untouched"] = (table, sample, table[sample].clone())
    losses = [model.train_batch_device(db)["loss"] for _ in range(3)]
    torch.cuda.synchronize()
    run.update(timed_steps(model, db, losses))
    run["losses"] = [float(v) for v in losses]
    return run


def train_report(run):
    """Check one timed run, profile ten more steps, print, and hold one
    step against the CPU; returns the kernels' launch counts over the
    main path's 20 steps."""
    mode, model, db = run["mode"], run["model"], run["db"]
    opt = run["opt"]
    what = train_name(mode, opt)
    launches, losses = run["launches"], run["losses"]
    stateful = mode == "cat" and model._stateful_sparse()
    kernel = ("scatter_add_rows" if mode == "dot" else
              "stateful_update_rows" if stateful else "scatter_write_rows")
    # the stateful update takes its one-launch route, the scatters one
    # pre-pass each; one dense update a step
    route, presorts = ("fused", 0) if stateful else ("block", TRAIN_STEPS)
    check(launches[kernel] == TRAIN_STEPS
          and launches[f"{kernel}:{route}"] == launches[kernel]
          and launches["scatter_presort"] == presorts
          and all(launches[k] == 0 for k in SCATTERS if k != kernel)
          and launches["dense_update"] == TRAIN_STEPS,
          f"train {what}: the {kernel} kernel did not launch once a step "
          f"on its {route} route after {presorts // TRAIN_STEPS} pre-pass, "
          f"alone of the scatters, beside one dense update: {launches}")
    check(run["plain_calls"] == 0,
          f"train {what}: a plain version ran {run['plain_calls']} times")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train {what}: loss {losses[0]} -> {losses[-1]}")
    if mode == "cat":
        table, sample, before = run.pop("untouched")
        check(sample.numel() > 4000
              and torch.equal(table[sample], before),
              f"train {what}: untouched table rows changed")
        # and their optimizer state never left zero (lazy: a dense
        # update would have moved both)
        for k in model.optimizer.sparse_slab_names():
            slab = model.opt_state[k]["emb_stack"]["kernel"].view(T * ROWS,
                                                                  D)
            check(not bool(slab[sample].any()),
                  f"train {what}: untouched rows' {k} state moved")

    windows, walls = run["windows"], run["walls"]
    step_ms = float(np.mean(windows))
    if (mode, opt) == ("dot", "adam"):
        eager_dense_steps(model, db, what)
    device = profiled_steps(model, db, what, 5, step_ms)
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items() if v}
    print(f"train {what}: {TRAIN_STEPS} steps back to back "
          f"{windows[0]:.3f} / {windows[1]:.3f} ms/step (two windows), "
          f"{TRAIN_B / step_ms * 1e3:.1f} samples/s; one step "
          f"alone {np.median(walls):.3f} ms median (min {min(walls):.3f}, "
          f"max {max(walls):.3f}); "
          f"launches per step {per_step}; loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; {device}")
    run.clear()
    del model, db
    torch.cuda.empty_cache()
    card_vs_cpu_step(mode, opt)
    return launches


class EagerDense:
    """While installed, the optimizers' dense update runs its plain
    version on the card: the eager elementwise passes that the dense
    update took before it had a kernel."""

    def __enter__(self):
        self._saved = opt_mod.dense_update
        opt_mod.dense_update = dense_mod.dense_update_reference
        return self

    def __exit__(self, *exc):
        opt_mod.dense_update = self._saved


def eager_dense_steps(model, db, what):
    """Steps of a timed model with the dense update on its kernel and,
    in turn, on its plain version (EagerDense): each one window of
    TRAIN_STEPS steps back to back, and each one step's peak device
    memory, from a reset of the peak just before it. Prints both."""
    res = {}
    for label in ("kernel", "eager", "kernel ", "eager "):
        with EagerDense() if label.startswith("eager") else \
                contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                model.train_batch_device(db)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            model.train_batch_device(db)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        res.setdefault(label.strip(), []).append((ms, peak, base))
    gib = 2 ** 30
    print(f"train {what}: dense update on its kernel against its plain "
          f"version (eager passes), in turn: " + "; ".join(
              f"{k} " + ", ".join(
                  f"{ms:.3f} ms/step, peak {peak / gib:.3f} GiB "
                  f"({(peak - base) / gib:.3f} above the step's start)"
                  for ms, peak, base in v)
              for k, v in res.items()))


def card_vs_cpu_step(mode, opt="sgd"):
    """One step on the card against the same step on the CPU, from the
    same weights, batch and (for an optimizer with state) the same
    non-zero state, at 8 × 65,536 rows (all widths full)."""
    what = train_name(mode, opt)
    gpu, cfg = train_model(mode, "cuda", CHECK_ROWS, opt)
    gpu.init_layers()
    cpu, _ = train_model(mode, "cpu", CHECK_ROWS, opt)
    cpu.swap_params({op: {n: v.cpu() for n, v in p.items()}
                     for op, p in gpu.params.items()})
    state = gpu.optimizer.init_state(gpu.params)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for k, sub in state.items():
        if k == "step":
            sub.fill_(4)
            continue
        for p in sub.values():
            for v in p.values():      # v of Adam positive, as it is
                v.copy_(1e-3 * torch.rand(v.shape, device="cuda",
                                          generator=gen))
    gpu.opt_state = state
    cpu.opt_state = {k: (v.cpu() if k == "step" else
                         {op: {n: t.cpu() for n, t in p.items()}
                          for op, p in v.items()})
                     for k, v in state.items()}
    init = {op: {n: v.clone() for n, v in p.items()}
            for op, p in cpu.params.items()}
    init_state = {k: {op: {n: t.clone() for n, t in p.items()}
                      for op, p in v.items()}
                  for k, v in cpu.opt_state.items() if k != "step"}
    x, y = synthetic_batch(cfg, TRAIN_B, seed=SEED + 4)
    x["label"] = y
    lg = float(gpu.train_batch(x)["loss"])
    lc = float(cpu.train_batch(x)["loss"])
    check(abs(lg - lc) <= 1e-5 * abs(lc),
          f"train {what}: card loss {lg} vs cpu {lc}")
    # cuBLAS and the CPU's BLAS sum the products in other orders; a relu
    # unit whose input lies within that rounding of 0 can take the other
    # branch on one side, which changes that unit's gradient for that
    # sample outright: each update within 10 % of its parameter's largest
    worst = 0.0
    pairs = [(cpu.params, gpu.params, init, "")]
    pairs += [(cpu.opt_state[k], gpu.opt_state[k], init_state[k], f" {k}")
              for k in init_state]
    for tc, tg, t0, tag in pairs:
        for op, p in tc.items():
            for n, v in p.items():
                dc = v - t0[op][n]
                dg = tg[op][n].cpu() - t0[op][n]
                scale = float(dc.abs().max())
                check(scale > 0, f"train {what}: {op}.{n}{tag} did not move")
                ratio = float((dg - dc).abs().max()) / scale
                worst = max(worst, ratio)
                check(ratio <= 0.1, f"train {what}: {op}.{n}{tag} update "
                      f"differs from the CPU's by {ratio:.3g} of its "
                      f"largest")
    print(f"train {what}: card vs cpu step ({CHECK_ROWS} rows per table"
          f"{', from non-zero state' if init_state else ''}): loss "
          f"{lg:.7f} / {lc:.7f}; worst update error {worst:.3g} of its "
          f"parameter's (or state's) largest update")
    del gpu, cpu
    torch.cuda.empty_cache()


def nmt_model(device, vocab=NMT_VOCAB, dim=NMT_DIM, seq=NMT_SEQ,
              batch=NMT_B, dtype="bfloat16"):
    """``build_nmt`` as benchmarks/run_zoo.py's ``bench_nmt`` builds and
    compiles it (embed = hidden = dim)."""
    model = FFModel(FFConfig(batch_size=batch, seed=SEED,
                             compute_dtype=dtype, device=device))
    build_nmt(model, src_vocab=vocab, tgt_vocab=vocab, embed_dim=dim,
              hidden=dim, num_layers=NMT_LAYERS, src_len=seq, tgt_len=seq)
    model.compile(SGDOptimizer(lr=NMT_LR), "sparse_categorical_crossentropy",
                  ["accuracy"])
    return model


def nmt_batch(vocab, seq, batch, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randint(0, vocab, (batch, seq)).astype(np.int32)
            for k in ("src", "tgt", "label")}


def nmt_timed():
    """Build and stage the full-width NMT model, bf16, take three warmup
    steps, then ``timed_steps``. Runs before any profiler session, as
    ``train_timed`` does; ``nmt_report`` checks and prints it."""
    model = nmt_model("cuda")
    t0 = time.perf_counter()
    model.init_layers()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    db = model._device_batch(nmt_batch(NMT_VOCAB, NMT_SEQ, NMT_B,
                                       SEED + 8))
    losses = [model.train_batch_device(db)["loss"] for _ in range(3)]
    torch.cuda.synchronize()
    run = {"model": model, "db": db, "init_s": t_init,
           **timed_steps(model, db, losses)}
    run["losses"] = [float(v) for v in losses]
    return run


def nmt_report(run):
    """Check the timed NMT run, profile ten more steps, print, and hold
    one step against the CPU; returns the launch counts of the main
    path's TRAIN_STEPS steps."""
    model, db = run.pop("model"), run.pop("db")
    launches, losses = run["launches"], run["losses"]
    for name, per_step in NMT_LAUNCHES.items():
        check(launches[name] == per_step * TRAIN_STEPS,
              f"train nmt: {launches[name]} {name} launches in "
              f"{TRAIN_STEPS} steps, expected {per_step} a step")
    check(run["plain_calls"] == 0,
          f"train nmt: a plain version ran {run['plain_calls']} times")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train nmt: loss {losses[0]} -> {losses[-1]}")
    windows, walls = run["windows"], run["walls"]
    step_ms = float(np.mean(windows))
    device = profiled_steps(model, db, "nmt", 6, step_ms, host_reps=3)
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items() if v}
    print(f"train nmt (b{NMT_B}, seq {NMT_SEQ}, vocab {NMT_VOCAB}, "
          f"{NMT_LAYERS}x{NMT_DIM}, bf16): {TRAIN_STEPS} steps back to back "
          f"{windows[0]:.3f} / {windows[1]:.3f} ms/step (two windows), "
          f"{NMT_B / step_ms * 1e3:.1f} samples/s; one step alone "
          f"{np.median(walls):.3f} ms median (min {min(walls):.3f}, max "
          f"{max(walls):.3f}); "
          f"launches per step {per_step}; loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; init {run['init_s']:.2f} s; {device}")
    del model, db
    torch.cuda.empty_cache()
    nmt_card_vs_cpu()
    return launches


def nmt_card_vs_cpu():
    """One fp32 SGD step of NMT on the card against the same step on the
    CPU, from the same weights and batch, at NMT_CHECK's reduced size."""
    c = NMT_CHECK
    gpu = nmt_model("cuda", **c)
    gpu.init_layers()
    cpu = nmt_model("cpu", **c)
    cpu.swap_params({op: {n: v.cpu() for n, v in p.items()}
                     for op, p in gpu.params.items()})
    init = {op: {n: v.clone() for n, v in p.items()}
            for op, p in cpu.params.items()}
    x = nmt_batch(c["vocab"], c["seq"], c["batch"], SEED + 9)
    before = lstm_mod.lstm_fwd.launches
    lg = float(gpu.train_batch(x)["loss"])
    lc = float(cpu.train_batch(x)["loss"])
    check(lstm_mod.lstm_fwd.launches - before == 2 * NMT_LAYERS,
          "nmt card step: the LSTM kernels did not run")
    check(abs(lg - lc) <= 1e-5 * abs(lc),
          f"nmt: card loss {lg} vs cpu {lc}")
    # the kernels, cuBLAS and the CPU's BLAS sum in other fp32 orders:
    # each update within 1e-3 of its parameter's largest update, plus two
    # fp32 steps of the parameter's values (the update lands in a sum
    # with the parameter, whose rounding can go either way; an embedding
    # row's update is small against its value)
    worst = 0.0
    for op, p in cpu.params.items():
        for n, v in p.items():
            dc = v - init[op][n]
            dg = gpu.params[op][n].cpu() - init[op][n]
            scale = float(dc.abs().max())
            check(scale > 0, f"nmt: {op}.{n} did not move")
            ulps = 2 * 2 ** -23 * float(init[op][n].abs().max())
            ratio = max(float((dg - dc).abs().max()) - ulps, 0.0) / scale
            worst = max(worst, ratio)
            check(ratio <= 1e-3, f"nmt: {op}.{n} update differs from the "
                  f"CPU's by {ratio:.3g} of its largest")
    print(f"train nmt: card vs cpu step (vocab {c['vocab']}, {NMT_LAYERS}x"
          f"{c['dim']}, seq {c['seq']}, batch {c['batch']}, fp32): loss "
          f"{lg:.7f} / {lc:.7f}; worst update error {worst:.3g} of its "
          f"parameter's largest update")
    del gpu, cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------
# Criteo's shapes (phase 10): non-uniform tables, the unfused "dot" and
# host-resident tables
# ---------------------------------------------------------------------
KAGGLE_D = 16
KAGGLE_TABLES = 26       # Criteo-Kaggle's sparse features
KAGGLE_CHECK_STEPS = 4   # steps of each run held against the plain run
KAGGLE_TIMED = 20        # back-to-back steps timed
# id sets cycled when timing the kernels at the Kaggle step's shape:
# 160 x (6,656 ids, updates and rows) = 143 MB, more than the 50 MB L2
KAGGLE_SETS = 160
KAGGLE_RUNS = (("cat", "sgd"), ("cat", "adam"), ("dot", "sgd"),
               ("dot", "adam"))
# examples/native/run_criteo_kaggle.sh's flags, on the synthetic batch
KAGGLE_FLAGS = ["-b", str(TRAIN_B), "-e", "1", "--lr", str(LR),
                "--arch-embedding-size",
                "-".join(map(str, DLRMConfig.criteo_kaggle().embedding_size)),
                "--arch-sparse-feature-size", str(KAGGLE_D),
                "--arch-mlp-bot", "13-512-256-64-16",
                "--arch-mlp-top", "224-512-256-1"]
# Criteo-Terabyte (the MLPerf DLRM shapes) with --host-tables: batch
# 2,048, "dot", TB_STEPS timed steps in each mode; the tables of at
# least TB_LARGE rows are the ones cut, by one common factor, when the
# host memory this process may still take (``host_headroom``) cannot
# hold them whole with TB_RESERVE bytes left: the process grows while it
# trains (the init's draws, a step's rows, cotangents and batches, the
# allocators' caches), and a process that meets the machine's limit is
# killed
TB_B = 2048
TB_STEPS = 8
TB_LARGE = 1_000_000
TB_RESERVE = 12 << 30


def kaggle_model(mode, opt, device="cuda", **cfg):
    """The full Criteo-Kaggle DLRM (26 tables, 11,386,880 concatenated
    rows x 16) in one graph, built as the launcher builds it, compiled
    under one of TRAIN_OPTS; not initialized."""
    dcfg = DLRMConfig.criteo_kaggle()
    dcfg.arch_interaction_op = mode
    m = FFModel(FFConfig(batch_size=TRAIN_B, device=device, seed=SEED,
                         **cfg))
    build_dlrm(m, dcfg)
    m.compile(TRAIN_OPTS[opt](), "mean_squared_error", ["mse"])
    return m, dcfg


@contextlib.contextmanager
def plain_embedding_kernels():
    """The embedding ops' kernels 1-3 and the stateful entry, and the
    optimizers' dense update, replaced by their plain PyTorch versions,
    run on the card's tensors (the ops look them up as globals of
    ``ops/embedding.py``, the optimizers as one of ``core/optimizers.py``,
    as EagerDense swaps it). On the card the plain scatters add a row's
    duplicates with atomics, in no fixed order."""
    from dlrm_flexflow_tpu_torch.ops import embedding as emb_mod

    class PlainBag:
        @staticmethod
        def apply(table, ids, aggr):
            return bag_mod.embedding_bag_reference(table, ids, aggr)

    swaps = {
        "embedding_bag": lambda table, ids, aggr="sum", return_rows=False:
            bag_mod.embedding_bag_reference(table, ids, aggr, return_rows),
        "EmbeddingBagFunction": PlainBag,
        "scatter_add_rows": lambda table, ids, upd, scale=1.0, div=1,
            ids_in_range=False, ok=None: scat_mod.scatter_add_rows_reference(
                table, ids, upd, scale, div, ok),
        "scatter_write_rows": lambda table, ids, upd, fwd, scale=1.0, div=1,
            ids_in_range=False, ok=None:
            scat_mod.scatter_write_rows_reference(table, ids, upd, fwd,
                                                  scale, div, ok),
        "stateful_update_rows": lambda table, ids, upd, fwd, slabs, p,
            alpha_t=None, div=1, ids_in_range=False, ok=None:
            scat_mod.stateful_update_rows_reference(
                table, ids, upd, fwd, slabs, p, alpha_t, div, ok),
    }
    saved = {k: getattr(emb_mod, k) for k in swaps}
    try:
        for k, v in swaps.items():
            setattr(emb_mod, k, v)
        with EagerDense():
            yield
    finally:
        for k, v in saved.items():
            setattr(emb_mod, k, v)


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def criteo_kernels(dev):
    """Kernels 1-3 and the stateful entry at the Criteo-Kaggle step's
    shape: 6,656 lookups (batch 256 x 26 tables) at d = 16 into the
    11,386,880-row concatenated table, the ids as ``EmbeddingBagConcat``
    makes them from synthetic batches; each held to its plain version
    (the bag within 1e-6, the scatters and the stateful update bitwise
    against the plain versions on the CPU) and timed beside its bound,
    its plain version and the PyTorch call that computes the same
    function. Prints a JSON line {"criteo_shapes": [...]}."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    model, dcfg = kaggle_model("cat", "sgd")
    op = model.get_layer_by_name("emb_concat")
    nrows, d = op.total_rows, KAGGLE_D
    table = 0.05 * torch.randn(nrows, d, device=dev, generator=gen)
    n = TRAIN_B * len(dcfg.embedding_size)
    sets = []
    for s in range(KAGGLE_SETS):
        x, _ = synthetic_batch(dcfg, TRAIN_B, seed=SEED + 1000 + s)
        gid = op._global_ids(torch.as_tensor(x["sparse"], device=dev))
        upd = torch.randn(n, d, device=dev, generator=gen)
        sets.append((gid, upd))
    del model
    shape = f"n={n} d={d} (Criteo-Kaggle step, {nrows:,}-row table)"
    out = []
    ids2, upd = sets[0]
    ids = ids2.reshape(-1)
    uniq = torch.unique(ids)
    m = int(uniq.numel())

    # kernel 1: the bag
    got = bag_mod.embedding_bag(table, ids2, "sum")
    want = bag_mod.embedding_bag_reference(table, ids2, "sum")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
          f"embedding_bag disagrees with its plain version at {shape}: "
          f"{err}")
    b_ms, b_by = bound(n * d * 4 + n * d * 4 + n * 8, n * d)
    args = [(g,) for g, _ in sets]
    out.append({
        "name": "embedding_bag", "shape": shape, "max_abs_err": err,
        "bound_ms": b_ms, "bound_by": b_by,
        **timed("", lambda i: bag_mod.embedding_bag(table, i, "sum"), args),
        **timed("plain_", lambda i: bag_mod.embedding_bag_reference(
            table, i, "sum"), args),
        **timed("library_", lambda i: torch.nn.functional.embedding_bag(
            i, table, mode="sum"), args)})
    print_row(out[-1], f" at {shape}; library: F.embedding_bag")

    # kernels 2 and 3: the write-only and the read-modify-write scatter
    table_cpu = table.cpu()
    fwd = table[ids]
    flat_sets = [(g.reshape(-1), u, table[g.reshape(-1)], -LR * u)
                 for g, u in sets]
    for name, with_fwd in (("scatter_write_rows", True),
                           ("scatter_add_rows", False)):
        kern = getattr(scat_mod, name)
        plain = getattr(scat_mod, name + "_reference")

        def call(fn, t, i, u, f, *_, with_fwd=with_fwd, **kw):
            if with_fwd:
                return fn(t, i, u, f, -LR, **kw)
            return fn(t, i, u, -LR, **kw)

        got = call(kern, table.clone(), ids, upd, fwd, ids_in_range=True)
        want = call(plain, table_cpu.clone(), ids.cpu(), upd.cpu(),
                    fwd.cpu())
        got_rows, want_rows = got[uniq].cpu(), want[uniq.cpu()]
        err = float((got_rows - want_rows).abs().max())
        check(torch.equal(got.cpu(), want),
              f"{name} disagrees with its plain version at {shape}: {err}")
        del got, want
        b_ms, b_by = bound(n * 8 + n * d * 4 + 2 * m * d * 4, 2 * n * d)
        scratch = table.clone()
        out.append({
            "name": name, "shape": shape, "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by,
            **timed("", lambda *a: call(kern, scratch, *a,
                                        ids_in_range=True), flat_sets),
            **timed("plain_", lambda *a: call(plain, scratch, *a),
                    flat_sets),
            **timed("library_", lambda i, _u, _f, scaled:
                    scratch.index_add_(0, i, scaled), flat_sets)})
        split = traced_split(lambda *a: call(kern, scratch, *a,
                                             ids_in_range=True), flat_sets)
        print_row(out[-1], f" at {shape} ({m} distinct rows); library: "
                  f"index_add_; kernel launches a call, traced: {split}")
        del scratch

    # the stateful entry under Adam, on its one-launch route
    opt = TRAIN_OPTS["adam"]()
    p = opt.row_params()
    alpha_t = opt.alpha_t(torch.tensor(4, dtype=torch.int32, device=dev))
    slabs = {k: 1e-3 * torch.rand(nrows, d, device=dev, generator=gen)
             for k in ("m", "v")}
    check(scat_mod.stateful_route(n, nrows) == "fused",
          "the Kaggle step's stateful update is not on the fused route")
    got, got_s = table.clone(), {k: v.clone() for k, v in slabs.items()}
    scat_mod.stateful_update_rows(got, ids, upd, fwd, got_s, p, alpha_t,
                                  ids_in_range=True)
    want, want_s = table_cpu.clone(), {k: v.cpu() for k, v in slabs.items()}
    scat_mod.stateful_update_rows_reference(want, ids.cpu(), upd.cpu(),
                                            fwd.cpu(), want_s, p,
                                            alpha_t.cpu())
    err = float((got[uniq].cpu() - want[uniq.cpu()]).abs().max())
    check(torch.equal(got.cpu(), want)
          and all(torch.equal(got_s[k].cpu(), want_s[k]) for k in slabs),
          f"stateful_update_rows disagrees with its plain version at "
          f"{shape} (Adam)")
    del got, got_s, want, want_s, table_cpu
    b_ms, b_by = bound(n * 8 + n * d * 4 + m * d * 4 * (2 + 2 * 2),
                       n * d + 12 * m * d)
    st_sets = [(i, u, f) for i, u, f, _ in flat_sets]
    out.append({
        "name": "stateful_update_rows", "shape": shape, "max_abs_err": err,
        "bound_ms": b_ms, "bound_by": b_by,
        **timed("", lambda i, u, f: scat_mod.stateful_update_rows(
            table, i, u, f, slabs, p, alpha_t, ids_in_range=True), st_sets),
        **timed("plain_", lambda i, u, f:
                scat_mod.stateful_update_rows_reference(
                    table, i, u, f, slabs, p, alpha_t), st_sets),
        "library_ms": None, "library_call_ms": None})
    print_row(out[-1], f" at {shape} (Adam, fused route; library: none)")
    del slabs, sets, flat_sets, st_sets, table
    torch.cuda.empty_cache()
    keys = ("name", "shape", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")
    print(json.dumps({"criteo_shapes": [{k: r[k] for k in keys}
                                        for r in out]}))


def same_changes(before, a, b, frac, what):
    """Each tensor's change in `b` within `frac` of its largest change in
    `a`; returns the largest such fraction seen."""
    worst = 0.0
    for op in a:
        for pn in a[op]:
            da = (a[op][pn] - before[op][pn]).float()
            db = (b[op][pn] - before[op][pn]).float()
            scale = float(da.abs().max())
            diff = float((db - da).abs().max())
            check(diff <= frac * scale + 1e-7,
                  f"{what}: {op}.{pn} changed by up to {diff:.3g} more or "
                  f"less than on the kernels (largest change {scale:.3g})")
            worst = max(worst, diff / scale if scale else 0.0)
    return worst


def kaggle_runs():
    """Criteo-Kaggle at its full size on the card, in the "cat" and the
    unfused "dot" graph, under SGD and Adam: KAGGLE_CHECK_STEPS steps on
    the kernels held against the same steps on the plain versions of
    the bag, the scatters, the stateful entry and the dense update from
    the same weights and batches (the loss within rtol 1e-4; every parameter's and slab's
    change within 1e-3 of its largest change under SGD, 1e-2 under Adam:
    the plain scatters add duplicates in no fixed order, and Adam turns
    those differences of small gradients into update differences of
    their own size), then KAGGLE_TIMED steps back to back. Launches
    counted in both: one bag, one scatter (the write-only under SGD, the
    stateful under Adam) and one dense update a step; none in the plain
    run. Returns the launch counts."""
    total = {}
    for mode, opt in KAGGLE_RUNS:
        a, dcfg = kaggle_model(mode, opt)
        a.init_layers()
        b, _ = kaggle_model(mode, opt)
        b.swap_params({op: {n: v.clone() for n, v in p.items()}
                       for op, p in a.params.items()})
        before = {op: {n: v.clone() for n, v in p.items()}
                  for op, p in a.params.items()}
        dbs = []
        for s in range(KAGGLE_CHECK_STEPS):
            x, y = synthetic_batch(dcfg, TRAIN_B, seed=SEED + 200 + s)
            x["label"] = y
            dbs.append(a._device_batch(x))
        scatter = ("stateful_update_rows" if opt == "adam"
                   else "scatter_write_rows")
        zero_counts()
        with PlainCalls() as plain:
            la = [float(a.train_batch_device(db)["loss"]) for db in dbs]
        counts = read_counts()
        add_counts(total, counts)
        steps = KAGGLE_CHECK_STEPS
        check(plain.calls == 0 and counts["embedding_bag"] == steps
              and counts[scatter] == steps
              and counts["dense_update"] == steps
              and sum(counts[k] for k in SCATTERS) == steps,
              f"criteo-kaggle {mode} {opt}: launches {counts}, plain "
              f"calls {plain.calls}")
        zero_counts()
        with plain_embedding_kernels():
            lb = [float(b.train_batch_device(db)["loss"]) for db in dbs]
        counts = read_counts()
        check(counts["embedding_bag"] == 0
              and sum(counts[k] for k in SCATTERS) == 0
              and counts["dense_update"] == 0,
              f"criteo-kaggle {mode} {opt}: the plain run launched "
              f"{counts}")
        check(all(np.isfinite(la)) and np.allclose(la, lb, rtol=1e-4),
              f"criteo-kaggle {mode} {opt}: losses {la} on the kernels, "
              f"{lb} on the plain versions")
        frac = 1e-2 if opt == "adam" else 1e-3
        worst = same_changes(before, b.params, a.params, frac,
                             f"criteo-kaggle {mode} {opt}")
        for k in b.optimizer.sparse_slab_names():
            zeros = {op: {n: torch.zeros_like(v) for n, v in p.items()}
                     for op, p in b.opt_state[k].items()}
            worst = max(worst, same_changes(zeros, b.opt_state[k],
                                            a.opt_state[k], frac,
                                            f"criteo-kaggle {mode} {opt} "
                                            f"slab {k}"))
        del b, before
        # timed, back to back
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(KAGGLE_TIMED):
            mets = a.train_batch_device(dbs[s % len(dbs)])
        float(mets["loss"])
        ms = (time.perf_counter() - t0) * 1e3 / KAGGLE_TIMED
        counts = read_counts()
        add_counts(total, counts)
        check(counts["embedding_bag"] == KAGGLE_TIMED
              and counts[scatter] == KAGGLE_TIMED
              and counts["dense_update"] == KAGGLE_TIMED,
              f"criteo-kaggle {mode} {opt} timed: launches {counts}")
        print(f"criteo-kaggle {mode} {opt}: {ms:.3f} ms a step, "
              f"{TRAIN_B * 1e3 / ms:,.0f} samples/s (batch {TRAIN_B}, "
              f"{a.get_layer_by_name('emb_concat').total_rows:,} x "
              f"{KAGGLE_D} concatenated rows); {KAGGLE_CHECK_STEPS} steps "
              f"on the kernels against the plain versions: loss rel diff "
              f"{max(abs(p - q) / abs(q) for p, q in zip(la, lb)):.2g}, "
              f"largest change diff {worst:.2g} of the change")
        del a, dbs
        torch.cuda.empty_cache()
    return total


def host_headroom():
    """(bytes this process may still take, how it was read): the
    kernel's MemAvailable and, where the process's memory cgroup has a
    limit (v2 ``memory.max``, v1 ``memory.limit_in_bytes``), no more
    than that limit less the group's use."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    how = f"MemAvailable {avail / 1e9:.2f} GB"
    with open("/proc/self/cgroup") as f:
        groups = [line.strip().split(":", 2) for line in f]
    for _, ctrl, path in groups:
        if ctrl == "":
            files = (f"/sys/fs/cgroup{path}/memory.max",
                     f"/sys/fs/cgroup{path}/memory.current")
        elif "memory" in ctrl.split(","):
            files = (f"/sys/fs/cgroup/memory{path}/memory.limit_in_bytes",
                     f"/sys/fs/cgroup/memory{path}/memory.usage_in_bytes")
        else:
            continue
        try:
            limit, used = (Path(f).read_text().strip() for f in files)
        except OSError:
            continue
        if limit.isdigit() and int(limit) < 1 << 60:
            room = int(limit) - int(used)
            how += (f", cgroup limit {int(limit) / 1e9:.2f} GB of which "
                    f"{int(used) / 1e9:.2f} GB used")
            avail = min(avail, room)
    return avail, how


def terabyte_sizes(d):
    """Criteo-Terabyte's 26 table sizes, the large ones cut by one
    common factor when the host cannot hold them whole; (sizes, factor,
    the bytes they take, how the host memory was read)."""
    sizes = DLRMConfig.terabyte().embedding_size
    pad = 8192

    def nbytes(ss):
        return -(-sum(ss) // pad) * pad * d * 4

    avail, how = host_headroom()
    budget = avail - TB_RESERVE
    if nbytes(sizes) <= budget:
        return sizes, 1.0, nbytes(sizes), how
    large = sum(s for s in sizes if s >= TB_LARGE)
    small = sum(s for s in sizes if s < TB_LARGE)
    factor = (budget // (d * 4) - pad - small) / large
    check(factor > 0.1, f"host RAM ({how}) holds less than a tenth of "
          f"Criteo-Terabyte's tables")
    cut = [int(s * factor) if s >= TB_LARGE else s for s in sizes]
    return cut, factor, nbytes(cut), how


def span_ms(name, steps):
    """Milliseconds a step in the trace ring's spans of `name`."""
    from dlrm_flexflow_tpu_torch.obs import trace as obst
    return sum(e["dur"] for e in obst.events()
               if e["name"] == name) / 1e3 / steps


def terabyte_runs():
    """Criteo-Terabyte's widths with --host-tables: the unfused "dot",
    26 tables at d = 128, bottom 13-512-256-128, top 479-1024-512-256-1,
    batch 2,048, SGD, the tables in host RAM (cut as ``terabyte_sizes``
    says, printed). The host init is timed. Then TB_STEPS steps in exact
    mode and in async mode (the next batch's ids passed, as ``fit``
    passes them), each with: samples/s, and per step the host gather,
    the copy of the rows to the card, the cotangents' readback (which
    waits for the step's device work), the host scatter (the spans of
    ``obs.trace``), the step's wall time, the device's busy time (the
    profiler's kernel sum) and idle share. One dense update a step and no
    bag or scatter on the card; finite losses; the exact-mode loss of one
    batch trained five times falls; touched host rows change and a
    sample of untouched rows does not. Before the steps, the dense
    update over this model's dense set is held bitwise to its plain
    version (``dense_matches_plain``). Returns the launch counts."""
    from dlrm_flexflow_tpu_torch.obs import trace as obst
    d = 128
    sizes, factor, nbytes, how = terabyte_sizes(d)
    full = DLRMConfig.terabyte().embedding_size
    if factor < 1.0:
        print(f"criteo-terabyte: host memory ({how}) holds "
              f"not the full {sum(full):,} rows x {d} fp32 "
              f"({-(-sum(full) // 8192) * 8192 * d * 4 / 1e9:.2f} GB) with "
              f"{TB_RESERVE / 2 ** 30:.0f} GiB left for the process: the "
              f"rows of the {sum(s >= TB_LARGE for s in full)} tables of "
              f">= {TB_LARGE:,} rows cut by {factor:.4f}, to {sum(sizes):,} "
              f"rows ({nbytes / 1e9:.2f} GB); the widths unchanged")
    else:
        print(f"criteo-terabyte: host memory ({how}) holds the full "
              f"{sum(sizes):,} rows x {d} ({nbytes / 1e9:.2f} GB)")
    dcfg = DLRMConfig.terabyte()
    dcfg.embedding_size = sizes
    dcfg.arch_interaction_op = "dot"
    model = FFModel(FFConfig(batch_size=TB_B, seed=SEED,
                             host_resident_tables=True,
                             host_tables_async=False))
    build_dlrm(model, dcfg)
    model.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"])
    check(model.get_layer_by_name("top_dense_0").in_dim == 128 + 351,
          "the Terabyte top MLP does not take 479 features")
    t0 = time.perf_counter()
    model.init_layers()
    init_s = time.perf_counter() - t0
    kernel = model.host_params["emb_concat"]["kernel"]
    print(f"criteo-terabyte: host init {init_s:.1f} s for "
          f"{kernel.nbytes / 1e9:.2f} GB ({kernel.shape[0]:,} x "
          f"{kernel.shape[1]} fp32, {len(sizes)} tables drawn on "
          f"threads); the card holds {_model_bytes(model) / 1e6:.1f} MB "
          f"of dense parameters")
    # the dense update at this model's dense set (its MLPs, the tables
    # being in host RAM), held to its plain version on copies
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    ws = [v.clone() for p in model.params.values() for v in p.values()]
    dense_matches_plain(ws, [torch.randn(w.shape, device=w.device,
                                         generator=gen) for w in ws],
                        gen, "Criteo-Terabyte's dense set")
    del ws
    dbs, hidx = [], []
    for s in range(4):
        x, y = synthetic_batch(dcfg, TB_B, seed=SEED + 300 + s)
        x["label"] = y
        dbs.append(model._device_batch(x))
        hidx.append({"emb_concat": x["sparse"]})
    check(dbs[0]["sparse"].device.type == "cpu",
          "the host tables' ids went to the card")
    touched = np.unique(np.concatenate([
        model.get_layer_by_name("emb_concat").host_flat_indices(
            h["emb_concat"]).reshape(-1) for h in hidx]))
    rng = np.random.RandomState(SEED)
    spare = rng.randint(0, kernel.shape[0], 4096)
    spare = spare[~np.isin(spare, touched)]
    spare_rows = kernel[spare].copy()
    seen_rows = kernel[touched[:4096]].copy()
    total = {}
    # exact: one batch five times, its loss must fall
    losses = [float(model.train_batch_device(dbs[0])["loss"])
              for _ in range(5)]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"criteo-terabyte exact: the loss of one batch did not fall: "
          f"{losses}")
    for mode in ("exact", "async"):
        model.config.host_tables_async = mode == "async"
        nxt = (lambda s: hidx[(s + 1) % len(hidx)]) if mode == "async" \
            else (lambda s: None)
        for s in (2, 3):        # warm up; the last chains dbs[0]'s rows
            model.train_batch_device(dbs[s], nxt(s))
        model._host_drain()
        zero_counts()
        obst.clear()
        with obst.override(True, capacity=65536):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for s in range(TB_STEPS):
                mets = model.train_batch_device(dbs[s % len(dbs)], nxt(s))
            loss = float(mets["loss"])
            model._host_drain()
            el = time.perf_counter() - t0
            spans = {k: span_ms(f"host/{k}", TB_STEPS)
                     for k in ("gather", "h2d", "readback", "scatter")}
        counts = read_counts()
        add_counts(total, counts)
        check(np.isfinite(loss) and counts["dense_update"] == TB_STEPS
              and counts["embedding_bag"] == 0
              and sum(counts[k] for k in SCATTERS) == 0,
              f"criteo-terabyte {mode}: loss {loss}, launches {counts}")
        step_ms = el * 1e3 / TB_STEPS
        traced = traced_device_us(
            lambda db: model.train_batch_device(db), [(dbs[0],)], 4)
        model._host_drain()
        copies = (None if traced is None else sum(
            us for k, us in traced.items() if k.startswith("Memcpy")) / 1e3)
        print(f"criteo-terabyte {mode} (batch {TB_B}, SGD): "
              f"{TB_STEPS * TB_B / el:,.0f} samples/s, {step_ms:.2f} ms a "
              f"step; per step: host gather {spans['gather']:.2f} ms, "
              f"copy to the card {spans['h2d']:.2f} ms, cotangent "
              f"readback {spans['readback']:.2f} ms (waits for the step's "
              f"device work), host scatter {spans['scatter']:.2f} ms"
              + (" (on the worker thread, overlapped)" if mode == "async"
                 else "")
              + "; " + device_share(traced, step_ms, 4)
              + ("" if copies is None else
                 f"; of the busy time, copies {copies:.3f} ms"))
    model._host_drain()
    check(np.array_equal(kernel[spare], spare_rows)
          and not np.array_equal(kernel[touched[:4096]], seen_rows),
          "criteo-terabyte: the host scatter changed untouched rows or "
          "no touched row")
    del model, kernel, dbs
    # a model's ops and closures form cycles: its 88 GB of host tables go
    # back only when the cycle collector runs, which phase 11's own
    # models and processes must not wait on
    gc.collect()
    torch.cuda.empty_cache()
    return total


def kaggle_launcher_runs():
    """The launcher with run_criteo_kaggle.sh's flags (the synthetic
    batch), on device tables and with --host-tables: a warm-up step and
    64 timed ones; every count at 0 just before and read just after: a
    bag, a pre-pass (the radix kernel: 6,656 lookups), a write-only
    scatter and a dense update a step on device tables, only the dense
    update with host tables; no plain
    version. Returns the launch counts."""
    from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
    total = {}
    for name, extra in (("device tables", []),
                        ("--host-tables", ["--host-tables"])):
        zero_counts()
        with PlainCalls() as plain:
            out = launcher.main(KAGGLE_FLAGS + extra)
        counts = read_counts()
        add_counts(total, counts)
        steps = out["steps"] + 1
        host = bool(extra)
        want = {"dense_update": steps,
                "embedding_bag": 0 if host else steps,
                "scatter_write_rows": 0 if host else steps,
                "scatter_presort": 0 if host else steps,
                "scatter_presort:radix": 0 if host else steps}
        check(plain.calls == 0
              and all(counts[k] == v for k, v in want.items())
              and counts["scatter_add_rows"] == 0,
              f"the Criteo-Kaggle launcher ({name}): launches {counts}, "
              f"plain calls {plain.calls}")
        print(f"criteo-kaggle launcher ({name}): "
              f"{out['throughput']:,.0f} samples/s over {out['steps']} "
              f"steps")
        del out
        torch.cuda.empty_cache()
    return total


def criteo_phase():
    """Phase 10: Criteo's shapes. Returns the launch counts of its runs
    on the main paths."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    criteo_kernels(dev)
    total = kaggle_runs()
    add_counts(total, kaggle_launcher_runs())
    add_counts(total, terabyte_runs())
    print(f"criteo phase: {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------
# phase 11: the shard tier over Criteo-Kaggle's host tables
# ---------------------------------------------------------------------
def tier_model(batch, seed):
    """Criteo-Kaggle uncut with ``--host-tables`` (26 tables in one
    11,386,880-row concatenated host table x 16, 0.73 GB), the unfused
    "dot" as the app builds it, SGD at the launcher's rate, initialized
    from ``seed``. Returns (model, its DLRMConfig)."""
    dcfg = DLRMConfig.criteo_kaggle()
    dcfg.arch_interaction_op = "dot"
    dcfg.zipf_alpha = TIER_ZIPF
    m = FFModel(FFConfig(batch_size=batch, device=TIER_DEV, seed=seed,
                         host_resident_tables=True))
    build_dlrm(m, dcfg)
    m.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"])
    m.init_layers()
    return m, dcfg


def tier_flat(model):
    """The model's concatenated host table, (rows, 16)."""
    (op,) = model._host_resident_list
    kern = model.host_params[op.name]["kernel"]
    return op.name, kern.reshape(-1, kern.shape[-1])


def at_version(vv, version):
    """Whether a version vector read some shards, all at ``version``."""
    return bool(vv) and all(v == version for v in vv.values())


def check_tier_blocks(sset, model, what):
    """Every shard's block BITWISE the model's rows it owns."""
    name, flat = tier_flat(model)
    for rep in sset.shards:
        lo, hi = rep.shard.owned_range(name)
        blk = rep.shard.blocks_copy()[0][name]
        check(np.array_equal(blk, flat[lo:hi]),
              f"tier: {what}: slot {rep.slot}'s rows [{lo}, {hi}) are not "
              f"bitwise the trainer's")


def _tier_loop(work, apps, fleet=None):
    """(1) Freshness: a Criteo-Kaggle trainer (host tables, batch TIER_B)
    runs ``fit_stream`` with a ``DeltaPublisher`` (a publish every
    TIER_EVERY steps: a full base, deltas, the last one torn by
    FF_FAULT_DELTA_TORN=1, a compaction), followed by an in-process
    engine on a TIER_SHARDS-shard tier (its ranker's tables released) and
    by the app as a child process (``--host-tables --serve-shards 4
    --serve-cache-rows``), both polling every 50 ms. At every version the
    in-process tier's blocks are BITWISE the trainer's host table, slot by
    slot; the engine's scores BITWISE the trainer's, the app's within
    1e-5; the version vectors of both never go back; the torn delta is
    rejected with its reason. Counts at 0 just before the loop, read just
    after. With ``fleet`` (phase 12's figures) the loop also drives phase
    12 (a)'s readers over shard processes (``TcpReaders``, checked at
    every publish by ``tcp_follow``), then ``tcp_after_loop``. Returns
    (trainer, dcfg, checkpoint directory, launches)."""
    import os
    from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
    from dlrm_flexflow_tpu_torch.utils import faults
    from dlrm_flexflow_tpu_torch.utils.delta import DeltaPublisher
    ckdir = work / "tier"
    ckdir.mkdir()
    t0 = time.perf_counter()
    trainer, dcfg = tier_model(TIER_B, SEED)
    server, _ = tier_model(256, SEED + 1)
    t_init = time.perf_counter() - t0
    sset = EmbeddingShardSet.build(
        server, TIER_SHARDS,
        config=ShardTierConfig(nshards=TIER_SHARDS,
                               lookup_deadline_ms=TIER_DEADLINE_MS))
    freed = EmbeddingShardSet.release_ranker_tables(server)
    nbytes = tier_flat(trainer)[1].nbytes
    free = shutil.disk_usage(work).free
    check(free >= 6 * nbytes, f"tier: {free / 1e9:.1f} GB free under "
          f"{work}, the loop keeps up to 3 snapshots of "
          f"{nbytes / 1e9:.2f} GB")
    torn_step = TIER_EVERY * (TIER_DELTAS + 1)
    app = AppProcess(app_flags(dcfg, [
        "-b", "256", "--seed", str(SEED + 2), "--host-tables",
        "--serve-shards", str(TIER_SHARDS),
        "--serve-lookup-deadline-ms", str(TIER_DEADLINE_MS),
        "--serve-cache-rows", str(TIER_CACHE),
        "--serve-cache-warm", str(ckdir), "--checkpoint-dir", str(ckdir),
        "--serve-poll", "0.05", "--serve-max-batch", "256"]),
        work / "tier_app.log")
    apps.append(app)
    x, y = synthetic_batch(dcfg, TIER_B * TIER_STEPS, seed=SEED + 50)
    q = synthetic_batch(dcfg, TIER_REQ_ROWS, seed=SEED + 51)[0]
    q_body = {k: v.tolist() for k, v in q.items()}
    pub = DeltaPublisher(trainer, str(ckdir), keep_last=2,
                         full_every=TIER_DELTAS)
    published = []
    publish = pub.publish

    def timed_publish(loader_state):
        t_pub = time.perf_counter()
        entry = publish(loader_state)
        published.append((int(trainer._step), t_pub, time.perf_counter(),
                          dict(pub.last_publish)))
        return entry

    pub.publish = timed_publish
    engine = InferenceEngine(server, ServeConfig(max_batch=256, poll_s=0.05),
                             checkpoint_dir=str(ckdir), shard_set=sset)
    tcp = None if fleet is None else TcpReaders(work, dcfg, ckdir, apps)
    t_ready = app.wait_ready()
    if tcp is not None:
        t_tcp_ready = tcp.app.wait_ready()
    clients = Clients(app, q_body)
    rows, rejects, app_exact, vectors = [], {}, [], {"engine": [], "app": []}

    def app_stats():
        return app.call("/stats")[1]

    def monotonic(seq, who):
        for a, b in zip(seq, seq[1:]):
            check(all(b[s] >= a[s] for s in set(a) & set(b)),
                  f"tier: the {who}'s version vector went back: {a} -> {b}")

    def on_step(m, k, mets):
        if k == torn_step - 1:
            rejects["engine"] = engine.stats()["reload_rejects"]
            rejects["app"] = app_stats()["reload_rejects"]
            if tcp is not None:
                rejects["tcp_engine"] = tcp.engine.stats()["reload_rejects"]
                rejects["tcp_app"] = tcp.app.call("/stats")[1][
                    "reload_rejects"]
            os.environ["FF_FAULT_DELTA_TORN"] = "1"
            faults.install(faults.plan_from_env())
        if k % TIER_EVERY:
            return
        step, t_pub, t1, split = published[-1]
        check(step == k, f"tier: published step {step} at step {k}")
        torn = k == torn_step
        if torn:
            plan = faults.active()
            faults.clear()
            del os.environ["FF_FAULT_DELTA_TORN"]
            check(plan.fired and plan.fired[0][0] == "torn_delta",
                  f"tier: the torn-delta fault did not fire: {plan.fired}")
        clients.start()
        if torn:
            t_eng = wait_for(lambda: engine.stats()["reload_rejects"]
                             > rejects["engine"], "the engine's reject")
            t_app = wait_for(lambda: app_stats()["reload_rejects"]
                             > rejects["app"], "the app's reject")
        else:
            t_eng = wait_for(lambda: engine.version == k
                             and sset.min_version() == k,
                             f"the engine's tier at version {k}")
            t_app = wait_for(lambda: app_stats()["version"] == k,
                             f"the app at version {k}")
        n, dt = clients.stop()
        rows.append((split["kind"] if not torn else "torn", k, t1 - t_pub,
                     t_eng - t_pub, t_app - t_pub, n, dt, split))
        if tcp is not None:
            want = (None if torn else
                    trainer.forward_bucket(q, TIER_REQ_ROWS).cpu().numpy())
            tcp_follow(tcp, k, torn, trainer, q, q_body, want, rejects)
        if torn:
            for who, s in (("engine", engine.stats()), ("app", app_stats())):
                check("fails its CRC-32" in s["last_reload_reject"]
                      and s["version"] == k - TIER_EVERY,
                      f"tier: the {who} did not reject the torn delta with "
                      f"its reason: {s['last_reload_reject']!r}")
            check(sset.version_vector() == {s: k - TIER_EVERY
                                            for s in range(TIER_SHARDS)},
                  f"tier: the tier moved on a torn delta: "
                  f"{sset.version_vector()}")
            return
        check_tier_blocks(sset, trainer, f"version {k}")
        want = trainer.forward_bucket(q, TIER_REQ_ROWS).cpu().numpy()
        got = engine.predict(q, timeout=120)
        check(got.version == k and not got.degraded
              and at_version(got.versions, k)
              and np.array_equal(got.scores, want),
              f"tier: the engine at version {k} is not bitwise the trainer "
              f"(versions {got.versions}, largest difference "
              f"{float(np.abs(got.scores - want).max()):.3g})")
        vectors["engine"].append(got.versions)
        code, out = app.call("/predict", q_body)
        agot = np.asarray(out["scores"], np.float32) if code == 200 else None
        check(code == 200 and out["version"] == k and not out["degraded"]
              and at_version(out["versions"], k)
              and np.allclose(agot, want.reshape(-1), rtol=1e-5, atol=1e-6),
              f"tier: the app at version {k} answered {code} "
              f"{str(out)[:300]}")
        vectors["app"].append({int(s): v for s, v in out["versions"].items()})
        app_exact.append(bool(np.array_equal(agot, want.reshape(-1))))

    engine.start()
    if tcp is not None:
        tcp.engine.start()
    zero_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        out = trainer.fit_stream(ArrayStream(x, y, TIER_B, seed=1),
                                 steps=TIER_STEPS, publisher=pub,
                                 publish_every=TIER_EVERY,
                                 callbacks=[on_step], verbose=False)
        wall = time.perf_counter() - t0
        est = engine.stats()
    launches = read_counts()
    if tcp is not None:
        try:
            tst = tcp.engine.stats()
            check(tst["reload_rejects"] == 1
                  and tst["degraded_responses"] == 0
                  and tst["version"] == TIER_STEPS,
                  f"fleet: the engine over shard processes: {tst}")
            ast = tcp.app.call("/stats")[1]
            check(ast["version"] == TIER_STEPS and ast["reload_rejects"] == 1
                  and ast["degraded_responses"] == 0
                  and all(s.get("remote") for s in
                          ast["shard_set"]["shards"].values()),
                  f"fleet: the tcp app's stats {str(ast)[:400]}")
            rc = tcp.app.stop()
            check(rc == 0, f"fleet: the tcp app exited {rc}: "
                  f"{Path(tcp.app.log).read_text()[-2000:]}")
            print(f"fleet: (a) the warm cache seeded in {tcp.seed_s:.1f} s, "
                  f"{FLEET_SHARDS} shard processes booted in "
                  f"{tcp.boot_s:.1f} s (no CUDA context); the tcp app ready "
                  f"{t_tcp_ready:.1f} s after its start; at every version "
                  f"every shard process's block bitwise the trainer's, the "
                  f"engine over them bitwise the trainer, the tcp app "
                  f"{'bitwise' if all(tcp.exact) else 'within 1e-5'} at "
                  f"{len(tcp.exact)} versions; the torn delta rejected by "
                  f"both")
        except BaseException:
            tcp.close()
            raise
    check(not clients.errors, f"tier: /predict failed: {clients.errors[:3]}")
    kinds = [r[0] for r in rows]
    check(out["steps"] == TIER_STEPS and kinds == ["full"] + ["delta"] * (
        TIER_DELTAS - 1) + ["torn", "full"], f"tier: publishes {kinds}")
    check(est["delta_reloads"] == TIER_DELTAS - 1
          and est["full_reloads"] == 2 and est["reload_rejects"] == 1
          and est["degraded_responses"] == 0, f"tier: engine reloads {est}")
    monotonic(vectors["engine"], "engine")
    monotonic(vectors["app"], "app")
    check(plain.calls == 0 and launches["dense_update"] == TIER_STEPS
          and launches["embedding_bag"] == 0
          and not any(launches[s] for s in SCATTERS),
          f"tier: launches {launches}, plain calls {plain.calls}")
    ast = app_stats()
    rc = app.stop()
    check(ast["version"] == TIER_STEPS and ast["reload_rejects"] == 1
          and ast["shard_set"]["nshards"] == TIER_SHARDS
          and ast["degraded_responses"] == 0, f"tier: the app's stats "
          f"{str(ast)[:400]}")
    check(rc == 0, f"tier: the app exited {rc}: "
          f"{Path(app.log).read_text()[-2000:]}")
    check_tier_blocks(sset, trainer, "the last version")
    if tcp is not None:
        # phase 12 (a) after the loop, the phase 11 app stopped
        try:
            tcp_after_loop(tcp, trainer, dcfg, engine, fleet)
        finally:
            tcp.close()
    engine.close()
    sset.close()
    for kind, k, pub_s, eng_s, app_s, n, dt, split in rows:
        extra = "" if kind == "torn" else (
            f" (copy to host {split['copy_s']:.3f} s"
            + (f", diff {split['diff_s']:.3f} s" if "diff_s" in split
               else "")
            + f", write {split['write_s']:.3f} s, checksum "
            f"{split['crc_s']:.3f} s, {split['bytes'] / 1e6:.1f} MB)")
        print(f"tier: step {k} {kind} publish {pub_s:.3f} s{extra}; "
              f"publish to served: engine's tier {eng_s:.3f} s, app "
              f"{app_s:.3f} s; {n} app /predict meanwhile "
              f"({n / max(dt, 1e-9):.1f} req/s)")

    def pct(vals):
        s = sorted(vals)
        return f"p50 {percentile(s, 50):.3f} s, p99 {percentile(s, 99):.3f} s"

    for kind in ("delta", "full"):
        sel = [r for r in rows if r[0] == kind]
        print(f"tier: freshness ({kind}, {len(sel)} publishes): engine's "
              f"tier {pct([r[3] for r in sel])}; app "
              f"{pct([r[4] for r in sel])}")
    print(f"tier: {TIER_STEPS} steps of {TIER_B} in {wall:.1f} s "
          f"({out['throughput']:.1f} samples/s with the publishes and "
          f"waits); two models' host init {t_init:.1f} s; the ranker "
          f"released {freed / 1e9:.2f} GB to the tier; app ready "
          f"{t_ready:.1f} s after its start; the tier bitwise the trainer "
          f"slot by slot at every version, the engine bitwise at "
          f"{TIER_REQ_ROWS} rows, the app's answers "
          f"{'bitwise' if all(app_exact) else 'within 1e-5 but not bitwise'}"
          f" at {len(app_exact)} versions; torn delta rejected by both; "
          f"launches {launches}")
    del server, engine
    return trainer, dcfg, ckdir, launches


def serve_pool(engine, pool, passes=TIER_PASSES, clients=TIER_CLIENTS):
    """``pool`` (requests of TIER_REQ_ROWS rows) once one at a time, each
    its own batch at one bucket (the answers the paths are held to
    bitwise: a batch of other rows runs other GEMM shapes), then
    ``passes`` timed passes from ``clients`` threads, each answer within
    1e-5 of the request's own. Returns (the scores of each request alone,
    the timed passes' predictions, requests/s, latencies, the cache's
    counts after the first pass)."""
    alone = {}
    for i, feats in enumerate(pool):
        p = engine.predict(feats, timeout=120)
        check(not p.degraded, f"tier: request {i} degraded")
        alone[i] = p.scores
    first = (dict(engine._cache.stats()) if engine._cache is not None
             else None)
    preds, lat, errors = [], [], []
    lock = threading.Lock()

    def run(c):
        try:
            for i in range(c, len(pool), clients):
                p = engine.predict(pool[i], timeout=120)
                with lock:
                    lat.append(p.latency_ms)
                    preds.append((i, p))
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(repr(e))

    t0 = time.perf_counter()
    for _ in range(passes):
        threads = [threading.Thread(target=run, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(not errors and not any(t.is_alive() for t in threads),
              f"tier: requests failed: {errors[:3]}")
    wall = time.perf_counter() - t0
    for i, p in preds:
        check(not p.degraded and np.allclose(p.scores, alone[i], rtol=1e-5,
                                             atol=1e-6),
              f"tier: request {i} in a shared batch is not within 1e-5 of "
              f"its answer alone")
    return alone, preds, passes * len(pool) / wall, sorted(lat), first


def fetch_split(model, sset, feats, reps=20):
    """One request's shard-tier gather cut into its steps, as the engine's
    ``_shard_gather`` runs them on a cache miss: the flat ids and their
    unique set, the fetch (its shards' locked lookups, and the routing and
    copying around them), the assembly of the bags, the copy to the
    card. Median ms over ``reps``."""
    (op,) = model._host_resident_list
    idx = np.asarray(feats["sparse"], np.int64).reshape(
        (-1,) + tuple(op.inputs[0].shape[1:]))
    parts = {k: [] for k in ("plan", "fetch", "lookups", "assemble", "h2d")}
    for _ in range(reps):
        t0 = time.perf_counter()
        g3 = op.host_flat_indices(idx)
        u, inv = np.unique(g3, return_inverse=True)
        t1 = time.perf_counter()
        res = sset.fetch({op.name: u})
        t2 = time.perf_counter()
        owners = tier_mod.row_owners(u, sset._flat_rows[op.name],
                                     sset.nshards)
        t_look = 0.0
        for rep in sset.shards:
            ids = u[owners == rep.slot]
            ta = time.perf_counter()
            rep.shard.lookup({op.name: ids})
            t_look += time.perf_counter() - ta
        t3 = time.perf_counter()
        rows = op.host_lookup_rows(res.rows[op.name],
                                   inv.reshape(g3.shape).astype(np.int64))
        t4 = time.perf_counter()
        if torch.from_numpy(np.ascontiguousarray(rows)).to(TIER_DEV).is_cuda:
            torch.cuda.synchronize()
        t5 = time.perf_counter()
        for k, v in (("plan", t1 - t0), ("fetch", t2 - t1),
                     ("lookups", t_look), ("assemble", t4 - t3),
                     ("h2d", t5 - t4)):
            parts[k].append(1e3 * v)
    med = {k: float(np.median(v)) for k, v in parts.items()}
    return med, int(u.size)


def tier_read_paths(trainer, dcfg, ckdir, work):
    """(2) The read path: the same TIER_POOL requests of TIER_REQ_ROWS
    rows through (a) the plain host gather, (b) ``--serve-cache-rows
    TIER_CACHE`` pre-warmed from the trainer's ``id_histogram.npz`` and
    (c) a TIER_SHARDS-shard tier (its warm cache in ``work``) plus the row
    cache, each one request at a time (the scores BITWISE equal across
    the three), then TIER_PASSES passes from TIER_CLIENTS threads (timed).
    Returns (the tier, its engine, the pool, the pool's scores)."""
    pool = [synthetic_batch(dcfg, TIER_REQ_ROWS, seed=SEED + 100 + i)[0]
            for i in range(TIER_POOL)]
    results = {}
    engines = {
        "host gather": ServeConfig(max_batch=256),
        f"row cache {TIER_CACHE}, pre-warmed": ServeConfig(
            max_batch=256, cache_rows=TIER_CACHE, cache_warm=str(ckdir)),
    }
    for what, scfg in engines.items():
        eng = InferenceEngine(trainer, scfg)
        with eng:
            warm = len(eng._cache) if eng._cache is not None else 0
            results[what] = serve_pool(eng, pool) + (warm,
                                                     eng.stats())
    sset = EmbeddingShardSet.build(
        trainer, TIER_SHARDS,
        config=ShardTierConfig(nshards=TIER_SHARDS,
                               lookup_deadline_ms=TIER_DEADLINE_MS,
                               cooldown_s=0.2, replace_after=2),
        cache_dir=str(work / "shardcache"))
    eng = InferenceEngine(trainer, ServeConfig(max_batch=256,
                                               cache_rows=TIER_CACHE),
                          shard_set=sset).start()
    what = f"{TIER_SHARDS} shards + row cache"
    results[what] = serve_pool(eng, pool) + (0, eng.stats())
    ref = results["host gather"][0]
    for name, (scores, preds, rate, lat, first, warm, st) in results.items():
        check(all(np.array_equal(scores[i], ref[i]) for i in ref),
              f"tier: the {name} path's scores are not bitwise the host "
              f"gather's")
        cache = st.get("embedding_cache")
        hits = ""
        if cache is not None:
            first_rate = first["hits"] / max(first["hits"]
                                             + first["misses"], 1)
            hits = (f"; cache: {warm} entries pre-warmed, hit rate "
                    f"{first_rate:.4f} on the first pass (one request at "
                    f"a time), {cache['hit_rate']:.4f} over all "
                    f"{TIER_PASSES + 1}")
        print(f"tier: read path ({name}): {TIER_POOL} requests of "
              f"{TIER_REQ_ROWS} rows, bitwise one at a time, then "
              f"{TIER_PASSES} passes from "
              f"{TIER_CLIENTS} threads: {rate:.1f} req/s, p50 "
              f"{percentile(lat, 50):.3f} ms, p99 "
              f"{percentile(lat, 99):.3f} ms, batch fill "
              f"{st['batch_fill']:.3f}{hits}")
    split, uniq = fetch_split(trainer, sset, pool[0])
    print(f"tier: one {TIER_REQ_ROWS}-row request's tier gather "
          f"({uniq} unique rows over {TIER_SHARDS} shards), median ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f" (fetch less its lookups: {split['fetch'] - split['lookups']:.4f}"
          f" routing, copies and deadline bookkeeping); the tier's own "
          f"fetch p50 {sset.stats()['fetch_p50_ms']:.4f} ms, p99 "
          f"{sset.stats()['fetch_p99_ms']:.4f} ms; all three paths' scores "
          f"bitwise equal")
    return sset, eng, pool, ref


def tier_outage(trainer, dcfg, sset, eng):
    """(3) Degradation and replace-dead: FF_FAULT_SHARD_DOWN on slot 1
    under TIER_CLIENTS threads of new requests (cache misses). A publish
    lands while the slot is ejected; then the set's health thread probes
    it, replaces it from the shard warm cache, the replacement replays
    the publish from the set's history and is admitted by its probe.
    Zero requests fail; degraded answers are flagged (slot 1 absent from
    their version vector) and counted; after the recovery every request
    of the outage is answered BITWISE the trainer's forward with the same
    publish applied (nothing degraded was cached). Returns the publish's
    payload and version."""
    from dlrm_flexflow_tpu_torch.utils import faults
    name, flat = tier_flat(trainer)
    pool = [synthetic_batch(dcfg, TIER_REQ_ROWS, seed=SEED + 300 + i)[0]
            for i in range(TIER_OUTAGE_POOL)]
    got, errors = [], []
    stop = threading.Event()
    lock = threading.Lock()

    def client(c):
        k = c
        while not stop.is_set():
            i = k % len(pool)
            try:
                p = eng.predict(pool[i], timeout=120)
                with lock:
                    got.append((time.perf_counter(), i, p))
            except Exception as e:   # noqa: BLE001 — reported below
                errors.append(repr(e))
                return
            k += TIER_CLIENTS

    rng = np.random.RandomState(SEED + 301)
    rows = np.unique(np.concatenate([
        rng.randint(lo, hi, 256) for lo, hi in sset._ranges[name][:2]]))
    version = sset.version + 1
    payload = {"step": version, "full": {}, "rows": {
        f"hostparams/{name}/kernel": (rows.astype(np.int64),
                                      flat[rows] + np.float32(0.25))}}
    degraded0 = eng.stats()["degraded_responses"]
    plan = faults.FaultPlan()
    plan.shard_down[1] = -1
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(TIER_CLIENTS)]
    faults.install(plan)
    try:
        t_down = time.perf_counter()
        for t in threads:
            t.start()
        wait_for(lambda: sset.shards[1].state == "ejected",
                 "slot 1's ejection", 120)
        t_ej = time.perf_counter()
        eng.install_delta(payload, version)
        check(sset.shards[1].shard.version < version
              and sset.lagging_slots() == [] and sset.min_version() == version,
              f"tier: the ejected slot took the publish: "
              f"{sset.version_vector()}")
        sset.start_health(0.05)
        wait_for(lambda: all(r.state == "healthy" for r in sset.shards),
                 "the replacement's admission", 120)
        t_back = time.perf_counter()
        n_back = len(got)
        wait_for(lambda: len(got) >= n_back + 4 * TIER_CLIENTS,
                 "answers after the recovery", 120)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        faults.clear()
        sset.stop_health()
    check(not errors and not any(t.is_alive() for t in threads),
          f"tier: requests failed under the outage: {errors[:3]}")
    deg = [p for _, _, p in got if p.degraded]
    # the requests queued before the admission (one a client at most)
    # are answered first: the batcher serves in order
    late = [p for _, _, p in got[n_back + 2 * TIER_CLIENTS:]]
    st = eng.stats()
    check(deg and all(1 not in p.versions for p in deg)
          and st["degraded_responses"] - degraded0 == len(deg),
          f"tier: {len(deg)} degraded answers, engine counted "
          f"{st['degraded_responses'] - degraded0}")
    bad = [(p.degraded, p.versions) for p in late
           if p.degraded or not at_version(p.versions, version)]
    check(not bad, f"tier: {len(bad)} of {len(late)} answers after the "
          f"recovery degraded or stale: {bad[:3]}")
    slot1 = next(r for r in sset.shards if r.slot == 1)
    sc = sset.stats()["shard_cache"]
    check(sset.replacements == 1 and slot1.sid != 1
          and slot1.shard.version == version and sc["hits"] >= 1
          and sset.replace_rejects == 0,
          f"tier: the replacement: {sset.replacements} replacements, slot 1 "
          f"sid {slot1.sid} at version {slot1.shard.version}, shard cache "
          f"{sc}, last reject {sset.last_replace_reject!r}")
    # the reference: the trainer's own tables with the same publish
    trainer.apply_delta(payload)
    check_tier_blocks(sset, trainer, "after the replace-dead catch-up")
    for i, feats in enumerate(pool):
        p = eng.predict(feats, timeout=120)
        want = trainer.forward_bucket(feats, TIER_REQ_ROWS).cpu().numpy()
        check(not p.degraded and np.array_equal(p.scores, want),
              f"tier: outage request {i} after the recovery is not bitwise "
              f"the trainer's (a degraded answer was cached?)")
    print(f"tier: FF_FAULT_SHARD_DOWN on slot 1 under {TIER_CLIENTS} "
          f"threads: {len(got)} answers, 0 failed, {len(deg)} degraded "
          f"(flagged, counted, slot 1 absent from their version vectors); "
          f"ejected {t_ej - t_down:.3f} s after the fault, healthy again "
          f"{t_back - t_ej:.3f} s after the ejection (a publish of "
          f"{rows.size} rows landed meanwhile; the replacement booted from "
          f"the shard warm cache at version {version - 1} and replayed it "
          f"from the history; probes {slot1.probes}); every outage request "
          f"bitwise the trainer's afterwards")
    return payload, version


def tier_cascade(trainer, dcfg, sset, eng):
    """(4) The cascade riding the tier: the two-tower heads sized to the
    ranker's inputs and the 1,396-item index attached to the same
    TIER_SHARDS shards, as the app's ``_build_cascade`` builds it with
    ``--serve-shards``. One publish carries ranking rows and
    ``augment_delta``'s re-encoded item rows through the engine; the
    top-k kernel on every shard's rewritten block is held BITWISE to its
    plain version, the bag at the towers' shapes BITWISE to its plain
    version (bag 1: a row copy). Then the main path, counted from 0:
    TIER_CASCADE users from TIER_CLIENTS threads. Returns the counts."""
    tcfg = two_tower_config(dcfg)

    def head(name, batch):
        m = FFModel(FFConfig(batch_size=batch, seed=SEED, device=TIER_DEV))
        build_two_tower(m, tcfg, head=name)
        m.compile()
        m.init_layers()
        return m

    user, item = head("user", FFConfig().batch_size), head("item", 2048)
    transfer_tower_params(user, item)
    items = item_embeddings(item, tcfg)
    index = ShardedMIPSIndex.build(sset, items)
    check(index.table.q.is_cuda and all(
        r.shard._blocks[index.op_name].q.is_cuda for r in sset.shards),
        "tier: the index does not lie on the card")
    ub = user.config.batch_size

    def encode(feats):
        dense = np.asarray(feats["dense"], np.float32)
        sparse = np.asarray(feats["sparse"], np.int64)
        n = dense.shape[0]
        d = np.concatenate([dense, np.zeros((ub - n,) + dense.shape[1:],
                                            np.float32)])
        s = np.concatenate([sparse, np.zeros((ub - n,) + sparse.shape[1:],
                                             np.int64)])
        return user.forward_batch({"user_dense": d,
                                   "user_sparse": s})[:n]

    # one publish, both stages: ranking rows and re-encoded item rows
    name, flat = tier_flat(trainer)
    rng = np.random.RandomState(SEED + 400)
    ids = np.unique(rng.randint(0, tcfg.n_items, 400))
    rows = np.unique(rng.randint(0, flat.shape[0], 512))
    new = items[torch.as_tensor(ids, device=TIER_DEV)].cpu().numpy() * 1.5
    version = sset.version + 1
    payload = {"step": version, "full": {}, "rows": {
        f"hostparams/{name}/kernel": (rows.astype(np.int64),
                                      flat[rows] - np.float32(0.125))}}
    index.augment_delta(payload, ids, new)
    eng.install_delta(payload, version)
    trainer.apply_delta({"step": version, "full": {}, "rows": {
        k: v for k, v in payload["rows"].items() if name in k}})
    check(sset.version_vector() == {s: version for s in range(TIER_SHARDS)},
          f"tier: the publish did not advance every shard: "
          f"{sset.version_vector()}")
    users = synthetic_batch(dcfg, TOPK_B, seed=SEED + 401)[0]
    qc, qs = topk_mod.quantize_query(encode(users))
    for rep in sset.shards:
        blk = rep.shard.blocks_copy()[0][index.op_name]
        lo, _ = rep.shard.owned_range(index.op_name)
        got_s, got_i = topk_mod.mips_topk(qc, qs, blk.q, blk.scales, K,
                                          base=lo)
        want_s, want_i = topk_mod.mips_topk_reference(qc, qs, blk.q,
                                                      blk.scales, K, base=lo)
        check(torch.equal(got_i, want_i) and torch.equal(
            got_s.view(torch.int32), want_s.view(torch.int32)),
            f"tier: the top-k kernel disagrees with its plain version on "
            f"slot {rep.slot}'s rewritten block")
    one, _ = synthetic_batch(dcfg, 1, seed=SEED + 402)
    uid = torch.zeros((ub, len(tcfg.user_embedding_size)), dtype=torch.int64,
                      device=TIER_DEV)
    uid[0] = torch.as_tensor(one["sparse"][0, :, 0])
    bags = [("item head", item.params["item_emb"]["kernel"],
             torch.arange(tcfg.n_items, device=TIER_DEV)[:, None])]
    for t, r in enumerate(tcfg.user_embedding_size):
        bags.append((f"user table {t}", user.params[f"user_emb_{t}"]["kernel"],
                     torch.remainder(uid[:, t:t + 1], r)))
    for what, tab, bid in bags:
        check(torch.equal(bag_mod.embedding_bag(tab, bid, "sum"),
                          bag_mod.embedding_bag_reference(tab, bid, "sum")),
              f"tier: the bag kernel disagrees with its plain version on "
              f"the {what}")
    del item, bags
    cascade = CascadeEngine(
        index, encode, eng,
        dlrm_candidate_features(len(dcfg.embedding_size),
                                list(dcfg.embedding_size)),
        CascadeConfig(k=K, retrieve_deadline_ms=1000.0))
    data = synthetic_batch(dcfg, TIER_CASCADE, seed=SEED + 403)[0]
    reqs = [{k: v[i:i + 1] for k, v in data.items()}
            for i in range(TIER_CASCADE)]
    for feats in reqs[:4]:
        cascade.predict(feats)           # warmup
    results, errors = {}, []
    lookups0 = sum(r.shard.lookups for r in sset.shards)
    zero_counts()
    with PlainCalls() as plain:
        def client(c):
            try:
                for i in range(c, len(reqs), TIER_CLIENTS):
                    results[i] = cascade.predict(reqs[i])
            except Exception as e:   # noqa: BLE001 — reported below
                errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(TIER_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
    launches = read_counts()
    calls = sum(r.shard.lookups for r in sset.shards) - lookups0
    check(not errors and len(results) == len(reqs),
          f"tier: cascade requests failed: {errors[:3]}")
    bad = [(p.degraded, p.retrieve_versions, p.rank_versions)
           for p in results.values() if p.degraded
           or p.retrieve_versions != {s: version
                                      for s in range(TIER_SHARDS)}
           or not at_version(p.rank_versions, version)]
    check(not bad, f"tier: {len(bad)} cascade answers degraded or read "
          f"another version than {version}: {bad[:2]}")
    check(plain.calls == 0
          and launches["mips_topk"] == TIER_SHARDS * len(reqs)
          and launches["embedding_bag"] > 0 and calls >= launches["mips_topk"],
          f"tier: cascade launches {launches}, {calls} shard calls, plain "
          f"calls {plain.calls}")
    for i in range(0, len(reqs), 8):
        p = results[i]
        s, sid = index.exact_scan(encode(reqs[i]), K)
        o = np.lexsort((p.ids[0], -p.retrieve_scores[0]))
        check(np.array_equal(p.ids[0][o], sid[0]),
              f"tier: cascade request {i}'s retrieval differs from "
              f"exact_scan after the publish")
    lat = sorted(p.latency_ms for p in results.values())
    print(f"tier: cascade riding the {TIER_SHARDS}-shard tier "
          f"({tcfg.n_items} items, k={K}): one publish moved "
          f"{rows.size} ranking rows and {ids.size} item rows to version "
          f"{version}; the top-k kernel bitwise its plain version on every "
          f"shard's rewritten block ({TOPK_B} queries), the bag bitwise on "
          f"the item head and the {len(tcfg.user_embedding_size)} user "
          f"tables; {len(reqs)} users from {TIER_CLIENTS} threads in "
          f"{wall:.3f} s ({len(reqs) / wall:.1f} req/s), p50 "
          f"{percentile(lat, 50):.3f} ms, p99 {percentile(lat, 99):.3f} ms; "
          f"retrieval bitwise exact_scan; launches {launches}")
    del user, cascade, index
    return launches


def tier_app_cascade(dcfg, work):
    """The app with ``--retrieve on --serve-shards 4 --host-tables``:
    /predict of two users answers candidates from the index riding the
    app's own tier, with its version vector, none degraded; exit 0."""
    app = AppProcess(app_flags(dcfg, [
        "-b", "256", "--seed", str(SEED), "--host-tables",
        "--serve-shards", str(TIER_SHARDS), "--retrieve", "on",
        "--retrieve-k", str(K), "--retrieve-deadline-ms", "5000",
        "--serve-max-batch", "256"]), work / "tier_retrieve_app.log")
    try:
        t_ready = app.wait_ready()
        users = synthetic_batch(dcfg, 2, seed=SEED + 41)[0]
        body = {k: v.tolist() for k, v in users.items()}
        code, out = app.call("/predict", body)
        check(code == 200 and np.asarray(out["candidates"]).shape == (2, K)
              and not out["degraded"]
              and out["retrieve_versions"]
              == {str(s): 0 for s in range(TIER_SHARDS)}
              and at_version(out["versions"], 0),
              f"tier app: /predict {code} {str(out)[:300]}")
        code, st = app.call("/stats")
        check(code == 200 and st["shard_set"]["topk_queries"] >= 1,
              f"tier app: /stats {str(st)[:300]}")
    finally:
        rc = app.stop()
    check(rc == 0, f"tier app: exited {rc}: "
          f"{Path(app.log).read_text()[-2000:]}")
    print(f"tier: the app with --retrieve on --serve-shards {TIER_SHARDS} "
          f"--host-tables ready {t_ready:.1f} s after its start; /predict "
          f"of 2 users: {K} candidates each from the index riding its tier, "
          f"version vector {out['versions']}; exit 0")


def shard_tier_phase(fleet=None, loop_only=False):
    """Phase 11, parts (1)-(4) in run order, in WORK_DIR (removed at the end whatever
    happens); with ``fleet`` (phase 12's figures) the loop also drives
    phase 12 (a); ``loop_only`` stops after the loop. Returns the launch
    counts of its main paths: the loop's trainer and the cascade."""
    import os
    from dlrm_flexflow_tpu_torch.utils import faults
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    WORK_DIR.mkdir(parents=True)
    apps = []
    gc.collect()
    print(f"shard tier phase: host memory at its start: "
          f"{host_headroom()[1]}")
    t0 = time.perf_counter()
    try:
        trainer, dcfg, ckdir, counts = _tier_loop(WORK_DIR, apps, fleet)
        if loop_only:
            return counts
        sset, eng, _pool, _ref = tier_read_paths(trainer, dcfg, ckdir,
                                                 WORK_DIR)
        try:
            tier_outage(trainer, dcfg, sset, eng)
            add_counts(counts, tier_cascade(trainer, dcfg, sset, eng))
        finally:
            eng.close()
            sset.close()
        tier_app_cascade(dcfg, WORK_DIR)
        print(f"shard tier phase: {time.perf_counter() - t0:.1f} s")
        return counts
    finally:
        os.environ.pop("FF_FAULT_DELTA_TORN", None)
        faults.clear()
        for app in apps:
            app.kill()
        shutil.rmtree(WORK_DIR, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------
# phase 12: serving across processes (the wire, shard processes, the
# replica fleet with its router and autoscaler, ranker processes)
# ---------------------------------------------------------------------
def fleet_tier_config():
    """The tcp tier's knobs: the app's deadline of phase 11, and retries
    enough that a dropped frame costs a retry, never an answer (each
    WireClient retries too: a drop of p = FLEET_DROP loses a lookup with
    p^((1 + FLEET_RETRIES)^2))."""
    return ShardTierConfig(nshards=FLEET_SHARDS,
                           lookup_deadline_ms=TIER_DEADLINE_MS,
                           retries=FLEET_RETRIES, cooldown_s=0.2,
                           replace_after=2)


def cuda_pids():
    """The pids that hold a CUDA context on the card (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout
    return {int(p) for p in out.split() if p.strip().isdigit()}


class TcpReaders:
    """Phase 12 (a)'s publish followers, driven by phase 11's loop: a
    ranker (the loop's server model's seed) seeds the shard warm cache,
    FLEET_SHARDS ``serve.shard_server`` processes boot from it (all
    started at once), the engine on the card reaches them through
    ``EmbeddingShardSet.connect`` and follows the trainer's publishes
    (full ones travel as block installs over the wire, deltas as
    per-shard slices), and the app runs with ``--serve-transport tcp
    --serve-shard-procs FLEET_SHARDS --compile-cache-dir``."""

    def __init__(self, work, dcfg, ckdir, apps):
        from dlrm_flexflow_tpu_torch.examples.native.serve_dlrm import \
            ShardProcs
        self.cache = work / "fleet_cache"
        self.procs = ShardProcs()
        self.ranker, _ = tier_model(256, SEED + 1)
        t0 = time.perf_counter()
        EmbeddingShardSet.seed_shard_cache(self.ranker, FLEET_SHARDS,
                                           str(self.cache))
        t1 = time.perf_counter()
        addrs = self.procs.spawn(str(self.cache), FLEET_SHARDS)
        t2 = time.perf_counter()
        self.sset = EmbeddingShardSet.connect(addrs,
                                              config=fleet_tier_config(),
                                              cache_dir=str(self.cache))
        EmbeddingShardSet.release_ranker_tables(self.ranker)
        self.engine = InferenceEngine(
            self.ranker, ServeConfig(max_batch=256, poll_s=0.05),
            checkpoint_dir=str(ckdir), shard_set=self.sset)
        self.app = AppProcess(app_flags(dcfg, [
            "-b", "256", "--seed", str(SEED + 2), "--host-tables",
            "--serve-transport", "tcp",
            "--serve-shard-procs", str(FLEET_SHARDS),
            "--serve-lookup-deadline-ms", str(TIER_DEADLINE_MS),
            "--compile-cache-dir", str(work / "fleet_app_cache"),
            "--checkpoint-dir", str(ckdir), "--serve-poll", "0.05",
            "--serve-max-batch", "256"]), work / "fleet_app.log")
        apps.append(self.app)
        self.seed_s, self.boot_s = t1 - t0, t2 - t1
        held = cuda_pids() & {p.pid for p in self.procs.procs}
        check(not held, f"fleet: shard processes {sorted(held)} hold a "
              f"CUDA context")
        self.exact = []

    def close(self):
        try:
            self.engine.close()
            self.sset.close()
        finally:
            self.procs.stop()


def check_remote_blocks(sset, model, what, chunk=1 << 20):
    """Every shard process's block BITWISE the model's rows it owns, read
    back over the wire in chunks of ``chunk`` rows, the slots at once."""
    from concurrent.futures import ThreadPoolExecutor
    from dlrm_flexflow_tpu_torch.serve import wire
    name, flat = tier_flat(model)

    def slot(rep):
        lo, hi = sset._ranges[name][rep.slot]
        for a in range(lo, hi, chunk):
            ids = np.arange(a, min(a + chunk, hi), dtype=np.int64)
            _op, data = rep.shard.transport.request(
                wire.OP_LOOKUP, wire.encode_lookup_request({name: ids}),
                deadline_s=120)
            out, _ver = wire.decode_lookup_response(data)
            if not np.array_equal(out[name], flat[a:a + ids.size]):
                return a
        return None

    with ThreadPoolExecutor(len(sset.shards)) as ex:
        bad = list(ex.map(slot, sset.shards))
    check(all(b is None for b in bad), f"fleet: {what}: shard process "
          f"rows differ from the trainer's at {bad}")


def tcp_follow(tcp, k, torn, trainer, q, q_body, want, rejects):
    """At one publish of phase 11's loop: the tcp readers reach version
    ``k`` (or reject the torn delta with its reason), every shard
    process's block is the trainer's, the engine's scores are BITWISE the
    trainer's, the app's within 1e-5."""
    def app_stats():
        return tcp.app.call("/stats")[1]

    if torn:
        wait_for(lambda: tcp.engine.stats()["reload_rejects"]
                 > rejects["tcp_engine"], "the tcp engine's reject")
        wait_for(lambda: app_stats()["reload_rejects"] > rejects["tcp_app"],
                 "the tcp app's reject")
        for who, s in (("tcp engine", tcp.engine.stats()),
                       ("tcp app", app_stats())):
            check("fails its CRC-32" in s["last_reload_reject"]
                  and s["version"] == k - TIER_EVERY,
                  f"fleet: the {who} did not reject the torn delta with "
                  f"its reason: {s['last_reload_reject']!r}")
        check(tcp.sset.version_vector() == {s: k - TIER_EVERY
                                            for s in range(FLEET_SHARDS)},
              f"fleet: the shard processes moved on a torn delta: "
              f"{tcp.sset.version_vector()}")
        return
    wait_for(lambda: tcp.engine.version == k and tcp.sset.min_version() == k,
             f"the tcp tier at version {k}")
    wait_for(lambda: app_stats()["version"] == k, f"the tcp app at {k}")
    check_remote_blocks(tcp.sset, trainer, f"version {k}")
    got = tcp.engine.predict(q, timeout=120)
    check(got.version == k and not got.degraded
          and at_version(got.versions, k)
          and np.array_equal(got.scores, want),
          f"fleet: the engine over shard processes at version {k} is not "
          f"bitwise the trainer (versions {got.versions})")
    code, out = tcp.app.call("/predict", q_body)
    agot = np.asarray(out["scores"], np.float32) if code == 200 else None
    check(code == 200 and out["version"] == k and not out["degraded"]
          and at_version(out["versions"], k)
          and np.allclose(agot, want.reshape(-1), rtol=1e-5, atol=1e-6),
          f"fleet: the tcp app at version {k} answered {code} "
          f"{str(out)[:300]}")
    tcp.exact.append(bool(np.array_equal(agot, want.reshape(-1))))


def client_pool(fn, pool, passes=2, clients=FLEET_CLIENTS):
    """``passes`` passes of ``pool`` from ``clients`` threads through
    ``fn`` (a predict); returns (answers by request, requests/s, sorted
    client-observed latencies in ms, errors)."""
    answers, lat, errors = {}, [], []
    lock = threading.Lock()

    def run(c):
        for i in range(c, len(pool), clients):
            t = time.perf_counter()
            try:
                p = fn(pool[i])
            except Exception as e:   # noqa: BLE001 — reported by callers
                errors.append(repr(e))
                return
            with lock:
                lat.append(1e3 * (time.perf_counter() - t))
                answers.setdefault(i, []).append(p)

    t0 = time.perf_counter()
    for _ in range(passes):
        threads = [threading.Thread(target=run, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    wall = time.perf_counter() - t0
    return answers, passes * len(pool) / wall, sorted(lat), errors


def rate_line(what, rate, lat):
    return (f"{what}: {rate:.1f} req/s, client p50 "
            f"{percentile(lat, 50):.3f} ms, p99 {percentile(lat, 99):.3f} ms")


def within(answers, alone, what):
    """Every answer of a shared batch within 1e-5 of its request alone."""
    for i, ps in answers.items():
        for p in ps:
            check(not getattr(p, "degraded", False)
                  and np.allclose(p.scores, alone[i], rtol=1e-5, atol=1e-6),
                  f"fleet: {what}: request {i} in a shared batch is not "
                  f"within 1e-5 of its answer alone")


def tcp_after_loop(tcp, trainer, dcfg, engine, figures):
    """Phase 12 (a) after phase 11's loop, everything at its last
    version: FLEET_POOL requests of TIER_REQ_ROWS rows, each alone
    BITWISE through the shard processes and through phase 11's
    in-process tier, then timed from FLEET_CLIENTS threads through both;
    a shard process ``kill -9``ed under traffic (degraded, 0 failed,
    the slot replaced from the warm cache and re-admitted); and, on a
    fresh set of shard processes, FF_FAULT_NET_DROP, DUP and SLOW in
    this process and FF_FAULT_NET_REORDER in the shard processes on the
    lookup seam, each answer BITWISE the trainer's."""
    import signal
    from dlrm_flexflow_tpu_torch.serve import transport as tp
    from dlrm_flexflow_tpu_torch.utils import faults
    t_start = time.perf_counter()
    # nothing is published any more: the watchers stop (each poll reads
    # the newest full snapshot's 0.73 GB for its checksum, which would
    # share the host with the timed windows)
    for eng in (engine, tcp.engine):
        if eng._watcher is not None:
            eng._watcher.stop()
    pool = [synthetic_batch(dcfg, TIER_REQ_ROWS, seed=SEED + 500 + i)[0]
            for i in range(FLEET_POOL)]
    alone = {}
    for i, feats in enumerate(pool):
        a = tcp.engine.predict(feats, timeout=120)
        b = engine.predict(feats, timeout=120)
        check(not a.degraded and a.versions == b.versions
              and np.array_equal(a.scores, b.scores),
              f"fleet: request {i} over the shard processes is not bitwise "
              f"the in-process tier's")
        alone[i] = b.scores
    for what, eng in (("in-process tier", engine),
                      ("shard processes", tcp.engine)):
        ans, rate, lat, errors = client_pool(
            lambda f, e=eng: e.predict(f, timeout=120), pool)
        check(not errors, f"fleet: {what}: requests failed: {errors[:3]}")
        within(ans, alone, what)
        figures[what] = (rate, lat)
        print("fleet: " + rate_line(f"{FLEET_POOL} requests of "
                                    f"{TIER_REQ_ROWS} rows x 2 from "
                                    f"{FLEET_CLIENTS} threads, {what}",
                                    rate, lat))
    figures["lookup rtt floor"] = tp.measured_rtt_floor("lookup")
    # kill -9 of slot 1's process under traffic
    sset = tcp.sset
    got, errors = [], []
    stop = threading.Event()

    def client(c):
        k = c
        while not stop.is_set():
            try:
                got.append((time.perf_counter(),
                            tcp.engine.predict(pool[k % len(pool)],
                                               timeout=120)))
            except Exception as e:   # noqa: BLE001 — reported below
                errors.append(repr(e))
                return
            k += FLEET_CLIENTS

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(FLEET_CLIENTS)]
    for t in threads:
        t.start()
    try:
        wait_for(lambda: len(got) >= 2 * FLEET_CLIENTS, "traffic", 120)
        sset.start_health(0.05)
        victim = tcp.procs.procs[1]
        t_kill = time.perf_counter()
        victim.send_signal(signal.SIGKILL)
        victim.wait(60)
        wait_for(lambda: sset.shards[1].state == "ejected",
                 "the dead shard's ejection", 120)
        t_ej = time.perf_counter()
        wait_for(lambda: all(r.state == "healthy" for r in sset.shards),
                 "the replaced slot's admission", 120)
        t_back = time.perf_counter()
        n_back = len(got)
        wait_for(lambda: len(got) >= n_back + 4 * FLEET_CLIENTS,
                 "answers after the recovery", 120)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        sset.stop_health()
    check(not errors, f"fleet: requests failed while a shard process was "
          f"dead: {errors[:3]}")
    deg = [p for _, p in got if p.degraded]
    late = [p for _, p in got[n_back + 2 * FLEET_CLIENTS:]]
    check(deg and all(1 not in p.versions for p in deg)
          and not any(p.degraded for p in late),
          f"fleet: {len(deg)} degraded answers under the kill, "
          f"{sum(p.degraded for p in late)} after the recovery")
    slot1 = next(r for r in sset.shards if r.slot == 1)
    check(sset.replacements == 1 and not getattr(slot1.shard, "remote",
                                                  False)
          and sset.stats()["shard_cache"]["hits"] >= 1,
          f"fleet: slot 1 was not replaced from the warm cache: "
          f"{sset.replacements} replacements, last reject "
          f"{sset.last_replace_reject!r}")
    for i in range(0, FLEET_POOL, 8):
        p = tcp.engine.predict(pool[i], timeout=120)
        check(not p.degraded and np.array_equal(p.scores, alone[i]),
              f"fleet: request {i} after the replacement is not bitwise")
    figures["shard eject s"] = t_ej - t_kill
    figures["shard readmit s"] = t_back - t_ej
    print(f"fleet: kill -9 of shard process 1 under {FLEET_CLIENTS} "
          f"threads: {len(got)} answers, 0 failed, {len(deg)} degraded "
          f"(flagged, slot 1 absent from their version vectors); ejected "
          f"{t_ej - t_kill:.3f} s after the kill, the slot replaced from "
          f"the warm cache (an in-process shard) and re-admitted "
          f"{t_back - t_ej:.3f} s after the ejection; answers bitwise "
          f"again")
    # the network faults on the lookup seam, on a fresh set of shard
    # processes (the reorder is injected inside them, at their boot)
    tcp.engine.close()
    tcp.sset.close()
    drill = type(tcp.procs)()
    try:
        addrs = drill.spawn(str(tcp.cache), FLEET_SHARDS, env={
            "FF_FAULT_NET_REORDER": f"lookup:{FLEET_REORDER}"})
        dset = EmbeddingShardSet.connect(addrs, config=fleet_tier_config(),
                                         cache_dir=str(tcp.cache))
        check(at_version(dset.version_vector(), trainer._step),
              f"fleet: the drill's shard processes booted at "
              f"{dset.version_vector()}, not the trainer's "
              f"{trainer._step}")
        deng = InferenceEngine(tcp.ranker, ServeConfig(max_batch=256),
                               shard_set=dset).start()
        tp.reset_wire_stats()
        plans = (("drop", faults.FaultPlan(net_drop={"lookup": FLEET_DROP})),
                 ("dup", faults.FaultPlan(net_dup={"lookup": FLEET_DUP})),
                 ("slow", faults.FaultPlan(net_slow_ms={"lookup":
                                                        FLEET_SLOW_MS})),
                 ("reorder", None))
        try:
            for what, plan in plans:
                faults.install(plan)
                try:
                    for i in range(FLEET_DRILL):
                        feats = pool[i]
                        p = deng.predict(feats, timeout=120)
                        check(not p.degraded
                              and np.array_equal(p.scores, alone[i]),
                              f"fleet: under FF_FAULT_NET_{what.upper()} "
                              f"request {i} is degraded or not bitwise")
                finally:
                    faults.clear()
            st = tp.wire_stats()["lookup"]
            # what the shard processes counted: frames held, duplicates
            # answered from their dedup windows
            reorders = dedup = 0
            from dlrm_flexflow_tpu_torch.serve import wire
            for rep in dset.shards:
                _op, data = rep.shard.transport.request(
                    wire.OP_STATS, wire.encode_payload({}))
                meta, _ = wire.decode_payload(data)
                reorders += meta["wire"]["lookup"].get("reorders", 0)
                dedup += meta["wire"]["lookup"].get("dedup_hits", 0)
        finally:
            deng.close()
            dset.close()
    finally:
        drill.stop()
    # every process holds at least its first frame (the connect probe)
    check(st.get("drops", 0) >= 1 and st.get("dups", 0) == FLEET_DUP
          and dedup == FLEET_DUP and st.get("retries", 0)
          >= st.get("drops", 0) and FLEET_SHARDS <= reorders
          <= FLEET_SHARDS * FLEET_REORDER,
          f"fleet: the network faults did not all fire: client {st}, "
          f"server-side reorders {reorders}, dedup hits {dedup}")
    print(f"fleet: network faults on the lookup seam, {FLEET_DRILL} "
          f"requests each, all bitwise and none degraded: drop p "
          f"{FLEET_DROP} ({st['drops']} frames dropped, {st['retries']} "
          f"retries), dup {FLEET_DUP} ({dedup} answered by the servers' "
          f"dedup windows), slow {FLEET_SLOW_MS} ms a frame, reorder "
          f"{FLEET_REORDER} a process ({reorders} frames held server-side); "
          f"(a) after the loop {time.perf_counter() - t_start:.1f} s")


def fleet_model():
    """Criteo-Kaggle with its tables on the card, the unfused "dot", the
    seed SEED: every replica the same model."""
    m, _dcfg = kaggle_model("dot", "sgd")
    m.init_layers()
    return m


def _gate(engine):
    """Wedge ``engine``'s batcher on an Event (a parked ``run_quiesced``
    call); returns the Event that opens it."""
    entered, release = threading.Event(), threading.Event()
    threading.Thread(target=engine.run_quiesced, args=(
        lambda: entered.set() or release.wait(120),), daemon=True).start()
    check(entered.wait(60), "fleet: the gate did not close")
    return release


def fleet_batches(router):
    return sum(r.engine.stats()["batches"] for r in router.fleet)


def fleet_inproc(work, figures):
    """Phase 12 (b): FLEET_REPLICAS replicas of Kaggle with device tables
    behind a FleetRouter on the card. Returns its windows' launch counts
    and the answers of one engine to the pool (part (c) is held to
    them)."""
    from dlrm_flexflow_tpu_torch.serve import (Fleet, FleetRouter,
                                               RouterConfig)
    from dlrm_flexflow_tpu_torch.serve import transport as tp
    from dlrm_flexflow_tpu_torch.utils import faults
    t_start = time.perf_counter()
    dcfg = DLRMConfig.criteo_kaggle()
    dcfg.arch_interaction_op = "dot"
    pool = [synthetic_batch(dcfg, TIER_REQ_ROWS, seed=SEED + 600 + i)[0]
            for i in range(FLEET_POOL)]
    scfg = ServeConfig(max_batch=256, queue_capacity=4096)
    ref = InferenceEngine(fleet_model(), scfg).start()
    router = FleetRouter(
        Fleet.build(lambda i: fleet_model(), FLEET_REPLICAS, scfg),
        RouterConfig(retries=3, backoff_ms=2.0, eject_after=3,
                     cooldown_s=0.2, probe_deadline_s=30.0,
                     health_interval_s=0.05, canary_fraction=0.5,
                     canary_min_samples=16,
                     canary_score_tol=FLEET_SCORE_TOL,
                     canary_p99_ratio=1e9)).start()
    launches = {}
    try:
        alone = {}
        for i, feats in enumerate(pool):
            want = ref.predict(feats, timeout=120).scores
            got = router.predict(feats, timeout=120)
            check(np.array_equal(got.scores, want),
                  f"fleet: request {i} through the router is not bitwise "
                  f"one engine's")
            alone[i] = want
        per = [r.engine.stats()["requests"] for r in router.fleet]
        check(min(per) > 0, f"fleet: a replica took no request: {per}")
        # the main path, counted from 0: the router from 4 threads
        b0 = fleet_batches(router)
        zero_counts()
        with PlainCalls() as plain:
            ans, rate3, lat3, errors = client_pool(
                lambda f: router.predict(f, timeout=120), pool)
        counts = read_counts()
        batches = fleet_batches(router) - b0
        check(not errors, f"fleet: requests failed: {errors[:3]}")
        within(ans, alone, "the router")
        check(plain.calls == 0 and counts["embedding_bag"] == batches
              and counts["fused_interaction"] == 0,
              f"fleet: launches {counts} for {batches} dispatched batches, "
              f"plain calls {plain.calls}")
        add_counts(launches, counts)
        print(f"fleet: {FLEET_REPLICAS} replicas: {FLEET_POOL} requests "
              f"each alone bitwise one engine's, split {per}; "
              f"{2 * FLEET_POOL} from {FLEET_CLIENTS} threads in "
              f"{batches} batches, embedding_bag launched {batches} times, "
              f"no plain version")
        figures[f"{FLEET_REPLICAS} replicas"] = (rate3, lat3)
        # the hedge: replica 0 wedged, one request at a time
        router.config.hedge_ms = FLEET_HEDGE_MS
        release = _gate(router.fleet.get(0).engine)
        try:
            for i in range(FLEET_REPLICAS + 1):
                p = router.predict(pool[i], timeout=120)
                check(np.array_equal(p.scores, alone[i]),
                      f"fleet: hedged request {i} is not bitwise")
                if router.stats()["hedge_wins"]:
                    break
        finally:
            release.set()
            router.config.hedge_ms = 0.0
        st = router.stats()
        check(st["hedges"] >= 1 and st["hedge_wins"] >= 1,
              f"fleet: the hedge did not run: {st['hedges']} hedges, "
              f"{st['hedge_wins']} won")
        # FF_FAULT_REPLICA_DOWN under traffic: eject, then re-admit
        rep = router.fleet.get(1)
        ej0, ra0 = rep.ejections, rep.readmissions
        stop, errors, n_ok = threading.Event(), [], [0]

        def client(c):
            k = c
            while not stop.is_set():
                try:
                    p = router.predict(pool[k % len(pool)], timeout=120)
                    check(np.allclose(p.scores, alone[k % len(pool)],
                                      rtol=1e-5, atol=1e-6), "scores")
                    n_ok[0] += 1
                except Exception as e:   # noqa: BLE001 — reported below
                    errors.append(repr(e))
                    return
                k += FLEET_CLIENTS

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(FLEET_CLIENTS)]
        for t in threads:
            t.start()
        try:
            wait_for(lambda: n_ok[0] >= 8, "traffic", 120)
            faults.install(faults.FaultPlan(
                replica_down={1: FLEET_DOWN_BUDGET}))
            t_down = time.perf_counter()
            wait_for(lambda: rep.ejections > ej0, "replica 1's ejection",
                     120)
            t_ej = time.perf_counter()
            wait_for(lambda: rep.readmissions > ra0 and rep.state ==
                     "healthy", "replica 1's re-admission", 120)
            t_back = time.perf_counter()
            n_back = n_ok[0]
            wait_for(lambda: n_ok[0] >= n_back + 8, "traffic after", 120)
        finally:
            stop.set()
            for t in threads:
                t.join(120)
            faults.clear()
        check(not errors and router.stats()["failed"] == 0,
              f"fleet: requests failed under FF_FAULT_REPLICA_DOWN: "
              f"{errors[:3]}")
        figures["replica eject s"] = t_ej - t_down
        figures["replica readmit s"] = t_back - t_ej
        print(f"fleet: the hedge answered a request wedged on replica 0 "
              f"({st['hedges']} hedges, {st['hedge_wins']} won); "
              f"FF_FAULT_REPLICA_DOWN=1:{FLEET_DOWN_BUDGET} under "
              f"{FLEET_CLIENTS} threads: {n_ok[0]} answers, 0 failed, "
              f"replica 1 ejected {t_ej - t_down:.3f} s after the fault, "
              f"re-admitted {t_back - t_ej:.3f} s after the ejection")
        add_counts(launches, fleet_cascade(dcfg, router, ref))
        fleet_deploys(work, router, ref, pool, alone)
        # one replica, timed as the three were: the bare engine, then
        # behind a router of its own (the router's cost and the batching
        # it leaves a replica, apart from replicas sharing the card)
        windows = {f"{FLEET_REPLICAS} replicas": batches}
        b0 = ref.stats()["batches"]
        ans, rate1, lat1, errors = client_pool(
            lambda f: ref.predict(f, timeout=120), pool)
        check(not errors, f"fleet: one engine: {errors[:3]}")
        within(ans, alone, "one engine")
        figures["1 replica"] = (rate1, lat1)
        windows["1 replica"] = ref.stats()["batches"] - b0
        one = FleetRouter(Fleet.build(lambda i: fleet_model(), 1, scfg),
                          RouterConfig(retries=3, backoff_ms=2.0)).start()
        try:
            for i, feats in enumerate(pool):
                check(np.array_equal(one.predict(feats, timeout=120).scores,
                                     alone[i]),
                      f"fleet: request {i} through a 1-replica router is "
                      f"not bitwise one engine's")
            b0 = fleet_batches(one)
            ans, rate, lat, errors = client_pool(
                lambda f: one.predict(f, timeout=120), pool)
            windows["1 replica, router"] = fleet_batches(one) - b0
        finally:
            one.close()
        check(not errors, f"fleet: a 1-replica router: {errors[:3]}")
        within(ans, alone, "a 1-replica router")
        figures["1 replica, router"] = (rate, lat)
        for what in ("1 replica", "1 replica, router",
                     f"{FLEET_REPLICAS} replicas"):
            rate, lat = figures[what]
            print("fleet: " + rate_line(f"{FLEET_POOL} requests of "
                                        f"{TIER_REQ_ROWS} rows x 2 from "
                                        f"{FLEET_CLIENTS} threads, {what}",
                                        rate, lat)
                  + f", {windows[what]} dispatched batches")
    finally:
        router.close()
    fleet_autoscale(scfg, pool, figures)
    figures["dispatch rtt floor"] = tp.measured_rtt_floor("dispatch")
    print(f"fleet: (b) {time.perf_counter() - t_start:.1f} s")
    return launches, ref, pool, alone


def fleet_cascade(dcfg, router, ref):
    """``--retrieve on`` in front of the fleet: the two-tower heads sized
    to Kaggle's inputs and an item index on one standalone shard on the
    card, as the app's ``_build_cascade`` builds them; users answered
    through the router BITWISE as through one engine; then the main path
    counted: FLEET_CASCADE users from FLEET_CLIENTS threads, mips_topk
    once a user, embedding_bag the ranker's dispatched batches plus the
    user head's bags, no plain version. Returns the counts."""
    tcfg = two_tower_config(dcfg)

    def head(name, batch):
        m = FFModel(FFConfig(batch_size=batch, seed=SEED))
        build_two_tower(m, tcfg, head=name)
        m.compile()
        m.init_layers()
        return m

    user, item = head("user", FFConfig().batch_size), head("item", 2048)
    transfer_tower_params(user, item)
    index = ShardedMIPSIndex.build(ShardedMIPSIndex.standalone_set(1),
                                   item_embeddings(item, tcfg))
    del item
    ub = user.config.batch_size

    def encode(feats):
        dense = np.asarray(feats["dense"], np.float32)
        sparse = np.asarray(feats["sparse"], np.int64)
        n = dense.shape[0]
        d = np.concatenate([dense, np.zeros((ub - n,) + dense.shape[1:],
                                            np.float32)])
        s = np.concatenate([sparse, np.zeros((ub - n,) + sparse.shape[1:],
                                             np.int64)])
        return user.forward_batch({"user_dense": d,
                                   "user_sparse": s})[:n]

    feats_fn = dlrm_candidate_features(len(dcfg.embedding_size),
                                       list(dcfg.embedding_size))
    ccfg = CascadeConfig(k=K, retrieve_deadline_ms=1000.0)
    fleet_c = CascadeEngine(index, encode, router, feats_fn, ccfg)
    one_c = CascadeEngine(index, encode, ref, feats_fn, ccfg)
    data = synthetic_batch(dcfg, FLEET_CASCADE, seed=SEED + 700)[0]
    reqs = [{k: v[i:i + 1] for k, v in data.items()}
            for i in range(FLEET_CASCADE)]
    for i, feats in enumerate(reqs[:8]):
        a, b = fleet_c.predict(feats), one_c.predict(feats)
        check(np.array_equal(a.ids, b.ids) and np.array_equal(a.scores,
                                                              b.scores)
              and not a.degraded,
              f"fleet: cascade user {i} through the fleet is not bitwise "
              f"through one engine")
    zero_counts()
    encode(reqs[0])
    per_user = read_counts()["embedding_bag"]
    b0 = fleet_batches(router)
    results, errors = {}, []
    zero_counts()
    with PlainCalls() as plain:
        def client(c):
            try:
                for i in range(c, len(reqs), FLEET_CLIENTS):
                    results[i] = fleet_c.predict(reqs[i])
            except Exception as e:   # noqa: BLE001 — reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(FLEET_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    counts = read_counts()
    batches = fleet_batches(router) - b0
    check(not errors and len(results) == len(reqs)
          and not any(p.degraded for p in results.values()),
          f"fleet: cascade requests failed or degraded: {errors[:3]}")
    check(plain.calls == 0 and counts["mips_topk"] == len(reqs)
          and counts["embedding_bag"] == batches + per_user * len(reqs),
          f"fleet: cascade launches {counts} for {batches} ranker batches "
          f"and {len(reqs)} users ({per_user} bags a user), plain calls "
          f"{plain.calls}")
    print(f"fleet: --retrieve on in front of {FLEET_REPLICAS} replicas: 8 "
          f"users bitwise the cascade in front of one engine; "
          f"{len(reqs)} users from {FLEET_CLIENTS} threads: mips_topk "
          f"{counts['mips_topk']}, embedding_bag {counts['embedding_bag']} "
          f"({batches} ranker batches + {per_user} a user), no plain "
          f"version")
    return counts


def fleet_deploys(work, router, ref, pool, alone):
    """Shadow, a poisoned canary and a good one, from one snapshot: a
    replica's model after one SGD step at batch TRAIN_B."""
    from dlrm_flexflow_tpu_torch.utils import faults
    from dlrm_flexflow_tpu_torch.utils.checkpoint import save_checkpoint
    trained, dcfg = kaggle_model("dot", "sgd")
    trained.init_layers()
    x, y = synthetic_batch(dcfg, TRAIN_B, seed=SEED + 800)
    trained.train_batch({**x, "label": y})
    path = str(work / "fleet_snapshot.npz")
    save_checkpoint(trained, path)
    want = {i: trained.forward_bucket(pool[i], TIER_REQ_ROWS).cpu().numpy()
            for i in range(8)}
    del trained
    # shadow: clients answered by the stable replicas, bitwise
    rid = router.start_shadow(path)
    for i in range(16):
        p = router.predict(pool[i % 8], timeout=120)
        check(np.array_equal(p.scores, alone[i % 8]),
              f"fleet: a client saw the shadow's answer (request {i})")
    wait_for(lambda: router.shadow_report()["n"] >= 8 * TIER_REQ_ROWS,
             "the shadow's comparisons", 120)
    report = router.stop_shadow()
    check(report["mean_abs_diff"] > 0 and report["errors"] == 0
          and np.array_equal(router.fleet.get(rid).engine.predict(
              pool[0], timeout=120).scores, alone[0]),
          f"fleet: shadow report {report}")
    # a poisoned canary rolls back with 0 failed requests
    faults.install(faults.FaultPlan(poison_reloads=1))
    try:
        ids = router.start_canary(path)
    finally:
        faults.clear()
    t0 = time.perf_counter()
    failed0 = router.stats()["failed"]
    i = 0
    while router.stats()["canary"]["active"]:
        check(time.perf_counter() - t0 < 120, "fleet: no rollback")
        router.predict(pool[i % len(pool)], timeout=120)
        i += 1
    st = router.stats()
    check(st["canary"]["rollbacks"] == 1 and st["failed"] == failed0
          and "score divergence" in st["canary"]["last_rollback_reason"]
          and np.array_equal(router.fleet.get(ids[0]).engine.predict(
              pool[0], timeout=120).scores, alone[0]),
          f"fleet: the poisoned canary: {st['canary']}")
    t_rb = time.perf_counter() - t0
    # a good canary is promoted on every replica
    router.start_canary(path)
    for j in range(16):
        router.predict(pool[j % 8], timeout=120)
    router.promote_canary()
    st = router.stats()
    check(st["canary"]["promotions"] == 1 and not st["canary"]["active"]
          and st["failed"] == failed0, f"fleet: promotion {st['canary']}")
    for rep in router.fleet:
        for j in range(0, 8, 3):
            p = rep.engine.predict(pool[j], timeout=120)
            check(rep.cohort == "stable" and p.version == 1
                  and np.array_equal(p.scores, want[j]),
                  f"fleet: replica {rep.rid} after the promotion is not "
                  f"bitwise the snapshot's model")
    print(f"fleet: shadow on replica {rid}: {report['n']} scores compared "
          f"(mean |diff| {report['mean_abs_diff']:.3g}), no client saw "
          f"one; a poisoned canary on replica {ids[0]} rolled back after "
          f"{i} requests ({t_rb:.3f} s), 0 failed; a good canary promoted "
          f"on all {FLEET_REPLICAS}, bitwise the snapshot's model")


def fleet_autoscale(scfg, pool, figures):
    """The autoscaler grows a 1-replica fleet to 2 under a forced SLO
    breach (an SLO of FLEET_SLO_MS, which every request misses) and
    shrinks it back when idle (the SLO raised), with 0 failed
    requests. The grow time: from the autoscaler's start (the breach is
    there from the first request) to the new replica's admission; it
    holds the sustain periods, the model's build and warmup, and the
    probe."""
    from dlrm_flexflow_tpu_torch.serve import (AutoscaleConfig, Autoscaler,
                                               Fleet, FleetRouter,
                                               RouterConfig)
    router = FleetRouter(Fleet.build(lambda i: fleet_model(), 1, scfg),
                         RouterConfig(retries=3, cooldown_s=0.2,
                                      health_interval_s=0.05)).start()
    scaler = Autoscaler(router, AutoscaleConfig(
        slo_ms=FLEET_SLO_MS, min_replicas=1, max_replicas=2,
        interval_s=0.05, sustain=2, idle_sustain=4, cooldown_s=0.2))
    stop, errors = threading.Event(), []

    def client():
        k = 0
        while not stop.is_set():
            try:
                router.predict(pool[k % len(pool)], timeout=120)
            except Exception as e:   # noqa: BLE001 — reported below
                errors.append(repr(e))
                return
            k += 1

    t = threading.Thread(target=client)
    t.start()
    try:
        wait_for(lambda: router.stats()["p99_ms"] is not None,
                 "a first answer", 120)
        t_on = time.time()
        scaler.start()
        wait_for(lambda: len(router.fleet) == 2
                 and len(router.fleet.healthy()) == 2,
                 "the grown replica's admission", 300)
        t_ok = time.time()
        d = scaler.stats()["decisions"][0]
        scaler.config.slo_ms = 1e9        # the breach is over: idle
        wait_for(lambda: len(router.fleet) == 1, "the shrink", 120)
    finally:
        stop.set()
        t.join(120)
        scaler.close()
        router.close()
    st = scaler.stats()
    check(not errors and st["grows"] == 1 and st["shrinks"] == 1
          and d["action"] == "grow", f"fleet: autoscaler {st}, errors "
          f"{errors[:3]}")
    figures["grow s"] = t_ok - t_on
    print(f"fleet: the autoscaler grew 1 -> 2 replicas on a forced SLO "
          f"breach ({d['reason']}): the decision {d['t'] - t_on:.3f} s "
          f"after its start (the new replica built and warmed), the "
          f"admission {t_ok - t_on:.3f} s after it; shrank back to 1 when "
          f"idle; 0 failed")


class RankerEngine(InferenceEngine):
    """Part (c)'s ranker: its ``stats()``, which ``EngineServer`` answers
    over the wire, carry this process's kernel launch counts and the
    calls of the plain versions (``plain`` counts them for the
    process's whole life)."""

    def __init__(self, model, config, plain):
        super().__init__(model, config)
        self.plain = plain

    def stats(self):
        return dict(super().stats(), kernels=read_counts(),
                    plain_calls=self.plain.calls)


def ranker_child():
    """``chip_smoke.py --ranker-child``: one ranker replica as a process,
    the Kaggle ranker of part (b) on the card behind the engine's wire
    server. Prints ``RANKER_OK port=P`` once it listens; runs until
    killed."""
    plain = PlainCalls().__enter__()
    engine = RankerEngine(fleet_model(),
                          ServeConfig(max_batch=256, queue_capacity=4096),
                          plain).start()
    server = engine.serve(port=0)
    print(f"RANKER_OK port={server.address[1]}", flush=True)
    server.serve_forever()


class RankerChildren:
    """RANKER_CHILDREN ``chip_smoke.py --ranker-child`` processes, started
    at once through the app's ``ShardProcs``; ``addrs`` holds their
    addresses once each printed its port, ``stop`` kills them."""

    def __init__(self, work):
        import os
        from dlrm_flexflow_tpu_torch.examples.native.serve_dlrm import \
            ShardProcs
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("FF_FAULT_")}
        env["PYTHONPATH"] = str(REPO)
        work.mkdir(parents=True, exist_ok=True)
        self.log = open(work / "rankers.log", "w")
        self.children = ShardProcs()
        self.procs = self.children.procs
        t0 = time.perf_counter()
        try:
            self.addrs = self.children.start(
                [[sys.executable, str(REPO / "chip_smoke.py"),
                  "--ranker-child"]] * RANKER_CHILDREN,
                "RANKER_OK", "ranker process", env, stderr=self.log,
                boot_s=600)
        except SystemExit as e:
            self.stop()
            check(False, f"fleet: {e}: "
                  f"{Path(self.log.name).read_text()[-2000:]}")
        self.ready_s = time.perf_counter() - t0

    def stop(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        self.children.stop()
        self.log.close()


def fleet_procs(children, pool, alone, figures):
    """Phase 12 (c): the ranker processes behind ``Fleet.connect`` and a
    router: each request alone BITWISE part (b)'s engine, timed from
    FLEET_CLIENTS threads, then one process ``kill -9``ed under traffic
    with 0 failed requests. Returns the timed window's launch counts in
    the processes."""
    import signal
    from dlrm_flexflow_tpu_torch.serve import Fleet, FleetRouter, RouterConfig
    from dlrm_flexflow_tpu_torch.serve import transport as tp
    t_start = time.perf_counter()
    router = FleetRouter(Fleet.connect(children.addrs, deadline_s=120.0),
                         RouterConfig(retries=3, backoff_ms=2.0,
                                      eject_after=2, cooldown_s=1.0,
                                      health_interval_s=0.05)).start()
    try:
        for i, feats in enumerate(pool):
            p = router.predict(feats, timeout=120)
            check(np.array_equal(p.scores, alone[i]),
                  f"fleet: request {i} through the ranker processes is "
                  f"not bitwise part (b)'s engine")
        # the window counted in the children, from their stats over the
        # wire: launches and batches read before and after it
        k0, p0, b0 = child_counts(router)
        ans, rate, lat, errors = client_pool(
            lambda f: router.predict(f, timeout=120), pool)
        k1, p1, b1 = child_counts(router)
        check(not errors, f"fleet: ranker processes: {errors[:3]}")
        within(ans, alone, "the ranker processes")
        counts = {k: v - k0.get(k, 0) for k, v in k1.items()}
        batches = b1 - b0
        check(p1 == p0 and batches > 0
              and counts["embedding_bag"] == batches
              and counts["fused_interaction"] == 0,
              f"fleet: ranker processes launched {counts} for {batches} "
              f"dispatched batches, plain calls {p1 - p0}")
        print(f"fleet: the ranker processes' window: embedding_bag "
              f"launched {batches} times for {batches} dispatched batches, "
              f"no plain version")
        figures[f"{RANKER_CHILDREN} ranker processes"] = (rate, lat)
        print("fleet: " + rate_line(
            f"{FLEET_POOL} requests of {TIER_REQ_ROWS} rows x 2 from "
            f"{FLEET_CLIENTS} threads, {RANKER_CHILDREN} ranker processes",
            rate, lat))
        figures["dispatch rtt floor"] = tp.measured_rtt_floor("dispatch")
        stop, errors, n_ok = threading.Event(), [], [0]

        def client(c):
            k = c
            while not stop.is_set():
                try:
                    router.predict(pool[k % len(pool)], timeout=120)
                    n_ok[0] += 1
                except Exception as e:   # noqa: BLE001 — reported below
                    errors.append(repr(e))
                    return
                k += FLEET_CLIENTS

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(FLEET_CLIENTS)]
        for t in threads:
            t.start()
        rep = router.fleet.get(1)
        try:
            wait_for(lambda: n_ok[0] >= 8, "traffic", 120)
            t_kill = time.perf_counter()
            children.procs[1].send_signal(signal.SIGKILL)
            children.procs[1].wait(60)
            wait_for(lambda: rep.state != "healthy", "the ejection", 120)
            t_ej = time.perf_counter()
            n_at = n_ok[0]
            wait_for(lambda: n_ok[0] >= n_at + 16, "traffic after", 120)
        finally:
            stop.set()
            for t in threads:
                t.join(120)
        st = router.stats()
        check(not errors and st["failed"] == 0,
              f"fleet: requests failed when a ranker process died: "
              f"{errors[:3]}")
        figures["ranker process eject s"] = t_ej - t_kill
        print(f"fleet: {RANKER_CHILDREN} ranker processes ready "
              f"{children.ready_s:.1f} s after their start; kill -9 of one "
              f"under "
              f"{FLEET_CLIENTS} threads: {n_ok[0]} answers, 0 failed "
              f"({st['retries']} retries), ejected {t_ej - t_kill:.3f} s "
              f"after the kill; (c) {time.perf_counter() - t_start:.1f} s")
    finally:
        router.close()
    return counts


def child_counts(router):
    """Kernel launches ({wrapper: n}), plain-version calls and dispatched
    batches summed over the ranker processes, each read from its
    ``stats()`` over the wire."""
    kernels, plain, batches = {}, 0, 0
    for r in router.fleet:
        st = r.engine.stats()
        check("unreachable" not in st,
              f"fleet: ranker {r.rid}'s stats: {st.get('unreachable')}")
        add_counts(kernels, st["kernels"])
        plain += st["plain_calls"]
        batches += st["batches"]
    return kernels, plain, batches


def fleet_figures(figures):
    """Phase 12's figures on one line of JSON."""
    out = {}
    for k, v in figures.items():
        if isinstance(v, tuple):
            rate, lat = v
            out[k] = {"req_s": round(rate, 1),
                      "p50_ms": round(percentile(lat, 50), 3),
                      "p99_ms": round(percentile(lat, 99), 3)}
        else:
            out[k] = None if v is None else round(v, 4)
    print(json.dumps({"fleet": out}))


def fleet_phase(figures):
    """Phase 12 (b) and (c) in WORK_DIR (part (a) rides phase 11's loop).
    The ranker processes of (c) boot first, alone: a boot beside (b)
    would share the host's cores with its timed windows. Returns the
    launch counts of (b)'s and (c)'s windows."""
    import os
    from dlrm_flexflow_tpu_torch.utils import faults
    t0 = time.perf_counter()
    work = WORK_DIR / "fleet"
    work.mkdir(parents=True, exist_ok=True)
    gc.collect()
    children = RankerChildren(work)
    try:
        counts, ref, pool, alone = fleet_inproc(work, figures)
        ref.close()
        add_counts(counts, fleet_procs(children, pool, alone, figures))
        fleet_figures(figures)
        print(f"fleet phase (b) and (c): {time.perf_counter() - t0:.1f} s")
        return counts
    finally:
        os.environ.pop("FF_FAULT_NET_REORDER", None)
        faults.clear()
        children.stop()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


def window_kernel(dev, gen):
    """Kernel 4 at a rank's shape: a 4M-row block (4 of the 8 tables of
    1M rows), rank 1's window [4M, 8M) of the stacked ids, 8,192 lookups
    (a global batch of 2,048 on its 4 tables, bag 1): held bitwise to its
    plain version on the CPU, with the ranks' ids and again with a fifth
    of them pads and a fifth outside the window, and timed beside its
    plain version on the card and ``index_add_`` after a masked select."""
    tl, n = T // DIST_WORLD, DIST_B * (T // DIST_WORLD) * BAG
    lo, rows = tl * ROWS, tl * ROWS
    block = 0.5 * torch.randn(rows, D, device=dev, generator=gen)
    src = "dlrm_flexflow_tpu_torch/csrc/scatter_rows.cu"
    pallas = "dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py"
    sets = []
    for _ in range(ID_SETS):
        ids = lo + torch.randint(0, ROWS, (DIST_B, tl, BAG), device=dev,
                                 generator=gen) \
            + (torch.arange(tl, device=dev) * ROWS)[None, :, None]
        upd = torch.randn(n, D, device=dev, generator=gen)
        sets.append((ids.reshape(-1), upd))
    ids, upd = sets[0]
    mixed = ids.clone()
    pick = torch.rand(n, device=dev, generator=gen)
    mixed[pick < 0.2] = -1                              # pads
    mixed[(pick >= 0.2) & (pick < 0.4)] -= lo           # the block before
    block_cpu = block.cpu()
    errs = []
    for what, i in (("the ranks' ids", ids), ("pads and ids outside the "
                                              "window", mixed)):
        got = scat_mod.sharded_scatter_add_rows(block.clone(), i, upd, lo,
                                                scale=-LR)
        want = scat_mod.sharded_scatter_add_rows_reference(
            block_cpu.clone(), i.cpu(), upd.cpu(), lo, scale=-LR)
        got = got.cpu()
        errs.append(float((got - want).abs().max()))
        check(torch.equal(got, want),
              f"sharded_scatter_add_rows kernel disagrees with its plain "
              f"version ({what}): {errs[-1]}")
        local = i[(i >= lo) & (i < lo + rows)] - lo
        changed = (got != block_cpu).any(dim=1).nonzero().reshape(-1)
        check(set(changed.tolist()) <= set(local.cpu().tolist()),
              f"sharded_scatter_add_rows changed rows no id names ({what})")
        del got, want
    m = int(torch.unique(ids).numel())
    b_ms, b_by = bound(n * 8 + n * D * 4 + 2 * m * D * 4, 2 * n * D)
    scaled = [(i, -LR * u) for i, u in sets]

    def library(i, scaled_upd):
        keep = (i >= lo) & (i < lo + rows)
        block.index_add_(0, i[keep] - lo, scaled_upd[keep])

    r = {"name": "sharded_scatter_add_rows", "route": "cuda", "source": src,
         "replaces": f"{pallas}:584", "max_abs_err": max(errs),
         "bound_ms": b_ms, "bound_by": b_by,
         **timed("", lambda i, u: scat_mod.sharded_scatter_add_rows(
             block, i, u, lo, scale=-LR), sets),
         **timed("plain_", lambda i, u:
                 scat_mod.sharded_scatter_add_rows_reference(
                     block, i, u, lo, scale=-LR), sets),
         **timed("library_", library, scaled)}
    print_row(r, f" (n={n} on a {rows:,}-row block, {m} distinct rows; "
              f"bitwise its plain version with the ranks' ids and with pads "
              f"and ids outside the window; library: index_add_ after a "
              f"masked select)")
    split = traced_split(lambda i, u: scat_mod.sharded_scatter_add_rows(
        block, i, u, lo, scale=-LR), sets)
    pre = timed("", lambda i: scat_mod.scatter_presort(i, lo, rows),
                [(i,) for i, _ in sets])
    lib = timed("", lambda i: torch.sort(i, stable=True),
                [((i - lo).to(torch.int32),) for i, _ in sets])
    print(f"kernel sharded_scatter_add_rows at n={n}: kernel launches a "
          f"call, traced: {split}; the pre-pass alone {pre['ms']:.4f} ms "
          f"(call {pre['call_ms']:.4f} ms), torch.sort of the int32 "
          f"window rows {lib['ms']:.4f} ms (call {lib['call_ms']:.4f} ms)")
    del block, sets, scaled
    return {"sharded_scatter_add_rows": r}


def _dist_models(strategy):
    """The full-width "cat" model split over the process group's ranks
    under ``strategy`` ("dlrm_strategy", or the ``.pb`` loaded as
    ``--import`` loads it), and the same model on a mesh of this rank
    alone (a world of 1): both from one seed, batch DIST_B, plain SGD."""
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel import distributed
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.parallel.strategy_io import load_strategies
    out = []
    for mesh in (make_mesh(), make_mesh(devices=[distributed.rank()])):
        cfg = train_config("cat")
        model = FFModel(FFConfig(batch_size=DIST_B, seed=SEED,
                                 device="cuda:0"))
        build_dlrm(model, cfg)
        strat = (dlrm_strategy(model, cfg, mesh.size)
                 if strategy == "dlrm_strategy"
                 else load_strategies(str(REPO / strategy)))
        model.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"],
                      mesh=mesh, strategies=strat)
        model.init_layers()
        out.append(model)
    return out


def _timed_steps(model, batches, after_first=None):
    """Each step's loss, and the wall ms of the steps after the first,
    each ended by a synchronisation; ``after_first()`` runs between the
    first step and the second, outside the clock."""
    losses, ms = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(float(model.train_batch(b)["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0 and after_first is not None:
            after_first()
    return losses, ms[1:]


def _worst(got, want):
    """max |got - want| over max |want| (0 for equal tensors)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _dist_params(split, alone):
    """{name: (the split model's tensor, the world-1 model's)}: each MLP
    parameter, and the split model's tables beside this rank's slots of
    the world-1 model's."""
    op = split.get_layer_by_name("emb_stack")
    order = torch.tensor(op._table_order or tuple(range(T)))
    mine = order[op.local_slots().start:op.local_slots().stop]
    out = {"tables": (split.params["emb_stack"]["kernel"],
                      alone.params["emb_stack"]["kernel"][
                          mine.to(split.device)])}
    for name in sorted(split.params):
        if name != "emb_stack":
            for pn in sorted(split.params[name]):
                out[f"{name}.{pn}"] = (split.params[name][pn],
                                       alone.params[name][pn])
    return out


class BiasProbe:
    """The first step's bias gradient of every ``Linear`` of ``model``, as
    the dense update receives it (across ranks: all-reduced), beside an
    fp64 sum of the per-sample cotangents of the layer's pre-activation
    output over the whole global batch (across ranks: gathered from
    every rank). While installed, each Linear runs its own ``apply``'s
    operations with a hook on the pre-activation sum; the update is
    wrapped to read the gradients it is handed."""

    def __init__(self, model):
        from dlrm_flexflow_tpu_torch.ops.linear import Linear
        self.model = model
        self.ops = [op for op in model.ops
                    if isinstance(op, Linear) and op.use_bias]
        self.dz, self.grads, self.batch_dz = {}, None, {}

    def _apply(self, op):
        from dlrm_flexflow_tpu_torch.ops.common import apply_activation

        def apply(params, xs):
            (x,) = xs
            cdt = op.model.compute_dtype
            z = torch.matmul(x.to(cdt).float(),
                             params["kernel"].to(cdt).float()) \
                + params["bias"]
            if z.requires_grad and op.name not in self.dz:
                z.register_hook(lambda g: self.dz.setdefault(
                    op.name, g.detach().clone()))
            return [apply_activation(z, op.activation).to(x.dtype)]
        return apply

    def __enter__(self):
        opt = self.model.optimizer
        real = opt.update

        def update(params, grads, state, ok=None):
            if self.grads is None:
                self.grads = {n: g["bias"].detach().clone()
                              for n, g in grads.items() if "bias" in g}
            return real(params, grads, state, ok)

        opt.update = update
        for op in self.ops:
            op.apply = self._apply(op)
        return self

    def __exit__(self, *exc):
        del self.model.optimizer.update
        for op in self.ops:
            del op.apply

    def errors(self):
        """{layer: max |bias gradient - fp64 sum| / max |fp64 sum|}."""
        out = {}
        for op in self.ops:
            dz = self.dz[op.name].cpu()
            if self.model._dist() is not None:
                parts = [torch.empty_like(dz)
                         for _ in range(torch.distributed.get_world_size())]
                torch.distributed.all_gather(parts, dz)
                dz = torch.cat(parts)
            self.batch_dz[op.name] = dz
            want = dz.double().sum(0)
            got = self.grads[op.name].cpu().double()
            out[op.name] = float((got - want).abs().max()
                                 / max(float(want.abs().max()), 1e-300))
        return out


def dist_rank_child(rank, world, store):
    """``chip_smoke.py --dist-rank RANK WORLD STORE``: one rank of phase
    13. Joins the gloo group through the file store, then for each
    strategy trains the split model and a world-1 model DIST_STEPS steps
    on the same global batches, counts the split model's launches, holds
    its weights to the world-1 model's, and runs the launcher with
    ``run_random.sh``'s flags. Prints ``DIST_RESULT {json}``."""
    import hashlib

    from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
    from dlrm_flexflow_tpu_torch.parallel import distributed
    distributed.initialize_distributed(
        init_method=f"file://{store}", num_processes=world,
        process_id=rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = []
    for s in range(DIST_STEPS):
        x, y = synthetic_batch(train_config("cat"), DIST_B, seed=70 + s)
        x["label"] = y
        batches.append(x)
    result = {"rank": rank, "backend": torch.distributed.get_backend(),
              "runs": {}}
    for strategy in ("dlrm_strategy", DIST_PB):
        split, alone = _dist_models(strategy)
        op = split.get_layer_by_name("emb_stack")
        # one seed: the rank's tables and MLPs start bitwise the world-1
        # model's
        init = {k: a.clone() for k, (a, _) in
                _dist_params(split, alone).items()}
        same_init = all(torch.equal(a, b) for a, b in
                        _dist_params(split, alone).values())
        probes = (BiasProbe(split), BiasProbe(alone))
        zero_counts()
        with PlainCalls() as plain, probes[0]:
            losses, ms = _timed_steps(split, batches)
        counts = read_counts()
        with probes[1]:
            losses1, ms1 = _timed_steps(alone, batches)
        bias_errs = [p.errors() for p in probes]
        # the per-sample cotangents themselves, world 2's (gathered, in
        # rank order: the global batch's) against world 1's
        bias_errs.append({k: _worst(v, probes[1].batch_dz[k])
                          for k, v in probes[0].batch_dz.items()})
        errs, updates = {}, {}
        digest = hashlib.sha256()
        for k, (a, b) in _dist_params(split, alone).items():
            errs[k] = _worst(a, b)
            updates[k] = _worst(a - init[k], b - init[k])
            if k != "tables":
                digest.update(a.cpu().numpy().tobytes())
        del init
        result["runs"][strategy] = {
            "losses": losses, "world1_losses": losses1, "step_ms": ms,
            "world1_step_ms": ms1, "errs": errs, "updates": updates,
            "same_init": same_init, "bias_errs": bias_errs,
            "mlp_sha256": digest.hexdigest(), "plain_calls": plain.calls,
            "counts": {k: v for k, v in counts.items() if v},
            "order": list(op._table_order or ()),
            "slots": list(op.local_slots()),
            "collectives": split._collectives.stats}
        del split, alone
        torch.cuda.empty_cache()
    zero_counts()
    with PlainCalls() as plain:
        out = launcher.main(DIST_LAUNCH + ["--import", str(REPO / DIST_PB)])
    result["launcher"] = {
        "steps": out["steps"], "throughput": out["throughput"],
        "plain_calls": plain.calls, "loss_finite": bool(np.isfinite(
            out["model"].perf.report()["mse"])),
        "counts": {k: v for k, v in read_counts().items() if v},
        "collectives": out["model"]._collectives.stats}
    print("DIST_RESULT " + json.dumps(result), flush=True)
    torch.distributed.destroy_process_group()


def dist_phase(dev):
    """Phase 13: the kernel at a rank's shape (``window_kernel``), then
    DIST_WORLD ``--dist-rank`` children on the card, their results held.
    Returns (the kernel's row, the children's launch counts summed)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    rows = window_kernel(dev, gen)
    torch.cuda.empty_cache()
    work = WORK_DIR / "dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        outs = run_rank_children("--dist-rank", "DIST_RESULT", work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts = {}
    for out in outs:
        check(out["backend"] == "gloo", f"ranks: backend {out['backend']}")
        for strategy, run in out["runs"].items():
            c = run["counts"]
            check(c.get("sharded_scatter_add_rows") == DIST_STEPS
                  and c.get("scatter_presort:radix") == DIST_STEPS
                  and c.get("dense_update") == DIST_STEPS
                  and run["plain_calls"] == 0
                  and not any(c.get(k) for k in SCATTERS),
                  f"ranks ({strategy}), rank {out['rank']}: launches {c}, "
                  f"{run['plain_calls']} plain calls")
            bad = {k: v for k, v in run["updates"].items()
                   if not v <= DIST_UPDATE_TOL}
            check(run["same_init"] and not bad,
                  f"ranks ({strategy}), rank {out['rank']}: start bitwise "
                  f"the world-1 run's {run['same_init']}; updates beyond "
                  f"{DIST_UPDATE_TOL} of the world-1 run's largest: {bad}")
            check(all(np.isfinite(run["losses"])) and np.allclose(
                run["losses"], run["world1_losses"], rtol=DIST_LOSS_RTOL),
                f"ranks ({strategy}): losses {run['losses']} against the "
                f"world-1 run's {run['world1_losses']}")
            add_counts(counts, c)
        lr = out["launcher"]
        c = lr["counts"]
        check(c.get("sharded_scatter_add_rows") == lr["steps"] + 1
              and c.get("dense_update") == lr["steps"] + 1
              and lr["plain_calls"] == 0 and lr["loss_finite"],
              f"ranks (launcher), rank {out['rank']}: launches {c}, "
              f"{lr['plain_calls']} plain calls, finite "
              f"{lr['loss_finite']}")
        add_counts(counts, c)
    for strategy in outs[0]["runs"]:
        runs = [out["runs"][strategy] for out in outs]
        check(len({r["mlp_sha256"] for r in runs}) == 1,
              f"ranks ({strategy}): the ranks' MLP weights differ")
        check(sorted(s for r in runs for s in r["slots"]) == list(range(T)),
              f"ranks ({strategy}): slots {[r['slots'] for r in runs]}")
        worst = max(max(r["errs"].values()) for r in runs)
        worst_update = max(max(r["updates"].values()) for r in runs)
        order = runs[0]["order"] or "as declared"
        print(f"ranks, {strategy}: table order {order}; step ms (after the "
              f"first) world {DIST_WORLD}: "
              f"{[round(v, 3) for v in runs[0]['step_ms']]} (rank 0), "
              f"{[round(v, 3) for v in runs[1]['step_ms']]} (rank 1); "
              f"world 1: {[round(v, 3) for v in runs[0]['world1_step_ms']]};"
              f" from the world-1 run's weights: each update within "
              f"{worst_update:.3g} of its parameter's largest, each weight "
              f"within {worst:.3g} of its parameter's largest (tables "
              f"{max(r['errs']['tables'] for r in runs):.3g}, their updates "
              f"{max(r['updates']['tables'] for r in runs):.3g}); losses "
              f"{runs[0]['losses']} against {runs[0]['world1_losses']}; the "
              f"ranks' MLP weights bitwise equal")
        split_b, alone_b, dz_b = runs[0]["bias_errs"]
        print(f"  first step's bias gradients against an fp64 sum of the "
              f"per-sample cotangents (max |err| / max |sum| by layer): "
              f"world {DIST_WORLD}, all-reduced, "
              f"{ {k: float(f'{v:.3g}') for k, v in split_b.items()} }; "
              f"world 1 { {k: float(f'{v:.3g}') for k, v in alone_b.items()} }"
              f"; worst {max(split_b.values()):.3g} against "
              f"{max(alone_b.values()):.3g}; the per-sample cotangents "
              f"of world {DIST_WORLD} against world 1's (max |diff| / max "
              f"|world 1's|) {_fmt(dz_b)}")
        for name, st in runs[0]["collectives"].items():
            print(f"  {name}: {st['calls']} calls, {st['bytes']:,} bytes "
                  f"sent and received by rank 0, {st['seconds']:.4f} s "
                  f"(host clock, the host copies under gloo included)")
    lr = outs[0]["launcher"]
    print(f"ranks, launcher ({' '.join(DIST_LAUNCH[:4])} --import "
          f"{DIST_PB}): {lr['steps']} steps, {lr['throughput']:.2f} "
          f"samples/s; collectives {lr['collectives']}")
    print(f"ranks phase: {time.perf_counter() - t0:.1f} s")
    return rows, counts


# ---------------------------------------------------------------------
# phase 15: row-sharded tables across ranks (parallel/alltoall.py)
# ---------------------------------------------------------------------
def rowshard_kernels(dev):
    """The exchange's owner side at a rank's shape (DIST_WORLD peers x
    8,192 received slots, a 4M-row block, d = 64; duplicate-heavy ids and
    sentinel pads): the owner's gather (the bag kernel at bag 1, the
    sentinel clamped and its row zeroed), the canonical combine (its
    segment sums on the scatter kernel), the SGD and gradient updates
    (the scatter kernel) and the stateful update (momentum, Adam), each
    held bitwise to its plain version on the CPU. Checks, not the path:
    the phase's counts are the ranks'."""
    from dlrm_flexflow_tpu_torch.parallel import alltoall as a2a
    S, n = DIST_WORLD, DIST_B // DIST_WORLD * T * BAG
    block = T * ROWS // DIST_WORLD
    g = torch.Generator(device="cpu").manual_seed(SEED + 15)
    rid, pos, upd = [], [], []
    for j in range(S):
        k = int(torch.randint(n // 2, n, (1,), generator=g))
        ids = torch.where(torch.rand(k, generator=g) < 0.5,
                          torch.randint(0, 64, (k,), generator=g),
                          torch.randint(0, block, (k,), generator=g))
        p = torch.sort(torch.randperm(n, generator=g)[:k]).values
        rid.append(torch.cat([ids, torch.full((n - k,), block)]))
        pos.append(torch.cat([j * n + p, torch.full((n - k,), 2 ** 31 - 1)]))
        upd.append(torch.cat([torch.randn(k, D, generator=g),
                              torch.zeros(n - k, D)]))
    rid, pos, upd = (torch.cat(v) for v in (rid, pos, upd))
    table = 0.5 * torch.randn(block, D, generator=g)
    valid, safe = rid < block, rid.clamp(max=block - 1)
    got = torch.where(valid.to(dev)[:, None],
                      a2a._gather_rows(table.to(dev), safe.to(dev)), 0.0)
    want = torch.where(valid[:, None], bag_mod.embedding_bag_reference(
        table, safe.reshape(-1, 1)), 0.0)
    check(torch.equal(got.cpu(), want),
          "row exchange: the owner's gather disagrees with its plain version")
    gid, gp = a2a._combine_received(rid.to(dev), pos.to(dev), upd.to(dev),
                                    n, block)
    wid, wp = a2a._combine_received(rid, pos, upd, n, block)
    check(torch.equal(gid.cpu(), wid) and torch.equal(gp.cpu(), wp),
          "row exchange: the canonical combine disagrees with its plain "
          "version")
    for what, base, scale in (("SGD", table, -LR),
                              ("gradient", torch.zeros_like(table), 1.0)):
        got = scat_mod.scatter_add_rows(base.to(dev, copy=True), gid, gp,
                                        scale,
                                        ids_in_range=True).cpu()
        want = scat_mod.scatter_add_rows_reference(base.clone(), wid, wp,
                                                   scale)
        check(torch.equal(got, want), f"row exchange: the routed {what} "
              f"update disagrees with its plain version")
        del got, want
    for name in ("momentum", "adam"):
        opt = TRAIN_OPTS[name]()
        slabs = {k: torch.rand(block, D, generator=g)
                 for k in opt.sparse_slab_names()}
        alpha_t = opt.alpha_t(torch.tensor(2, dtype=torch.int32))
        got_s = {k: v.to(dev, copy=True) for k, v in slabs.items()}
        got = scat_mod.stateful_update_rows(
            table.to(dev, copy=True), gid, gp, None, got_s, opt.row_params(),
            None if alpha_t is None else alpha_t.to(dev),
            ids_in_range=True).cpu()
        want = scat_mod.stateful_update_rows_reference(
            table.clone(), wid, wp, None, slabs, opt.row_params(), alpha_t)
        check(torch.equal(got, want) and all(
            torch.equal(got_s[k].cpu(), slabs[k]) for k in slabs),
            f"row exchange: the routed {name} update disagrees with its "
            f"plain version")
        del got, want, got_s, slabs
    print(f"row exchange at a rank's shape ({S} peers x {n} slots, "
          f"{int(valid.sum())} lookups, {int((wid >= 0).sum())} partials "
          f"on a {block:,}-row block): the owner's gather, the combine, "
          f"the SGD, gradient, momentum and Adam updates bitwise their "
          f"plain versions")


def _rs_model(opt, mesh, strategy="row", form=None):
    """The full-width "cat" model on ``mesh`` (a world of 1: this rank's
    own) under ``strategy``: "row" (``dlrm_strategy(row_shard=True)``,
    the table's config refined by ``form``) or "table" (phase 13's
    ``dlrm_strategy``); one seed, batch DIST_B."""
    import dataclasses

    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    cfg = train_config("cat")
    model = FFModel(FFConfig(batch_size=DIST_B, seed=SEED, device="cuda:0"))
    build_dlrm(model, cfg)
    strat = dlrm_strategy(model, cfg, mesh.size, row_shard=strategy == "row")
    if form:
        strat["emb_stack"] = dataclasses.replace(strat["emb_stack"], **form)
    model.compile(TRAIN_OPTS[opt](), "mean_squared_error", ["mse"],
                  mesh=mesh, strategies=strat)
    model.init_layers()
    return model


def _bit_sums(t):
    """Per table, the sum of the int32 bit patterns of ``t`` (T, rows, d)
    as int64: exact, and the same whichever ranks hold which rows."""
    return [int(t[i].view(torch.int32).to(torch.int64).sum())
            for i in range(t.shape[0])]


def _rs_digest(model, rank, batches, path):
    """What the bitwise checks of the skew forms compare, for this rank:
    each table's bit sums over the rows it holds (the replicated hot head
    counted by rank 0 only), of the weights and of every state slab, the
    MLPs' sha256, and (written to ``path``) the values of every touched
    row it holds, by logical id t * ROWS + row."""
    import hashlib
    op = model.get_layer_by_name("emb_stack")
    H, rl, s = op._hot_rows, op._row_plan.rows_local, op._row_ex.shard
    trees = {"weights": model.params["emb_stack"]}
    for k in model.optimizer.sparse_slab_names():
        trees[k] = model.opt_state[k]["emb_stack"]
    sums = {}
    for name, tree in trees.items():
        v = _bit_sums(tree["kernel"])
        if H and rank == 0:
            v = [a + b for a, b in zip(v, _bit_sums(tree["hot_kernel"]))]
        sums[name] = v
    touched = np.unique(np.concatenate(
        [(np.asarray(b["sparse"], np.int64) % ROWS
          + np.arange(T)[None, :, None] * ROWS).reshape(-1)
         for b in batches]))
    t, ix = touched // ROWS, touched % ROWS
    mine_hot = (ix < H) & (rank == 0)
    c = ix - H
    mine_cold = (ix >= H) & (c // rl == s)
    w = model.params["emb_stack"]
    vals = np.concatenate([
        w["hot_kernel"][t[mine_hot], ix[mine_hot]].cpu().numpy()
        if mine_hot.any() else np.zeros((0, D), np.float32),
        w["kernel"][t[mine_cold], c[mine_cold] % rl].cpu().numpy()])
    np.savez(path, ids=np.concatenate([touched[mine_hot],
                                       touched[mine_cold]]), vals=vals)
    digest = hashlib.sha256()
    for name in sorted(model.params):
        if name != "emb_stack":
            for pn in sorted(model.params[name]):
                digest.update(model.params[name][pn].cpu().numpy().tobytes())
    return {"bit_sums": sums, "mlp_sha256": digest.hexdigest()}


def _rs_named(tree, rows=None):
    """{name: tensor} of a {op: {param: tensor}} tree: the tables (rows
    ``rows`` of each, a slice, when given), and each MLP parameter."""
    t = tree["emb_stack"]["kernel"]
    out = {"tables": t if rows is None else t[:, rows]}
    for name in sorted(tree):
        if name != "emb_stack":
            for pn in sorted(tree[name]):
                out[f"{name}.{pn}"] = tree[name][pn]
    return out


def _rs_state(model, rows=None):
    """{"slab: name": a copy of the tensor} of the optimizer's slabs."""
    return {f"{sl}: {k}": v.clone()
            for sl in model.optimizer.sparse_slab_names()
            for k, v in _rs_named(model.opt_state[sl], rows).items()}


def _rs_vs_world1(split, alone, init, rows):
    """The split model against the world-1 model (``rows``: this rank's
    block of its tables), each over max |the world-1 model's|: (each
    weight, each update from the split model's initial weights ``init``,
    the share of values whose update is off by more than
    DIST_UPDATE_TOL of the largest)."""
    a, b = _rs_named(split.params), _rs_named(alone.params, rows)
    beyond = {}
    for k in a:
        d, w = a[k] - init[k], b[k] - init[k]
        off = (d - w).abs() > DIST_UPDATE_TOL * float(w.abs().max())
        beyond[k] = float(off.float().mean())
    return ({k: _worst(a[k], b[k]) for k in a},
            {k: _worst(a[k] - init[k], b[k] - init[k]) for k in a}, beyond)


def _rs_exchange_figures(model, batches, rank):
    """Per step: every collective's calls, bytes (sent and received, less
    the kept blocks), bytes handed over and host seconds, beside the
    balanced exchange's bytes (``exchange_bytes_per_step``; under dedup
    at this rank's distinct routed ids a step, the hot head's left out)
    and the padded buffers' (``dense_exchange_hlo_bytes`` or the dedup
    one)."""
    from dlrm_flexflow_tpu_torch.parallel import alltoall as a2a
    op = model.get_layer_by_name("emb_stack")
    plan, H = op._row_plan, op._hot_rows
    look = DIST_B * T * BAG
    padded = (a2a.dedup_exchange_hlo_bytes if plan.dedup
              else a2a.dense_exchange_hlo_bytes)(plan, look, D)
    distinct = None
    if plan.dedup:
        b = DIST_B // DIST_WORLD
        distinct = float(np.mean([np.unique(
            (ids + np.arange(T)[None, :, None] * ROWS)[ids >= H]).size
            for ids in (np.asarray(x["sparse"][rank * b:(rank + 1) * b],
                                   np.int64) for x in batches)]))
    per = {k: {f: v[f] / len(batches) for f in v}
           for k, v in model._collectives.stats.items() if v["calls"]}
    return {"per_step": per, "padded": padded, "distinct": distinct,
            "dedup": plan.dedup,
            "balanced": a2a.exchange_bytes_per_step(
                plan, look, D, distinct_per_device=distinct)}


def rowshard_rank_child(rank, world, store):
    """``chip_smoke.py --rowshard-rank RANK WORLD STORE``: one rank of
    phase 15. Joins the gloo group through the file store; trains every
    run of the phase DIST_STEPS steps, counting the split model's
    launches; holds (a) and (c) to world-1 runs; writes the skew forms'
    touched rows beside the store; runs the launcher on
    run_criteo_kaggle.sh's flags with the JSON strategy beside the store.
    Prints ``RS_RESULT {json}``."""
    from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
    from dlrm_flexflow_tpu_torch.parallel import distributed
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    distributed.initialize_distributed(
        init_method=f"file://{store}", num_processes=world,
        process_id=rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(store).parent
    uniform, zipf = [], []
    for s in range(DIST_STEPS):
        for out, alpha in ((uniform, 0.0), (zipf, RS_ZIPF)):
            x, y = synthetic_batch(train_config("cat"), DIST_B, seed=90 + s,
                                   zipf_alpha=alpha)
            x["label"] = y
            out.append(x)
    mine = slice(rank * DIST_B // world, (rank + 1) * DIST_B // world)
    distinct = [int(np.unique((np.asarray(b["sparse"][mine], np.int64)
                               + np.arange(T)[None, :, None] * ROWS)
                              ).size) for b in zipf]
    result = {"rank": rank, "backend": torch.distributed.get_backend(),
              "distinct": distinct, "runs": {}}

    def counted(model, batches, after_first=None):
        zero_counts()
        with PlainCalls() as plain:
            losses, ms = _timed_steps(model, batches, after_first)
        return {"losses": losses, "step_ms": ms, "plain_calls": plain.calls,
                "counts": {k: v for k, v in read_counts().items() if v}}

    # (a) the dense exchange under SGD and (c) under Adam, each held to a
    # world-1 run of the same steps; phase 13's split by table timed
    for opt, batches in (("sgd", uniform), ("adam", zipf)):
        split = _rs_model(opt, make_mesh())
        init = {k: v.clone() for k, v in _rs_named(split.params).items()}
        first = {}
        run = counted(split, batches,
                      lambda: first.update(split=_rs_state(split)))
        run["exchange"] = _rs_exchange_figures(split, batches, rank)
        run.update(_rs_digest(split, rank, batches,
                              work / f"rows_{opt}_dense_{rank}.npz"))
        alone = _rs_model(opt, make_mesh(devices=[rank]))
        s = split.get_layer_by_name("emb_stack")._row_ex.shard
        rl = split.get_layer_by_name("emb_stack")._row_plan.rows_local
        rows = slice(s * rl, (s + 1) * rl)
        run["same_init"] = bool(torch.equal(
            init["tables"], alone.params["emb_stack"]["kernel"][:, rows]))
        run["world1_losses"], run["world1_step_ms"] = _timed_steps(
            alone, batches,
            lambda: first.update(alone=_rs_state(alone, rows)))
        run["errs"], run["updates"], run["beyond"] = _rs_vs_world1(
            split, alone, init, rows)
        # the first step's optimizer state (Adam's m and v: (1 - b1)·g
        # and (1 - b2)·g², linear and quadratic in the gradient)
        run["first_state"] = {k: _worst(v, first["alone"][k])
                              for k, v in first.get("split", {}).items()}
        del first
        result["runs"][f"{opt} dense"] = run
        del split, alone, init
        torch.cuda.empty_cache()
    table = _rs_model("sgd", make_mesh(), strategy="table")
    result["table_parallel_step_ms"] = _timed_steps(table, uniform)[1]
    del table
    torch.cuda.empty_cache()
    # (b) the skew forms on zipf ids under SGD (their baseline: the dense
    # exchange on the same ids), (c) dedup under Adam
    runs = [("sgd", "dense", None)] + [("sgd", n, f) for n, f in RS_FORMS] \
        + [("adam", "dedup", dict(exchange="dedup"))]
    for opt, name, form in runs:
        model = _rs_model(opt, make_mesh(), form=form)
        batches = zipf
        run = counted(model, batches)
        run["exchange"] = _rs_exchange_figures(model, batches, rank)
        run["hot_rows"] = model.get_layer_by_name("emb_stack")._hot_rows
        run.update(_rs_digest(model, rank, batches,
                              work / f"rows_{opt}_{name}_zipf_{rank}.npz"))
        result["runs"][f"{opt} {name} zipf"] = run
        del model
        torch.cuda.empty_cache()
    # (d) the launcher: run_criteo_kaggle.sh's flags at DIST_WORLD devices,
    # the concatenated table split by rows
    zero_counts()
    with PlainCalls() as plain:
        out = launcher.main(rowshard_kaggle_flags(work))
    op = out["model"].get_layer_by_name("emb_concat")
    result["launcher"] = {
        "steps": out["steps"], "throughput": out["throughput"],
        "plain_calls": plain.calls, "loss_finite": bool(np.isfinite(
            out["model"].perf.report()["mse"])),
        "nshards": op._row_plan.nshards if op._row_plan else 0,
        "counts": {k: v for k, v in read_counts().items() if v},
        "collectives": out["model"]._collectives.stats}
    print("RS_RESULT " + json.dumps(result), flush=True)
    torch.distributed.destroy_process_group()


def rowshard_kaggle_flags(work):
    """run_criteo_kaggle.sh's flags at DIST_WORLD devices (-b scaled as
    run_random.sh scales it) with ``--import`` of a JSON strategy that
    splits the concatenated table's rows over the ranks (``param_dim``)
    and runs every other op data-parallel, written by the port's own
    ``save_strategies``."""
    from dlrm_flexflow_tpu_torch.parallel.pconfig import ParallelConfig
    from dlrm_flexflow_tpu_torch.parallel.strategy_io import save_strategies
    from dlrm_flexflow_tpu_torch.core.op import InputOp
    flags = ["-ll:gpu", str(DIST_WORLD), "-b", str(TRAIN_B * DIST_WORLD)] \
        + KAGGLE_FLAGS[2:]
    path = work / "kaggle_row_shard.json"
    if not path.exists():
        model = FFModel(FFConfig(batch_size=TRAIN_B * DIST_WORLD,
                                 device="cpu"))
        build_dlrm(model, DLRMConfig.parse_args(flags))
        strat = {}
        for op in model.ops:
            if isinstance(op, InputOp):
                continue
            nd = op.outputs[0].num_dims
            strat[op.name] = (ParallelConfig(
                (DIST_WORLD,) + (1,) * (nd - 1), param_degree=DIST_WORLD)
                if op.name == "emb_concat"
                else ParallelConfig.data_parallel(nd, DIST_WORLD))
        save_strategies(str(path), strat)
    return flags + ["--import", str(path)]


# each split run's launches a step: the bag kernel looks up on the owner
# and sums the bags (and, hybrid, looks up the hot head); the scatter
# kernel sums each combine's segments (the receiver's, the dedup
# sender's, the hot stream's two) and applies SGD to the block (and the
# hot head); the stateful entry applies Adam
RS_LAUNCHES = {
    "sgd dense": {"embedding_bag": 2, "scatter_add_rows": 2},
    "sgd dense zipf": {"embedding_bag": 2, "scatter_add_rows": 2},
    "sgd dedup zipf": {"embedding_bag": 2, "scatter_add_rows": 3},
    "sgd hybrid zipf": {"embedding_bag": 3, "scatter_add_rows": 6},
    "sgd overlap zipf": {"embedding_bag": 2, "scatter_add_rows": 2},
    "adam dense": {"embedding_bag": 2, "scatter_add_rows": 1,
                   "stateful_update_rows": 1},
    "adam dedup zipf": {"embedding_bag": 2, "scatter_add_rows": 2,
                        "stateful_update_rows": 1},
}


def run_rank_children(flag, marker, work, timeout=300, world=DIST_WORLD):
    """``world`` ``chip_smoke.py FLAG RANK WORLD STORE`` children on the
    card, the store in ``work``; each child's one ``MARKER {json}`` line,
    in rank order. Every child is stopped before this returns."""
    import os
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FF_FAULT_")}
    env["PYTHONPATH"] = str(REPO)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    procs, logs, outs = [], [], []
    try:
        for r in range(world):
            logs.append(open(work / f"rank{r}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), flag,
                 str(r), str(world), str(store)],
                stdout=subprocess.PIPE, stderr=logs[-1], text=True, env=env))
        for r, p in enumerate(procs):
            try:
                text, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                text = ""
            logs[r].seek(0)
            check(p.returncode == 0,
                  f"ranks: rank {r} exited {p.returncode}: "
                  f"{logs[r].read()[-3000:]}")
            lines = [ln for ln in text.splitlines()
                     if ln.startswith(marker + " ")]
            check(len(lines) == 1, f"ranks: rank {r} printed no result")
            outs.append(json.loads(lines[0][len(marker) + 1:]))
            for ln in text.splitlines():
                if ln.startswith(("ELAPSED TIME", "[Metrics]")):
                    print(f"  rank {r}: {ln}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return outs


def _fmt(d):
    return "{" + ", ".join(f"{k}: {v:.3g}" for k, v in d.items()) + "}"


def _touched_rows(work, run):
    """{logical id: row} over every rank's file of ``run``."""
    out = {}
    for r in range(DIST_WORLD):
        f = np.load(work / f"rows_{run}_{r}.npz")
        for i, v in zip(f["ids"].tolist(), f["vals"]):
            check(i not in out, f"row exchange ({run}): row {i} held by "
                  f"two ranks")
            out[i] = v
    return out


def rowshard_phase(dev):
    """Phase 15: the owner side at a rank's shape (``rowshard_kernels``),
    then DIST_WORLD ``--rowshard-rank`` children on the card, their
    results held. Returns the children's launch counts, summed."""
    t0 = time.perf_counter()
    rowshard_kernels(dev)
    torch.cuda.empty_cache()
    work = WORK_DIR / "rowshard"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rowshard_kaggle_flags(work)          # the strategy file, once
    try:
        outs = run_rank_children("--rowshard-rank", "RS_RESULT", work)
        counts = {}
        for out in outs:
            check(out["backend"] == "gloo", f"ranks: backend {out['backend']}")
            for name, run in out["runs"].items():
                c, steps = run["counts"], DIST_STEPS
                want = dict(RS_LAUNCHES[name], dense_update=1)
                bad = {k: c.get(k, 0) for k, v in want.items()
                       if c.get(k, 0) != v * steps}
                check(not bad and run["plain_calls"] == 0
                      and not c.get("scatter_write_rows")
                      and not c.get("sharded_scatter_add_rows"),
                      f"row shards ({name}), rank {out['rank']}: launches "
                      f"{c} (off: {bad}), {run['plain_calls']} plain calls")
                check(all(np.isfinite(run["losses"])),
                      f"row shards ({name}): losses {run['losses']}")
                add_counts(counts, c)
            for name in ("sgd dense", "adam dense"):
                run = out["runs"][name]
                # SGD's updates are linear in the gradient. Adam's step is
                # about alpha times the sign of the gradient wherever |g|
                # is above eps, so a gradient that the other summation
                # order moves across 0 (a relu unit at 0, phase 13) flips
                # a whole step of a few values, and the steps after it
                # see other weights; Adam's first step's moments, linear
                # and quadratic in its gradient, are held instead
                held = (run["updates"] if name == "sgd dense"
                        else run["first_state"])
                bad = {k: v for k, v in held.items()
                       if not v <= DIST_UPDATE_TOL}
                print(f"row shards ({name}), rank {out['rank']}, against "
                      f"the world-1 run: updates {_fmt(run['updates'])}; "
                      f"share of values whose update is off by more than "
                      f"{DIST_UPDATE_TOL} of the largest "
                      f"{_fmt(run['beyond'])}; the first step's state "
                      f"{_fmt(run['first_state'])}")
                check(run["same_init"] and held and not bad,
                      f"row shards ({name}), rank {out['rank']}: start "
                      f"bitwise the world-1 run's {run['same_init']}; "
                      f"{'updates' if name == 'sgd dense' else 'state'} "
                      f"beyond {DIST_UPDATE_TOL} of the world-1 run's "
                      f"largest: {bad}")
                check(np.allclose(run["losses"], run["world1_losses"],
                                  rtol=DIST_LOSS_RTOL),
                      f"row shards ({name}): losses {run['losses']} against "
                      f"the world-1 run's {run['world1_losses']}")
            lr = out["launcher"]
            c = lr["counts"]
            steps = lr["steps"] + 1
            check(c.get("embedding_bag") == 2 * steps
                  and c.get("scatter_add_rows") == 2 * steps
                  and c.get("dense_update") == steps
                  and lr["plain_calls"] == 0 and lr["loss_finite"]
                  and lr["nshards"] == DIST_WORLD,
                  f"row shards (launcher), rank {out['rank']}: launches {c}, "
                  f"{lr['plain_calls']} plain calls, finite "
                  f"{lr['loss_finite']}, {lr['nshards']} row shards")
            add_counts(counts, c)
        # the ranks' replicated weights, and the forms among themselves
        for name in outs[0]["runs"]:
            check(len({o["runs"][name]["mlp_sha256"] for o in outs}) == 1,
                  f"row shards ({name}): the ranks' MLP weights differ")
        for name, base in [(f"sgd {n} zipf", "sgd dense zipf")
                           for n, _ in RS_FORMS] \
                + [("adam dedup zipf", "adam dense")]:
            runs = [o["runs"][name] for o in outs]
            bases = [o["runs"][base] for o in outs]
            check(runs[0]["losses"] == bases[0]["losses"]
                  and runs[0]["mlp_sha256"] == bases[0]["mlp_sha256"],
                  f"row shards: {name} differs from {base} (losses "
                  f"{runs[0]['losses']} against {bases[0]['losses']})")
            for k in runs[0]["bit_sums"]:
                got = np.sum([r["bit_sums"][k] for r in runs], axis=0)
                want = np.sum([r["bit_sums"][k] for r in bases], axis=0)
                check(np.array_equal(got, want),
                      f"row shards: {name}'s {k} differ from {base}'s")
            a = _touched_rows(work, name.replace(" ", "_"))
            b = _touched_rows(work, base.replace(" ", "_"))
            check(a.keys() == b.keys() and all(
                np.array_equal(a[i], b[i]) for i in a),
                f"row shards: {name}'s touched rows differ from {base}'s")
        _rs_report(outs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"row shards phase: {time.perf_counter() - t0:.1f} s")
    return counts


def _rs_report(outs):
    runs = outs[0]["runs"]
    med = lambda v: float(np.median(v)) if v else float("nan")  # noqa
    tp = med(outs[0]["table_parallel_step_ms"])
    for name, run in runs.items():
        w1 = (f", world 1 {med(run['world1_step_ms']):.3f} ms"
              if "world1_step_ms" in run else "")
        ex = run["exchange"]
        print(f"row shards, {name}: step ms (median after the first, rank "
              f"0) {med(run['step_ms']):.3f}{w1}, split by table (phase 13's "
              f"strategy) {tp:.3f}; losses {run['losses']}")
        for k, st in ex["per_step"].items():
            print(f"  {k} a step: {st['calls']:g} calls, {st['bytes']:,.0f} "
                  f"bytes sent and received less the kept blocks, "
                  f"{st['sent']:,.0f} handed over, {st['seconds']:.4f} s "
                  f"(host clock, gloo's host copies included)")
        at = ("" if ex["distinct"] is None else
              f" at {ex['distinct']:.1f} distinct routed ids")
        print(f"  the row exchange's bytes a rank a step: balanced "
              f"(exchange_bytes_per_step{at}) {ex['balanced']:,}, padded "
              f"buffers handed over ({'dedup' if ex['dedup'] else 'dense'}"
              f"_exchange_hlo_bytes) {ex['padded']:,}")
        if "updates" in run:
            print(f"  against the world-1 run: each update within "
                  f"{max(run['updates'].values()):.3g} of its parameter's "
                  f"largest (tables {run['updates']['tables']:.3g}), each "
                  f"weight within {max(run['errs'].values()):.3g}; losses "
                  f"{run['world1_losses']}")
    n_local = DIST_B // DIST_WORLD * T * BAG
    print(f"row shards: distinct ids a rank a step under zipf({RS_ZIPF}): "
          f"{[o['distinct'] for o in outs]} of {n_local} lookups; hot rows "
          f"a table {runs['sgd hybrid zipf']['hot_rows']:,}; dedup, hybrid "
          f"and overlap bitwise the dense exchange (SGD), dedup bitwise it "
          f"(Adam); the ranks' MLP weights bitwise equal")
    lr = outs[0]["launcher"]
    print(f"row shards, launcher (run_criteo_kaggle.sh's flags, -ll:gpu "
          f"{DIST_WORLD} -b {TRAIN_B * DIST_WORLD}, the concatenated table "
          f"split by rows): {lr['steps']} steps, {lr['throughput']:.2f} "
          f"samples/s; collectives {lr['collectives']}")


# ---------------------------------------------------------------------
# phase 16: DLRM across ranks under the rest of dlrm_strategy and the
# reference's per-table files (parallel/split.py)
# ---------------------------------------------------------------------
def tablepar_kernel(dev):
    """Kernels 4 and 1 at a Criteo-Kaggle row block's shape: the global
    batch of TP_KAGGLE_B (run_criteo_kaggle.sh at -ll:gpu 2), 26 lookups
    a sample over the concatenated rows, on rank 0's block of half of
    them (5,693,440 rows, d = 16). Kernel 4 is held bitwise to its plain
    version on the CPU, timed beside it and ``index_add_`` after a masked
    select; kernel 1 takes the block's masked bags as the row-block
    lookup gives them (bag 1, the ids outside the block -1), held bitwise
    to its plain version on the same inputs, timed beside it and
    ``F.embedding_bag`` with the outside ids weighted 0. Returns {name:
    row} (the kernel line keeps phases 1 and 13's)."""
    dcfg = DLRMConfig.criteo_kaggle()
    sizes = np.asarray(dcfg.embedding_size, np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    total = -(-int(sizes.sum()) // 8192) * 8192
    rows, lo, d = total // TP_WORLD, 0, KAGGLE_D
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    block = 0.5 * torch.randn(rows, d, device=dev, generator=gen)
    sets = []
    for s in range(ID_SETS):
        x, _ = synthetic_batch(dcfg, TP_KAGGLE_B, seed=160 + s)
        ids = (np.asarray(x["sparse"], np.int64) % sizes[None, :, None]
               + offs[None, :, None]).reshape(-1)
        sets.append((torch.as_tensor(ids, device=dev),
                     torch.randn(ids.size, d, device=dev, generator=gen)))
    n = sets[0][0].numel()
    ids, upd = sets[0]
    got = scat_mod.sharded_scatter_add_rows(block.clone(), ids, upd, lo,
                                            scale=-LR).cpu()
    want = scat_mod.sharded_scatter_add_rows_reference(
        block.cpu(), ids.cpu(), upd.cpu(), lo, scale=-LR)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"sharded_scatter_add_rows at a Kaggle "
          f"row block disagrees with its plain version: {err}")
    del got, want
    inside = (ids >= lo) & (ids < lo + rows)
    n_in, m = int(inside.sum()), int(torch.unique(ids[inside]).numel())
    b_ms, b_by = bound(n * 8 + n * d * 4 + 2 * m * d * 4, 2 * n_in * d)
    scaled = [(i, -LR * u) for i, u in sets]

    def library(i, scaled_upd):
        keep = (i >= lo) & (i < lo + rows)
        block.index_add_(0, i[keep] - lo, scaled_upd[keep])

    src = "dlrm_flexflow_tpu_torch/csrc/scatter_rows.cu"
    r = {"name": "sharded_scatter_add_rows", "route": "cuda", "source": src,
         "replaces": "dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:584",
         "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
         **timed("", lambda i, u: scat_mod.sharded_scatter_add_rows(
             block, i, u, lo, scale=-LR), sets),
         **timed("plain_", lambda i, u:
                 scat_mod.sharded_scatter_add_rows_reference(
                     block, i, u, lo, scale=-LR), sets),
         **timed("library_", library, scaled)}
    print_row(r, f" (a Kaggle row block: n={n} lookups of a global batch "
              f"of {TP_KAGGLE_B}, {n_in} in a {rows:,}-row block, {m} "
              f"distinct rows there, d={d}; bitwise its plain version; "
              f"library: index_add_ after a masked select)")
    del scaled
    # kernel 1 on the block's masked bags: what the row-block lookup runs
    masked = []
    for i, _ in sets:
        local = i - lo
        keep = (local >= 0) & (local < rows)
        masked.append((torch.where(keep, local, -1).reshape(-1, 1),))
    got = bag_mod.embedding_bag(block, masked[0][0], "sum")
    want = bag_mod.embedding_bag_reference(block, masked[0][0], "sum")
    torch.cuda.synchronize()
    berr = float((got - want).abs().max())
    check(torch.equal(got, want), f"embedding_bag on a Kaggle row block's "
          f"masked bags disagrees with its plain version: {berr}")
    del got, want
    bb_ms, bb_by = bound(n * 8 + n_in * d * 4 + n * d * 4, n_in * d)

    def bag_library(i):
        keep = i >= 0
        return torch.nn.functional.embedding_bag(
            torch.where(keep, i, 0), block, mode="sum",
            per_sample_weights=keep.to(block.dtype))

    src = "dlrm_flexflow_tpu_torch/csrc/embedding_bag.cu"
    rb = {"name": "embedding_bag", "route": "cuda", "source": src,
          "replaces": "dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:55",
          "max_abs_err": berr, "bound_ms": bb_ms, "bound_by": bb_by,
          **timed("", lambda i: bag_mod.embedding_bag(block, i, "sum"),
                  masked),
          **timed("plain_", lambda i: bag_mod.embedding_bag_reference(
              block, i, "sum"), masked),
          **timed("library_", bag_library, masked)}
    print_row(rb, f" (a Kaggle row block's masked bags: n={n} bags of 1, "
              f"{n_in} in the {rows:,}-row block, the rest -1, d={d}; "
              f"bitwise its plain version; library: F.embedding_bag with "
              f"the outside ids weighted 0)")
    del block, sets, masked
    return {"sharded_scatter_add_rows": r, "embedding_bag": rb}


def _tp_per_table_file(work, ntables, ndev, world, rank, linear=False):
    """The reference's per-table keys (table i on device i % ndev), every
    other op data-parallel over ``world``; with ``linear`` the first top
    Linear split by channel over 2 devices. Written in ``work``, a file
    a rank."""
    ops = [{"name": f"embedding{i}", "device_type": "TPU", "dims": [1, 1],
            "device_ids": [i % ndev], "memory_types": []}
           for i in range(ntables)]
    ops += [{"name": k, "device_type": "TPU", "dims": [world, 1],
             "device_ids": list(range(world)), "memory_types": []}
            for k in ("linear", "concat")]
    if linear:
        ops.append({"name": TP_LINEAR, "device_type": "TPU", "dims": [1, 2],
                    "device_ids": list(range(world)), "memory_types": []})
    path = work / f"per_table_{ntables}_{ndev}_{world}_{int(linear)}_" \
        f"{rank}.json"
    path.write_text(json.dumps({"ops": ops}))
    return path


def _tp_piece(op, t):
    """This rank's piece of the world-1 model's parameter ``t`` of
    ``op``: what the split model holds of it."""
    split = getattr(op, "_split", None)
    if split is None or split.kind == "replicated":
        return t
    if split.kind == "table":
        order = torch.tensor(op._table_order or range(op.num_tables),
                             device=t.device)
        return t[order[op.local_slots().start:op.local_slots().stop]]
    if split.kind == "rows":
        rl = t.shape[0] // split.nblocks
        return t[split.block * rl:(split.block + 1) * rl]
    return t[..., split.columns(t.shape[-1])]


def _tp_models(make, world_mesh):
    """(the split model, the world-1 model on this rank alone), each made
    by ``make(mesh)`` from one seed."""
    from dlrm_flexflow_tpu_torch.parallel import distributed
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    return make(world_mesh), make(make_mesh(devices=[distributed.rank()]))


def _tp_held(split, alone, batches, dp=None):
    """TP_STEPS steps of the split model (every count at 0 just before,
    read just after) and of the world-1 model on the same global batches
    (its counts read the same way); each parameter of the split model
    against this rank's piece of the world-1 model's, over max |the
    world-1 piece|: the weights, the updates from the split model's
    initial weights, and whether they started bitwise equal; each
    optimizer state slab the same way (from zero: its update is its
    value), and after the first step (``first_state``: Adam's first
    moments are linear and quadratic in the first gradient, where its
    later steps are not); the share of values whose update is off by
    more than DIST_UPDATE_TOL of the largest; each piece's sha256 and
    split, for the copies' check. With ``dp``, the same model on the same
    ranks with every table whole on each (data-parallel, as the MLPs:
    the ranks' summation order without the split), its TP_STEPS steps
    held the same way under "witness"."""
    import hashlib
    ops = {op.name: op for op in split.ops}

    def slabs(model):
        return {(k, o, p): v for k in sorted(model.opt_state or {})
                if k != "step" for o in sorted(model.opt_state[k])
                for p, v in sorted(model.opt_state[k][o].items())}

    first, first_state = {}, {}

    def keep_first():
        first.update({k: v.clone() for k, v in slabs(split).items()})

    def hold_first():
        for (k, o, p), v in slabs(alone).items():
            first_state[f"{k}:{o}.{p}"] = _worst(first.pop((k, o, p)),
                                                 _tp_piece(ops[o], v))

    names = [(o, p) for o in sorted(split.params)
             for p in sorted(split.params[o])]
    init = {k: split.params[k[0]][k[1]].clone() for k in names}

    def starts_equal(ref):
        return all(torch.equal(init[(o, p)], _tp_piece(ops[o],
                                                       ref.params[o][p]))
                   for o, p in names)

    def against(ref):
        """{key: (weight error, update error, share of values off)} of
        every parameter and state slab against ``ref``'s piece, and
        whether all are bitwise equal."""
        held = [("", o, p, split.params[o][p], ref.params[o][p],
                 init[(o, p)]) for o, p in names]
        for k in sorted(split.opt_state or {}):
            if k == "step":
                continue
            held += [(f"{k}:", o, p, v, ref.opt_state[k][o][p],
                      torch.zeros_like(v))
                     for o in sorted(split.opt_state[k])
                     for p, v in sorted(split.opt_state[k][o].items())]
        out, equal = {}, True
        for slab, o, p, a, whole, a0 in held:
            b = _tp_piece(ops[o], whole)
            equal = equal and torch.equal(a, b)
            off = ((a - a0) - (b - a0)).abs() \
                > DIST_UPDATE_TOL * float((b - a0).abs().max())
            out[f"{slab}{o}.{p}"] = (_worst(a, b), _worst(a - a0, b - a0),
                                     float(off.float().mean()))
        return out, equal

    same_init = starts_equal(alone)
    for st in split._collectives.stats.values():    # the steps' alone
        st.update(calls=0, bytes=0, sent=0, seconds=0.0)
    zero_counts()
    with PlainCalls() as plain:
        losses, ms = _timed_steps(split, batches, keep_first)
    counts = read_counts()
    stats = {k: dict(v) for k, v in split._collectives.stats.items()}
    zero_counts()
    losses1, ms1 = _timed_steps(alone, batches, hold_first)
    counts1 = read_counts()
    held, _ = against(alone)
    digests = {}
    for key in held:
        slab, _, name = key.rpartition(":")
        o, p = name.split(".", 1)
        a = (split.params[o][p] if not slab
             else split.opt_state[slab][o][p])
        sp = getattr(ops[o], "_split", None)
        block = (sp.block if sp is not None and sp.kind != "replicated"
                 else None)
        digests[key] = [block, hashlib.sha256(
            a.detach().cpu().numpy().tobytes()).hexdigest()]
    run = {"losses": losses, "world1_losses": losses1, "step_ms": ms,
           "world1_step_ms": ms1, "same_init": same_init,
           "errs": {k: v[0] for k, v in held.items()},
           "updates": {k: v[1] for k, v in held.items()},
           "beyond": {k: v[2] for k, v in held.items()},
           "first_state": first_state, "digests": digests,
           "plain_calls": plain.calls,
           "counts": {k: v for k, v in counts.items() if v},
           "world1_counts": {k: v for k, v in counts1.items() if v},
           "collectives": stats}
    if dp is not None:
        dp_init = starts_equal(dp)
        dp_losses, dp_ms = _timed_steps(dp, batches)
        w, equal = against(dp)
        run["witness"] = {
            "same_init": dp_init, "losses": dp_losses, "step_ms": dp_ms,
            "bitwise": equal, "updates": {k: v[1] for k, v in w.items()},
            "beyond": {k: v[2] for k, v in w.items()}}
    return run


def _tp_warnings(fn):
    """(fn's result, the warnings of the "ff.model" logger while it
    ran)."""
    import logging
    msgs = []

    class Keep(logging.Handler):
        def emit(self, rec):
            msgs.append(rec.getMessage())

    h = Keep(logging.WARNING)
    logging.getLogger("ff.model").addHandler(h)
    try:
        return fn(), msgs
    finally:
        logging.getLogger("ff.model").removeHandler(h)


def _tp_launcher_run(flags, rank):
    """The launcher on ``flags`` (every count at 0 just before it, read
    just after), then TP_STEPS steps of the model it builds against the
    world-1 model of the same flags."""
    from dlrm_flexflow_tpu_torch.config import FFConfig as Cfg
    from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.parallel.strategy_io import load_strategies
    zero_counts()
    with PlainCalls() as plain:
        out, warns = _tp_warnings(lambda: launcher.main(flags))
    model = out["model"]
    op = model.get_layer_by_name("emb_concat")
    sp = op._split
    rl = op.total_rows // sp.nblocks
    run = {"launcher": {
        "steps": out["steps"], "throughput": out["throughput"],
        "plain_calls": plain.calls, "loss_finite": bool(np.isfinite(
            model.perf.report()["mse"])),
        "counts": {k: v for k, v in read_counts().items() if v},
        "collectives": model._collectives.stats},
        "warnings": warns, "split": [sp.kind, sp.block, sp.nblocks],
        "total_rows": op.total_rows,
        # the tables whose rows lie in this rank's block, and whether each
        # lies in it whole
        "tables": [t for t, (o, s) in enumerate(zip(op._offsets,
                                                    op.table_sizes))
                   if sp.block * rl <= o < (sp.block + 1) * rl],
        "whole": all((o // rl) == ((o + s - 1) // rl)
                     for o, s in zip(op._offsets, op.table_sizes))}
    del out, model, op
    gc.collect()
    torch.cuda.empty_cache()
    cfg = Cfg.parse_args(flags)
    dcfg = DLRMConfig.parse_args(cfg.unparsed)

    def make(mesh):
        m = FFModel(FFConfig(
            batch_size=cfg.batch_size, seed=SEED, device="cuda:0",
            sparse_embedding_update=cfg.sparse_embedding_update))
        build_dlrm(m, dcfg)
        strat = (load_strategies(cfg.import_strategy_file)
                 if cfg.import_strategy_file
                 else dlrm_strategy(m, dcfg, mesh.size))
        m.compile(SGDOptimizer(lr=cfg.learning_rate), "mean_squared_error",
                  ["mse"], mesh=mesh, strategies=strat)
        m.init_layers()
        return m

    batches = []
    for s in range(TP_STEPS):
        x, y = synthetic_batch(dcfg, cfg.batch_size, seed=170 + s)
        x["label"] = y
        batches.append(x)
    split, alone = _tp_models(make, make_mesh())
    run.update(_tp_held(split, alone, batches))
    del split, alone
    gc.collect()          # a model and its ops refer to each other
    torch.cuda.empty_cache()
    return run


def _tp_random_run(fuse, strategies, opt=lambda: SGDOptimizer(lr=LR),
                   batch=DIST_B, mode="cat", after=None, witness=False,
                   **config):
    """run_random.sh's widths (random_benchmark: 8 x 1M x 64), batch
    ``batch``, fused or one Embedding a table ("dot": the fused
    interaction), under ``strategies(model, cfg, mesh)`` and ``opt()``
    (``config``: more FFConfig fields): TP_STEPS steps against the
    world-1 model (``witness``: and against the model with every op
    data-parallel, see ``_tp_held``); then ``after(split model,
    batches)``, whose result the run keeps as "after"."""
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    cfg = train_config(mode)

    def make(mesh, strat=strategies):
        m = FFModel(FFConfig(batch_size=batch, seed=SEED, device="cuda:0",
                             **config))
        build_dlrm(m, cfg, fuse_embeddings=fuse,
                   fuse_interaction=mode == "dot")
        m.compile(opt(), "mean_squared_error", ["mse"],
                  mesh=mesh, strategies=strat(m, cfg, mesh))
        m.init_layers()
        return m

    batches = []
    for s in range(TP_STEPS):
        x, y = synthetic_batch(cfg, batch, seed=180 + s)
        x["label"] = y
        batches.append(x)
    split, alone = _tp_models(make, make_mesh())
    dp = make(make_mesh(), lambda m, cfg, mesh: {}) if witness else None
    run = _tp_held(split, alone, batches, dp)
    del dp
    run["splits"] = {op.name: [op._split.kind, op._split.block,
                               op._split.nblocks]
                     for op in split.ops
                     if getattr(op, "_split", None) is not None}
    if after is not None:
        run["after"] = after(split, alone, batches)
    del split, alone
    gc.collect()          # a model and its ops refer to each other
    torch.cuda.empty_cache()
    return run


def tablepar_rank_child(rank, world, store):
    """``chip_smoke.py --tablepar-rank RANK WORLD STORE``: one rank of
    phase 16. Joins the gloo group through the file store. At TP_WORLD
    ranks: (a) the launcher with run_criteo_kaggle.sh's flags, (b) the
    same under the per-table file beside the store, (c) the unfused "cat"
    split by width; at TP_WORLD4: (d) the stacked tables over 2 of the 4
    ranks with the first top Linear split by channel. Each held to a
    world-1 run. Prints ``TP_RESULT {json}``."""
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel import distributed
    from dlrm_flexflow_tpu_torch.parallel.strategy_io import load_strategies
    distributed.initialize_distributed(
        init_method=f"file://{store}", num_processes=world,
        process_id=rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(store).parent
    result = {"rank": rank, "backend": torch.distributed.get_backend(),
              "runs": {}}
    if world == TP_WORLD:
        flags = tp_kaggle_flags()
        result["runs"]["a"] = _tp_launcher_run(flags, rank)
        path = _tp_per_table_file(work, KAGGLE_TABLES, TP_WORLD, TP_WORLD,
                                  rank)
        result["runs"]["b"] = _tp_launcher_run(
            flags + ["--import", str(path)], rank)
        result["runs"]["c"] = _tp_random_run(
            False, lambda m, cfg, mesh: dlrm_strategy(m, cfg, mesh.size))
    else:
        path = _tp_per_table_file(work, T, 2, TP_WORLD4, rank, linear=True)
        result["runs"]["d"] = _tp_random_run(
            True, lambda m, cfg, mesh: load_strategies(str(path)))
    print("TP_RESULT " + json.dumps(result), flush=True)
    torch.distributed.destroy_process_group()


def tp_kaggle_flags():
    """run_criteo_kaggle.sh's flags at -ll:gpu TP_WORLD: -b 256 x
    TP_WORLD, no --import."""
    return ["-ll:gpu", str(TP_WORLD), "-b", str(TP_KAGGLE_B)] \
        + KAGGLE_FLAGS[2:]


# each split step's launches: (a), (b) the masked bags and kernel 4 on
# the row block; (c) a bag and a scatter a table on its columns; (d) the
# table exchange's bag and kernel 4; one dense update each
TP_LAUNCHES = {
    "a": {"embedding_bag": 1, "sharded_scatter_add_rows": 1},
    "b": {"embedding_bag": 1, "sharded_scatter_add_rows": 1},
    "c": {"embedding_bag": T, "scatter_add_rows": T},
    "d": {"embedding_bag": 1, "sharded_scatter_add_rows": 1},
}
TP_NAMES = {
    "a": "(a) Kaggle, the launcher, dlrm_strategy: row blocks",
    "b": "(b) Kaggle, the launcher, a per-table file (i % 2): row blocks "
         "by device",
    "c": "(c) run_random.sh's widths unfused: each Embedding by width",
    "d": "(d) run_random.sh's stacked tables over 2 of 4 ranks, "
         f"{TP_LINEAR} by channel [1, 2]",
}


def _tp_check(out, name, run, world, launches=None, names=None,
              exempt=(), held="updates", upto=None):
    """The checks of one run of one rank; returns its launch counts.
    ``launches``/``names``: the table of a step's launches and of run
    names (phase 16's by default); a step launches exactly those and one
    dense update. ``held``: what is held within DIST_UPDATE_TOL, every
    update ("updates") or, under Adam, the first step's state
    ("first_state"; see ``_tp_held``); ``exempt``: parameters the caller
    holds instead; ``upto``: the losses held within DIST_LOSS_RTOL, the
    first ``upto`` (None: all)."""
    launches = TP_LAUNCHES if launches is None else launches
    label = (TP_NAMES if names is None else names)[name]
    c, steps = run["counts"], TP_STEPS
    want = dict(launches[name], dense_update=1)
    bad = {k: c.get(k, 0) for k, v in want.items() if c.get(k, 0) != v * steps}
    others = {k: v for k, v in c.items() if ":" not in k and k not in want
              and k != "scatter_presort"}
    check(not bad and not others and run["plain_calls"] == 0,
          f"{label}, rank {out['rank']}: launches {c} (off: {bad}, "
          f"unexpected: {others}), {run['plain_calls']} plain calls")
    bad = {k: v for k, v in run[held].items()
           if not v <= DIST_UPDATE_TOL and k not in exempt}
    check(run["same_init"] and run[held] and not bad,
          f"{label}, rank {out['rank']}: start bitwise the world-1 "
          f"run's {run['same_init']}; {held} beyond {DIST_UPDATE_TOL} of "
          f"the world-1 run's largest: {bad}")
    upto = len(run["losses"]) if upto is None else upto
    check(all(np.isfinite(run["losses"])) and np.allclose(
        run["losses"][:upto], run["world1_losses"][:upto],
        rtol=DIST_LOSS_RTOL),
        f"{label}: losses {run['losses']} against the world-1 "
        f"run's {run['world1_losses']} (the first {upto} held)")
    return c


def _tp_copies(outs, name, names=None):
    """Every copy of a piece bitwise equal across the ranks: the
    replicated parameters (and state slabs) on every rank, a block on
    every rank holding it."""
    label = (TP_NAMES if names is None else names)[name]
    runs = [o["runs"][name] for o in outs]
    for key in runs[0]["digests"]:
        by_block = {}
        for r in runs:
            block, sha = r["digests"][key]
            by_block.setdefault(block, set()).add(sha)
        check(all(len(v) == 1 for v in by_block.values()),
              f"{label}: the copies of {key} differ across ranks")
    check(all(r["losses"] == runs[0]["losses"] for r in runs),
          f"{label}: the ranks' losses differ")


def tablepar_phase(dev):
    """Phase 16: kernels 4 and 1 at a Kaggle row block's shape, then
    TP_WORLD ``--tablepar-rank`` children on the card for (a)-(c) and
    TP_WORLD4 for (d), their results held. Returns (the kernels' rows at
    that shape, the children's launch counts, summed)."""
    t0 = time.perf_counter()
    rows = tablepar_kernel(dev)
    torch.cuda.empty_cache()
    work = WORK_DIR / "tablepar"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    counts = {}
    try:
        outs2 = run_rank_children("--tablepar-rank", "TP_RESULT", work,
                                  world=TP_WORLD)
        outs4 = run_rank_children("--tablepar-rank", "TP_RESULT",
                                  work / "four", world=TP_WORLD4)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for outs, world in ((outs2, TP_WORLD), (outs4, TP_WORLD4)):
        for out in outs:
            check(out["backend"] == "gloo",
                  f"ranks: backend {out['backend']}")
            for name, run in out["runs"].items():
                add_counts(counts, _tp_check(out, name, run, world))
                lr = run.get("launcher")
                if lr is None:
                    continue
                c, steps = lr["counts"], lr["steps"] + 1
                check(c.get("embedding_bag") == steps
                      and c.get("sharded_scatter_add_rows") == steps
                      and c.get("dense_update") == steps
                      and lr["plain_calls"] == 0 and lr["loss_finite"]
                      and run["split"][0] == "rows"
                      and run["split"][2] == TP_WORLD
                      and (name != "b" or run["whole"]),
                      f"{TP_NAMES[name]} (launcher), rank {out['rank']}: "
                      f"launches {c}, {lr['plain_calls']} plain calls, "
                      f"finite {lr['loss_finite']}, split {run['split']}, "
                      f"tables whole in a block {run['whole']}")
                add_counts(counts, c)
        for name in outs[0]["runs"]:
            _tp_copies(outs, name)
    # (b): each rank's block holds exactly the tables of its device, and
    # the grouping's padding was warned of
    b = [o["runs"]["b"] for o in outs2]
    for k, r in enumerate(b):
        check(r["tables"] == [t for t in range(KAGGLE_TABLES)
                              if t % TP_WORLD == k],
              f"{TP_NAMES['b']}: rank {k}'s block holds tables "
              f"{r['tables']}")
        check(any("honoring per-table device placement pads" in w
                  for w in r["warnings"]),
              f"{TP_NAMES['b']}: no padding warning in {r['warnings']}")
    d = outs4[0]["runs"]["d"]["splits"]
    check(d["emb_stack"][0] == "table" and d["emb_stack"][2] == 2
          and d[TP_LINEAR][0] == "channel" and d[TP_LINEAR][2] == 2,
          f"{TP_NAMES['d']}: splits {d}")
    _tp_report(outs2, outs4, b)
    print(f"tables split phase: {time.perf_counter() - t0:.1f} s")
    return rows, counts


def _tp_report(outs2, outs4, b):
    med = lambda v: float(np.median(v)) if v else float("nan")  # noqa
    for outs, world in ((outs2, TP_WORLD), (outs4, TP_WORLD4)):
        for name in outs[0]["runs"]:
            runs = [o["runs"][name] for o in outs]
            r0 = runs[0]
            print(f"tables split, {TP_NAMES[name]}: step ms (median after "
                  f"the first, rank 0) world {world} "
                  f"{med(r0['step_ms']):.3f}, world 1 "
                  f"{med(r0['world1_step_ms']):.3f}; losses {r0['losses']} "
                  f"against {r0['world1_losses']}; each update within "
                  f"{max(max(r['updates'].values()) for r in runs):.3g} "
                  f"of its parameter's largest, each weight within "
                  f"{max(max(r['errs'].values()) for r in runs):.3g}; "
                  f"launches a rank {r0['counts']}; every copy bitwise "
                  f"equal across the ranks")
            for k, st in r0["collectives"].items():
                if st["calls"]:
                    print(f"  {k} a step: {st['calls'] / TP_STEPS:g} calls,"
                          f" {st['bytes'] / TP_STEPS:,.0f} bytes sent and "
                          f"received less the kept blocks, "
                          f"{st['sent'] / TP_STEPS:,.0f} handed over, "
                          f"{st['seconds'] / TP_STEPS:.4f} s (host clock, "
                          f"gloo's host copies included)")
            lr = r0.get("launcher")
            if lr is not None:
                print(f"  the launcher ({' '.join(tp_kaggle_flags()[:4])}"
                      f"{' --import per-table' if name == 'b' else ''}): "
                      f"{lr['steps']} steps, {lr['throughput']:.2f} "
                      f"samples/s; concatenated rows {r0['total_rows']:,}, "
                      f"{r0['total_rows'] // TP_WORLD:,} a rank")
    print(f"tables split, (b): rank blocks hold tables "
          f"{[r['tables'] for r in b]}; "
          f"{[w for w in b[0]['warnings'] if 'pads' in w]}")


# ---------------------------------------------------------------------
# phase 17: split tables under every optimizer
# ---------------------------------------------------------------------
SO_WORLD = 2
# the global batch of the "cat" runs: 4,096 lookups a block of 4 tables
SO_B = 1024
SO_ADAM = lambda: AdamOptimizer(alpha=0.001)                  # noqa: E731
SO_MOMENTUM = lambda: SGDOptimizer(lr=LR, momentum=0.9,       # noqa: E731
                                   weight_decay=1e-4)
SO_SR = dict(emb_dtype="int8", emb_update_rule="stochastic_rounding")
# rows of the width piece the two rounding passes are timed on:
# run_random.sh's 1M x 64 Embedding over 2 ranks
SO_PIECE = (ROWS, D // SO_WORLD)


def _so_window_case(dev, gen, what, block_rows, lo, sets, d, p, alpha_t):
    """Kernel 2's stateful entry over the window [lo, lo + block_rows) of
    a table (Adam, fresh state slabs), held bitwise to its plain version
    on the CPU over the rows it touches (a compact copy of them; the ids
    outside the window pads) and timed beside its bound and the plain
    version on the card. Returns its row."""
    block = 0.5 * torch.randn(block_rows, d, device=dev, generator=gen)
    slabs = {k: 1e-3 * torch.rand(block_rows, d, device=dev, generator=gen)
             for k in ("m", "v")}
    ids, upd = sets[0]
    n = ids.numel()
    local = scat_mod.window_ids(ids, lo, block_rows)
    real = local >= 0
    uniq, inv = torch.unique(local[real], return_inverse=True)
    cids = torch.full_like(local, -1)
    cids[real] = inv
    want = block[uniq].cpu()
    want_s = {k: v[uniq].cpu() for k, v in slabs.items()}
    scat_mod.stateful_update_rows_reference(want, cids.cpu(), upd.cpu(),
                                            None, want_s, p, alpha_t.cpu())
    spare = torch.randint(0, block_rows, (4096,), device=dev, generator=gen)
    spare = spare[~torch.isin(spare, uniq)]
    kept = [t[spare].clone() for t in (block, *slabs.values())]
    before = scat_mod.stateful_update_rows.routes["fused"]
    scat_mod.stateful_update_rows(block, ids, upd, None, slabs, p, alpha_t,
                                  lo=lo)
    check(scat_mod.stateful_update_rows.routes["fused"] == before + 1,
          f"the windowed stateful entry ({what}) did not take its one-launch "
          f"route")
    got = [block[uniq].cpu()] + [slabs[k][uniq].cpu() for k in want_s]
    err = max(float((a - b).abs().max())
              for a, b in zip(got, [want] + list(want_s.values())))
    check(all(torch.equal(a, b) for a, b in
              zip(got, [want] + list(want_s.values()))),
          f"the windowed stateful entry ({what}) disagrees with its plain "
          f"version: {err}")
    check(all(torch.equal(t[spare], k) for t, k in
              zip((block, *slabs.values()), kept)),
          f"the windowed stateful entry ({what}) changed rows it was not "
          f"given")
    m = int(uniq.numel())
    n_in = int(real.sum())
    # the ids, the updates; a distinct row's weight, m and v read and
    # written; about 12 operations an element of a distinct row and one
    # add a lookup's in the window
    b_ms, b_by = bound(n * 8 + n * d * 4 + m * d * 4 * 6,
                       n_in * d + 12 * m * d)
    plain_ms, plain_call_ms = time_ms(
        lambda i, u: scat_mod.stateful_update_rows_reference(
            block, scat_mod.window_ids(i, lo, block_rows), u, None, slabs, p,
            alpha_t), sets, iters=10, warmup=2, what="plain call")
    r = {"name": "stateful_update_rows", "route": "cuda",
         "source": "dlrm_flexflow_tpu_torch/csrc/scatter_rows.cu",
         "replaces": "dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:495",
         "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
         **timed("", lambda i, u: scat_mod.stateful_update_rows(
             block, i, u, None, slabs, p, alpha_t, lo=lo), sets),
         "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
         "library_ms": None, "library_call_ms": None}
    print_row(r, f" ({what}: n={n} lookups, {n_in} in the window of "
              f"{block_rows:,} rows at lo={lo:,}, {m} distinct rows there, "
              f"d={d}, Adam, fused route, one launch; bitwise its plain "
              f"version; library: none)")
    del block, slabs
    torch.cuda.empty_cache()
    return r


def splitopt_kernels(dev):
    """Kernel 2's windowed stateful entry, ``stateful_update_rows(lo=)``,
    at a Criteo-Kaggle row block's shape (the global batch of
    TP_KAGGLE_B: 13,312 lookups over the concatenated rows, rank 1's
    block of 5,693,440 rows, d = 16) and at the "cat" split's (4 of 8
    tables of 1M x 64, rank 1's block, SO_B x 4 = 4,096 lookups), Adam;
    then the two passes of a width piece's rounding, ``row_amax`` and
    ``fake_quant_rows_amax``, on a 1M x 32 piece (int8, stochastic),
    each bitwise its plain version on the CPU (and the piece bitwise the
    whole rows' ``fake_quant_rows`` at its columns), timed beside its
    bound. Returns {"stateful_update_rows:window": [rows], "row_amax":
    row, "fake_quant_rows_amax": row}."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    opt = SO_ADAM()
    p = opt.row_params()
    alpha_t = opt.alpha_t(torch.tensor(4, dtype=torch.int32, device=dev))
    windows = []
    dcfg = DLRMConfig.criteo_kaggle()
    sizes = np.asarray(dcfg.embedding_size, np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    total = -(-int(sizes.sum()) // 8192) * 8192
    rows = total // SO_WORLD
    sets = []
    for s in range(ID_SETS):
        x, _ = synthetic_batch(dcfg, TP_KAGGLE_B, seed=190 + s)
        ids = (np.asarray(x["sparse"], np.int64) % sizes[None, :, None]
               + offs[None, :, None]).reshape(-1)
        sets.append((torch.as_tensor(ids, device=dev),
                     torch.randn(ids.size, KAGGLE_D, device=dev,
                                 generator=gen)))
    windows.append(_so_window_case(dev, gen, "a Kaggle row block", rows,
                                   rows, sets, KAGGLE_D, p, alpha_t))
    tl = T // SO_WORLD
    lo = tl * ROWS
    sets = [(lo + torch.randint(0, tl * ROWS, (SO_B * tl,), device=dev,
                                generator=gen),
             torch.randn(SO_B * tl, D, device=dev, generator=gen))
            for _ in range(ID_SETS)]
    windows.append(_so_window_case(dev, gen, "the \"cat\" split's block "
                                   "of 4 tables", tl * ROWS, lo, sets, D, p,
                                   alpha_t))
    del sets
    # the two passes on rank 1's columns of a 1M x 64 table
    nrows, dc = SO_PIECE
    whole = 0.01 * torch.randn(nrows, D, device=dev, generator=gen)
    pieces = [whole[:, k * dc:(k + 1) * dc].contiguous()
              for k in range(SO_WORLD)]
    amax = torch.stack([qr_mod.row_amax(x) for x in pieces])
    want_amax = qr_mod.row_amax_reference(pieces[1].cpu())
    a_err = float((amax[1].cpu() - want_amax).abs().max())
    check(torch.equal(amax[1].cpu(), want_amax),
          f"row_amax on a {nrows:,} x {dc} piece disagrees with its plain "
          f"version: {a_err}")
    top = amax.view(torch.int32).amax(dim=0).view(torch.float32)
    draws = dict(seed=SEED, step=3, salt=0x51)
    got = qr_mod.fake_quant_rows_amax(pieces[1].clone(), top, "int8",
                                      "stochastic", col0=dc, **draws)
    want = qr_mod.fake_quant_rows_reference(
        pieces[1].cpu(), "int8", "stochastic", amax=top.cpu(), col0=dc,
        **draws)
    q_err = float((got.cpu() - want).abs().max())
    rows_whole = qr_mod.fake_quant_rows(whole.clone(), "int8", "stochastic",
                                        **draws)[:, dc:]
    check(torch.equal(got.cpu(), want) and torch.equal(got, rows_whole),
          f"fake_quant_rows_amax on a {nrows:,} x {dc} piece disagrees with "
          f"its plain version ({q_err}) or with the whole rows' rounding")
    del rows_whole
    src = "dlrm_flexflow_tpu_torch/csrc/quant_rows.cu"
    piece = pieces[1]
    b1 = bound(nrows * dc * 4 + nrows * 4)
    r1 = {"name": "row_amax", "route": "cuda", "source": src,
          "replaces": "dlrm_flexflow_tpu/quant/codec.py:176",
          "max_abs_err": a_err, "bound_ms": b1[0], "bound_by": b1[1],
          **timed("", qr_mod.row_amax, [(piece,)]),
          **timed("plain_", qr_mod.row_amax_reference, [(piece,)]),
          **timed("library_", lambda x: torch.amax(x.abs(), dim=1),
                  [(piece,)])}
    print_row(r1, f" (a {nrows:,} x {dc} width piece, pass 1; bitwise its "
              f"plain version; library: torch.amax of abs)")
    b2 = bound(2 * nrows * dc * 4 + nrows * 4)
    plain_ms, plain_call_ms = time_ms(
        lambda x: qr_mod.fake_quant_rows_reference(
            x, "int8", "stochastic", amax=top, col0=dc, **draws),
        [(piece,)], iters=4, warmup=1, what="plain call")
    r2 = {"name": "fake_quant_rows_amax", "route": "cuda", "source": src,
          "replaces": "dlrm_flexflow_tpu/quant/codec.py:176",
          "max_abs_err": q_err, "bound_ms": b2[0], "bound_by": b2[1],
          **timed("", lambda x: qr_mod.fake_quant_rows_amax(
              x, top, "int8", "stochastic", col0=dc, **draws), [(piece,)]),
          "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
          "library_ms": None, "library_call_ms": None}
    print_row(r2, f" (a {nrows:,} x {dc} width piece at column {dc}, pass "
              f"2, int8 Philox; bitwise its plain version and the whole "
              f"rows' fake_quant_rows at its columns; library: none)")
    del whole, pieces, piece, amax, top, got
    torch.cuda.empty_cache()
    return {"stateful_update_rows:window": windows, "row_amax": r1,
            "fake_quant_rows_amax": r2}


def _so_code_steps(split, alone):
    """Under stochastic rounding, each table piece against the world-1
    run's, in codes of the world-1 row's int8 step (its |x| max / 127):
    the most any value differs (0: bitwise; 1: one code apart, a draw on
    the other side of a value the two runs' sums moved by ulps)."""
    out = {}
    for op in split.ops:
        if getattr(op, "_split", None) is None \
                or op._split.kind != "width":
            continue
        whole = alone.params[op.name]["kernel"]
        code = whole.abs().amax(dim=1, keepdim=True) / 127.0
        diff = (split.params[op.name]["kernel"] - _tp_piece(op, whole)).abs()
        out[op.name] = float((diff / code.clamp(min=1e-30)).max())
    return out


def _so_sr_step(split, alone, batches):
    """One more step of the width split under stochastic rounding, its
    rounding held: the first table's columns before the rounding,
    gathered whole (one all-gather), rounded as one card rounds the
    whole table at that step (``fake_quant_rows``, the same draws), and
    this rank's rounded piece bitwise its columns of that. Returns
    (bitwise, the code steps against the world-1 run after TP_STEPS)."""
    steps = _so_code_steps(split, alone)
    names = [n for n, _ in split._sr_quant_ops()]
    op = split.get_layer_by_name(names[0])
    pol = split.quant_policies()[op.name]
    rounding = split._requant_sr_params
    box = {}

    def hooked(ok=None):
        pre = op._split.gather_pieces(split.params[op.name]["kernel"], -1)
        rounding(ok)
        qr_mod.fake_quant_rows(pre, pol.dtype, "stochastic",
                               seed=int(split.config.seed),
                               step=int(split._step), salt=0x51)
        box["equal"] = torch.equal(split.params[op.name]["kernel"],
                                   _tp_piece(op, pre))

    split._requant_sr_params = hooked
    try:
        split.train_batch(batches[0])
    finally:
        split._requant_sr_params = rounding
    return {"rounded_bitwise": box.get("equal", False), "code_steps": steps}


def _so_kaggle_run():
    """Criteo-Kaggle's concatenated table in SO_WORLD row blocks
    (dlrm_strategy) under Adam, global batch TP_KAGGLE_B: TP_STEPS
    steps against the world-1 model."""
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    dcfg = DLRMConfig.criteo_kaggle()

    def make(mesh):
        m = FFModel(FFConfig(batch_size=TP_KAGGLE_B, seed=SEED,
                             device="cuda:0"))
        build_dlrm(m, dcfg)
        m.compile(SO_ADAM(), "mean_squared_error", ["mse"], mesh=mesh,
                  strategies=dlrm_strategy(m, dcfg, mesh.size))
        m.init_layers()
        return m

    batches = []
    for s in range(TP_STEPS):
        x, y = synthetic_batch(dcfg, TP_KAGGLE_B, seed=200 + s)
        x["label"] = y
        batches.append(x)
    split, alone = _tp_models(make, make_mesh())
    run = _tp_held(split, alone, batches)
    op = split.get_layer_by_name("emb_concat")
    run["splits"] = {"emb_concat": [op._split.kind, op._split.block,
                                    op._split.nblocks]}
    del split, alone, op
    gc.collect()          # a model and its ops refer to each other
    torch.cuda.empty_cache()
    return run


def splitopt_rank_child(rank, world, store):
    """``chip_smoke.py --splitopt-rank RANK WORLD STORE``: one rank of
    phase 17, joined to the gloo group through the file store: (a) the
    "cat" split by table under Adam and under momentum with weight
    decay, (b) Criteo-Kaggle's concatenated table in row blocks under
    Adam, (c) the unfused "cat" split by width under Adam and under int8
    stochastic rounding (compile()'s default optimizer), (d) the
    launcher with run_criteo_kaggle.sh's flags at -ll:gpu 2 -b 512
    --dense-embedding-update, (e) the fused "dot" under Adam, each held
    to a world-1 run, (a) and (c) under Adam also to the witness run
    (SO_WITNESS_RUNS). Prints ``SO_RESULT {json}``."""
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel import distributed
    distributed.initialize_distributed(
        init_method=f"file://{store}", num_processes=world,
        process_id=rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"rank": rank, "backend": torch.distributed.get_backend(),
              "runs": {}}
    runs = result["runs"]

    def strat(m, cfg, mesh):
        return dlrm_strategy(m, cfg, mesh.size)

    runs["a_adam"] = _tp_random_run(True, strat, SO_ADAM, SO_B,
                                    witness=True)
    runs["a_momentum"] = _tp_random_run(True, strat, SO_MOMENTUM, SO_B)
    runs["b"] = _so_kaggle_run()
    runs["c_adam"] = _tp_random_run(False, strat, SO_ADAM, SO_B,
                                    witness=True)
    runs["c_sr"] = _tp_random_run(False, strat, lambda: None, SO_B,
                                  after=_so_sr_step, **SO_SR)
    runs["d"] = _tp_launcher_run(
        tp_kaggle_flags() + ["--dense-embedding-update"], rank)
    runs["e"] = _tp_random_run(True, strat, SO_ADAM, SO_B, mode="dot")
    print("SO_RESULT " + json.dumps(result), flush=True)
    torch.distributed.destroy_process_group()


# each split step's launches, one dense update besides: (a) the table
# exchange's bag and the windowed stateful entry on the rank's block; (b)
# the masked bags and the windowed stateful entry on the row block; (c)
# a bag and a stateful update a table on its columns, under stochastic
# rounding also the two rounding passes a table; (d) the masked bags and
# kernel 4 summing the block's dense gradient; (e) as the world-1 run
SO_LAUNCHES = {
    "a_adam": {"embedding_bag": 1, "stateful_update_rows": 1},
    "a_momentum": {"embedding_bag": 1, "stateful_update_rows": 1},
    "b": {"embedding_bag": 1, "stateful_update_rows": 1},
    "c_adam": {"embedding_bag": T, "stateful_update_rows": T},
    "c_sr": {"embedding_bag": T, "stateful_update_rows": T, "row_amax": T,
             "fake_quant_rows_amax": T},
    "d": {"embedding_bag": 1, "sharded_scatter_add_rows": 1},
}
SO_ADAM_RUNS = ("a_adam", "b", "c_adam", "e")
# the Adam runs that also run the witness: the same model on the same
# ranks with every op data-parallel (the tables whole on each rank)
SO_WITNESS_RUNS = ("a_adam", "c_adam")
# (e): the share of a parameter's values whose update may be off by more
# than DIST_UPDATE_TOL of the world-1 run's largest (flipped Adam steps)
SO_FLIP_SHARE = 1e-7
SO_NAMES = {
    "a_adam": "(a) run_random.sh's stacked tables by table, Adam",
    "a_momentum": "(a) run_random.sh's stacked tables by table, momentum "
                  "with weight decay",
    "b": "(b) Kaggle's concatenated table in row blocks, Adam",
    "c_adam": "(c) run_random.sh's widths unfused, each Embedding by "
              "width, Adam",
    "c_sr": "(c) the same under int8 stochastic rounding, compile()'s "
            "default optimizer",
    "d": "(d) Kaggle, the launcher, --dense-embedding-update: row blocks",
    "e": "(e) the fused \"dot\", Adam",
}


def splitopt_phase(dev):
    """Phase 17: the windowed stateful entry and the two rounding passes
    at the paths' shapes, then SO_WORLD ``--splitopt-rank`` children on
    the card, their results held. Returns (the kernels' rows, the
    children's launch counts, summed)."""
    t0 = time.perf_counter()
    rows = splitopt_kernels(dev)
    torch.cuda.empty_cache()
    work = WORK_DIR / "splitopt"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        outs = run_rank_children("--splitopt-rank", "SO_RESULT", work,
                                 world=SO_WORLD)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts = _so_held(outs)
    _so_report(outs)
    print(f"split tables under every optimizer phase: "
          f"{time.perf_counter() - t0:.1f} s")
    return rows, counts


def _so_held(outs):
    """Phase 17's checks of the children's results; returns their launch
    counts, summed."""
    counts = {}
    for out in outs:
        check(out["backend"] == "gloo", f"ranks: backend {out['backend']}")
        for name, run in out["runs"].items():
            if name == "e":
                per_step = {k: v // TP_STEPS
                            for k, v in run["world1_counts"].items()
                            if ":" not in k and k != "scatter_presort"
                            and k != "dense_update"}
                launches = {"e": per_step}
            else:
                launches = SO_LAUNCHES
            tables = {k for k in run["updates"]
                      if name == "c_sr" and k.startswith("emb_")}
            # Adam's step is about alpha times the sign of the gradient
            # wherever |g| is above eps: where the ranks' summation order
            # moves a gradient across 0 (or a relu unit's input), a whole
            # step of a value flips, and the steps after it see other
            # weights. Against world 1 the first step's moments are held
            # (as phase 15 holds them), and the losses: (a) and (c) to the
            # one after the first update, their every weight, slab and
            # loss held against the witness run instead, the same ranks'
            # order with the tables whole (_so_witness); (e) all of them,
            # and at most SO_FLIP_SHARE of any parameter's values off
            flipped = name in SO_WITNESS_RUNS or name == "e"
            add_counts(counts, _tp_check(
                out, name, run, SO_WORLD, launches, SO_NAMES, exempt=tables,
                held="first_state" if flipped else "updates",
                upto=2 if name in SO_WITNESS_RUNS else None))
            if name in SO_WITNESS_RUNS:
                _so_witness(out, name, run)
            if name == "e":
                many = {k: v for k, v in run["beyond"].items()
                        if v > SO_FLIP_SHARE}
                check(not many,
                      f"{SO_NAMES[name]}, rank {out['rank']}: shares of "
                      f"values off by more than {DIST_UPDATE_TOL} of the "
                      f"world-1 run's largest update above "
                      f"{SO_FLIP_SHARE}: {many}")
            stateful = run["counts"].get("stateful_update_rows", 0)
            check(run["counts"].get("stateful_update_rows:fused", 0)
                  == stateful,
                  f"{SO_NAMES[name]}, rank {out['rank']}: the stateful "
                  f"entry left its one-launch route: {run['counts']}")
            lr = run.get("launcher")
            if lr is not None:
                c, steps = lr["counts"], lr["steps"] + 1
                check(c.get("embedding_bag") == steps
                      and c.get("sharded_scatter_add_rows") == steps
                      and c.get("dense_update") == steps
                      and lr["plain_calls"] == 0 and lr["loss_finite"]
                      and run["split"][0] == "rows"
                      and run["split"][2] == SO_WORLD,
                      f"{SO_NAMES[name]} (launcher), rank {out['rank']}: "
                      f"launches {c}, {lr['plain_calls']} plain calls, "
                      f"finite {lr['loss_finite']}, split {run['split']}")
                add_counts(counts, c)
        sr = out["runs"]["c_sr"]["after"]
        check(sr["rounded_bitwise"]
              and max(sr["code_steps"].values()) <= 1.0 + 1e-3,
              f"{SO_NAMES['c_sr']}, rank {out['rank']}: the rounding of a "
              f"step bitwise one card's {sr['rounded_bitwise']}; tables "
              f"against the world-1 run's, in codes: {sr['code_steps']}")
        check(out["runs"]["e"]["world1_counts"].get("fused_interaction", 0)
              > 0, f"{SO_NAMES['e']}: the fused interaction never launched")
    for name in outs[0]["runs"]:
        _tp_copies(outs, name, SO_NAMES)
    for name in SO_ADAM_RUNS + ("a_momentum",):
        check(any(k.startswith(("m:", "v:")) for k in
                  outs[0]["runs"][name]["updates"]),
              f"{SO_NAMES[name]}: no optimizer state was held")
    return counts


def _so_witness(out, name, run):
    """The split run against the witness run (``_tp_held``'s "witness"):
    both start bitwise equal, every loss within DIST_LOSS_RTOL, every
    weight's and slab's update within DIST_UPDATE_TOL of the witness's
    largest."""
    w = run["witness"]
    bad = {k: v for k, v in w["updates"].items()
           if not v <= DIST_UPDATE_TOL}
    check(w["same_init"] and not bad and np.allclose(
        run["losses"], w["losses"], rtol=DIST_LOSS_RTOL),
        f"{SO_NAMES[name]}, rank {out['rank']}: against the tables whole "
        f"on each rank: start bitwise {w['same_init']}, losses "
        f"{run['losses']} against {w['losses']}, updates beyond "
        f"{DIST_UPDATE_TOL} of the largest {bad}")


def _so_report(outs):
    med = lambda v: float(np.median(v)) if v else float("nan")  # noqa
    for name in outs[0]["runs"]:
        runs = [o["runs"][name] for o in outs]
        r0 = runs[0]
        first = max([v for r in runs for v in r["first_state"].values()]
                    + [0.0])
        print(f"split tables under every optimizer, {SO_NAMES[name]}: step "
              f"ms (median after the first, rank 0) world {SO_WORLD} "
              f"{med(r0['step_ms']):.3f}, world 1 "
              f"{med(r0['world1_step_ms']):.3f}; losses {r0['losses']} "
              f"against {r0['world1_losses']}; each update within "
              f"{max(max(r['updates'].values()) for r in runs):.3g} of its "
              f"largest (slabs included; the largest share of values off "
              f"by more than {DIST_UPDATE_TOL} of it "
              f"{max(max(r['beyond'].values()) for r in runs):.3g}), each "
              f"weight within "
              f"{max(max(r['errs'].values()) for r in runs):.3g}, the first "
              f"step's state within {first:.3g}; launches a rank "
              f"{r0['counts']}; every copy bitwise equal across the ranks")
        w = r0.get("witness")
        if w is not None:
            worst = max(max(r["witness"]["updates"].values()) for r in runs)
            print(f"  against the same ranks with the tables whole on each "
                  f"(data-parallel): bitwise "
                  f"{[r['witness']['bitwise'] for r in runs]}; its losses "
                  f"{w['losses']}; each update within {worst:.3g} of its "
                  f"largest; step ms {med(w['step_ms']):.3f}")
        if "after" in r0:
            print(f"  stochastic rounding: a step's rounding bitwise one "
                  f"card's {[r['after']['rounded_bitwise'] for r in runs]};"
                  f" tables against world 1's, in codes "
                  f"{[r['after']['code_steps'] for r in runs]}")
        for k, st in r0["collectives"].items():
            if st["calls"]:
                print(f"  {k} a step: {st['calls'] / TP_STEPS:g} calls, "
                      f"{st['bytes'] / TP_STEPS:,.0f} bytes sent and "
                      f"received less the kept blocks, "
                      f"{st['sent'] / TP_STEPS:,.0f} handed over, "
                      f"{st['seconds'] / TP_STEPS:.4f} s (host clock, "
                      f"gloo's host copies included)")
        lr = r0.get("launcher")
        if lr is not None:
            print(f"  the launcher (--dense-embedding-update): "
                  f"{lr['steps']} steps, {lr['throughput']:.2f} samples/s")


# ---------------------------------------------------------------------
# phase 18: training across ranks as fit runs it
# ---------------------------------------------------------------------
# FR_WORLD gloo ranks on the card. (a) run_criteo_kaggle.sh's flags at
# -ll:gpu FR_WORLD -b FR_KAGGLE_B from an .ffbin of FR_KAGGLE_BATCHES
# global batches of synthetic Kaggle-shaped samples, through the ring and
# with --no-prefetch, against world 1 on the same file; (b) "cat" at
# run_random.sh's widths under dlrm_strategy (split by table), momentum
# 0.9 with weight decay 1e-4, global batch FR_B, FR_FIT_STEPS steps, a
# snapshot every FR_FIT_STEPS // 2 steps (keep_last 1), stopped as the
# step after it begins and resumed by fresh ranks; (c) the sentinel in
# fit on Kaggle (SGD, FR_KAGGLE_B, FR_SENT_STEPS steps), rank 1's share
# poisoned at FR_POISON; (d) the Kaggle launcher with --host-tables
# (exact) and FR_HOST_STEPS momentum steps of host against device
# tables; (e) fit_stream of "cat" row-sharded, a publish every
# FR_EVERY steps, a full one every FR_FULL_EVERY + 1 publishes, for
# FR_PUBLISHES publishes, followed by a one-card engine (reshard=True)
FR_WORLD = 2
FR_KAGGLE_B = 256 * FR_WORLD
FR_KAGGLE_BATCHES = 16
FR_B = 512
FR_FIT_STEPS = 24
FR_SENT_STEPS = 6
FR_POISON = 5
FR_HOST_STEPS = 3
FR_EVERY = 8
FR_FULL_EVERY = 3
FR_PUBLISHES = 4


def _fr_kaggle_flags(work, *extra):
    return (tp_kaggle_flags() + ["--data-path", str(work / "kaggle.ffbin")]
            + list(extra))


def _fr_launcher(flags):
    """The launcher on ``flags``, every count at 0 just before it and read
    just after, plain versions counted: its summary."""
    from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
    zero_counts()
    with PlainCalls() as plain:
        out = launcher.main(flags)
    model = out["model"]
    run = {"steps": out["steps"], "throughput": out["throughput"],
           "mse": float(model.perf.report()["mse"]), "plain": plain.calls,
           "counts": {k: v for k, v in read_counts().items() if v}}
    return run, model


def _fr_crc(a):
    import zlib
    return zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B"))


def _fr_pieces(m):
    """{name: a tensor of this rank} of its parameters and slabs."""
    out = {f"{o}.{p}": v for o, d in m.params.items() for p, v in d.items()}
    for k, tree in (m.opt_state or {}).items():
        if k != "step":
            out.update({f"{k}:{o}.{p}": v for o, d in tree.items()
                        for p, v in d.items()})
    return out


def _fr_cat(seed, stage="never", policy="none", row_shard=False):
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    cfg = train_config("cat")
    m = FFModel(FFConfig(batch_size=FR_B, seed=SEED, device="cuda:0",
                         stage_dataset=stage, anomaly_policy=policy))
    build_dlrm(m, cfg)
    mesh = make_mesh()
    opt = (SGDOptimizer(lr=LR) if row_shard else
           SGDOptimizer(lr=LR, momentum=0.9, weight_decay=1e-4))
    m.compile(opt, "mean_squared_error", ["mse"], mesh=mesh,
              strategies=dlrm_strategy(m, cfg, mesh.size,
                                       row_shard=row_shard))
    m.init_layers(seed=seed)
    return m, cfg


class _FrManagers:
    """While installed, every CheckpointManager ``fit`` makes is kept (for
    its ``last_save``) and its restores are timed."""

    def __enter__(self):
        from dlrm_flexflow_tpu_torch.utils import checkpoint as ckpt_mod
        self.mod, self.real = ckpt_mod, ckpt_mod.CheckpointManager
        made, restores = self.made, self.restores = [], []

        class Kept(self.real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

            def restore_latest(self, model):
                t0 = time.perf_counter()
                entry = super().restore_latest(model)
                restores.append(time.perf_counter() - t0)
                return entry

        ckpt_mod.CheckpointManager = Kept
        return self

    def __exit__(self, *exc):
        self.mod.CheckpointManager = self.real


def _fr_fit_stop(work):
    """(b), first ranks: the fit through the ring with a snapshot every
    FR_FIT_STEPS // 2 steps, stopped as the step after it begins."""
    half = FR_FIT_STEPS // 2
    m, cfg = _fr_cat(SEED)
    x, y = synthetic_batch(cfg, FR_FIT_STEPS * FR_B, seed=SEED + 60)
    real, calls = m.train_batch_staged, []

    def crashing(staged, **kw):
        calls.append(1)
        if len(calls) == half + 1:
            raise SimulatedCrash()
        return real(staged, **kw)

    m.train_batch_staged = crashing
    stopped = False
    with _FrManagers() as mk:
        try:
            m.fit(x, y, epochs=1, batch_size=FR_B, verbose=False,
                  checkpoint_dir=str(work / "fit"), save_every=half,
                  keep_last=1)
        except SimulatedCrash:
            stopped = True
    save = mk.made[-1].last_save
    del m
    gc.collect()
    torch.cuda.empty_cache()
    return {"stopped": stopped, "save": save}


def _fr_fit_resume(work):
    """(b), fresh ranks: a model from other weights resumes the stopped
    fit from its snapshot to the end; then the uninterrupted fit from the
    first weights, staged; every piece and slab bitwise."""
    half = FR_FIT_STEPS // 2
    resumed, cfg = _fr_cat(SEED + 1)
    x, y = synthetic_batch(cfg, FR_FIT_STEPS * FR_B, seed=SEED + 60)
    t0 = time.perf_counter()
    with _FrManagers() as mk:
        out = resumed.fit(x, y, epochs=1, batch_size=FR_B, verbose=False,
                          checkpoint_dir=str(work / "fit"), keep_last=1)
    resume_s = time.perf_counter() - t0
    zero_counts()
    whole, _ = _fr_cat(SEED, stage="auto")
    with PlainCalls() as plain:
        t1 = time.perf_counter()
        whole.fit(x, y, epochs=1, batch_size=FR_B, verbose=False)
        fit_s = time.perf_counter() - t1
    counts = {k: v for k, v in read_counts().items() if v}
    a, b = _fr_pieces(resumed), _fr_pieces(whole)
    run = {"samples": out["num_samples"], "steps": resumed._step,
           "bitwise": {k: bool(torch.equal(v, b[k])) for k, v in a.items()},
           "resume_s": resume_s, "restore_s": mk.restores,
           "final_save": mk.made[-1].last_save, "counts": counts,
           "plain": plain.calls,
           "samples_s": FR_FIT_STEPS * FR_B / fit_s,
           "split": {op.name: op._split.kind for op in whole.ops
                     if getattr(op, "_split", None) is not None}}
    check(out["num_samples"] == half * FR_B, f"(b) resumed "
          f"{out['num_samples']} samples")
    del resumed, whole, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return run


def _fr_kaggle_model(policy="none", momentum=0.0, **cfg):
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    dcfg = DLRMConfig.criteo_kaggle()
    m = FFModel(FFConfig(batch_size=FR_KAGGLE_B, seed=SEED,
                         device="cuda:0", anomaly_policy=policy,
                         stage_dataset="never", **cfg))
    build_dlrm(m, dcfg)
    mesh = make_mesh()
    m.compile(SGDOptimizer(lr=LR, momentum=momentum), "mean_squared_error",
              ["mse"], mesh=mesh,
              strategies=dlrm_strategy(m, dcfg, mesh.size))
    m.init_layers()
    return m, dcfg


def _fr_sentinel(work, rank):
    """(c): skip_step and rollback fits with rank 1's share poisoned at
    FR_POISON, the flags each step, the launches; the no-anomaly
    skip_step fit and a rollback fit against the fit without the
    sentinel, bitwise."""
    from dlrm_flexflow_tpu_torch.utils import faults
    dcfg = DLRMConfig.criteo_kaggle()
    x, y = synthetic_batch(dcfg, FR_SENT_STEPS * FR_KAGGLE_B, seed=SEED + 61)
    kw = dict(epochs=1, batch_size=FR_KAGGLE_B, verbose=False)
    out = {}

    def poisoned(on):
        plan = (faults.FaultPlan(nan_grad_steps={FR_POISON})
                if on and rank == 1 else None)
        return faults.active_plan(plan)

    def flags_of(m):
        """(each finished step's anomaly flag, the steps begun)."""
        got, begun, real = [], [], m.train_batch_staged

        def rec(staged, **k):
            begun.append(m._step)
            mets = real(staged, **k)
            got.append(bool(mets["anomaly"]))
            return mets

        m.train_batch_staged = rec
        return got, begun

    ref, _ = _fr_kaggle_model()
    ref.fit(x, y, **kw)
    want = _fr_pieces(ref)
    runs = (("skip_step", True, None), ("skip_step", False, None),
            ("rollback", True, str(work / "rollback")))
    for policy, poison, ckdir in runs:
        m, _ = _fr_kaggle_model(policy)
        flags, begun = flags_of(m)
        zero_counts()
        with PlainCalls() as plain, poisoned(poison):
            r = m.fit(x, y, checkpoint_dir=ckdir,
                      save_every=4 if ckdir else None, keep_last=1, **kw)
        counts = read_counts()
        got = _fr_pieces(m)
        key = f"{policy}/{'poisoned' if poison else 'clean'}"
        out[key] = {
            "flags": flags, "begun": begun, "rollbacks": r["rollbacks"],
            "steps": m._step, "counts": {k: v for k, v in counts.items()
                                         if v},
            "sumsq": counts["grad_sumsq"], "plain": plain.calls,
            "bitwise": all(torch.equal(v, want[k]) for k, v in got.items())}
        del m, got
        gc.collect()
        torch.cuda.empty_cache()
    del ref, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _fr_host(work, rank):
    """(d): the Kaggle launcher with --host-tables, exact, from the file
    (its host split traced), the ranks' copies' CRC-32; then
    FR_HOST_STEPS momentum steps with the tables on the host against the
    same steps with them on the card, from the same tables."""
    from dlrm_flexflow_tpu_torch.obs import trace as obst
    from dlrm_flexflow_tpu_torch.utils.weights import params_from_jax
    obst.clear()
    with obst.override(True, capacity=65536):
        run, model = _fr_launcher(_fr_kaggle_flags(
            work, "--host-tables", "--no-host-tables-async",
            "--no-prefetch"))
        steps = run["steps"] + 1
        run["split_ms"] = {k: span_ms(f"host/{k}", steps) for k in
                           ("gather", "h2d", "readback", "scatter")}
    obst.clear()
    run["host"] = [op.name for op in model._host_resident_list]
    run["crc"] = _fr_crc(model.host_params["emb_concat"]["kernel"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    hm, dcfg = _fr_kaggle_model(momentum=0.9, host_resident_tables=True,
                                host_tables_async=False)
    dm, _ = _fr_kaggle_model(momentum=0.9)
    table = hm.host_params["emb_concat"]["kernel"]
    dm.swap_params(params_from_jax(dm, {
        **{o: {p: v.cpu().numpy() for p, v in d.items()}
           for o, d in hm.params.items()},
        "emb_concat": {"kernel": table}}))
    for s in range(FR_HOST_STEPS):
        bx, by = synthetic_batch(dcfg, FR_KAGGLE_B, seed=SEED + 70 + s)
        bx["label"] = by
        hm.train_batch(bx)
        dm.train_batch(bx)
    with dm._as_one_card() as whole:
        dev_table = whole["emb_concat"]["kernel"].cpu().numpy()
    run["momentum_table_bitwise"] = bool(np.array_equal(
        hm.host_params["emb_concat"]["kernel"], dev_table))
    run["momentum_mlp_bitwise"] = all(
        torch.equal(v, dm.params[o][p]) for o, d in hm.params.items()
        for p, v in d.items())
    del hm, dm, dev_table
    gc.collect()
    torch.cuda.empty_cache()
    return run


def _fr_stream(work, rank):
    """(e): fit_stream of "cat" row-sharded (the dense exchange), a
    DeltaPublisher into work/loop: each publish's gathered state's CRC-32
    per array (rank 0), the publish seconds."""
    from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
    from dlrm_flexflow_tpu_torch.utils.delta import DeltaPublisher
    m, cfg = _fr_cat(SEED + 3, row_shard=True)
    steps = FR_EVERY * FR_PUBLISHES
    x, y = synthetic_batch(cfg, steps * FR_B, seed=SEED + 62)
    pub = DeltaPublisher(m, str(work / "loop"), keep_last=2,
                         full_every=FR_FULL_EVERY, compact_frac=100.0)
    digests, pubs, times = {}, [], {}

    def cb(model, trained, mets):
        if trained % FR_EVERY == 0:
            times[trained] = time.time()
            pubs.append(dict(pub.last_publish))
            if pub._writer:
                digests[trained] = {k: _fr_crc(v)
                                    for k, v in pub._last_flat.items()}

    zero_counts()
    with PlainCalls() as plain:
        r = m.fit_stream(ArrayStream(x, y, FR_B, seed=SEED),
                         steps=steps, publisher=pub,
                         publish_every=FR_EVERY, verbose=False,
                         callbacks=[cb])
    out = {"steps": r["steps"], "publishes": r["publishes"],
           "digests": {str(k): v for k, v in digests.items()},
           "times": {str(k): v for k, v in times.items()},
           "pubs": pubs, "plain": plain.calls,
           "counts": {k: v for k, v in read_counts().items() if v},
           "row_plan": [op.name for op in m.ops
                        if getattr(op, "_row_plan", None) is not None]}
    del m, pub
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fitranks_rank_child(rank, world, store, part):
    """``chip_smoke.py --fitranks-rank`` / ``--fitranks-resume-rank RANK
    WORLD STORE``: one rank of phase 18, joined to the gloo group through
    the file store. The first ranks: (a) the Kaggle launcher from the
    file through the ring and without it, (b) the fit stopped after its
    snapshot, (d) host tables; the fresh ranks: (b) resumed, (c) the
    sentinel, (e) the online loop. Prints ``FR_RESULT {json}``."""
    from dlrm_flexflow_tpu_torch.parallel import distributed
    distributed.initialize_distributed(
        init_method=f"file://{store}", num_processes=world,
        process_id=rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(store).parent.parent       # the phase's directory
    result = {"rank": rank, "backend": torch.distributed.get_backend(),
              "runs": {}}
    runs = result["runs"]
    t0 = time.perf_counter()
    if part == 1:
        runs["a"] = {}
        for label, extra in (("ring", ["--prefetch-depth", "2"]),
                             ("no prefetch", ["--no-prefetch"])):
            runs["a"][label], model = _fr_launcher(
                _fr_kaggle_flags(work, *extra))
            del model
            gc.collect()
            torch.cuda.empty_cache()
        runs["b"] = _fr_fit_stop(work)
        runs["d"] = _fr_host(work, rank)
    else:
        runs["b"] = _fr_fit_resume(work)
        runs["c"] = _fr_sentinel(work, rank)
        runs["e"] = _fr_stream(work, rank)
    result["seconds"] = time.perf_counter() - t0
    print("FR_RESULT " + json.dumps(result), flush=True)
    torch.distributed.destroy_process_group()


def fitranks_sumsq(dev):
    """grad_sumsq across ranks at the "cat" step's shapes: the first
    launch over a rank's own gradients (its rows' cotangent, FR_B / 2 x
    T x D) into a slot, the second over the replicated MLP gradients
    with the slot as its addend: bitwise the second list's own sum plus
    the slot in fp32 and its root, within rtol 1e-5 of the plain version
    over both lists; one launch alone bitwise as before (a rerun)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    model, _ = train_model("cat", "cuda")
    sparse = {op.name for op in model._select_sparse_update_ops()}
    rep = [torch.randn(tuple(d.shape), device=dev, generator=gen)
           for op in model.ops if op.name not in sparse
           for d in op.param_defs().values()]
    own = [torch.randn((FR_B // FR_WORLD, T, D), device=dev, generator=gen)]
    del model
    loss = torch.tensor(0.25, device=dev)
    before = dense_mod.grad_sumsq.launches
    slot = torch.zeros(2, device=dev)
    with PlainCalls() as plain:
        dense_mod.grad_sumsq(own, loss, out=slot[0:1])
        gsq, norm, ok = dense_mod.grad_sumsq(rep, slot[1], addend=slot[0:1])
        alone = dense_mod.grad_sumsq(rep, loss)
        again = dense_mod.grad_sumsq(rep, loss)
    check(plain.calls == 0 and dense_mod.grad_sumsq.launches - before == 4,
          f"grad_sumsq across ranks: {plain.calls} plain calls, "
          f"{dense_mod.grad_sumsq.launches - before} launches (4 wanted)")
    check(dense_mod.grad_sumsq.routes["own"] >= 1
          and dense_mod.grad_sumsq.routes["replicated"] >= 1,
          f"grad_sumsq across ranks: routes {dense_mod.grad_sumsq.routes}")
    want = (alone[0] + slot[0]).view(())
    check(torch.equal(gsq, want) and torch.equal(norm, torch.sqrt(want))
          and int(ok) == 1,
          f"grad_sumsq across ranks: {float(gsq)!r}, {float(norm)!r} "
          f"against the second list's own sum plus the slot "
          f"{float(want)!r}")
    check(all(torch.equal(a, b) for a, b in zip(alone, again)),
          "grad_sumsq: one launch alone is not bitwise a rerun")
    pslot = torch.zeros(2, device=dev)
    dense_mod.grad_sumsq_reference(own, loss, out=pslot[0:1])
    pgsq, pnorm, _ = dense_mod.grad_sumsq_reference(rep, pslot[1],
                                                    addend=pslot[0:1])
    err = abs(float(norm) - float(pnorm))
    check(abs(float(gsq) - float(pgsq)) <= 1e-5 * float(pgsq)
          and err <= 1e-5 * float(pnorm),
          f"grad_sumsq across ranks: {float(gsq)}, {float(norm)} against "
          f"the plain {float(pgsq)}, {float(pnorm)}")
    nan = own[0].clone()
    nan.view(-1)[7] = float("nan")
    dense_mod.grad_sumsq([nan], loss, out=slot[0:1])
    check(int(dense_mod.grad_sumsq(rep, slot[1], addend=slot[0:1])[2]) == 0,
          "grad_sumsq across ranks: a NaN in the first launch's list "
          "passes the second's flag")
    print(f"grad_sumsq across ranks (\"cat\" at global batch {FR_B}, "
          f"{FR_WORLD} ranks): two launches bitwise the second list's sum "
          f"plus the first's slot, norm {float(norm):.6g}, within "
          f"{err:.3g} of the plain version; one launch alone bitwise a "
          f"rerun; a NaN in the first list clears the flag")
    del rep, own, nan
    torch.cuda.empty_cache()


def _fr_follow(work, stop, seen):
    """(e)'s engine: a one-card "cat" model (the strategy as the trainer's,
    whole on one card) behind an engine with reshard=True, its watcher
    polling work/loop until ``stop``; each install's (version, wall time,
    CRC-32 of each served array) into ``seen``, and the rejects of an
    engine without reshard."""
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.serve.watcher import SnapshotWatcher
    from dlrm_flexflow_tpu_torch.utils.weights import params_to_jax
    cfg = train_config("cat")

    def engine(reshard):
        m = FFModel(FFConfig(batch_size=FR_B, seed=SEED, device="cuda:0"))
        build_dlrm(m, cfg)
        mesh = make_mesh(devices=[0])
        m.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"],
                  mesh=mesh, strategies=dlrm_strategy(m, cfg, 1,
                                                      row_shard=True))
        m.init_layers()
        return InferenceEngine(m, ServeConfig(max_batch=8, warmup=False,
                                              reshard=reshard))

    eng = engine(True)
    w = SnapshotWatcher(eng, str(work / "loop"), elastic=True)
    plain_w = None
    while not stop.is_set():
        if not (work / "loop" / "manifest.json").exists():
            time.sleep(0.05)
            continue
        if plain_w is None:
            plain_eng = engine(False)
            plain_w = SnapshotWatcher(plain_eng, str(work / "loop"))
            plain_w.poll_once()
            seen["plain_reject"] = plain_w.stats()["last_reload_error"]
            seen["plain_version"] = plain_eng.version
            del plain_eng
            torch.cuda.empty_cache()
        if w.poll_once():
            t = time.time()
            flat = params_to_jax(eng.model, eng.model.params)
            seen["installs"].append(
                (eng.version, t, {f"params/{o}/{p}": _fr_crc(v)
                                  for o, d in flat.items()
                                  for p, v in d.items()}))
        else:
            time.sleep(0.05)
    seen["watcher"] = w.stats()


def fitranks_phase(dev):
    """Phase 18: grad_sumsq's across-ranks form, then FR_WORLD
    ``--fitranks-rank`` children (the launcher, the stopped fit, host
    tables), world 1's launcher on the same file, and FR_WORLD
    ``--fitranks-resume-rank`` children (the resumed fit, the sentinel,
    the online loop, followed by an engine in this process). Returns the
    children's launch counts, summed."""
    from dlrm_flexflow_tpu_torch.data.dataloader import write_ffbin
    t0 = time.perf_counter()
    fitranks_sumsq(dev)
    work = WORK_DIR / "fitranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    counts = {}
    try:
        free = shutil.disk_usage(work).free
        check(free >= 16e9, f"fitranks: {free / 1e9:.1f} GB free under "
              f"{work}, the phase's snapshots need 16 GB")
        dcfg = DLRMConfig.criteo_kaggle()
        x, y = synthetic_batch(dcfg, FR_KAGGLE_BATCHES * FR_KAGGLE_B,
                               seed=SEED + 63)
        write_ffbin(str(work / "kaggle.ffbin"), x["dense"], x["sparse"], y)
        del x, y
        outs1 = run_rank_children("--fitranks-rank", "FR_RESULT",
                                  work / "first", timeout=400,
                                  world=FR_WORLD)
        one = {}
        for label, extra in (("device", ()), ("host", (
                "--host-tables", "--no-host-tables-async"))):
            one[label], model = _fr_launcher(["-ll:gpu", "1"]
                                             + _fr_kaggle_flags(
                                                 work, "--no-prefetch",
                                                 *extra)[2:])
            del model
            gc.collect()
            torch.cuda.empty_cache()
        stop, seen = threading.Event(), {"installs": []}
        follower = threading.Thread(target=_fr_follow,
                                    args=(work, stop, seen), daemon=True)
        follower.start()
        try:
            outs2 = run_rank_children("--fitranks-resume-rank", "FR_RESULT",
                                      work / "fresh", timeout=500,
                                      world=FR_WORLD)
            deadline = time.time() + 60
            while (not seen["installs"] or seen["installs"][-1][0]
                   < FR_EVERY * FR_PUBLISHES) and time.time() < deadline:
                time.sleep(0.1)
        finally:
            stop.set()
            follower.join(120)
        counts = _fr_held(outs1, outs2, one, seen, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"training across ranks as fit runs it phase: "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def _fr_held(outs1, outs2, one, seen, work):
    """Phase 18's checks and report; returns the children's launch
    counts, summed."""
    counts = {}
    one, one_host = one["device"], one["host"]

    def add(c):
        add_counts(counts, c)

    for outs in (outs1, outs2):
        for out in outs:
            check(out["backend"] == "gloo", f"fitranks: backend "
                  f"{out['backend']}")
    # (a) the launcher from the file
    for label in ("ring", "no prefetch"):
        runs = [o["runs"]["a"][label] for o in outs1]
        for r in runs:
            steps = r["steps"] + 1              # the warm-up step
            c = r["counts"]
            check(r["steps"] == FR_KAGGLE_BATCHES and r["plain"] == 0
                  and c.get("dense_update") == steps
                  and c.get("embedding_bag", 0) >= steps
                  and c.get("sharded_scatter_add_rows", 0) >= steps,
                  f"(a) {label}: {r['steps']} steps, {r['plain']} plain "
                  f"calls, launches {c}")
            check(abs(r["mse"] - one["mse"]) <= DIST_LOSS_RTOL
                  * abs(one["mse"]),
                  f"(a) {label}: mse {r['mse']!r} against world 1's "
                  f"{one['mse']!r}")
            add(c)
        print(f"fit across ranks (a) the Kaggle launcher at -ll:gpu "
              f"{FR_WORLD} -b {FR_KAGGLE_B} from an .ffbin, {label}: "
              f"{runs[0]['steps']} steps, "
              f"{[round(r['throughput'], 1) for r in runs]} samples/s (rank "
              f"0, 1), mse {runs[0]['mse']!r} against world 1's "
              f"{one['mse']!r} ({one['throughput']:.1f} samples/s); "
              f"launches a rank {runs[0]['counts']}")
    # (b) the stopped fit, resumed by fresh ranks
    b1 = [o["runs"]["b"] for o in outs1]
    b2 = [o["runs"]["b"] for o in outs2]
    check(all(r["stopped"] for r in b1), "(b) the fit did not stop")
    for r in b2:
        bad = [k for k, ok in r["bitwise"].items() if not ok]
        check(r["steps"] == FR_FIT_STEPS and not bad and r["plain"] == 0,
              f"(b) resumed to step {r['steps']}, not bitwise at {bad}, "
              f"{r['plain']} plain calls")
        c = r["counts"]
        check(c.get("dense_update") == FR_FIT_STEPS
              and c.get("stateful_update_rows", 0) >= FR_FIT_STEPS,
              f"(b) the uninterrupted fit's launches {c}")
        add(c)
    save = b1[0]["save"]
    fin = b2[0]["final_save"]
    gb = save["bytes"] / 1e9
    print(f"fit across ranks (b) \"cat\" split by table ({b2[0]['split']}),"
          f" momentum: stopped as step {FR_FIT_STEPS // 2 + 1} began, "
          f"resumed by fresh ranks to step {FR_FIT_STEPS}: every piece and "
          f"slab bitwise the uninterrupted fit on both ranks; snapshot "
          f"{save['bytes']:,} bytes (rank 0's file), the gather to rank 0 "
          f"with the copies {save['gather_s']:.2f} s "
          f"({gb / save['gather_s']:.2f} GB/s), the write "
          f"{save['file_write_s']:.2f} s ({gb / save['file_write_s']:.2f} "
          f"GB/s, fsync included; the manifest and checksum: "
          f"{save['write_s']:.2f} s in all); restore (the CRC-32 on rank 0"
          f", every rank reading the file) {b2[0]['restore_s']} s on rank "
          f"0, {b2[1]['restore_s']} on rank 1; the final snapshot "
          f"{fin.get('gather_s', 0.0):.2f} s to gather, "
          f"{fin.get('file_write_s', 0.0):.2f} s to write; the staged fit "
          f"{b2[0]['samples_s']:.1f} samples/s")
    # (c) the sentinel
    c_runs = [o["runs"]["c"] for o in outs2]
    want = [i == FR_POISON for i in range(FR_SENT_STEPS)]
    for r in c_runs:
        sp, sc, rb = (r["skip_step/poisoned"], r["skip_step/clean"],
                      r["rollback/poisoned"])
        check(sp["flags"] == want and sc["flags"] == [False] * FR_SENT_STEPS,
              f"(c) skip_step flags {sp['flags']}, clean {sc['flags']}")
        check(sc["bitwise"], "(c) skip_step with no anomaly is not bitwise "
              "the fit without the sentinel")
        check(rb["rollbacks"] == 1 and rb["steps"] == FR_SENT_STEPS
              and rb["bitwise"],
              f"(c) rollback: {rb['rollbacks']} rollbacks to step "
              f"{rb['steps']}, bitwise the clean fit: {rb['bitwise']}")
        for k in ("skip_step/poisoned", "skip_step/clean",
                  "rollback/poisoned"):
            v = r[k]
            n = len(v["begun"])
            check(v["sumsq"] == 2 * n and v["plain"] == 0
                  and v["counts"].get("grad_sumsq:own") == n
                  and v["counts"].get("grad_sumsq:replicated") == n,
                  f"(c) {k}: {v['sumsq']} grad_sumsq launches for {n} "
                  f"steps ({v['counts']}), {v['plain']} plain calls")
            add(v["counts"])
    check(c_runs[0]["rollback/poisoned"]["begun"]
          == c_runs[1]["rollback/poisoned"]["begun"],
          "(c) the ranks rolled back at different steps")
    print(f"fit across ranks (c) the sentinel, Kaggle, rank 1's share "
          f"poisoned at step {FR_POISON}: skip_step skipped it on both "
          f"ranks, rollback rolled back once on both (steps begun "
          f"{c_runs[0]['rollback/poisoned']['begun']}) and ended bitwise "
          f"the fit without the sentinel, as did skip_step with no "
          f"anomaly; 2 grad_sumsq launches a step, no plain version")
    # (d) host tables
    d_runs = [o["runs"]["d"] for o in outs1]
    for r in d_runs:
        check(r["steps"] == FR_KAGGLE_BATCHES and r["plain"] == 0
              and r["host"] == ["emb_concat"],
              f"(d) {r['steps']} steps, {r['plain']} plain calls, host "
              f"tables {r['host']}")
        check(abs(r["mse"] - one_host["mse"]) <= DIST_LOSS_RTOL
              * abs(one_host["mse"]),
              f"(d) mse {r['mse']!r} against world 1's host tables' "
              f"{one_host['mse']!r}")
        check(r["momentum_table_bitwise"] and r["momentum_mlp_bitwise"],
              "(d) host tables under momentum are not bitwise the device "
              "tables' run")
        add(r["counts"])
    check(d_runs[0]["crc"] == d_runs[1]["crc"],
          "(d) the ranks' copies of the host table differ")
    sm = d_runs[0]["split_ms"]
    print(f"fit across ranks (d) the Kaggle launcher with --host-tables "
          f"(exact) at {FR_WORLD} ranks: {d_runs[0]['steps']} steps, "
          f"{[round(r['throughput'], 1) for r in d_runs]} samples/s, mse "
          f"{d_runs[0]['mse']!r} against world 1's host tables' "
          f"{one_host['mse']!r} ({one_host['throughput']:.1f} samples/s); "
          f"the ranks' copies bitwise equal (CRC-32 {d_runs[0]['crc']}); a "
          f"step on rank 0: gather {sm['gather']:.2f} ms, copy "
          f"{sm['h2d']:.2f}, readback and all-gather {sm['readback']:.2f}, "
          f"scatter {sm['scatter']:.2f}; {FR_HOST_STEPS} momentum steps: "
          f"the host table and the MLPs bitwise the device tables' run")
    # (e) the online loop and the engine
    e_runs = [o["runs"]["e"] for o in outs2]
    for r in e_runs:
        check(r["steps"] == FR_EVERY * FR_PUBLISHES
              and r["publishes"] == FR_PUBLISHES and r["plain"] == 0
              and r["row_plan"] == ["emb_stack"],
              f"(e) {r['steps']} steps, {r['publishes']} publishes, "
              f"{r['plain']} plain calls, row plans {r['row_plan']}")
        add(r["counts"])
    digests = e_runs[0]["digests"]
    installs = seen["installs"]
    check(len(installs) >= 2 and installs[-1][0] == FR_EVERY * FR_PUBLISHES,
          f"(e) the engine installed {[v for v, _, _ in installs]}")
    fresh = []
    for v, t, crc in installs:
        d = digests.get(str(v))
        check(d is not None and all(d[k] == c for k, c in crc.items()),
              f"(e) the engine at version {v} does not serve the "
              f"trainer's gathered parameters")
        fresh.append(t - e_runs[0]["times"][str(v)])
    check("2-device mesh" in seen.get("plain_reject", ""),
          f"(e) an engine without reshard: {seen.get('plain_reject')!r}")
    kinds = [p.get("kind") for p in e_runs[0]["pubs"]]
    print(f"fit across ranks (e) fit_stream, \"cat\" row-sharded at "
          f"{FR_WORLD} ranks, publishes {kinds} every {FR_EVERY} steps; a "
          f"one-card engine (reshard=True) installed versions "
          f"{[v for v, _, _ in installs]}, each bitwise the trainer's "
          f"gathered parameters (CRC-32 per array); freshness p50 "
          f"{float(np.median(fresh)):.2f} s (max {max(fresh):.2f}); the "
          f"publishes' seconds {[round(p.get('total_s', 0), 2) for p in e_runs[0]['pubs']]}"
          f"; without reshard the full snapshot is rejected: "
          f"{seen['plain_reject'][:80]!r}")
    secs = [o["seconds"] for o in outs1 + outs2]
    print(f"fit across ranks: the children's seconds {secs}")
    return counts


# ---------------------------------------------------------------------
# phase 14: quantized tables trained, published and served, the row
# fake-quant kernel, and the two-tower train head
# ---------------------------------------------------------------------
QUANT_STEPS = 4      # stochastic-rounding steps of "cat" at full width
QUANT_DS = (8, 16, 64, 128)   # the kernel's widths held to the plain one
QUANT_ROWS = 4096    # rows of each of those checks
QUANT_DRAWS = 2048   # draws of one row for the unbiasedness check
QUANT_SIGMAS = 6.0   # its bound, in standard errors of the mean
TT_B = 1024          # the train head's batch: (1024, 1024) logits
TT_STEPS = 4
TT_USERS = 8         # users the cascade answers on the trained towers


def quant_model(mode="cat", fuse=False, seed=SEED, **cfg):
    """random_benchmark() at full width under a storage policy (``cfg``:
    emb_dtype, emb_update_rule), SGD, batch TRAIN_B, initialised."""
    dcfg = train_config(mode)
    model = FFModel(FFConfig(batch_size=TRAIN_B, seed=seed, device="cuda",
                             **cfg))
    build_dlrm(model, dcfg, fuse_interaction=fuse)
    model.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"])
    model.init_layers()
    return model, dcfg


def fixed_point_error(t, w, dt):
    """How far the w-wide rows of ``t`` (on the card) are from quantized
    images: (the largest |x / s - code| of an int8 row under its own
    scale s, 0 for fp8; the largest |fake_quant(x) - x| over (qmax + 1)
    ulps of the row's scale, over the rows whose largest code is qmax;
    the rows whose largest code is 126). A stochastic-rounding row is
    its integer codes times the scale it was quantized with, s = amax /
    127 before the rounding: its largest value's x / s lies within an ulp
    of 127 and rounds to 127, or to 126 where it fell short and u was
    smaller than the shortfall; such a row is still codes times one
    scale, s = amax / 126, but nearest re-quantization (scale amax / 127)
    moves it by up to half a code. A row whose largest code is qmax is a
    fixed point of nearest quantization: re-quantizing recomputes its
    scale within an ulp, which moves q * s by at most |q| <= qmax
    ulps."""
    v = t.detach().reshape(-1, w)
    qmax = 127.0 if dt == "int8" else 448.0
    code_err, ulp_err, short = 0.0, 0.0, 0
    for lo in range(0, v.shape[0], 1 << 18):
        c = v[lo:lo + (1 << 18)]
        amax = c.abs().amax(dim=1)
        top = torch.ones_like(amax)
        if dt == "int8":
            errs = []
            for n in (127.0, 126.0):
                sc = amax / torch.full_like(amax, n)
                y = c / torch.where(sc > 0, sc, torch.ones_like(sc))[:, None]
                errs.append((y - torch.round(y)).abs().amax(dim=1))
            top = errs[0] < 1e-3
            short += int((~top & (errs[1] < 1e-3)).sum())
            code_err = max(code_err, float(torch.minimum(*errs).max()))
        fq = qr_mod.fake_quant_rows_reference(c.clone(), dt, "nearest")
        s = amax / torch.full_like(amax, qmax)
        _, e = torch.frexp(s)
        ulp = torch.ldexp(torch.ones_like(s), e - 24)[:, None]
        moved = torch.where(s[:, None] > 0, (fq - c).abs() / (
            (qmax + 1) * ulp), (fq - c).abs())
        ulp_err = max(ulp_err, float(torch.where(
            top.bool()[:, None], moved, torch.zeros_like(moved)).max()))
    return code_err, ulp_err, short


def check_fixed_point(t, w, dt, what):
    code_err, ulp_err, short = fixed_point_error(t, w, dt)
    check(code_err < 1e-3 and ulp_err <= 1.0,
          f"quant: {what}: a stored row is not its codes times one scale "
          f"(code error {code_err:.3g}) or moves under nearest {dt} "
          f"re-quantization ({ulp_err:.3g} x (qmax + 1) ulps of its scale)")
    return code_err, ulp_err, short


def same_params(a, b):
    return all(torch.equal(a.params[op][pn], b.params[op][pn])
               for op in a.params for pn in a.params[op])


def user_encoder(user):
    """The user head over a request's users in batches of its compiled
    batch, zero-padded: (n, dim) fp32 on the card."""
    def encode(feats):
        dense = np.asarray(feats["dense"], np.float32)
        sparse = np.asarray(feats["sparse"], np.int64)
        ub, out = user.config.batch_size, []
        for lo in range(0, dense.shape[0], ub):
            d, s = dense[lo:lo + ub], sparse[lo:lo + ub]
            pad = ub - d.shape[0]
            d = np.concatenate([d, np.zeros((pad,) + d.shape[1:],
                                            np.float32)])
            s = np.concatenate([s, np.zeros((pad,) + s.shape[1:],
                                            np.int64)])
            out.append(user.forward_batch({"user_dense": d,
                                           "user_sparse": s})[:ub - pad])
        return torch.cat(out)
    return encode


def two_tower_train():
    """(a) The two-tower train head at the cascade's own TwoTowerConfig
    (``_build_cascade``'s, around random_benchmark(): 1M items, dim 32,
    8 user tables of 1M x 8): TT_STEPS ``fit`` steps of TT_B on
    ``synthetic_two_tower_batch`` batches under the sparse softmax
    cross-entropy, every count at 0 just before and read just after;
    then the towers handed to the user and item heads by
    ``transfer_tower_params``, the catalog encoded into a 1-shard index
    and the cascade (the "cat" ranker behind an engine) answering
    TT_USERS users, retrieval bitwise to ``exact_scan``."""
    dcfg = DLRMConfig.random_benchmark()
    tcfg = two_tower_config(dcfg)
    t0 = time.perf_counter()
    model = FFModel(FFConfig(batch_size=TT_B, seed=SEED, device="cuda"))
    build_two_tower(model, tcfg, head="train")
    model.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                  ["accuracy"])
    model.init_layers()
    parts = [synthetic_two_tower_batch(tcfg, TT_B, seed=SEED + 40 + k)
             for k in range(TT_STEPS)]
    x = {k: np.concatenate([p[0][k] for p in parts]) for k in parts[0][0]}
    y = np.concatenate([p[1] for p in parts])
    model.fit({k: v[:TT_B] for k, v in x.items()}, y[:TT_B], epochs=1,
              batch_size=TT_B, verbose=False)    # the kernels' first use
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    zero_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        model.fit(x, y, epochs=1, batch_size=TT_B, verbose=False)
        mets = model.train_batch({**{k: v[:TT_B] for k, v in x.items()},
                                  "label": y[:TT_B]})
        loss = float(mets["loss"])
        t_fit = time.perf_counter() - t0
    counts = read_counts()
    check(plain.calls == 0, f"quant (a): a plain version ran {plain.calls} "
          f"times")
    check(np.isfinite(loss), f"quant (a): the train head's loss is {loss}")
    steps = TT_STEPS + 1
    sparse = {op.name for op in model._sparse_ops}
    check({"item_emb", "user_emb_0"} <= sparse,
          f"quant (a): the towers' tables take no touched-rows update "
          f"({sorted(sparse)})")
    check(counts["embedding_bag"] >= steps * len(sparse)
          and counts["scatter_add_rows"] == steps * len(sparse)
          and counts["dense_update"] == steps,
          f"quant (a): launches {counts}")

    def head(name, batch):
        m = FFModel(FFConfig(batch_size=batch, seed=SEED + 1, device="cuda"))
        build_two_tower(m, tcfg, head=name)
        m.compile()
        m.init_layers()
        check(transfer_tower_params(model, m) > 0,
              f"quant (a): nothing moved to the {name} head")
        for op, p in m.params.items():
            for pn, v in p.items():
                check(torch.equal(v, model.params[op][pn]),
                      f"quant (a): {op}.{pn} did not reach the {name} head")
        return m

    user, item = head("user", 64), head("item", ITEM_BATCH)
    items = item_embeddings(item, tcfg)
    del item
    sset = ShardedMIPSIndex.standalone_set(1)
    index = ShardedMIPSIndex.build(sset, items)
    ranker = FFModel(FFConfig(batch_size=256, seed=SEED, device="cuda",
                              retrieve_deadline_ms=1000.0))
    build_dlrm(ranker, dcfg)
    ranker.compile()
    ranker.init_layers()
    encode = user_encoder(user)
    expand = dlrm_candidate_features(T, list(dcfg.embedding_size))
    data, _ = synthetic_batch(dcfg, TT_USERS, seed=SEED + 41)
    with InferenceEngine(ranker, ServeConfig(max_batch=256)) as engine:
        cascade = CascadeEngine(index, encode, engine, expand,
                                CascadeConfig.from_config(ranker.config))
        for i in range(TT_USERS):
            feats = {k: v[i:i + 1] for k, v in data.items()}
            p = cascade.predict(feats)
            check(not p.degraded and p.ids.shape == (1, K)
                  and np.isfinite(p.scores).all(),
                  f"quant (a): bad cascade answer for user {i}")
            want_s, want_i = index.exact_scan(encode(feats), K)
            o = np.lexsort((p.ids[0], -p.retrieve_scores[0]))
            check(np.array_equal(p.ids[0][o], want_i[0])
                  and np.array_equal(p.retrieve_scores[0][o].view(np.uint32),
                                     want_s[0].view(np.uint32)),
                  f"quant (a): user {i}'s retrieval differs from exact_scan")
    sset.close()
    print(f"quant (a): two-tower train head at the cascade's config "
          f"({tcfg.n_items} items, dim {tcfg.dim}, "
          f"{len(tcfg.user_embedding_size)} user tables of "
          f"{tcfg.user_embedding_size[0]} x {tcfg.user_sparse_dim}), batch "
          f"{TT_B}: {steps} steps in {t_fit:.3f} s after {t_build:.2f} s of "
          f"build and a first step, loss {loss:.4f}; launches "
          f"{ {k: v for k, v in counts.items() if v} }; towers served: "
          f"{TT_USERS} cascade answers, retrieval bitwise to exact_scan")
    del model, user, items, index, ranker, cascade, engine
    torch.cuda.empty_cache()
    return counts


def quant_training(work):
    """(b) stochastic rounding at full width, (c) the other rules, (d) a
    quantized delta publish. Returns (b)'s launch counts."""
    sr = dict(emb_dtype="int8", emb_update_rule="stochastic_rounding")
    w = D * 2            # the stored row: two 64-wide rows lane-packed
    a, dcfg = quant_model(**sr)
    x, y = synthetic_batch(dcfg, TRAIN_B * QUANT_STEPS, seed=SEED + 42)
    init = fixed_point_error(a.params["emb_stack"]["kernel"], w, "int8")
    check(init[0] < 1e-3 and init[1] <= 1.0 and init[2] == 0,
          f"quant (b): the initial table is not quantized ({init})")
    a.fit(x, y, epochs=1, batch_size=TRAIN_B, verbose=False)  # warm
    zero_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        a.fit(x, y, epochs=1, batch_size=TRAIN_B, verbose=False)
        torch.cuda.synchronize()
        t_sr = time.perf_counter() - t0
    counts = read_counts()
    check(plain.calls == 0, f"quant (b): a plain version ran "
          f"{plain.calls} times")
    check(counts["fake_quant_rows"] == QUANT_STEPS
          == counts["fake_quant_rows:philox"],
          f"quant (b): {counts['fake_quant_rows']} re-quantize launches in "
          f"{QUANT_STEPS} steps")
    fp = check_fixed_point(a.params["emb_stack"]["kernel"], w, "int8",
                           "\"cat\" after stochastic rounding")
    b, _ = quant_model(**sr)
    b.fit(x, y, epochs=1, batch_size=TRAIN_B, verbose=False)
    b.fit(x, y, epochs=1, batch_size=TRAIN_B, verbose=False)
    check(same_params(a, b), "quant (b): two runs from one seed differ")
    del b
    base, _ = quant_model()
    base.fit(x, y, epochs=1, batch_size=TRAIN_B, verbose=False)
    t0 = time.perf_counter()
    base.fit(x, y, epochs=1, batch_size=TRAIN_B, verbose=False)
    torch.cuda.synchronize()
    t_base = time.perf_counter() - t0
    _, s = quantize_rows(a.params["emb_stack"]["kernel"].view(-1, w), "int8")
    drift = float((a.params["emb_stack"]["kernel"]
                   - base.params["emb_stack"]["kernel"]).abs().max())
    nrows = a.params["emb_stack"]["kernel"].numel() // w
    print(f"quant (b): \"cat\" int8 stochastic rounding, {QUANT_STEPS} SGD "
          f"steps of {TRAIN_B} in {t_sr:.3f} s "
          f"({1e3 * t_sr / QUANT_STEPS:.3f} ms a step; the same fit at "
          f"fp32 {1e3 * t_base / QUANT_STEPS:.3f}), one re-quantize "
          f"launch a step over the whole 2.05 GB table; every row its "
          f"codes times one scale (code error {fp[0]:.2g}); rows whose "
          f"largest code is 127 fixed points of nearest quantization "
          f"({fp[1]:.3g} x 128 ulps), {fp[2]} of {nrows} rows with largest "
          f"code 126; bitwise across two runs; {2 * QUANT_STEPS} steps from "
          f"fp32 training's table: {drift:.3g} "
          f"({drift / float(s.max()):.2f} of the largest code step)")
    # the graphs a "dot" user trains: the launcher's unfused one (its
    # stacked table re-quantized) and the fused one, whose table lives in
    # the fused interaction, no embedding op: no policy, as in the JAX
    # package
    for fuse in (False, True):
        m, dd = quant_model("dot", fuse, **sr)
        xd, yd = synthetic_batch(dd, TRAIN_B, seed=SEED + 43)
        n0 = qr_mod.fake_quant_rows.launches
        m.fit(xd, yd, epochs=1, batch_size=TRAIN_B, verbose=False)
        n = qr_mod.fake_quant_rows.launches - n0
        if fuse:
            check(not m.quant_policies() and n == 0,
                  f"quant (b): the fused \"dot\" re-quantized ({n})")
        else:
            check(n == 1, f"quant (b): unfused \"dot\" launched {n}")
            check_fixed_point(m.params["emb_stack"]["kernel"], w, "int8",
                              "unfused \"dot\"")
        del m
    # (c) fp8 under stochastic rounding rounds to nearest; master_weight
    # trains bitwise as fp32
    m, _ = quant_model(emb_dtype="fp8", emb_update_rule="stochastic_rounding")
    n0 = qr_mod.fake_quant_rows.routes["nearest"]
    m.fit({k: v[:TRAIN_B] for k, v in x.items()}, y[:TRAIN_B], epochs=1,
          batch_size=TRAIN_B, verbose=False)
    check(qr_mod.fake_quant_rows.routes["nearest"] - n0 == 1,
          "quant (c): fp8's step did not re-quantize once")
    fp8 = check_fixed_point(m.params["emb_stack"]["kernel"], w, "fp8",
                            "fp8 stochastic rounding")
    del m
    mw, _ = quant_model(emb_dtype="int8")
    n0 = qr_mod.fake_quant_rows.launches
    for _ in range(2):
        mw.fit(x, y, epochs=1, batch_size=TRAIN_B, verbose=False)
    check(qr_mod.fake_quant_rows.launches == n0 and same_params(mw, base),
          "quant (c): master_weight int8 training is not fp32 training")
    del mw, base
    torch.cuda.empty_cache()
    print(f"quant (c): fp8 stochastic rounding one step, a fixed point "
          f"of nearest fp8 quantization ({fp8[1]:.3g} x 449 ulps); "
          f"master_weight int8 "
          f"{2 * QUANT_STEPS} steps bitwise the fp32 run, no re-quantize")

    # (d) a quantized delta publish from (b)'s trainer to an engine
    from dlrm_flexflow_tpu_torch.serve.watcher import SnapshotWatcher
    from dlrm_flexflow_tpu_torch.utils.delta import (DeltaPublisher,
                                                     load_delta_file)
    from dlrm_flexflow_tpu_torch.utils.weights import rows_from_jax
    nbytes = _model_bytes(a)
    check(shutil.disk_usage(work).free >= 3 * nbytes,
          f"quant (d): too little free disk under {work}")
    pub = DeltaPublisher(a, str(work), compact_frac=1e9)
    pub.publish_full()
    a.fit({k: v[:2 * TRAIN_B] for k, v in x.items()}, y[:2 * TRAIN_B],
          epochs=1, batch_size=TRAIN_B, verbose=False)
    entry = pub.publish()
    check(entry is not None and entry["kind"] == "delta",
          f"quant (d): the publish was {entry}")
    payload = load_delta_file(str(work / entry["file"]))
    key = "params/emb_stack/kernel"
    idx, q, scales, dt = payload["qrows"][key]
    check(dt == "int8" and q.dtype == np.int8 and idx.size > 0,
          f"quant (d): the row payload is {dt} {q.dtype}")
    server, _ = quant_model(seed=SEED + 1, **sr)
    engine = InferenceEngine(server, ServeConfig(max_batch=256,
                                                 warmup=False))
    check(SnapshotWatcher(engine, str(work)).poll_once(),
          "quant (d): the engine took no reload")
    op = server.get_layer_by_name("emb_stack")
    from dlrm_flexflow_tpu_torch.quant import dequantize_rows_np
    pidx, pvals = rows_from_jax(op, "kernel", idx,
                                dequantize_rows_np(q, scales, dt))
    got = server.params["emb_stack"]["kernel"].view(-1, D)[
        torch.as_tensor(pidx, device=server.device)].cpu().numpy()
    check(np.array_equal(got.view(np.uint32),
                         np.ascontiguousarray(pvals, np.float32)
                         .view(np.uint32)),
          "quant (d): the served rows are not the dequantized payload")
    # the publish quantizes to nearest: a row whose largest code was 126
    # moves by up to half a code; every other row arrives as trained
    ka = a.params["emb_stack"]["kernel"].view(-1, w)
    ks = server.params["emb_stack"]["kernel"].view(-1, w)
    moved = (ka - ks).abs().amax(dim=1)
    _, short_rows = quantize_rows(ka, "int8")
    n_moved = int((moved > 0).sum())
    half = float((moved / torch.where(short_rows > 0, short_rows,
                                      torch.ones_like(short_rows))).max())
    check(half <= 0.5 + 1e-3, f"quant (d): a served row moved {half:.3g} "
          f"codes from the trainer's")
    check(all(torch.equal(server.params[op][pn], a.params[op][pn])
              for op in a.params if op != "emb_stack"
              for pn in a.params[op]),
          "quant (d): the engine's dense weights are not the trainer's")
    feats = synthetic_batch(dcfg, 64, seed=SEED + 44)[0]
    with engine:
        got = engine.predict(feats).scores
    want = server.forward_bucket(feats, bucket=64).cpu().numpy()[:64]
    check(np.array_equal(np.asarray(got).reshape(-1).view(np.uint32),
                         np.ascontiguousarray(want.reshape(-1)).view(
                             np.uint32)),
          "quant (d): the engine's scores are not its model's")
    trained = a.forward_bucket(feats, bucket=64).cpu().numpy()[:64]
    print(f"quant (d): a delta of {idx.size} quantized packed rows "
          f"({entry['bytes'] / 1e6:.3f} MB, {pub.last_publish}) served "
          f"bitwise as its dequantized payload; {n_moved} of {ka.shape[0]} "
          f"served rows differ from the trainer's (largest code 126: at "
          f"most {half:.3f} of a code); 64 scores bitwise the engine "
          f"model's forward, within "
          f"{float(np.abs(np.asarray(got).reshape(-1) - trained.reshape(-1)).max()):.3g} "
          f"of the trainer's")
    del a, server, engine
    torch.cuda.empty_cache()
    return counts


def quant_kernel(dev):
    """(e) The row kernel against its plain version on the card: both
    modes at d in QUANT_DS with all-zero rows and rows at +-qmax codes,
    the "noise" entry and the Philox entry bitwise; each Philox code
    floor or floor + 1 of x / s and QUANT_DRAWS draws of one row
    unbiased within QUANT_SIGMAS standard errors; then timed at the
    "cat" step's shape (its 2.05 GB table, 4,194,304 rows of 128) on the
    main path's route ("philox") and "nearest", and at Criteo-Kaggle's
    table, beside the bound and the plain version."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    fq, plain = qr_mod.fake_quant_rows, qr_mod.fake_quant_rows_reference

    def rows_with_edges(d):
        x = torch.randn(QUANT_ROWS, d, device=dev, generator=gen) \
            * torch.rand(QUANT_ROWS, 1, device=dev, generator=gen)
        x[0], x[1] = 0.0, -0.0
        sign = torch.where(torch.arange(d, device=dev) % 2 == 1, 1.0, -1.0)
        x[2], x[3] = sign * 1.27, sign * 224.0
        return x

    def same(p, q):
        return torch.equal(p.view(torch.int32), q.view(torch.int32))

    for d in QUANT_DS:
        x = rows_with_edges(d)
        for dt in ("int8", "fp8", "bf16"):
            k, r = fq(x.clone(), dt), plain(x.clone(), dt)
            check(same(k, r), f"fake_quant_rows {dt} nearest d={d} differs "
                  f"from its plain version")
        u = torch.rand(x.shape, device=dev, generator=gen)
        check(same(fq(x.clone(), "int8", "stochastic", u=u),
                   plain(x.clone(), "int8", "stochastic", u=u)),
              f"fake_quant_rows noise entry d={d} differs")
        key = dict(seed=SEED + 5, step=3, salt=0x51, row0=77)
        check(same(fq(x.clone(), "int8", "stochastic", **key),
                   plain(x.clone(), "int8", "stochastic", **key)),
              f"fake_quant_rows Philox entry d={d} differs")
    row = torch.randn(1, 64, device=dev, generator=gen) * 0.02
    r = fq(row.repeat(QUANT_DRAWS, 1).contiguous(), "int8", "stochastic",
           seed=SEED, step=1, salt=0x51)
    s = row.abs().amax() / torch.tensor(127.0, device=dev)
    codes, want = (r / s).double(), (row / s).double()
    lo = torch.floor(want)
    check(bool((((codes - lo).abs() < 1e-3)
                | ((codes - lo - 1).abs() < 1e-3)).all()),
          "fake_quant_rows: a stochastic code is neither floor nor floor+1")
    frac = want - lo
    se = torch.sqrt(frac * (1 - frac) / QUANT_DRAWS)
    dev_se = float(((codes.mean(0) - want[0]).abs()
                    / (se[0] + 1e-6)).max())
    check(dev_se <= QUANT_SIGMAS, f"fake_quant_rows: the mean of "
          f"{QUANT_DRAWS} draws is {dev_se:.2f} standard errors off")

    # the main path's shape: "cat"'s stacked table as 128-wide rows
    table = 0.05 * torch.randn(T * ROWS * D // 128, 128, device=dev,
                               generator=gen)
    key = dict(seed=SEED, step=7, salt=0x51)
    k, r = fq(table.clone(), "int8", "stochastic", **key), \
        plain(table.clone(), "int8", "stochastic", **key)
    check(same(k, r), "fake_quant_rows differs from its plain version at "
          "the \"cat\" table's shape")
    del k, r
    nel = table.numel()
    b_ms, b_by = bound(2 * nel * 4, 6 * nel)

    def event_ms(fn, n=2):
        """The plain version's wall: events around n back-to-back calls
        (it is host-bound: ten or more launches a block of rows)."""
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    dev_ms, call_ms = time_ms(lambda: fq(table, "int8", "stochastic", **key),
                              [()], iters=20, warmup=2,
                              what="fake_quant_rows philox")
    near_ms, _ = time_ms(lambda: fq(table, "int8"), [()], iters=20, warmup=2,
                         what="fake_quant_rows nearest")
    p_ms = event_ms(lambda: plain(table, "int8", "stochastic", **key))
    pn_ms = event_ms(lambda: plain(table, "int8"))
    row = {"name": "fake_quant_rows", "route": "cuda",
           "source": "dlrm_flexflow_tpu_torch/csrc/quant_rows.cu",
           "replaces": "dlrm_flexflow_tpu/quant/codec.py:176",
           "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
           "ms": dev_ms, "call_ms": call_ms, "plain_ms": p_ms,
           "plain_call_ms": p_ms, "library_ms": None,
           "library_call_ms": None}
    print_row(row, f" (\"cat\" table {tuple(table.shape)}, philox route; "
              f"nearest {near_ms:.4f} ms, its plain version {pn_ms:.4f} ms; "
              f"no one PyTorch call computes it)")
    del table
    torch.cuda.empty_cache()
    # Criteo-Kaggle's concatenated table, stored as 128-wide rows
    km = FFModel(FFConfig(batch_size=TRAIN_B, device="cuda"))
    build_dlrm(km, DLRMConfig.criteo_kaggle())
    op = next(o for o in km.ops if hasattr(o, "total_rows"))
    from dlrm_flexflow_tpu_torch.ops.embedding import quant_row_width
    kw = quant_row_width(op)
    kt = 0.05 * torch.randn(op.total_rows * op.out_dim // kw, kw,
                            device=dev, generator=gen)
    k_ms, _ = time_ms(lambda: fq(kt, "int8", "stochastic", **key), [()],
                      iters=20, warmup=2, what="fake_quant_rows kaggle")
    kb_ms, _ = bound(2 * kt.numel() * 4, 6 * kt.numel())
    print(f"kernel fake_quant_rows at Criteo-Kaggle's table "
          f"{tuple(kt.shape)} ({kt.numel() * 4 / 1e9:.3f} GB): device "
          f"{k_ms:.4f} ms, bound {kb_ms:.4f} ms (bytes); d={QUANT_DS} "
          f"bitwise to the plain version in both modes and both entries; "
          f"{QUANT_DRAWS} draws within {dev_se:.2f} standard errors")
    del kt, km
    torch.cuda.empty_cache()
    return {"fake_quant_rows": row}


def quant_phase(dev):
    """Phase 14. Returns ({"fake_quant_rows": row}, launch counts of (a)
    and (b)'s main paths)."""
    counts = two_tower_train()
    shutil.rmtree(WORK_DIR / "quant", ignore_errors=True)
    (WORK_DIR / "quant").mkdir(parents=True)
    try:
        add_counts(counts, quant_training(WORK_DIR / "quant"))
    finally:
        shutil.rmtree(WORK_DIR / "quant", ignore_errors=True)
    return quant_kernel(dev), counts


def main() -> int:
    if sys.argv[1:] == ["--ranker-child"]:
        # one ranker replica of phase 12 (c), a child of this script
        ranker_child()
        return 0
    if sys.argv[1:2] == ["--dist-rank"] and torch.cuda.is_available():
        # one rank of phase 13, a child of this script
        dist_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--rowshard-rank"] and torch.cuda.is_available():
        # one rank of phase 15, a child of this script
        rowshard_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--tablepar-rank"] and torch.cuda.is_available():
        # one rank of phase 16, a child of this script
        tablepar_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--splitopt-rank"] and torch.cuda.is_available():
        # one rank of phase 17, a child of this script
        splitopt_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if sys.argv[1:2] in (["--fitranks-rank"], ["--fitranks-resume-rank"]) \
            and torch.cuda.is_available():
        # one rank of phase 18 (first or fresh ranks), a child
        fitranks_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                            1 if sys.argv[1] == "--fitranks-rank" else 2)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(device_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    if sys.argv[1:] == ["--serving-app"]:
        # only phase 9 (its kernels built first, as the child loads them)
        build.build_all()
        counts = serving_app_phase()
        print(json.dumps({"launches": {k: v for k, v in counts.items()
                                       if v}}))
        return 0
    if sys.argv[1:] == ["--criteo"]:
        # only phase 10, its kernels built first
        build.build_all()
        counts = criteo_phase()
        print(json.dumps({"launches": {k: v for k, v in counts.items()
                                       if v}}))
        return 0
    if sys.argv[1:] == ["--shard-tier"]:
        # only phase 11, its kernels built first (the app children load
        # them)
        build.build_all()
        counts = shard_tier_phase()
        print(json.dumps({"launches": {k: v for k, v in counts.items()
                                       if v}}))
        return 0
    if sys.argv[1:] == ["--fleet"]:
        # phase 11's loop (which drives phase 12 (a)) and phase 12, the
        # kernels built first (the children load them)
        build.build_all()
        figures = {}
        counts = shard_tier_phase(figures, loop_only=True)
        add_counts(counts, fleet_phase(figures))
        print(json.dumps({"launches": {k: v for k, v in counts.items()
                                       if v}}))
        return 0
    if sys.argv[1:] == ["--dist"]:
        # only phase 13, its kernels built first (the ranks load them)
        build.build_all()
        rows, counts = dist_phase(dev)
        rows["sharded_scatter_add_rows"]["launches"] = counts.get(
            "sharded_scatter_add_rows", 0)
        print(json.dumps({"launches": {k: v for k, v in counts.items()
                                       if v}, "kernel": rows}))
        return 0
    if sys.argv[1:] == ["--rowshard"]:
        # only phase 15, its kernels built first (the ranks load them)
        build.build_all()
        counts = rowshard_phase(dev)
        print(json.dumps({"launches": {k: v for k, v in counts.items()
                                       if v}}))
        return 0
    if sys.argv[1:] == ["--tablepar"]:
        # only phase 16, its kernels built first (the ranks load them)
        build.build_all()
        rows, counts = tablepar_phase(dev)
        print(json.dumps({"launches": {k: v for k, v in counts.items()
                                       if v}, "kaggle_block_kernels": rows}))
        return 0
    if sys.argv[1:] == ["--splitopt"]:
        # only phase 17, its kernels built first (the ranks load them)
        build.build_all()
        rows, counts = splitopt_phase(dev)
        print(json.dumps({"launches": {k: v for k, v in counts.items()
                                       if v}, "splitopt_kernels": rows}))
        return 0
    if sys.argv[1:] == ["--fitranks"]:
        # only phase 18, its kernels built first (the ranks load them)
        build.build_all()
        counts = fitranks_phase(dev)
        print(json.dumps({"launches": {k: v for k, v in counts.items()
                                       if v}}))
        return 0
    if sys.argv[1:] == ["--scatter"]:
        # only the touched-rows scatters and their pre-pass at the paths'
        # shapes: kernels 2 and 3 (n = 2,048 and Criteo-Kaggle's 6,656),
        # the stateful entry, and kernel 4 at a rank's shape
        build.build_all()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        table = 0.5 * torch.randn(T * ROWS, D, device=dev, generator=gen)
        scatter_kernels(dev, gen, table)
        del table
        torch.cuda.empty_cache()
        criteo_kernels(dev)
        window_kernel(dev, torch.Generator(device=dev).manual_seed(SEED + 13))
        return 0
    if sys.argv[1:] == ["--quant"]:
        # only phase 14, its kernels built first
        build.build_all()
        rows, counts = quant_phase(dev)
        rows["fake_quant_rows"]["launches"] = counts.get("fake_quant_rows", 0)
        print(json.dumps({"launches": {k: v for k, v in counts.items()
                                       if v}, "kernel": rows}))
        return 0
    if sys.argv[1:] == ["--shapes"]:
        # only the bag and the interaction at their paths' shapes: what
        # the same script times on another tree of the port
        gen = torch.Generator(device=dev).manual_seed(SEED)
        table = 0.5 * torch.randn(T * ROWS, D, device=dev, generator=gen)
        shape_phase(dev, gen, table)
        return 0
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} kernel sources in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # training and the cascade are timed first, before any profiler
    # session (the cascade profiles only after its timed requests)
    runs = [train_timed(mode, opt) for mode, opt in TRAIN_RUNS]
    nmt_run = nmt_timed()
    launches = {}

    def add(counts):
        add_counts(launches, counts)

    add(launch_phase())
    sumsq_row, counts = resilience_phase()
    add(counts)
    add(cascade_phase())
    quant_rows_row, counts = quant_phase(dev)
    add(counts)
    add(serving_app_phase())
    add(criteo_phase())
    figures = {}
    add(shard_tier_phase(figures))
    add(fleet_phase(figures))
    dist_rows, counts = dist_phase(dev)
    add(counts)
    add(rowshard_phase(dev))
    _, counts = tablepar_phase(dev)
    add(counts)
    so_rows, counts = splitopt_phase(dev)
    add(counts)
    add(fitranks_phase(dev))
    for run in runs:
        add(train_report(run))
    del runs
    rows = kernel_phase(dev)
    rows.update(dense_kernel(dev))
    rows.update(sumsq_row)
    alpha_t_check(dev)
    rows.update(topk_kernel(dev))
    rows.update(lstm_kernels(dev))
    rows.update(dist_rows)
    rows.update(quant_rows_row)
    rows.update({k: v for k, v in so_rows.items() if ":" not in k})
    torch.cuda.empty_cache()
    for mode in ("cat", "dot"):
        add(serve_phase(mode))
    # last: NMT's profiler sessions trace long kernels and many launches
    add(nmt_report(nmt_run))
    del nmt_run
    for name, r in rows.items():
        r["launches"] = launches.get(name, 0)
        check(r["launches"] > 0 or name in OFF_PATH | OFF_SHAPE,
              f"{name} never launched on the main path")

    print("grad_sumsq launches on the main paths by route: " + json.dumps(
        {k: launches.get(f"grad_sumsq:{k}", 0)
         for k in dense_mod.grad_sumsq.routes}))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
