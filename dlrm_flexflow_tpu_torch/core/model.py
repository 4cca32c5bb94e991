"""FFModel: graph construction, parameter init, the serving forward and
the training step.

The counterpart of ``dlrm_flexflow_tpu.core.model.FFModel``, cut to the
serving and training slices: the op builders the DLRM, two-tower and
NMT graphs use, ``compile``, ``init_layers``, ``forward_batch`` and the
bucketed serving entries, the hot-reload hooks ``swap_params`` and
``apply_delta``, and training: ``train_batch``,
``train_batch_device``, ``train_batch_staged``, ``reset_metrics``, ``fit``
(rolling, resumable checkpoints in the JAX package's format, rollback to
the last snapshot after a non-finite step, the whole dataset staged on
the device when it fits, else batches through the prefetch ring) and
``fit_stream`` (training off a batch source, publishing delta snapshots
through ``utils.delta.DeltaPublisher``, resumable). Op names,
parameter names and parameter layouts follow the JAX graph, so
``utils.weights.params_from_jax`` can carry a JAX model's weights
across by name.

There is no jit: the graph runs eagerly on ``config.device``, op by op
— serving under ``torch.inference_mode``, training under autograd. On a
CUDA device the embedding, interaction and LSTM ops launch their
hand-written kernels; on the CPU they run the kernels' plain versions.
``compile`` resolves the JAX package's placement on a mesh over ranks
(``parallel/``); on a mesh of several ranks, one process each, each
rank trains on its rows of the global batch, each op split as its
placement says (``parallel.split``, ``parallel.alltoall``), and ``fit``,
``fit_stream``, the checkpoints, the sentinel and host-resident tables
run across the ranks as on one card.

The training step mirrors the JAX ``train_step`` (core/model.py:996-1159
there). The embedding ops that support it take the touched-rows update:
phase A, without grad, evaluates their ancestors and their lookups
through ``apply_with_fwd``, which keeps the gathered rows; phase B runs
the graph with the lookups' outputs as autograd leaves and
differentiates the loss w.r.t. the dense parameters and those outputs,
so the tables never enter autograd; then the tables take
``sparse_sgd_update`` (plain SGD) or ``sparse_opt_update`` (SGD with
momentum or weight decay, Adam: the touched rows' weights and optimizer
state, lazily) and the dense parameters the optimizer's update. When no
op takes the sparse update (the fused "dot" graph keeps its table in a
non-sparse op; ``sparse_embedding_update=False``), phase A is empty and
the one autograd pass covers every parameter. Parameters and optimizer
state are updated IN PLACE, where the JAX step returns new arrays and
donates the old ones.

The anomaly sentinel (``config.anomaly_policy`` other than "none")
mirrors the JAX step's (core/model.py:1111-1135 there): after the
backward one ``grad_sumsq`` launch computes the global gradient norm
over the dense gradients and the lookups' cotangents and the flag ok =
isfinite(loss) & isfinite(norm) on the device, before any update runs;
every update kernel takes the flag and changes nothing where it is 0,
and Adam's step advances by it. The JAX step keeps the pre-step values
with ``jnp.where``; updating in place, the port keeps them by not
writing. "raise" and "rollback" read the flag back at the step's end
(one host sync) and raise ``AnomalyError``; "skip_step" never syncs.
Across ranks the norm takes two launches: the first over what each rank
holds of its own (its rows' cotangents, its pieces of split parameters)
into a slot of the one buffer the dense gradients are all-reduced in,
beside the rank's share of the loss; the second over the all-reduced
gradients, adding the all-reduced slot, with the global loss: one flag,
the same on every rank, and no collective more a step.

Host-resident tables (``config.host_resident_tables``, ``--host-tables``;
the JAX step's core/model.py:1893-2130 there): the embedding ops with a
host form keep their tables in ``host_params`` (numpy, in host RAM) and
their optimizer slabs in ``host_opt_state``; the ids only they read
never reach the card. Each step gathers their rows on the host, copies
them to the card, where they enter the graph as the ops' outputs (as
phase A's lookups do), and brings their cotangents back for the host's
touched-rows update, guarded by the sentinel's flag: inline, or on the
``ff-scatter`` worker thread (``host_tables_async``), which gathers the
next step's rows first when the caller passes them (bounded one-step
staleness) and whose error surfaces at the next ``_host_drain``. Across
ranks every rank keeps the tables whole, gathers its own rows, and
applies the global batch's update from the ranks' ids and cotangents,
all-gathered on the main thread.

Quantized tables (``quant/``; the JAX step's core/model.py:1219-1290
there): ``compile`` resolves each table op's storage policy (a strategy
entry's ``quant_dtype`` / ``quant_update``, else ``--emb-dtype`` /
``--emb-update-rule``). Training keeps every table as the fp32 image of
its codes. Under ``master_weight`` nothing in the step changes (bitwise
fp32 training; the codes are made at storage boundaries). Under
``stochastic_rounding`` a table starts fake-quantized (nearest) and the
step re-quantizes every updated table whole after the updates, one
``fake_quant_rows`` launch a parameter with Philox draws keyed by
(seed, step, op, parameter), guarded by the sentinel's flag; a host
table re-quantizes exactly its touched rows after the host scatter,
with the JAX package's per-step ``RandomState`` (bitwise its host path).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import FFConfig
from ..data.prefetch import StagedBatch, stage_batch
from ..obs import trace as obstrace
from ..ops.kernels.dense_update import grad_sumsq
from ..quant.codec import fake_quant_np, fake_quant_stochastic_np
from ..utils import faults
from ..utils.logging import get_logger
from . import losses as losses_mod
from . import metrics as metrics_mod
from .op import InputOp, Op
from .optimizers import AdamOptimizer, SGDOptimizer
from .tensor import Tensor

log_model = get_logger("model")


class AnomalyError(RuntimeError):
    """A training step produced a non-finite loss or gradient norm and the
    anomaly policy is "rollback" or "raise" (``FFConfig.anomaly_policy``).
    Under "rollback", ``fit(checkpoint_dir=...)`` catches it, restores the
    last good snapshot and rewinds; elsewhere it propagates. The step's
    update was already suppressed on the device: the parameters and the
    optimizer state keep their pre-step values."""

    def __init__(self, step: int, loss: float, grad_norm: float):
        super().__init__(
            f"non-finite training step {step}: loss={loss}, "
            f"global grad norm={grad_norm}")
        self.step = step
        self.loss = loss
        self.grad_norm = grad_norm
        # the sentinel's fires land in the obs layer (no-op when off)
        from ..obs import metrics as obsm
        obsm.counter("ff_anomalies_total",
                     "non-finite training steps the sentinel caught").inc()
        obstrace.instant("anomaly", cat="sentinel", step=int(step),
                         loss=repr(loss), grad_norm=repr(grad_norm))


def _same_ids(a, b) -> bool:
    """Whether two {op name: ids} maps hold the same ids."""
    return a is b or (a.keys() == b.keys()
                      and all(np.array_equal(a[k], b[k]) for k in a))


def _tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda":
            # "cuda" names the current card; tensors report its index,
            # and swap_params compares devices
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            # the slice computes in full fp32: a float32 matmul or
            # convolution must not drop to TF32 (PyTorch's default keeps
            # matmuls fp32 but lets cuDNN use TF32; both are set here)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        # the side stream the prefetch ring copies batches on
        self._stage_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        self._op_guid = 0
        self.ops: List[Op] = []          # topological (construction) order
        self.input_tensors: List[Tensor] = []
        self.compute_dtype = self.config.torch_compute_dtype
        # set by compile()
        self.optimizer = None
        self.loss_type: Optional[str] = None
        self.metrics: List[str] = []
        self._preds_tensor: Optional[Tensor] = None
        self._logits_tensor: Optional[Tensor] = None
        self._sparse_ops: Optional[List[Op]] = None  # resolved at 1st step
        # set by compile(): the mesh over ranks, each op's strategy and
        # placement, and the collectives of a mesh of several ranks
        self.mesh = None
        self.strategies: Dict[str, Any] = {}
        self._op_pc: Dict[str, Any] = {}
        self._collectives = None
        # set by init_layers() / swap_params()
        self.params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.opt_state = None                        # built at 1st step
        self._step = 0
        # running metric sums of the epoch, 0-d tensors on self.device
        self.perf = metrics_mod.PerfMetrics()
        self._msums: Optional[Dict[str, torch.Tensor]] = None
        # whether the step under way has begun to write parameters or
        # optimizer state (its error then cannot be undone)
        self._updating = False
        # host-resident tables (config.host_resident_tables): the ops
        # whose tables live in host RAM, as numpy, with their optimizer
        # slabs; the inputs only they read, which never go to the card
        self._host_resident_list: List[Op] = []
        self._host_only_inputs: set = set()
        self.host_params: Dict[str, Dict[str, np.ndarray]] = {}
        self.host_opt_state: Dict[str, Dict[str, np.ndarray]] = {}
        # the async pipeline: the table lock (gathers against the
        # scatter worker), the worker and its error, the next step's
        # chained gather, and the tables' generation
        self._host_table_lock = threading.Lock()
        self._host_scatter_thread: Optional[threading.Thread] = None
        self._host_scatter_exc: Optional[BaseException] = None
        self._host_gather_pending = None
        self._host_gather_next = None
        self._host_gen = 0
        # set by EmbeddingShardSet.release_ranker_tables: the host tables
        # live in the serving shard tier, this model keeps 0-row stubs
        self._host_tables_released = False

    # ------------------------------------------------------------------
    # graph construction
    # ------------------------------------------------------------------
    def _next_op_guid(self) -> int:
        self._op_guid += 1
        return self._op_guid

    def _register_op(self, op: Op):
        if any(o.name == op.name for o in self.ops):
            raise ValueError(
                f"duplicate op name {op.name!r}; op names must be unique "
                f"(they key parameters)")
        self.ops.append(op)

    def create_tensor(self, shape: Sequence[int], dtype=torch.float32,
                      name: Optional[str] = None) -> Tensor:
        """A model input, sample dim first."""
        op = InputOp(self, shape, dtype, name)
        t = op.outputs[0]
        if name:
            t.name = name
        self.input_tensors.append(t)
        return t

    def dense(self, input_tensor, out_dim, activation=None, use_bias=True,
              kernel_initializer=None, bias_initializer=None, name=None):
        from ..ops.linear import Linear
        if activation == "softmax":
            # a Linear, then a separate Softmax op, so that compile() can
            # hand the loss the logits (as the JAX dense lowers it)
            t = Linear(self, input_tensor, out_dim, "none", use_bias,
                       kernel_initializer, bias_initializer,
                       name).outputs[0]
            return self.softmax(t, name=f"{name}_softmax" if name else None)
        return Linear(self, input_tensor, out_dim, activation or "none",
                      use_bias, kernel_initializer, bias_initializer,
                      name).outputs[0]

    def embedding(self, input_tensor, num_entries, out_dim, aggr="sum",
                  kernel_initializer=None, name=None):
        from ..ops.embedding import Embedding
        return Embedding(self, input_tensor, num_entries, out_dim, aggr,
                         kernel_initializer, name).outputs[0]

    def embedding_stacked(self, input_tensor, num_tables, num_entries,
                          out_dim, aggr="sum", kernel_initializer=None,
                          name=None):
        from ..ops.embedding import EmbeddingBagStacked
        return EmbeddingBagStacked(self, input_tensor, num_tables,
                                   num_entries, out_dim, aggr,
                                   kernel_initializer, name).outputs[0]

    def embedding_concat(self, input_tensor, table_sizes, out_dim,
                         aggr="sum", kernel_initializer=None, name=None):
        """Non-uniform tables (one width, different row counts) in one
        concatenated-rows table: see ops.embedding.EmbeddingBagConcat."""
        from ..ops.embedding import EmbeddingBagConcat
        return EmbeddingBagConcat(self, input_tensor, table_sizes, out_dim,
                                  aggr, kernel_initializer, name).outputs[0]

    def concat(self, tensors, axis, name=None):
        from ..ops.tensor_ops import Concat
        return Concat(self, list(tensors), axis, name).outputs[0]

    def split(self, input_tensor, sizes, axis, name=None):
        from ..ops.tensor_ops import Split
        return Split(self, input_tensor, sizes, axis, name).outputs

    def reshape(self, input_tensor, shape, name=None):
        from ..ops.tensor_ops import Reshape
        return Reshape(self, input_tensor, shape, name).outputs[0]

    def transpose(self, input_tensor, name=None):
        from ..ops.tensor_ops import Transpose
        return Transpose(self, input_tensor, name).outputs[0]

    def reverse(self, input_tensor, axis, name=None):
        from ..ops.tensor_ops import Reverse
        return Reverse(self, input_tensor, axis, name).outputs[0]

    def index_select(self, input_tensor, indices, axis, name=None):
        from ..ops.tensor_ops import IndexSelect
        return IndexSelect(self, input_tensor, indices, axis,
                           name).outputs[0]

    def batch_matmul(self, a, b, trans_a=True, trans_b=False, name=None):
        from ..ops.batch_matmul import BatchMatmul
        return BatchMatmul(self, a, b, trans_a, trans_b, name).outputs[0]

    def softmax(self, input_tensor, name=None):
        from ..ops.elementwise import Softmax
        return Softmax(self, input_tensor, name).outputs[0]

    def lstm(self, input_tensor, hidden, name=None):
        from ..ops.rnn import LSTM
        return LSTM(self, input_tensor, hidden, name).outputs[0]

    def lstm_stack(self, input_tensor, hidden, num_layers, name=None):
        """N stacked LSTM layers (see ops/rnn.LSTMStack: layer by layer,
        each one scan kernel launch)."""
        from ..ops.rnn import LSTMStack
        return LSTMStack(self, input_tensor, hidden, num_layers,
                         name).outputs[0]

    def fused_dot_interaction(self, sparse_idx, bottom, num_entries,
                              out_dim, activation="relu",
                              emb_initializer=None, kernel_initializer=None,
                              bias_initializer=None, name=None):
        """Fused gather -> dot interaction -> first top-MLP layer (see
        ops/interaction.FusedDotInteraction): on the card the chain runs
        as one CUDA kernel and the (B, F, F) tensor never reaches device
        memory."""
        from ..ops.interaction import FusedDotInteraction
        return FusedDotInteraction(self, sparse_idx, bottom, num_entries,
                                   out_dim, activation, emb_initializer,
                                   kernel_initializer, bias_initializer,
                                   name).outputs[0]

    def get_layer_by_name(self, name: str) -> Op:
        for op in self.ops:
            if op.name == name:
                return op
        raise KeyError(name)

    # ------------------------------------------------------------------
    # compile / init
    # ------------------------------------------------------------------
    def compile(self, optimizer=None,
                loss_type: str = "mean_squared_error",
                metrics: Sequence[str] = ("mean_squared_error",),
                mesh=None, strategies=None,
                final_tensor: Optional[Tensor] = None):
        """Fix the optimizer (default, as in the JAX package: SGD at
        ``config.learning_rate`` with ``config.weight_decay``), the loss,
        the metrics and the output tensor. When the output is a Softmax's
        and the loss a cross-entropy, the loss takes the Softmax's input,
        the logits, and the metrics the probabilities (as in the JAX
        package). Which ops take the touched-rows update is resolved at
        the first training step.

        The placement, as the JAX ``compile`` resolves it
        (core/model.py:360-460 there): ``mesh`` (default
        ``make_mesh(num_devices=config.num_devices)``), ``strategies``
        ({op name: ParallelConfig}, default the file
        ``config.import_strategy_file`` names, loaded and checked against
        the mesh and the ops), the reference's generic keys resolved
        (``_resolve_generic_strategy_keys``), data parallelism for every
        other op, each config clamped to the shapes and the mesh
        (``_effective_pc``) and placed on its axes (``_build_placement``).
        On a mesh of one rank that changes nothing the step does. On more
        (one rank a process, ``parallel.distributed``), each rank trains
        on its rows of the global batch: the tables and ``Linear``s split
        as their configs say (``_build_placement``), every other op
        data-parallel with its weights replicated. The loss is the global
        batch's mean; one all-reduce sums the replicated dense gradients
        before the one dense update, another the metrics."""
        ops = [op for op in self.ops if not isinstance(op, InputOp)]
        if not ops:
            raise ValueError("compile() needs at least one op")
        self.optimizer = optimizer or SGDOptimizer(
            lr=self.config.learning_rate,
            weight_decay=self.config.weight_decay)
        self.loss_type = losses_mod.canonical_loss(loss_type)
        self.metrics = metrics_mod.canonical_metrics(list(metrics))
        from ..parallel.mesh import make_mesh
        self.mesh = mesh if mesh is not None else make_mesh(
            num_devices=self.config.num_devices)
        ndev = self.mesh.size
        self.strategies = dict(strategies or {})
        if not self.strategies and self.config.import_strategy_file:
            from ..parallel.strategy_io import load_strategies
            self.strategies = load_strategies(
                self.config.import_strategy_file, num_devices=ndev,
                known_ops={op.name for op in self.ops},
                row_shard_ops={op.name for op in self.ops
                               if hasattr(op, "_row_shard_geometry")})
        self._resolve_generic_strategy_keys(ndev)
        for op in ops:
            if op.name not in self.strategies:
                self.strategies[op.name] = op.default_parallel_config(ndev)
        from ..ops.elementwise import Softmax
        preds = final_tensor if final_tensor is not None \
            else ops[-1].outputs[0]
        self._preds_tensor = preds
        if (isinstance(preds.owner_op, Softmax)
                and "crossentropy" in self.loss_type):
            self._logits_tensor = preds.owner_op.inputs[0]
        else:
            self._logits_tensor = preds
        self._sparse_ops = None
        self.opt_state = None
        self._resolve_host_ops()
        # the tables' quantized-storage policies (strategy quant_dtype /
        # --emb-dtype), resolved at every compile as in the JAX package
        from ..ops.embedding import configure_quant
        self._quant_policies = {}
        for op in ops:
            if hasattr(op, "host_lookup"):
                configure_quant(op, self.strategies.get(op.name))
        if self._host_resident_list and not isinstance(
                self.optimizer, (SGDOptimizer, AdamOptimizer)):
            raise ValueError(
                "host-resident tables support SGD (plain/momentum/"
                "weight-decay) and Adam — stateful optimizers take the "
                "lazy touched-rows host update")
        self._build_placement()
        self.host_opt_state = {}
        self.reset_metrics()
        return self

    def _resolve_generic_strategy_keys(self, ndev: int):
        """Translate the reference's generic strategy keys onto this
        graph's ops, as the JAX package does (core/model.py:451-594
        there): "embedding{i}" per table (dims (1, 1), the whole table on
        ``device_ids[0]``) becomes the table-dim degree of a fused
        embedding, the number of distinct devices (at most the tables and
        the mesh), with its tables stored grouped by device
        (``set_table_order``) where the groups are even, or the i-th
        unfused ``Embedding``'s config; "linear" and "concat" apply to
        every op of that type. The JAX warnings, word for word."""
        from ..ops.embedding import (Embedding, EmbeddingBagConcat,
                                     EmbeddingBagStacked)
        from ..ops.linear import Linear
        from ..ops.tensor_ops import Concat
        from ..parallel.pconfig import ParallelConfig
        strategies = self.strategies
        if not strategies:
            return
        emb_keys = sorted((k for k in strategies
                           if k.startswith("embedding")
                           and k[len("embedding"):].isdigit()),
                          key=lambda k: int(k[len("embedding"):]))
        fused_types = (EmbeddingBagStacked, EmbeddingBagConcat)
        emb_ops = [op for op in self.ops
                   if isinstance(op, (Embedding,) + fused_types)]
        for i, op in enumerate(emb_ops):
            if op.name in strategies:
                continue
            if isinstance(op, fused_types) and emb_keys:
                pcs = [strategies[k] for k in emb_keys]
                distinct = {pc.device_ids[:1] for pc in pcs if pc.device_ids}
                degree = max(1, min(len(distinct), op.num_tables, ndev))
                dtyp = pcs[0].device_type
                if any(pc.device_type != dtyp for pc in pcs):
                    log_model.warning(
                        "per-table strategies mix device types %s; the "
                        "fused embedding %r uses %r for all tables",
                        sorted({pc.device_type for pc in pcs}), op.name,
                        dtyp)
                # a table marked ZCM makes the fused op host-resident
                zcm = ["ZCM" in pc.memory_types for pc in pcs]
                mem = ("ZCM",) if any(zcm) else ()
                if any(zcm) and not all(zcm):
                    log_model.warning(
                        "per-table strategies mark only %d/%d tables ZCM; "
                        "the fused embedding %r stores ALL tables "
                        "host-resident (fusion constraint)",
                        sum(zcm), len(zcm), op.name)
                # row-shard degrees fuse to the largest requested
                pd = max((getattr(pc, "param_degree", 1) for pc in pcs),
                         default=1)
                if pd > 1 and not mem:
                    batch = op.inputs[0].shape[0]
                    ds = ndev if batch % max(ndev, 1) == 0 else 1
                    exch = ("dedup" if any(
                        getattr(pc, "exchange", "dense") == "dedup"
                        for pc in pcs) else "dense")
                    frac = max((getattr(pc, "hot_fraction", 0.0)
                                for pc in pcs), default=0.0)
                    ovl = any(getattr(pc, "overlap", False)
                              for pc in pcs)
                    strategies[op.name] = ParallelConfig(
                        (ds, 1, 1), device_type=dtyp, param_degree=pd,
                        exchange=exch, hot_fraction=frac, overlap=ovl)
                    continue
                strategies[op.name] = ParallelConfig(
                    (1, degree, 1), device_type=dtyp, memory_types=mem)
                # the per-table device assignment: tables grouped by
                # their strategy device, so block-splitting the stacked
                # dim lands table i on device_ids[i] (the reference's
                # round robin, dlrm_strategy.cc:242-296)
                dev_of = [pc.device_ids[0] if pc.device_ids else None
                          for pc in pcs]
                if len(emb_keys) == op.num_tables and None not in dev_of:
                    devs = sorted(set(dev_of))
                    if hasattr(op, "set_device_groups") and len(devs) > 1:
                        before = op.total_rows
                        op.set_device_groups(dev_of)
                        if op.total_rows > 1.25 * before:
                            log_model.warning(
                                "honoring per-table device placement "
                                "pads %r from %d to %d rows (+%d%%): "
                                "groups pad to the LARGEST device's row "
                                "count — skewed placements cost memory",
                                op.name, before, op.total_rows,
                                round(100 * (op.total_rows / before - 1)))
                        if len(devs) != ndev:
                            log_model.warning(
                                "strategy places tables on %d devices "
                                "but the mesh has %d; row blocks land "
                                "in device order, placement is "
                                "approximate", len(devs), ndev)
                    elif hasattr(op, "set_table_order"):
                        per = op.num_tables // max(len(devs), 1)
                        if (len(devs) == degree
                                and all(dev_of.count(g) == per
                                        for g in devs)):
                            op.set_table_order(tuple(
                                i for g in devs
                                for i, dg in enumerate(dev_of)
                                if dg == g))
                        elif len(devs) > 1:
                            log_model.warning(
                                "per-table device_ids place %d tables "
                                "unevenly across %d devices (counts %s); "
                                "the stacked uniform embedding can only "
                                "block-shard equal groups — PLACEMENT "
                                "INTENT DROPPED, executing degree-%d "
                                "table sharding in declaration order",
                                op.num_tables, len(devs),
                                [dev_of.count(g) for g in devs], degree)
            elif not isinstance(op, fused_types) and i < len(emb_keys):
                strategies[op.name] = strategies[emb_keys[i]]
        for op in self.ops:
            if isinstance(op, InputOp) or op.name in strategies:
                continue
            generic = None
            if isinstance(op, Linear):
                generic = "linear"
            elif isinstance(op, Concat):
                generic = "concat"
            if generic and generic in strategies:
                pc = strategies[generic]
                nd = op.outputs[0].num_dims
                degs = tuple(pc.degrees[:nd]) + (1,) * (nd - len(pc.degrees))
                strategies[op.name] = ParallelConfig(
                    degs, device_type=pc.device_type,
                    device_ids=pc.device_ids)

    def _effective_pc(self, op: Op):
        """The op's strategy with each degree clamped to divide its output
        dim and to be feasible on the mesh, as the JAX package clamps it:
        a change warns, or raises under ``config.strict_strategies``."""
        from ..parallel.pconfig import ParallelConfig
        from ..parallel.sharding import AxisAssigner
        pc = self.strategies[op.name]
        shape = op.outputs[0].shape
        degs = list(pc.degrees)[:len(shape)]
        degs += [1] * (len(shape) - len(degs))
        feas = AxisAssigner(self.mesh).feasible_degrees()
        for i, d in enumerate(degs):
            d = min(d, shape[i])
            while d > 1 and (shape[i] % d != 0 or d not in feas):
                d -= 1
            degs[i] = max(d, 1)
        eff = ParallelConfig(tuple(degs), pc.device_type, pc.device_ids)
        requested = tuple(pc.degrees)[:len(shape)]
        requested += (1,) * (len(shape) - len(requested))
        if tuple(degs) != requested and not op.raw_degree_semantics:
            msg = (f"strategy for {op.name!r} requests degrees {requested} "
                   f"but output shape {shape} / mesh "
                   f"{tuple(self.mesh.shape.values())} only admits "
                   f"{tuple(degs)}; executing the clamped config")
            if self.config.strict_strategies:
                raise ValueError(msg)
            log_model.warning(msg)
        return eff

    def _build_placement(self):
        """Place every op on the mesh, as the JAX ``_build_shardings``
        does (core/model.py:626-758 there): its clamped config
        (``_op_pc``) and the mesh axes of each output dim (``_out_axes``;
        degrees that cannot be placed together run replicated, with a
        warning or, strict, a raise). On a mesh of more than one rank, the
        tables of a row-sharded config (``param_degree`` > 1;
        ``configure_row_shard`` per op, before the axes, as in the JAX
        package) split by rows with the all-to-all exchange of
        ``parallel.alltoall``, the ops below split as
        ``_check_across_ranks`` plans, and every other op runs
        data-parallel: set up here when the process group is the mesh,
        else at the first use. What ``_check_across_ranks`` plans:
        the ``EmbeddingBagStacked`` tables split by table over the mesh
        axes of their table dim (all of them or part), the
        ``EmbeddingBagConcat`` table in equal row blocks over the whole
        mesh when its RAW table degree is above 1 (as the JAX op's
        ``param_axes``), an ``Embedding`` split by width over the axes of
        its output's channel dim, a ``Linear`` split by channel the same
        way (``parallel.split``), and every other table replicated (also
        where ``configure_row_shard`` refused a request, after its
        warning). Host-resident tables stay whole on every rank's host
        (each rank gathers its rows; every rank applies the global
        batch's update, ``_host_update_after_step``)."""
        from ..ops.embedding import configure_row_shard
        from ..parallel.pconfig import ParallelConfig
        from ..parallel.sharding import AxisAssigner
        asn = AxisAssigner(self.mesh)
        self._op_pc, self._out_axes = {}, {}
        for op in self.ops:
            if isinstance(op, InputOp):
                continue
            pc = self._effective_pc(op)
            if hasattr(op, "_row_shard_geometry"):
                configure_row_shard(op, self.strategies.get(op.name))
            try:
                out_axes = op.output_axes(pc, asn,
                                          self.strategies.get(op.name, pc))
            except ValueError:
                msg = (f"strategy for {op.name!r} degrees {pc.degrees} are "
                       f"not jointly assignable on mesh "
                       f"{dict(self.mesh.shape)}; executing replicated")
                if self.config.strict_strategies:
                    raise ValueError(msg) from None
                log_model.warning(msg)
                pc = ParallelConfig((1,) * op.outputs[0].num_dims)
                out_axes = asn.assign(pc.degrees)
            self._op_pc[op.name] = pc
            self._out_axes[op.name] = out_axes
        self._collectives = None
        for op in self.ops:
            if hasattr(op, "bind_split"):
                op.bind_split(None)
        from ..parallel.distributed import world_size
        if self.mesh.size > 1 and world_size() == self.mesh.size:
            self._dist()

    def _check_across_ranks(self):
        """Raise for a batch that does not divide over the mesh's ranks
        (see ``_build_placement``); else how each op splits, {op name:
        (kind, mesh axes)}: "table" (stacked tables split by table),
        "rows" (the concatenated table's row blocks), "width", "channel"
        or "replicated" (a table whole on every rank). Row-sharded ops
        (``_row_plan``) and data-parallel ops have no entry."""
        from ..ops.embedding import (Embedding, EmbeddingBagConcat,
                                     EmbeddingBagStacked)
        from ..ops.linear import Linear
        from ..parallel.sharding import AxisAssigner
        asn = AxisAssigner(self.mesh)
        world = self.mesh.size
        batch = self.input_tensors[0].shape[0] if self.input_tensors else 0
        if batch % world:
            raise ValueError(f"the global batch {batch} does not divide "
                             f"over {world} ranks")
        hres = {op.name for op in self._host_resident_list}
        plan = {}
        for op in self.ops:
            if getattr(op, "_row_plan", None) is not None:
                continue                  # row-sharded: parallel/alltoall
            if op.name in hres:
                continue                  # whole on every rank's host
            axes = self._out_axes.get(op.name)
            if isinstance(op, Linear):
                if asn.degree(axes[-1]) > 1:
                    plan[op.name] = ("channel", axes[-1])
            elif isinstance(op, EmbeddingBagStacked):
                plan[op.name] = (("table", axes[1]) if asn.degree(axes[1]) > 1
                                 else ("replicated", ()))
            elif isinstance(op, EmbeddingBagConcat):
                raw = self.strategies.get(op.name)
                if raw is not None and len(raw.degrees) > 1 \
                        and raw.degrees[1] > 1:
                    if op.total_rows % world:
                        raise ValueError(
                            f"{op.name!r}: {op.total_rows} rows do not "
                            f"split in equal blocks over {world} ranks")
                    plan[op.name] = ("rows", tuple(self.mesh.axis_names))
                else:
                    plan[op.name] = ("replicated", ())
            elif isinstance(op, Embedding):
                plan[op.name] = (("width", axes[-1])
                                 if asn.degree(axes[-1]) > 1
                                 else ("replicated", ()))
        for name, (kind, axes) in plan.items():
            op = self.get_layer_by_name(name)
            if kind == "width" and self._sr_policy_of(name) is not None \
                    and (op.out_dim // asn.degree(axes)) % 4:
                raise ValueError(
                    f"{name!r}: stochastic rounding of a table split by "
                    f"width needs pieces of a multiple of 4 columns (the "
                    f"Philox counter's 4-value chunks), got "
                    f"{op.out_dim} columns over {asn.degree(axes)} ranks")
        return plan

    def _dist(self):
        """The collectives of a mesh of more than one rank (made at the
        first use; the mesh must be the process group), or None. Binds
        every op's split (``_check_across_ranks``) in op order on every
        rank: the exchanges make their process groups in one order
        everywhere."""
        if self.mesh is None or self.mesh.size == 1:
            return None
        if self._collectives is None:
            from ..parallel import distributed
            if self.mesh.ranks != tuple(range(distributed.world_size())):
                raise ValueError(
                    f"the mesh spans ranks {self.mesh.ranks} but the "
                    f"process group has {distributed.world_size()}: "
                    f"initialize_distributed() with as many ranks")
            from ..parallel.alltoall import RowExchange
            from ..parallel.split import OpSplit
            plan = self._check_across_ranks()
            coll = self._collectives = distributed.Collectives()
            me = distributed.rank()
            for op in self.ops:
                if getattr(op, "_row_plan", None) is not None:
                    op.bind_row_exchange(RowExchange(op._row_plan, coll, me))
                    continue
                if op.name not in plan:
                    continue
                kind, axes = plan[op.name]
                op.bind_split(OpSplit(kind, self.mesh, axes, coll, me))
        return self._collectives

    def _split_dense_ops(self) -> List[Op]:
        """The table ops split by table, row block or width whose table
        takes a dense update (``sparse_embedding_update`` off): the step
        builds each piece's gradient with ``split_dense_grad``, since the
        split lookup's collectives are no autograd graph."""
        sparse = {op.name for op in self._select_sparse_update_ops()}
        return [op for op in self.ops
                if getattr(op, "_split", None) is not None
                and op._split.kind in ("table", "rows", "width")
                and op.name not in sparse]

    def _split_params(self) -> set:
        """The ops whose parameters are split over the ranks (row shards,
        tables split by table, row block or width, a ``Linear`` split by
        channel): their gradients are never all-reduced."""
        out = set()
        for op in self.ops:
            split = getattr(op, "_split", None)
            if getattr(op, "_row_plan", None) is not None \
                    or (split is not None and split.kind != "replicated"):
                out.add(op.name)
        return out

    @contextlib.contextmanager
    def _as_one_card(self):
        """Every split op as one card runs it, for a batch that does not
        divide over the ranks (the JAX route: the op gathers its table):
        yields the parameters with each split op's gathered whole
        (``whole_params``, one all-gather a parameter), and while inside,
        the ops' splits are off."""
        attrs = ("_row_plan", "_split")
        params = dict(self.params)
        for op in self.ops:
            whole = getattr(op, "whole_params", None)
            if whole is not None and op.name in params:
                p = whole(params[op.name])
                if p is not None:
                    params[op.name] = p
        saved = [(op, {a: getattr(op, a) for a in attrs if hasattr(op, a)})
                 for op in self.ops]
        for op, st in saved:
            for a in st:
                setattr(op, a, None)
        try:
            yield params
        finally:
            for op, st in saved:
                for a, v in st.items():
                    setattr(op, a, v)

    def _resolve_host_ops(self):
        """The ops whose tables are host-resident: under
        ``config.host_resident_tables`` every op with a host form, as the
        JAX package's global flag selects them (core/model.py:636-657
        there). The JAX package can also select single ops by a strategy
        file's ZCM memory type, and so does the port. An input that only
        host-resident ops read stays on the host."""
        hres = [op for op in self.ops if not isinstance(op, InputOp)
                and hasattr(op, "host_lookup")
                and (self.config.host_resident_tables
                     or "ZCM" in getattr(self.strategies.get(op.name),
                                         "memory_types", ()))]
        for op in hres:
            if any(t.owner_op is not None
                   and not isinstance(t.owner_op, InputOp)
                   for t in op.inputs):
                raise ValueError(
                    f"host-resident table op {op.name!r} must consume "
                    f"a model input directly (use the fused DLRM "
                    f"embedding layout)")
            if (getattr(op, "aggr", None) == "none"
                    and not getattr(op, "host_aggr_none_ok", False)):
                raise ValueError(
                    f"host-resident table op {op.name!r}: aggr='none' "
                    f"is not implemented on the host path for this op")
        names = {op.name for op in hres}
        consumers: Dict[str, List[Op]] = {}
        for op in self.ops:
            for t in op.inputs:
                if isinstance(t.owner_op, InputOp):
                    consumers.setdefault(t.name, []).append(op)
        self._host_resident_list = hres
        self._host_only_inputs = {
            name for name, cons in consumers.items()
            if cons and all(c.name in names for c in cons)}

    def init_layers(self, seed: Optional[int] = None):
        """Draw every op's parameters on ``self.device`` from one
        ``torch.Generator`` seeded with ``seed`` (default config.seed)."""
        seed = self.config.seed if seed is None else seed
        self._dist()       # a table-parallel op draws only its tables
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        self._host_drain()
        self._host_prefetch_invalidate()
        self._resolve_host_ops()
        hres = {op.name for op in self._host_resident_list}
        params, host = {}, {}
        for i, op in enumerate(self.ops):
            if op.name in hres:
                # drawn in host RAM by numpy, as the JAX package draws
                # them: the same seed gives the same tables
                host[op.name] = op.host_init(seed + i)
                self._quant_init_host(op, host[op.name])
            elif not isinstance(op, InputOp) and op.param_defs():
                params[op.name] = self._quant_init_device(
                    op, op.init_params(gen, self.device))
        self.params = params
        self.host_params = host
        self.host_opt_state = {}
        self.opt_state = None
        self._step = 0
        self.reset_metrics()
        return self

    def swap_params(self, params: Optional[Dict[str, Dict[str, torch.Tensor]]]
                    = None, host_params=None, op_state=None):
        """Install new parameters (the hot-reload hook, with the JAX
        signature), checked first against every op's ParamDefs (names,
        shapes, dtypes, device), and host-resident tables
        (``host_params``, {op name: {"kernel": numpy table}}) against the
        model's host layout; a mismatch raises before anything is
        replaced. An in-flight host scatter lands first, and a chained
        gather is dropped. The serving engine's batcher thread is the
        only caller during serving, between dispatches. The port has no
        op state (a non-empty ``op_state``: ROADMAP queue 1 item 11)."""
        from ..utils.weights import host_param_shapes
        if op_state and any(op_state.values()):
            raise NotImplementedError(
                "swap_params(op_state=...): op state is not ported yet "
                "(ROADMAP queue 1 item 11)")
        if host_params is not None:
            want_host = host_param_shapes(self)
            if set(host_params) != set(want_host):
                raise ValueError(
                    f"swap_params: host tables {sorted(host_params)} do "
                    f"not match the model's {sorted(want_host)}")
            for name, shapes in want_host.items():
                got = host_params[name]
                if set(got) != set(shapes) or any(
                        np.asarray(got[pn]).shape != shape
                        or np.asarray(got[pn]).dtype != np.float32
                        for pn, shape in shapes.items()):
                    raise ValueError(
                        f"swap_params: host table {name} does not hold "
                        f"{shapes} in float32")
        if params is not None:
            self._check_params(params)
        self._host_drain()
        self._host_prefetch_invalidate()
        if host_params is not None:
            self.host_params = host_params
        if params is not None:
            self.params = params

    def _check_params(self, params):
        hres = {op.name for op in self._host_resident_list}
        want = {op.name: op.param_defs() for op in self.ops
                if not isinstance(op, InputOp) and op.param_defs()
                and op.name not in hres}
        if set(params) != set(want):
            raise ValueError(f"swap_params: ops {sorted(params)} do not "
                             f"match the model's {sorted(want)}")
        for name, defs in want.items():
            got = params[name]
            if set(got) != set(defs):
                raise ValueError(f"swap_params: {name} has params "
                                 f"{sorted(got)}, expected {sorted(defs)}")
            for pn, d in defs.items():
                v = got[pn]
                if tuple(v.shape) != tuple(d.shape) or v.dtype != d.dtype \
                        or v.device != self.device:
                    raise ValueError(
                        f"swap_params: {name}.{pn} is {tuple(v.shape)} "
                        f"{v.dtype} on {v.device}, expected "
                        f"{tuple(d.shape)} {d.dtype} on {self.device}")

    def apply_delta(self, delta: Dict[str, Any]):
        """Install a delta snapshot in place (the continual loop's hot
        path; see ``utils/delta.py``), as the JAX ``apply_delta``.

        ``delta`` is a ``load_delta_file`` payload: ``rows[key] = (idx,
        vals)`` replaces rows of a parameter in the JAX stored layout
        flattened to 2-D, ``full[key]`` replaces whole arrays, ``step``
        becomes the model's step. A payload from ``stage_delta_rows``
        also carries the rows already on the device in the port's layout
        (``"staged"``) and the staging stream's event (``"ready"``),
        which the current stream waits on before the first write.

        Everything is validated BEFORE anything is installed: an unknown
        key, a row index out of range or a width mismatch raises with
        the key named and the model untouched. The rows are then written
        with ``index_copy_`` on the (rows, width) view of the tensor, IN
        PLACE: the serving engine calls this only on its batcher thread
        between dispatches, where no queued kernel of another thread
        reads the tensor. Host tables (``hostparams/<op>/kernel``) take
        their rows and whole arrays in place under the table lock, as the
        JAX package's do. A delta for op state (``state/``) raises: the
        port has none yet (ROADMAP queue 1 item 11)."""
        from ..utils.weights import (host_param_shapes, jax_param_shapes,
                                     param_from_jax, rows_from_jax)
        step = int(delta["step"])
        rows = delta.get("rows") or {}
        full = delta.get("full") or {}
        staged = delta.get("staged") or {}
        shapes = {"params": jax_param_shapes(self),
                  "hostparams": host_param_shapes(self)}
        ops = {op.name: op for op in self.ops}

        def leaf(key, what):
            parts = key.split("/")
            if parts[0] not in shapes:
                raise ValueError(
                    f"delta {what} targets unsupported section {key!r} "
                    f"(the port has no op state yet: ROADMAP queue 1 item "
                    f"11)")
            sec = shapes[parts[0]]
            if (len(parts) != 3 or parts[1] not in sec
                    or parts[2] not in sec[parts[1]]):
                raise ValueError(
                    f"delta {what} {key!r} does not exist in this model "
                    f"(differently-built model?)")
            if parts[0] == "hostparams" and self._host_tables_released:
                raise ValueError(
                    f"delta {what} {key!r}: this model's host tables were "
                    f"released to the serving shard tier, which applies "
                    f"their rows")
            return parts[0], parts[1], parts[2], sec[parts[1]][parts[2]]

        # ---- validate first, install second ----------------------------
        plan, host_plan = [], []
        for key, (idx, vals) in rows.items():
            sec, opname, pn, shape = leaf(key, "row update")
            vals = np.asarray(vals)
            if len(shape) < 2 or vals.shape[-1:] != shape[-1:]:
                raise ValueError(
                    f"delta rows for {key!r} have width "
                    f"{vals.shape[-1:]} but the stored array is {shape}")
            nrows = int(np.prod(shape[:-1]))
            idx_np = np.asarray(idx)
            if idx_np.size and (int(idx_np.max()) >= nrows
                                or int(idx_np.min()) < 0):
                raise ValueError(
                    f"delta rows for {key!r} index up to "
                    f"{int(idx_np.max())} but the stored array has only "
                    f"{nrows} rows")
            if sec == "hostparams":
                host_plan.append((opname, pn, idx_np, vals))
            else:
                plan.append((key, opname, pn, idx_np, vals))
        fulls, host_fulls = [], []
        for key, v in full.items():
            sec, opname, pn, shape = leaf(key, "full update")
            if sec == "hostparams":
                if tuple(np.shape(v)) != tuple(shape):
                    raise ValueError(
                        f"delta full update {key!r} is {np.shape(v)} but "
                        f"the host table is {shape}")
                host_fulls.append((opname, pn, v))
            else:
                fulls.append((opname, pn,
                              param_from_jax(self, ops[opname], pn, v)))
        # ---- install ---------------------------------------------------
        ready = delta.get("ready")
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        with torch.no_grad():
            for key, opname, pn, idx_np, vals in plan:
                cur = self.params[opname][pn]
                if key in staged:
                    i, v = staged[key]
                    if ready is not None:
                        # made on the staging stream, read on this one
                        i.record_stream(torch.cuda.current_stream(
                            self.device))
                        v.record_stream(torch.cuda.current_stream(
                            self.device))
                else:
                    pidx, pvals = rows_from_jax(ops[opname], pn, idx_np,
                                                vals)
                    i = torch.from_numpy(pidx).to(self.device)
                    v = torch.from_numpy(np.ascontiguousarray(pvals))
                    v = v.to(self.device)
                cur.view(-1, cur.shape[-1]).index_copy_(
                    0, i, v.to(cur.dtype))
            for opname, pn, t in fulls:
                self.params[opname][pn] = t
        if host_plan or host_fulls:
            # an in-flight training scatter lands first; a chained gather
            # of the old rows is dropped
            self._host_drain()
            self._host_prefetch_invalidate()
            with self._host_table_lock:
                for opname, pn, idx_np, vals in host_plan:
                    tbl = self.host_params[opname][pn]
                    mi = np.unravel_index(idx_np, tbl.shape[:-1])
                    tbl[mi] = np.asarray(vals, dtype=tbl.dtype)
                for opname, pn, v in host_fulls:
                    self.host_params[opname][pn] = np.array(v, np.float32)
        self._step = step
        self._msums = None
        return self

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _batch_dtypes(self, batch: Dict[str, Any]) -> Dict[str, torch.dtype]:
        """The device dtype of every model input and, when the batch has
        one, of its ``"label"`` (int64 for the sparse categorical loss,
        else float32)."""
        for t in self.input_tensors:
            if t.name not in batch:
                raise ValueError(f"batch is missing input {t.name!r}")
        out = {t.name: t.dtype for t in self.input_tensors}
        if "label" in batch:
            out["label"] = (torch.int64 if self.loss_type
                            == losses_mod.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
                            else torch.float32)
        return out

    def _device_batch(self, batch: Dict[str, Any], local: bool = False
                      ) -> Dict[str, torch.Tensor]:
        """Stage a batch on ``self.device``: every model input, and the
        ``"label"`` when the batch has one. Inputs may be host arrays or
        tensors already on a device (``item_embeddings`` feeds the item
        head ids that never leave the card). An input that only
        host-resident tables read stays on the host, as a CPU tensor.
        On a mesh of several ranks the batch is the global one and this
        rank stages its rows of it (``host_local_slice``), unless
        ``local`` says they are its rows already."""
        if not local and self.mesh is not None and self.mesh.size > 1:
            from ..parallel.distributed import host_local_slice
            self._dist()
            batch = host_local_slice(
                {k: batch[k] for k in self._batch_dtypes(batch)})
        out = {}
        for k, dt in self._batch_dtypes(batch).items():
            v = batch[k]
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            dev = "cpu" if k in self._host_only_inputs else self.device
            out[k] = v.to(device=dev, dtype=dt)
        return out

    def _stage_step(self, batch: Dict[str, Any], local: bool = False
                    ) -> StagedBatch:
        """Stage a host batch for one training step from a staging
        thread (the prefetch ring's ``produce``): on the card through
        pinned memory, a non-blocking copy on this model's side stream
        (each rank's own) and an event; ``train_batch_staged`` orders the
        step after it. On a mesh of several ranks the batch is the global
        one and this rank stages its rows of it (``host_local_slice``),
        unless ``local`` says they are its rows already."""
        if not local and self.mesh is not None and self.mesh.size > 1:
            from ..parallel.distributed import host_local_slice
            batch = host_local_slice(
                {k: batch[k] for k in self._batch_dtypes(batch)})
        dts = self._batch_dtypes(batch)
        host = self._host_only_inputs
        staged = stage_batch({k: batch[k] for k in dts if k not in host},
                             {k: v for k, v in dts.items() if k not in host},
                             self.device, self._stage_stream)
        staged.host = {k: torch.as_tensor(np.array(batch[k])).to(dts[k])
                       for k in dts if k in host}
        return staged

    def _forward_env(self, params, batch: Dict[str, torch.Tensor],
                     overrides: Optional[Dict[str, torch.Tensor]] = None,
                     only_ops: Optional[set] = None
                     ) -> Dict[int, torch.Tensor]:
        """Run the graph on a staged batch: tensor guid -> value.
        ``overrides`` maps op name -> its precomputed output, whose
        compute is then skipped (the sparse update threads the lookups'
        outputs in here); ``only_ops`` restricts the run to those ops."""
        env: Dict[int, torch.Tensor] = {}
        for t in self.input_tensors:
            if t.name in batch:
                v = batch[t.name]
                # under bf16 compute float inputs enter the graph in bf16,
                # as in the JAX package
                if v.is_floating_point():
                    v = v.to(self.compute_dtype)
                env[t.guid] = v
        for op in self.ops:
            if isinstance(op, InputOp):
                continue
            if only_ops is not None and op.name not in only_ops:
                continue
            if overrides and op.name in overrides:
                env[op.outputs[0].guid] = overrides[op.name]
                continue
            outs = op.apply(params.get(op.name, {}),
                            [env[t.guid] for t in op.inputs])
            for t, v in zip(op.outputs, outs):
                env[t.guid] = v
        return env

    def forward_batch(self, batch: Dict[str, Any],
                      host_gather: Optional[Callable] = None
                      ) -> torch.Tensor:
        """Forward pass for one host batch (no labels): the output
        tensor's value, on ``self.device``. The caller's ``.cpu()`` is
        the synchronisation. Across ranks the batch is the global one and
        every rank gets all of its predictions, in row order, as the JAX
        package's global output: a batch that divides over the ranks runs
        split, each rank on its rows, and the predictions are all-gathered
        (one all-gather of the output, B rows); one that does not runs
        whole on every rank, each split op on its parameters gathered
        (``_as_one_card``: one all-gather of every split parameter at
        each call, the whole table, 0.73 GB for Criteo-Kaggle's
        concatenated one). ``host_gather`` replaces the host tables' row
        gather ({op name: numpy ids} -> {op name: rows on the device}):
        the serving engine passes its cached or shard-tier gather; the
        default is ``_host_emb_forward``."""
        if self._preds_tensor is None or self.params is None:
            raise ValueError("call compile() and init_layers() (or "
                             "swap_params()) first")
        rows = len(next(iter(batch.values())))
        coll = self._dist()
        # the JAX route for a batch that does not divide over the ranks:
        # every rank runs it whole, each op on its gathered table
        whole = coll is not None and rows % self.mesh.size != 0
        db, host_idx = self._split_host_idx(
            self._device_batch(batch, local=whole))
        rows = None
        if host_idx is not None:
            self._host_drain()   # eval sees the last step's scatter
            rows = (host_gather or self._host_emb_forward)(host_idx)
        if whole:
            with self._as_one_card() as params, torch.inference_mode():
                env = self._forward_env(params, db, overrides=rows)
            return env[self._preds_tensor.guid]
        with torch.inference_mode():
            env = self._forward_env(self.params, db, overrides=rows)
        out = env[self._preds_tensor.guid]
        if coll is not None:
            out = coll.all_gather(out, None, self.mesh.size)
        return out

    # --- serving entry points (serve/engine.py) -----------------------
    def bucket_sizes(self, max_batch: int) -> tuple:
        """The power-of-two batch buckets up to ``max_batch``, small to
        large. One device and no sharded inputs, so the floor is 1."""
        out, b = [], 1
        while b <= max(int(max_batch), 1):
            out.append(b)
            b *= 2
        return tuple(out)

    def forward_bucket(self, batch: Dict[str, Any],
                       bucket: Optional[int] = None,
                       host_gather: Optional[Callable] = None
                       ) -> torch.Tensor:
        """Zero-pad the batch's rows up to `bucket` (default: the smallest
        power of two >= rows), run it, and return predictions for ONLY
        the real rows."""
        from ..data.dataloader import pad_batch_rows
        n = int(next(iter(batch.values())).shape[0])
        if bucket is None:
            bucket = 1
            while bucket < n:
                bucket *= 2
        if bucket < n:
            raise ValueError(f"bucket {bucket} < batch rows {n}")
        padded = pad_batch_rows(batch, bucket) if bucket > n else batch
        out = self.forward_batch(padded, host_gather=host_gather)
        return out[:n] if bucket > n else out

    def warmup_buckets(self, buckets: Sequence[int],
                       host_gather: Optional[Callable] = None) -> float:
        """Run one zero batch of every bucket size, so no live request
        pays the first-call costs (kernel build and load, cuBLAS handle
        and workspace). Returns the warmup seconds."""
        t0 = time.perf_counter()
        for b in buckets:
            batch = {}
            for t in self.input_tensors:
                shape = (int(b),) + tuple(t.shape[1:])
                dtype = np.float32 if t.dtype.is_floating_point \
                    else np.int64
                batch[t.name] = np.zeros(shape, dtype)
            self.forward_batch(batch, host_gather=host_gather).cpu()
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _select_sparse_update_ops(self) -> List[Op]:
        """Embedding ops (``Embedding``, ``EmbeddingBagStacked``,
        ``EmbeddingBagConcat``) on the card whose tables take the
        touched-rows update, unless
        ``config.sparse_embedding_update`` is off: under plain SGD
        (momentum 0, weight decay 0) through ``sparse_sgd_update``; under
        SGD with momentum or weight decay, or Adam, through the stateful
        ``sparse_opt_update`` (as the JAX package's selection,
        core/model.py:875-903 there)."""
        from ..ops.embedding import (Embedding, EmbeddingBagConcat,
                                     EmbeddingBagStacked)
        if not self.config.sparse_embedding_update:
            return []
        opt = self.optimizer
        if not isinstance(opt, (SGDOptimizer, AdamOptimizer)):
            return []
        host = {op.name for op in self._host_resident_list}
        return [op for op in self.ops
                if isinstance(op, (Embedding, EmbeddingBagStacked,
                                   EmbeddingBagConcat))
                and op.supports_sparse_update() and op.name not in host]

    def _stateful_sparse(self) -> bool:
        """Whether the touched-rows update carries optimizer state or
        weight decay (``sparse_opt_update``) rather than plain SGD."""
        opt = self.optimizer
        return bool(opt.sparse_slab_names()) or (
            isinstance(opt, SGDOptimizer) and opt.weight_decay != 0.0)

    def _ancestor_op_names(self, targets) -> set:
        out: set = set()

        def visit(op):
            if isinstance(op, InputOp) or op.name in out:
                return
            out.add(op.name)
            for t in op.inputs:
                if t.owner_op is not None:
                    visit(t.owner_op)

        for op in targets:
            visit(op)
        return out

    def train_batch(self, batch: Dict[str, Any], next_host_idx=None):
        """One training step on a host batch holding every input and the
        ``"label"``; see ``train_batch_device``."""
        return self.train_batch_device(self._device_batch(batch),
                                       next_host_idx=next_host_idx)

    def train_batch_staged(self, staged: StagedBatch, next_host_idx=None):
        """One training step on a batch staged by ``_stage_step`` (the
        prefetch ring's items): the step's stream waits for the copy,
        then ``train_batch_device``."""
        return self.train_batch_device(staged.wait(),
                                       next_host_idx=next_host_idx)

    def train_batch_device(self, device_batch: Dict[str, torch.Tensor],
                           next_host_idx=None):
        """One training step — forward, backward and the update, in
        place — on a batch already on ``self.device`` (as
        ``_device_batch`` stages it, ``"label"`` included). Returns the
        step's metric sums and its ``"loss"`` as 0-d tensors on the
        device, and under the anomaly sentinel its ``"anomaly"`` (bool)
        and ``"grad_norm"``: nothing here waits for the device, except
        that "raise" and "rollback" read the flag back at the end and
        raise ``AnomalyError`` for a non-finite step (whose update the
        kernels suppressed).

        With host-resident tables the step gathers their rows on the
        host (or takes the rows the last step's worker gathered), copies
        them to the card, where they enter the graph as the ops' outputs,
        and brings their cotangents back for the host update: inline
        under ``--no-host-tables-async``, else on the ``ff-scatter``
        worker thread, which first gathers ``next_host_idx`` ({op name:
        ids}, or a callable giving it; the next step's ids, when the
        caller knows them) and then scatters this step's update. The
        sentinel's flag guards the host update under every policy: the
        one readback a policy costs there."""
        with obstrace.span("train/step", step=self._step):
            return self._train_step(device_batch, next_host_idx)

    def _split_host_idx(self, device_batch: Dict[str, torch.Tensor]):
        """(the batch less the inputs only host tables read, {op name:
        numpy ids} or None)."""
        if not self._host_resident_list:
            return device_batch, None
        out = dict(device_batch)
        host_idx = {}
        for op in self._host_resident_list:
            name = op.inputs[0].name
            host_idx[op.name] = out[name].cpu().numpy()
            if name in self._host_only_inputs:
                out.pop(name)
        return out, host_idx

    def _train_step(self, device_batch: Dict[str, torch.Tensor],
                    next_host_idx=None):
        if self._preds_tensor is None or self.params is None:
            raise ValueError("call compile() and init_layers() (or "
                             "swap_params()) first")
        if "label" not in device_batch:
            raise ValueError("a training batch needs its 'label'")
        policy = self.config.anomaly_policy
        coll = self._dist()
        if coll is not None:
            rows = int(next(iter(device_batch.values())).shape[0])
            want = self.input_tensors[0].shape[0] // self.mesh.size
            if rows != want:
                raise ValueError(f"a rank of {self.mesh.size} trains on "
                                 f"{want} rows of the global batch, got "
                                 f"{rows}")
        self._updating = False
        if faults.active() is not None and faults.take_nan_grad(self._step):
            # the fault harness: NaNs flow through the real backward into
            # the loss and the gradient norm the sentinel watches
            device_batch = faults.poison_batch(device_batch)
        if self._sparse_ops is None:
            self._sparse_ops = self._select_sparse_update_ops()
        if self.opt_state is None:
            self.opt_state = self.optimizer.init_state(self.params)
        sparse_ops = self._sparse_ops
        sparse_names = {op.name for op in sparse_ops}
        # split tables under a dense update: looked up as the sparse ones
        # are, their pieces' gradients built from the cotangents below
        split_dense = self._split_dense_ops() if coll is not None else []
        looked_up = sparse_ops + split_dense
        off_graph = {op.name for op in looked_up}
        device_batch, host_idx = self._split_host_idx(device_batch)

        # phase A (no grad): the lookups' ancestors, then the lookups
        # themselves, keeping their gathered rows for the update
        emb_vals, emb_fwd, emb_xs = {}, {}, {}
        if host_idx is not None:
            self._ensure_host_opt_state()
            # the host tables' rows enter as plain leaves; their
            # cotangents leave for the host update
            for name, v in self._host_emb_input(host_idx).items():
                emb_vals[name] = v.requires_grad_()
        if looked_up:
            with torch.no_grad():
                anc = self._forward_env(
                    self.params, device_batch,
                    only_ops=self._ancestor_op_names(looked_up)
                    - off_graph)
                for op in looked_up:
                    xs = [anc[t.guid] for t in op.inputs]
                    outs, emb_fwd[op.name] = op.apply_with_fwd(
                        self.params[op.name], xs)
                    emb_vals[op.name] = outs[0].requires_grad_()
                    emb_xs[op.name] = xs

        # phase B: the loss's gradient w.r.t. the dense parameters and
        # the lookups' outputs; the tables of sparse ops stay out
        leaves = {name: {pn: v.detach().requires_grad_()
                         for pn, v in p.items()}
                  for name, p in self.params.items()
                  if name not in off_graph}
        env = self._forward_env(leaves, device_batch, overrides=emb_vals)
        preds = env[self._preds_tensor.guid]
        loss = losses_mod.loss_fn(self.loss_type)(
            env[self._logits_tensor.guid], device_batch["label"])
        if coll is not None:
            # the global batch's mean: each rank's mean over its equal
            # share, over the ranks (a power of two scales exactly)
            loss = loss * (1.0 / self.mesh.size)
        flat = [v for p in leaves.values() for v in p.values()] \
            + list(emb_vals.values())
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(flat, grads)]
        it = iter(grads)
        gd = {name: {pn: next(it) for pn in p} for name, p in leaves.items()}
        gev = {name: next(it) for name in emb_vals}
        dense = buf = None
        if coll is not None:
            with torch.no_grad():
                for op in split_dense:
                    # the piece's gradient joins the dense update (never
                    # all-reduced: ``_split_params``); built before the
                    # all-reduce, whose buffer carries the sentinel's sum
                    gd[op.name] = op.split_dense_grad(
                        self.params[op.name], emb_xs[op.name],
                        gev[op.name], fwd=emb_fwd[op.name])
            # the dense gradients summed over the ranks, in one buffer:
            # every rank gets the same bits, so its replicated weights
            # stay equal (a split parameter's gradient is already its
            # piece's whole one: the exchange summed it on the owner, or
            # the split's collectives brought the global batch's
            # cotangent)
            local = self._split_params()
            dense = [g for name, p in gd.items() if name not in local
                     for g in p.values()]
            if dense or policy != "none":
                buf = self._dense_all_reduce(
                    coll, dense, loss.detach(),
                    self._own_grads(gd, gev, local, split_dense)
                    if policy != "none" else None)

        with torch.no_grad():
            # the sentinel's flag exists before the first update reads it
            ok = gnorm = None
            if policy != "none" and coll is None:
                _, gnorm, ok = grad_sumsq(grads, loss.detach())
            elif policy != "none":
                # the replicated gradients, all-reduced, plus every rank's
                # own, summed in the buffer's slot; the flag from the
                # global loss: the same on every rank
                _, gnorm, ok = grad_sumsq(dense, buf[-1],
                                          addend=buf[-2:-1])
            self._updating = True
            # the state of the sparse tables is not part of the dense
            # update: split it out, update it touched-rows only, and merge
            # it back (in place, the split shares the merged tensors), so
            # opt_state stays one tree of the JAX package's shape
            slab_names = self.optimizer.sparse_slab_names()
            dense_state, sparse_state = {}, {}
            for k, sub in self.opt_state.items():
                if k in slab_names:
                    dense_state[k] = {n: v for n, v in sub.items()
                                      if n not in sparse_names}
                    sparse_state[k] = {n: v for n, v in sub.items()
                                       if n in sparse_names}
                else:
                    dense_state[k] = sub
            # the sparse ops first: they take the step before the dense
            # update counts this one (Adam's alpha_t)
            step = self.opt_state.get("step")
            for op in sparse_ops:
                if self._stateful_sparse():
                    # the hybrid's hot_kernel carries state of its own
                    nested = "hot_kernel" in self.params[op.name]
                    op.sparse_opt_update(
                        self.params[op.name], emb_xs[op.name], gev[op.name],
                        self.optimizer,
                        {k: (sparse_state[k][op.name] if nested
                             else sparse_state[k][op.name]["kernel"])
                         for k in slab_names},
                        step, fwd=emb_fwd[op.name], ok=ok)
                else:
                    op.sparse_sgd_update(self.params[op.name],
                                         emb_xs[op.name], gev[op.name],
                                         self.optimizer.lr,
                                         fwd=emb_fwd[op.name], ok=ok)
            self.optimizer.update({name: self.params[name] for name in gd},
                                  gd, dense_state, ok)
            # stochastic_rounding: re-quantize every updated table of a
            # policy op in the step (master_weight trains the exact fp32
            # master); a step the sentinel skips writes nothing here
            self._requant_sr_params(ok)
            preds = preds.detach()
            if ("crossentropy" in self.loss_type
                    and self._preds_tensor is self._logits_tensor):
                # the graph ends in logits: metrics take probabilities
                preds = torch.softmax(preds.float(), dim=-1)
            mets = metrics_mod.compute_metrics(
                self.metrics, self.loss_type, preds, device_batch["label"])
            loss = loss.detach()
            if coll is not None:
                # the metrics' sums and the loss over the ranks, at once
                keys = list(mets)
                both = coll.all_reduce_sum_(torch.stack(
                    [mets[k].float() for k in keys] + [loss.float()]))
                mets = {k: both[i] for i, k in enumerate(keys)}
                loss = both[-1]
            if self._msums is None:
                self._msums = {k: torch.zeros_like(v)
                               for k, v in mets.items()}
            passed = None if ok is None else ok.bool()
            for k, v in mets.items():
                # a skipped step adds nothing: its NaNs would spoil the
                # epoch's sums for good
                self._msums[k] += (v if passed is None
                                   else torch.where(passed, v, 0.0))
        self.perf.sums = dict(self._msums)
        if host_idx is not None:
            self._host_update_after_step(
                host_idx, {op.name: gev[op.name]
                           for op in self._host_resident_list},
                ok, next_host_idx)
        self._updating = False
        self._step += 1          # a skipped step counts, as in JAX
        mets["loss"] = loss
        if ok is not None:
            mets["anomaly"] = ~passed
            mets["grad_norm"] = gnorm
            if policy in ("rollback", "raise") and not bool(ok):
                # the one host sync these policies add
                raise AnomalyError(step=self._step - 1,
                                   loss=float(loss.detach()),
                                   grad_norm=float(gnorm))
        return mets

    def _dense_all_reduce(self, coll, dense, loss, own):
        """Sum the replicated dense gradients ``dense`` over the ranks in
        place, in one all-reduce of one buffer, which it returns. Under
        the sentinel (``own``, this rank's own gradients, not None) the
        buffer ends in two more elements: the first ``grad_sumsq``
        launch's sum over ``own`` and this rank's share of the loss, so
        that after the all-reduce its last two elements are the global
        sum of the ranks' own squares and the global batch's loss."""
        parts = [g.reshape(-1) for g in dense]
        if own is not None:
            parts.append(torch.zeros(2, dtype=torch.float32,
                                     device=loss.device))
        buf = torch.cat(parts)
        if own is not None:
            buf[-1:].copy_(loss.float().reshape(1))
            grad_sumsq(own, loss, out=buf[-2:-1])
        coll.all_reduce_sum_(buf)
        at = 0
        for g in dense:
            g.copy_(buf[at:at + g.numel()].view_as(g))
            at += g.numel()
        return buf

    def _own_grads(self, gd, gev, local, split_dense) -> List[torch.Tensor]:
        """The gradients of the sentinel's norm that this rank holds of
        its own, as the JAX step's ``grad_leaves`` count them over the
        mesh: its rows' cotangents of every lookup and host table (each
        rank's rows are its own), and its pieces of the split parameters
        where it is the first rank holding the piece (the copies of a
        block, or a parameter every rank holds whole, count once). A
        table on a dense update counts its piece's gradient, not the
        cotangent."""
        from ..parallel.distributed import rank
        from ..utils.weights import piece_layout
        mesh = self.mesh
        pos = mesh.ranks.index(rank())
        dense_tables = {op.name for op in split_dense}
        out = [g for name, g in gev.items() if name not in dense_tables]
        ops = {op.name: op for op in self.ops}
        for name in sorted(local & set(gd)):
            for pn, g in gd[name].items():
                lay = piece_layout(ops[name], pn)
                if lay is None:
                    first = pos == 0
                else:
                    blocks = [mesh.linear_index(r, lay[0])
                              for r in mesh.ranks]
                    first = blocks.index(blocks[pos]) == pos
                if first:
                    out.append(g)
        return out

    def reset_metrics(self):
        """Start a new epoch's running metric sums."""
        self.perf.reset()
        self._msums = None

    # ------------------------------------------------------------------
    # host-resident tables (the JAX package's core/model.py:1893-2130)
    # ------------------------------------------------------------------
    def _ensure_host_opt_state(self):
        """The stateful optimizers' table-shaped slabs of each host table,
        zero, in host RAM beside it (made at the first step: the port's
        ``init_layers`` may run before ``compile``)."""
        for op in self._host_resident_list:
            slabs = self.host_opt_state.setdefault(op.name, {})
            for k in self.optimizer.sparse_slab_names():
                if k not in slabs:
                    slabs[k] = np.zeros_like(
                        self.host_params[op.name]["kernel"])

    def _host_update_after_step(self, host_idx, cts, ok, next_host_idx):
        """The host update of the step just queued (see
        ``train_batch_device``); ``step`` is this step's number before it
        counts, as Adam's bias correction reads it. Across ranks each
        rank's ids and cotangents are its rows of the global batch; they
        are all-gathered first, on this (the main) thread, and every rank
        applies the global batch's update in its row order (world 1's
        order of duplicates), so the ranks' copies of the tables stay
        bitwise equal."""
        step = self._step
        coll = self._dist()
        if coll is not None:
            host_idx, cts = self._host_global(coll, host_idx, cts)
        if not self.config.host_tables_async:
            # exact ordering: the readback is the step's completion
            if ok is None or bool(ok):
                self._host_emb_update(host_idx, cts, step)
            return
        # one worker in flight: land the previous one first
        self._host_drain()
        nh = next_host_idx() if callable(next_host_idx) else next_host_idx
        gathered = threading.Event()
        self._host_gather_pending = ((nh, gathered) if nh is not None
                                     else None)
        gen = self._host_gen

        def scatter():
            try:
                try:
                    if nh is not None:
                        self._host_gather_next = (
                            nh, self._host_emb_forward(nh))
                finally:
                    gathered.set()   # never leave the consumer waiting
                faults.maybe_stall("scatter")
                if gen != self._host_gen:
                    # the tables were replaced under an abandoned worker:
                    # a late scatter would corrupt them
                    return
                if ok is None or bool(ok):
                    self._host_emb_update(host_idx, cts, step)
            except BaseException as e:   # raised again at the drain
                self._host_scatter_exc = e

        t = threading.Thread(target=scatter, daemon=True, name="ff-scatter")
        self._host_scatter_thread = t
        t.start()

    def _host_global(self, coll, host_idx, cts):
        """(the global batch's ids, its cotangents), host arrays a host
        table, from every rank's rows (two all-gathers a table, in rank
        order: the global batch's row order)."""
        ids, out = {}, {}
        with obstrace.span("host/readback", cat="host"):
            for op in self._host_resident_list:
                ids[op.name] = coll.all_gather_host(host_idx[op.name])
                out[op.name] = coll.all_gather_host(
                    cts[op.name].detach().float().cpu().numpy())
        return ids, out

    def _host_drain(self, deadline_s: Optional[float] = None):
        """Join the in-flight host scatter, if any, and raise the error it
        hit: a dropped scatter would corrupt training. Everything that
        reads the host tables for the latest update calls it first (eval,
        checkpoints, ``swap_params``, the end of ``fit``). With
        ``deadline_s`` a worker still running after it raises
        ``WorkerStalled`` and is left running."""
        from ..utils.watchdog import StallReport, WorkerStalled
        t = self._host_scatter_thread
        if t is not None and t.is_alive():
            if deadline_s:
                t0 = time.perf_counter()
                t.join(deadline_s)
                if t.is_alive():
                    raise WorkerStalled(StallReport(
                        worker=t.name, waiting_for="host-table scatter "
                        "completion", waited_s=time.perf_counter() - t0,
                        deadline_s=deadline_s, detail=f"step {self._step}"))
            else:
                t.join()
        self._host_scatter_thread = None
        exc = self._host_scatter_exc
        if exc is not None:
            self._host_scatter_exc = None
            raise exc

    def _host_abandon(self):
        """Drop the in-flight worker without joining it (a stalled one)
        and any chained gather; the tables' generation moves on, so a late
        scatter of that worker writes nothing."""
        self._host_gen += 1
        self._host_scatter_thread = None
        self._host_scatter_exc = None
        self._host_prefetch_invalidate()

    def _host_prefetch_invalidate(self):
        """Drop a chained gather: stale once the tables are replaced."""
        self._host_gather_next = None
        self._host_gather_pending = None

    def _host_emb_input(self, host_idx):
        """This step's host rows on the card: the rows the last step's
        worker gathered for these ids when it did (it gathers before its
        scatter: the bounded one-step staleness of the async mode), else
        a gather now."""
        pending = self._host_gather_pending
        if pending is not None and _same_ids(pending[0], host_idx):
            self._host_gather_pending = None
            pending[1].wait()
            got = self._host_gather_next
            self._host_gather_next = None
            if got is not None and _same_ids(got[0], host_idx):
                return got[1]
            # the worker died before its gather: its error surfaces here
            self._host_drain()
        return self._host_emb_forward(host_idx)

    def _host_emb_forward(self, host_idx):
        """Gather the host tables' rows for ``host_idx`` and copy them to
        the card. Only the table reads hold the table lock (a lookup
        returns fresh arrays); the copy runs after it."""
        rows = {}
        with obstrace.span("host/gather", cat="host"), self._host_table_lock:
            for op in self._host_resident_list:
                rows[op.name] = op.host_lookup(self.host_params[op.name],
                                               host_idx[op.name])
        with obstrace.span("host/h2d", cat="host"):
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in rows.items()}

    def _host_emb_update(self, host_idx, cts, step):
        """Read the cotangents back (outside the table lock: the part the
        async mode overlaps) and update the host tables' touched rows:
        the SGD scatter, or the lazy stateful update under momentum,
        weight decay or Adam."""
        opt = self.optimizer
        stateful = bool(opt.sparse_slab_names()) or (
            isinstance(opt, SGDOptimizer) and opt.weight_decay != 0.0)
        with obstrace.span("host/readback", cat="host"):
            # (across ranks they are host arrays already: _host_global)
            cts_np = {k: (v if isinstance(v, np.ndarray)
                          else v.detach().float().cpu().numpy())
                      for k, v in cts.items()}
        with obstrace.span("host/scatter", cat="host"), \
                self._host_table_lock:
            for op in self._host_resident_list:
                if stateful:
                    op.host_opt_update(
                        self.host_params[op.name], host_idx[op.name],
                        cts_np[op.name], opt,
                        self.host_opt_state.get(op.name, {}), step)
                else:
                    op.host_sgd_update(self.host_params[op.name],
                                       host_idx[op.name],
                                       cts_np[op.name], opt.lr)
                pol = self._sr_policy_of(op.name)
                if pol is not None:
                    # stochastic_rounding: re-quantize exactly the rows
                    # this scatter touched, with the JAX package's
                    # per-step RandomState (bitwise its host path)
                    rows = np.unique(np.asarray(
                        op.host_delta_touched_rows(host_idx[op.name])))
                    kern = self.host_params[op.name]["kernel"]
                    v = kern.reshape(-1, kern.shape[-1])
                    rng = np.random.RandomState(
                        (self.config.seed ^ (int(step) * 2654435761))
                        & 0x7FFFFFFF)
                    v[rows] = fake_quant_stochastic_np(v[rows], pol.dtype,
                                                       rng)

    # ------------------------------------------------------------------
    # quantized embedding storage (quant/)
    # ------------------------------------------------------------------
    def quant_policies(self):
        """The non-default quantized-storage policies ``compile``
        resolved, {op name: QuantPolicy}: what the training step, the
        delta publisher, the serving cache and shard tier and the
        checkpoint manifest read."""
        return dict(getattr(self, "_quant_policies", {}) or {})

    def _sr_quant_ops(self):
        """The device-table ops whose policy re-quantizes in the step
        (stochastic_rounding with a dtype other than fp32), sorted by
        name: the order that numbers their draws."""
        hres = {op.name for op in self._host_resident_list}
        return sorted(
            (name, pol) for name, pol in self.quant_policies().items()
            if pol.update_rule == "stochastic_rounding"
            and pol.dtype != "fp32" and name not in hres)

    def _sr_policy_of(self, op_name: str):
        pol = self.quant_policies().get(op_name)
        if pol is None or pol.dtype == "fp32" \
                or pol.update_rule != "stochastic_rounding":
            return None
        return pol

    def _requant_sr_params(self, ok=None):
        """The step's stochastic-rounding hook: re-quantize, in place,
        the WHOLE table (``kernel``, and a ``hot_kernel`` where there is
        one) of every stochastic-rounding op, one ``fake_quant_rows``
        launch a parameter, over the JAX op's stored rows
        (``quant_row_width``). Re-quantizing only the touched rows would
        be another function: the codec's scale moves by an ulp, which
        moves untouched rows' codes under stochastic rounding. The draws
        are keyed by (seed, step, 0x51 + 2i + j) for the i-th op and j-th
        parameter, as the JAX step folds its key; ``ok`` 0 (a step the
        sentinel skips) writes nothing. A table split by width rounds its
        columns with the whole row's scale (``_fake_quant_piece``)."""
        sr = self._sr_quant_ops()
        if not sr:
            return
        from ..ops.embedding import quant_row_width
        from ..ops.kernels.quant_rows import fake_quant_rows
        ops = {op.name: op for op in self.ops}
        for i, (name, pol) in enumerate(sr):
            if name not in self.params:
                continue
            op = ops[name]
            w = quant_row_width(op)
            row0 = 0
            split = getattr(op, "_split", None)
            kind = split.kind if split is not None else None
            if kind == "table":
                # a rank's block of the stacked slots: its rows' global
                # numbers key the draws
                row0 = op.local_slots().start * op.num_entries * \
                    op.out_dim // w
            elif kind == "rows":
                # a rank's row block of the concatenated table, the same
                row0 = split.block * self.params[name]["kernel"].shape[0] \
                    * op.out_dim // w
            elif kind == "width":
                self._fake_quant_piece(
                    split, self.params[name]["kernel"], pol.dtype,
                    "stochastic", seed=int(self.config.seed),
                    step=int(self._step), salt=0x51 + 2 * i, ok=ok)
                continue
            for j, pname in enumerate(("kernel", "hot_kernel")):
                p = self.params[name].get(pname)
                if p is None:
                    continue
                fake_quant_rows(p.view(-1, w), pol.dtype, "stochastic",
                                seed=int(self.config.seed),
                                step=int(self._step), salt=0x51 + 2 * i + j,
                                row0=row0, ok=ok)

    @staticmethod
    def _fake_quant_piece(split, piece, dtype, mode, **draws):
        """``fake_quant_rows`` of the rows of which ``piece`` (rows, d /
        dc) holds this rank's columns under a width split: each row's
        |x| max over the piece (``row_amax``), their max over the ranks
        of the other columns (one all-reduce, of the fp32 bits as int32:
        the order of non-negative floats, a NaN above every number, so
        the max propagates a NaN as the one-card reduction does), then
        the piece rounded with that scale and its draws at its columns
        of the row (``fake_quant_rows_amax``): bitwise those columns of
        the whole rows' rounding. bf16 rounds each value alone."""
        from ..ops.kernels.quant_rows import (fake_quant_rows,
                                              fake_quant_rows_amax,
                                              row_amax)
        if dtype == "bf16":
            fake_quant_rows(piece, dtype, mode, **draws)
            return
        amax = row_amax(piece)
        split.coll.all_reduce_max_(amax.view(torch.int32), split.group)
        fake_quant_rows_amax(piece, amax, dtype, mode,
                             col0=split.block * piece.shape[1], **draws)

    def _quant_init_device(self, op, p):
        """Under stochastic_rounding training starts from the stored
        representation: the fresh table is fake-quantized once (nearest)
        at init. master_weight tables stay exact fp32."""
        pol = self._sr_policy_of(op.name)
        if pol is None:
            return p
        from ..ops.embedding import quant_row_width
        from ..ops.kernels.quant_rows import fake_quant_rows
        split = getattr(op, "_split", None)
        if split is not None and split.kind == "width":
            self._fake_quant_piece(split, p["kernel"], pol.dtype, "nearest")
            return p
        w = quant_row_width(op)
        for n in ("kernel", "hot_kernel"):
            if n in p:
                fake_quant_rows(p[n].view(-1, w), pol.dtype, "nearest")
        return p

    def _quant_init_host(self, op, tbl):
        """The host table's counterpart of ``_quant_init_device`` (the
        JAX package's numpy codec, over unpacked rows)."""
        pol = self._sr_policy_of(op.name)
        if pol is None or "kernel" not in tbl:
            return
        k = tbl["kernel"]
        tbl["kernel"] = fake_quant_np(
            k.reshape(-1, k.shape[-1]), pol.dtype).reshape(
                k.shape).astype(np.float32)


    def _untrainable_shape(self, exc: BaseException) -> bool:
        """Whether a step's error says its batch cannot train at its
        shape: it was raised before the step wrote any parameter or
        optimizer state (in the forward, the backward or the sentinel's
        norm), and it is no error of the card (CUDA's errors surface late,
        at whatever call syncs next) or a stalled worker's. Anything else
        leaves the run in a state no later step may build on."""
        from ..utils.watchdog import WorkerStalled
        card = tuple(t for t in (getattr(torch, "AcceleratorError", None),
                                 torch.cuda.OutOfMemoryError) if t)
        return not (self._updating or isinstance(exc, (AnomalyError,
                                                        WorkerStalled) + card)
                    or "CUDA" in str(exc))

    def _staging_budget(self) -> float:
        """The bytes ``fit`` may stage the dataset into: 0.7 of the card's
        memory less what the parameters and the optimizer state hold
        there (the rest is room for activations and workspace), as the
        JAX ``fit`` sizes it against its chip's HBM; 2e9 on the CPU, the
        JAX package's cap for a second copy of the dataset in host
        memory."""
        if self.device.type != "cuda":
            return 2e9
        total = torch.cuda.get_device_properties(self.device).total_memory
        resident = _tree_bytes(self.params) + _tree_bytes(self.opt_state)
        return max(0.0, 0.7 * total - resident)

    def _staging_bytes(self, inputs, labels) -> float:
        """The device bytes of the whole dataset, in the dtypes a staged
        batch holds."""
        dts = self._batch_dtypes({**inputs, "label": labels})
        sizes = {**{k: np.asarray(v).size for k, v in inputs.items()},
                 "label": np.asarray(labels).size}
        return float(sum(sizes[k] * dt.itemsize for k, dt in dts.items()))

    def fit(self, inputs: Dict[str, np.ndarray], labels: np.ndarray,
            epochs: Optional[int] = None, batch_size: Optional[int] = None,
            verbose: bool = True,
            checkpoint_dir: Optional[str] = None,
            save_every: Optional[int] = None,
            keep_last: Optional[int] = None,
            resume: bool = True):
        """Train for ``epochs`` (default ``config.epochs``) over host
        arrays in batches of ``batch_size`` (default
        ``config.batch_size``); the last ``len(labels) % batch_size``
        samples of each epoch train as one smaller batch, which is
        dropped with a warning when its step fails before any update
        (``_untrainable_shape``; any other error raises). When the
        dataset fits the staging budget (``_staging_budget``;
        ``config.stage_dataset``: "auto", "always" trusts the caller,
        "never" forces the ring) every batch is staged
        on the device once, as the JAX ``fit`` stages it; otherwise
        batches reach the device through the prefetch ring
        (``config.prefetch_depth`` batches ahead, on a staging thread; 0
        stages each in the loop). Both give the same result, bitwise.

        With ``checkpoint_dir`` the run is fault-tolerant, as the JAX
        ``fit``: rolling atomic snapshots every ``save_every`` optimizer
        steps (written on a background thread; the last ``keep_last``
        files and a manifest) and a final one; ``resume=True`` first
        restores the newest valid snapshot (parameters, optimizer state,
        step and the (epoch, batch) position) and skips corrupt,
        truncated or foreign ones. The three default from the config
        (``--checkpoint-dir``, ``--save-every``, ``--keep-last``). Under
        ``anomaly_policy="rollback"`` (which needs the directory; it is
        seeded with the initial state when it holds no valid snapshot) a
        non-finite step restores the newest snapshot and training goes
        on from its position, at most ``config.max_rollbacks`` times;
        then the ``AnomalyError`` is raised. With
        ``config.profile_dir`` the loop runs under a ``torch.profiler``
        trace written there. With ``--obs on`` a drift monitor watches
        each step's wall time (``"drift"`` in the result) and the span
        ring is exported to ``--obs-trace-dir``. Returns {"elapsed",
        "throughput", "num_samples", "rollbacks", "metrics"}. With
        host-resident tables in async mode each step passes the next
        step's ids, so the worker gathers them before its scatter, and
        the last scatter lands before ``fit`` returns. The fused
        supersteps are not ported yet (ROADMAP queue 1 item 6); the
        config refuses them.

        Across ranks (a mesh of several ranks, as the JAX ``fit`` on a
        mesh) every rank calls ``fit`` with the same global arrays and
        trains on its rows of each global batch: the whole-dataset
        staging and the ring stage each rank's own rows, the snapshots
        gather every rank's pieces into rank 0's one file (the
        ``CheckpointManager`` of ``utils/checkpoint.py``, made on every
        rank), the resume position and a rollback's snapshot are chosen
        on rank 0 and broadcast, the sentinel's flag is the same on every
        rank (so every rank skips, raises or rolls back at the same
        step), the metrics are the global batch's, and rank 0 alone
        prints. A remainder batch, which no rank's share fits, is
        dropped with a warning."""
        from ..data.prefetch import PrefetchPipeline
        from ..obs import configure as obs_configure
        from ..utils.checkpoint import CheckpointManager
        from ..utils.profiling import TraceContext
        epochs = epochs or self.config.epochs
        bs = batch_size or self.config.batch_size
        checkpoint_dir = checkpoint_dir or (self.config.checkpoint_dir
                                            or None)
        save_every = (self.config.save_every if save_every is None
                      else save_every)
        keep_last = self.config.keep_last if keep_last is None else keep_last
        policy = self.config.anomaly_policy
        n = len(labels)
        if n < bs:
            raise ValueError(f"dataset has {n} samples < batch size {bs}")
        num_batches, rem = divmod(n, bs)
        rem_ok = rem > 0
        if self.params is None:
            self.init_layers()
        if self.optimizer is not None and self.opt_state is None:
            # a snapshot (a rollback's seed among them) carries the state
            self.opt_state = self.optimizer.init_state(self.params)
        coll = self._dist()
        if coll is not None and rem_ok:
            log_model.warning(
                "dropping the remainder batch (%d samples): across %d "
                "ranks each trains on its share of a global batch of %d "
                "— pad the dataset or pick a batch size dividing %d",
                rem, self.mesh.size, bs, n)
            rem_ok = False
        verbose = verbose and self._is_rank0()

        mgr = None
        start_epoch = start_batch = 0
        if checkpoint_dir:
            mgr = CheckpointManager(checkpoint_dir, keep_last=keep_last,
                                    model=self)
            if resume:
                entry = mgr.restore_latest(self)
                if entry is not None:
                    ls = entry.get("loader_state") or {}
                    start_epoch = int(ls.get("epoch", 0))
                    start_batch = min(int(ls.get("batch", 0)), num_batches)
                    if verbose:
                        print(f"resumed from checkpoint step "
                              f"{entry['step']} (epoch {start_epoch}, "
                              f"batch {start_batch})")
            if start_epoch >= epochs:
                log_model.warning(
                    "checkpoint in %s is already at epoch %d >= epochs=%d; "
                    "nothing to train", checkpoint_dir, start_epoch, epochs)
                return {"elapsed": 0.0, "throughput": 0.0,
                        "num_samples": 0, "rollbacks": 0,
                        "metrics": self.perf.report()}
            if policy == "rollback" and mgr.latest_valid(
                    model=self) is None:
                # a rollback needs a target from the first step on
                mgr.save(self, {"epoch": start_epoch, "batch": start_batch})
        elif policy == "rollback":
            raise ValueError(
                'anomaly_policy="rollback" needs fit(checkpoint_dir=...) '
                "(or FFConfig.checkpoint_dir) to roll back to")

        def rows_of(b):
            return (slice(num_batches * bs, n) if b == "rem"
                    else slice(b * bs, (b + 1) * bs))

        def host_batch(b):
            sl = rows_of(b)
            batch = {k: v[sl] for k, v in inputs.items()}
            batch["label"] = labels[sl]
            return batch

        chain = bool(self._host_resident_list
                     and self.config.host_tables_async)

        def next_ids(j):
            # the host tables' ids of step j, which the async worker of
            # the step before gathers ahead
            if not chain or j >= len(sched):
                return None
            sl = rows_of(sched[j][1])
            ids = {op.name: np.asarray(inputs[op.inputs[0].name][sl])
                   for op in self._host_resident_list}
            if coll is not None:
                # each rank gathers its own rows
                from ..parallel.distributed import host_local_slice
                ids = host_local_slice(ids)
            return ids

        # the whole dataset on the device once, when it fits
        staged = staged_rem = None
        mode = self.config.stage_dataset
        cost = (float("inf") if mode == "never" else 0.0 if mode == "always"
                else self._staging_bytes(inputs, labels))
        if cost <= self._staging_budget():
            staged = [self._device_batch(host_batch(b))
                      for b in range(num_batches)]
            if rem_ok:
                staged_rem = self._device_batch(host_batch("rem"))

        # one entry per step from (e0, b0) on: (epoch, batch), batch "rem"
        # the remainder
        def schedule(e0, b0):
            return [(e, b) for e in range(e0, epochs)
                    for b in list(range(b0 if e == e0 else 0, num_batches))
                    + (["rem"] if rem_ok else [])]

        depth = max(int(self.config.prefetch_depth or 0), 0)
        use_pipe = staged is None and depth > 0
        pipe = None

        def build_pipe(sched):
            nonlocal pipe
            if pipe is not None:
                pipe.close()
                pipe = None
            if use_pipe and sched:
                pipe = PrefetchPipeline(
                    lambda i: self._stage_step(host_batch(sched[i][1])),
                    depth=depth, num_items=len(sched), name="fit")

        drift = None
        if obs_configure(self.config):
            # --obs on: the drift monitor watches each step's wall time
            from ..obs.drift import DriftMonitor
            drift = DriftMonitor.from_model(self, name="fit")
            drift.audit_collectives()
        sched = schedule(start_epoch, start_batch)
        build_pipe(sched)
        mets = None
        num_samples = 0
        rollbacks = 0
        i = 0
        start = time.perf_counter()
        try:
            with TraceContext(self.config.profile_dir or None):
                while i < len(sched):
                    epoch, b = sched[i]
                    if b == 0:
                        self.reset_metrics()   # an epoch starts at batch 0
                    if staged is not None:
                        step, arg = self.train_batch_device, (
                            staged_rem if b == "rem" else staged[b])
                    elif pipe is not None:
                        # the ring's errors (sticky, a missed deadline)
                        # raise here, outside the step's handlers
                        step, arg = self.train_batch_staged, pipe.get()
                    else:
                        step, arg = self.train_batch, host_batch(b)
                    t_step = time.perf_counter()
                    nh = next_ids(i + 1)
                    try:
                        mets = step(arg, next_host_idx=nh)
                    except AnomalyError as exc:
                        if (policy != "rollback" or mgr is None
                                or rollbacks >= self.config.max_rollbacks):
                            raise
                        rollbacks += 1
                        mgr.wait()
                        entry = mgr.restore_latest(self)
                        if entry is None:
                            raise
                        ls = entry.get("loader_state") or {}
                        e0 = int(ls.get("epoch", 0))
                        b0 = min(int(ls.get("batch", 0)), num_batches)
                        log_model.warning(
                            "anomaly at step %d (%s); rolled back to step "
                            "%d (epoch %d, batch %d) — recovery %d/%d",
                            exc.step, exc, entry["step"], e0, b0,
                            rollbacks, self.config.max_rollbacks)
                        # staged-ahead batches are dropped: the ring
                        # restarts at the restored position
                        sched, i = schedule(e0, b0), 0
                        build_pipe(sched)
                        continue
                    except Exception as e:
                        if b != "rem" or not self._untrainable_shape(e):
                            raise
                        rem_ok = False
                        log_model.warning(
                            "dropping the remainder batch (%d samples): it "
                            "cannot train at its own shape (%s) — pad the "
                            "dataset or pick a batch size dividing %d",
                            rem, e, n)
                        sched, i = schedule(epoch + 1, 0), 0
                        build_pipe(sched)
                        continue
                    if drift is not None:
                        drift.observe_step(time.perf_counter() - t_step)
                    num_samples += rem if b == "rem" else bs
                    # position = the next (epoch, batch) to train
                    nxt = ((epoch + 1, 0) if b == "rem"
                           else (epoch, b + 1))
                    if mgr is not None and save_every \
                            and self._step % save_every == 0:
                        mgr.save_async(self, {"epoch": nxt[0],
                                              "batch": nxt[1]})
                    last = i + 1 == len(sched) or sched[i + 1][0] != epoch
                    if verbose and last:
                        # the host syncs here only
                        print(f"epoch {epoch}: "
                              f"loss={float(mets['loss']):.6f} "
                              + self.perf.summary_line())
                    i += 1
                if mets is not None:
                    float(mets["loss"])   # waits for the last step
                self._host_drain()        # and the last host scatter
        except BaseException:
            # land a snapshot already copied to the host before the error
            # leaves fit; the error itself is what the caller sees
            if mgr is not None:
                try:
                    mgr.wait()
                except Exception as e:
                    log_model.warning("background checkpoint save failed "
                                      "(%s)", e)
            raise
        finally:
            if pipe is not None:
                pipe.close()
        elapsed = time.perf_counter() - start
        if mgr is not None:
            mgr.wait()        # raise a background save's error
            mgr.save(self, {"epoch": epochs, "batch": 0})  # final snapshot
        throughput = num_samples / elapsed if elapsed > 0 else float("inf")
        if verbose:
            print(f"ELAPSED TIME = {elapsed:.4f}s, "
                  f"THROUGHPUT = {throughput:.2f} samples/s")
        out = {"elapsed": elapsed, "throughput": throughput,
               "num_samples": num_samples, "rollbacks": rollbacks,
               "metrics": self.perf.report()}
        if drift is not None:
            out["drift"] = drift.report()
            obstrace.export_to_dir()   # no-op without --obs-trace-dir
        return out

    def _is_rank0(self) -> bool:
        """Whether this process prints and writes for the model: always on
        one rank, rank 0 only across ranks."""
        from ..parallel.distributed import rank
        return self._dist() is None or rank() == 0

    def fit_stream(self, source, steps: Optional[int] = None,
                   publisher=None, publish_every: Optional[int] = None,
                   verbose: bool = True, callbacks=None,
                   resume: bool = False):
        """Train off a streaming source, publishing snapshots for the
        serving fleet, as the JAX ``fit_stream``.

        ``source(i)`` returns the i-th host batch, a feature dict with its
        ``"label"`` (``data.stream.ArrayStream`` wraps in-memory arrays,
        ``data.replay.FeedbackSpool.source`` replays served traffic; any
        deterministic callable works). ``None``, ``StopIteration`` or
        ``IndexError`` ends the stream; ``steps`` bounds it (None: until
        the source ends). Batches ride the prefetch ring, as ``fit``'s do
        (at least one batch ahead), and each is shown to the publisher's
        ``TouchedRowTracker`` before it is staged. Every ``publish_every``
        steps (default ``--publish-every``) the publisher
        (``utils.delta.DeltaPublisher``) writes a delta or, when the
        chain compacts, a full checkpoint, inline on the training thread
        (the copy must see a quiesced step), with the stream position as
        ``loader_state["stream_step"]``; a partial last interval is
        published at the end. After each step every callback gets
        ``(model, steps trained, the step's metrics)``.

        ``resume=True`` restores the newest valid full checkpoint of the
        publisher's directory and continues the stream at its
        ``stream_step``; the publisher starts a fresh chain on a new full
        base (a dead trainer's chain cannot be extended). With ``--obs
        on`` a drift monitor watches each step's wall time and the trace
        ring is exported to ``--obs-trace-dir`` at the end.

        The anomaly policy "rollback" is refused (a stream has no epoch
        to rewind); "skip_step" and "raise" work as in any step. Returns
        {"steps", "elapsed", "throughput", "publishes", "publisher"} and,
        with obs on, "drift".

        Across ranks every rank runs ``fit_stream`` over the same source
        (each batch the global one) and stages its rows of each; the
        publisher (made on every rank over the same directory) gathers
        the pieces to rank 0, which writes, and a resume restores as
        ``CheckpointManager.restore_latest`` does across ranks; rank 0
        alone prints."""
        from ..data.prefetch import PrefetchPipeline
        from ..obs import configure as obs_configure
        if self.config.anomaly_policy == "rollback":
            raise ValueError(
                'anomaly_policy="rollback" is not supported by '
                "fit_stream (no epoch position to re-wind); use "
                '"skip_step" or "raise"')
        if publish_every is None:
            publish_every = int(self.config.publish_every)
        if publisher is not None and publish_every < 1:
            raise ValueError(
                "fit_stream(publisher=...) needs publish_every >= 1 "
                "(--publish-every N)")
        if self.params is None:
            self.init_layers()
        verbose = verbose and self._is_rank0()
        start = 0
        if resume and publisher is not None:
            entry = publisher.mgr.restore_latest(self)
            if entry is not None:
                start = int((entry.get("loader_state") or {})
                            .get("stream_step", 0))
                if verbose:
                    print(f"resumed stream from checkpoint step "
                          f"{entry['step']} (stream position {start})")

        def produce(i):
            try:
                batch = source(start + i)
            except (StopIteration, IndexError):
                raise IndexError("stream exhausted") from None
            if batch is None:
                raise IndexError("stream exhausted")
            if publisher is not None:
                publisher.observe_batch(batch)
            return self._stage_step(batch)

        drift = None
        if obs_configure(self.config):
            from ..obs.drift import DriftMonitor
            drift = DriftMonitor.from_model(self, name="fit_stream")
            drift.audit_collectives()
        depth = max(int(self.config.prefetch_depth or 0), 1)
        pipe = PrefetchPipeline(produce, depth=depth, num_items=steps,
                                name="fit_stream")
        trained = 0
        publishes = 0
        mets = None
        t0 = time.perf_counter()
        try:
            while steps is None or trained < steps:
                try:
                    staged = pipe.get()
                except IndexError:
                    break
                t_step = time.perf_counter()
                mets = self.train_batch_staged(staged)
                if drift is not None:
                    drift.observe_step(time.perf_counter() - t_step)
                trained += 1
                if publisher is not None and trained % publish_every == 0:
                    publisher.publish({"stream_step": start + trained})
                    publishes += 1
                if callbacks:
                    for cb in callbacks:
                        cb(self, trained, mets)
            if mets is not None:
                float(mets["loss"])   # waits for the last step
            self._host_drain()        # and the last host scatter
        finally:
            pipe.close()
        if publisher is not None and trained % publish_every:
            # the partial last interval: the fleet must not miss the tail
            publisher.publish({"stream_step": start + trained})
            publishes += 1
        elapsed = time.perf_counter() - t0
        bs = int(self.config.batch_size)
        rate = trained * bs / max(elapsed, 1e-9)
        if verbose and mets is not None:
            print(f"fit_stream: {trained} steps, "
                  f"loss={float(mets['loss']):.6f}, {rate:.2f} samples/s, "
                  f"{publishes} publish(es)")
        out = {"steps": trained, "elapsed": elapsed, "throughput": rate,
               "publishes": publishes,
               "publisher": (publisher.stats()
                             if publisher is not None else None)}
        if drift is not None:
            out["drift"] = drift.report()
            obstrace.export_to_dir()   # no-op without --obs-trace-dir
        return out
