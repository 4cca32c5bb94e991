"""FFModel: graph construction, parameter init and the serving forward.

The counterpart of ``dlrm_flexflow_tpu.core.model.FFModel``, cut to the
serving slice: the op builders the DLRM graph uses, ``compile`` (records
the optimizer, loss and metrics; the training step is not ported yet),
``init_layers``, ``forward_batch`` and the bucketed serving entries, and
``swap_params``. Op names, parameter names and parameter layouts follow
the JAX graph, so ``utils.weights.params_from_jax`` can carry a JAX
model's weights across by name.

There is no mesh and no jit: the graph runs eagerly on
``config.device``, op by op, under ``torch.inference_mode``. On a CUDA
device the embedding and interaction ops launch their hand-written
kernels; on the CPU they run the kernels' plain versions.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import FFConfig
from .op import InputOp, Op
from .tensor import Tensor


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda":
            # the slice computes in full fp32: a float32 matmul or
            # convolution must not drop to TF32 (PyTorch's default keeps
            # matmuls fp32 but lets cuDNN use TF32; both are set here)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._op_guid = 0
        self.ops: List[Op] = []          # topological (construction) order
        self.input_tensors: List[Tensor] = []
        self.compute_dtype = self.config.torch_compute_dtype
        # set by compile()
        self.optimizer = None
        self.loss_type: Optional[str] = None
        self.metrics: List[str] = []
        self._preds_tensor: Optional[Tensor] = None
        # set by init_layers() / swap_params()
        self.params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._step = 0

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
            raise NotImplementedError(
                "dense(activation='softmax') lowers to a Softmax op, which "
                "is not ported yet")
        return Linear(self, input_tensor, out_dim, activation or "none",
                      use_bias, kernel_initializer, bias_initializer,
                      name).outputs[0]

    def embedding_stacked(self, input_tensor, num_tables, num_entries,
                          out_dim, aggr="sum", kernel_initializer=None,
                          name=None):
        from ..ops.embedding import EmbeddingBagStacked
        return EmbeddingBagStacked(self, input_tensor, num_tables,
                                   num_entries, out_dim, aggr,
                                   kernel_initializer, name).outputs[0]

    def concat(self, tensors, axis, name=None):
        from ..ops.tensor_ops import Concat
        return Concat(self, list(tensors), axis, name).outputs[0]

    def reshape(self, input_tensor, shape, name=None):
        from ..ops.tensor_ops import Reshape
        return Reshape(self, input_tensor, shape, name).outputs[0]

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
                final_tensor: Optional[Tensor] = None):
        """Record the optimizer, loss and metrics and fix the output
        tensor. The training step is not ported yet, so nothing here
        builds one."""
        ops = [op for op in self.ops if not isinstance(op, InputOp)]
        if not ops:
            raise ValueError("compile() needs at least one op")
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.metrics = list(metrics)
        self._preds_tensor = (final_tensor if final_tensor is not None
                              else ops[-1].outputs[0])
        return self

    def init_layers(self, seed: Optional[int] = None):
        """Draw every op's parameters on ``self.device`` from one
        ``torch.Generator`` seeded with ``seed`` (default config.seed)."""
        seed = self.config.seed if seed is None else seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        params = {}
        for op in self.ops:
            if not isinstance(op, InputOp) and op.param_defs():
                params[op.name] = op.init_params(gen, self.device)
        self.params = params
        self._step = 0
        return self

    def swap_params(self, params: Dict[str, Dict[str, torch.Tensor]]):
        """Install new parameters, checked first against every op's
        ParamDefs (names, shapes, dtypes); a mismatch raises before
        anything is replaced. The serving engine's batcher thread is the
        only caller during serving, between dispatches."""
        want = {op.name: op.param_defs() for op in self.ops
                if not isinstance(op, InputOp) and op.param_defs()}
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
        self.params = params

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for t in self.input_tensors:
            if t.name not in batch:
                raise ValueError(f"batch is missing input {t.name!r}")
            v = torch.as_tensor(np.asarray(batch[t.name]), dtype=t.dtype)
            # under bf16 compute float inputs enter the graph in bf16, as
            # in the JAX package
            if t.dtype.is_floating_point:
                v = v.to(self.compute_dtype)
            out[t.name] = v.to(self.device)
        return out

    def forward_batch(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Forward pass for one host batch (no labels): the output
        tensor's value, on ``self.device``. The caller's ``.cpu()`` is
        the synchronisation."""
        if self._preds_tensor is None or self.params is None:
            raise ValueError("call compile() and init_layers() (or "
                             "swap_params()) first")
        db = self._device_batch(batch)
        env: Dict[int, torch.Tensor] = {}
        for t in self.input_tensors:
            env[t.guid] = db[t.name]
        with torch.inference_mode():
            for op in self.ops:
                if isinstance(op, InputOp):
                    continue
                outs = op.apply(self.params.get(op.name, {}),
                                [env[t.guid] for t in op.inputs])
                for t, v in zip(op.outputs, outs):
                    env[t.guid] = v
        return env[self._preds_tensor.guid]

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
                       bucket: Optional[int] = None) -> torch.Tensor:
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
        out = self.forward_batch(padded)
        return out[:n] if bucket > n else out

    def warmup_buckets(self, buckets: Sequence[int]) -> float:
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
            self.forward_batch(batch).cpu()
        return time.perf_counter() - t0
