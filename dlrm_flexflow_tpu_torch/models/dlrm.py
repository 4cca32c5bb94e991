"""DLRM, the flagship model (the counterpart of
``dlrm_flexflow_tpu.models.dlrm``).

Per-table embedding bags, a bottom MLP over the dense features, the
feature interaction, and a top MLP with a sigmoid head, built with the
same op names as the JAX graph (``bot_dense_i``, ``emb_stack``,
``emb_concat``, ``emb_i``, ``interaction_concat``, ``interaction_bmm``,
``interaction_tril``, ``fused_interaction``, ``top_dense_i``), so
parameter names and checkpoint fingerprints match the JAX package's.

The tables are one ``EmbeddingBagStacked`` when their sizes are uniform,
one ``EmbeddingBagConcat`` when they are not (Criteo's 26 tables), or
one ``Embedding`` per table with ``fuse_embeddings=False``. The
interaction is "cat", the unfused "dot" (``BatchMatmul`` of the stacked
features with themselves, then the strictly-lower triangle by
``IndexSelect``), or the fused "dot" (``fuse_interaction=True``, one
CUDA kernel on the card).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.initializers import UniformInitializer
from ..core.model import FFModel
from ..parallel.pconfig import ParallelConfig, StrategyMap


@dataclass
class DLRMConfig:
    """Arch flags: --arch-embedding-size dash-separated rows per table,
    --embedding-bag-size, --arch-sparse-feature-size, --arch-mlp-bot /
    --arch-mlp-top, --arch-interaction-op, --loss-threshold,
    --zipf-alpha."""

    embedding_size: List[int] = field(default_factory=lambda: [4] * 8)
    embedding_bag_size: int = 1
    sparse_feature_size: int = 2
    mlp_bot: List[int] = field(default_factory=lambda: [4, 2])
    mlp_top: List[int] = field(default_factory=lambda: [8, 2])
    arch_interaction_op: str = "cat"     # "cat" | "dot"
    loss_threshold: float = 0.0
    # zipf exponent for synthetic_batch's ids (0 = uniform draws)
    zipf_alpha: float = 0.0

    @staticmethod
    def random_benchmark() -> "DLRMConfig":
        """8 × 1M-row × 64-d tables, bot 64-512-512-64, top
        576-1024-1024-1024-1."""
        return DLRMConfig(
            embedding_size=[1000000] * 8,
            embedding_bag_size=1,
            sparse_feature_size=64,
            mlp_bot=[64, 512, 512, 64],
            mlp_top=[576, 1024, 1024, 1024, 1],
        )

    @staticmethod
    def criteo_kaggle() -> "DLRMConfig":
        """26 tables × 16-d, bot 13-512-256-64-16, top 224-512-256-1."""
        return DLRMConfig(
            embedding_size=[1396, 550, 2481689, 687, 20, 15, 204, 96, 14,
                            1400181, 397059, 3166985, 10, 2208, 11156, 155,
                            4, 976, 14, 1398149, 1263872, 1246444, 13107,
                            336, 101, 30],
            embedding_bag_size=1,
            sparse_feature_size=16,
            mlp_bot=[13, 512, 256, 64, 16],
            mlp_top=[224, 512, 256, 1],
        )

    @staticmethod
    def terabyte() -> "DLRMConfig":
        """Criteo-Terabyte (MLPerf DLRM) shapes: 26 tables up to ~40M rows
        × 128-d, bot 13-512-256-128, top 1024-1024-512-256-1."""
        return DLRMConfig(
            embedding_size=[39884406, 39043, 17289, 7420, 20263, 3, 7120,
                            1543, 63, 38532951, 2953546, 403346, 10, 2208,
                            11938, 155, 4, 976, 14, 39979771, 25641295,
                            39664984, 585935, 12972, 108, 36],
            embedding_bag_size=1,
            sparse_feature_size=128,
            mlp_bot=[13, 512, 256, 128],
            mlp_top=[1024, 1024, 512, 256, 1],
        )

    @staticmethod
    def parse_args(argv: List[str]) -> "DLRMConfig":
        cfg = DLRMConfig()
        i = 0
        while i < len(argv):
            a = argv[i]

            def take():
                nonlocal i
                i += 1
                if i >= len(argv):
                    raise ValueError(f"flag {argv[i - 1]!r} requires a value")
                return argv[i]

            if a == "--arch-embedding-size":
                cfg.embedding_size = [int(x) for x in take().split("-")]
            elif a == "--embedding-bag-size":
                cfg.embedding_bag_size = int(take())
            elif a == "--arch-sparse-feature-size":
                cfg.sparse_feature_size = int(take())
            elif a == "--arch-mlp-bot":
                cfg.mlp_bot = [int(x) for x in take().split("-")]
            elif a == "--arch-mlp-top":
                cfg.mlp_top = [int(x) for x in take().split("-")]
            elif a == "--arch-interaction-op":
                cfg.arch_interaction_op = take()
            elif a == "--loss-threshold":
                cfg.loss_threshold = float(take())
            elif a == "--zipf-alpha":
                cfg.zipf_alpha = float(take())
                if cfg.zipf_alpha < 0:
                    raise ValueError(
                        f"--zipf-alpha expects a >= 0 exponent, got "
                        f"{cfg.zipf_alpha}")
            i += 1
        return cfg


def create_mlp(model: FFModel, input_tensor, sizes: List[int],
               sigmoid_last: bool = False, prefix: str = "mlp"):
    """dense+relu per layer, sigmoid on the last layer when asked."""
    t = input_tensor
    for i, out_dim in enumerate(sizes[1:]):
        last = i == len(sizes) - 2
        act = "sigmoid" if (last and sigmoid_last) else "relu"
        t = model.dense(t, out_dim, activation=act,
                        name=f"{prefix}_dense_{i}")
    return t


def interact_features(model: FFModel, bottom_out, embedding_outs_3d,
                      arch_op: str, cfg: DLRMConfig):
    """"cat": concat the bottom-MLP output and the flattened embeddings
    along the feature dim. "dot": the pairwise dot products of the
    bottom-MLP output and the T embeddings, stacked to (batch, T+1, d):
    Z = X·Xᵀ by ``BatchMatmul``, flattened, its strictly-lower triangle
    (i > j) picked by ``IndexSelect`` and concatenated after the bottom
    output."""
    d = cfg.sparse_feature_size
    T = len(cfg.embedding_size)
    batch = bottom_out.shape[0]
    if arch_op == "cat":
        flat_embs = [model.reshape(e, (batch, T * d), name="emb_flatten")
                     if e.num_dims == 3 else e
                     for e in embedding_outs_3d]
        return model.concat([bottom_out] + flat_embs, axis=1,
                            name="interaction_concat")
    if arch_op == "dot":
        bot3 = model.reshape(bottom_out, (batch, 1, d), name="bot3d")
        parts = [bot3]
        for e in embedding_outs_3d:
            parts.append(e if e.num_dims == 3
                         else model.reshape(e, (batch, 1, d)))
        x = model.concat(parts, axis=1, name="interaction_stack")  # (b,F,d)
        z = model.batch_matmul(x, x, trans_a=False, trans_b=True,
                               name="interaction_bmm")            # (b,F,F)
        F = x.shape[1]
        zf = model.reshape(z, (batch, F * F), name="interaction_flat")
        tril = [i * F + j for i in range(F) for j in range(i)]
        zt = model.index_select(zf, tril, axis=1, name="interaction_tril")
        return model.concat([bottom_out, zt], axis=1,
                            name="interaction_concat")
    raise ValueError(f"unknown interaction op {arch_op}")


def build_dlrm(model: FFModel, cfg: DLRMConfig,
               fuse_embeddings: Optional[bool] = None,
               fuse_interaction: bool = False
               ) -> Tuple[Dict[str, tuple], object]:
    """Build the DLRM graph on `model`. Returns (input_specs,
    output_tensor); inputs 'dense' float (batch, mlp_bot[0]) and 'sparse'
    int64 (batch, T, bag).

    ``fuse_interaction=True`` (dot interaction, uniform tables) replaces
    the gather -> stack -> bmm -> tril -> first top dense chain with ONE
    FusedDotInteraction op."""
    batch = model.config.batch_size
    T = len(cfg.embedding_size)
    d = cfg.sparse_feature_size
    uniform = len(set(cfg.embedding_size)) == 1
    if fuse_embeddings is None:
        fuse_embeddings = True

    dense_in = model.create_tensor((batch, cfg.mlp_bot[0]), name="dense")
    sparse_in = model.create_tensor((batch, T, cfg.embedding_bag_size),
                                    dtype=torch.int64, name="sparse")

    bottom = create_mlp(model, dense_in, cfg.mlp_bot, sigmoid_last=False,
                        prefix="bot")

    emb_init = UniformInitializer(min_val=-0.05, max_val=0.05)
    if fuse_interaction:
        if cfg.arch_interaction_op != "dot":
            raise ValueError("fuse_interaction=True needs "
                             "--arch-interaction-op dot (the fused kernel "
                             "computes the pairwise-dot interaction)")
        if not uniform:
            raise ValueError("fuse_interaction=True needs uniform table "
                             "sizes (the fused gather stacks the tables "
                             "row-wise)")
        if len(cfg.mlp_top) < 2:
            raise ValueError("fuse_interaction=True needs at least one "
                             "top-MLP layer to fold into the kernel")
        # the fused op IS the first top-MLP layer; it takes the sigmoid
        # head when it is also the last
        fused_last = len(cfg.mlp_top) == 2
        fused = model.fused_dot_interaction(
            sparse_in, bottom, cfg.embedding_size[0], cfg.mlp_top[1],
            activation="sigmoid" if fused_last else "relu",
            emb_initializer=emb_init, name="fused_interaction")
        if fused_last:
            out = fused
        else:
            out = create_mlp(model, fused,
                             [cfg.mlp_top[1]] + cfg.mlp_top[2:],
                             sigmoid_last=True, prefix="top")
        inputs = {"dense": (batch, cfg.mlp_bot[0]),
                  "sparse": (batch, T, cfg.embedding_bag_size)}
        return inputs, out
    if fuse_embeddings and uniform:
        embs = [model.embedding_stacked(
            sparse_in, T, cfg.embedding_size[0], d, aggr="sum",
            kernel_initializer=emb_init, name="emb_stack")]  # (b,T,d)
    elif fuse_embeddings:
        # non-uniform row counts (Criteo's 26 tables): one
        # concatenated-rows table, one gather and one scatter a step
        embs = [model.embedding_concat(
            sparse_in, cfg.embedding_size, d, aggr="sum",
            kernel_initializer=emb_init, name="emb_concat")]  # (b,T,d)
    else:
        cols = model.split(sparse_in, [1] * T, axis=1, name="sparse_split")
        embs = []
        for i, (rows, col) in enumerate(zip(cfg.embedding_size, cols)):
            idx2d = model.reshape(col, (batch, cfg.embedding_bag_size),
                                  name=f"idx_{i}")
            embs.append(model.embedding(
                idx2d, rows, d, aggr="sum", kernel_initializer=emb_init,
                name=f"emb_{i}"))
    inter = interact_features(model, bottom, embs, cfg.arch_interaction_op,
                              cfg)
    out = create_mlp(model, inter, [inter.shape[1]] + cfg.mlp_top[1:],
                     sigmoid_last=True, prefix="top")
    inputs = {"dense": (batch, cfg.mlp_bot[0]),
              "sparse": (batch, T, cfg.embedding_bag_size)}
    return inputs, out


def dlrm_strategy(model: FFModel, cfg: DLRMConfig, num_devices: int,
                  row_shard: bool = False) -> StrategyMap:
    """The hand-written DLRM strategy of the JAX package (its
    models/dlrm.py:277-315, after the reference's
    src/runtime/dlrm_strategy.cc:242-296): the stacked tables
    table-parallel, with the largest degree that divides both the table
    count and ``num_devices``; the concatenated table's table degree 2
    over more than one device, which splits its rows in equal blocks over
    the whole mesh (``EmbeddingBagConcat``); each ``Embedding`` split by
    width, over the largest common divisor of its width and
    ``num_devices``; and every other op data-parallel over all of them.
    ``row_shard=True`` splits the ROWS of every table over the whole mesh
    instead (``param_degree`` = ``num_devices``, the all-to-all exchange
    of ``parallel.alltoall``), as the JAX map does."""
    strat: StrategyMap = {}
    batch = model.config.batch_size
    for op in model.ops:
        tname = type(op).__name__
        nd = op.outputs[0].num_dims if op.outputs else 0
        if row_shard and batch % max(num_devices, 1) == 0 and tname in (
                "EmbeddingBagStacked", "EmbeddingBagConcat", "Embedding"):
            strat[op.name] = ParallelConfig(
                (num_devices,) + (1,) * (nd - 1), param_degree=num_devices)
        elif tname == "EmbeddingBagStacked":
            # (batch, T, d): the table dim over the largest common
            # divisor of the table count and the device count
            dt = next(d for d in range(min(num_devices, op.num_tables), 0, -1)
                      if op.num_tables % d == 0 and num_devices % d == 0)
            strat[op.name] = ParallelConfig((1, dt, 1))
        elif tname == "EmbeddingBagConcat":
            # any table degree above 1 splits the concatenated rows over
            # the whole mesh
            strat[op.name] = ParallelConfig(
                (1, 2 if num_devices > 1 else 1, 1))
        elif tname == "Embedding":
            # the width over the largest common divisor of the width and
            # the device count
            dc = next(d for d in range(min(num_devices, op.out_dim), 0, -1)
                      if op.out_dim % d == 0 and num_devices % d == 0)
            strat[op.name] = ParallelConfig((1, dc))
        elif nd > 0:
            strat[op.name] = ParallelConfig.data_parallel(nd, num_devices)
    return strat


def synthetic_batch(cfg: DLRMConfig, batch: int, seed: int = 0,
                    zipf_alpha: Optional[float] = None):
    """Random features and labels from a seed: the same numpy draws as
    the JAX package's ``synthetic_batch``, so both packages see the same
    data."""
    from ..data.dataloader import zipf_indices
    rng = np.random.RandomState(seed)
    alpha = cfg.zipf_alpha if zipf_alpha is None else float(zipf_alpha)
    dense = rng.rand(batch, cfg.mlp_bot[0]).astype(np.float32)
    sparse = np.stack(
        [zipf_indices(rng, rows, (batch, cfg.embedding_bag_size), alpha)
         for rows in cfg.embedding_size], axis=1).astype(np.int32)
    labels = rng.randint(0, 2, size=(batch, 1)).astype(np.float32)
    return {"dense": dense, "sparse": sparse}, labels
