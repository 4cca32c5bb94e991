"""Two-tower candidate-generation model (the counterpart of
``dlrm_flexflow_tpu.retrieve.model``).

A USER tower (dense + sparse user features through per-feature
``Embedding`` s and an MLP) and an ITEM tower (one ``Embedding`` table +
a small MLP) meet in a shared d-dim space where relevance is an inner
product, so serving is a maximum-inner-product search over the item
catalog (``retrieve.index``).

One graph, shared op NAMES across heads (``head=``), so weights move
between heads by name (``transfer_tower_params``) and from the JAX
package by name (``utils.weights.params_from_jax``):

  train : both towers      -> (B, B) in-batch logits (row b scores user
          b against every item of the batch; the diagonal is the
          positive), trained with ``sparse_categorical_crossentropy``
          against ``in_batch_labels`` (the in-batch sampled softmax)
  user  : user inputs only -> (B, d) user embeddings (query encoder)
  item  : item ids only    -> (B, d) item embeddings (index builder)

``synthetic_two_tower_batch`` draws the JAX package's batches (the same
numpy ``RandomState`` draws, so bitwise the same arrays) and
``two_tower_strategy`` its strategy. Not ported yet: the self-attention
over the user features (``attention_heads > 0``, ROADMAP queue 1 item
11).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.initializers import UniformInitializer
from ..core.model import FFModel


@dataclass
class TwoTowerConfig:
    """Shapes for both towers. ``dim`` is the shared output width, the
    MIPS scoring width (the top-k kernel takes any dim % 4 == 0)."""

    n_items: int = 1000              # item vocabulary (index row count)
    dim: int = 32                    # shared tower-output width
    user_dense_dim: int = 8          # dense user feature width
    user_embedding_size: List[int] = field(
        default_factory=lambda: [100, 100])   # user sparse vocab sizes
    user_sparse_dim: int = 16        # per-feature user embedding width
    user_bag_size: int = 1
    user_mlp: List[int] = field(default_factory=lambda: [64])
    item_raw_dim: int = 32           # item embedding width before MLP
    item_mlp: List[int] = field(default_factory=lambda: [64])
    attention_heads: int = 0         # >0: self-attention (not ported)

    @staticmethod
    def bench() -> "TwoTowerConfig":
        """The JAX package's bench/recall config. Its attention_heads=4
        makes ``build_two_tower`` raise until the attention is ported."""
        return TwoTowerConfig(
            n_items=20000, dim=128, user_dense_dim=16,
            user_embedding_size=[5000, 2000, 500], user_sparse_dim=32,
            user_mlp=[256, 128], item_raw_dim=64, item_mlp=[128],
            attention_heads=4)


def _user_tower(model: FFModel, cfg: TwoTowerConfig, batch: int):
    """Dense + per-feature embeddings -> MLP -> (B, dim)."""
    from ..models.dlrm import create_mlp
    dense_in = model.create_tensor((batch, cfg.user_dense_dim),
                                   name="user_dense")
    T = len(cfg.user_embedding_size)
    sparse_in = model.create_tensor((batch, T, cfg.user_bag_size),
                                    dtype=torch.int64, name="user_sparse")
    init = UniformInitializer(min_val=-0.05, max_val=0.05)
    cols = model.split(sparse_in, [1] * T, axis=1, name="user_split")
    embs = []
    for i, (rows, col) in enumerate(zip(cfg.user_embedding_size, cols)):
        idx2d = model.reshape(col, (batch, cfg.user_bag_size),
                              name=f"user_idx_{i}")
        embs.append(model.embedding(
            idx2d, rows, cfg.user_sparse_dim, aggr="sum",
            kernel_initializer=init, name=f"user_emb_{i}"))
    feats = model.concat(embs, axis=1, name="user_cat") if T > 1 \
        else embs[0]
    joined = model.concat([dense_in, feats], axis=1, name="user_join")
    width = cfg.user_dense_dim + T * cfg.user_sparse_dim
    hid = create_mlp(model, joined, [width] + cfg.user_mlp, prefix="user")
    # the projection into the shared space is linear: a relu head would
    # clamp the outputs non-negative
    return model.dense(hid, cfg.dim, activation=None,
                       name=f"user_dense_{len(cfg.user_mlp)}")


def _item_tower(model: FFModel, cfg: TwoTowerConfig, batch: int):
    """Item-id embedding -> MLP -> (B, dim)."""
    from ..models.dlrm import create_mlp
    ids_in = model.create_tensor((batch, 1), dtype=torch.int64,
                                 name="item_ids")
    init = UniformInitializer(min_val=-0.05, max_val=0.05)
    raw = model.embedding(ids_in, cfg.n_items, cfg.item_raw_dim,
                          aggr="sum", kernel_initializer=init,
                          name="item_emb")
    hid = create_mlp(model, raw, [cfg.item_raw_dim] + cfg.item_mlp,
                     prefix="item")
    return model.dense(hid, cfg.dim, activation=None,
                       name=f"item_dense_{len(cfg.item_mlp)}")


def build_two_tower(model: FFModel, cfg: TwoTowerConfig,
                    head: str = "train") -> Tuple[Dict[str, tuple], object]:
    """Build one head of the two-tower graph on ``model``. Returns
    (input_specs, output_tensor) like ``build_dlrm``."""
    if head not in ("train", "user", "item"):
        raise ValueError(f"build_two_tower: unknown head {head!r} "
                         f"(train|user|item)")
    T = len(cfg.user_embedding_size)
    if cfg.attention_heads > 0 and T > 1:
        raise NotImplementedError(
            "the user tower's self-attention (attention_heads > 0) is not "
            "ported yet (ROADMAP queue 1 item 11)")
    batch = model.config.batch_size
    user_inputs = {"user_dense": (batch, cfg.user_dense_dim),
                   "user_sparse": (batch, T, cfg.user_bag_size)}
    if head == "user":
        return dict(user_inputs), _user_tower(model, cfg, batch)
    if head == "item":
        return {"item_ids": (batch, 1)}, _item_tower(model, cfg, batch)
    u = _user_tower(model, cfg, batch)
    v = _item_tower(model, cfg, batch)
    # (B, d) x (B, d) -> (B, B) in-batch logits: row b scores user b
    # against every in-batch item (the diagonal is the positive)
    u3 = model.reshape(u, (1, batch, cfg.dim), name="logits_u3")
    v3 = model.reshape(v, (1, batch, cfg.dim), name="logits_v3")
    z = model.batch_matmul(u3, v3, trans_a=False, trans_b=True,
                           name="logits_bmm")
    logits = model.reshape(z, (batch, batch), name="logits")
    inputs = dict(user_inputs)
    inputs["item_ids"] = (batch, 1)
    return inputs, logits


def in_batch_labels(batch: int) -> np.ndarray:
    """Labels of the in-batch sampled softmax: row b's positive is
    column b."""
    return np.arange(batch, dtype=np.int32).reshape(batch, 1)


def synthetic_two_tower_batch(cfg: TwoTowerConfig, batch: int,
                              seed: int = 0, zipf_alpha: float = 0.0):
    """Synthetic (inputs, labels) for one train-head batch, the JAX
    package's draws from ``RandomState(seed)``: item ids zipf-skewed,
    and user features that carry a signal of the positive item, so
    training moves recall."""
    from ..data.dataloader import zipf_indices
    rng = np.random.RandomState(seed)
    T = len(cfg.user_embedding_size)
    items = zipf_indices(rng, cfg.n_items, (batch, 1),
                         zipf_alpha).astype(np.int32)
    dense = rng.rand(batch, cfg.user_dense_dim).astype(np.float32)
    # the planted signal: dense feature 0 tracks the positive's id
    dense[:, 0] = items[:, 0].astype(np.float32) / float(cfg.n_items)
    sparse = np.stack(
        [(items[:, 0] * (t + 3)) % rows
         for t, rows in enumerate(cfg.user_embedding_size)],
        axis=1).astype(np.int32)[:, :, None]
    sparse = np.broadcast_to(
        sparse, (batch, T, cfg.user_bag_size)).copy()
    inputs = {"user_dense": dense, "user_sparse": sparse,
              "item_ids": items}
    return inputs, in_batch_labels(batch)


def two_tower_strategy(model: FFModel, num_devices: int,
                       row_shard: bool = False):
    """The strategy of any two-tower head: ``dlrm_strategy``'s table and
    data-parallel rules never read the DLRM config, so the same
    generator covers this graph (over the ranks it takes)."""
    from ..models.dlrm import dlrm_strategy
    return dlrm_strategy(model, None, num_devices, row_shard=row_shard)


def transfer_tower_params(src: FFModel, dst: FFModel) -> int:
    """Copy weights from one head to another by op name (the towers
    share names across heads), installed through ``swap_params``.
    Returns the number of ops transferred."""
    moved = 0
    new_params = {op: dict(d) for op, d in dst.params.items()}
    for op_name, pdict in new_params.items():
        if op_name in (src.params or {}):
            for pname in pdict:
                if pname in src.params[op_name]:
                    pdict[pname] = src.params[op_name][pname].to(dst.device)
            moved += 1
    dst.swap_params(new_params)
    return moved


def item_embeddings(item_model: FFModel, cfg: TwoTowerConfig,
                    ids=None) -> torch.Tensor:
    """Run the item head over ``ids`` (default: the whole catalog) in
    compiled-batch chunks -> (n, dim) fp32 on the model's device (the
    JAX package returns a host array; here the index is built on the
    card from it without a host round trip)."""
    batch = item_model.config.batch_size
    dev = item_model.device
    if ids is None:
        ids = torch.arange(cfg.n_items, dtype=torch.int64, device=dev)
    ids = torch.as_tensor(ids, dtype=torch.int64).to(dev).reshape(-1)
    out = torch.empty((ids.shape[0], cfg.dim), dtype=torch.float32,
                      device=dev)
    for lo in range(0, ids.shape[0], batch):
        chunk = ids[lo:lo + batch]
        n = chunk.shape[0]
        if n < batch:
            chunk = torch.cat([chunk, torch.zeros(batch - n,
                                                  dtype=torch.int64,
                                                  device=dev)])
        res = item_model.forward_batch({"item_ids": chunk.reshape(-1, 1)})
        out[lo:lo + n] = res[:n]
    return out

