"""The per-table storage policy and its byte accounting (the port's own
copy of ``dlrm_flexflow_tpu.quant.policy``, which is pure Python).

A :class:`QuantPolicy` says how ONE embedding table's rows are stored:
element dtype, the row-wise scale layout, and the update rule. It rides
per op on ``ParallelConfig.quant_dtype``/``quant_update`` (strategy files
round-trip it), with ``FFConfig.emb_dtype``/``emb_update_rule`` as the
model-wide default: the strategy entry wins, then the config, then fp32.
``compile`` resolves it onto every table op (``ops.embedding.
configure_quant``); the training step, the delta publisher, the serving
cache, the shard tier and the checkpoint manifest read it from there
through :func:`effective_policy`, so they never disagree on a row's size.
The validation messages are the JAX package's, word for word.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

DTYPES = ("fp32", "bf16", "int8", "fp8")
UPDATE_RULES = ("master_weight", "stochastic_rounding")

# one fp32 scale per stored row (symmetric codes: the zero-point is 0,
# so only the scale is stored)
SCALE_BYTES = 4.0

_ITEMSIZE = {"fp32": 4.0, "bf16": 2.0, "int8": 1.0, "fp8": 1.0}


@dataclass(frozen=True)
class QuantPolicy:
    """How one table's rows are stored. ``dtype`` is the element storage
    type; int8/fp8 carry one fp32 scale per row; ``update_rule`` picks
    master-weight (exact fp32 master, quantized only at storage
    boundaries) or stochastic rounding (no master: the table is
    re-quantized after every update)."""

    dtype: str = "fp32"
    update_rule: str = "master_weight"
    scale_block: str = "row"     # row-wise scales are the only layout

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(
                f"invalid quant dtype {self.dtype!r} (expected one of "
                f"{DTYPES})")
        if self.update_rule not in UPDATE_RULES:
            raise ValueError(
                f"invalid quant update rule {self.update_rule!r} "
                f"(expected one of {UPDATE_RULES})")
        if self.scale_block != "row":
            raise ValueError(
                f"invalid scale layout {self.scale_block!r} (row-wise "
                f"scales are the only supported layout)")

    @property
    def is_quantized(self) -> bool:
        """True for the scaled codes (int8/fp8), which carry a row
        scale."""
        return self.dtype in ("int8", "fp8")

    @property
    def is_default(self) -> bool:
        return self.dtype == "fp32" and self.update_rule == "master_weight"

    @property
    def itemsize(self) -> float:
        return _ITEMSIZE[self.dtype]

    def row_bytes(self, dim: int) -> float:
        """Stored bytes of one ``dim``-wide row, scale included."""
        b = dim * self.itemsize
        if self.is_quantized:
            b += SCALE_BYTES
        return b

    def table_bytes(self, rows: int, dim: int) -> float:
        return rows * self.row_bytes(dim)


FP32 = QuantPolicy()


def policy_from_pc(pc) -> Optional[QuantPolicy]:
    """The policy a strategy entry asks for, or None when it is silent
    (an empty ``quant_dtype`` inherits the model default)."""
    if pc is None:
        return None
    dt = getattr(pc, "quant_dtype", "")
    if not dt:
        return None
    return QuantPolicy(dt, getattr(pc, "quant_update", "master_weight")
                       or "master_weight")


def policy_from_config(config) -> Optional[QuantPolicy]:
    """The model-wide default from FFConfig (``--emb-dtype`` /
    ``--emb-update-rule``), or None when it is the fp32 default."""
    dt = getattr(config, "emb_dtype", "fp32") or "fp32"
    ur = getattr(config, "emb_update_rule",
                 "master_weight") or "master_weight"
    pol = QuantPolicy(dt, ur)
    return None if pol.is_default else pol


def effective_policy(op, pc=None) -> QuantPolicy:
    """The one resolution every storage and accounting site uses: an
    explicit strategy entry ``pc`` wins, else the policy ``compile``
    resolved onto the op (``op._quant_policy``), else the model config's
    default, else fp32."""
    pol = policy_from_pc(pc)
    if pol is not None:
        return pol
    pol = getattr(op, "_quant_policy", None)
    if pol is not None:
        return pol
    model = getattr(op, "model", None)
    if model is not None:
        pol = policy_from_config(getattr(model, "config", None))
        if pol is not None:
            return pol
    return FP32


def param_storage_bytes(op, pc, shapes) -> float:
    """Stored bytes of ``op``'s parameter ``shapes`` ({name: shape})
    under its effective policy: a table op's ``kernel``/``hot_kernel``
    at the policy's row bytes, every other parameter at its ParamDef's
    itemsize. Under ``master_weight`` the fp32 master is not counted:
    the stored rows are the quantized ones."""
    pol = effective_policy(op, pc) if hasattr(op, "host_lookup") else None
    total = 0.0
    for pname, shape in shapes.items():
        if pol is not None and not pol.is_default \
                and pname in ("kernel", "hot_kernel"):
            total += table_storage_bytes(shape, pol)
            continue
        d = op.param_defs().get(pname)
        total += math.prod(shape) * (float(d.dtype.itemsize)
                                     if d is not None else 4.0)
    return total


def table_storage_bytes(shape, policy: Optional[QuantPolicy]) -> float:
    """Stored bytes of a table-shaped parameter under ``policy``: the
    last axis is the row width, every axis before it multiplies into the
    row count (a stacked (T, rows, d) table counts T*rows scales)."""
    if policy is None:
        policy = FP32
    if not shape:
        return policy.itemsize
    dim = int(shape[-1])
    rows = int(math.prod(shape[:-1])) if len(shape) > 1 else 1
    return policy.table_bytes(rows, dim)
