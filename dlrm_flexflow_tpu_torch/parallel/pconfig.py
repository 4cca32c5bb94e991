"""Per-operator parallelization configs, the counterpart of
``dlrm_flexflow_tpu.parallel.pconfig`` (the reference's
``ParallelConfig {device_type, nDims, dim[], device_ids[]}``,
include/config.h:41-50, and its per-op strategy map keyed by op name,
src/runtime/strategy.cc:23-94).

A config records the partition degree of each dimension of the op's
output, sample dimension first, and the fields the strategy files carry:
``device_ids`` (kept for round trips and for the per-table placement of
the stacked embedding), ``memory_types`` (FBM, or ZCM for host-resident
tables), the row-shard ``param_degree`` with its ``exchange``,
``hot_fraction`` and ``overlap`` refinements, and the quantized-storage
fields. ``compile`` resolves every op's config and places it on the
mesh's axes (``parallel.sharding``); which of them the port executes
across ranks is said there. ``device_type == "CPU"`` marks the
reference's host-offloaded ops (dlrm_strategy_hetero.cc:28-36). The
checks are the JAX package's, so a config either package refuses the
other refuses too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

DEVICE_TPU = "TPU"   # reference: DeviceType::GPU (config.h:41); the name
                     # the JAX package's files use, kept for them
DEVICE_CPU = "CPU"   # reference: DeviceType::CPU — host offload


@dataclass(frozen=True)
class ParallelConfig:
    """Partition degrees per output-tensor dim; degrees[0] is the sample dim
    for activations. Product of degrees = number of parallel parts."""

    degrees: Tuple[int, ...]
    device_type: str = DEVICE_TPU
    device_ids: Tuple[int, ...] = field(default=())
    # per-part memory placement (reference strategy.proto:11-14: FBM =
    # framebuffer/HBM, ZCM = zero-copy host memory); round-tripped through
    # strategy files and consulted by the hetero host-offload path
    memory_types: Tuple[str, ...] = field(default=())
    # PARAMETER-axis partition degree: how many row shards the op's
    # parameter (an embedding table's row space) splits into, independent
    # of the output degrees above. degrees describe the OUTPUT tensor and
    # cannot express "rows of the table sharded, output data-parallel" —
    # the pod-scale DLRM shape (Naumov 2019 / ZionEX 2022: row-sharded
    # tables + all-to-all lookup exchange). 1 = replicated/whole rows
    # (legacy behavior for every op that ignores it).
    param_degree: int = 1
    # skew-aware refinements of the row-sharded exchange (param_degree
    # > 1 only; both default to the legacy behavior so files and
    # strategies without them are unchanged):
    # - exchange "dedup": sort→unique the lookup ids before the
    #   all-to-all and pre-accumulate gradient rows per unique id before
    #   the return exchange, so exchanged bytes scale with DISTINCT ids
    #   rather than batch size (Neo/ZionEX dedup-before-exchange).
    # - hot_fraction f in (0, 1): frequency-aware hybrid placement — the
    #   top f of each table's rows (the low-numbered, hot ids) are
    #   REPLICATED on every device (local lookups, allreduce-style
    #   lockstep updates) while the cold tail stays row-sharded (FAE,
    #   Adnan 2021). 0 = every row routed.
    exchange: str = "dense"
    hot_fraction: float = 0.0
    # per-table quantized STORAGE policy (the JAX package's
    # quant/policy.py; quantized training is not ported yet): element
    # dtype of the stored rows ("" = inherit the model-wide
    # FFConfig.emb_dtype default; "fp32"/"bf16"/"int8"/"fp8" pin it per
    # table) and the update rule ("master_weight" keeps an exact fp32
    # master beside the optimizer state; "stochastic_rounding" re-
    # quantizes after every update). int8/fp8 rows carry one fp32 scale
    # per row; every byte-accounting site resolves sizes through
    # quant.effective_policy so search, shardcheck, and serving agree.
    quant_dtype: str = ""
    quant_update: str = ""
    # pipelined (double-buffered) row-shard exchange (param_degree > 1
    # only; the JAX package's meaning, not ported yet): the lookup/row/
    # gradient all-to-alls decompose into chunked rounds that hide under
    # independent dense compute (the bottom MLP), instead of the fused
    # blocking all-to-all that serializes with the step. Bit-identical
    # to the serial exchange — the same per-peer blocks arrive, the
    # pipeline drains inside every step dispatch (no staleness). False
    # keeps the legacy fused collective.
    overlap: bool = False

    def __post_init__(self):
        object.__setattr__(self, "degrees", tuple(int(d) for d in self.degrees))
        for d in self.degrees:
            if d < 1:
                raise ValueError(f"invalid partition degree {d}")
        object.__setattr__(self, "param_degree", int(self.param_degree))
        if self.param_degree < 1:
            raise ValueError(
                f"invalid parameter-axis degree {self.param_degree}")
        if self.exchange not in ("dense", "dedup"):
            raise ValueError(
                f"invalid exchange mode {self.exchange!r} "
                f"(expected 'dense' or 'dedup')")
        object.__setattr__(self, "hot_fraction", float(self.hot_fraction))
        if not 0.0 <= self.hot_fraction < 1.0:
            raise ValueError(
                f"invalid hot_fraction {self.hot_fraction} "
                f"(expected 0 <= f < 1)")
        # the JAX package's quant.policy vocabulary
        if self.quant_dtype not in ("", "fp32", "bf16", "int8", "fp8"):
            raise ValueError(
                f"invalid quant_dtype {self.quant_dtype!r} (expected "
                f"'', 'fp32', 'bf16', 'int8', or 'fp8')")
        if self.quant_update not in ("", "master_weight",
                                     "stochastic_rounding"):
            raise ValueError(
                f"invalid quant_update {self.quant_update!r} (expected "
                f"'', 'master_weight', or 'stochastic_rounding')")
        if self.quant_update and not self.quant_dtype:
            raise ValueError(
                f"quant_update={self.quant_update!r} without a "
                f"quant_dtype — the update rule refines a storage "
                f"dtype, it cannot stand alone")
        if not isinstance(self.overlap, (bool, int)):
            raise ValueError(
                f"invalid overlap flag {self.overlap!r} (expected a "
                f"bool)")
        object.__setattr__(self, "overlap", bool(self.overlap))

    @property
    def num_parts(self) -> int:
        n = 1
        for d in self.degrees:
            n *= d
        return n

    @staticmethod
    def data_parallel(ndims: int, num_devices: int) -> "ParallelConfig":
        """Reference Op::get_data_parallel_config (model.cc:282-293): all
        devices along the sample dim, every other dim unpartitioned."""
        degrees = [1] * ndims
        degrees[0] = num_devices
        return ParallelConfig(tuple(degrees),
                              device_ids=tuple(range(num_devices)))

    @staticmethod
    def replicated(ndims: int) -> "ParallelConfig":
        return ParallelConfig((1,) * ndims)


# A strategy is a map from op name ("<Type>_<guid>" or user name — the same
# key scheme as the reference, where op->name seeds the MappingTagID hash,
# strategy.cc:23-26) to its ParallelConfig.
StrategyMap = Dict[str, ParallelConfig]
