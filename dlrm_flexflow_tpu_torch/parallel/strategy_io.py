"""Strategy files: load, save and validate, the counterpart of
``dlrm_flexflow_tpu.parallel.strategy_io`` (the reference's
src/runtime/strategy.proto:5-23, proto2 ``Strategy{ops[]: name,
device_type, dims[], device_ids[], memory_types[]}``; load and save in
src/runtime/strategy.cc:96-172).

Two formats, chosen by extension:

- ``.pb``: the reference's binary proto2 wire format, through the
  hand-written codec below (``message Op {required string name = 1;
  required DeviceType device_type = 2; repeated int32 dims = 3; repeated
  int32 device_ids = 4; repeated MemoryType memory_types = 5;}`` in
  ``message Strategy {repeated Op ops = 1;}``, with the JAX package's
  extension fields 6-11, written only when set). It reads the bundled
  ``strategies/*.pb`` into the same configs as the JAX package, and for
  the same map writes the same bytes. DeviceType GPU (0) reads as
  "TPU", the JAX package's name for an accelerator; CPU (1) stays "CPU".
- ``.json`` (any other extension): the same field names, sample dim
  first, byte-identical to the JAX package's file for the same map.

The reference stores dims in Legion order, sample dim LAST
(Op::get_data_parallel_config, model.cc:282-293); ``ParallelConfig`` is
sample-first, so the ``.pb`` codec reverses the dims on load and save.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .pconfig import ParallelConfig, StrategyMap

# --- proto2 wire-format primitives ---------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = v = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint")
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


# proto enum for the quantized-storage policy (field 9/10 below):
# 0 = unset (inherit the model default) — never written, so legacy
# files stay byte-identical
_QUANT_DTYPE_ENUM = {"": 0, "fp32": 1, "bf16": 2, "int8": 3, "fp8": 4}
_QUANT_DTYPE_NAME = {v: k for k, v in _QUANT_DTYPE_ENUM.items()}
_QUANT_UPDATE_ENUM = {"": 0, "master_weight": 1, "stochastic_rounding": 2}
_QUANT_UPDATE_NAME = {v: k for k, v in _QUANT_UPDATE_ENUM.items()}


def _encode_op(name: str, device_type: int, dims: List[int],
               device_ids: List[int],
               memory_types: List[int], param_dim: int = 1,
               hot_ppm: int = 0, exchange: int = 0,
               quant_dtype: int = 0, quant_update: int = 0,
               overlap: int = 0) -> bytes:
    msg = bytearray()
    nb = name.encode()
    msg += b"\x0a" + _varint(len(nb)) + nb          # 1: name (len-delim)
    msg += b"\x10" + _varint(device_type)           # 2: device_type varint
    for d in dims:                                  # 3: dims, unpacked
        msg += b"\x18" + _varint(d)
    for d in device_ids:                            # 4: device_ids
        msg += b"\x20" + _varint(d)
    for m in memory_types:                          # 5: memory_types
        msg += b"\x28" + _varint(m)
    if param_dim > 1:                               # 6: PARAM-axis degree
        # extension field: the reference's proto2 parser skips unknown
        # fields, so files stay readable by it; files without row
        # sharding stay byte-identical to the legacy encoding
        msg += b"\x30" + _varint(param_dim)
    if hot_ppm > 0:                                 # 7: hot rows, ppm
        # hybrid hot/cold placement fraction in parts-per-million (a
        # varint round-trips exactly; floats would need a fixed64)
        msg += b"\x38" + _varint(hot_ppm)
    if exchange > 0:                                # 8: exchange mode
        msg += b"\x40" + _varint(exchange)          # 1 = dedup
    if quant_dtype > 0:                             # 9: quantized storage
        # extension fields like 6-8: unknown to the reference's proto2
        # parser (skipped), omitted when unset so legacy files stay
        # byte-identical
        msg += b"\x48" + _varint(quant_dtype)
    if quant_update > 0:                            # 10: quant update rule
        msg += b"\x50" + _varint(quant_update)
    if overlap > 0:                                 # 11: pipelined exchange
        # extension field like 6-10: omitted when off, so legacy files
        # (and files without overlap) stay byte-identical
        msg += b"\x58" + _varint(overlap)
    return bytes(msg)


def _decode_message(buf: bytes):
    """Yield (field_number, wire_type, value) triples; packed repeated
    varints are handled by the caller."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            if i + ln > len(buf):
                raise ValueError("truncated length-delimited field")
            v = buf[i:i + ln]
            i += ln
        elif wt in (5, 1):
            ln = 4 if wt == 5 else 8
            if i + ln > len(buf):
                raise ValueError("truncated fixed-width field")
            v = buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _unpack_varints(payload: bytes) -> List[int]:
    out, i = [], 0
    while i < len(payload):
        v, i = _read_varint(payload, i)
        out.append(v)
    return out


def save_strategies_pb(path: str, strategies: StrategyMap) -> None:
    """Write the reference's binary format (reference
    save_strategies_to_file, src/runtime/strategy.cc:137-172)."""
    body = bytearray()
    for name, pc in sorted(strategies.items()):
        dt = 1 if pc.device_type == "CPU" else 0
        mts = [1 if m == "ZCM" else 0 for m in pc.memory_types]
        op = _encode_op(
            name, dt, list(reversed(pc.degrees)),
            list(pc.device_ids), mts,
            param_dim=getattr(pc, "param_degree", 1),
            hot_ppm=int(round(getattr(pc, "hot_fraction", 0.0) * 1e6)),
            exchange=1 if getattr(pc, "exchange",
                                  "dense") == "dedup" else 0,
            quant_dtype=_QUANT_DTYPE_ENUM[
                getattr(pc, "quant_dtype", "") or ""],
            quant_update=_QUANT_UPDATE_ENUM[
                getattr(pc, "quant_update", "") or ""],
            overlap=1 if getattr(pc, "overlap", False) else 0)
        body += b"\x0a" + _varint(len(op)) + op     # Strategy.ops = 1
    with open(path, "wb") as f:
        f.write(bytes(body))


def load_strategies_pb(path: str) -> StrategyMap:
    """Read the reference's binary format (reference
    load_strategies_from_file, src/runtime/strategy.cc:96-135)."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        return _decode_strategies(buf)
    except ValueError as e:
        raise ValueError(f"corrupt strategy file {path!r}: {e}") from None


def _decode_strategies(buf: bytes) -> StrategyMap:
    out: StrategyMap = {}
    for field, wt, v in _decode_message(buf):
        if field != 1 or wt != 2:
            continue
        name, dt, dims, dev_ids, mts, pd = "", 0, [], [], [], 1
        hot_ppm, exch, qdt, qup, ovl = 0, 0, 0, 0, 0
        for f2, wt2, v2 in _decode_message(v):
            if f2 == 1:
                name = v2.decode()
            elif f2 == 2:
                dt = v2
            elif f2 == 3:
                dims += _unpack_varints(v2) if wt2 == 2 else [v2]
            elif f2 == 4:
                dev_ids += _unpack_varints(v2) if wt2 == 2 else [v2]
            elif f2 == 5:
                mts += _unpack_varints(v2) if wt2 == 2 else [v2]
            elif f2 == 6:
                pd = v2                    # PARAM-axis (row-shard) degree
            elif f2 == 7:
                hot_ppm = v2               # hybrid hot fraction, ppm
            elif f2 == 8:
                exch = v2                  # exchange mode (1 = dedup)
            elif f2 == 9:
                qdt = v2                   # quantized storage dtype
            elif f2 == 10:
                qup = v2                   # quant update rule
            elif f2 == 11:
                ovl = v2                   # pipelined exchange (1 = on)
        if pd < 1:
            raise ValueError(
                f"op {name!r}: parameter-axis degree {pd} < 1")
        if not 0 <= hot_ppm < 1_000_000:
            raise ValueError(
                f"op {name!r}: hot fraction {hot_ppm} ppm out of "
                f"[0, 1e6)")
        if exch not in (0, 1):
            raise ValueError(
                f"op {name!r}: unknown exchange mode {exch}")
        if qdt not in _QUANT_DTYPE_NAME:
            raise ValueError(
                f"op {name!r}: unknown quant dtype enum {qdt}")
        if qup not in _QUANT_UPDATE_NAME:
            raise ValueError(
                f"op {name!r}: unknown quant update-rule enum {qup}")
        if ovl not in (0, 1):
            raise ValueError(
                f"op {name!r}: unknown overlap flag {ovl}")
        out[name] = ParallelConfig(
            tuple(reversed(dims)), device_type="CPU" if dt == 1 else "TPU",
            device_ids=tuple(dev_ids),
            memory_types=tuple("ZCM" if m == 1 else "FBM" for m in mts),
            param_degree=pd, hot_fraction=hot_ppm / 1e6,
            exchange="dedup" if exch == 1 else "dense",
            quant_dtype=_QUANT_DTYPE_NAME[qdt],
            quant_update=_QUANT_UPDATE_NAME[qup],
            overlap=bool(ovl))
    return out


# --- validation ------------------------------------------------------------

# the reference's shared generic keys (dlrm_strategy.py /
# dlrm_strategy_hetero.cc): "embedding{i}" per table plus one entry per
# op TYPE — legal in a strategy file even when no op carries the name
# verbatim (FFModel._resolve_generic_strategy_keys maps them)
_GENERIC_KEY_RE = re.compile(r"^(embedding\d+|embedding|linear|concat|"
                             r"mse_loss)$")

_VALID_DEVICE_TYPES = ("TPU", "CPU")
_VALID_MEMORY_TYPES = ("FBM", "ZCM")


class StrategyValidationError(ValueError):
    """A strategy file failed load-time validation. The message always
    names the file, the op, and the reason — the alternative is a
    downstream placement error naming neither."""

    def __init__(self, path: str, op: str, reason: str):
        super().__init__(f"strategy file {path!r}, op {op!r}: {reason}")
        self.path = path
        self.op = op
        self.reason = reason


def validate_strategies(strategies: StrategyMap,
                        num_devices: Optional[int] = None,
                        axis_sizes: Optional[Sequence[int]] = None,
                        known_ops: Optional[Set[str]] = None,
                        path: str = "<memory>",
                        row_shard_ops: Optional[Set[str]] = None
                        ) -> StrategyMap:
    """Structural + mesh validation of a loaded strategy map.

    Always checked: op names are non-empty, degrees are a non-empty
    tuple of positive ints (ParallelConfig enforces positivity at
    construction), device/memory types are from the schema's
    vocabulary, and the skew-aware placement fields are coherent
    (hot_fraction / exchange="dedup" refine the ROW-SHARDED exchange,
    so both require param_degree > 1). With
    ``num_devices``/``axis_sizes``: each op's degrees must be jointly
    expressible over the factorized target mesh
    (``parallel.sharding.assign_indices`` — the exact feasibility rule
    compile() uses). With ``known_ops``: every op must name a model op
    (or a reference-style generic key like ``embedding3``/``linear``).
    With ``row_shard_ops`` (names of the model's row-shardable
    embedding ops): hot_fraction/exchange on any OTHER op is rejected —
    a hot/cold placement on a Linear is a corrupt or mis-keyed file,
    not a strategy.

    Returns the map unchanged so call sites can chain it; raises
    :class:`StrategyValidationError` (a ``ValueError``) with
    file + op + reason otherwise.
    """
    if axis_sizes is None and num_devices is not None:
        from .mesh import structural_axis_sizes
        axis_sizes = structural_axis_sizes(int(num_devices))
    for name, pc in strategies.items():
        frac = getattr(pc, "hot_fraction", 0.0)
        exch = getattr(pc, "exchange", "dense")
        pd0 = getattr(pc, "param_degree", 1)
        if frac > 0 and pd0 <= 1:
            raise StrategyValidationError(
                path, str(name),
                f"hot_fraction={frac:g} without row sharding "
                f"(param_degree must be > 1 — the hybrid placement "
                f"splits a row-sharded table into a replicated hot "
                f"head and a sharded cold tail)")
        if exch != "dense" and pd0 <= 1:
            raise StrategyValidationError(
                path, str(name),
                f"exchange={exch!r} without row sharding "
                f"(param_degree must be > 1 — there is no exchange "
                f"to dedup on a replicated table)")
        ovl = getattr(pc, "overlap", False)
        if ovl and pd0 <= 1:
            raise StrategyValidationError(
                path, str(name),
                "overlap=True without row sharding (param_degree must "
                "be > 1 — overlap pipelines the row-shard exchange, "
                "and a replicated table has no exchange to overlap)")
        if (frac > 0 or exch != "dense" or ovl) \
                and row_shard_ops is not None \
                and name not in row_shard_ops \
                and not _GENERIC_KEY_RE.match(str(name)):
            raise StrategyValidationError(
                path, str(name),
                f"hot_fraction/exchange/overlap set on an op with no "
                f"row-shard support (not one of the model's embedding "
                f"ops: {sorted(row_shard_ops)[:8]}...)")
        if getattr(pc, "quant_dtype", "") and row_shard_ops is not None \
                and name not in row_shard_ops \
                and not _GENERIC_KEY_RE.match(str(name)):
            # quantized row storage is a TABLE policy; on a Linear it is
            # a corrupt or mis-keyed file, not a strategy
            raise StrategyValidationError(
                path, str(name),
                f"quant_dtype={pc.quant_dtype!r} set on an op with no "
                f"embedding-table storage (not one of the model's "
                f"embedding ops: {sorted(row_shard_ops)[:8]}...)")
        if not name or not isinstance(name, str):
            raise StrategyValidationError(
                path, repr(name), "empty/non-string op name")
        if not pc.degrees:
            raise StrategyValidationError(
                path, name, "no partition degrees (empty dims)")
        if len(pc.degrees) > 6:
            raise StrategyValidationError(
                path, name,
                f"{len(pc.degrees)} partition dims — more than any "
                f"supported tensor rank (corrupt dims field?)")
        if pc.device_type not in _VALID_DEVICE_TYPES:
            raise StrategyValidationError(
                path, name,
                f"device_type {pc.device_type!r} not in "
                f"{_VALID_DEVICE_TYPES}")
        for m in pc.memory_types:
            if m not in _VALID_MEMORY_TYPES:
                raise StrategyValidationError(
                    path, name,
                    f"memory_type {m!r} not in {_VALID_MEMORY_TYPES}")
        if axis_sizes is not None:
            from .sharding import assignable
            ndev = 1
            for a in axis_sizes:
                ndev *= a
            if pc.num_parts > ndev:
                raise StrategyValidationError(
                    path, name,
                    f"degrees {pc.degrees} need {pc.num_parts} parts "
                    f"but the target mesh has {ndev} device(s)")
            if not assignable(pc.degrees, axis_sizes):
                raise StrategyValidationError(
                    path, name,
                    f"degrees {pc.degrees} do not factorize the target "
                    f"mesh axes {list(axis_sizes)} (no contiguous axis "
                    f"assignment multiplies to each degree)")
            pd = getattr(pc, "param_degree", 1)
            if pd > 1:
                if pd > ndev:
                    raise StrategyValidationError(
                        path, name,
                        f"parameter-axis degree {pd} (row shards) "
                        f"exceeds the target mesh's {ndev} device(s)")
                if not assignable((pd,), axis_sizes):
                    raise StrategyValidationError(
                        path, name,
                        f"parameter-axis degree {pd} does not factorize "
                        f"the target mesh axes {list(axis_sizes)} — row "
                        f"shards need a contiguous axis run multiplying "
                        f"to the degree")
        if known_ops is not None and name not in known_ops \
                and not _GENERIC_KEY_RE.match(name):
            preview = sorted(known_ops)[:8]
            raise StrategyValidationError(
                path, name,
                f"references no op of this model (known ops include "
                f"{preview}...) and is not a generic key "
                f"(embedding<i>/linear/concat/mse_loss)")
    return strategies


# --- public API ------------------------------------------------------------


def save_strategies(path: str, strategies: StrategyMap) -> None:
    if path.endswith(".pb"):
        save_strategies_pb(path, strategies)
        return
    ops = []
    for name, pc in sorted(strategies.items()):
        entry = {"name": name,
                 "device_type": pc.device_type,
                 "dims": list(pc.degrees),
                 "device_ids": list(pc.device_ids),
                 "memory_types": list(pc.memory_types)}
        if getattr(pc, "param_degree", 1) > 1:
            # row/PARAM-axis shard degree (omitted when 1 so legacy
            # files stay diff-identical)
            entry["param_dim"] = int(pc.param_degree)
        if getattr(pc, "hot_fraction", 0.0) > 0.0:
            entry["hot_frac"] = float(pc.hot_fraction)
        if getattr(pc, "exchange", "dense") != "dense":
            entry["exchange"] = pc.exchange
        if getattr(pc, "quant_dtype", ""):
            # quantized-storage policy (omitted when unset so legacy
            # files stay diff-identical)
            entry["quant_dtype"] = pc.quant_dtype
        if getattr(pc, "quant_update", ""):
            entry["quant_update"] = pc.quant_update
        if getattr(pc, "overlap", False):
            # pipelined row-shard exchange (omitted when off so legacy
            # files stay diff-identical)
            entry["overlap"] = True
        ops.append(entry)
    doc = {"ops": ops}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def load_strategies(path: str, num_devices: Optional[int] = None,
                    known_ops: Optional[Set[str]] = None,
                    row_shard_ops: Optional[Set[str]] = None
                    ) -> StrategyMap:
    """Load + validate a strategy file. Structural validation always
    runs; pass ``num_devices`` to also require every op's degrees to
    factorize the target mesh, and ``known_ops`` to require every entry
    to reference a real (or generic-keyed) op — malformed files fail
    HERE with file + op + reason instead of as a downstream placement
    error."""
    if path.endswith(".pb"):
        out = load_strategies_pb(path)
    else:
        with open(path) as f:
            doc = json.load(f)
        out = {}
        for entry in doc["ops"]:
            try:
                out[entry["name"]] = ParallelConfig(
                    tuple(entry["dims"]),
                    device_type=entry.get("device_type", "TPU"),
                    device_ids=tuple(entry.get("device_ids", ())),
                    memory_types=tuple(entry.get("memory_types", ())),
                    param_degree=int(entry.get("param_dim", 1)),
                    hot_fraction=float(entry.get("hot_frac", 0.0)),
                    exchange=str(entry.get("exchange", "dense")),
                    quant_dtype=str(entry.get("quant_dtype", "")),
                    quant_update=str(entry.get("quant_update", "")),
                    overlap=bool(entry.get("overlap", False)))
            except (KeyError, TypeError, ValueError) as e:
                raise StrategyValidationError(
                    path, str(entry.get("name", "?")),
                    f"malformed entry: {e}") from None
    return validate_strategies(out, num_devices=num_devices,
                               known_ops=known_ops, path=path,
                               row_shard_ops=row_shard_ops)
