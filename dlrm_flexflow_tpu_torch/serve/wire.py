"""The serving seams' binary wire protocol, frames and payload codecs
(own copy of ``dlrm_flexflow_tpu.serve.wire``: for the same input every
frame and payload is byte-identical to the JAX package's, so each
package's client talks to the other's server). One frame is

    +--------+-----+--------+------+----------------+--------+---------+
    | magic  | ver | opcode | pad  |   request-id   | length |  CRC-32 |
    | 4 B    | 1 B | 1 B    | 2 B  |      8 B       |  4 B   |   4 B   |
    +--------+-----+--------+------+----------------+--------+---------+
    |                      payload (length bytes)                      |
    +------------------------------------------------------------------+

big-endian, 24-byte header. The CRC-32 covers the payload; a mismatch
(or a bad magic/version/oversized length) raises :class:`FrameError`,
which the transport treats as transient — close the connection, retry
within the budget. The request-id is the idempotency key: a client
retries (and fault injection duplicates) frames under the SAME id, and
the server's dedup window answers repeats from cache without re-running
the handler.

Payloads are deterministic in-memory npz containers (STORED zip of
``.npy`` members plus a ``__meta__.json`` entry) — the same framing the
delta files on disk use, so the quantized lookup payloads of PR 14
(codes + row scales + dtype) and the per-shard delta slices of PR 10
(rows/full/crc) ship over the wire byte-compatibly with how they are
persisted. Version vectors, ``degraded`` flags, and slice CRCs travel
in the JSON meta, in-band. Tensors (the port's quantized blocks and
codes live on a device) are copied to host numpy before they are
encoded; decoded payloads are numpy.

Codecs only — no sockets here. serve/transport.py carries these frames.
"""

from __future__ import annotations

import io
import json
import struct
import zipfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

MAGIC = b"FFWP"
WIRE_VERSION = 1
# one frame's payload ceiling: a full shard install of a large tier is
# the biggest legitimate message; anything past this is a corrupt
# length field, not a real payload
MAX_FRAME_BYTES = 1 << 31

_HDR = struct.Struct(">4sBBxxQII")
HEADER_BYTES = _HDR.size  # 24

# --- opcodes ----------------------------------------------------------
# requests are low; a response echoes the request opcode with RESP_BIT
# set; OP_ERR is the one response opcode that can answer anything
OP_LOOKUP = 0x01      # shard seam: batched row lookup
OP_PUBLISH = 0x02     # shard seam: one delta publish's slice
OP_INSTALL = 0x03     # shard seam: full block replacement
OP_PROBE = 0x04       # shard seam: identity/version/freshness
OP_STATS = 0x05       # any server: stats() snapshot
OP_PREDICT = 0x10     # ranker seam: synchronous predict
OP_HEALTH = 0x11      # ranker seam: healthz snapshot
OP_MANIFEST = 0x20    # watcher seam: publish-directory manifest
OP_FETCH = 0x21       # watcher seam: one published file's bytes
RESP_BIT = 0x80
OP_ERR = 0xFF

OPCODE_NAMES = {
    OP_LOOKUP: "lookup", OP_PUBLISH: "publish", OP_INSTALL: "install",
    OP_PROBE: "probe", OP_STATS: "stats", OP_PREDICT: "predict",
    OP_HEALTH: "health", OP_MANIFEST: "manifest", OP_FETCH: "fetch",
    OP_ERR: "err",
}


def opcode_name(op: int) -> str:
    base = OPCODE_NAMES.get(op & ~RESP_BIT, f"op{op:#04x}")
    return base + ("+resp" if op & RESP_BIT and op != OP_ERR else "")


class FrameError(Exception):
    """A malformed or corrupted frame: bad magic, unknown protocol
    version, an impossible length, or a payload failing its CRC-32.
    Transient from the transport's point of view — the connection is
    poisoned (stream framing is lost), so the client closes it and
    retries on a fresh one within its budget."""


# --- frame codec ------------------------------------------------------
def encode_frame(opcode: int, request_id: int, payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME_BYTES:
        raise FrameError(
            f"payload of {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte frame ceiling")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return _HDR.pack(MAGIC, WIRE_VERSION, opcode & 0xFF,
                     request_id & 0xFFFFFFFFFFFFFFFF,
                     len(payload), crc) + payload


def decode_header(header: bytes) -> Tuple[int, int, int, int]:
    """(opcode, request_id, length, crc) from a 24-byte header; raises
    FrameError on bad magic / version / length."""
    if len(header) != HEADER_BYTES:
        raise FrameError(f"short header: {len(header)} of "
                         f"{HEADER_BYTES} bytes")
    magic, ver, opcode, rid, length, crc = _HDR.unpack(header)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic!r} (expected {MAGIC!r} — "
                         f"not a wire-protocol peer?)")
    if ver != WIRE_VERSION:
        raise FrameError(f"wire version {ver} (this build speaks "
                         f"{WIRE_VERSION})")
    if length > MAX_FRAME_BYTES:
        raise FrameError(f"frame length {length} exceeds the "
                         f"{MAX_FRAME_BYTES}-byte ceiling (corrupt "
                         f"length field)")
    return opcode, rid, length, crc


def decode_frame(buf: bytes) -> Tuple[int, int, bytes]:
    """(opcode, request_id, payload) from one complete frame's bytes,
    CRC-verified."""
    opcode, rid, length, crc = decode_header(buf[:HEADER_BYTES])
    payload = buf[HEADER_BYTES:HEADER_BYTES + length]
    if len(payload) != length:
        raise FrameError(f"truncated frame: payload {len(payload)} of "
                         f"{length} bytes")
    got = zlib.crc32(payload) & 0xFFFFFFFF
    if got != crc:
        raise FrameError(f"frame CRC mismatch: payload sums to "
                         f"{got:#010x}, header declares {crc:#010x} "
                         f"(corrupt in transit)")
    return opcode, rid, payload


def read_frame(sock) -> Tuple[int, int, bytes]:
    """Read exactly one frame off a socket; FrameError on corruption,
    ConnectionError on EOF mid-frame."""
    header = _recv_exact(sock, HEADER_BYTES)
    opcode, rid, length, crc = decode_header(header)
    payload = _recv_exact(sock, length)
    got = zlib.crc32(payload) & 0xFFFFFFFF
    if got != crc:
        raise FrameError(f"frame CRC mismatch: payload sums to "
                         f"{got:#010x}, header declares {crc:#010x} "
                         f"(corrupt in transit)")
    return opcode, rid, payload


def write_frame(sock, opcode: int, request_id: int,
                payload: bytes) -> None:
    sock.sendall(encode_frame(opcode, request_id, payload))


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-frame ({got} of {n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


# --- payload codec ----------------------------------------------------
_META_NAME = "__meta__.json"


def _host(x) -> np.ndarray:
    """An array as host numpy: a torch tensor (on any device) is copied
    to the host; fp8 codes go as their uint8 bit patterns, the portable
    form ``quant.codec.encode_q`` writes."""
    if hasattr(x, "detach"):
        import torch
        x = x.detach().cpu()
        if x.element_size() == 1 and x.is_floating_point():
            x = x.view(torch.uint8)
        return x.numpy()
    return np.asarray(x)


def encode_payload(meta: Dict[str, Any],
                   arrays: Optional[Dict[str, np.ndarray]] = None
                   ) -> bytes:
    """JSON meta + named ndarrays as a deterministic STORED zip of
    ``.npy`` members (the delta files' on-disk framing, in memory).
    Array names may contain '/' — they are zip entry names, not
    keywords."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        info = zipfile.ZipInfo(_META_NAME, date_time=(1980, 1, 1,
                                                      0, 0, 0))
        zf.writestr(info, json.dumps(meta, sort_keys=True))
        for name in sorted(arrays or {}):
            arr = np.ascontiguousarray((arrays or {})[name])
            info = zipfile.ZipInfo(name + ".npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
    return buf.getvalue()


def decode_payload(data: bytes
                   ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(meta, arrays) back from :func:`encode_payload` bytes; a torn or
    foreign container is a FrameError (transient to the transport)."""
    try:
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            meta = json.loads(zf.read(_META_NAME).decode("utf-8"))
            arrays = {}
            for name in zf.namelist():
                if not name.endswith(".npy"):
                    continue
                with zf.open(name) as f:
                    arrays[name[:-4]] = np.lib.format.read_array(
                        f, allow_pickle=False)
    except (zipfile.BadZipFile, KeyError, ValueError, OSError,
            json.JSONDecodeError) as e:
        raise FrameError(f"payload decode failed: {e}") from None
    if not isinstance(meta, dict):
        raise FrameError(f"payload meta is {type(meta).__name__}, "
                         f"expected an object")
    return meta, arrays


# --- seam codecs: shard lookups ---------------------------------------
def encode_lookup_request(requests: Dict[str, np.ndarray]) -> bytes:
    return encode_payload(
        {"kind": "lookup"},
        {"ids/" + op: np.asarray(ids, np.int64)
         for op, ids in requests.items()})


def decode_lookup_request(data: bytes) -> Dict[str, np.ndarray]:
    _meta, arrays = decode_payload(data)
    return {name[len("ids/"):]: arr for name, arr in arrays.items()
            if name.startswith("ids/")}


def encode_lookup_response(out: Dict[str, Any], version: int) -> bytes:
    """A shard's lookup result: dense rows ship as fp32 matrices,
    quantized ops ship their PR 14 wire payload — codes + row scales +
    dtype tag (the ranker boundary dequantizes). The shard version
    rides in-band."""
    meta: Dict[str, Any] = {"kind": "lookup", "version": int(version),
                            "quant": {}}
    arrays: Dict[str, np.ndarray] = {}
    for op, val in out.items():
        if isinstance(val, tuple):
            codes, scales, dtype = val
            arrays["q/" + op] = _host(codes)
            arrays["s/" + op] = _host(scales)
            meta["quant"][op] = str(dtype)
        else:
            arrays["rows/" + op] = np.asarray(val, np.float32)
    return encode_payload(meta, arrays)


def decode_lookup_response(data: bytes
                           ) -> Tuple[Dict[str, Any], int]:
    meta, arrays = decode_payload(data)
    out: Dict[str, Any] = {}
    for name, arr in arrays.items():
        if name.startswith("rows/"):
            out[name[len("rows/"):]] = arr
    for op, dtype in (meta.get("quant") or {}).items():
        out[op] = (arrays["q/" + op], arrays["s/" + op], str(dtype))
    return out, int(meta.get("version", 0))


# --- seam codecs: delta publishes -------------------------------------
def encode_publish(sub: Optional[Dict[str, Any]], version: int,
                   expect_crc: Optional[int]) -> bytes:
    """One shard's slice of a delta publish (the output of
    ``split_host_rows_by_shard``): sparse row updates as index+value
    pairs, full-table slices whole, the split-time slice CRC in-band.
    ``sub`` None is a version bump + chain link only."""
    meta: Dict[str, Any] = {"kind": "publish", "version": int(version),
                            "has_sub": sub is not None,
                            "expect_crc": expect_crc}
    arrays: Dict[str, np.ndarray] = {}
    if sub is not None:
        meta["crc"] = int(sub.get("crc", 0))
        meta["row_keys"] = sorted(sub.get("rows", {}))
        meta["full_keys"] = sorted(sub.get("full", {}))
        for key, (idx, vals) in sub.get("rows", {}).items():
            arrays["ri/" + key] = np.asarray(idx, np.int64)
            arrays["rv/" + key] = np.asarray(vals, np.float32)
        for key, arr in sub.get("full", {}).items():
            arrays["full/" + key] = np.asarray(arr, np.float32)
    return encode_payload(meta, arrays)


def decode_publish(data: bytes
                   ) -> Tuple[Optional[Dict[str, Any]], int,
                              Optional[int]]:
    """(sub, version, expect_crc) back from :func:`encode_publish`."""
    meta, arrays = decode_payload(data)
    version = int(meta.get("version", 0))
    expect_crc = meta.get("expect_crc")
    if expect_crc is not None:
        expect_crc = int(expect_crc)
    if not meta.get("has_sub"):
        return None, version, expect_crc
    sub: Dict[str, Any] = {"rows": {}, "full": {},
                           "crc": int(meta.get("crc", 0))}
    for key in meta.get("row_keys", []):
        sub["rows"][key] = (arrays["ri/" + key], arrays["rv/" + key])
    for key in meta.get("full_keys", []):
        sub["full"][key] = arrays["full/" + key]
    return sub, version, expect_crc


# --- seam codecs: full block install (warm boot over the wire) --------
def encode_blocks(blocks: Dict[str, Any], version: int,
                  chain_crc: int) -> bytes:
    """A shard's full blocks (install / warm-cache boot): fp32 blocks
    whole, quantized blocks as codes + scales + dtype — the same
    representation ``utils.warmcache.ShardCache`` persists, so a boot
    over the wire is bit-identical to a boot from disk."""
    from ..quant.store import QuantTable
    meta: Dict[str, Any] = {"kind": "install", "version": int(version),
                            "chain_crc": int(chain_crc) & 0xFFFFFFFF,
                            "quant": {}}
    arrays: Dict[str, np.ndarray] = {}
    for op, blk in blocks.items():
        if isinstance(blk, QuantTable):
            arrays["q/" + op] = _host(blk.encoded())
            arrays["s/" + op] = _host(blk.scales)
            meta["quant"][op] = blk.dtype
        else:
            arrays["b/" + op] = np.asarray(blk, np.float32)
    return encode_payload(meta, arrays)


def decode_blocks(data: bytes
                  ) -> Tuple[Dict[str, Any], int, int]:
    """(blocks, version, chain_crc); quantized entries come back as
    QuantTable (codes + scales bit-exact)."""
    from ..quant.store import QuantTable
    meta, arrays = decode_payload(data)
    blocks: Dict[str, Any] = {}
    for name, arr in arrays.items():
        if name.startswith("b/"):
            blocks[name[len("b/"):]] = arr
    for op, dtype in (meta.get("quant") or {}).items():
        blocks[op] = QuantTable.from_encoded(
            arrays["q/" + op], arrays["s/" + op], str(dtype))
    return (blocks, int(meta.get("version", 0)),
            int(meta.get("chain_crc", 0)) & 0xFFFFFFFF)


# --- seam codecs: ranker predict --------------------------------------
def encode_predict_request(features: Dict[str, np.ndarray]) -> bytes:
    return encode_payload(
        {"kind": "predict"},
        {"f/" + k: _host(v) for k, v in features.items()})


def decode_predict_request(data: bytes) -> Dict[str, np.ndarray]:
    _meta, arrays = decode_payload(data)
    return {name[len("f/"):]: arr for name, arr in arrays.items()
            if name.startswith("f/")}


def encode_prediction(pred) -> bytes:
    """A :class:`~.engine.Prediction`, version vector and ``degraded``
    flag in-band (old-or-new-never-mixed must survive the process
    boundary, so the consistency evidence ships with the scores)."""
    versions = pred.versions
    return encode_payload(
        {"kind": "prediction", "version": int(pred.version),
         "latency_ms": float(pred.latency_ms),
         "degraded": bool(pred.degraded),
         "versions": (None if versions is None
                      else {str(k): int(v)
                            for k, v in versions.items()})},
        {"scores": _host(pred.scores)})


def decode_prediction(data: bytes):
    from .engine import Prediction
    meta, arrays = decode_payload(data)
    versions = meta.get("versions")
    if versions is not None:
        versions = {int(k): int(v) for k, v in versions.items()}
    return Prediction(arrays["scores"], int(meta.get("version", 0)),
                      float(meta.get("latency_ms", 0.0)),
                      versions=versions,
                      degraded=bool(meta.get("degraded", False)))


# --- seam codecs: errors ----------------------------------------------
def encode_error(exc: BaseException) -> bytes:
    """A handler failure as data: exception type name + message, plus
    the structured fields the typed serving errors carry (shard id) so
    the client re-raises something the breaker logic already knows."""
    meta = {"kind": "error", "type": type(exc).__name__,
            "message": str(exc)}
    sid = getattr(exc, "shard_id", None)
    if sid is not None:
        meta["shard_id"] = int(sid)
    rid = getattr(exc, "replica_id", None)
    if rid is not None:
        meta["replica_id"] = int(rid)
    return encode_payload(meta)


def decode_error(data: bytes) -> Dict[str, Any]:
    meta, _arrays = decode_payload(data)
    return meta
