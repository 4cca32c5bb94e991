"""Int8 maximum-inner-product top-k: the Hopper kernel and its plain
version.

Replaces the Pallas TPU kernel ``_topk_kernel``
(dlrm_flexflow_tpu/ops/pallas/topk_kernel.py:117) behind ``mips_topk``.
The CUDA source, ``csrc/topk.cu``, states the kernel's bound (memory:
the index's code and scale bytes) and its design (per-chunk scoring with
``__dp4a`` and a shared-memory bitonic sort, then merge passes).

The contract is the JAX oracle's, bit for bit: ``score = float(int32
dot of the codes) * (row scale * query scale)``, the two fp32 products
in that order, and the top k' = min(k, R) by score descending, ties by
id ascending (scores compared as floats: -0.0 ties +0.0). The sharded
heap-merge of ``retrieve.index`` relies on it.

``mips_topk`` takes CPU tensors to the plain version
``mips_topk_reference`` and launches the kernel for CUDA tensors — it
raises there if the kernel cannot be built or launched, and never falls
back. ``mips_topk.launches`` counts kernel launches (shards launch from
pool threads; ``build.count_launch`` takes the count under a lock).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from ...quant.codec import quantize_rows

# the plain version's dot runs in fp32, exact while every partial sum of
# d products of |code| <= 127 stays below 2**24
MAX_EXACT_DIM = (2 ** 24 - 1) // (127 * 127)

_SIGNATURES = {
    "ff_mips_topk": (
        (ctypes.c_void_p,) * 8 + (ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_void_p),
        ctypes.c_int),
    "ff_topk_max_k": ((), ctypes.c_int),
    "ff_topk_scratch_entries": ((ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int), ctypes.c_longlong),
}


def quantize_query(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of a query batch, on its
    device (the codec the index rows use): (B, d) fp32 -> ((B, d) int8
    codes, (B,) fp32 scales). A 1-D query is a batch of one."""
    q = torch.as_tensor(q).to(torch.float32)
    if q.dim() == 1:
        q = q[None, :]
    return quantize_rows(q, "int8")


def score_rows(q_codes, q_scales, codes, scales) -> torch.Tensor:
    """(B, R) fp32 scores: the exact code dot, then one fp32 rescale
    with the row scale times the query scale taken first. The dot is an
    fp32 product of the int8 codes (CUDA has no integer matmul), exact
    for d <= MAX_EXACT_DIM and, on the card, only with TF32 off (an
    ``FFModel`` on the card turns it off)."""
    d = codes.shape[1]
    if d > MAX_EXACT_DIM:
        raise ValueError(f"score_rows: d={d} > {MAX_EXACT_DIM}, where the "
                         f"fp32 code dot stops being exact")
    if codes.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("score_rows: TF32 matmuls are on "
                         "(torch.backends.cuda.matmul.allow_tf32), which "
                         "round the code dot")
    dot = q_codes.to(torch.float32) @ codes.to(torch.float32).T   # (B, R)
    comb = scales.to(torch.float32)[None, :] * \
        q_scales.to(torch.float32)[:, None]                       # (B, R)
    return dot * comb


def topk_select(scores: torch.Tensor, ids: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row by (score desc, id asc), with ``ids`` (R,)
    ascending: (B, k') scores and int64 ids, k' = min(k, R). The stable
    sort of -score keeps ascending ids among ties; adding 0.0 first maps
    -0.0 to +0.0, so a sort that orders the sign bit (the card's radix
    sort) ties them as the oracle does."""
    kk = min(int(k), scores.shape[1])
    order = torch.sort(-(scores + 0.0), dim=1, stable=True).indices[:, :kk]
    return (torch.gather(scores, 1, order), ids.to(torch.int64)[order])


def mips_topk_reference(q_codes, q_scales, codes, scales, k: int,
                        base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact-scan oracle: score every row, sort, take k. ``base``
    offsets the returned ids (a shard scoring its [lo, hi) slice passes
    base=lo)."""
    scores = score_rows(q_codes, q_scales, codes, scales)
    ids = base + torch.arange(codes.shape[0], dtype=torch.int64,
                              device=codes.device)
    return topk_select(scores, ids, k)


def mips_topk(q_codes: torch.Tensor, q_scales: torch.Tensor,
              codes: torch.Tensor, scales: torch.Tensor, k: int,
              base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MIPS over one quantized row block.

    q_codes  : (B, d) int8 query codes (``quantize_query``)
    q_scales : (B,) fp32 query scales
    codes    : (R, d) int8 item codes, scales (R,) fp32 (a QuantTable)
    returns  : ((B, k') fp32 scores, (B, k') int64 ids + base) on the
               inputs' device, k' = min(k, R), ordered (score desc, id
               asc). R == 0 gives empty (B, 0) results."""
    if q_codes.dim() == 1:
        q_codes = q_codes[None, :]
    q_scales = q_scales.reshape(-1)
    if codes.dim() != 2 or q_codes.shape[1] != codes.shape[1] \
            or q_scales.shape[0] != q_codes.shape[0] \
            or scales.shape != (codes.shape[0],):
        raise ValueError(f"mips_topk: query {tuple(q_codes.shape)}, "
                         f"query scales {tuple(q_scales.shape)}, codes "
                         f"{tuple(codes.shape)}, scales "
                         f"{tuple(scales.shape)} do not fit")
    if int(k) < 1:
        raise ValueError(f"mips_topk: k must be >= 1, got {k}")
    B, d = q_codes.shape
    R = codes.shape[0]
    dev = codes.device
    if R == 0:
        return (torch.empty((B, 0), dtype=torch.float32, device=dev),
                torch.empty((B, 0), dtype=torch.int64, device=dev))
    if dev.type == "cpu":
        return mips_topk_reference(q_codes, q_scales, codes, scales, k, base)
    if dev.type != "cuda":
        raise ValueError(f"mips_topk runs on cpu or cuda, not {dev}")
    if q_codes.dtype != torch.int8 or codes.dtype != torch.int8 \
            or q_scales.dtype != torch.float32 \
            or scales.dtype != torch.float32:
        raise ValueError("mips_topk kernel takes int8 codes and float32 "
                         "scales")
    if any(t.device != dev for t in (q_codes, q_scales, scales)):
        raise ValueError("mips_topk inputs lie on different devices")
    if d % 4:
        raise ValueError(f"mips_topk kernel needs d % 4 == 0 (d={d})")
    q_codes, q_scales, codes, scales = (
        t.contiguous() for t in (q_codes, q_scales, codes, scales))
    if codes.data_ptr() % 4 or q_codes.data_ptr() % 4:
        raise ValueError("mips_topk kernel needs 4-byte aligned codes")
    if B > 65535:
        raise ValueError(f"mips_topk kernel takes at most 65535 queries, "
                         f"got {B}")
    lib = build.load("topk", _SIGNATURES)
    kk = min(int(k), R)
    if kk > lib.ff_topk_max_k():
        raise ValueError(f"mips_topk kernel takes k <= "
                         f"{lib.ff_topk_max_k()}, got {kk}")
    n = lib.ff_topk_scratch_entries(B, R, kk)
    scratch = [torch.empty(n, dtype=dt, device=dev)
               for dt in (torch.float32, torch.int64)]
    out_s = torch.empty((B, kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, kk), dtype=torch.int64, device=dev)
    err = lib.ff_mips_topk(
        q_codes.data_ptr(), q_scales.data_ptr(), codes.data_ptr(),
        scales.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        *(t.data_ptr() for t in scratch), B, R, d, kk, int(base),
        build.stream_of(codes))
    build.check(lib, err, "mips_topk kernel")
    build.count_launch(mips_topk)
    return out_s, out_i


mips_topk.launches = 0
