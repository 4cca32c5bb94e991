"""Int8 maximum-inner-product top-k: the Hopper kernel and its plain
version.

Replaces the Pallas TPU kernel ``_topk_kernel``
(dlrm_flexflow_tpu/ops/pallas/topk_kernel.py:117) behind ``mips_topk``.
The CUDA source, ``csrc/topk.cu``, states the kernel's bound (memory:
the index's code and scale bytes) and its design: select, then sort.
The top k of a query lie among the rows scoring at or above the k-th
largest of its chunk maxima (each chunk maximum is a distinct row's
score, so at least k rows reach it); the card scores every chunk's rows
for all queries at once and keeps each query's chunk maxima, takes that
threshold, compacts the rows that reach it into a bounded buffer, and
sorts only those. ``mips_topk_select_reference`` is the same selection
in plain PyTorch, the CPU's check of the lemma. When a query's
candidates overflow the buffer (many tied scores, or fewer chunks than
k), the call takes the "overflow" route instead: per-chunk sorts and
merge passes, bitwise the same.

The contract is the JAX oracle's, bit for bit: ``score = float(int32
dot of the codes) * (row scale * query scale)``, the two fp32 products
in that order, and the top k' = min(k, R) by score descending, ties by
id ascending (scores compared as floats: -0.0 ties +0.0). The sharded
heap-merge of ``retrieve.index`` relies on it.

``mips_topk`` takes CPU tensors to the plain version
``mips_topk_reference`` and launches the kernel for CUDA tensors — it
raises there if the kernel cannot be built or launched, and never falls
back. ``mips_topk.launches`` counts kernel launches (shards launch from
pool threads; ``build.count_launch`` takes the count under a lock), one
a call, and ``mips_topk.routes`` counts them by route, "select" or
"overflow". The route is chosen from the candidate counts, which the
wrapper reads back from the card: a call waits for its first passes.
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
    "ff_topk_cap": ((), ctypes.c_int),
    "ff_topk_chunk_rows": ((ctypes.c_longlong, ctypes.c_int), ctypes.c_int),
    "ff_topk_scores_max": ((), ctypes.c_longlong),
    "ff_topk_select": (
        (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int)
        + (ctypes.c_void_p,) * 7, ctypes.c_int),
    "ff_topk_sort": (
        (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_longlong) + (ctypes.c_void_p,) * 3,
        ctypes.c_int),
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


# the select route's limits, as csrc/topk.cu sets them: a query keeps at
# most CAP candidates; chunks of 32 to 2,048 rows; the score scratch up
# to SCORES_MAX = B * R entries
CAP = 8192
MIN_CHUNK_ROWS, MAX_CHUNK_ROWS = 32, 2048
SCORES_MAX = 1 << 22
MAX_ROWS = 2 ** 31 - 1      # rows travel as int32


def chunk_rows(R: int, k: int) -> int:
    """Rows of a select-route chunk (``ff_topk_chunk_rows``): the largest
    power of two from 32 to 2,048 that leaves at least 4k chunks."""
    c = MAX_CHUNK_ROWS
    while c > MIN_CHUNK_ROWS and -(-R // c) < 4 * k:
        c //= 2
    return c


def select_threshold(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) fp32: the k-th largest of each row's chunk maxima over chunks
    of ``chunk_rows(R, k)`` scores, or -inf with fewer than k chunks."""
    B, R = scores.shape
    c = chunk_rows(R, k)
    nch = -(-R // c)
    if nch < k:
        return torch.full((B,), float("-inf"), device=scores.device)
    pad = torch.full((B, nch * c - R), float("-inf"), device=scores.device)
    cmax = torch.cat([scores, pad], 1).view(B, nch, c).amax(2)
    return torch.sort(cmax, dim=1, descending=True).values[:, k - 1]


def mips_topk_select_reference(q_codes, q_scales, codes, scales, k: int,
                               base: int = 0):
    """The card's selection in plain PyTorch: chunk maxima -> threshold
    -> candidates (every score >= it) -> sort. Returns (scores, ids) as
    ``mips_topk_reference`` does, and the (B,) candidate counts; equal to
    the oracle because at least k rows reach the threshold."""
    scores = score_rows(q_codes, q_scales, codes, scales)
    kk = min(int(k), scores.shape[1])
    keep = scores >= select_threshold(scores, kk)[:, None]
    ids = base + torch.arange(codes.shape[0], dtype=torch.int64,
                              device=codes.device)
    out = [topk_select(scores[b:b + 1, keep[b]], ids[keep[b]], kk)
           for b in range(scores.shape[0])]
    return (torch.cat([s for s, _ in out]), torch.cat([i for _, i in out]),
            keep.sum(1))


def select_candidates(q_codes, q_scales, codes, scales, kk: int):
    """The select route's first passes on the card: (candidate scores
    (B, CAP) fp32, rows (B, CAP) int32, counts (B,) int32), query b's
    first min(count, CAP) entries its candidates in no order. What
    ``mips_topk`` launches before it reads the counts."""
    B, d = q_codes.shape
    R = codes.shape[0]
    dev = codes.device
    lib = build.load("topk", _SIGNATURES)
    nch = -(-R // lib.ff_topk_chunk_rows(R, kk))
    cmax = torch.empty(B * nch, dtype=torch.float32, device=dev)
    thr = torch.empty(B, dtype=torch.float32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    scores = (torch.empty(B * R, dtype=torch.float32, device=dev)
              if B * R <= lib.ff_topk_scores_max() else None)
    cap = lib.ff_topk_cap()
    cand_s = torch.empty((B, cap), dtype=torch.float32, device=dev)
    cand_r = torch.empty((B, cap), dtype=torch.int32, device=dev)
    err = lib.ff_topk_select(
        q_codes.data_ptr(), q_scales.data_ptr(), codes.data_ptr(),
        scales.data_ptr(), B, R, d, kk, cmax.data_ptr(), thr.data_ptr(),
        count.data_ptr(), scores.data_ptr() if scores is not None else None,
        cand_s.data_ptr(), cand_r.data_ptr(), build.stream_of(codes))
    build.check(lib, err, "mips_topk select kernels")
    return cand_s, cand_r, count


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
    if R > MAX_ROWS:
        raise ValueError(f"mips_topk kernel takes fewer than 2^31 rows, "
                         f"got {R}")
    lib = build.load("topk", _SIGNATURES)
    kk = min(int(k), R)
    if kk > lib.ff_topk_max_k():
        raise ValueError(f"mips_topk kernel takes k <= "
                         f"{lib.ff_topk_max_k()}, got {kk}")
    out_s = torch.empty((B, kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, kk), dtype=torch.int64, device=dev)
    stream = build.stream_of(codes)
    cand_s, cand_r, count = select_candidates(q_codes, q_scales, codes,
                                              scales, kk)
    most = int(count.max())             # waits for the select passes
    if most <= lib.ff_topk_cap():
        route = "select"
        err = lib.ff_topk_sort(cand_s.data_ptr(), cand_r.data_ptr(),
                               count.data_ptr(), B, kk,
                               1 << max(most - 1, 0).bit_length(), int(base),
                               out_s.data_ptr(), out_i.data_ptr(), stream)
    else:
        route = "overflow"
        n = lib.ff_topk_scratch_entries(B, R, kk)
        scratch = [torch.empty(n, dtype=dt, device=dev)
                   for dt in (torch.float32, torch.int64)]
        err = lib.ff_mips_topk(
            q_codes.data_ptr(), q_scales.data_ptr(), codes.data_ptr(),
            scales.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            *(t.data_ptr() for t in scratch), B, R, d, kk, int(base), stream)
    build.check(lib, err, f"mips_topk kernel ({route} route)")
    build.count_launch(mips_topk, route)
    return out_s, out_i


mips_topk.launches = 0
mips_topk.routes = {"select": 0, "overflow": 0}
