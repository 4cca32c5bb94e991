"""Embedding-bag gather: the Hopper kernel, its plain version and its
gradient.

Replaces the Pallas TPU kernel ``_bag_kernel``
(dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:55) and its stacked
entry ``stacked_embedding_bag``. The CUDA source,
``csrc/embedding_bag.cu``, states the kernel's bound (memory: the
random row reads) and its design (one thread per float4 column chunk,
neighbouring threads on neighbouring addresses).

``embedding_bag`` takes a CPU tensor to the plain version
``embedding_bag_reference`` and launches the kernel for a CUDA tensor —
it raises there if the kernel cannot be built or launched, and never
falls back. ``embedding_bag.launches`` counts kernel launches. With
``return_rows=True`` it also returns every gathered row, as the kernel
wrote it while reading: the residual of the write-only sparse update.

``embedding_bag_quant`` is the quantized twin, replacing
``_bag_kernel_quant`` (embedding_kernel.py:189) behind the JAX
``embedding_bag_quant``: the table holds int8 or fp8-e4m3 codes and one
fp32 scale per row, dequantized as they are accumulated. As in the JAX
package, no op calls it yet; its plain version is
``embedding_bag_quant_reference`` and ``embedding_bag_quant.launches``
counts its launches.

``EmbeddingBagFunction`` is the custom VJP of the JAX ``embedding_bag``
(``_bwd``, embedding_kernel.py:159): the cotangent repeated over the bag
(divided by the bag for "avg"), summed into a zero table in sorted id
order — on the card by the ``scatter_add_rows`` kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .scatter_rows import segment_sum_rows

_SIGNATURES = {
    "ff_embedding_bag_forward": (
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p),
        ctypes.c_int),
    "ff_embedding_bag_quant_forward": (
        (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) + (ctypes.c_int,) * 4
        + (ctypes.c_void_p,),
        ctypes.c_int),
}
_QUANT_CODES = (torch.int8, torch.float8_e4m3fn)


def embedding_bag_reference(table: torch.Tensor, ids: torch.Tensor,
                            aggr: str = "sum", return_rows: bool = False):
    """Plain PyTorch version: gather, then sum (or mean) over the bag dim
    in fp32, cast to the table's dtype — the oracle of the JAX package's
    ``embedding_bag_reference``. A negative id gathers a zero row."""
    ids = ids.long()
    if bool((ids < 0).any()):
        rows = torch.where((ids >= 0)[..., None], table[ids.clamp(min=0)],
                           torch.zeros((), dtype=table.dtype))
    else:
        rows = table[ids]
    out = rows.sum(dim=-2, dtype=torch.float32)
    if aggr == "avg":
        out = out / ids.shape[-1]
    out = out.to(table.dtype)
    if return_rows:
        return out, rows.reshape(-1, table.shape[1])
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  aggr: str = "sum", return_rows: bool = False):
    """table (rows, d), ids (n, bag) int in [0, rows) -> (n, d): the sum,
    or for ``aggr="avg"`` the mean, of each bag's rows; with
    ``return_rows`` also the gathered rows, (n * bag, d) in id order. A
    negative id adds a zero row (a lookup outside a rank's row block)."""
    if aggr not in ("sum", "avg"):
        raise ValueError(f"embedding_bag aggr expects sum|avg, got {aggr!r}")
    if ids.dim() != 2 or table.dim() != 2:
        raise ValueError(f"embedding_bag expects table (rows, d) and ids "
                         f"(n, bag), got {tuple(table.shape)} and "
                         f"{tuple(ids.shape)}")
    if table.device.type == "cpu":
        return embedding_bag_reference(table, ids, aggr, return_rows)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on cpu or cuda, not "
                         f"{table.device}")
    n, bag = ids.shape
    d = table.shape[1]
    if table.dtype != torch.float32 or ids.dtype != torch.int64:
        raise ValueError(f"embedding_bag kernel takes a float32 table and "
                         f"int64 ids, got {table.dtype} and {ids.dtype}")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    if d % 4 or not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("embedding_bag kernel needs a contiguous, 16-byte "
                         f"aligned table with d % 4 == 0 (d={d})")
    ids = ids.contiguous()
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    rows = (torch.empty((n * bag, d), dtype=table.dtype,
                        device=table.device) if return_rows else None)
    if n:
        lib = build.load("embedding_bag", _SIGNATURES)
        err = lib.ff_embedding_bag_forward(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(), n, bag, d,
            int(aggr == "avg"), build.stream_of(table))
        build.check(lib, err, "embedding_bag kernel")
        build.count_launch(embedding_bag)
    return (out, rows) if return_rows else out


embedding_bag.launches = 0


def embedding_bag_quant_reference(codes: torch.Tensor, scales: torch.Tensor,
                                  ids: torch.Tensor, aggr: str = "sum"
                                  ) -> torch.Tensor:
    """Plain PyTorch version: dequantize the gathered rows (code times
    its row's scale, in fp32), then sum (or mean) over the bag — the
    oracle of the JAX package's ``embedding_bag_quant_reference``."""
    idx = ids.long()
    # gather the code bytes (fp8 gathers as its bit patterns), then cast
    picked = codes.view(torch.uint8)[idx].view(codes.dtype)
    rows = picked.to(torch.float32) * \
        scales.to(torch.float32)[idx][..., None]
    out = rows.sum(dim=-2)
    if aggr == "avg":
        out = out / ids.shape[-1]
    return out


def embedding_bag_quant(codes: torch.Tensor, scales: torch.Tensor,
                        ids: torch.Tensor, aggr: str = "sum"
                        ) -> torch.Tensor:
    """codes (rows, d) int8 or float8_e4m3fn, scales (rows,) fp32, ids
    (n, bag) int in [0, rows) -> (n, d) fp32: the sum, or for
    ``aggr="avg"`` the mean, of each bag's dequantized rows."""
    if aggr not in ("sum", "avg"):
        raise ValueError(f"embedding_bag_quant aggr expects sum|avg, got "
                         f"{aggr!r}")
    if ids.dim() != 2 or codes.dim() != 2 \
            or scales.shape != (codes.shape[0],):
        raise ValueError(f"embedding_bag_quant expects codes (rows, d), "
                         f"scales (rows,) and ids (n, bag), got "
                         f"{tuple(codes.shape)}, {tuple(scales.shape)} and "
                         f"{tuple(ids.shape)}")
    if codes.dtype not in _QUANT_CODES:
        raise ValueError(f"embedding_bag_quant takes int8 or "
                         f"float8_e4m3fn codes, got {codes.dtype}")
    if codes.device.type == "cpu":
        return embedding_bag_quant_reference(codes, scales, ids, aggr)
    if codes.device.type != "cuda":
        raise ValueError(f"embedding_bag_quant runs on cpu or cuda, not "
                         f"{codes.device}")
    if scales.dtype != torch.float32 or ids.dtype != torch.int64:
        raise ValueError(f"embedding_bag_quant kernel takes float32 scales "
                         f"and int64 ids, got {scales.dtype} and {ids.dtype}")
    if ids.device != codes.device or scales.device != codes.device:
        raise ValueError("embedding_bag_quant inputs lie on different "
                         "devices")
    n, bag = ids.shape
    d = codes.shape[1]
    if d % 4 or not codes.is_contiguous() or codes.data_ptr() % 4:
        raise ValueError("embedding_bag_quant kernel needs contiguous, "
                         f"4-byte aligned codes with d % 4 == 0 (d={d})")
    ids, scales = ids.contiguous(), scales.contiguous()
    out = torch.empty((n, d), dtype=torch.float32, device=codes.device)
    if n:
        lib = build.load("embedding_bag", _SIGNATURES)
        err = lib.ff_embedding_bag_quant_forward(
            codes.data_ptr(), scales.data_ptr(), ids.data_ptr(),
            out.data_ptr(), n, bag, d, int(aggr == "avg"),
            int(codes.dtype == torch.float8_e4m3fn), build.stream_of(codes))
        build.check(lib, err, "embedding_bag_quant kernel")
        build.count_launch(embedding_bag_quant)
    return out


embedding_bag_quant.launches = 0


class EmbeddingBagFunction(torch.autograd.Function):
    """``embedding_bag`` with the gradient of the JAX custom VJP: a dense
    (rows, d) ``dtable`` and no gradient for the ids."""

    @staticmethod
    def forward(ctx, table, ids, aggr):
        ctx.save_for_backward(ids)
        ctx.aggr = aggr
        ctx.rows = table.shape[0]
        return embedding_bag(table, ids, aggr)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        bag = ids.shape[1]
        g = g.float()
        if ctx.aggr == "avg":
            g = g / bag
        # lookup j takes cotangent row j // bag: the repeat, unmaterialized
        dtable = segment_sum_rows(ids.reshape(-1), g.contiguous(), ctx.rows,
                                  div=bag)
        return dtable, None, None
