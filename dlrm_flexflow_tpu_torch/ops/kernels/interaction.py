"""Fused gather -> dot interaction -> first top-MLP layer: the Hopper
kernel and its plain version.

Replaces the Pallas TPU kernel ``_interaction_kernel``
(dlrm_flexflow_tpu/ops/pallas/interaction_kernel.py:92) behind
``fused_interaction``. The CUDA source, ``csrc/interaction.cu``, states
the kernel's bound (fp32 operations of the first layer) and its design
(a thread-block cluster along the output columns gathers a sample
tile's X and forms its lower-triangle dots once, in shared memory; each
block stages its W column tile with one TMA copy and computes a
register tile of samples x columns; the tril rows of W are indexed directly
instead of the TPU's zero-padded scatter matrix). ``interaction_tiles``
chooses the tiles from B and H, here in Python so that the CPU tests
reach it.

``fused_interaction`` takes CPU tensors to the plain version
``fused_interaction_reference`` and launches the kernel for CUDA
tensors — it raises there if the kernel cannot be built or launched, and
never falls back. ``fused_interaction.launches`` counts kernel launches.

``fused_interaction_quant`` is the quantized twin, replacing
``_interaction_kernel_quant`` (interaction_kernel.py:324) behind the JAX
``fused_interaction_quant``: the table holds int8 or fp8-e4m3 codes and
one fp32 scale per row, dequantized as X is gathered; from X on the math
is the fp32 kernel's. As in the JAX package, no op calls it yet; its
plain version is ``fused_interaction_quant_reference`` and
``fused_interaction_quant.launches`` counts its launches.

``FusedInteractionFunction`` is the custom VJP of the JAX
``fused_interaction`` (``_fused_fwd``/``_fused_bwd``,
interaction_kernel.py:260-310): the forward is ``fused_interaction``;
the backward recomputes X and Z and takes dw, db, dbottom and a dense
``dtable`` in torch ops, as the JAX package writes it in plain XLA. Its
one scatter, the sorted segment-sum of the rows' gradients into
``dtable``, runs through ``scatter_add_rows`` — the kernel on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import build
from .scatter_rows import segment_sum_rows

# the most shared memory one block may take on an H100 (227 KB), and the
# kernel's static part of it (the W tile's mbarrier, then the dynamic part
# 128-byte aligned)
MAX_SMEM_BYTES = 232448
STATIC_SMEM_BYTES = 128
# the blocks of a portable thread-block cluster
CLUSTER_MAX = 8
# blocks the tiles aim for: about two on each of the H100's 132 SMs
TARGET_BLOCKS = 256
# samples a block takes at most
MAX_SAMPLE_TILE = 64
# the kernel's threads a block at most (its __launch_bounds__)
MAX_THREADS = 512

_SIGNATURES = {
    "ff_fused_interaction_forward": (
        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 10 + (ctypes.c_void_p,),
        ctypes.c_int),
    "ff_fused_interaction_quant_forward": (
        (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 11 + (ctypes.c_void_p,),
        ctypes.c_int),
    "ff_fused_interaction_smem_bytes": (
        (ctypes.c_int,) * 5, ctypes.c_longlong),
    "ff_fused_interaction_max_clusters": (
        (ctypes.c_int,) * 8, ctypes.c_int),
}


class Tiles(NamedTuple):
    """One launch of the kernel: sample tiles of ``sb`` samples by
    column tiles of ``hc`` columns, ``ss`` samples (by 4 columns) a
    thread in the layer, ``cl`` column tiles a cluster; ``grid``
    (sample tiles, column tiles padded to a multiple of ``cl``),
    ``threads`` a block and ``smem`` bytes of dynamic shared memory a
    block."""
    sb: int
    hc: int
    ss: int
    cl: int
    grid: Tuple[int, int]
    threads: int
    smem: int


def _odd_quads(n: int) -> int:
    """n rounded up to a multiple of 4 whose quarter is odd (the
    kernel's padded row stride, in floats)."""
    q = -(-n // 4)
    return 4 * (q + 1 - q % 2)


def interaction_smem_bytes(T: int, d: int, sb: int, hc: int, cl: int) -> int:
    """Dynamic shared memory one block takes, as the kernel lays it
    out: the W column tile (K rounded up to 4 rows, hc columns), the
    tile's feat rows and X of the samples the block gathers itself."""
    F = T + 1
    K = d + F * (F - 1) // 2
    return 4 * (4 * -(-K // 4) * hc + sb * _odd_quads(K)
                + -(-sb // cl) * F * _odd_quads(d))


def _tiles(B, H, T, d, sb, hc) -> Tiles:
    cl = min(-(-H // hc), CLUSTER_MAX)
    ss = min(8, max(1, sb // 2))
    ny = -(-H // hc)
    layer = hc // 4 * (sb // ss)
    return Tiles(sb, hc, ss, cl, (-(-B // sb), -(-ny // cl) * cl),
                 max(128, -(-layer // 32) * 32),
                 interaction_smem_bytes(T, d, sb, hc, cl))


def interaction_tiles(B: int, H: int, T: int, d: int) -> Tiles:
    """The kernel's tiles for a batch of B, H output columns, T tables
    and width d. Column tiles: H split over one cluster of at most 8
    (at most 256 columns a tile, 4 at least). Sample tiles: the largest
    power of two up to 64 that still gives about 256 blocks, so that
    B >= 64 fills the card; each thread then keeps up to 8 samples.
    Halves the column and then the sample tile until a block's shared
    memory fits (the column tile while W's takes half of it or more);
    raises ValueError when even 4 columns of 1 sample do not."""
    if B < 1 or H < 1:
        raise ValueError(f"interaction_tiles: B={B}, H={H}")
    hc = min(256, 4 * -(-H // (4 * CLUSTER_MAX)))
    ny = -(-H // hc)
    sb = MAX_SAMPLE_TILE
    while sb > 1 and -(-B // sb) * ny < TARGET_BLOCKS:
        sb //= 2
    limit = MAX_SMEM_BYTES - STATIC_SMEM_BYTES
    while True:
        t = _tiles(B, H, T, d, sb, hc)
        if t.smem <= limit:
            break
        w_tile = interaction_smem_bytes(T, d, 0, hc, t.cl)
        if hc > 4 and (sb == 1 or 2 * w_tile >= MAX_SMEM_BYTES):
            hc = 4 * -(-hc // 8)
        elif sb > 1:
            sb //= 2
        else:
            need = interaction_smem_bytes(T, d, 1, 4, 1) + STATIC_SMEM_BYTES
            raise ValueError(
                f"fused_interaction: T={T}, d={d} needs {need} B of shared "
                f"memory per block, over {MAX_SMEM_BYTES}")
    return t


def tril_pairs(F: int):
    """The strictly-lower-triangle (i, j) pairs in DLRM's interaction
    order (``for i in range(F) for j in range(i)``)."""
    return [(i, j) for i in range(F) for j in range(i)]


def tril_flat(F: int, device) -> torch.Tensor:
    """The flat positions i·F + j of ``tril_pairs(F)`` in a row-major
    (F, F) matrix, built on ``device`` (torch.tril_indices enumerates
    the pairs in the same order) so no host copy waits on the stream."""
    i, j = torch.tril_indices(F, F, offset=-1, device=device)
    return i * F + j


def _as_3d(indices: torch.Tensor) -> torch.Tensor:
    return indices[:, :, None] if indices.dim() == 2 else indices


def fused_interaction_reference(table, indices, bottom, w, bias,
                                relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: gather -> stack -> X·Xᵀ -> tril -> concat
    -> first top-MLP layer, fp32 throughout — the oracle of the JAX
    package's ``fused_interaction_reference``."""
    idx = _as_3d(indices).long()
    emb = table[idx].float().sum(dim=2)                        # (b, T, d)
    return _interact(emb, bottom, w, bias, relu)


def _interact(emb, bottom, w, bias, relu: bool) -> torch.Tensor:
    """From the bag sums (b, T, d) on: stack under the bottom row ->
    X·Xᵀ -> tril -> concat -> first top-MLP layer, fp32."""
    batch, T, _ = emb.shape
    F = T + 1
    x = torch.cat([bottom.float()[:, None, :], emb], dim=1)    # (b, F, d)
    z = torch.bmm(x, x.transpose(1, 2))                        # (b, F, F)
    zt = z.reshape(batch, F * F)[:, tril_flat(F, z.device)]
    cat = torch.cat([bottom.float(), zt], dim=1)
    y = cat @ w.float() + bias.float()
    return torch.relu(y) if relu else y


def fused_interaction_quant_reference(codes, scales, indices, bottom, w,
                                      bias, relu: bool = True
                                      ) -> torch.Tensor:
    """Plain PyTorch version of the quantized twin: dequantize the
    gathered rows (code times its row's scale, fp32), bag-sum, then the
    fp32 composition — the oracle of the JAX package's
    ``fused_interaction_quant_reference``."""
    idx = _as_3d(indices).long()
    picked = codes.view(torch.uint8)[idx].view(codes.dtype)
    deq = picked.to(torch.float32) * \
        scales.to(torch.float32)[idx][..., None]
    return _interact(deq.sum(dim=2), bottom, w, bias, relu)


def _check_shapes(name, table, indices, bottom, w, bias):
    """(idx (B, T, bag), B, T, bag, d, H) after the shape checks."""
    idx = _as_3d(indices)
    if idx.dim() != 3 or bottom.dim() != 2 or table.dim() != 2:
        raise ValueError(f"{name} expects indices (B, T[, bag]), "
                         f"bottom (B, d) and table (rows, d), got "
                         f"{tuple(indices.shape)}, {tuple(bottom.shape)}, "
                         f"{tuple(table.shape)}")
    B, T, bag = idx.shape
    d = table.shape[1]
    P = len(tril_pairs(T + 1))
    if bottom.shape != (B, d) or w.dim() != 2 or w.shape[0] != d + P:
        raise ValueError(f"{name}: bottom {tuple(bottom.shape)} and w "
                         f"{tuple(w.shape)} do not fit B={B}, d={d}, "
                         f"{P} pairs")
    H = w.shape[1]
    if bias.shape != (H,):
        raise ValueError(f"bias {tuple(bias.shape)} does not fit H={H}")
    return idx, B, T, bag, d, H


def fused_interaction_quant(codes, scales, indices, bottom, w, bias,
                            relu: bool = True) -> torch.Tensor:
    """``fused_interaction`` over a quantized table: codes (rows, d)
    int8 or float8_e4m3fn, scales (rows,) fp32; everything else as
    ``fused_interaction``."""
    idx, B, T, bag, d, H = _check_shapes("fused_interaction_quant", codes,
                                         indices, bottom, w, bias)
    if codes.dtype not in (torch.int8, torch.float8_e4m3fn) \
            or scales.shape != (codes.shape[0],):
        raise ValueError(f"fused_interaction_quant takes int8 or "
                         f"float8_e4m3fn codes and (rows,) scales, got "
                         f"{codes.dtype} and {tuple(scales.shape)}")
    if codes.device.type == "cpu":
        return fused_interaction_quant_reference(codes, scales, idx, bottom,
                                                 w, bias, relu)
    if codes.device.type != "cuda":
        raise ValueError(f"fused_interaction_quant runs on cpu or cuda, "
                         f"not {codes.device}")
    floats = (scales, bottom, w, bias)
    if any(t.dtype != torch.float32 for t in floats) \
            or idx.dtype != torch.int64:
        raise ValueError("fused_interaction_quant kernel takes float32 "
                         "scales, bottom, w and bias and int64 indices")
    if any(t.device != codes.device for t in floats + (idx,)):
        raise ValueError("fused_interaction_quant inputs lie on different "
                         "devices")
    if d % 4:
        raise ValueError(f"fused_interaction_quant kernel needs d % 4 == 0 "
                         f"(d={d})")
    codes, scales, bottom, w, bias = (
        t.contiguous() for t in (codes,) + floats)
    idx = idx.contiguous()
    if codes.data_ptr() % 4 or bottom.data_ptr() % 16:
        raise ValueError("fused_interaction_quant kernel needs 4-byte "
                         "aligned codes and a 16-byte aligned bottom")
    out = torch.empty((B, H), dtype=torch.float32, device=codes.device)
    if B == 0 or H == 0:
        return out
    t = interaction_tiles(B, H, T, d)
    lib = build.load("interaction", _SIGNATURES)
    err = lib.ff_fused_interaction_quant_forward(
        codes.data_ptr(), scales.data_ptr(), idx.data_ptr(),
        bottom.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        B, T, bag, d, H, int(relu), int(codes.dtype == torch.float8_e4m3fn),
        t.sb, t.hc, t.ss, t.cl, build.stream_of(codes))
    build.check(lib, err, "fused_interaction_quant kernel")
    build.count_launch(fused_interaction_quant)
    return out


fused_interaction_quant.launches = 0


def fused_interaction(table, indices, bottom, w, bias,
                      relu: bool = True) -> torch.Tensor:
    """table (rows, d): the T tables stacked row-wise; indices (B, T) or
    (B, T, bag) int, already offset into the stacked rows; bottom (B, d);
    w (d + F(F-1)/2, H) with F = T + 1; bias (H,). Returns (B, H) fp32,
    relu'd when ``relu``."""
    idx, B, T, bag, d, H = _check_shapes("fused_interaction", table,
                                         indices, bottom, w, bias)
    if table.device.type == "cpu":
        return fused_interaction_reference(table, idx, bottom, w, bias, relu)
    if table.device.type != "cuda":
        raise ValueError(f"fused_interaction runs on cpu or cuda, not "
                         f"{table.device}")
    floats = (table, bottom, w, bias)
    if any(t.dtype != torch.float32 for t in floats) \
            or idx.dtype != torch.int64:
        raise ValueError("fused_interaction kernel takes float32 table, "
                         "bottom, w and bias and int64 indices")
    if any(t.device != table.device for t in floats + (idx,)):
        raise ValueError("fused_interaction inputs lie on different devices")
    if d % 4:
        raise ValueError(f"fused_interaction kernel needs d % 4 == 0 (d={d})")
    table, bottom, w, bias = (t.contiguous() for t in floats)
    idx = idx.contiguous()
    if table.data_ptr() % 16 or bottom.data_ptr() % 16:
        raise ValueError("fused_interaction kernel needs 16-byte aligned "
                         "table and bottom")
    out = torch.empty((B, H), dtype=torch.float32, device=table.device)
    if B == 0 or H == 0:
        return out
    t = interaction_tiles(B, H, T, d)
    lib = build.load("interaction", _SIGNATURES)
    err = lib.ff_fused_interaction_forward(
        table.data_ptr(), idx.data_ptr(), bottom.data_ptr(), w.data_ptr(),
        bias.data_ptr(), out.data_ptr(), B, T, bag, d, H, int(relu),
        t.sb, t.hc, t.ss, t.cl, build.stream_of(table))
    build.check(lib, err, "fused_interaction kernel")
    build.count_launch(fused_interaction)
    return out


fused_interaction.launches = 0


class FusedInteractionFunction(torch.autograd.Function):
    """``fused_interaction`` with the gradients of the JAX custom VJP:
    (dtable, None, dbottom, dw, db, None)."""

    @staticmethod
    def forward(ctx, table, indices, bottom, w, bias, relu):
        y = fused_interaction(table, indices, bottom, w, bias, relu)
        ctx.save_for_backward(table, _as_3d(indices).long(), bottom, w, y)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, g):
        table, idx, bottom, w, y = ctx.saved_tensors
        batch, T, bag = idx.shape
        F = T + 1
        d = bottom.shape[1]
        emb = table[idx].float().sum(dim=2)                    # (b, T, d)
        x = torch.cat([bottom.float()[:, None, :], emb], dim=1)  # (b, F, d)
        z = torch.bmm(x, x.transpose(1, 2))
        sel = tril_flat(F, z.device)
        zt = z.reshape(batch, F * F)[:, sel]
        cat = torch.cat([bottom.float(), zt], dim=1)

        g = g.float()
        if ctx.relu:
            g = torch.where(y > 0.0, g, torch.zeros_like(g))
        dw = cat.T @ g
        db = g.sum(dim=0)
        g_cat = g @ w.float().T
        g_z = torch.zeros((batch, F * F), dtype=torch.float32,
                          device=g.device)
        g_z[:, sel] = g_cat[:, d:]
        g_z = g_z.reshape(batch, F, F)
        dx = torch.bmm(g_z + g_z.transpose(1, 2), x)           # (b, F, d)
        g_bottom = g_cat[:, :d] + dx[:, 0, :]
        # the rows of one bag share their sample/table gradient: lookup j
        # takes row j // bag
        g_rows = dx[:, 1:, :].reshape(batch * T, d).contiguous()
        dtable = segment_sum_rows(idx.reshape(-1), g_rows, table.shape[0],
                                  div=bag)
        return (dtable, None, g_bottom.to(bottom.dtype), dw.to(w.dtype),
                db, None)
