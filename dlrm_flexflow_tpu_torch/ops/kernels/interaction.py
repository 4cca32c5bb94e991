"""Fused gather -> dot interaction -> first top-MLP layer: the Hopper
kernel and its plain version.

Replaces the Pallas TPU kernel ``_interaction_kernel``
(dlrm_flexflow_tpu/ops/pallas/interaction_kernel.py:92) behind
``fused_interaction``. The CUDA source, ``csrc/interaction.cu``, states
the kernel's bound (fp32 operations of the first layer) and its design
(a sample tile's X and lower-triangle dots in shared memory, one output
column per thread, the tril rows of W indexed directly instead of the
TPU's zero-padded scatter matrix).

``fused_interaction`` takes CPU tensors to the plain version
``fused_interaction_reference`` and launches the kernel for CUDA
tensors — it raises there if the kernel cannot be built or launched, and
never falls back. ``fused_interaction.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# the most shared memory one block may take on an H100 (227 KB)
MAX_SMEM_BYTES = 232448

_SIGNATURES = {
    "ff_fused_interaction_forward": (
        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,),
        ctypes.c_int),
    "ff_fused_interaction_smem_bytes": (
        (ctypes.c_int, ctypes.c_int), ctypes.c_longlong),
}


def tril_pairs(F: int):
    """The strictly-lower-triangle (i, j) pairs in DLRM's interaction
    order (``for i in range(F) for j in range(i)``)."""
    return [(i, j) for i in range(F) for j in range(i)]


def _as_3d(indices: torch.Tensor) -> torch.Tensor:
    return indices[:, :, None] if indices.dim() == 2 else indices


def fused_interaction_reference(table, indices, bottom, w, bias,
                                relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: gather -> stack -> X·Xᵀ -> tril -> concat
    -> first top-MLP layer, fp32 throughout — the oracle of the JAX
    package's ``fused_interaction_reference``."""
    idx = _as_3d(indices).long()
    batch, T, _ = idx.shape
    F = T + 1
    emb = table[idx].float().sum(dim=2)                        # (b, T, d)
    x = torch.cat([bottom.float()[:, None, :], emb], dim=1)    # (b, F, d)
    z = torch.bmm(x, x.transpose(1, 2))                        # (b, F, F)
    sel = torch.tensor([i * F + j for i, j in tril_pairs(F)],
                       dtype=torch.long, device=z.device)
    zt = z.reshape(batch, F * F)[:, sel]
    cat = torch.cat([bottom.float(), zt], dim=1)
    y = cat @ w.float() + bias.float()
    return torch.relu(y) if relu else y


def fused_interaction(table, indices, bottom, w, bias,
                      relu: bool = True) -> torch.Tensor:
    """table (rows, d): the T tables stacked row-wise; indices (B, T) or
    (B, T, bag) int, already offset into the stacked rows; bottom (B, d);
    w (d + F(F-1)/2, H) with F = T + 1; bias (H,). Returns (B, H) fp32,
    relu'd when ``relu``."""
    idx = _as_3d(indices)
    if idx.dim() != 3 or bottom.dim() != 2 or table.dim() != 2:
        raise ValueError(f"fused_interaction expects indices (B, T[, bag]), "
                         f"bottom (B, d) and table (rows, d), got "
                         f"{tuple(indices.shape)}, {tuple(bottom.shape)}, "
                         f"{tuple(table.shape)}")
    B, T, bag = idx.shape
    d = table.shape[1]
    P = len(tril_pairs(T + 1))
    if bottom.shape != (B, d) or w.dim() != 2 or w.shape[0] != d + P:
        raise ValueError(f"fused_interaction: bottom {tuple(bottom.shape)} "
                         f"and w {tuple(w.shape)} do not fit B={B}, d={d}, "
                         f"{P} pairs")
    H = w.shape[1]
    if bias.shape != (H,):
        raise ValueError(f"bias {tuple(bias.shape)} does not fit H={H}")
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
    lib = build.load("interaction", _SIGNATURES)
    smem = lib.ff_fused_interaction_smem_bytes(T, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_interaction: T={T}, d={d} needs {smem} B of "
                         f"shared memory per block, over {MAX_SMEM_BYTES}")
    err = lib.ff_fused_interaction_forward(
        table.data_ptr(), idx.data_ptr(), bottom.data_ptr(), w.data_ptr(),
        bias.data_ptr(), out.data_ptr(), B, T, bag, d, H, int(relu),
        build.stream_of(table))
    build.check(lib, err, "fused_interaction kernel")
    fused_interaction.launches += 1
    return out


fused_interaction.launches = 0
