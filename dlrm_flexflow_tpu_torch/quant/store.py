"""Quantized row-block storage (the counterpart of
``dlrm_flexflow_tpu.quant.store``).

A :class:`QuantTable` is one quantized table, or one shard's row block
of it: the codes at the storage dtype plus one fp32 scale per row, both
torch tensors on one device. The JAX package keeps numpy arrays and
converts them at every call; here the codes and scales stay where they
were made (on the card, for the retrieval index), and every method
computes on that device.

Writes quantize per row (``set_rows``): each row's scale comes from the
incoming fp32 values alone, so neighbouring rows are untouched.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .codec import decode_q, dequantize_rows, encode_q, quantize_rows


class QuantTable:
    """(rows, dim) quantized storage: ``q`` codes + ``(rows,)`` fp32
    scales on one device. Not thread-safe: callers hold their own lock
    (a shard's lock serializes its block access)."""

    __slots__ = ("q", "scales", "dtype")

    def __init__(self, q: torch.Tensor, scales: torch.Tensor, dtype: str):
        if scales.device != q.device:
            raise ValueError(f"codes on {q.device}, scales on "
                             f"{scales.device}")
        self.q = q
        self.scales = scales.to(torch.float32).contiguous()
        self.dtype = dtype

    @classmethod
    def from_dense(cls, arr, dtype: str, device=None) -> "QuantTable":
        """Quantize fp32 rows (a tensor, or an array on the CPU) on
        ``device`` (default: where ``arr`` lies)."""
        arr = torch.as_tensor(arr)
        if device is not None:
            arr = arr.to(device)
        q, s = quantize_rows(arr.reshape(-1, arr.shape[-1]), dtype)
        return cls(q, s, dtype)

    # --- geometry / accounting ----------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.q.shape)

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        """Stored bytes: codes + scales (the fp32 equivalent is 4x the
        code bytes)."""
        return int(self.q.numel() * self.q.element_size()
                   + self.scales.numel() * self.scales.element_size())

    # --- reads ---------------------------------------------------------
    def take(self, idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """The quantized row payload for ``idx``: (codes, scales)."""
        idx = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        return self.q[idx], self.scales[idx]

    def dense_rows(self, idx) -> torch.Tensor:
        q, s = self.take(idx)
        return dequantize_rows(q, s, self.dtype)

    def to_dense(self) -> torch.Tensor:
        return dequantize_rows(self.q, self.scales, self.dtype)

    # --- writes --------------------------------------------------------
    def set_rows(self, idx, vals) -> None:
        """Quantize-and-store fp32 rows at ``idx``, in place. Per-row
        scales: neighbours are untouched."""
        idx = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        q, s = quantize_rows(torch.as_tensor(vals).to(self.device),
                             self.dtype)
        self.q[idx] = q
        self.scales[idx] = s

    def set_all(self, arr) -> None:
        """Quantize and store a whole block (a full publish's slice), on
        this table's device."""
        arr = torch.as_tensor(arr).to(self.device)
        q, s = quantize_rows(arr.reshape(-1, arr.shape[-1]), self.dtype)
        self.q = q
        self.scales = s.to(torch.float32).contiguous()

    def copy(self) -> "QuantTable":
        return QuantTable(self.q.clone(), self.scales.clone(), self.dtype)

    # --- portable round trip -------------------------------------------
    def encoded(self) -> torch.Tensor:
        """Portable codes (fp8 bit patterns as uint8)."""
        return encode_q(self.q, self.dtype)

    @classmethod
    def from_encoded(cls, raw, scales, dtype: str) -> "QuantTable":
        q = decode_q(raw, dtype)
        return cls(q, torch.as_tensor(scales).to(q.device), dtype)
