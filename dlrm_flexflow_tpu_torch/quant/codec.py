"""Row-wise symmetric quantize/dequantize codecs, in torch (the
counterpart of ``dlrm_flexflow_tpu.quant.codec``'s numpy half).

The codes and scales equal the JAX package's ``quantize_rows_np`` bit
for bit, on the CPU and on the card:

- the LAST axis is the row; every leading axis multiplies into the row
  count. ``scale = amax / QMAX`` per row in fp32, zero-point 0, and an
  all-zero row gets scale 0 (codes 0, dequant exactly 0);
- int8 rounds ``x / scale`` with ``torch.round`` (half to even, as
  ``np.rint``), clips to +-127 and casts;
- fp8 is e4m3 through ``torch.float8_e4m3fn`` (the JAX codec reaches the
  same format through ``ml_dtypes``, which the port does not need):
  clip to +-448 first, then cast (round to nearest even).

``encode_q``/``decode_q`` carry fp8 codes as uint8 bit patterns, as the
JAX codec does for npz. Every function takes tensors (or array-likes,
turned into CPU tensors) and computes on the input's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# int8 symmetric uses +-127 (not -128: symmetry keeps dequantization
# zero-point-free); fp8 e4m3's largest finite is 448
_QMAX = {"int8": 127.0, "fp8": 448.0}


def _check_dtype(fn: str, dtype: str) -> None:
    if dtype not in _QMAX:
        raise ValueError(f"{fn}: {dtype!r} is not a quantized dtype "
                         f"(int8/fp8)")


def quantize_rows(arr, dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 rows -> (codes, scales). ``codes`` has ``arr``'s shape in the
    storage dtype (int8, or float8_e4m3fn); ``scales`` is fp32 with the
    leading (row) shape."""
    _check_dtype("quantize_rows", dtype)
    arr = torch.as_tensor(arr).to(torch.float32)
    qmax = _QMAX[dtype]
    amax = arr.abs().amax(dim=-1)
    scales = torch.where(amax > 0, amax / qmax, torch.zeros_like(amax))
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    scaled = arr / safe[..., None]
    if dtype == "int8":
        q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(scaled, -qmax, qmax).to(torch.float8_e4m3fn)
    return q, scales


def dequantize_rows(q, scales, dtype: str) -> torch.Tensor:
    """(codes, scales) -> fp32 rows."""
    _check_dtype("dequantize_rows", dtype)
    q = torch.as_tensor(q)
    return q.to(torch.float32) * torch.as_tensor(scales).to(
        torch.float32)[..., None]


def encode_q(q: torch.Tensor, dtype: str) -> torch.Tensor:
    """Codes -> a portable tensor (fp8 bit patterns as uint8)."""
    if dtype == "fp8":
        return q.contiguous().view(torch.uint8)
    return q.to(torch.int8).contiguous()


def decode_q(raw, dtype: str) -> torch.Tensor:
    """Inverse of :func:`encode_q`."""
    raw = torch.as_tensor(raw)
    if dtype == "fp8":
        return raw.to(torch.uint8).contiguous().view(torch.float8_e4m3fn)
    return raw.to(torch.int8).contiguous()


def validate_scales(key: str, scales, bound: Optional[float] = None
                    ) -> None:
    """Reject garbage scales before they are served: every scale must be
    finite, non-negative and, when the payload recorded its publish-time
    bound, at most a whisker above it. A corrupt scale is silent score
    garbage, so the load path refuses the payload with a reason."""
    s = torch.as_tensor(scales)
    if s.numel() == 0:
        return
    if not bool(torch.isfinite(s).all()):
        raise ValueError(
            f"quantized payload {key!r}: non-finite row scale(s) — "
            f"corrupt scales would serve garbage rows; payload rejected")
    lo = float(s.min())
    if lo < 0:
        raise ValueError(
            f"quantized payload {key!r}: negative row scale {lo:g} — "
            f"symmetric codes never store one; payload rejected")
    hi = float(s.max())
    if bound is not None and hi > float(bound) * 1.001:
        raise ValueError(
            f"quantized payload {key!r}: max row scale {hi:g} exceeds "
            f"the publish-time bound {float(bound):g} — scales corrupted "
            f"after publish; payload rejected")
