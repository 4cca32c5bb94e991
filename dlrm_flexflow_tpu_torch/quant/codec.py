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

The numpy half (``quantize_rows_np``, ``dequantize_rows_np``,
``fake_quant_np``, ``fake_quant_stochastic_np``) gives the JAX codec's
numpy functions' bits on host arrays (delta payloads, the serving cache,
the shard tier's layout, host-resident tables), the same
``RandomState`` the same draws; its fp8 codes are uint8 bit patterns.

``fake_quant`` and ``fake_quant_stochastic`` are the training step's
half, on tensors: the JAX codec's jnp functions, computed by the row
kernel ``ops.kernels.quant_rows.fake_quant_rows`` (its plain version on
a CPU tensor) over the last axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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
    # a tensor divisor: CUDA multiplies by the reciprocal of a scalar one
    scales = torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                         torch.zeros_like(amax))
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


# --- numpy half (the JAX codec's numpy functions) -----------------------
def quantize_rows_np(arr, dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """``quantize_rows`` on host arrays: (codes, scales) as numpy, int8
    codes or fp8 codes as uint8 bit patterns."""
    q, s = quantize_rows(torch.from_numpy(np.ascontiguousarray(
        arr, np.float32)), dtype)
    return encode_q(q, dtype).numpy(), s.numpy()


def dequantize_rows_np(q, scales, dtype: str) -> np.ndarray:
    """(codes, scales) -> fp32 rows as numpy (fp8 codes as bit
    patterns)."""
    return dequantize_rows(decode_q(torch.from_numpy(np.ascontiguousarray(
        q)), dtype), torch.from_numpy(np.asarray(scales, np.float32)),
        dtype).numpy()


def fake_quant_np(arr, dtype: str) -> np.ndarray:
    """Quantize-dequantize in one hop: the exact fp32 image of the stored
    representation. fp32 is the identity; bf16 a precision round trip
    with no scales."""
    if dtype == "fp32":
        return np.asarray(arr, np.float32)
    if dtype == "bf16":
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        return t.to(torch.bfloat16).to(torch.float32).numpy()
    q, s = quantize_rows_np(arr, dtype)
    return dequantize_rows_np(q, s, dtype)


def fake_quant_stochastic_np(arr, dtype: str,
                             rng: np.random.RandomState) -> np.ndarray:
    """Stochastic rounding of host-resident rows (the touched rows after
    a host scatter): ``floor(x / s + u)`` for int8 with u from ``rng``;
    the other dtypes round to nearest."""
    if dtype != "int8":
        return fake_quant_np(arr, dtype)
    arr = np.asarray(arr, np.float32)
    amax = np.max(np.abs(arr), axis=-1)
    scales = np.where(amax > 0, amax / _QMAX["int8"], 0.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)[..., None]
    u = rng.random_sample(arr.shape).astype(np.float32)
    q = np.clip(np.floor(arr / safe + u), -127, 127)
    return q * scales[..., None]


# --- tensor half (the training step's) ----------------------------------
def fake_quant(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """Quantize-dequantize (nearest) over the last axis: a new fp32
    tensor of x's shape; one kernel launch on the card."""
    x = x.to(torch.float32)
    if dtype == "fp32":
        return x
    from ..ops.kernels.quant_rows import fake_quant_rows
    out = x.contiguous().clone()
    if out.numel():
        fake_quant_rows(out.view(-1, out.shape[-1] if out.dim() else 1),
                        dtype, "nearest")
    return out


def fake_quant_stochastic(x: torch.Tensor, dtype: str,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Quantize-dequantize with stochastic rounding for int8 codes
    (``floor(x / s + u)``, unbiased); fp8 and bf16 round to nearest and
    fp32 is the identity, as in the JAX codec. The draws u come from
    exactly one of ``noise`` (fp32, x's shape) or ``generator`` (drawn
    by ``torch.rand`` on x's device). Returns a new fp32 tensor. (The
    training step calls ``fake_quant_rows`` in place, with its Philox
    draws.)"""
    if (generator is None) == (noise is None):
        raise ValueError("fake_quant_stochastic takes exactly one of "
                         "generator or noise")
    x = x.to(torch.float32)
    if dtype != "int8":
        return fake_quant(x, dtype)
    from ..ops.kernels.quant_rows import fake_quant_rows
    out = x.contiguous().clone()
    if not out.numel():
        return out
    d = out.shape[-1] if out.dim() else 1
    rows = out.view(-1, d)
    if generator is not None:
        noise = torch.rand(out.shape, generator=generator,
                           dtype=torch.float32, device=out.device)
    fake_quant_rows(rows, dtype, "stochastic",
                    u=noise.to(torch.float32).contiguous().view(-1, d))
    return out
