"""Row-wise fake quantization (quantize, then dequantize, in place): the
Hopper kernel and its plain version.

No Pallas kernel computes it in the JAX package: XLA fuses the codec's
``fake_quant`` / ``fake_quant_stochastic`` (dlrm_flexflow_tpu/quant/
codec.py:154, :176) into one pass over the table inside the jitted step,
where the stochastic-rounding rule re-quantizes every updated table
(dlrm_flexflow_tpu/core/model.py:1110, ``_requant_sr_params`` :1235).
Run eagerly, the same math is about ten elementwise launches, each
streaming the whole table; the CUDA source, ``csrc/quant_rows.cu``, reads
each row once and writes it once.

``fake_quant_rows(x, dtype, mode)`` works IN PLACE on an fp32 (rows, d)
tensor, with the JAX codec's arithmetic exactly:

- ``scale = amax / qmax`` per row as an IEEE division (qmax 127 for int8,
  448 for fp8 e4m3), 0 for an all-zero row, ``safe = scale or 1``;
- int8 "nearest": ``clip(rint(x / safe), -127, 127) * scale`` (half to
  even); int8 "stochastic": ``clip(floor(x / safe + u), -127, 127) *
  scale`` with u in [0, 1);
- fp8: ``clip(x / safe, -448, 448)`` cast to e4m3 (round to nearest
  even), times ``scale``; bf16: a round trip through bf16. Under
  "stochastic" both round to nearest, as the JAX codec does.

The stochastic mode draws u one of two ways. Given ``u`` (an fp32 tensor
shaped as x) the kernel reads it, so the card can be held bitwise to the
plain version fed the same u. Otherwise u comes from a counter-based
Philox4x32-10 keyed by (``seed``, the step, ``salt``) at counter (row +
``row0``, column // 4): the port's counterpart of the JAX step's
``fold_in(rng, 0x51 + 2i + j)``, deterministic per seed, and computed
bit for bit the same by ``philox_uniform`` here, so the plain version
takes the same draws on the CPU. Its bits are not JAX's threefry.

A table split by width over ranks holds some columns of every row, and
the row's scale is the |x| max of the WHOLE row, so it is rounded in two
passes: ``row_amax`` gives each piece row's |x| max, the caller takes
the max over the ranks holding the row's other columns, and
``fake_quant_rows_amax`` rounds the piece with that max's scale, its
Philox counters at the piece's columns ``col0 + c`` of the row (col0 % 4
== 0): the values and draws of the whole row at those columns, bitwise.

CPU tensors take the plain version; CUDA tensors launch the kernel
(``fake_quant_rows.launches`` counts the launches, ``.routes`` by
"nearest", "philox" and "noise"; ``row_amax.launches`` and
``fake_quant_rows_amax.launches``, ``.routes`` by "nearest" and
"philox", the two passes') or raise, never falling back. With ``ok``
(the sentinel's 0-d int32 flag on x's device) a step whose flag is 0
changes nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .scatter_rows import check_ok, skipped

DTYPES = ("int8", "fp8", "bf16")
MODES = ("nearest", "stochastic")
QMAX = {"int8": 127.0, "fp8": 448.0}
# csrc/quant_rows.cu's dtype codes (int8, fp8 as quant_rows.cuh's
# Storage enum; bf16 its own) and the widest row it takes
_DTYPE_CODE = {"int8": 1, "fp8": 2, "bf16": 3}
MAX_D = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_SIGNATURES = {
    "ff_fake_quant_rows": (
        (_P, ctypes.c_longlong, _I, _I, _I, ctypes.c_ulonglong, _U, _U, _U,
         _P, _P), _I),
    "ff_fake_quant_rows_noise": (
        (_P, _P, ctypes.c_longlong, _I, _P, _P), _I),
    "ff_row_amax": ((_P, ctypes.c_longlong, _I, _P, _P), _I),
    "ff_fake_quant_rows_amax": (
        (_P, _P, ctypes.c_longlong, _I, _I, _I, ctypes.c_ulonglong, _U, _U,
         _U, _U, _P, _P), _I),
}

# Philox4x32-10 (Salmon et al. 2011), as csrc/quant_rows.cu computes it
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
# rows of the plain version at a time (its int64 Philox temporaries)
_CHUNK = 1 << 15


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of m * b, b an int64 tensor of uint32
    values, without overflowing int64 (b split into 16-bit halves)."""
    t1 = (b & 0xFFFF) * m                   # < 2^48
    t2 = (b >> 16) * m                      # < 2^48
    s = (t2 & 0xFFFF) * 65536 + t1          # < 2^49
    return (t2 >> 16) + (s >> 32), s & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counters (int64 tensors of uint32 values,
    broadcastable) under the key (k0, k1): its four uint32 outputs."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_uniform(rows: int, d: int, seed: int, step: int, salt: int,
                   row0: int = 0, device=None, col0: int = 0
                   ) -> torch.Tensor:
    """The kernel's draws for a (rows, d) block: u[r, c] in [0, 1) from
    output c % 4 of Philox at counter (row0 + r, (col0 + c) // 4, step,
    salt) under the key (seed's low and high 32 bits), its top 24 bits
    times 2^-24 (exact in fp32); col0 % 4 == 0."""
    dev = torch.device(device) if device is not None else None
    n4 = -(-d // 4)
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None] + row0
    c = torch.arange(n4, dtype=torch.int64, device=dev)[None, :] \
        + col0 // 4
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    outs = philox4x32(r & _MASK32, c, zero + (step & _MASK32),
                      zero + (salt & _MASK32), seed & _MASK32,
                      (seed >> 32) & _MASK32)
    bits = torch.stack([o.expand(rows, n4) for o in outs], dim=-1)
    return ((bits >> 8).to(torch.float32) * 2.0 ** -24).reshape(
        rows, 4 * n4)[:, :d]


def _check(x, dtype, mode, u):
    if dtype not in DTYPES:
        raise ValueError(f"fake_quant_rows: dtype {dtype!r} is not one of "
                         f"{DTYPES}")
    if mode not in MODES:
        raise ValueError(f"fake_quant_rows: mode {mode!r} is not one of "
                         f"{MODES}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"fake_quant_rows works on an fp32 (rows, d) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if u is not None and (u.dtype != torch.float32 or u.shape != x.shape
                          or u.device != x.device):
        raise ValueError(f"fake_quant_rows: u must be fp32 shaped as x "
                         f"{tuple(x.shape)} on {x.device}, got {u.dtype} "
                         f"{tuple(u.shape)} on {u.device}")


def fake_quant_rows_reference(x: torch.Tensor, dtype: str,
                              mode: str = "nearest", u=None, seed: int = 0,
                              step: int = 0, salt: int = 0, row0: int = 0,
                              ok=None, amax=None, col0: int = 0
                              ) -> torch.Tensor:
    """Plain PyTorch version of ``fake_quant_rows``, in place, a block of
    rows at a time; every operation rounds on its own (the divisor a
    tensor, so CUDA does not turn the division into a product by the
    reciprocal). With ``amax`` (rows,) and ``col0`` the plain version of
    ``fake_quant_rows_amax``."""
    _check(x, dtype, mode, u)
    if skipped(ok) or x.numel() == 0:
        return x
    if dtype == "bf16":
        x.copy_(x.to(torch.bfloat16).to(torch.float32))
        return x
    stochastic = mode == "stochastic" and dtype == "int8"
    qmax = QMAX[dtype]
    rows, d = x.shape
    for lo in range(0, rows, _CHUNK):
        xc = x[lo:lo + _CHUNK]
        m = (xc.abs().amax(dim=1) if amax is None
             else amax[lo:lo + _CHUNK])
        scale = torch.where(m > 0, m / torch.full_like(m, qmax),
                            torch.zeros_like(m))
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        y = xc / safe[:, None]
        if dtype == "int8":
            if stochastic:
                uc = (u[lo:lo + _CHUNK] if u is not None else
                      philox_uniform(xc.shape[0], d, seed, step, salt,
                                     row0 + lo, device=x.device,
                                     col0=col0))
                q = torch.floor(y + uc)
            else:
                q = torch.round(y)
            q = torch.clamp(q, -127.0, 127.0)
        else:
            q = torch.clamp(y, -qmax, qmax).to(torch.float8_e4m3fn).to(
                torch.float32)
        xc.copy_(q * scale[:, None])
    return x


def fake_quant_rows(x: torch.Tensor, dtype: str, mode: str = "nearest",
                    u: Optional[torch.Tensor] = None, seed: int = 0,
                    step: int = 0, salt: int = 0, row0: int = 0,
                    ok=None) -> torch.Tensor:
    """Fake-quantize every row of the fp32 (rows, d) tensor ``x`` in
    place under ``dtype`` ("int8", "fp8", "bf16") and ``mode``
    ("nearest", "stochastic"); the stochastic draws from ``u`` when
    given, else from Philox keyed by (``seed``, ``step``, ``salt``) at
    rows offset by ``row0``; ``ok`` the sentinel's flag. Returns x.
    Raises on other dtypes or shapes, and on the card on a tensor that
    is not contiguous, a row wider than ``MAX_D`` or more than 2^32
    rows."""
    _check(x, dtype, mode, u)
    check_ok(ok, x.device)
    if x.device.type == "cpu":
        return fake_quant_rows_reference(x, dtype, mode, u, seed, step,
                                         salt, row0, ok)
    if x.device.type != "cuda":
        raise ValueError(f"fake_quant_rows runs on cpu or cuda, not "
                         f"{x.device}")
    rows, d = x.shape
    if not x.is_contiguous() or (u is not None and not u.is_contiguous()):
        raise ValueError("fake_quant_rows works in place on a contiguous "
                         "x (and a contiguous u)")
    if d > MAX_D or rows + row0 > 1 << 32:
        raise ValueError(f"fake_quant_rows takes rows of at most {MAX_D} "
                         f"values and 2^32 rows, got {tuple(x.shape)} at "
                         f"row {row0}")
    if x.numel() == 0:
        return x
    stochastic = mode == "stochastic" and dtype == "int8"
    okp = None if ok is None else ok.data_ptr()
    stream = build.stream_of(x)
    lib = build.load("quant_rows", _SIGNATURES)
    if stochastic and u is not None:
        err = lib.ff_fake_quant_rows_noise(x.data_ptr(), u.data_ptr(), rows,
                                           d, okp, stream)
        route = "noise"
    else:
        err = lib.ff_fake_quant_rows(
            x.data_ptr(), rows, d, _DTYPE_CODE[dtype], int(stochastic),
            seed & 0xFFFFFFFFFFFFFFFF, step & _MASK32, salt & _MASK32, row0,
            okp, stream)
        route = "philox" if stochastic else "nearest"
    build.check(lib, err, "fake_quant_rows kernel")
    build.count_launch(fake_quant_rows, route)
    return x


def row_amax_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``row_amax``."""
    return x.abs().amax(dim=1)


def _check_piece(x, col0):
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"a width piece is an fp32 (rows, d) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if col0 % 4:
        raise ValueError(f"a width piece starts at a column that is a "
                         f"multiple of 4 (the Philox counter's 4-value "
                         f"chunks), got col0={col0}")


def _cuda_piece(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if not x.is_contiguous() or x.shape[1] > MAX_D \
            or x.shape[0] > 1 << 32:
        raise ValueError(f"{what} takes a contiguous x of at most {MAX_D} "
                         f"values a row and 2^32 rows, got "
                         f"{tuple(x.shape)}")


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """Each row's |x| max (NaN-propagating) of the fp32 (rows, d) piece
    ``x``, as an fp32 (rows,) tensor: pass 1 of a width-split table's
    rounding (``fake_quant_rows_amax`` is pass 2). x is only read."""
    _check_piece(x, 0)
    if x.device.type == "cpu":
        return row_amax_reference(x)
    _cuda_piece(x, "row_amax")
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out.zero_()
    lib = build.load("quant_rows", _SIGNATURES)
    err = lib.ff_row_amax(x.data_ptr(), x.shape[0], x.shape[1],
                          out.data_ptr(), build.stream_of(x))
    build.check(lib, err, "row_amax kernel")
    build.count_launch(row_amax)
    return out


def fake_quant_rows_amax(x: torch.Tensor, amax: torch.Tensor, dtype: str,
                         mode: str = "nearest", seed: int = 0,
                         step: int = 0, salt: int = 0, row0: int = 0,
                         col0: int = 0, ok=None) -> torch.Tensor:
    """``fake_quant_rows`` of the piece ``x`` (rows, d), columns [col0,
    col0 + d) of rows whose |x| max is ``amax`` (rows,) fp32, in place:
    each row's scale from amax, the stochastic draws at the row's
    columns col0 + c (col0 % 4 == 0), so x becomes those columns of the
    whole row's ``fake_quant_rows``, bitwise. int8 and fp8 only: bf16
    rounds each value alone, so a piece of it takes ``fake_quant_rows``.
    Returns x."""
    _check(x, dtype, mode, None)
    _check_piece(x, col0)
    if dtype == "bf16":
        raise ValueError("fake_quant_rows_amax: bf16 has no row scale; "
                         "round a bf16 piece with fake_quant_rows")
    if amax.dtype != torch.float32 or amax.shape != (x.shape[0],) \
            or amax.device != x.device:
        raise ValueError(f"fake_quant_rows_amax: amax must be fp32 "
                         f"({x.shape[0]},) on {x.device}, got {amax.dtype} "
                         f"{tuple(amax.shape)} on {amax.device}")
    check_ok(ok, x.device)
    if x.device.type == "cpu":
        return fake_quant_rows_reference(x, dtype, mode, None, seed, step,
                                         salt, row0, ok, amax=amax,
                                         col0=col0)
    _cuda_piece(x, "fake_quant_rows_amax")
    if row0 + x.shape[0] > 1 << 32:
        raise ValueError(f"fake_quant_rows_amax: rows past 2^32 at row "
                         f"{row0}")
    if x.numel() == 0:
        return x
    stochastic = mode == "stochastic" and dtype == "int8"
    lib = build.load("quant_rows", _SIGNATURES)
    err = lib.ff_fake_quant_rows_amax(
        x.data_ptr(), amax.contiguous().data_ptr(), x.shape[0], x.shape[1],
        _DTYPE_CODE[dtype], int(stochastic), seed & 0xFFFFFFFFFFFFFFFF,
        step & _MASK32, salt & _MASK32, row0, col0,
        None if ok is None else ok.data_ptr(), build.stream_of(x))
    build.check(lib, err, "fake_quant_rows_amax kernel")
    build.count_launch(fake_quant_rows_amax,
                       "philox" if stochastic else "nearest")
    return x


fake_quant_rows.launches = 0
fake_quant_rows.routes = {"nearest": 0, "philox": 0, "noise": 0}
row_amax.launches = 0
fake_quant_rows_amax.launches = 0
fake_quant_rows_amax.routes = {"nearest": 0, "philox": 0}
