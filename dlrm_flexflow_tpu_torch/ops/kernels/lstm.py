"""LSTM scans: the Hopper kernels, their plain versions and the VJP.

Replaces the Pallas TPU kernels ``_fwd_kernel`` and ``_bwd_kernel``
(dlrm_flexflow_tpu/ops/pallas/lstm_kernel.py:44 and :95) behind the JAX
``lstm_scan``. The CUDA source, ``csrc/lstm.cu``, states the kernels'
bound (the recurrent products, serial in time) and design (one
cooperative launch per call with a grid-wide barrier between steps; a
block owns a group of hidden units and all four gate columns of each).

Time-major, as the JAX kernels: ``xproj`` (T, b, 4h) fp32 is the input
projection ``x @ wx + bias`` hoisted by the caller, ``wh`` (h, 4h) the
recurrent weights in the compute dtype (fp32 or bf16), gate columns
i, f, g, o; the initial h and c are zero.

- ``lstm_fwd(xproj, wh, with_residuals)`` -> (ys, cs): the hidden states
  and, when a gradient will be taken, the cell states, (T, b, h) fp32.
- ``lstm_bwd(xproj, wh, ys, cs, dys)`` -> dzs (T, b, 4h) fp32: the gate
  cotangents [di, df, dg, do], the gates recomputed from ys and cs.

Each takes a CPU tensor to its plain version (``lstm_fwd_reference``,
``lstm_bwd_reference``) and launches its kernel for a CUDA tensor,
raising there if the kernel cannot be built, the grid cannot be
co-resident or the cooperative launch is refused: it never falls back.
``lstm_fwd.launches`` and ``lstm_bwd.launches`` count kernel launches.

``lstm_scan(xproj, wh)`` is the JAX ``lstm_scan`` as an autograd
Function: the forward keeps cs only when a gradient is needed (as
``with_residuals=False`` skips it), the backward returns dxproj = dzs
and dwh = Σ_t h_{t-1}ᵀ dz_t, one fp32 matmul outside the kernel cast to
wh's dtype (``_vjp_bwd``, lstm_kernel.py:166-176). ``lstm_scan_reference``
is the same Function over the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ff_lstm_units": ((), _I),
    "ff_lstm_capacity": ((_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I),
                          ctypes.POINTER(_I)), _I),
    "ff_lstm_fwd": ((_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "ff_lstm_bwd": ((_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
                    _I),
}


def _cell(gates, cprev):
    """i, f, g, o and the new c from (b, 4h) pre-activations."""
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    return i, f, g, o, f * cprev + i * g


def _recurrent(v, wh):
    """v rounded to wh's dtype, times wh (or whᵀ), accumulated in fp32:
    JAX's dot(v.astype(wh.dtype), wh, preferred_element_type=f32)."""
    return v.to(wh.dtype).float() @ wh.float()


def lstm_fwd_reference(xproj, wh, with_residuals=True):
    """Plain PyTorch version of ``lstm_fwd``: a loop over time."""
    T, b, h4 = xproj.shape
    h = torch.zeros((b, h4 // 4), dtype=torch.float32, device=xproj.device)
    c = torch.zeros_like(h)
    ys, cs = [], []
    for t in range(T):
        _, _, _, o, c = _cell(xproj[t] + _recurrent(h, wh), c)
        h = o * torch.tanh(c)
        ys.append(h)
        cs.append(c)
    return torch.stack(ys), (torch.stack(cs) if with_residuals else None)


def lstm_bwd_reference(xproj, wh, ys, cs, dys):
    """Plain PyTorch version of ``lstm_bwd``: the reverse loop of the
    JAX ``_bwd_kernel``, line for line."""
    T, b, h4 = xproj.shape
    zeros = torch.zeros((b, h4 // 4), dtype=torch.float32,
                        device=xproj.device)
    whT = wh.t()
    dh_c, dc_c = zeros, zeros
    dzs = [None] * T
    for t in reversed(range(T)):
        hprev = ys[t - 1] if t > 0 else zeros
        cprev = cs[t - 1] if t > 0 else zeros
        i, f, g, o, _ = _cell(xproj[t] + _recurrent(hprev, wh), cprev)
        tanh_c = torch.tanh(cs[t])
        dh = dys[t] + dh_c
        dc = dc_c + dh * o * (1.0 - tanh_c * tanh_c)
        di = dc * g * i * (1.0 - i)
        df = dc * cprev * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        do = dh * tanh_c * o * (1.0 - o)
        dz = torch.cat([di, df, dg, do], dim=1)
        dzs[t] = dz
        dh_c = _recurrent(dz, whT)
        dc_c = dc * f
    return torch.stack(dzs)


def _check(xproj, wh, extra=()):
    if xproj.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"lstm expects xproj (T, b, 4h) and wh (h, 4h), "
                         f"got {tuple(xproj.shape)} and {tuple(wh.shape)}")
    T, b, h4 = xproj.shape
    h = wh.shape[0]
    if h4 != 4 * h or wh.shape[1] != 4 * h:
        raise ValueError(f"lstm: xproj {tuple(xproj.shape)} and wh "
                         f"{tuple(wh.shape)} disagree on 4h")
    if xproj.dtype != torch.float32 or wh.dtype not in (torch.float32,
                                                        torch.bfloat16):
        raise ValueError(f"lstm takes fp32 xproj and fp32 or bf16 wh, got "
                         f"{xproj.dtype} and {wh.dtype}")
    for name, t, shape in extra:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"lstm: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} float32")
    devs = {xproj.device, wh.device} | {t.device for _, t, _ in extra}
    if len(devs) != 1:
        raise ValueError(f"lstm inputs lie on different devices: {devs}")
    if xproj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm runs on cpu or cuda, not {xproj.device}")
    return T, b, h


def _lib():
    return build.load("lstm", _SIGNATURES)


def capacity(backward: bool, wh_dtype) -> int:
    """How many blocks of the kernel the current card holds at once;
    raises when it cannot take a cooperative launch or holds none."""
    lib = _lib()
    per_sm, sms, coop = _I(0), _I(0), _I(0)
    err = lib.ff_lstm_capacity(int(backward), int(wh_dtype == torch.bfloat16),
                               ctypes.byref(per_sm), ctypes.byref(sms),
                               ctypes.byref(coop))
    build.check(lib, err, "lstm occupancy query")
    if not coop.value or per_sm.value < 1:
        raise RuntimeError(
            f"lstm {'bwd' if backward else 'fwd'} kernel cannot run: "
            f"cooperative launch {'supported' if coop.value else 'absent'}, "
            f"{per_sm.value} resident blocks per SM")
    return per_sm.value * sms.value


def _grid(h, backward, wh_dtype, grid):
    """One block per group of hidden units, as many as can be resident;
    an explicit ``grid`` is launched as given (a grid the card cannot
    hold makes the launch fail, and the wrapper raise)."""
    if grid is not None:
        return int(grid)
    groups = -(-h // _lib().ff_lstm_units())
    return min(groups, capacity(backward, wh_dtype))


def lstm_fwd(xproj: torch.Tensor, wh: torch.Tensor,
             with_residuals: bool = True, grid=None):
    """(ys, cs or None), each (T, b, h) fp32; see the module docstring.
    ``grid`` overrides the number of blocks (the tests use it)."""
    T, b, h = _check(xproj, wh)
    if xproj.device.type == "cpu":
        return lstm_fwd_reference(xproj, wh, with_residuals)
    xproj, wh = xproj.contiguous(), wh.contiguous()
    ys = torch.empty((T, b, h), dtype=torch.float32, device=xproj.device)
    cs = torch.empty_like(ys) if with_residuals else None
    cbuf = torch.empty((b, h), dtype=torch.float32, device=xproj.device)
    g = _grid(h, False, wh.dtype, grid)
    lib = _lib()
    err = lib.ff_lstm_fwd(xproj.data_ptr(), wh.data_ptr(),
                          int(wh.dtype == torch.bfloat16), ys.data_ptr(),
                          cs.data_ptr() if cs is not None else None,
                          cbuf.data_ptr(), T, b, h, g,
                          build.stream_of(xproj))
    build.check(lib, err, f"lstm_fwd kernel ({g} blocks)")
    build.count_launch(lstm_fwd)
    return ys, cs


def lstm_bwd(xproj: torch.Tensor, wh: torch.Tensor, ys: torch.Tensor,
             cs: torch.Tensor, dys: torch.Tensor, grid=None):
    """dzs (T, b, 4h) fp32; see the module docstring."""
    tbh = (xproj.shape[0], xproj.shape[1], wh.shape[0])
    T, b, h = _check(xproj, wh, (("ys", ys, tbh), ("cs", cs, tbh),
                                 ("dys", dys, tbh)))
    if xproj.device.type == "cpu":
        return lstm_bwd_reference(xproj, wh, ys, cs, dys)
    xproj, wh = xproj.contiguous(), wh.contiguous()
    ys, cs, dys = ys.contiguous(), cs.contiguous(), dys.contiguous()
    dzs = torch.empty_like(xproj)
    dcbuf = torch.empty((b, h), dtype=torch.float32, device=xproj.device)
    g = _grid(h, True, wh.dtype, grid)
    lib = _lib()
    err = lib.ff_lstm_bwd(xproj.data_ptr(), wh.data_ptr(),
                          int(wh.dtype == torch.bfloat16), ys.data_ptr(),
                          cs.data_ptr(), dys.data_ptr(), dzs.data_ptr(),
                          dcbuf.data_ptr(), T, b, h, g,
                          build.stream_of(xproj))
    build.check(lib, err, f"lstm_bwd kernel ({g} blocks)")
    build.count_launch(lstm_bwd)
    return dzs


lstm_fwd.launches = 0
lstm_bwd.launches = 0


class _LSTMScan(torch.autograd.Function):
    """The custom VJP of the JAX ``lstm_scan`` over the kernels, or over
    their plain versions when ``plain``."""

    @staticmethod
    def forward(ctx, xproj, wh, plain):
        fwd = lstm_fwd_reference if plain else lstm_fwd
        need_grad = any(ctx.needs_input_grad[:2])
        ys, cs = fwd(xproj, wh, need_grad)
        if need_grad:
            ctx.save_for_backward(xproj, wh, ys, cs)
        ctx.plain = plain
        return ys

    @staticmethod
    def backward(ctx, dys):
        xproj, wh, ys, cs = ctx.saved_tensors
        bwd = lstm_bwd_reference if ctx.plain else lstm_bwd
        dzs = bwd(xproj, wh, ys, cs, dys.float().contiguous())
        T, b, h = ys.shape
        # dW is one stacked product over every step, outside the kernel
        hs_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
        dwh = hs_prev.reshape(T * b, h).t() @ dzs.reshape(T * b, 4 * h)
        return dzs, dwh.to(wh.dtype), None


def lstm_scan(xproj: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """ys (T, b, h) fp32 of the LSTM scan over ``xproj`` (T, b, 4h) with
    recurrent weights ``wh`` (h, 4h); differentiable in both."""
    return _LSTMScan.apply(xproj, wh, False)


def lstm_scan_reference(xproj: torch.Tensor,
                        wh: torch.Tensor) -> torch.Tensor:
    """``lstm_scan`` over the plain versions of both kernels."""
    return _LSTMScan.apply(xproj, wh, True)
