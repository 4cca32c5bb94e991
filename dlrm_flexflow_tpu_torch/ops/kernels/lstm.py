"""LSTM scans: the Hopper kernels, their plain versions and the VJP.

Replaces the Pallas TPU kernels ``_fwd_kernel`` and ``_bwd_kernel``
(dlrm_flexflow_tpu/ops/pallas/lstm_kernel.py:44 and :95) behind the JAX
``lstm_scan``. The CUDA source, ``csrc/lstm.cu``, states the kernels'
bound (the recurrent products, serial in time) and design.

Time-major, as the JAX kernels: ``xproj`` (T, b, 4h) fp32 is the input
projection ``x @ wx + bias`` hoisted by the caller, ``wh`` (h, 4h) the
recurrent weights in the compute dtype (fp32 or bf16), gate columns
i, f, g, o; the initial h and c are zero.

- ``lstm_fwd(xproj, wh, with_residuals)`` -> (ys, cs): the hidden states
  and, when a gradient will be taken, the cell states, (T, b, h) fp32.
  Two routes, chosen by shape (``fwd_route``) as the backward's:
  "resident" (bf16 wh, b <= 128, one block per group of units
  co-resident) keeps each block's 32 columns of wh in shared memory and
  runs a step's gate product on the bf16 tensor cores; "streaming" (fp32
  wh, or any other shape) re-reads wh from L2 every step.
- ``lstm_bwd(xproj, wh, ys, cs, dys)`` -> dzs (T, b, 4h) fp32: the gate
  cotangents [di, df, dg, do], the gates recomputed from ys and cs. Two
  routes, chosen by shape (``bwd_route``): "resident" (bf16 wh, b <= 128,
  one block per group of units co-resident) launches ``lstm_gates``, the
  gate pre-activations of every step at once, then the serial carry scan
  with each block's wh rows resident in shared memory; "streaming" (fp32
  wh, or any other shape) launches one kernel that recomputes the gates
  inside the serial loop.
- ``lstm_gates(xproj, wh, ys)`` -> gates (T, b, 4h) fp32:
  ``round(h_{t-1}) @ wh + xproj[t]`` for every t, h_{-1} = 0. Two
  routes, chosen by shape (``gates_route``): "wgmma" (h % 4 == 0, where
  TMA can describe ys) launches the persistent TMA + wgmma kernel;
  "mma" (any other h) the mma.sync kernel. ``route=`` forces one (the
  tests and chip_smoke.py's side-by-side timing).

Each takes a CPU tensor to its plain version (``lstm_fwd_reference``,
``lstm_bwd_reference``, ``lstm_gates_reference``) and launches its kernel
for a CUDA tensor, raising there if the kernel cannot be built, the grid
cannot be co-resident or the cooperative launch is refused: it never
falls back, and no route stands in for another. ``lstm_carry_reference``
is the plain serial phase given the gates: with ``lstm_gates_reference``
it composes to ``lstm_bwd_reference``. ``.launches`` on each wrapper
counts kernel launches; ``lstm_fwd.routes``, ``lstm_bwd.routes`` and
``lstm_gates.routes`` count them by route.

``lstm_scan(xproj, wh)`` is the JAX ``lstm_scan`` as an autograd
Function: the forward keeps cs only when a gradient is needed (as
``with_residuals=False`` skips it), the backward returns dxproj = dzs
and dwh = Σ_t h_{t-1}ᵀ dz_t, one fp32 matmul outside the kernel cast to
wh's dtype (``_vjp_bwd``, lstm_kernel.py:166-176). ``lstm_scan_reference``
is the same Function over the plain versions. ``grid_barrier`` times the
resident route's barriers alone; no path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ff_lstm_units": ((), _I),
    "ff_lstm_resident_max_b": ((), _I),
    "ff_lstm_resident_smem": ((_I,), ctypes.c_longlong),
    "ff_lstm_fwd_resident_smem": ((_I,), ctypes.c_longlong),
    "ff_lstm_capacity": ((_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I),
                          ctypes.POINTER(_I)), _I),
    "ff_lstm_fwd": ((_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "ff_lstm_fwd_resident": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "ff_lstm_bwd": ((_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
                    _I),
    "ff_lstm_gates": ((_P, _P, _P, _P, _I, _I, _I, _P), _I),
    "ff_lstm_gates_wgmma": ((_P, _P, _P, _P, _I, _I, _I, _P), _I),
    "ff_lstm_gates_route": ((_I,), _I),
    "ff_lstm_bwd_resident": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
                             _I),
    "ff_lstm_barrier": ((_I, _I, _P), _I),
}
# the resident routes' limits, as csrc/lstm.cu sets them: 8 units a
# block, at most 4 batch rows a thread of 32 row lanes, and the shared
# memory of the wh slice and of the partial products
UNITS = 8
RESIDENT_MAX_B = 128
SMEM_LIMIT = 232_448     # bytes a block may use on Hopper (227 KB)
KERNELS = {"fwd": 0, "bwd": 1, "resident": 2, "fwd_resident": 3}


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


def lstm_gates_reference(xproj, wh, ys):
    """Plain PyTorch version of ``lstm_gates``: the gate pre-activations
    of every step, ``xproj[t] + round(h_{t-1}) @ wh`` with h_{-1} = 0, as
    one product over the T·b rows."""
    T, b, h4 = xproj.shape
    hs_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    return xproj + _recurrent(hs_prev.reshape(T * b, h4 // 4),
                              wh).reshape(T, b, h4)


def lstm_carry_reference(gates, wh, cs, dys):
    """Plain PyTorch version of the backward's serial phase given the
    gate pre-activations: the reverse loop of ``lstm_bwd_reference``
    with the gates read, not recomputed."""
    T, b, h4 = gates.shape
    zeros = torch.zeros((b, h4 // 4), dtype=torch.float32,
                        device=gates.device)
    whT = wh.t()
    dh_c, dc_c = zeros, zeros
    dzs = [None] * T
    for t in reversed(range(T)):
        cprev = cs[t - 1] if t > 0 else zeros
        i, f, g, o, _ = _cell(gates[t], cprev)
        tanh_c = torch.tanh(cs[t])
        dh = dys[t] + dh_c
        dc = dc_c + dh * o * (1.0 - tanh_c * tanh_c)
        dz = torch.cat([dc * g * i * (1.0 - i), dc * cprev * f * (1.0 - f),
                        dc * i * (1.0 - g * g),
                        dh * tanh_c * o * (1.0 - o)], dim=1)
        dzs[t] = dz
        dh_c = _recurrent(dz, whT)
        dc_c = dc * f
    return torch.stack(dzs)


def resident_smem(h: int) -> int:
    """Bytes of dynamic shared memory the resident backward takes at
    hidden size h (``ff_lstm_resident_smem``): its 8 rows of wh (4h bf16
    padded to 16, plus 4 words a row) and the partial carries (8 tiles of
    16 x 8 fp32)."""
    kp = -(-4 * h // 16) * 16
    return UNITS * (kp // 2 + 4) * 4 + 8 * 16 * UNITS * 4


def fwd_resident_smem(h: int) -> int:
    """Bytes of dynamic shared memory the resident forward takes at
    hidden size h (``ff_lstm_fwd_resident_smem``): its 32 columns of wh
    (h bf16 padded to 16, plus 4 words a column) and the partial gate
    tiles (8 tiles of 16 rows of 32 + 8 fp32)."""
    kp = -(-h // 16) * 16
    return 4 * UNITS * (kp // 2 + 4) * 4 + 8 * 16 * (4 * UNITS + 8) * 4


def _route(b, h, wh_dtype, blocks, smem):
    if wh_dtype != torch.bfloat16 or b > RESIDENT_MAX_B or smem > SMEM_LIMIT:
        return "streaming"
    return "resident" if -(-h // UNITS) <= blocks else "streaming"


def fwd_route(b: int, h: int, wh_dtype, blocks: int) -> str:
    """The forward's route for a batch of b rows at hidden size h:
    "resident" when wh is bf16, b <= RESIDENT_MAX_B, the wh slice fits a
    block's shared memory and the ceil(h / UNITS) groups fit in
    ``blocks`` co-resident blocks (one each); else "streaming"."""
    return _route(b, h, wh_dtype, blocks, fwd_resident_smem(h))


def bwd_route(b: int, h: int, wh_dtype, blocks: int) -> str:
    """The backward's route, by the rule of ``fwd_route`` with the
    resident backward's shared memory."""
    return _route(b, h, wh_dtype, blocks, resident_smem(h))


def gates_route(h: int) -> str:
    """The gate phase's route at hidden size h (``ff_lstm_gates_route``):
    "wgmma" where TMA can describe ys, whose rows of h fp32 must lie a
    multiple of 16 bytes apart (h % 4 == 0); else "mma"."""
    return "wgmma" if h % 4 == 0 else "mma"


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


def capacity(kernel: str, wh_dtype, h: int = 0) -> int:
    """How many blocks of ``kernel`` ("fwd" and "bwd" for the streaming
    routes, "fwd_resident" and "resident" (the backward's) at hidden size
    h) the current card holds at once; raises when it cannot take a
    cooperative launch or holds none."""
    lib = _lib()
    per_sm, sms, coop = _I(0), _I(0), _I(0)
    err = lib.ff_lstm_capacity(KERNELS[kernel],
                               int(wh_dtype == torch.bfloat16), h,
                               ctypes.byref(per_sm), ctypes.byref(sms),
                               ctypes.byref(coop))
    build.check(lib, err, f"lstm {kernel} occupancy query")
    if not coop.value or per_sm.value < 1:
        raise RuntimeError(
            f"lstm {kernel} kernel cannot run: cooperative launch "
            f"{'supported' if coop.value else 'absent'}, {per_sm.value} "
            f"resident blocks per SM")
    return per_sm.value * sms.value


def _grid(h, kernel, wh_dtype, grid):
    """One block per group of hidden units, as many as can be resident;
    an explicit ``grid`` is launched as given (a grid the card cannot
    hold makes the launch fail, and the wrapper raise)."""
    if grid is not None:
        return int(grid)
    groups = -(-h // UNITS)
    return min(groups, capacity(kernel, wh_dtype))


def lstm_fwd(xproj: torch.Tensor, wh: torch.Tensor,
             with_residuals: bool = True, grid=None):
    """(ys, cs or None), each (T, b, h) fp32; see the module docstring.
    ``grid`` overrides the number of blocks (the tests use it): the route
    is chosen as if the card held that many, and the launch takes them as
    given."""
    T, b, h = _check(xproj, wh)
    if xproj.device.type == "cpu":
        return lstm_fwd_reference(xproj, wh, with_residuals)
    xproj, wh = xproj.contiguous(), wh.contiguous()
    ys = torch.empty((T, b, h), dtype=torch.float32, device=xproj.device)
    cs = torch.empty_like(ys) if with_residuals else None
    cs_ptr = cs.data_ptr() if cs is not None else None
    # the occupancy query only for a shape the resident kernel can take
    route = fwd_route(b, h, wh.dtype, 1 << 30)
    if route == "resident":
        route = fwd_route(b, h, wh.dtype, grid if grid is not None
                          else capacity("fwd_resident", wh.dtype, h))
    lib = _lib()
    stream = build.stream_of(xproj)
    if route == "resident":
        g = -(-h // UNITS) if grid is None else int(grid)
        ring = torch.zeros(2 * -(-b // 16) * 16 * (-(-h // 16) * 16),
                           dtype=torch.bfloat16, device=xproj.device)
        err = lib.ff_lstm_fwd_resident(xproj.data_ptr(), wh.data_ptr(),
                                       ys.data_ptr(), cs_ptr,
                                       ring.data_ptr(), T, b, h, g, stream)
    else:
        g = _grid(h, "fwd", wh.dtype, grid)
        cbuf = torch.empty((b, h), dtype=torch.float32, device=xproj.device)
        err = lib.ff_lstm_fwd(xproj.data_ptr(), wh.data_ptr(),
                              int(wh.dtype == torch.bfloat16), ys.data_ptr(),
                              cs_ptr, cbuf.data_ptr(), T, b, h, g, stream)
    build.check(lib, err, f"lstm_fwd kernel ({route}, {g} blocks)")
    build.count_launch(lstm_fwd, route)
    return ys, cs


def lstm_gates(xproj: torch.Tensor, wh: torch.Tensor, ys: torch.Tensor,
               route=None) -> torch.Tensor:
    """gates (T, b, 4h) fp32, the resident route's gate phase; wh bf16 on
    the card (both kernels multiply on the bf16 tensor cores). ``route``
    ("wgmma" or "mma") overrides ``gates_route(h)``: the tests and
    chip_smoke.py time both routes side by side; "wgmma" at an h it
    cannot take raises."""
    tbh = (xproj.shape[0], xproj.shape[1], wh.shape[0])
    T, b, h = _check(xproj, wh, (("ys", ys, tbh),))
    route = gates_route(h) if route is None else route
    if route not in lstm_gates.routes:
        raise ValueError(f"lstm_gates has no route {route!r}")
    if xproj.device.type == "cpu":
        return lstm_gates_reference(xproj, wh, ys)
    if wh.dtype != torch.bfloat16:
        raise ValueError("the lstm_gates kernel takes bf16 wh")
    xproj, wh, ys = xproj.contiguous(), wh.contiguous(), ys.contiguous()
    gates = torch.empty_like(xproj)
    lib = _lib()
    stream = build.stream_of(xproj)
    ptrs = (xproj.data_ptr(), wh.data_ptr(), ys.data_ptr(), gates.data_ptr())
    launch = lib.ff_lstm_gates_wgmma if route == "wgmma" \
        else lib.ff_lstm_gates
    err = launch(*ptrs, T, b, h, stream)
    build.check(lib, err, f"lstm_gates kernel ({route} route)")
    build.count_launch(lstm_gates, route)
    return gates


def lstm_bwd(xproj: torch.Tensor, wh: torch.Tensor, ys: torch.Tensor,
             cs: torch.Tensor, dys: torch.Tensor, grid=None):
    """dzs (T, b, 4h) fp32; see the module docstring. ``grid`` overrides
    the number of blocks (the tests use it): the route is chosen as if
    the card held that many, and the launch takes them as given."""
    tbh = (xproj.shape[0], xproj.shape[1], wh.shape[0])
    T, b, h = _check(xproj, wh, (("ys", ys, tbh), ("cs", cs, tbh),
                                 ("dys", dys, tbh)))
    if xproj.device.type == "cpu":
        return lstm_bwd_reference(xproj, wh, ys, cs, dys)
    xproj, wh = xproj.contiguous(), wh.contiguous()
    ys, cs, dys = ys.contiguous(), cs.contiguous(), dys.contiguous()
    dzs = torch.empty_like(xproj)
    # the occupancy query only for a shape the resident kernel can take:
    # its shared memory may exceed what a block is allowed
    route = bwd_route(b, h, wh.dtype, 1 << 30)
    if route == "resident":
        route = bwd_route(b, h, wh.dtype, grid if grid is not None
                          else capacity("resident", wh.dtype, h))
    lib = _lib()
    stream = build.stream_of(xproj)
    if route == "resident":
        g = -(-h // UNITS) if grid is None else int(grid)
        gates = lstm_gates(xproj, wh, ys)
        kp = -(-4 * h // 16) * 16
        ring = torch.zeros(2 * -(-b // 16) * 16 * kp, dtype=torch.bfloat16,
                           device=xproj.device)
        err = lib.ff_lstm_bwd_resident(gates.data_ptr(), wh.data_ptr(),
                                       cs.data_ptr(), dys.data_ptr(),
                                       dzs.data_ptr(), ring.data_ptr(), T,
                                       b, h, g, stream)
    else:
        g = _grid(h, "bwd", wh.dtype, grid)
        dcbuf = torch.empty((b, h), dtype=torch.float32, device=xproj.device)
        err = lib.ff_lstm_bwd(xproj.data_ptr(), wh.data_ptr(),
                              int(wh.dtype == torch.bfloat16), ys.data_ptr(),
                              cs.data_ptr(), dys.data_ptr(), dzs.data_ptr(),
                              dcbuf.data_ptr(), T, b, h, g, stream)
    build.check(lib, err, f"lstm_bwd kernel ({route}, {g} blocks)")
    build.count_launch(lstm_bwd, route)
    return dzs


def grid_barrier(steps: int, grid: int, device) -> None:
    """``steps`` grid-wide barriers over ``grid`` blocks of the resident
    kernel's size and nothing else, one cooperative launch on the current
    stream: what the resident route's serial phase costs with its work
    taken out. A measuring probe; no path calls it."""
    lib = _lib()
    err = lib.ff_lstm_barrier(int(steps), int(grid),
                              torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, err, f"lstm barrier probe ({grid} blocks)")


lstm_fwd.launches = 0
lstm_fwd.routes = {"resident": 0, "streaming": 0}
lstm_gates.launches = 0
lstm_gates.routes = {"wgmma": 0, "mma": 0}
lstm_bwd.launches = 0
lstm_bwd.routes = {"resident": 0, "streaming": 0}


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
