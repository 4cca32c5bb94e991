"""The optimizer's dense update and the anomaly sentinel's gradient norm:
the Hopper kernels and their plain versions.

No Pallas kernel computes it in the JAX package: XLA fuses each
parameter's update there (dlrm_flexflow_tpu/core/optimizers.py:93-114
SGD, :167-185 Adam). Run eagerly, the same math is two to twelve
elementwise launches a tensor, each streaming whole tensors; the CUDA
source, ``csrc/dense_update.cu``, reads every element of a parameter,
its gradient and its state slabs once and writes the parameter and the
slabs once, for all the step's dense tensors in one launch. It states
the bound (memory) and the design (a host-side launch plan; the
descriptors passed by value; float4 spans where 16-byte aligned).

``dense_update(ws, gs, slabs, opt_params, alpha_t)`` updates IN PLACE
the weights ``ws``, from the gradients ``gs``, and the state ``slabs``
(one {name: tensor shaped as its weight} for each weight, the names of
``slab_names(opt_params)``), with the row math of
``row_update_reference``; its plain version ``dense_update_reference``
runs that function on each tensor in turn. CPU tensors take the plain
version; CUDA tensors launch the kernel (``dense_update.launches``
counts the launches: one for up to MAX_TENSORS tensors) or raise, never
falling back. With ``ok`` (the sentinel's 0-d int32 flag on the weights'
device) a step whose flag is 0 changes nothing: the kernel returns
before any store, and the plain version leaves its tensors as they are.

``grad_sumsq(gs, loss)`` is the sentinel's predicate, computed by XLA in
the JAX step (dlrm_flexflow_tpu/core/model.py:1120-1123): gsq, the fp32
sum of the squares of every gradient in ``gs``, its square root and ok =
isfinite(loss) & isfinite(sqrt(gsq)), as 0-d device tensors (ok int32).
On the card it is one launch over every gradient on ``dense_update``'s
launch plan (``grad_sumsq.launches``), deterministic to the bit; its
plain version ``grad_sumsq_reference`` sums each tensor's squares in
fp32 and adds the sums in list order. Across ranks the step calls it
twice: over each rank's own gradients into a slot of the buffer the
dense gradients are all-reduced in (``out``), then over the all-reduced
gradients adding that slot (``addend``); ``grad_sumsq.routes`` counts
the launches as "alone", "own" and "replicated".
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Sequence

import torch

from . import build
from . import scatter_rows

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ff_dense_update_max_tensors": ((), _I),
    "ff_dense_update_tile_vecs": ((), _I),
    "ff_dense_update_threads": ((), _I),
    "ff_dense_update_blocks_per_sm": ((_I, ctypes.POINTER(_I)), _I),
    "ff_dense_update": (
        (_P, _I, ctypes.c_longlong, _I, _P, _I, _I)
        + (ctypes.c_float,) * 8 + (_P, _P), _I),
    "ff_grad_sumsq_blocks_per_sm": ((ctypes.POINTER(_I),), _I),
    "ff_grad_sumsq": (
        (_P, _I, ctypes.c_longlong, _P, ctypes.c_longlong,
         ctypes.c_longlong, _I, _P, _P, _P, _P, _P, _P, _P), _I),
}
# csrc/dense_update.cu's kMaxTensors (descriptors a launch carries in its
# 4 KB of arguments), kThreads (elements a scalar tile) and kTileVecs
# (float4s a vector tile); a card test checks them against the library
MAX_TENSORS = 48
THREADS = 256
TILE_VECS = 1024


class PlanEntry(NamedTuple):
    """One tensor of a launch: ``index`` in the caller's list, ``n``
    elements, the float4 span [head, head + 4 * nvec), and ``tile0``,
    its first tile in the launch."""
    index: int
    head: int
    nvec: int
    n: int
    tile0: int


def vector_span(n: int, addrs: Sequence[int]):
    """(head, nvec): the span [head, head + 4 * nvec) of an n-element
    fp32 tensor where every address in ``addrs`` (its weight, gradient
    and slabs) is 16-byte aligned; (n, 0) when they are not all aligned
    at the same element."""
    if any(a % 4 for a in addrs):
        raise ValueError("dense_update takes fp32 tensors: an address is "
                         "not 4-byte aligned")
    offs = {a % 16 for a in addrs}
    if len(offs) != 1:
        return n, 0
    head = min(n, (16 - offs.pop()) % 16 // 4)
    return head, (n - head) // 4


def tensor_tiles(n: int, nvec: int) -> int:
    """The kernel's tiles for a tensor: its vector tiles, then scalar
    tiles for the n - 4 * nvec elements outside the float4 span."""
    return -(-nvec // TILE_VECS) + -(-(n - 4 * nvec) // THREADS)


def launch_plan(sizes: Sequence[int], addrs: Sequence[Sequence[int]],
                max_tensors: int = MAX_TENSORS):
    """The launches for tensors of ``sizes`` elements whose weight,
    gradient and slabs lie at ``addrs``: a list of (entries, tiles), at
    most ``max_tensors`` entries (``PlanEntry``) a launch, in the order
    given, empty tensors left out. A pure function of its arguments."""
    launches: List[tuple] = []
    entries: List[PlanEntry] = []
    tiles = 0
    for i, (n, a) in enumerate(zip(sizes, addrs)):
        if n == 0:
            continue
        if len(entries) == max_tensors:
            launches.append((entries, tiles))
            entries, tiles = [], 0
        head, nvec = vector_span(n, a)
        entries.append(PlanEntry(i, head, nvec, n, tiles))
        tiles += tensor_tiles(n, nvec)
    if entries:
        launches.append((entries, tiles))
    return launches


class _Desc(ctypes.Structure):
    """csrc/dense_update.cu's TensorDesc."""
    _fields_ = [("w", _P), ("g", _P), ("s0", _P), ("s1", _P),
                ("head", ctypes.c_longlong), ("nvec", ctypes.c_longlong),
                ("n", ctypes.c_longlong), ("tile0", ctypes.c_longlong)]


def dense_update_reference(ws, gs, slabs, opt_params, alpha_t=None,
                           ok=None):
    """Plain PyTorch version of ``dense_update``: ``row_update_reference``
    on each tensor in turn, or nothing when ``ok`` is 0."""
    if scatter_rows.skipped(ok):
        return ws
    for w, g, s in zip(ws, gs, slabs):
        scatter_rows.row_update_reference(w, g, s, opt_params, alpha_t)
    return ws


def _check(ws, gs, slabs, names, adam, alpha_t):
    if not len(ws) == len(gs) == len(slabs):
        raise ValueError(f"dense_update: {len(ws)} weights, {len(gs)} "
                         f"gradients and {len(slabs)} slab sets")
    dev = ws[0].device if ws else None
    for w, g, s in zip(ws, gs, slabs):
        missing = set(names) - set(s)
        if missing:
            raise ValueError(f"dense_update: slabs {sorted(s)} lack "
                             f"{sorted(missing)}")
        ts = (w, g, *(s[k] for k in names))
        if any(t.dtype != torch.float32 for t in ts):
            raise ValueError("dense_update takes float32 weights, "
                             "gradients and slabs")
        if any(t.device != dev for t in ts):
            raise ValueError("dense_update: tensors lie on different "
                             "devices")
        if any(t.shape != w.shape for t in ts):
            raise ValueError(f"dense_update: a gradient or slab is not "
                             f"shaped as its weight {tuple(w.shape)}")
    if adam and ws and (alpha_t is None or alpha_t.dim() != 0
                        or alpha_t.dtype != torch.float32
                        or alpha_t.device != dev):
        raise ValueError("dense_update: Adam takes alpha_t, a 0-d float32 "
                         "tensor on the weights' device")


def blocks_per_sm(slabs: int) -> int:
    """The blocks of a launch with ``slabs`` state slabs that one SM of
    the current card holds at once (the kernel's grid is that many per
    SM)."""
    out = _I(0)
    lib = build.load("dense_update", _SIGNATURES)
    build.check(lib, lib.ff_dense_update_blocks_per_sm(slabs,
                                                       ctypes.byref(out)),
                "dense_update occupancy")
    return out.value


def dense_update(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                 slabs: Sequence[dict], opt_params, alpha_t=None, ok=None):
    """In place, one optimizer step on every weight of ``ws`` from its
    gradient in ``gs`` and its state in ``slabs`` ({name: tensor shaped
    as the weight} per weight, the names ``slab_names(opt_params)``
    gives), with ``row_update_reference``'s math; ``opt_params`` an
    optimizer's ``row_params()``; Adam reads ``alpha_t``, a 0-d fp32
    tensor on the weights' device; ``ok``, the sentinel's 0-d int32 flag
    there, or None: where it is 0 nothing changes. Raises on non-fp32
    tensors, mixed devices, a missing or misshapen slab, and (on the
    card) a weight or slab that is not contiguous. Returns ``ws``."""
    names = scatter_rows.slab_names(opt_params)
    adam = opt_params["kind"] == "adam"
    _check(ws, gs, slabs, names, adam, alpha_t)
    if ws:
        scatter_rows.check_ok(ok, ws[0].device)
    if not ws or ws[0].device.type == "cpu":
        return dense_update_reference(ws, gs, slabs, opt_params, alpha_t,
                                      ok)
    if ws[0].device.type != "cuda":
        raise ValueError(f"dense_update runs on cpu or cuda, not "
                         f"{ws[0].device}")
    if any(not t.is_contiguous() for w, s in zip(ws, slabs)
           for t in (w, *(s[k] for k in names))):
        raise ValueError("dense_update updates contiguous weights and "
                         "slabs in place")
    gs = [g.contiguous() for g in gs]
    ptrs = [(w.data_ptr(), g.data_ptr(), *(s[k].data_ptr() for k in names))
            for w, g, s in zip(ws, gs, slabs)]
    _, nesterov, *hp = scatter_rows.kernel_hyperparams(opt_params)
    at = alpha_t.data_ptr() if adam else None
    stream = build.stream_of(ws[0])
    lib = build.load("dense_update", _SIGNATURES)
    for entries, tiles in launch_plan([w.numel() for w in ws], ptrs):
        descs = (_Desc * len(entries))()
        for d, e in zip(descs, entries):
            p = ptrs[e.index] + (None,) * (4 - len(ptrs[e.index]))
            d.w, d.g, d.s0, d.s1 = p
            d.head, d.nvec, d.n, d.tile0 = e.head, e.nvec, e.n, e.tile0
        err = lib.ff_dense_update(descs, len(entries), tiles, len(names),
                                  at, int(adam), nesterov, *hp,
                                  None if ok is None else ok.data_ptr(),
                                  stream)
        build.check(lib, err, "dense_update kernel")
        build.count_launch(dense_update)
    return ws


dense_update.launches = 0


def grad_sumsq_reference(gs: Sequence[torch.Tensor], loss: torch.Tensor,
                         addend=None, out=None):
    """Plain PyTorch version of ``grad_sumsq``: each gradient's fp32 sum
    of squares, added in list order from 0, then ``addend``; (gsq, norm,
    ok), gsq also copied into ``out``."""
    gsq = torch.zeros((), dtype=torch.float32, device=loss.device)
    for g in gs:
        g = g.float()
        gsq = gsq + torch.sum(g * g)
    if addend is not None:
        gsq = gsq + addend.reshape(()).float()
    if out is not None:
        out.view(-1)[0].copy_(gsq)
    norm = torch.sqrt(gsq)
    ok = (torch.isfinite(loss.float()) & torch.isfinite(norm)).to(
        torch.int32)
    return gsq, norm, ok


# per (device, stream): the uint32 counter the last block of a launch
# finds itself by and resets (a launch on another stream may overlap)
_counters: Dict[tuple, torch.Tensor] = {}
_counters_lock = threading.Lock()


def _counter(dev, stream) -> torch.Tensor:
    with _counters_lock:
        c = _counters.get((dev, stream))
        if c is None:
            c = _counters[(dev, stream)] = torch.zeros(
                1, dtype=torch.int32, device=dev)
        return c


def grad_sumsq(gs: Sequence[torch.Tensor], loss: torch.Tensor,
               addend=None, out=None):
    """The anomaly sentinel's predicate over a step's gradients ``gs`` and
    its 0-d ``loss``: (gsq, norm, ok), 0-d tensors on the loss's device —
    gsq the fp32 sum of every gradient's squares plus ``addend`` (a
    one-element fp32 tensor on the device, or None), norm its square
    root, ok int32, 1 when the loss and the norm are finite. ``out`` (a
    one-element fp32 tensor on the device, e.g. a slot of a buffer an
    all-reduce sums) receives gsq; it is then the returned gsq. Nothing
    waits for the device. Gradients that are not fp32 are read as fp32
    copies; raises when they, the addend or ``out`` lie on another
    device than the loss. Across ranks the sentinel calls it twice a
    step (``FFModel``): over each rank's own gradients into ``out``,
    then, after the all-reduce, over the replicated ones with that slot
    as ``addend``."""
    dev = loss.device
    if loss.dim() != 0:
        raise ValueError(f"grad_sumsq takes a 0-d loss, got "
                         f"{tuple(loss.shape)}")
    for t in (addend, out):
        if t is not None and (t.numel() != 1 or t.dtype != torch.float32):
            raise ValueError("grad_sumsq: the addend and out are one "
                             "fp32 element each")
    if any(g.device != dev for g in gs) or any(
            t is not None and t.device != dev for t in (addend, out)):
        raise ValueError("grad_sumsq: the gradients and the loss lie on "
                         "different devices")
    if dev.type == "cpu":
        return grad_sumsq_reference(gs, loss, addend, out)
    if dev.type != "cuda":
        raise ValueError(f"grad_sumsq runs on cpu or cuda, not {dev}")
    gs = [(g if g.dtype == torch.float32 else g.float()).contiguous()
          for g in gs]
    loss = loss if loss.dtype == torch.float32 else loss.float()
    plan = launch_plan([g.numel() for g in gs],
                       [(g.data_ptr(),) for g in gs])
    total = sum(tiles for _, tiles in plan)
    partials = torch.empty(max(total, 1), dtype=torch.float32, device=dev)
    res = torch.empty(3, dtype=torch.float32, device=dev)
    ok = res[2:].view(torch.int32)
    gsq = res[0:1] if out is None else out.view(-1)
    route = ("replicated" if addend is not None
             else "own" if out is not None else "alone")
    stream = build.stream_of(loss)
    counter = _counter(dev, stream)
    lib = build.load("dense_update", _SIGNATURES)
    base = 0
    for k, (entries, tiles) in enumerate(plan or [([], 0)]):
        descs = (_Desc * max(len(entries), 1))()
        for d, e in zip(descs, entries):
            d.g = gs[e.index].data_ptr()
            d.head, d.nvec, d.n, d.tile0 = e.head, e.nvec, e.n, e.tile0
        err = lib.ff_grad_sumsq(descs, len(entries), tiles,
                                partials.data_ptr(), base, total,
                                int(k == max(len(plan), 1) - 1),
                                counter.data_ptr(), loss.data_ptr(),
                                None if addend is None
                                else addend.data_ptr(),
                                gsq.data_ptr(), res[1:2].data_ptr(),
                                ok.data_ptr(), stream)
        build.check(lib, err, "grad_sumsq kernel")
        build.count_launch(grad_sumsq, route)
        base += tiles
    return gsq.view(()), res[1], ok[0]


grad_sumsq.launches = 0
# "alone": one rank's one launch; across ranks "own" (a rank's own
# gradients into a slot) and "replicated" (the all-reduced ones, adding
# the slot)
grad_sumsq.routes = {"alone": 0, "own": 0, "replicated": 0}
