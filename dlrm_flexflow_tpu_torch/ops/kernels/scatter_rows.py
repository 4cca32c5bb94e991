"""Touched-rows scatter updates: the Hopper kernels and their plain
versions.

Replaces the Pallas TPU kernels ``_scatter_unique_kernel``
(dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:289, the
read-modify-write ``scatter_add_rows``), its ``shard_map`` over the row
blocks of a table split across chips, ``sharded_scatter_add_packed``
(:584; here ``sharded_scatter_add_rows``: a rank's block, global ids, the
window test in the kernel), and ``_scatter_write_kernel
(:495, the write-only ``scatter_write_rows_packed``, and through
``scatter_write_tiles`` (:547) the weight and state-slab writes of the
stateful ``_stateful_update_tiles_packed``, ops/embedding.py:460: here
``stateful_update_rows``). The CUDA source,
``csrc/scatter_rows.cu``, states the kernels' bound (memory) and design
(the stable order by ranks or, from RADIX_MIN lookups, by a radix sort
in one thread-block cluster; then one owner per distinct row; no
atomics).

Both functions update ``table`` IN PLACE (the JAX kernels alias the
table to their output) and return it. Lookup ``j`` targets row
``ids[j]`` with update row ``upd[j // div]``; each update is scaled as
``scale * upd`` BEFORE duplicates are summed, in ascending lookup order.
A lookup whose row is negative is a pad slot and changes nothing, as
``@pl.when(row >= 0)`` skips it in the Pallas kernels; a row id >= the
table's rows raises ``ValueError`` (on the card that check waits for the
device, so callers whose ids are in range by construction, the ops that
wrap their ids, pass ``ids_in_range=True``):

- ``scatter_add_rows``:   table[row] = table[row] + sum
- ``sharded_scatter_add_rows``: block[row - lo] = block[row - lo] + sum,
  for the rows in [lo, lo + block rows); every other id changes nothing
- ``scatter_write_rows``: table[row] = fwd[j] + sum, fwd[j] being the row
  a lookup of that row read in the forward pass (all equal);
- ``stateful_update_rows``: the optimizer's row math (SGD with weight
  decay, momentum, nesterov; Adam) on each distinct row, from its summed
  RAW gradient (no scale), its weight (fwd[j] or the table row) and its
  state-slab rows; it writes the weight and every slab, and rows no
  lookup touched keep their weight and their state (lazy semantics).
  With ``lo`` the table and slabs are the window [lo, lo + rows) of a
  larger table, as for ``sharded_scatter_add_rows``: its plain version
  is ``stateful_update_rows_reference`` over ``window_ids(ids, lo,
  rows)``.
  ``row_update_reference`` is that row math in PyTorch, in the JAX
  optimizers' operation order; the dense optimizers run it too.

The pre-pass is the row-granular counterpart of the JAX
``_dedup_tile_updates`` (the port stores tables unpacked, so no lane
tiles): ``scatter_presort`` (one launch: below RADIX_MIN lookups the
rank kernel, n^2 compares; from it a radix sort of ``key_bits(rows)``-bit
keys by one cluster of RADIX_CLUSTER blocks, ``presort_cluster``; plain
version ``presort_reference``) for n <= BLOCK_SORT_MAX lookups, route
"block"; a stable ``torch.sort`` of int32 ids above it, route "sort"
(``scatter_route``). Both give the lookups in stable order of their row
ids and, for each row's first lookup, where its segment of that order
starts and how long it is. ``stateful_update_rows`` needs no pre-pass
up to FUSED_MAX lookups: route "fused" (``stateful_route``) is one
launch that finds each row's first lookup and sums its lookups by
scanning the ids itself. A CPU tensor takes the plain version; a CUDA
tensor launches the kernels or raises, never falling back.
``scatter_add_rows.launches``, ``scatter_write_rows.launches``,
``stateful_update_rows.launches`` and ``scatter_presort.launches`` count
kernel launches, ``.routes`` the update launches by route and the
pre-pass's by kernel ("rank", "radix").

The three updates take ``ok``, the anomaly sentinel's 0-d int32 flag on
the table's device, or None: where it is 0 nothing changes (the update
kernel returns before any store; the plain version returns at once).
The pre-pass still runs: it writes no parameter.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ff_scatter_block_sort_max": ((), _I),
    "ff_scatter_presort": (
        (_P, _I, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _P, _P, _P),
        _I),
    "ff_scatter_add_rows": (
        (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, ctypes.c_longlong,
         ctypes.c_longlong, _P, _P), _I),
    "ff_scatter_write_rows": (
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P, _P), _I),
    "ff_stateful_update_rows": (
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I)
        + (ctypes.c_float,) * 8 + (ctypes.c_longlong, _P, _P), _I),
    "ff_stateful_fused_max": ((), _I),
    "ff_stateful_update_fused": (
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I)
        + (ctypes.c_float,) * 8 + (ctypes.c_longlong, ctypes.c_longlong,
                                   _P, _P), _I),
}
# the pre-pass kernels' limit (kBlockSortMax in csrc/scatter_rows.cu): a
# block (rank) or one cluster's blocks (radix) hold every key, 8 bytes
# each, in shared memory
BLOCK_SORT_MAX = 16384
# keys one block of the radix pre-pass's cluster holds at most
# (kSliceMax in csrc/scatter_rows.cu)
SLICE_MAX = 2048
# the least lookup count the radix kernel takes (below it the rank kernel
# is faster) and its cluster's blocks: measured on an H100 with
# tools/presort_probe.py (PERF.md, section 6)
RADIX_MIN = 4608
RADIX_CLUSTER = 8
# row ids travel as 31-bit keys
MAX_ROWS = 2 ** 31
# the sort key of a pad slot (row < 0) in the plain pre-pass: above every
# real row, so pads sort last on both routes (the kernels key a pad, and
# an id outside the window, as 2^32 - 1 (rank) or the window's rows
# (radix))
PAD_KEY = 2 ** 32 - 1
PAD_KEY32 = 2 ** 31 - 1
# the one-launch stateful route's limit (kFusedMax in csrc/scatter_rows.cu):
# a block holds every lookup's int32 key in shared memory. Measured on an
# H100 (chip_smoke.py), it beat the rank pre-pass route at every n up to
# it; the radix pre-pass route beats it from about 8,192 lookups (PERF.md,
# section 6), which this limit does not follow yet
FUSED_MAX = 16384


def _segment_sums(ids, upd, scale, div):
    """(distinct sorted rows, first lookup of each, per-row sums): the pad
    slots (row < 0) masked out, a stable sort, then ``index_add_`` of the
    updates (times ``scale`` unless it is None) in sorted order — on the
    CPU a sequential loop, so each row's duplicates add in ascending
    lookup order, starting from 0."""
    real = torch.nonzero(ids >= 0).reshape(-1)
    sorted_ids, order = torch.sort(ids[real], stable=True)
    order = real[order]
    rows, inv, counts = torch.unique_consecutive(
        sorted_ids, return_inverse=True, return_counts=True)
    vals = upd[order // div]
    if scale is not None:
        vals = scale * vals
    sums = torch.zeros((rows.shape[0], upd.shape[1]), dtype=upd.dtype,
                       device=upd.device).index_add_(0, inv, vals)
    first = order[torch.cumsum(counts, 0) - counts]
    return rows, first, sums


def skipped(ok) -> bool:
    """Whether the sentinel's flag ``ok`` (None: no sentinel) says to
    change nothing: what the plain versions read (on the card, a wait for
    the device)."""
    return ok is not None and not bool(ok)


def check_ok(ok, dev):
    """Raise unless ``ok`` is None or a 0-d int32 tensor on ``dev``."""
    if ok is not None and (ok.dim() != 0 or ok.dtype != torch.int32
                           or ok.device != dev):
        raise ValueError(f"the sentinel's ok is a 0-d int32 tensor on "
                         f"{dev}, got {tuple(ok.shape)} {ok.dtype} on "
                         f"{ok.device}")


def scatter_add_rows_reference(table, ids, upd, scale=1.0, div=1, ok=None):
    """Plain PyTorch version of ``scatter_add_rows``."""
    if skipped(ok):
        return table
    rows, _, sums = _segment_sums(ids, upd, scale, div)
    table[rows] = table[rows] + sums
    return table


def window_ids(ids, lo: int, rows: int):
    """The ids of a block's window as the JAX wrapper masks them
    (embedding_kernel.py:621-632): id - lo for an id in [lo, lo + rows),
    -1 (a pad) for any other id and for a pad."""
    local = ids - lo
    return torch.where((ids >= 0) & (local >= 0) & (local < rows), local,
                       torch.full_like(local, -1))


def sharded_scatter_add_rows_reference(block, ids, upd, lo, scale=1.0,
                                       div=1, ok=None):
    """Plain PyTorch version of ``sharded_scatter_add_rows``."""
    return scatter_add_rows_reference(
        block, window_ids(ids, int(lo), block.shape[0]), upd, scale, div, ok)


def scatter_write_rows_reference(table, ids, upd, fwd, scale=1.0, div=1,
                                 ok=None):
    """Plain PyTorch version of ``scatter_write_rows``."""
    if skipped(ok):
        return table
    rows, first, sums = _segment_sums(ids, upd, scale, div)
    table[rows] = fwd[first] + sums
    return table


def slab_names(p) -> tuple:
    """The state slabs the row math of optimizer parameters ``p`` reads
    and writes: Adam's ("m", "v"), momentum SGD's ("v",), else none."""
    if p["kind"] == "adam":
        return ("m", "v")
    return ("v",) if p["momentum"] > 0.0 else ()


def sqrt_rn(x):
    """fp32 sqrt, correctly rounded, as XLA's and CUDA's are: PyTorch's
    vectorized CPU sqrt can be an ulp off (about 0.6 % of the values on
    an AVX-512 host), so on the CPU it is taken in float64 and rounded
    once, which is exact for a square root of an fp32 value."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


@torch.no_grad()
def kernel_hyperparams(p) -> tuple:
    """(adam, nesterov, wd, lr, momentum, b1, c1, b2, c2, eps): the row
    math's arguments of the kernels' C entries (row_math.cuh's
    OptParams) for optimizer parameters ``p``. The constants stay Python
    doubles (1 - beta computed in double first), which ctypes casts to
    fp32, as JAX's weak types round them."""
    if p["kind"] == "adam":
        return (1, 0, p["weight_decay"], 0.0, 0.0, p["beta1"],
                1.0 - p["beta1"], p["beta2"], 1.0 - p["beta2"],
                p["epsilon"])
    return (0, int(bool(p.get("nesterov", False))), p["weight_decay"],
            p["lr"], p["momentum"], 0.0, 0.0, 0.0, 0.0, 0.0)


def row_update_reference(w, g, slabs, p, alpha_t=None):
    """The optimizer's update of rows ``w`` by gradient rows ``g``, IN
    PLACE on ``w`` and the state ``slabs`` ({name: tensor shaped as w}),
    in the JAX optimizers' operation order, one rounding an operation
    (no fused multiply-add), the constants rounded to fp32 as JAX's
    weak-typed Python floats are. ``p`` (an optimizer's ``row_params()``):

    - "sgd" (lr, momentum, nesterov, weight_decay): gt = g + wd·w;
      v = m·v + gt; d = gt + m·v (nesterov) | v | gt (no momentum);
      w = w - lr·d;
    - "adam" (beta1, beta2, weight_decay, epsilon; ``alpha_t`` a 0-d
      fp32 tensor, alpha·sqrt(1 - beta2^t)/(1 - beta1^t)): gt as above;
      m = b1·m + (1 - b1)·gt; v = b2·v + ((1 - b2)·gt)·gt;
      w = w - (alpha_t·m) / (sqrt(v) + eps).

    The dense update's plain version runs it on whole parameters, the
    touched-rows update's on the gathered rows; the CUDA kernels repeat
    it with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn
    (csrc/row_math.cuh)."""
    wd = p["weight_decay"]
    gt = g + wd * w if wd > 0.0 else g
    if p["kind"] == "adam":
        b1, b2 = p["beta1"], p["beta2"]
        slabs["m"].mul_(b1).add_((1.0 - b1) * gt)
        sq = (1.0 - b2) * gt
        slabs["v"].mul_(b2).add_(sq.mul_(gt))
        den = sqrt_rn(slabs["v"]).add_(p["epsilon"])
        w.sub_((alpha_t * slabs["m"]).div_(den))
        return w
    m = p["momentum"]
    if m > 0.0:
        v = slabs["v"]
        v.mul_(m).add_(gt)
        d = gt + m * v if p["nesterov"] else v
    else:
        d = gt
    w.sub_(p["lr"] * d)
    return w


def stateful_update_rows_reference(table, ids, upd, fwd, slabs, p,
                                   alpha_t=None, div=1, ok=None):
    """Plain PyTorch version of ``stateful_update_rows``."""
    if skipped(ok):
        return table
    rows, first, sums = _segment_sums(ids, upd, None, div)
    w = fwd[first] if fwd is not None else table[rows]
    srows = {k: slabs[k][rows] for k in slab_names(p)}
    row_update_reference(w, sums, srows, p, alpha_t)
    table[rows] = w
    for k, v in srows.items():
        slabs[k][rows] = v
    return table


def scatter_route(n: int, rows: int) -> str:
    """The pre-pass for n lookups into a table of ``rows`` rows: "block"
    (the rank or the radix kernel, every key in shared memory) up to
    BLOCK_SORT_MAX lookups, else "sort" (``torch.sort`` of int32 ids).
    Raises when the row ids do not fit the kernels' 31-bit keys."""
    if rows >= MAX_ROWS:
        raise ValueError(f"scatter kernels take tables of fewer than 2^31 "
                         f"rows (31-bit row keys), got {rows}")
    return "block" if n <= BLOCK_SORT_MAX else "sort"


def stateful_route(n: int, rows: int) -> str:
    """The route of ``stateful_update_rows`` for n lookups into a table of
    ``rows`` rows: "fused" (one launch, no pre-pass) up to FUSED_MAX
    lookups, else ``scatter_route``'s. Raises as ``scatter_route``."""
    route = scatter_route(n, rows)
    return "fused" if n <= FUSED_MAX else route


def _segments(sorted_ids, order, pad=None):
    """seg (n, 2) int32 from ids sorted stably (``order`` their
    positions): for the first lookup j of each row, (its place in the
    order, the row's lookup count); (-1, 0) for the others and for the
    pad slots, ``pad`` (n,) bool in sorted order. Tensor ops that never
    wait for the device."""
    n = sorted_ids.shape[0]
    dev = sorted_ids.device
    heads = torch.ones(n, dtype=torch.bool, device=dev)
    heads[1:] = sorted_ids[1:] != sorted_ids[:-1]
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    if pad is not None:         # pads sort last and count for no row
        heads &= ~pad
        ones = (~pad).to(torch.int32)
    number = torch.cumsum(heads, 0) - 1
    counts = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, number.clamp(min=0), ones)
    place = torch.arange(n, dtype=torch.int32, device=dev)
    seg = torch.empty((n, 2), dtype=torch.int32, device=dev)
    seg[order.long()] = torch.stack(
        [torch.where(heads, place, -1),
         torch.where(heads, counts[number], 0)], 1)
    return seg


def key_bits(rows: int) -> int:
    """The bits of the pre-pass's keys over a window of ``rows`` rows:
    the window rows 0..rows - 1 and the pad key ``rows``, so the bit
    width of ``rows`` (22 for a 4M-row block, 23 for 8M rows, 32 for
    the 2^31 of a pre-pass without a table)."""
    return int(rows).bit_length()


def presort_cluster(n: int) -> int:
    """The pre-pass kernel for n lookups: 0, the rank kernel, below
    RADIX_MIN; else the blocks of the radix kernel's one cluster."""
    return 0 if n < RADIX_MIN else RADIX_CLUSTER


def presort_reference(ids: torch.Tensor, chunk: int = 1024):
    """Plain PyTorch version of ``scatter_presort`` over the ids as its
    window makes them (``window_ids``), ``chunk`` lookups at a time: the
    rank kernel's counts. A lookup's place in the stable order is the
    number of (row id, position) keys below its own; it is its row's
    first when none of those has its row, and then its segment is (that
    place, the number of lookups of its row). A pad slot (row < 0) is
    keyed as row ``PAD_KEY``, after every real row, and owns no segment.
    The keys being distinct, the order and the segments are unique: the
    radix kernel's sort gives the same. Returns order (n,) and seg (n, 2),
    int32."""
    n = ids.shape[0]
    pads = ids < 0
    ids = torch.where(pads, PAD_KEY, ids.long())
    pos = torch.arange(n, device=ids.device)
    seg = torch.empty((n, 2), dtype=torch.int32, device=ids.device)
    order = torch.empty(n, dtype=torch.int32, device=ids.device)
    for lo in range(0, n, chunk):
        mine, at = ids[lo:lo + chunk, None], pos[lo:lo + chunk, None]
        row = ids[None] == mine
        below = (ids[None] < mine) | (row & (pos[None] < at))
        rank = below.sum(1)
        first = ~(below & row).any(1) & ~pads[lo:lo + chunk]
        order[rank] = pos[lo:lo + chunk].to(torch.int32)
        seg[lo:lo + chunk, 0] = torch.where(first, rank, -1)
        seg[lo:lo + chunk, 1] = torch.where(first, row.sum(1), 0)
    return order, seg


def scatter_presort(ids: torch.Tensor, lo: int = 0, rows: int = None):
    """The pre-pass kernel over n <= BLOCK_SORT_MAX int64 ids, the rows
    of the window [lo, lo + rows) of a table (``rows`` None: every id in
    [0, 2^31)): (order, seg) as ``presort_reference(window_ids(ids, lo,
    rows))`` returns them, every pad and every id outside the window
    keyed last and owning no segment."""
    if ids.dim() != 1 or ids.dtype != torch.int64:
        raise ValueError(f"scatter_presort takes (n,) int64 ids, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    rows = MAX_ROWS if rows is None else int(rows)
    if int(lo) < 0 or not 0 <= rows <= MAX_ROWS:
        raise ValueError(f"scatter_presort: window [{lo}, {lo} + {rows}) "
                         f"is not within [0, 2^31) rows of a table")
    if ids.device.type == "cpu":
        return presort_reference(window_ids(ids, int(lo), rows))
    n = ids.shape[0]
    if n > BLOCK_SORT_MAX:
        raise ValueError(f"scatter_presort ranks at most {BLOCK_SORT_MAX} "
                         f"lookups, got {n}")
    ids = ids.contiguous()
    order = torch.empty(n, dtype=torch.int32, device=ids.device)
    seg = torch.empty((n, 2), dtype=torch.int32, device=ids.device)
    lib = build.load("scatter_rows", _SIGNATURES)
    cluster = presort_cluster(n)
    err = lib.ff_scatter_presort(ids.data_ptr(), n, int(lo), rows,
                                 key_bits(rows), cluster, order.data_ptr(),
                                 seg.data_ptr(), build.stream_of(ids))
    build.check(lib, err, "scatter_presort kernel")
    build.count_launch(scatter_presort, "radix" if cluster else "rank")
    return order, seg


def _check(table, ids, upd, fwd, div, ids_in_range):
    if table.dim() != 2 or ids.dim() != 1 or upd.dim() != 2:
        raise ValueError(f"scatter expects table (rows, d), ids (n,) and "
                         f"upd (n/div, d), got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(upd.shape)}")
    n, d = ids.shape[0], table.shape[1]
    if div < 1 or n % div or upd.shape != (n // div, d):
        raise ValueError(f"scatter: upd {tuple(upd.shape)} does not fit "
                         f"{n} lookups, div={div}, d={d}")
    if fwd is not None and fwd.shape != (n, d):
        raise ValueError(f"scatter: fwd {tuple(fwd.shape)} is not "
                         f"({n}, {d})")
    # a device-to-host wait on the card: callers whose ids are in range
    # by construction skip it
    if not ids_in_range and n and int(ids.max()) >= table.shape[0]:
        raise ValueError(f"scatter: row id {int(ids.max())} is past the "
                         f"table's {table.shape[0]} rows")


def _kernel_inputs(table, ids, upd, fwd, slabs=()):
    """Check what the update kernels take: (ids, upd, fwd), contiguous.
    Raises on any input the kernels do not take."""
    floats = (table, upd, *slabs) + (() if fwd is None else (fwd,))
    if any(t.dtype != torch.float32 for t in floats) \
            or ids.dtype != torch.int64:
        raise ValueError("scatter kernels take float32 table, upd, fwd and "
                         "slabs and int64 ids")
    if any(t.device != table.device for t in floats + (ids,)):
        raise ValueError("scatter inputs lie on different devices")
    d = table.shape[1]
    if d % 4 or any(not t.is_contiguous() or t.data_ptr() % 16
                    for t in (table, *slabs)):
        raise ValueError(f"scatter kernels need a contiguous, 16-byte "
                         f"aligned table and slabs with d % 4 == 0 (d={d})")
    upd = upd.contiguous()
    ids = ids.contiguous()
    fwd = None if fwd is None else fwd.contiguous()
    if any(t.data_ptr() % 16 for t in (upd,) + (() if fwd is None
                                                 else (fwd,))):
        raise ValueError("scatter kernels need 16-byte aligned upd and fwd")
    return ids, upd, fwd


def _presorted(table, ids, upd, fwd, slabs=(), lo=None):
    """``_kernel_inputs``, then the pre-pass: (route, ids, upd, fwd,
    order, seg); order is None when there are no lookups. With ``lo``
    the table is the block [lo, lo + rows) of a larger one and an id
    outside it counts as a pad."""
    n = ids.shape[0]
    route = scatter_route(n, table.shape[0])
    ids, upd, fwd = _kernel_inputs(table, ids, upd, fwd, slabs)
    if n == 0:
        return route, ids, upd, fwd, None, None
    if route == "block":
        order, seg = scatter_presort(ids, lo or 0, table.shape[0])
    else:
        local = ids if lo is None else window_ids(ids, lo, table.shape[0])
        pads = local < 0
        key = torch.where(pads, PAD_KEY32, local).to(torch.int32)
        sorted_ids, order = torch.sort(key, stable=True)
        seg = _segments(sorted_ids, order.to(torch.int32), pads[order])
        order = order.to(torch.int32)
    return route, ids, upd, fwd, order, seg


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(wrapper, table, ids, upd, fwd, scale, div, ok, lo=None):
    """The pre-pass, then one update launch: ``ff_scatter_write_rows``
    with ``fwd``, else ``ff_scatter_add_rows`` over the window [lo, lo +
    table rows) (``lo`` None: the whole table)."""
    route, ids, upd, fwd, order, seg = _presorted(table, ids, upd, fwd,
                                                  lo=lo)
    if order is None:
        return table
    args = (table.data_ptr(), ids.data_ptr(), order.data_ptr(),
            seg.data_ptr(), upd.data_ptr())
    common = (ids.shape[0], table.shape[1], int(div), float(scale))
    lib = build.load("scatter_rows", _SIGNATURES)
    if fwd is not None:
        entry = "ff_scatter_write_rows"
        err = lib.ff_scatter_write_rows(*args, fwd.data_ptr(), *common,
                                        _ptr(ok), build.stream_of(table))
    else:
        entry = "ff_scatter_add_rows"
        err = lib.ff_scatter_add_rows(*args, *common, lo or 0,
                                      table.shape[0], _ptr(ok),
                                      build.stream_of(table))
    build.check(lib, err, f"{entry} kernel ({route} pre-pass)")
    build.count_launch(wrapper, route)
    return table


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     upd: torch.Tensor, scale: float = 1.0,
                     div: int = 1, ids_in_range: bool = False, *,
                     ok=None) -> torch.Tensor:
    """In place: table[ids[j]] += scale * upd[j // div], duplicates summed
    first in lookup order. table (rows, d) fp32; ids (n,) int64 below
    rows, a negative id a pad that changes nothing; upd (n // div, d).
    ``ids_in_range``: the caller guarantees ids < rows, and the check
    (a wait for the device on the card) is skipped. ``ok``: the
    sentinel's flag (see the module's docstring)."""
    _check(table, ids, upd, None, div, ids_in_range)
    check_ok(ok, table.device)
    if table.device.type == "cpu":
        return scatter_add_rows_reference(table, ids, upd, scale, div, ok)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on cpu or cuda, not "
                         f"{table.device}")
    return _launch(scatter_add_rows, table, ids, upd, None, scale, div, ok)


def sharded_scatter_add_rows(block: torch.Tensor, ids: torch.Tensor,
                             upd: torch.Tensor, lo: int, scale: float = 1.0,
                             div: int = 1, *, ok=None) -> torch.Tensor:
    """In place, on one rank's block of a table split in row blocks:
    block[ids[j] - lo] += scale * upd[j // div] for each id in [lo, lo +
    block rows), duplicates summed first in lookup order; an id outside
    the window, or a pad (< 0), changes nothing. block (rows, d) fp32,
    the rows [lo, lo + rows) of the whole table; ids (n,) int64, rows of
    the whole table, replicated or not; upd (n // div, d). On the card:
    the pre-pass over the window, then ``ff_scatter_add_rows`` over it,
    which tests the window and shifts the id itself (no masked copy of
    the ids). ``ok``: the sentinel's flag."""
    _check(block, ids, upd, None, div, True)
    check_ok(ok, block.device)
    if block.device.type == "cpu":
        return sharded_scatter_add_rows_reference(block, ids, upd, lo, scale,
                                                  div, ok)
    if block.device.type != "cuda":
        raise ValueError(f"sharded_scatter_add_rows runs on cpu or cuda, "
                         f"not {block.device}")
    if int(lo) < 0:
        raise ValueError(f"sharded_scatter_add_rows: lo {lo} < 0")
    return _launch(sharded_scatter_add_rows, block, ids, upd, None, scale,
                   div, ok, lo=int(lo))


def scatter_write_rows(table: torch.Tensor, ids: torch.Tensor,
                       upd: torch.Tensor, fwd: torch.Tensor,
                       scale: float = 1.0, div: int = 1,
                       ids_in_range: bool = False, *,
                       ok=None) -> torch.Tensor:
    """In place, write-only: table[ids[j]] = fwd[j] + sum of scale *
    upd[j' // div] over the lookups j' of that row. fwd (n, d): the row
    lookup j read in the forward pass. Pads, ``ids_in_range`` and ``ok``
    as in ``scatter_add_rows``."""
    _check(table, ids, upd, fwd, div, ids_in_range)
    check_ok(ok, table.device)
    if table.device.type == "cpu":
        return scatter_write_rows_reference(table, ids, upd, fwd, scale, div,
                                            ok)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_write_rows runs on cpu or cuda, not "
                         f"{table.device}")
    return _launch(scatter_write_rows, table, ids, upd, fwd, scale, div, ok)


def stateful_update_rows(table: torch.Tensor, ids: torch.Tensor,
                         upd: torch.Tensor, fwd, slabs, opt_params,
                         alpha_t=None, div: int = 1,
                         ids_in_range: bool = False, *, lo=None,
                         ok=None) -> torch.Tensor:
    """In place, the stateful touched-rows update: for each distinct row
    of ``ids``, g = the sum of upd[j // div] over its lookups j in lookup
    order (the RAW gradient, no scale), w = fwd[j] (the row lookup j read
    in the forward pass) or, with ``fwd`` None, table[row]; then
    ``row_update_reference``'s math with ``opt_params`` (an optimizer's
    ``row_params()``) writes table[row] and the row of each state slab
    it names (``slabs``: {name: tensor shaped as table}). Adam reads
    ``alpha_t``, a 0-d fp32 tensor on the table's device, there (the
    step never comes back to the host). Pads, ``ids_in_range`` and ``ok``
    as in ``scatter_add_rows``; rows no lookup names keep weight and
    state. ``lo``: the table and the slabs are the rows [lo, lo + table
    rows) of a larger table (a rank's block), ``ids`` rows of that
    table; an id outside the window changes nothing, as a pad. On the
    card the kernels test the window and shift the id themselves (the
    "fused" route's one launch, or the pre-pass over the window and one
    launch), with no masked copy of the ids."""
    _check(table, ids, upd, fwd, div, ids_in_range or lo is not None)
    check_ok(ok, table.device)
    names = slab_names(opt_params)
    if set(names) - set(slabs):
        raise ValueError(f"stateful_update_rows: slabs {sorted(slabs)} "
                         f"lack {sorted(set(names) - set(slabs))}")
    if any(slabs[k].shape != table.shape for k in names):
        raise ValueError("stateful_update_rows: a slab is not shaped as "
                         "the table")
    adam = opt_params["kind"] == "adam"
    if adam and (alpha_t is None or alpha_t.dim() != 0
                 or alpha_t.dtype != torch.float32
                 or alpha_t.device != table.device):
        raise ValueError("stateful_update_rows: Adam takes alpha_t, a 0-d "
                         "float32 tensor on the table's device")
    if lo is not None and int(lo) < 0:
        raise ValueError(f"stateful_update_rows: lo {lo} < 0")
    if table.device.type == "cpu":
        if lo is not None:
            ids = window_ids(ids, int(lo), table.shape[0])
        return stateful_update_rows_reference(table, ids, upd, fwd, slabs,
                                              opt_params, alpha_t, div, ok)
    if table.device.type != "cuda":
        raise ValueError(f"stateful_update_rows runs on cpu or cuda, not "
                         f"{table.device}")
    fused = stateful_route(ids.shape[0], table.shape[0]) == "fused"
    return _stateful_kernels(table, ids, upd, fwd, slabs, opt_params,
                             alpha_t, div, fused, ok, lo)


def _stateful_kernels(table, ids, upd, fwd, slabs, opt_params, alpha_t,
                      div, fused, ok=None, lo=None):
    """The kernels of ``stateful_update_rows`` on checked CUDA inputs:
    with ``fused`` one launch (route "fused", n <= FUSED_MAX), else the
    pre-pass of ``_presorted`` and one launch after it; both over the
    window [lo, lo + table rows) (``lo`` None: the whole table)."""
    names = slab_names(opt_params)
    slab = [slabs[k] for k in names]
    if fused:
        route, order, seg = "fused", None, None
        ids, upd, fwd = _kernel_inputs(table, ids, upd, fwd, slab)
    else:
        route, ids, upd, fwd, order, seg = _presorted(table, ids, upd, fwd,
                                                      slab, lo=lo)
    n = ids.shape[0]
    if n == 0:
        return table
    adam, nesterov, *hp = kernel_hyperparams(opt_params)
    slab += [None] * (2 - len(slab))
    lib = build.load("scatter_rows", _SIGNATURES)
    common = (_ptr(slab[0]), _ptr(slab[1]),
              _ptr(alpha_t) if adam else None, n, table.shape[1], int(div),
              adam, nesterov, *(float(x) for x in hp))
    tail = (_ptr(ok), build.stream_of(table))
    lo = int(lo or 0)
    if fused:
        err = lib.ff_stateful_update_fused(
            table.data_ptr(), ids.data_ptr(), upd.data_ptr(), _ptr(fwd),
            *common, lo, table.shape[0], *tail)
    else:
        err = lib.ff_stateful_update_rows(
            table.data_ptr(), ids.data_ptr(), order.data_ptr(),
            seg.data_ptr(), upd.data_ptr(), _ptr(fwd), *common, lo, *tail)
    build.check(lib, err, f"stateful_update_rows kernel ({route} route)")
    build.count_launch(stateful_update_rows, route)
    return table


scatter_presort.launches = 0
scatter_presort.routes = {"rank": 0, "radix": 0}
scatter_add_rows.launches = 0
sharded_scatter_add_rows.launches = 0
scatter_write_rows.launches = 0
stateful_update_rows.launches = 0
scatter_add_rows.routes = {"block": 0, "sort": 0}
sharded_scatter_add_rows.routes = {"block": 0, "sort": 0}
scatter_write_rows.routes = {"block": 0, "sort": 0}
stateful_update_rows.routes = {"fused": 0, "block": 0, "sort": 0}


def segment_sum_rows(ids: torch.Tensor, upd: torch.Tensor, num_rows: int,
                     div: int = 1) -> torch.Tensor:
    """A zero (num_rows, d) table with every lookup's update row summed
    into its row in sorted order: the dense ``dtable`` of the bag and
    fused-interaction backwards (JAX's sorted ``segment_sum``), through
    ``scatter_add_rows`` — the kernel on the card. The ids are those a
    forward pass read rows of, so in range."""
    out = torch.zeros((num_rows, upd.shape[1]), dtype=upd.dtype,
                      device=upd.device)
    return scatter_add_rows(out, ids, upd, 1.0, div, ids_in_range=True)
