"""Touched-rows scatter updates: the Hopper kernels and their plain
versions.

Replaces the Pallas TPU kernels ``_scatter_unique_kernel``
(dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:289, the
read-modify-write ``scatter_add_rows``) and ``_scatter_write_kernel``
(:495, the write-only ``scatter_write_rows_packed``). The CUDA source,
``csrc/scatter_rows.cu``, states the kernels' bound (memory) and design
(each lookup's place in the stable order counted as a rank, then one
owner per distinct row; no atomics).

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
- ``scatter_write_rows``: table[row] = fwd[j] + sum, fwd[j] being the row
  a lookup of that row read in the forward pass (all equal).

The pre-pass is the row-granular counterpart of the JAX
``_dedup_tile_updates`` (the port stores tables unpacked, so no lane
tiles): ``scatter_presort`` (a kernel; plain version
``presort_reference``) for n <= BLOCK_SORT_MAX lookups, route "block";
a stable ``torch.sort`` of int32 ids above it, route "sort"
(``scatter_route``). Both give the lookups in stable order of their row
ids and, for each row's first lookup, where its segment of that order
starts and how long it is. A CPU tensor takes the plain version; a CUDA tensor
launches the kernels or raises, never falling back.
``scatter_add_rows.launches``, ``scatter_write_rows.launches`` and
``scatter_presort.launches`` count kernel launches, ``.routes`` the
update launches by route.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ff_scatter_block_sort_max": ((), _I),
    "ff_scatter_presort": ((_P, _I, _P, _P, _P), _I),
    "ff_scatter_add_rows": (
        (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P), _I),
    "ff_scatter_write_rows": (
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P), _I),
}
# the pre-pass kernel's limit (kBlockSortMax in csrc/scatter_rows.cu): a
# block holds every key, 8 bytes each, in its 227 KB of shared memory
BLOCK_SORT_MAX = 16384
# row ids travel as 31-bit keys
MAX_ROWS = 2 ** 31
# the sort key of a pad slot (row < 0): above every real row, so pads
# sort last on both routes (the rank kernel keys them as row 2^32 - 1)
PAD_KEY = 2 ** 32 - 1
PAD_KEY32 = 2 ** 31 - 1


def _segment_sums(ids, upd, scale, div):
    """(distinct sorted rows, first lookup of each, per-row sums): the pad
    slots (row < 0) masked out, a stable sort, then ``index_add_`` of the
    scaled updates in sorted order — on the CPU a sequential loop, so
    each row's duplicates add in ascending lookup order, starting from
    0."""
    real = torch.nonzero(ids >= 0).reshape(-1)
    sorted_ids, order = torch.sort(ids[real], stable=True)
    order = real[order]
    rows, inv, counts = torch.unique_consecutive(
        sorted_ids, return_inverse=True, return_counts=True)
    vals = scale * upd[order // div]
    sums = torch.zeros((rows.shape[0], upd.shape[1]), dtype=upd.dtype,
                       device=upd.device).index_add_(0, inv, vals)
    first = order[torch.cumsum(counts, 0) - counts]
    return rows, first, sums


def scatter_add_rows_reference(table, ids, upd, scale=1.0, div=1):
    """Plain PyTorch version of ``scatter_add_rows``."""
    rows, _, sums = _segment_sums(ids, upd, scale, div)
    table[rows] = table[rows] + sums
    return table


def scatter_write_rows_reference(table, ids, upd, fwd, scale=1.0, div=1):
    """Plain PyTorch version of ``scatter_write_rows``."""
    rows, first, sums = _segment_sums(ids, upd, scale, div)
    table[rows] = fwd[first] + sums
    return table


def scatter_route(n: int, rows: int) -> str:
    """The pre-pass for n lookups into a table of ``rows`` rows: "block"
    (the rank kernel, every key in one block's shared memory) up to
    BLOCK_SORT_MAX lookups, else "sort" (``torch.sort`` of int32 ids).
    Raises when the row ids do not fit the kernels' 31-bit keys."""
    if rows >= MAX_ROWS:
        raise ValueError(f"scatter kernels take tables of fewer than 2^31 "
                         f"rows (31-bit row keys), got {rows}")
    return "block" if n <= BLOCK_SORT_MAX else "sort"


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


def presort_reference(ids: torch.Tensor, chunk: int = 1024):
    """Plain PyTorch version of ``scatter_presort``: the kernel's counts,
    ``chunk`` lookups at a time. A lookup's place in the stable order is
    the number of (row id, position) keys below its own; it is its row's
    first when none of those has its row, and then its segment is (that
    place, the number of lookups of its row). A pad slot (row < 0) is
    keyed as row ``PAD_KEY``, after every real row, and owns no segment.
    Returns order (n,) and seg (n, 2), int32."""
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


def scatter_presort(ids: torch.Tensor):
    """The pre-pass kernel over n <= BLOCK_SORT_MAX int64 row ids below
    2^31, negative ones pads: (order, seg) as ``presort_reference``
    returns them."""
    if ids.dim() != 1 or ids.dtype != torch.int64:
        raise ValueError(f"scatter_presort takes (n,) int64 ids, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if ids.device.type == "cpu":
        return presort_reference(ids)
    n = ids.shape[0]
    if n > BLOCK_SORT_MAX:
        raise ValueError(f"scatter_presort ranks at most {BLOCK_SORT_MAX} "
                         f"lookups, got {n}")
    ids = ids.contiguous()
    order = torch.empty(n, dtype=torch.int32, device=ids.device)
    seg = torch.empty((n, 2), dtype=torch.int32, device=ids.device)
    lib = build.load("scatter_rows", _SIGNATURES)
    err = lib.ff_scatter_presort(ids.data_ptr(), n, order.data_ptr(),
                                 seg.data_ptr(), build.stream_of(ids))
    build.check(lib, err, "scatter_presort kernel")
    build.count_launch(scatter_presort)
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


def _launch(wrapper, entry, table, ids, upd, fwd, scale, div):
    """The pre-pass, then one update launch; raises on any input the
    kernels do not take."""
    floats = (table, upd) if fwd is None else (table, upd, fwd)
    if any(t.dtype != torch.float32 for t in floats) \
            or ids.dtype != torch.int64:
        raise ValueError("scatter kernels take float32 table, upd and fwd "
                         "and int64 ids")
    if any(t.device != table.device for t in floats + (ids,)):
        raise ValueError("scatter inputs lie on different devices")
    d = table.shape[1]
    if d % 4 or not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError(f"scatter kernels need a contiguous, 16-byte "
                         f"aligned table with d % 4 == 0 (d={d})")
    n = ids.shape[0]
    route = scatter_route(n, table.shape[0])
    if n == 0:
        return table
    upd = upd.contiguous()
    ids = ids.contiguous()
    if route == "block":
        order, seg = scatter_presort(ids)
    else:
        pads = ids < 0
        key = torch.where(pads, PAD_KEY32, ids).to(torch.int32)
        sorted_ids, order = torch.sort(key, stable=True)
        seg = _segments(sorted_ids, order.to(torch.int32), pads[order])
        order = order.to(torch.int32)
    args = [table.data_ptr(), ids.data_ptr(), order.data_ptr(),
            seg.data_ptr(), upd.data_ptr()]
    if fwd is not None:
        fwd = fwd.contiguous()
        args.append(fwd.data_ptr())
    if any(p % 16 for p in args[4:]):
        raise ValueError("scatter kernels need 16-byte aligned upd and fwd")
    lib = build.load("scatter_rows", _SIGNATURES)
    err = getattr(lib, entry)(*args, n, d, int(div), float(scale),
                              build.stream_of(table))
    build.check(lib, err, f"{entry} kernel ({route} pre-pass)")
    build.count_launch(wrapper, route)
    return table


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     upd: torch.Tensor, scale: float = 1.0,
                     div: int = 1, ids_in_range: bool = False
                     ) -> torch.Tensor:
    """In place: table[ids[j]] += scale * upd[j // div], duplicates summed
    first in lookup order. table (rows, d) fp32; ids (n,) int64 below
    rows, a negative id a pad that changes nothing; upd (n // div, d).
    ``ids_in_range``: the caller guarantees ids < rows, and the check
    (a wait for the device on the card) is skipped."""
    _check(table, ids, upd, None, div, ids_in_range)
    if table.device.type == "cpu":
        return scatter_add_rows_reference(table, ids, upd, scale, div)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on cpu or cuda, not "
                         f"{table.device}")
    return _launch(scatter_add_rows, "ff_scatter_add_rows", table, ids, upd,
                   None, scale, div)


def scatter_write_rows(table: torch.Tensor, ids: torch.Tensor,
                       upd: torch.Tensor, fwd: torch.Tensor,
                       scale: float = 1.0, div: int = 1,
                       ids_in_range: bool = False) -> torch.Tensor:
    """In place, write-only: table[ids[j]] = fwd[j] + sum of scale *
    upd[j' // div] over the lookups j' of that row. fwd (n, d): the row
    lookup j read in the forward pass. Pads and ``ids_in_range`` as in
    ``scatter_add_rows``."""
    _check(table, ids, upd, fwd, div, ids_in_range)
    if table.device.type == "cpu":
        return scatter_write_rows_reference(table, ids, upd, fwd, scale, div)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_write_rows runs on cpu or cuda, not "
                         f"{table.device}")
    return _launch(scatter_write_rows, "ff_scatter_write_rows", table, ids,
                   upd, fwd, scale, div)


scatter_presort.launches = 0
scatter_add_rows.launches = 0
scatter_write_rows.launches = 0
scatter_add_rows.routes = {"block": 0, "sort": 0}
scatter_write_rows.routes = {"block": 0, "sort": 0}


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
