"""Touched-rows scatter updates: the Hopper kernels and their plain
versions.

Replaces the Pallas TPU kernels ``_scatter_unique_kernel``
(dlrm_flexflow_tpu/ops/pallas/embedding_kernel.py:289, the
read-modify-write ``scatter_add_rows``) and ``_scatter_write_kernel``
(:495, the write-only ``scatter_write_rows_packed``). The CUDA source,
``csrc/scatter_rows.cu``, states the kernels' bound (memory) and design
(one owner per distinct row, found from a stable sort; no atomics).

Both functions update ``table`` IN PLACE (the JAX kernels alias the
table to their output) and return it. Lookup ``j`` targets row
``ids[j]`` with update row ``upd[j // div]``; each update is scaled as
``scale * upd`` BEFORE duplicates are summed, in ascending lookup order:

- ``scatter_add_rows``:   table[row] = table[row] + sum
- ``scatter_write_rows``: table[row] = fwd[j] + sum, fwd[j] being the row
  a lookup of that row read in the forward pass (all equal).

The pre-pass is a stable ``torch.sort`` of the ids, the row-granular
counterpart of the JAX ``_dedup_tile_updates`` (the port stores tables
unpacked, so no lane tiles). A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises, never falling back.
``scatter_add_rows.launches`` and ``scatter_write_rows.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_SIGNATURES = {
    "ff_scatter_add_rows": (
        (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, _P),
        ctypes.c_int),
    "ff_scatter_write_rows": (
        (_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, _P),
        ctypes.c_int),
}


def _segment_sums(ids, upd, scale, div):
    """(distinct sorted rows, first lookup of each, per-row sums): a
    stable sort, then ``index_add_`` of the scaled updates in sorted
    order — on the CPU a sequential loop, so each row's duplicates add
    in ascending lookup order, starting from 0."""
    sorted_ids, order = torch.sort(ids, stable=True)
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


def _check(table, ids, upd, fwd, div):
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


def _launch(entry, table, ids, upd, fwd, scale, div):
    """Sort on the card, then one kernel launch; raises on any input the
    kernel does not take."""
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
    if n == 0:
        return table
    upd = upd.contiguous()
    sorted_ids, order = torch.sort(ids, stable=True)
    args = [table.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
            upd.data_ptr()]
    if fwd is not None:
        fwd = fwd.contiguous()
        args.append(fwd.data_ptr())
    if any(p % 16 for p in args[3:]):
        raise ValueError("scatter kernels need 16-byte aligned upd and fwd")
    lib = build.load("scatter_rows", _SIGNATURES)
    err = getattr(lib, entry)(*args, n, d, int(div), float(scale),
                              build.stream_of(table))
    build.check(lib, err, f"{entry} kernel")
    return table


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     upd: torch.Tensor, scale: float = 1.0,
                     div: int = 1) -> torch.Tensor:
    """In place: table[ids[j]] += scale * upd[j // div], duplicates summed
    first in lookup order. table (rows, d) fp32; ids (n,) int64 in
    [0, rows); upd (n // div, d)."""
    _check(table, ids, upd, None, div)
    if table.device.type == "cpu":
        return scatter_add_rows_reference(table, ids, upd, scale, div)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on cpu or cuda, not "
                         f"{table.device}")
    out = _launch("ff_scatter_add_rows", table, ids, upd, None, scale, div)
    build.count_launch(scatter_add_rows)
    return out


def scatter_write_rows(table: torch.Tensor, ids: torch.Tensor,
                       upd: torch.Tensor, fwd: torch.Tensor,
                       scale: float = 1.0, div: int = 1) -> torch.Tensor:
    """In place, write-only: table[ids[j]] = fwd[j] + sum of scale *
    upd[j' // div] over the lookups j' of that row. fwd (n, d): the row
    lookup j read in the forward pass."""
    _check(table, ids, upd, fwd, div)
    if table.device.type == "cpu":
        return scatter_write_rows_reference(table, ids, upd, fwd, scale, div)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_write_rows runs on cpu or cuda, not "
                         f"{table.device}")
    out = _launch("ff_scatter_write_rows", table, ids, upd, fwd, scale, div)
    build.count_launch(scatter_write_rows)
    return out


scatter_add_rows.launches = 0
scatter_write_rows.launches = 0


def segment_sum_rows(ids: torch.Tensor, upd: torch.Tensor, num_rows: int,
                     div: int = 1) -> torch.Tensor:
    """A zero (num_rows, d) table with every lookup's update row summed
    into its row in sorted order: the dense ``dtable`` of the bag and
    fused-interaction backwards (JAX's sorted ``segment_sum``), through
    ``scatter_add_rows`` — the kernel on the card."""
    out = torch.zeros((num_rows, upd.shape[1]), dtype=upd.dtype,
                      device=upd.device)
    return scatter_add_rows(out, ids, upd, 1.0, div)
