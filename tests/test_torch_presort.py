"""The pre-pass kernel's algorithm, step by step, against its oracle.

``csrc/scatter_rows.cu``'s ``scatter_radix_kernel`` sorts a window's
lookups by one thread-block cluster; it has no CPU mode. ``radix_model``
below repeats it in PyTorch, block by block and warp step by warp step:
the window keying (a pad and an id outside [lo, lo + rows) keyed
``rows``), the C slices of S = ceil(n / C) places, the passes of
``digit_bits``-bit digits over ``key_bits(rows)`` bits, each warp's
ranks in place order (its counters plus the lower lanes of its 32-key
step that share a digit, as ``__match_any_sync`` gives them), the
warps' offsets, the cluster's digit counts and the keys' new places,
then the heads, the block max-scans with each block's first place left
out, the blocks' ends (last head, first and last rows) resolving the
carry across blocks, and each run's last place writing its head's
segment. The model is held EXACTLY
to ``presort_reference(window_ids(ids, lo, rows))``, the plain version
the card's kernel is held to bitwise, on hypothesis-drawn windows (rows
at 2^k - 1, 2^k and 2^k + 1, lo > 0), ids with pads and ids below and
above the window, one hot row, every id outside, n from 1 to a few
thousand, C in {1, 8, 16} and 8- and 11-bit digits. The wrapper's host
arithmetic (``key_bits``, ``presort_cluster``) and its CPU path are held
here too.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from dlrm_flexflow_tpu_torch.ops.kernels import scatter_rows as sr

THREADS = 512                   # kSortThreads
WARPS = THREADS // 32


def _ranks(digits, counts):
    """One warp step: each active lane's rank (its warp's count of its
    digit so far plus the lower lanes of the step with its digit), then
    the counts as the group leaders leave them."""
    same = digits[:, None] == digits[None, :]
    below = torch.tril(same, -1).sum(1)
    rank = counts[digits] + below
    counts.index_add_(0, digits, torch.ones_like(digits))
    return rank


def radix_model(ids, lo, rows, clusters, digit_bits=8):
    """(order, seg) of the cluster radix pre-pass over int64 ``ids`` in
    the window [lo, lo + rows), run by ``clusters`` blocks."""
    n = ids.shape[0]
    S = -(-n // clusters)
    assert S <= sr.SLICE_MAX
    R = 1 << digit_bits
    local = ids - lo
    keys = torch.where((ids >= 0) & (local >= 0) & (local < rows), local,
                       torch.full_like(local, rows))
    places = torch.arange(n)
    pos = places.clone()            # the lookup at each place
    span = -(-S // THREADS) * 32          # a warp's places
    passes = max(1, -(-sr.key_bits(rows) // digit_bits))
    for p in range(passes):
        digit = (keys >> (p * digit_bits)) & (R - 1)
        counts = torch.zeros((clusters, WARPS, R), dtype=torch.int64)
        rank = torch.zeros(n, dtype=torch.int64)
        warp = torch.zeros(n, dtype=torch.int64)
        for r in range(clusters):
            p0, cnt = r * S, max(0, min(S, n - r * S))
            for w in range(WARPS):
                for step in range(span // 32):
                    at = w * span + step * 32 + torch.arange(32)
                    at = at[at < cnt] + p0
                    if not at.numel():
                        break
                    rank[at] = _ranks(digit[at], counts[r, w])
                    warp[at] = w
        hist = counts.sum(1)                               # (C, R)
        woff = torch.cumsum(counts, 1) - counts            # warp order
        total = hist.sum(0)
        lower_digits = torch.cumsum(total, 0) - total      # every block's
        lower_blocks = torch.cumsum(hist, 0) - hist        # lower blocks'
        block = places // S
        dest = (lower_digits[digit] + lower_blocks[block, digit]
                + woff[block, warp, digit] + rank)
        assert torch.equal(torch.sort(dest).values, places)
        new_keys, new_pos = torch.empty_like(keys), torch.empty_like(pos)
        new_keys[dest], new_pos[dest] = keys, pos
        keys, pos = new_keys, new_pos
    # heads, runs and segments: thread t of block r holds the places
    # r S + [t per, (t + 1) per); a block's first place stays out of its
    # scan and is resolved, after the barrier, from every block's ends
    per = -(-S // THREADS)
    differs = torch.cat([torch.tensor([True]), keys[1:] != keys[:-1]])
    head = (keys != rows) & differs
    start = torch.empty(n, dtype=torch.int64)
    ends = []
    for r in range(clusters):
        p0, cnt = r * S, max(0, min(S, n - r * S))
        if not cnt:
            ends.append(None)
            continue
        mine = torch.full((THREADS * per,), -1, dtype=torch.int64)
        mine[1:cnt] = torch.where(head[p0 + 1:p0 + cnt],
                                  places[p0 + 1:p0 + cnt], -1)
        by_thread = mine.reshape(THREADS, per)
        last = by_thread.max(1).values
        before = torch.cat([torch.tensor([-1]),
                            torch.cummax(last, 0).values[:-1]])
        run = torch.maximum(before[:, None],
                            torch.cummax(by_thread, 1).values)
        start[p0:p0 + cnt] = run.reshape(-1)[:cnt]
        block_last = int(last.max())
        ends.append({"last_place": block_last,
                     "last_lookup": int(pos[block_last])
                     if block_last >= 0 else -1,
                     "first_lookup": int(pos[p0]),
                     "first_row": int(keys[p0]),
                     "last_row": int(keys[p0 + cnt - 1])})
    lookup = pos.clone()                # the head lookup a tail reads
    for r in range(clusters):
        p0, cnt = r * S, max(0, min(S, n - r * S))
        if not cnt:
            continue
        carry, carry_lookup = -1, -1
        for c in range(r, -1, -1):
            e = ends[c]
            if c < r and e["last_place"] >= 0:
                carry, carry_lookup = e["last_place"], e["last_lookup"]
                break
            if e["first_row"] != rows and (
                    c == 0 or e["first_row"] != ends[c - 1]["last_row"]):
                carry, carry_lookup = c * S, e["first_lookup"]
                break
        head[p0] = carry == p0
        start[p0:p0 + cnt] = torch.clamp(start[p0:p0 + cnt], min=carry)
        inside = start[p0:p0 + cnt] >= p0
        lookup[p0:p0 + cnt] = torch.where(
            inside, pos[start[p0:p0 + cnt].clamp(min=0)],
            torch.full((cnt,), carry_lookup))
    tail = (keys != rows) & torch.cat([keys[1:] != keys[:-1],
                                       torch.tensor([True])])
    order = pos.to(torch.int32)
    seg = torch.empty((n, 2), dtype=torch.int32)
    seg[pos[~head]] = torch.tensor([-1, 0], dtype=torch.int32)
    t = torch.nonzero(tail).reshape(-1)
    seg[lookup[t]] = torch.stack([start[t], t - start[t] + 1],
                                 1).to(torch.int32)
    return order, seg


def _want(ids, lo, rows):
    return sr.presort_reference(sr.window_ids(ids, lo, rows))


def _ids(kind, n, lo, rows, seed):
    """n ids of the window [lo, lo + rows): "spread" in it with some
    pads and ids outside, "hot" all one row, "outside" none in it,
    "mixed" a third each in it, outside and pads."""
    rng = np.random.RandomState(seed)
    inside = lo + rng.randint(0, max(rows, 1), size=n)
    outside = np.where(rng.rand(n) < 0.5,
                       lo - 1 - rng.randint(0, lo + 1, size=n),
                       lo + rows + rng.randint(0, 1000, size=n))
    pads = np.where(rng.rand(n) < 0.5, -1, -(2 ** 40))
    pick = rng.rand(n)
    if kind == "hot":
        ids = np.full(n, inside[0])
    elif kind == "outside":
        ids = np.where(pick < 0.7, outside, pads)
    elif kind == "mixed":
        ids = np.where(pick < 1 / 3, inside,
                       np.where(pick < 2 / 3, outside, pads))
    else:
        ids = np.where(pick < 0.9, inside, np.where(pick < 0.95, outside,
                                                    pads))
    if rows == 0 and kind in ("spread", "hot", "mixed"):
        ids = np.where(ids >= lo, lo, ids)       # no row to hit
    return torch.as_tensor(ids, dtype=torch.int64)


@st.composite
def _cases(draw):
    k = draw(st.integers(0, 24))
    rows = max(0, 2 ** k + draw(st.sampled_from([-1, 0, 1])))
    lo = draw(st.sampled_from([0, 1, 37, 4_000_000, 2 ** 31 - rows]))
    clusters = draw(st.sampled_from([1, 8, 16]))
    n = min(draw(st.integers(1, 3000)), clusters * sr.SLICE_MAX)
    kind = draw(st.sampled_from(["spread", "hot", "outside", "mixed"]))
    return (_ids(kind, n, lo, rows, draw(st.integers(0, 2 ** 31 - 1))),
            lo, rows, clusters, draw(st.sampled_from([8, 11])))


@settings(max_examples=120, deadline=None, derandomize=True, database=None)
@given(case=_cases())
def test_radix_model_matches_the_plain_pre_pass(case):
    ids, lo, rows, clusters, digit_bits = case
    order, seg = radix_model(ids, lo, rows, clusters, digit_bits)
    want_order, want_seg = _want(ids, lo, rows)
    assert torch.equal(order, want_order)
    assert torch.equal(seg, want_seg)


@pytest.mark.parametrize("n", [1, 2, 31, 33, 511, 513, 2048, 6656, 8192,
                               16384])
@pytest.mark.parametrize("kind", ["spread", "hot", "outside"])
def test_radix_model_at_the_wrappers_cluster(n, kind):
    """The cluster the wrapper launches for n (below RADIX_MIN, where the
    wrapper takes the rank kernel, the least cluster that holds n), on a
    rank's 4M-row block (22-bit keys), with 8-bit digits (the
    kernel's)."""
    lo, rows = 4_000_000, 4_000_000
    ids = _ids(kind, n, lo, rows, n)
    clusters = sr.presort_cluster(n) or -(-n // sr.SLICE_MAX)
    got = radix_model(ids, lo, rows, clusters)
    want = _want(ids, lo, rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("rows,bits", [
    (0, 0), (1, 1), (2, 2), (3, 2), (4, 3), (255, 8), (256, 9), (257, 9),
    (4_000_000, 22), (8_000_000, 23), (11_386_880, 24), (2 ** 31 - 1, 31),
    (2 ** 31, 32)])
def test_key_bits_hold_every_row_and_the_pad_key(rows, bits):
    assert sr.key_bits(rows) == bits
    assert rows < 2 ** bits and (bits == 0 or rows >= 2 ** (bits - 1))


@pytest.mark.parametrize("n", [1, 1024, 1025, 2048, 4095, 4096, 4607, 4608,
                               6656, 8192, 12000, 16383, 16384])
def test_presort_cluster_fits_the_kernel(n):
    """The rank kernel (0) below RADIX_MIN; above it a portable cluster
    (at most 8 blocks) whose blocks hold every key."""
    c = sr.presort_cluster(n)
    assert (c == 0) == (n < sr.RADIX_MIN)
    if c:
        assert c <= 8 and -(-n // c) <= sr.SLICE_MAX
    assert sr.RADIX_CLUSTER * sr.SLICE_MAX >= sr.BLOCK_SORT_MAX
    assert sr.BLOCK_SORT_MAX <= 8 * sr.SLICE_MAX


@pytest.mark.parametrize("lo,rows", [(0, None), (0, 100), (50, 64),
                                     (7, 0)])
def test_scatter_presort_on_cpu_is_the_windowed_plain_version(lo, rows):
    ids = torch.tensor([60, 5, 60, -1, 113, 50, 49, 5, 2 ** 31 + 3])
    before = sr.scatter_presort.launches, dict(sr.scatter_presort.routes)
    got = sr.scatter_presort(ids, lo, rows)
    want = _want(ids, lo, sr.MAX_ROWS if rows is None else rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (sr.scatter_presort.launches,
            sr.scatter_presort.routes) == before


@pytest.mark.parametrize("lo,rows", [(-1, 10), (0, -1), (0, 2 ** 31 + 1)])
def test_scatter_presort_refuses_a_window_off_the_keys(lo, rows):
    with pytest.raises(ValueError, match="window"):
        sr.scatter_presort(torch.tensor([1, 2]), lo, rows)
