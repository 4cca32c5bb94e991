"""The port's touched-rows scatters and kernel backwards against the JAX
package.

The plain PyTorch versions of the two scatter kernels (what the port's
wrappers run for CPU tensors) must equal the Pallas TPU kernels, run in
interpret mode as the JAX package's own tests run them:
``scatter_add_rows_reference`` against ``scatter_add_rows``
(``_scatter_unique_kernel``) and ``scatter_write_rows_reference``
against ``scatter_write_rows_packed`` (``_scatter_write_kernel``), at
d=64, with duplicate ids and with ids sharing a packed 128-lane tile.
The check is BITWISE: both sides scale each update first, then sum a
row's duplicates in ascending lookup order starting from 0, then add
(or write over the forward row). The packed Pallas tiles only add +0.0
for the tile's other row, which changes no value here.

The pre-pass's plain version (``presort_reference``: each lookup's place
in the stable order counted as the number of (row id, position) keys
below its own) must give exactly ``torch.sort(stable=True)``'s order,
and each row's first lookup its segment (start in that order, lookup
count), on hypothesis-drawn ids with heavy duplicates; the segments the
torch.sort route derives above the kernel's limit must equal it.

Pad slots: a negative row id (-1, or -(rows + 1)) is skipped, as the
Pallas kernels' ``@pl.when(row >= 0)`` skips it. With pads among the
ids, at d=64 and d=128, the port's scatters change exactly the rows the
Pallas kernels change, bitwise; the pre-pass keys pads after every real
row and gives them no segment, on both routes; ids >= rows raise.

The backwards of the two ported kernels must match ``jax.vjp`` of the
JAX custom VJPs in interpret mode at d=128 (the Pallas forward's
width): the bag's dtable bitwise (the same sorted segment-sum), the
fused interaction's gradients to rtol/atol 1e-5 (its products and dots
sum in another fp32 order in XLA and in PyTorch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlrm_flexflow_tpu.ops.pallas.embedding_kernel import (
    embedding_bag as jax_embedding_bag, scatter_add_rows as jax_scatter_add,
    scatter_write_rows_packed as jax_scatter_write)
from dlrm_flexflow_tpu.ops.pallas.interaction_kernel import (
    fused_interaction as jax_fused)

from dlrm_flexflow_tpu_torch.ops.kernels.embedding_bag import (
    EmbeddingBagFunction)
from dlrm_flexflow_tpu_torch.ops.kernels.interaction import (
    FusedInteractionFunction)
from hypothesis import given, settings, strategies as st

from dlrm_flexflow_tpu_torch.ops.kernels import scatter_rows as sr
from dlrm_flexflow_tpu_torch.ops.kernels.scatter_rows import (
    scatter_add_rows, scatter_write_rows, segment_sum_rows)

ROWS, D, LR = 256, 64, 0.05


def _case(n, seed, tile_pairs=False):
    """A table, n lookups with duplicates (the first 8 ids equal) and,
    with ``tile_pairs``, ids 2k and 2k+1 that share one packed tile."""
    rng = np.random.RandomState(seed)
    table = rng.randn(ROWS, D).astype(np.float32)
    ids = rng.randint(0, ROWS, size=n)
    ids[:8] = ids[0]
    if tile_pairs:
        ids[8:14] = [10, 11, 10, 11, 11, 10]
    upd = rng.randn(n, D).astype(np.float32)
    return table, ids, upd


def _jax_scaled(upd):
    return np.asarray(-LR * jnp.asarray(upd))


@pytest.mark.parametrize("n,tile_pairs", [(64, False), (300, True),
                                          (1000, True)])
def test_add_rows_matches_pallas_rmw_kernel(n, tile_pairs):
    table, ids, upd = _case(n, n, tile_pairs)
    want = np.asarray(jax_scatter_add(
        jnp.asarray(table), jnp.asarray(ids, jnp.int32),
        jnp.asarray(_jax_scaled(upd)), interpret=True))
    got = scatter_add_rows(torch.from_numpy(table.copy()),
                           torch.from_numpy(ids.astype(np.int64)),
                           torch.from_numpy(upd), scale=-LR)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,tile_pairs", [(64, False), (300, True),
                                          (1000, True)])
def test_write_rows_matches_pallas_write_kernel(n, tile_pairs):
    table, ids, upd = _case(n, n + 1, tile_pairs)
    view = table.reshape(ROWS // 2, 2 * D)
    want = np.asarray(jax_scatter_write(
        jnp.asarray(view), jnp.asarray(ids, jnp.int32),
        jnp.asarray(_jax_scaled(upd)), jnp.asarray(view[ids // 2]), D,
        interpret=True)).reshape(ROWS, D)
    t = torch.from_numpy(table.copy())
    fwd = t[torch.from_numpy(ids)].clone()
    got = scatter_write_rows(t, torch.from_numpy(ids.astype(np.int64)),
                             torch.from_numpy(upd), fwd, scale=-LR)
    np.testing.assert_array_equal(got.numpy(), want)


def test_shared_update_rows_equal_repeated_updates():
    """div=bag reads lookup j's update from row j // bag: the same as
    repeating each row bag times."""
    table, ids, upd = _case(96, 5)
    bag = 3
    t1 = scatter_add_rows(torch.from_numpy(table.copy()),
                          torch.from_numpy(ids), torch.from_numpy(upd[::bag]),
                          scale=-LR, div=bag)
    t2 = scatter_add_rows(torch.from_numpy(table.copy()),
                          torch.from_numpy(ids),
                          torch.from_numpy(np.repeat(upd[::bag], bag, 0)),
                          scale=-LR)
    assert torch.equal(t1, t2)


def test_untouched_rows_stay_bitwise():
    table, ids, upd = _case(40, 6)
    t = torch.from_numpy(table.copy())
    scatter_write_rows(t, torch.from_numpy(ids), torch.from_numpy(upd),
                       t[torch.from_numpy(ids)].clone(), scale=-LR)
    untouched = np.setdiff1d(np.arange(ROWS), ids)
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])


def test_rejects_bad_shapes():
    t = torch.zeros(8, 4)
    ids = torch.zeros(6, dtype=torch.int64)
    with pytest.raises(ValueError, match="div"):
        scatter_add_rows(t, ids, torch.zeros(4, 4), div=2)
    with pytest.raises(ValueError, match="fwd"):
        scatter_write_rows(t, ids, torch.zeros(6, 4), torch.zeros(5, 4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        segment_sum_rows(ids.to("meta"), torch.zeros(6, 4, device="meta"), 8)


@pytest.mark.parametrize("aggr", ["sum", "avg"])
@pytest.mark.parametrize("batch,bag", [(16, 1), (13, 3)])
def test_bag_backward_matches_jax_vjp(aggr, batch, bag):
    rng = np.random.RandomState(7)
    table = rng.randn(200, 128).astype(np.float32)
    ids = rng.randint(0, 200, size=(batch, bag))
    ids[:4] = ids[0]
    g = rng.randn(batch, 128).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_embedding_bag(
        t, jnp.asarray(ids, jnp.int32), aggr, True), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_()
    out = EmbeddingBagFunction.apply(t, torch.from_numpy(ids), aggr)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("batch,bag", [(13, 1), (8, 2)])
def test_fused_interaction_backward_matches_jax_vjp(relu, batch, bag):
    T, rows, d, H = 4, 32, 128, 24
    P = (T + 1) * T // 2
    rng = np.random.RandomState(3)
    table = (0.5 * rng.randn(T * rows, d)).astype(np.float32)
    idx = np.stack([rng.randint(t * rows, (t + 1) * rows, size=(batch, bag))
                    for t in range(T)], axis=1)
    idx[:3, 0] = idx[0, 0]
    bottom = (0.5 * rng.randn(batch, d)).astype(np.float32)
    w = (rng.randn(d + P, H) / np.sqrt(d + P)).astype(np.float32)
    bias = (0.1 * rng.randn(H)).astype(np.float32)
    g = rng.randn(batch, H).astype(np.float32)

    jidx = jnp.asarray(idx, jnp.int32)
    _, vjp = jax.vjp(lambda tb, b, ww, bi: jax_fused(
        tb, jidx, b, ww, bi, relu, True), *(jnp.asarray(a) for a in
                                            (table, bottom, w, bias)))
    want = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(a).requires_grad_()
           for a in (table, bottom, w, bias)]
    out = FusedInteractionFunction.apply(ins[0], torch.from_numpy(idx),
                                         ins[1], ins[2], ins[3], relu)
    out.backward(torch.from_numpy(g))
    for name, t, ref in zip(("dtable", "dbottom", "dw", "db"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------
# the pre-pass


def _want_segments(ids):
    """(order, seg) from torch.sort(stable=True): seg[j] = (the place of
    row ids[j]'s first lookup in the order, the row's lookup count) when
    j is that first lookup, else (-1, 0)."""
    t = torch.as_tensor(ids, dtype=torch.int64)
    s, order = torch.sort(t, stable=True)
    rows, counts = torch.unique_consecutive(s, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    seg = torch.tensor([[-1, 0]] * len(ids), dtype=torch.int32)
    for r, c, at in zip(rows.tolist(), counts.tolist(), starts.tolist()):
        seg[int(order[at])] = torch.tensor([at, c])
    return order.to(torch.int32), seg


_IDS = st.one_of(
    st.lists(st.integers(0, 5), min_size=1, max_size=300),      # few rows
    st.lists(st.integers(0, 2 ** 31 - 1), min_size=1, max_size=60),
    st.builds(lambda n, v: [v] * n, st.integers(1, 200),         # all equal
              st.integers(0, 2 ** 31 - 1)))


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(ids=_IDS, chunk=st.sampled_from([1, 7, 1024]))
def test_presort_plain_matches_stable_torch_sort(ids, chunk):
    want_order, want_seg = _want_segments(ids)
    order, seg = sr.presort_reference(torch.tensor(ids, dtype=torch.int64),
                                      chunk=chunk)
    assert order.dtype == seg.dtype == torch.int32
    assert torch.equal(order, want_order)
    assert torch.equal(seg, want_seg)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(ids=_IDS)
def test_sort_route_segments_match_the_plain_pre_pass(ids):
    t = torch.tensor(ids, dtype=torch.int64)
    s, order = torch.sort(t.to(torch.int32), stable=True)
    seg = sr._segments(s, order.to(torch.int32))
    assert torch.equal(seg, sr.presort_reference(t)[1])


def test_presort_on_cpu_is_the_plain_version_and_counts_nothing():
    ids = torch.tensor([5, 1, 5, 0, 1, 5], dtype=torch.int64)
    before = sr.scatter_presort.launches
    for a, b in zip(sr.scatter_presort(ids), sr.presort_reference(ids)):
        assert torch.equal(a, b)
    assert sr.scatter_presort.launches == before
    with pytest.raises(ValueError, match="int64"):
        sr.scatter_presort(ids.to(torch.int32))


@pytest.mark.parametrize("n,rows,route", [
    (1, 10, "block"), (2048, 8_000_000, "block"), (2560, 65_536, "block"),
    (16384, 2 ** 31 - 1, "block"), (16385, 2 ** 31 - 1, "sort"),
    (1_000_000, 100, "sort")])
def test_scatter_route_by_lookups(n, rows, route):
    assert sr.scatter_route(n, rows) == route


@pytest.mark.parametrize("rows", [2 ** 31, 2 ** 40])
def test_scatter_refuses_tables_past_31_bit_rows(rows):
    with pytest.raises(ValueError, match="2\\^31"):
        sr.scatter_route(8, rows)


def test_scatter_on_cpu_counts_no_route():
    table, ids, upd = _case(64, 9)
    before = (dict(scatter_add_rows.routes), dict(scatter_write_rows.routes))
    t = torch.from_numpy(table.copy())
    scatter_add_rows(t, torch.from_numpy(ids), torch.from_numpy(upd))
    scatter_write_rows(t, torch.from_numpy(ids), torch.from_numpy(upd),
                       t[torch.from_numpy(ids)].clone())
    assert (scatter_add_rows.routes, scatter_write_rows.routes) == before


def _pad_case(d, seed):
    """A table of width d and 300 lookups with duplicates, a run of -1
    pads and -(rows + 1) pads among them (some between duplicates)."""
    rng = np.random.RandomState(seed)
    table = rng.randn(ROWS, d).astype(np.float32)
    # the last row is never looked up: an id of -1 that wrapped would
    # change it
    ids = rng.randint(0, ROWS - 1, size=300)
    ids[:8] = ids[0]
    ids[3] = -1
    ids[20:40] = -1
    ids[rng.choice(300, 25, replace=False)] = -(ROWS + 1)
    upd = rng.randn(300, d).astype(np.float32)
    return table, ids, upd


@pytest.mark.parametrize("d", [64, 128])
def test_add_rows_skips_pads_as_the_pallas_kernel(d):
    table, ids, upd = _pad_case(d, d)
    want = np.asarray(jax_scatter_add(
        jnp.asarray(table), jnp.asarray(ids, jnp.int32),
        jnp.asarray(_jax_scaled(upd)), interpret=True))
    got = scatter_add_rows(torch.from_numpy(table.copy()),
                           torch.from_numpy(ids.astype(np.int64)),
                           torch.from_numpy(upd), scale=-LR)
    np.testing.assert_array_equal(got.numpy(), want)
    changed = np.flatnonzero((got.numpy() != table).any(1))
    assert set(changed) <= set(ids[ids >= 0]) and ROWS - 1 not in changed


@pytest.mark.parametrize("d", [64, 128])
def test_write_rows_skips_pads_as_the_pallas_kernel(d):
    table, ids, upd = _pad_case(d, d + 1)
    per = 128 // d
    view = table.reshape(ROWS // per, 128)
    want = np.asarray(jax_scatter_write(
        jnp.asarray(view), jnp.asarray(ids, jnp.int32),
        jnp.asarray(_jax_scaled(upd)),
        jnp.asarray(view[np.maximum(ids, 0) // per]), d,
        interpret=True)).reshape(ROWS, d)
    t = torch.from_numpy(table.copy())
    fwd = t[torch.from_numpy(np.maximum(ids, 0))].clone()
    got = scatter_write_rows(t, torch.from_numpy(ids.astype(np.int64)),
                             torch.from_numpy(upd), fwd, scale=-LR)
    np.testing.assert_array_equal(got.numpy(), want)
    changed = np.flatnonzero((got.numpy() != table).any(1))
    assert set(changed) <= set(ids[ids >= 0]) and ROWS - 1 not in changed


def test_only_pads_change_nothing():
    table, _, upd = _case(16, 11)
    t = torch.from_numpy(table.copy())
    ids = torch.tensor([-1] * 8 + [-(ROWS + 1)] * 8)
    scatter_add_rows(t, ids, torch.from_numpy(upd), scale=-LR)
    scatter_write_rows(t, ids, torch.from_numpy(upd), torch.zeros(16, D))
    assert torch.equal(t, torch.from_numpy(table))


@pytest.mark.parametrize("write", [False, True])
@pytest.mark.parametrize("bad", [ROWS, ROWS + 7, 2 ** 40])
def test_ids_past_the_table_raise(write, bad):
    table, ids, upd = _case(64, 12)
    ids[5] = bad
    t = torch.from_numpy(table.copy())
    args = (t, torch.from_numpy(ids), torch.from_numpy(upd))
    with pytest.raises(ValueError, match="past the table"):
        if write:
            scatter_write_rows(*args, torch.zeros(64, D))
        else:
            scatter_add_rows(*args)
    assert torch.equal(t, torch.from_numpy(table))


_PADDED_IDS = st.lists(st.one_of(st.integers(0, 5), st.integers(-9, -1),
                                 st.just(-(2 ** 40))),
                       min_size=1, max_size=200)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(ids=_PADDED_IDS, chunk=st.sampled_from([1, 7, 1024]))
def test_presort_puts_pads_last_without_a_segment(ids, chunk):
    """The pads' keys sort after every real row; the real lookups' order
    and segments are those of the ids without the pads."""
    t = torch.tensor(ids, dtype=torch.int64)
    order, seg = sr.presort_reference(t, chunk=chunk)
    real = torch.nonzero(t >= 0).reshape(-1)
    npad = len(ids) - real.numel()
    want = torch.cat([real[torch.sort(t[real], stable=True).indices],
                      torch.nonzero(t < 0).reshape(-1)])
    assert torch.equal(order.long(), want)
    assert bool((seg[t < 0] == torch.tensor([-1, 0], dtype=torch.int32))
                .all())
    if real.numel():
        sub = sr.presort_reference(t[real])[1]
        assert torch.equal(seg[real], sub)
    assert int((seg[:, 0] >= 0).sum()) == len(set(i for i in ids if i >= 0))
    assert npad == int((t < 0).sum())


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(ids=_PADDED_IDS)
def test_sort_route_keys_pads_as_the_pre_pass(ids):
    t = torch.tensor(ids, dtype=torch.int64)
    pads = t < 0
    key = torch.where(pads, sr.PAD_KEY32, t).to(torch.int32)
    s, order = torch.sort(key, stable=True)
    seg = sr._segments(s, order.to(torch.int32), pads[order])
    want_order, want_seg = sr.presort_reference(t)
    assert torch.equal(order.to(torch.int32), want_order)
    assert torch.equal(seg, want_seg)
