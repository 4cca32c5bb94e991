"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (the kernels have no CPU mode). The file imports
nothing of JAX, so it also runs on a machine without JAX, where the
repository's conftest (which imports the JAX package) is left out:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: the bag sums in fp32 in bag order on both sides (rtol, atol
1e-6); the interaction's dots and layer products sum in another fp32
order than torch's bmm and matmul (1e-5). The scatter kernels are held
BITWISE to their plain versions run on the CPU (the plain version on the
card would add duplicates with atomics, in no fixed order): both scale
first, then sum a row's duplicates in lookup order; both pre-pass
kernels (the rank kernel and the radix kernel, on clusters of 1 to 16
blocks) are held bitwise to the plain version and to
torch.sort(stable=True).
The stateful touched-rows kernel too, on both its routes, for every
optimizer, Adam included (the same alpha_t tensor, copied): both sum a
row's raw gradients in lookup order and run the row math one rounding an
operation in the same order, square roots and quotients correctly
rounded. The dense update kernel BITWISE to its plain version on the
card and on the CPU, for the same reason (the same row math). A stateful training step on the card against the CPU: weights
and state as the plain step, but under Adam each weight's update
within 1e-2 of its parameter's largest update, since Adam's normalised
step turns a gradient that differs only in its summation order into an
update of full size where the gradient is near zero.
A training step on
the card against the same step on the CPU: rtol 1e-5, atol 1e-7
(cuBLAS and the CPU's BLAS sum the layers' products in other orders).
The int8 MIPS top-k is held BITWISE to its plain version, scores, ids
and tie order (an exact integer dot and the same two fp32 products on
both sides), on its select route and its overflow route, and its
candidate counts exactly to the CPU mirror of the selection; the quantized bag bitwise at bag 1 (1e-6 above it, where
torch sums the bag in another order); the quantized interaction as the
fp32 one. The two-tower heads on the card against the CPU: rtol 1e-5,
atol 1e-6. The LSTM scan kernels against their plain versions on the
card: atol 1e-5 with fp32 wh (the recurrent products sum in another
order), 4e-3 with bf16 wh (the carried h or dz is rounded to bf16
before each product, and a sum near the midpoint of two bf16 values can
round the other way, moving that operand by one bf16 step); dwh within
1e-5 of its largest entry in fp32, two bf16 steps (2^-6) in bf16. An
NMT step on the card against the CPU: every update within 1e-3 of its
parameter's largest update, plus two fp32 steps of the parameter. The
anomaly sentinel's gradient norm (``grad_sumsq``) against its plain
version on the CPU: rtol 1e-5 (the fp32 sum of squares in another
order), the flag exactly for NaN and +-Inf, a rerun bitwise. The guarded
update entries: with ok = 0 every output bitwise as it was, with ok = 1
bitwise the unguarded call. A skip_step run on the card against the same
run on the CPU as the stateful step above; the poisoned step, bitwise
nothing. A delta installed on the card (``apply_delta``, plain and
staged on the side stream) BITWISE the CPU install (rows and arrays are
copied); deltas staged and installed through the engine while clients
keep its batcher busy give BITWISE the scores of a model that took them
quiesced (the same kernels at the same shapes). The row fake-quant
kernel BITWISE its plain version on the card, nearest for int8, fp8 and
bf16 and both stochastic entries (the caller's u, and Philox against the
plain version's ``philox_uniform``: the same IEEE operations, one
rounding each); its Philox codes floor or floor + 1 of x / s and the
mean of 2,048 draws within 6 standard errors of x / s. The row-sharded
exchange's owner side at a rank's shape of the full-width DLRM split over
2 ranks (8,192 lookups a rank, 2 peers, a 4M-row block): the canonical
combine of a received buffer (segment sums on the scatter kernel) and its
routed SGD, stateful and gradient updates BITWISE their plain versions on
the CPU, sentinel pads included; the owner's gather of received ids with
the sentinel clamped (the bag kernel at bag 1) BITWISE its plain version.
Tables split across ranks: kernel 4 at a Criteo-Kaggle row block's shape
(13,312 lookups, a 5.7M-row block, d = 16), the bag kernel's masked ids
(a negative id adds a zero row) and kernels 1 and 3 on a width slice of
a table (32 of 64 columns; 8 of 16 and of 32), each BITWISE its plain
version. Every optimizer on them: kernel 2's stateful entry over a
block's window (a Kaggle row block, the "cat" split's block of 4
tables, edge windows), on both routes, BITWISE its plain version over
the masked ids; the two passes of a width piece's rounding (the row's
|x| max, the rounding with the whole row's scale at the piece's
columns) BITWISE their plain versions and the whole rows' rounding at
those columns (NaN at the same places: a NaN's payload is the device's
own).
"""

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.ops.kernels import build
from dlrm_flexflow_tpu_torch.ops.kernels import dense_update as dense_mod
from dlrm_flexflow_tpu_torch.ops.kernels.embedding_bag import (
    embedding_bag, embedding_bag_quant, embedding_bag_quant_reference,
    embedding_bag_reference)
from dlrm_flexflow_tpu_torch.core.optimizers import (AdamOptimizer,
                                                     SGDOptimizer)
from dlrm_flexflow_tpu_torch.models.nmt import build_nmt
from dlrm_flexflow_tpu_torch.ops.kernels import lstm as lstm_mod
from dlrm_flexflow_tpu_torch.ops.kernels import scatter_rows as scatter_rows_mod
from dlrm_flexflow_tpu_torch.ops.kernels.interaction import (
    fused_interaction, fused_interaction_quant,
    fused_interaction_quant_reference, fused_interaction_reference)
from dlrm_flexflow_tpu_torch.ops.kernels import topk as topk_mod
from dlrm_flexflow_tpu_torch.ops.kernels.topk import (
    mips_topk, mips_topk_reference, quantize_query)
from dlrm_flexflow_tpu_torch.quant import quantize_rows
from dlrm_flexflow_tpu_torch.retrieve import (CascadeConfig, CascadeEngine,
                                              ShardedMIPSIndex,
                                              TwoTowerConfig,
                                              build_two_tower,
                                              item_embeddings,
                                              transfer_tower_params)
from dlrm_flexflow_tpu_torch.ops.kernels.scatter_rows import (
    presort_reference, scatter_add_rows, scatter_add_rows_reference,
    scatter_presort, scatter_write_rows, scatter_write_rows_reference,
    stateful_route, stateful_update_rows, stateful_update_rows_reference)
from dlrm_flexflow_tpu_torch.serve import InferenceEngine, ServeConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # the plain top-k's fp32 code dot is exact only without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _index_codes(cuda, R, d, seed):
    """Random int8 item codes and scales with planted duplicate rows
    (exact score ties on distinct ids)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    codes, scales = quantize_rows(
        torch.randn(R, d, device=cuda, generator=g), "int8")
    dup = torch.randint(0, R, (R // 50,), device=cuda, generator=g)
    codes[dup] = codes[0].clone()
    scales[dup] = scales[0].clone()
    return codes, scales


@pytest.mark.parametrize("B,R,d,k,base", [(64, 1_000_000, 32, 100, 0),
                                          (1, 1_000_000, 32, 100, 0),
                                          (3, 5000, 128, 1000, 7),
                                          (2, 37, 8, 100, 5)])
def test_topk_kernel_matches_plain(cuda, B, R, d, k, base):
    codes, scales = _index_codes(cuda, R, d, seed=B + R)
    g = torch.Generator(device=cuda).manual_seed(9)
    q, qs = quantize_query(torch.randn(B, d, device=cuda, generator=g))
    before = mips_topk.launches
    got_s, got_i = mips_topk(q, qs, codes, scales, k, base=base)
    torch.cuda.synchronize()
    assert mips_topk.launches == before + 1
    want_s, want_i = mips_topk_reference(q, qs, codes, scales, k, base)
    assert got_s.shape == (B, min(k, R))
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    if R <= 5000:
        cs, ci = mips_topk_reference(q.cpu(), qs.cpu(), codes.cpu(),
                                     scales.cpu(), k, base)
        assert torch.equal(got_i.cpu(), ci)
        assert torch.equal(got_s.cpu().view(torch.int32),
                           cs.view(torch.int32))


def test_topk_kernel_ties_negative_zero(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    # k = R: every row comes back, the +-0.0 ties among them
    codes = torch.randint(-127, 128, (1000, 32), device=cuda,
                          generator=g).to(torch.int8)
    scales = torch.rand(1000, device=cuda, generator=g)
    scales[::3] = 1e-30          # x 1e-20 underflows to 0 -> +-0.0
    q = torch.randint(-127, 128, (2, 32), device=cuda,
                      generator=g).to(torch.int8)
    qs = torch.tensor([1e-20, 1e-20], device=cuda)
    got_s, got_i = mips_topk(q, qs, codes, scales, 1000)
    want_s, want_i = mips_topk_reference(q.cpu(), qs.cpu(), codes.cpu(),
                                         scales.cpu(), 1000)
    assert bool(((got_s == 0) & torch.signbit(got_s)).any())
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_s.cpu().view(torch.int32),
                       want_s.view(torch.int32))
    # +-0.0 at the select route's threshold: 40 rows of a real scale, the
    # rest underflow to +-0.0, so the 100th chunk maximum is a zero and
    # every zero is a candidate (about 4,000, within the buffer)
    codes = torch.randint(-127, 128, (8000, 32), device=cuda,
                          generator=g).to(torch.int8)
    scales = torch.full((8000,), 1e-30, device=cuda)
    scales[::200] = 0.5
    qs = torch.tensor([1e-20, 1e-20], device=cuda)
    before = mips_topk.routes["select"]
    got_s, got_i = mips_topk(q, qs, codes, scales, 100)
    want_s, want_i = mips_topk_reference(q.cpu(), qs.cpu(), codes.cpu(),
                                         scales.cpu(), 100)
    assert mips_topk.routes["select"] == before + 1
    assert bool(((got_s == 0) & torch.signbit(got_s)).any())
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_s.cpu().view(torch.int32),
                       want_s.view(torch.int32))


@pytest.mark.parametrize("k", [1, 100, 1024])
@pytest.mark.parametrize("R", [1, 2047, 2049, 1_000_000])
@pytest.mark.parametrize("B", [1, 5, 64])
def test_topk_select_route_matches_plain(cuda, B, R, k):
    """Random codes take the select route at every shape: bitwise to the
    plain version, with base, and each query's candidate count equal to
    the plain mirror of the selection."""
    _select_matches_plain(cuda, B, R, 32, k)


@pytest.mark.parametrize("B,R,d,k", [(16, 5000, 8, 10), (17, 300_000, 96, 50),
                                     (130, 3000, 128, 7), (20, 3000, 160, 5)])
def test_topk_select_route_other_widths(cuda, B, R, d, k):
    """Other widths (d = 8, 96, 128, 160: code words loaded one or four
    at a time) and query tiles of 16 cut ragged."""
    _select_matches_plain(cuda, B, R, d, k)


def _select_matches_plain(cuda, B, R, d, k):
    g = torch.Generator(device=cuda).manual_seed(B * R + k + d)
    codes, scales = quantize_rows(
        torch.randn(R, d, device=cuda, generator=g), "int8")
    q, qs = quantize_query(torch.randn(B, d, device=cuda, generator=g))
    before = (mips_topk.launches, dict(mips_topk.routes))
    got_s, got_i = mips_topk(q, qs, codes, scales, k, base=11)
    want_s, want_i = mips_topk_reference(q, qs, codes, scales, k, 11)
    torch.cuda.synchronize()
    assert mips_topk.launches == before[0] + 1
    assert mips_topk.routes == {"select": before[1]["select"] + 1,
                                "overflow": before[1]["overflow"]}
    assert got_s.shape == (B, min(k, R))
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    _, _, counts = topk_mod.select_candidates(q, qs, codes, scales,
                                              min(k, R))
    _, _, want_counts = topk_mod.mips_topk_select_reference(
        q, qs, codes, scales, k)
    assert torch.equal(counts.long(), want_counts)
    lib = build.load("topk", topk_mod._SIGNATURES)
    assert lib.ff_topk_chunk_rows(R, min(k, R)) \
        == topk_mod.chunk_rows(R, min(k, R))


@pytest.mark.parametrize("B", [5, 64])
@pytest.mark.parametrize("case", ["all_tied", "k_past_chunks"])
def test_topk_overflow_route_matches_plain(cuda, case, B):
    """Candidates past the buffer take the overflow route, bitwise the
    same: an index whose scores all tie (every row reaches the
    threshold), and k above the number of chunks with more rows than the
    buffer holds (R = 20,000, k = 1,000, base = 3); B = 5 in query
    tiles of 4, B = 64 in tiles of 16."""
    g = torch.Generator(device=cuda).manual_seed(5)
    R, k, base = (50_000, 100, 0) if case == "all_tied" else (20_000, 1000, 3)
    codes, scales = quantize_rows(
        torch.randn(R, 32, device=cuda, generator=g), "int8")
    if case == "all_tied":
        codes[:] = codes[0].clone()
        scales[:] = scales[0].clone()
    q, qs = quantize_query(torch.randn(B, 32, device=cuda, generator=g))
    before = dict(mips_topk.routes)
    got_s, got_i = mips_topk(q, qs, codes, scales, k, base=base)
    want_s, want_i = mips_topk_reference(q.cpu(), qs.cpu(), codes.cpu(),
                                         scales.cpu(), k, base)
    assert mips_topk.routes == {"select": before["select"],
                                "overflow": before["overflow"] + 1}
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_s.cpu().view(torch.int32),
                       want_s.view(torch.int32))
    _, _, counts = topk_mod.select_candidates(q, qs, codes, scales, k)
    assert int(counts.max()) > topk_mod.CAP
    lib = build.load("topk", topk_mod._SIGNATURES)
    assert (lib.ff_topk_cap(), lib.ff_topk_scores_max()) \
        == (topk_mod.CAP, topk_mod.SCORES_MAX)


def test_index_on_card_is_exact(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    items = torch.randn(100_000, 32, device=cuda, generator=g)
    users = torch.randn(5, 32, device=cuda, generator=g)
    sset = ShardedMIPSIndex.standalone_set(4)
    idx = ShardedMIPSIndex.build(sset, items)
    try:
        before = mips_topk.launches
        r = idx.topk(users, 100, deadline_s=60.0)
        assert mips_topk.launches == before + 4 and not r.degraded
        s, i = idx.exact_scan(users, 100)
        np.testing.assert_array_equal(r.ids, i)
        np.testing.assert_array_equal(r.scores.view(np.uint32),
                                      s.view(np.uint32))
    finally:
        sset.close()


@pytest.mark.parametrize("dt", ["int8", "fp8"])
@pytest.mark.parametrize("aggr,bag", [("sum", 1), ("avg", 1), ("sum", 3),
                                      ("avg", 3)])
def test_bag_quant_kernel_matches_plain(cuda, dt, aggr, bag):
    g = torch.Generator(device=cuda).manual_seed(5)
    codes, scales = quantize_rows(
        torch.randn(50000, 64, device=cuda, generator=g), dt)
    ids = torch.randint(0, 50000, (16384, bag), device=cuda, generator=g)
    before = embedding_bag_quant.launches
    got = embedding_bag_quant(codes, scales, ids, aggr)
    torch.cuda.synchronize()
    assert embedding_bag_quant.launches == before + 1
    want = embedding_bag_quant_reference(codes, scales, ids, aggr)
    if bag == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dt", ["int8", "fp8"])
@pytest.mark.parametrize("batch,T,bag,d,H", [(2048, 8, 1, 64, 1024),
                                             (37, 3, 2, 128, 16)])
def test_interaction_quant_kernel_matches_plain(cuda, dt, batch, T, bag, d,
                                                H):
    g = torch.Generator(device=cuda).manual_seed(6)
    rows = 500
    P = (T + 1) * T // 2
    codes, scales = quantize_rows(
        0.5 * torch.randn(T * rows, d, device=cuda, generator=g), dt)
    idx = (torch.randint(0, rows, (batch, T, bag), device=cuda, generator=g)
           + (torch.arange(T, device=cuda) * rows)[None, :, None])
    bottom = 0.5 * torch.randn(batch, d, device=cuda, generator=g)
    w = torch.randn(d + P, H, device=cuda, generator=g) / (d + P) ** 0.5
    bias = 0.1 * torch.randn(H, device=cuda, generator=g)
    before = fused_interaction_quant.launches
    got = fused_interaction_quant(codes, scales, idx, bottom, w, bias)
    torch.cuda.synchronize()
    assert fused_interaction_quant.launches == before + 1
    torch.testing.assert_close(
        got, fused_interaction_quant_reference(codes, scales, idx, bottom, w,
                                               bias),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("aggr", ["sum", "avg"])
@pytest.mark.parametrize("n,bag,d", [(16384, 1, 64), (1000, 3, 64),
                                     (77, 2, 132)])
def test_bag_kernel_matches_plain(cuda, aggr, n, bag, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn(4096, d, device=cuda, generator=g)
    ids = torch.randint(0, 4096, (n, bag), device=cuda, generator=g)
    before = embedding_bag.launches
    got = embedding_bag(table, ids, aggr)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    torch.testing.assert_close(got, embedding_bag_reference(table, ids, aggr),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("batch,T,bag,d,H", [(2048, 8, 1, 64, 1024),
                                             (37, 8, 3, 64, 300),
                                             (5, 3, 2, 128, 16)])
def test_interaction_kernel_matches_plain(cuda, relu, batch, T, bag, d, H):
    g = torch.Generator(device=cuda).manual_seed(1)
    rows = 500
    P = (T + 1) * T // 2
    table = 0.5 * torch.randn(T * rows, d, device=cuda, generator=g)
    idx = (torch.randint(0, rows, (batch, T, bag), device=cuda, generator=g)
           + (torch.arange(T, device=cuda) * rows)[None, :, None])
    bottom = 0.5 * torch.randn(batch, d, device=cuda, generator=g)
    w = torch.randn(d + P, H, device=cuda, generator=g) / (d + P) ** 0.5
    bias = 0.1 * torch.randn(H, device=cuda, generator=g)
    before = fused_interaction.launches
    got = fused_interaction(table, idx, bottom, w, bias, relu)
    torch.cuda.synchronize()
    assert fused_interaction.launches == before + 1
    torch.testing.assert_close(
        got, fused_interaction_reference(table, idx, bottom, w, bias, relu),
        rtol=1e-5, atol=1e-5)


def test_bag_kernel_returns_the_gathered_rows(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    table = torch.randn(4096, 64, device=cuda, generator=g)
    ids = torch.randint(0, 4096, (300, 3), device=cuda, generator=g)
    out, rows = embedding_bag(table, ids, "sum", return_rows=True)
    torch.cuda.synchronize()
    assert torch.equal(rows, table[ids.reshape(-1)])
    torch.testing.assert_close(out, embedding_bag_reference(table, ids),
                               rtol=1e-6, atol=1e-6)


# the shapes the paths launch the bag at (the cascade's user tables at
# n = 64, d = 8; the "cat" step at n = 2,048), an n that is not a
# multiple of the rows a warp owns (8 at d = 64, 32 at d = 8), rows
# wider than a warp (d = 132) and bags of 3
BAG_EDGES = [(64, 1, 8), (2048, 1, 64), (1001, 1, 64), (77, 1, 8),
             (33, 3, 8), (300, 3, 132), (16385, 1, 64), (1, 40, 16)]


def _bag_order_sum(rows, aggr):
    """The kernels' arithmetic on (n, bag, d) rows: 0 plus each row in
    bag order, each add rounded, then the mean's one division. Bitwise
    at any bag, where torch's own sum (the plain versions) takes another
    order and the stated 1e-6 holds only for short bags."""
    acc = torch.zeros_like(rows[:, 0])
    for j in range(rows.shape[1]):
        acc = acc + rows[:, j]
    # a tensor divisor: torch may multiply by the reciprocal of a scalar
    return acc / torch.full_like(acc, rows.shape[1]) if aggr == "avg" \
        else acc


@pytest.mark.parametrize("aggr", ["sum", "avg"])
@pytest.mark.parametrize("n,bag,d", BAG_EDGES)
def test_bag_kernel_edges_return_the_gathered_rows(cuda, aggr, n, bag, d):
    g = torch.Generator(device=cuda).manual_seed(7)
    table = torch.randn(50000, d, device=cuda, generator=g)
    ids = torch.randint(0, 50000, (n, bag), device=cuda, generator=g)
    before = embedding_bag.launches
    out, rows = embedding_bag(table, ids, aggr, return_rows=True)
    alone = embedding_bag(table, ids, aggr)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 2
    assert torch.equal(rows, table[ids.reshape(-1)])
    assert torch.equal(out, alone)
    assert torch.equal(out, _bag_order_sum(table[ids], aggr))
    if bag <= 3:
        torch.testing.assert_close(
            out, embedding_bag_reference(table, ids, aggr), rtol=1e-6,
            atol=1e-6)


@pytest.mark.parametrize("dt", ["int8", "fp8"])
@pytest.mark.parametrize("n,bag,d", BAG_EDGES)
def test_bag_quant_kernel_edges(cuda, dt, n, bag, d):
    g = torch.Generator(device=cuda).manual_seed(8)
    codes, scales = quantize_rows(
        torch.randn(50000, d, device=cuda, generator=g), dt)
    ids = torch.randint(0, 50000, (n, bag), device=cuda, generator=g)
    got = embedding_bag_quant(codes, scales, ids, "sum")
    torch.cuda.synchronize()
    want = embedding_bag_quant_reference(codes, scales, ids, "sum")
    rows = codes.view(torch.uint8)[ids].view(codes.dtype).float() \
        * scales[ids][..., None]
    assert torch.equal(got, _bag_order_sum(rows, "sum"))
    if bag == 1:
        assert torch.equal(got, want)
    elif bag <= 3:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _interaction_inputs(cuda, seed, batch, T, bag, d, H):
    g = torch.Generator(device=cuda).manual_seed(seed)
    rows = 500
    P = (T + 1) * T // 2
    table = 0.5 * torch.randn(T * rows, d, device=cuda, generator=g)
    idx = (torch.randint(0, rows, (batch, T, bag), device=cuda, generator=g)
           + (torch.arange(T, device=cuda) * rows)[None, :, None])
    bottom = 0.5 * torch.randn(batch, d, device=cuda, generator=g)
    w = torch.randn(d + P, H, device=cuda, generator=g) / (d + P) ** 0.5
    bias = 0.1 * torch.randn(H, device=cuda, generator=g)
    return table, idx, bottom, w, bias


# every tile choice and edge: one sample, a batch one under and one over
# a multiple of 16, the paths' 64 and 256; one column tile of 4 columns
# (H = 16), column tiles of 40 with a ragged last one (H = 300), the
# model's 1,024
INTER_EDGES = [(b, h) for b in (1, 15, 17, 64, 256) for h in (16, 300, 1024)]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("T,bag,d", [(8, 1, 64), (8, 3, 128)])
@pytest.mark.parametrize("batch,H", INTER_EDGES)
def test_interaction_kernel_tile_edges(cuda, relu, T, bag, d, batch, H):
    from dlrm_flexflow_tpu_torch.ops.kernels.interaction import (
        interaction_tiles)
    table, idx, bottom, w, bias = _interaction_inputs(cuda, 9, batch, T, bag,
                                                      d, H)
    before = fused_interaction.launches
    got = fused_interaction(table, idx, bottom, w, bias, relu)
    torch.cuda.synchronize()
    assert fused_interaction.launches == before + 1
    torch.testing.assert_close(
        got, fused_interaction_reference(table, idx, bottom, w, bias, relu),
        rtol=1e-5, atol=1e-5)
    t = interaction_tiles(batch, H, T, d)
    assert t.grid[0] * t.sb >= batch and t.grid[1] * t.hc >= H


@pytest.mark.parametrize("dt", ["int8", "fp8"])
@pytest.mark.parametrize("T,bag,d", [(8, 1, 64), (8, 3, 128)])
@pytest.mark.parametrize("batch,H", INTER_EDGES)
def test_interaction_quant_kernel_tile_edges(cuda, dt, T, bag, d, batch, H):
    table, idx, bottom, w, bias = _interaction_inputs(cuda, 10, batch, T,
                                                      bag, d, H)
    codes, scales = quantize_rows(table, dt)
    before = fused_interaction_quant.launches
    got = fused_interaction_quant(codes, scales, idx, bottom, w, bias)
    torch.cuda.synchronize()
    assert fused_interaction_quant.launches == before + 1
    torch.testing.assert_close(
        got, fused_interaction_quant_reference(codes, scales, idx, bottom, w,
                                               bias),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch,H,T,d", [(b, h, 8, 64) for b, h in
                                         INTER_EDGES + [(2048, 1024)]]
                         + [(2048, 1024, 26, 128), (37, 16, 3, 128)])
def test_interaction_tiles_fit_the_card(cuda, batch, H, T, d):
    """The Python mirror of the kernel's shared memory equals the C
    side's, and a cluster of the chosen tiles fits on the card."""
    from dlrm_flexflow_tpu_torch.ops.kernels import interaction as im
    t = im.interaction_tiles(batch, H, T, d)
    lib = build.load("interaction", im._SIGNATURES)
    assert lib.ff_fused_interaction_smem_bytes(T, d, t.sb, t.hc,
                                               t.cl) == t.smem
    assert lib.ff_fused_interaction_max_clusters(
        batch, T, d, H, t.sb, t.hc, t.ss, t.cl) >= 1


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("batch,T,bag,d,H", [(37, 3, 2, 128, 18),
                                             (20, 22, 1, 64, 64)])
def test_interaction_kernel_stages_w_without_tma(cuda, relu, batch, T, bag,
                                                 d, H):
    """W's tile comes element by element where TMA cannot take it: rows
    not 16-byte aligned (H % 4 != 0) and K = d + P past the 256 rows of
    one TMA box (T = 22: K = 64 + 253)."""
    table, idx, bottom, w, bias = _interaction_inputs(cuda, 11, batch, T,
                                                      bag, d, H)
    got = fused_interaction(table, idx, bottom, w, bias, relu)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, fused_interaction_reference(table, idx, bottom, w, bias, relu),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("write", [False, True])
@pytest.mark.parametrize("n,div,ids_kind", [
    (2048, 1, "uniform"), (16384, 1, "uniform"), (16385, 1, "uniform"),
    (771, 3, "uniform"), (1, 1, "uniform"), (2048, 1, "equal"),
    (16384, 4, "equal"), (2560, 1, "zipf")])
def test_scatter_kernels_match_plain(cuda, write, n, div, ids_kind):
    """Bitwise against the plain version on the CPU: at the cluster
    pre-pass's limit (16,384) and one above it (the torch.sort route),
    with div > 1, at n = 1, with every id equal and with Zipf-skewed
    ids."""
    g = torch.Generator(device=cuda).manual_seed(n)
    table = torch.randn(50000, 64, device=cuda, generator=g)
    ids = torch.randint(0, 50000, (n,), device=cuda, generator=g)
    ids[:8] = ids[0].clone()
    ids[8:12] = ids[9 % n].clone()
    if ids_kind == "equal":
        ids[:] = 4321
    elif ids_kind == "zipf":
        r = np.random.RandomState(n)
        ids = torch.as_tensor((r.zipf(1.2, n) - 1) % 50000, device=cuda)
    upd = torch.randn(n // div, 64, device=cuda, generator=g)
    fwd = table[ids]
    kernel = scatter_write_rows if write else scatter_add_rows
    route = "block" if n <= 16384 else "sort"
    before = kernel.launches
    before_route = kernel.routes[route]
    got = table.clone()
    if write:
        kernel(got, ids, upd, fwd, scale=-0.01, div=div)
        want = scatter_write_rows_reference(
            table.cpu(), ids.cpu(), upd.cpu(), fwd.cpu(), -0.01, div)
    else:
        kernel(got, ids, upd, scale=-0.01, div=div)
        want = scatter_add_rows_reference(table.cpu(), ids.cpu(),
                                          upd.cpu(), -0.01, div)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert kernel.routes[route] == before_route + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("write", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [2048, 16385])
def test_scatter_kernels_skip_pads(cuda, write, d, n):
    """Pad slots (-1 and -(rows + 1)) among the ids on both pre-pass
    routes ("block" at 2,048, "sort" at 16,385): bitwise to the plain
    version on the CPU, the pads' rows (the last, wrapped) untouched;
    ids past the table raise."""
    rows = 50000
    g = torch.Generator(device=cuda).manual_seed(n + d)
    table = torch.randn(rows, d, device=cuda, generator=g)
    ids = torch.randint(0, rows - 1, (n,), device=cuda, generator=g)
    ids[:8] = ids[0].clone()
    ids[3] = -1
    ids[100:300] = -1
    ids[torch.randperm(n, device=cuda, generator=g)[:n // 10]] = -(rows + 1)
    upd = torch.randn(n, d, device=cuda, generator=g)
    fwd = table[ids.clamp(min=0)]
    kernel = scatter_write_rows if write else scatter_add_rows
    route = "block" if n <= 16384 else "sort"
    before = kernel.routes[route]
    got = table.clone()
    if write:
        kernel(got, ids, upd, fwd, scale=-0.01)
        want = scatter_write_rows_reference(
            table.cpu(), ids.cpu(), upd.cpu(), fwd.cpu(), -0.01)
    else:
        kernel(got, ids, upd, scale=-0.01)
        want = scatter_add_rows_reference(table.cpu(), ids.cpu(),
                                          upd.cpu(), -0.01)
    torch.cuda.synchronize()
    assert kernel.routes[route] == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got[-1], table[-1])
    changed = torch.nonzero((got != table).any(1)).reshape(-1)
    assert bool(torch.isin(changed, ids[ids >= 0]).all())
    ids[5] = rows
    with pytest.raises(ValueError, match="past the table"):
        if write:
            kernel(got, ids, upd, fwd)
        else:
            kernel(got, ids, upd)


@pytest.mark.parametrize("n,div", [
    (1, 1), (2, 1), (1000, 1), (1000, 4), (2048, 1), (6656, 4), (8192, 1),
    (8192, 4), (16384, 1), (16388, 1), (16388, 4)])
def test_windowed_scatter_matches_plain(cuda, n, div):
    """Kernel 4 (``sharded_scatter_add_rows``) on a block [lo, lo + rows)
    of a larger table, on both pre-pass routes ("block" up to 16,384,
    "sort" at 16,388), with pads, ids below and above the window and a
    hot row: bitwise to its plain version on the CPU, one pre-pass
    launch on the "block" route, and no row outside what the in-window
    ids name changed."""
    rows, lo, d = 40000, 80000, 64
    g = torch.Generator(device=cuda).manual_seed(n + div)
    block = torch.randn(rows, d, device=cuda, generator=g)
    ids = torch.randint(lo - rows, lo + 2 * rows, (n,), device=cuda,
                        generator=g)
    ids[:8] = lo + 17
    ids[100:300] = -1
    upd = torch.randn(n // div, d, device=cuda, generator=g)
    kernel = scatter_rows_mod.sharded_scatter_add_rows
    route = "block" if n <= 16384 else "sort"
    before = kernel.routes[route], scatter_presort.launches
    got = kernel(block.clone(), ids, upd, lo, scale=-0.01, div=div)
    want = scatter_rows_mod.sharded_scatter_add_rows_reference(
        block.cpu(), ids.cpu(), upd.cpu(), lo, scale=-0.01, div=div)
    torch.cuda.synchronize()
    assert kernel.routes[route] == before[0] + 1
    assert scatter_presort.launches == before[1] + (route == "block")
    assert torch.equal(got.cpu(), want)
    inside = ids[(ids >= lo) & (ids < lo + rows)] - lo
    changed = torch.nonzero((got != block).any(1)).reshape(-1)
    assert bool(torch.isin(changed, inside).all())
    assert len(changed) or not len(inside)


def _window_ids(cuda, g, n, lo, rows, kind):
    """n ids around the window [lo, lo + rows): "spread" over it with
    pads and ids below and above it among them, "hot" all one row of
    it, "pads" all pads, "outside" all below or above it."""
    spread = torch.randint(lo, lo + rows, (n,), device=cuda, generator=g)
    if kind == "hot":
        return torch.full_like(spread, lo + rows - 1)
    if kind == "pads":
        return torch.where(spread % 2 == 0, torch.full_like(spread, -1),
                           torch.full_like(spread, -(2 ** 40)))
    if kind == "outside":
        return torch.where(spread % 2 == 0, lo - 1 - spread % (lo + 1),
                           lo + rows + spread % 1000)
    spread[3::7] = -1
    spread[5::11] = lo - 1
    spread[6::13] = lo + rows
    return spread


@pytest.mark.parametrize("kind", ["spread", "hot", "pads", "outside"])
@pytest.mark.parametrize("rows", [2 ** 8 - 1, 2 ** 8, 2 ** 8 + 1,
                                  2 ** 22 - 1, 2 ** 22, 2 ** 22 + 1])
@pytest.mark.parametrize("n", [1000, 8192])
def test_windowed_scatter_edge_windows(cuda, n, rows, kind):
    """Kernel 4 where the pre-pass's key bits change (rows 2^k - 1, 2^k,
    2^k + 1 take k, k + 1, k + 1 bits, the pad key being rows), with
    every id one row, every id a pad and every id outside the window:
    bitwise to the plain version on the CPU."""
    lo, d = 3 * rows + 5, 16
    g = torch.Generator(device=cuda).manual_seed(n + rows)
    block = torch.randn(rows, d, device=cuda, generator=g)
    ids = _window_ids(cuda, g, n, lo, rows, kind)
    upd = torch.randn(n, d, device=cuda, generator=g)
    got = scatter_rows_mod.sharded_scatter_add_rows(block.clone(), ids, upd,
                                                    lo, scale=-0.5)
    want = scatter_rows_mod.sharded_scatter_add_rows_reference(
        block.cpu(), ids.cpu(), upd.cpu(), lo, scale=-0.5)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if kind in ("pads", "outside"):
        assert torch.equal(got, block)


@pytest.mark.parametrize("n", [1, 2, 1000, 2048,
                               scatter_rows_mod.RADIX_MIN - 1,
                               scatter_rows_mod.RADIX_MIN, 6656, 8192,
                               16384])
def test_scatter_presort_matches_plain(cuda, n):
    """The pre-pass (the rank kernel below RADIX_MIN, the cluster radix
    kernel from it) against its plain version on the CPU (bitwise) and
    against torch.sort(stable=True), one launch a call: without a window
    (ids with many duplicates) and over a rank's 4M-row window (ids
    spread over it with pads and ids outside)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    ids = torch.randint(0, max(1, n // 3), (n,), device=cuda, generator=g)
    kernel = "rank" if n < scatter_rows_mod.RADIX_MIN else "radix"
    before = scatter_presort.launches, scatter_presort.routes[kernel]
    got = scatter_presort(ids)
    want = presort_reference(ids.cpu())
    torch.cuda.synchronize()
    assert scatter_presort.launches == before[0] + 1
    assert scatter_presort.routes[kernel] == before[1] + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(got[0].long().cpu(),
                       torch.sort(ids.cpu(), stable=True).indices)
    lo = rows = 4_000_000
    ids = _window_ids(cuda, g, n, lo, rows, "spread")
    got = scatter_presort(ids, lo, rows)
    want = presort_reference(scatter_rows_mod.window_ids(ids.cpu(), lo,
                                                         rows))
    torch.cuda.synchronize()
    assert scatter_presort.launches == before[0] + 2
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    lib = build.load("scatter_rows", scatter_rows_mod._SIGNATURES)
    assert lib.ff_scatter_block_sort_max() == scatter_rows_mod.BLOCK_SORT_MAX
    assert lib.ff_stateful_fused_max() == scatter_rows_mod.FUSED_MAX
    with pytest.raises(ValueError, match="at most"):
        scatter_presort(torch.zeros(16385, dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("cluster", [0, 1, 2, 8, 16])
@pytest.mark.parametrize("kind", ["spread", "hot", "pads", "outside"])
@pytest.mark.parametrize("rows", [2 ** 8 - 1, 2 ** 8, 2 ** 8 + 1,
                                  2 ** 23 - 1, 2 ** 23, 2 ** 23 + 1])
@pytest.mark.parametrize("n", [1, 1000, 2048])
def test_scatter_presort_edge_windows(cuda, monkeypatch, n, rows, kind,
                                      cluster):
    """Both pre-pass kernels (the rank kernel, cluster 0, and the radix
    kernel on clusters of 1 to 16 blocks), where the radix kernel's key
    bits change, on one row, all pads and all ids outside the window:
    bitwise to the plain version."""
    monkeypatch.setattr(scatter_rows_mod, "presort_cluster",
                        lambda n: cluster)
    lo = rows + 7
    g = torch.Generator(device=cuda).manual_seed(n + rows)
    ids = _window_ids(cuda, g, n, lo, rows, kind)
    got = scatter_presort(ids, lo, rows)
    want = presort_reference(scatter_rows_mod.window_ids(ids.cpu(), lo,
                                                         rows))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n", [2048, 8192, 16384])
def test_scatter_presort_kernels_agree(cuda, monkeypatch, n):
    """The rank kernel and the radix kernel at every cluster that holds
    n, on the same ids: bitwise the same (order, seg)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    ids = _window_ids(cuda, g, n, 0, 8_000_000, "spread")
    want = presort_reference(scatter_rows_mod.window_ids(ids.cpu(), 0,
                                                         8_000_000))
    for cluster in (0, 1, 2, 4, 8, 16):
        if cluster and -(-n // cluster) > scatter_rows_mod.SLICE_MAX:
            continue
        monkeypatch.setattr(scatter_rows_mod, "presort_cluster",
                            lambda n, c=cluster: c)
        got = scatter_presort(ids, 0, 8_000_000)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), cluster


STATEFUL = {
    "sgd_wd": lambda: SGDOptimizer(lr=0.01, weight_decay=1e-4),
    "momentum": lambda: SGDOptimizer(lr=0.01, momentum=0.9),
    "nesterov_wd": lambda: SGDOptimizer(lr=0.1, momentum=0.9, nesterov=True,
                                        weight_decay=1e-3),
    "adam": lambda: AdamOptimizer(alpha=0.001),
    "adam_wd": lambda: AdamOptimizer(alpha=0.01, weight_decay=1e-3),
}


def _stateful_ids(cuda, g, n, rows, kind):
    """n ids below rows - 1 (the last row stays a pad's wrap target)."""
    if kind == "distinct":
        return torch.randperm(rows - 1, device=cuda, generator=g)[:n]
    if kind == "equal":
        return torch.full((n,), 4321, dtype=torch.int64, device=cuda)
    if kind == "zipf":
        r = np.random.RandomState(n)
        return torch.as_tensor((r.zipf(1.2, n) - 1) % (rows - 1),
                               device=cuda)
    ids = torch.randint(0, rows - 1, (n,), device=cuda, generator=g)
    ids[:8] = ids[0].clone()
    if kind == "pads":
        ids[3] = -1
        ids[n // 2:n // 2 + n // 8] = -1
        ids[n // 4] = -(rows + 1)
    return ids


@pytest.mark.parametrize("name", list(STATEFUL))
@pytest.mark.parametrize("n,d,kind,residual", [
    (64, 64, "distinct", True), (2048, 64, "uniform", True),
    (2048, 64, "zipf", False), (2048, 8, "equal", True),
    (2048, 132, "pads", False), (16384, 64, "zipf", True),
    (16385, 64, "uniform", False),
    (16385, 132, "zipf", True), (16385, 8, "pads", True)])
def test_stateful_kernel_matches_plain(cuda, name, n, d, kind, residual):
    """The stateful touched-rows kernel, bitwise against its plain
    version on the CPU, from non-zero state: on the route the wrapper
    takes (n = 64, 2,048 and 16,384 "fused", 16,385 "sort"), with
    distinct, uniform,
    Zipf-skewed and all-equal ids and pad slots, at d = 8, 64 and 132,
    with one slab (momentum) or two (Adam), reading the forward rows or
    (no residual) the table; rows it was not given keep weight and
    state, pads' rows (the last, where -1 wraps) included."""
    rows = 50000
    g = torch.Generator(device=cuda).manual_seed(n + d)
    opt = STATEFUL[name]()
    table = torch.randn(rows, d, device=cuda, generator=g)
    ids = _stateful_ids(cuda, g, n, rows, kind)
    upd = torch.randn(n, d, device=cuda, generator=g)
    slabs = {k: torch.rand(rows, d, device=cuda, generator=g)
             for k in opt.sparse_slab_names()}
    fwd = table[ids.clamp(min=0)] if residual else None
    alpha_t = opt.alpha_t(torch.tensor(6, dtype=torch.int32, device=cuda))
    got, got_s = table.clone(), {k: v.clone() for k, v in slabs.items()}
    route = stateful_route(n, rows)
    before = stateful_update_rows.routes[route]
    stateful_update_rows(got, ids, upd, fwd, got_s, opt.row_params(),
                         alpha_t)
    want, want_s = table.cpu(), {k: v.cpu() for k, v in slabs.items()}
    stateful_update_rows_reference(
        want, ids.cpu(), upd.cpu(), None if fwd is None else fwd.cpu(),
        want_s, opt.row_params(), None if alpha_t is None
        else alpha_t.cpu())
    torch.cuda.synchronize()
    assert stateful_update_rows.routes[route] == before + 1
    assert torch.equal(got.cpu(), want)
    for k in slabs:
        assert torch.equal(got_s[k].cpu(), want_s[k]), k
    changed = torch.nonzero((got != table).any(1)).reshape(-1)
    assert bool(torch.isin(changed, ids[ids >= 0]).all())
    assert torch.equal(got[-1], table[-1])
    for k in slabs:
        assert torch.equal(got_s[k][-1], slabs[k][-1])


def test_stateful_kernel_raises_on_what_it_does_not_take(cuda):
    """An id past the table, Adam without its step size on the card, a
    slab of another shape: ValueError before any launch."""
    table = torch.zeros(100, 8, device=cuda)
    ids = torch.arange(10, device=cuda)
    upd = torch.ones(10, 8, device=cuda)
    adam = AdamOptimizer()
    slabs = {k: torch.zeros_like(table) for k in ("m", "v")}
    alpha_t = adam.alpha_t(torch.zeros((), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="past the table"):
        stateful_update_rows(table, ids + 95, upd, None, slabs,
                             adam.row_params(), alpha_t)
    with pytest.raises(ValueError, match="alpha_t"):
        stateful_update_rows(table, ids, upd, None, slabs,
                             adam.row_params(), alpha_t.cpu())
    with pytest.raises(ValueError, match="slab"):
        stateful_update_rows(table, ids, upd, None,
                             {"m": slabs["m"], "v": slabs["v"][:50]},
                             adam.row_params(), alpha_t)


@pytest.mark.parametrize("name", list(STATEFUL))
def test_stateful_training_step_on_card_matches_cpu(cuda, name):
    """Two "cat" steps under each stateful optimizer on the card against
    the CPU from the same weights: the table takes the stateful kernel
    once a step on its one-launch route (no pre-pass), no write-only SGD
    scatter runs, the dense update is one launch a step, and the weights
    and state agree."""
    gpu = _model("cat", "cuda")
    cpu = _model("cat", "cpu", gpu.params)
    for m in (gpu, cpu):
        m.compile(STATEFUL[name](), "mean_squared_error", ["mse"])
    init = {op: {n: v.clone() for n, v in p.items()}
            for op, p in cpu.params.items()}
    before = (stateful_update_rows.routes["fused"],
              scatter_write_rows.launches, scatter_presort.launches,
              dense_mod.dense_update.launches)
    for step in range(2):
        x, y = synthetic_batch(DLRMConfig(**ARCH["cat"]), 16, seed=5 + step)
        x["label"] = y
        lg = float(gpu.train_batch(x)["loss"])
        lc = float(cpu.train_batch(x)["loss"])
        np.testing.assert_allclose(lg, lc, rtol=1e-5)
    assert (stateful_update_rows.routes["fused"] - before[0],
            scatter_write_rows.launches - before[1],
            scatter_presort.launches - before[2],
            dense_mod.dense_update.launches - before[3]) == (2, 0, 0, 2)
    adam = isinstance(gpu.optimizer, AdamOptimizer)
    trees = [(cpu.params, gpu.params, init)]
    trees += [(cpu.opt_state[k], gpu.opt_state[k], None)
              for k in gpu.optimizer.sparse_slab_names()]
    for tc, tg, t0 in trees:
        for op, p in tc.items():
            for pn, v in p.items():
                got = tg[op][pn].cpu()
                if adam and t0 is not None:
                    dc, dg = v - t0[op][pn], got - t0[op][pn]
                    scale = float(dc.abs().max())
                    assert float((dg - dc).abs().max()) <= 1e-2 * scale, \
                        (op, pn)
                else:
                    torch.testing.assert_close(got, v, rtol=1e-5, atol=1e-7)
    if adam:
        assert int(gpu.opt_state["step"]) == int(cpu.opt_state["step"]) == 2


@pytest.mark.parametrize("name", ["sgd_wd", "momentum", "adam"])
@pytest.mark.parametrize("n,div,kind", [
    (2048, 1, "uniform"), (2048, 1, "equal"), (2048, 1, "zipf"),
    (2048, 1, "pads"), (2048, 8, "uniform"), (999, 3, "zipf"),
    (16384, 1, "uniform"), (16384, 1, "pads")])
def test_stateful_routes_match_plain(cuda, name, n, div, kind):
    """The one-launch route and the pre-pass route on the same inputs,
    each bitwise against the plain version on the CPU, with a bag
    divisor (``div`` lookups sharing one update row) and pads."""
    rows, d = 50000, 64
    g = torch.Generator(device=cuda).manual_seed(n + div)
    opt = STATEFUL[name]()
    table = torch.randn(rows, d, device=cuda, generator=g)
    ids = _stateful_ids(cuda, g, n, rows, kind)
    upd = torch.randn(n // div, d, device=cuda, generator=g)
    slabs = {k: torch.rand(rows, d, device=cuda, generator=g)
             for k in opt.sparse_slab_names()}
    alpha_t = opt.alpha_t(torch.tensor(2, dtype=torch.int32, device=cuda))
    want, want_s = table.cpu(), {k: v.cpu() for k, v in slabs.items()}
    stateful_update_rows_reference(
        want, ids.cpu(), upd.cpu(), None, want_s, opt.row_params(),
        None if alpha_t is None else alpha_t.cpu(), div)
    for fused in (True, False):
        got, got_s = table.clone(), {k: v.clone() for k, v in slabs.items()}
        scatter_rows_mod._stateful_kernels(got, ids, upd, None, got_s,
                                           opt.row_params(), alpha_t, div,
                                           fused)
        assert torch.equal(got.cpu(), want), fused
        for k in slabs:
            assert torch.equal(got_s[k].cpu(), want_s[k]), (fused, k)


# the dense update's six settings: plain SGD, compile()'s default,
# momentum with weight decay, nesterov, Adam, Adam with weight decay
DENSE = {
    "sgd": lambda: SGDOptimizer(lr=0.01),
    "default": lambda: SGDOptimizer(lr=0.01, weight_decay=1e-4),
    "momentum_wd": lambda: SGDOptimizer(lr=0.01, momentum=0.9,
                                        weight_decay=1e-4),
    "nesterov_wd": STATEFUL["nesterov_wd"],
    "adam": STATEFUL["adam"],
    "adam_wd": STATEFUL["adam_wd"],
}


def _dense_case(cuda, opt, sizes, offsets, seed):
    """Weights, gradients and slabs of ``sizes`` elements, each a view
    at its element offset (w, g, slab...) into a larger buffer, so that
    some are 16-byte aligned alike, some at another offset each."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    names = opt.sparse_slab_names()

    def at(n, off):
        buf = torch.randn(n + 4, device=cuda, generator=g)
        return buf[off:off + n]

    ws, gs, slabs = [], [], []
    for i, n in enumerate(sizes):
        o = offsets[i % len(offsets)]
        ws.append(at(n, o[0]))
        gs.append(at(n, o[1]))
        slabs.append({k: at(n, o[2 + j]).abs_() for j, k in
                      enumerate(names)})
    return ws, gs, slabs


def _dense_matches_plain(cuda, opt, ws, gs, slabs, cpu=True):
    """The kernel on copies of the inputs against the plain version on
    the card (and, with ``cpu``, on the CPU); returns the launches."""
    p = opt.row_params()
    alpha_t = opt.alpha_t(torch.tensor(3, dtype=torch.int32, device=cuda))
    if cpu:
        cw = [w.cpu() for w in ws]
        cs = [{k: v.cpu() for k, v in s.items()} for s in slabs]
        dense_mod.dense_update_reference(
            cw, [gr.cpu() for gr in gs], cs, p,
            None if alpha_t is None else alpha_t.cpu())
    kw = [w.clone() for w in ws]
    ks = [{k: v.clone() for k, v in s.items()} for s in slabs]
    before = dense_mod.dense_update.launches
    dense_mod.dense_update(kw, gs, ks, p, alpha_t)
    launches = dense_mod.dense_update.launches - before
    dense_mod.dense_update_reference(ws, gs, slabs, p, alpha_t)
    torch.cuda.synchronize()
    for a, b in zip(kw, ws):
        assert torch.equal(a, b)
    for a, b in zip(ks, slabs):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    if cpu:
        for a, b in zip(kw, cw):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(ks, cs):
            for k in a:
                assert torch.equal(a[k].cpu(), b[k]), k
    return launches


@pytest.mark.parametrize("name", list(DENSE))
@pytest.mark.parametrize("offsets", [[(0, 0, 0, 0)], [(1, 1, 1, 1)],
                                     [(0, 1, 2, 3), (3, 3, 3, 3)]])
def test_dense_kernel_matches_plain(cuda, name, offsets):
    """One launch over tensors of 0, 1, 7, 35, 1,027 and 65,541
    elements, from non-zero state, aligned alike (float4 spans, scalar
    heads and tails) or at different offsets (scalar throughout),
    bitwise to the plain version on the card."""
    opt = DENSE[name]()
    ws, gs, slabs = _dense_case(cuda, opt, [0, 1, 7, 35, 1027, 65541],
                                offsets, len(name))
    assert _dense_matches_plain(cuda, opt, ws, gs, slabs) == 1


def test_dense_kernel_splits_long_lists(cuda):
    """More tensors than one launch's descriptors: one launch for each
    MAX_TENSORS, all bitwise to the plain version."""
    opt = DENSE["adam_wd"]()
    n = 2 * dense_mod.MAX_TENSORS + 5
    ws, gs, slabs = _dense_case(cuda, opt, [1 + 37 * i for i in range(n)],
                                [(0, 0, 0, 0), (2, 2, 2, 2), (1, 0, 3, 2)],
                                7)
    assert _dense_matches_plain(cuda, opt, ws, gs, slabs) == 3


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_dense_kernel_on_a_2gib_tensor(cuda, name):
    """One tensor of 2^29 + 3 elements (past 2^31 bytes), a view one
    element into its buffers: 64-bit offsets, a scalar head and tail,
    bitwise to the plain version on the card."""
    opt = DENSE[name]()
    ws, gs, slabs = _dense_case(cuda, opt, [2 ** 29 + 3], [(1, 1, 1, 1)], 5)
    assert _dense_matches_plain(cuda, opt, ws, gs, slabs, cpu=False) == 1
    del ws, gs, slabs
    torch.cuda.empty_cache()


def test_dense_update_constants_match_the_source(cuda):
    """The wrapper's launch plan assumes csrc/dense_update.cu's tile and
    descriptor sizes."""
    lib = build.load("dense_update", dense_mod._SIGNATURES)
    assert (lib.ff_dense_update_max_tensors(), lib.ff_dense_update_threads(),
            lib.ff_dense_update_tile_vecs()) == (
        dense_mod.MAX_TENSORS, dense_mod.THREADS, dense_mod.TILE_VECS)
    assert all(dense_mod.blocks_per_sm(k) >= 1 for k in range(3))


def test_dense_update_raises_on_card(cuda):
    """Mixed devices, a strided weight, a bf16 gradient, a missing or
    misshapen slab, Adam without its step size on the card: ValueError
    before any launch."""
    adam = AdamOptimizer()
    p = adam.row_params()
    at = adam.alpha_t(torch.zeros((), dtype=torch.int32, device=cuda))
    w = torch.zeros(8, 4, device=cuda)
    s = {k: torch.zeros_like(w) for k in ("m", "v")}
    before = dense_mod.dense_update.launches
    cases = [([w], [w.cpu()], [s], at, "devices"),
             ([w.t()], [w.t()], [s], at, "shaped|contiguous"),
             ([w], [w.bfloat16()], [s], at, "float32"),
             ([w], [w], [{"m": s["m"]}], at, "lack"),
             ([w], [w], [{"m": s["m"], "v": s["v"][:4]}], at, "shaped"),
             ([w], [w], [s], at.cpu(), "alpha_t")]
    for ws, gs, sl, a, match in cases:
        with pytest.raises(ValueError, match=match):
            dense_mod.dense_update(ws, gs, sl, p, a)
    assert dense_mod.dense_update.launches == before


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("mode", ["cat", "dot"])
def test_step_launches(cuda, mode, opt):
    """One training step's launches: one dense update for every dense
    parameter; on "cat" one write-only scatter after one pre-pass under
    SGD, one stateful update on its one-launch route and no pre-pass
    under Adam; on "dot" one read-modify-write scatter after one
    pre-pass. No plain version runs."""
    m = _model(mode, "cuda")
    m.compile(DENSE[opt](), "mean_squared_error", ["mse"])
    x, y = synthetic_batch(DLRMConfig(**ARCH[mode]), 16, seed=4)
    x["label"] = y
    m.train_batch(x)                     # the state is made at step 1
    kernels = (dense_mod.dense_update, scatter_presort, scatter_add_rows,
               scatter_write_rows, stateful_update_rows)
    before = [k.launches for k in kernels]
    fused = stateful_update_rows.routes["fused"]
    m.train_batch(x)
    got = [k.launches - b for k, b in zip(kernels, before)]
    if mode == "dot":
        want = [1, 1, 1, 0, 0]
    else:
        want = [1, 1, 0, 1, 0] if opt == "sgd" else [1, 0, 0, 0, 1]
    assert got == want
    assert stateful_update_rows.routes["fused"] - fused == \
        (mode == "cat" and opt == "adam")


def test_cuda_call_raises_without_nvcc(cuda, tmp_path, monkeypatch):
    """No library and no compiler: a CUDA call raises, it never falls
    back to the plain version."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        embedding_bag(torch.zeros(16, 8, device=cuda),
                      torch.zeros(2, 1, dtype=torch.int64, device=cuda))


ARCH = {
    "cat": dict(embedding_size=[512] * 4, sparse_feature_size=64,
                mlp_bot=[8, 32, 64], mlp_top=[64 + 4 * 64, 32, 16, 1],
                arch_interaction_op="cat"),
    "dot": dict(embedding_size=[512] * 4, sparse_feature_size=64,
                mlp_bot=[8, 32, 64], mlp_top=[64 + 10, 32, 16, 1],
                arch_interaction_op="dot"),
}


def _model(mode, device, params=None):
    m = pt.FFModel(pt.FFConfig(batch_size=16, device=device, seed=3))
    build_dlrm(m, DLRMConfig(**ARCH[mode]), fuse_interaction=mode == "dot")
    m.compile()
    if params is None:
        m.init_layers()
    else:
        m.swap_params({op: {n: v.to(device) for n, v in p.items()}
                       for op, p in params.items()})
    return m


@pytest.mark.parametrize("mode", ["cat", "dot"])
def test_model_on_card_matches_cpu_and_serves(cuda, mode):
    gpu = _model(mode, "cuda")
    cpu = _model(mode, "cpu", gpu.params)
    x, _ = synthetic_batch(DLRMConfig(**ARCH[mode]), 40, seed=2)
    np.testing.assert_allclose(gpu.forward_batch(x).cpu().numpy(),
                               cpu.forward_batch(x).numpy(),
                               rtol=1e-5, atol=1e-6)
    kernel = fused_interaction if mode == "dot" else embedding_bag
    before = kernel.launches
    with InferenceEngine(gpu, ServeConfig(max_batch=16)) as eng:
        futs = [(a, eng.submit({k: v[a:a + 5] for k, v in x.items()}))
                for a in range(0, 40, 5)]
        res = [(a, f.result(60)) for a, f in futs]
    assert kernel.launches > before
    for a, r in res:
        want = gpu.forward_batch({k: v[a:a + 5] for k, v in x.items()})
        np.testing.assert_allclose(r.scores, want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["cat", "dot"])
def test_training_step_on_card_matches_cpu(cuda, mode):
    gpu = _model(mode, "cuda")
    cpu = _model(mode, "cpu", gpu.params)
    for m in (gpu, cpu):
        m.compile(SGDOptimizer(lr=0.05), "mean_squared_error", ["mse"])
    x, y = synthetic_batch(DLRMConfig(**ARCH[mode]), 16, seed=5)
    x["label"] = y
    kernel = scatter_add_rows if mode == "dot" else scatter_write_rows
    before = kernel.launches
    lg = float(gpu.train_batch(x)["loss"])
    lc = float(cpu.train_batch(x)["loss"])
    assert kernel.launches == before + 1
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for op, p in cpu.params.items():
        for pn, v in p.items():
            torch.testing.assert_close(gpu.params[op][pn].cpu(), v,
                                       rtol=1e-5, atol=1e-7)


TT = dict(n_items=3000, dim=32, user_dense_dim=8,
          user_embedding_size=[500, 300], user_sparse_dim=8, user_mlp=[16],
          item_raw_dim=32, item_mlp=[64])


def _heads(device, params=None):
    heads = {}
    for head in ("user", "item"):
        m = pt.FFModel(pt.FFConfig(batch_size=1024, device=device, seed=7))
        build_two_tower(m, TwoTowerConfig(**TT), head=head)
        m.compile()
        if params is None:
            m.init_layers()
        else:
            m.swap_params({op: {n: v.to(device) for n, v in p.items()}
                           for op, p in params[head].items()})
        heads[head] = m
    return heads


def test_two_tower_heads_and_cascade_on_card(cuda):
    """The heads on the card (the Embedding op on the bag kernel, item ids
    that stay on the card) against the same weights on the CPU, then a
    cascade over a 2-shard index on the card: its retrieval equals
    ``exact_scan`` bitwise and the top-k kernel launches per shard."""
    gpu = _heads("cuda")
    cpu = _heads("cpu", {h: m.params for h, m in gpu.items()})
    before = embedding_bag.launches
    items = item_embeddings(gpu["item"], TwoTowerConfig(**TT))
    assert items.is_cuda and embedding_bag.launches > before
    np.testing.assert_allclose(
        items.cpu().numpy(),
        item_embeddings(cpu["item"], TwoTowerConfig(**TT)).numpy(),
        rtol=1e-5, atol=1e-6)
    rng = np.random.RandomState(8)
    feats = {"user_dense": rng.rand(5, 8).astype(np.float32),
             "user_sparse": np.stack([rng.randint(0, 500, (5, 1)),
                                      rng.randint(0, 300, (5, 1))], axis=1)}
    users = gpu["user"].forward_batch(feats)
    np.testing.assert_allclose(users.cpu().numpy(),
                               cpu["user"].forward_batch(feats).numpy(),
                               rtol=1e-5, atol=1e-6)
    sset = ShardedMIPSIndex.standalone_set(2)
    index = ShardedMIPSIndex.build(sset, items)
    model = _model("cat", "cuda")
    try:
        with InferenceEngine(model, ServeConfig(max_batch=64)) as eng:
            cascade = CascadeEngine(
                index, lambda f: gpu["user"].forward_batch(f), eng,
                lambda f, ids: synthetic_batch(
                    DLRMConfig(**ARCH["cat"]), ids.size, seed=1)[0],
                CascadeConfig(k=20, retrieve_deadline_ms=5000.0))
            before = mips_topk.launches
            p = cascade.predict({k: v[:2] for k, v in feats.items()})
        assert mips_topk.launches == before + 2 and not p.degraded
        assert p.ids.shape == (2, 20)
        s, i = index.exact_scan(users[:2], 20)
        for b in range(2):
            o = np.lexsort((p.ids[b], -p.retrieve_scores[b]))
            np.testing.assert_array_equal(p.ids[b][o], i[b])
            np.testing.assert_array_equal(
                p.retrieve_scores[b][o].view(np.uint32), s[b].view(np.uint32))
    finally:
        sset.close()


def test_swap_params_takes_card_tensors(cuda):
    """A model built for "cuda" accepts parameters that lie on the card
    (they report the card's index), as ``transfer_tower_params`` hands
    them over."""
    src = _heads("cuda")["user"]
    dst = pt.FFModel(pt.FFConfig(batch_size=1024, device="cuda", seed=9))
    build_two_tower(dst, TwoTowerConfig(**TT), head="user")
    dst.compile()
    dst.init_layers()
    assert transfer_tower_params(src, dst) == 4
    for op, p in src.params.items():
        for n, v in p.items():
            assert torch.equal(dst.params[op][n], v)


def _lstm_inputs(cuda, T, b, h, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xp = torch.randn(T, b, 4 * h, device=cuda, generator=g)
    wh = (torch.rand(h, 4 * h, device=cuda, generator=g) * 2 - 1) \
        * (6.0 / (5 * h)) ** 0.5
    dys = torch.randn(T, b, h, device=cuda, generator=g)
    return xp, wh.to(dtype), dys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,b,h", [(5, 8, 128), (7, 24, 136), (3, 70, 40),
                                   (40, 64, 1024), (1, 64, 128),
                                   (6, 1, 64), (5, 96, 72), (4, 160, 64),
                                   (3, 129, 64), (4, 20, 44)])
def test_lstm_kernels_match_plain(cuda, T, b, h, dtype):
    """Forward (ys, cs), backward (dzs from the same residuals) and the
    autograd Function (dxproj, dwh): small, ragged (b and h not multiples
    of 16 rows and 8 units, h = 44 loading the forward's wh slice two
    bytes at a time; b above one tile; b = 1; T = 1), the NMT
    step's per-layer shape, and b = 129 and 160, which the resident
    routes do not take. Both kernels' route: resident for bf16 wh and
    b <= 128, streaming otherwise."""
    xp, wh, dys = _lstm_inputs(cuda, T, b, h, dtype, seed=T + b + h)
    tol = 4e-3 if dtype == torch.bfloat16 else 1e-5
    route = "resident" if dtype == torch.bfloat16 and b <= 128 \
        else "streaming"
    before = (lstm_mod.lstm_fwd.launches, lstm_mod.lstm_bwd.launches,
              dict(lstm_mod.lstm_bwd.routes), lstm_mod.lstm_gates.launches,
              dict(lstm_mod.lstm_fwd.routes))
    ys, cs = lstm_mod.lstm_fwd(xp, wh)
    assert lstm_mod.lstm_fwd.routes[route] == before[4][route] + 1
    ys_r, cs_r = lstm_mod.lstm_fwd_reference(xp, wh)
    dzs = lstm_mod.lstm_bwd(xp, wh, ys_r, cs_r, dys)
    dzs_r = lstm_mod.lstm_bwd_reference(xp, wh, ys_r, cs_r, dys)
    assert (lstm_mod.lstm_fwd.launches, lstm_mod.lstm_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    assert lstm_mod.lstm_bwd.routes[route] == before[2][route] + 1
    assert lstm_mod.lstm_gates.launches \
        == before[3] + (route == "resident")
    for got, want in ((ys, ys_r), (cs, cs_r), (dzs, dzs_r)):
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    ys_only, none = lstm_mod.lstm_fwd(xp, wh, with_residuals=False)
    assert none is None and torch.equal(ys_only, ys)
    grads = []
    for fn in (lstm_mod.lstm_scan, lstm_mod.lstm_scan_reference):
        x, w = xp.clone().requires_grad_(), wh.clone().requires_grad_()
        fn(x, w).backward(dys)
        assert w.grad.dtype == dtype
        grads.append((x.grad, w.grad.float()))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=tol)
    frac = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=0,
                               atol=frac * float(grads[1][1].abs().max()))


def test_lstm_grid_that_cannot_be_resident_raises(cuda):
    """A grid larger than the card holds at once: the cooperative launch
    is refused and the wrapper raises; it never runs the plain version."""
    xp, wh, dys = _lstm_inputs(cuda, 4, 8, 64, torch.bfloat16, seed=1)
    too_many = lstm_mod.capacity("fwd", wh.dtype) + 1
    before = lstm_mod.lstm_fwd.launches
    with pytest.raises(RuntimeError, match="lstm_fwd kernel"):
        lstm_mod.lstm_fwd(xp, wh, grid=too_many)
    ys, cs = lstm_mod.lstm_fwd_reference(xp, wh)
    for kernel in ("bwd", "resident"):  # fp32 wh takes the streaming one
        w = wh if kernel == "resident" else wh.float()
        with pytest.raises(RuntimeError, match="lstm_bwd kernel"):
            lstm_mod.lstm_bwd(xp, w, ys, cs, dys,
                              grid=lstm_mod.capacity(kernel, w.dtype, 64) + 1)
    assert lstm_mod.lstm_fwd.launches == before
    # a grid smaller than the groups of units: each block takes several
    ys1, _ = lstm_mod.lstm_fwd(xp, wh, grid=1)
    torch.testing.assert_close(ys1, ys, rtol=0, atol=4e-3)


def test_lstm_forward_grid_that_cannot_be_resident_raises(cuda):
    """Each forward route refuses a grid past its kernel's capacity and
    the wrapper raises, counting no launch; a grid with fewer blocks
    than groups takes the streaming route."""
    xp, wh, _ = _lstm_inputs(cuda, 4, 8, 64, torch.bfloat16, seed=2)
    before = (lstm_mod.lstm_fwd.launches, dict(lstm_mod.lstm_fwd.routes))
    for kernel, w in (("fwd_resident", wh), ("fwd", wh.float())):
        with pytest.raises(RuntimeError, match="lstm_fwd kernel"):
            lstm_mod.lstm_fwd(xp, w, grid=lstm_mod.capacity(
                kernel, w.dtype, 64) + 1)
    assert (lstm_mod.lstm_fwd.launches, lstm_mod.lstm_fwd.routes) == before
    lstm_mod.lstm_fwd(xp, wh, grid=7)        # 8 groups of units
    assert lstm_mod.lstm_fwd.routes["streaming"] \
        == before[1]["streaming"] + 1
    lib = lstm_mod._lib()
    for h in (5, 40, 136, 1024, 3296, 3312):
        assert lib.ff_lstm_fwd_resident_smem(h) \
            == lstm_mod.fwd_resident_smem(h)


def test_lstm_gate_phase_and_resident_limits(cuda):
    """The gate kernel against its plain version (the products of
    bf16-rounded operands summed in another fp32 order); the wrapper's
    mirror of the resident route's limits equals the kernel's."""
    lib = lstm_mod._lib()
    assert lib.ff_lstm_resident_max_b() == lstm_mod.RESIDENT_MAX_B
    assert lib.ff_lstm_units() == lstm_mod.UNITS
    for h in (5, 40, 136, 1024, 3000):
        assert lib.ff_lstm_resident_smem(h) == lstm_mod.resident_smem(h)
    for T, b, h in ((40, 64, 1024), (3, 5, 136), (1, 1, 8)):
        xp, wh, _ = _lstm_inputs(cuda, T, b, h, torch.bfloat16, seed=h)
        ys = torch.randn(T, b, h, device=cuda)
        before = lstm_mod.lstm_gates.launches
        got = lstm_mod.lstm_gates(xp, wh, ys)
        assert lstm_mod.lstm_gates.launches == before + 1
        torch.testing.assert_close(
            got, lstm_mod.lstm_gates_reference(xp, wh, ys), rtol=0,
            atol=1e-4)
    with pytest.raises(ValueError, match="bf16"):
        lstm_mod.lstm_gates(xp, wh.float(), ys)


@pytest.mark.parametrize("route", ["wgmma", "mma"])
@pytest.mark.parametrize("T,b,h", [(40, 64, 1024), (3, 5, 136), (1, 1, 8),
                                   (2, 100, 1000), (40, 64, 3296)])
def test_lstm_gate_routes_match_plain(cuda, T, b, h, route):
    """Each gate route against the plain version (products of bf16
    values, exact in fp32, summed in another order: atol 1e-4), at the
    NMT layer, K = 136 (not a multiple of the k depth), one row, a tile
    straddling t = 0's zero rows with N = 4,000 (not a multiple of 256)
    and the largest resident h; the launch counted on its route."""
    xp, wh, _ = _lstm_inputs(cuda, T, b, h, torch.bfloat16, seed=T + b + h)
    ys = torch.randn(T, b, h, device=cuda)
    before = (lstm_mod.lstm_gates.launches, dict(lstm_mod.lstm_gates.routes))
    got = lstm_mod.lstm_gates(xp, wh, ys, route=route)
    assert lstm_mod.lstm_gates.launches == before[0] + 1
    assert lstm_mod.lstm_gates.routes \
        == {**before[1], route: before[1][route] + 1}
    torch.testing.assert_close(
        got, lstm_mod.lstm_gates_reference(xp, wh, ys), rtol=0, atol=1e-4)


def test_lstm_gate_route_by_shape_on_card(cuda):
    """The C route rule equals ``gates_route``; h = 138 (h % 4 = 2)
    takes the "mma" route and matches, and the "wgmma" route refuses it
    (raises, counts nothing); two "wgmma" calls on the same inputs are
    bitwise equal."""
    lib = lstm_mod._lib()
    for h in [*range(1, 300), 1024, 3296, 4095, 4096]:
        assert bool(lib.ff_lstm_gates_route(h)) \
            == (lstm_mod.gates_route(h) == "wgmma")
    xp, wh, _ = _lstm_inputs(cuda, 3, 7, 138, torch.bfloat16, seed=138)
    ys = torch.randn(3, 7, 138, device=cuda)
    before = dict(lstm_mod.lstm_gates.routes)
    got = lstm_mod.lstm_gates(xp, wh, ys)
    assert lstm_mod.lstm_gates.routes == {**before, "mma": before["mma"] + 1}
    torch.testing.assert_close(
        got, lstm_mod.lstm_gates_reference(xp, wh, ys), rtol=0, atol=1e-4)
    with pytest.raises(RuntimeError, match="wgmma route"):
        lstm_mod.lstm_gates(xp, wh, ys, route="wgmma")
    assert lstm_mod.lstm_gates.routes == {**before, "mma": before["mma"] + 1}
    xp, wh, _ = _lstm_inputs(cuda, 40, 64, 1024, torch.bfloat16, seed=21)
    ys = torch.randn(40, 64, 1024, device=cuda)
    first = lstm_mod.lstm_gates(xp, wh, ys, route="wgmma")
    assert torch.equal(first, lstm_mod.lstm_gates(xp, wh, ys, route="wgmma"))


def test_lstm_barrier_probe_runs(cuda):
    lstm_mod.grid_barrier(39, 128, cuda)
    torch.cuda.synchronize()


def _nmt(device, params=None):
    m = pt.FFModel(pt.FFConfig(batch_size=6, device=device))
    build_nmt(m, src_vocab=300, tgt_vocab=300, embed_dim=48, hidden=40,
              num_layers=2, src_len=7, tgt_len=7)
    m.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
              ["accuracy"])
    if params is None:
        m.init_layers()
    else:
        m.swap_params({op: {n: v.to(device) for n, v in p.items()}
                       for op, p in params.items()})
    return m


def test_nmt_step_on_card_matches_cpu(cuda):
    gpu = _nmt("cuda")
    cpu = _nmt("cpu", gpu.params)
    init = {op: {n: v.clone() for n, v in p.items()}
            for op, p in cpu.params.items()}
    r = np.random.RandomState(0)
    x = {k: r.randint(0, 300, (6, 7)).astype(np.int32)
         for k in ("src", "tgt", "label")}
    counts = {f: f.launches for f in (lstm_mod.lstm_fwd, lstm_mod.lstm_bwd,
                                      scatter_add_rows)}
    lg = float(gpu.train_batch(x)["loss"])
    lc = float(cpu.train_batch(x)["loss"])
    assert {f.__name__: f.launches - n for f, n in counts.items()} \
        == {"lstm_fwd": 4, "lstm_bwd": 4, "scatter_add_rows": 2}
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for op, p in cpu.params.items():
        for n, v in p.items():
            dc = v - init[op][n]
            dg = gpu.params[op][n].cpu() - init[op][n]
            ulps = 2 * 2 ** -23 * float(init[op][n].abs().max())
            torch.testing.assert_close(
                dg, dc, rtol=0, atol=1e-3 * float(dc.abs().max()) + ulps)


# ---- the training runtime: prefetch, checkpoints, Adam's step size ---------
def test_prefetched_batches_on_card_equal_synchronous_ones(cuda, tmp_path):
    """Batches the prefetch ring stages on its side stream equal the same
    batches staged in the loop, over a run that trains on each; and
    ``fit`` through the ring trains BITWISE as ``fit`` without it."""
    from dlrm_flexflow_tpu_torch.data.dataloader import (FFBinDataLoader,
                                                         write_ffbin)
    cfg = DLRMConfig(**ARCH["cat"])
    x, y = synthetic_batch(cfg, 16 * 7 + 5, seed=8)
    path = str(tmp_path / "d.ffbin")
    write_ffbin(path, x["dense"], x["sparse"], y)
    m = _model("cat", "cuda")
    bag = cfg.embedding_bag_size
    staged = FFBinDataLoader(m, path, shuffle=True, seed=1,
                             sparse_shape=(len(cfg.embedding_size), bag),
                             depth=3)
    host = FFBinDataLoader(m, path, shuffle=True, seed=1,
                           sparse_shape=(len(cfg.embedding_size), bag),
                           prefetch=False)
    try:
        for _ in range(24):
            db, want = staged.next_batch(), m._device_batch(
                host.next_host_batch())
            m.train_batch_device(db)
            for k, v in want.items():
                assert torch.equal(db[k], v), k
    finally:
        staged.close()
        host.close()
    x["label"] = y
    labels = x.pop("label")
    runs = []
    for depth in (0, 2):
        fm = _model("cat", "cuda")
        fm.config.prefetch_depth = depth
        fm.config.stage_dataset = "never"     # not the staged dataset
        fm.compile(SGDOptimizer(lr=0.05, momentum=0.9), "mean_squared_error",
                   ["mse"])
        out = fm.fit(x, labels, epochs=2, batch_size=16, verbose=False)
        assert out["num_samples"] == 2 * len(labels)
        runs.append(fm)
    for op, p in runs[0].params.items():
        for pn, v in p.items():
            assert torch.equal(v, runs[1].params[op][pn]), (op, pn)


def test_checkpoint_from_card_restores_on_card_and_cpu(cuda, tmp_path):
    from dlrm_flexflow_tpu_torch.utils.checkpoint import CheckpointManager
    from dlrm_flexflow_tpu_torch.utils.weights import opt_state_to_jax
    g = _model("cat", "cuda")
    g.compile(AdamOptimizer(alpha=0.01), "mean_squared_error", ["mse"])
    x, y = synthetic_batch(DLRMConfig(**ARCH["cat"]), 16, seed=5)
    x["label"] = y
    for _ in range(3):
        g.train_batch(x)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(g, {"epoch": 0, "batch": 3})
    assert mgr.last_save["bytes"] > 0
    for dev in ("cuda", "cpu"):
        r = _model("cat", dev)
        r.compile(AdamOptimizer(alpha=0.01), "mean_squared_error", ["mse"])
        assert mgr.restore_latest(r)["step"] == 3 and r._step == 3
        for op, p in g.params.items():
            for pn, v in p.items():
                assert torch.equal(v.cpu(), r.params[op][pn].cpu())
        want, got = opt_state_to_jax(g, g.opt_state), opt_state_to_jax(
            r, r.opt_state)
        for k in ("m", "v"):
            for op in want[k]:
                for pn in want[k][op]:
                    np.testing.assert_array_equal(got[k][op][pn],
                                                  want[k][op][pn])
        assert int(got["step"]) == 3


def test_adam_step_size_on_card_matches_cpu(cuda):
    """``AdamOptimizer.alpha_t`` on the card BITWISE as on the CPU (which
    tests/test_torch_optimizers.py holds to jitted JAX) for steps
    0-99,999, vectorised and as 0-d steps."""
    opt = AdamOptimizer(alpha=0.001)
    steps = torch.arange(100_000, dtype=torch.int32)
    on_card = opt.alpha_t(steps.to(cuda)).cpu()
    want = opt.alpha_t(steps)
    assert torch.equal(on_card.view(torch.int32), want.view(torch.int32))
    for s in (0, 101, 3699, 18_013, 99_999):
        one = opt.alpha_t(torch.tensor(s, dtype=torch.int32, device=cuda))
        assert one.dim() == 0 and one.device.type == "cuda"
        assert float(one) == float(want[s])


# ---- the anomaly sentinel ---------------------------------------------------
def _sumsq_case(cuda, sizes, offsets, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    out = []
    for i, n in enumerate(sizes):
        o = offsets[i % len(offsets)]
        out.append(torch.randn(n + 4, device=cuda, generator=g)[o:o + n])
    return out


@pytest.mark.parametrize("sizes,offsets", [
    ([5000, 17, 0, 4096 * 4 + 3, 64 * 1024], [0, 1, 2, 3]),
    ([33] * 60, [0, 3]),                     # two launches
    ([1 << 22, 7, 256], [0]),
    ([], [0]),
])
def test_grad_sumsq_matches_plain(cuda, sizes, offsets):
    gs = _sumsq_case(cuda, sizes, offsets, seed=len(sizes))
    loss = torch.tensor(0.25, device=cuda)
    plan = dense_mod.launch_plan([g.numel() for g in gs],
                                 [(g.data_ptr(),) for g in gs])
    before = dense_mod.grad_sumsq.launches
    gsq, norm, ok = dense_mod.grad_sumsq(gs, loss)
    assert dense_mod.grad_sumsq.launches - before == max(len(plan), 1)
    want = dense_mod.grad_sumsq_reference([g.cpu() for g in gs],
                                          loss.cpu())
    exact = sum(float((g.double() ** 2).sum()) for g in gs)
    for got, w in zip((gsq, norm), want):
        assert got.dim() == 0 and got.device.type == "cuda"
        np.testing.assert_allclose(float(got), float(w), rtol=1e-5)
    np.testing.assert_allclose(float(gsq), exact, rtol=1e-5)
    assert ok.dtype == torch.int32 and int(ok) == int(want[2]) == 1
    again = dense_mod.grad_sumsq(gs, loss)
    assert float(again[0]) == float(gsq) and float(again[1]) == float(norm)
    if gs:
        for bad in (float("nan"), float("inf"), -float("inf")):
            g2 = [g.clone() for g in gs]
            g2[-1][g2[-1].numel() // 2] = bad
            assert int(dense_mod.grad_sumsq(g2, loss)[2]) == 0
            assert int(dense_mod.grad_sumsq(
                gs, torch.tensor(bad, device=cuda))[2]) == 0
        big = [torch.full((1024,), 3e19, device=cuda)]   # gsq overflows
        assert int(dense_mod.grad_sumsq(big, loss)[2]) == 0


@pytest.mark.parametrize("own,rep", [
    ([16 * 8 * 64], [5000, 17, 4096 * 4 + 3, 64 * 1024]),
    ([33] * 60, [1 << 20, 7]),               # the first form: two launches
    ([], [256]),
])
def test_grad_sumsq_across_ranks_two_launches(cuda, own, rep):
    """Across ranks: the first launch writes its sum into a slot of a
    buffer (``out``); the second adds the slot (``addend``) before the
    root and takes the buffer's loss. Bitwise the second list's own sum
    plus the slot in fp32 and its root; within rtol 1e-5 of the plain
    version's two calls and of the sum over both lists; the flag follows
    a non-finite value in either list or the loss."""
    a = _sumsq_case(cuda, own, [0, 1], seed=3)
    b = _sumsq_case(cuda, rep, [0, 2], seed=4)
    buf = torch.zeros(3, device=cuda)
    buf[2] = 0.5
    loss = buf[2]
    before = dense_mod.grad_sumsq.launches
    g1, _, _ = dense_mod.grad_sumsq(a, loss, out=buf[1:2])
    assert g1.data_ptr() == buf[1:2].data_ptr()
    gsq, norm, ok = dense_mod.grad_sumsq(b, loss, addend=buf[1:2])
    alone, _, _ = dense_mod.grad_sumsq(b, loss)
    want = (alone + buf[1]).view(())
    assert torch.equal(gsq, want) and torch.equal(norm, torch.sqrt(want))
    assert int(ok) == 1
    plan = dense_mod.launch_plan
    n = sum(max(len(plan([g.numel() for g in gs],
                         [(g.data_ptr(),) for g in gs])), 1)
            for gs in (a, b, b))
    assert dense_mod.grad_sumsq.launches - before == n
    pb = torch.zeros(3)
    pb[2] = 0.5
    dense_mod.grad_sumsq_reference([g.cpu() for g in a], pb[2], out=pb[1:2])
    pgsq, pnorm, pok = dense_mod.grad_sumsq_reference(
        [g.cpu() for g in b], pb[2], addend=pb[1:2])
    np.testing.assert_allclose(float(gsq), float(pgsq), rtol=1e-5)
    np.testing.assert_allclose(float(norm), float(pnorm), rtol=1e-5)
    exact = sum(float((g.double() ** 2).sum()) for g in a + b)
    np.testing.assert_allclose(float(gsq), exact, rtol=1e-5)
    assert int(pok) == 1
    if a:
        a[0][0] = float("nan")
        dense_mod.grad_sumsq(a, loss, out=buf[1:2])
        assert int(dense_mod.grad_sumsq(b, loss, addend=buf[1:2])[2]) == 0
    buf[1] = 0.0
    buf[2] = float("inf")
    assert int(dense_mod.grad_sumsq(b, buf[2], addend=buf[1:2])[2]) == 0


def test_grad_sumsq_one_launch_is_unchanged(cuda):
    """World 1: one launch, no addend, bitwise a rerun and the slot form's
    first launch (the same sum whether it lands in its own buffer or in
    a slot)."""
    gs = _sumsq_case(cuda, [5000, 17, 64 * 1024], [0, 1, 2], seed=9)
    loss = torch.tensor(0.25, device=cuda)
    before = dense_mod.grad_sumsq.launches
    one = dense_mod.grad_sumsq(gs, loss)
    assert dense_mod.grad_sumsq.launches - before == 1
    slot = torch.zeros(1, device=cuda)
    dense_mod.grad_sumsq(gs, loss, out=slot)
    assert torch.equal(one[0], slot.view(()))
    assert all(torch.equal(x, y)
               for x, y in zip(one, dense_mod.grad_sumsq(gs, loss)))


def _guarded_calls(cuda):
    """Each guarded entry as a call (table, slabs, ok): the dense update
    under Adam and SGD, the add and write scatters, the stateful update
    on its one-launch and its pre-pass route."""
    g = torch.Generator(device=cuda).manual_seed(21)
    rows, d, n = 4096, 64, 2048
    ids = torch.randint(0, rows, (n,), device=cuda, generator=g)
    ids[:8] = ids[0]
    upd = torch.randn(n, d, device=cuda, generator=g)
    fwd_src = torch.randn(rows, d, device=cuda, generator=g)
    adam = AdamOptimizer(alpha=0.01)
    at = adam.alpha_t(torch.tensor(3, dtype=torch.int32, device=cuda))
    sgd = SGDOptimizer(lr=0.1, momentum=0.9)
    grads = torch.randn(rows, d, device=cuda, generator=g)
    return {
        "dense_adam": lambda t, s, ok: dense_mod.dense_update(
            [t], [grads], [s], adam.row_params(), at, ok),
        "dense_momentum": lambda t, s, ok: dense_mod.dense_update(
            [t], [grads], [{"v": s["v"]}], sgd.row_params(), None, ok),
        "add": lambda t, s, ok: scatter_rows_mod.scatter_add_rows(
            t, ids, upd, -0.1, ok=ok),
        "write": lambda t, s, ok: scatter_rows_mod.scatter_write_rows(
            t, ids, upd, fwd_src[ids], -0.1, ok=ok),
        "stateful_fused": lambda t, s, ok: scatter_rows_mod._stateful_kernels(
            t, ids, upd, None, s, adam.row_params(), at, 1, True, ok),
        "stateful_presort": lambda t, s, ok:
            scatter_rows_mod._stateful_kernels(
                t, ids, upd, None, s, adam.row_params(), at, 1, False, ok),
    }, (rows, d)


@pytest.mark.parametrize("entry", ["dense_adam", "dense_momentum", "add",
                                   "write", "stateful_fused",
                                   "stateful_presort"])
def test_guarded_entries_honour_the_flag(cuda, entry):
    calls, (rows, d) = _guarded_calls(cuda)
    g = torch.Generator(device=cuda).manual_seed(22)
    table = torch.randn(rows, d, device=cuda, generator=g)
    slabs = {k: torch.rand(rows, d, device=cuda, generator=g)
             for k in ("m", "v")}
    outs = {}
    for ok in (None, 0, 1):
        t, s = table.clone(), {k: v.clone() for k, v in slabs.items()}
        calls[entry](t, s, None if ok is None else torch.tensor(
            ok, dtype=torch.int32, device=cuda))
        outs[ok] = [t, *s.values()]
    for a, b in zip(outs[0], [table, *slabs.values()]):
        assert torch.equal(a, b)
    for a, b in zip(outs[1], outs[None]):
        assert torch.equal(a, b)
    assert not torch.equal(outs[None][0], table)


def test_skip_step_on_card_matches_cpu(cuda):
    """Three "cat" steps under Adam with skip_step, the second poisoned,
    on the card and on the CPU from the same weights: one norm launch a
    step, the poisoned step leaves weights, state and Adam's step
    bitwise, and the runs agree as the stateful step does."""
    from dlrm_flexflow_tpu_torch.utils import faults
    runs = {}
    for dev in ("cuda", "cpu"):
        m = _model("cat", dev, None if dev == "cuda" else runs["cuda"][1])
        m.config.anomaly_policy = "skip_step"
        m.compile(AdamOptimizer(alpha=0.001), "mean_squared_error", ["mse"])
        init = {op: {n: v.clone() for n, v in p.items()}
                for op, p in m.params.items()}
        before = dense_mod.grad_sumsq.launches
        with faults.active_plan(faults.FaultPlan(nan_grad_steps={1})):
            for step in range(3):
                x, y = synthetic_batch(DLRMConfig(**ARCH["cat"]), 16,
                                       seed=5 + step)
                x["label"] = y
                if step == 1:
                    snap = ([v.clone() for p in m.params.values()
                             for v in p.values()],
                            int(m.opt_state["step"]))
                mets = m.train_batch(x)
                assert bool(mets["anomaly"]) == (step == 1)
                if step == 1:
                    assert all(torch.equal(a, b) for a, b in zip(
                        snap[0], [v for p in m.params.values()
                                  for v in p.values()]))
                    assert int(m.opt_state["step"]) == snap[1] == 1
        if dev == "cuda":
            assert dense_mod.grad_sumsq.launches - before == 3
        runs[dev] = (m, init)
    gpu, cpu = runs["cuda"][0], runs["cpu"][0]
    init = runs["cuda"][1]
    assert int(gpu.opt_state["step"]) == int(cpu.opt_state["step"]) == 2
    for op, p in cpu.params.items():
        for pn, v in p.items():
            dc = v - init[op][pn].cpu()
            dg = gpu.params[op][pn].cpu() - init[op][pn].cpu()
            assert float((dg - dc).abs().max()) <= 1e-2 * float(
                dc.abs().max()), (op, pn)


def test_staged_fit_on_card_equals_ring_fit(cuda):
    x, y = synthetic_batch(DLRMConfig(**ARCH["cat"]), 16 * 6 + 5, seed=9)
    runs = []
    for stage in ("auto", "never"):
        fm = _model("cat", "cuda")
        fm.config.stage_dataset = stage
        fm.compile(SGDOptimizer(lr=0.05, momentum=0.9), "mean_squared_error",
                   ["mse"])
        out = fm.fit(x, y, epochs=2, batch_size=16, verbose=False)
        assert out["num_samples"] == 2 * len(y)
        runs.append(fm)
    for op, p in runs[0].params.items():
        for pn, v in p.items():
            assert torch.equal(v, runs[1].params[op][pn]), (op, pn)


def _delta_payload(model, seed, n_rows=24):
    """A delta of random rows of every table and one whole bias, in the
    JAX stored layout (what ``utils.delta.load_delta_file`` returns)."""
    from dlrm_flexflow_tpu_torch.utils.weights import jax_param_shapes
    rng = np.random.RandomState(seed)
    rows, full = {}, {}
    for op, shapes in jax_param_shapes(model).items():
        for pn, shape in shapes.items():
            if len(shape) >= 2:
                n = int(np.prod(shape[:-1]))
                idx = np.sort(rng.choice(n, size=min(n_rows, n),
                                         replace=False)).astype(np.int64)
                rows[f"params/{op}/{pn}"] = (
                    idx, rng.randn(len(idx), shape[-1]).astype(np.float32))
            else:
                full[f"params/{op}/{pn}"] = rng.randn(*shape).astype(
                    np.float32)
    return {"step": 7, "prev_step": 0, "base_step": 0, "rows": rows,
            "full": full}


@pytest.mark.parametrize("mode", ["cat", "dot"])
def test_apply_delta_on_card_matches_cpu(cuda, mode):
    """A delta installed on the card, plain and staged on the side
    stream, is bitwise the CPU install (copies only)."""
    from dlrm_flexflow_tpu_torch.utils.delta import stage_delta_rows
    gpu = _model(mode, "cuda")
    staged = _model(mode, "cuda", gpu.params)
    cpu = _model(mode, "cpu", gpu.params)
    payload = _delta_payload(gpu, seed=1)
    gpu.apply_delta(payload)
    cpu.apply_delta(payload)
    st = stage_delta_rows(staged, payload)
    assert st["ready"] is not None and all(
        i.is_cuda and v.is_cuda for i, v in st["staged"].values())
    staged.apply_delta(st)
    for op, p in cpu.params.items():
        for pn, v in p.items():
            assert torch.equal(gpu.params[op][pn].cpu(), v), (op, pn)
            assert torch.equal(staged.params[op][pn].cpu(), v), (op, pn)
    assert gpu._step == staged._step == cpu._step == 7


@pytest.mark.parametrize("mode", ["cat", "dot"])
def test_staged_delta_under_traffic_serves_as_quiesced(cuda, mode):
    """Deltas staged on the side stream and installed through the engine
    while client threads keep the batcher busy give, after the last
    install, the scores of a model that took the same deltas quiesced;
    every answer before is finite and tagged with an installed
    version."""
    import threading
    from dlrm_flexflow_tpu_torch.utils.delta import stage_delta_rows
    live = _model(mode, "cuda")
    quiet = _model(mode, "cuda", live.params)
    x, _ = synthetic_batch(DLRMConfig(**ARCH[mode]), 16, seed=5)
    payloads = [dict(_delta_payload(live, seed=s), step=s)
                for s in (1, 2, 3)]
    for p in payloads:
        quiet.apply_delta(p)
    stop, errors, tags = threading.Event(), [], set()
    with InferenceEngine(live, ServeConfig(max_batch=16)) as eng:
        def client():
            try:
                while not stop.is_set():
                    r = eng.predict(x, timeout=60)
                    assert np.isfinite(r.scores).all()
                    tags.add(r.version)
            except Exception as e:   # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        for p in payloads:
            eng.install_delta(stage_delta_rows(live, p), p["step"])
        stop.set()
        for t in threads:
            t.join(60)
        got = eng.predict(x, timeout=60)
    assert not errors and tags <= {0, 1, 2, 3}
    assert got.version == 3 and eng.stats()["reload_rejects"] == 0
    want = quiet.forward_bucket(x, 16).cpu().numpy()
    np.testing.assert_array_equal(got.scores, want)


# ---------------------------------------------------------------------
# Criteo's non-uniform tables: the concatenated table at d = 16
# ---------------------------------------------------------------------
KAGGLE = DLRMConfig.criteo_kaggle().embedding_size


def _kaggle_ids(cuda, batch=256, seed=0, zipf=0.0):
    """The global ids of a batch into the concatenated Criteo-Kaggle
    table (11,386,880 rows), as ``EmbeddingBagConcat`` makes them."""
    m = pt.FFModel(pt.FFConfig(batch_size=batch, device="cuda"))
    ids = m.create_tensor((batch, len(KAGGLE), 1), dtype=torch.int64,
                          name="ids")
    m.embedding_concat(ids, KAGGLE, 16, name="emb")
    op = m.get_layer_by_name("emb")
    cfg = DLRMConfig.criteo_kaggle()
    cfg.zipf_alpha = zipf
    x, _ = synthetic_batch(cfg, batch, seed=seed)
    gid = op._global_ids(torch.as_tensor(x["sparse"], device=cuda))
    return op, gid


def test_concat_bag_kernel_matches_plain_at_kaggle(cuda):
    """The bag kernel over the concatenated table at d = 16 and the
    Kaggle step's 6,656 lookups, against its plain version on the CPU
    (rtol, atol 1e-6; bag 1: a copy), the gathered rows bitwise."""
    op, gid = _kaggle_ids(cuda)
    assert op.total_rows == 11_386_880 and gid.shape == (256 * 26, 1)
    g = torch.Generator(device=cuda).manual_seed(3)
    table = torch.randn(op.total_rows, 16, device=cuda, generator=g)
    before = embedding_bag.launches
    out, rows = embedding_bag(table, gid, "sum", return_rows=True)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    want, want_rows = embedding_bag_reference(table.cpu(), gid.cpu(), "sum",
                                              return_rows=True)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(rows.cpu(), want_rows)


@pytest.mark.parametrize("write", [False, True])
@pytest.mark.parametrize("zipf", [0.0, 1.1])
def test_concat_scatters_match_plain_at_kaggle(cuda, write, zipf):
    """Both scatters on the concatenated Kaggle table at d = 16, the
    step's 6,656 lookups (uniform and Zipf-skewed ids), bitwise against
    their plain versions on the CPU."""
    _, gid = _kaggle_ids(cuda, seed=1, zipf=zipf)
    ids = gid.reshape(-1)
    g = torch.Generator(device=cuda).manual_seed(4)
    table = torch.randn(11_386_880, 16, device=cuda, generator=g)
    upd = torch.randn(ids.shape[0], 16, device=cuda, generator=g)
    fwd = table[ids]
    got = table.clone()
    if write:
        scatter_write_rows(got, ids, upd, fwd, scale=-0.01,
                           ids_in_range=True)
        want = scatter_write_rows_reference(table.cpu(), ids.cpu(),
                                            upd.cpu(), fwd.cpu(), -0.01)
    else:
        scatter_add_rows(got, ids, upd, scale=-0.01, ids_in_range=True)
        want = scatter_add_rows_reference(table.cpu(), ids.cpu(), upd.cpu(),
                                          -0.01)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_concat_stateful_matches_plain_at_kaggle(cuda, name):
    """The stateful update on the concatenated Kaggle table at d = 16,
    6,656 lookups on the one-launch route, bitwise against its plain
    version on the CPU."""
    _, gid = _kaggle_ids(cuda, seed=2, zipf=1.1)
    ids = gid.reshape(-1)
    rows = 11_386_880
    g = torch.Generator(device=cuda).manual_seed(5)
    opt = STATEFUL[name]()
    table = torch.randn(rows, 16, device=cuda, generator=g)
    upd = torch.randn(ids.shape[0], 16, device=cuda, generator=g)
    slabs = {k: torch.rand(rows, 16, device=cuda, generator=g)
             for k in opt.sparse_slab_names()}
    fwd = table[ids]
    alpha_t = opt.alpha_t(torch.tensor(3, dtype=torch.int32, device=cuda))
    assert stateful_route(ids.shape[0], rows) == "fused"
    got, got_s = table.clone(), {k: v.clone() for k, v in slabs.items()}
    stateful_update_rows(got, ids, upd, fwd, got_s, opt.row_params(),
                         alpha_t, ids_in_range=True)
    want, want_s = table.cpu(), {k: v.cpu() for k, v in slabs.items()}
    stateful_update_rows_reference(
        want, ids.cpu(), upd.cpu(), fwd.cpu(), want_s, opt.row_params(),
        None if alpha_t is None else alpha_t.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for k in slabs:
        assert torch.equal(got_s[k].cpu(), want_s[k]), k


CRITEO_SMALL = dict(embedding_size=[1396, 550, 24681, 687, 20, 15],
                    sparse_feature_size=16, mlp_bot=[13, 64, 16])


@pytest.mark.parametrize("mode,host", [("cat", False), ("dot", False),
                                       ("cat", True), ("dot", True)])
def test_non_uniform_step_on_card_matches_cpu(cuda, mode, host):
    """One SGD step of a non-uniform DLRM (one concatenated table, "cat"
    or the unfused "dot", device tables or host tables in exact mode) on
    the card against the same step on the CPU from the same weights:
    rtol 1e-5, atol 1e-7, as the uniform step above."""
    T, d = 6, 16
    top0 = d + (T * d if mode == "cat" else (T + 1) * T // 2)
    dcfg = DLRMConfig(**CRITEO_SMALL, mlp_top=[top0, 32, 1],
                      arch_interaction_op=mode)
    models = []
    for dev in ("cuda", "cpu"):
        m = pt.FFModel(pt.FFConfig(batch_size=64, device=dev, seed=3,
                                   host_resident_tables=host,
                                   host_tables_async=False))
        build_dlrm(m, dcfg)
        m.compile(SGDOptimizer(lr=0.05), "mean_squared_error", ["mse"])
        m.init_layers()
        models.append(m)
    gpu, cpu = models
    cpu.swap_params({op: {n: v.cpu() for n, v in p.items()}
                     for op, p in gpu.params.items()},
                    host_params={k: {n: v.copy() for n, v in p.items()}
                                 for k, p in gpu.host_params.items()}
                    if host else None)
    x, y = synthetic_batch(dcfg, 64, seed=5)
    x["label"] = y
    lg = float(gpu.train_batch(dict(x))["loss"])
    lc = float(cpu.train_batch(dict(x))["loss"])
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for op, p in cpu.params.items():
        for pn, v in p.items():
            torch.testing.assert_close(gpu.params[op][pn].cpu(), v,
                                       rtol=1e-5, atol=1e-7)
    for op, p in cpu.host_params.items():
        np.testing.assert_allclose(gpu.host_params[op]["kernel"],
                                   p["kernel"], rtol=1e-5, atol=1e-7)


def test_topk_on_a_rewritten_shard_block_matches_plain(cuda):
    """The index riding a 4-shard ranker tier on the card: a publish
    rewrites rows of every shard's block (``augment_delta`` through the
    tier's routing), and each shard's top-k kernel on its rewritten block
    is BITWISE its plain version on the same codes."""
    from dlrm_flexflow_tpu_torch.serve import EmbeddingShardSet
    dcfg = DLRMConfig(embedding_size=[5000] * 4, sparse_feature_size=16,
                      mlp_bot=[13, 64, 16], mlp_top=[80, 32, 1])
    m = pt.FFModel(pt.FFConfig(batch_size=64, device="cuda", seed=3,
                               host_resident_tables=True,
                               host_tables_async=False))
    build_dlrm(m, dcfg)
    m.compile(SGDOptimizer(lr=0.05), "mean_squared_error", ["mse"])
    m.init_layers()
    sset = EmbeddingShardSet.build(m, 4)
    g = torch.Generator(device=cuda).manual_seed(8)
    idx = ShardedMIPSIndex.build(
        sset, torch.randn(20_000, 32, device=cuda, generator=g))
    try:
        rng = np.random.RandomState(2)
        ids = np.unique(rng.randint(0, 20_000, 3000))
        payload = {"rows": {}, "full": {}}
        idx.augment_delta(payload, ids,
                          5 * rng.randn(ids.size, 32).astype(np.float32))
        assert sset.apply_delta(payload, 8) == 4
        users = torch.randn(64, 32, device=cuda, generator=g)
        qc, qs = quantize_query(users)
        for rep in sset.shards:
            blk = rep.shard.blocks_copy()[0]["retrieve_index"]
            lo, _ = rep.shard.owned_range("retrieve_index")
            before = mips_topk.launches
            got_s, got_i = mips_topk(qc, qs, blk.q, blk.scales, 100,
                                     base=lo)
            torch.cuda.synchronize()
            assert mips_topk.launches == before + 1
            want_s, want_i = mips_topk_reference(qc, qs, blk.q, blk.scales,
                                                 100, base=lo)
            assert torch.equal(got_i, want_i)
            assert torch.equal(got_s.view(torch.int32),
                               want_s.view(torch.int32))
        r = idx.topk(users, 100, deadline_s=60.0)
        s, i = idx.exact_scan(users, 100)
        assert r.versions == {0: 8, 1: 8, 2: 8, 3: 8}
        np.testing.assert_array_equal(r.ids, i)
        np.testing.assert_array_equal(r.scores.view(np.uint32),
                                      s.view(np.uint32))
    finally:
        sset.close()


def test_sharded_engine_rows_match_plain(cuda):
    """An engine on a 4-shard tier with the row cache, on the card: the
    rows it gathers through the tier and copies in are BITWISE the host
    gather's, and its scores BITWISE the model's direct forward (the same
    kernels at the same shapes)."""
    from dlrm_flexflow_tpu_torch.serve import EmbeddingShardSet
    dcfg = DLRMConfig(embedding_size=[1396, 550, 24681, 687, 20, 15],
                      sparse_feature_size=16, mlp_bot=[13, 64, 16],
                      mlp_top=[37, 32, 1], arch_interaction_op="dot")
    m = pt.FFModel(pt.FFConfig(batch_size=64, device="cuda", seed=3,
                               host_resident_tables=True,
                               host_tables_async=False))
    build_dlrm(m, dcfg)
    m.compile(SGDOptimizer(lr=0.05), "mean_squared_error", ["mse"])
    m.init_layers()
    x, _ = synthetic_batch(dcfg, 32, seed=6)
    direct = m.forward_bucket(x, bucket=32).cpu().numpy()
    sset = EmbeddingShardSet.build(m, 4)
    eng = InferenceEngine(m, ServeConfig(max_batch=32, cache_rows=64),
                          shard_set=sset).start()
    try:
        (op,) = m._host_resident_list
        host_idx = {op.name: np.asarray(x["sparse"])}
        plain = m._host_emb_forward(host_idx)[op.name]
        got = eng._shard_gather()(host_idx)[op.name]
        assert got.device.type == "cuda"
        assert torch.equal(got, plain)
        for _ in range(2):          # misses, then cache hits
            p = eng.predict(x)
            np.testing.assert_array_equal(p.scores, direct)
            assert p.versions == {0: 0, 1: 0, 2: 0, 3: 0}
    finally:
        eng.close()
        sset.close()


def test_fleet_replicas_and_a_remote_shard_answer_bitwise(cuda, tmp_path):
    """Two in-process replicas on the card behind the router answer each
    request BITWISE as one engine does (each replica its own model of the
    same seed, the same kernels at the same shapes); an engine on the
    card whose tier is a RemoteShard per slot over loopback answers
    BITWISE as the engine on the in-process tier."""
    from dlrm_flexflow_tpu_torch.serve import (EmbeddingShardSet, Fleet,
                                               FleetRouter, RouterConfig)
    from dlrm_flexflow_tpu_torch.serve.shard_server import build_shard
    dcfg = DLRMConfig(embedding_size=[1396, 550, 24681, 687, 20, 15],
                      sparse_feature_size=16, mlp_bot=[13, 64, 16],
                      mlp_top=[37, 32, 1], arch_interaction_op="dot")

    def model(host):
        m = pt.FFModel(pt.FFConfig(batch_size=64, device="cuda", seed=3,
                                   host_resident_tables=host,
                                   host_tables_async=False))
        build_dlrm(m, dcfg)
        m.compile(SGDOptimizer(lr=0.05), "mean_squared_error", ["mse"])
        m.init_layers()
        return m

    reqs = [synthetic_batch(dcfg, 16, seed=20 + i)[0] for i in range(6)]
    one = InferenceEngine(model(False), ServeConfig(max_batch=16)).start()
    router = FleetRouter(Fleet.build(lambda i: model(False), 2,
                                     ServeConfig(max_batch=16)),
                         RouterConfig()).start()
    try:
        for x in reqs:
            np.testing.assert_array_equal(router.predict(x).scores,
                                          one.predict(x).scores)
        per = [r.engine.stats()["requests"] for r in router.fleet]
        assert sum(per) == len(reqs) and min(per) > 0
    finally:
        router.close()
        one.close()
    m = model(True)
    local = EmbeddingShardSet.build(m, 2)
    EmbeddingShardSet.seed_shard_cache(m, 2, str(tmp_path))
    servers = [build_shard(str(tmp_path), 2, s).serve() for s in range(2)]
    remote = EmbeddingShardSet.connect([s.address for s in servers],
                                       cache_dir=str(tmp_path))
    engines = [InferenceEngine(m, ServeConfig(max_batch=16),
                               shard_set=s).start() for s in (local, remote)]
    try:
        for x in reqs:
            a, b = (e.predict(x) for e in engines)
            np.testing.assert_array_equal(a.scores, b.scores)
            assert a.versions == b.versions == {0: 0, 1: 0}
            assert not b.degraded
    finally:
        for e in engines:
            e.close()
        remote.close()
        local.close()
        for s in servers:
            s.close()


# ---------------------------------------------------------------------
# the row fake-quant kernel (csrc/quant_rows.cu)
# ---------------------------------------------------------------------
def _quant_rows(cuda, rows, d, seed):
    """Rows with the codec's edges: all-zero, -0.0, at +-qmax codes, one
    value a row, fp8 subnormals, then random rows."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(rows, d, device=cuda, generator=g) * torch.rand(
        rows, 1, device=cuda, generator=g)
    x[0] = 0.0
    x[1] = -0.0
    sign = torch.where(torch.arange(d, device=cuda) % 2 == 1, 1.0, -1.0)
    x[2] = sign * 127.0 * 0.01
    x[3] = sign * 448.0 * 0.5
    x[4] = 3.0
    x[5] = x[5] * 1e-30
    return x


@pytest.mark.parametrize("dt", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("d", [8, 16, 64, 128, 10, 200, 1024])
def test_fake_quant_kernel_matches_plain(cuda, dt, d):
    """Nearest on every dtype and the "noise" stochastic entry (int8):
    BITWISE the plain version on the card fed the same draws."""
    from dlrm_flexflow_tpu_torch.ops.kernels.quant_rows import (
        fake_quant_rows, fake_quant_rows_reference)
    x = _quant_rows(cuda, 3000, d, seed=d)
    a, b = x.clone(), x.clone()
    fake_quant_rows(a, dt, "nearest")
    fake_quant_rows_reference(b, dt, "nearest")
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if dt == "int8":
        u = torch.rand(x.shape, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(1))
        a, b = x.clone(), x.clone()
        fake_quant_rows(a, dt, "stochastic", u=u)
        fake_quant_rows_reference(b, dt, "stochastic", u=u)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("d", [8, 64, 128, 10])
def test_fake_quant_kernel_philox_matches_plain(cuda, d):
    """The Philox entry draws the plain version's philox_uniform bits:
    BITWISE; its codes are floor or floor + 1 of x / s, and the mean of
    2,048 draws of one row is within 6 standard errors of x / s."""
    from dlrm_flexflow_tpu_torch.ops.kernels.quant_rows import (
        fake_quant_rows, fake_quant_rows_reference)
    x = _quant_rows(cuda, 5000, d, seed=7)
    a, b = x.clone(), x.clone()
    key = dict(seed=(3 << 40) + 17, step=9, salt=0x53, row0=123)
    fake_quant_rows(a, "int8", "stochastic", **key)
    fake_quant_rows_reference(b, "int8", "stochastic", **key)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    row = x[6:7]
    reps = 2048
    r = row.repeat(reps, 1).contiguous()
    fake_quant_rows(r, "int8", "stochastic", seed=5, step=1, salt=0x51)
    s = row.abs().amax() / torch.tensor(127.0, device=cuda)
    codes, want = (r / s).double(), (row / s).double()
    lo = torch.floor(want)
    assert bool((((codes - lo).abs() < 1e-3)
                 | ((codes - lo - 1).abs() < 1e-3)).all())
    frac = want - lo
    se = torch.sqrt(frac * (1 - frac) / reps) + 1e-6
    assert bool(((codes.mean(0) - want[0]).abs() <= 6 * se[0] + 1e-4).all())


def test_fake_quant_kernel_honours_the_flag_and_raises(cuda):
    from dlrm_flexflow_tpu_torch.ops.kernels.quant_rows import (
        fake_quant_rows)
    x = _quant_rows(cuda, 100, 64, seed=3)
    y = x.clone()
    fake_quant_rows(y, "int8", "stochastic", seed=1,
                    ok=torch.zeros((), dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(y, x)
    fake_quant_rows(y, "int8", "stochastic", seed=1,
                    ok=torch.ones((), dtype=torch.int32, device=cuda))
    z = x.clone()
    fake_quant_rows(z, "int8", "stochastic", seed=1)
    assert torch.equal(y, z)
    with pytest.raises(ValueError, match="contiguous"):
        fake_quant_rows(x.t(), "int8")
    with pytest.raises(ValueError, match="at most"):
        fake_quant_rows(torch.zeros(2, 2048, device=cuda), "int8")


def test_stochastic_rounding_step_launches_once_per_table(cuda):
    """A device step under stochastic rounding re-quantizes its stacked
    table with one kernel launch, and the table holds quantized rows
    afterwards."""
    from dlrm_flexflow_tpu_torch.ops.kernels.quant_rows import (
        fake_quant_rows)
    dcfg = DLRMConfig(embedding_size=[4096] * 4, sparse_feature_size=64,
                      mlp_bot=[4, 16, 64], mlp_top=[320, 16, 1])
    m = pt.FFModel(pt.FFConfig(batch_size=64, emb_dtype="int8",
                               emb_update_rule="stochastic_rounding"))
    build_dlrm(m, dcfg)
    m.compile(SGDOptimizer(lr=0.05), "mean_squared_error", ["mse"])
    m.init_layers()
    x, y = synthetic_batch(dcfg, 64, seed=1)
    x["label"] = y
    n0 = fake_quant_rows.launches
    m.train_batch(x)
    m.train_batch(x)
    assert fake_quant_rows.launches - n0 == 2
    # every row its integer codes times one scale: amax / 127, or amax /
    # 126 where the rounding took the largest value (an ulp short of
    # 127) down to 126
    v = m.params["emb_stack"]["kernel"].view(-1, 128)
    amax = v.abs().amax(dim=1)
    errs = []
    for n in (127.0, 126.0):
        s = amax / torch.full_like(amax, n)
        y = v / torch.where(s > 0, s, torch.ones_like(s))[:, None]
        errs.append((y - torch.round(y)).abs().amax(dim=1))
    assert float(torch.minimum(*errs).max()) < 1e-3


# ---- the row-sharded exchange's owner side (parallel/alltoall.py) ---------
ROW_S, ROW_N, ROW_D = 2, 8192, 64          # peers, lookups a rank, width
ROW_BLOCK = 8 * 524_288                     # 8 tables x 1M rows / 2 ranks


def _received(cuda, seed):
    """What a rank of a 2-rank full-width run receives in its update
    exchange: a block of ROW_N slots from each peer, its lookups first
    (duplicate-heavy row ids in the block, the peer's global positions in
    ascending order), then pads (the sentinel row, int32-max position,
    zero rows)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rid, pos, upd = [], [], []
    for j in range(ROW_S):
        k = int(torch.randint(ROW_N // 2, ROW_N, (1,), generator=g))
        hot = torch.randint(0, 64, (k,), generator=g)
        cold = torch.randint(0, ROW_BLOCK, (k,), generator=g)
        ids = torch.where(torch.rand(k, generator=g) < 0.5, hot, cold)
        p = torch.sort(torch.randperm(ROW_N, generator=g)[:k]).values
        rid.append(torch.cat([ids, torch.full((ROW_N - k,), ROW_BLOCK)]))
        pos.append(torch.cat([j * ROW_N + p,
                              torch.full((ROW_N - k,), 2 ** 31 - 1)]))
        upd.append(torch.cat([torch.randn(k, ROW_D, generator=g),
                              torch.zeros(ROW_N - k, ROW_D)]))
    return (torch.cat(rid).to(cuda), torch.cat(pos).to(cuda),
            torch.cat(upd).to(cuda))


@pytest.mark.parametrize("mode", ["grad", "sgd", "momentum", "adam"])
def test_routed_updates_match_plain_at_a_rank_shape(cuda, mode):
    from dlrm_flexflow_tpu_torch.parallel.alltoall import _combine_received
    rid, pos, upd = _received(cuda, seed=len(mode))
    before = scatter_add_rows.launches
    got_id, got_p = _combine_received(rid, pos, upd, ROW_N, ROW_BLOCK)
    want_id, want_p = _combine_received(rid.cpu(), pos.cpu(), upd.cpu(),
                                        ROW_N, ROW_BLOCK)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1     # the segment sums
    assert torch.equal(got_id.cpu(), want_id)
    assert torch.equal(got_p.cpu(), want_p)
    assert int((want_id < 0).sum()) > 0                 # pads are there
    g = torch.Generator(device=cuda).manual_seed(3)
    table = torch.randn(ROW_BLOCK, ROW_D, device=cuda, generator=g)
    if mode in ("grad", "sgd"):
        got = torch.zeros_like(table) if mode == "grad" else table.clone()
        want = got.cpu()
        scale = 1.0 if mode == "grad" else -0.01
        scatter_add_rows(got, got_id, got_p, scale, ids_in_range=True)
        scatter_add_rows_reference(want, want_id, want_p, scale)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        return
    opt = STATEFUL[mode]()
    slabs = {k: torch.rand(ROW_BLOCK, ROW_D, device=cuda, generator=g)
             for k in opt.sparse_slab_names()}
    alpha_t = opt.alpha_t(torch.tensor(2, dtype=torch.int32, device=cuda))
    got, got_s = table.clone(), {k: v.clone() for k, v in slabs.items()}
    stateful_update_rows(got, got_id, got_p, None, got_s, opt.row_params(),
                         alpha_t, ids_in_range=True)
    want, want_s = table.cpu(), {k: v.cpu() for k, v in slabs.items()}
    stateful_update_rows_reference(
        want, want_id, want_p, None, want_s, opt.row_params(),
        None if alpha_t is None else alpha_t.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for k in slabs:
        assert torch.equal(got_s[k].cpu(), want_s[k]), k


def test_owner_gather_matches_plain_at_a_rank_shape(cuda):
    """The owner's gather of the ids it received, the sentinel (a pad)
    clamped to the last row and its row zeroed, as the exchange does."""
    from dlrm_flexflow_tpu_torch.parallel.alltoall import _gather_rows
    rid, _, _ = _received(cuda, seed=11)
    g = torch.Generator(device=cuda).manual_seed(4)
    table = torch.randn(ROW_BLOCK, ROW_D, device=cuda, generator=g)
    valid = rid < ROW_BLOCK
    before = embedding_bag.launches
    got = torch.where(valid[:, None],
                      _gather_rows(table, rid.clamp(max=ROW_BLOCK - 1)), 0.0)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    want = embedding_bag_reference(
        table.cpu(), rid.cpu().clamp(max=ROW_BLOCK - 1).reshape(-1, 1))
    want = torch.where(valid.cpu()[:, None], want, 0.0)
    assert torch.equal(got.cpu(), want)


# ---- tables split across ranks (parallel/split.py) -------------------------
# Criteo-Kaggle's concatenated table (11,386,880 padded rows) in 2 row
# blocks, and a global batch of 512 (run_criteo_kaggle.sh at -ll:gpu 2)
KAGGLE_BLOCK = 11_386_880 // 2
KAGGLE_N = 512 * 26


def test_windowed_scatter_at_a_kaggle_row_block(cuda):
    """Kernel 4 at a Kaggle row block's shape: the global batch's 13,312
    lookups, about half of them in rank 1's block of 5.7M rows, d = 16,
    BITWISE its plain version on the CPU (the same scaled updates summed
    in lookup order)."""
    g = torch.Generator(device=cuda).manual_seed(24)
    lo = KAGGLE_BLOCK
    block = torch.randn(KAGGLE_BLOCK, 16, device=cuda, generator=g)
    ids = torch.randint(0, 2 * KAGGLE_BLOCK, (KAGGLE_N,), device=cuda,
                        generator=g)
    ids[:64] = lo + 5                          # a hot row
    upd = torch.randn(KAGGLE_N, 16, device=cuda, generator=g)
    got = scatter_rows_mod.sharded_scatter_add_rows(block.clone(), ids, upd,
                                                    lo, scale=-0.01)
    want = scatter_rows_mod.sharded_scatter_add_rows_reference(
        block.cpu(), ids.cpu(), upd.cpu(), lo, scale=-0.01)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("aggr", ["sum", "avg"])
@pytest.mark.parametrize("bag", [1, 2])
def test_bag_kernel_masks_ids_outside_a_row_block(cuda, aggr, bag):
    """The row block's masked bags: a negative id adds a zero row, as the
    plain version's; bitwise at bag 1 and 2 (a sum of at most two rows
    and zeros in bag order on both sides)."""
    g = torch.Generator(device=cuda).manual_seed(bag)
    table = torch.randn(100_000, 16, device=cuda, generator=g)
    ids = torch.randint(-100_000, 100_000, (KAGGLE_N, bag), device=cuda,
                        generator=g).clamp(min=-1)
    got = embedding_bag(table, ids, aggr)
    want = embedding_bag_reference(table.cpu(), ids.cpu(), aggr)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert not got[(ids < 0).all(1)].any()


@pytest.mark.parametrize("d,cols", [(64, 32), (16, 8), (32, 8)])
def test_bag_and_scatter_kernels_on_a_width_slice(cuda, d, cols):
    """An Embedding split by width: the bag kernel (kernel 1) and the
    scatter (kernel 3) on a rank's columns, a (rows, cols) slice of a
    (rows, d) table (a (rows, 32) slice of a (rows, 64) table, and
    d = 8), with a global batch's ids: each BITWISE its plain version,
    and the slice's bags the columns of the whole table's."""
    rows, n, bag = 1_000_000, 2048, 1
    g = torch.Generator(device=cuda).manual_seed(d + cols)
    whole = torch.randn(rows, d, device=cuda, generator=g)
    piece = whole[:, cols:2 * cols].contiguous()
    ids = torch.randint(0, rows, (n, bag), device=cuda, generator=g)
    got = embedding_bag(piece, ids)
    want = embedding_bag_reference(piece.cpu(), ids.cpu())
    full = embedding_bag(whole, ids)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, full[:, cols:2 * cols])
    upd = torch.randn(n, cols, device=cuda, generator=g)
    flat = ids.reshape(-1)
    got = scatter_add_rows(piece.clone(), flat, upd, scale=-0.01, div=bag,
                           ids_in_range=True)
    want = scatter_add_rows_reference(piece.cpu(), flat.cpu(), upd.cpu(),
                                      scale=-0.01, div=bag)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# ---- every optimizer on tables split across ranks ------------------------


@pytest.mark.parametrize("name", ["sgd_wd", "nesterov_wd", "adam"])
@pytest.mark.parametrize("n,div,lo,rows", [
    (KAGGLE_N, 1, KAGGLE_BLOCK, KAGGLE_BLOCK),    # a Kaggle row block
    (4096, 1, 4_000_000, 4_000_000),              # "cat": 4 of 8 tables
    (2048, 2, 1000, 30000), (20000, 1, 5000, 20000), (999, 3, 0, 777)])
def test_windowed_stateful_kernel_matches_plain(cuda, name, n, div, lo,
                                                rows):
    """Kernel 2's stateful entry over the window [lo, lo + rows) of a
    table (``stateful_update_rows(lo=)``), on the one-launch route (n up
    to FUSED_MAX) and on the pre-pass routes: BITWISE its plain version
    on the CPU over the masked ids (``window_ids``), weights and slabs;
    an id outside the window, or a pad, changes nothing."""
    g = torch.Generator(device=cuda).manual_seed(n + lo)
    opt = STATEFUL[name]()
    d = 16 if rows > 1_000_000 else 64
    block = torch.randn(rows, d, device=cuda, generator=g)
    ids = torch.randint(0, lo + 2 * rows, (n,), device=cuda, generator=g)
    ids[:8] = lo + 3                                 # a hot row
    ids[9] = -1
    upd = torch.randn(n // div, d, device=cuda, generator=g)
    slabs = {k: torch.rand(rows, d, device=cuda, generator=g)
             for k in opt.sparse_slab_names()}
    alpha_t = opt.alpha_t(torch.tensor(2, dtype=torch.int32, device=cuda))
    want, want_s = block.cpu(), {k: v.cpu() for k, v in slabs.items()}
    stateful_update_rows_reference(
        want, scatter_rows_mod.window_ids(ids, lo, rows).cpu(), upd.cpu(),
        None, want_s, opt.row_params(),
        None if alpha_t is None else alpha_t.cpu(), div)
    route = stateful_route(n, rows)
    for fused in ((True, False) if route == "fused" else (False,)):
        got, got_s = block.clone(), {k: v.clone() for k, v in slabs.items()}
        before = dict(stateful_update_rows.routes)
        if fused:
            stateful_update_rows(got, ids, upd, None, got_s,
                                 opt.row_params(), alpha_t, div, lo=lo)
            assert stateful_update_rows.routes["fused"] \
                == before["fused"] + 1
        else:
            scatter_rows_mod._stateful_kernels(got, ids, upd, None, got_s,
                                               opt.row_params(), alpha_t,
                                               div, False, lo=lo)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), fused
        for k in slabs:
            assert torch.equal(got_s[k].cpu(), want_s[k]), (fused, k)


def _same_bits(a, b):
    """a and b (fp32, one on the card) NaN at the same places and bitwise
    equal elsewhere (a NaN's payload is the device's own)."""
    a, b = a.cpu(), b.cpu()
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.parametrize("dt,mode", [("int8", "stochastic"),
                                     ("int8", "nearest"),
                                     ("fp8", "nearest")])
@pytest.mark.parametrize("d,pieces", [(64, 2), (16, 2), (128, 4), (64, 8)])
def test_width_piece_rounding_passes_match_plain(cuda, dt, mode, d, pieces):
    """The two passes of a width piece's rounding: ``row_amax`` of each
    piece BITWISE its plain version; their max (the fp32 bits as int32),
    then ``fake_quant_rows_amax`` at the piece's columns BITWISE its
    plain version on the CPU and BITWISE the whole rows'
    ``fake_quant_rows`` (the kernel) at those columns; a NaN in a row's
    piece reaches every piece of the row."""
    from dlrm_flexflow_tpu_torch.ops.kernels import quant_rows as qr
    rows = 100_000
    g = torch.Generator(device=cuda).manual_seed(d + pieces)
    whole = torch.randn(rows, d, device=cuda, generator=g) * torch.rand(
        rows, 1, device=cuda, generator=g)
    whole[7] = 0.0
    whole[11, 1] = float("nan")
    draws = (dict(seed=(5 << 33) + 1, step=4, salt=0x53)
             if mode == "stochastic" else {})
    want_whole = qr.fake_quant_rows(whole.clone(), dt, mode, row0=9,
                                    **draws)
    dc = d // pieces
    parts = [whole[:, k * dc:(k + 1) * dc].contiguous()
             for k in range(pieces)]
    amax = torch.stack([qr.row_amax(x) for x in parts])
    for k, x in enumerate(parts):
        assert _same_bits(amax[k], qr.row_amax_reference(x.cpu())), k
    top = amax.view(torch.int32).amax(dim=0).view(torch.float32)
    assert bool(torch.isnan(top[11]))
    for k, x in enumerate(parts):
        want = qr.fake_quant_rows_reference(x.cpu(), dt, mode, row0=9,
                                            amax=top.cpu(), col0=k * dc,
                                            **draws)
        qr.fake_quant_rows_amax(x, top, dt, mode, row0=9, col0=k * dc,
                                **draws)
        torch.cuda.synchronize()
        assert _same_bits(x, want), k
        assert _same_bits(x, want_whole[:, k * dc:(k + 1) * dc]), k
