"""The port's retrieve -> rank cascade against the JAX package.

- Top-k: the port's plain ``mips_topk_reference`` equals the JAX Pallas
  ``mips_topk`` in interpret mode (d = 128) and the JAX oracle (d = 32)
  bit for bit, scores and ids: planted ties, ``k > R``, ``R == 0``,
  ``base != 0``, and -0.0 scores (an underflowing scale product against
  a negative dot), which tie with +0.0 and fall to the id order.
- Index: the merged answer over ``standalone_set(n)``, n in {1, 2, 4},
  equals the port's and the JAX package's ``exact_scan`` bitwise, ties
  across shards included (as tests/test_retrieve.py:85-130 pins the JAX
  index). Degradation (tests/test_retrieve.py:236-273): a slot ejected
  through its circuit breaker drops its candidates, flagged, the answer
  is the exact top-k over the rows that answered, and ``degrade="fail"``
  raises.
- Heads: the JAX "user" and "item" heads' weights carried across with
  ``params_from_jax``; ``forward_batch`` and ``item_embeddings`` agree
  within rtol 1e-5, atol 1e-6 (the MLPs' products sum in other fp32
  orders in XLA and in PyTorch).
- The train head (in-batch logits, the sampled softmax over the batch):
  its batches and labels bitwise the JAX package's, its strategy the
  same configs; 3 SGD steps from the JAX weights: the loss within rtol
  1e-5 and every parameter's update within 1e-3 of its largest update
  (the MLPs and the logits' product sum in other fp32 orders; the
  tables take the touched-rows update in both); the towers then serve
  through ``transfer_tower_params``: the user and item heads within rtol
  1e-5, atol 1e-6 of the JAX heads given the JAX towers.
- Cascade: a fixed-projection encoder on both sides (as
  benchmarks/bench_retrieve.py does) and a small DLRM ranker with the
  same weights: retrieval ids and scores bitwise, ranker scores within
  1e-5, the final order the lexsort of those scores; validation, the
  spent-budget ``DeadlineExceeded``, the all-shards-dead empty answer,
  and the ranker's ``degraded``/``versions`` read from a port engine.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.ops.pallas.topk_kernel import (
    mips_topk as jax_mips_topk,
    mips_topk_reference as jax_mips_topk_reference,
    quantize_query as jax_quantize_query)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh
from dlrm_flexflow_tpu.retrieve import (
    CascadeConfig as JaxCascadeConfig, CascadeEngine as JaxCascadeEngine,
    ShardedMIPSIndex as JaxIndex, TwoTowerConfig as JaxTwoTowerConfig,
    build_two_tower as jax_build_two_tower,
    dlrm_candidate_features as jax_candidate_features,
    in_batch_labels as jax_in_batch_labels,
    item_embeddings as jax_item_embeddings,
    synthetic_two_tower_batch as jax_synthetic_two_tower_batch,
    transfer_tower_params as jax_transfer_tower_params,
    two_tower_strategy as jax_two_tower_strategy)
from dlrm_flexflow_tpu.serve.engine import Prediction as JaxPrediction

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.ops.kernels import build
from dlrm_flexflow_tpu_torch.ops.kernels import topk as topk_mod
from dlrm_flexflow_tpu_torch.ops.kernels.topk import (
    mips_topk, mips_topk_reference, quantize_query)
from dlrm_flexflow_tpu_torch.retrieve import (
    CascadeConfig, CascadeEngine, ShardedMIPSIndex, TwoTowerConfig,
    build_two_tower, dlrm_candidate_features, in_batch_labels,
    item_embeddings, merge_partials, synthetic_two_tower_batch,
    transfer_tower_params, two_tower_strategy)
from dlrm_flexflow_tpu_torch.serve import (DeadlineExceeded,
                                           InferenceEngine, Prediction,
                                           ServeConfig)
from dlrm_flexflow_tpu_torch.serve.shardtier import (ShardTierUnavailable,
                                                     shard_row_ranges)
from dlrm_flexflow_tpu_torch.utils.weights import params_from_jax

DIM = 16
N_ITEMS = 512
DEADLINE = 30.0      # generous per-shard budget: these tests pin
#                      exactness, not latency


def _items(n=N_ITEMS, dim=DIM, seed=0):
    return np.random.RandomState(seed).randn(n, dim).astype(np.float32)


def _users(b=8, dim=DIM, seed=1):
    return np.random.RandomState(seed).randn(b, dim).astype(np.float32)


def _index(items, nshards):
    sset = ShardedMIPSIndex.standalone_set(nshards)
    return (ShardedMIPSIndex.build(sset, torch.from_numpy(items),
                                   device="cpu"), sset)


def _jax_index(items, nshards):
    sset = JaxIndex.standalone_set(nshards)
    return JaxIndex.build(sset, items), sset


def _equal_bits(got_s, got_i, want_s, want_i):
    """Scores compared by their bits (-0.0 is not +0.0), ids exactly."""
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    assert got_s.dtype == np.float32 and want_s.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.view(np.uint32),
                                  want_s.view(np.uint32))


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


# ---------------------------------------------------------------------
# the plain top-k against the JAX kernel and oracle
# ---------------------------------------------------------------------
class TestTopK:
    def test_plain_matches_jax_interpret_kernel(self):
        # lane-aligned width for the Pallas kernel; forced ties
        items = np.tile(_items(16, dim=128), (8, 1))
        codes, scales = jax_quantize_query(items)
        q_codes, q_scales = jax_quantize_query(_users(4, dim=128))
        ks, ki = jax_mips_topk(q_codes, q_scales, codes, scales, 8,
                               interpret=True, chunk=32)
        got_s, got_i = mips_topk(*_t(q_codes, q_scales, codes, scales), 8)
        _equal_bits(got_s.numpy(), got_i.numpy(), ks, ki)
        # the port quantizes the query as the JAX codec does
        tq, ts = quantize_query(torch.from_numpy(_users(4, dim=128)))
        np.testing.assert_array_equal(tq.numpy(), q_codes)
        np.testing.assert_array_equal(ts.numpy(), q_scales)

    @pytest.mark.parametrize("k,base", [(10, 0), (300, 0), (25, 1000)])
    def test_plain_matches_jax_oracle(self, k, base):
        items = np.tile(_items(50, dim=32, seed=2), (4, 1))    # R = 200
        codes, scales = jax_quantize_query(items)
        q_codes, q_scales = jax_quantize_query(_users(6, dim=32, seed=3))
        rs, ri = jax_mips_topk_reference(q_codes, q_scales, codes, scales,
                                         k, base)
        got_s, got_i = mips_topk(*_t(q_codes, q_scales, codes, scales), k,
                                 base=base)
        assert got_s.shape == (6, min(k, 200))
        _equal_bits(got_s.numpy(), got_i.numpy(), rs, ri)

    def test_negative_zero_scores_tie_with_zero(self):
        rng = np.random.RandomState(4)
        codes = rng.randint(-127, 128, size=(64, 32)).astype(np.int8)
        scales = np.abs(rng.randn(64)).astype(np.float32)
        scales[::3] = 1e-30            # x 1e-20 underflows to 0 -> +-0.0
        scales[::7] = 0.0
        q_codes = rng.randint(-127, 128, size=(3, 32)).astype(np.int8)
        q_scales = np.asarray([1e-20, 0.5, 1e-20], np.float32)
        rs, ri = jax_mips_topk_reference(q_codes, q_scales, codes, scales,
                                         64)
        assert (np.signbit(rs) & (rs == 0)).any()      # -0.0 occurs
        got_s, got_i = mips_topk(*_t(q_codes, q_scales, codes, scales), 64)
        _equal_bits(got_s.numpy(), got_i.numpy(), rs, ri)

    def test_empty_block_and_bad_inputs(self):
        q = torch.zeros(3, 8, dtype=torch.int8)
        s, i = mips_topk(q, torch.ones(3), torch.zeros(0, 8,
                                                       dtype=torch.int8),
                         torch.zeros(0), 5)
        assert s.shape == (3, 0) and i.shape == (3, 0)
        assert s.dtype == torch.float32 and i.dtype == torch.int64
        codes = torch.zeros(10, 8, dtype=torch.int8)
        with pytest.raises(ValueError, match="do not fit"):
            mips_topk(q, torch.ones(3), codes, torch.ones(9), 5)
        with pytest.raises(ValueError, match="k must be"):
            mips_topk(q, torch.ones(3), codes, torch.ones(10), 0)
        with pytest.raises(ValueError, match="exact"):
            mips_topk_reference(torch.zeros(1, 1100, dtype=torch.int8),
                                torch.ones(1),
                                torch.zeros(2, 1100, dtype=torch.int8),
                                torch.ones(2), 1)


# ---------------------------------------------------------------------
# the sharded index: the merged answer IS the single-machine answer
# ---------------------------------------------------------------------
class TestMergeExactness:
    @pytest.mark.parametrize("nshards", [1, 2, 4])
    def test_bitwise_identical_to_exact_scan(self, nshards):
        items = _items()
        idx, sset = _index(items, nshards)
        jidx, jset = _jax_index(items, 1)
        try:
            r = idx.topk(_users(), 50, deadline_s=DEADLINE)
            ref_s, ref_i = idx.exact_scan(_users(), 50)
            _equal_bits(r.scores, r.ids, ref_s, ref_i)
            js, ji = jidx.exact_scan(_users(), 50)
            _equal_bits(r.scores, r.ids, js, ji)
            assert not r.degraded and r.dropped_slots == []
            assert r.versions == {s: 0 for s in range(nshards)}
        finally:
            sset.close()
            jset.close()

    @pytest.mark.parametrize("nshards", [2, 4])
    def test_ties_break_by_id_across_shards(self, nshards):
        # the first 32 rows repeated over the corpus: exact ties land on
        # different shards, and the merge orders them by ascending id
        items = np.tile(_items(32), (N_ITEMS // 32, 1))
        idx, sset = _index(items, nshards)
        jidx, jset = _jax_index(items, nshards)
        try:
            r = idx.topk(_users(4), 64, deadline_s=DEADLINE)
            jr = jidx.topk(_users(4), 64, deadline_s=DEADLINE)
            _equal_bits(r.scores, r.ids, jr.scores, jr.ids)
            ref_s, ref_i = idx.exact_scan(_users(4), 64)
            _equal_bits(r.scores, r.ids, ref_s, ref_i)
            for b in range(4):
                s, i = r.scores[b], r.ids[b]
                tied = s[:-1] == s[1:]
                assert tied.any() and np.all(i[:-1][tied] < i[1:][tied])
        finally:
            sset.close()
            jset.close()

    def test_k_past_corpus_returns_all_rows(self):
        idx, sset = _index(_items(24), 4)
        try:
            r = idx.topk(_users(2), 100, deadline_s=DEADLINE)
            assert r.ids.shape == (2, 24)
            assert sorted(r.ids[0]) == list(range(24))
        finally:
            sset.close()

    def test_merge_partials_empty(self):
        out_i, out_s = merge_partials({}, {}, 10)
        assert out_i.shape == (0, 0) and out_s.shape == (0, 0)

    def test_query_dim_mismatch_raises(self):
        idx, sset = _index(_items(), 2)
        try:
            with pytest.raises(ValueError, match="dim"):
                idx.topk(_users(2, dim=DIM + 1), 8)
        finally:
            sset.close()

    def test_fp32_scan_matches_jax(self):
        items, users = _items(), _users()
        idx, sset = _index(items, 1)
        jidx, jset = _jax_index(items, 1)
        try:
            s, i = idx.exact_scan_fp32(users, items, 20)
            js, ji = jidx.exact_scan_fp32(users, items, 20)
            np.testing.assert_array_equal(i, ji)
            np.testing.assert_allclose(s, js, rtol=1e-6, atol=1e-6)
        finally:
            sset.close()
            jset.close()

    def test_concurrent_queries_stay_exact(self):
        """Many threads querying one 4-shard index at once: every answer
        is the exact scan's (a shard's lock serializes its block)."""
        idx, sset = _index(_items(), 4)
        users = [_users(2, seed=10 + t) for t in range(8)]
        want = [idx.exact_scan(u, 16) for u in users]
        bad, done = [], []
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            def worker(t):
                for _ in range(5):
                    r = idx.topk(users[t], 16, deadline_s=DEADLINE)
                    if not (np.array_equal(r.ids, want[t][1])
                            and np.array_equal(r.scores, want[t][0])):
                        bad.append(t)
                done.append(t)

            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(old)
            sset.close()
        assert sorted(done) == list(range(8)) and not bad
        assert idx.queries == 40

    def test_index_lands_on_the_asked_device(self, monkeypatch):
        """A numpy catalog (what the JAX callers pass) is quantized on the
        device asked for; the default is the card, which raises without
        one rather than building a CPU index quietly."""
        items, users = _items(), _users()
        sset = ShardedMIPSIndex.standalone_set(2)
        try:
            idx = ShardedMIPSIndex.build(sset, items, device="cpu")
            assert idx.table.device.type == "cpu" and all(
                r.shard._blocks[idx.op_name].device.type == "cpu"
                for r in sset.shards)
            s, i = idx.exact_scan(users, 20)
            r = idx.topk(users, 20, deadline_s=DEADLINE)
            _equal_bits(r.scores, r.ids, s, i)
        finally:
            sset.close()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for attach in (
                lambda: ShardedMIPSIndex.build(
                    ShardedMIPSIndex.standalone_set(1), items),
                lambda: ShardedMIPSIndex.standalone_set(1).attach_index(
                    "retrieve_index", items)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                attach()

    def test_launch_counts_survive_thread_races(self):
        """Shards launch the top-k kernel from pool threads and clients
        the bag kernel from theirs: ``build.count_launch`` loses no
        update under a short switch interval."""
        def wrapper():
            pass

        wrapper.launches = 0
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [
                build.count_launch(wrapper) for _ in range(2000)])
                for _ in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(old)
        assert wrapper.launches == 16 * 2000


# ---------------------------------------------------------------------
# the card's select-then-sort, mirrored in plain PyTorch
# ---------------------------------------------------------------------
def _select_case(kind, R, d=32, B=5, seed=0):
    """Item codes whose scores are random, all tied (one row repeated),
    or Zipf-skewed (rows drawn from 64 distinct ones by a Zipf law, so
    hot scores repeat many times)."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        items = rng.randn(R, d)
    elif kind == "tied":
        items = np.tile(rng.randn(1, d), (R, 1))
    else:
        items = rng.randn(64, d)[np.minimum(rng.zipf(1.3, R) - 1, 63)]
    codes, scales = jax_quantize_query(items.astype(np.float32))
    q_codes, q_scales = jax_quantize_query(
        rng.randn(B, d).astype(np.float32))
    return q_codes, q_scales, codes, scales


class TestSelect:
    @pytest.mark.parametrize("kind", ["random", "tied", "zipf"])
    @pytest.mark.parametrize("R,k,base", [
        (20_000, 1, 0), (20_000, 100, 0), (20_000, 1000, 3),
        (2047, 100, 0), (2049, 100, 7), (37, 100, 0), (1, 1, 0)])
    def test_selection_matches_jax_oracle(self, kind, R, k, base):
        """Chunk maxima -> threshold -> candidates -> sort equals the JAX
        oracle bitwise: at least k rows reach the threshold."""
        q_codes, q_scales, codes, scales = _select_case(kind, R, seed=R + k)
        rs, ri = jax_mips_topk_reference(q_codes, q_scales, codes, scales,
                                         k, base)
        got_s, got_i, counts = topk_mod.mips_topk_select_reference(
            *_t(q_codes, q_scales, codes, scales), k, base)
        _equal_bits(got_s.numpy(), got_i.numpy(), rs, ri)
        kk = min(k, R)
        assert bool((counts >= kk).all())
        if kind == "tied":          # every row reaches the threshold
            assert bool((counts == R).all())

    def test_random_scores_keep_few_candidates(self):
        """At the cascade's shape cut to 200k rows: k = 100 keeps a
        little more than k rows a query, far below the buffer."""
        q_codes, q_scales, codes, scales = _select_case("random", 200_000,
                                                        B=3)
        _, _, counts = topk_mod.mips_topk_select_reference(
            *_t(q_codes, q_scales, codes, scales), 100)
        assert bool((counts >= 100).all()) and int(counts.max()) < 200

    def test_negative_zero_threshold(self):
        """Scores of +-0.0 at the threshold: both reach it, and the
        order ties them as the oracle does."""
        rng = np.random.RandomState(4)
        codes = rng.randint(-127, 128, size=(4096, 32)).astype(np.int8)
        scales = np.full(4096, 1e-30, np.float32)
        scales[::5] = 0.5
        q_codes = rng.randint(-127, 128, size=(3, 32)).astype(np.int8)
        q_scales = np.asarray([1e-20, 1e-20, 1e-20], np.float32)
        for k in (1, 100, 1000):
            rs, ri = jax_mips_topk_reference(q_codes, q_scales, codes,
                                             scales, k)
            got_s, got_i, counts = topk_mod.mips_topk_select_reference(
                *_t(q_codes, q_scales, codes, scales), k)
            _equal_bits(got_s.numpy(), got_i.numpy(), rs, ri)
        assert (np.signbit(rs) & (rs == 0)).any()

    @pytest.mark.parametrize("R,k,c", [
        (1_000_000, 100, 2048), (1_000_000, 1, 2048), (1_000_000, 1024, 128),
        (20_000, 1000, 32), (20_000, 100, 32), (2049, 1, 512), (1, 1, 32)])
    def test_chunk_rows(self, R, k, c):
        assert topk_mod.chunk_rows(R, k) == c

    def test_threshold_is_minus_inf_below_k_chunks(self):
        scores = torch.randn(2, 100)
        assert torch.equal(topk_mod.select_threshold(scores, 50),
                           torch.full((2,), float("-inf")))
        thr = topk_mod.select_threshold(scores, 2)    # 4 chunks of 32
        maxima = torch.cat([scores, torch.full((2, 28), float("-inf"))],
                           1).view(2, 4, 32).amax(2)
        assert torch.equal(thr, maxima.sort(1, descending=True).values[:, 1])

    def test_cpu_call_counts_no_route(self):
        q_codes, q_scales, codes, scales = _select_case("random", 500)
        before = dict(mips_topk.routes)
        mips_topk(*_t(q_codes, q_scales, codes, scales), 10)
        assert mips_topk.routes == before


# ---------------------------------------------------------------------
# degradation: drop and flag, never fabricate
# ---------------------------------------------------------------------
class TestDegradation:
    def test_ejected_slot_drops_candidates_flagged(self):
        items = _items()
        idx, sset = _index(items, 2)
        try:
            mid = shard_row_ranges(N_ITEMS, 2)[0][1]
            sset.shards[1].eject("test: slot 1 down")
            assert sset.degraded_now()
            r = idx.topk(_users(), 32, deadline_s=DEADLINE)
            assert r.degraded and r.dropped_slots == [1]
            assert np.all(r.ids < mid)          # slot 0's rows only
            sub, ssub = _index(items[:mid], 1)
            try:
                ref_s, ref_i = sub.exact_scan(_users(), 32)
                _equal_bits(r.scores, r.ids, ref_s, ref_i)
            finally:
                ssub.close()
            assert idx.degraded_queries == 1
            assert sset.stats()["topk_degraded"] == 1
            # re-admitted: full bitwise answers come back
            sset.shards[1].begin_probe()
            sset.shards[1].readmit()
            r2 = idx.topk(_users(), 32, deadline_s=DEADLINE)
            ref_s, ref_i = idx.exact_scan(_users(), 32)
            assert not r2.degraded
            _equal_bits(r2.scores, r2.ids, ref_s, ref_i)
        finally:
            sset.close()

    def test_degrade_fail_raises(self):
        idx, sset = _index(_items(), 2)
        try:
            sset.shards[0].eject("test: slot 0 down")
            with pytest.raises(ShardTierUnavailable, match="slot 0"):
                idx.topk(_users(), 8, deadline_s=DEADLINE, degrade="fail")
        finally:
            sset.close()

    def test_failing_shard_is_ejected_by_its_breaker(self, monkeypatch):
        idx, sset = _index(_items(), 2)
        try:
            rep = sset.shards[1]

            def boom(*a, **kw):
                raise RuntimeError("shard crashed")

            monkeypatch.setattr(rep.shard, "topk", boom)
            for _ in range(sset.config.eject_after):
                r = idx.topk(_users(2), 8, deadline_s=DEADLINE)
                assert r.degraded and r.dropped_slots == [1]
            assert rep.state == "ejected" and rep.ejections == 1
        finally:
            sset.close()


# ---------------------------------------------------------------------
# the two-tower heads, with the JAX heads' weights
# ---------------------------------------------------------------------
TT = dict(n_items=64, dim=8, user_dense_dim=4, user_embedding_size=[32, 16],
          user_sparse_dim=4, user_mlp=[16], item_raw_dim=8, item_mlp=[16])
HB = 16


def _jax_head(head):
    m = ff.FFModel(ff.FFConfig(batch_size=HB, seed=3))
    jax_build_two_tower(m, JaxTwoTowerConfig(**TT), head=head)
    m.compile(ff.SGDOptimizer(lr=0.05), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers(seed=3)
    return m


def _port_head(head, jm):
    m = pt.FFModel(pt.FFConfig(batch_size=HB, device="cpu", seed=3))
    build_two_tower(m, TwoTowerConfig(**TT), head=head)
    m.compile()
    m.swap_params(params_from_jax(m, jax.tree.map(np.asarray, jm.params)))
    return m


class TestHeads:
    def test_user_head_matches_jax(self):
        jm = _jax_head("user")
        pm = _port_head("user", jm)
        assert [op.name for op in pm.ops] == [op.name for op in jm.ops]
        rng = np.random.RandomState(7)
        feats = {"user_dense": rng.rand(11, 4).astype(np.float32),
                 "user_sparse": np.stack(
                     [rng.randint(0, 32, (11, 1)),
                      rng.randint(-20, 40, (11, 1))], axis=1)}  # wraps
        want = np.asarray(jm.forward_batch(
            {k: v.astype(np.int32) if k == "user_sparse" else v
             for k, v in feats.items()}))
        got = pm.forward_batch(feats).numpy()
        assert got.shape == (11, 8)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_item_embeddings_match_jax(self):
        jm = _jax_head("item")
        pm = _port_head("item", jm)
        want = jax_item_embeddings(jm, JaxTwoTowerConfig(**TT))
        got = item_embeddings(pm, TwoTowerConfig(**TT))
        assert isinstance(got, torch.Tensor) and got.shape == (64, 8)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    def test_transfer_and_unported_heads(self):
        user = _port_head("user", _jax_head("user"))
        item = pt.FFModel(pt.FFConfig(batch_size=HB, device="cpu"))
        build_two_tower(item, TwoTowerConfig(**TT), head="item")
        item.compile()
        item.init_layers(seed=9)
        # the heads share no op, so nothing moves
        assert transfer_tower_params(user, item) == 0
        again = pt.FFModel(pt.FFConfig(batch_size=HB, device="cpu"))
        build_two_tower(again, TwoTowerConfig(**TT), head="user")
        again.compile()
        again.init_layers(seed=5)
        assert transfer_tower_params(user, again) == 4   # 2 tables, 2 layers
        for op, p in user.params.items():
            for n, v in p.items():
                assert torch.equal(again.params[op][n], v)
        m = pt.FFModel(pt.FFConfig(batch_size=HB, device="cpu"))
        # the train head builds (item 10.2); the attention does not
        inputs, logits = build_two_tower(m, TwoTowerConfig(**TT),
                                         head="train")
        assert tuple(logits.shape) == (HB, HB)
        assert set(inputs) == {"user_dense", "user_sparse", "item_ids"}
        m = pt.FFModel(pt.FFConfig(batch_size=HB, device="cpu"))
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            build_two_tower(m, TwoTowerConfig(**TT, attention_heads=2),
                            head="user")
        with pytest.raises(ValueError, match="unknown head"):
            build_two_tower(m, TwoTowerConfig(**TT), head="both")


class TestTrainHead:
    def test_batches_labels_and_strategy_equal_jax(self):
        for zipf in (0.0, 1.1):
            px, py = synthetic_two_tower_batch(TwoTowerConfig(**TT), HB,
                                               seed=4, zipf_alpha=zipf)
            jx, jy = jax_synthetic_two_tower_batch(
                JaxTwoTowerConfig(**TT), HB, seed=4, zipf_alpha=zipf)
            assert set(px) == set(jx)
            for k in px:
                assert px[k].dtype == jx[k].dtype, k
                np.testing.assert_array_equal(px[k], jx[k])
            np.testing.assert_array_equal(py, jy)
        np.testing.assert_array_equal(in_batch_labels(5),
                                      jax_in_batch_labels(5))
        jm, pm = _jax_head("train"), pt.FFModel(
            pt.FFConfig(batch_size=HB, device="cpu"))
        build_two_tower(pm, TwoTowerConfig(**TT), head="train")
        want = jax_two_tower_strategy(jm, 1)
        got = two_tower_strategy(pm, 1)
        assert {k: tuple(v.degrees) for k, v in got.items()} == {
            k: tuple(v.degrees) for k, v in want.items()}

    def test_trains_like_jax_then_serves(self):
        cfg = TwoTowerConfig(**TT)
        jm = ff.FFModel(ff.FFConfig(batch_size=HB, seed=3))
        jax_build_two_tower(jm, JaxTwoTowerConfig(**TT), head="train")
        jm.compile(ff.SGDOptimizer(lr=0.1),
                   "sparse_categorical_crossentropy", ["accuracy"],
                   mesh=make_mesh(devices=jax.devices()[:1]))
        jm.init_layers(seed=3)
        p0 = jax.tree.map(np.asarray, jm.params)
        pm = pt.FFModel(pt.FFConfig(batch_size=HB, device="cpu", seed=3))
        build_two_tower(pm, cfg, head="train")
        from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
        pm.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                   ["accuracy"])
        pm.swap_params(params_from_jax(pm, p0))
        lj, lp = [], []
        for step in range(3):
            x, y = synthetic_two_tower_batch(cfg, HB, seed=10 + step)
            lj.append(float(jm.train_batch(dict(x, label=y))["loss"]))
            lp.append(float(pm.train_batch(dict(x, label=y))["loss"]))
        np.testing.assert_allclose(lp, lj, rtol=1e-5)
        assert {op.name for op in pm._sparse_ops} >= {
            "user_emb_0", "user_emb_1", "item_emb"}
        from dlrm_flexflow_tpu_torch.utils.weights import params_to_jax
        pj, pp = jax.tree.map(np.asarray, jm.params), params_to_jax(
            pm, pm.params)
        assert set(pp) == set(pj)
        for op in pj:
            for pn in pj[op]:
                dw = pj[op][pn] - p0[op][pn]
                err = np.abs(pp[op][pn] - pj[op][pn]).max()
                assert err <= 1e-3 * np.abs(dw).max() + 1e-7, (op, pn)
        # the towers serve: the port's heads given the port's towers
        # against the JAX heads given the JAX towers
        rng = np.random.RandomState(8)
        feats = {"user_dense": rng.rand(HB, 4).astype(np.float32),
                 "user_sparse": rng.randint(0, 16, (HB, 2, 1))}
        ids = rng.randint(0, 64, HB)
        for head in ("user", "item"):
            jh = _jax_head(head)
            ph = pt.FFModel(pt.FFConfig(batch_size=HB, device="cpu"))
            build_two_tower(ph, cfg, head=head)
            ph.compile()
            ph.init_layers(seed=1)
            assert transfer_tower_params(pm, ph) == \
                jax_transfer_tower_params(jm, jh) > 0
            if head == "user":
                got = ph.forward_batch(feats).numpy()
                want = np.asarray(jh.forward_batch(feats))
            else:
                got = item_embeddings(ph, cfg, ids).numpy()
                want = jax_item_embeddings(jh, JaxTwoTowerConfig(**TT), ids)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------
# the cascade, against the JAX cascade on the same weights
# ---------------------------------------------------------------------
RANKER = dict(embedding_size=[512] * 4, sparse_feature_size=64,
              mlp_bot=[8, 32, 64], mlp_top=[64 + 4 * 64, 32, 16, 1],
              arch_interaction_op="cat")
K = 16


class _JaxRanker:
    """The JAX model behind the serving tier's predict shape."""

    def __init__(self, model):
        self.model = model

    def predict(self, features, timeout=None):
        return JaxPrediction(np.asarray(self.model.forward_batch(features)),
                             0, 0.0)


@pytest.fixture(scope="module")
def rankers():
    jm = ff.FFModel(ff.FFConfig(batch_size=16, seed=11))
    jax_build_dlrm(jm, JaxDLRMConfig(**RANKER))
    jm.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
               mesh=make_mesh(devices=jax.devices()[:1]))
    jm.init_layers()
    pm = pt.FFModel(pt.FFConfig(batch_size=16, device="cpu", seed=11))
    build_dlrm(pm, DLRMConfig(**RANKER))
    pm.compile()
    pm.swap_params(params_from_jax(pm, jax.tree.map(np.asarray, jm.params)))
    return jm, pm


def _encoder():
    W = np.random.default_rng(5).standard_normal(
        (RANKER["mlp_bot"][0], DIM)).astype(np.float32)
    return lambda feats: np.asarray(feats["dense"], np.float32) @ W


class TestCascade:
    def test_matches_jax_cascade(self, rankers):
        jm, pm = rankers
        items = _items()
        idx, sset = _index(items, 2)
        jidx, jset = _jax_index(items, 2)
        x, _ = synthetic_batch(DLRMConfig(**RANKER), 6, seed=3)
        expand = dlrm_candidate_features(4, RANKER["embedding_size"])
        jexpand = jax_candidate_features(4, RANKER["embedding_size"])
        try:
            with InferenceEngine(pm, ServeConfig(max_batch=64)) as eng:
                mine = CascadeEngine(idx, _encoder(), eng, expand,
                                     CascadeConfig(k=K,
                                                   retrieve_deadline_ms=3e4))
                ref = JaxCascadeEngine(jidx, _encoder(), _JaxRanker(jm),
                                       jexpand,
                                       JaxCascadeConfig(
                                           k=K, retrieve_deadline_ms=3e4))
                for a in range(0, 6, 2):
                    feats = {k: v[a:a + 2] for k, v in x.items()}
                    p = mine.predict(feats)
                    q = ref.predict(feats)
                    assert p.ids.shape == (2, K) and not p.degraded
                    assert p.rank_versions is None
                    # retrieval: the same candidates with the same scores
                    r = idx.topk(_encoder()(feats), K, deadline_s=DEADLINE)
                    jr = jidx.topk(_encoder()(feats), K, deadline_s=DEADLINE)
                    _equal_bits(r.scores, r.ids, jr.scores, jr.ids)
                    for b in range(2):
                        lut = dict(zip(r.ids[b], r.scores[b]))
                        got = np.asarray([lut[i] for i in p.ids[b]],
                                         np.float32)
                        np.testing.assert_array_equal(
                            p.retrieve_scores[b].view(np.uint32),
                            got.view(np.uint32))
                    # ranker: each candidate's score within 1e-5 of JAX's
                    want = {(b, i): s for b in range(2)
                            for i, s in zip(q.ids[b], q.scores[b])}
                    for b in range(2):
                        for i, s in zip(p.ids[b], p.scores[b]):
                            assert abs(s - want[(b, i)]) <= 1e-5
                    # the final order is the lexsort of the ranker scores
                    # over the retrieval order
                    flat = np.asarray(pm.forward_batch(expand(feats, r.ids)),
                                      np.float32).reshape(2, K)
                    np.testing.assert_allclose(
                        np.take_along_axis(flat, np.lexsort(
                            (np.broadcast_to(np.arange(K), (2, K)), -flat),
                            axis=1), 1), p.scores, rtol=0, atol=1e-6)
                    assert np.all(np.diff(p.scores, axis=1) <= 0)
            assert mine.stats()["requests"] == 3
        finally:
            sset.close()
            jset.close()

    def test_reads_degraded_and_versions_from_the_ranker(self, rankers):
        _, pm = rankers

        class Flagged:
            def predict(self, features, timeout=None):
                n = features["dense"].shape[0]
                return Prediction(np.zeros((n, 1), np.float32), 7, 0.1,
                                  versions={0: 7, 1: 6}, degraded=True)

        idx, sset = _index(_items(), 1)
        x, _ = synthetic_batch(DLRMConfig(**RANKER), 2, seed=4)
        expand = dlrm_candidate_features(4, RANKER["embedding_size"])
        try:
            p = CascadeEngine(idx, _encoder(), Flagged(), expand,
                              CascadeConfig(k=4)).predict(x)
            assert p.degraded and p.rank_versions == {0: 7, 1: 6}
            assert p.rank_version == 7 and p.dropped_slots == []
            with InferenceEngine(pm, ServeConfig(max_batch=8)) as eng:
                pred = eng.predict({k: v[:1] for k, v in x.items()})
                assert pred.versions is None and pred.degraded is False
                p = CascadeEngine(idx, _encoder(), eng, expand,
                                  CascadeConfig(k=4)).predict(x)
            assert not p.degraded and p.rank_versions is None
        finally:
            sset.close()

    def test_all_shards_dead_returns_empty_degraded(self):
        idx, sset = _index(_items(), 2)
        try:
            for rep in sset.shards:
                rep.eject("test: down")
            eng = CascadeEngine(idx, lambda f: f["user"], None,
                                lambda f, ids: {}, CascadeConfig(k=8))
            p = eng.predict({"user": _users(2)})
            assert p.degraded and p.ids.shape == (2, 0)
            assert p.rank_version == -1
            assert sorted(p.dropped_slots) == [0, 1]
            assert eng.stats()["degraded_requests"] == 1
        finally:
            sset.close()

    def test_spent_budget_raises_deadline_exceeded(self):
        idx, sset = _index(_items(), 1)
        try:
            eng = CascadeEngine(idx, lambda f: f["user"], None,
                                lambda f, ids: {}, CascadeConfig(k=8))
            with pytest.raises(DeadlineExceeded):
                eng.predict({"user": _users(2)}, timeout=1e-9)
            assert eng.deadline_misses == 1
        finally:
            sset.close()

    def test_config_validates_and_lifts_flags(self):
        with pytest.raises(ValueError, match="k"):
            CascadeConfig(k=0)
        with pytest.raises(ValueError, match="deadline"):
            CascadeConfig(retrieve_deadline_ms=-1.0)
        cfg = pt.FFConfig.parse_args(
            ["--device", "cpu", "--retrieve-k", "7",
             "--retrieve-deadline-ms", "40", "--retrieve-shards", "3",
             "--serve-deadline-ms", "90"])
        assert (cfg.retrieve_k, cfg.retrieve_deadline_ms,
                cfg.retrieve_shards) == (7, 40.0, 3)
        cc = CascadeConfig.from_config(cfg)
        assert (cc.k, cc.retrieve_deadline_ms, cc.deadline_ms) == \
            (7, 40.0, 90.0)
        for flag, bad in (("--retrieve-k", "0"),
                          ("--retrieve-deadline-ms", "-1"),
                          ("--retrieve-shards", "-2")):
            with pytest.raises(ValueError, match=flag):
                pt.FFConfig.parse_args(["--device", "cpu", flag, bad])

    def test_dlrm_candidate_features_expand(self):
        x, _ = synthetic_batch(DLRMConfig(**RANKER), 2, seed=0)
        ids = np.asarray([[3, 700], [5, 1]], np.int64)
        out = dlrm_candidate_features(4, RANKER["embedding_size"])(x, ids)
        want = jax_candidate_features(4, RANKER["embedding_size"])(x, ids)
        for k in ("dense", "sparse"):
            np.testing.assert_array_equal(out[k], want[k])
        np.testing.assert_array_equal(out["sparse"][:, 0, 0],
                                      ids.reshape(-1) % 512)
