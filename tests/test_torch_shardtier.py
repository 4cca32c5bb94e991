"""The port's serving shard tier (``serve/shardtier.py``), row cache
(``serve/cache.py``), shard warm cache (``utils/warmcache.py``), the rest
of the id sketch (``utils/histogram.py``) and the tier's delta routing
(``utils/delta.py``) against the JAX package, on the CPU.

A small DLRM with host-resident tables: 4 tables × 64 rows × d = 8
("cat", stacked) and the non-uniform 40-7-300-12 ("cat", concatenated),
batch 16, 2-4 shards. One seed draws the same host tables in both
packages; dense weights cross by ``params_from_jax``.

Tolerances, and why:

- the sketch's statistics, its draws from one ``RandomState``, the
  cache's values and the keys it inserts and evicts, the split slices,
  slice and chain CRCs, tier ranges, default rows, fetched rows and the
  warm-cache entries: EXACT (the same numpy arithmetic on the same
  arrays, the same integers);
- an engine on the tier, with the cache or without it: BITWISE the
  port's direct forward (the tier assembles rows through the op's own
  ``host_lookup_rows``); against the JAX engine on the same tier: rtol
  1e-5, atol 1e-6, as tests/test_torch_serve.py holds the two forwards
  (the MLPs' products sum in another fp32 order in XLA).

The behaviour classes mirror the JAX package's tests/test_shardtier.py.
Faults are injected through ``faults.active_plan``; every threaded test
joins its threads under a timeout of its own.
"""

import os
import threading
import time

import numpy as np
import pytest

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.parallel import alltoall as jax_a2a
from dlrm_flexflow_tpu.parallel.mesh import make_mesh
from dlrm_flexflow_tpu.serve import cache as jax_cache
from dlrm_flexflow_tpu.serve import shardtier as jax_tier
from dlrm_flexflow_tpu.serve.engine import InferenceEngine as JaxEngine
from dlrm_flexflow_tpu.serve.engine import ServeConfig as JaxServeConfig
from dlrm_flexflow_tpu.quant.store import QuantTable as JaxQuantTable
from dlrm_flexflow_tpu.utils import delta as jax_delta
from dlrm_flexflow_tpu.utils import faults as jax_faults
from dlrm_flexflow_tpu.utils import histogram as jax_hist
from dlrm_flexflow_tpu.utils import warmcache as jax_warm

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.quant.store import QuantTable
from dlrm_flexflow_tpu_torch.serve import (EmbeddingShardSet,
                                           InferenceEngine, ServeConfig,
                                           ShardTierConfig,
                                           ShardTierUnavailable,
                                           SnapshotWatcher)
from dlrm_flexflow_tpu_torch.serve import cache as port_cache
from dlrm_flexflow_tpu_torch.serve import shardtier as tier
from dlrm_flexflow_tpu_torch.serve.fleet import EJECTED, HEALTHY, PROBING
from dlrm_flexflow_tpu_torch.utils import delta, faults
from dlrm_flexflow_tpu_torch.utils import histogram as hist
from dlrm_flexflow_tpu_torch.utils import warmcache
from dlrm_flexflow_tpu_torch.utils.weights import params_from_jax

BS = 16
UNIFORM = dict(embedding_size=[64] * 4, sparse_feature_size=8,
               mlp_bot=[4, 16, 8], mlp_top=[40, 16, 1])
NON_UNIFORM = dict(UNIFORM, embedding_size=[40, 7, 300, 12])
KEY = "hostparams/emb_stack/kernel"
THREAD_TIMEOUT_S = 20.0


def _port(arch=UNIFORM, seed=2, jm=None, **cfg):
    cfg.setdefault("host_resident_tables", True)
    cfg.setdefault("host_tables_async", False)
    m = pt.FFModel(pt.FFConfig(batch_size=BS, seed=seed, device="cpu",
                               **cfg))
    build_dlrm(m, DLRMConfig(**arch))
    m.compile(SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"])
    m.init_layers()
    if jm is not None:
        m.swap_params(params_from_jax(m, jax.tree.map(np.asarray,
                                                      jm.params)))
    return m


def _jax(arch=UNIFORM, seed=2):
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=seed,
                               host_resident_tables=True,
                               host_tables_async=False))
    jax_build_dlrm(m, JaxDLRMConfig(**arch))
    m.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers()
    return m


def _rows(n, seed=0, arch=UNIFORM):
    return synthetic_batch(DLRMConfig(**arch), n, seed=seed)[0]


def _tier_cfg(**kw):
    kw.setdefault("nshards", 2)
    kw.setdefault("eject_after", 2)
    kw.setdefault("retries", 1)
    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("replace_after", 2)
    kw.setdefault("lookup_deadline_ms", 500.0)
    return ShardTierConfig(**kw)


def _engine(model, sset, **scfg_kw):
    scfg_kw.setdefault("max_batch", BS)
    return InferenceEngine(model, ServeConfig(**scfg_kw),
                           shard_set=sset).start()


def _shard_down(sid, n=-1):
    plan = faults.FaultPlan()
    plan.shard_down[sid] = n
    return faults.active_plan(plan)


def _payload(idx, val, key=KEY, d=8):
    return {"rows": {key: (np.asarray(idx, np.int64),
                           np.full((len(idx), d), val, np.float32))},
            "full": {}}


# ---------------------------------------------------------------------
# the id sketch's statistics and draws, against the JAX package's
# ---------------------------------------------------------------------
class TestHistogram:
    @staticmethod
    def _pair(rows, buckets, seed):
        rng = np.random.RandomState(seed)
        ids = (rng.zipf(1.3, size=500) % rows).astype(np.int64)
        a = hist.IdFrequencySketch(rows, max_buckets=buckets)
        b = jax_hist.IdFrequencySketch(rows, max_buckets=buckets)
        a.observe(ids)
        b.observe(ids)
        return a, b

    @pytest.mark.parametrize("buckets", [256, 64])   # exact, folded
    def test_statistics_equal_jax(self, buckets):
        a, b = self._pair(256, buckets, 1)
        a2, b2 = self._pair(256, buckets, 2)
        np.testing.assert_array_equal(a.probs(), b.probs())
        assert a.divergence(a2) == b.divergence(b2)
        for n in (1, 16, 1000):
            assert a.expected_distinct(n) == b.expected_distinct(n)
            assert (a.expected_distinct(n, 4, 64)
                    == b.expected_distinct(n, 4, 64))
        assert a.hot_mass(4, 64, tables=4) == b.hot_mass(4, 64, tables=4)
        c, d = a.copy(), b.copy()
        c.merge(a2)
        d.merge(b2)
        np.testing.assert_array_equal(c.counts, d.counts)
        assert c.total == d.total and a.total != c.total
        c.reset()
        d.reset()
        assert c.total == d.total == 0 and not c.counts.any()
        # an unobserved side reads no drift; a foreign row space refuses
        assert c.divergence(a) == d.divergence(b) == 0.0
        with pytest.raises(ValueError, match="rows"):
            a.divergence(hist.IdFrequencySketch(128))
        with pytest.raises(ValueError, match="merge"):
            a.merge(hist.IdFrequencySketch(128))

    @pytest.mark.parametrize("rows,buckets,observed",
                             [(256, 256, True), (256, 64, True),
                              (256, 256, False)])
    def test_draws_bitwise_jax(self, rows, buckets, observed):
        a, b = self._pair(rows, buckets, 3)
        if not observed:
            a.reset()
            b.reset()
        ra, rb = np.random.RandomState(7), np.random.RandomState(7)
        for lo, hi, size in ((0, 64, (32, 2)), (64, 128, (5,)),
                             (192, 256, (4, 1, 3))):
            np.testing.assert_array_equal(a.sample_range(ra, lo, hi, size),
                                          b.sample_range(rb, lo, hi, size))
        np.testing.assert_array_equal(a.sample(ra, (9, 2)),
                                      b.sample(rb, (9, 2)))


# ---------------------------------------------------------------------
# the row cache, against the JAX package's, on the same ops and ids
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    """A JAX model and a port model with the same host tables and
    dense weights."""
    jm = _jax()
    return jm, _port(jm=jm)


class TestEmbeddingCache:
    @staticmethod
    def _ids(seed, n=12):
        idx = np.asarray(_rows(n, seed)["sparse"], np.int32)
        idx[n // 2:] = idx[:n - n // 2]     # repeats: hits in one batch
        return idx

    def test_lookups_equal_jax_and_hits_equal_misses(self, pair):
        jm, pm = pair
        pc, jc = port_cache.EmbeddingCache(64), jax_cache.EmbeddingCache(64)
        (pop,), (jop,) = pm._host_resident_list, jm._host_resident_list
        for seed in (0, 1, 0):
            idx = self._ids(seed)
            got = pc.lookup(pop, pm.host_params[pop.name], idx)
            want = jc.lookup(jop, jm.host_params[jop.name], idx)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, pop.host_lookup(pm.host_params[pop.name], idx))
        assert pc.stats() == jc.stats()
        assert pc.stats()["hits"] > 0 and len(pc) == len(jc)

    def test_invalidate_rows_evicts_the_keys_jax_evicts(self, pair):
        jm, pm = pair
        pc, jc = port_cache.EmbeddingCache(64), jax_cache.EmbeddingCache(64)
        (pop,), (jop,) = pm._host_resident_list, jm._host_resident_list
        for seed in range(3):
            idx = self._ids(seed)
            pc.lookup(pop, pm.host_params[pop.name], idx)
            jc.lookup(jop, jm.host_params[jop.name], idx)
        dirty = pop.host_delta_touched_rows(self._ids(1)[:2])
        np.testing.assert_array_equal(
            dirty, jop.host_delta_touched_rows(self._ids(1)[:2]))
        assert pc.invalidate_rows(pop.name, dirty) == \
            jc.invalidate_rows(jop.name, dirty) > 0
        assert list(pc._d) == list(jc._d)
        assert pc.invalidate_rows("other_op", dirty) == 0
        pc.invalidate()
        assert len(pc) == 0 and pc.stats()["invalidations"] == 1
        # a quantized cache evicts the same keys (its values are codes
        # and scales: tests/test_torch_quant_train.py)
        qc = port_cache.EmbeddingCache(64, quant={"emb_stack": "int8"})
        qj = jax_cache.EmbeddingCache(64, quant={"emb_stack": "int8"})
        for seed in range(3):
            qc.lookup(pop, pm.host_params[pop.name], self._ids(seed))
            qj.lookup(jop, jm.host_params[jop.name], self._ids(seed))
        assert qc.invalidate_rows(pop.name, dirty) == \
            qj.invalidate_rows(jop.name, dirty) > 0
        assert list(qc._d) == list(qj._d)

    def test_prewarm_inserts_what_jax_inserts(self, pair, tmp_path):
        jm, pm = pair
        (pop,), (jop,) = pm._host_resident_list, jm._host_resident_list
        sk = hist.IdFrequencySketch(pop.lookup_id_space())
        for seed in range(4):
            sk.observe(pop.flat_lookup_ids(_rows(BS, seed)["sparse"]))
        path = str(tmp_path / hist.HISTOGRAM_FILE)
        hist.save_histograms(path, {pop.name: sk})
        pe = InferenceEngine(pm, ServeConfig(max_batch=4, cache_rows=32,
                                             cache_warm=str(tmp_path)))
        je = JaxEngine(jm, JaxServeConfig(max_batch=4, cache_rows=32,
                                          cache_warm=path, warmup=False))
        pe._prewarm_cache()
        je._prewarm_cache()
        assert len(pe._cache) > 0
        assert list(pe._cache._d) == list(je._cache._d)
        for (pv, pdeps), (jv, jdeps) in zip(pe._cache._d.values(),
                                            je._cache._d.values()):
            np.testing.assert_array_equal(pv, jv)
            np.testing.assert_array_equal(pdeps, jdeps)
        assert pe._cache.stats()["hits"] == pe._cache.stats()["misses"] == 0


# ---------------------------------------------------------------------
# shard routing: the same slices and CRC integers as the JAX package
# ---------------------------------------------------------------------
class TestShardRouting:
    def test_owner_math_equals_jax(self):
        for rows, n in ((256, 1), (256, 3), (100, 7), (5, 8)):
            assert tier.shard_row_ranges(rows, n) == \
                jax_a2a.shard_row_ranges(rows, n)
            ids = np.arange(-3, 2 * rows)
            np.testing.assert_array_equal(tier.row_owners(ids, rows, n),
                                          jax_a2a.row_owners(ids, rows, n))
        with pytest.raises(ValueError, match="nshards"):
            tier.shard_row_ranges(10, 0)

    @pytest.mark.parametrize("nshards", [2, 3, 4])
    def test_split_and_crcs_equal_jax(self, nshards):
        rng = np.random.RandomState(nshards)
        ranges = {"emb_stack": tier.shard_row_ranges(256, nshards),
                  "emb_small": tier.shard_row_ranges(10, nshards)}
        payload = {
            "rows": {KEY: (rng.choice(256, 40, replace=False),
                           rng.randn(40, 8).astype(np.float32)),
                     "params/fc/kernel": (np.arange(2),
                                          np.ones((2, 3), np.float32))},
            "full": {"hostparams/emb_small/kernel":
                     rng.randn(10, 8).astype(np.float32)}}
        got = delta.split_host_rows_by_shard(payload, ranges)
        want = jax_delta.split_host_rows_by_shard(payload, ranges)
        assert set(got) == set(want) == set(range(nshards))
        for slot in got:
            assert (got[slot] is None) == (want[slot] is None)
            if got[slot] is None:
                continue
            assert got[slot]["crc"] == want[slot]["crc"]
            assert got[slot]["crc"] == jax_delta.shard_slice_crc(got[slot])
            assert sorted(got[slot]["rows"]) == sorted(want[slot]["rows"])
            for k, (i, v) in got[slot]["rows"].items():
                np.testing.assert_array_equal(i, want[slot]["rows"][k][0])
                np.testing.assert_array_equal(v, want[slot]["rows"][k][1])
        crc = 0
        for step in (4, 8, 12):
            c = delta.shard_chain_crc(crc, step, got[0]["crc"])
            assert c == jax_delta.shard_chain_crc(crc, step, got[0]["crc"])
            crc = c


# ---------------------------------------------------------------------
# the tier against the JAX package's tier over the same weights
# ---------------------------------------------------------------------
class TestTierAgainstJax:
    @pytest.mark.parametrize("arch", [UNIFORM, NON_UNIFORM],
                             ids=["stacked", "concat"])
    def test_fetch_defaults_and_ranges_bitwise(self, arch):
        jm = _jax(arch)
        pm = _port(arch, jm=jm)
        ps = EmbeddingShardSet.build(pm, 3)
        js = jax_tier.EmbeddingShardSet.build(jm, 3)
        try:
            (op,) = pm._host_resident_list
            name = op.name
            assert ps._ranges == js._ranges
            assert ps._bounds == {k: [tuple(b) for b in v]
                                  for k, v in js._bounds.items()}
            np.testing.assert_array_equal(ps._defaults[name],
                                          js._defaults[name])
            assert ps.fingerprint == js.fingerprint
            rows = ps._flat_rows[name]
            ids = np.unique(np.random.RandomState(0).randint(0, rows, 50))
            pr, jr = ps.fetch({name: ids}), js.fetch({name: ids})
            np.testing.assert_array_equal(pr.rows[name], jr.rows[name])
            assert pr.versions == jr.versions
            np.testing.assert_array_equal(
                ps._default_rows(name, ids), js._default_rows(name, ids))
            assert ps.serving_plan()["ranges"] == {
                k: list(v) for k, v in js._ranges.items()}
        finally:
            ps.close()
            js.close()

    @pytest.mark.parametrize("cache_rows", [0, 64])
    def test_engine_on_tier_bitwise_direct_close_to_jax(self, cache_rows):
        jm = _jax()
        pm = _port(jm=jm)
        x = _rows(8, seed=4)
        direct = pm.forward_bucket(x, bucket=BS).numpy()
        ps = EmbeddingShardSet.build(pm, 2)
        js = jax_tier.EmbeddingShardSet.build(jm, 2)
        pe = _engine(pm, ps, cache_rows=cache_rows)
        je = JaxEngine(jm, JaxServeConfig(max_batch=BS,
                                          cache_rows=cache_rows),
                       shard_set=js).start()
        try:
            for _ in range(2):          # the second pass hits the cache
                p = pe.predict(x)
                j = je.predict(x)
                np.testing.assert_array_equal(p.scores, direct[:8])
                np.testing.assert_allclose(p.scores, np.asarray(j.scores),
                                           rtol=1e-5, atol=1e-6)
                assert p.versions == j.versions == {0: 0, 1: 0}
                assert p.degraded is j.degraded is False
            if cache_rows:
                assert pe.stats()["embedding_cache"]["hits"] > 0
        finally:
            pe.close()
            je.close()
            ps.close()
            js.close()


# ---------------------------------------------------------------------
# the shard warm cache: each package reads the other's entries
# ---------------------------------------------------------------------
class TestShardCacheAcrossPackages:
    @staticmethod
    def _blocks():
        rng = np.random.RandomState(5)
        dense = rng.randn(12, 8).astype(np.float32)
        index = rng.randn(6, 8).astype(np.float32)
        return dense, index

    def test_each_package_reads_the_others_entries(self, tmp_path):
        dense, index = self._blocks()
        pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
        pq = QuantTable.from_dense(index, "int8")
        jq = JaxQuantTable.from_dense(index, "int8")
        np.testing.assert_array_equal(pq.q.numpy(), jq.q)
        warmcache.ShardCache(pdir, "fp").put(
            3, 1, {"emb": dense, "idx": pq}, 12, 0xDEADBEEF)
        jax_warm.ShardCache(jdir, "fp").put(
            3, 1, {"emb": dense, "idx": jq}, 12, 0xDEADBEEF)
        for name in ("shard-3x-1.npz",):
            with np.load(os.path.join(pdir, name)) as a, \
                    np.load(os.path.join(jdir, name)) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
        for reader, src in ((jax_warm.ShardCache(pdir, "fp"), "port"),
                            (warmcache.ShardCache(jdir, "fp"), "jax")):
            blocks, ver, crc = reader.get(3, 1)
            assert (ver, crc) == (12, 0xDEADBEEF), src
            np.testing.assert_array_equal(np.asarray(blocks["emb"]), dense)
            q = blocks["idx"].q
            np.testing.assert_array_equal(
                q.numpy() if hasattr(q, "numpy") else np.asarray(q),
                jq.q)
        meta = {"nshards": 3, "flat_rows": {"emb": 36}}
        warmcache.ShardCache(pdir, "fp").put_meta(3, meta)
        assert jax_warm.ShardCache(pdir, "fp").get_meta(3)[
            "flat_rows"] == {"emb": 36}

    def test_a_corrupt_entry_is_rejected_with_its_reason(self, tmp_path):
        dense, _ = self._blocks()
        for pkg, flt in ((warmcache, faults), (jax_warm, jax_faults)):
            d = str(tmp_path / pkg.__name__.split(".")[0])
            c = pkg.ShardCache(d, "fp")
            c.put(2, 0, {"emb": dense}, 3, 0)
            plan = flt.FaultPlan()
            plan.corrupt_cache_entries = 1
            with flt.active_plan(plan):
                assert c.get(2, 0) is None
            assert c.rejects == 1 and "shard-2x-0.npz" in c.last_reject
            assert ("cache_corrupt", c._path(2, 0)) in plan.fired
            c.put(2, 0, {"emb": dense}, 3, 0)
            assert pkg.ShardCache(d, "other").get(2, 0) is None
            assert pkg.ShardCache(d, "fp").get(2, 1) is None
            geo = pkg.ShardCache(d, "fp")
            os.replace(geo._path(2, 0), geo._path(2, 1))
            assert geo.get(2, 1) is None
            assert "geometry mismatch" in geo.last_reject
        # a flipped byte fails the CRC in the other package too
        c = warmcache.ShardCache(str(tmp_path / "flip"), "fp")
        c.put(2, 0, {"emb": dense}, 3, 0)
        with np.load(c._path(2, 0)) as z:
            flat = {k: z[k] for k in z.files}
        flat["block/emb"] = flat["block/emb"] + 1.0
        with open(c._path(2, 0), "wb") as f:
            np.savez(f, **flat)
        j = jax_warm.ShardCache(str(tmp_path / "flip"), "fp")
        assert j.get(2, 0) is None and "CRC mismatch" in j.last_reject
        assert c.get(2, 0) is None and "CRC mismatch" in c.last_reject


# ---------------------------------------------------------------------
# behaviour (mirrors the JAX package's tests/test_shardtier.py)
# ---------------------------------------------------------------------
class TestShardedLookup:
    @pytest.mark.parametrize("nshards", [1, 2, 3])
    def test_bit_identical_to_direct_forward(self, nshards):
        m = _port()
        x = _rows(8)
        direct = m.forward_bucket(x, bucket=BS).numpy()
        sset = EmbeddingShardSet.build(m, nshards)
        eng = _engine(m, sset)
        try:
            pred = eng.predict(x)
            np.testing.assert_array_equal(pred.scores, direct[:8])
            assert pred.degraded is False
            assert set(pred.versions) == set(range(nshards))
        finally:
            eng.close()
            sset.close()

    def test_released_ranker_tables_still_serve(self):
        m = _port()
        x = _rows(4)
        direct = m.forward_bucket(x, bucket=BS).numpy()
        sset = EmbeddingShardSet.build(m, 2)
        assert EmbeddingShardSet.release_ranker_tables(m) > 0
        assert m._host_tables_released
        assert m.host_params["emb_stack"]["kernel"].shape[0] == 0
        eng = _engine(m, sset, cache_rows=16, cache_warm="unused")
        try:
            pred = eng.predict(x)
            np.testing.assert_array_equal(pred.scores, direct[:4])
            with pytest.raises(ValueError, match="released"):
                m.apply_delta(dict(_payload([3], 1.0), step=1))
        finally:
            eng.close()
            sset.close()

    def test_build_rejects_device_resident_model(self):
        with pytest.raises(ValueError, match="host-resident"):
            EmbeddingShardSet.build(_port(host_resident_tables=False), 2)

    def test_out_of_range_lookup_rejected(self):
        sset = EmbeddingShardSet.build(_port(), 2)
        with pytest.raises(ValueError, match="outside its"):
            sset.shards[0].shard.lookup(
                {"emb_stack": np.asarray([999], np.int64)})
        sset.close()

    def test_the_process_boundary_raises_naming_item_9_4(self):
        """The process boundary is ported (the name is kept): a shard
        serves over the wire, connect() needs the tier's geometry as the
        JAX connect() does, and tcp is a transport the config takes."""
        from dlrm_flexflow_tpu_torch.serve.transport import (
            RemoteShard, WireClient)
        sset = EmbeddingShardSet.build(_port(), 2)
        shard = sset.shards[0].shard
        server = shard.serve()
        remote = RemoteShard(0, 0, WireClient(server.address))
        try:
            lo, hi = shard.owned_range("emb_stack")
            ids = np.arange(lo, min(hi, lo + 5), dtype=np.int64)
            got, ver = remote.lookup({"emb_stack": ids})
            want, wver = shard.lookup({"emb_stack": ids})
            np.testing.assert_array_equal(got["emb_stack"],
                                          want["emb_stack"])
            assert ver == wver == remote.refresh()["version"]
        finally:
            remote.close()
            server.close()
        with pytest.raises(ValueError, match="tier geometry"):
            EmbeddingShardSet.connect(["h:1"])
        assert ShardTierConfig(transport="tcp").transport == "tcp"
        with pytest.raises(ValueError, match="transport"):
            ShardTierConfig(transport="udp")
        sset.close()


class TestDegradation:
    def test_dead_shard_degrades_never_fails(self):
        m = _port()
        x = _rows(8)
        sset = EmbeddingShardSet.build(m, 2, config=_tier_cfg())
        eng = _engine(m, sset)
        try:
            with _shard_down(0):
                preds = [eng.predict(x) for _ in range(3)]
            assert all(p.degraded for p in preds)
            assert all(0 not in p.versions for p in preds)
            assert sset.shards[0].state == EJECTED
            st = eng.stats()
            assert st["degraded_responses"] >= 3
            assert st["shard_set"]["degraded_fetches"] >= 1
            assert st["shard_set"]["defaults_used"] > 0
            hz = eng.healthz()
            assert hz["ok"] is True and hz["degraded"] is True
        finally:
            eng.close()
            sset.close()

    def test_degraded_samples_never_cached(self):
        m = _port()
        x = _rows(4)
        direct = m.forward_bucket(x, bucket=BS).numpy()
        sset = EmbeddingShardSet.build(m, 2, config=_tier_cfg())
        eng = _engine(m, sset, cache_rows=128)
        try:
            with _shard_down(0):
                assert eng.predict(x).degraded
            for r in sset.shards:
                if r.state != HEALTHY:
                    r.begin_probe()
                    r.readmit()
            p2 = eng.predict(x)
            assert not p2.degraded
            np.testing.assert_array_equal(p2.scores, direct[:4])
        finally:
            eng.close()
            sset.close()

    def test_cache_hits_serve_real_values_while_degraded(self):
        m = _port()
        x = _rows(4)
        direct = m.forward_bucket(x, bucket=BS).numpy()
        sset = EmbeddingShardSet.build(m, 2, config=_tier_cfg())
        eng = _engine(m, sset, cache_rows=128)
        try:
            assert not eng.predict(x).degraded
            with _shard_down(0):
                p = eng.predict(x)
            assert not p.degraded
            np.testing.assert_array_equal(p.scores, direct[:4])
        finally:
            eng.close()
            sset.close()

    def test_degrade_fail_policy_raises(self):
        m = _port()
        sset = EmbeddingShardSet.build(m, 2,
                                       config=_tier_cfg(degrade="fail"))
        eng = _engine(m, sset)
        try:
            with _shard_down(0), pytest.raises(ShardTierUnavailable):
                eng.predict(_rows(4))
        finally:
            eng.close()
            sset.close()

    def test_probe_readmits_after_recovery(self):
        m = _port()
        x = _rows(4)
        sset = EmbeddingShardSet.build(m, 2, config=_tier_cfg())
        eng = _engine(m, sset)
        try:
            with _shard_down(0):
                assert eng.predict(x).degraded
                assert sset.shards[0].state == EJECTED
                acts = sset.health_tick()
                assert any(a["action"] == "shard-probe" and not a["ok"]
                           for a in acts)
                assert sset.shards[0].state == EJECTED
            acts = sset.health_tick()
            assert any(a["action"] == "shard-probe" and a["ok"]
                       for a in acts)
            assert sset.shards[0].state == HEALTHY
            p2 = eng.predict(x)
            assert not p2.degraded and set(p2.versions) == {0, 1}
        finally:
            eng.close()
            sset.close()

    def test_lookup_deadline_times_out_slow_shard(self):
        sset = EmbeddingShardSet.build(
            _port(), 2, config=_tier_cfg(lookup_deadline_ms=60.0,
                                         retries=0, eject_after=1))
        plan = faults.FaultPlan()
        plan.lookup_delay_shard[0] = 0.2
        try:
            with faults.active_plan(plan):
                r = sset.fetch({"emb_stack": np.asarray([0, 200], np.int64)})
            assert r.degraded
            assert r.default_mask["emb_stack"].tolist() == [True, False]
            assert sset.stats()["timeouts"] >= 1
            assert sset.shards[0].state == EJECTED
        finally:
            sset.close()

    def test_hedged_lookup_counted(self):
        sset = EmbeddingShardSet.build(
            _port(), 2, config=_tier_cfg(hedge_ms=10.0,
                                         lookup_deadline_ms=2000.0))
        plan = faults.FaultPlan()
        plan.lookup_delay_shard[1] = 0.05   # slow, not dead
        try:
            with faults.active_plan(plan):
                r = sset.fetch({"emb_stack": np.asarray([0, 200], np.int64)})
            assert not r.degraded and sset.stats()["hedges"] >= 1
        finally:
            sset.close()


class TestVersionVector:
    def test_delta_routes_to_owners_only(self):
        sset = EmbeddingShardSet.build(_port(), 2)
        before1 = sset.shards[1].shard.blocks_copy()[0]["emb_stack"]
        sset.apply_delta(_payload([3, 7], 5.5), 10)
        r = sset.fetch({"emb_stack": np.asarray([3, 7], np.int64)})
        assert np.all(r.rows["emb_stack"] == 5.5)
        np.testing.assert_array_equal(
            before1, sset.shards[1].shard.blocks_copy()[0]["emb_stack"])
        assert sset.version_vector() == {0: 10, 1: 10}
        assert [r.shard.publishes_applied for r in sset.shards] == [1, 1]
        sset.close()

    def test_publish_idempotent_across_rankers(self):
        sset = EmbeddingShardSet.build(_port(), 2)
        p = _payload([3], 5.5)
        assert sset.apply_delta(p, 10) == 1
        assert sset.apply_delta(p, 10) == 0
        assert sset.version_vector() == {0: 10, 1: 10}
        sset.close()

    def test_corrupt_slice_lags_shard_not_garbage(self):
        sset = EmbeddingShardSet.build(_port(), 2)
        sub = delta.split_host_rows_by_shard(_payload([3], 1.0),
                                             sset._ranges)[0]
        good_crc = sub["crc"]
        sub["rows"][KEY][1][...] = 999.0
        rep = sset.shards[0]
        before = rep.shard.blocks_copy()[0]["emb_stack"]
        with pytest.raises(delta.ChainError, match="CRC"):
            rep.shard.apply_publish(sub, 10, good_crc)
        np.testing.assert_array_equal(
            before, rep.shard.blocks_copy()[0]["emb_stack"])
        assert rep.shard.version == 0 and rep.shard.apply_rejects == 1
        # rows outside the shard's range: rejected before anything lands
        bad = {"rows": {KEY: (np.asarray([3, 250], np.int64),
                              np.ones((2, 8), np.float32))}, "full": {}}
        with pytest.raises(delta.ChainError, match="outside"):
            rep.shard.apply_publish(bad, 11)
        np.testing.assert_array_equal(
            before, rep.shard.blocks_copy()[0]["emb_stack"])
        sset.close()

    def test_chain_crc_orders_publishes(self):
        sset = EmbeddingShardSet.build(_port(), 2)
        sset.apply_delta(_payload([3], 1.0), 10)
        c1 = sset.shards[0].shard.chain_crc
        sset.apply_delta(_payload([3], 2.0), 11)
        assert sset.shards[0].shard.chain_crc != c1
        sset.close()

    def test_never_mixed_within_one_shard_under_publish_storm(self):
        """Every publish rewrites every row of each shard to its step:
        a torn read would show two values in one shard, or a value that
        is not the version reported."""
        sset = EmbeddingShardSet.build(_port(), 2)
        R = sset._flat_rows["emb_stack"]
        stop = threading.Event()
        errs = []

        def publisher():
            step = 1
            while not stop.is_set() and step < 2000:
                flat = np.full((R, 8), float(step), np.float32)
                sset.apply_delta({"rows": {}, "full": {KEY: flat}}, step)
                step += 1

        t = threading.Thread(target=publisher, daemon=True,
                             name="ff-test-publisher")
        t.start()
        ids = np.asarray([0, 1, 100, 200, 255], np.int64)
        owners = tier.row_owners(ids, R, 2)
        try:
            for _ in range(200):
                r = sset.fetch({"emb_stack": ids})
                for slot in (0, 1):
                    ver = r.versions[slot]
                    if ver < 1:
                        continue
                    uniq = np.unique(r.rows["emb_stack"][owners == slot])
                    if uniq.size != 1 or uniq[0] != float(ver):
                        errs.append((slot, ver, uniq))
        finally:
            stop.set()
            t.join(THREAD_TIMEOUT_S)
            sset.close()
        assert not t.is_alive()
        assert not errs, errs[:5]

    def test_prediction_version_vector_monotonic(self):
        m = _port()
        x = _rows(4)
        sset = EmbeddingShardSet.build(m, 2)
        eng = _engine(m, sset)
        try:
            p1 = eng.predict(x)
            sset.apply_delta(_payload([3], 1.0), 10)
            p2 = eng.predict(x)
            assert all(p2.versions[s] >= v for s, v in p1.versions.items())
            assert p2.versions == {0: 10, 1: 10}
            assert eng.version_floor == 0       # the ranker's own
        finally:
            eng.close()
            sset.close()


class TestReplaceDead:
    def test_replacement_boots_from_cache_and_probes_in(self, tmp_path):
        m = _port()
        x = _rows(4)
        direct = m.forward_bucket(x, bucket=BS).numpy()
        sset = EmbeddingShardSet.build(m, 2, config=_tier_cfg(),
                                       cache_dir=str(tmp_path))
        eng = _engine(m, sset)
        try:
            with _shard_down(0):
                assert eng.predict(x).degraded
                replaced = False
                for _ in range(6):
                    if any(a["action"] == "shard-replace"
                           and a["new_sid"] is not None
                           for a in sset.health_tick()):
                        replaced = True
                        break
                assert replaced
                assert any(a["action"] == "shard-probe" and a["ok"]
                           for a in sset.health_tick())
            assert all(r.state == HEALTHY for r in sset.shards)
            assert sset.replacements == 1
            p2 = eng.predict(x)
            assert not p2.degraded
            np.testing.assert_array_equal(p2.scores, direct[:4])
        finally:
            eng.close()
            sset.close()

    def test_replacement_catches_up_from_history(self, tmp_path):
        sset = EmbeddingShardSet.build(_port(), 2, config=_tier_cfg(),
                                       cache_dir=str(tmp_path))
        cache, sset._cache = sset._cache, None   # the entry goes stale
        sset.apply_delta(_payload([3], 4.25), 10)
        sset._cache = cache
        sset.shards[0].eject("test")
        assert sset.replace(0) is not None
        rep = next(r for r in sset.shards if r.slot == 0)
        assert rep.shard.version == 10 and rep.state == PROBING
        assert sset.probe(rep)
        r = sset.fetch({"emb_stack": np.asarray([3], np.int64)})
        assert np.all(r.rows["emb_stack"] == 4.25)
        sset.close()

    def test_corrupt_cache_entry_rejects_with_reason(self, tmp_path):
        sset = EmbeddingShardSet.build(_port(), 2, config=_tier_cfg(),
                                       cache_dir=str(tmp_path))
        sset.shards[0].eject("test")
        plan = faults.FaultPlan()
        plan.corrupt_cache_entries = 1
        with faults.active_plan(plan):
            assert sset.replace(0) is None
        assert sset.replace_rejects == 1
        assert "cache" in sset.last_replace_reject
        assert sset.fetch({"emb_stack": np.asarray([3], np.int64)}).degraded
        sset.close()

    def test_stale_probe_rejected_until_caught_up(self):
        sset = EmbeddingShardSet.build(_port(), 2, config=_tier_cfg())
        rep = sset.shards[0]
        rep.eject("test")
        sset.apply_delta(_payload([200], 1.0), 10)
        assert rep.shard.version < sset.version
        assert not sset.probe(rep)
        assert "stale" in rep.last_error
        sset.close()

    def test_kill_one_shard_under_traffic_zero_failed(self, tmp_path):
        m = _port()
        sset = EmbeddingShardSet.build(
            m, 2, config=_tier_cfg(lookup_deadline_ms=1000.0),
            cache_dir=str(tmp_path))
        # more request tuples than the cache holds: the tier is asked
        # throughout
        eng = _engine(m, sset, cache_rows=8, queue_capacity=4096)
        reqs = [_rows(2, seed=s) for s in range(48)]
        results, errors = [], []
        stop = threading.Event()
        served = threading.Semaphore(0)
        # set once every slot is healthy again: a request sent after it
        # is looked up after the re-admission
        readmitted = threading.Event()

        def client(i):
            k = 0
            while not stop.is_set():
                after = readmitted.is_set()
                try:
                    p = eng.predict(reqs[(i * 13 + k) % len(reqs)],
                                    timeout=THREAD_TIMEOUT_S)
                    results.append((after, p.degraded, dict(p.versions)))
                    served.release()
                except Exception as e:   # noqa: BLE001
                    errors.append(e)
                k += 1

        threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                    name=f"ff-test-client-{i}")
                   for i in range(4)]
        plan = faults.FaultPlan()
        try:
            for t in threads:
                t.start()
            for _ in range(20):                   # a healthy phase
                assert served.acquire(timeout=THREAD_TIMEOUT_S)
            plan.shard_down[0] = -1               # kill shard 0
            with faults.active_plan(plan):
                n0 = len(results)
                deadline = time.monotonic() + THREAD_TIMEOUT_S
                while (not any(d for _, d, _ in results[n0:])
                       and time.monotonic() < deadline):
                    assert served.acquire(timeout=THREAD_TIMEOUT_S)
                replaced = False
                while not replaced and time.monotonic() < deadline:
                    replaced = any(a["action"] == "shard-replace"
                                   and a["new_sid"] is not None
                                   for a in sset.health_tick())
                assert replaced, "replacement never booted"
                while (any(r.state != HEALTHY for r in sset.shards)
                       and time.monotonic() < deadline):
                    sset.health_tick()
            assert all(r.state == HEALTHY for r in sset.shards)
            # the recovered phase: the requests sent after the
            # re-admission (one sent before it may be answered, degraded,
            # after it, so the answers' order cannot mark this point)
            readmitted.set()
            deadline = time.monotonic() + THREAD_TIMEOUT_S
            while (sum(a for a, _, _ in results) < 20
                   and time.monotonic() < deadline):
                served.acquire(timeout=THREAD_TIMEOUT_S)
            assert sum(a for a, _, _ in results) >= 20, \
                "recovered phase stalled"
        finally:
            stop.set()
            for t in threads:
                t.join(THREAD_TIMEOUT_S)
            eng.close()
            sset.close()
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert any(deg for after, deg, _ in results if not after)
        tail = [deg for after, deg, _ in results if after]
        assert len(tail) >= 20 and not any(tail)
        assert eng.stats()["degraded_responses"] > 0


class TestWatcherIntegration:
    @staticmethod
    def _publish(d, steps=12, every=4):
        trainer = _port(seed=2)
        X, Y = synthetic_batch(DLRMConfig(**UNIFORM), 64, seed=1)
        pub = delta.DeltaPublisher(trainer, d, row_delta_min_elems=0,
                                   compact_frac=100.0)
        trainer.fit_stream(ArrayStream(X, Y, BS, seed=1), steps=steps,
                           publisher=pub, publish_every=every,
                           verbose=False)
        return trainer, X

    def test_chain_applies_per_shard_and_matches_trainer(self, tmp_path):
        d = str(tmp_path)
        trainer, X = self._publish(d)
        server = _port(seed=2)
        sset = EmbeddingShardSet.build(server, 2)
        EmbeddingShardSet.release_ranker_tables(server)
        eng = InferenceEngine(server, ServeConfig(max_batch=BS,
                                                  cache_rows=32),
                              shard_set=sset).start()
        try:
            assert SnapshotWatcher(eng, d).poll_once()
            assert eng.version == 12
            assert sset.version_vector() == {0: 12, 1: 12}
            x = {k: v[:8] for k, v in X.items()}
            np.testing.assert_array_equal(
                eng.predict(x).scores,
                trainer.forward_bucket(x, bucket=BS).numpy()[:8])
            flat = trainer.host_params["emb_stack"]["kernel"].reshape(-1, 8)
            for rep in sset.shards:
                lo, hi = rep.shard.owned_range("emb_stack")
                np.testing.assert_array_equal(
                    rep.shard.blocks_copy()[0]["emb_stack"], flat[lo:hi])
        finally:
            eng.close()
            sset.close()

    def test_version_floor_drives_catch_up(self, tmp_path):
        d = str(tmp_path)
        self._publish(d)
        server = _port(seed=2)
        sset = EmbeddingShardSet.build(server, 2)
        eng = InferenceEngine(server, ServeConfig(max_batch=BS),
                              shard_set=sset).start()
        try:
            w = SnapshotWatcher(eng, d)
            assert w.poll_once()
            assert eng.version_floor == 12
            sset.shards[0].shard._version = 4    # a stale replacement
            assert eng.version_floor == 4
            assert w.poll_once()
            assert sset.version_vector() == {0: 12, 1: 12}
            assert eng.version_floor == 12
        finally:
            eng.close()
            sset.close()


class TestFaultEnvParsing:
    @staticmethod
    def _parse(monkeypatch, **env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        return faults.plan_from_env()

    def test_shard_forms(self, monkeypatch):
        p = self._parse(monkeypatch, FF_FAULT_SHARD_DOWN="0:3,2:1",
                        FF_FAULT_LOOKUP_DELAY="0.1,1:0.25",
                        FF_FAULT_INDEX_STALE="0:2",
                        FF_FAULT_TOPK_DROP="1", FF_FAULT_CACHE_CORRUPT="2")
        assert p.shard_down == {0: 3, 2: 1}
        assert (p.lookup_delay_s, p.lookup_delay_shard) == (0.1, {1: 0.25})
        assert p.index_stale == {0: 2} and p.topk_drop == {1: -1}
        assert p.corrupt_cache_entries == 2
        assert self._parse(monkeypatch, FF_FAULT_SHARD_DOWN="1").shard_down \
            == {1: -1}

    @pytest.mark.parametrize("var,raw,match", [
        ("FF_FAULT_SHARD_DOWN", "zero", "FF_FAULT_SHARD_DOWN"),
        ("FF_FAULT_LOOKUP_DELAY", "0:fast", "FF_FAULT_LOOKUP_DELAY"),
        ("FF_FAULT_LOOKUP_DELAY", "0:1:2", "more than one"),
        ("FF_FAULT_INDEX_STALE", "0", "missing its ':'"),
        ("FF_FAULT_TOPK_DROP", "x:1", "FF_FAULT_TOPK_DROP"),
        ("FF_FAULT_CACHE_CORRUPT", "1.5", "FF_FAULT_CACHE_CORRUPT"),
    ])
    def test_bad_values_raise_naming_the_variable(self, monkeypatch, var,
                                                  raw, match):
        with pytest.raises(ValueError, match=match):
            self._parse(monkeypatch, **{var: raw})

    def test_hooks_fire_and_spend_their_budget(self):
        plan = faults.FaultPlan()
        plan.shard_down[3] = 1
        plan.topk_drop[2] = -1
        plan.index_stale[1] = 1
        with faults.active_plan(plan):
            assert faults.take_shard_down(3) is True
            assert faults.take_shard_down(3) is False
            assert faults.take_topk_drop(2) and faults.take_topk_drop(2)
            assert faults.take_index_stale(1)
            assert not faults.take_index_stale(1)
        assert {("shard_down", 3), ("topk_drop", 2),
                ("index_stale", 1)} <= set(plan.fired)
        assert not faults.take_shard_down(3)      # no plan, no fault


class TestServingFeasibility:
    def test_replicated_rejected_sharded_admitted_as_jax(self, pair):
        jm, pm = pair
        fp = tier.serving_footprint(pm, replicas=4)
        assert fp == jax_tier.serving_footprint(jm, replicas=4)
        budget = fp["dense_bytes"] + fp["table_bytes"] // 2
        rep = tier.check_serving_feasible(pm, 4, budget, nshards=0)
        assert not rep["feasible"] and "--serve-shards" in rep["reason"]
        assert rep == jax_tier.check_serving_feasible(jm, 4, budget)
        m2 = _port(seed=3)
        sset = EmbeddingShardSet.build(m2, 4)
        EmbeddingShardSet.release_ranker_tables(m2)
        shd = tier.check_serving_feasible(m2, 4, budget, nshards=4)
        assert shd["feasible"] and shd["ranker_bytes"] == shd["dense_bytes"]
        assert shd["shard_bytes"] <= fp["table_bytes"] // 2
        sset.close()

    def test_install_full_ignores_released_stub(self):
        m = _port()
        x = _rows(4)
        direct = m.forward_bucket(x, bucket=BS).numpy()
        sset = EmbeddingShardSet.build(m, 2)
        stub = {"emb_stack": {"kernel": np.zeros((0, 8), np.float32)}}
        assert sset.install_full(stub, version=99)
        assert sset.version_vector() == {0: 99, 1: 99}
        eng = _engine(m, sset)
        try:
            np.testing.assert_array_equal(eng.predict(x).scores,
                                          direct[:4])
        finally:
            eng.close()
            sset.close()

    def test_seed_shard_cache_boots_a_replacement(self, tmp_path):
        m = _port()
        sset = EmbeddingShardSet.build(m, 2, config=_tier_cfg())
        sset._cache = EmbeddingShardSet.seed_shard_cache(m, 2,
                                                         str(tmp_path))
        meta = sset._cache.get_meta(2)
        assert meta["ranges"]["emb_stack"] == [[0, 128], [128, 256]]
        assert jax_warm.ShardCache(str(tmp_path)).get_meta(2) == meta
        sset.shards[1].eject("test")
        assert sset.replace(1) is not None
        assert sset.probe(next(r for r in sset.shards if r.slot == 1))
        sset.close()
