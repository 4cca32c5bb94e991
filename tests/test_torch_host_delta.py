"""Host-resident tables through the continual loop and the retrieval
index riding the shard tier, against the JAX package, on the CPU.

- A port trainer's ``fit_stream`` with a ``DeltaPublisher`` over host
  tables writes a chain (a full base, then deltas whose
  ``hostparams/<op>/kernel`` rows are the touched rows) that the JAX
  package's ``resolve_chain``, ``load_delta_file`` and ``apply_delta``
  replay into the port trainer's host tables; a JAX publisher's chain
  replays into the JAX trainer's through the port's ``apply_delta``.
- An engine with the row cache follows a host-table chain: each delta
  evicts only the cached samples whose rows it rewrote.
- ``ShardedMIPSIndex.augment_delta``: one publish advances the ranking
  tables and the index (the JAX package's tests/test_retrieve.py
  "one publish advances both stages"), after which the plain top-k
  equals the JAX ``mips_topk_reference``; the stale-index drill.

Tolerances: every replayed table, slab-free dense parameter and served
score against the trainer's is BITWISE (rows are copied, never
recomputed; the engine runs the port's own forward); the top-k against
the JAX oracle is BITWISE (the same integer dot and fp32 rescale).
A small "cat" DLRM, 4 tables × 64 rows × d = 8 (stacked) or
40-7-300-12 (concatenated), batch 16, plain SGD.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.data.stream import ArrayStream as JaxArrayStream
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.ops.pallas.topk_kernel import (
    mips_topk_reference as jax_mips_topk_reference,
    quantize_query as jax_quantize_query)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh
from dlrm_flexflow_tpu.utils import checkpoint as jax_ckpt
from dlrm_flexflow_tpu.utils import delta as jax_delta

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.retrieve import ShardedMIPSIndex
from dlrm_flexflow_tpu_torch.serve import (EmbeddingShardSet,
                                           InferenceEngine, ServeConfig,
                                           SnapshotWatcher)
from dlrm_flexflow_tpu_torch.utils import checkpoint as ckpt
from dlrm_flexflow_tpu_torch.utils import delta, faults
from dlrm_flexflow_tpu_torch.utils.weights import params_to_jax

BS = 16
UNIFORM = dict(embedding_size=[64] * 4, sparse_feature_size=8,
               mlp_bot=[4, 16, 8], mlp_top=[40, 16, 1])
NON_UNIFORM = dict(UNIFORM, embedding_size=[40, 7, 300, 12])
DEADLINE = 30.0


def _port(arch=UNIFORM, seed=2):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, seed=seed, device="cpu",
                               host_resident_tables=True,
                               host_tables_async=False))
    build_dlrm(m, DLRMConfig(**arch))
    m.compile(SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"])
    m.init_layers()
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


def _data(arch, n=96, seed=1):
    return synthetic_batch(DLRMConfig(**arch), n, seed=seed)


def _chain(d, fingerprint):
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return jax_delta.resolve_chain(manifest, fingerprint, d)


def _assert_tables_equal(a, b):
    assert set(a) == set(b)
    for op in a:
        np.testing.assert_array_equal(np.asarray(a[op]["kernel"]),
                                      np.asarray(b[op]["kernel"]))


@pytest.mark.parametrize("arch", [UNIFORM, NON_UNIFORM],
                         ids=["stacked", "concat"])
def test_port_host_chain_replays_in_jax_bitwise(arch, tmp_path):
    d = str(tmp_path)
    trainer = _port(arch)
    X, Y = _data(arch)
    pub = delta.DeltaPublisher(trainer, d, row_delta_min_elems=0,
                               compact_frac=100.0)
    trainer.fit_stream(ArrayStream(X, Y, BS, seed=1), steps=12,
                       publisher=pub, publish_every=4, verbose=False)
    assert (pub.full_publishes, pub.delta_publishes) == (1, 2)
    (op,) = trainer._host_resident_list
    key = f"hostparams/{op.name}/kernel"
    jm = _jax(arch)
    base, chain = _chain(d, jax_ckpt.config_fingerprint(jm))
    jax_ckpt.restore_checkpoint(jm, os.path.join(d, base["file"]))
    for e in chain:
        payload = jax_delta.load_delta_file(os.path.join(d, e["file"]))
        # only the touched host rows travel
        idx, _ = payload["rows"][key]
        assert 0 < idx.size < trainer.host_params[op.name][
            "kernel"].reshape(-1, 8).shape[0]
        assert e["touched_rows"][key] == idx.size
        jm.apply_delta(payload)
    assert jm._step == trainer._step == 12
    _assert_tables_equal(jm.host_params, trainer.host_params)
    want = jax.tree.map(np.array, params_to_jax(trainer, trainer.params))
    for name, p in want.items():
        for pn, v in p.items():
            np.testing.assert_array_equal(np.asarray(jm.params[name][pn]), v)


@pytest.mark.parametrize("arch", [UNIFORM, NON_UNIFORM],
                         ids=["stacked", "concat"])
def test_jax_host_chain_replays_in_the_port_bitwise(arch, tmp_path):
    d = str(tmp_path)
    jt = _jax(arch)
    X, Y = _data(arch)
    pub = jax_delta.DeltaPublisher(jt, d, row_delta_min_elems=0,
                                   compact_frac=100.0)
    jt.fit_stream(JaxArrayStream(X, Y, BS, seed=1), steps=12,
                  publisher=pub, publish_every=4, verbose=False)
    pm = _port(arch)
    base, chain = _chain(d, ckpt.config_fingerprint(pm))
    ckpt.restore_checkpoint(pm, os.path.join(d, base["file"]))
    assert chain
    for e in chain:
        pm.apply_delta(delta.load_delta_file(os.path.join(d, e["file"])))
    assert pm._step == 12
    _assert_tables_equal(pm.host_params, jt.host_params)
    got = jax.tree.map(np.array, params_to_jax(pm, pm.params))
    for name, p in got.items():
        for pn, v in p.items():
            np.testing.assert_array_equal(v, np.asarray(jt.params[name][pn]))


def test_apply_delta_validates_host_rows_before_writing():
    pm = _port()
    before = pm.host_params["emb_stack"]["kernel"].copy()
    key = "hostparams/emb_stack/kernel"
    good = (np.asarray([3], np.int64), np.ones((1, 8), np.float32))
    for rows, match in (
            ({key: (np.asarray([256], np.int64),
                    np.ones((1, 8), np.float32))}, "index up to 256"),
            ({key: (np.asarray([3], np.int64),
                    np.ones((1, 4), np.float32))}, "width"),
            ({key: good, "hostparams/nope/kernel": good}, "does not exist"),
            ({key: good, "state/bn/mean": good}, "item 11")):
        with pytest.raises(ValueError, match=match):
            pm.apply_delta({"step": 1, "rows": rows, "full": {}})
        np.testing.assert_array_equal(pm.host_params["emb_stack"]["kernel"],
                                      before)
    full = np.full((4, 64, 8), 0.5, np.float32)
    pm.apply_delta({"step": 2, "rows": {},
                    "full": {"hostparams/emb_stack/kernel": full}})
    np.testing.assert_array_equal(pm.host_params["emb_stack"]["kernel"],
                                  full)
    with pytest.raises(ValueError, match="host table"):
        pm.apply_delta({"step": 3, "rows": {}, "full": {
            "hostparams/emb_stack/kernel": full[:2]}})


def test_engine_with_cache_follows_host_deltas_bitwise(tmp_path):
    d = str(tmp_path)
    trainer = _port()
    X, Y = _data(UNIFORM)
    pub = delta.DeltaPublisher(trainer, d, row_delta_min_elems=0,
                               compact_frac=100.0)
    src = ArrayStream(X, Y, BS, seed=1)
    trainer.fit_stream(src, steps=4, publisher=pub, publish_every=4,
                       verbose=False)
    server = _port(seed=9)          # other tables until the first reload
    eng = InferenceEngine(server, ServeConfig(max_batch=BS, cache_rows=64,
                                              cache_warm=d)).start()
    x = {k: v[:8] for k, v in X.items()}
    try:
        w = SnapshotWatcher(eng, d)
        assert w.poll_once() and eng.version == 4
        # the reload re-warmed the cache from the published histogram
        assert len(eng._cache) > 0
        np.testing.assert_array_equal(
            eng.predict(x).scores,
            trainer.forward_bucket(x, bucket=BS).numpy()[:8])
        trainer.fit_stream(src, steps=4, publisher=pub, publish_every=4,
                           verbose=False)
        assert w.poll_once() and eng.version == trainer._step
        st = eng.stats()
        assert st["delta_reloads"] == 1
        assert st["embedding_cache"]["row_invalidations"] > 0
        assert st["embedding_cache"]["invalidations"] == 1  # the full
        np.testing.assert_array_equal(
            eng.predict(x).scores,
            trainer.forward_bucket(x, bucket=BS).numpy()[:8])
        _assert_tables_equal(server.host_params, trainer.host_params)
    finally:
        eng.close()


# ---------------------------------------------------------------------
# the retrieval index riding the ranker's shard tier
# ---------------------------------------------------------------------
def _items(n=64, dim=8, seed=0):
    return np.random.RandomState(seed).randn(n, dim).astype(np.float32)


def _jax_reference(q, table, k):
    qc, qs = jax_quantize_query(q)
    return jax_mips_topk_reference(qc, qs, table.q.numpy(),
                                   table.scales.numpy(), k)


def test_one_publish_advances_both_stages():
    sset = EmbeddingShardSet.build(_port(), 2)
    idx = ShardedMIPSIndex.build(sset, _items(), device="cpu")
    try:
        assert sset.version_vector() == {0: 0, 1: 0}
        payload = {"rows": {"hostparams/emb_stack/kernel":
                            (np.asarray([3], np.int64),
                             np.full((1, 8), 5.5, np.float32))},
                   "full": {}}
        idx.augment_delta(payload, np.asarray([5]),
                          np.full((1, 8), 9.0, np.float32))
        assert sset.apply_delta(payload, 10) >= 1
        assert sset.version_vector() == {0: 10, 1: 10}
        got = sset.fetch({"emb_stack": np.asarray([3], np.int64)})
        assert np.all(got.rows["emb_stack"] == 5.5)
        q = np.ones((1, 8), np.float32)
        r = idx.topk(q, 5, deadline_s=DEADLINE)
        assert r.versions == {0: 10, 1: 10} and r.ids[0, 0] == 5
        ref_s, ref_i = idx.exact_scan(q, 5)
        np.testing.assert_array_equal(r.ids, ref_i)
        np.testing.assert_array_equal(r.scores, ref_s)
        # the plain top-k after the publish is the JAX oracle's
        users = np.random.RandomState(1).randn(6, 8).astype(np.float32)
        js, ji = _jax_reference(users, idx.table, 7)
        r = idx.topk(users, 7, deadline_s=DEADLINE)
        np.testing.assert_array_equal(r.ids, ji)
        np.testing.assert_array_equal(r.scores, js)
        with pytest.raises(ValueError, match="augment_delta"):
            idx.augment_delta({}, np.asarray([1, 2]), np.ones((1, 8)))
    finally:
        sset.close()


def test_index_rides_the_engine_publish_path():
    m = _port()
    sset = EmbeddingShardSet.build(m, 2)
    idx = ShardedMIPSIndex.build(sset, _items(), device="cpu")
    eng = InferenceEngine(m, ServeConfig(max_batch=BS),
                          shard_set=sset).start()
    try:
        payload = {"step": 10, "rows": {}, "full": {}}
        idx.augment_delta(payload, np.asarray([40]),
                          np.full((1, 8), 9.0, np.float32))
        eng.install_delta(payload, 10)
        assert eng.version == 10 and eng.stats()["reload_rejects"] == 0
        r = idx.topk(np.ones((1, 8), np.float32), 3, deadline_s=DEADLINE)
        assert r.versions == {0: 10, 1: 10} and r.ids[0, 0] == 40
        assert sset.serving_plan()["retrieve_index"]["rows"] == 64
    finally:
        eng.close()
        sset.close()


def test_stale_fault_serves_the_displaced_block_once():
    sset = EmbeddingShardSet.build(_port(), 2)
    idx = ShardedMIPSIndex.build(sset, _items(), device="cpu")
    try:
        payload = {"rows": {}, "full": {}}
        idx.augment_delta(payload, np.asarray([5]),
                          np.full((1, 8), 9.0, np.float32))
        sset.apply_delta(payload, 7)
        plan = faults.FaultPlan()
        plan.index_stale[0] = 1
        plan.topk_drop[1] = 1
        q = np.ones((1, 8), np.float32)
        with faults.active_plan(plan):
            stale = idx.topk(q, 5, deadline_s=DEADLINE)
            assert stale.versions == {0: 0}         # shard 1 dropped
            assert stale.degraded and stale.dropped_slots == [1]
            assert 5 not in stale.ids[0]            # the old block
            fresh = idx.topk(q, 5, deadline_s=DEADLINE)
        assert fresh.versions == {0: 7, 1: 7} and fresh.ids[0, 0] == 5
        assert ("index_stale", 0) in plan.fired
    finally:
        sset.close()


def test_replacement_moves_a_cached_index_block_to_the_index_device(
        tmp_path):
    m = _port()
    sset = EmbeddingShardSet.build(m, 2, cache_dir=str(tmp_path))
    idx = ShardedMIPSIndex.build(sset, _items(), device="cpu")
    try:
        q = np.ones((2, 8), np.float32)
        before = idx.topk(q, 4, deadline_s=DEADLINE)
        sset.shards[0].eject("test")
        assert sset.replace(0) is not None
        rep = next(r for r in sset.shards if r.slot == 0)
        assert sset.probe(rep)
        blk = rep.shard.blocks_copy()[0]["retrieve_index"]
        assert blk.q.dtype == torch.int8 and blk.device == idx.device
        after = idx.topk(q, 4, deadline_s=DEADLINE)
        np.testing.assert_array_equal(after.ids, before.ids)
        np.testing.assert_array_equal(after.scores, before.scores)
    finally:
        sset.close()


def test_app_serves_the_cascade_riding_its_shard_tier():
    """The app with ``--host-tables --serve-shards 2 --retrieve on``: the
    index rides the ranker's two shards, /predict answers candidates
    with both stages' version vectors, and ``--retrieve-shards`` that
    disagrees with ``--serve-shards`` is refused before any model is
    built."""
    from dlrm_flexflow_tpu_torch.examples.native import serve_dlrm
    from test_torch_serve_app import BASE, _request, _Running
    flags = BASE + ["--host-tables", "--serve-shards", "2", "--retrieve",
                    "on", "--retrieve-k", "4"]
    with pytest.raises(SystemExit, match="conflicts with --serve-shards"):
        serve_dlrm.App(flags + ["--retrieve-shards", "3"])
    srv = _Running(flags)
    try:
        assert srv.app._index_set is None          # no standalone set
        assert srv.app.shard_set.serving_plan()["retrieve_index"]["rows"] \
            == 64
        _x, body = _request(2)
        code, text = srv.post("/predict", body)
        out = json.loads(text)
        assert code == 200 and np.asarray(out["candidates"]).shape == (2, 4)
        assert out["retrieve_versions"] == {"0": 0, "1": 0}
        assert out["versions"] and set(out["versions"].values()) == {0}
        assert out["degraded"] is False
        code, text = srv.post("/retrieve", dict(body, k=3))
        assert code == 200 and json.loads(text)["versions"] == {"0": 0,
                                                                "1": 0}
    finally:
        srv.close()
