"""The port's delta publication (``utils/delta.py``, the manager's delta
chain, ``FFModel.apply_delta``, ``fit_stream``'s publisher and resume)
against the JAX package's, on the CPU.

The small "cat" DLRM of tests/test_torch_checkpoint.py (8 tables × 64
rows × d = 8, bag 2: the JAX op lane-packs the tables to (8, 4, 128)),
with a non-identity table storage order in both packages, batch 16,
plain SGD.

Tolerances, and why:

- Touched-row candidates, id sketches, diffs, delta files, manifests,
  histograms and chain decisions: EXACT (the same integer and fp32
  arrays, the same messages).
- A delta installed by either package's engine or ``apply_delta``: the
  installed parameters BITWISE the publishing trainer's (the rows and
  arrays are copied, never computed).
- The serving engine's scores against the other package's trainer:
  rtol 1e-5, atol 1e-6, as tests/test_torch_serve.py holds the two
  forwards (the MLPs' products sum in another fp32 order in XLA).
- ``fit_stream(resume=True)`` against an uninterrupted run: BITWISE.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.data.stream import ArrayStream as JaxArrayStream
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh
from dlrm_flexflow_tpu.serve import ServeConfig as JaxServeConfig
from dlrm_flexflow_tpu.serve.engine import InferenceEngine as JaxEngine
from dlrm_flexflow_tpu.serve.watcher import SnapshotWatcher as JaxWatcher
from dlrm_flexflow_tpu.utils import checkpoint as jax_ckpt
from dlrm_flexflow_tpu.utils import delta as jax_delta
from dlrm_flexflow_tpu.utils import histogram as jax_hist

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.serve import (InferenceEngine, ServeConfig,
                                           SnapshotWatcher)
from dlrm_flexflow_tpu_torch.utils import checkpoint as ckpt
from dlrm_flexflow_tpu_torch.utils import delta
from dlrm_flexflow_tpu_torch.utils import histogram as hist
from dlrm_flexflow_tpu_torch.utils.weights import (params_from_jax,
                                                   params_to_jax)

SMALL = dict(embedding_size=[64] * 8, sparse_feature_size=8,
             embedding_bag_size=2, mlp_bot=[4, 16, 8], mlp_top=[72, 16, 1])
ORDER = (3, 0, 7, 1, 6, 2, 5, 4)
BS = 16
# the small model's arrays are below the JAX default threshold: row-diff
# every array of 1,024 elements or more (the tables and fc layers); the
# chains compact on their full_every cadence alone (a delta of this
# model is a large share of its base)
MIN_ELEMS = 1024
NO_SIZE_COMPACTION = 1e9


def _jax_model(seed=5, order=ORDER):
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=seed))
    jax_build_dlrm(m, JaxDLRMConfig(**SMALL))
    if order:
        m.get_layer_by_name("emb_stack").set_table_order(order)
    m.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers()
    return m


def _port_model(jm=None, seed=0, order=ORDER, **cfg):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu", seed=seed,
                               **cfg))
    build_dlrm(m, DLRMConfig(**SMALL))
    if order:
        m.get_layer_by_name("emb_stack").set_table_order(order)
    m.compile(SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"])
    m.init_layers()
    if jm is not None:
        m.swap_params(params_from_jax(m, jax.tree.map(np.asarray,
                                                      jm.params)))
    return m


def _data(n=160, seed=3):
    return synthetic_batch(DLRMConfig(**SMALL), n, seed=seed)


def _query(n=5, seed=9):
    return synthetic_batch(DLRMConfig(**SMALL), n, seed=seed)[0]


def _port_params(m):
    return jax.tree.map(np.array, params_to_jax(m, m.params))


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _assert_histograms_read_alike(path):
    """Both packages read the same sketches from one id_histogram.npz,
    and a sketch saved by either is read back the same by the other."""
    ps, js = hist.load_histograms(str(path)), jax_hist.load_histograms(
        str(path))
    assert set(ps) == set(js) == {"emb_stack"}
    p, j = ps["emb_stack"], js["emb_stack"]
    assert (p.rows, p.buckets, p.total) == (j.rows, j.buckets, j.total)
    assert p.rows == 8 * 64 and p.total > 0
    np.testing.assert_array_equal(p.counts, j.counts)
    assert hist.sketch_signature(ps) == jax_hist.sketch_signature(js)
    hist.save_histograms(str(path) + ".port", ps)
    jax_hist.save_histograms(str(path) + ".jax", js)
    for a, b in ((str(path) + ".port", jax_hist), (str(path) + ".jax", hist)):
        back = b.load_histograms(a)["emb_stack"]
        np.testing.assert_array_equal(back.counts, p.counts)
        assert back.total == p.total


def _publish_chain(pm, d, steps=6, every=2, full_every=0):
    """A port fit_stream publishing into ``d``; returns the publisher."""
    x, y = _data()
    pub = delta.DeltaPublisher(pm, str(d), full_every=full_every,
                               compact_frac=NO_SIZE_COMPACTION,
                               row_delta_min_elems=MIN_ELEMS)
    pm.fit_stream(ArrayStream(x, y, BS, seed=1), steps=steps, publisher=pub,
                  publish_every=every, verbose=False)
    return pub


def test_tracker_candidates_and_sketches_match_jax():
    jm = _jax_model()
    pm = _port_model(jm)
    x, y = _data()
    jt, tt = jax_delta.TouchedRowTracker(jm), delta.TouchedRowTracker(pm)
    src = ArrayStream(x, y, BS, seed=1)
    for i in range(5):
        b = src(i)
        jt.observe(b)
        tt.observe(b)
    (jc, jn), (pc, pn) = jt.snapshot(), tt.snapshot()
    assert jn == pn == 5 and set(jc) == set(pc) == {"params/emb_stack/kernel"}
    np.testing.assert_array_equal(pc["params/emb_stack/kernel"],
                                  jc["params/emb_stack/kernel"])
    js, ps = jt.id_histograms(), tt.id_histograms()
    assert set(js) == set(ps) == {"emb_stack"}
    assert (ps["emb_stack"].rows, ps["emb_stack"].total) == (
        js["emb_stack"].rows, js["emb_stack"].total)
    np.testing.assert_array_equal(ps["emb_stack"].counts,
                                  js["emb_stack"].counts)


def test_diff_flat_matches_jax_and_candidates_change_nothing():
    """The same two states and candidates through both packages'
    ``_diff_flat``: the same idx and vals, bitwise; the candidate-limited
    diff equals the all-rows one."""
    jm = _jax_model()
    pm = _port_model(jm)
    jflat = jax_delta.serving_flat(jm)
    prev = delta.serving_flat(pm)
    assert {k: v.shape for k, v in prev.items()} == {
        k: v.shape for k, v in jflat.items()}
    x, y = _data()
    tracker = delta.TouchedRowTracker(pm)
    src = ArrayStream(x, y, BS, seed=1)
    for i in range(3):
        tracker.observe(src(i))
        pm.train_batch(src(i))
    cur = delta.serving_flat(pm)
    cand, _ = tracker.snapshot()
    for c in (cand, None):
        got = delta._diff_flat(prev, cur, c, MIN_ELEMS)
        want = jax_delta._diff_flat(prev, cur, c, MIN_ELEMS)
        assert got[2] == want[2] and sorted(got[1]) == sorted(want[1])
        for key, (idx, vals) in want[0].items():
            np.testing.assert_array_equal(got[0][key][0], idx)
            np.testing.assert_array_equal(got[0][key][1], vals)
    limited = delta._diff_flat(prev, cur, cand, MIN_ELEMS)
    everything = delta._diff_flat(prev, cur, None, MIN_ELEMS)
    assert limited[2] == everything[2] and limited[2]
    assert limited[2]["params/emb_stack/kernel"] > 0
    for k in everything[0]:
        np.testing.assert_array_equal(limited[0][k][0], everything[0][k][0])


def test_port_chain_loads_in_jax(tmp_path):
    """A port publisher's manifest, delta files and id histogram read
    in the JAX package: its manager, ``resolve_chain``,
    ``load_delta_file``, ``load_histograms``; a JAX engine hot-reloads
    the chain to the port trainer's parameters, bitwise."""
    pm = _port_model(_jax_model())
    pub = _publish_chain(pm, tmp_path, steps=7, every=2)
    assert (pub.full_publishes, pub.delta_publishes) == (1, 3)
    mgr = jax_ckpt.CheckpointManager(str(tmp_path))
    assert [e["step"] for e in mgr.delta_entries()] == [4, 6, 7]
    with open(tmp_path / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["id_histogram"]["file"] == "id_histogram.npz"
    jm = _jax_model(seed=17)
    fp = jax_ckpt.config_fingerprint(jm)
    assert fp == ckpt.config_fingerprint(pm)
    base, chain = jax_delta.resolve_chain(manifest, fp, str(tmp_path))
    assert base["step"] == 2 and [e["step"] for e in chain] == [4, 6, 7]
    for e in chain:
        path = str(tmp_path / e["file"])
        want, got = delta.load_delta_file(path), jax_delta.load_delta_file(
            path)
        assert (want["step"], want["prev_step"], want["base_step"]) == (
            got["step"], got["prev_step"], got["base_step"])
        assert set(want["rows"]) == set(got["rows"])
        for k, (i, v) in want["rows"].items():
            np.testing.assert_array_equal(got["rows"][k][0], i)
            np.testing.assert_array_equal(got["rows"][k][1], v)
        assert set(want["full"]) == set(got["full"])
    _assert_histograms_read_alike(tmp_path / "id_histogram.npz")
    eng = JaxEngine(jm, JaxServeConfig(max_batch=8, warmup=False))
    assert JaxWatcher(eng, str(tmp_path)).poll_once()
    assert eng.version == 7 and eng.stats()["delta_reloads"] == 3
    _assert_trees_equal(jax.tree.map(np.asarray, jm.params),
                        _port_params(pm))


def test_jax_chain_loads_in_the_port(tmp_path):
    """The other way round: a JAX publisher's chain and histogram read
    by the port's manager, ``resolve_chain``, ``load_delta_file`` and
    ``load_histograms``; a port engine reloads it bitwise."""
    jm = _jax_model()
    x, y = _data()
    pub = jax_delta.DeltaPublisher(jm, str(tmp_path),
                                   compact_frac=NO_SIZE_COMPACTION,
                                   row_delta_min_elems=MIN_ELEMS)
    jm.fit_stream(JaxArrayStream(x, y, BS, seed=1), steps=7, publisher=pub,
                  publish_every=2, verbose=False)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    assert [e["step"] for e in mgr.delta_entries()] == [4, 6, 7]
    with open(tmp_path / "manifest.json") as f:
        manifest = json.load(f)
    pm = _port_model(seed=4)
    fp = ckpt.config_fingerprint(pm)
    base, chain = delta.resolve_chain(manifest, fp, str(tmp_path))
    assert base["step"] == 2 and [e["step"] for e in chain] == [4, 6, 7]
    for e in chain:
        path = str(tmp_path / e["file"])
        got, want = delta.load_delta_file(path), jax_delta.load_delta_file(
            path)
        for k, (i, v) in want["rows"].items():
            np.testing.assert_array_equal(got["rows"][k][0], i)
            np.testing.assert_array_equal(got["rows"][k][1], v)
        for k, v in want["full"].items():
            np.testing.assert_array_equal(got["full"][k], v)
    _assert_histograms_read_alike(tmp_path / "id_histogram.npz")
    eng = InferenceEngine(pm, ServeConfig(max_batch=8, warmup=False))
    assert SnapshotWatcher(eng, str(tmp_path)).poll_once()
    assert eng.version == 7 and eng.stats()["delta_reloads"] == 3
    _assert_trees_equal(_port_params(pm),
                        jax.tree.map(np.asarray, jm.params))


def _variants(d):
    """(name, manifest, fingerprint) cases of one valid chain in ``d``."""
    with open(os.path.join(d, "manifest.json")) as f:
        good = json.load(f)
    out = [("valid", good, None)]
    fp = good["deltas"][0]["fingerprint"]
    out.append(("foreign fingerprint", good, "0123456789ab"))
    m = json.loads(json.dumps(good))
    del m["deltas"][1]
    out.append(("gap", m, fp))
    m = json.loads(json.dumps(good))
    m["entries"] = [e for e in m["entries"]
                    if e["step"] != m["deltas"][0]["base_step"]]
    out.append(("orphaned base", m, fp))
    m = json.loads(json.dumps(good))
    m["deltas"].append(dict(m["deltas"][0], file="delta-stale.npz",
                            base_step=-7, step=1))
    out.append(("mixed bases", m, fp))
    m = json.loads(json.dumps(good))
    for e in m["entries"]:
        e["crc32"] = (e["crc32"] or 0) + 1
    out.append(("replaced base", m, fp))
    m = json.loads(json.dumps(good))
    m["deltas"][0]["fingerprint"] = "0123456789ab"
    out.append(("foreign delta", m, fp))
    m = json.loads(json.dumps(good))
    m["deltas"] = []
    out.append(("no deltas", m, fp))
    return out


def test_resolve_chain_decides_as_jax(tmp_path):
    """Valid, foreign, gapped, orphaned, mixed, replaced-base, torn and
    missing chains: the same result or the same ChainError message."""
    pm = _port_model()
    _publish_chain(pm, tmp_path, steps=8, every=2)

    def both(manifest, fp):
        res = []
        for mod in (delta, jax_delta):
            try:
                r = mod.resolve_chain(manifest, fp, str(tmp_path))
                res.append(None if r is None else
                           (r[0]["file"], [e["file"] for e in r[1]]))
            except ValueError as e:
                assert type(e).__name__ == "ChainError"
                res.append(("ChainError", str(e)))
        return res

    seen = set()
    for name, manifest, fp in _variants(str(tmp_path)):
        got, want = both(manifest, fp)
        assert got == want, name
        seen.add("none" if got is None else
                 "error" if got[0] == "ChainError" else "chain")
    with open(tmp_path / "manifest.json") as f:
        good = json.load(f)
    fp = good["deltas"][0]["fingerprint"]
    torn = tmp_path / good["deltas"][1]["file"]
    shutil.copy(torn, tmp_path / "keep.npz")
    with open(torn, "r+b") as f:
        f.truncate(64)
    got, want = both(good, fp)
    assert got == want and "fails its CRC-32" in got[1]
    os.unlink(torn)
    got, want = both(good, fp)
    assert got == want and "missing on disk" in got[1]
    assert seen == {"none", "error", "chain"}


def test_apply_delta_validates_before_installing():
    pm = _port_model()
    before = _port_params(pm)
    key = "params/emb_stack/kernel"
    cases = [
        ({"params/nope/kernel": (np.zeros(1, np.int64),
                                 np.zeros((1, 128), np.float32))},
         "params/nope/kernel"),
        ({key: (np.asarray([32], np.int64), np.zeros((1, 128), np.float32))},
         "index up to 32"),
        ({key: (np.asarray([0], np.int64), np.zeros((1, 64), np.float32))},
         "width"),
        ({"state/emb_stack/kernel": (np.zeros(1, np.int64),
                                     np.zeros((1, 128), np.float32))},
         "unsupported section"),
    ]
    good = (np.asarray([1], np.int64), np.ones((1, 128), np.float32))
    for rows, msg in cases:
        with pytest.raises(ValueError, match=msg):
            pm.apply_delta({"step": 9, "rows": {key: good, **rows},
                            "full": {}})
        _assert_trees_equal(_port_params(pm), before)
    with pytest.raises(ValueError, match="params/fc/bias"):
        pm.apply_delta({"step": 9, "rows": {},
                        "full": {"params/fc/bias": np.zeros(3)}})
    assert pm._step == 0


def test_apply_delta_installs_as_jax():
    """One JAX delta payload applied by both packages from the same
    state: the same parameters, bitwise; the staged form installs the
    same."""
    jm = _jax_model()
    pm = _port_model(jm)
    rng = np.random.RandomState(0)
    key = "params/emb_stack/kernel"
    idx = np.asarray([0, 5, 17, 31], np.int64)
    payload = {"step": 3, "rows": {
        key: (idx, rng.randn(4, 128).astype(np.float32)),
        "params/bot_dense_0/kernel": (np.asarray([2], np.int64),
                                      rng.randn(1, 16).astype(np.float32))},
        "full": {"params/top_dense_1/bias":
                 rng.randn(1).astype(np.float32)}}
    staged_model = _port_model(jm)
    jm.apply_delta(payload)
    pm.apply_delta(payload)
    staged_model.apply_delta(delta.stage_delta_rows(staged_model, payload))
    want = jax.tree.map(np.asarray, jm.params)
    _assert_trees_equal(_port_params(pm), want)
    _assert_trees_equal(_port_params(staged_model), want)
    assert pm._step == 3


def test_jax_trainer_feeds_the_port_engine(tmp_path):
    """A JAX fit_stream with a DeltaPublisher (full, deltas, a
    compaction) hot-reloads into the port's started engine, polled after
    every publish: the engine's parameters equal the JAX trainer's
    bitwise at every version, its scores the trainer's forward within
    the tolerance above."""
    jm = _jax_model()
    x, y = _data()
    pub = jax_delta.DeltaPublisher(jm, str(tmp_path), full_every=2,
                                   compact_frac=NO_SIZE_COMPACTION,
                                   row_delta_min_elems=MIN_ELEMS)
    pm = _port_model(seed=8)
    q = _query()
    seen = []
    with InferenceEngine(pm, ServeConfig(max_batch=8)) as eng:
        watcher = SnapshotWatcher(eng, str(tmp_path))

        def cb(model, k, mets):
            if k % 2:
                return
            assert watcher.poll_once()
            assert eng.version == k
            _assert_trees_equal(_port_params(pm),
                                jax.tree.map(np.asarray, jm.params))
            got = eng.predict(q, timeout=30).scores
            want = np.asarray(jm.forward_batch(
                {k2: np.concatenate([v, np.zeros((BS - 5,) + v.shape[1:],
                                                 v.dtype)])
                 for k2, v in q.items()}))[:5]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            seen.append(k)

        jm.fit_stream(JaxArrayStream(x, y, BS, seed=1), steps=10,
                      publisher=pub, publish_every=2, callbacks=[cb],
                      verbose=False)
        st = eng.stats()
    assert seen == [2, 4, 6, 8, 10]
    assert pub.stats()["compactions"] >= 1
    assert st["delta_reloads"] == pub.stats()["delta_publishes"] >= 2
    assert st["full_reloads"] == pub.stats()["full_publishes"]
    assert st["reload_rejects"] == 0


def test_port_trainer_feeds_the_jax_engine(tmp_path):
    """The port's fit_stream publisher feeds the JAX watcher and engine:
    the JAX engine's parameters equal the port trainer's bitwise at
    every version, its scores the port trainer's ``forward_bucket``
    within the tolerance above."""
    pm = _port_model(_jax_model())
    x, y = _data()
    pub = delta.DeltaPublisher(pm, str(tmp_path), full_every=2,
                               compact_frac=NO_SIZE_COMPACTION,
                               row_delta_min_elems=MIN_ELEMS)
    jm = _jax_model(seed=23)
    q = _query()
    seen = []
    with JaxEngine(jm, JaxServeConfig(max_batch=8)) as eng:
        watcher = JaxWatcher(eng, str(tmp_path))

        def cb(model, k, mets):
            if k % 2:
                return
            assert watcher.poll_once()
            assert eng.version == k
            _assert_trees_equal(jax.tree.map(np.asarray, jm.params),
                                _port_params(pm))
            got = eng.predict(q, timeout=60).scores
            want = pm.forward_bucket(q, bucket=8).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            seen.append(k)

        pm.fit_stream(ArrayStream(x, y, BS, seed=1), steps=10,
                      publisher=pub, publish_every=2, callbacks=[cb],
                      verbose=False)
        st = eng.stats()
    assert seen == [2, 4, 6, 8, 10]
    assert st["delta_reloads"] == pub.stats()["delta_publishes"] >= 2
    assert st["reload_rejects"] == 0


def test_fit_stream_resume_is_bitwise(tmp_path):
    """A publishing fit_stream stopped after 7 steps (a full base at 4, a
    delta at 7) and resumed by a fresh model from the directory equals 12
    uninterrupted steps, bitwise: parameters, momentum and step."""
    x, y = _data()

    def model(seed):
        m = _port_model(seed=seed)
        m.compile(SGDOptimizer(lr=0.1, momentum=0.9), "mean_squared_error",
                  ["mse"])
        return m

    ref = model(0)
    ref.fit_stream(ArrayStream(x, y, BS, seed=1), steps=12, verbose=False)
    first = model(0)
    pub = delta.DeltaPublisher(first, str(tmp_path), full_every=4)
    out = first.fit_stream(ArrayStream(x, y, BS, seed=1), steps=7,
                           publisher=pub, publish_every=4, verbose=False)
    assert out["publishes"] == 2 and pub.full_publishes == 1
    again = model(99)
    pub2 = delta.DeltaPublisher(again, str(tmp_path), full_every=4)
    assert ckpt.CheckpointManager(str(tmp_path)).delta_entries() == []
    out = again.fit_stream(ArrayStream(x, y, BS, seed=1), steps=8,
                           publisher=pub2, publish_every=4, resume=True,
                           verbose=False)
    assert out["steps"] == 8 and again._step == ref._step == 12
    _assert_trees_equal(_port_params(again), _port_params(ref))
    for op, p in ref.opt_state["v"].items():
        for pn, v in p.items():
            assert torch.equal(again.opt_state["v"][op][pn], v)
    # the resumed publisher re-anchored on a fresh full base
    assert pub2.full_publishes >= 1
    with open(tmp_path / "manifest.json") as f:
        m = json.load(f)
    assert m["entries"][-1]["loader_state"]["stream_step"] == 8
    assert m["deltas"][-1]["loader_state"]["stream_step"] == 12


def test_failed_publish_is_retried_and_quantized_payloads_refused(tmp_path):
    """An aborted delta publish leaves no file and no entry; the next
    delta covers its rows, and the chain still installs bitwise. A
    quantized payload (the test keeps its name from before quantized
    payloads were ported) is written and loaded, and one with a corrupt
    scale is rejected on load."""
    from dlrm_flexflow_tpu_torch.utils import faults
    pm = _port_model()
    x, y = _data()
    pub = delta.DeltaPublisher(pm, str(tmp_path),
                               compact_frac=NO_SIZE_COMPACTION,
                               row_delta_min_elems=MIN_ELEMS)
    with faults.active_plan(faults.FaultPlan(publish_aborts=1)) as plan:
        pm.fit_stream(ArrayStream(x, y, BS, seed=1), steps=6, publisher=pub,
                      publish_every=2, verbose=False)
    assert plan.fired[0][0] == "publish_abort"
    assert pub.publish_errors == 1 and pub.delta_publishes == 1
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    assert [e["step"] for e in pub.mgr.delta_entries()] == [6]
    sv = _port_model(seed=3)
    eng = InferenceEngine(sv, ServeConfig(max_batch=8, warmup=False))
    assert SnapshotWatcher(eng, str(tmp_path)).poll_once()
    _assert_trees_equal(_port_params(sv), _port_params(pm))
    # a quantized payload is written as codes + scales and loads back
    # as their dequantized rows (tests/test_torch_quant_train.py holds it
    # to the JAX package's); a corrupt scale is a ChainError
    key = "params/emb_stack/kernel"
    vals = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    delta.write_delta_file(str(tmp_path / "q.npz"), 1, 0, 0,
                           {key: (np.arange(3), vals)}, {},
                           quant={key: "int8"})
    got = delta.load_delta_file(str(tmp_path / "q.npz"))
    _, q, scales, dt = got["qrows"][key]
    assert dt == "int8" and q.dtype == np.int8
    np.testing.assert_allclose(got["rows"][key][1], vals,
                               atol=float(scales.max()) / 2 + 1e-7)
    np.savez(tmp_path / "q.npz", **{"meta/step": 1, "meta/prev_step": 0,
                                    "meta/base_step": 0,
                                    "idx/params/a/kernel": np.zeros(1),
                                    "rows/params/a/kernel": np.zeros(
                                        (1, 2), np.int8),
                                    "scl/params/a/kernel": -np.ones(1),
                                    "qdt/params/a/kernel": np.asarray(
                                        "int8")})
    with pytest.raises(delta.ChainError, match="negative row scale"):
        delta.load_delta_file(str(tmp_path / "q.npz"))


def test_read_npz_reads_as_np_load(tmp_path):
    """``checkpoint.read_npz`` (one read a member) gives ``np.load``'s
    arrays, bitwise, with their dtypes, shapes and memory order, writable;
    ``keep`` selects keys; a torn file raises as ``np.load`` does."""
    import zipfile
    rng = np.random.RandomState(0)
    arrays = {"params/a/kernel": rng.rand(37, 5).astype(np.float32),
              "meta/step": np.asarray(7, np.int64),
              "qdt/x": np.asarray("int8"),
              "empty": np.zeros((0, 4), np.float32),
              "f": np.asfortranarray(rng.rand(3, 4))}
    path = str(tmp_path / "a.npz")
    np.savez(path, **arrays)
    got = ckpt.read_npz(path)
    with np.load(path) as want:
        assert set(got) == set(want.files)
        for k in want.files:
            w = want[k]
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            assert got[k].flags.f_contiguous == w.flags.f_contiguous, k
            np.testing.assert_array_equal(got[k], w)
            assert got[k].flags.writeable
    assert set(ckpt.read_npz(path, keep=lambda k: k.startswith("meta/"))) \
        == {"meta/step"}
    with open(path, "r+b") as f:
        f.truncate(200)
    for load in (ckpt.read_npz, lambda p: dict(np.load(p))):
        with pytest.raises(zipfile.BadZipFile):
            load(path)
