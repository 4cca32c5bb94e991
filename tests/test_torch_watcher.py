"""The port's snapshot watcher and the engine's hot-reload hooks on the
CPU, against the JAX package where both decide: torn, gapped and foreign
chains fall back to the newest full snapshot with a reason, reported
once; corrupt and poisoned reloads; backoff; the background watcher
reaching the trainer's tip; installs parked for the batcher.

The small "cat" DLRM of tests/test_torch_delta.py, batch 16, plain SGD.
Tolerances: an installed state is BITWISE the trainer's (rows and arrays
are copied), and the engine's scores BITWISE the trainer's
``forward_bucket`` on the same bucket (one process, the same kernels,
the same shapes); the fault hooks' budgets and the environment variables
parse as in the JAX package.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import jax

from dlrm_flexflow_tpu.serve import ServeConfig as JaxServeConfig
from dlrm_flexflow_tpu.serve.engine import InferenceEngine as JaxEngine
from dlrm_flexflow_tpu.serve.watcher import SnapshotWatcher as JaxWatcher
from dlrm_flexflow_tpu.utils import faults as jax_faults

from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
from dlrm_flexflow_tpu_torch.serve import (InferenceEngine, ServeConfig,
                                           SnapshotWatcher)
from dlrm_flexflow_tpu_torch.utils import delta, faults

from test_torch_delta import (BS, MIN_ELEMS, NO_SIZE_COMPACTION,
                              _assert_trees_equal, _data, _jax_model,
                              _port_model, _port_params, _query)


def _publisher(pm, d, full_every=0):
    return delta.DeltaPublisher(pm, str(d), full_every=full_every,
                                compact_frac=NO_SIZE_COMPACTION,
                                row_delta_min_elems=MIN_ELEMS)


def _train(pm, pub, steps, start=0):
    """``steps`` more steps of the stream, publishing at the end."""
    x, y = _data()
    src = ArrayStream(x, y, BS, seed=1)
    for i in range(start, start + steps):
        b = src(i)
        pub.observe_batch(b)
        pm.train_batch(b)
    return pub.publish({"stream_step": start + steps})


def _engine(seed=7):
    return InferenceEngine(_port_model(seed=seed),
                           ServeConfig(max_batch=8, warmup=False))


@pytest.fixture
def env_faults(monkeypatch):
    """Set FF_FAULT_* variables (only these) and adopt them, as a fresh
    process does; the plan is cleared afterwards."""

    def adopt(**kv):
        for k in list(os.environ):
            if k.startswith("FF_FAULT_"):
                monkeypatch.delenv(k)
        for k, v in kv.items():
            monkeypatch.setenv(k, v)
        return faults.install(faults.plan_from_env())

    yield adopt
    faults.clear()


def test_fault_env_keys_parse_as_jax(env_faults, monkeypatch):
    keys = ("FF_FAULT_DELTA_TORN", "FF_FAULT_PUBLISH_ABORT",
            "FF_FAULT_DELTA_GAP", "FF_FAULT_CORRUPT_RELOAD",
            "FF_FAULT_POISON_RELOAD")
    plan = env_faults(**{k: str(i + 1) for i, k in enumerate(keys)})
    want = jax_faults.plan_from_env()
    for f in ("torn_deltas", "publish_aborts", "delta_gaps",
              "corrupt_reloads", "poison_reloads", "torn_delta_bytes",
              "corrupt_reload_bytes", "poison_reload_scale"):
        assert getattr(plan, f) == getattr(want, f), f
    monkeypatch.setenv("FF_FAULT_DELTA_TORN", "x")
    with pytest.raises(ValueError) as ep:
        faults.plan_from_env()
    with pytest.raises(ValueError) as ej:
        jax_faults.plan_from_env()
    assert str(ep.value) == str(ej.value)


def test_torn_delta_is_rejected_once_and_the_compaction_recovers(
        tmp_path, env_faults):
    """FF_FAULT_DELTA_TORN=1 tears the third publish (a delta): the
    watcher rejects the chain with the CRC reason, reports it once,
    keeps serving the last good version, and the next full publish
    reloads the trainer's state bitwise."""
    pm = _port_model()
    pub = _publisher(pm, tmp_path)
    eng = _engine().start()
    w = SnapshotWatcher(eng, str(tmp_path))
    q = _query()
    try:
        _train(pm, pub, 2)                          # full base, step 2
        assert w.poll_once() and eng.version == 2
        _train(pm, pub, 2, start=2)                 # delta, step 4
        assert w.poll_once() and eng.version == 4
        good = eng.predict(q).scores
        np.testing.assert_array_equal(good,
                                      pm.forward_bucket(q, 8).numpy())
        env_faults(FF_FAULT_DELTA_TORN="1")
        _train(pm, pub, 2, start=4)                 # torn delta, step 6
        faults.clear()
        assert not w.poll_once() and not w.poll_once()
        st = eng.stats()
        assert eng.version == 4 and st["reload_rejects"] == 1
        assert "fails its CRC-32" in st["last_reload_reject"]
        assert "falling back to full reload" in st["last_reload_reject"]
        np.testing.assert_array_equal(eng.predict(q).scores, good)
        assert w.stats()["chain_fallbacks"] == 1
        pub.publish_full({"stream_step": 6})        # compaction
        assert w.poll_once() and eng.version == 6
        _assert_trees_equal(_port_params(eng.model), _port_params(pm))
        np.testing.assert_array_equal(eng.predict(q).scores,
                                      pm.forward_bucket(q, 8).numpy())
        st = eng.stats()
        assert (st["full_reloads"], st["delta_reloads"]) == (2, 1)
    finally:
        eng.close()


def test_gap_falls_back_to_the_newest_full_snapshot(tmp_path, env_faults):
    """FF_FAULT_DELTA_GAP=1 drops a delta's manifest entry: a cold engine
    rejects the chain (gap) and restores the base, as the JAX watcher
    decides on the same directory."""
    pm = _port_model(_jax_model())
    pub = _publisher(pm, tmp_path)
    _train(pm, pub, 2)
    env_faults(FF_FAULT_DELTA_GAP="1")
    _train(pm, pub, 2, start=2)
    faults.clear()
    _train(pm, pub, 2, start=4)
    eng = _engine()
    assert SnapshotWatcher(eng, str(tmp_path)).poll_once()
    jm = _jax_model(seed=13)
    jeng = JaxEngine(jm, JaxServeConfig(max_batch=8, warmup=False))
    assert JaxWatcher(jeng, str(tmp_path)).poll_once()
    assert eng.version == jeng.version == 2
    assert "chain gap" in eng.stats()["last_reload_reject"]
    assert eng.stats()["last_reload_reject"] == \
        jeng.stats()["last_reload_reject"]
    _assert_trees_equal(_port_params(eng.model),
                        jax.tree.map(np.asarray, jm.params))


def test_corrupt_and_poisoned_reloads(tmp_path, env_faults):
    pm = _port_model()
    pub = _publisher(pm, tmp_path)
    _train(pm, pub, 2)
    eng = _engine()
    w = SnapshotWatcher(eng, str(tmp_path))
    env_faults(FF_FAULT_CORRUPT_RELOAD="1")
    assert not w.poll_once()
    assert eng.version == 0 and "failed to load" in \
        eng.stats()["last_reload_reject"]
    faults.clear()
    pub.publish_full({"stream_step": 2})   # a clean copy, same step
    assert w.poll_once() and eng.version == 2
    assert eng.stats()["reload_rejects"] == 1
    pm.train_batch(ArrayStream(*_data(), BS, seed=1)(2))
    pub.publish_full({"stream_step": 3})
    env_faults(FF_FAULT_POISON_RELOAD="1")
    w2 = SnapshotWatcher(_engine(seed=2), str(tmp_path))
    assert w2.poll_once()
    got = _port_params(w2._engine.model)
    want = _port_params(pm)
    np.testing.assert_array_equal(
        got["emb_stack"]["kernel"],
        (want["emb_stack"]["kernel"] * np.float32(1e3)))


def test_foreign_snapshot_is_reported_once_and_backs_off(tmp_path):
    """A snapshot of another graph: one reject with the fingerprint
    reason however often it is polled; consecutive failing polls back
    off exponentially up to backoff_max_s, and a good poll resets."""
    pm = _port_model()
    _train(pm, _publisher(pm, tmp_path), 2)
    m = json.loads((tmp_path / "manifest.json").read_text())
    for e in m["entries"]:
        e["fingerprint"] = "0123456789ab"
    (tmp_path / "manifest.json").write_text(json.dumps(m))
    eng = _engine()
    w = SnapshotWatcher(eng, str(tmp_path), poll_s=0.01, backoff_max_s=0.3)
    paces = []
    for _ in range(8):
        w._poll_tick()
        paces.append(w.stats()["next_poll_s"])
    st = w.stats()
    assert eng.stats()["reload_rejects"] == 1
    assert "fingerprint" in eng.stats()["last_reload_reject"]
    assert st["reload_failures"] == 8 and st["consecutive_failures"] == 8
    assert paces[-1] <= 0.3 and max(paces) > 0.05
    m["entries"][0]["fingerprint"] = None
    (tmp_path / "manifest.json").write_text(json.dumps(m))
    assert w._poll_tick() and w.stats()["next_poll_s"] == 0.01


def test_background_watcher_reaches_the_tip_under_traffic(tmp_path):
    """An engine started with checkpoint_dir follows a publishing
    fit_stream on its own watcher thread while a client thread keeps
    predicting: it reaches the final version, every answer is finite and
    tagged with a published version, and at the tip the engine's scores
    are the trainer's bitwise."""
    pm = _port_model()
    pub = _publisher(pm, tmp_path, full_every=2)
    x, y = _data()
    eng = InferenceEngine(_port_model(seed=3),
                          ServeConfig(max_batch=8, poll_s=0.01),
                          checkpoint_dir=str(tmp_path)).start()
    q = _query()
    stop, seen, errors = threading.Event(), set(), []

    def client():
        try:
            while not stop.is_set():
                p = eng.predict(q, timeout=30)
                assert np.isfinite(p.scores).all()
                seen.add(p.version)
        except Exception as e:   # noqa: BLE001 — asserted below
            errors.append(e)

    th = threading.Thread(target=client)
    th.start()
    try:
        pm.fit_stream(ArrayStream(x, y, BS, seed=1), steps=12, publisher=pub,
                      publish_every=2, verbose=False)
        deadline = time.monotonic() + 30
        while eng.version != 12 and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        th.join(30)
        assert not errors and eng.version == 12
        assert seen <= {0, 2, 4, 6, 8, 10, 12}
        np.testing.assert_array_equal(eng.predict(q).scores,
                                      pm.forward_bucket(q, 8).numpy())
        st = eng.stats()
        assert st["reload_rejects"] == 0 and st["delta_reloads"] >= 1
        assert st["watcher"]["polls"] > 0
    finally:
        stop.set()
        eng.close()


def test_installs_run_on_the_batcher_between_dispatches():
    """install_snapshot, install_delta and run_quiesced park their work
    for the batcher thread and return once it is applied; a full install
    supersedes parked deltas; a failed call re-raises and counts as a
    reject; healthz reflects the lifecycle."""
    eng = _engine()
    assert eng.healthz()["ok"] is False          # not started: draining
    eng.start()
    try:
        assert eng.healthz()["ok"] and eng.healthz()["batcher_alive"]
        names = []
        assert eng.run_quiesced(
            lambda: names.append(threading.current_thread().name) or 5) == 5
        assert names == ["ff-serve-batcher"]
        with pytest.raises(RuntimeError, match="boom"):
            eng.run_quiesced(lambda: (_ for _ in ()).throw(
                RuntimeError("boom")))
        assert eng.stats()["reload_rejects"] == 1
        src = _port_model(seed=11)
        state = {"params": src.params, "op_state": {}, "host_params": None}
        eng.install_snapshot(state, 5, source="x")
        assert eng.version == 5 and eng.has_applied_snapshot
        _assert_trees_equal(_port_params(eng.model), _port_params(src))
        bad = {"step": 6, "rows": {"params/nope/kernel": (
            np.zeros(1, np.int64), np.zeros((1, 2), np.float32))},
            "full": {}}
        eng.install_delta(bad, 6)
        assert eng.version == 5 and "nope" in eng.stats()[
            "last_reload_reject"]
        # the JAX engine's wire server: predict over loopback answers
        # the engine's own scores bitwise, with its version
        from dlrm_flexflow_tpu_torch.serve.transport import \
            RemoteEngineClient
        server = eng.serve()
        client = RemoteEngineClient(server.address, rid=0)
        try:
            q = _query(3)
            got = client.predict(q, timeout=30)
            np.testing.assert_array_equal(got.scores,
                                          eng.predict(q, timeout=30).scores)
            assert got.version == 5 and client.healthz()["ok"] is True
        finally:
            client.close()
            server.close()
    finally:
        eng.close()
    assert eng.healthz()["ok"] is False and eng.healthz()["draining"]


def test_swap_params_refuses_what_the_port_lacks():
    pm = _port_model()
    # host-resident tables are ported: a host-table model installs new
    # tables, and a model of device tables refuses any
    with pytest.raises(ValueError, match="host tables"):
        pm.swap_params(pm.params, host_params={"x": {}})
    hm = _port_model(host_resident_tables=True)
    new = {"emb_stack": {"kernel": np.zeros_like(
        hm.host_params["emb_stack"]["kernel"])}}
    hm.swap_params(hm.params, host_params=new)
    assert hm.host_params is new
    with pytest.raises(NotImplementedError, match="item 11"):
        pm.swap_params(pm.params, op_state={"bn": {"mean": 1}})
    pm.swap_params(pm.params, op_state={})
    # the row cache is ported (a host-table engine builds one)
    assert ServeConfig.from_config(type(pm.config)(
        device="cpu", serve_cache_rows=8)).cache_rows == 8
    # the fleet is ported: a config of two replicas gives each replica
    # its engine config, as the JAX ServeConfig.from_config does
    assert ServeConfig.from_config(type(pm.config)(
        device="cpu", serve_replicas=2, serve_max_batch=8)).max_batch == 8
