"""Shard processes on the CPU: ``python -m
dlrm_flexflow_tpu_torch.serve.shard_server`` children booted from a warm
cache, the tier connected to them over loopback TCP, and the app's
``--serve-transport tcp --serve-shard-procs N``.

The small host-table DLRM of tests/test_torch_shardtier.py (4 tables x
64 rows x d = 8, batch 16). Tolerances: the engine over shard processes
is BITWISE the engine over the in-process tier (the same rows, the same
assembly, the same forward); after a ``kill -9`` answers are flagged
degraded and none fails, and once the slot is replaced from the warm
cache they are bitwise again.

Every child is killed and reaped by the test that spawned it; every wait
is bounded.
"""

import json
import signal

import numpy as np
import pytest

from dlrm_flexflow_tpu_torch.config import FFConfig
from dlrm_flexflow_tpu_torch.examples.native import serve_dlrm
from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig
from dlrm_flexflow_tpu_torch.serve import (EmbeddingShardSet,
                                           InferenceEngine, ServeConfig)

from test_torch_serve_app import BASE, _Running, _request
from test_torch_shardtier import BS, _port, _rows, _tier_cfg

WAIT_S = 60.0


@pytest.fixture
def procs():
    p = serve_dlrm.ShardProcs()
    yield p
    p.stop()


def test_kill_9_degrades_never_fails_then_the_slot_is_replaced(procs,
                                                               tmp_path):
    m = _port()
    x = _rows(8)
    EmbeddingShardSet.seed_shard_cache(m, 2, str(tmp_path))
    cfg = _tier_cfg(eject_after=1, retries=0, lookup_deadline_ms=5000)
    sset = EmbeddingShardSet.connect(procs.spawn(str(tmp_path), 2),
                                     config=cfg, cache_dir=str(tmp_path))
    local = EmbeddingShardSet.build(m, 2, config=_tier_cfg())
    engines = [InferenceEngine(m, ServeConfig(max_batch=BS),
                               shard_set=s).start() for s in (sset, local)]
    try:
        got, want = (e.predict(x, timeout=WAIT_S) for e in engines)
        np.testing.assert_array_equal(got.scores, want.scores)
        assert got.versions == {0: 0, 1: 0} and not got.degraded
        procs.procs[1].send_signal(signal.SIGKILL)
        procs.procs[1].wait(WAIT_S)
        for i in range(3):
            p = engines[0].predict(_rows(8, seed=i), timeout=WAIT_S)
            assert p.degraded and p.versions == {0: 0}
        for _ in range(2 * cfg.replace_after + 2):
            sset.health_tick()
        assert sset.replacements == 1 and sset.shards[1].state == "healthy"
        np.testing.assert_array_equal(
            engines[0].predict(_rows(8, seed=7), timeout=WAIT_S).scores,
            engines[1].predict(_rows(8, seed=7), timeout=WAIT_S).scores)
        assert engines[0].stats()["degraded_responses"] == 3
    finally:
        for e in engines:
            e.close()
        sset.close()
        local.close()


def test_a_shard_that_cannot_boot_names_its_slot(procs, tmp_path):
    with pytest.raises(SystemExit, match="slot 0 failed to boot"):
        procs.spawn(str(tmp_path), 2)   # no seeded cache there
    assert procs.procs[0].wait(WAIT_S) != 0


def test_the_app_serves_over_shard_processes_and_reaps_them(tmp_path):
    app = _Running(BASE + ["--host-tables", "--serve-transport", "tcp",
                           "--serve-shard-procs", "2",
                           "--compile-cache-dir", str(tmp_path / "cache")])
    children = list(app.app.procs.procs)
    try:
        assert len(children) == 2 and all(p.poll() is None
                                           for p in children)
        assert all(r.shard.remote for r in app.app.shard_set.shards)
        x, body = _request(2)
        code, text = app.post("/predict", body)
        out = json.loads(text)
        assert code == 200 and out["versions"] == {"0": 0, "1": 0}
        assert out["degraded"] is False
        # the app seeded the cache from its model before it released its
        # tables: the answer is BITWISE the same model's own forward
        cfg = FFConfig.parse_args(BASE + ["--host-tables"])
        m = serve_dlrm.build_server_model(
            cfg, DLRMConfig.parse_args(cfg.unparsed))
        np.testing.assert_array_equal(
            np.asarray(out["scores"], np.float32),
            m.forward_bucket(x, 2).numpy().reshape(-1))
    finally:
        app.close()
    assert all(p.poll() is not None for p in children)


@pytest.mark.parametrize("flags,match", [
    (["--serve-transport", "tcp", "--serve-shards", "2"],
     "--serve-shard-procs N"),
    (["--retrieve", "on", "--serve-transport", "tcp"],
     "--retrieve on requires --serve-transport inproc"),
    (["--retrieve", "on", "--serve-transport", "tcp",
      "--serve-shard-procs", "2"], "--retrieve on requires"),
    (["--serve-transport", "tcp", "--serve-shard-procs", "2"],
     "needs a shard cache directory"),
])
def test_the_jax_apps_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        serve_dlrm.App(BASE + ["--host-tables"] + flags)
