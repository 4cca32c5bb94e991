"""The port's serving app, ``python -m
dlrm_flexflow_tpu_torch.examples.native.serve_dlrm``, on the CPU through a
real ``ThreadingHTTPServer`` on 127.0.0.1 (port 0): its endpoints, status
codes and JSON keys are the JAX app's.

- ``/predict`` answers the engine's scores, and the JSON round trip of
  the float32 scores is EXACT (``tolist()``, float64 text): BITWISE the
  app model's ``forward_bucket`` on the same bucket; with
  ``--checkpoint-dir`` the app restores the newest snapshot and then
  hot-reloads a published delta, answering the trainer's scores bitwise.
- ``/healthz`` 200 while serving and 503 once draining; ``/stats`` the
  engine's stats with the reload counters; ``/metrics`` the Prometheus
  text with the JAX engine's series names under ``--obs on`` and a
  comment without it; 400, 404, 429 and 504 where the JAX app answers
  them.
- ``--retrieve on``: ``/predict`` answers candidates and ``/retrieve``
  the index stage alone, with the JAX app's keys.
- The JAX app's deployment flags serve as the JAX app serves them (the
  fleet, its router's and autoscaler's knobs, the shard warm cache of
  ``--compile-cache-dir``) or are refused with its messages.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
from dlrm_flexflow_tpu_torch.examples.native import serve_dlrm
from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, synthetic_batch
from dlrm_flexflow_tpu_torch.obs import metrics, trace
from dlrm_flexflow_tpu_torch.serve import DeadlineExceeded, Overloaded
from dlrm_flexflow_tpu_torch.utils import delta

from test_torch_delta import (BS, MIN_ELEMS, NO_SIZE_COMPACTION, SMALL,
                              _data, _port_model)

ARCH = ["--arch-embedding-size", "-".join(["64"] * 8),
        "--arch-sparse-feature-size", "8", "--embedding-bag-size", "2",
        "--arch-mlp-bot", "4-16-8", "--arch-mlp-top", "72-16-1"]
BASE = ["--device", "cpu", "-b", str(BS), "--host", "127.0.0.1",
        "--port", "0", "--serve-max-batch", "8"] + ARCH


@pytest.fixture(autouse=True)
def _obs_off(monkeypatch):
    for mod in (metrics, trace):
        monkeypatch.setattr(mod, "_ENABLED", False)
    yield
    metrics.registry().reset()
    trace.clear()


class _Running:
    """An app serving on a thread; ``close`` stops and releases it."""

    def __init__(self, argv):
        self.app = serve_dlrm.App(argv)
        host, port = self.app.address
        self.url = f"http://{host}:{port}"
        self._th = threading.Thread(target=self.app.serve, daemon=True)
        self._th.start()

    def get(self, path):
        return self._call(urllib.request.Request(self.url + path))

    def post(self, path, body):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        return self._call(urllib.request.Request(self.url + path, data=data,
                                                 method="POST"))

    @staticmethod
    def _call(req):
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def close(self):
        self.app.shutdown()
        self._th.join(30)
        self.app.close()


def _request(n=3, seed=4):
    x, _ = synthetic_batch(DLRMConfig(**SMALL), n, seed=seed)
    return x, {k: v.tolist() for k, v in x.items()}


def test_endpoints_codes_and_keys(monkeypatch):
    srv = _Running(BASE)
    try:
        x, body = _request()
        code, text = srv.post("/predict", body)
        assert code == 200
        out = json.loads(text)
        assert set(out) == {"scores", "version", "latency_ms"}
        want = srv.app.engine.model.forward_bucket(x, 4).numpy().reshape(-1)
        np.testing.assert_array_equal(np.asarray(out["scores"], np.float32),
                                      want)
        assert out["version"] == 0
        code, text = srv.get("/healthz")
        assert code == 200 and json.loads(text)["ok"] is True
        code, text = srv.get("/stats")
        st = json.loads(text)
        assert code == 200 and st["responses"] == 1
        assert {"reloads", "full_reloads", "delta_reloads",
                "reload_rejects"} <= set(st)
        code, text = srv.get("/metrics")
        assert code == 200 and text.startswith("# observability is off")
        assert srv.get("/nope")[0] == 404
        assert srv.post("/retrieve", body)[0] == 404
        assert srv.post("/predict", {"dense": body["dense"]})[0] == 400
        assert srv.post("/predict", b"{not json")[0] == 400
        bad = dict(body, dense=[[0.0] * 5] * 3)
        assert srv.post("/predict", bad)[0] == 400
        eng = srv.app.engine
        for exc, status in ((Overloaded(3, 3), 429),
                            (DeadlineExceeded("late"), 504),
                            (RuntimeError("boom"), 500)):
            def fail(*a, _e=exc, **k):
                raise _e
            monkeypatch.setattr(eng, "predict", fail)
            code, text = srv.post("/predict", body)
            assert code == status and "error" in json.loads(text)
        monkeypatch.undo()
        eng.close()                       # draining: a balancer must stop
        code, text = srv.get("/healthz")
        assert code == 503 and json.loads(text)["draining"] is True
    finally:
        srv.close()


def test_restores_then_hot_reloads_the_trainers_chain(tmp_path):
    """A trainer publishes a full base; the app restores it params-only
    at start, then follows a delta (--serve-poll 0.01): /predict answers
    the trainer's forward_bucket bitwise at each version, and /metrics
    (--obs on) shows the reload series."""
    pm = _port_model(seed=2, order=None)      # the app's storage order
    pub = delta.DeltaPublisher(pm, str(tmp_path),
                               compact_frac=NO_SIZE_COMPACTION,
                               row_delta_min_elems=MIN_ELEMS)
    x, y = _data()
    src = ArrayStream(x, y, BS, seed=1)

    def train(a, b):
        for i in range(a, b):
            pub.observe_batch(src(i))
            pm.train_batch(src(i))
        pub.publish({"stream_step": b})

    train(0, 2)
    srv = _Running(BASE + ["--checkpoint-dir", str(tmp_path),
                           "--serve-poll", "0.01", "--obs", "on"])
    try:
        q, body = _request(n=5)
        for version in (2, 4):
            if version == 4:
                train(2, 4)
                deadline = time.monotonic() + 30
                while (srv.app.engine.version != 4
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
            out = json.loads(srv.post("/predict", body)[1])
            assert out["version"] == version
            np.testing.assert_array_equal(
                np.asarray(out["scores"], np.float32),
                pm.forward_bucket(q, 8).numpy().reshape(-1))
        st = json.loads(srv.get("/stats")[1])
        assert (st["full_reloads"], st["delta_reloads"]) == (1, 1)
        code, text = srv.get("/metrics")
        assert code == 200
        for name in ("ff_serve_reloads_total", "ff_serve_delta_reloads_total",
                     "ff_serve_reload_rejects_total", "ff_serve_version",
                     "ff_watcher_polls_total",
                     "ff_serve_request_latency_ms_count"):
            assert name in text, name
        assert 'ff_serve_version{replica=""} 4' in text
    finally:
        srv.close()


def test_retrieve_on_answers_candidates():
    srv = _Running(BASE + ["--serve-max-batch", "16",
                           "--retrieve", "on", "--retrieve-k", "5",
                           "--retrieve-shards", "2",
                           "--retrieve-deadline-ms", "10000"])
    try:
        _, body = _request(n=2)
        code, text = srv.post("/predict", body)
        assert code == 200
        out = json.loads(text)
        assert set(out) == {"candidates", "scores", "version",
                            "retrieve_versions", "degraded", "latency_ms",
                            "stage_ms"}
        assert np.asarray(out["candidates"]).shape == (2, 5)
        assert out["degraded"] is False
        code, text = srv.post("/retrieve", dict(body, k=3))
        out = json.loads(text)
        assert code == 200 and set(out) == {
            "ids", "scores", "versions", "degraded", "dropped_slots",
            "latency_ms"}
        ids = np.asarray(out["ids"])
        assert ids.shape == (2, 3) and (ids >= 0).all() and (ids < 64).all()
        assert "cascade" in json.loads(srv.get("/stats")[1])
    finally:
        srv.close()


# every deployment flag of the JAX app is ported: each case keeps its ID
# and checks what the JAX app does with the same flags. "tier" cases serve
# a host-table app on a 2-shard tier with a row cache; "fleet" serves two
# replicas behind the router; "engine" serves one engine with the knob
# set (the JAX app's autoscaler and router need --serve-replicas > 1, and
# tcp carries only a shard tier); "refused" is the JAX app's start-up
# refusal; "cache" is --compile-cache-dir as the tier's warm cache
@pytest.mark.parametrize("flags,item", [
    pytest.param(["--serve-replicas", "2"], "fleet", id="flags0-item 9.4"),
    pytest.param(["--serve-slo-ms", "20"], "engine", id="flags1-item 9.4"),
    pytest.param(["--serve-min-replicas", "1"], "engine",
                 id="flags2-item 9.4"),
    pytest.param(["--serve-max-replicas", "4"], "engine",
                 id="flags3-item 9.4"),
    pytest.param(["--serve-hedge-ms", "5"], "tier", id="flags4-item 9.4"),
    pytest.param(["--serve-canary-fraction", "0.2"], "engine",
                 id="flags5-item 9.4"),
    pytest.param(["--serve-shards", "2"], "tier", id="flags6-item 9.3"),
    pytest.param(["--serve-shard-procs", "2"], "refused",
                 id="flags7-item 9.3"),
    pytest.param(["--serve-transport", "tcp"], "engine",
                 id="flags8-item 9.3"),
    pytest.param(["--serve-degrade", "fail"], "tier", id="flags9-item 9.3"),
    pytest.param(["--serve-lookup-deadline-ms", "9"], "tier",
                 id="flags10-item 9.3"),
    pytest.param(["--serve-cache-rows", "64"], "tier", id="flags11-item 9.2"),
    pytest.param(["--serve-cache-warm", "x.npz"], "tier",
                 id="flags12-item 9.2"),
    pytest.param(["--compile-cache-dir", "x"], "cache",
                 id="flags13-item 9.5"),
])
def test_unported_deployments_raise_with_their_item(flags, item, tmp_path,
                                                    monkeypatch):
    if item == "refused":
        with pytest.raises(SystemExit,
                           match="--serve-shard-procs requires "
                                 "--serve-transport tcp"):
            serve_dlrm.App(BASE + flags)
        return
    x, body = _request(3)
    if item in ("fleet", "engine"):
        srv = _Running(BASE + flags)
        try:
            cfg = srv.app.engine.model.config
            code, text = srv.post("/predict", body)
            out = json.loads(text)
            want = srv.app.engine.model.forward_bucket(x, 4).numpy()
            assert code == 200 and set(out) == {"scores", "version",
                                                "latency_ms"}
            np.testing.assert_array_equal(
                np.asarray(out["scores"], np.float32), want.reshape(-1))
            st = json.loads(srv.get("/stats")[1])
            hz = json.loads(srv.get("/healthz")[1])
            assert srv.app.scaler is None
            if item == "fleet":
                assert srv.app.router is not None
                assert st["fleet"]["size"] == 2 and st["responses"] == 1
                assert st["failed"] == 0 and hz["healthy"] == 2
            else:
                assert srv.app.router is None and st["responses"] == 1
                key, val = {
                    "--serve-slo-ms": ("serve_slo_ms", 20.0),
                    "--serve-min-replicas": ("serve_min_replicas", 1),
                    "--serve-max-replicas": ("serve_max_replicas", 4),
                    "--serve-canary-fraction":
                        ("serve_canary_fraction", 0.2),
                    "--serve-transport": ("serve_transport", "tcp"),
                }[flags[0]]
                assert getattr(cfg, key) == val
        finally:
            srv.close()
        return
    # a host-table app on a 2-shard tier with a row cache takes the flag,
    # and its /predict answers the tier's version vector
    monkeypatch.chdir(tmp_path)
    extra = ["--host-tables", "--serve-shards", "2",
             "--serve-cache-rows", "16"]
    srv = _Running(BASE + extra + flags)
    try:
        cfg = srv.app.engine.model.config
        want = {"--serve-hedge-ms": ("serve_hedge_ms", 5.0),
                "--serve-degrade": ("serve_degrade", "fail"),
                "--serve-lookup-deadline-ms":
                    ("serve_lookup_deadline_ms", 9.0),
                "--serve-cache-warm": ("serve_cache_warm", "x.npz")
                }.get(flags[0])
        if want is not None:
            assert getattr(cfg, want[0]) == want[1]
        tcfg = srv.app.shard_set.config
        assert (tcfg.nshards, tcfg.hedge_ms, tcfg.degrade,
                tcfg.lookup_deadline_ms) == (
            2, cfg.serve_hedge_ms, cfg.serve_degrade,
            cfg.serve_lookup_deadline_ms)
        cache = srv.app.shard_set._cache
        if item == "cache":
            # the JAX app's shard warm cache: every slot persisted there,
            # the replace-dead boot source
            assert cache.directory == str(tmp_path / "x")
            assert cache.get(2, 0) is not None and cache.get(2, 1) \
                is not None
        else:
            assert cache is None
        _x, body = _request(2)
        code, text = srv.post("/predict", body)
        out = json.loads(text)
        assert code == 200 and out["versions"] == {"0": 0, "1": 0}
        assert out["degraded"] is False
        assert srv.app.engine.stats()["embedding_cache"]["capacity"] == (
            64 if flags[0] == "--serve-cache-rows" else 16)
    finally:
        srv.close()


def test_retrieve_shards_without_retrieve_is_refused():
    with pytest.raises(SystemExit, match="--retrieve on"):
        serve_dlrm.App(BASE + ["--retrieve-shards", "2"])


@pytest.mark.parametrize("flags", [["--arch-interaction-op", "dot"],
                                   ["--host-tables"],
                                   ["--arch-interaction-op", "dot",
                                    "--host-tables"]])
def test_serves_a_jax_trainers_snapshot_of_dot_and_host_tables(flags,
                                                               tmp_path):
    """The app builds the graph the JAX app builds from the same flags:
    the unfused "dot" (``build_dlrm``), host-resident tables under
    ``--host-tables``; a JAX trainer's snapshot of that graph restores at
    start (same fingerprint), and /predict answers the JAX model's
    forward within rtol 1e-5, atol 1e-6 (the MLPs' sums run in another
    order)."""
    import dlrm_flexflow_tpu as ff
    from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                               build_dlrm as jax_build_dlrm)
    from dlrm_flexflow_tpu.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu.utils.checkpoint import \
        CheckpointManager as JaxManager
    dot = "dot" in flags
    arch = dict(SMALL, mlp_top=[8 + 36 if dot else 72, 16, 1],
                arch_interaction_op="dot" if dot else "cat")
    jm = ff.FFModel(ff.FFConfig(batch_size=BS, seed=5,
                                host_resident_tables="--host-tables" in flags,
                                host_tables_async=False))
    jax_build_dlrm(jm, JaxDLRMConfig(**arch))
    jm.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
               mesh=make_mesh(devices=jax.devices()[:1]))
    jm.init_layers()
    x, y = _data()
    for i in range(2):
        b = {k: v[i * BS:(i + 1) * BS] for k, v in x.items()}
        b["label"] = y[i * BS:(i + 1) * BS]
        jm.train_batch(b)
    JaxManager(str(tmp_path)).save(jm, {"epoch": 0, "batch": 2})
    argv = list(BASE)
    argv[argv.index("72-16-1")] = "-".join(map(str, arch["mlp_top"]))
    srv = _Running(argv + flags + ["--checkpoint-dir", str(tmp_path)])
    try:
        model = srv.app.engine.model
        assert bool(model._host_resident_list) == ("--host-tables" in flags)
        if dot:
            model.get_layer_by_name("interaction_bmm")
        q, body = _request(n=5)
        out = json.loads(srv.post("/predict", body)[1])
        assert out["version"] == 2
        np.testing.assert_allclose(
            np.asarray(out["scores"], np.float32),
            np.asarray(jm.forward_batch(q)).reshape(-1),
            rtol=1e-5, atol=1e-6)
    finally:
        srv.close()
