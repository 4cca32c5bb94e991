"""The port's observability layer (``obs/``) against the JAX package's, on
the CPU.

- The registry: the same instruments driven the same way in both
  packages give the same Prometheus text, character for character; off
  is a shared no-op (type identity); the reservoir is bounded and its
  empty percentile None; ``serve.engine.percentile`` is
  ``obs.metrics.percentile``.
- The engine's and the watcher's scrape series carry the JAX engine's
  and watcher's names and labels; ``/metrics`` of the app exposes them
  (tests/test_torch_serve_app.py).
- Tracing: spans nest per thread and export as Chrome-trace JSON; the
  serving and freshness spans (``serve/...``, ``publish/...``) land.
- The drift monitor: quiet at calibration, one warning per breach
  episode, the JAX report's keys; ``fit`` and ``fit_stream`` with
  ``--obs on`` report it and export the trace.
Exact comparisons throughout (strings, counts, keys).
"""

import json
import threading

import numpy as np
import pytest

from dlrm_flexflow_tpu.obs import metrics as jax_metrics
from dlrm_flexflow_tpu.obs import trace as jax_trace
from dlrm_flexflow_tpu.obs.drift import DriftMonitor as JaxDrift
from dlrm_flexflow_tpu.serve import ServeConfig as JaxServeConfig
from dlrm_flexflow_tpu.serve.engine import InferenceEngine as JaxEngine
from dlrm_flexflow_tpu.serve.watcher import SnapshotWatcher as JaxWatcher

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch import obs
from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
from dlrm_flexflow_tpu_torch.obs import metrics, trace
from dlrm_flexflow_tpu_torch.obs.drift import DriftMonitor
from dlrm_flexflow_tpu_torch.serve import (InferenceEngine, ServeConfig,
                                           SnapshotWatcher)
from dlrm_flexflow_tpu_torch.serve import engine as engine_mod
from dlrm_flexflow_tpu_torch.utils import delta

from test_torch_delta import (BS, MIN_ELEMS, NO_SIZE_COMPACTION, _data,
                              _jax_model, _port_model, _query)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """obs state is process-wide: every test starts and ends with it
    off, an empty registry and an empty ring, in both packages."""
    for mod in (metrics, trace, jax_metrics, jax_trace):
        monkeypatch.setattr(mod, "_ENABLED", False)
    monkeypatch.setattr(trace, "_TRACE_DIR", "")
    for reg, ring in ((metrics, trace), (jax_metrics, jax_trace)):
        reg.registry().reset()
        ring.clear()
    yield
    for reg, ring in ((metrics, trace), (jax_metrics, jax_trace)):
        reg.registry().reset()
        ring.clear()


def _drive(m):
    """The same instruments and collector through one package."""
    c = m.counter("ff_req_total", "requests served",
                  labelnames=("replica",))
    c.inc(3, replica="0")
    c.labels(replica='a"b\n').inc()
    m.gauge("ff_depth", "queue depth").set(2.5)
    h = m.histogram("ff_lat_ms", "latency", labelnames=("loop",),
                    reservoir=8)
    for v in (1.0, 3.0, 7.0, 2.0):
        h.observe(v, loop="x")
    r = m.latency_reservoir("ff_win_ms", "window", maxlen=4, replica="")
    r.extend([5.0, 1.0, 9.0, 2.0, 8.0])
    m.register_collector(lambda: [("ff_coll", {"a": "b"}, 7.0)])
    m.register_collector(lambda: 1 / 0)     # a dying collector
    return m.registry().prometheus_text()


def test_registry_exposition_matches_jax():
    with metrics.override(True), jax_metrics.override(True):
        got, want = _drive(metrics), _drive(jax_metrics)
    assert got == want and "ff_coll" in got and "ff_win_ms_count" in got


def test_off_is_a_shared_noop_and_windows_are_bounded():
    assert metrics.counter("x") is metrics.NULL_COUNTER
    assert metrics.gauge("x") is metrics.NULL_GAUGE
    assert metrics.histogram("x") is metrics.NULL_HISTOGRAM
    assert trace.span("x") is trace.NULL_SPAN
    r = metrics.latency_reservoir("ff_x_ms", maxlen=3)
    assert type(r) is metrics.Reservoir and r.percentile(99) is None
    r.extend(range(10))
    assert len(r) == 3 and r.count == 10
    assert sorted(r.samples()) == [7.0, 8.0, 9.0]
    assert engine_mod.percentile is metrics.percentile
    for vals in ([], [3.0], [1.0, 2.0, 4.0, 8.0]):
        for p in (50, 90, 99):
            assert metrics.percentile(vals, p) == jax_metrics.percentile(
                vals, p)
    with pytest.raises(ValueError):
        with metrics.override(True):
            metrics.counter("ff_a", labelnames=("x",)).inc(y="1")
    with metrics.override(True):
        metrics.counter("ff_b")
        with pytest.raises(ValueError, match="already registered"):
            metrics.gauge("ff_b")
        with pytest.raises(ValueError, match="invalid metric name"):
            metrics.counter("bad name")


def test_configure_follows_the_flags(tmp_path):
    assert not obs.configure(pt.FFConfig(device="cpu"))
    cfg = pt.FFConfig.parse_args(["--device", "cpu", "--obs", "on",
                                  "--obs-trace-dir", str(tmp_path),
                                  "--obs-drift-threshold", "2.5"])
    assert (cfg.obs, cfg.obs_trace_dir, cfg.obs_drift_threshold) == (
        "on", str(tmp_path), 2.5)
    assert obs.configure(cfg) and metrics.enabled() and trace.enabled()
    assert trace.trace_dir() == str(tmp_path)
    assert obs.configure(pt.FFConfig(device="cpu"))   # never turns off
    with pytest.raises(ValueError):
        pt.FFConfig.parse_args(["--device", "cpu", "--obs", "maybe"])
    with pytest.raises(ValueError):
        pt.FFConfig.parse_args(["--device", "cpu",
                                "--obs-drift-threshold", "0"])


def test_spans_nest_per_thread_and_export(tmp_path):
    with trace.override(True, trace_dir=str(tmp_path)):
        with trace.span("outer", k=1):
            with trace.span("inner"):
                pass
            trace.instant("mark", why="x")

        def work():
            with trace.span("other"):
                pass

        th = threading.Thread(target=work, name="ff-test-worker")
        th.start()
        th.join()
        with pytest.raises(KeyError):
            with trace.span("fails"):
                raise KeyError("x")
        path = trace.export_to_dir()
    evs = {e["name"]: e for e in trace.events()}
    outer, inner = evs["outer"], evs["inner"]
    assert outer["ts"] <= inner["ts"] and (
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])
    assert evs["other"]["tid"] != outer["tid"]
    assert evs["fails"]["args"]["error"] == "KeyError"
    data = json.loads(open(path).read())
    lanes = {e["args"]["name"] for e in data["traceEvents"]
             if e["ph"] == "M"}
    assert "ff-test-worker" in lanes
    assert set(data) == set(jax_trace.chrome_trace())


def test_drift_monitor_calibrates_and_fires_once_per_episode():
    with metrics.override(True), trace.override(True):
        mon = DriftMonitor(calibrate_steps=4, sustain=2, threshold=1.5,
                           name="t")
        for _ in range(6):
            mon.observe_step(0.001)
        assert mon.report()["baseline_source"] == "calibration"
        assert mon.fired == 0 and mon.audit_collectives() == {}
        for _ in range(5):
            mon.observe_step(0.01)
        for _ in range(3):
            mon.observe_step(0.001)
        for _ in range(3):
            mon.observe_step(0.01)
        c = metrics.registry().counter("ff_drift_warnings_total",
                                       labelnames=("kind", "loop"))
        assert mon.fired == 2 and c.value(kind="step-time", loop="t") == 2
        assert sum(e["name"] == "drift/step-time"
                   for e in trace.events()) == 2
    assert set(mon.report()) == set(JaxDrift(name="t").report())


def test_engine_and_watcher_series_match_jax(tmp_path):
    """The port's engine and watcher, and the JAX ones over a JAX model
    of the same graph, scraped after the same work: the same series
    names and labels."""
    pm = _port_model()
    pub = delta.DeltaPublisher(pm, str(tmp_path),
                               row_delta_min_elems=MIN_ELEMS)
    x, y = _data()
    pm.fit_stream(ArrayStream(x, y, BS, seed=1), steps=4, publisher=pub,
                  publish_every=2, verbose=False)
    q = _query()

    def scrape(reg, engine, watcher_cls, predict_n=2):
        with engine:
            watcher_cls(engine, str(tmp_path)).start().stop()
            w = watcher_cls(engine, str(tmp_path)).start()
            for _ in range(predict_n):
                engine.predict(q, timeout=60)
            text = reg.registry().prometheus_text()
            w.stop()
        return {(line.split("{")[0].split(" ")[0], line.split("{")[1]
                 .split("}")[0] if "{" in line else "")
                for line in text.splitlines()
                if line.startswith("ff_")}

    with metrics.override(True), trace.override(True):
        got = scrape(metrics, InferenceEngine(
            _port_model(seed=5), ServeConfig(max_batch=8)),
            SnapshotWatcher)
        names = {e["name"] for e in trace.events()}
    with jax_metrics.override(True), jax_trace.override(True):
        want = scrape(jax_metrics, JaxEngine(
            _jax_model(seed=5), JaxServeConfig(max_batch=8)),
            JaxWatcher)
    serve_keys = {k for k in want if k[0].startswith(("ff_serve_",
                                                      "ff_watcher_"))}
    assert serve_keys and serve_keys <= got
    assert {"ff_serve_reloads_total", "ff_serve_delta_reloads_total",
            "ff_serve_reload_rejects_total", "ff_serve_version",
            "ff_watcher_polls_total"} <= {k[0] for k in got}
    assert {"serve/enqueue", "serve/batch-form", "serve/dispatch",
            "serve/swap", "publish/watcher-apply"} <= names


def test_prefetch_ring_series_match_jax():
    """The ring's scrape series and its staging span, as the JAX ring's."""
    from dlrm_flexflow_tpu.data.prefetch import PrefetchPipeline as JaxRing
    from dlrm_flexflow_tpu_torch.data.prefetch import PrefetchPipeline

    def scrape(reg, ring_cls, ring_trace):
        with reg.override(True), ring_trace.override(True):
            ring = ring_cls(lambda i: i * i, depth=2, num_items=5,
                            name="t")
            got = [ring.get() for _ in range(5)]
            rows = {(n, tuple(sorted(lab.items())))
                    for n, lab, _ in ring._obs_collect()}
            text = reg.registry().prometheus_text()
            ring.close()
            spans = {e["name"] for e in ring_trace.events()}
        assert got == [0, 1, 4, 9, 16]
        return rows, "ff_prefetch_items_total" in text, spans

    mine, theirs = scrape(metrics, PrefetchPipeline, trace), scrape(
        jax_metrics, JaxRing, jax_trace)
    assert mine[0] == theirs[0] and mine[1] and theirs[1]
    assert "prefetch/produce" in mine[2]
    assert "ff_prefetch_items_total" not in metrics.registry().collect()


def test_fit_and_fit_stream_report_drift_and_export(tmp_path):
    cfg = dict(obs="on", obs_trace_dir=str(tmp_path / "tr"))
    pm = _port_model(**cfg)
    x, y = _data()
    out = pm.fit(x, y, epochs=2, batch_size=BS, verbose=False)
    assert out["drift"]["loop"] == "fit" and out["drift"]["steps"] == 20
    pub = delta.DeltaPublisher(pm, str(tmp_path / "ck"),
                               compact_frac=NO_SIZE_COMPACTION,
                               row_delta_min_elems=MIN_ELEMS)
    out = pm.fit_stream(ArrayStream(x, y, BS, seed=1), steps=20,
                        publisher=pub, publish_every=4, verbose=False)
    d = out["drift"]
    assert d["loop"] == "fit_stream" and d["steps"] == 20
    assert d["baseline_source"] == "calibration"
    names = {e["name"] for e in trace.events()}
    assert {"publish/full", "publish/delta", "prefetch/produce",
            "train/step"} <= names
    text = metrics.registry().prometheus_text()
    assert 'ff_publishes_total{kind="delta"} 4' in text
    assert len(list((tmp_path / "tr").iterdir())) == 2
    assert np.isfinite(pm.perf.report()["mse"])
