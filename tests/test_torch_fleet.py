"""The port's serving fleet (``serve/fleet.py``) and router
(``serve/router.py``) on the CPU, against the JAX package's engine.

The small "cat" DLRM of tests/test_torch_delta.py (8 tables x 64 rows,
batch 16), every replica its own port model carrying one JAX model's
parameters. Tolerances, and why:

- an answer through the router is BITWISE the answer of one engine to
  the same request alone (each replica runs the same kernels on the same
  shapes, one request a batch here); against the JAX engine, rtol 1e-5,
  atol 1e-6 (XLA sums the MLPs' products in another fp32 order);
- balancing, retry, eject and re-admit (``FF_FAULT_REPLICA_DOWN``), the
  hedge, the canary's rollback and promotion and shadow traffic are
  checked on counts and states, never on wall-clock times.

Steadiness: a slow or wedged replica is made so by an ``Event`` its
batcher waits on (``run_quiesced``), never by a sleep; every wait is
bounded; requests that must land on a given replica are sent one at a
time, so the router's choice (shallowest queue, then its round-robin
counter) is determined.
"""

import glob
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from dlrm_flexflow_tpu.serve.engine import InferenceEngine as JaxEngine
from dlrm_flexflow_tpu.serve.engine import ServeConfig as JaxServeConfig

from dlrm_flexflow_tpu_torch.serve import (Fleet, FleetRouter,
                                           FleetUnavailable,
                                           InferenceEngine, Replica,
                                           ReplicaDown, RouterConfig,
                                           ServeConfig, percentile)
from dlrm_flexflow_tpu_torch.serve.fleet import EJECTED, HEALTHY, PROBING
from dlrm_flexflow_tpu_torch.utils import faults
from dlrm_flexflow_tpu_torch.utils.checkpoint import CheckpointManager

from test_torch_delta import _data, _jax_model, _port_model, _query

WAIT_S = 20.0


@pytest.fixture(scope="module")
def jm():
    return _jax_model()


def _router(jm, n=2, **kw):
    cfg = dict(retries=3, backoff_ms=1.0, eject_after=2, cooldown_s=0.05,
               probe_deadline_s=10.0, health_interval_s=0.02)
    cfg.update(kw)
    fleet = Fleet.build(lambda i: _port_model(jm),
                        n, ServeConfig(max_batch=8, queue_capacity=512))
    return FleetRouter(fleet, RouterConfig(**cfg))


def _one(i=0):
    """Row ``i % 8`` of the query batch, as a one-row request."""
    i %= 8
    return {k: v[i:i + 1] for k, v in _query(8).items()}


def _wait(cond, what):
    end = time.monotonic() + WAIT_S
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


class _Gate:
    """Wedge one engine's batcher on an Event (a parked ``run_quiesced``
    call), until ``open``."""

    def __init__(self, engine):
        self.entered = threading.Event()
        self.release = threading.Event()
        self._t = threading.Thread(target=engine.run_quiesced, args=(
            lambda: self.entered.set() or self.release.wait(WAIT_S),))
        self._t.start()
        assert self.entered.wait(WAIT_S)

    def open(self):
        self.release.set()
        self._t.join(WAIT_S)


def _snapshot(jm, tmp_path, steps=1):
    """One SGD step of a replica's model, saved; returns the path."""
    trainer = _port_model(jm)
    x, y = _data(16)
    trainer.train_batch({**x, "label": y})
    CheckpointManager(str(tmp_path), keep_last=2).save(trainer, {})
    (path,) = glob.glob(str(tmp_path / "ckpt-*.npz"))
    return path


# ---------------------------------------------------------------------
# the fleet and the breaker
# ---------------------------------------------------------------------
class TestFleet:
    def test_rejects_empty_and_duplicate_rids(self, jm):
        with pytest.raises(ValueError, match="at least one"):
            Fleet([])
        a = InferenceEngine(_port_model(jm), replica_id=4)
        b = InferenceEngine(_port_model(jm), replica_id=4)
        with pytest.raises(ValueError, match="duplicate"):
            Fleet([a, b])
        c = InferenceEngine(_port_model(jm))
        assert [r.rid for r in Fleet([c])] == [0] and c.replica_id == 0

    def test_breaker_transitions_and_drain(self, jm):
        eng = InferenceEngine(_port_model(jm), ServeConfig(max_batch=8),
                              replica_id=0).start()
        rep = Replica(eng, 0)
        gate = _Gate(eng)
        try:
            futs = [eng.submit(_one(i)) for i in range(3)]
            assert rep.queue_depth == 3
            assert rep.record_error(RuntimeError("x"), 2) is False
            assert rep.record_error(RuntimeError("y"), 2) is True
            assert rep.eject("test") == 3 and rep.state == EJECTED
            for f in futs:
                with pytest.raises(ReplicaDown, match="ejected: test"):
                    f.result(WAIT_S)
            assert rep.due_for_probe(0.0)
            rep.begin_probe()
            rep.probe_failed("still down")
            assert rep.state == EJECTED and "probe failed" in rep.last_error
            rep.begin_probe()
            rep.readmit()
            st = rep.stats()
            assert (st["state"], st["ejections"], st["readmissions"],
                    st["probes"]) == (HEALTHY, 1, 1, 2)
        finally:
            gate.open()
            eng.close()

    def test_stats_merge_latency_windows(self, jm):
        router = _router(jm)
        with router:
            for i in range(6):
                router.predict(_one(i), timeout=WAIT_S)
            st = router.fleet.stats()
        lat = sorted(s for r in router.fleet
                     for s in r.engine._lat_ms.samples())
        assert st["p99_ms"] == percentile(lat, 99) and len(lat) == 6
        assert st["totals"]["requests"] == 6 and st["size"] == 2


# ---------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------
class TestRouter:
    def test_bitwise_answers_and_balancing(self, jm):
        x = _query(8)
        alone = InferenceEngine(_port_model(jm), ServeConfig(max_batch=8))
        jeng = JaxEngine(jm, JaxServeConfig(max_batch=8))
        with alone, jeng, _router(jm) as router:
            for i in range(8):
                q = {k: v[i:i + 1] for k, v in x.items()}
                got = router.predict(q, timeout=WAIT_S)
                want = alone.predict(q, timeout=WAIT_S)
                np.testing.assert_array_equal(got.scores, want.scores)
                np.testing.assert_allclose(
                    got.scores, np.asarray(jeng.predict(q).scores),
                    rtol=1e-5, atol=1e-6)
            st = router.stats()
            per = [r.engine.stats()["requests"] for r in router.fleet]
        # one request at a time: equal queues, and the JAX router's
        # tie-break, (rid + n) % 3 for the n-th pick, sends picks 1, 3,
        # 4, 6 and 7 to replica 0
        assert per == [5, 3] and st["failed"] == 0 and st["retries"] == 0
        assert st["responses"] == 8 and st["p99_ms"] is not None

    def test_a_wedged_replica_repels_traffic(self, jm):
        with _router(jm) as router:
            r0 = router.fleet.get(0).engine
            gate = _Gate(r0)
            try:
                stuck = r0.submit(_one())        # replica 0's queue: 1
                for i in range(6):
                    router.predict(_one(i), timeout=WAIT_S)
                per = [r.engine.stats()["requests"] for r in router.fleet]
            finally:
                gate.open()
            assert stuck.result(WAIT_S).scores.shape == (1, 1)
        assert per == [1, 6]

    def test_replica_down_zero_failures_then_readmit(self, jm, monkeypatch):
        monkeypatch.setenv("FF_FAULT_REPLICA_DOWN", "0:4")
        plan = faults.plan_from_env()
        assert plan.replica_down == {0: 4}
        with faults.active_plan(plan), _router(jm) as router:
            want = InferenceEngine(_port_model(jm)).start()
            try:
                for i in range(12):
                    np.testing.assert_array_equal(
                        router.predict(_one(i), timeout=WAIT_S).scores,
                        want.predict(_one(i), timeout=WAIT_S).scores)
            finally:
                want.close()
            rep = router.fleet.get(0)
            assert rep.ejections >= 1
            _wait(lambda: rep.state == HEALTHY and rep.readmissions >= 1,
                  "replica 0's re-admission")
            st = router.stats()
        assert st["failed"] == 0 and st["retries"] >= 2
        assert ("replica_down", 0) in plan.fired

    def test_a_cancelled_dispatch_is_retried_elsewhere(self, jm):
        """A dispatch whose future the replica cancels (a remote
        replica's client cancels its queued requests when the replica is
        ejected) is re-routed as a failed one: a survivor answers it."""
        with _router(jm) as router:
            def cancelled(features):
                f = Future()
                f.cancel()
                return f

            router.fleet.get(0).engine.submit = cancelled
            want = InferenceEngine(_port_model(jm)).start()
            try:
                for i in range(4):
                    np.testing.assert_array_equal(
                        router.predict(_one(i), timeout=WAIT_S).scores,
                        want.predict(_one(i), timeout=WAIT_S).scores)
            finally:
                want.close()
            st = router.stats()
            errors = router.fleet.get(0).dispatch_errors
        assert st["failed"] == 0 and st["retries"] >= 1 and errors >= 1

    def test_every_replica_down_fails_after_the_budget(self, jm):
        plan = faults.FaultPlan(replica_down={0: -1, 1: -1})
        with faults.active_plan(plan), _router(jm, retries=2) as router:
            with pytest.raises((FleetUnavailable, ReplicaDown)):
                router.predict(_one(), timeout=WAIT_S)
            # three attempts alternate 0, 1, 0: replica 0 is ejected
            assert router.stats()["failed"] == 1
            assert router.fleet.get(0).state == EJECTED

    def test_malformed_request_fails_without_retry(self, jm):
        with _router(jm) as router:
            with pytest.raises(ValueError, match="missing inputs"):
                router.predict({"dense": _one()["dense"]}, timeout=WAIT_S)
            assert router.stats()["retries"] == 0

    def test_the_hedge_answers_a_wedged_dispatch(self, jm):
        with _router(jm, hedge_ms=20.0) as router:
            r0 = router.fleet.get(0).engine
            gate = _Gate(r0)
            try:
                # one at a time: the round-robin sends one of the first
                # two to replica 0, where it waits on the gate until the
                # hedge on replica 1 answers it
                for i in range(2):
                    router.predict(_one(i), timeout=WAIT_S)
                st = router.stats()
            finally:
                gate.open()
        assert st["hedges"] >= 1 and st["hedge_wins"] == 1
        assert st["failed"] == 0

    def test_a_stale_heartbeat_ejects_the_replica(self, jm):
        with _router(jm, heartbeat_deadline_s=0.2) as router:
            rep = router.fleet.get(1)
            gate = _Gate(rep.engine)
            try:
                _wait(lambda: rep.state == EJECTED, "the ejection")
                assert "stale heartbeat" in rep.last_error
                for i in range(3):
                    router.predict(_one(i), timeout=WAIT_S)
            finally:
                gate.open()
            _wait(lambda: rep.state == HEALTHY, "the re-admission")
            hz = router.healthz()
        assert hz["ok"] and hz["healthy"] == 2


# ---------------------------------------------------------------------
# canary and shadow
# ---------------------------------------------------------------------
class TestCanaryShadow:
    def test_poisoned_canary_rolls_back_then_a_good_one_is_promoted(
            self, jm, tmp_path):
        snap = _snapshot(jm, tmp_path)
        with _router(jm, canary_fraction=0.5, canary_min_samples=8,
                     canary_score_tol=0.1, canary_p99_ratio=1e9) as router:
            fleet = router.fleet
            before = fleet.get(1).engine.predict(_one(), timeout=WAIT_S)
            with faults.active_plan(faults.FaultPlan(poison_reloads=1)):
                ids = router.start_canary(snap)
            assert ids == [1] and fleet.get(1).cohort == "canary"
            end = time.monotonic() + WAIT_S
            i = 0
            while router.stats()["canary"]["active"] \
                    and time.monotonic() < end:
                router.predict(_one(i % 8), timeout=WAIT_S)
                i += 1
            st = router.stats()
            assert st["canary"]["rollbacks"] == 1 and st["failed"] == 0
            assert "score divergence" in st["canary"]["last_rollback_reason"]
            assert fleet.get(1).cohort == "stable"
            np.testing.assert_array_equal(
                fleet.get(1).engine.predict(_one(), timeout=WAIT_S).scores,
                before.scores)
            # a good snapshot: promoted on every replica
            router.start_canary(snap)
            want = fleet.get(1).engine.predict(_one(), timeout=WAIT_S)
            router.promote_canary()
            st = router.stats()["canary"]
            assert st["promotions"] == 1 and not st["active"]
            for rep in fleet:
                assert rep.cohort == "stable" and rep.engine.version == 1
                np.testing.assert_array_equal(
                    rep.engine.predict(_one(), timeout=WAIT_S).scores,
                    want.scores)
            assert not np.array_equal(want.scores, before.scores)

    def test_canary_pacing_and_guard_rails(self, jm, tmp_path):
        snap = _snapshot(jm, tmp_path)
        with _router(jm, canary_fraction=0.25) as router:
            router.fleet.get(1).eject("test")
            with pytest.raises(RuntimeError, match=">= 2 healthy"):
                router.start_canary(snap)
            router.fleet.get(1).readmit()
            router.start_canary(snap)
            cohorts = [router._choose_cohort() for _ in range(40)]
            assert cohorts.count("canary") == 10
            with pytest.raises(RuntimeError, match="already active"):
                router.start_canary(snap)
            router.rollback_canary("manual")
            assert router.stats()["canary"]["active"] is False

    def test_shadow_never_reaches_a_client(self, jm, tmp_path):
        snap = _snapshot(jm, tmp_path)
        with _router(jm, n=3) as router:
            fleet = router.fleet
            want = [fleet.get(0).engine.predict(_one(i), timeout=WAIT_S)
                    for i in range(8)]
            rid = router.start_shadow(snap)
            assert fleet.get(rid).cohort == "shadow" and rid == 2
            for i in range(16):
                np.testing.assert_array_equal(
                    router.predict(_one(i % 8), timeout=WAIT_S).scores,
                    want[i % 8].scores)
            _wait(lambda: router.shadow_report()["n"] >= 16,
                  "the shadow's comparisons")
            assert router.shadow_report()["mean_abs_diff"] > 0
            # a dead shadow: the clients never notice
            with faults.active_plan(faults.FaultPlan(
                    replica_down={rid: -1})):
                for i in range(4):
                    np.testing.assert_array_equal(
                        router.predict(_one(i), timeout=WAIT_S).scores,
                        want[i].scores)
            report = router.stop_shadow()
            assert report["n"] >= 16 and fleet.get(rid).cohort == "stable"
            np.testing.assert_array_equal(
                fleet.get(rid).engine.predict(_one(), timeout=WAIT_S)
                .scores, want[0].scores)
            assert router.stats()["failed"] == 0


# ---------------------------------------------------------------------
# a fleet over ranker processes' wire servers
# ---------------------------------------------------------------------
def test_connect_routes_over_the_wire_and_refuses_deploys(jm, tmp_path):
    engines = [InferenceEngine(_port_model(jm), ServeConfig(max_batch=8),
                               replica_id=i).start() for i in range(2)]
    servers = [e.serve() for e in engines]
    router = FleetRouter(Fleet.connect([s.address for s in servers]),
                         RouterConfig(retries=2, backoff_ms=1.0))
    try:
        with router:
            for i in range(4):
                np.testing.assert_array_equal(
                    router.predict(_one(i), timeout=WAIT_S).scores,
                    engines[0].predict(_one(i), timeout=WAIT_S).scores)
            st = router.stats()
            assert st["fleet"]["size"] == 2 and st["failed"] == 0
            assert st["fleet"]["totals"]["requests"] == 8
            with pytest.raises(RuntimeError, match="inproc-only"):
                router.start_canary(_snapshot(jm, tmp_path))
            # a replica process gone: its requests re-route
            servers[1].close()
            for i in range(4):
                router.predict(_one(i), timeout=WAIT_S)
            assert router.stats()["failed"] == 0
    finally:
        for s in servers:
            s.close()
        for e in engines:
            e.close()
    assert PROBING  # the state names are the JAX package's


def test_the_app_serves_a_fleet_behind_the_cascade():
    """The app with ``--serve-replicas 2 --retrieve on`` (the cascade in
    front of the fleet, as the JAX app allows) and ``--serve-slo-ms``
    (the autoscaler over it): candidates answered through the router,
    the fleet and the cascade in /stats."""
    import json

    from test_torch_serve_app import BASE, _Running, _request
    srv = _Running(BASE + ["--serve-max-batch", "16", "--serve-replicas",
                           "2", "--serve-slo-ms", "1000",
                           "--serve-max-replicas", "3", "--retrieve", "on",
                           "--retrieve-k", "5", "--retrieve-shards", "2",
                           "--retrieve-deadline-ms", "10000"])
    try:
        assert srv.app.scaler is not None
        assert srv.app.cascade.ranker is srv.app.router
        _x, body = _request(2)
        code, text = srv.post("/predict", body)
        out = json.loads(text)
        assert code == 200 and np.asarray(out["candidates"]).shape == (2, 5)
        assert out["degraded"] is False
        st = json.loads(srv.get("/stats")[1])
        assert st["fleet"]["size"] == 2 and st["failed"] == 0
        assert st["cascade"]["requests"] == 1
        assert json.loads(srv.get("/healthz")[1])["healthy"] == 2
    finally:
        srv.close()
