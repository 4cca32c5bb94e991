"""The port's SLO autoscaler (``serve/autoscale.py``) and the fleet's
elastic verbs on the CPU, against the JAX package's autoscaler.

- The policy is driven from injected ``stats()``, never from wall-clock
  load: a stub router and fleet script the p99, the queue depths and the
  healthy count tick by tick, the port's and the JAX package's
  autoscalers run the same script, and their decisions (action, reason,
  detail) are EQUAL.
- The verbs on a real fleet of port engines (the small "cat" DLRM of
  tests/test_torch_delta.py): ``grow`` builds from the factory and the
  grown replica is born PROBING until the router's probe admits it;
  ``shrink`` retires the highest stable replica and never the last; a
  replica killed by ``FF_FAULT_REPLICA_DOWN`` is replaced with zero
  failed requests; a forced SLO breach grows 1 -> 2 and idleness shrinks
  2 -> 1.

Every wait is bounded; the policy thread is not started where a test
drives the ticks itself.
"""

import time

import numpy as np
import pytest

from dlrm_flexflow_tpu.serve import autoscale as jax_autoscale

from dlrm_flexflow_tpu_torch.config import FFConfig
from dlrm_flexflow_tpu_torch.serve import autoscale as port_autoscale
from dlrm_flexflow_tpu_torch.serve import (AutoscaleConfig, Autoscaler,
                                           Fleet, FleetRouter,
                                           InferenceEngine, RouterConfig,
                                           ServeConfig)
from dlrm_flexflow_tpu_torch.serve.fleet import HEALTHY, PROBING
from dlrm_flexflow_tpu_torch.utils import faults

from test_torch_delta import _jax_model, _port_model, _query

WAIT_S = 20.0


# ---------------------------------------------------------------------
# the policy, from injected stats, against the JAX autoscaler
# ---------------------------------------------------------------------
class _Rep:
    def __init__(self):
        self.queue_depth = 0


class _Fleet:
    """What the policy reads and calls: the size, the healthy replicas'
    queue depths, grow and shrink."""

    can_grow = True
    shard_set = None

    def __init__(self, n):
        self.reps = [_Rep() for _ in range(n)]
        self.dead = 0

    def __len__(self):
        return len(self.reps)

    def healthy(self):
        return self.reps[self.dead:]

    def grow(self, n):
        self.reps += [_Rep() for _ in range(n)]
        return list(range(len(self.reps) - n, len(self.reps)))

    def shrink(self, n=1):
        gone = list(range(len(self.reps) - n, len(self.reps)))
        del self.reps[-n:]
        return gone


class _Router:
    def __init__(self, fleet):
        self.fleet = fleet
        self.p99 = None

    def stats(self):
        return {"p99_ms": self.p99,
                "fleet": {"healthy": len(self.fleet.healthy())}}


# (p99 ms, queue depth per healthy replica, replicas dead) a tick
SCRIPT = ([(30.0, 0, 0)] * 2          # a sustained SLO breach: grow
          + [(5.0, 0, 0)] * 3         # idle: shrink
          + [(5.0, 0, 1)]             # the only replica dead: replace
          + [(5.0, 9, 0)] * 2         # queue pressure: grow
          + [(30.0, 9, 0)] * 4        # at max_replicas: nothing
          + [(None, 0, 0)] * 4)       # no traffic: idle, shrink


def _run_script(mod):
    fleet = _Fleet(1)
    router = _Router(fleet)
    cfg = mod.AutoscaleConfig(slo_ms=20.0, min_replicas=1, max_replicas=3,
                              sustain=2, idle_sustain=3, queue_hwm=4.0,
                              cooldown_s=0.0)
    scaler = mod.Autoscaler(router, cfg)
    sizes = []
    for p99, depth, dead in SCRIPT:
        router.p99, fleet.dead = p99, dead
        for r in fleet.reps:
            r.queue_depth = depth
        scaler._tick()
        sizes.append(len(fleet))
    st = scaler.stats()
    return sizes, [(d["action"], d["reason"], d["detail"])
                   for d in st["decisions"]], st


def test_decisions_equal_the_jax_autoscaler():
    sizes, mine, st = _run_script(port_autoscale)
    jsizes, theirs, jst = _run_script(jax_autoscale)
    assert mine == theirs and sizes == jsizes
    assert sizes == [1, 2, 2, 2, 1, 2, 2, 3, 3, 3, 3, 3, 3, 3, 2, 2]
    assert [a for a, _r, _d in mine] == ["grow", "shrink", "replace",
                                        "grow", "shrink"]
    assert "p99 30.0 ms > SLO 20 ms" in mine[0][1]
    assert "queue depth 9.0/replica" in mine[3][1]
    for k in ("grows", "shrinks", "replacements", "breaches", "last_reason",
              "size", "healthy"):
        assert st[k] == jst[k], k


def test_config_bounds_and_flags_as_jax():
    for mod in (jax_autoscale, port_autoscale):
        with pytest.raises(ValueError, match="min_replicas must be >= 1"):
            mod.AutoscaleConfig(min_replicas=0)
        with pytest.raises(ValueError, match="max_replicas 1 < "):
            mod.AutoscaleConfig(min_replicas=2, max_replicas=1)
    cfg = FFConfig.parse_args(["--device", "cpu", "--serve-slo-ms", "25",
                               "--serve-min-replicas", "2",
                               "--serve-max-replicas", "5"])
    a = AutoscaleConfig.from_config(cfg)
    assert (a.slo_ms, a.min_replicas, a.max_replicas) == (25.0, 2, 5)
    for flag in ("--serve-min-replicas", "--serve-max-replicas"):
        with pytest.raises(ValueError, match=f"{flag} expects N >= 1"):
            FFConfig.parse_args(["--device", "cpu", flag, "0"])


# ---------------------------------------------------------------------
# the verbs on a real fleet
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def jm():
    return _jax_model()


def _router(jm, n, **kw):
    cfg = dict(retries=3, backoff_ms=1.0, eject_after=2, cooldown_s=0.05,
               probe_deadline_s=10.0, health_interval_s=0.02)
    cfg.update(kw)
    fleet = Fleet.build(lambda i: _port_model(jm), n,
                        ServeConfig(max_batch=8, queue_capacity=512))
    return FleetRouter(fleet, RouterConfig(**cfg))


def _one(i=0):
    i %= 8
    return {k: v[i:i + 1] for k, v in _query(8).items()}


def _wait(cond, what):
    end = time.monotonic() + WAIT_S
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def test_grow_is_probed_before_admission_and_shrink_keeps_one(jm):
    with _router(jm, 1) as router:
        fleet = router.fleet
        router.predict(_one(), timeout=WAIT_S)   # the probe's template
        assert fleet.grow(1) == [1]
        rep = fleet.get(1)
        assert rep.engine.alive() and rep.engine.replica_id == 1
        assert rep.state in (PROBING, HEALTHY)
        _wait(lambda: rep.state == HEALTHY, "the grown replica's probe")
        assert rep.probes == 1 and rep.readmissions == 1
        np.testing.assert_array_equal(
            rep.engine.predict(_one(3), timeout=WAIT_S).scores,
            fleet.get(0).engine.predict(_one(3), timeout=WAIT_S).scores)
        assert fleet.shrink(1) == [1] and len(fleet) == 1
        assert fleet.shrink(3) == [] and not rep.engine.alive()
        assert (fleet.grows, fleet.shrinks) == (1, 1)
    with pytest.raises(RuntimeError, match="no recipe"):
        Fleet([InferenceEngine(_port_model(jm))]).grow(1)


def test_a_forced_breach_grows_and_idleness_shrinks(jm, monkeypatch):
    with _router(jm, 1) as router:
        scaler = Autoscaler(router, AutoscaleConfig(
            slo_ms=20.0, min_replicas=1, max_replicas=2, sustain=2,
            idle_sustain=2, cooldown_s=0.0))
        for i in range(4):
            router.predict(_one(i), timeout=WAIT_S)
        real = router.stats
        # the breach is forced through the stats the policy reads
        monkeypatch.setattr(router, "stats",
                            lambda: dict(real(), p99_ms=1e3))
        scaler._tick()
        scaler._tick()
        assert len(router.fleet) == 2 and scaler.stats()["grows"] == 1
        _wait(lambda: len(router.fleet.healthy()) == 2, "the admission")
        monkeypatch.setattr(router, "stats",
                            lambda: dict(real(), p99_ms=1.0))
        scaler._tick()
        scaler._tick()
        st = scaler.stats()
        assert len(router.fleet) == 1 and st["shrinks"] == 1
        assert [d["action"] for d in st["decisions"]] == ["grow", "shrink"]
        assert router.stats()["failed"] == 0


def test_a_dead_replica_is_replaced_with_zero_failures(jm):
    with faults.active_plan(faults.FaultPlan(replica_down={1: -1})), \
            _router(jm, 2) as router:
        scaler = Autoscaler(router, AutoscaleConfig(min_replicas=2,
                                                    max_replicas=3,
                                                    cooldown_s=0.0))
        for i in range(6):
            router.predict(_one(i), timeout=WAIT_S)
        assert router.fleet.get(1).state != HEALTHY
        scaler._tick()
        st = scaler.stats()
        assert st["replacements"] == 1 and len(router.fleet) == 3
        assert "healthy 1 < min 2" in st["last_reason"]
        _wait(lambda: router.fleet.get(2).state == HEALTHY,
              "the replacement's admission")
        for i in range(6):
            router.predict(_one(i), timeout=WAIT_S)
        assert router.stats()["failed"] == 0


def test_the_policy_thread_starts_and_joins(jm):
    with _router(jm, 1) as router:
        scaler = Autoscaler(router, AutoscaleConfig(interval_s=0.01))
        scaler.start()
        t = scaler._thread
        assert t.name == "ff-autoscaler" and t.daemon
        scaler.close()
        assert not t.is_alive() and scaler._thread is None
