"""The port's streaming side of the continual-learning loop against the
JAX package on the CPU: ``data/stream.py`` (``ArrayStream``),
``data/replay.py`` (``ReplaySpec``, ``scenario_spec``, ``TraceReplay``,
``FeedbackSpool``), the feedback-loss fault hook and
``FFModel.fit_stream``, mirroring tests/test_replay.py.

Tolerances, and why:

- Streams, traces, labels and the spool's batches: BITWISE (the same
  numpy draws from the same seeds), and the fault hook drops the same
  offers (the same seeded generator).
- ``fit_stream`` against a ``train_batch`` loop over the same batches,
  in the port: BITWISE (the same steps; the ring changes no value).
- ``fit_stream`` against the JAX ``fit_stream``: the loss within rtol
  1e-6 and every parameter's change within 1e-3 of its largest change,
  as tests/test_torch_sentinel.py holds SGD training (the MLP products
  sum in another fp32 order in XLA).
"""

import threading

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.data import replay as jax_replay
from dlrm_flexflow_tpu.data.stream import ArrayStream as JaxArrayStream
from dlrm_flexflow_tpu.parallel.mesh import make_mesh
from dlrm_flexflow_tpu.utils import faults as jax_faults

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.data import replay
from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, build_dlrm
from dlrm_flexflow_tpu_torch.utils import faults
from dlrm_flexflow_tpu_torch.utils.weights import (params_from_jax,
                                                   params_to_jax)

T, R, BAG, D = 4, 64, 2, 4


def _pair(name="drifting_zipf", steps=48, seed=0, batch=8):
    spec = dict(steps=steps, seed=seed, rows=R, batch=batch)
    return (replay.TraceReplay(T, R, BAG, D,
                               replay.scenario_spec(name, **spec)),
            jax_replay.TraceReplay(T, R, BAG, D,
                                   jax_replay.scenario_spec(name, **spec)))


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- ArrayStream ------------------------------------------------------------
@pytest.mark.parametrize("shuffle", [True, False])
def test_array_stream_matches_jax(shuffle):
    rng = np.random.RandomState(3)
    x = {"dense": rng.rand(50, 4).astype(np.float32),
         "sparse": rng.randint(0, 64, (50, 4, 2)).astype(np.int32)}
    y = rng.rand(50, 1).astype(np.float32)
    got = ArrayStream(x, y, 8, shuffle=shuffle, seed=5, max_steps=20)
    want = JaxArrayStream(x, y, 8, shuffle=shuffle, seed=5, max_steps=20)
    for i in list(range(20)) + [3, 13, 0]:      # re-reads are the same
        _assert_batches_equal(got(i), want(i))
    assert got(20) is None and want(20) is None
    with pytest.raises(ValueError, match="samples < batch size"):
        ArrayStream(x, y[:4], 8)


# ---- TraceReplay -------------------------------------------------------------
@pytest.mark.parametrize("name", ["diurnal", "flash_crowd", "drifting_zipf"])
def test_trace_replay_matches_jax(name):
    got, want = _pair(name, seed=4)
    for i in (0, 1, 11, 23, 24, 47):
        fg, fw = got.request(i), want.request(i)
        _assert_batches_equal(fg, fw)
        np.testing.assert_array_equal(got.labels(i), want.labels(i))
        np.testing.assert_array_equal(got.labels(i, fg), want.labels(i, fw))
        assert got.spec.qps_at(i) == want.spec.qps_at(i)
        assert got.spec.alpha_at(i) == want.spec.alpha_at(i)
        assert got.spec.in_flash(i) == want.spec.in_flash(i)
        assert got.spec.interarrival_s(i) == want.spec.interarrival_s(i)
    assert got.spec.churn_step() == want.spec.churn_step()
    assert fg["sparse"].shape == (8, T, BAG) and fg["dense"].shape == (8, D)


def test_trace_replay_behaves_as_jax_tests_it():
    """tests/test_replay.py's properties: deterministic per seed, the skew
    rises under drift, the hot set rotates at the churn, labels are a
    fixed function of the ids."""
    a, _ = _pair(seed=1)
    b, _ = _pair(seed=1)
    c, _ = _pair(seed=2)
    _assert_batches_equal(a.request(7), b.request(7))
    assert not np.array_equal(a.request(3)["sparse"], c.request(3)["sparse"])
    assert a.spec.alpha_at(47) > a.spec.alpha_at(0)
    churn = a.spec.churn_step()
    assert churn == 24
    before = np.bincount(a.request(churn - 1)["sparse"].ravel(), minlength=R)
    after = np.bincount(a.request(churn)["sparse"].ravel(), minlength=R)
    assert before.argmax() != after.argmax()


def test_scenario_names_and_spec_checks_match_jax():
    with pytest.raises(ValueError) as ep:
        replay.scenario_spec("nope")
    with pytest.raises(ValueError) as ej:
        jax_replay.scenario_spec("nope")
    assert str(ep.value) == str(ej.value)
    assert replay.SCENARIOS == jax_replay.SCENARIOS
    for kw in ({"steps": 0}, {"batch": 0}):
        with pytest.raises(ValueError) as ep:
            replay.ReplaySpec(**kw)
        with pytest.raises(ValueError) as ej:
            jax_replay.ReplaySpec(**kw)
        assert str(ep.value) == str(ej.value)


# ---- FeedbackSpool -----------------------------------------------------------
def test_spool_roundtrip_strips_judge_keys():
    rp, _ = _pair()
    sp = replay.FeedbackSpool(capacity=8)
    f = rp.request(0)
    lab = rp.labels(0, f)
    assert sp.offer(f, lab, scores=np.ones((8, 1)), step=0)
    batch = sp.source(0, timeout_s=5)
    assert set(batch) == {"dense", "sparse", "label"}
    np.testing.assert_array_equal(batch["label"], lab)
    served = sp.served(0)
    assert "_served_scores" in served and served["_trace_step"] == 0
    assert sp.served(1) is None


def test_spool_blocks_then_drains_in_order_overflows_and_closes():
    rp, _ = _pair()
    sp = replay.FeedbackSpool(capacity=8)
    got = []

    def consume():
        for i in range(3):
            got.append(sp.source(i, timeout_s=10))

    t = threading.Thread(target=consume)
    t.start()
    for i in range(3):
        sp.offer(rp.request(i), rp.labels(i), step=i)
    t.join(10)
    assert len(got) == 3 and sp.lag() == 0
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["sparse"], rp.request(i)["sparse"])
    small = replay.FeedbackSpool(capacity=2)
    assert small.offer(rp.request(0), rp.labels(0))
    assert small.offer(rp.request(1), rp.labels(1))
    assert not small.offer(rp.request(2), rp.labels(2))
    assert small.stats() == {"offered": 3, "landed": 2, "consumed": 0,
                             "lag": 2, "dropped_faults": 0,
                             "dropped_overflow": 1}
    small.close()
    assert small.source(2, timeout_s=5) is None
    assert not small.offer(rp.request(3), rp.labels(3))
    with pytest.raises(ValueError, match="capacity"):
        replay.FeedbackSpool(capacity=0)


@pytest.mark.parametrize("p", [0.3, 1.0])
def test_feedback_loss_drops_the_offers_jax_drops(p):
    rp, _ = _pair()
    landed = []
    for sp_mod, flt in ((replay, faults), (jax_replay, jax_faults)):
        sp = sp_mod.FeedbackSpool(capacity=64)
        with flt.active_plan(flt.FaultPlan(feedback_loss_p=p)) as plan:
            landed.append([sp.offer(rp.request(i), rp.labels(i))
                           for i in range(24)])
        assert ("feedback_loss", "spool") in plan.fired
        st = sp.stats()
        assert st["dropped_faults"] == 24 - sum(landed[-1])
    assert landed[0] == landed[1]
    assert (sum(landed[0]) == 0) == (p == 1.0)
    sp = replay.FeedbackSpool(capacity=4)
    assert sp.offer(rp.request(0), rp.labels(0))     # no plan, no drop


@pytest.mark.parametrize("val", ["0.25", "1.5", "-0.1", "lossy"])
def test_feedback_loss_env_matches_jax(monkeypatch, val):
    monkeypatch.setenv("FF_FAULT_FEEDBACK_LOSS", val)
    try:
        want = jax_faults.plan_from_env().feedback_loss_p
    except ValueError as e:
        with pytest.raises(ValueError) as ep:
            faults.plan_from_env()
        assert str(ep.value) == str(e)
        assert "FF_FAULT_FEEDBACK_LOSS" in str(e)
    else:
        assert faults.plan_from_env().feedback_loss_p == want == 0.25


# ---- fit_stream -------------------------------------------------------------
def _mlp_jax(policy="none", seed=1):
    m = ff.FFModel(ff.FFConfig(batch_size=8, seed=seed,
                               anomaly_policy=policy))
    x = m.create_tensor((8, 4), name="x")
    h = m.dense(x, 8, activation="relu", name="fc1")
    m.dense(h, 1, name="fc2")
    m.compile(ff.SGDOptimizer(0.1, momentum=0.9), "mean_squared_error",
              ["mse"], mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers()
    return m


def _mlp_port(jm, policy="none", **cfg):
    m = pt.FFModel(pt.FFConfig(batch_size=8, device="cpu",
                               anomaly_policy=policy, **cfg))
    x = m.create_tensor((8, 4), name="x")
    h = m.dense(x, 8, activation="relu", name="fc1")
    m.dense(h, 1, name="fc2")
    m.compile(SGDOptimizer(0.1, momentum=0.9), "mean_squared_error", ["mse"])
    m.swap_params(params_from_jax(m, jax.tree.map(np.asarray, jm.params)))
    return m


def _stream_data(n=40):
    r = np.random.RandomState(11)
    return ({"x": r.rand(n, 4).astype(np.float32)},
            r.rand(n, 1).astype(np.float32))


def _params(m):
    return jax.tree.map(np.array, params_to_jax(m, m.params))


@pytest.mark.parametrize("depth", [0, 2])
def test_fit_stream_trains_as_jax_and_as_a_loop(depth, capsys):
    """12 steps over an ArrayStream of 5 batches an epoch (a reshuffle
    each epoch): the port's fit_stream equals its train_batch loop over
    the same batches bitwise, and the JAX fit_stream within the
    tolerances above; callbacks see every step."""
    x, y = _stream_data()
    jm = _mlp_jax()
    pm = _mlp_port(jm, prefetch_depth=depth)
    loop = _mlp_port(jm)
    p0 = _params(pm)
    seen = []
    out = pm.fit_stream(ArrayStream(x, y, 8, seed=1), steps=12,
                        callbacks=[lambda m, n, mets: seen.append(
                            (n, float(mets["loss"])))])
    jout = jm.fit_stream(JaxArrayStream(x, y, 8, seed=1), steps=12,
                         verbose=False)
    assert out["steps"] == jout["steps"] == 12
    assert set(out) == set(jout)
    assert (out["publishes"], out["publisher"]) == (0, None)
    assert out["throughput"] > 0 and [n for n, _ in seen] == list(
        range(1, 13))
    assert "fit_stream: 12 steps" in capsys.readouterr().out
    src = ArrayStream(x, y, 8, seed=1)
    losses = [float(loop.train_batch(src(i))["loss"]) for i in range(12)]
    assert [v for _, v in seen] == losses
    got, want, loop_p = _params(pm), jax.tree.map(np.array, jm.params), \
        _params(loop)
    for op in want:
        for pn, w in want[op].items():
            assert np.array_equal(got[op][pn], loop_p[op][pn]), (op, pn)
            dj, dp = w - p0[op][pn], got[op][pn] - p0[op][pn]
            np.testing.assert_allclose(dp, dj, rtol=0,
                                       atol=1e-3 * np.abs(dj).max())
    assert pm._step == jm._step == 12


def test_fit_stream_ends_with_its_source():
    x, y = _stream_data()
    jm = _mlp_jax()
    for stop in (None, StopIteration, IndexError):
        pm = _mlp_port(jm)
        src = ArrayStream(x, y, 8, seed=1)

        def source(i, stop=stop, src=src):
            if i < 7:
                return src(i)
            if stop is None:
                return None
            raise stop()

        out = pm.fit_stream(source, steps=None, verbose=False)
        assert out["steps"] == 7 and pm._step == 7
    pm = _mlp_port(jm)
    out = pm.fit_stream(ArrayStream(x, y, 8, max_steps=3), verbose=False)
    assert out["steps"] == 3


def test_fit_stream_under_skip_step_and_its_refusals():
    x, y = _stream_data()
    jm = _mlp_jax()
    pm = _mlp_port(jm, policy="skip_step")
    ref = _mlp_port(jm)
    src = ArrayStream(x, y, 8, seed=1)
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={2})):
        out = pm.fit_stream(src, steps=5, verbose=False)
    assert out["steps"] == 5 and pm._step == 5
    for i in (0, 1, 3, 4):                 # the same batches, minus 2
        ref.train_batch(src(i))
    for op, p in pm.params.items():
        for pn, v in p.items():
            assert torch.equal(v, ref.params[op][pn]), (op, pn)
    rb = _mlp_port(jm, policy="rollback")
    with pytest.raises(ValueError) as ep:
        rb.fit_stream(src, steps=2)
    jrb = _mlp_jax(policy="rollback")
    with pytest.raises(ValueError) as ej:
        jrb.fit_stream(JaxArrayStream(x, y, 8), steps=2)
    assert str(ep.value) == str(ej.value)
    # a publisher needs publish_every >= 1, as the JAX fit_stream says
    for kw in ({"publish_every": 0}, {}):
        with pytest.raises(ValueError) as ep:
            pm.fit_stream(src, steps=2, publisher=object(), **kw)
        with pytest.raises(ValueError) as ej:
            jm.fit_stream(JaxArrayStream(x, y, 8), steps=2,
                          publisher=object(), **kw)
        assert str(ep.value) == str(ej.value)
        assert "publish_every >= 1" in str(ep.value)


def test_fit_stream_trains_off_a_spool_on_a_thread():
    """The serve -> train loop as scenarios/runner.py drives it: a
    trainer thread runs fit_stream on ``spool.source`` while the driver
    offers the trace's batches with their labels; closing the spool ends
    the stream, every landed batch trained, none dropped."""
    cfg = DLRMConfig(embedding_size=[R] * T, embedding_bag_size=BAG,
                     sparse_feature_size=8, mlp_bot=[D, 16, 8],
                     mlp_top=[8 * (T + 1), 16, 1])
    m = pt.FFModel(pt.FFConfig(batch_size=8, device="cpu", seed=3))
    build_dlrm(m, cfg)
    m.compile(SGDOptimizer(lr=0.3), "mean_squared_error", ["mse"])
    m.init_layers()
    rp, _ = _pair(steps=16)
    spool = replay.FeedbackSpool(capacity=64)
    result, errors = {}, []

    def train():
        try:
            result.update(m.fit_stream(spool.source, steps=None,
                                       verbose=False))
        except BaseException as e:   # noqa: BLE001 — asserted below
            errors.append(e)

    t = threading.Thread(target=train, daemon=True)
    t.start()
    for i in range(16):
        f = rp.request(i)
        assert spool.offer(f, rp.labels(i, f), scores=np.zeros((8, 1)),
                           step=i)
    spool.close()
    t.join(60)
    assert not t.is_alive() and not errors
    assert result["steps"] == 16 and m._step == 16
    st = spool.stats()
    assert st["landed"] == st["consumed"] == 16
    assert st["dropped_faults"] == st["dropped_overflow"] == 0
    assert np.isfinite(m.perf.report()["mse"])
