"""The port's prefetch ring (``data/prefetch.py``) and its wiring into the
loaders and ``fit``: the three contracts of tests/test_prefetch.py, held
the same way on the CPU.

- **Order**: items arrive in produce order, so prefetched batches, and a
  prefetched ``fit``, are BITWISE those of synchronous staging;
- **Errors**: a staging error surfaces at the consumer's next ``get`` and
  sticks; transient IO errors are absorbed by ``read_with_retries``;
- **Drain**: ``close`` stops and joins the staging thread, unblocking a
  full ring, and is idempotent; loader state capture drains the ring.

Also: a wedged staging thread trips the ring's liveness deadline
(``WorkerStalled``). On the card a staged batch is copied on a side
stream and ordered by an event; tests/test_torch_cuda.py holds that
path to synchronous staging there.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.data.dataloader import SingleDataLoader
from dlrm_flexflow_tpu_torch.data.prefetch import (PrefetchPipeline,
                                                   StagedBatch,
                                                   stack_batches)
from dlrm_flexflow_tpu_torch.utils import faults
from dlrm_flexflow_tpu_torch.utils.watchdog import WorkerStalled


def _mlp(**cfg):
    m = pt.FFModel(pt.FFConfig(batch_size=8, seed=1, device="cpu", **cfg))
    x = m.create_tensor((8, 4), name="x")
    m.dense(x, 8, activation="relu", name="fc1")
    m.dense(m.ops[-1].outputs[0], 1, name="fc2")
    m.compile(SGDOptimizer(0.1), "mean_squared_error", ["mse"])
    m.init_layers()
    return m


def _data(n, seed=5):
    r = np.random.RandomState(seed)
    return ({"x": r.rand(n, 4).astype(np.float32)},
            r.rand(n, 1).astype(np.float32))


def _stagers():
    return {t for t in threading.enumerate()
            if t.name.startswith("ff-prefetch-")}


def _no_new_stagers(before):
    """Every staging thread started since `before` (a ``_stagers()``
    snapshot: other tests of the process may leave their own) has
    ended."""
    deadline = time.time() + 5
    while time.time() < deadline:
        if not [t for t in _stagers() - before if t.is_alive()]:
            return True
        time.sleep(0.01)
    return False


# ---- the ring ---------------------------------------------------------------
def test_delivers_in_order_and_exhausts():
    pipe = PrefetchPipeline(lambda i: i * i, depth=3, num_items=10)
    try:
        assert [pipe.get() for _ in range(10)] == [i * i for i in range(10)]
        with pytest.raises(IndexError):
            pipe.get()
        st = pipe.stats()
        assert st["items"] == 10
        assert 0.0 <= st["overlap_fraction"] <= 1.0
    finally:
        pipe.close()


def test_depth_bounds_staging_ahead():
    produced = []

    def produce(i):
        produced.append(i)
        return i

    pipe = PrefetchPipeline(produce, depth=2, num_items=100)
    try:
        deadline = time.time() + 5
        while len(produced) < 2 and time.time() < deadline:
            time.sleep(0.005)
        time.sleep(0.05)   # time for an over-eager producer to leak
        assert len(produced) <= 3   # ring full (+1 in flight at most)
        assert pipe.get() == 0
    finally:
        pipe.close()
    with pytest.raises(ValueError, match="depth"):
        PrefetchPipeline(lambda i: i, depth=0)


def test_error_surfaces_at_step_boundary_and_sticks():
    def produce(i):
        if i == 2:
            raise RuntimeError("staging exploded")
        return i

    pipe = PrefetchPipeline(produce, depth=2, num_items=10)
    try:
        assert pipe.get() == 0
        assert pipe.get() == 1
        with pytest.raises(RuntimeError, match="staging exploded"):
            pipe.get()
        with pytest.raises(RuntimeError, match="staging exploded"):
            pipe.get()   # sticky: the producer is dead
    finally:
        pipe.close()


def test_transient_io_error_recovers_via_retry():
    with faults.active_plan(
            faults.FaultPlan(io_errors={"prefetch": 2})) as plan:
        pipe = PrefetchPipeline(lambda i: i, depth=2, num_items=5,
                                io_backoff_s=0.001)
        try:
            assert [pipe.get() for _ in range(5)] == list(range(5))
        finally:
            pipe.close()
    assert [f for f in plan.fired if f[0] == "io_error"]


def test_close_unblocks_full_ring_and_is_idempotent():
    before = _stagers()
    pipe = PrefetchPipeline(lambda i: i, depth=1, num_items=1000)
    assert pipe.get() == 0
    pipe.close()
    pipe.close()
    assert pipe.closed
    with pytest.raises(RuntimeError, match="closed"):
        pipe.get()
    assert _no_new_stagers(before)


def test_a_wedged_stager_misses_its_deadline():
    before = _stagers()
    with faults.active_plan(faults.FaultPlan(stall_s={"prefetch": 0.6})):
        pipe = PrefetchPipeline(lambda i: i, depth=1, num_items=3,
                                deadline_s=0.1)
        try:
            with pytest.raises(WorkerStalled) as err:
                pipe.get()
            assert err.value.report.waiting_for == "staged item 0"
            assert err.value.report.alive
        finally:
            pipe.close()
    assert _no_new_stagers(before)


def test_stack_batches_and_a_staged_cpu_batch():
    a = {"x": np.ones((2, 3), np.float32), "y": np.zeros(2, np.int32)}
    out = stack_batches([a, a, a])
    assert out["x"].shape == (3, 2, 3) and out["y"].shape == (3, 2)
    with pytest.raises(ValueError, match="ragged"):
        stack_batches([a, {"x": np.ones((3, 3), np.float32), "y": a["y"]}])
    with pytest.raises(ValueError, match="keys"):
        stack_batches([a, {"x": a["x"]}])
    m = _mlp()
    staged = m._stage_step({"x": a["x"][:, :2].repeat(2, 1),
                            "label": np.ones((2, 1))})
    assert isinstance(staged, StagedBatch) and staged.event is None
    got = staged.wait()
    assert got["x"].dtype == torch.float32 and got["x"].shape == (2, 4)
    assert got["label"].dtype == torch.float32


# ---- the loaders --------------------------------------------------------------
def test_sequence_identical_across_epochs():
    m = _mlp()
    xs, ys = _data(40)
    a = SingleDataLoader(m, xs, ys, shuffle=True, seed=3, prefetch=True)
    b = SingleDataLoader(m, xs, ys, shuffle=True, seed=3, prefetch=False)
    try:
        for i in range(12):   # 5 batches an epoch: two reshuffles
            ba, bb = a.next_host_batch(), b.next_host_batch()
            np.testing.assert_array_equal(ba["x"], bb["x"], err_msg=str(i))
            np.testing.assert_array_equal(ba["label"], bb["label"])
            da, db = a.next_batch(), b.next_batch()
            assert torch.equal(da["x"], db["x"])
            assert torch.equal(da["label"], db["label"])
    finally:
        a.close()


def test_state_roundtrip_with_prefetch_on():
    before = _stagers()
    m = _mlp()
    xs, ys = _data(40)
    dl = SingleDataLoader(m, xs, ys, shuffle=True, seed=3, prefetch=True)
    for _ in range(3):
        dl.next_host_batch()
    state = json.loads(json.dumps(dl.state()))   # JSON-safe
    want = [dl.next_host_batch() for _ in range(7)]
    dl2 = SingleDataLoader(m, xs, ys, shuffle=True, seed=99, prefetch=True)
    dl2.set_state(state)
    got = [dl2.next_host_batch() for _ in range(7)]
    dl.close()
    dl2.close()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w["x"], g["x"])
        np.testing.assert_array_equal(w["label"], g["label"])
    assert _no_new_stagers(before)


def test_staging_error_propagates_at_next_batch():
    m = _mlp()
    xs, ys = _data(40)
    dl = SingleDataLoader(m, xs, ys, prefetch=True)
    orig = m._stage_step
    calls = {"n": 0}

    def flaky(batch):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("H2D exploded")
        return orig(batch)

    m._stage_step = flaky
    try:
        dl.next_batch()
        dl.next_batch()
        with pytest.raises(RuntimeError, match="H2D exploded"):
            for _ in range(3):
                dl.next_batch()
    finally:
        dl.close()


def test_transient_io_error_mid_prefetch_recovers():
    m = _mlp()
    xs, ys = _data(40)
    ref = SingleDataLoader(m, xs, ys, shuffle=True, seed=3, prefetch=False)
    with faults.active_plan(
            faults.FaultPlan(io_errors={"prefetch": 2})) as plan:
        dl = SingleDataLoader(m, xs, ys, shuffle=True, seed=3,
                              prefetch=True)
        got = [dl.next_host_batch() for _ in range(5)]
        dl.close()
    want = [ref.next_host_batch() for _ in range(5)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w["x"], g["x"])
    assert [f for f in plan.fired if f[0] == "io_error"]


# ---- fit ------------------------------------------------------------------------
def _fit_params(depth, n=44, epochs=3, **kw):
    # 44 samples / batch 8: 5 full batches and a remainder of 4
    xs, ys = _data(n, seed=7)
    # through the ring (depth > 0) or staged in the loop (depth 0), not
    # the whole dataset staged at once
    m = _mlp(prefetch_depth=depth, stage_dataset="never")
    res = m.fit(xs, ys, epochs=epochs, verbose=False, **kw)
    return m, res


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetched_fit_is_bitwise_the_synchronous_one(depth):
    before = _stagers()
    sync, rs = _fit_params(0)
    pre, rp = _fit_params(depth)
    assert rs["num_samples"] == rp["num_samples"] == 44 * 3
    for op in ("fc1", "fc2"):
        for k, v in sync.params[op].items():
            assert torch.equal(v, pre.params[op][k]), (op, k)
    assert _no_new_stagers(before)


def test_prefetched_resume_from_the_final_checkpoint(tmp_path):
    """A fresh model resuming from a finished run's directory has nothing
    left to train and takes the run's final parameters."""
    m1, _ = _fit_params(2, checkpoint_dir=str(tmp_path / "ck"),
                        save_every=3)
    m2, res = _fit_params(2, checkpoint_dir=str(tmp_path / "ck"),
                          save_every=3)
    assert res["num_samples"] == 0
    for op in ("fc1", "fc2"):
        for k, v in m1.params[op].items():
            assert torch.equal(v, m2.params[op][k])
