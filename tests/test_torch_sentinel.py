"""The port's anomaly sentinel, ``fit``'s rollback and whole-dataset
staging, and the NaN-gradient fault hook, against the JAX package on the
CPU.

Both packages build the same model (the MLP of tests/test_resilience.py,
the small "cat" DLRM of tests/test_torch_optimizers.py, a small fused
"dot" DLRM), the JAX model's weights cross into the port through
``params_from_jax``, and both train on the same numpy batches with the
same fault plan (``nan_grad_steps``: the batch of that step poisoned to
NaN). On the CPU the port's update kernels run their plain versions,
which honour the sentinel's flag as the CUDA kernels do.

Tolerances, and why:

- A skipped step, inside the port: BITWISE. The parameters, the
  optimizer state and Adam's step after a poisoned step equal those
  before it (nothing is written), as the JAX step keeps its pre-step
  values; ``_step`` advances either way.
- The port against JAX after a clean, a poisoned and a clean step:
  every parameter's and slab's change within 1e-3 of its largest change
  under SGD and 1e-2 under Adam, the tolerances of
  tests/test_torch_optimizers.py's training test and for its reasons
  (the MLP products sum in another fp32 order in XLA; Adam divides by
  sqrt(v)); losses within rtol 1e-6; Adam's step count exactly.
- The global gradient norm of a clean step: rtol 1e-5 (an fp32 sum of
  squares in another order); the flag, the anomaly and the step counts
  exactly.
- A rollback ``fit`` against a clean port ``fit`` of the same data:
  BITWISE (the restored snapshot is exact, the replayed steps the same
  arithmetic); against the JAX rollback ``fit``: the tolerances above.
- A staged ``fit`` against a ring ``fit`` and a ``fit`` staging in the
  loop: BITWISE (the same batches, the same steps).
"""

import json

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh
from dlrm_flexflow_tpu.utils import faults as jax_faults

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import (AdamOptimizer,
                                                     SGDOptimizer)
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.ops.kernels import dense_update as dense_mod
from dlrm_flexflow_tpu_torch.ops.kernels import scatter_rows as scat_mod
from dlrm_flexflow_tpu_torch.utils import faults
from dlrm_flexflow_tpu_torch.utils.profiling import TraceContext
from dlrm_flexflow_tpu_torch.utils.weights import (opt_state_to_jax,
                                                   params_from_jax,
                                                   params_to_jax)

OPTS = {
    "momentum": (lambda: ff.SGDOptimizer(0.1, momentum=0.9),
                 lambda: SGDOptimizer(0.1, momentum=0.9)),
    "adam": (lambda: ff.AdamOptimizer(alpha=0.01),
             lambda: AdamOptimizer(alpha=0.01)),
}
# tests/test_torch_optimizers.py's small "cat" DLRM, and a fused "dot"
# one of the same widths
ARCH = {
    "cat": dict(embedding_size=[64] * 8, sparse_feature_size=8,
                embedding_bag_size=2, mlp_bot=[4, 16, 8],
                mlp_top=[72, 16, 1]),
    "dot": dict(embedding_size=[64] * 8, sparse_feature_size=8,
                embedding_bag_size=2, mlp_bot=[4, 16, 8],
                mlp_top=[8 + 9 * 8 // 2, 16, 1],
                arch_interaction_op="dot"),
}


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _mlp_jax(policy, opt="momentum", seed=1, bs=8):
    m = ff.FFModel(ff.FFConfig(batch_size=bs, seed=seed,
                               anomaly_policy=policy))
    x = m.create_tensor((bs, 4), name="x")
    h = m.dense(x, 8, activation="relu", name="fc1")
    m.dense(h, 1, name="fc2")
    m.compile(OPTS[opt][0](), "mean_squared_error", ["mse"], mesh=_mesh())
    m.init_layers()
    return m


def _mlp_port(policy, jm, opt="momentum", bs=8, **cfg):
    m = pt.FFModel(pt.FFConfig(batch_size=bs, device="cpu",
                               anomaly_policy=policy, **cfg))
    x = m.create_tensor((bs, 4), name="x")
    h = m.dense(x, 8, activation="relu", name="fc1")
    m.dense(h, 1, name="fc2")
    m.compile(OPTS[opt][1](), "mean_squared_error", ["mse"])
    m.swap_params(params_from_jax(m, jax.tree.map(np.asarray, jm.params)))
    return m


def _mlp_data(n=40, seed=0):
    r = np.random.RandomState(seed)
    return ({"x": r.rand(n, 4).astype(np.float32)},
            r.rand(n, 1).astype(np.float32))


def _mlp_batch(seed):
    xs, ys = _mlp_data(8, seed)
    xs["label"] = ys
    return xs


def _dlrm_jax(mode, policy, opt):
    m = ff.FFModel(ff.FFConfig(batch_size=16, seed=2,
                               anomaly_policy=policy))
    jax_build_dlrm(m, JaxDLRMConfig(**ARCH[mode]),
                   fuse_interaction=mode == "dot")
    m.compile(OPTS[opt][0](), "mean_squared_error", ["mse"], mesh=_mesh())
    m.init_layers()
    return m


def _dlrm_port(mode, policy, opt, jm, **cfg):
    m = pt.FFModel(pt.FFConfig(batch_size=16, device="cpu",
                               anomaly_policy=policy, **cfg))
    build_dlrm(m, DLRMConfig(**ARCH[mode]), fuse_interaction=mode == "dot")
    m.compile(OPTS[opt][1](), "mean_squared_error", ["mse"])
    m.swap_params(params_from_jax(m, jax.tree.map(np.asarray, jm.params)))
    return m


def _dlrm_batch(mode, seed):
    x, y = synthetic_batch(DLRMConfig(**ARCH[mode]), 16, seed=30 + seed)
    x["label"] = y
    return x


def _state(m):
    """The port's parameters and optimizer state as numpy copies in the
    JAX layout."""
    out = {"params": params_to_jax(m, m.params)}
    if m.opt_state is not None:
        out.update(opt_state_to_jax(m, m.opt_state))
    return jax.tree.map(np.array, out)


def _jax_state(m):
    out = {"params": m.params, **m.opt_state}
    return jax.tree.map(np.array, out)


def _assert_same(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _assert_close_changes(got, want, start, frac):
    """Every slab's change from ``start`` within ``frac`` of its largest
    change in JAX; Adam's step exactly."""
    for k in want:
        if k == "step":
            assert int(got[k]) == int(want[k])
            continue
        for op in want[k]:
            for pn, w in want[k][op].items():
                dj = w - start[k][op][pn]
                dp = got[k][op][pn] - start[k][op][pn]
                scale = np.abs(dj).max()
                np.testing.assert_allclose(dp, dj, rtol=0,
                                           atol=frac * scale + 1e-12,
                                           err_msg=f"{k}.{op}.{pn}")


def _frac(opt):
    return 1e-2 if opt == "adam" else 1e-3


def _three_steps(jm, pm, batch, poison=1):
    """A clean, a poisoned and a clean step in both packages; checks the
    poisoned step changed nothing in the port. Returns (JAX metrics, port
    metrics) of each step."""
    mj, mp = [], []
    with jax_faults.active_plan(jax_faults.FaultPlan(
            nan_grad_steps={poison})):
        for s in range(3):
            mj.append(jm.train_batch(batch(s)))
    with faults.active_plan(faults.FaultPlan(
            nan_grad_steps={poison})) as plan:
        for s in range(3):
            if s == poison:
                before = _state(pm)
            mp.append(pm.train_batch(batch(s)))
            if s == poison:
                _assert_same(_state(pm), before)
    assert plan.fired == [("nan_grad", poison)]
    return mj, mp


def _check_three_steps(jm, pm, mj, mp, start, opt, poison=1):
    for s in range(3):
        bad = s == poison
        assert bool(np.asarray(mj[s]["anomaly"])) == bad
        assert bool(mp[s]["anomaly"]) == bad
        assert np.isfinite(float(mp[s]["grad_norm"])) == (not bad)
        if not bad:
            np.testing.assert_allclose(float(mp[s]["loss"]),
                                       float(mj[s]["loss"]), rtol=1e-6)
            np.testing.assert_allclose(float(mp[s]["grad_norm"]),
                                       float(mj[s]["grad_norm"]),
                                       rtol=1e-5)
    assert pm._step == jm._step == 3
    _assert_close_changes(_state(pm), _jax_state(jm), start, _frac(opt))


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_skip_step_on_an_mlp_matches_jax(opt):
    jm = _mlp_jax("skip_step", opt)
    pm = _mlp_port("skip_step", jm, opt)
    pm.opt_state = pm.optimizer.init_state(pm.params)
    start = _state(pm)
    mj, mp = _three_steps(jm, pm, _mlp_batch)
    _check_three_steps(jm, pm, mj, mp, start, opt)
    if opt == "adam":
        assert int(pm.opt_state["step"]) == 2     # the skipped step: none
    # the running sums hold the two clean steps only
    assert np.isfinite(pm.perf.report()["mse"])


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("mode", ["cat", "dot"])
def test_skip_step_on_dlrm_matches_jax(mode, opt):
    """"cat": the tables take the touched-rows update (the stateful
    scatter), which the flag guards; "dot": the table is a dense
    parameter of the fused interaction, on the dense update."""
    jm = _dlrm_jax(mode, "skip_step", opt)
    pm = _dlrm_port(mode, "skip_step", opt, jm)
    pm.opt_state = pm.optimizer.init_state(pm.params)
    start = _state(pm)
    mj, mp = _three_steps(jm, pm, lambda s: _dlrm_batch(mode, s))
    assert [op.name for op in pm._sparse_ops] == (
        ["emb_stack"] if mode == "cat" else [])
    _check_three_steps(jm, pm, mj, mp, start, opt)


def test_skip_step_under_plain_sgd_guards_the_write_only_scatter():
    """Plain SGD takes ``sparse_sgd_update`` (the add or write scatter):
    a poisoned first step leaves the table bitwise."""
    jm = _dlrm_jax("cat", "skip_step", "momentum")
    pm = pt.FFModel(pt.FFConfig(batch_size=16, device="cpu",
                                anomaly_policy="skip_step"))
    build_dlrm(pm, DLRMConfig(**ARCH["cat"]))
    pm.compile(SGDOptimizer(0.1), "mean_squared_error", ["mse"])
    pm.swap_params(params_from_jax(pm, jax.tree.map(np.asarray, jm.params)))
    table = pm.params["emb_stack"]["kernel"].clone()
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={0})):
        mets = pm.train_batch(_dlrm_batch("cat", 0))
    assert bool(mets["anomaly"]) and not pm._stateful_sparse()
    assert torch.equal(pm.params["emb_stack"]["kernel"], table)
    pm.train_batch(_dlrm_batch("cat", 1))
    assert not torch.equal(pm.params["emb_stack"]["kernel"], table)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_raise_policy_matches_jax(opt):
    jm = _mlp_jax("raise", opt)
    pm = _mlp_port("raise", jm, opt)
    before = _state(pm)
    with jax_faults.active_plan(jax_faults.FaultPlan(nan_grad_steps={0})):
        with pytest.raises(ff.AnomalyError) as ej:
            jm.train_batch(_mlp_batch(0))
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={0})):
        with pytest.raises(pt.AnomalyError) as ep:
            pm.train_batch(_mlp_batch(0))
    assert ep.value.step == ej.value.step == 0
    assert not np.isfinite(ep.value.loss) and not np.isfinite(ej.value.loss)
    assert not np.isfinite(ep.value.grad_norm)
    assert str(ep.value).startswith("non-finite training step 0: loss=nan")
    assert pm._step == jm._step == 1
    # the update was suppressed: the weights are the carried-over ones
    after = _state(pm)
    _assert_same(after["params"], before["params"])
    _assert_same(after["params"], jax.tree.map(np.asarray, jm.params))
    # a clean step raises nothing and trains on
    mp = pm.train_batch(_mlp_batch(1))
    assert not bool(mp["anomaly"]) and pm._step == 2


def test_rollback_restores_and_continues(tmp_path):
    """tests/test_resilience.py's rollback case in both packages: 3 epochs
    of 5 batches, a snapshot every 2 steps, step 7 poisoned."""
    xs, ys = _mlp_data()
    jm = _mlp_jax("rollback", seed=5)
    pm = _mlp_port("rollback", jm)
    clean = _mlp_port("none", jm)
    pm.opt_state = pm.optimizer.init_state(pm.params)
    start = _state(pm)
    kw = dict(epochs=3, verbose=False, save_every=2)
    with jax_faults.active_plan(jax_faults.FaultPlan(nan_grad_steps={7})):
        rj = jm.fit(xs, ys, checkpoint_dir=str(tmp_path / "jax"), **kw)
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={7})):
        rp = pm.fit(xs, ys, checkpoint_dir=str(tmp_path / "port"), **kw)
    rc = clean.fit(xs, ys, **kw)
    assert rp["rollbacks"] == rj["rollbacks"] == 1 and rc["rollbacks"] == 0
    assert pm._step == jm._step == clean._step == 15
    assert rp["num_samples"] == rj["num_samples"]
    _assert_same(_state(pm), _state(clean))
    _assert_close_changes(_state(pm), _jax_state(jm), start, 1e-3)
    entries = json.loads(
        (tmp_path / "port" / "manifest.json").read_text())["entries"]
    assert entries[-1]["step"] == 15


def test_rollback_seeds_an_empty_directory(tmp_path):
    """With no snapshot yet (no save_every), the seed snapshot of the
    initial state is the rollback target: the run trains from step 0
    again and ends as a clean fit does."""
    xs, ys = _mlp_data()
    jm = _mlp_jax("rollback", seed=5)
    pm = _mlp_port("rollback", jm)
    clean = _mlp_port("none", jm)
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={3})):
        rp = pm.fit(xs, ys, epochs=2, verbose=False,
                    checkpoint_dir=str(tmp_path))
    clean.fit(xs, ys, epochs=2, verbose=False)
    assert rp["rollbacks"] == 1 and pm._step == 10
    assert rp["num_samples"] == (3 + 10) * 8
    _assert_same(_state(pm), _state(clean))


def test_rollback_budget_exhausts_and_raises(tmp_path):
    xs, ys = _mlp_data()
    jm = _mlp_jax("rollback", seed=5)
    pm = _mlp_port("rollback", jm)
    kw = dict(epochs=3, verbose=False, save_every=100)
    with jax_faults.active_plan(
            jax_faults.FaultPlan(nan_grad_steps={2, 3, 4, 5})):
        with pytest.raises(ff.AnomalyError) as ej:
            jm.fit(xs, ys, checkpoint_dir=str(tmp_path / "jax"), **kw)
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={2, 3, 4, 5})):
        with pytest.raises(pt.AnomalyError) as ep:
            pm.fit(xs, ys, checkpoint_dir=str(tmp_path / "port"), **kw)
    assert ep.value.step == ej.value.step == 5
    # the state is the rolled-back, clean one
    assert all(np.isfinite(v).all()
               for v in jax.tree.leaves(_state(pm)))


def test_rollback_without_checkpoint_dir_rejected():
    xs, ys = _mlp_data()
    jm = _mlp_jax("rollback")
    pm = _mlp_port("rollback", jm)
    with pytest.raises(ValueError, match="checkpoint_dir") as ep:
        pm.fit(xs, ys, epochs=1, verbose=False)
    with pytest.raises(ValueError, match="checkpoint_dir") as ej:
        jm.fit(xs, ys, epochs=1, verbose=False)
    assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("argv", [
    ["--anomaly-policy", "skip_step", "--checkpoint-dir", "/tmp/c",
     "--save-every", "50", "--keep-last", "5"],
    ["--anomaly-policy", "rollback", "--stage-dataset", "never",
     "--profile-dir", "prof"],
    ["--anomaly-policy", "raise", "--stage-dataset", "always"],
])
def test_cli_flags_parse_as_jax(argv):
    got = pt.FFConfig.parse_args(argv + ["--device", "cpu"])
    want = ff.FFConfig.parse_args(argv)
    for k in ("anomaly_policy", "max_rollbacks", "stage_dataset",
              "profile_dir", "checkpoint_dir", "save_every", "keep_last"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.unparsed == ["--device", "cpu"] or got.unparsed == []


@pytest.mark.parametrize("argv", [["--anomaly-policy", "bogus"],
                                  ["--stage-dataset", "sometimes"]])
def test_cli_flags_reject_as_jax(argv):
    with pytest.raises(ValueError) as ep:
        pt.FFConfig.parse_args(argv)
    with pytest.raises(ValueError) as ej:
        ff.FFConfig.parse_args(argv)
    assert str(ep.value) == str(ej.value)
    with pytest.raises(ValueError, match="anomaly_policy|stage_dataset"):
        pt.FFConfig(device="cpu", **{argv[0][2:].replace("-", "_"):
                                     argv[1]})


def _staged_counts(m):
    """Count ``_device_batch`` and ``_stage_step`` calls of ``m``."""
    counts = {"device_batch": 0, "stage_step": 0}
    db, ss = m._device_batch, m._stage_step

    def device_batch(b):
        counts["device_batch"] += 1
        return db(b)

    def stage_step(b):
        counts["stage_step"] += 1
        return ss(b)

    m._device_batch, m._stage_step = device_batch, stage_step
    return counts


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_staged_fit_is_bitwise_the_ring_fit(opt):
    """44 samples in batches of 8 (5 and a remainder of 4), 3 epochs:
    staged once ("auto" under the CPU's 2e9-byte cap, and "always"), in
    the ring ("never", depth 2) and in the loop ("never", depth 0)."""
    xs, ys = _mlp_data(44, seed=7)
    jm = _mlp_jax("none", opt)
    runs = {}
    for name, cfg in (("auto", {}), ("always", {"stage_dataset": "always"}),
                      ("ring", {"stage_dataset": "never"}),
                      ("loop", {"stage_dataset": "never",
                                "prefetch_depth": 0})):
        m = _mlp_port("none", jm, opt, **cfg)
        counts = _staged_counts(m)
        out = m.fit(xs, ys, epochs=3, verbose=False)
        assert out["num_samples"] == 3 * 44 and m._step == 18
        staged = name in ("auto", "always")
        assert counts["device_batch"] == (6 if staged else
                                          18 if name == "loop" else 0)
        assert counts["stage_step"] == (18 if name == "ring" else 0)
        runs[name] = _state(m)
    for name in ("always", "ring", "loop"):
        _assert_same(runs[name], runs["auto"])


def test_fit_stages_only_within_the_budget(monkeypatch):
    xs, ys = _mlp_data(44, seed=7)
    jm = _mlp_jax("none")
    m = _mlp_port("none", jm)
    # x (44, 4) and the label (44, 1), fp32
    assert m._staging_bytes(xs, ys) == 44 * 5 * 4
    assert m._staging_budget() == 2e9
    monkeypatch.setattr(m, "_staging_budget", lambda: 44 * 5 * 4 - 1)
    counts = _staged_counts(m)
    m.fit(xs, ys, epochs=1, verbose=False)
    assert counts["device_batch"] == 0 and counts["stage_step"] == 6


@pytest.mark.parametrize("stage", ["auto", "never"])
def test_a_remainder_that_cannot_train_is_dropped(stage, capsys):
    """A remainder whose step raises before any update is dropped with
    the JAX warning and every full batch trains, staged or through the
    ring; an anomaly in it is not such a failure."""
    xs, ys = _mlp_data(44, seed=7)
    jm = _mlp_jax("none")
    m = _mlp_port("none", jm, stage_dataset=stage)
    train = m.train_batch_device

    def refuse(batch, **kw):
        if len(batch["label"]) != 8:
            raise RuntimeError("an op bakes the batch of 8 into its shape")
        return train(batch, **kw)

    m.train_batch_device = refuse
    out = m.fit(xs, ys, epochs=2, verbose=False)
    assert out["num_samples"] == 2 * 40 and m._step == 10
    clean = _mlp_port("none", jm)
    clean.fit({"x": xs["x"][:40]}, ys[:40], epochs=2, verbose=False)
    _assert_same(_state(m), _state(clean))
    pm = _mlp_port("raise", jm, stage_dataset=stage)
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={5})):
        with pytest.raises(pt.AnomalyError):
            pm.fit(xs, ys, epochs=2, verbose=False)


@pytest.mark.parametrize("stage", ["auto", "never"])
def test_a_remainder_whose_staging_fails_raises(stage):
    """Staging the remainder is a copy that cannot fail at its shape: an
    error there (staged, or the ring's sticky one) is the caller's."""
    xs, ys = _mlp_data(44, seed=7)
    m = _mlp_port("none", _mlp_jax("none"), stage_dataset=stage)
    name = "_device_batch" if stage == "auto" else "_stage_step"
    real = getattr(m, name)

    def refuse(batch):
        if len(batch["label"]) != 8:
            raise RuntimeError("the copy failed")
        return real(batch)

    setattr(m, name, refuse)
    with pytest.raises(RuntimeError, match="the copy failed"):
        m.fit(xs, ys, epochs=2, verbose=False)


@pytest.mark.parametrize("stage", ["auto", "never"])
def test_a_remainder_error_after_the_sparse_update_raises(stage):
    """An error once the step has written (here the dense update, after
    the touched-rows update of the tables) is never taken for a shape
    failure: the tables are already changed, so fit raises."""
    jm = _dlrm_jax("cat", "none", "momentum")
    m = _dlrm_port("cat", "none", "momentum", jm, stage_dataset=stage)
    x, y = synthetic_batch(DLRMConfig(**ARCH["cat"]), 40, seed=5)
    train, update = m.train_batch_device, m.optimizer.update
    before, failed = {}, []

    def step(batch, **kw):
        if len(batch["label"]) == 8:      # 40 = 2 x 16 + a remainder of 8
            before.update({op.name: m.params[op.name]["kernel"].clone()
                           for op in m._sparse_ops})
        return train(batch, **kw)

    def fail_on_the_remainder(*args, **kw):
        if before and not failed:
            failed.append(m._step)
            raise RuntimeError("the dense update failed")
        return update(*args, **kw)

    m.train_batch_device = step
    m.optimizer.update = fail_on_the_remainder
    with pytest.raises(RuntimeError, match="the dense update failed"):
        m.fit(x, y, epochs=2, verbose=False)
    assert failed == [2] and m._step == 2 and m._updating
    for name, table in before.items():
        assert not torch.equal(table, m.params[name]["kernel"])


def test_profile_dir_writes_a_trace(tmp_path):
    xs, ys = _mlp_data(16)
    jm = _mlp_jax("none")
    m = _mlp_port("none", jm, profile_dir=str(tmp_path / "prof"))
    m.fit(xs, ys, epochs=1, verbose=False)
    (trace,) = (tmp_path / "prof").glob("trace-*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    with TraceContext("") as t:
        pass
    assert t.path is None


def test_per_op_profile_raises_with_its_item():
    from dlrm_flexflow_tpu_torch.utils import profiling
    for fn, arg in ((profiling.profile_ops, None),
                    (profiling.format_profile, [])):
        with pytest.raises(NotImplementedError, match="item 6"):
            fn(arg)


def test_fault_env_matches_jax(monkeypatch):
    for k in ("FF_FAULT_NAN_STEPS", "FF_FAULT_IO_ERRORS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("FF_FAULT_NAN_STEPS", "3, 7,3")
    monkeypatch.setenv("FF_FAULT_TRUNCATE_CKPTS", "2")
    got, want = faults.plan_from_env(), jax_faults.plan_from_env()
    assert got.nan_grad_steps == want.nan_grad_steps == {3, 7}
    assert got.truncate_checkpoints == want.truncate_checkpoints == 2
    monkeypatch.setenv("FF_FAULT_NAN_STEPS", "3,x")
    with pytest.raises(ValueError) as ep:
        faults.plan_from_env()
    with pytest.raises(ValueError) as ej:
        jax_faults.plan_from_env()
    assert str(ep.value) == str(ej.value)
    assert "FF_FAULT_NAN_STEPS" in str(ep.value)


def test_take_nan_grad_is_consume_once():
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={2})) as plan:
        assert [faults.take_nan_grad(s) for s in (1, 2, 2, 3)] == [
            False, True, False, False]
    assert plan.fired == [("nan_grad", 2)]
    assert not faults.take_nan_grad(2)          # no plan: never


@pytest.mark.parametrize("row", [None, 1])
def test_poison_batch_matches_jax(row):
    b = _dlrm_batch("cat", 0)
    want = jax_faults.poison_batch(
        {k: np.asarray(v) for k, v in b.items()}, row=row)
    db = {k: torch.as_tensor(v) for k, v in b.items()}
    got = faults.poison_batch(db, row=row)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    assert got["label"] is not db["label"] and got["dense"] is db["dense"]
    assert torch.equal(db["label"], torch.as_tensor(b["label"]))
    # an integer label: the first float input is poisoned
    ib = {"ids": torch.zeros(4, 2, dtype=torch.int64),
          "x": torch.ones(4, 3), "label": torch.zeros(4, dtype=torch.int64)}
    out = faults.poison_batch(ib)
    assert torch.isnan(out["x"]).all() and torch.equal(out["label"],
                                                       ib["label"])
    with pytest.raises(ValueError, match="no float tensor"):
        faults.poison_batch({"ids": ib["ids"], "label": ib["label"]})


def test_grad_sumsq_plain_version():
    """The norm's plain version: the fp32 sum over the list, in order,
    against float64 (rtol 1e-5); the flag exact for NaN and +-Inf in a
    gradient or the loss; an empty list gives 0."""
    rng = np.random.RandomState(0)
    gs = [torch.from_numpy(rng.randn(*s).astype(np.float32))
          for s in ((7, 5), (3,), (0, 4), (129,))]
    want = sum(float((g.double() ** 2).sum()) for g in gs)
    gsq, norm, ok = dense_mod.grad_sumsq(gs, torch.tensor(0.5))
    np.testing.assert_allclose(float(gsq), want, rtol=1e-5)
    np.testing.assert_allclose(float(norm), np.sqrt(want), rtol=1e-5)
    assert ok.dtype == torch.int32 and ok.dim() == 0 and int(ok) == 1
    for bad in (float("nan"), float("inf"), -float("inf")):
        g2 = [g.clone() for g in gs]
        g2[3][17] = bad
        assert int(dense_mod.grad_sumsq(g2, torch.tensor(0.5))[2]) == 0
        assert int(dense_mod.grad_sumsq(gs, torch.tensor(bad))[2]) == 0
    assert [float(v) for v in dense_mod.grad_sumsq(
        [], torch.tensor(1.0))] == [0.0, 0.0, 1.0]


def test_plain_updates_honour_the_flag():
    """``ok`` = 0 leaves every output of the guarded plain versions
    bitwise; ``ok`` = 1 equals the call without a flag."""
    rng = np.random.RandomState(1)
    table = torch.from_numpy(rng.randn(32, 8).astype(np.float32))
    ids = torch.tensor([3, 5, 3, -1, 9], dtype=torch.int64)
    upd = torch.from_numpy(rng.randn(5, 8).astype(np.float32))
    fwd = table[ids.clamp(min=0)]
    slabs = {k: torch.rand(32, 8) for k in ("m", "v")}
    adam = AdamOptimizer(alpha=0.01)
    at = adam.alpha_t(torch.tensor(2, dtype=torch.int32))
    calls = {
        "add": lambda t, s, ok: scat_mod.scatter_add_rows(
            t, ids, upd, -0.1, ok=ok),
        "write": lambda t, s, ok: scat_mod.scatter_write_rows(
            t, ids, upd, fwd, -0.1, ok=ok),
        "stateful": lambda t, s, ok: scat_mod.stateful_update_rows(
            t, ids, upd, None, s, adam.row_params(), at, ok=ok),
        "dense": lambda t, s, ok: dense_mod.dense_update(
            [t], [torch.ones_like(t)], [s], adam.row_params(), at, ok),
    }
    for name, call in calls.items():
        outs = {}
        for ok in (None, 0, 1):
            t, s = table.clone(), {k: v.clone() for k, v in slabs.items()}
            call(t, s, None if ok is None else torch.tensor(
                ok, dtype=torch.int32))
            outs[ok] = [t, *s.values()]
        for a, b in zip(outs[0], [table, *slabs.values()]):
            assert torch.equal(a, b), name
        for a, b in zip(outs[1], outs[None]):
            assert torch.equal(a, b), name
        assert not torch.equal(outs[None][0], table), name
    with pytest.raises(ValueError, match="0-d int32"):
        scat_mod.scatter_add_rows(table.clone(), ids, upd,
                                  ok=torch.tensor(1))


def test_launcher_takes_the_sentinel_staging_and_profile_flags(tmp_path):
    """The DLRM launcher parses --anomaly-policy, --stage-dataset and
    --profile-dir (the JAX spellings), guards its steps with the
    sentinel, and writes a trace of its timed loop; a poisoned step under
    skip_step leaves the run finite."""
    from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
    args = ["--device", "cpu", "-b", "16", "-e", "1", "--lr", "0.05",
            "--arch-embedding-size", "64-64-64-64",
            "--arch-sparse-feature-size", "8", "--arch-mlp-bot", "4-16-8",
            "--arch-mlp-top", "40-16-1", "--anomaly-policy", "skip_step",
            "--stage-dataset", "never", "--profile-dir",
            str(tmp_path / "prof")]
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={3})) as plan:
        out = launcher.main(args)
    m = out["model"]
    assert plan.fired == [("nan_grad", 3)]
    assert (m.config.anomaly_policy, m.config.stage_dataset) == (
        "skip_step", "never")
    assert all(torch.isfinite(v).all() for p in m.params.values()
               for v in p.values())
    assert len(list((tmp_path / "prof").glob("trace-*.json"))) == 1
    with pytest.raises(pt.AnomalyError):
        with faults.active_plan(faults.FaultPlan(nan_grad_steps={0})):
            launcher.main(args[:-6] + ["--anomaly-policy", "raise"])
