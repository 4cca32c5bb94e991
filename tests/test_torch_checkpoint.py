"""The port's checkpoints against the JAX package's: one file format,
read and written by both.

The small "cat" DLRM of tests/test_torch_optimizers.py (8 tables × 64
rows × d = 8, bag 2, lane-packed by the JAX op to (8, 4, 128); batch 16)
under plain SGD, SGD with momentum 0.9 and weight decay 1e-4, and Adam.

- ``config_fingerprint`` equals the JAX package's digest on the "cat"
  graph (fp32 and bf16) and the fused "dot" graph, so neither package
  skips the other's snapshots as foreign.
- JAX trains 2 steps and saves; the port restores (BITWISE equal to the
  JAX state, parameters, optimizer state and step) and both train 2
  more steps on the same batches; the other way round through both
  managers. Tolerances after the 2 further steps, as
  tests/test_torch_optimizers.py's training test states them: the loss
  within rtol 1e-6 and every parameter's and slab's change within 1e-3
  of its largest change (1e-2 under Adam), since the MLPs' products sum
  in another fp32 order in XLA and in PyTorch.
- A JAX ``fit(checkpoint_dir=...)`` directory whose two newest snapshots
  are torn is resumed by the port's ``fit`` from the one before, at its
  recorded epoch and batch, to the JAX run's end (the same tolerances).
- The manager skips torn, corrupt, missing and foreign snapshots
  (injected through the port's ``utils.faults``), keeps the last K,
  sweeps orphan temp files, and an aborted write leaves the previous
  snapshot as it was.
- A port ``fit`` stopped by a crash after a snapshot and resumed by a
  fresh model equals an uninterrupted one BITWISE on the CPU.
"""

import json

import numpy as np
import pytest

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh
from dlrm_flexflow_tpu.utils import checkpoint as jax_ckpt

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import (AdamOptimizer,
                                                     SGDOptimizer)
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.utils import checkpoint as ckpt
from dlrm_flexflow_tpu_torch.utils import faults
from dlrm_flexflow_tpu_torch.utils.weights import (opt_state_to_jax,
                                                   params_from_jax,
                                                   params_to_jax)

SMALL = dict(embedding_size=[64] * 8, sparse_feature_size=8,
             embedding_bag_size=2, mlp_bot=[4, 16, 8], mlp_top=[72, 16, 1])
DOT = dict(SMALL, arch_interaction_op="dot", mlp_top=[8 + 36, 16, 1])
BS = 16
OPTIMIZERS = {
    "sgd": (lambda: ff.SGDOptimizer(lr=0.1), lambda: SGDOptimizer(lr=0.1)),
    "momentum": (lambda: ff.SGDOptimizer(lr=0.1, momentum=0.9,
                                         weight_decay=1e-4),
                 lambda: SGDOptimizer(lr=0.1, momentum=0.9,
                                      weight_decay=1e-4)),
    "adam": (lambda: ff.AdamOptimizer(alpha=0.01),
             lambda: AdamOptimizer(alpha=0.01)),
}
NAMES = list(OPTIMIZERS)


def _jax_model(name, arch=SMALL, fuse=False, compute_dtype="float32"):
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=5,
                               compute_dtype=compute_dtype))
    jax_build_dlrm(m, JaxDLRMConfig(**arch), fuse_interaction=fuse)
    m.compile(OPTIMIZERS[name][0](), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers()
    return m


def _port_model(name, arch=SMALL, fuse=False, seed=0, **cfg):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu", seed=seed,
                               **cfg))
    build_dlrm(m, DLRMConfig(**arch), fuse_interaction=fuse)
    m.compile(OPTIMIZERS[name][1](), "mean_squared_error", ["mse"])
    m.init_layers()
    return m


def _batch(step, n=BS):
    x, y = synthetic_batch(DLRMConfig(**SMALL), n, seed=40 + step)
    x["label"] = y
    return x


def _jax_state(jm):
    return (jax.tree.map(np.array, jm.params),
            jax.tree.map(np.array, jm.opt_state))


def _port_state(pm):
    return (jax.tree.map(np.array, params_to_jax(pm, pm.params)),
            jax.tree.map(np.array, opt_state_to_jax(pm, pm.opt_state)))


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


def _assert_trained_alike(name, jm, pm, start, lj, lp):
    """The 2 further steps of both packages from the same state `start`
    (JAX layout): losses, and every parameter's and slab's change."""
    np.testing.assert_allclose(lp, lj, rtol=1e-6)
    frac = 1e-2 if name == "adam" else 1e-3
    (pj, sj), (pp, sp) = _jax_state(jm), _port_state(pm)
    trees = [(pj, pp, start[0])]
    trees += [(sj[k], sp[k], start[1][k]) for k in sj if k != "step"]
    if name == "adam":
        assert int(sp["step"]) == int(sj["step"]) == int(start[1]["step"]) + 2
    for tj, tp, t0 in trees:
        for op in tj:
            for pn, want in tj[op].items():
                dj, dp = want - t0[op][pn], tp[op][pn] - t0[op][pn]
                scale = np.abs(dj).max()
                assert scale > 0, (op, pn)
                np.testing.assert_allclose(dp, dj, rtol=0,
                                           atol=frac * scale,
                                           err_msg=f"{op}.{pn}")


def _train(m, steps):
    return [float(m.train_batch(_batch(s))["loss"]) for s in steps]


# ---- the fingerprint ------------------------------------------------------
@pytest.mark.parametrize("graph,dtype", [("cat", "float32"),
                                         ("cat", "bfloat16"),
                                         ("dot", "float32")])
def test_fingerprint_matches_jax(graph, dtype):
    arch, fuse = (DOT, True) if graph == "dot" else (SMALL, False)
    jm = _jax_model("sgd", arch, fuse, dtype)
    pm = _port_model("sgd", arch, fuse, compute_dtype=dtype)
    assert ckpt.config_fingerprint(pm) == jax_ckpt.config_fingerprint(jm)
    other = _port_model("sgd", dict(arch, mlp_bot=[4, 32, 8]), fuse,
                        compute_dtype=dtype)
    assert ckpt.config_fingerprint(other) != ckpt.config_fingerprint(pm)


# ---- cross-loading ---------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_port_restores_a_jax_checkpoint(name, tmp_path):
    jm = _jax_model(name)
    _train(jm, range(2))
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(jm, path)
    pm = _port_model(name, seed=9)           # other weights, no state yet
    ckpt.restore_checkpoint(pm, path)
    start = _jax_state(jm)
    _assert_trees_equal(_port_state(pm), start)
    assert pm._step == jm._step == 2
    lj, lp = _train(jm, range(2, 4)), _train(pm, range(2, 4))
    _assert_trained_alike(name, jm, pm, start, lj, lp)


@pytest.mark.parametrize("name", NAMES)
def test_jax_restores_a_port_checkpoint(name, tmp_path):
    j0 = _jax_model(name)
    pm = _port_model(name)
    pm.swap_params(params_from_jax(pm, jax.tree.map(np.asarray, j0.params)))
    _train(pm, range(2))
    ckpt.CheckpointManager(str(tmp_path)).save(pm, {"epoch": 0, "batch": 2})
    jm = _jax_model(name)
    jm.init_layers(seed=11)                  # other weights
    entry = jax_ckpt.CheckpointManager(str(tmp_path)).restore_latest(jm)
    assert entry is not None and entry["step"] == 2
    assert entry["loader_state"] == {"epoch": 0, "batch": 2}
    start = _port_state(pm)
    _assert_trees_equal(_jax_state(jm), start)
    assert jm._step == 2
    lj, lp = _train(jm, range(2, 4)), _train(pm, range(2, 4))
    _assert_trained_alike(name, jm, pm, start, lj, lp)


def test_port_fit_resumes_a_jax_fit_directory(tmp_path):
    """JAX fits 6 batches with a snapshot every 2 steps; its snapshots of
    steps 4 and 6 are then torn, so the port's fit resumes from step 2,
    at epoch 0, batch 2, and trains batches 2-5 to the JAX run's end."""
    name = "momentum"
    data = _batch(0, 6 * BS)
    labels = data.pop("label")
    jm = _jax_model(name)
    d = tmp_path / "ckpt"
    jm.fit(data, labels, epochs=1, batch_size=BS, verbose=False,
           checkpoint_dir=str(d), save_every=2, keep_last=3)
    entries = json.loads((d / "manifest.json").read_text())["entries"]
    assert [e["step"] for e in entries] == [2, 4, 6]
    assert entries[0]["loader_state"] == {"epoch": 0, "batch": 2}
    for e in entries[1:]:
        with open(d / e["file"], "r+b") as f:
            f.truncate(64)
    with np.load(d / entries[0]["file"]) as z:
        start = (jax_ckpt._unflatten({k[7:]: z[k] for k in z.files
                                      if k.startswith("params/")}),
                 jax_ckpt._unflatten({k[4:]: z[k] for k in z.files
                                      if k.startswith("opt/")}))
    pm = _port_model(name, seed=9)
    out = pm.fit(data, labels, epochs=1, batch_size=BS, verbose=False,
                 checkpoint_dir=str(d), keep_last=3)
    assert out["num_samples"] == 4 * BS
    assert pm._step == jm._step == 6
    frac = 1e-3
    (pj, sj), (pp, sp) = _jax_state(jm), _port_state(pm)
    for tj, tp, t0 in ((pj, pp, start[0]), (sj["v"], sp["v"], start[1]["v"])):
        for op in tj:
            for pn, want in tj[op].items():
                dj, dp = want - t0[op][pn], tp[op][pn] - t0[op][pn]
                np.testing.assert_allclose(
                    dp, dj, rtol=0, atol=frac * np.abs(dj).max(),
                    err_msg=f"{op}.{pn}")
    # the port's final snapshot replaced the torn one of step 6
    entry = ckpt.CheckpointManager(str(d), 3).latest_valid(
        ckpt.config_fingerprint(pm))
    assert entry["step"] == 6 and entry["loader_state"] == {"epoch": 1,
                                                            "batch": 0}


# ---- the manager -----------------------------------------------------------
TINY = dict(embedding_size=[32] * 2, sparse_feature_size=4,
            embedding_bag_size=1, mlp_bot=[4, 8, 4], mlp_top=[12, 8, 1])


def _tiny(name="momentum", seed=0, arch=TINY):
    return _port_model(name, arch, seed=seed)


def _tiny_batch(step):
    x, y = synthetic_batch(DLRMConfig(**TINY), BS, seed=60 + step)
    x["label"] = y
    return x


def _snapshots(mgr, model, steps):
    """Train one step and save, `steps` times; returns each snapshot's
    state in the JAX layout."""
    out = []
    for _ in range(steps):
        model.train_batch(_tiny_batch(model._step))
        mgr.save(model, {"epoch": 0, "batch": model._step})
        out.append(_port_state(model))
    return out


def test_manager_skips_torn_corrupt_and_foreign(tmp_path):
    m = _tiny()
    mgr = ckpt.CheckpointManager(str(tmp_path), keep_last=5)
    states = _snapshots(mgr, m, 2)                        # steps 1, 2
    with faults.active_plan(faults.FaultPlan(truncate_checkpoints=1)) as p:
        _snapshots(mgr, m, 1)                             # step 3, torn
    assert [h for h, _ in p.fired] == ["truncate"]
    f2 = tmp_path / "ckpt-00000002.npz"                   # bit rot
    raw = bytearray(f2.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    f2.write_bytes(bytes(raw))
    foreign = _tiny(arch=dict(TINY, mlp_bot=[4, 16, 4]))
    foreign._step = 3
    _snapshots(mgr, foreign, 1)                           # step 4, foreign
    assert [e["step"] for e in mgr.entries()] == [1, 2, 3, 4]
    fp = ckpt.config_fingerprint(m)
    assert mgr.latest_valid(fp)["step"] == 1
    assert mgr.latest_valid()["step"] == 4
    fresh = _tiny(seed=3)
    entry = mgr.restore_latest(fresh)
    assert entry["step"] == 1 and fresh._step == 1
    _assert_trees_equal(_port_state(fresh), states[0])


def test_manager_aborted_write_keeps_the_previous(tmp_path):
    m = _tiny()
    mgr = ckpt.CheckpointManager(str(tmp_path), keep_last=3)
    (first,) = _snapshots(mgr, m, 1)
    m.train_batch(_tiny_batch(1))
    with faults.active_plan(faults.FaultPlan(abort_writes=1)):
        with pytest.raises(IOError, match="injected"):
            mgr.save(m, {"epoch": 0, "batch": 2})
        mgr.save_async(m)            # the budget is spent: this one lands
        mgr.wait()
    with faults.active_plan(faults.FaultPlan(abort_writes=1)):
        m.train_batch(_tiny_batch(2))
        mgr.save_async(m)
        with pytest.raises(IOError, match="injected"):
            mgr.wait()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt-00000001.npz", "ckpt-00000002.npz",
                     "manifest.json"]
    fresh = _tiny(seed=3)
    ckpt.restore_checkpoint(fresh, str(tmp_path / "ckpt-00000001.npz"))
    _assert_trees_equal(_port_state(fresh), first)


def test_manager_keeps_the_last_k_and_sweeps_orphans(tmp_path):
    m = _tiny()
    mgr = ckpt.CheckpointManager(str(tmp_path), keep_last=2)
    _snapshots(mgr, m, 4)
    assert [e["step"] for e in mgr.entries()] == [3, 4]
    orphan = tmp_path / "ckpt-00000009.npz.tmp-4242"
    orphan.write_bytes(b"half a snapshot")
    mgr = ckpt.CheckpointManager(str(tmp_path), keep_last=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt-00000003.npz", "ckpt-00000004.npz", "manifest.json"]
    (tmp_path / "ckpt-00000004.npz").unlink()               # listed, gone
    assert mgr.restore_latest(_tiny(seed=3))["step"] == 3
    (tmp_path / "manifest.json").write_text("{torn")
    assert mgr.entries() == [] and mgr.restore_latest(_tiny()) is None
    with pytest.raises(ValueError, match="keep_last"):
        ckpt.CheckpointManager(str(tmp_path), keep_last=0)


def test_restore_checks_the_optimizer_and_params_only(tmp_path):
    m = _tiny("sgd")
    m.train_batch(_tiny_batch(0))
    path = str(tmp_path / "sgd.npz")
    ckpt.save_checkpoint(m, path)
    adam = _tiny("adam", seed=3)
    adam.train_batch(_tiny_batch(0))
    before = _port_state(adam)
    with pytest.raises(ValueError, match="optimizer"):
        ckpt.restore_checkpoint(adam, path)
    _assert_trees_equal(_port_state(adam), before)    # nothing replaced
    ckpt.restore_checkpoint(adam, path, params_only=True)
    _assert_trees_equal(_port_state(adam)[0], _port_state(m)[0])
    _assert_trees_equal(_port_state(adam)[1], before[1])
    flat = ckpt._model_flat(m)
    other = _tiny("sgd", seed=4)
    ckpt.restore_from_flat(other, flat)
    _assert_trees_equal(_port_state(other), _port_state(m))
    w = ckpt.get_weights(m, "bot_dense_0")
    ckpt.set_weights(other, "bot_dense_0", {"bias": w["bias"] + 1})
    np.testing.assert_array_equal(
        other.params["bot_dense_0"]["bias"].numpy(), w["bias"] + 1)
    with pytest.raises(ValueError, match="shape"):
        ckpt.set_weights(other, "bot_dense_0", {"bias": w["bias"][:2]})


# ---- fit: interrupted, then resumed ---------------------------------------
class _Crash(Exception):
    pass


@pytest.mark.parametrize("crash_at", [5, 8])
@pytest.mark.parametrize("name", NAMES)
def test_interrupted_fit_resumes_bitwise(name, crash_at, tmp_path):
    """2 epochs of 5 batches and a remainder of 6 samples (12 steps),
    a snapshot every 3 steps. The interrupted run crashes as step
    ``crash_at`` begins: 5 resumes inside epoch 0 at batch 3, 8 resumes
    at the start of epoch 1 (after the remainder). A fresh model with
    other weights resumes from the directory. The interrupted and the
    resumed runs take their batches through the prefetch ring
    (``stage_dataset="never"``), the uninterrupted one stages the whole
    dataset, so the two paths are held to each other too."""
    data = _batch(0, 5 * BS + 6)
    labels = data.pop("label")
    kw = dict(epochs=2, batch_size=BS, verbose=False)
    whole = _port_model(name)
    whole.fit(data, labels, **kw)

    broken = _port_model(name, stage_dataset="never")
    real, calls = broken.train_batch_staged, []

    def crashing(staged, **kw):
        calls.append(1)
        if len(calls) == crash_at:
            raise _Crash()
        return real(staged, **kw)

    broken.train_batch_staged = crashing
    d = str(tmp_path / "ckpt")
    with pytest.raises(_Crash):
        broken.fit(data, labels, checkpoint_dir=d, save_every=3,
                   keep_last=2, **kw)
    (last,) = [e for e in ckpt.CheckpointManager(d, 2).entries()
               if e["step"] == 3 * ((crash_at - 1) // 3)]
    want = {5: {"epoch": 0, "batch": 3}, 8: {"epoch": 1, "batch": 0}}
    assert last["loader_state"] == want[crash_at]

    resumed = _port_model(name, seed=7, stage_dataset="never")
    out = resumed.fit(data, labels, checkpoint_dir=d, save_every=3,
                      keep_last=2, **kw)
    assert resumed._step == whole._step == 12
    assert out["num_samples"] == len(labels) * 2 - (
        3 * BS if crash_at == 5 else len(labels))
    _assert_trees_equal(_port_state(resumed), _port_state(whole))
