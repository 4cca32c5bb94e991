"""The port's DLRM training step against the JAX package.

A shrunk ``DLRMConfig.random_benchmark()`` (8 tables × 4,096 rows ×
d=64, bag 1, the full 64-512-512-64 bottom and 576-1024-1024-1024-1 top
MLPs, batch 64) is built in both packages; the JAX model's weights cross
into the port through ``params_from_jax``, both take the same three SGD
steps on the same numpy batches, and the trained weights come back
through ``params_to_jax`` to be compared array by array, as their
updates (trained minus initial weights).

Tolerances, and why:

- loss per step: rtol 1e-6 — the MLPs' products sum in another fp32
  order in XLA and in PyTorch (measured about 1e-7).
- "cat" with the touched-rows update: every update within 1e-3 of the
  parameter's largest update. The JAX CPU step adds a row's duplicate
  lookups into the table one after another, (t + u1) + u2, where the
  port's kernels add t + (u1 + u2); the rest is summation order.
- fused "dot": every update within 10 % of the parameter's largest
  update. A relu unit whose pre-activation lies within fp32 rounding of
  zero takes the other branch in one package (one unit of the fused
  layer's and one of top_dense_0's 65,536 outputs flip on this batch),
  which changes that unit's gradient for that sample outright; the
  flip reaches every parameter below it (measured at most 6.1 %). The
  kernel backwards themselves are held to 1e-5 by test_torch_scatter.py.
- the dense-embedding form against the touched-rows form, both in the
  port: bitwise but for rows a batch looks up more than once, which
  differ by one rounding (the dense form scales the summed gradient,
  w - lr·(g1 + g2), the sparse form sums the scaled ones); untouched
  rows are bitwise equal.

The pieces: ``SGDOptimizer.update`` (momentum, nesterov, weight decay)
matches the JAX optimizer BITWISE (both write w - lr·d with the same
roundings); the three losses and the metrics match to rtol 1e-6 (the
batch means sum in another order).

Part 0: under bf16 compute the port's ``Linear`` gives the fp32 product
of the bf16-rounded operands, as JAX's ``preferred_element_type`` does —
held BITWISE on a case where rounding the product to bf16 first would
change the result — and the bf16 "cat" forward matches the JAX model.
"""

import json

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.core import losses as jax_losses
from dlrm_flexflow_tpu.core import metrics as jax_metrics
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core import losses, metrics
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.utils.weights import (params_from_jax,
                                                   params_to_jax)

T, D, BS, LR, STEPS = 8, 64, 64, 0.1, 3
ARCH = {
    "cat": dict(embedding_size=[4096] * T, sparse_feature_size=D,
                mlp_bot=[64, 512, 512, 64],
                mlp_top=[64 + T * D, 1024, 1024, 1024, 1],
                arch_interaction_op="cat"),
    "dot": dict(embedding_size=[4096] * T, sparse_feature_size=D,
                mlp_bot=[64, 512, 512, 64],
                mlp_top=[64 + (T + 1) * T // 2, 1024, 1024, 1024, 1],
                arch_interaction_op="dot"),
}


def _jax_model(mode, compute_dtype="float32"):
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=3,
                               compute_dtype=compute_dtype))
    jax_build_dlrm(m, JaxDLRMConfig(**ARCH[mode]),
                   fuse_interaction=mode == "dot")
    m.compile(ff.SGDOptimizer(lr=LR), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers()
    return m


def _port_model(mode, params_np=None, **cfg):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu", **cfg))
    build_dlrm(m, DLRMConfig(**ARCH[mode]), fuse_interaction=mode == "dot")
    m.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"])
    if params_np is None:
        m.init_layers()
    else:
        m.swap_params(params_from_jax(m, params_np))
    return m


def _batch(mode, step, n=BS):
    x, y = synthetic_batch(DLRMConfig(**ARCH[mode]), n, seed=20 + step)
    x["label"] = y
    return x


def _train(mode):
    """Both packages after STEPS steps from the same weights: (mode,
    initial JAX-layout weights, JAX losses, port losses, JAX weights,
    port weights in the JAX layout, the port model)."""
    jm = _jax_model(mode)
    p0 = jax.tree.map(np.asarray, jm.params)
    pm = _port_model(mode, p0)
    lj, lp = [], []
    for s in range(STEPS):
        lj.append(float(jm.train_batch(_batch(mode, s))["loss"]))
        lp.append(float(pm.train_batch(_batch(mode, s))["loss"]))
    return (mode, p0, lj, lp, jax.tree.map(np.asarray, jm.params),
            params_to_jax(pm, pm.params), pm)


@pytest.fixture(scope="module")
def runs():
    return {}


def _trained(runs, mode):
    if mode not in runs:
        runs[mode] = _train(mode)
    return runs[mode]


@pytest.fixture(params=["cat", "dot"])
def trained(request, runs):
    return _trained(runs, request.param)


def test_the_same_ops_take_the_sparse_update(trained):
    mode, *_, pm = trained
    want = ["emb_stack"] if mode == "cat" else []
    assert [op.name for op in pm._sparse_ops] == want


def test_loss_per_step_matches_jax(trained):
    _, _, lj, lp, *_ = trained
    assert all(np.isfinite(lp))
    np.testing.assert_allclose(lp, lj, rtol=1e-6)


def test_updated_params_match_jax(trained):
    mode, p0, _, _, pj, pp, _ = trained
    frac = 1e-3 if mode == "cat" else 0.1
    assert set(pp) == set(pj)
    for op in pj:
        for pn, want in pj[op].items():
            got = pp[op][pn]
            assert got.shape == want.shape, (op, pn)
            dj, dp = want - p0[op][pn], got - p0[op][pn]
            scale = np.abs(dj).max()
            assert scale > 0, (op, pn)
            np.testing.assert_allclose(dp, dj, rtol=0, atol=frac * scale,
                                       err_msg=f"{op}.{pn}")


def test_cat_untouched_rows_match_jax_bitwise(runs):
    mode, p0, _, _, pj, pp, _ = _trained(runs, "cat")
    ids = np.stack([_batch(mode, s)["sparse"] for s in range(STEPS)])
    touched = np.zeros((T, 4096), bool)
    for t in range(T):
        touched[t, ids[:, :, t].reshape(-1)] = True
    # the JAX layout packs rows two per 128-lane tile
    got = pp["emb_stack"]["kernel"].reshape(T, 4096, D)
    want = pj["emb_stack"]["kernel"].reshape(T, 4096, D)
    init = p0["emb_stack"]["kernel"].reshape(T, 4096, D)
    np.testing.assert_array_equal(got[~touched], want[~touched])
    np.testing.assert_array_equal(got[~touched], init[~touched])


def test_dense_embedding_update_matches_sparse():
    """The bag's autograd backward (kernel 3 on a zero table) plus a
    dense SGD step against the touched-rows update."""
    sparse = _port_model("cat")
    params = {op: {pn: v.clone() for pn, v in p.items()}
              for op, p in sparse.params.items()}
    dense = _port_model("cat", sparse_embedding_update=False)
    dense.swap_params(params)
    init = sparse.params["emb_stack"]["kernel"].clone()
    for s in range(STEPS):
        ls = float(sparse.train_batch(_batch("cat", s))["loss"])
        ld = float(dense.train_batch(_batch("cat", s))["loss"])
        np.testing.assert_allclose(ld, ls, rtol=1e-6)
    assert dense._sparse_ops == [] and len(sparse._sparse_ops) == 1
    got = dense.params["emb_stack"]["kernel"]
    want = sparse.params["emb_stack"]["kernel"]
    changed = (want != init).any(dim=-1)
    assert changed.sum() > 0
    assert torch.equal(got[~changed], init[~changed])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-8)
    for op, p in sparse.params.items():
        if op != "emb_stack":
            for pn, v in p.items():
                torch.testing.assert_close(dense.params[op][pn], v,
                                           rtol=1e-6, atol=1e-9)


def test_fit_trains_every_batch_and_the_remainder():
    n = 2 * BS + 22
    data = _batch("cat", 0, n)
    labels = data.pop("label")
    a = _port_model("cat")
    b = _port_model("cat")
    b.swap_params({op: {pn: v.clone() for pn, v in p.items()}
                   for op, p in a.params.items()})
    out = a.fit(data, labels, epochs=2, batch_size=BS, verbose=False)
    assert set(out) == {"elapsed", "throughput", "num_samples",
                        "rollbacks", "metrics"}
    assert out["rollbacks"] == 0
    assert out["num_samples"] == 2 * n
    assert out["metrics"]["train_all"] == n
    assert np.isfinite(out["metrics"]["mse"])
    for _ in range(2):
        for lo, hi in ((0, BS), (BS, 2 * BS), (2 * BS, n)):
            batch = {k: v[lo:hi] for k, v in data.items()}
            batch["label"] = labels[lo:hi]
            b.train_batch(batch)
    for op, p in a.params.items():
        for pn, v in p.items():
            assert torch.equal(v, b.params[op][pn]), (op, pn)


def test_fit_refuses_checkpoints(tmp_path):
    """Until checkpoints were ported this test pinned the raise of
    ``fit(checkpoint_dir=...)``; now that call writes a snapshot and a
    manifest, as the JAX ``fit`` does (tests/test_torch_checkpoint.py
    holds the files to the JAX package), while the fused supersteps,
    still not ported, keep raising."""
    m = _port_model("cat")
    data = _batch("cat", 0)
    labels = data.pop("label")
    ckpt = tmp_path / "ckpt"
    m.fit(data, labels, checkpoint_dir=str(ckpt), verbose=False)
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "ckpt-00000001.npz", "manifest.json"]
    (entry,) = json.loads((ckpt / "manifest.json").read_text())["entries"]
    assert (entry["step"], entry["loader_state"]) == (
        1, {"epoch": 1, "batch": 0})
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        pt.FFConfig.parse_args(["--device", "cpu", "--superstep", "4"])


def test_stateful_sgd_on_a_sparse_op_raises():
    """compile() without an optimizer takes SGD with the config's weight
    decay (1e-4), as the JAX compile: a stateful touched-rows update.
    Until the stateful update was ported this test pinned the
    NotImplementedError its first step raised; now both compiles, the
    default and momentum 0.9, take a step on the stateful touched-rows
    path (the table selected for the sparse update, its rows updated
    through ``sparse_opt_update``, never ``sparse_sgd_update``), and
    only the rows the batch looked up move. tests/test_torch_optimizers.py
    holds the values to the JAX package."""
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
    build_dlrm(m, DLRMConfig(**ARCH["cat"]))
    m.compile()
    assert (m.optimizer.lr, m.optimizer.weight_decay) == (0.01, 1e-4)
    m.init_layers()
    op = m.get_layer_by_name("emb_stack")
    calls = []
    op.sparse_opt_update = lambda *a, _f=op.sparse_opt_update, **k: (
        calls.append("opt"), _f(*a, **k))[1]
    op.sparse_sgd_update = lambda *a, **k: calls.append("sgd")
    batch = _batch("cat", 0)
    touched = np.zeros((T, 4096), bool)
    for t in range(T):
        touched[t, batch["sparse"][:, t].reshape(-1) % 4096] = True
    for opt in (None, SGDOptimizer(lr=0.01, momentum=0.9)):
        if opt is not None:
            m.compile(opt)
        before = m.params["emb_stack"]["kernel"].clone()
        assert np.isfinite(float(m.train_batch(batch)["loss"]))
        assert [o.name for o in m._sparse_ops] == ["emb_stack"]
        assert m._stateful_sparse()
        after = m.params["emb_stack"]["kernel"]
        moved = (after != before).any(dim=-1).numpy()
        assert moved.any() and not (moved & ~touched).any()
        if opt is not None:
            v = m.opt_state["v"]["emb_stack"]["kernel"]
            assert not v[torch.from_numpy(~touched)].any()
    assert calls == ["opt", "opt"]


def test_config_training_flags():
    cfg = pt.FFConfig.parse_args(["--device", "cpu", "-e", "3", "--wd",
                                  "0", "--dense-embedding-update"])
    assert (cfg.epochs, cfg.weight_decay, cfg.sparse_embedding_update) \
        == (3, 0.0, False)
    assert pt.FFConfig(device="cpu").sparse_embedding_update


@pytest.mark.parametrize("loss", ["mse", "cce", "scce"])
def test_losses_and_metrics_match_jax(loss):
    rng = np.random.RandomState(4)
    logits = rng.randn(12, 5).astype(np.float32)
    if loss == "scce":
        labels = rng.randint(0, 5, size=(12, 1))
    elif loss == "cce":
        labels = np.eye(5, dtype=np.float32)[rng.randint(0, 5, size=12)]
    else:
        labels = rng.rand(12, 5).astype(np.float32)
    name = losses.canonical_loss(loss)
    assert name == jax_losses.canonical_loss(loss)
    want = float(jax_losses.loss_fn(name)(logits, labels))
    got = float(losses.loss_fn(name)(torch.from_numpy(logits),
                                     torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    names = ["acc", "mse", "rmse", "mae"] + (["scce"] if loss == "scce"
                                              else ["cce"])
    assert metrics.canonical_metrics(names) \
        == jax_metrics.canonical_metrics(names)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = jax_metrics.compute_metrics(
        jax_metrics.canonical_metrics(names), name, probs, labels)
    got = metrics.compute_metrics(metrics.canonical_metrics(names), name,
                                  torch.from_numpy(probs),
                                  torch.from_numpy(labels))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, err_msg=k)


def _bf16_linear_models(w, b):
    jm = ff.FFModel(ff.FFConfig(batch_size=2, compute_dtype="bfloat16"))
    jm.dense(jm.create_tensor((2, 2), name="dense"), 3, name="lin")
    jm.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
               mesh=make_mesh(devices=jax.devices()[:1]))
    jm.init_layers()
    old = jm.params["lin"]
    jm.params = {"lin": {"kernel": jax.device_put(w, old["kernel"].sharding),
                         "bias": jax.device_put(b, old["bias"].sharding)}}
    pm = pt.FFModel(pt.FFConfig(batch_size=2, compute_dtype="bfloat16",
                                device="cpu"))
    pm.dense(pm.create_tensor((2, 2), name="dense"), 3, name="lin")
    pm.compile(SGDOptimizer(lr=0.1))
    pm.swap_params(params_from_jax(pm, {"lin": {"kernel": w, "bias": b}}))
    return jm, pm


def test_bf16_linear_keeps_the_fp32_product_bitwise():
    """Small integers make every fp32 sum exact in any order. 16·16 + 1·1
    = 257 needs 9 significant bits: rounded to bf16 first it is 256, and
    256 + 0.75 rounds to 256 in bf16, where the fp32 product gives
    257 + 0.75 -> 258."""
    x = np.array([[16, 1], [3, 2]], np.float32)
    w = np.array([[16, 1, 3], [1, 16, 5]], np.float32)
    b = np.array([0.75, 0.5, 0.25], np.float32)
    jm, pm = _bf16_linear_models(w, b)
    want = np.asarray(jm.forward_batch({"dense": x})).astype(np.float32)
    got = pm.forward_batch({"dense": x})
    assert got.dtype == torch.bfloat16
    assert want[0, 0] == 258.0
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bf16_cat_forward_matches_jax():
    """The whole "cat" model under bf16 compute. Each layer's fp32 sum
    runs in another order, and a sum that lands near the midpoint of two
    bf16 values can round to the other one: tolerance two bf16 steps of
    the sigmoid output's size, 2·2^-8 relative."""
    jm = _jax_model("cat", compute_dtype="bfloat16")
    pm = _port_model("cat", jax.tree.map(np.asarray, jm.params),
                     compute_dtype="bfloat16")
    x = _batch("cat", 7)
    x.pop("label")
    want = np.asarray(jm.forward_batch(x)).astype(np.float32)
    got = pm.forward_batch(x).float().numpy()
    assert got.shape == (BS, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("momentum,nesterov,wd", [
    (0.0, False, 0.0), (0.0, False, 1e-2), (0.9, False, 0.0),
    (0.9, True, 1e-2)])
def test_sgd_update_matches_jax(momentum, nesterov, wd):
    """Three dense updates, in place in the port, functional in JAX."""
    rng = np.random.RandomState(9)
    shapes = {"a": {"kernel": (5, 7), "bias": (7,)}, "b": {"kernel": (3,)}}
    init = {op: {pn: rng.randn(*s).astype(np.float32)
                 for pn, s in p.items()} for op, p in shapes.items()}
    grads = [{op: {pn: rng.randn(*s).astype(np.float32)
                   for pn, s in p.items()} for op, p in shapes.items()}
             for _ in range(3)]
    jopt = ff.SGDOptimizer(lr=0.1, momentum=momentum, nesterov=nesterov,
                           weight_decay=wd)
    jp = jax.tree.map(jax.numpy.asarray, init)
    js = jopt.init_state(jp)
    popt = SGDOptimizer(lr=0.1, momentum=momentum, nesterov=nesterov,
                        weight_decay=wd)
    pp = {op: {pn: torch.from_numpy(v.copy()) for pn, v in p.items()}
          for op, p in init.items()}
    ps = popt.init_state(pp)
    for g in grads:
        jp, js = jopt.update(jp, jax.tree.map(jax.numpy.asarray, g), js)
        popt.update(pp, {op: {pn: torch.from_numpy(v) for pn, v in p.items()}
                         for op, p in g.items()}, ps)
    assert popt.sparse_slab_names() == jopt.sparse_slab_names()
    for op, p in init.items():
        for pn in p:
            np.testing.assert_array_equal(pp[op][pn].numpy(),
                                          np.asarray(jp[op][pn]))


@pytest.mark.parametrize("aggr", ["sum", "avg"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dups", [False, True])
def test_sparse_sgd_update_matches_jax_op(aggr, residual, dups):
    """``EmbeddingBagStacked.sparse_sgd_update`` on its own, bag 3, with a
    storage permutation: the write-only kernel's plain version (with the
    residual of ``apply_with_fwd``) and the read-modify-write one
    (without) against the JAX op's update. Distinct ids: bitwise. With
    duplicates: within 1e-7 — the JAX CPU update adds them one after
    another into the row, the port sums them first."""
    Tn, rows, d, batch, bag, order = 4, 96, 64, 6, 3, (2, 0, 3, 1)
    jm = ff.FFModel(ff.FFConfig(batch_size=batch, seed=5))
    s = jm.create_tensor((batch, Tn, bag), dtype=jax.numpy.int32,
                         name="sparse")
    jm.embedding_stacked(s, Tn, rows, d, aggr=aggr, name="emb_stack")
    jop = jm.get_layer_by_name("emb_stack")
    jop.set_table_order(order)
    jm.compile(ff.SGDOptimizer(lr=LR), "mean_squared_error", ["mse"],
               mesh=make_mesh(devices=jax.devices()[:1]))
    jm.init_layers()
    pm = pt.FFModel(pt.FFConfig(batch_size=batch, device="cpu"))
    s = pm.create_tensor((batch, Tn, bag), dtype=torch.int64, name="sparse")
    pm.embedding_stacked(s, Tn, rows, d, aggr=aggr, name="emb_stack")
    pop = pm.get_layer_by_name("emb_stack")
    pop.set_table_order(order)
    pm.compile(SGDOptimizer(lr=LR))
    pm.swap_params(params_from_jax(pm, jax.tree.map(np.asarray, jm.params)))

    rng = np.random.RandomState(11)
    if dups:
        idx = rng.randint(-rows, 2 * rows, size=(batch, Tn, bag))
        idx[:3, :, 0] = idx[0, :, 0]
    else:
        idx = np.stack([rng.permutation(rows)[:batch * bag].reshape(
            batch, bag) for _ in range(Tn)], axis=1)
    ct = rng.randn(batch, Tn, d).astype(np.float32)
    want = jop.sparse_sgd_update(jm.params["emb_stack"],
                                 [jax.numpy.asarray(idx, jax.numpy.int32)],
                                 jax.numpy.asarray(ct), LR)["kernel"]
    xs = [torch.from_numpy(idx.astype(np.int64))]
    fwd = pop.apply_with_fwd(pm.params["emb_stack"], xs)[1] \
        if residual else None
    pop.sparse_sgd_update(pm.params["emb_stack"], xs, torch.from_numpy(ct),
                          LR, fwd=fwd)
    got = params_to_jax(pm, pm.params)["emb_stack"]["kernel"]
    if dups:
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))
