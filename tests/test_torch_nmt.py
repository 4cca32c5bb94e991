"""The port's NMT slice against the JAX package, on the CPU.

``build_nmt`` at the size tests/test_examples.py trains it (vocab 64,
embed 32, hidden 32, 2 layers, seq 6, batch 4) is built in both
packages; the JAX model's weights cross into the port through
``params_from_jax``, both take the same three SGD steps (lr 0.1, sparse
categorical cross-entropy, accuracy and the sparse cross-entropy metric)
on the same numpy batches, and the trained weights come back through
``params_to_jax``. The slice's other ops are held to the JAX ops one by
one: ``Reverse``, ``Softmax``, ``Embedding(aggr="none")`` and the
touched-rows update of ``Embedding`` in every ``aggr``.

Tolerances, and why:

- forward probabilities: atol 1e-7 (fp32; the products sum in another
  order; measured 3.7e-9). Under bf16 compute: atol 2^-8 of the largest
  probability, since a sum that lands near the midpoint of two bf16
  values can round to the other one in one package (measured 2.3e-7
  of it).
- losses: rtol 1e-6 (measured 1.1e-7); accuracy sums: equal.
- parameters: every update within 1e-3 of the parameter's largest update
  (summation order over three steps; measured at most 2.5e-4), the two
  embedding tables within 5e-3: their updates are about 1e-5 against
  table values near 0.2, so the one rounding by which duplicate ids
  differ (the JAX CPU update adds them one after another into the row,
  (t + u1) + u2; the port sums them first, t + (u1 + u2); ROADMAP queue
  3) is about 1e-3 of an update (measured 1.6e-3).
- ``Embedding.sparse_sgd_update`` on its own: bitwise on distinct ids,
  atol 1e-7 with duplicates (the same one rounding, on values near 0.1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.nmt import build_nmt as jax_build_nmt
from dlrm_flexflow_tpu.parallel.mesh import make_mesh

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.models.nmt import build_nmt
from dlrm_flexflow_tpu_torch.ops.elementwise import Softmax
from dlrm_flexflow_tpu_torch.ops.linear import Linear
from dlrm_flexflow_tpu_torch.utils.weights import (params_from_jax,
                                                   params_to_jax)

V, E, HID, L, SEQ, BS, LR, STEPS = 64, 32, 32, 2, 6, 4, 0.1, 3
ARGS = dict(src_vocab=V, tgt_vocab=V, embed_dim=E, hidden=HID,
            num_layers=L, src_len=SEQ, tgt_len=SEQ)
METRICS = ["accuracy", "sparse_categorical_crossentropy"]


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _jax_nmt(compute_dtype="float32"):
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=3,
                               compute_dtype=compute_dtype))
    jax_build_nmt(m, **ARGS)
    m.compile(ff.SGDOptimizer(lr=LR), "sparse_categorical_crossentropy",
              METRICS, mesh=_mesh())
    m.init_layers()
    return m


def _port_nmt(params_np=None, **cfg):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu", **cfg))
    build_nmt(m, **ARGS)
    m.compile(SGDOptimizer(lr=LR), "sparse_categorical_crossentropy",
              METRICS)
    if params_np is None:
        m.init_layers()
    else:
        m.swap_params(params_from_jax(m, params_np))
    return m


def _batch(step, n=BS):
    r = np.random.RandomState(30 + step)
    x = {k: r.randint(0, V, (n, SEQ)).astype(np.int32)
         for k in ("src", "tgt")}
    x["label"] = r.randint(0, V, (n, SEQ)).astype(np.int32)
    return x


@pytest.fixture(scope="module")
def trained():
    """Both packages after STEPS steps from the same weights."""
    jm = _jax_nmt()
    p0 = jax.tree.map(np.asarray, jm.params)
    pm = _port_nmt(p0)
    x = _batch(99)
    x.pop("label")
    probs = (np.asarray(jm.forward_batch(x)), pm.forward_batch(x).numpy())
    mj, mp = [], []
    for s in range(STEPS):
        mj.append({k: float(v) for k, v in jm.train_batch(_batch(s)).items()})
        mp.append({k: float(v) for k, v in pm.train_batch(_batch(s)).items()})
    return dict(p0=p0, probs=probs, mj=mj, mp=mp, pm=pm,
                pj=jax.tree.map(np.asarray, jm.params),
                pp=params_to_jax(pm, pm.params))


def test_nmt_graph_matches_jax_op_for_op():
    jm = ff.FFModel(ff.FFConfig(batch_size=BS))
    jin, jout = jax_build_nmt(jm, **ARGS)
    pm = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
    pin, pout = build_nmt(pm, **ARGS)
    assert pin == jin and pout.shape == jout.shape == (BS * SEQ, V)
    jops = [(op.name, type(op).__name__, [t.shape for t in op.outputs])
            for op in jm.ops]
    pops = [(op.name, type(op).__name__, [t.shape for t in op.outputs])
            for op in pm.ops]
    assert pops == jops
    for jop, pop in zip(jm.ops, pm.ops):
        assert {k: tuple(d.shape) for k, d in pop.param_defs().items()} \
            == {k: tuple(d.shape) for k, d in jop.param_defs().items()}


def test_forward_probabilities_match_jax(trained):
    want, got = trained["probs"]
    assert got.shape == (BS * SEQ, V) and np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_losses_and_metric_sums_match_jax(trained):
    for mj, mp in zip(trained["mj"], trained["mp"]):
        assert set(mp) == set(mj)
        np.testing.assert_allclose(mp["loss"], mj["loss"], rtol=1e-6)
        assert mp["train_all"] == mj["train_all"] == BS * SEQ
        assert mp["train_correct"] == mj["train_correct"]
        # the metric reads the probabilities, not a second softmax of them
        np.testing.assert_allclose(mp["sparse_cce"], mj["sparse_cce"],
                                   rtol=1e-6)
        np.testing.assert_allclose(mp["sparse_cce"] / (BS * SEQ),
                                   mp["loss"], rtol=1e-5)


def test_updated_params_match_jax(trained):
    p0, pj, pp = trained["p0"], trained["pj"], trained["pp"]
    assert set(pp) == set(pj)
    assert [op.name for op in trained["pm"]._sparse_ops] \
        == ["src_embed", "tgt_embed"]
    for op in pj:
        frac = 5e-3 if op.endswith("_embed") else 1e-3
        for pn, want in pj[op].items():
            got = pp[op][pn]
            assert got.shape == want.shape, (op, pn)
            dj, dp = want - p0[op][pn], got - p0[op][pn]
            scale = np.abs(dj).max()
            assert scale > 0, (op, pn)
            np.testing.assert_allclose(dp, dj, rtol=0, atol=frac * scale,
                                       err_msg=f"{op}.{pn}")


def test_untouched_embedding_rows_stay_bitwise(trained):
    p0, pp = trained["p0"], trained["pp"]
    for op, key in (("src_embed", "src"), ("tgt_embed", "tgt")):
        ids = np.concatenate([_batch(s)[key].reshape(-1)
                              for s in range(STEPS)])
        untouched = np.setdiff1d(np.arange(V), ids)
        assert untouched.size > 0
        np.testing.assert_array_equal(pp[op]["kernel"][untouched],
                                      p0[op]["kernel"][untouched])


def test_bf16_forward_matches_jax():
    jm = _jax_nmt("bfloat16")
    pm = _port_nmt(jax.tree.map(np.asarray, jm.params),
                   compute_dtype="bfloat16")
    x = _batch(7)
    x.pop("label")
    want = np.asarray(jm.forward_batch(x)).astype(np.float32)
    got = pm.forward_batch(x).float().numpy()
    assert got.shape == (BS * SEQ, V) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -8 * np.abs(want).max())


def test_dense_embedding_update_matches_sparse():
    """``--dense-embedding-update``: the tables' gradients through
    autograd of the "none" gather, then a dense SGD step, against the
    touched-rows update: equal but for rows a batch looks up more than
    once (one rounding: the dense form scales the summed gradient)."""
    sparse = _port_nmt()
    dense = _port_nmt(sparse_embedding_update=False)
    dense.swap_params({op: {pn: v.clone() for pn, v in p.items()}
                       for op, p in sparse.params.items()})
    for s in range(2):
        ls = float(sparse.train_batch(_batch(s))["loss"])
        ld = float(dense.train_batch(_batch(s))["loss"])
        np.testing.assert_allclose(ld, ls, rtol=1e-6)
    assert dense._sparse_ops == [] and len(sparse._sparse_ops) == 2
    for op, p in sparse.params.items():
        for pn, v in p.items():
            torch.testing.assert_close(dense.params[op][pn], v, rtol=0,
                                       atol=1e-7)


def test_fit_trains_the_nmt_model():
    m = _port_nmt()
    data = _batch(0, 3 * BS)
    labels = data.pop("label")
    out = m.fit(data, labels, epochs=1, batch_size=BS, verbose=False)
    assert out["num_samples"] == 3 * BS
    assert out["metrics"]["train_all"] == 3 * BS * SEQ
    assert np.isfinite(out["metrics"]["sparse_cce"])


def test_weights_round_trip_unchanged():
    p0 = jax.tree.map(np.asarray, _jax_nmt().params)
    pm = _port_nmt(p0)
    back = params_to_jax(pm, pm.params)
    assert set(back) == set(p0)
    for op in p0:
        assert set(back[op]) == set(p0[op])
        for pn, v in p0[op].items():
            np.testing.assert_array_equal(back[op][pn], v)


def test_config_refuses_the_lstm_fallback_flag():
    with pytest.raises(NotImplementedError, match="pallas-lstm"):
        pt.FFConfig.parse_args(["--device", "cpu", "--no-pallas-lstm"])


# ---------------------------------------------------------------------
# the slice's ops one by one


def _pair(shape, dtype_j, dtype_p, build):
    """The same one-op graph in both packages: (JAX op, port op)."""
    jm = ff.FFModel(ff.FFConfig(batch_size=shape[0]))
    pm = pt.FFModel(pt.FFConfig(batch_size=shape[0], device="cpu"))
    jop = build(jm, jm.create_tensor(shape, dtype=dtype_j, name="x"))
    pop = build(pm, pm.create_tensor(shape, dtype=dtype_p, name="x"))
    return jm.get_layer_by_name(jop), pm.get_layer_by_name(pop)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_reverse_matches_jax(axis):
    jop, pop = _pair((3, 5, 4), jnp.float32, torch.float32,
                     lambda m, x: (m.reverse(x, axis, name="rev"),
                                   "rev")[1])
    x = np.random.RandomState(0).randn(3, 5, 4).astype(np.float32)
    want = np.asarray(jop.apply({}, [jnp.asarray(x)])[0])
    got = pop.apply({}, [torch.from_numpy(x)])[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_matches_jax(dtype):
    jop, pop = _pair((6, 9), jnp.float32, torch.float32,
                     lambda m, x: (m.softmax(x, name="sm"), "sm")[1])
    x = (np.random.RandomState(1).randn(6, 9) * 4).astype(np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, px = jx.astype(jnp.bfloat16), px.to(torch.bfloat16)
    want = np.asarray(jop.apply({}, [jx])[0])
    got = pop.apply({}, [px])[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_dense_softmax_lowers_to_linear_then_softmax():
    pm = pt.FFModel(pt.FFConfig(batch_size=2, device="cpu"))
    probs = pm.dense(pm.create_tensor((2, 3), name="x"), 4,
                     activation="softmax", name="out")
    jm = ff.FFModel(ff.FFConfig(batch_size=2))
    jm.dense(jm.create_tensor((2, 3), name="x"), 4, activation="softmax",
             name="out")
    assert [op.name for op in pm.ops] == [op.name for op in jm.ops] \
        == ["x", "out", "out_softmax"]
    assert isinstance(pm.ops[1], Linear) and isinstance(pm.ops[2], Softmax)
    pm.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
               ["accuracy"])
    assert pm._preds_tensor is probs
    assert pm._logits_tensor is pm.ops[1].outputs[0]
    pm.compile(SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"])
    assert pm._logits_tensor is probs


def _embedding_pair(aggr, rows=40, d=8, batch=5, slots=3):
    return _pair((batch, slots), jnp.int32, torch.int64,
                 lambda m, x: (m.embedding(x, rows, d, aggr=aggr,
                                           name="emb"), "emb")[1])


def test_embedding_none_forward_matches_jax():
    jop, pop = _embedding_pair("none")
    assert pop.outputs[0].shape == jop.outputs[0].shape == (5, 3, 8)
    table = np.random.RandomState(2).randn(40, 8).astype(np.float32)
    ids = np.random.RandomState(3).randint(-40, 80, size=(5, 3))
    want = np.asarray(jop.apply({"kernel": jnp.asarray(table)},
                                [jnp.asarray(ids, jnp.int32)])[0])
    got = pop.apply({"kernel": torch.from_numpy(table)},
                    [torch.from_numpy(ids)])[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("aggr", ["none", "sum", "avg"])
@pytest.mark.parametrize("dups", [False, True])
def test_embedding_sparse_update_matches_jax_op(aggr, dups):
    rows, d, batch, slots = 40, 8, 5, 3
    jop, pop = _embedding_pair(aggr, rows, d, batch, slots)
    assert pop.supports_sparse_update() and jop.supports_sparse_update()
    rng = np.random.RandomState(4)
    table = (rng.rand(rows, d).astype(np.float32) - 0.5) * 0.2
    if dups:
        ids = rng.randint(-rows, 2 * rows, size=(batch, slots))
        ids[:3, 0] = ids[0, 0]
    else:
        ids = rng.permutation(rows)[:batch * slots].reshape(batch, slots)
    ct_shape = pop.outputs[0].shape
    ct = rng.randn(*ct_shape).astype(np.float32)
    want = jop.sparse_sgd_update({"kernel": jnp.asarray(table)},
                                 [jnp.asarray(ids, jnp.int32)],
                                 jnp.asarray(ct), LR)["kernel"]
    params = {"kernel": torch.from_numpy(table.copy())}
    xs = [torch.from_numpy(ids)]
    outs, fwd = pop.apply_with_fwd(params, xs)
    assert fwd is None and outs[0].shape == ct_shape
    pop.sparse_sgd_update(params, xs, torch.from_numpy(ct), LR)
    got = params["kernel"].numpy()
    assert not np.array_equal(got, table)
    if dups:
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, np.asarray(want))
