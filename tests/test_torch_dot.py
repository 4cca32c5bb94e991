"""The unfused "dot" interaction against the JAX package: ``BatchMatmul``,
``Transpose`` and ``IndexSelect``, and the DLRM graph built from them.

Inputs come from numpy seeds; the DLRM's weights cross from the JAX
model by ``params_from_jax``.

Tolerances, and why:

- ``BatchMatmul`` forward and gradients under fp32 compute: rtol 1e-5,
  atol 1e-6 — both are fp32 products summed in another order by XLA and
  by PyTorch. Under bf16 compute the forward keeps that tolerance (the
  operands are rounded to bf16 alike, their products are exact in fp32,
  only the sum order differs), and the gradients, rounded to bf16 by the
  cast's transpose in both packages, are held to one bf16 rounding
  (rtol 2^-7, atol 1e-6): an fp32 sum order can move a value across a
  bf16 rounding boundary.
- ``Transpose`` and ``IndexSelect``: bitwise, forward and gradient (a
  permutation and a gather; the gather's gradient adds at most one
  value into each place here).
- the DLRM: the forward to rtol 1e-5; 3 SGD steps, losses to rtol 1e-5
  and every parameter's update (trained minus initial weight) within
  1e-3 of the parameter's largest update, as tests/test_torch_train.py
  holds the "cat" graph (the JAX CPU step adds a row's duplicate lookups
  one after another, the port's scatter sums them first; the rest is
  summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh
from dlrm_flexflow_tpu.utils import checkpoint as jax_ckpt

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.utils import checkpoint as ckpt
from dlrm_flexflow_tpu_torch.utils.weights import (params_from_jax,
                                                   params_to_jax)

BF16_RTOL = 2.0 ** -7


def _models(compute_dtype, batch=6):
    jm = ff.FFModel(ff.FFConfig(batch_size=batch,
                                compute_dtype=compute_dtype))
    pm = pt.FFModel(pt.FFConfig(batch_size=batch, device="cpu",
                                compute_dtype=compute_dtype))
    return jm, pm


def _pair(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


# ---------------------------------------------------------------------
# BatchMatmul
# ---------------------------------------------------------------------
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_batch_matmul_matches_jax(trans_a, trans_b, compute_dtype):
    d, m, k, n = 6, 5, 7, 3
    sa = (d, k, m) if trans_a else (d, m, k)
    sb = (d, n, k) if trans_b else (d, k, n)
    jm, pm = _models(compute_dtype, batch=d)
    ops = []
    for model in (jm, pm):
        a = model.create_tensor(sa, name="a")
        b = model.create_tensor(sb, name="b")
        out = model.batch_matmul(a, b, trans_a=trans_a, trans_b=trans_b,
                                 name="bmm")
        assert out.shape == (d, m, n)
        ops.append(out.owner_op)
    jop, pop = ops
    ja, ta = _pair(sa, 1)
    jb, tb = _pair(sb, 2)
    ta.requires_grad_()
    tb.requires_grad_()
    jout, vjp = jax.vjp(lambda x, y: jop.apply({}, [x, y])[0], ja, jb)
    pout = pop.apply({}, [ta, tb])[0]
    assert pout.dtype == torch.float32
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    ct = np.random.RandomState(3).randn(d, m, n).astype(np.float32)
    jga, jgb = vjp(jnp.asarray(ct))
    pga, pgb = torch.autograd.grad(pout, [ta, tb], torch.from_numpy(ct))
    rtol = 1e-5 if compute_dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(pga.numpy(), np.asarray(jga), rtol=rtol,
                               atol=1e-6)
    np.testing.assert_allclose(pgb.numpy(), np.asarray(jgb), rtol=rtol,
                               atol=1e-6)


def test_batch_matmul_refuses_what_jax_refuses():
    _, pm = _models("float32")
    a = pm.create_tensor((6, 4, 5), name="a")
    b = pm.create_tensor((6, 4, 3), name="b")
    with pytest.raises(ValueError, match="contraction dim mismatch"):
        pm.batch_matmul(a, b, trans_a=False)
    c = pm.create_tensor((5, 4, 3), name="c")
    with pytest.raises(ValueError, match="batch dim mismatch"):
        pm.batch_matmul(a, c)
    flat = pm.create_tensor((6, 4), name="flat")
    with pytest.raises(ValueError, match="rank-3"):
        pm.batch_matmul(flat, b)


# ---------------------------------------------------------------------
# Transpose and IndexSelect
# ---------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(6, 4), (6, 3, 5), (6, 2, 3, 4)])
def test_transpose_matches_jax(shape):
    jm, pm = _models("float32")
    ops = [model.transpose(model.create_tensor(shape, name="x")).owner_op
           for model in (jm, pm)]
    want_shape = shape[:-2] + (shape[-1], shape[-2])
    assert ops[1].outputs[0].shape == want_shape == ops[0].outputs[0].shape
    jx, tx = _pair(shape, 4)
    tx.requires_grad_()
    jout, vjp = jax.vjp(lambda x: ops[0].apply({}, [x])[0], jx)
    pout = ops[1].apply({}, [tx])[0]
    np.testing.assert_array_equal(pout.detach().numpy(), np.asarray(jout))
    ct = np.random.RandomState(5).randn(*want_shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(ct))
    (pg,) = torch.autograd.grad(pout, [tx], torch.from_numpy(ct))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("axis,indices", [(1, [3, 0, 2]), (-1, [4, 4, 1]),
                                          (2, [0])])
def test_index_select_matches_jax(axis, indices):
    shape = (6, 4, 5)
    jm, pm = _models("float32")
    ops = [model.index_select(model.create_tensor(shape, name="x"),
                              indices, axis=axis).owner_op
           for model in (jm, pm)]
    assert ops[1].outputs[0].shape == ops[0].outputs[0].shape
    jx, tx = _pair(shape, 6)
    tx.requires_grad_()
    jout, vjp = jax.vjp(lambda x: ops[0].apply({}, [x])[0], jx)
    pout = ops[1].apply({}, [tx])[0]
    np.testing.assert_array_equal(pout.detach().numpy(), np.asarray(jout))
    ct = np.random.RandomState(7).randn(*pout.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(ct))
    (pg,) = torch.autograd.grad(pout, [tx], torch.from_numpy(ct))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))


def test_index_select_refuses_an_index_out_of_range():
    _, pm = _models("float32")
    x = pm.create_tensor((6, 4), name="x")
    with pytest.raises(ValueError, match="out of range"):
        pm.index_select(x, [0, 4], axis=1)


# ---------------------------------------------------------------------
# the unfused "dot" DLRM
# ---------------------------------------------------------------------
T, D, BS, LR, STEPS = 4, 16, 32, 0.1, 3
ARCH = dict(embedding_size=[512] * T, sparse_feature_size=D,
            mlp_bot=[4, 32, D], mlp_top=[D + (T + 1) * T // 2, 32, 1],
            arch_interaction_op="dot")


def _jax_dlrm():
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=5))
    jax_build_dlrm(m, JaxDLRMConfig(**ARCH))
    m.compile(ff.SGDOptimizer(lr=LR), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers()
    return m


def _port_dlrm(params_np=None):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
    build_dlrm(m, DLRMConfig(**ARCH))
    m.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"])
    if params_np is None:
        m.init_layers()
    else:
        m.swap_params(params_from_jax(m, params_np))
    return m


def _batch(step):
    x, y = synthetic_batch(DLRMConfig(**ARCH), BS, seed=40 + step)
    x["label"] = y
    return x


def assert_updates_close(p0, want, got, frac=1e-3):
    """Each parameter's update within ``frac`` of its largest."""
    for op in want:
        for pn in want[op]:
            du_w = want[op][pn] - p0[op][pn]
            du_g = got[op][pn] - p0[op][pn]
            scale = float(np.abs(du_w).max())
            err = float(np.abs(du_g - du_w).max())
            assert err <= frac * scale + 1e-7, (op, pn, err, scale)


def test_dot_graph_has_the_jax_names_and_fingerprint():
    jm, pm = _jax_dlrm(), _port_dlrm()
    assert ([(op.name, type(op).__name__) for op in pm.ops]
            == [(op.name, type(op).__name__) for op in jm.ops])
    for name in ("interaction_bmm", "interaction_tril", "interaction_flat",
                 "interaction_stack", "bot3d"):
        pm.get_layer_by_name(name)
    assert {op: set(p) for op, p in params_to_jax(pm, pm.params).items()} \
        == {op: set(p) for op, p in jm.params.items()}
    assert ckpt.config_fingerprint(pm) == jax_ckpt.config_fingerprint(jm)


def test_dot_forward_and_three_sgd_steps_match_jax():
    jm = _jax_dlrm()
    p0 = jax.tree.map(np.asarray, jm.params)
    pm = _port_dlrm(p0)
    x = _batch(0)
    feats = {k: v for k, v in x.items() if k != "label"}
    np.testing.assert_allclose(pm.forward_batch(feats).numpy(),
                               np.asarray(jm.forward_batch(feats)),
                               rtol=1e-5, atol=1e-7)
    lj, lp = [], []
    for s in range(STEPS):
        lj.append(float(jm.train_batch(_batch(s))["loss"]))
        lp.append(float(pm.train_batch(_batch(s))["loss"]))
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    assert [op.name for op in pm._sparse_ops] == ["emb_stack"]
    assert_updates_close(p0, jax.tree.map(np.asarray, jm.params),
                         params_to_jax(pm, pm.params))
