"""The port's fused dot interaction against the JAX package.

The plain PyTorch version (what the port's wrapper runs for CPU tensors)
of gather -> X·Xᵀ -> tril -> first top-MLP layer must match the JAX
Pallas kernel ``_interaction_kernel`` (interpret mode) at d=128 and the
JAX ``fused_interaction_reference`` at d=64: 2-D and bagged ids, a batch
that is not a multiple of 8, relu on and off. The port's
``FusedDotInteraction`` op must match the JAX op, relu and sigmoid head.

Tolerance: rtol 1e-5, atol 1e-5 — the pairwise dots and the layer's
products sum in another fp32 order on the two sides. The CUDA kernel
itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.ops.pallas.interaction_kernel import (
    fused_interaction as jax_fused, fused_interaction_reference as jax_ref,
    tril_pairs as jax_tril_pairs)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.ops.kernels.interaction import (
    fused_interaction, tril_pairs)
from dlrm_flexflow_tpu_torch.utils.weights import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
T, ROWS, H = 4, 64, 24
F = T + 1
P = F * (F - 1) // 2


def _inputs(d, batch, bag, seed=0):
    """Table, pre-offset ids, bottom, weight and bias at the scale of a
    DLRM layer (tables in ±0.05 would give tiny dots; randn·0.5 keeps
    every term of the sums visible)."""
    rng = np.random.RandomState(seed)
    table = (0.5 * rng.randn(T * ROWS, d)).astype(np.float32)
    idx = np.stack([rng.randint(t * ROWS, (t + 1) * ROWS, size=(batch, bag))
                    for t in range(T)], axis=1).astype(np.int64)
    bottom = (0.5 * rng.randn(batch, d)).astype(np.float32)
    w = (rng.randn(d + P, H) / np.sqrt(d + P)).astype(np.float32)
    bias = (0.1 * rng.randn(H)).astype(np.float32)
    return table, idx, bottom, w, bias


def _port(args, relu, two_d=False):
    table, idx, bottom, w, bias = (torch.from_numpy(a) for a in args)
    if two_d:
        idx = idx[:, :, 0]
    return fused_interaction(table, idx, bottom, w, bias, relu).numpy()


def _jax(fn, args, relu, two_d=False, **kw):
    table, idx, bottom, w, bias = (jnp.asarray(a) for a in args)
    idx = idx.astype(jnp.int32)
    if two_d:
        idx = idx[:, :, 0]
    return np.asarray(fn(table, idx, bottom, w, bias, relu, **kw))


def test_tril_pairs_match_jax():
    for f in (2, 5, 9):
        assert tril_pairs(f) == jax_tril_pairs(f)


class TestPlainInteraction:
    @pytest.mark.parametrize("relu", [True, False])
    @pytest.mark.parametrize("bag,batch,two_d", [(1, 13, True),
                                                 (3, 16, False)])
    def test_matches_pallas_kernel_d128(self, relu, bag, batch, two_d):
        args = _inputs(128, batch, bag)
        want = _jax(jax_fused, args, relu, two_d, interpret=True)
        got = _port(args, relu, two_d)
        assert got.shape == (batch, H)
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("relu", [True, False])
    @pytest.mark.parametrize("bag,batch,two_d", [(1, 5, True),
                                                 (2, 12, False)])
    def test_matches_jax_reference_d64(self, relu, bag, batch, two_d):
        args = _inputs(64, batch, bag, seed=1)
        want = _jax(jax_ref, args, relu, two_d)
        np.testing.assert_allclose(_port(args, relu, two_d), want, **TOL)

    def test_rejects_bad_shapes(self):
        table, idx, bottom, w, bias = (torch.from_numpy(a)
                                       for a in _inputs(64, 4, 1))
        with pytest.raises(ValueError, match="pairs"):
            fused_interaction(table, idx, bottom, w[1:], bias)
        with pytest.raises(ValueError, match="bias"):
            fused_interaction(table, idx, bottom, w, bias[1:])


def _models(act, batch=7, bag=2, d=64):
    """The same one-op graph in both packages: FusedDotInteraction over
    a sparse input and a dense input standing for the bottom MLP."""
    jm = ff.FFModel(ff.FFConfig(batch_size=batch, seed=4))
    s = jm.create_tensor((batch, T, bag), dtype=jnp.int32, name="sparse")
    b = jm.create_tensor((batch, d), name="dense")
    jm.fused_dot_interaction(s, b, ROWS, H, activation=act,
                             name="fused_interaction")
    jm.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
               mesh=make_mesh(devices=jax.devices()[:1]))
    jm.init_layers()
    pm = pt.FFModel(pt.FFConfig(batch_size=batch, device="cpu"))
    s = pm.create_tensor((batch, T, bag), dtype=torch.int64, name="sparse")
    b = pm.create_tensor((batch, d), name="dense")
    pm.fused_dot_interaction(s, b, ROWS, H, activation=act,
                             name="fused_interaction")
    pm.compile()
    pm.swap_params(params_from_jax(pm, jax.tree.map(np.asarray, jm.params)))
    return jm, pm


@pytest.mark.parametrize("act", ["relu", "sigmoid"])
def test_op_matches_jax_op(act):
    jm, pm = _models(act)
    rng = np.random.RandomState(2)
    batch = {"sparse": rng.randint(0, ROWS, size=(7, T, 2)).astype(np.int32),
             "dense": rng.randn(7, 64).astype(np.float32)}
    want = np.asarray(jm.forward_batch(batch))
    got = pm.forward_batch(batch).numpy()
    assert got.shape == (7, H)
    np.testing.assert_allclose(got, want, **TOL)

