"""The port's embedding bag against the JAX package.

The plain PyTorch version of the bag (what the port's wrapper runs for
CPU tensors) must match the JAX Pallas kernel ``_bag_kernel`` (run in
interpret mode, as the JAX package's own tests run it here) at d=128,
where the TPU kernel takes the width, and the JAX ``embedding_bag_reference``
at d=64, where it does not. The port's ``EmbeddingBagStacked`` op must
match the JAX op at d=64 — lane-packed there as r=2 rows per tile — with
a ``_table_order`` storage permutation, wrapped ids (negative and >= N)
and both aggregations, after ``params_from_jax`` carries the weights.

Tolerance: rtol 1e-6, atol 1e-6 — both sides sum in fp32 in bag order,
so only the last bit may differ. The CUDA kernel itself is held to the
plain version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.ops.pallas.embedding_kernel import (
    embedding_bag_reference as jax_bag_reference, stacked_embedding_bag)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.ops.kernels.embedding_bag import embedding_bag
from dlrm_flexflow_tpu_torch.utils.weights import params_from_jax

TOL = dict(rtol=1e-6, atol=1e-6)
T, ROWS = 4, 96


def _stacked_inputs(d, batch, bag, seed=0):
    rng = np.random.RandomState(seed)
    tables = rng.randn(T, ROWS, d).astype(np.float32)
    idx = rng.randint(0, ROWS, size=(batch, T, bag)).astype(np.int32)
    return tables, idx


def _port_stacked(tables, idx, aggr):
    """The port's stacked bag: ids offset by t*rows into the flat table,
    one wrapper call, as EmbeddingBagStacked.apply does."""
    batch, _, bag = idx.shape
    offs = (np.arange(T) * ROWS)[None, :, None]
    flat = torch.from_numpy((idx + offs).reshape(batch * T, bag)
                            .astype(np.int64))
    table = torch.from_numpy(tables.reshape(T * ROWS, -1))
    return embedding_bag(table, flat, aggr).reshape(batch, T, -1).numpy()


class TestPlainBag:
    @pytest.mark.parametrize("aggr", ["sum", "avg"])
    @pytest.mark.parametrize("bag,batch", [(1, 16), (3, 13)])
    def test_matches_pallas_kernel_d128(self, aggr, bag, batch):
        tables, idx = _stacked_inputs(128, batch, bag)
        want = np.asarray(stacked_embedding_bag(
            jnp.asarray(tables), jnp.asarray(idx), aggr, interpret=True))
        np.testing.assert_allclose(_port_stacked(tables, idx, aggr), want,
                                   **TOL)

    @pytest.mark.parametrize("aggr", ["sum", "avg"])
    @pytest.mark.parametrize("bag,batch", [(1, 9), (4, 16)])
    def test_matches_jax_reference_d64(self, aggr, bag, batch):
        rng = np.random.RandomState(1)
        table = rng.randn(200, 64).astype(np.float32)
        ids = rng.randint(0, 200, size=(batch, bag))
        want = np.asarray(jax_bag_reference(jnp.asarray(table),
                                            jnp.asarray(ids), aggr))
        got = embedding_bag(torch.from_numpy(table),
                            torch.from_numpy(ids.astype(np.int64)), aggr)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_rejects_bad_arguments(self):
        table = torch.zeros(10, 8)
        with pytest.raises(ValueError, match="aggr"):
            embedding_bag(table, torch.zeros(2, 1, dtype=torch.int64),
                          "none")
        with pytest.raises(ValueError, match="ids"):
            embedding_bag(table, torch.zeros(2, dtype=torch.int64))


def _jax_stack_model(d, batch, bag, aggr, order):
    m = ff.FFModel(ff.FFConfig(batch_size=batch, seed=5))
    x = m.create_tensor((batch, T, bag), dtype=jnp.int32, name="sparse")
    m.embedding_stacked(x, T, ROWS, d, aggr=aggr, name="emb_stack")
    op = m.get_layer_by_name("emb_stack")
    if order is not None:
        op.set_table_order(order)
    m.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers()
    return m, op


def _port_stack_model(d, batch, bag, aggr, order):
    m = pt.FFModel(pt.FFConfig(batch_size=batch, device="cpu"))
    x = m.create_tensor((batch, T, bag), dtype=torch.int64, name="sparse")
    m.embedding_stacked(x, T, ROWS, d, aggr=aggr, name="emb_stack")
    if order is not None:
        m.get_layer_by_name("emb_stack").set_table_order(order)
    return m.compile()


class TestStackedOp:
    @pytest.mark.parametrize("aggr", ["sum", "avg"])
    @pytest.mark.parametrize("order", [None, (2, 0, 3, 1)])
    def test_matches_jax_op_packed_d64(self, aggr, order):
        batch, bag = 11, 2
        jm, jop = _jax_stack_model(64, batch, bag, aggr, order)
        assert jop._pack == 2          # 64-wide rows, two per 128 lanes
        pm = _port_stack_model(64, batch, bag, aggr, order)
        pm.swap_params(params_from_jax(
            pm, jax.tree.map(np.asarray, jm.params)))
        _, idx = _stacked_inputs(64, batch, bag, seed=3)
        want = np.asarray(jm.forward_batch({"sparse": idx}))
        got = pm.forward_batch({"sparse": idx}).numpy()
        assert got.shape == (batch, T, 64)
        np.testing.assert_allclose(got, want, **TOL)

    def test_ids_wrap_like_jax(self):
        """Negative ids and ids >= N wrap as jnp's floor-mod % does."""
        batch, bag = 6, 3
        jm, _ = _jax_stack_model(64, batch, bag, "sum", None)
        pm = _port_stack_model(64, batch, bag, "sum", None)
        pm.swap_params(params_from_jax(
            pm, jax.tree.map(np.asarray, jm.params)))
        rng = np.random.RandomState(7)
        idx = rng.randint(-3 * ROWS, 3 * ROWS,
                          size=(batch, T, bag)).astype(np.int32)
        idx[0, 0] = [-1, ROWS, -ROWS]
        want = np.asarray(jm.forward_batch({"sparse": idx}))
        got = pm.forward_batch({"sparse": idx}).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        table = pm.params["emb_stack"]["kernel"][0].numpy()
        np.testing.assert_allclose(
            got[0, 0], table[ROWS - 1] + table[0] + table[0], **TOL)

