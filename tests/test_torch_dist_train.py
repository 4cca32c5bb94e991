"""DLRM trained across ranks against the JAX package on a mesh of as many
devices.

Worlds of 2 and 4 gloo ranks (``utils.testing.spawn_ranks``, one spawn a
world for the whole module) train a small DLRM (8 tables x 512 rows x
d = 16, bag 1, "cat", batch 32, narrow MLPs) for 3 SGD steps, under the
hand-written ``dlrm_strategy`` and under a strategy file that places
table i on device i % world (so the stacked tables are stored grouped by
device, a permuted table order). The JAX model runs the same steps on a
2- and a 4-device mesh of the virtual CPU devices ``conftest.py`` makes;
its weights cross into every rank by ``params_from_jax`` and come back
by ``params_to_jax`` (a rank's kernel is its slots of the JAX stored
kernel, so the ranks' blocks in rank order are the whole of it).

Held, and why:

- every rank's replicated weights are BITWISE equal: the dense
  gradients are summed by one all-reduce, whose result every rank gets,
  before the one dense update;
- the loss of each step within rtol 1e-5 of the JAX loss, and every
  trained weight (tables and MLPs) within rtol 1e-5, atol 1e-7 of the
  JAX one: the gradients sum in another order (each rank's share, then
  over the ranks; GSPMD's partial sums), and the JAX CPU step adds a
  row's duplicates into the table one after another where the port sums
  them first;
- every update (trained minus initial weight) within 1e-3 of the
  parameter's largest update, as in ``test_torch_train.py``;
- the table order the strategy file asks for is the JAX op's, and the
  ranks hold the JAX op's storage slots;
- the collectives: three all-to-alls and two all-reduces a step.
"""

import json

import numpy as np
import pytest

# The ranks are spawned processes that import this module to find
# _rank_train: the JAX package is imported in the functions that use it,
# so that they do not load it too.

T, ROWS, D, BS, LR, STEPS = 8, 512, 16, 32, 0.1, 3
ARCH = dict(embedding_size=[ROWS] * T, sparse_feature_size=D,
            mlp_bot=[4, 16, D], mlp_top=[D + T * D, 16, 1])
WORLDS = (2, 4)


def _strategy_file(tmp_path, world):
    """The reference's per-table keys, table i on device i % world, and
    the MLPs data-parallel over the world."""
    ops = [{"name": f"embedding{i}", "device_type": "TPU", "dims": [1, 1],
            "device_ids": [i % world], "memory_types": []}
           for i in range(T)]
    ops += [{"name": k, "device_type": "TPU", "dims": [world, 1],
             "device_ids": list(range(world)), "memory_types": []}
            for k in ("linear", "concat")]
    path = tmp_path / f"round_robin_{world}.json"
    path.write_text(json.dumps({"ops": ops}))
    return str(path)


def _batches():
    from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig,
                                                     synthetic_batch)
    out = []
    for s in range(STEPS):
        x, y = synthetic_batch(DLRMConfig(**ARCH), BS, seed=40 + s)
        x["label"] = y
        out.append(x)
    return out


def _rank_train(rank, world, scenarios, batches):
    """One rank: each scenario's 3 steps from the JAX weights. Returns
    {scenario: (losses, weights in the JAX layout, table order, slots,
    collective stats)}."""
    import dlrm_flexflow_tpu_torch as pt
    from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
    from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                     dlrm_strategy)
    import torch

    from dlrm_flexflow_tpu_torch.parallel.distributed import (
        global_batch_from_host_local, host_local_slice)
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.parallel.strategy_io import load_strategies
    from dlrm_flexflow_tpu_torch.utils.weights import (params_from_jax,
                                                       params_to_jax)
    out = {}
    for name, (path, p0) in scenarios.items():
        m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
        cfg = DLRMConfig(**ARCH)
        build_dlrm(m, cfg)
        strat = (dlrm_strategy(m, cfg, world) if path is None
                 else load_strategies(path))
        m.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"],
                  mesh=make_mesh(), strategies=strat)
        m.swap_params(params_from_jax(m, p0))
        # the launcher's staging: this rank's rows of the global batch
        mine = global_batch_from_host_local(host_local_slice(batches[0]), m)
        assert torch.equal(mine["sparse"], torch.as_tensor(
            batches[0]["sparse"][rank * BS // world:(rank + 1) * BS // world]
        ).long())
        losses = [float(m.train_batch(b)["loss"]) for b in batches]
        op = m.get_layer_by_name("emb_stack")
        out[name] = (losses, params_to_jax(m, m.params), op._table_order,
                     tuple(op.local_slots()), m._collectives.stats,
                     m.perf.report())
    return out


def _jax_model(world, path):
    import dlrm_flexflow_tpu as ff
    from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                               build_dlrm as jax_build_dlrm,
                                               dlrm_strategy as jax_strategy)
    from dlrm_flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from dlrm_flexflow_tpu.parallel.strategy_io import \
        load_strategies as jax_load_strategies
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=5))
    cfg = JaxDLRMConfig(**ARCH)
    jax_build_dlrm(m, cfg)
    strat = (jax_strategy(m, cfg, world) if path is None
             else jax_load_strategies(path))
    m.compile(ff.SGDOptimizer(lr=LR), "mean_squared_error", ["mse"],
              mesh=jax_make_mesh(num_devices=world), strategies=strat)
    m.init_layers()
    return m


@pytest.fixture(scope="module", params=WORLDS)
def world_run(request, tmp_path_factory):
    """One spawn of ``world`` ranks for both scenarios, and the JAX
    models trained the same way."""
    import jax

    from dlrm_flexflow_tpu_torch.utils.testing import spawn_ranks
    world = request.param
    tmp = tmp_path_factory.mktemp(f"world{world}")
    paths = {"dlrm_strategy": None,
             "round_robin_file": _strategy_file(tmp, world)}
    jms = {k: _jax_model(world, p) for k, p in paths.items()}
    p0 = {k: jax.tree.map(np.asarray, m.params) for k, m in jms.items()}
    batches = _batches()
    ranks = spawn_ranks(_rank_train, world, tmp, timeout_s=240,
                        args=({k: (paths[k], p0[k]) for k in paths},
                              batches))
    jax_out = {}
    for k, m in jms.items():
        losses = [float(m.train_batch(dict(b))["loss"]) for b in batches]
        order = m.get_layer_by_name("emb_stack")._table_order
        jax_out[k] = (losses, jax.tree.map(np.asarray, m.params),
                      None if order is None
                      else tuple(int(t) for t in np.asarray(order)))
    return world, p0, ranks, jax_out


@pytest.mark.parametrize("scenario", ["dlrm_strategy", "round_robin_file"])
def test_replicated_weights_bitwise_equal_across_ranks(world_run, scenario):
    world, _, ranks, _ = world_run
    first = ranks[0][scenario][1]
    for r in range(1, world):
        got = ranks[r][scenario][1]
        for op, p in first.items():
            for pn, v in p.items():
                if op == "emb_stack":
                    continue
                np.testing.assert_array_equal(got[op][pn], v,
                                              err_msg=f"rank {r} {op}.{pn}")
        assert ranks[r][scenario][0] == ranks[0][scenario][0]


@pytest.mark.parametrize("scenario", ["dlrm_strategy", "round_robin_file"])
def test_trains_as_the_jax_mesh(world_run, scenario):
    world, p0, ranks, jax_out = world_run
    lj, pj, order = jax_out[scenario]
    np.testing.assert_allclose(ranks[0][scenario][0], lj, rtol=1e-5)
    # the ranks' blocks, in rank order, are the JAX stored kernel
    slots = [ranks[r][scenario][3] for r in range(world)]
    assert [s for blk in slots for s in blk] == list(range(T))
    got = {op: dict(p) for op, p in ranks[0][scenario][1].items()}
    got["emb_stack"]["kernel"] = np.concatenate(
        [ranks[r][scenario][1]["emb_stack"]["kernel"] for r in range(world)])
    init = p0[scenario]
    for op, p in pj.items():
        for pn, want in p.items():
            have = got[op][pn]
            assert have.shape == want.shape, (op, pn)
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{op}.{pn}")
            dj, dp = want - init[op][pn], have - init[op][pn]
            scale = np.abs(dj).max()
            assert scale > 0, (op, pn)
            np.testing.assert_allclose(dp, dj, rtol=0, atol=1e-3 * scale,
                                       err_msg=f"{op}.{pn} update")


def test_table_order_and_collectives(world_run):
    world, _, ranks, jax_out = world_run
    want = tuple(i for g in range(world) for i in range(T) if i % world == g)
    for scenario in ("dlrm_strategy", "round_robin_file"):
        jorder = jax_out[scenario][2]
        for r in range(world):
            _, _, order, slots, stats, report = ranks[r][scenario]
            assert order == jorder, (scenario, r)
            assert slots == tuple(range(r * T // world,
                                        (r + 1) * T // world))
            # ids and rows forward, cotangents back; gradients and metrics
            assert stats["all_to_all"]["calls"] == 3 * STEPS
            assert stats["all_reduce"]["calls"] == 2 * STEPS
            assert report["train_all"] == STEPS * BS
    assert jax_out["round_robin_file"][2] == want
    assert jax_out["dlrm_strategy"][2] is None
