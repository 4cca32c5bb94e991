"""The port's placement against the JAX package's.

- ``make_mesh`` over 1, 2, 3, 4 and 8 ranks has the JAX mesh's axes (the
  same names and sizes in the same order), each rank at the coordinates
  of the JAX device of the same index, and ``AxisAssigner``,
  ``assign_indices``, the feasible degrees and the clamps agree with the
  JAX functions for every degree tuple tried (or both refuse it).
- ``compile`` resolves a small DLRM's per-op configs as the JAX
  ``compile`` does, at 1, 2, 4 and 8 devices, under ``dlrm_strategy``
  and under each bundled DLRM ``.pb`` (loaded as the launchers load it):
  the same strategy map (generic keys resolved, defaults filled), the
  same clamped config of every op, the same stacked-table order, and the
  same warnings, word for word. The JAX model compiles on the virtual
  CPU devices ``conftest.py`` makes; the port compiles on a mesh of that
  many ranks, which it places but does not run (no process group).
- The process group's pieces that need no second process: the backend
  choice, the environment's checks, a world of one.
"""

import dataclasses
import itertools
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm,
                                           dlrm_strategy as jax_strategy)
from dlrm_flexflow_tpu.parallel import sharding as jsh
from dlrm_flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dlrm_flexflow_tpu.parallel.strategy_io import \
    load_strategies as jax_load_strategies

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 dlrm_strategy,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.parallel import distributed, sharding
from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
from dlrm_flexflow_tpu_torch.parallel.strategy_io import load_strategies

REPO = Path(__file__).resolve().parents[1]
DLRM_PB = sorted(p.name for p in (REPO / "strategies").glob("dlrm_*.pb"))
COUNTS = (1, 2, 3, 4, 8)
DEGREES = [d for n in range(1, 4)
           for d in itertools.product((1, 2, 3, 4, 6, 8), repeat=n)]
BS = 32
ARCH = dict(embedding_size=[64] * 8, sparse_feature_size=8,
            mlp_bot=[4, 16, 8], mlp_top=[8 + 8 * 8, 16, 1])


@pytest.mark.parametrize("n", COUNTS)
def test_mesh_matches_jax(n):
    jm = jax_make_mesh(num_devices=n)
    pm = make_mesh(devices=range(n))
    assert pm.axis_names == tuple(jm.axis_names)
    assert pm.shape == dict(jm.shape)
    assert pm.size == n
    for r, dev in enumerate(jax.devices()[:n]):
        at = np.argwhere(jm.devices == dev)[0]
        assert tuple(pm.coords(r).values()) == tuple(int(i) for i in at)
        # a dimension split over every axis puts rank r in block r
        assert pm.linear_index(r, pm.axis_names) == r


@pytest.mark.parametrize("n", COUNTS)
def test_axis_assignment_matches_jax(n):
    jm = jax_make_mesh(num_devices=n)
    sizes = [jm.shape[a] for a in jm.axis_names]
    jasn = jsh.AxisAssigner(jm)
    pasn = sharding.AxisAssigner(make_mesh(devices=range(n)))
    assert pasn.feasible_degrees() == jasn.feasible_degrees()
    for degs in DEGREES:
        assert sharding.assign_indices(degs, sizes) == \
            jsh.assign_indices(degs, sizes)
        assert sharding.clamp_degrees(degs, sizes) == \
            jsh.clamp_degrees(degs, sizes)
        try:
            want = [tuple(a) for a in jasn.assign(degs)]
        except ValueError as e:
            with pytest.raises(ValueError, match="not jointly expressible"):
                pasn.assign(degs)
            assert "not jointly expressible" in str(e)
            continue
        assert pasn.assign(degs) == want
    for pd in (1, 2, 3, 4, 8, 16):
        assert sharding.param_axis_indices(pd, sizes) == \
            jsh.param_axis_indices(pd, sizes)
        for rows in (None, 64, 96):
            assert sharding.clamp_param_degree(pd, sizes, rows, 2) == \
                jsh.clamp_param_degree(pd, sizes, rows, 2)


class _Records(logging.Handler):
    """The warnings the compile of either package logs (both log to the
    "ff.model" channel)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _warnings_of(fn):
    h = _Records()
    lg = logging.getLogger("ff.model")
    lg.addHandler(h)
    try:
        fn()
    finally:
        lg.removeHandler(h)
    return h.messages


def _jax_compiled(ndev, source, arch=ARCH):
    m = ff.FFModel(ff.FFConfig(batch_size=BS))
    cfg = JaxDLRMConfig(**arch)
    jax_build_dlrm(m, cfg)
    strat = (jax_strategy(m, cfg, ndev) if source == "dlrm_strategy"
             else jax_load_strategies(str(REPO / "strategies" / source)))
    msgs = _warnings_of(lambda: m.compile(
        ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
        mesh=jax_make_mesh(num_devices=ndev), strategies=strat))
    return m, msgs


def _port_compiled(ndev, source, arch=ARCH):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
    cfg = DLRMConfig(**arch)
    build_dlrm(m, cfg)
    strat = (dlrm_strategy(m, cfg, ndev) if source == "dlrm_strategy"
             else load_strategies(str(REPO / "strategies" / source)))
    msgs = _warnings_of(lambda: m.compile(
        SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
        mesh=make_mesh(devices=range(ndev)), strategies=strat))
    return m, msgs


def _as_dicts(configs):
    return {k: dataclasses.asdict(v) for k, v in configs.items()}


@pytest.mark.parametrize("source", ["dlrm_strategy"] + DLRM_PB)
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_compile_resolves_as_jax(ndev, source):
    jm, jmsgs = _jax_compiled(ndev, source)
    pm, pmsgs = _port_compiled(ndev, source)
    assert _as_dicts(pm.strategies) == _as_dicts(jm.strategies)
    assert _as_dicts(pm._op_pc) == _as_dicts(jm._op_pc)
    jorder = jm.get_layer_by_name("emb_stack")._table_order
    assert pm.get_layer_by_name("emb_stack")._table_order == (
        None if jorder is None else tuple(int(t) for t in np.asarray(jorder)))
    assert pmsgs == jmsgs
    # each op on the axes AxisAssigner gives its clamped degrees
    asn = sharding.AxisAssigner(pm.mesh)
    assert pm._out_axes == {k: asn.assign(pc.degrees)
                            for k, pc in pm._op_pc.items()}


@pytest.mark.parametrize("source", [p for p in DLRM_PB if "kaggle" in p])
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_compile_resolves_criteo_shapes_as_jax(ndev, source):
    """The Criteo-Kaggle strategy files over a model with non-uniform
    tables (one ``EmbeddingBagConcat``, whose table-dim degree is clamped
    without a warning): the same strategies, configs and warnings."""
    arch = dict(ARCH, embedding_size=[64, 32, 16, 8] * 2)
    jm, jmsgs = _jax_compiled(ndev, source, arch)
    pm, pmsgs = _port_compiled(ndev, source, arch)
    assert _as_dicts(pm.strategies) == _as_dicts(jm.strategies)
    assert _as_dicts(pm._op_pc) == _as_dicts(jm._op_pc)
    assert pmsgs == jmsgs


def test_dlrm_strategy_refuses_what_it_cannot_split():
    """``dlrm_strategy`` over 1, 2 and 4 devices gives the JAX map for the
    stacked, the concatenated and the unfused graphs (the stacked tables
    split by table, the concatenated table's table degree 2, each
    ``Embedding`` split by width), with and without ``row_shard=True``,
    and raises nowhere."""
    for fuse, arch in ((True, ARCH),
                       (True, dict(ARCH, embedding_size=[64, 32] * 4)),
                       (False, ARCH),
                       (False, dict(ARCH, sparse_feature_size=6,
                                    mlp_bot=[4, 16, 6],
                                    mlp_top=[6 + 6 * 8, 16, 1]))):
        m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
        build_dlrm(m, DLRMConfig(**arch), fuse_embeddings=fuse)
        jmodel = ff.FFModel(ff.FFConfig(batch_size=BS))
        jax_build_dlrm(jmodel, JaxDLRMConfig(**arch), fuse_embeddings=fuse)
        for n in (1, 2, 4):
            for rs in (False, True):
                got = dlrm_strategy(m, DLRMConfig(**arch), n, row_shard=rs)
                assert _as_dicts(got) == _as_dicts(jax_strategy(
                    jmodel, JaxDLRMConfig(**arch), n, row_shard=rs))
                if rs:
                    assert all(got[op.name].param_degree == n
                               for op in m.ops
                               if type(op).__name__.startswith("Embed"))


def test_process_group_pieces_without_a_group(monkeypatch):
    for k in ("NUM_PROCESSES", "COORDINATOR_ADDRESS", "PROCESS_ID",
              "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize_distributed()            # a single process
    assert (distributed.world_size(), distributed.rank()) == (1, 0)
    assert not distributed.is_initialized()
    batch = {"x": np.arange(8)}
    assert distributed.host_local_slice(batch) is batch
    assert distributed.probe_mesh(make_mesh(), deadline_s=5) >= 0
    m, _ = _port_compiled(1, "dlrm_strategy")
    x, _ = synthetic_batch(DLRMConfig(**ARCH), BS, seed=1)
    staged = distributed.global_batch_from_host_local(x, m)
    assert all(torch.equal(staged[k], v)
               for k, v in m._device_batch(x).items())
    with pytest.raises(ValueError, match="share of the global batch"):
        distributed.global_batch_from_host_local(
            {k: v[:BS // 2] for k, v in x.items()}, m)
    # the CPU machine has no card: ranks share nothing, gloo
    assert distributed.choose_backend(2) == "gloo"
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(ValueError, match="PROCESS_ID"):
        distributed.initialize_distributed()
    monkeypatch.setenv("PROCESS_ID", "2")
    with pytest.raises(ValueError, match="not a rank of 2"):
        distributed.initialize_distributed()
    monkeypatch.setenv("PROCESS_ID", "one")
    with pytest.raises(ValueError, match="PROCESS_ID='one'"):
        distributed.initialize_distributed()


def test_a_mesh_wider_than_the_group_places_but_does_not_train():
    m, _ = _port_compiled(4, "dlrm_strategy")
    with pytest.raises(ValueError, match="process group has 1"):
        m.init_layers()
    with pytest.raises(ValueError, match="requested 4 devices"):
        make_mesh(num_devices=4)


@pytest.mark.parametrize("rows,d,n", [(1024, 16, 96), (512, 64, 300)])
def test_windowed_scatter_matches_the_sharded_pallas_kernel(rows, d, n):
    """Kernel 4: each of 8 ranks' blocks, updated by
    ``sharded_scatter_add_rows_reference`` from the same global ids and
    updates, equals the JAX ``sharded_scatter_add_packed`` (a shard_map of
    kernel 3, interpret mode) on an 8-device mesh, BITWISE: both scale
    each update, sum a row's duplicates in ascending lookup order from 0,
    then add, and both skip the pads and every id outside the block.
    The wrapper runs the same plain version on CPU tensors, and the
    blocks together equal kernel 3's plain version on the whole table."""
    import jax.numpy as jnp

    from dlrm_flexflow_tpu.ops.pallas.embedding_kernel import \
        sharded_scatter_add_packed

    from dlrm_flexflow_tpu_torch.ops.kernels import scatter_rows as sr
    mesh = jax_make_mesh(num_devices=8)
    rng = np.random.RandomState(rows + n)
    table = rng.rand(rows, d).astype(np.float32)
    ids = rng.randint(0, rows, (n,)).astype(np.int64)
    ids[:8] = ids[0]                           # a hot row
    ids[8:12] = ids[20]
    ids[rng.rand(n) < 0.1] = -1                # pads
    upd = rng.rand(n, d).astype(np.float32)
    scale = np.float32(-0.05)
    r = 128 // d
    want = np.asarray(jax.jit(lambda v, i, u: sharded_scatter_add_packed(
        mesh, tuple(mesh.axis_names), v, i, u, d, interpret=True))(
            jnp.asarray(table.reshape(rows // r, r * d)),
            jnp.asarray(ids.astype(np.int32)),
            jnp.asarray(scale * upd))).reshape(rows, d)
    block = rows // 8
    got, wrapped = [], []
    for k in range(8):
        for fn, out in ((sr.sharded_scatter_add_rows_reference, got),
                        (sr.sharded_scatter_add_rows, wrapped)):
            b = torch.from_numpy(table[k * block:(k + 1) * block].copy())
            fn(b, torch.from_numpy(ids), torch.from_numpy(upd),
               k * block, scale=float(scale))
            out.append(b.numpy())
    np.testing.assert_array_equal(np.concatenate(got), want)
    np.testing.assert_array_equal(np.concatenate(wrapped), want)
    whole = sr.scatter_add_rows_reference(
        torch.from_numpy(table.copy()), torch.from_numpy(ids),
        torch.from_numpy(upd), float(scale))
    np.testing.assert_array_equal(np.concatenate(got), whole.numpy())
    assert (want != table).any(axis=1).sum() > 0
