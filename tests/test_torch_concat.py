"""Non-uniform tables against the JAX package: ``EmbeddingBagConcat``
(T tables of one width and different row counts in one
concatenated-rows table) and the DLRM graphs ``build_dlrm`` makes of
them, concatenated or one ``Embedding`` per table, under "cat" and the
unfused "dot".

Sizes: [5, 300, 17, 9000] rows (9,322 rows padded to 16,384) at d = 16
and d = 8, where the JAX op lane-packs the table 8 and 16 rows to a
128-wide row; the JAX weights cross by ``params_from_jax``, which undoes
the packing by a reshape.

Tolerances, and why:

- the op's forward: bitwise (the same rows summed over a bag of 2 in the
  same order), ids past a table's size and negative ids wrapping into
  their table;
- the lane-pack carry-over (``params_from_jax`` / ``params_to_jax``, the
  optimizer state's, ``rows_from_jax``): bitwise;
- 3 training steps of the DLRM: the loss within rtol 1e-5 (the MLPs'
  products sum in another fp32 order in XLA and in PyTorch), every
  parameter's and state slab's change within 1e-3 of its largest change
  under SGD and momentum and within 1e-2 under Adam (Adam divides by
  sqrt(v), turning those order differences of small gradients into
  update differences of their own size), as tests/test_torch_optimizers.py
  holds the stacked graph; rows of the table no step looked up, and
  their state: bitwise.
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
from dlrm_flexflow_tpu_torch.core.optimizers import (AdamOptimizer,
                                                     SGDOptimizer)
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.ops.embedding import EmbeddingBagConcat
from dlrm_flexflow_tpu_torch.utils import checkpoint as ckpt
from dlrm_flexflow_tpu_torch.utils.weights import (opt_state_from_jax,
                                                   opt_state_to_jax,
                                                   params_from_jax,
                                                   params_to_jax,
                                                   rows_from_jax)

SIZES = [5, 300, 17, 9000]
B, BAG = 8, 2


def _op_models(d, aggr="sum"):
    """A JAX and a port model of one concatenated table and a head, the
    port's weights carried from the JAX model's."""
    T = len(SIZES)
    jm = ff.FFModel(ff.FFConfig(batch_size=B, seed=2))
    pm = pt.FFModel(pt.FFConfig(batch_size=B, device="cpu"))
    for m, itype in ((jm, jnp.int32), (pm, torch.int64)):
        ids = m.create_tensor((B, T, BAG), dtype=itype, name="ids")
        e = m.embedding_concat(ids, SIZES, d, aggr=aggr, name="emb")
        flat = m.reshape(e, (B, T * d), name="flat")
        m.dense(flat, 1, name="head")
    jm.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
               mesh=make_mesh(devices=jax.devices()[:1]))
    jm.init_layers()
    pm.compile(SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"])
    p0 = jax.tree.map(np.asarray, jm.params)
    pm.swap_params(params_from_jax(pm, p0))
    return jm, pm, p0


def _ids(seed, spread=3):
    """Ids of every table, some past its size and some negative."""
    rng = np.random.RandomState(seed)
    cols = [rng.randint(-rows, spread * rows, size=(B, 1, BAG))
            for rows in SIZES]
    return np.concatenate(cols, axis=1).astype(np.int32)


@pytest.mark.parametrize("aggr", ["sum", "avg"])
@pytest.mark.parametrize("d", [16, 8])
def test_concat_forward_wraps_ids_like_jax(d, aggr):
    jm, pm, p0 = _op_models(d, aggr)
    jop = jm.get_layer_by_name("emb")
    pop = pm.get_layer_by_name("emb")
    assert isinstance(pop, EmbeddingBagConcat)
    assert pop.total_rows == jop.total_rows == 16384
    assert pop._offsets == jop._offsets
    ids = _ids(d)
    want = np.asarray(jop.apply(jm.params["emb"], [jnp.asarray(ids)])[0])
    got = pop.apply(pm.params["emb"], [torch.from_numpy(ids).long()])[0]
    np.testing.assert_array_equal(got.numpy(), want)
    # the ids' wrapped global rows: the same as the JAX op's
    np.testing.assert_array_equal(
        pop._global_ids(torch.from_numpy(ids)).numpy().reshape(-1),
        np.asarray(jop._global_indices(jnp.asarray(ids))).reshape(-1))


@pytest.mark.parametrize("d", [16, 8])
def test_concat_lane_pack_carries_bitwise(d):
    jm, pm, p0 = _op_models(d)
    pop = pm.get_layer_by_name("emb")
    r = 128 // d
    assert p0["emb"]["kernel"].shape == (16384 // r, 128)
    assert tuple(pm.params["emb"]["kernel"].shape) == (16384, d)
    back = params_to_jax(pm, pm.params)
    np.testing.assert_array_equal(back["emb"]["kernel"], p0["emb"]["kernel"])
    # the pad rows are zero and each table lies at its offset
    logical = pm.params["emb"]["kernel"].numpy()
    assert not logical[sum(SIZES):].any()
    jop = jm.get_layer_by_name("emb")
    np.testing.assert_array_equal(
        logical, np.asarray(jop.unpack_kernel(jm.params["emb"]["kernel"])))
    # a delta's packed rows map onto the port's logical rows
    idx = np.array([0, 3, 1000], np.int64)
    vals = p0["emb"]["kernel"][idx]
    rows, v = rows_from_jax(pop, "kernel", idx, vals)
    np.testing.assert_array_equal(logical[rows], v)
    # the touched rows of the stored kernel, as the JAX op's
    ids = _ids(1)
    np.testing.assert_array_equal(pop.delta_touched_rows(ids),
                                  np.asarray(jop.delta_touched_rows(ids)))
    np.testing.assert_array_equal(pop.flat_lookup_ids(ids),
                                  np.asarray(jop.flat_lookup_ids(ids)))


def _fresh_ops(d=16):
    """A JAX and a port model of one concatenated table, compiled, no
    parameters drawn yet."""
    T = len(SIZES)
    jm = ff.FFModel(ff.FFConfig(batch_size=B, seed=2))
    pm = pt.FFModel(pt.FFConfig(batch_size=B, device="cpu"))
    for m, itype in ((jm, jnp.int32), (pm, torch.int64)):
        ids = m.create_tensor((B, T, BAG), dtype=itype, name="ids")
        e = m.embedding_concat(ids, SIZES, d, name="emb")
        m.dense(m.reshape(e, (B, T * d), name="flat"), 1, name="head")
    jm.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
               mesh=make_mesh(devices=jax.devices()[:1]))
    pm.compile(SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"])
    return jm, pm


def test_concat_refuses_device_groups():
    """``set_device_groups`` groups the tables by device as the JAX op
    does: the same offsets and total rows, and the init of the grouped
    table draws each table at its own shape at its offset, the pad rows
    zero, as the JAX op's init (whose weights carry across bitwise)."""
    for dev_of in ([0, 1, 0, 1], [1, 1, 0, 1], [2, 0, 2, 5]):
        _check_device_groups(dev_of)


def _check_device_groups(dev_of):
    jm, pm = _fresh_ops()
    jop, pop = jm.get_layer_by_name("emb"), pm.get_layer_by_name("emb")
    jop.set_device_groups(dev_of)
    pop.set_device_groups(dev_of)
    assert pop._offsets == tuple(int(o) for o in jop._offsets)
    assert pop.total_rows == jop.total_rows
    groups = sorted(set(dev_of))
    block = pop.total_rows // len(groups)
    assert block % pop._ROW_PAD == 0
    for i, dg in enumerate(dev_of):
        k = groups.index(dg)
        assert k * block <= pop._offsets[i] < (k + 1) * block
    jm.init_layers()
    pm.init_layers(seed=3)
    want = np.asarray(jop.unpack_kernel(jm.params["emb"]["kernel"]))
    got = pm.params["emb"]["kernel"].numpy()
    assert got.shape == want.shape == (pop.total_rows, 16)
    # the same rows hold tables, the rest (pads) zero in both
    np.testing.assert_array_equal(got != 0, want != 0)
    for off, rows in zip(pop._offsets, SIZES):
        lim = (6.0 / (rows + 16)) ** 0.5     # Glorot at (rows, d)
        assert float(np.abs(got[off:off + rows]).max()) <= lim
        assert float(np.abs(want[off:off + rows]).max()) <= lim
    carried = params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
    np.testing.assert_array_equal(carried["emb"]["kernel"].numpy(), want)


# Criteo-Kaggle's 26 table sizes (run_criteo_kaggle.sh)
KAGGLE = [1396, 550, 2481689, 687, 20, 15, 204, 96, 14, 1400181, 397059,
          3166985, 10, 2208, 11156, 155, 4, 976, 14, 1398149, 1263872,
          1246444, 13107, 336, 101, 30]


def _per_table_file(tmp_path, ndev):
    """The reference's per-table keys, table i on device i % ndev, every
    other op data-parallel over one device."""
    import json
    ops = [{"name": f"embedding{i}", "device_type": "TPU", "dims": [1, 1],
            "device_ids": [i % ndev], "memory_types": []}
           for i in range(len(KAGGLE))]
    ops += [{"name": k, "device_type": "TPU", "dims": [1, 1],
             "device_ids": [0], "memory_types": []}
            for k in ("linear", "concat")]
    path = tmp_path / f"kaggle_per_table_{ndev}.json"
    path.write_text(json.dumps({"ops": ops}))
    return str(path)


def _warnings(fn, *names):
    import logging
    msgs = []

    class H(logging.Handler):
        def emit(self, rec):
            msgs.append(rec.getMessage())

    h = H(logging.WARNING)
    for n in names:
        logging.getLogger(n).addHandler(h)
    try:
        fn()
    finally:
        for n in names:
            logging.getLogger(n).removeHandler(h)
    return msgs


def test_per_table_file_trains_at_world_one(tmp_path):
    """A per-table strategy file for Criteo-Kaggle naming 2 devices, on one
    device: the port groups the concatenated table by device as the JAX
    compile does (the same offsets and total rows at Kaggle's sizes, and
    the JAX warnings word for word: the padding and "placement is
    approximate"), then trains as the JAX model does at Kaggle's 26
    tables cut to a few thousand rows (losses within rtol 1e-5, every
    change within 1e-3 of its largest)."""
    from dlrm_flexflow_tpu.parallel.strategy_io import \
        load_strategies as jax_load
    from dlrm_flexflow_tpu_torch.parallel.strategy_io import load_strategies
    path = _per_table_file(tmp_path, 2)

    def arch(sizes):
        return dict(embedding_size=sizes, sparse_feature_size=16,
                    mlp_bot=[13, 32, 16], mlp_top=[16 * 27, 32, 1])

    def pair(sizes):
        jm = ff.FFModel(ff.FFConfig(batch_size=BS, seed=4))
        jax_build_dlrm(jm, JaxDLRMConfig(**arch(sizes)))
        pm = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
        build_dlrm(pm, DLRMConfig(**arch(sizes)))
        jw = _warnings(lambda: jm.compile(
            ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
            mesh=make_mesh(devices=jax.devices()[:1]),
            strategies=jax_load(path)), "ff.model")
        pw = _warnings(lambda: pm.compile(
            SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
            strategies=load_strategies(path)), "ff.model")
        return jm, pm, jw, pw

    # Kaggle's own sizes: compiled, no parameters drawn
    jm, pm, jw, pw = pair(KAGGLE)
    jop, pop = jm.get_layer_by_name("emb_concat"), \
        pm.get_layer_by_name("emb_concat")
    assert pop.total_rows == jop.total_rows == 2 * 7217152
    assert pop._offsets == tuple(int(o) for o in jop._offsets)
    assert pw == jw and any("placement is approximate" in w for w in pw)
    assert any("pads 'emb_concat'" in w for w in pw)
    # cut to a few thousand rows, trained
    small = [s // 2048 + 3 for s in KAGGLE]
    jm, pm, jw, pw = pair(small)
    assert pw == jw
    jop, pop = jm.get_layer_by_name("emb_concat"), \
        pm.get_layer_by_name("emb_concat")
    assert pop._offsets == tuple(int(o) for o in jop._offsets)
    assert pop.total_rows == jop.total_rows
    jm.init_layers()
    p0 = jax.tree.map(np.asarray, jm.params)
    pm.swap_params(params_from_jax(pm, p0))
    lj, lp = [], []
    for s in range(STEPS):
        x, y = synthetic_batch(DLRMConfig(**arch(small)), BS, seed=80 + s)
        x["label"] = y
        lj.append(float(jm.train_batch(dict(x))["loss"]))
        lp.append(float(pm.train_batch(dict(x))["loss"]))
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    _changes_close(p0, jax.tree.map(np.asarray, jm.params),
                   params_to_jax(pm, pm.params), 1e-3, "per-table file")


def test_concat_init_draws_each_table_at_its_own_shape():
    pm = pt.FFModel(pt.FFConfig(batch_size=B, device="cpu"))
    ids = pm.create_tensor((B, len(SIZES), BAG), dtype=torch.int64,
                           name="ids")
    pm.embedding_concat(ids, SIZES, 16, name="emb")
    pm.init_layers(seed=3)
    k = pm.params["emb"]["kernel"]
    op = pm.get_layer_by_name("emb")
    assert not k[sum(SIZES):].any()
    for off, rows in zip(op._offsets, SIZES):
        lim = (6.0 / (rows + 16)) ** 0.5     # Glorot at (rows, d)
        part = k[off:off + rows]
        assert float(part.abs().max()) <= lim
        assert float(part.abs().max()) > 0.5 * lim


# ---------------------------------------------------------------------
# the DLRM graphs of non-uniform tables, 3 training steps against JAX
# ---------------------------------------------------------------------
T, D, BS, STEPS = len(SIZES), 16, 32, 3


def _arch(mode):
    top0 = D + (T * D if mode == "cat" else (T + 1) * T // 2)
    return dict(embedding_size=SIZES, sparse_feature_size=D,
                mlp_bot=[4, 32, D], mlp_top=[top0, 32, 1],
                arch_interaction_op=mode)


OPTS = {
    "sgd": (lambda: ff.SGDOptimizer(lr=0.1),
            lambda: SGDOptimizer(lr=0.1), 1e-3),
    "momentum": (lambda: ff.SGDOptimizer(lr=0.1, momentum=0.9,
                                         weight_decay=1e-4),
                 lambda: SGDOptimizer(lr=0.1, momentum=0.9,
                                      weight_decay=1e-4), 1e-3),
    "adam": (lambda: ff.AdamOptimizer(alpha=0.01),
             lambda: AdamOptimizer(alpha=0.01), 1e-2),
}


def _dlrm_pair(layout, mode, opt):
    fuse = layout == "concat"
    jopt, popt, frac = OPTS[opt]
    jm = ff.FFModel(ff.FFConfig(batch_size=BS, seed=4))
    jax_build_dlrm(jm, JaxDLRMConfig(**_arch(mode)), fuse_embeddings=fuse)
    jm.compile(jopt(), "mean_squared_error", ["mse"],
               mesh=make_mesh(devices=jax.devices()[:1]))
    jm.init_layers()
    pm = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
    build_dlrm(pm, DLRMConfig(**_arch(mode)), fuse_embeddings=fuse)
    pm.compile(popt(), "mean_squared_error", ["mse"])
    p0 = jax.tree.map(np.asarray, jm.params)
    pm.swap_params(params_from_jax(pm, p0))
    return jm, pm, p0, frac


def _batch(mode, step):
    x, y = synthetic_batch(DLRMConfig(**_arch(mode)), BS, seed=60 + step)
    x["label"] = y
    return x


def _changes_close(before, want, got, frac, where):
    for op in want:
        for pn in want[op]:
            b = before[op][pn] if before is not None else 0.0
            dw, dg = want[op][pn] - b, got[op][pn] - b
            scale = float(np.abs(dw).max())
            err = float(np.abs(dg - dw).max())
            assert err <= frac * scale + 1e-7, (where, op, pn, err, scale)


@pytest.mark.parametrize("layout,mode,opt", [
    ("concat", "cat", "sgd"), ("concat", "dot", "sgd"),
    ("per_table", "cat", "sgd"), ("per_table", "dot", "sgd"),
    ("concat", "cat", "momentum"), ("concat", "cat", "adam"),
    ("concat", "dot", "adam"), ("per_table", "cat", "adam")])
def test_non_uniform_dlrm_trains_like_jax(layout, mode, opt):
    jm, pm, p0, frac = _dlrm_pair(layout, mode, opt)
    assert ([(op.name, type(op).__name__) for op in pm.ops]
            == [(op.name, type(op).__name__) for op in jm.ops])
    assert ckpt.config_fingerprint(pm) == jax_ckpt.config_fingerprint(jm)
    want_sparse = (["emb_concat"] if layout == "concat"
                   else [f"emb_{i}" for i in range(T)])
    lj, lp = [], []
    touched = set()
    for s in range(STEPS):
        b = _batch(mode, s)
        lj.append(float(jm.train_batch(dict(b))["loss"]))
        lp.append(float(pm.train_batch(dict(b))["loss"]))
        if layout == "concat":
            touched |= set(pm.get_layer_by_name("emb_concat")
                           .flat_lookup_ids(b["sparse"]).tolist())
    assert [op.name for op in pm._sparse_ops] == want_sparse
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    pj = jax.tree.map(np.asarray, jm.params)
    pp = params_to_jax(pm, pm.params)
    _changes_close(p0, pj, pp, frac, "params")
    sj = jax.tree.map(np.asarray, jm.opt_state)
    sp = opt_state_to_jax(pm, pm.opt_state)
    assert set(sp) == set(sj)
    for k in sj:
        if k == "step":
            assert int(sp[k]) == int(sj[k]) == STEPS
        else:
            _changes_close(None, sj[k], sp[k], frac, k)
    # the state round-trips through the JAX layout bitwise
    again = opt_state_to_jax(pm, opt_state_from_jax(pm, sp))
    for k in sp:
        if k != "step":
            for op in sp[k]:
                for pn in sp[k][op]:
                    np.testing.assert_array_equal(again[k][op][pn],
                                                  sp[k][op][pn])
    if layout == "concat":
        untouched = np.setdiff1d(np.arange(16384), sorted(touched))
        got = pm.params["emb_concat"]["kernel"].numpy()
        start = params_from_jax(pm, p0)["emb_concat"]["kernel"].numpy()
        np.testing.assert_array_equal(got[untouched], start[untouched])
        for k, slab in (pm.opt_state or {}).items():
            if k != "step":
                assert not slab["emb_concat"]["kernel"][untouched].any()
