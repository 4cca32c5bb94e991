"""Host tables and the online loop across ranks, against the JAX package.

One spawn of 2 gloo ranks (``utils.testing.spawn_ranks``) runs every
scenario; the JAX models run on a mesh of 2 of ``conftest.py``'s virtual
CPU devices, and the ranks start from the JAX models' weights. Narrow
shapes: non-uniform tables [300, 1024, 77, 4000, 9, 2500] (one
concatenated table), 8 uniform tables of 512 rows (stacked), d = 16,
batch 32, MLPs of 16, plain SGD (the host tables: SGD with momentum 0.9).

Held, and why:

- host-resident tables at world 2, exact mode, 4 steps, momentum 0.9:
  each rank keeps the table whole and gathers its own rows; the global
  batch's ids and row cotangents are all-gathered in rank order and
  every rank applies the same update, so the host table and the MLPs
  are BITWISE the same ranks' device-table run (the concatenated table
  in row blocks, whose split update is bitwise the one-card update of
  the whole table: a row's lookups summed in batch order from 0, then
  the row math). Under plain SGD they are not, at one card either: the
  host scatter applies a row's lookups one after another, as the JAX
  package's host path does, (t - lr·u1) - lr·u2, where the device
  kernels form t - lr·(u1 + u2). The
  two ranks' copies are bitwise equal, and the run is within rtol 1e-5,
  atol 1e-7 of JAX's host-table run on the mesh (the MLPs' gradients
  sum in another order); async mode keeps the copies bitwise equal;
- ``fit_stream`` at world 2 publishing through a ``DeltaPublisher``
  (every 2 steps, a full snapshot after 3 deltas) for row-sharded
  tables (the dense exchange), the hybrid (a hot head), the
  concatenated table in row blocks and the stacked tables by table:
  rank 0 writes the files and entries JAX's mesh run writes, each delta
  with the same touched rows (``idx/``) and its values within rtol
  1e-5, atol 1e-7; full files with the same keys and values within the
  same tolerance; the other rank writes nothing;
- a one-card engine with ``ServeConfig(reshard=True)`` follows those
  publishes through the watcher (the full base, then the delta chain)
  and serves the trainer's gathered parameters BITWISE; without
  ``reshard`` it rejects the full snapshot with the JAX package's
  reason. The hybrid's files hold the cold rows and the hot head apart,
  as the JAX mesh's do, which a one-card model does not hold: no engine
  follows them, in either package.
"""

import json
import os
import threading

import numpy as np
import pytest

# The ranks are spawned processes that import this module to find
# _rank_run: the JAX package is imported in the functions that use it.

SIZES = [300, 1024, 77, 4000, 9, 2500]
UNIFORM = [512] * 8
HYBRID = [1024] * 4
HOT = 0.125
D, BS, WORLD = 16, 32, 2
LR = 0.1
HOST_STEPS = 4
HOST_MOMENTUM = 0.9
STREAM_STEPS, PUBLISH_EVERY, FULL_EVERY = 8, 2, 3
STREAM_KINDS = ("rowshard", "hybrid", "rows", "table")
ENGINE_KINDS = ("rowshard", "rows", "table")


def _arch(kind):
    sizes = {"rows": SIZES, "table": UNIFORM, "rowshard": UNIFORM,
             "hybrid": HYBRID}[kind]
    return dict(embedding_size=list(sizes), sparse_feature_size=D,
                embedding_bag_size=1, mlp_bot=[4, 16, D],
                mlp_top=[D * (len(sizes) + 1), 16, 1])


def _strategies(kind, model, cfg, world, pkg):
    if kind in ("rows", "table"):
        return pkg["dlrm_strategy"](model, cfg, world)
    PC = pkg["ParallelConfig"]
    hot = HOT if kind == "hybrid" else 0.0
    out = {}
    for op in model.ops:
        nd = op.outputs[0].num_dims if op.outputs else 0
        if type(op).__name__ in ("EmbeddingBagStacked", "Embedding",
                                 "EmbeddingBagConcat"):
            out[op.name] = PC((world,) + (1,) * (nd - 1), param_degree=world,
                              hot_fraction=hot)
        elif nd:
            out[op.name] = PC.data_parallel(nd, world)
    return out


def _data(kind, n, seed):
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, synthetic_batch
    return synthetic_batch(DLRMConfig(**_arch(kind)), n, seed=seed)


def _port_pkg():
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel.pconfig import ParallelConfig
    return dict(dlrm_strategy=dlrm_strategy, ParallelConfig=ParallelConfig)


def _port_model(kind, mesh=None, momentum=0.0, **cfg):
    import dlrm_flexflow_tpu_torch as pt
    from dlrm_flexflow_tpu_torch.core import optimizers
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    dcfg = DLRMConfig(**_arch(kind))
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu", seed=3, **cfg))
    build_dlrm(m, dcfg)
    mesh = mesh or make_mesh()
    m.compile(optimizers.SGDOptimizer(lr=LR, momentum=momentum),
              "mean_squared_error", ["mse"], mesh=mesh,
              strategies=_strategies(kind, m, dcfg, mesh.size, _port_pkg()))
    m.init_layers()
    return m


def _np(t):
    return t.detach().numpy().copy()


# ---- the ranks -----------------------------------------------------------


def _host_runs(rank, sp):
    from dlrm_flexflow_tpu_torch.utils.weights import params_from_jax
    p0, table = sp["p0"], sp["table"]
    out = {}
    dev = _port_model("rows", momentum=HOST_MOMENTUM)
    dev.swap_params(params_from_jax(dev, {**p0, "emb_concat": {
        "kernel": table}}))
    for b in sp["batches"]:
        dev.train_batch(b)
    with dev._as_one_card() as whole:
        out["device_table"] = _np(whole["emb_concat"]["kernel"])
    out["device_mlp"] = {f"{o}.{p}": _np(v) for o, d in dev.params.items()
                         if o != "emb_concat" for p, v in d.items()}
    for mode, asyn in (("exact", False), ("async", True)):
        hm = _port_model("rows", momentum=HOST_MOMENTUM,
                         host_resident_tables=True,
                         host_tables_async=asyn)
        hm.swap_params(params_from_jax(hm, p0),
                       host_params={"emb_concat": {"kernel": table.copy()}})
        losses = [float(hm.train_batch(b)["loss"]) for b in sp["batches"]]
        hm._host_drain()
        q = sp["batches"][0]
        preds = {n: hm.forward_batch({k: v[:n] for k, v in q.items()
                                      if k != "label"}).numpy().copy()
                 for n in (BS, BS - 1)}
        out[mode] = {"losses": losses, "preds": preds,
                     "table": hm.host_params["emb_concat"]["kernel"].copy(),
                     "mlp": {f"{o}.{p}": _np(v)
                             for o, d in hm.params.items()
                             for p, v in d.items()},
                     "host": [op.name for op in hm._host_resident_list],
                     "splits": {op.name: getattr(op, "_split", None)
                                is not None for op in hm.ops}}
    return out


def _stream_runs(rank, kind, sp):
    from dlrm_flexflow_tpu_torch.data.stream import ArrayStream
    from dlrm_flexflow_tpu_torch.utils.delta import (DeltaPublisher,
                                                     serving_flat)
    from dlrm_flexflow_tpu_torch.utils.weights import params_from_jax
    m = _port_model(kind)
    m.swap_params(params_from_jax(m, sp["p0"]))
    x, y = sp["data"]
    pub = DeltaPublisher(m, sp["dir"], full_every=FULL_EVERY,
                         compact_frac=100.0)
    r = m.fit_stream(ArrayStream(x, y, BS, seed=2), steps=STREAM_STEPS,
                     publisher=pub, publish_every=PUBLISH_EVERY,
                     verbose=False)
    flat = serving_flat(m)
    op = next(o for o in m.ops if hasattr(o, "delta_touched_rows"))
    resumed = None
    if kind == "rows":
        # a fresh model resumes the stream from the publisher's newest full
        # snapshot (step PUBLISH_EVERY) and trains to the same end
        import shutil

        import torch.distributed as dist
        again = sp["dir"] + "-resumed"
        if rank == 0:          # a copy: the new publisher retires the chain
            shutil.copytree(sp["dir"], again)
        dist.barrier()
        m2 = _port_model(kind)
        pub2 = DeltaPublisher(m2, again, full_every=FULL_EVERY,
                              compact_frac=100.0)
        r2 = m2.fit_stream(ArrayStream(x, y, BS, seed=2),
                           steps=STREAM_STEPS - PUBLISH_EVERY,
                           publisher=pub2, publish_every=PUBLISH_EVERY,
                           verbose=False, resume=True)
        got = serving_flat(m2)
        resumed = {"steps": r2["steps"], "step": m2._step,
                   "bitwise": None if got is None else all(
                       np.array_equal(v, flat[k]) for k, v in got.items())}
    return {"touched": op.delta_touched_rows(sp["touch_ids"]),
            "resumed": resumed,
            "steps": r["steps"], "publishes": r["publishes"],
            "stats": pub.stats(), "flat": flat,
            "row_plans": [op.name for op in m.ops
                          if getattr(op, "_row_plan", None) is not None],
            "hot": {op.name: op._hot_rows for op in m.ops
                    if getattr(op, "_row_plan", None) is not None}}


def _rank_run(rank, world, specs):
    out = {"host": _host_runs(rank, specs["host"]), "stream": {}}
    for kind in STREAM_KINDS:
        out["stream"][kind] = _stream_runs(rank, kind, specs["stream"][kind])
    return out


# ---- the JAX side ----------------------------------------------------------


def _jax_pkg():
    from dlrm_flexflow_tpu.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu.parallel.pconfig import ParallelConfig
    return dict(dlrm_strategy=dlrm_strategy, ParallelConfig=ParallelConfig)


def _jax_model(kind, momentum=0.0, **cfg):
    import jax

    import dlrm_flexflow_tpu as ff
    from dlrm_flexflow_tpu.models.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu.parallel.mesh import make_mesh
    dcfg = DLRMConfig(**_arch(kind))
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=5, **cfg))
    build_dlrm(m, dcfg)
    m.compile(ff.SGDOptimizer(lr=LR, momentum=momentum),
              "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:WORLD]),
              strategies=_strategies(kind, m, dcfg, WORLD, _jax_pkg()))
    m.init_layers()
    return m


def _np_tree(t):
    import jax
    return jax.tree.map(np.asarray, t)


def _touch_ids(kind):
    """A batch's ids for the tables of ``kind``, the hot head's edge and
    the last rows among them."""
    sizes = _arch(kind)["embedding_size"]
    rng = np.random.RandomState(8)
    ids = np.stack([rng.randint(0, n, size=BS) for n in sizes], axis=1)
    ids[0] = 0
    ids[1] = [min(127, n - 1) for n in sizes]
    ids[2] = [min(128, n - 1) for n in sizes]
    ids[3] = [n - 1 for n in sizes]
    return ids[:, :, None]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from dlrm_flexflow_tpu.data.stream import ArrayStream as JaxStream
    from dlrm_flexflow_tpu.utils.delta import DeltaPublisher as JaxPublisher
    from dlrm_flexflow_tpu_torch.utils.testing import spawn_ranks
    tmp = tmp_path_factory.mktemp("fitranks_stream")
    # host tables: the JAX host model's own weights for every run
    jh = _jax_model("rows", momentum=HOST_MOMENTUM,
                    host_resident_tables=True,
                    host_tables_async=False)
    batches = []
    for s in range(HOST_STEPS):
        bx, by = _data("rows", BS, 50 + s)
        batches.append({**bx, "label": by})
    host = {"p0": _np_tree(jh.params),
            "table": np.array(jh.host_params["emb_concat"]["kernel"]),
            "batches": batches}
    specs = {"host": host, "stream": {}}
    jms = {}
    for kind in STREAM_KINDS:
        jm = _jax_model(kind)
        jms[kind] = jm
        x, y = _data(kind, BS * 6, 60)
        specs["stream"][kind] = {"p0": _np_tree(jm.params), "data": (x, y),
                                 "dir": str(tmp / f"port-{kind}"),
                                 "touch_ids": _touch_ids(kind)}
    box = {}

    def ranks():
        try:
            box["ranks"] = spawn_ranks(_rank_run, WORLD, tmp, timeout_s=400,
                                       args=(specs,))
        except BaseException as e:     # raised below, in the test
            box["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    jax_out = {}
    try:
        losses = [float(jh.train_batch(dict(b))["loss"]) for b in batches]
        jh._host_drain()
        jax_out["host"] = {
            "losses": losses,
            "table": np.array(jh.host_params["emb_concat"]["kernel"]),
            "params": _np_tree(jh.params)}
        for kind, jm in jms.items():
            x, y = specs["stream"][kind]["data"]
            d = str(tmp / f"jax-{kind}")
            pub = JaxPublisher(jm, d, full_every=FULL_EVERY,
                               compact_frac=100.0)
            jm.fit_stream(JaxStream(x, y, BS, seed=2), steps=STREAM_STEPS,
                          publisher=pub, publish_every=PUBLISH_EVERY,
                          verbose=False)
            jax_out[kind] = d
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "jax": jax_out, "specs": specs}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-7, err_msg=what)


# ---- host tables -----------------------------------------------------------


def test_host_tables_are_bitwise_the_device_table_run(run):
    """Exact mode: every rank's host table and MLPs bitwise the same
    ranks' device-table run (the table gathered whole); the host op is
    whole on every rank, the device run's table split in row blocks."""
    for r in run["ranks"]:
        h = r["host"]
        ex = h["exact"]
        assert ex["host"] == ["emb_concat"]
        assert not ex["splits"]["emb_concat"]
        np.testing.assert_array_equal(ex["table"], h["device_table"])
        for k, v in h["device_mlp"].items():
            np.testing.assert_array_equal(ex["mlp"][k], v, err_msg=k)


@pytest.mark.parametrize("mode", ["exact", "async"])
def test_the_ranks_copies_of_a_host_table_stay_bitwise_equal(run, mode):
    """Every rank applies the global batch's update: the copies and the
    MLPs stay bitwise equal, the losses are the same on both ranks."""
    a, b = (r["host"][mode] for r in run["ranks"])
    np.testing.assert_array_equal(a["table"], b["table"])
    assert a["losses"] == b["losses"]
    assert np.isfinite(a["losses"]).all()
    for k in a["mlp"]:
        np.testing.assert_array_equal(a["mlp"][k], b["mlp"][k], err_msg=k)


def test_host_tables_match_the_jax_mesh(run):
    """Exact mode against JAX's host-table run on the mesh: the losses,
    the host table and the MLPs within rtol 1e-5, atol 1e-7."""
    ex = run["ranks"][0]["host"]["exact"]
    j = run["jax"]["host"]
    _close(ex["losses"], j["losses"], "losses")
    _close(ex["table"], j["table"], "host table")
    for op, d in j["params"].items():
        for pn, v in d.items():
            _close(ex["mlp"][f"{op}.{pn}"], v, f"{op}.{pn}")


# ---- the online loop -------------------------------------------------------


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def _arrays(path):
    from dlrm_flexflow_tpu_torch.utils.checkpoint import read_npz
    return read_npz(path)


@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_stream_publishes_are_the_jax_mesh_publishes(run, kind):
    """The port's files and entries against JAX's: the same chain (kinds
    and steps), each delta's keys and touched rows the same, their values
    and the full files' arrays within rtol 1e-5, atol 1e-7."""
    r0, r1 = (r["stream"][kind] for r in run["ranks"])
    assert r0["steps"] == r1["steps"] == STREAM_STEPS
    assert r0["publishes"] == r1["publishes"] == STREAM_STEPS // PUBLISH_EVERY
    assert r1["flat"] is None                     # rank 0 gathers
    if kind in ("rowshard", "hybrid"):
        assert r0["row_plans"] == ["emb_stack"]
        assert r0["hot"]["emb_stack"] == (128 if kind == "hybrid" else 0)
    pd, jd = run["specs"]["stream"][kind]["dir"], run["jax"][kind]
    pm, jm = _manifest(pd), _manifest(jd)
    assert [e["step"] for e in pm["entries"]] == \
        [e["step"] for e in jm["entries"]]
    assert [e["step"] for e in pm["deltas"]] == \
        [e["step"] for e in jm["deltas"]] != []
    assert [e["fingerprint"] for e in pm["deltas"]] == \
        [e["fingerprint"] for e in jm["deltas"]]
    for pe, je in zip(pm["deltas"], jm["deltas"]):
        assert pe["touched_rows"] == je["touched_rows"]
        assert pe["full_arrays"] == je["full_arrays"]
        pa = _arrays(os.path.join(pd, pe["file"]))
        ja = _arrays(os.path.join(jd, je["file"]))
        assert sorted(pa) == sorted(ja)
        for k in ja:
            if k.startswith("idx/") or k.startswith("meta/"):
                np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
            else:
                _close(pa[k], ja[k], f"{pe['file']} {k}")
    for pe, je in zip(pm["entries"], jm["entries"]):
        pa = _arrays(os.path.join(pd, pe["file"]))
        ja = _arrays(os.path.join(jd, je["file"]))
        assert sorted(pa) == sorted(ja)
        for k in ja:
            _close(pa[k], ja[k], f"{pe['file']} {k}")
    assert pm["entries"][-1]["mesh"]["num_devices"] == WORLD


@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_a_reshard_engine_serves_the_trainer_bitwise(run, kind):
    """A one-card engine with reshard=True installs the full base and the
    delta chain and holds the trainer's gathered parameters bitwise;
    without reshard it rejects the full snapshot with the JAX package's
    reason."""
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.serve.engine import (InferenceEngine,
                                                      ServeConfig)
    from dlrm_flexflow_tpu_torch.serve.watcher import SnapshotWatcher
    from dlrm_flexflow_tpu_torch.utils.weights import params_to_jax
    d = run["specs"]["stream"][kind]["dir"]
    want = run["ranks"][0]["stream"][kind]["flat"]
    model = _port_model(kind, mesh=make_mesh(devices=[0]))
    eng = InferenceEngine(model, ServeConfig(max_batch=8, warmup=False,
                                             reshard=True))
    w = SnapshotWatcher(eng, d, elastic=eng.config.reshard)
    assert w.poll_once() and eng.version == STREAM_STEPS
    assert w.stats()["delta_installs"] >= 1
    got = params_to_jax(model, model.params)
    for op, dd in got.items():
        for pn, v in dd.items():
            np.testing.assert_array_equal(v, want[f"params/{op}/{pn}"],
                                          err_msg=f"{op}.{pn}")
    plain = InferenceEngine(_port_model(kind, mesh=make_mesh(devices=[0])),
                            ServeConfig(max_batch=8, warmup=False))
    wp = SnapshotWatcher(plain, d)
    assert not wp.poll_once()
    assert "2-device mesh" in wp.stats()["last_reload_error"]
    assert ServeConfig.from_config(model.config).reshard is False


@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_touched_rows_map_as_the_jax_op(run, kind):
    """The publisher's candidates: the rows of the JAX stored array a
    batch touches, as the JAX op on the mesh maps them (a row-sharded
    hybrid's cold rows only, offset by its hot head and packed)."""
    op = next(o for o in _jax_model(kind).ops
              if hasattr(o, "delta_touched_rows"))
    want = op.delta_touched_rows(run["specs"]["stream"][kind]["touch_ids"])
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["stream"][kind]["touched"], want)


def test_a_host_table_model_serves_every_row_across_ranks(run):
    """``forward_batch`` of the world-2 host-table model gives every rank
    every row's prediction, for a batch that divides over the ranks and
    for one that does not (each rank then runs it whole), as a one-rank
    model holding the same tables and weights does."""
    import torch

    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    ex = run["ranks"][0]["host"]["exact"]
    one = _port_model("rows", mesh=make_mesh(devices=[0]),
                      momentum=HOST_MOMENTUM, host_resident_tables=True,
                      host_tables_async=False)
    one.swap_params({o: {p: torch.from_numpy(ex["mlp"][f"{o}.{p}"])
                         for p in d} for o, d in one.params.items()},
                    host_params={"emb_concat": {"kernel": ex["table"]}})
    q = run["specs"]["host"]["batches"][0]
    for n in (BS, BS - 1):
        want = one.forward_batch({k: v[:n] for k, v in q.items()
                                  if k != "label"}).numpy()
        for r in run["ranks"]:
            got = r["host"]["exact"]["preds"][n]
            assert got.shape == want.shape == (n, 1)
            _close(got, want, f"{n} rows")


def test_a_resumed_stream_ends_bitwise_the_uninterrupted_one(run):
    """A fresh world-2 trainer resumes ``fit_stream`` from the publisher's
    newest full snapshot (chosen on rank 0, restored on every rank) and,
    trained to the same end, gathers bitwise the uninterrupted
    trainer's parameters."""
    r0, r1 = (r["stream"]["rows"]["resumed"] for r in run["ranks"])
    assert r0["step"] == r1["step"] == STREAM_STEPS
    assert r0["steps"] == STREAM_STEPS - PUBLISH_EVERY
    assert r0["bitwise"] is True and r1["bitwise"] is None
