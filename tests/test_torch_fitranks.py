"""Training across ranks as ``fit`` runs it, against the JAX package.

One spawn of 2 gloo ranks (``utils.testing.spawn_ranks``) runs every
scenario of the module; the JAX models run on a mesh of 2 of
``conftest.py``'s virtual CPU devices, their initial weights carried
into the ranks by ``params_from_jax`` (a rank takes its piece). Narrow
shapes: non-uniform tables [300, 1024, 77, 4000, 9, 2500] (one
concatenated table, or an ``Embedding`` a table), 8 uniform tables of
512 rows (stacked), 4 of 1,024 rows row-sharded with a hot head of 128
rows (the hybrid), d = 16, batch 32, MLPs of 16; ``fit`` over 6 batches
for 2 epochs (12 steps) under SGD with momentum 0.9 and weight decay
1e-4, a snapshot every 4 steps.

Held, and why:

- ``fit`` against JAX's ``fit`` on the mesh, for each split kind (the
  concatenated table in row blocks, the stacked tables by table, each
  ``Embedding`` by width, the row-sharded hybrid): the epochs' losses
  within rtol 1e-5, and every weight and momentum slab of the final
  snapshot (rank 0's one file, joined from the ranks' pieces) within
  rtol 1e-5, atol 1e-7 of JAX's arrays, as ``test_torch_splitopt.py``
  holds them (the MLPs' gradients sum in another order: each rank's
  share, then over the ranks);
- a ``fit`` stopped by an exception as step 6 begins and resumed by a
  fresh model from the last snapshot (step 4) BITWISE the uninterrupted
  ``fit``, every rank's pieces and slabs, for each kind: the snapshot
  holds every bit and the data position;
- checkpoints both ways: the port's world-2 file restores into a JAX
  2-device model bitwise, under the JAX model's own fingerprint; a JAX
  2-device file restores into the ranks bitwise (each rank's pieces are
  the JAX arrays' pieces); a file recorded under another world is
  rejected, before anything is applied, by the port (either way) and by
  JAX;
- the loaders: each rank's ``.ffbin`` window and ``SingleDataLoader``
  rows, joined in rank order, BITWISE the one-rank loader's batches,
  shuffled or not;
- the sentinel with rank 1's share alone poisoned at step 1: under
  ``skip_step`` and ``raise`` both ranks decide as JAX decides with the
  whole batch's rows of rank 1 poisoned, the norms of the clean steps
  within rtol 1e-5 of JAX's; a ``rollback`` ``fit`` rolls back once on
  both ranks, as JAX's does, and ends BITWISE the clean world-2 ``fit``;
  ``skip_step`` with no anomaly is BITWISE the run without the
  sentinel.
"""

import threading

import numpy as np
import pytest

# The ranks are spawned processes that import this module to find
# _rank_run: the JAX package is imported in the functions that use it.

SIZES = [300, 1024, 77, 4000, 9, 2500]
UNIFORM = [512] * 8
HYBRID = [1024] * 4
HOT = 0.125                      # 1,024 rows, lane pack 8 -> H = 128
D, BS, NB, EPOCHS = 16, 32, 6, 2
SAVE_EVERY, STOP_AT = 4, 6
LR = 0.1
WORLD = 2
KINDS = ("rows", "table", "width", "rowshard")
POISON_STEP = 1
SENTINEL_STEPS = 3


def _arch(kind):
    sizes = {"rows": SIZES, "table": UNIFORM, "width": SIZES,
             "rowshard": HYBRID}[kind]
    return dict(embedding_size=list(sizes), sparse_feature_size=D,
                embedding_bag_size=1, mlp_bot=[4, 16, D],
                mlp_top=[D * (len(sizes) + 1), 16, 1])


def _strategies(kind, model, cfg, world, pkg):
    """dlrm_strategy, or for "rowshard" every table's rows over the mesh
    with a hot head, every other op data-parallel."""
    if kind != "rowshard":
        return pkg["dlrm_strategy"](model, cfg, world)
    PC = pkg["ParallelConfig"]
    out = {}
    for op in model.ops:
        nd = op.outputs[0].num_dims if op.outputs else 0
        if type(op).__name__ in ("EmbeddingBagStacked", "Embedding",
                                 "EmbeddingBagConcat"):
            out[op.name] = PC((world,) + (1,) * (nd - 1), param_degree=world,
                              hot_fraction=HOT)
        elif nd:
            out[op.name] = PC.data_parallel(nd, world)
    return out


def _opt(pkg):
    return pkg.SGDOptimizer(lr=LR, momentum=0.9, weight_decay=1e-4)


def _data(kind, n=BS * NB, seed=7):
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, synthetic_batch
    return synthetic_batch(DLRMConfig(**_arch(kind)), n, seed=seed)


def _port_pkg():
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel.pconfig import ParallelConfig
    return dict(dlrm_strategy=dlrm_strategy, ParallelConfig=ParallelConfig)


def _port_model(kind, mesh=None, policy="none", **cfg):
    import dlrm_flexflow_tpu_torch as pt
    from dlrm_flexflow_tpu_torch.core import optimizers
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    dcfg = DLRMConfig(**_arch(kind))
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu", seed=3,
                               anomaly_policy=policy, stage_dataset="never",
                               **cfg))
    build_dlrm(m, dcfg, fuse_embeddings=kind != "width")
    mesh = mesh or make_mesh()
    m.compile(_opt(optimizers), "mean_squared_error", ["mse"], mesh=mesh,
              strategies=_strategies(kind, m, dcfg, mesh.size, _port_pkg()))
    return m


def _pieces(m):
    """This rank's parameters and slabs, in the port's layout, numpy."""
    out = {f"{o}.{p}": v.detach().numpy().copy()
           for o, d in m.params.items() for p, v in d.items()}
    for k, tree in (m.opt_state or {}).items():
        if k != "step":
            out.update({f"{k}:{o}.{p}": v.detach().numpy().copy()
                        for o, d in tree.items() for p, v in d.items()})
    return out


class _Stop(RuntimeError):
    pass


def _stop_at(m, step):
    """Make ``m``'s steps raise as step ``step`` begins."""
    for name in ("train_batch", "train_batch_device", "train_batch_staged"):
        inner = getattr(m, name)

        def hooked(*a, _inner=inner, **kw):
            if m._step == step:
                raise _Stop(f"stopped at step {step}")
            return _inner(*a, **kw)

        setattr(m, name, hooked)


# ---- the ranks -----------------------------------------------------------


def _fit_runs(rank, kind, sp, tmp):
    """The fit scenarios of one kind on this rank."""
    import json
    import os

    from dlrm_flexflow_tpu_torch.utils.checkpoint import restore_checkpoint
    from dlrm_flexflow_tpu_torch.utils.weights import (opt_state_to_jax,
                                                       params_from_jax,
                                                       params_to_jax)
    x, y = sp["data"]
    kw = dict(epochs=EPOCHS, batch_size=BS, verbose=False,
              save_every=SAVE_EVERY, keep_last=2)
    res = {}
    # against JAX: from JAX's initial weights
    m = _port_model(kind)
    m.init_layers()
    m.swap_params(params_from_jax(m, sp["p0"]))
    d = os.path.join(tmp, f"fit-{kind}")
    if rank == 0:
        # a crashed writer's temp file: rank 0's manager sweeps it
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, "ckpt-00000001.npz.tmp-99999"), "w").close()
    r = m.fit(x, y, checkpoint_dir=d, **kw)
    res["listing"] = sorted(os.listdir(d))
    res["metrics"] = r["metrics"]
    res["splits"] = {op.name: (getattr(op, "_split", None) or
                               getattr(op, "_row_plan", None)) is not None
                     for op in m.ops}
    res["whole"] = _pieces(m)
    if rank == 0:
        man = json.load(open(os.path.join(d, "manifest.json")))
        res["entry"] = man["entries"][-1]
        res["file"] = os.path.join(d, man["entries"][-1]["file"])
    # stopped as step STOP_AT begins, then resumed by a fresh model
    m2 = _port_model(kind)
    m2.init_layers()
    m2.swap_params(params_from_jax(m2, sp["p0"]))
    d2 = os.path.join(tmp, f"stop-{kind}")
    _stop_at(m2, STOP_AT)
    try:
        m2.fit(x, y, checkpoint_dir=d2, **kw)
        res["stopped"] = False
    except _Stop:
        res["stopped"] = True
    m3 = _port_model(kind)
    m3.init_layers()
    r3 = m3.fit(x, y, checkpoint_dir=d2, **kw)
    res["resumed_steps"] = m3._step
    res["resumed_samples"] = r3["num_samples"]
    mine, ref = _pieces(m3), res["whole"]
    res["resume_bitwise"] = {k: np.array_equal(v, ref[k])
                             for k, v in mine.items()}
    # a JAX 2-device file into the ranks: each rank takes its pieces
    m4 = _port_model(kind)
    m4.init_layers()
    restore_checkpoint(m4, sp["jax_file"])
    res["from_jax"] = {"params": params_to_jax(m4, m4.params),
                       "opt": opt_state_to_jax(
                           m4, {k: v for k, v in m4.opt_state.items()
                                if k != "step"}),
                       "step": m4._step}
    # a file of another world (JAX, one device) is rejected
    try:
        restore_checkpoint(m4, sp["jax_file1"])
        res["other_world"] = None
    except ValueError as e:
        res["other_world"] = str(e)
    return res


def _loader_runs(rank, world, sp):
    from dlrm_flexflow_tpu_torch.data.dataloader import (FFBinDataLoader,
                                                         SingleDataLoader)
    m = _port_model("rows")
    out = {}
    for shuffle in (False, True):
        ld = FFBinDataLoader(m, sp["ffbin"], shuffle=shuffle, seed=4,
                             sparse_shape=(len(SIZES), 1), prefetch=False)
        out[f"ffbin/{shuffle}"] = [ld.next_host_batch() for _ in range(9)]
        ld.close()
        x, y = sp["data"]
        sl = SingleDataLoader(m, x, y, shuffle=shuffle, seed=4,
                              prefetch=shuffle)
        out[f"single/{shuffle}"] = [sl.next_host_batch() for _ in range(9)]
        sl.close()
    return out


def _sentinel_runs(rank, world, sp, tmp):
    import os

    from dlrm_flexflow_tpu_torch.core.model import AnomalyError
    from dlrm_flexflow_tpu_torch.utils import faults
    from dlrm_flexflow_tpu_torch.utils.weights import params_from_jax
    out = {}

    def poisoned(steps):
        plan = faults.FaultPlan(nan_grad_steps=set(steps)) if rank == 1 \
            else None
        return faults.active_plan(plan)

    def model(policy):
        m = _port_model("rows", policy=policy)
        m.init_layers()
        m.swap_params(params_from_jax(m, sp["p0"]))
        return m

    for policy in ("skip_step", "raise"):
        m = model(policy)
        got = []
        with poisoned({POISON_STEP}):
            for b in sp["batches"]:
                try:
                    mets = m.train_batch(b)
                    got.append((bool(mets["anomaly"]),
                                float(mets["grad_norm"]),
                                float(mets["loss"])))
                except AnomalyError as e:
                    got.append(("raised", e.step))
        out[policy] = got
        out[f"{policy}/params"] = _pieces(m)
    # skip_step with no anomaly against no sentinel
    a, b = model("skip_step"), model("none")
    for batch in sp["batches"]:
        a.train_batch(batch)
        b.train_batch(batch)
    pa, pb = _pieces(a), _pieces(b)
    out["no_anomaly_bitwise"] = all(np.array_equal(pa[k], pb[k]) for k in pa)
    # rollback in fit: rank 1's share poisoned at step 5
    x, y = sp["data"]
    kw = dict(epochs=1, batch_size=BS, verbose=False, save_every=2)
    rb = model("rollback")
    with poisoned({5}):
        r = rb.fit(x, y, checkpoint_dir=os.path.join(tmp, "rollback"), **kw)
    clean = model("none")
    clean.fit(x, y, **kw)
    out["rollbacks"] = r["rollbacks"]
    out["rollback_steps"] = rb._step
    prb, pc = _pieces(rb), _pieces(clean)
    out["rollback_bitwise"] = all(np.array_equal(prb[k], pc[k]) for k in prb)
    return out


LAUNCH_RUNS = {"ffbin": (), "npz": (), "ffbin/ring": ("--prefetch-depth",
                                                     "2"),
               "host": ("--host-tables", "--no-host-tables-async"),
               "host/async": ("--host-tables",),
               "sentinel": ("--anomaly-policy", "skip_step")}


def _launch_flags(sp, run, ndev):
    path = sp["npz"] if run == "npz" else sp["ffbin"]
    extra = LAUNCH_RUNS[run]
    if "--prefetch-depth" not in extra:
        extra = extra + ("--no-prefetch",)
    return ["-ll:gpu", str(ndev), "-b", str(BS), "-e", "1", "--device",
            "cpu", "--lr", str(LR), "--arch-embedding-size",
            "-".join(map(str, SIZES)), "--arch-sparse-feature-size", str(D),
            "--arch-mlp-bot", "4-16-16",
            "--arch-mlp-top", f"{D * (len(SIZES) + 1)}-16-1",
            "--data-path", path] + list(extra)


def _launcher_runs(rank, world, sp):
    """The launcher across ranks on each data path and flag set: its
    steps, the epoch's mse, the host table."""
    from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
    out = {}
    for run in LAUNCH_RUNS:
        r = launcher.main(_launch_flags(sp, run, world))
        m = r["model"]
        out[run] = {"steps": r["steps"], "mse": m.perf.report()["mse"],
                    "world": m.mesh.size,
                    "host": {k: v["kernel"].copy()
                             for k, v in m.host_params.items()},
                    "splits": {op.name: op._split.kind for op in m.ops
                               if getattr(op, "_split", None) is not None}}
    return out


def _rank_run(rank, world, specs, tmp):
    out = {"fit": {}}
    out["launcher"] = _launcher_runs(rank, world, specs["loaders"])
    for kind in KINDS:
        out["fit"][kind] = _fit_runs(rank, kind, specs["fit"][kind], tmp)
    out["loaders"] = _loader_runs(rank, world, specs["loaders"])
    out["sentinel"] = _sentinel_runs(rank, world, specs["sentinel"], tmp)
    return out


# ---- the JAX side ----------------------------------------------------------


def _jax_pkg():
    from dlrm_flexflow_tpu.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu.parallel.pconfig import ParallelConfig
    return dict(dlrm_strategy=dlrm_strategy, ParallelConfig=ParallelConfig)


def _jax_model(kind, world=WORLD, policy="none"):
    import jax

    import dlrm_flexflow_tpu as ff
    from dlrm_flexflow_tpu.models.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu.parallel.mesh import make_mesh
    cfg = DLRMConfig(**_arch(kind))
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=5, anomaly_policy=policy))
    build_dlrm(m, cfg, fuse_embeddings=kind != "width")
    m.compile(_opt(ff), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:world]),
              strategies=_strategies(kind, m, cfg, world, _jax_pkg()))
    m.init_layers()
    return m


def _np_tree(t):
    import jax
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results beside the JAX runs: {"ranks", "jax", "specs",
    "tmp"}."""
    from dlrm_flexflow_tpu.utils import checkpoint as jax_ckpt
    from dlrm_flexflow_tpu.utils import faults as jax_faults
    from dlrm_flexflow_tpu_torch.data.dataloader import write_ffbin
    from dlrm_flexflow_tpu_torch.utils.testing import spawn_ranks
    tmp = tmp_path_factory.mktemp("fitranks")
    specs = {"fit": {}}
    jms = {}
    for kind in KINDS:
        jm = _jax_model(kind)
        jms[kind] = jm
        x, y = _data(kind)
        sp = {"data": (x, y), "p0": _np_tree(jm.params)}
        # a JAX 2-device file after one step, and a 1-device one
        j2 = _jax_model(kind)
        j2.train_batch({k: v[:BS] for k, v in {**x, "label": y}.items()})
        sp["jax_file"] = str(tmp / f"jax2-{kind}.npz")
        jax_ckpt.save_checkpoint(j2, sp["jax_file"])
        sp["jax_arrays"] = {"params": _np_tree(j2.params),
                            "opt": {k: _np_tree(v)
                                    for k, v in j2.opt_state.items()
                                    if k != "step"},
                            "step": int(j2._step)}
        j1 = _jax_model(kind, world=1)
        sp["jax_file1"] = str(tmp / f"jax1-{kind}.npz")
        jax_ckpt.save_checkpoint(j1, sp["jax_file1"])
        specs["fit"][kind] = sp
    x, y = _data("rows", n=BS * 4 + 8, seed=9)
    path = str(tmp / "data.ffbin")
    write_ffbin(path, x["dense"], x["sparse"], y)
    npz = str(tmp / "data.npz")
    np.savez(npz, dense=x["dense"], sparse=x["sparse"], label=y)
    specs["loaders"] = {"ffbin": path, "npz": npz, "data": (x, y)}
    js = _jax_model("rows", policy="skip_step")
    batches = []
    for s in range(SENTINEL_STEPS):
        bx, by = _data("rows", n=BS, seed=30 + s)
        batches.append({**bx, "label": by})
    sx, sy = _data("rows", n=BS * 8, seed=11)
    specs["sentinel"] = {"p0": _np_tree(js.params), "batches": batches,
                         "data": (sx, sy)}
    box = {}

    def ranks():
        try:
            box["ranks"] = spawn_ranks(_rank_run, WORLD, tmp, timeout_s=400,
                                       args=(specs, str(tmp)))
        except BaseException as e:     # raised below, in the test
            box["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    jax_out = {"fit": {}}
    try:
        for kind, jm in jms.items():
            x, y = specs["fit"][kind]["data"]
            r = jm.fit(x, y, epochs=EPOCHS, batch_size=BS, verbose=False)
            jax_out["fit"][kind] = {
                "metrics": r["metrics"],
                "params": _np_tree(jm.params),
                "opt": {k: _np_tree(v) for k, v in jm.opt_state.items()
                        if k != "step"},
                "model": jm}
        sent = {}
        for policy in ("skip_step", "raise"):
            jm = _jax_model("rows", policy=policy)
            got = []
            for i, b in enumerate(batches):
                b = dict(b)
                if i == POISON_STEP:
                    lab = np.array(b["label"], np.float32)
                    lab[BS // WORLD:] = np.nan       # rank 1's rows
                    b["label"] = lab
                try:
                    mets = jm.train_batch(b)
                    got.append((bool(mets["anomaly"]),
                                float(mets["grad_norm"]),
                                float(mets["loss"])))
                except Exception as e:      # noqa: BLE001 (AnomalyError)
                    got.append(("raised", getattr(e, "step", None)))
            sent[policy] = got
        jr = _jax_model("rows", policy="rollback")
        with jax_faults.active_plan(jax_faults.FaultPlan(nan_grad_steps={5})):
            r = jr.fit(sx, sy, epochs=1, batch_size=BS, verbose=False,
                       save_every=2, checkpoint_dir=str(tmp / "jax_rb"))
        sent["rollbacks"] = r["rollbacks"]
        jax_out["sentinel"] = sent
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "jax": jax_out, "specs": specs,
            "tmp": tmp}


def _close(got, want, what, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _file_arrays(path):
    from dlrm_flexflow_tpu_torch.utils.checkpoint import read_npz
    return read_npz(path)


# ---- fit against JAX -------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_fit_as_the_jax_mesh(run, kind):
    """The epochs' loss and every weight and momentum slab of the final
    snapshot (rank 0's file, joined from the pieces) against JAX's
    ``fit`` on the 2-device mesh."""
    r0 = run["ranks"][0]["fit"][kind]
    j = run["jax"]["fit"][kind]
    assert any(r0["splits"].values()), "the kind splits no op"
    _close(r0["metrics"]["mse"], j["metrics"]["mse"], "epoch mse")
    flat = _file_arrays(r0["file"])
    assert int(flat["meta/num_devices"]) == WORLD
    assert int(flat["meta/step"]) == NB * EPOCHS
    for op, d in j["params"].items():
        for pn, v in d.items():
            _close(flat[f"params/{op}/{pn}"], v, f"{op}.{pn}")
    for slab, tree in j["opt"].items():
        for op, d in tree.items():
            for pn, v in d.items():
                _close(flat[f"opt/{slab}/{op}/{pn}"], v,
                       f"{slab}:{op}.{pn}")
    assert run["ranks"][1]["fit"][kind].get("file") is None   # rank 0 writes


@pytest.mark.parametrize("kind", KINDS)
def test_resumed_fit_is_bitwise_the_uninterrupted_one(run, kind):
    """Stopped as step 6 begins, resumed by a fresh model from the step-4
    snapshot: every rank's pieces and slabs bitwise the uninterrupted
    fit's, 12 steps in all."""
    for r in run["ranks"]:
        res = r["fit"][kind]
        assert res["stopped"]
        assert res["resumed_steps"] == NB * EPOCHS
        assert res["resumed_samples"] == BS * (NB * EPOCHS - SAVE_EVERY)
        bad = [k for k, ok in res["resume_bitwise"].items() if not ok]
        assert not bad, bad


# ---- checkpoints both ways -------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_restores_into_the_jax_mesh(run, kind):
    """The port's world-2 file restores into a JAX 2-device model
    bitwise, and its manifest fingerprint is the JAX model's."""
    from dlrm_flexflow_tpu.utils import checkpoint as jax_ckpt
    r0 = run["ranks"][0]["fit"][kind]
    jm = _jax_model(kind)
    jax_ckpt.restore_checkpoint(jm, r0["file"])
    flat = _file_arrays(r0["file"])
    for op, d in _np_tree(jm.params).items():
        for pn, v in d.items():
            np.testing.assert_array_equal(v, flat[f"params/{op}/{pn}"])
    for slab, tree in jm.opt_state.items():
        if slab == "step":
            continue
        for op, d in _np_tree(tree).items():
            for pn, v in d.items():
                np.testing.assert_array_equal(
                    v, flat[f"opt/{slab}/{op}/{pn}"])
    assert r0["entry"]["fingerprint"] == jax_ckpt.config_fingerprint(jm)
    assert r0["entry"]["mesh"]["num_devices"] == WORLD


@pytest.mark.parametrize("kind", KINDS)
def test_jax_file_restores_into_the_ranks(run, kind):
    """A JAX 2-device file restores into the ranks: each rank's arrays in
    the JAX layout are its pieces of the JAX arrays, and the pieces,
    joined, are the JAX arrays, bitwise; the step carries over."""
    want = run["specs"]["fit"][kind]["jax_arrays"]
    ranks = run["ranks"]
    assert all(r["fit"][kind]["from_jax"]["step"] == want["step"]
               for r in ranks)

    def check(got0, got1, whole, what):
        if got0.shape == whole.shape:
            np.testing.assert_array_equal(got0, whole, err_msg=what)
            np.testing.assert_array_equal(got1, whole, err_msg=what)
            return
        for ax in range(whole.ndim):
            if got0.shape[ax] * WORLD == whole.shape[ax]:
                joined = np.concatenate([got0, got1], axis=ax)
                if np.array_equal(joined, whole):
                    return
        raise AssertionError(f"{what}: the ranks' pieces do not join into "
                             f"the JAX array {whole.shape}")

    p0, p1 = (r["fit"][kind]["from_jax"] for r in ranks)
    for op, d in want["params"].items():
        for pn, v in d.items():
            check(p0["params"][op][pn], p1["params"][op][pn], v,
                  f"{op}.{pn}")
    for slab, tree in want["opt"].items():
        for op, d in tree.items():
            for pn, v in d.items():
                check(p0["opt"][slab][op][pn], p1["opt"][slab][op][pn], v,
                      f"{slab}:{op}.{pn}")


@pytest.mark.parametrize("kind", KINDS)
def test_a_file_of_another_world_is_rejected(run, kind):
    """A JAX 1-device file into the ranks, the port's world-2 file into a
    one-rank port model and into a JAX 1-device model: each rejected
    with the JAX package's reason, the model untouched."""
    from dlrm_flexflow_tpu.utils import checkpoint as jax_ckpt
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.utils.checkpoint import restore_checkpoint
    for r in run["ranks"]:
        msg = r["fit"][kind]["other_world"]
        assert msg is not None and "1-device mesh" in msg \
            and "7.5" in msg, msg
    path = run["ranks"][0]["fit"][kind]["file"]
    m = _port_model(kind, mesh=make_mesh(devices=[0]))
    m.init_layers()
    before = _pieces(m)
    with pytest.raises(ValueError, match="2-device mesh"):
        restore_checkpoint(m, path)
    after = _pieces(m)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    jm = _jax_model(kind, world=1)
    with pytest.raises(ValueError, match="2-device mesh"):
        jax_ckpt.restore_checkpoint(jm, path)


# ---- the loaders -----------------------------------------------------------


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("loader", ["ffbin", "single"])
def test_rank_shares_join_to_the_one_rank_batches(run, loader, shuffle):
    """Each rank's rows of each global batch, joined in rank order, are
    the one-rank loader's batch, bitwise (the native reader copies only
    the rank's window; the permutation is the same on every rank)."""
    from dlrm_flexflow_tpu_torch.data.dataloader import (FFBinDataLoader,
                                                         SingleDataLoader)
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    sp = run["specs"]["loaders"]
    m = _port_model("rows", mesh=make_mesh(devices=[0]))
    if loader == "ffbin":
        ld = FFBinDataLoader(m, sp["ffbin"], shuffle=shuffle, seed=4,
                             sparse_shape=(len(SIZES), 1), prefetch=False)
    else:
        x, y = sp["data"]
        ld = SingleDataLoader(m, x, y, shuffle=shuffle, seed=4,
                              prefetch=False)
    want = [ld.next_host_batch() for _ in range(9)]
    ld.close()
    got = [r["loaders"][f"{loader}/{shuffle}"] for r in run["ranks"]]
    for i, w in enumerate(want):
        for k, v in w.items():
            assert got[0][i][k].shape[0] == BS // WORLD
            np.testing.assert_array_equal(
                np.concatenate([got[0][i][k], got[1][i][k]]), v,
                err_msg=f"batch {i} {k}")


# ---- the sentinel ----------------------------------------------------------


@pytest.mark.parametrize("policy", ["skip_step", "raise"])
def test_rank1_poisoned_decides_as_jax(run, policy):
    """Rank 1's share poisoned at step 1: both ranks take JAX's decision
    at every step (skip, or raise), and the clean steps' norms and losses
    are within rtol 1e-5 of JAX's."""
    got = [r["sentinel"][policy] for r in run["ranks"]]
    want = run["jax"]["sentinel"][policy]
    assert len(got[0]) == len(got[1]) == len(want) == SENTINEL_STEPS
    for i, (a, b, w) in enumerate(zip(got[0], got[1], want)):
        assert a == b or (a[0] is True and b[0] is True), (i, a, b)
        if w[0] == "raised":
            assert a[0] == b[0] == "raised", (i, a, b, w)
            assert a[1] == b[1] == i
            continue
        assert a[0] == w[0], (i, a, w)
        if w[0]:                         # skipped: non-finite both sides
            assert not np.isfinite(a[1]) and not np.isfinite(w[1])
        else:
            _close(a[1], w[1], f"step {i} norm")
            _close(a[2], w[2], f"step {i} loss")
    assert [g[0] for g in want] == (
        [False, True, False] if policy == "skip_step"
        else [False, "raised", False])


def test_rollback_fit_rolls_back_once_as_jax_and_ends_as_a_clean_fit(run):
    """A rollback ``fit`` with rank 1's share poisoned at step 5 rolls
    back once on both ranks, as JAX's with the step poisoned, trains
    every step, and ends bitwise the clean world-2 ``fit``."""
    for r in run["ranks"]:
        s = r["sentinel"]
        assert s["rollbacks"] == 1 == run["jax"]["sentinel"]["rollbacks"]
        assert s["rollback_steps"] == 8
        assert s["rollback_bitwise"]


def test_skip_step_without_an_anomaly_is_bitwise_no_sentinel(run):
    """The sentinel adds its sum and the loss to the one dense all-reduce:
    with no anomaly the world-2 run is bitwise the run without it."""
    assert all(r["sentinel"]["no_anomaly_bitwise"] for r in run["ranks"])


def test_the_ranks_hold_the_same_replicated_weights(run):
    """After each sentinel run, the weights every rank holds whole (the
    MLPs) are bitwise equal across the ranks."""
    for policy in ("skip_step", "raise"):
        a, b = (r["sentinel"][f"{policy}/params"] for r in run["ranks"])
        for k in a:
            if k.split(".")[0].split(":")[-1].startswith(("bot_", "top_")):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- the launcher ----------------------------------------------------------


@pytest.mark.parametrize("name", list(LAUNCH_RUNS))
def test_the_launcher_trains_from_a_data_file_across_ranks(run, name,
                                                           capsys):
    """``examples/native/dlrm.py`` at -ll:gpu 2 on 2 ranks: from an
    ``.ffbin`` (without and through the ring) and an ``.npz``, with host
    tables (exact and async) and under the sentinel; the epoch's mse the
    same on both ranks and within rtol 1e-5 of the one-rank launcher's
    on the same file and flags (async host tables: finite, their
    staleness timed); host tables whole on each rank, the copies bitwise
    equal, the concatenated table otherwise in row blocks."""
    from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
    sp = run["specs"]["loaders"]
    a, b = (r["launcher"][name] for r in run["ranks"])
    assert a["world"] == b["world"] == WORLD
    assert a["mse"] == b["mse"]
    one = launcher.main(_launch_flags(sp, name, 1))
    assert one["model"].mesh.size == 1
    assert a["steps"] == b["steps"] == one["steps"] >= 4
    if name != "host/async":
        # async mode gathers a step's rows while the previous step's
        # scatter may still run (its bounded one-step staleness): its
        # losses depend on the timing, at one rank or several
        _close(a["mse"], one["model"].perf.report()["mse"], name)
    assert np.isfinite(a["mse"])
    if name.startswith("host"):
        assert a["splits"] == {} and list(a["host"]) == ["emb_concat"]
        np.testing.assert_array_equal(a["host"]["emb_concat"],
                                      b["host"]["emb_concat"])
    else:
        assert a["splits"] == {"emb_concat": "rows"}
    printed = capsys.readouterr().out
    assert "THROUGHPUT" in printed         # the one-rank launcher's report


# ---- the pieces ------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_rank0_keeps_the_directory(run, kind):
    """Rank 0 alone sweeps the orphan temp file, writes the snapshots and
    keeps the last ``keep_last`` (2) with the manifest."""
    listing = run["ranks"][0]["fit"][kind]["listing"]
    assert listing == ["ckpt-00000008.npz", "ckpt-00000012.npz",
                       "manifest.json"], listing


@pytest.mark.parametrize("with_out", [False, True])
def test_grad_sumsq_plain_version_takes_an_addend(with_out):
    """The plain version of the sentinel's norm across ranks: the sum
    over the list plus the addend, copied into ``out``, its root and the
    flag of the loss and the root; a non-finite addend clears the
    flag."""
    import torch

    from dlrm_flexflow_tpu_torch.ops.kernels import dense_update as dm
    g = torch.Generator().manual_seed(4)
    gs = [torch.randn(37, generator=g), torch.randn(5, 3, generator=g)]
    loss = torch.tensor(0.5)
    add = torch.tensor([2.25])
    out = torch.zeros(3) if with_out else None
    gsq, norm, ok = dm.grad_sumsq(gs, loss, addend=add,
                                  out=out[1:2] if with_out else None)
    own, _, _ = dm.grad_sumsq_reference(gs, loss)
    assert torch.equal(gsq, own + add[0])
    assert torch.equal(norm, torch.sqrt(own + add[0])) and int(ok) == 1
    if with_out:
        assert torch.equal(out[1], gsq) and out[0] == 0 and out[2] == 0
    assert int(dm.grad_sumsq(gs, loss,
                             addend=torch.tensor([float("nan")]))[2]) == 0
    with pytest.raises(ValueError, match="one fp32 element"):
        dm.grad_sumsq(gs, loss, addend=torch.zeros(2))
