"""Host-resident embedding tables (``FFConfig.host_resident_tables``,
``--host-tables``) against the JAX package: the tables live in host RAM
as numpy, gathered and updated there around each step, while the dense
part of the model runs on the device.

Modelled on the JAX package's tests/test_host_tables.py. Inputs come
from numpy seeds; dense weights cross by ``params_from_jax``; the host
tables need no carrying: one seed draws the same tables in both
packages.

Tolerances, and why:

- host init: bitwise (the same numpy draws, chunked in the port);
- the host helpers (bag lookup, SGD scatter, the stateful update under
  momentum, nesterov with weight decay, Adam, Adam with weight decay)
  against the JAX package's on the same numpy inputs: bitwise (the same
  numpy expressions; each package's ``ffemb.cc`` build computes the same
  sums in the same order);
- the native ``ffemb.cc`` against the numpy path: bitwise for sum bags
  (both write w - lr·c, sum rows in bag order); "avg" within rtol 1e-6,
  atol 1e-9 (the native code multiplies by 1/bag where numpy divides by
  the bag, and its scatter folds 1/bag into lr: a rounding or two
  apart);
- 3 exact-mode training steps against the JAX package's: the loss within
  rtol 1e-5, every dense parameter's, host table's and host slab's change
  within 1e-3 of its largest change under SGD and momentum, 1e-2 under
  Adam (as tests/test_torch_concat.py, and why); untouched host rows
  bitwise;
- checkpoints across packages: bitwise, both ways.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.ops import embedding as jax_emb
from dlrm_flexflow_tpu.parallel.mesh import make_mesh
from dlrm_flexflow_tpu.utils import checkpoint as jax_ckpt

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch import native
from dlrm_flexflow_tpu_torch.core.optimizers import (AdamOptimizer,
                                                     SGDOptimizer)
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.ops import embedding as emb
from dlrm_flexflow_tpu_torch.utils import checkpoint as ckpt
from dlrm_flexflow_tpu_torch.utils import faults
from dlrm_flexflow_tpu_torch.utils.watchdog import WorkerStalled
from dlrm_flexflow_tpu_torch.utils.weights import (params_from_jax,
                                                   params_to_jax)

BS = 16
UNIFORM = (64,) * 6
NON_UNIFORM = (40, 7, 300, 12, 64, 5)


def _dcfg(sizes=UNIFORM, mode="cat"):
    T, d = len(sizes), 8
    top0 = d + (T * d if mode == "cat" else (T + 1) * T // 2)
    return dict(embedding_size=list(sizes), sparse_feature_size=d,
                mlp_bot=[4, 16, d], mlp_top=[top0, 16, 1],
                arch_interaction_op=mode)


JOPT = {"sgd": lambda: ff.SGDOptimizer(lr=0.1),
        "momentum": lambda: ff.SGDOptimizer(lr=0.1, momentum=0.9,
                                            weight_decay=1e-4),
        "adam": lambda: ff.AdamOptimizer(alpha=0.01)}
POPT = {"sgd": lambda: SGDOptimizer(lr=0.1),
        "momentum": lambda: SGDOptimizer(lr=0.1, momentum=0.9,
                                         weight_decay=1e-4),
        "adam": lambda: AdamOptimizer(alpha=0.01)}


def _jax(arch, opt="sgd", host=True):
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=7,
                               host_resident_tables=host,
                               host_tables_async=False))
    jax_build_dlrm(m, JaxDLRMConfig(**arch))
    m.compile(JOPT[opt](), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers()
    return m


def _port(arch, opt="sgd", host=True, asynchronous=False, params_np=None,
          **cfg):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, seed=7, device="cpu",
                               host_resident_tables=host,
                               host_tables_async=asynchronous, **cfg))
    build_dlrm(m, DLRMConfig(**arch))
    m.compile(POPT[opt](), "mean_squared_error", ["mse"])
    m.init_layers()
    if params_np is not None:
        m.swap_params(params_from_jax(m, params_np))
    return m


def _batch(arch, step, n=BS):
    x, y = synthetic_batch(DLRMConfig(**arch), n, seed=80 + step)
    x["label"] = y
    return x


def _emb_name(model):
    (op,) = model._host_resident_list
    return op.name


# ---------------------------------------------------------------------
# host init
# ---------------------------------------------------------------------
@pytest.mark.parametrize("sizes", [UNIFORM, NON_UNIFORM])
def test_host_init_equals_jax_bitwise(sizes, monkeypatch):
    # a small chunk, so the port's chunked draws are exercised
    monkeypatch.setattr(emb, "_HOST_INIT_CHUNK", 7)
    arch = _dcfg(sizes)
    jm, pm = _jax(arch), _port(arch)
    name = _emb_name(pm)
    assert name == ("emb_stack" if sizes == UNIFORM else "emb_concat")
    assert set(pm.host_params) == set(jm.host_params) == {name}
    assert name not in pm.params and name not in jm.params
    np.testing.assert_array_equal(pm.host_params[name]["kernel"],
                                  jm.host_params[name]["kernel"])
    assert pm.host_params[name]["kernel"].dtype == np.float32
    assert set(params_to_jax(pm, pm.params)) == set(jm.params)
    assert ckpt.config_fingerprint(pm) == jax_ckpt.config_fingerprint(jm)


@pytest.mark.parametrize("init", ["glorot", "uniform", "zero"])
def test_host_init_table_equals_jax_for_each_initializer(init, monkeypatch):
    from dlrm_flexflow_tpu.core import initializers as JI

    from dlrm_flexflow_tpu_torch.core import initializers as PI
    jinit, pinit = {"glorot": (JI.GlorotUniform(), PI.GlorotUniform()),
                    "uniform": (JI.UniformInitializer(min_val=-0.3,
                                                      max_val=0.2),
                                PI.UniformInitializer(-0.3, 0.2)),
                    "zero": (JI.ZeroInitializer(),
                             PI.ZeroInitializer())}[init]
    monkeypatch.setattr(emb, "_HOST_INIT_CHUNK", 5)
    for shape in [(33, 8), (3, 17, 4)]:
        want = jax_emb._host_init_table(jinit, shape, 2 ** 33 + 11)
        got = emb._host_init_table(pinit, shape, 2 ** 33 + 11)
        np.testing.assert_array_equal(got, want)


def test_host_embedding_with_slots_trains_like_jax():
    """An ``Embedding`` of aggr "none" on the host path, as the JAX
    package's test of it."""
    def build(model, itype):
        sl = model.create_tensor((8, 3), dtype=itype, name="slots")
        e = model.embedding(sl, 32, 4, aggr="none", name="emb")
        flat = model.reshape(e, (8, 12), name="flat")
        return model.dense(flat, 1, name="head")

    jm = ff.FFModel(ff.FFConfig(batch_size=8, seed=3,
                                host_resident_tables=True,
                                host_tables_async=False))
    out = build(jm, "int32")
    jm.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
               mesh=make_mesh(devices=jax.devices()[:1]), final_tensor=out)
    jm.init_layers()
    pm = pt.FFModel(pt.FFConfig(batch_size=8, seed=3, device="cpu",
                                host_resident_tables=True,
                                host_tables_async=False))
    out = build(pm, torch.int64)
    pm.compile(SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
               final_tensor=out)
    pm.init_layers()
    np.testing.assert_array_equal(pm.host_params["emb"]["kernel"],
                                  jm.host_params["emb"]["kernel"])
    pm.swap_params(params_from_jax(pm, jax.tree.map(np.asarray,
                                                    jm.params)))
    rng = np.random.RandomState(0)
    for _ in range(3):
        batch = {"slots": rng.randint(0, 32, (8, 3)).astype(np.int32),
                 "label": rng.rand(8, 1).astype(np.float32)}
        jm.train_batch(dict(batch))
        pm.train_batch(dict(batch))
    np.testing.assert_allclose(pm.host_params["emb"]["kernel"],
                               jm.host_params["emb"]["kernel"],
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------
# the host helpers and ffemb.cc
# ---------------------------------------------------------------------
def _table(rows=50, d=8, seed=0):
    return np.random.RandomState(seed).randn(rows, d).astype(np.float32)


def _g(rows=50, shape=(12, 3, 3), seed=1):
    return np.random.RandomState(seed).randint(0, rows, shape).astype(
        np.int64)


@pytest.mark.parametrize("aggr", ["sum", "avg"])
def test_host_lookup_and_sgd_update_equal_jax(aggr, monkeypatch):
    t, g = _table(), _g()
    ct = np.random.RandomState(2).randn(12, 3, 8).astype(np.float32)
    # each package times its own gather route once per shape; pin both to
    # the same route, since "avg" rounds differently on the two
    for route in ("numpy", "native"):
        for mod in (emb, jax_emb):
            monkeypatch.setattr(mod, "_GATHER_CHOICE",
                                {(t.shape, g.shape, aggr): route})
        np.testing.assert_array_equal(emb._host_bag_lookup(t, g, aggr),
                                      jax_emb._host_bag_lookup(t, g, aggr))
    a, b = t.copy(), t.copy()
    emb._host_bag_update(a, g, ct, 0.1, aggr)
    jax_emb._host_bag_update(b, g, ct, 0.1, aggr)
    np.testing.assert_array_equal(a, b)


STATEFUL = {
    "momentum": (lambda: ff.SGDOptimizer(lr=0.1, momentum=0.9),
                 lambda: SGDOptimizer(lr=0.1, momentum=0.9)),
    "nesterov_wd": (lambda: ff.SGDOptimizer(lr=0.1, momentum=0.9,
                                            nesterov=True,
                                            weight_decay=1e-3),
                    lambda: SGDOptimizer(lr=0.1, momentum=0.9,
                                         nesterov=True, weight_decay=1e-3)),
    "wd": (lambda: ff.SGDOptimizer(lr=0.1, weight_decay=1e-3),
           lambda: SGDOptimizer(lr=0.1, weight_decay=1e-3)),
    "adam": (lambda: ff.AdamOptimizer(alpha=0.01),
             lambda: AdamOptimizer(alpha=0.01)),
    "adam_wd": (lambda: ff.AdamOptimizer(alpha=0.01, weight_decay=1e-3),
                lambda: AdamOptimizer(alpha=0.01, weight_decay=1e-3)),
}


@pytest.mark.parametrize("opt", sorted(STATEFUL))
def test_host_stateful_update_equals_jax(opt):
    jopt, popt = STATEFUL[opt][0](), STATEFUL[opt][1]()
    names = popt.sparse_slab_names()
    assert names == jopt.sparse_slab_names()
    rng = np.random.RandomState(3)
    a, b = _table(), _table()
    sa = {k: np.abs(rng.randn(50, 8)).astype(np.float32) for k in names}
    sb = {k: v.copy() for k, v in sa.items()}
    for step in range(3):
        g = _g(seed=10 + step)
        ct = rng.randn(12, 3, 8).astype(np.float32)
        emb._host_stateful_update(a, g, ct, popt, sa, step, "sum")
        jax_emb._host_stateful_update(b, g, ct, jopt, sb, step, "sum")
        np.testing.assert_array_equal(a, b)
        for k in names:
            np.testing.assert_array_equal(sa[k], sb[k])


@pytest.mark.parametrize("aggr", ["sum", "avg"])
@pytest.mark.parametrize("bag", [1, 3])
def test_native_ffemb_equals_numpy(aggr, bag):
    lib = native.get_emb_lib()
    assert native.library_path(native.EMB_SRC).parent.parts[-2:] == (
        "build", "native")
    t = _table(rows=300, d=16)
    g = _g(rows=300, shape=(40, 4, bag))
    same = (np.testing.assert_array_equal if aggr == "sum" else
            lambda x, y: np.testing.assert_allclose(x, y, rtol=1e-6,
                                                    atol=1e-9))
    same(emb._native_gather(lib, t, g, aggr, 16),
         emb._numpy_gather(t, g, aggr, 16))
    ct = np.random.RandomState(4).randn(40, 4, 16).astype(np.float32)
    a, b = t.copy(), t.copy()
    emb._host_bag_update(a, g, ct, 0.05, aggr)       # native
    c = ct / bag if aggr == "avg" else ct
    upd = np.broadcast_to(c[..., None, :], g.shape + (16,))
    np.add.at(b, g.reshape(-1), -0.05 * upd.reshape(-1, 16))
    same(a, b)


def test_the_gather_route_is_timed_once_and_kept(monkeypatch):
    monkeypatch.setattr(emb, "_GATHER_CHOICE", {})
    t, g = _table(), _g()
    out = emb._host_bag_lookup(t, g, "sum")
    assert set(emb._GATHER_CHOICE.values()) <= {"native", "numpy"}
    assert len(emb._GATHER_CHOICE) == 1
    for route in ("native", "numpy"):
        emb._GATHER_CHOICE[next(iter(emb._GATHER_CHOICE))] = route
        np.testing.assert_array_equal(emb._host_bag_lookup(t, g, "sum"), out)


def test_a_failed_ffemb_build_raises(tmp_path, monkeypatch):
    out = tmp_path / "libffemb-x.so"
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffemb.cc cannot be built"):
        native._build(out, native.EMB_SRC)
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------
# training against the JAX package
# ---------------------------------------------------------------------
def _close(before, want, got, frac, where):
    dw, dg = want - before, got - before
    scale = float(np.abs(dw).max())
    err = float(np.abs(dg - dw).max())
    assert err <= frac * scale + 1e-7, (where, err, scale)


@pytest.mark.parametrize("sizes,mode,opt", [
    (UNIFORM, "cat", "sgd"), (NON_UNIFORM, "cat", "sgd"),
    (NON_UNIFORM, "dot", "sgd"), (NON_UNIFORM, "cat", "momentum"),
    (NON_UNIFORM, "dot", "adam"), (UNIFORM, "cat", "adam")])
def test_exact_mode_trains_like_jax(sizes, mode, opt):
    arch = _dcfg(sizes, mode)
    jm = _jax(arch, opt)
    p0 = jax.tree.map(np.asarray, jm.params)
    pm = _port(arch, opt, params_np=p0)
    name = _emb_name(pm)
    h0 = pm.host_params[name]["kernel"].copy()
    np.testing.assert_array_equal(h0, jm.host_params[name]["kernel"])
    frac = 1e-2 if opt == "adam" else 1e-3
    lj, lp, touched = [], [], set()
    for s in range(3):
        b = _batch(arch, s)
        lj.append(float(jm.train_batch(dict(b))["loss"]))
        lp.append(float(pm.train_batch(dict(b))["loss"]))
        op = pm.get_layer_by_name(name)
        touched |= set(op.host_delta_touched_rows(b["sparse"]).tolist())
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    got = pm.host_params[name]["kernel"].reshape(-1, 8)
    want = jm.host_params[name]["kernel"].reshape(-1, 8)
    _close(h0.reshape(-1, 8), want, got, frac, "host table")
    untouched = np.setdiff1d(np.arange(got.shape[0]), sorted(touched))
    np.testing.assert_array_equal(got[untouched],
                                  h0.reshape(-1, 8)[untouched])
    for k in POPT[opt]().sparse_slab_names():
        _close(0.0, jm.host_opt_state[name][k],
               pm.host_opt_state[name][k], frac, k)
    pj = jax.tree.map(np.asarray, jm.params)
    pp = params_to_jax(pm, pm.params)
    assert set(pp) == set(pj)
    for op in pj:
        for pn in pj[op]:
            _close(p0[op][pn], pj[op][pn], pp[op][pn], frac, (op, pn))


def test_host_rows_enter_the_graph_and_the_dense_part_stays_on_device():
    arch = _dcfg(NON_UNIFORM)
    pm = _port(arch)
    b = _batch(arch, 0)
    db = pm._device_batch(b)
    assert db["sparse"].device.type == "cpu"     # never staged
    assert pm._host_only_inputs == {"sparse"}
    rest, host_idx = pm._split_host_idx(db)
    assert "sparse" not in rest and set(host_idx) == {"emb_concat"}
    staged = pm._stage_step(b)
    assert set(staged.wait()) == {"dense", "sparse", "label"}
    assert "sparse" in staged.host


def test_async_mode_trains_and_drains():
    arch = _dcfg(NON_UNIFORM)
    pm = _port(arch, asynchronous=True)
    name = _emb_name(pm)
    before = pm.host_params[name]["kernel"].copy()
    for s in range(4):
        pm.train_batch(_batch(arch, s))
    assert pm._host_scatter_thread is not None
    x = {k: v for k, v in _batch(arch, 9).items() if k != "label"}
    out = pm.forward_batch(x)                 # drains first
    assert pm._host_scatter_thread is None
    assert torch.isfinite(out).all() and out.shape == (BS, 1)
    k = pm.host_params[name]["kernel"]
    assert np.isfinite(k).all() and not np.array_equal(k, before)


def test_async_with_the_next_ids_is_one_step_stale_deterministically():
    """Given the next batch's ids, the worker gathers the next step's
    rows before it scatters this step's update, so step N reads the
    table with every update through step N-2: bitwise an exact run in
    which each step's scatter is held back until the next step's gather
    is made."""
    arch = _dcfg(NON_UNIFORM)
    batches = [_batch(arch, s) for s in range(5)]
    a = _port(arch, asynchronous=True)
    for s, b in enumerate(batches):
        nxt = (None if s + 1 == len(batches)
               else {"emb_concat": batches[s + 1]["sparse"]})
        a.train_batch(dict(b), next_host_idx=nxt)
    a._host_drain()
    e = _port(arch)
    held = []
    gather, update = e._host_emb_forward, e._host_emb_update

    def gather_then_release(idx):
        rows = gather(idx)
        while held:
            update(*held.pop(0))
        return rows

    e._host_emb_forward = gather_then_release
    e._host_emb_update = lambda idx, cts, step: held.append(
        (idx, {k: v.detach().clone() for k, v in cts.items()}, step))
    for b in batches:
        e.train_batch(dict(b))
    while held:
        update(*held.pop(0))
    np.testing.assert_array_equal(a.host_params["emb_concat"]["kernel"],
                                  e.host_params["emb_concat"]["kernel"])
    for op in a.params:
        for pn in a.params[op]:
            assert torch.equal(a.params[op][pn], e.params[op][pn])
    # and not the exact run's: the staleness is real
    x = _port(arch)
    for b in batches:
        x.train_batch(dict(b))
    assert not np.array_equal(x.host_params["emb_concat"]["kernel"],
                              a.host_params["emb_concat"]["kernel"])


def test_the_workers_error_surfaces_at_drain():
    arch = _dcfg(NON_UNIFORM)
    pm = _port(arch, asynchronous=True)
    pm.train_batch(_batch(arch, 0))
    pm._host_drain()
    op = pm._host_resident_list[0]
    orig = op.host_sgd_update

    def boom(*a, **k):
        raise RuntimeError("scatter exploded")

    op.host_sgd_update = boom
    try:
        pm.train_batch(_batch(arch, 1))       # spawns the failing worker
        with pytest.raises(RuntimeError, match="scatter exploded"):
            pm._host_drain()
        pm._host_drain()                      # consumed: clean now
        op.host_sgd_update = boom
        pm.train_batch(_batch(arch, 2))
        with pytest.raises(RuntimeError, match="scatter exploded"):
            pm.train_batch(_batch(arch, 3))   # the next step drains
    finally:
        op.host_sgd_update = orig


def test_an_abandoned_worker_writes_nothing():
    arch = _dcfg(NON_UNIFORM)
    pm = _port(arch, asynchronous=True)
    name = _emb_name(pm)
    pm.train_batch(_batch(arch, 0))
    pm._host_drain()
    before = pm.host_params[name]["kernel"].copy()
    with faults.active_plan(faults.FaultPlan(stall_s={"scatter": 0.5})):
        pm.train_batch(_batch(arch, 1))
        t = pm._host_scatter_thread
        with pytest.raises(WorkerStalled, match="host-table scatter"):
            pm._host_drain(deadline_s=0.05)
        pm._host_abandon()
        t.join(10)
    assert not t.is_alive()
    np.testing.assert_array_equal(pm.host_params[name]["kernel"], before)
    pm._host_drain()                          # nothing left to raise


@pytest.mark.parametrize("asynchronous", [False, True])
def test_the_sentinel_guards_the_host_scatter(asynchronous):
    """A poisoned step under skip_step leaves the host table as it was:
    the run equals a clean run without that batch, bitwise. In async mode
    each step's worker is landed before the next step (without the next
    ids, a step's gather races the last step's scatter, whose order the
    two runs need not share)."""
    arch = _dcfg(NON_UNIFORM)
    batches = [_batch(arch, s) for s in range(4)]
    a = _port(arch, asynchronous=asynchronous, anomaly_policy="skip_step")
    b = _port(arch, asynchronous=asynchronous, anomaly_policy="skip_step")
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={2})):
        for x in batches:
            mets = a.train_batch(dict(x))
            a._host_drain()
    assert bool(mets["anomaly"]) is False
    for s, x in enumerate(batches):
        if s != 2:
            b.train_batch(dict(x))
            b._host_drain()
    a._host_drain()
    b._host_drain()
    np.testing.assert_array_equal(a.host_params["emb_concat"]["kernel"],
                                  b.host_params["emb_concat"]["kernel"])
    for op in a.params:
        for pn in a.params[op]:
            assert torch.equal(a.params[op][pn], b.params[op][pn])


def test_raise_policy_leaves_the_host_table_and_raises():
    arch = _dcfg(NON_UNIFORM)
    pm = _port(arch, anomaly_policy="raise")
    pm.train_batch(_batch(arch, 0))
    before = pm.host_params["emb_concat"]["kernel"].copy()
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={1})):
        with pytest.raises(pt.core.model.AnomalyError):
            pm.train_batch(_batch(arch, 1))
    np.testing.assert_array_equal(pm.host_params["emb_concat"]["kernel"],
                                  before)


@pytest.mark.parametrize("asynchronous", [False, True])
def test_eval_and_fit_with_host_tables(asynchronous):
    arch = _dcfg(NON_UNIFORM)
    pm = _port(arch, asynchronous=asynchronous, stage_dataset="never")
    x, y = synthetic_batch(DLRMConfig(**arch), 4 * BS + 3, seed=5)
    out = pm.forward_batch({k: v[:5] for k, v in x.items()})
    assert out.shape == (5, 1) and torch.isfinite(out).all()
    res = pm.fit(x, y, epochs=2, batch_size=BS, verbose=False)
    assert res["num_samples"] == 2 * (4 * BS + 3)
    assert pm._host_scatter_thread is None
    assert np.isfinite(pm.host_params["emb_concat"]["kernel"]).all()
    # fit staged on the device gives the ring's result, bitwise
    st = _port(arch, asynchronous=asynchronous, stage_dataset="always")
    st.fit(x, y, epochs=2, batch_size=BS, verbose=False)
    np.testing.assert_array_equal(st.host_params["emb_concat"]["kernel"],
                                  pm.host_params["emb_concat"]["kernel"])


def test_fit_chains_the_next_gather_in_async_mode():
    arch = _dcfg(NON_UNIFORM)
    pm = _port(arch, asynchronous=True)
    seen = []
    real = pm._host_emb_input

    def spy(host_idx):
        seen.append(pm._host_gather_pending is not None)
        return real(host_idx)

    pm._host_emb_input = spy
    x, y = synthetic_batch(DLRMConfig(**arch), 4 * BS, seed=6)
    pm.fit(x, y, epochs=1, batch_size=BS, verbose=False)
    assert seen == [False, True, True, True]


# ---------------------------------------------------------------------
# checkpoints and swap_params
# ---------------------------------------------------------------------
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_checkpoints_restore_across_packages(opt, tmp_path):
    arch = _dcfg(NON_UNIFORM)
    jm = _jax(arch, opt)
    pm = _port(arch, opt, params_np=jax.tree.map(np.asarray, jm.params))
    for s in range(2):
        jm.train_batch(_batch(arch, s))
        pm.train_batch(_batch(arch, 10 + s))
    # the port's snapshot into the JAX package
    path = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(pm, path)
    j2 = _jax(arch, opt)
    jax_ckpt.restore_checkpoint(j2, path)
    np.testing.assert_array_equal(j2.host_params["emb_concat"]["kernel"],
                                  pm.host_params["emb_concat"]["kernel"])
    for k, v in pm.host_opt_state.get("emb_concat", {}).items():
        np.testing.assert_array_equal(
            j2.host_opt_state["emb_concat"][k], v)
    pp = params_to_jax(pm, pm.params)
    for op in pp:
        for pn in pp[op]:
            np.testing.assert_array_equal(np.asarray(j2.params[op][pn]),
                                          pp[op][pn])
    assert j2._step == pm._step == 2
    # the JAX package's snapshot into the port
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(jm, path)
    p2 = _port(arch, opt)
    ckpt.restore_checkpoint(p2, path)
    np.testing.assert_array_equal(p2.host_params["emb_concat"]["kernel"],
                                  jm.host_params["emb_concat"]["kernel"])
    assert set(p2.host_opt_state) == set(jm.host_opt_state)
    for k, v in jm.host_opt_state.get("emb_concat", {}).items():
        np.testing.assert_array_equal(p2.host_opt_state["emb_concat"][k], v)
    pp = params_to_jax(p2, p2.params)
    for op in pp:
        for pn in pp[op]:
            np.testing.assert_array_equal(pp[op][pn],
                                          np.asarray(jm.params[op][pn]))
    # and it trains on from there as the JAX package does
    lj = float(jm.train_batch(_batch(arch, 5))["loss"])
    lp = float(p2.train_batch(_batch(arch, 5))["loss"])
    np.testing.assert_allclose(lp, lj, rtol=1e-5)


def test_a_device_table_snapshot_does_not_load_into_a_host_model(tmp_path):
    arch = _dcfg(NON_UNIFORM)
    dev = _port(arch, host=False)
    path = str(tmp_path / "dev.npz")
    ckpt.save_checkpoint(dev, path)
    host = _port(arch)
    with pytest.raises(ValueError, match="--host-tables must match"):
        ckpt.restore_checkpoint(host, path)
    ckpt.save_checkpoint(host, str(tmp_path / "host.npz"))
    with pytest.raises(ValueError, match="--host-tables must match"):
        ckpt.restore_checkpoint(dev, str(tmp_path / "host.npz"))


def test_a_checkpoint_taken_under_an_async_scatter_holds_it(tmp_path):
    arch = _dcfg(NON_UNIFORM)
    pm = _port(arch, asynchronous=True)
    for s in range(3):
        pm.train_batch(_batch(arch, s))
    path = str(tmp_path / "a.npz")
    ckpt.save_checkpoint(pm, path)            # lands the scatter first
    assert pm._host_scatter_thread is None
    again = _port(arch)
    ckpt.restore_checkpoint(again, path)
    np.testing.assert_array_equal(again.host_params["emb_concat"]["kernel"],
                                  pm.host_params["emb_concat"]["kernel"])


def test_swap_params_installs_host_tables():
    arch = _dcfg(NON_UNIFORM)
    pm = _port(arch)
    new = {"emb_concat": {"kernel": np.ones_like(
        pm.host_params["emb_concat"]["kernel"])}}
    pm.swap_params(pm.params, host_params=new)
    assert pm.host_params is new
    with pytest.raises(ValueError, match="do not match"):
        pm.swap_params(host_params={"other": new["emb_concat"]})
    with pytest.raises(ValueError, match="does not hold"):
        pm.swap_params(host_params={"emb_concat": {
            "kernel": np.ones((3, 8), np.float32)}})
    assert pm.host_params is new


def test_host_tables_refuse_what_jax_refuses(tmp_path):
    from dlrm_flexflow_tpu_torch.core.optimizers import Optimizer

    class Exotic(Optimizer):
        lr = 0.1

        def init_state(self, params):
            return {}

    arch = _dcfg(NON_UNIFORM)
    pm = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu",
                                host_resident_tables=True))
    build_dlrm(pm, DLRMConfig(**arch))
    with pytest.raises(ValueError, match="support SGD"):
        pm.compile(Exotic(), "mean_squared_error", ["mse"])
    per_table = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu",
                                       host_resident_tables=True))
    build_dlrm(per_table, DLRMConfig(**arch), fuse_embeddings=False)
    with pytest.raises(ValueError, match="must consume a model input"):
        per_table.compile(SGDOptimizer(lr=0.1), "mean_squared_error",
                          ["mse"])
    # a DeltaPublisher over host tables is ported: its tracker takes the
    # host table's touched rows as candidates
    from dlrm_flexflow_tpu_torch.utils.delta import DeltaPublisher
    pub = DeltaPublisher(_port(arch), str(tmp_path))
    assert [key for _, _, key, _ in pub.tracker._tracked] == [
        "hostparams/emb_concat/kernel"]


def test_the_host_tables_flags_parse():
    cfg = pt.FFConfig.parse_args(["--device", "cpu", "--host-tables"])
    assert cfg.host_resident_tables and cfg.host_tables_async
    cfg = pt.FFConfig.parse_args(["--device", "cpu", "--host-tables",
                                  "--no-host-tables-async"])
    assert not cfg.host_tables_async
    cfg = pt.FFConfig.parse_args(["--device", "cpu", "--no-host-tables-async",
                                  "--host-tables-async"])
    assert cfg.host_tables_async and not cfg.host_resident_tables
    assert not pt.FFConfig(device="cpu").host_resident_tables
