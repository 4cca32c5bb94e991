"""The port's stateful optimizers against the JAX package: Adam's dense
update, the touched-rows row math (``sparse_row_update``), the stateful
touched-rows update of both embedding ops (``sparse_opt_update``,
through the plain version of the ``stateful_update_rows`` kernel), the
training step that selects it, and the optimizer-state carriers of
``utils.weights``.

Every case runs the five stateful optimizers of the JAX package's own
tests (tests/test_sparse_update.py ``_stateful_optimizers``): momentum,
nesterov with weight decay, weight decay alone, Adam, Adam with weight
decay. Inputs are made with numpy from a seed and handed to both
packages; state slabs start NON-zero where a case says so, carried by
``opt_state_from_jax``.

Tolerances, and why:

- Row math and touched-rows updates on the same inputs against the JAX
  functions run op by op (as the JAX package calls them outside a
  jit): BITWISE for every optimizer, duplicate ids included. Both sum a
  row's duplicates in lookup order from 0 (a stable sort, then a
  sequential segment sum), round each operation once in the same order
  with the constants rounded to fp32 alike, and take Adam's alpha_t
  through the same fp32 power and a correctly rounded square root (the
  port's plain version takes fp32 square roots in float64 on the CPU:
  PyTorch's vectorized one is an ulp off for some values).
- The same functions under ``jax.jit``: within rtol 1e-6, atol 1e-7,
  since XLA fuses the row math and contracts a multiply and an add into
  one fused multiply-add, which rounds once where the port, the CUDA
  kernel and the eager JAX ops round twice (measured: an ulp).
- On the CPU the JAX ops take that XLA path; its TPU path
  (``_stateful_update_tiles_packed``, whose writes are the
  ``_scatter_write_kernel`` the CUDA kernel replaces) is held to it by
  the JAX package's own tests (test_pallas.py TestStatefulTilesPacked);
  run op by op in interpret mode it equals the port bitwise too, but a
  call takes some 15 s there, so it is not repeated here.
- Adam's dense update, 3 steps op by op: BITWISE.
- The training step, 3 steps of the small "cat" DLRM from the same
  weights and state, the JAX step jitted: the loss within rtol 1e-6
  (the MLPs' products sum in another fp32 order in XLA and in PyTorch,
  about 1e-7), every parameter's and slab's change within 1e-3 of its
  largest change for SGD; under Adam within 1e-2: Adam divides by
  sqrt(v), so where v is small it turns those summation-order
  differences of the gradient into differences of the update of their
  own size. Rows no step looked up, and their state: BITWISE.
- One touched-rows step against one dense step, and against the JAX
  step, and the momentum slab after 3 steps against the JAX one: rtol
  1e-5, atol 1e-6, as the JAX package's own test of the pair; every row
  touched every step, 4 steps: 2e-5 and 2e-6, as there.
- ``opt_state_from_jax`` / ``opt_state_to_jax``: BITWISE round trip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.ops.embedding import _stateful_update_rows_xla
from dlrm_flexflow_tpu.parallel.mesh import make_mesh

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import (AdamOptimizer,
                                                     SGDOptimizer)
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.ops.kernels.scatter_rows import (
    stateful_update_rows, stateful_update_rows_reference)
from dlrm_flexflow_tpu_torch.utils.weights import (opt_state_from_jax,
                                                   opt_state_to_jax,
                                                   params_from_jax,
                                                   params_to_jax)

# (name, JAX optimizer, port optimizer): tests/test_sparse_update.py's
OPTIMIZERS = {
    "momentum": (lambda: ff.SGDOptimizer(lr=0.1, momentum=0.9),
                 lambda: SGDOptimizer(lr=0.1, momentum=0.9)),
    "nesterov_wd": (lambda: ff.SGDOptimizer(lr=0.1, momentum=0.9,
                                            nesterov=True,
                                            weight_decay=1e-3),
                    lambda: SGDOptimizer(lr=0.1, momentum=0.9,
                                         nesterov=True, weight_decay=1e-3)),
    "wd_only": (lambda: ff.SGDOptimizer(lr=0.1, weight_decay=1e-3),
                lambda: SGDOptimizer(lr=0.1, weight_decay=1e-3)),
    "adam": (lambda: ff.AdamOptimizer(alpha=0.01),
             lambda: AdamOptimizer(alpha=0.01)),
    "adam_wd": (lambda: ff.AdamOptimizer(alpha=0.01, weight_decay=1e-3),
                lambda: AdamOptimizer(alpha=0.01, weight_decay=1e-3)),
}
NAMES = list(OPTIMIZERS)


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _slabs_np(rng, names, shape):
    """Non-zero state: v of Adam positive, as a sum of squares is."""
    return {k: (rng.rand(*shape) if k == "v" else rng.randn(*shape))
            .astype(np.float32) for k in names}


# ---- Adam's step size -----------------------------------------------------
@pytest.mark.parametrize("alpha,beta1,beta2", [(0.001, 0.9, 0.999),
                                               (0.01, 0.8, 0.99),
                                               (3e-4, 0.9, 0.9999)])
def test_adam_step_size_matches_jitted_jax(alpha, beta1, beta2):
    """``AdamOptimizer.alpha_t`` against the JAX update's alpha_t under
    ``jax.jit`` on the CPU, BITWISE, for steps 0-299,999 (every step,
    in one vectorised call each; the port's table ends after 1,794 to
    180,180 steps, so its clamped last entry is held too), and one 0-d
    step as a training step asks for it."""
    n = 300_000

    @jax.jit
    def want_fn(step):
        t = (step + 1).astype(jnp.float32)
        return alpha * jnp.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)

    want = np.asarray(want_fn(jnp.arange(n, dtype=jnp.int32)))
    opt = AdamOptimizer(alpha=alpha, beta1=beta1, beta2=beta2)
    got = opt.alpha_t(torch.arange(n, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    one = opt.alpha_t(torch.tensor(4, dtype=torch.int32))
    assert one.dim() == 0 and float(one) == float(want[4])
    with pytest.raises(ValueError, match="betas"):
        AdamOptimizer(beta2=1.0)


# ---- the row math --------------------------------------------------------
@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_adam_dense_update_matches_jax(wd):
    """Three dense Adam steps, in place in the port, functional in JAX,
    weights and the m, v and step state."""
    rng = np.random.RandomState(9)
    shapes = {"a": {"kernel": (5, 7), "bias": (7,)}, "b": {"kernel": (3,)}}
    init = {op: {pn: rng.randn(*s).astype(np.float32)
                 for pn, s in p.items()} for op, p in shapes.items()}
    grads = [{op: {pn: rng.randn(*s).astype(np.float32)
                   for pn, s in p.items()} for op, p in shapes.items()}
             for _ in range(3)]
    jopt = ff.AdamOptimizer(alpha=0.01, weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, init)
    js = jopt.init_state(jp)
    popt = AdamOptimizer(alpha=0.01, weight_decay=wd)
    pp = {op: {pn: torch.from_numpy(v.copy()) for pn, v in p.items()}
          for op, p in init.items()}
    ps = popt.init_state(pp)
    for g in grads:
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js)
        popt.update(pp, {op: {pn: torch.from_numpy(v) for pn, v in p.items()}
                         for op, p in g.items()}, ps)
    assert popt.sparse_slab_names() == jopt.sparse_slab_names()
    assert int(ps["step"]) == int(js["step"]) == 3
    assert ps["step"].dtype == torch.int32
    for op, p in init.items():
        for pn in p:
            np.testing.assert_array_equal(pp[op][pn].numpy(),
                                          np.asarray(jp[op][pn]))
            for k in ("m", "v"):
                np.testing.assert_array_equal(ps[k][op][pn].numpy(),
                                              np.asarray(js[k][op][pn]))


@pytest.mark.parametrize("name", NAMES)
def test_sparse_row_update_matches_jax(name):
    """The JAX contract on (m, k) rows with a lane mask: touched lanes
    take the update, untouched ones keep weight and state bitwise."""
    jopt, popt = OPTIMIZERS[name][0](), OPTIMIZERS[name][1]()
    rng = np.random.RandomState(3)
    w, g = (rng.randn(12, 16).astype(np.float32) for _ in range(2))
    slabs = _slabs_np(rng, jopt.sparse_slab_names(), (12, 16))
    touched = rng.rand(12, 16) < 0.6
    wj, sj = jopt.sparse_row_update(
        jnp.asarray(w), jnp.asarray(g),
        {k: jnp.asarray(v) for k, v in slabs.items()},
        jnp.asarray(touched), jnp.asarray(4, jnp.int32))
    ts = {k: torch.from_numpy(v) for k, v in slabs.items()}
    wp, sp = popt.sparse_row_update(
        torch.from_numpy(w), torch.from_numpy(g), ts,
        torch.from_numpy(touched), torch.tensor(4, dtype=torch.int32))
    np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(wp.numpy()[~touched], w[~touched])
    assert set(sp) == set(sj) == set(slabs)
    for k in slabs:
        np.testing.assert_array_equal(sp[k].numpy(), np.asarray(sj[k]))
        np.testing.assert_array_equal(ts[k].numpy(), slabs[k])  # inputs kept


# ---- the kernel's plain version --------------------------------------------
def _kernel_case(name, rows, d, n, seed, dups="some"):
    jopt, popt = OPTIMIZERS[name][0](), OPTIMIZERS[name][1]()
    rng = np.random.RandomState(seed)
    table = rng.randn(rows, d).astype(np.float32)
    if dups == "equal":
        ids = np.full(n, rows // 3, np.int64)
    else:
        ids = rng.randint(0, rows, size=n).astype(np.int64)
        ids[: n // 4] = ids[0]
    upd = rng.randn(n, d).astype(np.float32)
    slabs = _slabs_np(rng, jopt.sparse_slab_names(), (rows, d))
    return jopt, popt, table, ids, upd, slabs


def _port_update(popt, table, ids, upd, slabs, step, fwd=None, div=1):
    t = torch.from_numpy(table.copy())
    s = {k: torch.from_numpy(v.copy()) for k, v in slabs.items()}
    stateful_update_rows(t, torch.from_numpy(ids), torch.from_numpy(upd),
                         fwd, s, popt.row_params(),
                         popt.alpha_t(torch.tensor(step, dtype=torch.int32)),
                         div=div)
    return t.numpy(), {k: v.numpy() for k, v in s.items()}


@pytest.mark.parametrize("name", NAMES)
def test_stateful_rows_match_the_xla_path(name):
    """``stateful_update_rows`` (its plain version on the CPU) against
    the JAX oracle ``_stateful_update_rows_xla`` at d = 64 with
    duplicate ids, from non-zero state, op by op and under ``jax.jit``.
    Rows not looked up keep weight and state."""
    rows, d, n, step = 256, 64, 96, 3
    jopt, popt, table, ids, upd, slabs = _kernel_case(name, rows, d, n, 0)
    got_w, got_s = _port_update(popt, table, ids, upd, slabs, step)
    jstep = jnp.asarray(step, jnp.int32)

    def oracle(t, g, u, s):
        return _stateful_update_rows_xla(t, g, u, jopt, s, jstep)

    args = (jnp.asarray(table), jnp.asarray(ids, jnp.int32),
            jnp.asarray(upd), {k: jnp.asarray(v) for k, v in slabs.items()})
    want_w, want_s = oracle(*args)
    np.testing.assert_array_equal(got_w, np.asarray(want_w))
    for k in slabs:
        np.testing.assert_array_equal(got_s[k], np.asarray(want_s[k]),
                                      err_msg=k)
    want_w, want_s = jax.jit(oracle)(*args)
    np.testing.assert_allclose(got_w, np.asarray(want_w), rtol=1e-6,
                               atol=1e-7)
    for k in slabs:
        np.testing.assert_allclose(got_s[k], np.asarray(want_s[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    untouched = np.setdiff1d(np.arange(rows), ids)
    np.testing.assert_array_equal(got_w[untouched], table[untouched])
    for k in slabs:
        np.testing.assert_array_equal(got_s[k][untouched],
                                      slabs[k][untouched])


@pytest.mark.parametrize("name", ["nesterov_wd", "adam_wd"])
@pytest.mark.parametrize("d,dups", [(8, "equal"), (132, "some"),
                                    (64, "equal")])
def test_stateful_rows_edges(name, d, dups):
    """The plain version at d = 8 and 132 and with every id equal (one
    row, every lookup its duplicate) against the XLA oracle; with the
    residual ``fwd`` it reads the forward rows, not the table."""
    rows, n, step = 40, 33, 0
    jopt, popt, table, ids, upd, slabs = _kernel_case(name, rows, d, n, 1,
                                                      dups)
    want_w, want_s = _stateful_update_rows_xla(
        jnp.asarray(table), jnp.asarray(ids, jnp.int32), jnp.asarray(upd),
        jopt, {k: jnp.asarray(v) for k, v in slabs.items()},
        jnp.asarray(step, jnp.int32))
    got_w, got_s = _port_update(popt, table, ids, upd, slabs, step)
    np.testing.assert_array_equal(got_w, np.asarray(want_w))
    for k in slabs:
        np.testing.assert_array_equal(got_s[k], np.asarray(want_s[k]))
    # the forward rows stand in for the table's: a stale table changes
    # nothing where fwd holds the rows the lookups read
    fwd = torch.from_numpy(table[ids])
    stale = np.zeros_like(table)
    w2, s2 = _port_update(popt, stale, ids, upd, slabs, step, fwd=fwd)
    touched = np.unique(ids)
    np.testing.assert_array_equal(w2[touched], got_w[touched])
    for k in slabs:
        np.testing.assert_array_equal(s2[k], got_s[k])


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_stateful_rows_skip_pads(name):
    """Negative ids are pad slots (the Pallas kernels' ``@pl.when(row >=
    0)``): the update equals the one without them, their rows (where -1
    would wrap) untouched; an id past the table raises."""
    rows, d, n = 64, 16, 48
    _, popt, table, ids, upd, slabs = _kernel_case(name, rows, d, n, 2)
    ids[ids == rows - 1] = 0
    padded = ids.copy()
    padded[5:11] = -1
    padded[20] = -(rows + 1)
    real = padded >= 0
    got_w, got_s = _port_update(popt, table, padded, upd, slabs, 2)
    want_w, want_s = _port_update(popt, table, padded[real], upd[real],
                                  slabs, 2)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_w[rows - 1], table[rows - 1])
    for k in slabs:
        np.testing.assert_array_equal(got_s[k], want_s[k])
    bad = ids.copy()
    bad[3] = rows
    with pytest.raises(ValueError, match="past the table"):
        _port_update(popt, table, bad, upd, slabs, 2)


def test_stateful_rows_reference_takes_a_bag_divisor():
    """div > 1: lookup j takes update row j // div, as a bag of div
    lookups shares its cotangent row."""
    _, popt, table, ids, upd, slabs = _kernel_case("adam", 32, 8, 24, 4)
    t1, t2 = torch.from_numpy(table.copy()), torch.from_numpy(table.copy())
    s1 = {k: torch.from_numpy(v.copy()) for k, v in slabs.items()}
    s2 = {k: torch.from_numpy(v.copy()) for k, v in slabs.items()}
    a = popt.alpha_t(torch.tensor(1, dtype=torch.int32))
    ti = torch.from_numpy(ids)
    u = torch.from_numpy(upd[:8])
    stateful_update_rows_reference(t1, ti, u, None, s1, popt.row_params(), a,
                                   div=3)
    stateful_update_rows_reference(t2, ti, u.repeat_interleave(3, 0), None,
                                   s2, popt.row_params(), a)
    assert torch.equal(t1, t2)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


# ---- the embedding ops ---------------------------------------------------
_MODELS = {}


def _op_models(kind, aggr, batch, Tn, rows, d, bag, order=None):
    """A JAX and a port model holding one embedding op, the port's
    weights carried from the JAX model afresh at each call (the port's
    update is in place; the ops take the optimizer as an argument, so
    one pair serves every optimizer)."""
    key = (kind, aggr, batch, Tn, rows, d, bag, order)
    if key not in _MODELS:
        _MODELS[key] = _build_op_models(*key)
    jm, pm = _MODELS[key]
    pm.swap_params(params_from_jax(pm, jax.tree.map(np.asarray, jm.params)))
    return jm, pm


def _build_op_models(kind, aggr, batch, Tn, rows, d, bag, order):
    jm = ff.FFModel(ff.FFConfig(batch_size=batch, seed=5))
    pm = pt.FFModel(pt.FFConfig(batch_size=batch, device="cpu"))
    if kind == "stacked":
        s = jm.create_tensor((batch, Tn, bag), dtype=jnp.int32, name="ids")
        jm.embedding_stacked(s, Tn, rows, d, aggr=aggr, name="emb")
        s = pm.create_tensor((batch, Tn, bag), dtype=torch.int64, name="ids")
        pm.embedding_stacked(s, Tn, rows, d, aggr=aggr, name="emb")
        jm.get_layer_by_name("emb").set_table_order(order)
        pm.get_layer_by_name("emb").set_table_order(order)
    else:
        s = jm.create_tensor((batch, bag), dtype=jnp.int32, name="ids")
        jm.embedding(s, rows, d, aggr=aggr, name="emb")
        s = pm.create_tensor((batch, bag), dtype=torch.int64, name="ids")
        pm.embedding(s, rows, d, aggr=aggr, name="emb")
    jm.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
               mesh=_mesh())
    jm.init_layers()
    pm.compile(SGDOptimizer(lr=0.1))
    return jm, pm


def _run_op(jm, pm, jopt, popt, idx, ct, step, residual, rng):
    """Both ops' sparse_opt_update from the same non-zero state; returns
    (JAX params, JAX state, port params, port state), JAX layout."""
    jop, pop = jm.get_layer_by_name("emb"), pm.get_layer_by_name("emb")
    names = jopt.sparse_slab_names()
    shape = np.asarray(jm.params["emb"]["kernel"]).shape
    state = {k: {"emb": {"kernel": v}}
             for k, v in _slabs_np(rng, names, shape).items()}
    pstate = opt_state_from_jax(pm, state)
    new_k, new_s = jop.sparse_opt_update(
        jm.params["emb"], [jnp.asarray(idx, jnp.int32)], jnp.asarray(ct),
        jopt, {k: {"kernel": jnp.asarray(v["emb"]["kernel"])}
               for k, v in state.items()},
        jnp.asarray(step, jnp.int32))
    xs = [torch.from_numpy(idx.astype(np.int64))]
    fwd = pop.apply_with_fwd(pm.params["emb"], xs)[1] if residual else None
    pop.sparse_opt_update(pm.params["emb"], xs, torch.from_numpy(ct), popt,
                          {k: pstate[k]["emb"]["kernel"] for k in names},
                          torch.tensor(step, dtype=torch.int32), fwd=fwd)
    return (np.asarray(new_k["kernel"]),
            {k: np.asarray(v["kernel"]) for k, v in new_s.items()},
            params_to_jax(pm, pm.params)["emb"]["kernel"],
            {k: v["emb"]["kernel"]
             for k, v in opt_state_to_jax(pm, pstate).items()})


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("aggr,residual", [("sum", True), ("avg", False)])
@pytest.mark.parametrize("dups", [False, True])
def test_stacked_sparse_opt_update_matches_jax_op(name, aggr, residual,
                                                  dups):
    """``EmbeddingBagStacked.sparse_opt_update``, bag 3, a storage
    permutation, with and without duplicate (and out-of-range, wrapped)
    ids, with the forward residual ("sum") or the table read ("avg"),
    against the JAX op."""
    Tn, rows, d, batch, bag, order = 4, 96, 64, 6, 3, (2, 0, 3, 1)
    jopt, popt = OPTIMIZERS[name][0](), OPTIMIZERS[name][1]()
    jm, pm = _op_models("stacked", aggr, batch, Tn, rows, d, bag, order)
    rng = np.random.RandomState(11)
    if dups:
        idx = rng.randint(-rows, 2 * rows, size=(batch, Tn, bag))
        idx[:3, :, 0] = idx[0, :, 0]
    else:
        idx = np.stack([rng.permutation(rows)[:batch * bag].reshape(
            batch, bag) for _ in range(Tn)], axis=1)
    ct = rng.randn(batch, Tn, d).astype(np.float32)
    wj, sj, wp, sp = _run_op(jm, pm, jopt, popt, idx, ct, 5, residual, rng)
    np.testing.assert_array_equal(wp, wj)
    assert set(sp) == set(sj)
    for k in sj:
        np.testing.assert_array_equal(sp[k], sj[k], err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_embedding_none_sparse_opt_update_matches_jax_op(name):
    """``Embedding(aggr="none")`` (NMT's lookups), one row a slot, with
    duplicate and wrapped ids, against the JAX op."""
    rows, d, batch, slots = 50, 16, 5, 4
    jopt, popt = OPTIMIZERS[name][0](), OPTIMIZERS[name][1]()
    jm, pm = _op_models("one", "none", batch, 1, rows, d, slots)
    rng = np.random.RandomState(12)
    idx = rng.randint(-rows, 2 * rows, size=(batch, slots))
    idx[:, 0] = 7
    ct = rng.randn(batch, slots, d).astype(np.float32)
    wj, sj, wp, sp = _run_op(jm, pm, jopt, popt, idx, ct, 0, False, rng)
    np.testing.assert_array_equal(wp, wj)
    for k in sj:
        np.testing.assert_array_equal(sp[k], sj[k], err_msg=k)


def test_opt_state_round_trip_is_exact():
    """JAX state -> port -> JAX layout, bitwise, through a permuted,
    lane-packed stacked table, and the step as int32."""
    jm, pm = _op_models("stacked", "sum", 4, 4, 32, 16, 2, (3, 1, 0, 2))
    rng = np.random.RandomState(2)
    shape = np.asarray(jm.params["emb"]["kernel"]).shape
    assert shape == (4, 32 // 8, 16 * 8)          # packed 8 rows a tile
    state = {k: {"emb": {"kernel": v}}
             for k, v in _slabs_np(rng, ("m", "v"), shape).items()}
    state["step"] = np.asarray(7, np.int32)
    ps = opt_state_from_jax(pm, state)
    assert ps["m"]["emb"]["kernel"].shape == (4, 32, 16)
    assert ps["step"].dtype == torch.int32 and int(ps["step"]) == 7
    back = opt_state_to_jax(pm, ps)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 7
    for k in ("m", "v"):
        np.testing.assert_array_equal(back[k]["emb"]["kernel"],
                                      state[k]["emb"]["kernel"])
    # the logical layout: stored slot s holds table order[s]
    logical = state["m"]["emb"]["kernel"].reshape(4, 32, 16)
    np.testing.assert_array_equal(ps["m"]["emb"]["kernel"][3].numpy(),
                                  logical[0])


# ---- the training step ---------------------------------------------------
# tests/test_sparse_update.py TestStatefulSparseUpdate's DLRM
SMALL = dict(embedding_size=[64] * 8, sparse_feature_size=8,
             embedding_bag_size=2, mlp_bot=[4, 16, 8], mlp_top=[72, 16, 1])
STEPS = 3


def _small_models(jopt, popt, sparse=True, state_seed=None):
    """The small DLRM in both packages from the same weights (and, with
    ``state_seed``, the same non-zero optimizer state)."""
    cfg = ff.FFConfig(batch_size=16, seed=5)
    cfg.sparse_embedding_update = sparse
    jm = ff.FFModel(cfg)
    jax_build_dlrm(jm, JaxDLRMConfig(**SMALL))
    jm.compile(jopt, "mean_squared_error", ["mse"], mesh=_mesh())
    jm.init_layers()
    pm = pt.FFModel(pt.FFConfig(batch_size=16, device="cpu",
                                sparse_embedding_update=sparse))
    build_dlrm(pm, DLRMConfig(**SMALL))
    pm.compile(popt, "mean_squared_error", ["mse"])
    pm.swap_params(params_from_jax(pm, jax.tree.map(np.asarray, jm.params)))
    if state_seed is not None:
        rng = np.random.RandomState(state_seed)
        st = jax.tree.map(np.asarray, jm.opt_state)
        st = {k: (v if k == "step" else jax.tree.map(
            lambda a: _slabs_np(rng, (k,), a.shape)[k], v))
            for k, v in st.items()}
        jm.opt_state = jax.tree.map(
            lambda a, s: jax.device_put(jnp.asarray(a), s.sharding), st,
            jm.opt_state)
        pm.opt_state = opt_state_from_jax(pm, st)
    return jm, pm


def _copy(tree):
    return jax.tree.map(np.array, tree)


def _batch(step):
    x, y = synthetic_batch(DLRMConfig(**SMALL), 16, seed=step)
    x["label"] = y
    return x


def _train_both(jm, pm, steps=STEPS):
    lj, lp = [], []
    for s in range(steps):
        lj.append(float(jm.train_batch(_batch(s))["loss"]))
        lp.append(float(pm.train_batch(_batch(s))["loss"]))
    return lj, lp


def _logical(op, arr):
    """A stacked table (or slab) of the JAX layout as (T, rows, d)."""
    arr = np.asarray(arr).reshape(op.num_tables, op.num_entries, op.out_dim)
    if op._table_order is not None:
        arr = arr[np.argsort(op._table_order)]
    return arr


@pytest.mark.parametrize("name", ["default"] + NAMES)
def test_small_cat_trains_as_jax(name):
    """3 steps of the small "cat" DLRM, from the same weights and, for
    the optimizers with state, the same non-zero state: ``compile()``'s
    default optimizer (SGD, lr 0.01, weight decay 1e-4, as the JAX
    ``compile``) and the five stateful ones. The table takes the
    stateful touched-rows update in both packages; losses, parameters
    and slabs agree, untouched rows and their state stay bitwise."""
    if name == "default":
        jopt, popt = None, None
    else:
        jopt, popt = OPTIMIZERS[name][0](), OPTIMIZERS[name][1]()
    jm, pm = _small_models(jopt, popt, state_seed=6)
    # copies: the port's arrays share memory with its tensors
    p0 = _copy(params_to_jax(pm, pm.params))
    s0 = _copy(opt_state_to_jax(pm, pm.opt_state))
    lj, lp = _train_both(jm, pm)
    assert [op.name for op in pm._sparse_ops] == ["emb_stack"]
    assert pm._stateful_sparse()
    assert jm._sparse_update_ops == ["emb_stack"]
    assert all(np.isfinite(lp))
    np.testing.assert_allclose(lp, lj, rtol=1e-6)
    adam = isinstance(pm.optimizer, AdamOptimizer)
    frac = 1e-2 if adam else 1e-3
    pj = jax.tree.map(np.asarray, jm.params)
    pp = params_to_jax(pm, pm.params)
    trees = [(pj, pp, p0)]
    sj = jax.tree.map(np.asarray, jm.opt_state)
    sp = opt_state_to_jax(pm, pm.opt_state)
    assert set(sp) == set(sj)
    if adam:
        assert int(sp["step"]) == int(sj["step"]) == STEPS
    trees += [(sj[k], sp[k], s0[k]) for k in pm.optimizer.sparse_slab_names()]
    for tj, tp, t0 in trees:
        for op in tj:
            for pn, want in tj[op].items():
                dj, dp = want - t0[op][pn], tp[op][pn] - t0[op][pn]
                scale = np.abs(dj).max()
                assert scale > 0, (op, pn)
                np.testing.assert_allclose(dp, dj, rtol=0,
                                           atol=frac * scale,
                                           err_msg=f"{op}.{pn}")
    # rows no step looked up: weight and state bitwise as they started
    op = pm.get_layer_by_name("emb_stack")
    ids = np.stack([_batch(s)["sparse"] for s in range(STEPS)]) % 64
    touched = np.zeros((8, 64), bool)
    for t in range(8):
        touched[t, ids[:, :, t].reshape(-1)] = True
    assert (~touched).sum() > 0
    for tj, tp, t0 in trees:
        got = _logical(op, tp["emb_stack"]["kernel"])
        np.testing.assert_array_equal(
            got[~touched], _logical(op, t0["emb_stack"]["kernel"])[~touched])
        np.testing.assert_array_equal(
            got[~touched], _logical(op, tj["emb_stack"]["kernel"])[~touched])


@pytest.mark.parametrize("name", NAMES)
def test_single_step_matches_dense_on_touched_rows(name):
    """TestStatefulSparseUpdate's first case through both packages: one
    step of the touched-rows update against one dense step (the table
    in autograd, the optimizer's dense update), on the touched rows and
    their slabs; the port's touched-rows step against the JAX one."""
    jopt, popt = OPTIMIZERS[name][0](), OPTIMIZERS[name][1]()
    jm, pm = _small_models(jopt, popt)
    _, dense = _small_models(OPTIMIZERS[name][0](), OPTIMIZERS[name][1](),
                             sparse=False)
    lj, lp = _train_both(jm, pm, 1)
    dense.train_batch(_batch(0))
    assert dense._sparse_ops == []
    np.testing.assert_allclose(lp, lj, rtol=1e-6)
    op = pm.get_layer_by_name("emb_stack")
    idx = _batch(0)["sparse"].astype(np.int64) % 64        # (16, 8, 2)
    names = pm.optimizer.sparse_slab_names()
    pairs = [(pm.params["emb_stack"]["kernel"],
              dense.params["emb_stack"]["kernel"],
              _logical(op, jm.params["emb_stack"]["kernel"]))]
    pairs += [(pm.opt_state[k]["emb_stack"]["kernel"],
               dense.opt_state[k]["emb_stack"]["kernel"],
               _logical(op, jm.opt_state[k]["emb_stack"]["kernel"]))
              for k in names]
    for sparse_t, dense_t, jax_t in pairs:
        for t in range(8):
            rows = np.unique(idx[:, t, :])
            got = sparse_t[t].numpy()[rows]
            np.testing.assert_allclose(got, dense_t[t].numpy()[rows],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got, jax_t[t][rows], rtol=1e-5,
                                       atol=1e-6)


def test_untouched_rows_and_state_are_lazy():
    """TestStatefulSparseUpdate's second case: after 3 momentum steps the
    rows no step looked up keep their initial weight AND zero state, in
    the port as in JAX."""
    jm, pm = _small_models(ff.SGDOptimizer(lr=0.1, momentum=0.9),
                           SGDOptimizer(lr=0.1, momentum=0.9))
    init = pm.params["emb_stack"]["kernel"].clone()
    _train_both(jm, pm)
    op = pm.get_layer_by_name("emb_stack")
    touched = np.zeros((8, 64), bool)
    for s in range(STEPS):
        idx = _batch(s)["sparse"].astype(np.int64) % 64
        for t in range(8):
            touched[t, idx[:, t, :].reshape(-1)] = True
    un = torch.from_numpy(~touched)
    assert int(un.sum()) > 0
    w = pm.params["emb_stack"]["kernel"]
    v = pm.opt_state["v"]["emb_stack"]["kernel"]
    assert torch.equal(w[un], init[un])
    assert torch.equal(v[un], torch.zeros_like(v[un]))
    assert bool((v[~un] != 0).any(dim=-1).all())
    np.testing.assert_allclose(
        v.numpy(), _logical(op, jm.opt_state["v"]["emb_stack"]["kernel"]),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_all_rows_touched_matches_dense_multi_step(name):
    """TestStatefulSparseUpdate's third case: when every row is touched
    every step, the lazy update equals the dense one for the whole run,
    weights and state; in the port, and against the JAX lazy run."""
    rows, Tn, d, batch, bag = 32, 4, 8, 16, 2

    def build(make, sparse):
        m = make(sparse)
        dense_in = m.create_tensor((batch, 4), name="dense")
        sparse_in = m.create_tensor((batch, Tn, bag), dtype=(
            jnp.int32 if isinstance(m, ff.FFModel) else torch.int64),
            name="sparse")
        bot = m.dense(dense_in, 8, activation="relu", name="bot")
        emb = m.embedding_stacked(sparse_in, Tn, rows, d, name="emb")
        flat = m.reshape(emb, (batch, Tn * d), name="flat")
        cat = m.concat([bot, flat], axis=1, name="cat")
        return m, m.dense(cat, 1, name="head")

    def jax_model(sparse):
        cfg = ff.FFConfig(batch_size=batch, seed=11)
        cfg.sparse_embedding_update = sparse
        return ff.FFModel(cfg)

    def port_model(sparse):
        return pt.FFModel(pt.FFConfig(batch_size=batch, device="cpu",
                                      sparse_embedding_update=sparse))

    jm, out = build(jax_model, True)
    jm.compile(OPTIMIZERS[name][0](), "mean_squared_error", ["mse"],
               final_tensor=out, mesh=_mesh())
    jm.init_layers()
    runs = [jm]
    for sparse in (True, False):
        m, out = build(port_model, sparse)
        m.compile(OPTIMIZERS[name][1](), "mean_squared_error", ["mse"],
                  final_tensor=out)
        m.swap_params(params_from_jax(m, jax.tree.map(np.asarray,
                                                      jm.params)))
        runs.append(m)
    rng = np.random.RandomState(7)
    for _ in range(4):
        idx = np.stack([rng.permutation(rows).reshape(batch, bag)
                        for _ in range(Tn)], axis=1)
        b = {"dense": rng.rand(batch, 4).astype(np.float32),
             "sparse": idx.astype(np.int32),
             "label": rng.rand(batch, 1).astype(np.float32)}
        for m in runs:
            m.train_batch(b)
    jm, lazy, dense = runs
    assert [op.name for op in lazy._sparse_ops] == ["emb"]
    assert dense._sparse_ops == []
    want = jax.tree.map(np.asarray, jm.params)
    for m in (lazy, dense):
        got = params_to_jax(m, m.params)
        for op in want:
            for pn in want[op]:
                np.testing.assert_allclose(got[op][pn], want[op][pn],
                                           rtol=2e-5, atol=2e-6)
    for k in lazy.optimizer.sparse_slab_names():
        a = lazy.opt_state[k]["emb"]["kernel"]
        torch.testing.assert_close(a, dense.opt_state[k]["emb"]["kernel"],
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(
            opt_state_to_jax(lazy, lazy.opt_state)[k]["emb"]["kernel"],
            np.asarray(jm.opt_state[k]["emb"]["kernel"]), rtol=2e-5,
            atol=2e-6)
