"""Row-sharded embedding tables across ranks against the JAX package.

The configuration of the JAX package's ``tests/test_rowshard.py``: 4
tables of 1,024 rows, d = 8, bag 2, batch 32, narrow MLPs. Worlds of 2
and 4 gloo ranks (``utils.testing.spawn_ranks``, one spawn a world for
the whole module) run every scenario; the JAX models run on a mesh of as
many of ``conftest.py``'s virtual CPU devices, their weights carried into
every rank by ``params_from_jax`` (a rank takes its row block) and back
by ``params_to_jax`` (the ranks' blocks, in shard order, are the JAX
stored kernel).

Held, and why:

- the first forward of every form (stacked, per-table ``Embedding``,
  concatenated non-uniform tables): the embedding output BITWISE the
  JAX row-sharded lookup's and the port's world-1 lookup's. A gather is
  a gather, and the bags' sums add the same rows in the same order;
- three steps under SGD, momentum and Adam, at ``param_degree`` = world
  and at 2 of 4, and under SGD with the tables' dense gradient (the
  routed backward's "grad" mode, ``sparse_embedding_update`` off): the
  losses within rtol 1e-5 of JAX's, every weight and
  state slab within rtol 1e-5, atol 1e-7. Not bitwise: where a row gets
  partial sums from more than one rank, JAX's CPU scatter adds them to
  the row one after another, (t + u1) + u2, and the port's kernels form
  t + (u1 + u2); the MLPs' gradients sum in another order (each rank's
  share, then over the ranks). Under Adam, which divides by sqrt(v), a
  weight whose gradient is near 0 (an MLP weight, or a table row through
  the MLPs' cotangent) turns that order into an update difference of its
  own size (measured: up to 6.5e-7, on 1 or 2 of 32,768 table values and
  1 of 640 MLP weights), so there the weights are held within rtol 1e-5
  and 1e-5 of the distance Adam's steps can move a weight, alpha a step
  (1.5e-6 over 3 steps); the state slabs keep rtol 1e-5, atol 1e-7.
  The replicated MLP weights: BITWISE equal on every rank (one
  all-reduce, whose result every rank gets);
- among the port's own forms, on a duplicate-heavy batch (ids from 8
  rows a table, across the hot head and every shard) under all three
  optimizers, and under the dense gradient: the dense, dedup, hybrid
  (hot/cold) and overlap exchanges, and degree 2 against 4 at world 4,
  BITWISE equal in losses, tables,
  slabs and MLPs (the canonical combine: a segment sum per (row, source
  rank) in ascending position, then the partials in ascending
  first-occurrence position; the kernels sum in list order);
- the loud fallbacks: the same ``ff.embedding`` warnings as the JAX
  compile, word for word; a request ``configure_row_shard`` refuses then
  trains with the table replicated on every rank (bitwise equal copies,
  the losses within rtol 1e-5 of a world-1 run's), and a hot split that
  cannot resolve keeps plain row sharding;
- the launcher (``examples/native/dlrm.py``) at world ranks with
  ``--import`` of a JSON strategy whose embedding entry carries
  ``param_dim`` (and ``exchange``, ``hot_frac``, ``overlap``):
  run_random.sh's uniform tables and run_criteo_kaggle.sh's
  concatenated ones train row-sharded, the exchange's collectives
  counted;
- the collectives: per step, the calls, and the bytes handed over
  (``stats[...]["sent"]``) equal to ``dense_exchange_hlo_bytes`` /
  ``dedup_exchange_hlo_bytes`` (the padded buffers);
- ``params_from_jax`` / ``params_to_jax`` and ``opt_state_*``: a rank's
  block, hot head and slabs round-trip BITWISE;
- without a process group: ``plan_row_shard``, ``resolve_hot_rows``,
  ``row_shard_structural_reason`` and the byte formulas equal JAX's over
  a grid of rows, packs, degrees, fractions and meshes of 2, 4 and 8.
"""

import logging
import threading

import numpy as np
import pytest

# The ranks are spawned processes that import this module to find
# _rank_run: the JAX package is imported in the functions that use it.

ROWS, T, D, BS, BAG = 1024, 4, 8, 32, 2
STEPS = 3
SIZES = [300, 1024, 77, 4000]          # the concatenated non-uniform form
HOT = 0.125                            # 1024 rows, lane pack 16 -> H = 128
DUP_ROWS = (0, 3, 127, 128, 300, 511, 600, 1023)
WORLDS = (2, 4)
OPTS = ("sgd", "momentum", "adam")


def _arch(sizes=None, bag=BAG):
    sizes = list(sizes or [ROWS] * T)
    return dict(embedding_size=sizes, sparse_feature_size=D,
                embedding_bag_size=bag, mlp_bot=[D, 16, D],
                mlp_top=[D * (len(sizes) + 1), 16, 1])


def _strategies(model, n, pd=None, exchange="dense", hot=0.0,
                overlap=False, pkg=None):
    """The JAX test's map: every table row-sharded over ``pd`` (default
    ``n``) with its output data-parallel over the mesh, every other op
    data-parallel. ``pkg``: the package whose ParallelConfig to use."""
    if pkg is None:
        from dlrm_flexflow_tpu_torch.parallel.pconfig import ParallelConfig
    else:
        ParallelConfig = pkg
    pd = n if pd is None else pd
    out = {}
    for op in model.ops:
        tn = type(op).__name__
        nd = op.outputs[0].num_dims if op.outputs else 0
        if tn in ("EmbeddingBagStacked", "EmbeddingBagConcat", "Embedding"):
            out[op.name] = ParallelConfig(
                (n,) + (1,) * (nd - 1), param_degree=pd, exchange=exchange,
                hot_fraction=hot, overlap=overlap)
        elif nd:
            out[op.name] = ParallelConfig.data_parallel(nd, n)
    return out


def _opt(name, pkg):
    if name == "adam":
        return pkg.AdamOptimizer(alpha=0.05)
    if name == "momentum":
        return pkg.SGDOptimizer(lr=0.05, momentum=0.9)
    return pkg.SGDOptimizer(lr=0.05)


def _emb_names(model):
    return [op.name for op in model.ops
            if type(op).__name__ in ("EmbeddingBagStacked",
                                     "EmbeddingBagConcat", "Embedding")]


def _uniform_batches(sizes=None):
    from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig,
                                                     synthetic_batch)
    out = []
    for s in range(STEPS):
        x, y = synthetic_batch(DLRMConfig(**_arch(sizes)), BS, seed=40 + s)
        x["label"] = y
        out.append(x)
    return out


def _dup_batches(sizes=None):
    """Duplicate-heavy batches: every table's ids from 8 rows spread over
    the hot head and every shard (the middle step zipf(1.05))."""
    from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig,
                                                     synthetic_batch)
    sizes = list(sizes or [ROWS] * T)
    rng = np.random.RandomState(7)
    out = []
    for s in range(STEPS):
        x, y = synthetic_batch(DLRMConfig(**_arch(sizes)), BS, seed=50 + s,
                               zipf_alpha=1.05)
        if s != 1:
            x["sparse"] = np.stack(
                [np.asarray(DUP_ROWS, np.int32)[rng.randint(0, 8, (BS, BAG))]
                 % rows for rows in sizes], axis=1).astype(np.int32)
        x["label"] = y
        out.append(x)
    return out


# ---- the ranks -----------------------------------------------------------


def _tree_np(tree):
    return {k: ({p: v.detach().cpu().numpy().copy() for p, v in d.items()}
                if isinstance(d, dict) else d) for k, d in tree.items()}


def _same_tree(a, b):
    import torch
    return all(torch.equal(a[k][p], b[k][p]) for k in a for p in a[k])


def _rank_run(rank, world, specs):
    """Every scenario of ``specs`` on this rank; returns {key: result}."""
    import torch

    import dlrm_flexflow_tpu_torch as pt
    from dlrm_flexflow_tpu_torch.core import optimizers
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.utils.weights import (opt_state_from_jax,
                                                       opt_state_to_jax,
                                                       params_from_jax,
                                                       params_to_jax)
    out = {}
    for sp in specs:
        if sp.get("launcher"):
            from dlrm_flexflow_tpu_torch.examples.native import dlrm as app
            res = app.main(sp["launcher"])
            m = res["model"]
            op = m.get_layer_by_name(_emb_names(m)[0])
            out[sp["key"]] = {
                "steps": res["steps"], "nshards": op._row_plan.nshards,
                "hot_rows": op._hot_rows, "dedup": op._row_plan.dedup,
                "overlap": op._row_plan.overlap,
                "mse": m.perf.report()["mse"],
                "stats": {k: dict(v) for k, v in m._collectives.stats.items()}}
            continue
        cfg = DLRMConfig(**_arch(sp.get("sizes"), sp.get("bag", BAG)))

        def model(mesh, pd):
            m = pt.FFModel(pt.FFConfig(
                batch_size=BS, device="cpu", seed=3,
                sparse_embedding_update=sp.get("sparse", True)))
            build_dlrm(m, cfg, fuse_embeddings=sp.get("fuse", True))
            m.compile(_opt(sp["opt"], optimizers), "mean_squared_error",
                      ["mse"], mesh=mesh,
                      strategies=_strategies(
                          m, mesh.size, pd, sp.get("exchange", "dense"),
                          sp.get("hot", 0.0), sp.get("overlap", False)))
            return m

        if sp.get("replicated"):
            # a refused request: the table replicated on every rank,
            # trained beside a world-1 run from the same seed
            res = {}
            for key, mesh in (("losses", make_mesh()),
                              ("world1_losses", make_mesh(devices=[rank]))):
                m = model(mesh, sp.get("pd", world))
                m.init_layers()
                res[key] = [float(m.train_batch(x)["loss"])
                            for x in sp["batches"]]
                if mesh.size > 1:
                    op = m.get_layer_by_name(_emb_names(m)[0])
                    res["kind"] = op._split.kind
                    res["table"] = m.params[op.name]["kernel"].numpy().copy()
            out[sp["key"]] = res
            continue
        m = model(make_mesh(), sp.get("pd", world))
        if sp.get("p0") is not None:
            m.swap_params(params_from_jax(m, sp["p0"]))
        else:
            m.init_layers()
        batches = sp["batches"]
        b = BS // world
        mine = slice(rank * b, (rank + 1) * b)
        names = _emb_names(m)
        ops = [m.get_layer_by_name(n) for n in names]

        def emb_out(model_, ids):
            with torch.no_grad():
                if len(ops) == 1:
                    return model_.get_layer_by_name(names[0]).apply(
                        model_.params[names[0]], [ids])[0].numpy()
                return np.stack(
                    [model_.get_layer_by_name(n).apply(
                        model_.params[n], [ids[:, i]])[0].numpy()
                     for i, n in enumerate(names)], axis=1)

        ids = torch.as_tensor(batches[0]["sparse"][mine]).long()
        res = {"emb": emb_out(m, ids)}
        if sp.get("world1") and rank == 0:
            m1 = model(make_mesh(devices=[rank]), 1)
            m1.swap_params(params_from_jax(m1, sp["p0"]))
            res["emb1"] = emb_out(
                m1, torch.as_tensor(batches[0]["sparse"]).long())
        for st in m._collectives.stats.values():     # the steps' alone
            st.update(calls=0, bytes=0, sent=0, seconds=0.0)
        res["losses"] = [float(m.train_batch(x)["loss"]) for x in batches]
        res["params"] = params_to_jax(m, m.params)
        state = {k: v for k, v in m.opt_state.items() if k != "step"}
        res["state"] = opt_state_to_jax(m, state)
        res["raw"] = _tree_np(m.params)
        res["raw_state"] = {k: _tree_np(v) for k, v in state.items()}
        res["shard"] = ops[0]._row_ex.shard
        res["nshards"] = ops[0]._row_plan.nshards
        res["hot_rows"] = ops[0]._hot_rows
        res["stats"] = {k: dict(v) for k, v in m._collectives.stats.items()}
        # a rank's block, hot head and slabs round-trip bitwise
        back = params_from_jax(m, res["params"])
        sback = opt_state_from_jax(m, res["state"])
        res["roundtrip"] = _same_tree(back, m.params) and all(
            _same_tree(sback[k], state[k]) for k in state)
        out[sp["key"]] = res
    return out


# ---- the JAX side ----------------------------------------------------------


def _jax_model(n, sp):
    import jax

    import dlrm_flexflow_tpu as ff
    from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                               build_dlrm as jax_build_dlrm)
    from dlrm_flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from dlrm_flexflow_tpu.parallel.pconfig import \
        ParallelConfig as JaxParallelConfig
    m = ff.FFModel(ff.FFConfig(
        batch_size=BS, seed=3,
        sparse_embedding_update=sp.get("sparse", True)))
    jax_build_dlrm(m, JaxDLRMConfig(**_arch(sp.get("sizes"))),
                   fuse_embeddings=sp.get("fuse", True))
    m.compile(_opt(sp["opt"], ff), "mean_squared_error", ["mse"],
              mesh=jax_make_mesh(devices=jax.devices()[:n]),
              strategies=_strategies(m, n, sp.get("pd", n),
                                     pkg=JaxParallelConfig))
    m.init_layers()
    return m


def _jax_run(m, sp):
    """(embedding output of the first batch, losses, params, state)."""
    import jax
    import jax.numpy as jnp
    batches = sp["batches"]
    names = _emb_names(m)
    ops = [m.get_layer_by_name(n) for n in names]
    sparse = jnp.asarray(batches[0]["sparse"])
    look = jax.jit(lambda p, i, op: op.apply(p, [i])[0],
                   static_argnums=2)
    if len(ops) == 1:
        emb = np.asarray(look(m.params[names[0]], sparse, ops[0]))
    else:
        emb = np.stack([np.asarray(look(m.params[n], sparse[:, i], op))
                        for i, (n, op) in enumerate(zip(names, ops))],
                       axis=1)
    losses = [float(m.train_batch(dict(x))["loss"]) for x in batches]
    state = jax.tree.map(np.asarray, m.opt_state)
    state = {k: v for k, v in state.items() if k != "step"}
    return emb, losses, jax.tree.map(np.asarray, m.params), state


# ---- the scenarios ---------------------------------------------------------


def _jax_specs(world):
    """Scenarios held against the JAX package: key -> spec."""
    out = {}
    for opt in OPTS:
        out[f"jax/stacked/{opt}/pd{world}"] = dict(opt=opt, pd=world)
        if world == 4:
            out[f"jax/stacked/{opt}/pd2"] = dict(opt=opt, pd=2)
    out["jax/embedding/sgd"] = dict(opt="sgd", fuse=False)
    out["jax/grad/sgd"] = dict(opt="sgd", sparse=False)
    out["jax/concat/adam"] = dict(opt="adam", sizes=SIZES)
    for k, sp in out.items():
        sp.update(key=k, world1=True,
                  batches=_uniform_batches(sp.get("sizes")))
    return out


# the port's own forms: (key suffix, spec changes), each held bitwise to
# the dense exchange at degree = world on the same batches
_FORMS = (("dedup", dict(exchange="dedup")),
          ("hybrid", dict(exchange="dedup", hot=HOT)),
          ("hybrid_dense", dict(hot=HOT)),
          ("overlap", dict(overlap=True)),
          ("overlap_hybrid", dict(exchange="dedup", hot=HOT, overlap=True)))


def _internal_specs(world):
    """key -> spec; keys "int/<form>/<opt>/<variant>", the baseline's
    variant "dense"."""
    out = {}
    forms = [("stacked", {}, OPTS), ("embedding", dict(fuse=False), ("sgd",)),
             ("concat", dict(sizes=SIZES), ("adam",)),
             ("grad", dict(sparse=False), ("sgd",))]
    for form, base, opts in forms:
        for opt in opts:
            variants = [("dense", {})] + [
                v for v in _FORMS
                if form == "stacked" or (form in ("embedding", "grad")
                                         and v[0] == "hybrid")
                or (form in ("concat", "grad")
                    and v[0] in ("dedup", "overlap"))]
            if world == 4 and form == "stacked":
                variants += [("pd2", dict(pd=2)),
                             ("pd2_overlap_hybrid",
                              dict(pd=2, exchange="dedup", hot=HOT,
                                   overlap=True))]
            for name, change in variants:
                key = f"int/{form}/{opt}/{name}"
                out[key] = dict(base, opt=opt, key=key, **change,
                                batches=_dup_batches(base.get("sizes")))
    return out


def _launcher_specs(world, tmp):
    """run_random.sh's and run_criteo_kaggle.sh's flags at ``world``
    devices (narrow), each with a JSON strategy that row-shards the
    table, written by ``save_strategies``."""
    import dlrm_flexflow_tpu_torch as pt
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu_torch.parallel.pconfig import ParallelConfig
    from dlrm_flexflow_tpu_torch.parallel.strategy_io import save_strategies
    out = {}
    for name, sizes, refine in (
            ("random", [ROWS] * T, dict(exchange="dedup", hot_fraction=HOT,
                                        overlap=True)),
            ("kaggle", SIZES, {})):
        arch = _arch(sizes, 1)
        m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
        build_dlrm(m, DLRMConfig(**arch))
        strat = _strategies(m, world)
        emb = _emb_names(m)[0]
        strat[emb] = ParallelConfig((world, 1, 1), param_degree=world,
                                    **refine)
        path = tmp / f"{name}_rows_{world}.json"
        save_strategies(str(path), strat)
        argv = ["-ll:gpu", str(world), "-b", str(BS), "-e", "1", "--lr",
                "0.01", "--device", "cpu", "--arch-embedding-size",
                "-".join(map(str, sizes)), "--arch-sparse-feature-size",
                str(D), "--arch-mlp-bot", "-".join(map(str, arch["mlp_bot"])),
                "--arch-mlp-top", "-".join(map(str, arch["mlp_top"])),
                "--import", str(path)]
        out[f"launcher/{name}"] = dict(launcher=argv)
    return out


def _fallback_specs():
    return {
        # 61 rows split over no degree: replicated rows
        "fb/infeasible": dict(opt="sgd", sizes=[61] * T, replicated=True,
                              batches=_uniform_batches([61] * T)),
        # concatenated tables have no hot split: replicated rows
        "fb/concat_hot": dict(opt="sgd", sizes=SIZES, hot=0.25,
                              replicated=True,
                              batches=_uniform_batches(SIZES)),
        # 128 rows at lane pack 16: a hot quantum is the whole table; the
        # op keeps plain row sharding
        "fb/unresolvable_hot": dict(opt="sgd", sizes=[128] * T, bag=3,
                                    hot=0.25, batches=None),
    }


@pytest.fixture(scope="module", params=WORLDS)
def world_run(request, tmp_path_factory):
    """One spawn of ``world`` ranks for every scenario, and the JAX models
    trained beside it (their initial weights first: the ranks start from
    them)."""
    import jax

    from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig,
                                                     synthetic_batch)
    from dlrm_flexflow_tpu_torch.utils.testing import spawn_ranks
    world = request.param
    tmp = tmp_path_factory.mktemp(f"rowshard{world}")
    jspecs = _jax_specs(world)
    jms = {k: _jax_model(world, sp) for k, sp in jspecs.items()}
    for k, m in jms.items():
        jspecs[k]["p0"] = jax.tree.map(np.asarray, m.params)
    specs = dict(jspecs)
    specs.update(_internal_specs(world))
    fb = _fallback_specs()
    x, y = synthetic_batch(DLRMConfig(**_arch([128] * T, 3)), BS, seed=9)
    x["label"] = y
    fb["fb/unresolvable_hot"]["batches"] = [x]
    for k, sp in fb.items():
        specs[k] = dict(sp, key=k)
    for k, sp in _launcher_specs(world, tmp).items():
        specs[k] = dict(sp, key=k)
    box = {}

    def ranks():
        try:
            box["ranks"] = spawn_ranks(_rank_run, world, tmp, timeout_s=400,
                                       args=(list(specs.values()),))
        except BaseException as e:     # raised below, in the test
            box["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    try:
        jax_out = {k: _jax_run(m, jspecs[k]) for k, m in jms.items()}
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return world, jspecs, box["ranks"], jax_out


def _blocks(ranks, key, getter):
    """Every shard's block of a row-sharded array, in shard order (one
    rank a shard)."""
    by_shard = {}
    for r in ranks:
        by_shard.setdefault(r[key]["shard"], getter(r[key]))
    return [by_shard[s] for s in sorted(by_shard)]


def _assembled(ranks, key, tree_of, emb):
    """The JAX-layout tree of one scenario: row-sharded kernels joined
    from every shard, every other array rank 0's."""
    out = {}
    for op, p in tree_of(ranks[0][key]).items():
        out[op] = {}
        for pn, v in p.items():
            if op in emb and pn == "kernel":
                v = np.concatenate(_blocks(
                    ranks, key, lambda r: tree_of(r)[op][pn]), axis=-2)
            out[op][pn] = v
    return out


@pytest.mark.parametrize("key", ["stacked/sgd", "stacked/momentum",
                                 "stacked/adam", "embedding/sgd",
                                 "concat/adam"])
def test_first_forward_bitwise_jax_and_world1(world_run, key):
    world, jspecs, ranks, jax_out = world_run
    form, opt = key.split("/")
    k = (f"jax/{key}/pd{world}" if form == "stacked" else f"jax/{key}")
    got = np.concatenate([r[k]["emb"] for r in ranks])
    np.testing.assert_array_equal(got, jax_out[k][0])
    np.testing.assert_array_equal(got, ranks[0][k]["emb1"])


def _jax_keys():
    keys = [f"stacked/{o}/pdW" for o in OPTS]
    keys += [f"stacked/{o}/pd2" for o in OPTS]
    return keys + ["embedding/sgd", "concat/adam", "grad/sgd"]


@pytest.mark.parametrize("key", _jax_keys())
def test_three_steps_as_the_jax_mesh(world_run, key):
    world, jspecs, ranks, jax_out = world_run
    if key.endswith("pd2") and world == 2:
        key = key.replace("pd2", "pdW")      # degree 2 = world there
    k = "jax/" + key.replace("pdW", f"pd{world}")
    _, lj, pj, sj = jax_out[k]
    emb = set(_emb_names_of(pj))
    np.testing.assert_allclose(ranks[0][k]["losses"], lj, rtol=1e-5)
    for r in ranks[1:]:
        assert r[k]["losses"] == ranks[0][k]["losses"]
    # under Adam, 1e-5 of the distance its steps move a weight, alpha a
    # step (see above)
    w_atol = 1e-5 * 0.05 * STEPS if "adam" in key else 1e-7

    def close(have, want, what, atol):
        assert have.shape == want.shape, what
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=atol,
                                   err_msg=what)

    got = _assembled(ranks, k, lambda r: r["params"], emb)
    for op, p in pj.items():
        for pn, want in p.items():
            close(got[op][pn], want, f"{op}.{pn}", w_atol)
    for slab, tree in sj.items():
        have = _assembled(ranks, k, lambda r, s=slab: r["state"][s], emb)
        for op, p in tree.items():
            for pn, want in p.items():
                close(have[op][pn], want, f"{slab}: {op}.{pn}", 1e-7)
    # the replicated weights: bitwise on every rank
    for r in ranks[1:]:
        for op, p in r[k]["params"].items():
            if op not in emb:
                for pn, v in p.items():
                    np.testing.assert_array_equal(
                        v, ranks[0][k]["params"][op][pn])


def _emb_names_of(params):
    return [op for op in params if op.startswith(("emb", "Embed"))]


def _logical(ranks, key, tree_of):
    """Each row-sharded op's logical tables (hot head, then the cold
    blocks in shard order) and every other array, from the port's own
    layout."""
    first = ranks[0][key]
    H = first["hot_rows"]
    out = {}
    for op, p in tree_of(first).items():
        if "kernel" not in p or not op.startswith("emb"):
            out[op] = p
            continue
        cold = np.concatenate(_blocks(
            ranks, key, lambda r: tree_of(r)[op]["kernel"]), axis=-2)
        out[op] = {"kernel": (np.concatenate([p["hot_kernel"], cold],
                                             axis=-2) if H else cold)}
        out[op].update({pn: v for pn, v in p.items()
                        if pn not in ("kernel", "hot_kernel")})
    return out


def _internal_pairs(world):
    specs = _internal_specs(world)
    return sorted(k for k in specs if not k.endswith("/dense"))


@pytest.mark.parametrize("variant", sorted(
    {k.split("/", 1)[1] for w in WORLDS for k in _internal_pairs(w)}))
def test_forms_bitwise_equal(world_run, variant):
    """dense == dedup == hybrid == overlap, degree 2 == 4, bitwise."""
    world, _, ranks, _ = world_run
    key = f"int/{variant}"
    if key not in ranks[0]:
        pytest.skip(f"{variant} runs at world 4 only")
    base = key.rsplit("/", 1)[0] + "/dense"
    assert ranks[0][key]["losses"] == ranks[0][base]["losses"]
    np.testing.assert_array_equal(
        np.concatenate([r[key]["emb"] for r in ranks]),
        np.concatenate([r[base]["emb"] for r in ranks]))
    want, got = _logical(ranks, base, lambda r: r["raw"]), \
        _logical(ranks, key, lambda r: r["raw"])
    for op in want:
        for pn in want[op]:
            np.testing.assert_array_equal(got[op][pn], want[op][pn],
                                          err_msg=f"{variant}: {op}.{pn}")
    for slab in ranks[0][base]["raw_state"]:
        want = _logical(ranks, base, lambda r, s=slab: r["raw_state"][s])
        got = _logical(ranks, key, lambda r, s=slab: r["raw_state"][s])
        for op in want:
            for pn in want[op]:
                np.testing.assert_array_equal(
                    got[op][pn], want[op][pn],
                    err_msg=f"{variant} {slab}: {op}.{pn}")


def test_collectives_and_weight_round_trip(world_run):
    from dlrm_flexflow_tpu_torch.parallel import alltoall
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    world, _, ranks, _ = world_run
    mesh = make_mesh(devices=range(world))
    lookups = BS * T * BAG
    for key, exch, ovl in (("int/stacked/sgd/dense", "dense", False),
                           ("int/stacked/sgd/dedup", "dedup", False),
                           ("int/stacked/sgd/overlap", "dense", True)):
        plan = alltoall.plan_row_shard(mesh, world, ROWS, 16, T,
                                       dedup=exch == "dedup", overlap=ovl)
        want = (alltoall.dedup_exchange_hlo_bytes if exch == "dedup"
                else alltoall.dense_exchange_hlo_bytes)(plan, lookups, D)
        # ids and rows forward, the packed update back, each one
        # collective, or under overlap its rounds: one point-to-point
        # call over one row axis, a call a capacity chunk over several
        name, calls = "all_to_all", 3
        if ovl and len(plan.row_axes) == 1:
            name = "p2p"
        elif ovl:
            C = plan.capacity(lookups // world)
            calls *= next(c for c in (4, 3, 2, 1) if C % c == 0)
        for r in ranks:
            st = r[key]["stats"]
            assert st[name]["calls"] == calls * STEPS, (key, st)
            assert st[name]["sent"] == want * STEPS, (key, st)
            # the dense gradients and the metrics
            assert st["all_reduce"]["calls"] == 2 * STEPS
            assert st["all_gather"]["calls"] == 0
    for r in ranks:
        # the hybrid's hot stream: one all-gather a step
        assert r["int/stacked/sgd/hybrid"]["stats"]["all_gather"][
            "calls"] == STEPS
        for key, res in r.items():
            if "roundtrip" in res:
                assert res["roundtrip"], key
    if world == 4:
        # degree 2 of 4: the row exchange inside each pair, and the
        # update rows gathered from the block's other replica
        st = ranks[0]["int/stacked/sgd/pd2"]["stats"]
        assert st["all_to_all"]["calls"] == 3 * STEPS
        assert st["all_gather"]["calls"] == STEPS
        assert {r["int/stacked/sgd/pd2"]["shard"] for r in ranks} == {0, 1}


def test_launcher_imports_row_sharded_strategies(world_run):
    world, _, ranks, _ = world_run
    for r in ranks:
        rnd, kag = r["launcher/random"], r["launcher/kaggle"]
        # a warm-up step and 64 timed ones, each its three exchanges
        for res in (rnd, kag):
            assert res["nshards"] == world and np.isfinite(res["mse"])
            assert res["steps"] == 64
        assert rnd["dedup"] and rnd["overlap"] and rnd["hot_rows"] == 128
        assert not kag["dedup"] and kag["hot_rows"] == 0
        name = "p2p" if len(_plan_axes(world)) == 1 else "all_to_all"
        assert rnd["stats"]["all_gather"]["calls"] == 65
        assert rnd["stats"][name]["calls"] >= 3 * 65
        assert kag["stats"]["all_to_all"]["calls"] == 3 * 65


def _plan_axes(world):
    from dlrm_flexflow_tpu_torch.parallel import alltoall
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    return alltoall.plan_row_shard(make_mesh(devices=range(world)), world,
                                   ROWS, 16).row_axes


def _warnings_of(fn):
    msgs = []

    class H(logging.Handler):
        def emit(self, rec):
            msgs.append(rec.getMessage())

    h = H(logging.WARNING)
    lg = logging.getLogger("ff.embedding")
    lg.addHandler(h)
    try:
        fn()
    finally:
        lg.removeHandler(h)
    return msgs


@pytest.mark.parametrize("case", ["infeasible", "concat_hot",
                                  "unresolvable_hot"])
def test_loud_fallbacks(world_run, case):
    """The JAX compile's warnings, word for word (the port compiles on a
    mesh of ``world`` ranks without a group: it places, and warns); then,
    across ranks, a refused request trains with the table replicated
    (every rank's copy bitwise equal, the losses those of a world-1 run
    within rtol 1e-5) and an unresolvable hot split trains plain
    row-sharded."""
    import jax

    import dlrm_flexflow_tpu as ff
    import dlrm_flexflow_tpu_torch as pt
    from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                               build_dlrm as jax_build_dlrm)
    from dlrm_flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from dlrm_flexflow_tpu.parallel.pconfig import \
        ParallelConfig as JaxParallelConfig
    from dlrm_flexflow_tpu_torch.core import optimizers
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    world, _, ranks, _ = world_run
    sp = _fallback_specs()[f"fb/{case}"]
    arch = _arch(sp["sizes"], sp.get("bag", BAG))

    def jax_compile():
        m = ff.FFModel(ff.FFConfig(batch_size=BS))
        jax_build_dlrm(m, JaxDLRMConfig(**arch))
        m.compile(ff.SGDOptimizer(lr=0.05), "mean_squared_error", ["mse"],
                  mesh=jax_make_mesh(devices=jax.devices()[:world]),
                  strategies=_strategies(m, world, hot=sp.get("hot", 0.0),
                                         pkg=JaxParallelConfig))

    def port_compile():
        m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
        build_dlrm(m, DLRMConfig(**arch))
        m.compile(optimizers.SGDOptimizer(lr=0.05),
                  "mean_squared_error", ["mse"],
                  mesh=make_mesh(devices=range(world)),
                  strategies=_strategies(m, world, hot=sp.get("hot", 0.0)))

    want = _warnings_of(jax_compile)
    assert want and _warnings_of(port_compile) == want
    res = [r[f"fb/{case}"] for r in ranks]
    if sp.get("replicated"):
        assert "replicated rows" in want[-1]
        assert all(r["kind"] == "replicated" for r in res)
        for r in res:
            np.testing.assert_array_equal(r["table"], res[0]["table"])
            assert r["losses"] == res[0]["losses"]
            assert np.isfinite(r["losses"]).all()
            np.testing.assert_allclose(r["losses"], r["world1_losses"],
                                       rtol=1e-5)
    else:
        assert "plain row sharding" in want[0]
        assert all(r["hot_rows"] == 0 and r["nshards"] == world
                   and np.isfinite(r["losses"]).all() for r in res)


# ---- without a process group ----------------------------------------------


def test_plans_and_formulas_match_jax():
    import jax

    from dlrm_flexflow_tpu.ops import embedding as jemb
    from dlrm_flexflow_tpu.parallel import alltoall as ja
    from dlrm_flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from dlrm_flexflow_tpu_torch.ops import embedding as pemb
    from dlrm_flexflow_tpu_torch.parallel import alltoall as pa
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    assert pemb.HOT_QUANTUM_PACKS == jemb.HOT_QUANTUM_PACKS
    for rows in (61, 128, 1000, 1024, 4096, 11386880):
        for pack in (1, 2, 8, 16):
            for pd in (1, 2, 3, 4, 8):
                for frac in (0.0, 1e-5, 0.05, 0.125, 0.5, 0.9):
                    assert pemb.resolve_hot_rows(rows, pack, pd, frac) == \
                        jemb.resolve_hot_rows(rows, pack, pd, frac)
    fields = ("row_axes", "nshards", "rows_local", "flat_rows_local",
              "dedup", "hot_rows", "tables", "overlap")
    for n in (2, 4, 8):
        jm, pm = jax_make_mesh(devices=jax.devices()[:n]), make_mesh(
            devices=range(n))
        for rows in (128, 1000, 1024, 4096):
            for pack in (1, 2, 16):
                for pd in (1, 2, 3, 4, 8):
                    for tables, dedup, hot, ovl in ((1, False, 0, False),
                                                    (4, True, 128, True),
                                                    (26, True, 0, False)):
                        jp = ja.plan_row_shard(jm, pd, rows, pack, tables,
                                               dedup, hot, ovl)
                        pp = pa.plan_row_shard(pm, pd, rows, pack, tables,
                                               dedup, hot, ovl)
                        assert (jp is None) == (pp is None), (n, rows, pd)
                        if jp is None:
                            continue
                        assert all(getattr(jp, f) == getattr(pp, f)
                                   for f in fields), (n, rows, pd)
                        assert pp.row_ranges() == jp.row_ranges()
                        assert pp.nonrow_axes == jp.nonrow_axes
                        for look in (64, 2048, 16384):
                            for fn in ("dense_exchange_hlo_bytes",
                                       "dedup_exchange_hlo_bytes",
                                       "exchange_bytes_per_step"):
                                assert getattr(pa, fn)(pp, look, 8) == \
                                    getattr(ja, fn)(jp, look, 8), fn
                            assert pa.exchange_bytes_per_step(
                                pp, look, 64, distinct_per_device=37.5,
                                backward=False) == ja.exchange_bytes_per_step(
                                jp, look, 64, distinct_per_device=37.5,
                                backward=False)
        assert pa.shard_row_ranges(1000, n) == ja.shard_row_ranges(1000, n)
        ids = np.arange(-5, 2000, 7)
        np.testing.assert_array_equal(pa.row_owners(ids, 1000, n),
                                      ja.row_owners(ids, 1000, n))


def test_structural_reasons_match_jax():
    import dlrm_flexflow_tpu as ff
    import dlrm_flexflow_tpu_torch as pt
    from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                               build_dlrm as jax_build_dlrm)
    from dlrm_flexflow_tpu.ops.embedding import \
        row_shard_structural_reason as jreason
    from dlrm_flexflow_tpu.parallel.pconfig import \
        ParallelConfig as JaxParallelConfig
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu_torch.ops.embedding import \
        row_shard_structural_reason as preason
    from dlrm_flexflow_tpu_torch.parallel.pconfig import ParallelConfig
    seen = set()
    for sizes, fuse, batch in (([ROWS] * T, True, BS), ([61] * T, True, BS),
                               (SIZES, True, BS), ([ROWS] * T, False, BS),
                               ([ROWS] * T, True, 6)):
        jm = ff.FFModel(ff.FFConfig(batch_size=batch))
        jax_build_dlrm(jm, JaxDLRMConfig(**_arch(sizes)), fuse_embeddings=fuse)
        pm = pt.FFModel(pt.FFConfig(batch_size=batch, device="cpu"))
        build_dlrm(pm, DLRMConfig(**_arch(sizes)), fuse_embeddings=fuse)
        for name in _emb_names(pm):
            jop, pop = jm.get_layer_by_name(name), pm.get_layer_by_name(name)
            nd = pop.outputs[0].num_dims
            for pd in (1, 2, 3, 4, 8):
                for degs in ((2,) + (1,) * (nd - 1), (1, 2) + (1,) * (nd - 2)):
                    for hot in (0.0, 0.25):
                        for sizes_ in ([2], [2, 2], [2, 2, 2], [3]):
                            want = jreason(jop, JaxParallelConfig(
                                degs, param_degree=pd, hot_fraction=hot),
                                sizes_)
                            got = preason(pop, ParallelConfig(
                                degs, param_degree=pd, hot_fraction=hot),
                                sizes_)
                            assert got == want, (name, pd, degs, sizes_)
                            seen.add(want)
    # every reason of the rule set came up
    assert len(seen) >= 6, seen
