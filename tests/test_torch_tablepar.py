"""DLRM across ranks under the rest of ``dlrm_strategy`` and the
reference's per-table strategy files, against the JAX package.

Worlds of 2 and 4 gloo ranks (``utils.testing.spawn_ranks``, one spawn a
world for the whole module) run every scenario; the JAX models run on a
mesh of as many of ``conftest.py``'s virtual CPU devices, their weights
carried into every rank by ``params_from_jax`` (a rank takes its piece)
and back by ``params_to_jax`` (the pieces, in block order, are the JAX
stored arrays). Narrow shapes: non-uniform tables [300, 1024, 77, 4000,
9, 2500] (Criteo-Kaggle's shape: one concatenated table, 16,384 padded
rows) or 8 uniform tables of 512 rows, d = 16, batch 32, MLPs of 16.

The scenarios:

- the concatenated table in row blocks over the whole mesh
  (``dlrm_strategy``'s table degree 2), at bag 1 and bag 2, and grouped
  by device under a per-table file (table i on device i % world);
- one ``Embedding`` a table split by width (``dlrm_strategy``), and
  replicated on every rank (the per-table file's (1, 1) entries);
- the stacked tables split by table (``dlrm_strategy``) with the first
  top ``Linear`` split by channel over 2 devices; at world 4 the stacked
  tables over 2 of the 4 ranks (a per-table file naming 2 devices) with
  the same ``Linear``;
- a batch of 31 rows, which divides over no world, through
  ``forward_batch`` beside row-sharded tables and beside each split
  above: every rank runs all of it with the split ops' parameters
  gathered (the JAX op's route); and a batch of 32, which does: every
  rank runs its rows and gets every row's prediction;
- the launcher with ``run_criteo_kaggle.sh``'s flags (narrow) at world
  devices, with no ``--import`` and with a per-table file.

Held, and why:

- the embedding output of the first batch BITWISE the JAX op's: a bag's
  rows are the same rows, and at bag 1 and 2 their sum is the same sum
  (a row block's masked bags add zero rows, and two partial sums add in
  either order to the same value);
- three SGD steps: the losses within rtol 1e-5 of JAX's and every
  weight within rtol 1e-5, atol 1e-7 (the MLPs' gradients sum in
  another order: each rank's share, then over the ranks; GSPMD's
  partial sums), as ``test_torch_rowshard.py`` holds them;
- every copy of a block (the replicated MLPs and tables, a block's
  copies on the other mesh axes, a ``Linear``'s column block over 2 of
  4 ranks) BITWISE equal across ranks;
- the 31-row forward: the predictions BITWISE a world-1 run's from the
  same weights, the gathered embedding output BITWISE the JAX op's on
  the same rows (the op gathers its table); the 32-row forward within
  rtol 1e-5, atol 1e-7 of a world-1 run's, bitwise equal across ranks;
- the collectives of each step: the calls, and the bytes handed over
  (``stats[...]["sent"]``) equal to the formulas of ``_per_step``.
"""

import json
import threading

import numpy as np
import pytest

# The ranks are spawned processes that import this module to find
# _rank_run: the JAX package is imported in the functions that use it.

SIZES = [300, 1024, 77, 4000, 9, 2500]    # 16,384 rows padded
UNIFORM = [512] * 8
D, BS, LR, STEPS = 16, 32, 0.1, 3
EVAL_ROWS = 31                             # divides over no world
WORLDS = (2, 4)
LINEAR = "top_dense_0"


def _arch(sizes, bag=1):
    return dict(embedding_size=list(sizes), sparse_feature_size=D,
                embedding_bag_size=bag, mlp_bot=[4, 16, D],
                mlp_top=[D * (len(sizes) + 1), 16, 1])


def _scenarios(world):
    """key -> (sizes, bag, fuse, strategy source, top Linear split)."""
    out = {
        "concat/bag1": (SIZES, 1, True, "dlrm", False),
        "concat/bag2": (SIZES, 2, True, "dlrm", False),
        "concat/groups": (SIZES, 1, True, "file", False),
        "width": (SIZES, 1, False, "dlrm", False),
        "replicated": (SIZES, 2, False, "file", False),
        "channel": (UNIFORM, 1, True, "dlrm", True),
        "rowshard": (UNIFORM, 1, True, "rows", False),
    }
    if world == 4:
        out["partial"] = (UNIFORM, 1, True, "file2", True)
    return out


def _strategy_file(tmp, world, ntables, ndev, channel):
    """The reference's per-table keys, table i on device i % ndev, every
    other op data-parallel over the world; with ``channel`` the first top
    Linear split by channel over 2 devices."""
    ops = [{"name": f"embedding{i}", "device_type": "TPU", "dims": [1, 1],
            "device_ids": [i % ndev], "memory_types": []}
           for i in range(ntables)]
    ops += [{"name": k, "device_type": "TPU", "dims": [world, 1],
             "device_ids": list(range(world)), "memory_types": []}
            for k in ("linear", "concat")]
    if channel:
        ops.append({"name": LINEAR, "device_type": "TPU", "dims": [1, 2],
                    "device_ids": list(range(world)), "memory_types": []})
    path = tmp / f"per_table_{world}_{ntables}_{ndev}_{int(channel)}.json"
    path.write_text(json.dumps({"ops": ops}))
    return str(path)


def _strategies(model, cfg, world, source, channel, path, pkg):
    """The strategy map of a scenario, made by ``pkg``'s own functions
    (the port's or the JAX package's)."""
    if source in ("dlrm", "rows"):
        strat = pkg["dlrm_strategy"](model, cfg, world,
                                     row_shard=source == "rows")
        if channel:
            strat[LINEAR] = pkg["ParallelConfig"]((1, 2))
        return strat
    return pkg["load_strategies"](path)


def _port_pkg():
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel.pconfig import ParallelConfig
    from dlrm_flexflow_tpu_torch.parallel.strategy_io import load_strategies
    return dict(dlrm_strategy=dlrm_strategy, ParallelConfig=ParallelConfig,
                load_strategies=load_strategies)


def _emb_names(model):
    return [op.name for op in model.ops
            if type(op).__name__ in ("EmbeddingBagStacked",
                                     "EmbeddingBagConcat", "Embedding")]


def _batches(sizes, bag):
    from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig,
                                                     synthetic_batch)
    out = []
    for s in range(STEPS):
        x, y = synthetic_batch(DLRMConfig(**_arch(sizes, bag)), BS,
                               seed=60 + s)
        x["label"] = y
        out.append(x)
    return out


def _eval_batch(sizes, bag):
    from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig,
                                                     synthetic_batch)
    return synthetic_batch(DLRMConfig(**_arch(sizes, bag)), EVAL_ROWS,
                           seed=99)[0]


# ---- the ranks -----------------------------------------------------------


def _split_of(op):
    """(kind, block, nblocks) of an op split across ranks, or None."""
    split = getattr(op, "_split", None)
    if split is not None:
        return (split.kind, split.block, split.nblocks)
    if getattr(op, "_row_plan", None) is not None:
        return ("rowshard", op._row_ex.shard, op._row_plan.nshards)
    return None


def _emb_out(model, names, ids, params=None):
    import torch
    params = params or model.params
    with torch.no_grad():
        if len(names) == 1:
            return model.get_layer_by_name(names[0]).apply(
                params[names[0]], [ids])[0].numpy()
        return np.stack([model.get_layer_by_name(n).apply(
            params[n], [ids[:, i]])[0].numpy()
            for i, n in enumerate(names)], axis=1)


def _rank_run(rank, world, specs):
    """Every scenario of ``specs`` on this rank; returns {key: result}."""
    import torch

    import dlrm_flexflow_tpu_torch as pt
    from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
    from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, build_dlrm
    from dlrm_flexflow_tpu_torch.parallel.mesh import make_mesh
    from dlrm_flexflow_tpu_torch.utils.weights import (params_from_jax,
                                                       params_to_jax)
    pkg = _port_pkg()
    out = {}
    for sp in specs:
        if sp.get("launcher"):
            from dlrm_flexflow_tpu_torch.examples.native import dlrm as app
            res = app.main(sp["launcher"])
            m = res["model"]
            op = m.get_layer_by_name("emb_concat")
            out[sp["key"]] = {
                "steps": res["steps"], "split": _split_of(op),
                "offsets": op._offsets, "total_rows": op.total_rows,
                "mse": m.perf.report()["mse"],
                "stats": {k: dict(v) for k, v in
                          m._collectives.stats.items()}}
            continue
        sizes, bag, fuse = sp["sizes"], sp["bag"], sp["fuse"]
        cfg = DLRMConfig(**_arch(sizes, bag))

        def model(mesh):
            m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu", seed=3))
            build_dlrm(m, cfg, fuse_embeddings=fuse)
            m.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"],
                      mesh=mesh, strategies=_strategies(
                          m, cfg, mesh.size, sp["source"], sp["channel"],
                          sp["path"], pkg))
            m.swap_params(params_from_jax(m, sp["p0"]))
            return m

        m = model(make_mesh())
        names = _emb_names(m)
        b = BS // world
        mine = slice(rank * b, (rank + 1) * b)
        res = {"splits": {op.name: _split_of(op) for op in m.ops
                          if _split_of(op) is not None}}
        # a batch that divides over no world: all of it on every rank,
        # beside a world-1 model holding the same logical weights
        ev = _eval_batch(sizes, bag)
        m1 = model(make_mesh(devices=[rank]))
        res["eval"] = m.forward_batch(ev).numpy()
        with m._as_one_card() as whole:
            res["eval_emb"] = _emb_out(
                m, names, torch.as_tensor(ev["sparse"]).long(), whole)
            m1.swap_params({k: {p: v.clone() for p, v in d.items()}
                            for k, d in whole.items()})
        res["eval1"] = m1.forward_batch(ev).numpy()
        batches = sp["batches"]
        full = {k: v for k, v in batches[0].items() if k != "label"}
        res["eval_all"] = m.forward_batch(full).numpy()
        res["eval_all1"] = m1.forward_batch(full).numpy()
        del m1
        res["emb"] = _emb_out(m, names, torch.as_tensor(
            batches[0]["sparse"][mine]).long())
        for st in m._collectives.stats.values():     # the steps' alone
            st.update(calls=0, bytes=0, sent=0, seconds=0.0)
        if sp["source"] != "rows":
            res["losses"] = [float(m.train_batch(x)["loss"])
                             for x in batches]
        res["params"] = params_to_jax(m, m.params)
        res["stats"] = {k: dict(v) for k, v in m._collectives.stats.items()}
        # a rank's pieces round-trip bitwise
        back = params_from_jax(m, res["params"])
        res["roundtrip"] = all(torch.equal(back[k][p], m.params[k][p])
                               for k in back for p in back[k])
        if "emb_concat" in names:
            op = m.get_layer_by_name("emb_concat")
            res["offsets"], res["total_rows"] = op._offsets, op.total_rows
        out[sp["key"]] = res
    return out


# ---- the JAX side ----------------------------------------------------------


def _jax_pkg():
    from dlrm_flexflow_tpu.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu.parallel.pconfig import ParallelConfig
    from dlrm_flexflow_tpu.parallel.strategy_io import load_strategies
    return dict(dlrm_strategy=dlrm_strategy, ParallelConfig=ParallelConfig,
                load_strategies=load_strategies)


def _jax_model(world, sp):
    import jax

    import dlrm_flexflow_tpu as ff
    from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                               build_dlrm as jax_build_dlrm)
    from dlrm_flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
    cfg = JaxDLRMConfig(**_arch(sp["sizes"], sp["bag"]))
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=5))
    jax_build_dlrm(m, cfg, fuse_embeddings=sp["fuse"])
    m.compile(ff.SGDOptimizer(lr=LR), "mean_squared_error", ["mse"],
              mesh=jax_make_mesh(devices=jax.devices()[:world]),
              strategies=_strategies(m, cfg, world, sp["source"],
                                     sp["channel"], sp["path"], _jax_pkg()))
    m.init_layers()
    return m


def _jax_run(m, sp):
    """(embedding output of the first batch and of the eval batch, the
    losses, the trained params, the concatenated op's offsets)."""
    import jax
    import jax.numpy as jnp
    names = _emb_names(m)
    look = jax.jit(lambda p, i, op: op.apply(p, [i])[0], static_argnums=2)

    def emb(sparse):
        sparse = jnp.asarray(sparse)
        ops = [m.get_layer_by_name(n) for n in names]
        if len(ops) == 1:
            return np.asarray(look(m.params[names[0]], sparse, ops[0]))
        return np.stack([np.asarray(look(m.params[n], sparse[:, i], op))
                         for i, (n, op) in enumerate(zip(names, ops))],
                        axis=1)

    first = emb(sp["batches"][0]["sparse"])
    ev = emb(_eval_batch(sp["sizes"], sp["bag"])["sparse"])
    losses = ([float(m.train_batch(dict(x))["loss"]) for x in sp["batches"]]
              if sp["source"] != "rows" else None)
    offs = None
    if "emb_concat" in names:
        op = m.get_layer_by_name("emb_concat")
        offs = (tuple(int(o) for o in op._offsets), int(op.total_rows))
    return first, ev, losses, jax.tree.map(np.asarray, m.params), offs


def _launcher_specs(world, tmp):
    """run_criteo_kaggle.sh's flags at ``world`` devices (narrow), with
    no ``--import`` (``dlrm_strategy``) and with a per-table file."""
    argv = ["-ll:gpu", str(world), "-b", str(BS), "-e", "1", "--lr",
            "0.01", "--device", "cpu", "--arch-embedding-size",
            "-".join(map(str, SIZES)), "--arch-sparse-feature-size", str(D),
            "--arch-mlp-bot", "4-16-16",
            "--arch-mlp-top", f"{D * (len(SIZES) + 1)}-16-1"]
    path = _strategy_file(tmp, world, len(SIZES), world, False)
    return {"launcher/dlrm": dict(launcher=argv),
            "launcher/file": dict(launcher=argv + ["--import", path])}


@pytest.fixture(scope="module", params=WORLDS)
def world_run(request, tmp_path_factory):
    """One spawn of ``world`` ranks for every scenario, and the JAX models
    beside it (their initial weights first: the ranks start from them)."""
    import jax

    from dlrm_flexflow_tpu_torch.utils.testing import spawn_ranks
    world = request.param
    tmp = tmp_path_factory.mktemp(f"tablepar{world}")
    specs = {}
    for key, (sizes, bag, fuse, source, channel) in \
            _scenarios(world).items():
        path = None
        if source == "file":
            path = _strategy_file(tmp, world, len(sizes), world, channel)
        elif source == "file2":
            path = _strategy_file(tmp, world, len(sizes), 2, channel)
        specs[key] = dict(key=key, sizes=sizes, bag=bag, fuse=fuse,
                          source=source, channel=channel, path=path,
                          batches=_batches(sizes, bag))
    jms = {k: _jax_model(world, sp) for k, sp in specs.items()}
    for k, m in jms.items():
        specs[k]["p0"] = jax.tree.map(np.asarray, m.params)
    run = list(specs.values()) + [dict(sp, key=k) for k, sp in
                                  _launcher_specs(world, tmp).items()]
    box = {}

    def ranks():
        try:
            box["ranks"] = spawn_ranks(_rank_run, world, tmp, timeout_s=400,
                                       args=(run,))
        except BaseException as e:     # raised below, in the test
            box["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    try:
        jax_out = {k: _jax_run(m, specs[k]) for k, m in jms.items()}
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return world, specs, box["ranks"], jax_out


def _assembled(ranks, key):
    """The JAX-layout params of one scenario: each split op's pieces
    joined in block order (a block's first rank's), every other array
    rank 0's."""
    axis = {"rows": 0, "table": 0, "rowshard": -2, "width": -1,
            "channel": -1}
    first = ranks[0][key]
    out = {}
    for op, p in first["params"].items():
        split = first["splits"].get(op)
        if split is None or split[0] == "replicated":
            out[op] = p
            continue
        pieces = {}
        for r in ranks:
            pieces.setdefault(r[key]["splits"][op][1], r[key]["params"][op])
        out[op] = {pn: np.concatenate([pieces[k][pn]
                                       for k in sorted(pieces)],
                                      axis=axis[split[0]])
                   for pn in p}
    return out


TRAINED = ["concat/bag1", "concat/bag2", "concat/groups", "width",
           "replicated", "channel", "partial"]


def _keys(world):
    return [k for k in TRAINED if k in _scenarios(world)]


@pytest.mark.parametrize("key", TRAINED)
def test_splits_as_the_jax_mesh(world_run, key):
    """Each op splits as the JAX map places it: the concatenated table in
    row blocks over every rank (with device groups, block k exactly the
    k-th group's tables), an Embedding by width, the stacked tables by
    table over all ranks or 2 of 4, the Linear by channel over 2."""
    world, specs, ranks, jax_out = world_run
    if key not in specs:
        pytest.skip(f"{key} runs at world 4 only")
    sizes = specs[key]["sizes"]
    splits = [r[key]["splits"] for r in ranks]
    want = {"concat/bag1": ("rows", world), "concat/bag2": ("rows", world),
            "concat/groups": ("rows", world), "width": ("width", world),
            "replicated": ("replicated", 1), "channel": ("table", world),
            "partial": ("table", 2)}[key]
    emb = _emb_names_of(ranks[0][key]["params"])
    for s in splits:
        for name in emb:
            assert s[name][0] == want[0] and s[name][2] == want[1], s
        if specs[key]["channel"]:
            assert s[LINEAR][0] == "channel" and s[LINEAR][2] == 2
    if "concat" in key:
        offs, total = jax_out[key][4]
        for r in ranks:
            assert r[key]["offsets"] == offs and r[key]["total_rows"] == total
        if key == "concat/groups":
            # block k holds exactly the tables of device k
            rl = total // world
            for t, off in enumerate(offs):
                assert off // rl == t % world
                assert (off + sizes[t] - 1) // rl == t % world


def _emb_names_of(params):
    return [op for op in params if op.startswith("emb")]


@pytest.mark.parametrize("key", TRAINED)
def test_three_steps_as_the_jax_mesh(world_run, key):
    world, specs, ranks, jax_out = world_run
    if key not in specs:
        pytest.skip(f"{key} runs at world 4 only")
    first, _, lj, pj, _ = jax_out[key]
    # the embedding output of the first batch, bitwise
    np.testing.assert_array_equal(
        np.concatenate([r[key]["emb"] for r in ranks]), first)
    np.testing.assert_allclose(ranks[0][key]["losses"], lj, rtol=1e-5)
    got = _assembled(ranks, key)
    init = specs[key]["p0"]
    for op, p in pj.items():
        for pn, want in p.items():
            have = got[op][pn]
            assert have.shape == want.shape, (op, pn, have.shape)
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{key}: {op}.{pn}")
            assert np.abs(want - init[op][pn]).max() > 0, (op, pn)
    for r in ranks:
        assert r[key]["losses"] == ranks[0][key]["losses"]
        assert r[key]["roundtrip"], key


@pytest.mark.parametrize("key", TRAINED)
def test_copies_bitwise_equal_across_ranks(world_run, key):
    """Every copy of a piece is bitwise the first: a replicated op's
    arrays on every rank, a split op's block on every rank holding it."""
    world, specs, ranks, _ = world_run
    if key not in specs:
        pytest.skip(f"{key} runs at world 4 only")
    first = ranks[0][key]
    copies = 0
    for op, p in first["params"].items():
        split = first["splits"].get(op)
        for r in ranks[1:]:
            rs = r[key]["splits"].get(op)
            if split is not None and split[0] != "replicated" \
                    and rs[1] != split[1]:
                continue           # another block
            copies += 1
            for pn, v in p.items():
                np.testing.assert_array_equal(
                    r[key]["params"][op][pn], v, err_msg=f"{op}.{pn}")
    # the blocks held on more than one rank were compared too
    if key == "partial" or (key == "channel" and world == 4):
        blocks = [r[key]["splits"][LINEAR][1] for r in ranks]
        assert blocks.count(blocks[0]) == world // 2
    assert copies


@pytest.mark.parametrize("key", TRAINED + ["rowshard"])
def test_undivided_eval_batch_gathers_the_tables(world_run, key):
    """A 31-row batch through ``forward_batch``: every rank returns all
    31 predictions, bitwise a world-1 model's from the same weights, and
    the gathered tables' embedding output is bitwise the JAX op's on the
    same rows."""
    world, specs, ranks, jax_out = world_run
    if key not in specs:
        pytest.skip(f"{key} runs at world 4 only")
    if key == "rowshard":
        assert all(s[0] == "rowshard"
                   for s in ranks[0][key]["splits"].values())
    for r in ranks:
        assert r[key]["eval"].shape == (EVAL_ROWS, 1)
        np.testing.assert_array_equal(r[key]["eval"], r[key]["eval1"])
        np.testing.assert_array_equal(r[key]["eval_emb"], jax_out[key][1])


@pytest.mark.parametrize("key", TRAINED + ["rowshard"])
def test_divided_eval_batch_returns_every_row(world_run, key):
    """A batch that divides over the ranks through ``forward_batch``:
    every rank returns all BS predictions in row order, as for one that
    does not, within rtol 1e-5 / atol 1e-7 of a world-1 model's from the
    same weights (each rank's rows went through the split ops), and the
    ranks' results bitwise equal (one all-gather)."""
    world, specs, ranks, _ = world_run
    if key not in specs:
        pytest.skip(f"{key} runs at world 4 only")
    for r in ranks:
        assert r[key]["eval_all"].shape == (BS, 1)
        np.testing.assert_allclose(r[key]["eval_all"], r[key]["eval_all1"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(r[key]["eval_all"],
                                      ranks[0][key]["eval_all"])


def _per_step(world, key, specs):
    """{collective: (calls, bytes handed over)} of one training step of a
    rank: the formulas the counts must equal."""
    sizes, bag = specs[key]["sizes"], specs[key]["bag"]
    T, b = len(sizes), BS // world
    ids, rows = 8, 4                       # int64 ids, fp32 rows
    out = {"all_to_all": [0, 0], "all_gather": [0, 0],
           "reduce_scatter": [0, 0], "p2p": [0, 0]}
    if key.startswith("concat"):
        # the global ids (forward) and cotangents (update); the partial
        # bags summed into each rank's rows
        out["all_gather"] = [2, b * T * bag * ids + b * T * D * rows]
        out["reduce_scatter"] = [1, BS * T * D * rows]
    elif key == "width":
        # a table: its global ids; its columns to the ranks' rows and back
        out["all_gather"] = [T, T * b * bag * ids]
        out["all_to_all"] = [2 * T, 2 * T * BS * (D // world) * rows]
    elif key == "replicated":
        # a table's update: the global ids and cotangents
        out["all_gather"] = [2 * T, T * (b * bag * ids + b * D * rows)]
    else:
        # split by table: ids, bags back, cotangents (the table exchange),
        # then over 2 of 4 the copies gather cotangents and ids
        out["all_to_all"] = [3, b * T * bag * ids + 2 * b * T * D * rows]
        if key == "partial":
            out["all_gather"] = [2, b * T * D * rows + b * T * bag * ids]
        # the Linear split by channel: the global input, its columns to
        # the ranks' rows, the cotangent's columns back
        n_in, n_out = D * (T + 1), 16
        out["all_gather"][0] += 1
        out["all_gather"][1] += b * n_in * rows
        out["all_to_all"][0] += 2
        out["all_to_all"][1] += 2 * BS * (n_out // 2) * rows
    return out


@pytest.mark.parametrize("key", TRAINED)
def test_collectives_per_step(world_run, key):
    world, specs, ranks, _ = world_run
    if key not in specs:
        pytest.skip(f"{key} runs at world 4 only")
    want = _per_step(world, key, specs)
    # the dense gradients and the metrics; the Linear's partial products
    # of its input's cotangent summed over the other column block
    reduces = 2 + (1 if specs[key]["channel"] else 0)
    for r in ranks:
        st = r[key]["stats"]
        for name, (calls, sent) in want.items():
            assert st[name]["calls"] == calls * STEPS, (name, st[name])
            assert st[name]["sent"] == sent * STEPS, (name, st[name])
        assert st["all_reduce"]["calls"] == reduces * STEPS


@pytest.mark.parametrize("how", ["dlrm", "file"])
def test_launcher_trains_criteo_kaggle_across_ranks(world_run, how):
    """run_criteo_kaggle.sh's flags (narrow) at world devices: the
    concatenated table in row blocks, grouped by device under the file;
    a warm-up step and 64 timed ones, each its collectives."""
    world, _, ranks, _ = world_run
    for r in ranks:
        res = r[f"launcher/{how}"]
        assert res["split"][0] == "rows" and res["split"][2] == world
        assert res["steps"] == 64 and np.isfinite(res["mse"])
        st = res["stats"]
        assert st["reduce_scatter"]["calls"] == 65
        assert st["all_gather"]["calls"] == 2 * 65
        assert st["all_reduce"]["calls"] == 2 * 65
    grouped = ranks[0]["launcher/file"]
    assert grouped["total_rows"] == world * 8192
    rl = grouped["total_rows"] // world
    for t, off in enumerate(grouped["offsets"]):
        assert off // rl == t % world
