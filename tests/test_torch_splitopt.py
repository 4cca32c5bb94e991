"""Every optimizer on tables split across ranks, against the JAX package.

Worlds of 2 and 4 gloo ranks (``utils.testing.spawn_ranks``, one spawn a
world for the whole module) run every scenario; the JAX models run on a
mesh of as many of ``conftest.py``'s virtual CPU devices, their weights
and optimizer state carried into every rank by ``params_from_jax`` /
``opt_state_from_jax`` (a rank takes its piece) and back by
``params_to_jax`` / ``opt_state_to_jax`` (the pieces, in block order,
are the JAX stored arrays). Narrow shapes: non-uniform tables [300,
1024, 77, 4000, 9, 2500] (one concatenated table, 16,384 padded rows,
or an ``Embedding`` a table) or 8 uniform tables of 512 rows, d = 16,
batch 32, MLPs of 16, 3 steps.

The scenarios (world 2 unless named):

- the concatenated table in row blocks (bag 1 and 2), and grouped by
  device under a per-table file; the stacked tables split by table;
  ``Embedding``s split by width: each under ``compile()``'s default
  optimizer (SGD with weight decay 1e-4), SGD with momentum 0.9,
  nesterov and weight decay 1e-4, and Adam (the touched-rows update:
  kernel 2's stateful entry over a block's window, ``lo``, or on a
  width piece's columns);
- each of the three kinds with ``sparse_embedding_update=False`` under
  plain SGD and Adam (a split piece's dense gradient, ``split_dense_grad``,
  in the one dense update: every row of the piece moves under Adam);
- the width split under int8 stochastic rounding (the two-pass
  rounding of a row split over ranks);
- the fused "dot" (its table replicated and batch-parallel) under SGD
  and Adam;
- world 4: the stacked tables over 2 of the 4 ranks (a per-table file
  naming 2 devices) under Adam, each block on two ranks.

Held, and why:

- against JAX: the losses within rtol 1e-5, and every weight and every
  state slab, assembled in block order, within rtol 1e-5, atol 1e-7, as
  ``test_torch_tablepar.py`` and ``test_torch_rowshard.py`` hold them
  (the MLPs' gradients sum in another order: each rank's share, then
  over the ranks; GSPMD's partial sums). Under Adam, which divides by
  sqrt(v) + eps, a weight whose summed gradient cancels to near 0 at a
  step turns that order (an ulp of the terms) into a relative error of
  its own step; ``test_torch_rowshard.py`` holds the weights within
  rtol 1e-5 and 1e-5 of the distance Adam's steps can move a weight,
  alpha a step, and so does this module, except at the values whose
  JAX gradient at some step was below GRAD_FLOOR (1e-3) of its
  parameter's largest at that step (recovered from JAX's moments after
  each step): there within 2e-4 of that distance. Measured, with alpha
  0.01 over 3 steps: 9 values of the tables go past 1e-5 of it, all of
  that kind (the rule takes in 2 to 121 values of a table), the worst
  1.03e-4 of it (an ``Embedding`` split by width,
  emb_3 [1059, 1], its JAX gradient 2e-7, 9e-5 of the largest); every
  slab (m, v) within rtol 1e-5, atol 1e-7, and the op-level checks
  below hold the split update itself bitwise;
- each split kind (row blocks, by table, by width) under Adam BITWISE
  the same ranks' run with every op data-parallel, each table whole on
  every rank (losses, weights, slabs, 3 steps): the split moves no bit,
  the data-parallel summation order alone moves a run off JAX's;
- every copy of a piece (the replicated MLPs, a block's copies on the
  other mesh axes) BITWISE equal across ranks, weights and slabs;
- at op level: each split op's update, fed the global batch's ids and a
  seeded cotangent (each rank its rows), BITWISE the world-1 op's update
  of the whole table from the same global ids and cotangent, restricted
  to the rank's piece, weights and slabs, under the default optimizer,
  momentum and Adam; the dense gradient of the piece BITWISE the
  world-1 op's autograd gradient restricted to it. A row's lookups sum
  in lookup order from 0 on both sides, and the row math is the same
  per element;
- the width split under stochastic rounding: its init BITWISE the
  port's own world-1 init from the same seed, and at every step each
  rank's rounded piece BITWISE the world-1 model's rounding of the same
  tables gathered whole at that step (the row's scale the max over the
  ranks' pieces, its draws at the piece's columns); the losses within
  rtol 1e-5 of a world-1 run's (its MLP gradients sum in another order,
  so its trained weights are not bitwise); every row of the gathered
  table its codes times one scale (``test_torch_quant_train.py``'s
  check);
- the fused "dot" within the same tolerances of JAX, and of the port's
  world-1 run from the same weights (there with no value exempted);
- the plain versions of the new kernel entries: the windowed stateful
  update BITWISE the plain update over the masked ids, and the two
  passes of a width piece's rounding BITWISE the whole rows' rounding
  at the piece's columns.
"""

import json
import threading

import numpy as np
import pytest

# The ranks are spawned processes that import this module to find
# _rank_run: the JAX package is imported in the functions that use it.

SIZES = [300, 1024, 77, 4000, 9, 2500]    # 16,384 rows padded
UNIFORM = [512] * 8
D, BS, STEPS = 16, 32, 3
WORLDS = (2, 4)
LR = 0.1
ALPHA = 0.01
# a gradient under this share of its parameter's largest at that step
# cancelled: there Adam's step carries the summation order's ulps
GRAD_FLOOR = 1e-3
OPTS = ("default", "momentum", "adam")
DENSE_OPTS = ("sgd", "adam")
# kind -> (sizes, bag, fuse, strategy source)
KINDS = {
    "concat/bag1": (SIZES, 1, True, "dlrm"),
    "concat/bag2": (SIZES, 2, True, "dlrm"),
    "concat/groups": (SIZES, 1, True, "file"),
    "table": (UNIFORM, 1, True, "dlrm"),
    "width": (SIZES, 1, False, "dlrm"),
}
DENSE_KINDS = ("concat/bag1", "table", "width")
# each split kind under Adam against the same ranks with every op
# data-parallel (the tables whole on each rank)
WITNESS_KINDS = ("concat/bag1", "table", "width")
SPLIT_KIND = {"concat/bag1": "rows", "concat/bag2": "rows",
              "concat/groups": "rows", "table": "table", "width": "width",
              "partial": "table"}


def _arch(sizes, bag=1, dot=False):
    top = (D + len(sizes) * (len(sizes) + 1) // 2 if dot
           else D * (len(sizes) + 1))
    return dict(embedding_size=list(sizes), sparse_feature_size=D,
                embedding_bag_size=bag, mlp_bot=[4, 16, D],
                mlp_top=[top, 16, 1],
                arch_interaction_op="dot" if dot else "cat")


def _opt(name, pkg):
    """The optimizer of a scenario from ``pkg`` (the port's optimizers
    module or the JAX package); None: compile()'s default."""
    if name == "default":
        return None
    if name == "momentum":
        return pkg.SGDOptimizer(lr=LR, momentum=0.9, nesterov=True,
                                weight_decay=1e-4)
    if name == "adam":
        return pkg.AdamOptimizer(alpha=ALPHA)
    return pkg.SGDOptimizer(lr=LR)


def _scenarios(world):
    """key -> spec (without batches, weights or files)."""
    out = {}
    if world == 2:
        for kind, (sizes, bag, fuse, source) in KINDS.items():
            for opt in OPTS:
                out[f"{kind}/{opt}"] = dict(kind=kind, sizes=sizes, bag=bag,
                                            fuse=fuse, source=source,
                                            opt=opt, sparse=True)
        for kind in DENSE_KINDS:
            sizes, bag, fuse, source = KINDS[kind]
            for opt in DENSE_OPTS:
                out[f"dense/{kind}/{opt}"] = dict(
                    kind=kind, sizes=sizes, bag=bag, fuse=fuse,
                    source=source, opt=opt, sparse=False)
        for opt in DENSE_OPTS:
            out[f"dot/{opt}"] = dict(kind="dot", sizes=[512] * 4, bag=1,
                                     fuse=True, source="dlrm", opt=opt,
                                     sparse=True, dot=True)
    else:
        out["partial/adam"] = dict(kind="partial", sizes=UNIFORM, bag=1,
                                   fuse=True, source="file2", opt="adam",
                                   sparse=True)
    return out


def _port_only(world):
    """Scenarios held among the port's own runs: the width split under
    stochastic rounding, the op-level checks of each split kind, and
    each kind under Adam against its all-data-parallel witness."""
    out = {}
    if world == 2:
        sizes, bag, fuse, source = KINDS["width"]
        out["sr/width"] = dict(kind="width", sizes=sizes, bag=bag,
                               fuse=fuse, source=source, opt="default",
                               sparse=True, sr=True)
        for kind in KINDS:
            sizes, bag, fuse, source = KINDS[kind]
            out[f"oplevel/{kind}"] = dict(kind=kind, sizes=sizes, bag=bag,
                                          fuse=fuse, source=source,
                                          opt="sgd", sparse=True,
                                          oplevel=True)
        for kind in WITNESS_KINDS:
            sizes, bag, fuse, source = KINDS[kind]
            out[f"witness/{kind}"] = dict(kind=kind, sizes=sizes, bag=bag,
                                          fuse=fuse, source=source,
                                          opt="adam", sparse=True,
                                          witness=True)
    else:
        out["oplevel/partial"] = dict(kind="partial", sizes=UNIFORM, bag=1,
                                      fuse=True, source="file2", opt="sgd",
                                      sparse=True, oplevel=True)
    return out


def _strategy_file(tmp, world, ntables, ndev):
    """The reference's per-table keys, table i on device i % ndev, every
    other op data-parallel over the world."""
    ops = [{"name": f"embedding{i}", "device_type": "TPU", "dims": [1, 1],
            "device_ids": [i % ndev], "memory_types": []}
           for i in range(ntables)]
    ops += [{"name": k, "device_type": "TPU", "dims": [world, 1],
             "device_ids": list(range(world)), "memory_types": []}
            for k in ("linear", "concat")]
    path = tmp / f"per_table_{world}_{ntables}_{ndev}.json"
    path.write_text(json.dumps({"ops": ops}))
    return str(path)


def _strategies(model, cfg, world, sp, pkg):
    if sp["source"] == "dlrm":
        return pkg["dlrm_strategy"](model, cfg, world)
    return pkg["load_strategies"](sp["path"])


def _port_pkg():
    from dlrm_flexflow_tpu_torch.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu_torch.parallel.strategy_io import load_strategies
    return dict(dlrm_strategy=dlrm_strategy, load_strategies=load_strategies)


def _batches(sp):
    from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig,
                                                     synthetic_batch)
    out = []
    for s in range(STEPS):
        x, y = synthetic_batch(DLRMConfig(**_arch(sp["sizes"], sp["bag"],
                                                  sp.get("dot", False))),
                               BS, seed=70 + s)
        x["label"] = y
        out.append(x)
    return out


# ---- the ranks -----------------------------------------------------------


def _split_of(op):
    split = getattr(op, "_split", None)
    if split is None:
        return None
    return (split.kind, split.block, split.nblocks)


def _tree_np(tree):
    return {k: {p: v.detach().cpu().numpy().copy() for p, v in d.items()}
            for k, d in tree.items()}


def _piece(op, t):
    """This rank's piece of the whole (one card's) tensor ``t`` of the
    split op ``op``, in the port's layout."""
    s = op._split
    if s.kind == "table":
        order = list(op._table_order or range(op.num_tables))
        slots = op.local_slots()
        return t[[order[k] for k in slots]]
    if s.kind == "rows":
        rl = t.shape[0] // s.nblocks
        return t[s.block * rl:(s.block + 1) * rl]
    return t[..., s.columns(t.shape[-1])]


def _op_inputs(model, name, x, sizes):
    """The global batch's ids of op ``name`` and a seeded cotangent of its
    output (numpy), from the batch ``x``."""
    import torch
    op = model.get_layer_by_name(name)
    sparse = np.asarray(x["sparse"])
    if type(op).__name__ == "Embedding":
        ids = sparse[:, int(name.rsplit("_", 1)[1])]   # emb_i
        shape = (BS, D)
    else:
        ids = sparse
        shape = (BS, len(sizes), D)
    rng = np.random.RandomState(11 + len(name))
    ct = rng.randn(*shape).astype(np.float32)
    return torch.as_tensor(ids).long(), torch.from_numpy(ct)


def _op_level(m, m1, rank, world, sp, x):
    """Each split op's updates and dense gradient against the world-1
    op's, restricted to this rank's piece: {op.mode: (weights equal,
    slabs equal, largest difference)}."""
    import torch

    from dlrm_flexflow_tpu_torch.core import optimizers as O
    b = BS // world
    mine = slice(rank * b, (rank + 1) * b)
    opts = {"default": O.SGDOptimizer(lr=LR, weight_decay=1e-4),
            "momentum": _opt("momentum", O), "adam": _opt("adam", O)}
    step = torch.tensor(4, dtype=torch.int32)
    out = {}
    for op in m.ops:
        if _split_of(op) is None or op._split.kind == "replicated":
            continue
        op1 = m1.get_layer_by_name(op.name)
        ids, ct = _op_inputs(m, op.name, x, sp["sizes"])
        whole = m1.params[op.name]["kernel"]
        gen = torch.Generator().manual_seed(5)
        slabs1 = {k: 1e-3 * torch.rand(whole.shape, generator=gen)
                  for k in ("m", "v")}
        for mode, opt in opts.items():
            p = {"kernel": m.params[op.name]["kernel"].clone()}
            p1 = {"kernel": whole.clone()}
            names = opt.sparse_slab_names()
            s1 = {k: slabs1[k].clone() for k in names}
            s = {k: _piece(op, slabs1[k]).clone() for k in names}
            with torch.no_grad():
                _, fwd = op.apply_with_fwd(p, [ids[mine]])
                _, fwd1 = op1.apply_with_fwd(p1, [ids])
            op.sparse_opt_update(p, [ids[mine]], ct[mine], opt, s, step,
                                 fwd=fwd)
            op1.sparse_opt_update(p1, [ids], ct, opt, s1, step, fwd=fwd1)
            want = _piece(op, p1["kernel"])
            out[f"{op.name}.{mode}"] = (
                torch.equal(p["kernel"], want),
                all(torch.equal(s[k], _piece(op, s1[k])) for k in names),
                float((p["kernel"] - want).abs().max()))
        # the piece's dense gradient against the one-card autograd one
        with torch.no_grad():
            _, fwd = op.apply_with_fwd(m.params[op.name], [ids[mine]])
        g = op.split_dense_grad(m.params[op.name], [ids[mine]], ct[mine],
                                fwd=fwd)["kernel"]
        w1 = whole.detach().clone().requires_grad_()
        (g1,) = torch.autograd.grad(op1.apply({"kernel": w1}, [ids])[0],
                                    [w1], ct)
        want = _piece(op, g1)
        out[f"{op.name}.grad"] = (torch.equal(g, want), True,
                                  float((g - want).abs().max()))
    return out


def _hold_rounding(m, m1, mine_of, out):
    """Wrap the split model's stochastic-rounding hook: at each step the
    tables before it, gathered whole, go into the world-1 model ``m1``,
    which rounds them at the same step; ``out`` gets whether every piece
    the split model rounded is bitwise its part of that."""
    import torch
    split_round = m._requant_sr_params

    def hooked(ok=None):
        names = [n for n, _ in m._sr_quant_ops()]
        with m._as_one_card() as whole:
            pre = {n: whole[n]["kernel"].clone() for n in names}
        split_round(ok)
        for n, v in pre.items():
            m1.params[n]["kernel"].copy_(v)
        m1._step = m._step
        m1._requant_sr_params(ok)
        out.append(all(torch.equal(m.params[n]["kernel"],
                                   mine_of(n, m1.params[n]["kernel"]))
                       for n in names))

    m._requant_sr_params = hooked


def _witness_run(m, dp, batches):
    """The split model ``m`` and ``dp``, the same model with every op
    data-parallel, trained on the same batches from the same seed: their
    splits and losses, and whether each of m's weights and slabs is
    bitwise its piece of dp's, at the start and at the end."""
    import torch
    m.init_layers()
    dp.init_layers()
    ops = {op.name: op for op in m.ops}

    def mine(name, v):
        split = _split_of(ops[name])
        return (v if split is None or split[0] == "replicated"
                else _piece(ops[name], v))

    def equal():
        out = {f"{o}.{p}": torch.equal(v, mine(o, dp.params[o][p]))
               for o, d in m.params.items() for p, v in d.items()}
        for k, tree in (m.opt_state or {}).items():
            if k != "step":
                out.update({f"{k}:{o}.{p}": torch.equal(
                    v, mine(o, dp.opt_state[k][o][p]))
                    for o, d in tree.items() for p, v in d.items()})
        return out

    start = equal()
    res = {"splits": {op.name: _split_of(op) for op in m.ops
                      if _split_of(op) is not None},
           "whole_splits": {op.name: _split_of(op) for op in dp.ops
                            if _split_of(op) is not None},
           "start": start,
           "losses": [float(m.train_batch(x)["loss"]) for x in batches],
           "dp_losses": [float(dp.train_batch(x)["loss"]) for x in batches]}
    res["end"] = equal()
    return res


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
    pkg = _port_pkg()
    out = {}
    for sp in specs:
        cfg = DLRMConfig(**_arch(sp["sizes"], sp["bag"], sp.get("dot",
                                                                False)))
        quant = (dict(emb_dtype="int8", emb_update_rule="stochastic_rounding")
                 if sp.get("sr") else {})

        def model(mesh, whole=False):
            m = pt.FFModel(pt.FFConfig(
                batch_size=BS, device="cpu", seed=3, learning_rate=LR,
                sparse_embedding_update=sp["sparse"], **quant))
            build_dlrm(m, cfg, fuse_embeddings=sp["fuse"],
                       fuse_interaction=sp.get("dot", False))
            m.compile(_opt(sp["opt"], optimizers), "mean_squared_error",
                      ["mse"], mesh=mesh,
                      strategies=({} if whole else _strategies(
                          m, cfg, mesh.size, sp, pkg)))
            return m

        if sp.get("witness"):
            out[sp["key"]] = _witness_run(model(make_mesh()),
                                          model(make_mesh(), whole=True),
                                          sp["batches"])
            continue

        m = model(make_mesh())
        m1 = model(make_mesh(devices=[rank]))
        res = {"splits": {op.name: _split_of(op) for op in m.ops
                          if _split_of(op) is not None}}
        ops = {op.name: op for op in m.ops}

        def mine_of(name, v):
            """This rank's piece of the world-1 run's tensor ``v``."""
            split = _split_of(ops[name])
            return (v if split is None or split[0] == "replicated"
                    else _piece(ops[name], v))

        run1 = m1
        if sp.get("sr"):
            # the same seed on both: the width split's init bitwise
            m.init_layers()
            m1.init_layers()
            res["init_equal"] = all(
                torch.equal(v, mine_of(k, m1.params[k][p]))
                for k, d in m.params.items() for p, v in d.items())
            run1 = model(make_mesh(devices=[rank]))
            run1.init_layers()
            res["rounded_equal"] = []
            _hold_rounding(m, m1, mine_of, res["rounded_equal"])
        else:
            m.swap_params(params_from_jax(m, sp["p0"]))
            # the world-1 model holds the same logical weights (the JAX
            # storage order of the mesh's tables is not its own)
            with m._as_one_card() as whole:
                m1.swap_params({k: {p: v.clone() for p, v in d.items()}
                                for k, d in whole.items()})
        if sp.get("oplevel"):
            res["ops"] = _op_level(m, m1, rank, world, sp, sp["batches"][0])
            out[sp["key"]] = res
            continue
        for st in m._collectives.stats.values():     # the steps' alone
            st.update(calls=0, bytes=0, sent=0, seconds=0.0)
        res["losses"] = [float(m.train_batch(x)["loss"])
                         for x in sp["batches"]]
        res["world1_losses"] = [float(run1.train_batch(x)["loss"])
                                for x in sp["batches"]]
        res["params"] = params_to_jax(m, m.params)
        state = {k: v for k, v in m.opt_state.items() if k != "step"}
        res["state"] = opt_state_to_jax(m, state)
        res["raw"] = _tree_np(m.params)
        res["raw_state"] = {k: _tree_np(v) for k, v in state.items()}
        # this rank's piece of the world-1 run's weights
        res["world1"] = {k: {p: mine_of(k, v).detach().numpy().copy()
                             for p, v in d.items()}
                         for k, d in run1.params.items()}
        if sp.get("sr"):
            with m._as_one_card() as whole:
                res["whole"] = {k: d["kernel"].numpy().copy()
                                for k, d in whole.items()
                                if k.startswith("emb_")}
        else:
            back = opt_state_from_jax(m, res["state"])
            res["roundtrip"] = all(torch.equal(back[k][o][p], state[k][o][p])
                                   for k in state for o in state[k]
                                   for p in state[k][o])
        res["stats"] = {k: dict(v) for k, v in m._collectives.stats.items()}
        out[sp["key"]] = res
    return out


# ---- the JAX side ----------------------------------------------------------


def _jax_pkg():
    from dlrm_flexflow_tpu.models.dlrm import dlrm_strategy
    from dlrm_flexflow_tpu.parallel.strategy_io import load_strategies
    return dict(dlrm_strategy=dlrm_strategy, load_strategies=load_strategies)


def _jax_model(world, sp):
    import jax

    import dlrm_flexflow_tpu as ff
    from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                               build_dlrm as jax_build_dlrm)
    from dlrm_flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
    cfg = JaxDLRMConfig(**_arch(sp["sizes"], sp["bag"], sp.get("dot",
                                                                False)))
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=5, learning_rate=LR,
                               sparse_embedding_update=sp["sparse"]))
    jax_build_dlrm(m, cfg, fuse_embeddings=sp["fuse"],
                   fuse_interaction=sp.get("dot", False))
    m.compile(_opt(sp["opt"], ff), "mean_squared_error", ["mse"],
              mesh=jax_make_mesh(devices=jax.devices()[:world]),
              strategies=_strategies(m, cfg, world, sp, _jax_pkg()))
    m.init_layers()
    return m


def _jax_run(m, sp):
    """(the losses, the trained params, the optimizer's slabs, under Adam
    its moments after each step)."""
    import jax
    losses, moments = [], []
    for x in sp["batches"]:
        losses.append(float(m.train_batch(dict(x))["loss"]))
        if sp["opt"] == "adam":
            moments.append({k: jax.tree.map(np.asarray, m.opt_state[k])
                            for k in ("m", "v")})
    state = jax.tree.map(np.asarray, m.opt_state)
    return (losses, jax.tree.map(np.asarray, m.params),
            {k: v for k, v in state.items() if k != "step"}, moments)


def _cancelling(moments, beta1=0.9):
    """{(op, pn): mask} of the values whose JAX gradient at some step
    was not 0 and below GRAD_FLOOR of the largest |gradient| of their
    parameter at that step, recovered from Adam's moments after each
    step: g = (m_t - beta1 m_(t-1)) / (1 - beta1) in fp32 where the
    step moved m or v (a value no lookup named moves under the dense
    update, and its g comes out 0: m_t is fl(beta1 m_(t-1)))."""
    b1, c1 = np.float32(beta1), np.float32(1 - beta1)
    out = {}
    for t, now in enumerate(moments):
        for op, p in now["m"].items():
            for pn, m in p.items():
                v = now["v"][op][pn]
                m0 = moments[t - 1]["m"][op][pn] if t else np.zeros_like(m)
                v0 = moments[t - 1]["v"][op][pn] if t else np.zeros_like(v)
                moved = (m != m0) | (v != v0)
                g = np.abs(np.where(moved, (m - b1 * m0) / c1, 0))
                low = (g > 0) & (g < GRAD_FLOOR * g.max())
                out[(op, pn)] = out.get((op, pn), False) | low
    return out


@pytest.fixture(scope="module", params=WORLDS)
def world_run(request, tmp_path_factory):
    """One spawn of ``world`` ranks for every scenario, and the JAX models
    beside it (their initial weights first: the ranks start from them)."""
    import jax

    from dlrm_flexflow_tpu_torch.utils.testing import spawn_ranks
    world = request.param
    tmp = tmp_path_factory.mktemp(f"splitopt{world}")
    specs = dict(_scenarios(world))
    specs.update(_port_only(world))
    for key, sp in specs.items():
        sp["key"] = key
        sp["path"] = None
        if sp["source"] == "file":
            sp["path"] = _strategy_file(tmp, world, len(sp["sizes"]), world)
        elif sp["source"] == "file2":
            sp["path"] = _strategy_file(tmp, world, len(sp["sizes"]), 2)
        sp["batches"] = _batches(sp)
    jms = {k: _jax_model(world, sp) for k, sp in specs.items()
           if not sp.get("sr") and not sp.get("witness")}
    for k, m in jms.items():
        specs[k]["p0"] = jax.tree.map(np.asarray, m.params)
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
        jax_out = {k: _jax_run(m, specs[k]) for k, m in jms.items()
                   if not specs[k].get("oplevel")}
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return world, specs, box["ranks"], jax_out


def _assembled(ranks, key, field):
    """The JAX-layout tree ``field`` ("params", or a slab's tree of
    "state") of one scenario: each split op's pieces joined in block
    order (a block's first rank's), every other array rank 0's."""
    axis = {"rows": 0, "table": 0, "width": -1}

    def tree(r):
        v = r[key]
        return v["params"] if field == "params" else v["state"][field]

    first = ranks[0][key]
    out = {}
    for op, p in tree(ranks[0]).items():
        split = first["splits"].get(op)
        if split is None or split[0] == "replicated":
            out[op] = p
            continue
        pieces = {}
        for r in ranks:
            pieces.setdefault(r[key]["splits"][op][1], tree(r)[op])
        out[op] = {pn: np.concatenate([pieces[k][pn]
                                       for k in sorted(pieces)],
                                      axis=axis[split[0]])
                   for pn in p}
    return out


def _trained(world):
    return [k for k in _scenarios(world)]


ALL_TRAINED = sorted(set(_trained(2)) | set(_trained(4)))


def _w_atol(key, cancelling=False):
    # under Adam 1e-5 of the distance its steps can move a weight, alpha a
    # step, and 2e-4 of it where the JAX gradient cancelled at some step
    # (see the module's docstring)
    if not key.endswith("adam"):
        return 1e-7
    return (2e-4 if cancelling else 1e-5) * ALPHA * STEPS


@pytest.mark.parametrize("key", ALL_TRAINED)
def test_three_steps_as_the_jax_mesh(world_run, key):
    """The losses, every weight and every slab of the split run against
    the JAX mesh's, within the tolerances of the module's docstring; the
    tables split as the scenario says; the state round-trips bitwise."""
    world, specs, ranks, jax_out = world_run
    if key not in specs:
        pytest.skip(f"{key} runs at the other world")
    sp = specs[key]
    lj, pj, sj, moments = jax_out[key]
    near0 = _cancelling(moments)
    kind = SPLIT_KIND.get(sp["kind"])
    for r in ranks:
        tables = [s for n, s in r[key]["splits"].items()
                  if n.startswith("emb")]
        if kind is not None:
            assert tables and all(s[0] == kind for s in tables), tables
        assert r[key]["roundtrip"], key
        assert r[key]["losses"] == ranks[0][key]["losses"]
    np.testing.assert_allclose(ranks[0][key]["losses"], lj, rtol=1e-5)
    got = _assembled(ranks, key, "params")
    init = sp["p0"]
    for op, p in pj.items():
        for pn, want in p.items():
            have = got[op][pn]
            assert have.shape == want.shape, (op, pn, have.shape)
            low = np.broadcast_to(near0.get((op, pn), False), want.shape)
            for exempt in (False, True):
                sel = low == exempt
                np.testing.assert_allclose(
                    have[sel], want[sel], rtol=1e-5,
                    atol=_w_atol(key, exempt),
                    err_msg=f"{key}: {op}.{pn} (cancelling {exempt})")
            assert np.abs(want - init[op][pn]).max() > 0, (op, pn)
    assert set(sj) == set(ranks[0][key]["state"])
    for slab, tree in sj.items():
        have = _assembled(ranks, key, slab)
        for op, p in tree.items():
            for pn, want in p.items():
                np.testing.assert_allclose(
                    have[op][pn], want, rtol=1e-5, atol=1e-7,
                    err_msg=f"{key}: {slab} of {op}.{pn}")


@pytest.mark.parametrize("key", ALL_TRAINED + ["sr/width"])
def test_copies_bitwise_equal_across_ranks(world_run, key):
    """Every copy of a piece bitwise the first, weights and slabs: a
    replicated op's arrays on every rank, a split op's block on every
    rank holding it."""
    world, specs, ranks, _ = world_run
    if key not in specs:
        pytest.skip(f"{key} runs at the other world")
    first = ranks[0][key]
    copies = 0
    trees = [("raw", first["raw"])] + [
        (k, v) for k, v in first["raw_state"].items()]
    for name, tree in trees:
        for op, p in tree.items():
            split = first["splits"].get(op)
            for r in ranks[1:]:
                rs = r[key]["splits"].get(op)
                if split is not None and split[0] != "replicated" \
                        and rs[1] != split[1]:
                    continue           # another block
                copies += 1
                other = (r[key]["raw"] if name == "raw"
                         else r[key]["raw_state"][name])
                for pn, v in p.items():
                    np.testing.assert_array_equal(
                        other[op][pn], v, err_msg=f"{name} {op}.{pn}")
    if key == "partial/adam":
        blocks = [r[key]["splits"]["emb_stack"][1] for r in ranks]
        assert blocks.count(blocks[0]) == world // 2
        assert all(r[key]["splits"]["emb_stack"][2] == 2 for r in ranks)
    assert copies


@pytest.mark.parametrize("opt", DENSE_OPTS)
def test_fused_dot_as_world_one(world_run, opt):
    """The fused "dot" across ranks (its table replicated, its gradient
    in the data-parallel all-reduce) against the port's world-1 run from
    the same weights: the losses within rtol 1e-5, every weight within
    the tolerances against JAX."""
    world, specs, ranks, _ = world_run
    key = f"dot/{opt}"
    if key not in specs:
        pytest.skip(f"{key} runs at world 2")
    for r in ranks:
        res = r[key]
        np.testing.assert_allclose(res["losses"], res["world1_losses"],
                                   rtol=1e-5)
        for op, p in res["raw"].items():
            for pn, v in p.items():
                np.testing.assert_allclose(
                    v, res["world1"][op][pn], rtol=1e-5,
                    atol=_w_atol(key), err_msg=f"{op}.{pn}")


def _assert_codes(v):
    """Every row of ``v`` is its int8 codes times one scale: x / s an
    integer (to 1e-3 of a code) under s = amax / 127 or amax / 126 (a
    stochastic-rounding row's largest code is 127 or, rarely, 126), as
    ``test_torch_quant_train.py`` holds them."""
    v = np.asarray(v, np.float32)
    amax = np.abs(v).max(axis=1)
    errs = []
    for n in (127, 126):
        s = (amax / np.float32(n)).astype(np.float32)
        y = v / np.where(s > 0, s, 1)[:, None]
        errs.append(np.abs(y - np.rint(y)).max(axis=1))
    assert np.minimum(*errs).max() < 1e-3


def test_width_split_stochastic_rounding_is_world_one(world_run):
    """int8 stochastic rounding of Embeddings split by width: the init
    (nearest) BITWISE the port's world-1 init from the same seed, and at
    every step each rank's rounded piece BITWISE the world-1 model's
    rounding of the same tables gathered whole, at the same step (the
    pieces' row maxima all-reduced, the draws at the piece's columns);
    the run's losses within rtol 1e-5 of a world-1 run's from the same
    seed (the MLPs' gradients sum in another order across ranks, so the
    trained weights are not bitwise); the gathered tables' rows are
    codes times one scale; the max all-reduce once a table a step."""
    world, specs, ranks, _ = world_run
    if "sr/width" not in specs:
        pytest.skip("runs at world 2")
    for r in ranks:
        res = r["sr/width"]
        assert all(s[0] == "width" for n, s in res["splits"].items()
                   if n.startswith("emb"))
        assert res["init_equal"]
        assert res["rounded_equal"] == [True] * STEPS
        np.testing.assert_allclose(res["losses"], res["world1_losses"],
                                   rtol=1e-5)
        for name, table in res["whole"].items():
            _assert_codes(table)
        # each step: the dense gradients and the metrics, and one max a
        # table of the width split
        ntables = len(specs["sr/width"]["sizes"])
        assert res["stats"]["all_reduce"]["calls"] == \
            (2 + ntables) * STEPS


@pytest.mark.parametrize("kind", WITNESS_KINDS)
def test_adam_split_bitwise_the_data_parallel_run(world_run, kind):
    """Each split kind under Adam BITWISE the same ranks' run with every
    op data-parallel (each table whole on every rank, updated from the
    global batch): the losses, and every weight and slab its piece of
    that run's, after 3 steps. The split changes no bit; what moves a
    run away from world 1 or JAX is the data-parallel summation order
    alone (see the module's docstring)."""
    world, specs, ranks, _ = world_run
    key = f"witness/{kind}"
    if key not in specs:
        pytest.skip("runs at world 2")
    for r in ranks:
        res = r[key]
        assert any(s[0] == SPLIT_KIND[kind] for s in res["splits"].values())
        assert all(s[0] == "replicated"
                   for n, s in res["whole_splits"].items()
                   if n.startswith("emb"))
        assert res["losses"] == res["dp_losses"]
        assert res["start"] and all(res["start"].values())
        assert any(k.startswith("m:") for k in res["end"])
        assert all(res["end"].values()), [k for k, v in res["end"].items()
                                          if not v]


def _oplevel_keys(world):
    return [k for k in _port_only(world) if k.startswith("oplevel/")]


@pytest.mark.parametrize("key", sorted(set(_oplevel_keys(2))
                                       | set(_oplevel_keys(4))))
def test_op_updates_bitwise_the_world_one_op(world_run, key):
    """Each split op's stateful updates (the default optimizer, momentum,
    Adam) and its piece's dense gradient, fed the global batch's ids and
    one seeded cotangent, BITWISE the world-1 op's restricted to the
    rank's piece, weights and slabs."""
    world, specs, ranks, _ = world_run
    if key not in specs:
        pytest.skip(f"{key} runs at the other world")
    kind = SPLIT_KIND[specs[key]["kind"]]
    for r in ranks:
        res = r[key]
        assert any(s[0] == kind for s in res["splits"].values())
        assert res["ops"]
        modes = {name.rsplit(".", 1)[1] for name in res["ops"]}
        assert modes == {"default", "momentum", "adam", "grad"}
        for name, (w_eq, s_eq, err) in res["ops"].items():
            assert w_eq and s_eq, (key, name, err)


# ---- the plain versions of the new kernel entries -------------------------


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("lo", [0, 300, 1000])
def test_windowed_stateful_plain_version(opt, lo):
    """``stateful_update_rows(lo=)`` on the CPU (its plain version): the
    block [lo, lo + rows) of a table updated as the whole table's update
    restricted to the block, bitwise, weights and slabs; a pad and an id
    outside the window change nothing; ``window_ids`` is the mask the
    plain version takes."""
    import torch

    from dlrm_flexflow_tpu_torch.core import optimizers as O
    from dlrm_flexflow_tpu_torch.ops.kernels import scatter_rows as sr
    o = _opt(opt, O) or O.SGDOptimizer(lr=LR, weight_decay=1e-4)
    gen = torch.Generator().manual_seed(lo + 1)
    whole = torch.randn(1400, D, generator=gen)
    slabs = {k: 1e-3 * torch.rand(1400, D, generator=gen)
             for k in o.sparse_slab_names()}
    ids = torch.randint(0, 1400, (512,), generator=gen)
    ids[::37] = ids[5]                     # duplicates
    ids[7] = -1                            # a pad
    upd = torch.randn(256, D, generator=gen)
    step = torch.tensor(3, dtype=torch.int32)
    rows = 400
    block = whole[lo:lo + rows].clone()
    bslabs = {k: v[lo:lo + rows].clone() for k, v in slabs.items()}
    sr.stateful_update_rows(block, ids, upd, None, bslabs, o.row_params(),
                            o.alpha_t(step), div=2, lo=lo)
    w1, s1 = whole.clone(), {k: v.clone() for k, v in slabs.items()}
    sr.stateful_update_rows_reference(w1, ids, upd, None, s1,
                                      o.row_params(), o.alpha_t(step), 2)
    assert torch.equal(block, w1[lo:lo + rows])
    for k in slabs:
        assert torch.equal(bslabs[k], s1[k][lo:lo + rows])
    # only the window's rows changed, and rows no lookup names kept
    named = torch.unique(ids[(ids >= lo) & (ids < lo + rows)]) - lo
    kept = torch.ones(rows, dtype=torch.bool)
    kept[named] = False
    assert torch.equal(block[kept], whole[lo:lo + rows][kept])
    assert not torch.equal(block, whole[lo:lo + rows])
    w2 = whole[lo:lo + rows].clone()
    s2 = {k: v[lo:lo + rows].clone() for k, v in slabs.items()}
    sr.stateful_update_rows_reference(w2, sr.window_ids(ids, lo, rows), upd,
                                      None, s2, o.row_params(),
                                      o.alpha_t(step), 2)
    assert torch.equal(block, w2)


@pytest.mark.parametrize("dtype,mode", [("int8", "stochastic"),
                                        ("int8", "nearest"),
                                        ("fp8", "nearest"),
                                        ("bf16", "nearest")])
@pytest.mark.parametrize("pieces", [2, 4])
def test_two_pass_rounding_of_width_pieces(dtype, mode, pieces):
    """The plain versions of the two passes of a width piece's rounding:
    ``row_amax`` of each piece, their max, then ``fake_quant_rows_amax``
    at the piece's columns, BITWISE the whole rows' ``fake_quant_rows``
    at those columns (the draws keyed by the row's column); a NaN in a
    row's piece reaches every piece of that row through the max of the
    fp32 bits as int32. bf16 has no row scale: the second pass refuses
    it, and ``fake_quant_rows`` of each piece (the model's route for a
    bf16 piece) is BITWISE the whole rows' at its columns."""
    import torch

    from dlrm_flexflow_tpu_torch.ops.kernels import quant_rows as qr
    gen = torch.Generator().manual_seed(pieces)
    whole = torch.randn(300, 64, generator=gen) * torch.rand(
        300, 1, generator=gen)
    whole[4] = 0.0                          # an all-zero row
    whole[9, 3] = float("nan")
    draws = dict(seed=3, step=2, salt=0x51) if mode == "stochastic" else {}
    want = qr.fake_quant_rows(whole.clone(), dtype, mode, row0=7, **draws)
    dc = 64 // pieces
    parts = [whole[:, k * dc:(k + 1) * dc].clone() for k in range(pieces)]
    if dtype == "bf16":
        with pytest.raises(ValueError, match="bf16"):
            qr.fake_quant_rows_amax(parts[0], qr.row_amax(parts[0]), dtype,
                                    mode)
        got = torch.cat([qr.fake_quant_rows(p, dtype, mode, row0=7)
                         for p in parts], dim=1)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        return
    amax = torch.stack([qr.row_amax(p) for p in parts])
    bits = amax.view(torch.int32).amax(dim=0).view(torch.float32)
    assert torch.isnan(bits[9]) and bits[4] == 0
    for k, p in enumerate(parts):
        qr.fake_quant_rows_amax(p, bits.clone(), dtype, mode, row0=7,
                                col0=k * dc, **draws)
    got = torch.cat(parts, dim=1)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    np.testing.assert_array_equal(
        qr.row_amax_reference(whole).numpy(), whole.abs().amax(1).numpy())


def test_width_piece_rounding_refuses_a_column_off_the_chunks():
    """A piece must start at a multiple of 4 columns (the Philox
    counter's 4-value chunks)."""
    import torch

    from dlrm_flexflow_tpu_torch.ops.kernels import quant_rows as qr
    x = torch.randn(4, 6)
    with pytest.raises(ValueError, match="multiple of 4"):
        qr.fake_quant_rows_amax(x, qr.row_amax(x), "int8", "stochastic",
                                col0=6)
