"""The port's dense optimizer update (``ops/kernels/dense_update.py``)
against the JAX package, its host-side launch plan, and its raises.

``dense_update`` runs its plain version on CPU tensors (the CUDA kernel
runs only on the card: tests/test_torch_cuda.py holds it to this plain
version there). Inputs are made with numpy from a seed and handed to
both packages.

Tolerances, and why:

- Three steps of ``Optimizer.update`` (one ``dense_update`` over every
  tensor) against the JAX optimizers' ``update`` run op by op, as the
  JAX package calls it outside a jit: BITWISE, weights, every slab and
  the int32 step, for SGD, momentum, nesterov with weight decay, weight
  decay alone, Adam and Adam with weight decay, on tensors of 0, 1, 7,
  5 x 7 and 1,027 elements. Both round each operation once in the same
  order with the constants rounded to fp32 alike, and take Adam's
  alpha_t through the same fp32 power and a correctly rounded square
  root.
- The launch plan is integer arithmetic: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ff

from dlrm_flexflow_tpu_torch.core.optimizers import (AdamOptimizer,
                                                     SGDOptimizer)
from dlrm_flexflow_tpu_torch.ops.kernels import dense_update as dm
from dlrm_flexflow_tpu_torch.ops.kernels.scatter_rows import (
    BLOCK_SORT_MAX, FUSED_MAX, MAX_ROWS, stateful_route)

# (JAX optimizer, port optimizer)
OPTIMIZERS = {
    "sgd": (lambda: ff.SGDOptimizer(lr=0.1),
            lambda: SGDOptimizer(lr=0.1)),
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
# tensors of 0, 1, 7, 5 x 7 and 1,027 elements
SHAPES = {"a": {"kernel": (5, 7), "bias": (7,)},
          "b": {"kernel": (1027,), "bias": (1,)},
          "c": {"empty": (0, 3)}}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_dense_update_matches_jax(name):
    """Three steps from NON-zero state (after a first step), in place in
    the port, functional in JAX: weights, every slab and the step."""
    rng = np.random.RandomState(13)
    init = {op: {pn: rng.randn(*s).astype(np.float32)
                 for pn, s in p.items()} for op, p in SHAPES.items()}
    grads = [{op: {pn: rng.randn(*s).astype(np.float32)
                   for pn, s in p.items()} for op, p in SHAPES.items()}
             for _ in range(3)]
    jopt, popt = OPTIMIZERS[name][0](), OPTIMIZERS[name][1]()
    jp = jax.tree.map(jnp.asarray, init)
    js = jopt.init_state(jp)
    pp = {op: {pn: torch.from_numpy(v.copy()) for pn, v in p.items()}
          for op, p in init.items()}
    ps = popt.init_state(pp)
    before = dm.dense_update.launches
    for g in grads:
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js)
        popt.update(pp, {op: {pn: torch.from_numpy(v) for pn, v in p.items()}
                         for op, p in g.items()}, ps)
    assert dm.dense_update.launches == before     # the CPU runs no kernel
    assert set(ps) == set(js)
    if "step" in js:
        assert ps["step"].dtype == torch.int32
        assert int(ps["step"]) == int(js["step"]) == 3
    for op, p in init.items():
        for pn in p:
            np.testing.assert_array_equal(pp[op][pn].numpy(),
                                          np.asarray(jp[op][pn]))
            for k in popt.sparse_slab_names():
                np.testing.assert_array_equal(ps[k][op][pn].numpy(),
                                              np.asarray(js[k][op][pn]))


def _kernel_elements(entries, tiles):
    """{index: (element -> times covered, float4 starts)}: the elements
    each tile of one launch covers, by csrc/dense_update.cu's index math
    (a block's forward walk to its tile's tensor, its vector or scalar
    tile)."""
    unroll = dm.TILE_VECS // dm.THREADS
    seen = {e.index: (np.zeros(e.n, np.int64), []) for e in entries}
    i = 0
    for t in range(tiles):
        while i + 1 < len(entries) and t >= entries[i + 1].tile0:
            i += 1
        e = entries[i]
        count, vec_starts = seen[e.index]
        k = t - e.tile0
        vtiles = -(-e.nvec // dm.TILE_VECS)
        if k < vtiles:
            j = (k * dm.TILE_VECS + np.arange(unroll)[:, None] * dm.THREADS
                 + np.arange(dm.THREADS)[None, :]).reshape(-1)
            j = j[j < e.nvec]
            for lane in range(4):
                np.add.at(count, e.head + 4 * j + lane, 1)
            vec_starts.extend((e.head + 4 * j).tolist())
        else:
            s = (k - vtiles) * dm.THREADS + np.arange(dm.THREADS)
            s = s[s < e.n - 4 * e.nvec]
            np.add.at(count, np.where(s < e.head, s, s + 4 * e.nvec), 1)
    return seen


@pytest.mark.parametrize("offsets", [(0, 0), (4, 4), (8, 8, 8, 8),
                                     (12, 12, 12), (0, 4), (4, 8, 12, 0)])
def test_launch_plan_covers_every_element_once(offsets):
    """Tensors of 1 to 9,000 elements at byte offsets (w, g, slabs...)
    that agree (float4 spans between scalar heads and tails) or differ
    (scalar throughout): the kernel's tiles cover every element exactly
    once, and a float4 starts only where every address is 16-byte
    aligned."""
    sizes = [1, 2, 3, 4, 5, 7, 35, 1027, 4096, 4099, 9000]
    base = 1 << 20
    addrs = [tuple(base * (i + 1) * 8 + o for o in offsets)
             for i in range(len(sizes))]
    plan = dm.launch_plan(sizes, addrs)
    assert len(plan) == 1
    entries, tiles = plan[0]
    assert [e.index for e in entries] == list(range(len(sizes)))
    assert tiles == sum(dm.tensor_tiles(e.n, e.nvec) for e in entries)
    for e, (count, vec_starts) in zip(
            entries, _kernel_elements(entries, tiles).values()):
        assert (count == 1).all(), e
        for a in addrs[e.index]:
            assert all((a + 4 * x) % 16 == 0 for x in vec_starts)
        if len(set(offsets)) > 1:
            assert e.nvec == 0
        else:
            assert e.head <= 3 and e.n - e.head - 4 * e.nvec <= 3


@pytest.mark.parametrize("n", [2 ** 29 - 1, 2 ** 29, 2 ** 29 + 3,
                               2 ** 31 // 4 + 5, 3 * 2 ** 29 + 1])
@pytest.mark.parametrize("offset", [0, 4, 12])
def test_launch_plan_past_2_31_bytes(n, offset):
    """Sizes around 2^31 bytes (integers only, nothing allocated): the
    float4 span, the head and the tail partition [0, n), the span starts
    16-byte aligned, the tile count fits the span and the scalars, and
    nothing is cut at 32 bits."""
    addr = 0x7F00_0000_0000 + offset
    (entries, tiles), = dm.launch_plan([n, 7], [(addr, addr + 2 ** 34)] * 2)
    e = entries[0]
    tail = e.n - e.head - 4 * e.nvec
    assert e.n == n and 0 <= e.head <= 3 and 0 <= tail <= 3
    assert (addr + 4 * e.head) % 16 == 0
    assert e.head == ((16 - offset) % 16) // 4
    vtiles = -(-e.nvec // dm.TILE_VECS)
    assert (vtiles - 1) * dm.TILE_VECS < e.nvec <= vtiles * dm.TILE_VECS
    assert dm.tensor_tiles(n, e.nvec) == vtiles + (1 if e.head + tail
                                                   else 0)
    assert entries[1].tile0 == dm.tensor_tiles(n, e.nvec)
    assert tiles == entries[1].tile0 + dm.tensor_tiles(7, entries[1].nvec)


def test_launch_plan_splits_long_lists():
    """More tensors than one launch's descriptors: launches of
    MAX_TENSORS in the given order, each with its own tiles from 0;
    empty tensors take no descriptor."""
    sizes = [5 + i for i in range(2 * dm.MAX_TENSORS + 4)] + [0]
    addrs = [(64 * i, 64 * i + 16) for i in range(len(sizes))]
    plan = dm.launch_plan(sizes, addrs)
    assert [len(es) for es, _ in plan] == [dm.MAX_TENSORS, dm.MAX_TENSORS, 4]
    assert [e.index for es, _ in plan for e in es] == list(range(len(sizes)
                                                                 - 1))
    for es, tiles in plan:
        assert es[0].tile0 == 0
        assert tiles == sum(dm.tensor_tiles(e.n, e.nvec) for e in es)
    assert dm.launch_plan([0, 0], [(0, 0), (16, 16)]) == []
    with pytest.raises(ValueError, match="4-byte"):
        dm.launch_plan([3], [(2, 16)])


def _adam_case():
    adam = AdamOptimizer()
    w = torch.zeros(4, 3)
    return (adam, [w], [torch.ones_like(w)],
            [{k: torch.zeros_like(w) for k in ("m", "v")}],
            adam.alpha_t(torch.zeros((), dtype=torch.int32)))


@pytest.mark.parametrize("case", ["lengths", "dtype", "grad_shape",
                                  "missing_slab", "slab_shape", "devices",
                                  "alpha_t", "device_type"])
def test_dense_update_raises(case):
    """What the update does not take raises ValueError, on the CPU as on
    the card, before any work."""
    adam, ws, gs, slabs, at = _adam_case()
    match = {"lengths": "weights", "dtype": "float32",
             "grad_shape": "shaped", "missing_slab": "lack",
             "slab_shape": "shaped", "devices": "devices",
             "alpha_t": "alpha_t", "device_type": "cpu or cuda"}[case]
    if case == "lengths":
        gs = gs * 2
    elif case == "dtype":
        gs = [gs[0].double()]
    elif case == "grad_shape":
        gs = [gs[0][:2]]
    elif case == "missing_slab":
        del slabs[0]["v"]
    elif case == "slab_shape":
        slabs[0]["m"] = slabs[0]["m"].t()
    elif case == "devices":
        gs = [gs[0].to("meta")]
    elif case == "alpha_t":
        at = at.double()
    else:
        ws = [ws[0].to("meta")]
        gs = [gs[0].to("meta")]
        slabs = [{k: v.to("meta") for k, v in slabs[0].items()}]
        at = at.to("meta")
    before = ws[0].clone() if ws[0].device.type == "cpu" else None
    with pytest.raises(ValueError, match=match):
        dm.dense_update(ws, gs, slabs, adam.row_params(), at)
    if before is not None:
        assert torch.equal(ws[0], before)


@pytest.mark.parametrize("n,want", [(1, "fused"), (2048, "fused"),
                                    (FUSED_MAX, "fused"),
                                    (FUSED_MAX + 1, "sort"),
                                    (10 ** 6, "sort")])
def test_stateful_route(n, want):
    """The stateful touched-rows update's route: one launch up to
    FUSED_MAX lookups (the pre-pass kernel's limit: above it the
    torch.sort pre-pass); tables past 31-bit row ids raise."""
    assert FUSED_MAX <= BLOCK_SORT_MAX
    assert stateful_route(n, 8_000_000) == want
    with pytest.raises(ValueError, match="2\\^31"):
        stateful_route(n, MAX_ROWS)
