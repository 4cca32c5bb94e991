"""The port's LSTM scan and LSTM ops against the JAX package, on the CPU.

The plain versions of the two scan kernels (``lstm_fwd_reference``,
``lstm_bwd_reference``) through ``lstm_scan_reference`` are held to the
JAX ``lstm_scan`` run in Pallas interpret mode, forward and VJP
(``jax.vjp`` for dxproj and dwh), at (b, T, h) = (8, 5, 128) and at the
non-aligned (6, 4, 40), with fp32 and with bf16 wh. The ``LSTM`` and
``LSTMStack`` ops are held to the JAX ops over a forward and two SGD
steps, the JAX ops run through their ``lax.scan`` path and through the
resident route, forced here as tests/test_lstm_resident_routing.py
forces it (monkeypatched; nothing of the JAX package is edited).

Tolerances, and why:

- ys, cs, dzs and dxproj: atol 1e-5 with fp32 wh. The same fp32
  arithmetic; the recurrent products sum in another order in XLA and in
  PyTorch (measured at most 6e-7). With bf16 wh, atol 4e-3: the carried
  h (or dz) is rounded to bf16 before each product, and a sum that lands
  near the midpoint of two bf16 values can round to the other one in
  one package, moving that operand by one bf16 step (at most 2^-8 of
  it) and a gate by up to 2^-8 · |wh| (|wh| < 0.5 here); measured
  3.5e-5.
- the backward's two phases (``lstm_gates_reference`` then
  ``lstm_carry_reference``), composed: against ``_run_bwd`` at the
  tolerances above, and against ``lstm_bwd_reference`` at atol 1e-6 in
  fp32 (one batched product over the T·b rows against T per-step
  products, which may sum in another order on the CPU; measured 0) and
  4e-3 in bf16 (such an order change can round a carried dz to the other
  bf16 neighbour).
- dwh: within 1e-5 of its largest entry in fp32; in bf16 within 2^-7 of
  it, one bf16 step of the largest entry, since dwh is rounded to bf16
  after an fp32 product summed in another order (measured 7e-4).
- the ops: outputs atol 1e-6 and losses rtol 1e-6 (measured 9e-8 and
  6.4e-8); every updated parameter within 2e-4 of its largest update
  (summation order through two steps; measured at most 3.5e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.ops.pallas import lstm_kernel as lk
from dlrm_flexflow_tpu.parallel.mesh import make_mesh

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.ops.kernels import lstm as plstm
from dlrm_flexflow_tpu_torch.utils.weights import (params_from_jax,
                                                   params_to_jax)


def _inputs(b, T, h, bf16, seed=0):
    rng = np.random.RandomState(seed)
    xp = rng.randn(T, b, 4 * h).astype(np.float32)
    wh = (rng.randn(h, 4 * h) * 0.1).astype(np.float32)
    dys = rng.randn(T, b, h).astype(np.float32)
    jw = jnp.asarray(wh)
    tw = torch.from_numpy(wh)
    if bf16:
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    return xp, jw, tw, dys


SHAPES = [(8, 5, 128), (6, 4, 40)]


def _tol(bf16):
    return 4e-3 if bf16 else 1e-5


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,T,h", SHAPES)
def test_scan_reference_matches_jax_kernel(b, T, h, bf16):
    xp, jw, tw, dys = _inputs(b, T, h, bf16)
    ys_j, vjp = jax.vjp(lambda x, w: lk.lstm_scan(x, w, True),
                        jnp.asarray(xp), jw)
    dx_j, dw_j = vjp(jnp.asarray(dys))
    x = torch.from_numpy(xp).requires_grad_()
    w = tw.clone().requires_grad_()
    ys = plstm.lstm_scan_reference(x, w)
    ys.backward(torch.from_numpy(dys))
    assert ys.dtype == torch.float32 and w.grad.dtype == tw.dtype
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j),
                               rtol=0, atol=_tol(bf16))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dx_j), rtol=0,
                               atol=_tol(bf16))
    want = np.asarray(dw_j.astype(jnp.float32))
    frac = 2 ** -7 if bf16 else 1e-5
    np.testing.assert_allclose(w.grad.float().numpy(), want, rtol=0,
                               atol=frac * np.abs(want).max())


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,T,h", SHAPES)
def test_fwd_and_bwd_match_jax_kernels(b, T, h, bf16):
    """The two plain kernels on their own against ``_run_fwd`` and
    ``_run_bwd`` in interpret mode; the CPU wrappers route to them."""
    xp, jw, tw, dys = _inputs(b, T, h, bf16, seed=1)
    ys_j, cs_j = lk._run_fwd(jnp.asarray(xp), jw, True)
    x = torch.from_numpy(xp)
    ys, cs = plstm.lstm_fwd(x, tw)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=0,
                               atol=_tol(bf16))
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), rtol=0,
                               atol=_tol(bf16))
    ys_only, none = plstm.lstm_fwd(x, tw, with_residuals=False)
    assert none is None and torch.equal(ys_only, ys)
    zeros = jnp.zeros_like(ys_j[:1])
    dzs_j = lk._run_bwd(jnp.asarray(xp), jw,
                        jnp.concatenate([zeros, ys_j[:-1]]),
                        jnp.concatenate([zeros, cs_j[:-1]]), cs_j,
                        jnp.asarray(dys), True)
    dzs = plstm.lstm_bwd(x, tw, ys, cs, torch.from_numpy(dys))
    assert dzs.shape == (T, b, 4 * h)
    np.testing.assert_allclose(dzs.numpy(), np.asarray(dzs_j), rtol=0,
                               atol=_tol(bf16))
    assert torch.equal(dzs, plstm.lstm_bwd_reference(
        x, tw, ys, cs, torch.from_numpy(dys)))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,T,h", SHAPES + [(5, 1, 24)])
def test_split_backward_matches_jax_and_reference(b, T, h, bf16):
    """The resident route's split: the gate pre-activations of every step
    at once, then the carry scan given them, against ``_run_bwd`` in
    interpret mode and against the unsplit plain backward."""
    xp, jw, tw, dys = _inputs(b, T, h, bf16, seed=4)
    x = torch.from_numpy(xp)
    ys, cs = plstm.lstm_fwd_reference(x, tw)
    gates = plstm.lstm_gates_reference(x, tw, ys)
    assert gates.shape == (T, b, 4 * h) and gates.dtype == torch.float32
    assert torch.equal(gates[0], x[0])      # h_{-1} = 0
    dzs = plstm.lstm_carry_reference(gates, tw, cs, torch.from_numpy(dys))
    jys, jcs = jnp.asarray(ys.numpy()), jnp.asarray(cs.numpy())
    zeros = jnp.zeros_like(jys[:1])
    dzs_j = lk._run_bwd(jnp.asarray(xp), jw,
                        jnp.concatenate([zeros, jys[:-1]]),
                        jnp.concatenate([zeros, jcs[:-1]]), jcs,
                        jnp.asarray(dys), True)
    np.testing.assert_allclose(dzs.numpy(), np.asarray(dzs_j), rtol=0,
                               atol=_tol(bf16))
    want = plstm.lstm_bwd_reference(x, tw, ys, cs, torch.from_numpy(dys))
    np.testing.assert_allclose(dzs.numpy(), want.numpy(), rtol=0,
                               atol=4e-3 if bf16 else 1e-6)


def test_gate_phase_on_cpu_is_the_plain_version_and_counts_nothing():
    xp, _, tw, _ = _inputs(3, 4, 16, True, seed=5)
    x = torch.from_numpy(xp)
    ys, _ = plstm.lstm_fwd_reference(x, tw)
    before = (plstm.lstm_gates.launches, dict(plstm.lstm_gates.routes))
    assert torch.equal(plstm.lstm_gates(x, tw, ys),
                       plstm.lstm_gates_reference(x, tw, ys))
    assert torch.equal(plstm.lstm_gates(x, tw, ys, route="mma"),
                       plstm.lstm_gates_reference(x, tw, ys))
    assert (plstm.lstm_gates.launches, plstm.lstm_gates.routes) == before
    with pytest.raises(ValueError, match="route"):
        plstm.lstm_gates(x, tw, ys, route="cuda")
    with pytest.raises(ValueError, match="ys"):
        plstm.lstm_gates(x, tw, ys[:, :2])


@pytest.mark.parametrize("h,route", [
    (1024, "wgmma"),    # the NMT layer
    (136, "wgmma"),     # K not a multiple of the k depth
    (8, "wgmma"),
    (138, "mma"),       # ys rows 552 bytes apart: no tensor map
    (5, "mma"),
])
def test_gate_route_by_shape(h, route):
    assert plstm.gates_route(h) == route


@pytest.mark.parametrize("b,h,dtype,blocks,route", [
    (64, 1024, torch.bfloat16, 132, "resident"),    # the NMT layer
    (64, 1024, torch.float32, 132, "streaming"),    # fp32 wh: scalar FMAs
    (128, 64, torch.bfloat16, 132, "resident"),     # 4 rows a thread
    (129, 64, torch.bfloat16, 132, "streaming"),    # a fifth row
    (1, 8, torch.bfloat16, 1, "resident"),
    (64, 1056, torch.bfloat16, 132, "resident"),    # 132 groups, 132 blocks
    (64, 1064, torch.bfloat16, 132, "streaming"),   # 133 groups
    (64, 1064, torch.bfloat16, 264, "resident"),    # two blocks an SM
    (64, 8000, torch.bfloat16, 10_000, "streaming"),  # slice past 227 KB
])
def test_backward_route_by_shape(b, h, dtype, blocks, route):
    assert plstm.bwd_route(b, h, dtype, blocks) == route


def test_resident_shared_memory():
    # 8 rows of 4h bf16 padded by 4 words, and 8 tiles of 16 x 8 fp32
    assert plstm.resident_smem(1024) == 8 * (2048 + 4) * 4 + 4096 == 69_760
    assert plstm.resident_smem(5) == 8 * (16 + 4) * 4 + 4096
    assert plstm.resident_smem(3500) <= plstm.SMEM_LIMIT \
        < plstm.resident_smem(3600)


@pytest.mark.parametrize("b,h,dtype,blocks,route", [
    (64, 1024, torch.bfloat16, 132, "resident"),    # the NMT layer
    (64, 1024, torch.float32, 132, "streaming"),    # fp32 wh: scalar FMAs
    (24, 136, torch.bfloat16, 132, "resident"),     # ragged
    (128, 64, torch.bfloat16, 132, "resident"),     # 4 rows a thread
    (129, 64, torch.bfloat16, 132, "streaming"),    # a fifth row
    (1, 8, torch.bfloat16, 1, "resident"),
    (64, 1064, torch.bfloat16, 132, "streaming"),   # 133 groups
    (64, 1064, torch.bfloat16, 264, "resident"),    # two blocks an SM
    (64, 3296, torch.bfloat16, 10_000, "resident"),   # slice at 227 KB
    (64, 3312, torch.bfloat16, 10_000, "streaming"),  # slice past it
])
def test_forward_route_by_shape(b, h, dtype, blocks, route):
    assert plstm.fwd_route(b, h, dtype, blocks) == route


def test_forward_resident_shared_memory():
    # 32 columns of h bf16 padded by 4 words, and 8 tiles of 16 x 40 fp32
    assert plstm.fwd_resident_smem(1024) \
        == 32 * (512 + 4) * 4 + 8 * 16 * 40 * 4 == 86_528
    assert plstm.fwd_resident_smem(5) == 32 * (8 + 4) * 4 + 20_480
    assert plstm.fwd_resident_smem(3296) <= plstm.SMEM_LIMIT \
        < plstm.fwd_resident_smem(3312)


def test_forward_on_cpu_counts_no_route():
    xp, _, tw, _ = _inputs(3, 4, 16, True, seed=4)
    before = dict(plstm.lstm_fwd.routes)
    plstm.lstm_fwd(torch.from_numpy(xp), tw)
    assert plstm.lstm_fwd.routes == before


def test_scan_on_cpu_is_the_plain_version_and_counts_nothing():
    xp, _, tw, dys = _inputs(3, 4, 16, False, seed=2)
    before = (plstm.lstm_fwd.launches, plstm.lstm_bwd.launches)
    outs = []
    for fn in (plstm.lstm_scan, plstm.lstm_scan_reference):
        x = torch.from_numpy(xp).requires_grad_()
        w = tw.clone().requires_grad_()
        y = fn(x, w)
        y.backward(torch.from_numpy(dys))
        outs.append((y.detach(), x.grad, w.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert (plstm.lstm_fwd.launches, plstm.lstm_bwd.launches) == before
    assert plstm.lstm_bwd.routes == {"resident": 0, "streaming": 0}


def test_scan_rejects_bad_arguments():
    x = torch.zeros(3, 2, 16)
    with pytest.raises(ValueError, match="4h"):
        plstm.lstm_fwd(x, torch.zeros(5, 20))
    with pytest.raises(ValueError, match="fp32"):
        plstm.lstm_fwd(x.double(), torch.zeros(4, 16))
    with pytest.raises(ValueError, match="ys"):
        plstm.lstm_bwd(x, torch.zeros(4, 16), torch.zeros(3, 2, 5),
                       torch.zeros(3, 2, 4), torch.zeros(3, 2, 4))


# ---------------------------------------------------------------------
# the LSTM and LSTMStack ops

B, S, D, H, LR = 4, 5, 20, 24, 0.05


@pytest.fixture
def force_resident(monkeypatch):
    """The JAX ops' resident route on the CPU: eligibility reduced to the
    config flag, the kernel run in interpret mode."""
    monkeypatch.setattr(
        lk, "resident_scan_ok",
        lambda model, *a, **k: bool(getattr(model.config, "pallas_lstm",
                                            True)))
    orig = lk.lstm_scan
    monkeypatch.setattr(
        lk, "lstm_scan", lambda xp, wh, interpret=False: orig(xp, wh, True))


def _build(m, stack):
    x = m.create_tensor((B, S, D), name="x")
    t = (m.lstm_stack(x, H, num_layers=2, name="rnn") if stack
         else m.lstm(x, H, name="rnn"))
    t = m.reshape(t, (B * S, H), name="fold")
    return m.dense(t, 1, name="head")


def _jax_op_model(stack, resident):
    m = ff.FFModel(ff.FFConfig(batch_size=B, seed=3))
    m.config.pallas_lstm = resident
    _build(m, stack)
    m.compile(ff.SGDOptimizer(lr=LR), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers(seed=3)
    return m


@pytest.mark.parametrize("resident", [False, True],
                         ids=["lax_scan", "resident"])
@pytest.mark.parametrize("stack", [False, True], ids=["lstm", "stack"])
def test_lstm_ops_match_jax(stack, resident, force_resident):
    jm = _jax_op_model(stack, resident)
    p0 = jax.tree.map(np.asarray, jm.params)
    pm = pt.FFModel(pt.FFConfig(batch_size=B, device="cpu"))
    _build(pm, stack)
    pm.compile(SGDOptimizer(lr=LR), "mean_squared_error", ["mse"])
    pm.swap_params(params_from_jax(pm, p0))
    assert set(pm.params["rnn"]) == set(p0["rnn"])
    rng = np.random.RandomState(0)
    xb = rng.randn(B, S, D).astype(np.float32)
    np.testing.assert_allclose(pm.forward_batch({"x": xb}).numpy(),
                               np.asarray(jm.forward_batch({"x": xb})),
                               rtol=0, atol=1e-6)
    for _ in range(2):
        batch = {"x": xb, "label": rng.randn(B * S, 1).astype(np.float32)}
        lj = float(jm.train_batch(batch)["loss"])
        lp = float(pm.train_batch(batch)["loss"])
        np.testing.assert_allclose(lp, lj, rtol=1e-6)
    pj = jax.tree.map(np.asarray, jm.params)
    pp = params_to_jax(pm, pm.params)
    for op in pj:
        for pn, want in pj[op].items():
            dj, dp = want - p0[op][pn], pp[op][pn] - p0[op][pn]
            scale = np.abs(dj).max()
            assert scale > 0, (op, pn)
            np.testing.assert_allclose(dp, dj, rtol=0, atol=2e-4 * scale,
                                       err_msg=f"{op}.{pn}")


def test_lstm_ops_keep_the_jax_parameter_layout():
    pm = pt.FFModel(pt.FFConfig(batch_size=B, device="cpu"))
    px = pm.create_tensor((B, S, D), name="x")
    pm.lstm(px, H, name="one")
    pm.lstm_stack(px, H, 3, name="three")
    jm = ff.FFModel(ff.FFConfig(batch_size=B))
    jx = jm.create_tensor((B, S, D), name="x")
    jm.lstm(jx, H, name="one")
    jm.lstm_stack(jx, H, 3, name="three")
    for name in ("one", "three"):
        mine = pm.get_layer_by_name(name).param_defs()
        theirs = jm.get_layer_by_name(name).param_defs()
        assert {k: tuple(v.shape) for k, v in mine.items()} \
            == {k: tuple(v.shape) for k, v in theirs.items()}
    with pytest.raises(ValueError, match="num_layers"):
        pm.lstm_stack(px, H, 0, name="none")
