"""Quantized embedding tables in the port, trained, published and served,
against the JAX package on the CPU (``quant/policy.py``, the codec's
fake quantization, ``ops/kernels/quant_rows.py``'s plain version,
``FFModel``'s stochastic-rounding step, checkpoints, delta payloads, the
serving cache and shard tier, the launcher's flags).

Models: the JAX package's tests/test_quant.py graph, 4 tables x 64 rows
x d = 8 (stacked, lane-packed 16 rows to a 128-wide stored row), bottom
4-16-8, top 40-16-1, batch 16, 64 samples (4 steps). Inputs come from
numpy seeds; JAX weights cross by ``params_from_jax``.

Tolerances, and why:

- the policy, its errors and byte counts: EXACT (the same pure Python);
- nearest fake quantization: BITWISE to the JAX codec's jnp
  ``fake_quant`` (run op by op) for int8, fp8 and bf16, and the port's
  numpy ``fake_quant_np`` / ``fake_quant_stochastic_np`` /
  ``quantize_rows_np`` BITWISE to the JAX codec's numpy functions under
  one ``RandomState`` (the same IEEE operations; the JAX numpy codec
  turns int8 codes into integers first, so where the jnp one keeps a
  -0.0 the numpy one gives +0.0: equal as values);
- the row kernel's plain version: its "noise" entry BITWISE the codec's
  formula, its Philox entry BITWISE the "noise" entry fed the same draws
  (``philox_uniform``), the Philox bits equal to Random123's known
  answers; every stochastic code within {floor, floor + 1} of x / s, and
  the mean of 4,096 draws of one row within 6 standard errors of x (the
  rounding is unbiased: E[q] = x / s);
- ``master_weight`` int8 and fp8: BITWISE fp32 training, in each
  package (the policy changes nothing in the step); the port against the
  JAX package: every update within 1e-3 of its parameter's largest
  update (summation order, as tests/test_torch_host_tables.py);
- stochastic rounding on host tables: the host update (scatter, then the
  touched rows re-quantized with the per-step ``RandomState``) BITWISE
  to the JAX package's over 3 steps fed the same cotangents;
- stochastic rounding on device tables: the port's Philox draws are not
  JAX's threefry, so the tables are held by what the rule promises:
  every stored row is its codes times one scale (x / s within 1e-3 of
  an integer code, for s = amax / 127, or amax / 126 where the rounding
  took the largest value, an ulp short of 127, down to 126), and every
  row whose largest code is 127 a FIXED POINT of nearest int8
  quantization: re-quantizing moves a value by at most 128 ulps of its
  row's scale (the codec's 1-ulp scale drift times |q| <= 127) — the
  reference test tests/test_quant.py::...[momentum] demands exact
  equality there and fails on one row in 16 for that reason;
  DETERMINISTIC per seed (bitwise); and within tolerance of fp32
  training: under SGD and momentum every table value within (steps + 1)
  code steps (one per re-quantization and one at init, the largest
  row scale a step) and every dense value within 5e-3; under Adam
  within 2 x steps x alpha (each run moves a value at most about alpha
  a step, and a gradient near zero makes a full-size step either way);
- the sentinel: a poisoned step leaves every table bitwise untouched;
- storage boundaries: checkpoints cross-load BITWISE both ways and the
  manifest's quant meta equals the JAX one; delta files, their loads,
  the scale-fault gate, the quantized cache entries and the quantized
  shard tier's fetched rows (in process and over tcp) BITWISE the JAX
  package's (the same numpy codec on the same rows).
"""

import os

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh
from dlrm_flexflow_tpu.parallel.pconfig import (ParallelConfig as
                                                JaxParallelConfig)
from dlrm_flexflow_tpu.quant import codec as jcodec
from dlrm_flexflow_tpu.quant import policy as jpolicy
from dlrm_flexflow_tpu.serve import cache as jax_cache
from dlrm_flexflow_tpu.serve import shardtier as jax_tier
from dlrm_flexflow_tpu.utils import checkpoint as jax_ckpt
from dlrm_flexflow_tpu.utils import delta as jax_delta
from dlrm_flexflow_tpu.utils import faults as jax_faults

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import (AdamOptimizer,
                                                     SGDOptimizer)
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.ops.kernels import quant_rows as qr
from dlrm_flexflow_tpu_torch.parallel.pconfig import ParallelConfig
from dlrm_flexflow_tpu_torch.parallel.strategy_io import save_strategies
from dlrm_flexflow_tpu_torch.quant import codec, policy
from dlrm_flexflow_tpu_torch.serve import EmbeddingShardSet
from dlrm_flexflow_tpu_torch.serve import cache as port_cache
from dlrm_flexflow_tpu_torch.serve import shardtier as tier
from dlrm_flexflow_tpu_torch.utils import checkpoint as ckpt
from dlrm_flexflow_tpu_torch.utils import delta, faults, warmcache
from dlrm_flexflow_tpu_torch.utils.weights import (params_from_jax,
                                                   params_to_jax)

BS, N, STEPS = 16, 64, 4
ARCH = dict(embedding_size=[64] * 4, sparse_feature_size=8,
            mlp_bot=[4, 16, 8], mlp_top=[40, 16, 1])
SR = dict(emb_dtype="int8", emb_update_rule="stochastic_rounding")
JOPT = {"sgd": lambda: ff.SGDOptimizer(lr=0.05),
        "momentum": lambda: ff.SGDOptimizer(lr=0.05, momentum=0.9),
        "adam": lambda: ff.AdamOptimizer(alpha=0.05)}
POPT = {"sgd": lambda: SGDOptimizer(lr=0.05),
        "momentum": lambda: SGDOptimizer(lr=0.05, momentum=0.9),
        "adam": lambda: AdamOptimizer(alpha=0.05)}
ALPHA = 0.05


def _jax(opt="sgd", seed=3, strategies=None, **cfg):
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=seed, **cfg))
    jax_build_dlrm(m, JaxDLRMConfig(**ARCH))
    m.compile(JOPT[opt](), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]),
              strategies=strategies)
    m.init_layers()
    return m


def _port(opt="sgd", seed=3, jm=None, strategies=None, **cfg):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, seed=seed, device="cpu",
                               **cfg))
    build_dlrm(m, DLRMConfig(**ARCH))
    m.compile(POPT[opt](), "mean_squared_error", ["mse"],
              strategies=strategies)
    m.init_layers()
    if jm is not None:
        m.swap_params(params_from_jax(m, jax.tree.map(np.asarray,
                                                      jm.params)))
    return m


def _fit(model, seed=0):
    x, y = synthetic_batch(DLRMConfig(**ARCH), N, seed=seed)
    model.fit(x, y, epochs=1, verbose=False)
    return model


def _jax_fit(model, seed=0):
    from dlrm_flexflow_tpu.models.dlrm import synthetic_batch as jsb
    x, y = jsb(JaxDLRMConfig(**ARCH), N, seed=seed)
    model.fit(x, y, epochs=1, verbose=False)
    return model


def _table(model, name="emb_stack"):
    """The stored table in the JAX layout, (rows, 128) packed rows."""
    k = params_to_jax(model, model.params)[name]["kernel"]
    return k.reshape(-1, k.shape[-1])


def _assert_fixed_point(v, dt="int8"):
    """Every row of ``v`` is its codes times one scale, and every row
    whose largest code is qmax is a fixed point of nearest
    quantization. For int8 each row's x / s is an integer (to 1e-3 of a
    code) under s = amax / 127, or under amax / 126: stochastic rounding
    takes the largest value's x / s, which lies within an ulp of 127,
    down to 126 where it fell short and u was smaller than the
    shortfall. Where the largest code is qmax, nearest re-quantization
    moves no value by more than (qmax + 1) ulps of the row's scale (the
    recomputed scale is within an ulp, times |q| <= qmax). Returns how
    many rows have largest code 126."""
    v = np.asarray(v, np.float32)
    amax = np.abs(v).max(axis=1)
    qmax = 127.0 if dt == "int8" else 448.0
    top = np.ones(v.shape[0], bool)
    short = 0
    if dt == "int8":
        errs = []
        for n in (127, 126):
            s = (amax / np.float32(n)).astype(np.float32)
            y = v / np.where(s > 0, s, 1)[:, None]
            errs.append(np.abs(y - np.rint(y)).max(axis=1))
        assert np.minimum(*errs).max() < 1e-3
        top = errs[0] < 1e-3
        short = int((~top).sum())
    q, s = codec.quantize_rows_np(v, dt)
    fq = codec.fake_quant_np(v, dt)
    bound = (qmax + 1) * np.spacing(np.maximum(s, np.float32(1e-30)))
    assert np.all(np.abs(fq - v)[top] <= bound[top][:, None])
    return short


def _rows_with_edges(d, seed=0, n=96):
    rng = np.random.RandomState(seed)
    a = (rng.randn(n, d) * rng.rand(n, 1)).astype(np.float32)
    a[0] = 0.0                              # an all-zero row: scale 0
    a[1] = -0.0
    a[2] = np.where(np.arange(d) % 2, 127.0, -127.0) * np.float32(0.01)
    a[3] = np.where(np.arange(d) % 2, 448.0, -448.0) * np.float32(0.5)
    a[4, :] = 3.0                           # one value: x / s = 127
    a[5] = a[5] * 1e-30                     # fp8 subnormal codes
    return a


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------
@pytest.mark.parametrize("args", [("int4",), ("int8", "nearest"),
                                  ("int8", "master_weight", "tensor")])
def test_policy_errors_equal_jax(args):
    with pytest.raises(ValueError) as want:
        jpolicy.QuantPolicy(*args)
    with pytest.raises(ValueError) as got:
        policy.QuantPolicy(*args)
    assert str(got.value) == str(want.value)


class _Op:
    """An op with a table: what ``effective_policy`` reads."""
    host_lookup = None

    def __init__(self, model, pol=None):
        self.model = model
        if pol is not None:
            self._quant_policy = pol


class _Model:
    def __init__(self, config):
        self.config = config


@pytest.mark.parametrize("pc_dt,pc_ur,cfg_dt,cfg_ur", [
    ("", "", "fp32", "master_weight"), ("", "", "int8", "master_weight"),
    ("fp8", "", "int8", "stochastic_rounding"),
    ("int8", "stochastic_rounding", "fp32", "master_weight"),
    ("bf16", "master_weight", "fp8", "stochastic_rounding"),
    ("fp32", "", "int8", "master_weight")])
def test_policy_resolution_equals_jax(pc_dt, pc_ur, cfg_dt, cfg_ur):
    jpc = JaxParallelConfig((1, 1), quant_dtype=pc_dt, quant_update=pc_ur)
    ppc = ParallelConfig((1, 1), quant_dtype=pc_dt, quant_update=pc_ur)

    def view(p):
        return None if p is None else (p.dtype, p.update_rule,
                                       p.is_quantized, p.is_default,
                                       p.itemsize, p.row_bytes(64))
    jcfg = ff.FFConfig(emb_dtype=cfg_dt, emb_update_rule=cfg_ur)
    pcfg = pt.FFConfig(emb_dtype=cfg_dt, emb_update_rule=cfg_ur,
                       device="cpu")
    assert view(policy.policy_from_pc(ppc)) == \
        view(jpolicy.policy_from_pc(jpc))
    assert view(policy.policy_from_config(pcfg)) == \
        view(jpolicy.policy_from_config(jcfg))
    for pc in (None, ppc):
        jop = _Op(_Model(jcfg))
        pop = _Op(_Model(pcfg))
        assert view(policy.effective_policy(pop, pc)) == view(
            jpolicy.effective_policy(jop, None if pc is None else jpc))
    pol = policy.effective_policy(_Op(_Model(pcfg)), ppc)
    jpol = jpolicy.effective_policy(_Op(_Model(jcfg)), jpc)
    for shape in [(), (7,), (64, 8), (4, 4, 128)]:
        assert policy.table_storage_bytes(shape, pol) == \
            jpolicy.table_storage_bytes(shape, jpol)


def test_storage_bytes_of_a_model_equal_jax():
    jm = _jax(**SR)
    pm = _port(**SR)
    (jop,) = [op for op in jm.ops if op.name == "emb_stack"]
    (pop,) = [op for op in pm.ops if op.name == "emb_stack"]
    jshapes = {n: d.shape for n, d in jop.param_defs().items()}
    got = policy.param_storage_bytes(pop, None, {"kernel": (16, 128)})
    assert got == jpolicy.param_storage_bytes(jop, None, jshapes)
    assert tier.serving_footprint(pm, 2, 2) == \
        jax_tier.serving_footprint(jm, 2, 2)


# ---------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("d", [8, 16, 64, 128])
def test_nearest_fake_quant_bitwise_jax(dt, d):
    a = _rows_with_edges(d, seed=d)
    want_jnp = np.asarray(jcodec.fake_quant(a, dt))
    want_np = jcodec.fake_quant_np(a, dt)
    got = codec.fake_quant(torch.from_numpy(a), dt).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want_jnp))
    np.testing.assert_array_equal(got, want_np)          # as values
    np.testing.assert_array_equal(_bits(codec.fake_quant_np(a, dt)),
                                  _bits(want_np))
    # the kernel's plain version in place over (rows, d) is the same
    x = torch.from_numpy(a.copy())
    qr.fake_quant_rows(x, dt, "nearest")
    np.testing.assert_array_equal(_bits(x.numpy()), _bits(want_jnp))


@pytest.mark.parametrize("dt", ["int8", "fp8"])
def test_quantize_rows_np_bitwise_jax(dt):
    a = _rows_with_edges(32, seed=1)
    jq, js = jcodec.quantize_rows_np(a, dt)
    q, s = codec.quantize_rows_np(a, dt)
    np.testing.assert_array_equal(q, jcodec.encode_q(jq, dt))
    np.testing.assert_array_equal(_bits(s), _bits(js))
    np.testing.assert_array_equal(
        _bits(codec.dequantize_rows_np(q, s, dt)),
        _bits(jcodec.dequantize_rows_np(jq, js, dt)))


@pytest.mark.parametrize("dt", ["int8", "fp8", "bf16"])
def test_stochastic_np_bitwise_jax(dt):
    a = _rows_with_edges(64, seed=2)
    want = jcodec.fake_quant_stochastic_np(a, dt, np.random.RandomState(9))
    got = codec.fake_quant_stochastic_np(a, dt, np.random.RandomState(9))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = qr.philox4x32(*[torch.tensor(c, dtype=torch.int64)
                              for c in ctr], *key)
        assert tuple(int(g) for g in got) == want


def test_kernel_plain_version_entries():
    a = _rows_with_edges(24, seed=3, n=200)
    # the "noise" entry is the codec's formula on the given draws
    u = np.random.RandomState(4).random_sample(a.shape).astype(np.float32)
    x = torch.from_numpy(a.copy())
    qr.fake_quant_rows(x, "int8", "stochastic", u=torch.from_numpy(u))
    amax = np.abs(a).max(axis=1)
    s = np.where(amax > 0, amax / np.float32(127), 0).astype(np.float32)
    safe = np.where(s > 0, s, 1)[:, None]
    want = np.clip(np.floor(a / safe + u), -127, 127) * s[:, None]
    np.testing.assert_array_equal(_bits(x.numpy()), _bits(want))
    got = codec.fake_quant_stochastic(torch.from_numpy(a), "int8",
                                      noise=torch.from_numpy(u))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    assert torch.equal(codec.fake_quant_stochastic(x, "int8", generator=g1),
                       codec.fake_quant_stochastic(x, "int8", generator=g2))
    # the Philox entry is the "noise" entry fed philox_uniform
    y = torch.from_numpy(a.copy())
    qr.fake_quant_rows(y, "int8", "stochastic", seed=11, step=5, salt=0x52,
                       row0=7)
    uu = qr.philox_uniform(200, 24, 11, 5, 0x52, row0=7)
    assert float(uu.min()) >= 0.0 and float(uu.max()) < 1.0
    z = torch.from_numpy(a.copy())
    qr.fake_quant_rows(z, "int8", "stochastic", u=uu.contiguous())
    np.testing.assert_array_equal(_bits(y.numpy()), _bits(z.numpy()))
    # another step draws otherwise; fp8 and bf16 round to nearest
    w = torch.from_numpy(a.copy())
    qr.fake_quant_rows(w, "int8", "stochastic", seed=11, step=6, salt=0x52,
                       row0=7)
    assert not torch.equal(w, y)
    for dt in ("fp8", "bf16"):
        p, n = torch.from_numpy(a.copy()), torch.from_numpy(a.copy())
        qr.fake_quant_rows(p, dt, "stochastic", seed=1)
        qr.fake_quant_rows(n, dt, "nearest")
        assert torch.equal(p, n)
    # the sentinel's flag 0 writes nothing
    v = torch.from_numpy(a.copy())
    qr.fake_quant_rows(v, "int8", "stochastic", seed=1,
                       ok=torch.zeros((), dtype=torch.int32))
    np.testing.assert_array_equal(v.numpy(), a)


def test_stochastic_codes_are_floor_or_ceil_and_unbiased():
    rng = np.random.RandomState(5)
    row = (rng.randn(1, 64) * 0.02).astype(np.float32)
    reps = 4096
    x = torch.from_numpy(np.repeat(row, reps, axis=0))
    qr.fake_quant_rows(x, "int8", "stochastic", seed=3, step=1, salt=0x51)
    s = np.float32(np.abs(row).max() / np.float32(127))
    codes = x.numpy() / s
    lo = np.floor(row / s)
    assert np.all((np.abs(codes - lo) < 1e-3)
                  | (np.abs(codes - lo - 1) < 1e-3))
    # E[q] = x / s: the mean of the draws within 6 standard errors
    frac = row / s - lo
    se = np.sqrt(frac * (1 - frac) / reps) + 1e-6
    assert np.all(np.abs(codes.mean(axis=0) - row / s) <= 6 * se + 1e-4)


def test_fake_quant_rows_refuses_what_it_does_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="dtype"):
        qr.fake_quant_rows(x, "int4")
    with pytest.raises(ValueError, match="mode"):
        qr.fake_quant_rows(x, "int8", "floor")
    with pytest.raises(ValueError, match="rows, d"):
        qr.fake_quant_rows(torch.zeros(8), "int8")
    with pytest.raises(ValueError, match="u must be"):
        qr.fake_quant_rows(x, "int8", "stochastic", u=torch.zeros(4, 7))
    with pytest.raises(ValueError, match="ok"):
        qr.fake_quant_rows(x, "int8", ok=torch.ones(1))
    with pytest.raises(ValueError, match="exactly one"):
        codec.fake_quant_stochastic(x, "int8")


# ---------------------------------------------------------------------
# training
# ---------------------------------------------------------------------
def test_a_strategy_quant_entry_is_honoured(tmp_path):
    """The fault this slice repairs: a strategy file's quant_dtype /
    quant_update were parsed and then dropped, so a stochastic-rounding
    table trained at fp32. The fp32 run below shows what that trained:
    rows that are no quantized image. The same file now trains fixed
    points, as the JAX package does, and the entry wins over the
    config's default."""
    fp32 = _table(_fit(_port()))
    with pytest.raises(AssertionError):
        _assert_fixed_point(fp32)
    path = str(tmp_path / "s.json")
    save_strategies(path, {"emb_stack": ParallelConfig(
        (1, 1, 1), quant_dtype="int8",
        quant_update="stochastic_rounding")})
    pm = _port(import_strategy_file=path, emb_dtype="fp8")
    pol = pm.quant_policies()["emb_stack"]
    assert (pol.dtype, pol.update_rule) == ("int8", "stochastic_rounding")
    _assert_fixed_point(_table(_fit(pm)))
    jm = _jax(import_strategy_file=path, emb_dtype="fp8")
    assert jm.quant_policies() == {
        k: jpolicy.QuantPolicy(v.dtype, v.update_rule)
        for k, v in pm.quant_policies().items()}


@pytest.mark.parametrize("opt,dt", [("sgd", "int8"), ("sgd", "fp8"),
                                    ("adam", "int8")])
def test_master_weight_trains_as_fp32(opt, dt):
    jm = _jax(opt, emb_dtype=dt)
    j32 = _jax(opt)
    p0 = jax.tree.map(np.asarray, jm.params)
    pm = _port(opt, jm=jm, emb_dtype=dt)
    p32 = _port(opt, jm=jm)
    assert pm.quant_policies()["emb_stack"].dtype == dt
    for m in (jm, j32):
        _jax_fit(m)
    for m in (pm, p32):
        _fit(m)
    a, b = params_to_jax(pm, pm.params), params_to_jax(p32, p32.params)
    ja = jax.tree.map(np.asarray, jm.params)
    jb = jax.tree.map(np.asarray, j32.params)
    for op in a:
        for pn in a[op]:
            np.testing.assert_array_equal(a[op][pn], b[op][pn])
            np.testing.assert_array_equal(ja[op][pn], jb[op][pn])
            dw = ja[op][pn] - p0[op][pn]
            err = np.abs(a[op][pn] - ja[op][pn]).max()
            assert err <= 1e-3 * np.abs(dw).max() + 1e-7, (op, pn, err)


def _host_pair(opt):
    cfg = dict(host_resident_tables=True, host_tables_async=False, **SR)
    jm = _jax(opt, **cfg)
    pm = _port(opt, jm=jm, **cfg)
    np.testing.assert_array_equal(pm.host_params["emb_stack"]["kernel"],
                                  jm.host_params["emb_stack"]["kernel"])
    return jm, pm


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_host_stochastic_rounding_bitwise_jax(opt):
    jm, pm = _host_pair(opt)
    # the init re-quantized (nearest) the same host table in both
    _assert_fixed_point(pm.host_params["emb_stack"]["kernel"].reshape(-1, 8))
    pm._ensure_host_opt_state()
    rng = np.random.RandomState(6)
    (op,) = pm._host_resident_list
    for step in range(3):
        x = synthetic_batch(DLRMConfig(**ARCH), BS, seed=30 + step)[0]
        ids = {"emb_stack": x["sparse"]}
        ct = (rng.randn(BS, 4, 8) * 0.1).astype(np.float32)
        jm._host_emb_update(ids, {"emb_stack": ct}, step)
        pm._host_emb_update(ids, {"emb_stack": torch.from_numpy(ct)}, step)
        got = pm.host_params["emb_stack"]["kernel"]
        np.testing.assert_array_equal(
            _bits(got), _bits(jm.host_params["emb_stack"]["kernel"]))
        touched = np.unique(op.host_delta_touched_rows(x["sparse"]))
        _assert_fixed_point(got.reshape(-1, 8)[touched])
    for k, v in jm.host_opt_state.get("emb_stack", {}).items():
        np.testing.assert_array_equal(pm.host_opt_state["emb_stack"][k], v)


def test_host_stochastic_rounding_trains_to_fixed_points():
    jm, pm = _host_pair("sgd")
    _fit(pm)
    _assert_fixed_point(pm.host_params["emb_stack"]["kernel"].reshape(-1, 8))


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_device_stochastic_rounding(opt):
    sr = _fit(_port(opt, **SR))
    again = _fit(_port(opt, **SR))
    base = _fit(_port(opt))
    v = _table(sr)
    _assert_fixed_point(v)
    pa, pb = params_to_jax(sr, sr.params), params_to_jax(again,
                                                         again.params)
    for op in pa:                             # deterministic per seed
        for pn in pa[op]:
            np.testing.assert_array_equal(pa[op][pn], pb[op][pn])
    diff = np.abs(v - _table(base)).max()
    _, s = codec.quantize_rows_np(v, "int8")
    if opt == "adam":
        bound = dense_bound = 2 * STEPS * ALPHA
    else:
        bound, dense_bound = (STEPS + 1) * float(s.max()), 5e-3
    assert 0 < diff <= bound, (diff, bound)
    p32 = params_to_jax(base, base.params)
    dense = max(np.abs(pa[o][p] - p32[o][p]).max()
                for o in pa if o != "emb_stack" for p in pa[o])
    assert dense <= dense_bound


def test_fp8_stochastic_rounding_rounds_to_nearest():
    sr = _fit(_port(emb_dtype="fp8", emb_update_rule="stochastic_rounding"))
    _assert_fixed_point(_table(sr), "fp8")


def test_a_poisoned_step_leaves_the_tables_untouched():
    pm = _port(anomaly_policy="skip_step", **SR)
    x, y = synthetic_batch(DLRMConfig(**ARCH), BS, seed=1)
    x["label"] = y
    pm.train_batch(dict(x))
    before = {k: v.clone() for k, v in pm.params["emb_stack"].items()}
    with faults.active_plan(faults.FaultPlan(nan_grad_steps={1})):
        mets = pm.train_batch(dict(x))
    assert bool(mets["anomaly"])
    for k, v in pm.params["emb_stack"].items():
        assert torch.equal(v, before[k])
    pm.train_batch(dict(x))                  # and the next step trains
    assert not torch.equal(pm.params["emb_stack"]["kernel"],
                           before["kernel"])


# ---------------------------------------------------------------------
# storage boundaries
# ---------------------------------------------------------------------
def test_quantized_checkpoints_cross_load(tmp_path):
    pm = _fit(_port(**SR))
    mgr = ckpt.CheckpointManager(str(tmp_path / "port"))
    mgr.save(pm)
    jm = _jax(**SR)
    assert jax_ckpt.CheckpointManager(
        str(tmp_path / "port")).restore_latest(jm) is not None
    want = params_to_jax(pm, pm.params)
    for op in want:
        for pn in want[op]:
            np.testing.assert_array_equal(np.asarray(jm.params[op][pn]),
                                          want[op][pn])
    entry = mgr.entries()[-1]
    assert entry["mesh"]["quant"] == jax_ckpt.mesh_meta(jm)["quant"] == {
        "emb_stack": {"dtype": "int8", "update_rule": "stochastic_rounding"}}
    _jax_fit(jm, seed=1)
    jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"))
    jmgr.save(jm)
    p2 = _port(**SR)
    assert ckpt.CheckpointManager(
        str(tmp_path / "jax")).restore_latest(p2) is not None
    got = params_to_jax(p2, p2.params)
    for op in got:
        for pn in got[op]:
            np.testing.assert_array_equal(got[op][pn],
                                          np.asarray(jm.params[op][pn]))
    _assert_fixed_point(_table(p2))


def _delta_rows(dt, seed=0):
    rng = np.random.RandomState(seed)
    idx = np.unique(rng.randint(0, 64, 20)).astype(np.int64)
    vals = (rng.randn(idx.size, 128) * 0.05).astype(np.float32)
    vals[0] = 0.0
    key = "params/emb_stack/kernel"
    return key, {key: (idx, vals)}, {
        "params/dense/bias": rng.randn(16).astype(np.float32)}


@pytest.mark.parametrize("dt", ["int8", "fp8"])
def test_quantized_delta_files_equal_jax(dt, tmp_path):
    key, rows, full = _delta_rows(dt)
    pp, jp = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    delta.write_delta_file(pp, 3, 2, 1, rows, full, quant={key: dt})
    jax_delta.write_delta_file(jp, 3, 2, 1, rows, full, quant={key: dt})
    with np.load(pp) as a, np.load(jp) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    for path in (pp, jp):                    # each loads either file
        got, want = delta.load_delta_file(path), \
            jax_delta.load_delta_file(path)
        np.testing.assert_array_equal(_bits(got["rows"][key][1]),
                                      _bits(want["rows"][key][1]))
        gi, gq, gs, gdt = got["qrows"][key]
        wi, wq, ws, wdt = want["qrows"][key]
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gq.view(np.uint8),
                                      np.asarray(wq).view(np.uint8))
        np.testing.assert_array_equal(gs, ws)
        assert gdt == wdt == dt


def test_the_scale_fault_is_rejected_as_jax_rejects_it(tmp_path,
                                                        monkeypatch):
    key, rows, full = _delta_rows("int8")
    path = str(tmp_path / "d.npz")
    delta.write_delta_file(path, 3, 2, 1, rows, full, quant={key: "int8"})
    with faults.active_plan(faults.FaultPlan(
            quant_scale={"emb_stack": 1e3})) as plan:
        with pytest.raises(delta.ChainError) as got:
            delta.load_delta_file(path)
        assert plan.fired[0][0] == "quant_scale"
        delta.load_delta_file(path)           # consume-once
    with jax_faults.active_plan(jax_faults.FaultPlan(
            quant_scale={"emb_stack": 1e3})):
        with pytest.raises(jax_delta.ChainError) as want:
            jax_delta.load_delta_file(path)
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("FF_FAULT_QUANT_SCALE", "emb_stack:1e3")
    assert faults.plan_from_env().quant_scale == \
        jax_faults.plan_from_env().quant_scale == {"emb_stack": 1e3}
    monkeypatch.setenv("FF_FAULT_QUANT_SCALE", "emb_stack")
    with pytest.raises(ValueError, match="FF_FAULT_QUANT_SCALE"):
        faults.plan_from_env()


def test_a_quantized_publish_serves_its_dequantized_payload(tmp_path):
    from dlrm_flexflow_tpu_torch.serve import (InferenceEngine,
                                               ServeConfig, SnapshotWatcher)
    pm = _port(**SR)
    pub = delta.DeltaPublisher(pm, str(tmp_path), compact_frac=1e9,
                               row_delta_min_elems=1024)
    pub.publish_full()
    _fit(pm)
    entry = pub.publish()
    assert entry is not None and entry["kind"] == "delta"
    payload = delta.load_delta_file(os.path.join(str(tmp_path),
                                                 entry["file"]))
    key = "params/emb_stack/kernel"
    idx, q, s, dt = payload["qrows"][key]
    assert dt == "int8" and q.dtype == np.int8
    # the JAX package's loader reads the port's delta
    jp = jax_delta.load_delta_file(os.path.join(str(tmp_path),
                                                entry["file"]))
    np.testing.assert_array_equal(jp["rows"][key][1], payload["rows"][key][1])
    sv = _port(seed=9, **SR)
    eng = InferenceEngine(sv, ServeConfig(max_batch=BS, warmup=False))
    assert SnapshotWatcher(eng, str(tmp_path)).poll_once()
    served = _table(sv)
    np.testing.assert_array_equal(served[idx],
                                  codec.dequantize_rows_np(q, s, "int8"))
    # a stochastic-rounding row whose largest code is 127 is a fixed
    # point of the publish's nearest quantization: it arrives as trained
    trained = _table(pm)
    amax = np.abs(trained).max(axis=1)
    s = (amax / np.float32(127)).astype(np.float32)
    y = trained / np.where(s > 0, s, 1)[:, None]
    top = np.abs(y - np.rint(y)).max(axis=1) < 1e-3
    np.testing.assert_array_equal(served[top], trained[top])
    assert np.all(np.abs(served - trained)[~top]
                  <= 0.5 * s[~top][:, None] + 1e-9)


def _host_models(**cfg):
    cfg = dict(host_resident_tables=True, host_tables_async=False, **cfg)
    jm = _jax(**cfg)
    return jm, _port(jm=jm, **cfg)


@pytest.mark.parametrize("dt", ["int8", "fp8"])
def test_the_quantized_cache_equals_jax(dt):
    jm, pm = _host_models(emb_dtype=dt)
    (pop,), (jop,) = pm._host_resident_list, jm._host_resident_list
    pc = port_cache.EmbeddingCache(32, quant={"emb_stack": dt})
    jc = jax_cache.EmbeddingCache(32, quant={"emb_stack": dt})
    for seed in (0, 1, 0):
        idx = synthetic_batch(DLRMConfig(**ARCH), BS, seed=seed)[0][
            "sparse"]
        got = pc.lookup(pop, pm.host_params["emb_stack"], idx)
        want = jc.lookup(jop, jm.host_params["emb_stack"], idx)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert list(pc._d) == list(jc._d)
    for (pv, _), (jv, _) in zip(pc._d.values(), jc._d.values()):
        np.testing.assert_array_equal(pv[0].view(np.uint8),
                                      np.asarray(jv[0]).view(np.uint8))
        np.testing.assert_array_equal(pv[1], jv[1])
    assert pc.stats()["hits"] == jc.stats()["hits"] > 0
    assert pc.stored_bytes() == jc.stored_bytes()


def test_the_quantized_shard_tier_equals_jax(tmp_path):
    jm, pm = _host_models(**SR)
    ps = EmbeddingShardSet.build(pm, 3)
    js = jax_tier.EmbeddingShardSet.build(jm, 3)
    try:
        assert ps._quant == js._quant == {"emb_stack": "int8"}
        np.testing.assert_array_equal(ps._defaults["emb_stack"],
                                      js._defaults["emb_stack"])
        for rep, jrep in zip(ps.shards, js.shards):
            blk = rep.shard._blocks["emb_stack"]
            jblk = jrep.shard._blocks["emb_stack"]
            np.testing.assert_array_equal(blk.q.numpy(), jblk.q)
            np.testing.assert_array_equal(blk.scales.numpy(), jblk.scales)
            assert rep.shard.hbm_bytes() == jrep.shard.hbm_bytes()
        ids = np.unique(np.random.RandomState(0).randint(0, 256, 60))
        got, want = ps.fetch({"emb_stack": ids}), js.fetch(
            {"emb_stack": ids})
        np.testing.assert_array_equal(_bits(got.rows["emb_stack"]),
                                      _bits(want.rows["emb_stack"]))
    finally:
        ps.close()
        js.close()


def test_the_quantized_tier_over_tcp_equals_jax(tmp_path):
    from dlrm_flexflow_tpu_torch.examples.native import serve_dlrm
    jm, pm = _host_models(**SR)
    js = jax_tier.EmbeddingShardSet.build(jm, 2)
    EmbeddingShardSet.seed_shard_cache(pm, 2, str(tmp_path))
    procs = serve_dlrm.ShardProcs()
    sset = None
    try:
        sset = EmbeddingShardSet.connect(procs.spawn(str(tmp_path), 2),
                                         cache_dir=str(tmp_path))
        assert sset._quant == {"emb_stack": "int8"}
        ids = np.unique(np.random.RandomState(1).randint(0, 256, 60))
        got, want = sset.fetch({"emb_stack": ids}), js.fetch(
            {"emb_stack": ids})
        np.testing.assert_array_equal(_bits(got.rows["emb_stack"]),
                                      _bits(want.rows["emb_stack"]))
    finally:
        if sset is not None:
            sset.close()
        procs.stop()
        js.close()


def test_a_corrupt_warm_cache_scale_rejects_the_entry(tmp_path):
    jm, pm = _host_models(**SR)
    EmbeddingShardSet.seed_shard_cache(pm, 2, str(tmp_path))
    cache = warmcache.ShardCache(str(tmp_path))
    assert cache.get(2, 0) is not None
    with faults.active_plan(faults.FaultPlan(
            quant_scale={"emb_stack": 1e3})):
        assert cache.get(2, 1) is None
    assert "exceeds the publish-time bound" in cache.last_reject
    assert cache.get(2, 1) is not None


def test_the_launcher_takes_the_quant_flags():
    from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
    out = launcher.main([
        "--device", "cpu", "-b", "16", "--arch-embedding-size",
        "64-64-64-64", "--arch-sparse-feature-size", "8", "--arch-mlp-bot",
        "4-16-8", "--arch-mlp-top", "40-16-1", "--emb-dtype", "int8",
        "--emb-update-rule", "stochastic_rounding", "-e", "1"])
    m = out["model"]
    assert {k: (p.dtype, p.update_rule)
            for k, p in m.quant_policies().items()} == {
        "emb_stack": ("int8", "stochastic_rounding")}
    _assert_fixed_point(_table(m))
    with pytest.raises(ValueError, match="--emb-dtype expects"):
        pt.FFConfig.parse_args(["--emb-dtype", "int4"])
    with pytest.raises(ValueError, match="--emb-update-rule expects"):
        pt.FFConfig.parse_args(["--emb-update-rule", "nearest"])
