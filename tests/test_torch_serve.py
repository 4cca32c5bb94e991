"""The port's DLRM serving path against the JAX package.

A shrunk DLRM (4 tables × 512 rows × d=64, small MLPs) is built in both
packages, in the "cat" graph and the fused "dot" graph; the JAX model's
weights cross into the port through ``params_from_jax``, and the port's
``forward_batch`` must match the JAX one (rtol 1e-5, atol 1e-6: the
MLPs' products sum in another fp32 order in XLA and in PyTorch).

Within the port: ``forward_bucket``'s padding is bit-identical to
``forward_batch`` of the same rows, ``InferenceEngine`` answers
concurrent submits with the scores of ``forward_batch`` (within 1e-6:
a row coalesced with others runs in a BLAS call of another row count,
and a one-row call takes another BLAS kernel), backpressure and
deadlines are typed, malformed requests fail at submit, and a config
that asks for CUDA without a GPU raises.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.models.dlrm import (DLRMConfig as JaxDLRMConfig,
                                           build_dlrm as jax_build_dlrm)
from dlrm_flexflow_tpu.parallel.mesh import make_mesh

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.serve import (DeadlineExceeded,
                                           InferenceEngine, Overloaded,
                                           ServeConfig)
from dlrm_flexflow_tpu_torch.utils.weights import params_from_jax

BS = 16
ARCH = {
    "cat": dict(embedding_size=[512] * 4, sparse_feature_size=64,
                mlp_bot=[8, 32, 64], mlp_top=[64 + 4 * 64, 32, 16, 1],
                arch_interaction_op="cat"),
    "dot": dict(embedding_size=[512] * 4, sparse_feature_size=64,
                mlp_bot=[8, 32, 64], mlp_top=[64 + 10, 32, 16, 1],
                arch_interaction_op="dot"),
}


def _jax_model(mode):
    m = ff.FFModel(ff.FFConfig(batch_size=BS, seed=11))
    jax_build_dlrm(m, JaxDLRMConfig(**ARCH[mode]),
                   fuse_interaction=mode == "dot")
    m.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
              mesh=make_mesh(devices=jax.devices()[:1]))
    m.init_layers()
    return m


def _port_model(mode, jax_model=None):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu", seed=11))
    build_dlrm(m, DLRMConfig(**ARCH[mode]), fuse_interaction=mode == "dot")
    m.compile()
    if jax_model is None:
        m.init_layers()
    else:
        m.swap_params(params_from_jax(
            m, jax.tree.map(np.asarray, jax_model.params)))
    return m


@pytest.fixture(scope="module", params=["cat", "dot"])
def pair(request):
    jm = _jax_model(request.param)
    return request.param, jm, _port_model(request.param, jm)


def _rows(mode, n, seed=0):
    return synthetic_batch(DLRMConfig(**ARCH[mode]), n, seed=seed)[0]


def _slice(x, a, b):
    return {k: v[a:b] for k, v in x.items()}


class TestParity:
    def test_forward_batch_matches_jax(self, pair):
        mode, jm, pm = pair
        x = _rows(mode, 13, seed=1)
        names = [op.name for op in pm.ops]
        assert names == [op.name for op in jm.ops]
        want = np.asarray(jm.forward_batch(x))
        got = pm.forward_batch(x).numpy()
        assert got.shape == (13, 1) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_first_top_layer_matches_jax(self, pair):
        """The sigmoid head squashes differences: hold the layer the
        kernels feed (its pre-sigmoid output is a plain product of it)
        to the same tolerance through a model cut after it."""
        mode, jm, pm = pair
        first = "fused_interaction" if mode == "dot" else "top_dense_0"
        x = _rows(mode, 9, seed=2)
        jm2 = _jax_model(mode)
        jm2.params = jm.params
        jm2.compile(ff.SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"],
                    mesh=make_mesh(devices=jax.devices()[:1]),
                    final_tensor=jm2.get_layer_by_name(first).outputs[0])
        pm2 = _port_model(mode)
        pm2.compile(final_tensor=pm2.get_layer_by_name(first).outputs[0])
        pm2.swap_params(pm.params)
        want = np.asarray(jm2.forward_batch(x))
        got = pm2.forward_batch(x).numpy()
        assert got.shape == (9, ARCH[mode]["mlp_top"][1])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


class TestForwardBucket:
    @pytest.mark.parametrize("n,bucket", [(3, 4), (5, 8), (16, 16)])
    def test_padding_bit_identical(self, pair, n, bucket):
        mode, _, pm = pair
        x = _rows(mode, n, seed=n)
        got = pm.forward_bucket(x, bucket=bucket)
        assert got.shape[0] == n
        assert torch.equal(got, pm.forward_batch(x))

    def test_default_bucket_and_too_small(self, pair):
        mode, _, pm = pair
        x = _rows(mode, 6)
        assert pm.bucket_sizes(64) == (1, 2, 4, 8, 16, 32, 64)
        assert torch.equal(pm.forward_bucket(x), pm.forward_bucket(x, 8))
        with pytest.raises(ValueError, match="bucket"):
            pm.forward_bucket(x, bucket=4)


class TestEngine:
    @pytest.mark.parametrize("continuous", [True, False])
    def test_concurrent_submits_match_forward_batch(self, pair, continuous):
        mode, _, pm = pair
        x = _rows(mode, 200, seed=5)
        sizes = [1, 3, 7, 2, 16, 5, 9, 1, 4, 11, 6, 8]
        spans, off = [], 0
        for s in sizes * 2:
            spans.append((off, off + s))
            off += s
        results = {}
        cfg = ServeConfig(max_batch=32, max_delay_ms=2.0,
                          continuous=continuous)
        with InferenceEngine(pm, cfg) as eng:
            def client(k):
                for i in range(k, len(spans), 4):
                    a, b = spans[i]
                    results[i] = eng.predict(_slice(x, a, b), timeout=30)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            st = eng.stats()
        assert len(results) == len(spans)
        for i, (a, b) in enumerate(spans):
            want = pm.forward_batch(_slice(x, a, b)).numpy()
            assert results[i].scores.shape == (b - a, 1)
            np.testing.assert_allclose(results[i].scores, want,
                                       rtol=1e-6, atol=1e-7)
        assert st["responses"] == len(spans)
        assert st["buckets"] == [1, 2, 4, 8, 16, 32]
        assert sum(st["flushes"].values()) == st["batches"]
        assert st["p50_ms"] is not None and 0 < st["batch_fill"] <= 1

    def test_stress_more_clients_than_cores(self, pair):
        """24 client threads against the batcher, with the interpreter
        switching threads every microsecond: every request gets exactly
        its own rows back, and the counters lose no update."""
        mode, _, pm = pair
        x = _rows(mode, 24 * 6, seed=9)
        results, errors = {}, []
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with InferenceEngine(pm, ServeConfig(max_batch=32)) as eng:
                def client(k):
                    try:
                        for j in range(3):
                            a = 6 * k + 2 * j
                            results[(k, j)] = (a, eng.predict(
                                _slice(x, a, a + 2), timeout=60))
                    except Exception as e:   # noqa: BLE001 — asserted
                        errors.append(e)

                threads = [threading.Thread(target=client, args=(k,))
                           for k in range(24)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(120)
                assert not any(t.is_alive() for t in threads)
                st = eng.stats()
        finally:
            sys.setswitchinterval(old)
        assert not errors and len(results) == 72
        want = pm.forward_batch(x).numpy()
        for a, r in results.values():
            np.testing.assert_allclose(r.scores, want[a:a + 2],
                                       rtol=1e-6, atol=1e-7)
        assert st["requests"] == st["responses"] == 72
        assert sum(st["flushes"].values()) == st["batches"]

    def test_overloaded_is_typed(self, pair):
        mode, _, pm = pair
        x = _rows(mode, 1)
        release = threading.Event()
        real = pm.forward_bucket

        def blocked(batch, bucket=None):
            release.wait(10)
            return real(batch, bucket)

        eng = InferenceEngine(pm, ServeConfig(max_batch=4, queue_capacity=2,
                                              warmup=False))
        eng.start()
        pm.forward_bucket = blocked
        try:
            futs = [eng.submit(x)]
            time.sleep(0.2)          # the batcher takes it and blocks
            futs += [eng.submit(x), eng.submit(x)]
            with pytest.raises(Overloaded):
                eng.submit(x)
            assert eng.stats()["overloaded"] == 1
        finally:
            release.set()
            del pm.forward_bucket
            eng.close()
        for f in futs:
            assert f.result(10).scores.shape == (1, 1)

    def test_deadline_exceeded_is_typed(self, pair):
        mode, _, pm = pair
        x = _rows(mode, 1)
        real = pm.forward_bucket

        def slow(batch, bucket=None):
            time.sleep(0.3)
            return real(batch, bucket)

        eng = InferenceEngine(pm, ServeConfig(max_batch=1, deadline_ms=100,
                                              warmup=False))
        eng.start()
        pm.forward_bucket = slow
        try:
            first = eng.submit(x)
            time.sleep(0.05)         # the first is in its slow dispatch
            late = eng.submit(x)
            assert first.result(10).scores.shape == (1, 1)
            with pytest.raises(DeadlineExceeded):
                late.result(10)
            assert eng.stats()["timeouts"] == 1
        finally:
            del pm.forward_bucket
            eng.close()

    def test_malformed_requests_raise_value_error(self, pair):
        mode, _, pm = pair
        x = _rows(mode, 3)
        with InferenceEngine(pm, ServeConfig(max_batch=4,
                                             warmup=False)) as eng:
            bad = [
                dict(x, extra=x["dense"]),                       # unknown
                {"dense": x["dense"]},                           # missing
                dict(x, dense=x["dense"][:, :3]),                # shape
                dict(x, sparse=x["sparse"][:2]),                 # rows
                _rows(mode, 5),                                  # > max
                _slice(x, 0, 0),                                 # empty
            ]
            for req in bad:
                with pytest.raises(ValueError):
                    eng.submit(req)
            # (n, T) ids for a (n, T, 1) bag input reshape unambiguously
            ok = dict(x, sparse=x["sparse"][:, :, 0])
            assert eng.predict(ok, timeout=10).scores.shape == (3, 1)


def test_config_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.FFConfig()
    assert pt.FFConfig(device="cpu").device == "cpu"


def test_flags_parse_like_jax():
    cfg = pt.FFConfig.parse_args(
        ["--device", "cpu", "-b", "32", "--lr", "0.5", "--seed", "3",
         "--serve-max-batch", "128", "--serve-batching", "flush",
         "--serve-queue", "9", "--not-a-flag"])
    assert (cfg.batch_size, cfg.learning_rate, cfg.seed) == (32, 0.5, 3)
    sc = ServeConfig.from_config(cfg)
    assert (sc.max_batch, sc.queue_capacity, sc.continuous) == (128, 9,
                                                                 False)
    assert cfg.unparsed == ["--not-a-flag"]
    # the row cache is ported: its flags reach the engine's config
    sc = ServeConfig.from_config(pt.FFConfig.parse_args(
        ["--device", "cpu", "--serve-cache-rows", "8",
         "--serve-cache-warm", "hist.npz"]))
    assert (sc.cache_rows, sc.cache_warm) == (8, "hist.npz")
    argv = ["--arch-embedding-size", "5-6", "--arch-mlp-top", "12-4-1",
            "--arch-interaction-op", "dot", "--zipf-alpha", "1.1"]
    assert (vars(DLRMConfig.parse_args(argv))
            == vars(JaxDLRMConfig.parse_args(argv)))
    for preset in ("random_benchmark", "criteo_kaggle", "terabyte"):
        assert (vars(getattr(DLRMConfig, preset)())
                == vars(getattr(JaxDLRMConfig, preset)()))


def test_synthetic_batch_matches_jax():
    from dlrm_flexflow_tpu.models.dlrm import synthetic_batch as jax_batch
    cfg = DLRMConfig(**ARCH["cat"], zipf_alpha=1.05)
    jcfg = JaxDLRMConfig(**ARCH["cat"], zipf_alpha=1.05)
    (x, y), (jx, jy) = synthetic_batch(cfg, 8, 4), jax_batch(jcfg, 8, 4)
    for k in x:
        np.testing.assert_array_equal(x[k], jx[k])
    np.testing.assert_array_equal(y, jy)
