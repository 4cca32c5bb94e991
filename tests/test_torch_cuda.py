"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (the kernels have no CPU mode). The file imports
nothing of JAX, so it also runs on a machine without JAX, where the
repository's conftest (which imports the JAX package) is left out:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: the bag sums in fp32 in bag order on both sides (rtol, atol
1e-6); the interaction's dots and layer products sum in another fp32
order than torch's bmm and matmul (1e-5). The scatter kernels are held
BITWISE to their plain versions run on the CPU (the plain version on the
card would add duplicates with atomics, in no fixed order): both scale
first, then sum a row's duplicates in lookup order. A training step on
the card against the same step on the CPU: rtol 1e-5, atol 1e-7
(cuBLAS and the CPU's BLAS sum the layers' products in other orders).
"""

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.ops.kernels import build
from dlrm_flexflow_tpu_torch.ops.kernels.embedding_bag import (
    embedding_bag, embedding_bag_reference)
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.ops.kernels.interaction import (
    fused_interaction, fused_interaction_reference)
from dlrm_flexflow_tpu_torch.ops.kernels.scatter_rows import (
    scatter_add_rows, scatter_add_rows_reference, scatter_write_rows,
    scatter_write_rows_reference)
from dlrm_flexflow_tpu_torch.serve import InferenceEngine, ServeConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("aggr", ["sum", "avg"])
@pytest.mark.parametrize("n,bag,d", [(16384, 1, 64), (1000, 3, 64),
                                     (77, 2, 132)])
def test_bag_kernel_matches_plain(cuda, aggr, n, bag, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn(4096, d, device=cuda, generator=g)
    ids = torch.randint(0, 4096, (n, bag), device=cuda, generator=g)
    before = embedding_bag.launches
    got = embedding_bag(table, ids, aggr)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    torch.testing.assert_close(got, embedding_bag_reference(table, ids, aggr),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("batch,T,bag,d,H", [(2048, 8, 1, 64, 1024),
                                             (37, 8, 3, 64, 300),
                                             (5, 3, 2, 128, 16)])
def test_interaction_kernel_matches_plain(cuda, relu, batch, T, bag, d, H):
    g = torch.Generator(device=cuda).manual_seed(1)
    rows = 500
    P = (T + 1) * T // 2
    table = 0.5 * torch.randn(T * rows, d, device=cuda, generator=g)
    idx = (torch.randint(0, rows, (batch, T, bag), device=cuda, generator=g)
           + (torch.arange(T, device=cuda) * rows)[None, :, None])
    bottom = 0.5 * torch.randn(batch, d, device=cuda, generator=g)
    w = torch.randn(d + P, H, device=cuda, generator=g) / (d + P) ** 0.5
    bias = 0.1 * torch.randn(H, device=cuda, generator=g)
    before = fused_interaction.launches
    got = fused_interaction(table, idx, bottom, w, bias, relu)
    torch.cuda.synchronize()
    assert fused_interaction.launches == before + 1
    torch.testing.assert_close(
        got, fused_interaction_reference(table, idx, bottom, w, bias, relu),
        rtol=1e-5, atol=1e-5)


def test_bag_kernel_returns_the_gathered_rows(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    table = torch.randn(4096, 64, device=cuda, generator=g)
    ids = torch.randint(0, 4096, (300, 3), device=cuda, generator=g)
    out, rows = embedding_bag(table, ids, "sum", return_rows=True)
    torch.cuda.synchronize()
    assert torch.equal(rows, table[ids.reshape(-1)])
    torch.testing.assert_close(out, embedding_bag_reference(table, ids),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("write", [False, True])
@pytest.mark.parametrize("n,div", [(2048, 1), (16384, 1), (771, 3)])
def test_scatter_kernels_match_plain(cuda, write, n, div):
    g = torch.Generator(device=cuda).manual_seed(n)
    table = torch.randn(50000, 64, device=cuda, generator=g)
    ids = torch.randint(0, 50000, (n,), device=cuda, generator=g)
    ids[:8] = ids[0]
    ids[8:12] = ids[9]
    upd = torch.randn(n // div, 64, device=cuda, generator=g)
    fwd = table[ids]
    kernel = scatter_write_rows if write else scatter_add_rows
    before = kernel.launches
    got = table.clone()
    if write:
        kernel(got, ids, upd, fwd, scale=-0.01, div=div)
        want = scatter_write_rows_reference(
            table.cpu(), ids.cpu(), upd.cpu(), fwd.cpu(), -0.01, div)
    else:
        kernel(got, ids, upd, scale=-0.01, div=div)
        want = scatter_add_rows_reference(table.cpu(), ids.cpu(),
                                          upd.cpu(), -0.01, div)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_cuda_call_raises_without_nvcc(cuda, tmp_path, monkeypatch):
    """No library and no compiler: a CUDA call raises, it never falls
    back to the plain version."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        embedding_bag(torch.zeros(16, 8, device=cuda),
                      torch.zeros(2, 1, dtype=torch.int64, device=cuda))


ARCH = {
    "cat": dict(embedding_size=[512] * 4, sparse_feature_size=64,
                mlp_bot=[8, 32, 64], mlp_top=[64 + 4 * 64, 32, 16, 1],
                arch_interaction_op="cat"),
    "dot": dict(embedding_size=[512] * 4, sparse_feature_size=64,
                mlp_bot=[8, 32, 64], mlp_top=[64 + 10, 32, 16, 1],
                arch_interaction_op="dot"),
}


def _model(mode, device, params=None):
    m = pt.FFModel(pt.FFConfig(batch_size=16, device=device, seed=3))
    build_dlrm(m, DLRMConfig(**ARCH[mode]), fuse_interaction=mode == "dot")
    m.compile()
    if params is None:
        m.init_layers()
    else:
        m.swap_params({op: {n: v.to(device) for n, v in p.items()}
                       for op, p in params.items()})
    return m


@pytest.mark.parametrize("mode", ["cat", "dot"])
def test_model_on_card_matches_cpu_and_serves(cuda, mode):
    gpu = _model(mode, "cuda")
    cpu = _model(mode, "cpu", gpu.params)
    x, _ = synthetic_batch(DLRMConfig(**ARCH[mode]), 40, seed=2)
    np.testing.assert_allclose(gpu.forward_batch(x).cpu().numpy(),
                               cpu.forward_batch(x).numpy(),
                               rtol=1e-5, atol=1e-6)
    kernel = fused_interaction if mode == "dot" else embedding_bag
    before = kernel.launches
    with InferenceEngine(gpu, ServeConfig(max_batch=16)) as eng:
        futs = [(a, eng.submit({k: v[a:a + 5] for k, v in x.items()}))
                for a in range(0, 40, 5)]
        res = [(a, f.result(60)) for a, f in futs]
    assert kernel.launches > before
    for a, r in res:
        want = gpu.forward_batch({k: v[a:a + 5] for k, v in x.items()})
        np.testing.assert_allclose(r.scores, want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["cat", "dot"])
def test_training_step_on_card_matches_cpu(cuda, mode):
    gpu = _model(mode, "cuda")
    cpu = _model(mode, "cpu", gpu.params)
    for m in (gpu, cpu):
        m.compile(SGDOptimizer(lr=0.05), "mean_squared_error", ["mse"])
    x, y = synthetic_batch(DLRMConfig(**ARCH[mode]), 16, seed=5)
    x["label"] = y
    kernel = scatter_add_rows if mode == "dot" else scatter_write_rows
    before = kernel.launches
    lg = float(gpu.train_batch(x)["loss"])
    lc = float(cpu.train_batch(x)["loss"])
    assert kernel.launches == before + 1
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for op, p in cpu.params.items():
        for pn, v in p.items():
            torch.testing.assert_close(gpu.params[op][pn].cpu(), v,
                                       rtol=1e-5, atol=1e-7)
