"""The port stands alone: it imports neither JAX, nor ``ml_dtypes`` (the
GPU machine has none: fp8 goes through ``torch.float8_e4m3fn``), nor the
JAX package.

The test process has imported both already (tests/conftest.py imports
the JAX package for every test), so the import check runs in a fresh
subprocess. An AST scan of every source of the port, of
``chip_smoke.py`` and of ``tools/``, finds no import of either. A shard
server child (``serve/shard_server.py``'s boot and serve path) imports
neither and creates no CUDA context. ``chip_smoke.py`` run without a GPU
fails and prints no result.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dlrm_flexflow_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "dlrm_flexflow_tpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_import_leaves_jax_out():
    code = ("import sys, dlrm_flexflow_tpu_torch\n"
            "import dlrm_flexflow_tpu_torch.serve\n"
            "import dlrm_flexflow_tpu_torch.models.dlrm\n"
            "import dlrm_flexflow_tpu_torch.utils.weights\n"
            "import dlrm_flexflow_tpu_torch.core.losses\n"
            "import dlrm_flexflow_tpu_torch.core.metrics\n"
            "import dlrm_flexflow_tpu_torch.core.optimizers\n"
            "import dlrm_flexflow_tpu_torch.ops.kernels.scatter_rows\n"
            "import dlrm_flexflow_tpu_torch.ops.kernels.topk\n"
            "import dlrm_flexflow_tpu_torch.quant\n"
            "import dlrm_flexflow_tpu_torch.retrieve\n"
            "import dlrm_flexflow_tpu_torch.serve.shardtier\n"
            "import dlrm_flexflow_tpu_torch.serve.cache\n"
            "import dlrm_flexflow_tpu_torch.utils.warmcache\n"
            "import dlrm_flexflow_tpu_torch.models.nmt\n"
            "import dlrm_flexflow_tpu_torch.ops.rnn\n"
            "import dlrm_flexflow_tpu_torch.ops.elementwise\n"
            "import dlrm_flexflow_tpu_torch.ops.kernels.lstm\n"
            "import dlrm_flexflow_tpu_torch.ops.kernels.dense_update\n"
            "import dlrm_flexflow_tpu_torch.data.prefetch\n"
            "import dlrm_flexflow_tpu_torch.data.stream\n"
            "import dlrm_flexflow_tpu_torch.data.replay\n"
            "import dlrm_flexflow_tpu_torch.utils.faults\n"
            "import dlrm_flexflow_tpu_torch.utils.profiling\n"
            "import dlrm_flexflow_tpu_torch.utils.checkpoint\n"
            "import dlrm_flexflow_tpu_torch.examples.native.dlrm\n"
            "import dlrm_flexflow_tpu_torch.examples.native.serve_dlrm\n"
            "import dlrm_flexflow_tpu_torch.obs.drift\n"
            "import dlrm_flexflow_tpu_torch.utils.delta\n"
            "import dlrm_flexflow_tpu_torch.utils.histogram\n"
            "import dlrm_flexflow_tpu_torch.serve.watcher\n"
            "import dlrm_flexflow_tpu_torch.ops.batch_matmul\n"
            "import dlrm_flexflow_tpu_torch.ops.tensor_ops\n"
            "import dlrm_flexflow_tpu_torch.ops.embedding\n"
            "import dlrm_flexflow_tpu_torch.native\n"
            "import dlrm_flexflow_tpu_torch.serve.wire\n"
            "import dlrm_flexflow_tpu_torch.serve.transport\n"
            "import dlrm_flexflow_tpu_torch.serve.shard_server\n"
            "import dlrm_flexflow_tpu_torch.serve.fleet\n"
            "import dlrm_flexflow_tpu_torch.serve.router\n"
            "import dlrm_flexflow_tpu_torch.serve.autoscale\n"
            "import dlrm_flexflow_tpu_torch.utils.watchdog\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [REPO / "chip_smoke.py"]
    + list((REPO / "tools").glob("*.py"))),
    ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_a_shard_server_child_imports_no_jax(tmp_path):
    from dlrm_flexflow_tpu_torch.serve import EmbeddingShardSet

    from test_torch_shardtier import _port
    EmbeddingShardSet.seed_shard_cache(_port(), 1, str(tmp_path))
    code = ("import sys, torch\n"
            "from dlrm_flexflow_tpu_torch.serve import shard_server\n"
            f"shard = shard_server.build_shard({str(tmp_path)!r}, 1, 0)\n"
            "shard.serve().close()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_initialized()\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_without_gpu_fails_without_result():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok"), line
