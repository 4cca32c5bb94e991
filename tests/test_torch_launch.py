"""The port's DLRM launcher, ``python -m
dlrm_flexflow_tpu_torch.examples.native.dlrm``, on the CPU at a tiny size:
from an ``.ffbin`` file with prefetch and without, from an ``.npz``, and
from one synthetic batch; the same data in the same order gives BITWISE
the same trained weights whatever the source and the staging. Every
flag whose module is not ported raises, naming its ROADMAP item; the
flags of items since ported (``--host-tables``, ``--arch-interaction-op
dot``) train, ``--import`` reads a strategy file (a missing one raises
the codec's error naming it), ``-ll:gpu 8`` and ``--nodes 2`` train on
one rank without a process group, as the JAX launcher does on a
one-chip host, and the Criteo-Kaggle flags train on non-uniform tables.
A multi-process environment without an address to meet at raises.
"""

import numpy as np
import pytest
import torch

from dlrm_flexflow_tpu_torch.data.dataloader import write_ffbin
from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher
from dlrm_flexflow_tpu_torch.models.dlrm import DLRMConfig, synthetic_batch

ARGS = ["--device", "cpu", "-b", "16", "-e", "2", "--lr", "0.05",
        "--arch-embedding-size", "64-64-64-64",
        "--arch-sparse-feature-size", "8", "--arch-mlp-bot", "4-16-8",
        "--arch-mlp-top", "40-16-1"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    cfg = DLRMConfig(embedding_size=[64] * 4, sparse_feature_size=8,
                     mlp_bot=[4, 16, 8], mlp_top=[40, 16, 1])
    x, y = synthetic_batch(cfg, 96, seed=4)
    write_ffbin(str(d / "train.ffbin"), x["dense"], x["sparse"], y)
    np.savez(d / "train.npz", dense=x["dense"], sparse=x["sparse"], label=y)
    return d


def _params(out):
    return {(op, pn): v.clone() for op, p in out["model"].params.items()
            for pn, v in p.items()}


def test_trains_from_ffbin_npz_and_synthetic(files, capsys):
    runs = {}
    for name, extra in (
            ("ffbin", ["--data-path", str(files / "train.ffbin")]),
            ("ffbin, no prefetch", ["--data-path",
                                    str(files / "train.ffbin"),
                                    "--no-prefetch"]),
            ("ffbin, depth 4", ["--data-path", str(files / "train.ffbin"),
                                "--prefetch-depth", "4"]),
            ("npz", ["--data-path", str(files / "train.npz")])):
        out = launcher.main(ARGS + extra)
        assert out["steps"] == 2 * 6 and out["num_samples"] == 2 * 96
        assert out["throughput"] > 0
        assert out["model"].config.prefetch_depth == (
            0 if "no prefetch" in name else 4 if "4" in name else 2)
        runs[name] = _params(out)
    printed = capsys.readouterr().out
    assert printed.count("THROUGHPUT = ") == 4
    assert printed.count(" samples/s") == 4
    first = runs.pop("ffbin")
    for name, params in runs.items():
        for k, v in first.items():
            assert torch.equal(v, params[k]), (name, k)
    out = launcher.main(ARGS)                       # synthetic
    assert out["steps"] == 2 * 64
    assert all(torch.isfinite(v).all() for v in _params(out).values())
    assert np.isfinite(out["model"].perf.report()["mse"])


def test_sparse_ids_past_the_tables_raise(files, tmp_path):
    with np.load(files / "train.npz") as z:
        data = dict(z)
    data["sparse"][3, 2, 0] = 64
    np.savez(tmp_path / "bad.npz", **data)
    with pytest.raises(ValueError, match="table 2: max categorical index 64"):
        launcher.main(ARGS + ["--data-path", str(tmp_path / "bad.npz")])


@pytest.mark.parametrize("flags,item", [
    (["--budget", "10"], "item 8"),
    (["--import", "best.pb"], "item 8"),
    (["--export", "best.pb"], "item 8"),
    (["-ll:gpu", "8"], "item 7"),
    (["--nodes", "2"], "item 7"),
    (["--profiling"], "item 6"),
    (["--superstep", "4"], "item 6"),
    (["--debug-nans"], "item 6"),
    (["--debug-nans", "--profiling"], "item 6"),
    (["--host-tables"], "item 2.4"),
    (["--arch-interaction-op", "dot"], "item 4"),
])
def test_unported_flags_raise_with_their_item(flags, item):
    if flags[0] == "--import":
        # strategy files are ported (item 7): a missing one raises the
        # codec's own error, naming the file
        with pytest.raises(FileNotFoundError, match="best.pb"):
            launcher.main(ARGS + flags)
        return
    if item == "item 7":
        # devices come from the process group (item 7): without one the
        # world is one rank, and the run is the run without the flag
        out = launcher.main(ARGS + flags)
        cfg = out["model"].config
        assert out["model"].mesh.size == 1
        assert (cfg.workers_per_node, cfg.num_nodes) == (
            (8, 1) if flags[0] == "-ll:gpu" else (0, 2))
        plain = _params(launcher.main(ARGS))
        got = _params(out)
        assert set(got) == set(plain)
        assert all(torch.equal(got[k], plain[k]) for k in plain)
        return
    if item in ("item 2.4", "item 4"):
        # host-resident tables (item 2.4) and the unfused "dot"
        # interaction (item 4) are ported: the launcher trains with them
        args = list(ARGS)
        if item == "item 4":
            args[args.index("40-16-1")] = "18-16-1"  # 8 + 5·4/2 features
        out = launcher.main(args + flags)
        model = out["model"]
        assert out["steps"] == 2 * 64 and out["throughput"] > 0
        assert np.isfinite(model.perf.report()["mse"])
        if item == "item 2.4":
            assert [op.name for op in model._host_resident_list] == [
                "emb_stack"]
            assert model._host_scatter_thread is None   # drained
            assert np.isfinite(model.host_params["emb_stack"]["kernel"]).all()
        else:
            model.get_layer_by_name("interaction_bmm")
        return
    with pytest.raises(NotImplementedError, match=item):
        launcher.main(ARGS + flags)


def test_the_serving_fleet_flags_train_unchanged(files):
    """The fleet's flags (item 9.4) are parsed and leave training alone,
    as the JAX launcher does: the same run with and without them trains
    the same weights bitwise."""
    extra = ["--data-path", str(files / "train.ffbin"), "--no-prefetch"]
    fleet = ["--serve-replicas", "2", "--serve-retries", "3",
             "--serve-canary-fraction", "0.2", "--serve-slo-ms", "20",
             "--serve-min-replicas", "1", "--serve-max-replicas", "4"]
    plain = _params(launcher.main(ARGS + extra))
    out = launcher.main(ARGS + extra + fleet)
    cfg = out["model"].config
    assert (cfg.serve_replicas, cfg.serve_retries, cfg.serve_slo_ms,
            cfg.serve_max_replicas) == (2, 3, 20.0, 4)
    got = _params(out)
    assert set(got) == set(plain)
    assert all(torch.equal(got[k], plain[k]) for k in plain)


def test_multi_host_launch_raises(monkeypatch):
    """A multi-process launch is ported (item 7), but two processes with
    no address to meet at raise, naming the variable that is missing."""
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        launcher.main(ARGS)


CRITEO_SHAPED = ["--device", "cpu", "-b", "16", "-e", "1", "--lr", "0.05",
                 "--arch-embedding-size", "1396-550-24-687-20-3",
                 "--arch-sparse-feature-size", "16",
                 "--arch-mlp-bot", "13-64-16", "--arch-mlp-top",
                 "112-32-1"]


@pytest.mark.parametrize("extra", [[], ["--host-tables"],
                                   ["--host-tables", "--no-host-tables-async"],
                                   ["--arch-interaction-op", "dot"]])
def test_trains_criteo_shaped_flags(extra):
    """Non-uniform tables, as ``run_criteo_kaggle.sh`` passes them (at
    small sizes), train as one concatenated table, on the device or in
    host RAM."""
    args = list(CRITEO_SHAPED)
    if "dot" in extra:
        args[args.index("112-32-1")] = "37-32-1"    # 16 + 7·6/2
    out = launcher.main(args + extra)
    model = out["model"]
    assert out["steps"] == 64 and out["throughput"] > 0
    assert np.isfinite(model.perf.report()["mse"])
    host = "--host-tables" in extra
    assert ("emb_concat" in model.host_params) == host
    assert ("emb_concat" in model.params) == (not host)
    if host:
        assert model.config.host_tables_async == (
            "--no-host-tables-async" not in extra)
        assert model.host_params["emb_concat"]["kernel"].shape == (8192, 16)
