"""The port's data loaders against the JAX package's.

- ``write_ffbin`` writes the same bytes as the JAX package's;
- the port's ``FFBinDataLoader`` (its own build of ``native/ffloader.cc``)
  and ``SingleDataLoader`` deliver the JAX loaders' host batches, BITWISE
  and in the same order, shuffled from a seed and not, with prefetch on
  and off, across epoch boundaries;
- ``state``/``set_state`` of the ``SingleDataLoader`` round-trip through
  JSON and equal the JAX loader's state at the same position;
- a batch staged by the port (``next_batch``) holds the host batch's
  values in the model's dtypes;
- transient read errors are absorbed, a bad file or shape raises, and
  the native build writes only under ``build/native`` and raises without
  a compiler.

The models are stubs holding the config fields the loaders read, except
where a batch is staged.
"""

import json
import time
import types

import numpy as np
import pytest
import torch

from dlrm_flexflow_tpu.data import dataloader as jax_dl

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch import native
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.data import dataloader as dl
from dlrm_flexflow_tpu_torch.models.dlrm import (DLRMConfig, build_dlrm,
                                                 synthetic_batch)
from dlrm_flexflow_tpu_torch.utils import faults

ARCH = dict(embedding_size=[50] * 3, sparse_feature_size=4,
            embedding_bag_size=2, mlp_bot=[5, 8, 4], mlp_top=[16, 8, 1])
BS = 8


def _stub(depth=2):
    """What the loaders read of a model when only host batches are taken
    (the ring of a SingleDataLoader stages each batch all the same)."""
    return types.SimpleNamespace(
        config=types.SimpleNamespace(batch_size=BS, prefetch_depth=depth),
        _stage_step=lambda batch: None, _device_batch=lambda batch: None)


def _data(n, seed=1):
    x, y = synthetic_batch(DLRMConfig(**ARCH), n, seed=seed)
    return x, y


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("bag", [1, 2])
def test_write_ffbin_is_byte_identical(tmp_path, bag):
    x, y = _data(21)
    sparse = x["sparse"][:, :, :bag]
    if bag == 1:
        sparse = sparse[:, :, 0]                     # (n, T)
    dl.write_ffbin(str(tmp_path / "port.ffbin"), x["dense"], sparse, y)
    jax_dl.write_ffbin(str(tmp_path / "jax.ffbin"), x["dense"], sparse, y)
    assert ((tmp_path / "port.ffbin").read_bytes()
            == (tmp_path / "jax.ffbin").read_bytes())


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_ffbin_loader_delivers_jax_batches(tmp_path, shuffle, prefetch):
    """30 samples in batches of 8: 4 batches an epoch, the last wrapping
    within the epoch, over 3 epochs (each reshuffled)."""
    x, y = _data(30)
    path = str(tmp_path / "d.ffbin")
    dl.write_ffbin(path, x["dense"], x["sparse"], y)
    kw = dict(shuffle=shuffle, seed=7, sparse_shape=(3, 2),
              prefetch=prefetch)
    mine = dl.FFBinDataLoader(_stub(), path, **kw)
    ref = jax_dl.FFBinDataLoader(_stub(), path, **kw)
    try:
        assert (mine.num_samples, mine.dense_dim, mine.num_batches) == (
            ref.num_samples, ref.dense_dim, ref.num_batches) == (30, 5, 4)
        got = [mine.next_host_batch() for _ in range(12)]
        for i, g in enumerate(got):
            _same(g, ref.next_host_batch())
        if not shuffle:   # the file's own order, wrapping in the epoch
            np.testing.assert_array_equal(got[0]["dense"],
                                          x["dense"][:BS])
            wrap = [(3 * BS + r) % 30 for r in range(BS)]
            np.testing.assert_array_equal(got[3]["dense"], x["dense"][wrap])
        else:             # each epoch a permutation of the samples
            seen = np.concatenate([g["dense"] for g in got[:4]])[:30]
            assert sorted(map(tuple, seen)) == sorted(map(tuple,
                                                          x["dense"]))
    finally:
        mine.close()
        ref.close()


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_single_loader_delivers_jax_batches(shuffle, prefetch):
    x, y = _data(44)
    inputs = {"dense": x["dense"], "sparse": x["sparse"]}
    mine = dl.SingleDataLoader(_stub(), inputs, y, shuffle=shuffle,
                               seed=3, prefetch=prefetch)
    ref = jax_dl.SingleDataLoader(_stub(), inputs, y, shuffle=shuffle,
                                  seed=3, prefetch=prefetch)
    try:
        for _ in range(13):       # 5 batches an epoch: two reshuffles
            _same(mine.next_host_batch(), ref.next_host_batch())
        mine.reset()
        ref.reset()
        for _ in range(3):
            _same(mine.next_host_batch(), ref.next_host_batch())
    finally:
        mine.close()
        ref._close_pipe()


def test_single_loader_state_round_trips_and_matches_jax():
    x, y = _data(44)
    inputs = {"dense": x["dense"], "sparse": x["sparse"]}
    mine = dl.SingleDataLoader(_stub(), inputs, y, shuffle=True, seed=3)
    ref = jax_dl.SingleDataLoader(_stub(), inputs, y, shuffle=True, seed=3)
    for _ in range(9):            # the last batch of epoch 1 (5 an epoch)
        mine.next_host_batch()
        ref.next_host_batch()
    # the ring has staged into epoch 2, whose shuffle moved the RNG on:
    # the state must still be epoch 1's
    deadline = time.time() + 5
    while mine._pipe._produced < 11 and time.time() < deadline:
        time.sleep(0.005)
    assert mine._pipe._produced == 11
    state = json.loads(json.dumps(mine.state()))   # JSON-safe
    assert state == json.loads(json.dumps(ref.state()))
    want = [mine.next_host_batch() for _ in range(9)]
    again = dl.SingleDataLoader(_stub(), inputs, y, shuffle=True, seed=99)
    again.set_state(state)
    jax_again = jax_dl.SingleDataLoader(_stub(), inputs, y, shuffle=True,
                                        seed=99)
    jax_again.set_state(state)
    for w in want:
        g = again.next_host_batch()
        _same(w, g)
        _same(g, jax_again.next_host_batch())
    for loader in (mine, again):
        loader.close()
    for loader in (ref, jax_again):
        loader._close_pipe()
    with pytest.raises(ValueError, match="smaller than one batch"):
        dl.SingleDataLoader(_stub(), inputs, y[:3], batch_size=4 * 44)


def test_staged_batches_hold_the_host_values(tmp_path):
    m = pt.FFModel(pt.FFConfig(batch_size=BS, device="cpu"))
    build_dlrm(m, DLRMConfig(**ARCH))
    m.compile(SGDOptimizer(lr=0.1), "mean_squared_error", ["mse"])
    m.init_layers()
    x, y = _data(24)
    path = str(tmp_path / "d.ffbin")
    dl.write_ffbin(path, x["dense"], x["sparse"], y)
    staged = dl.FFBinDataLoader(m, path, shuffle=True, seed=2,
                                sparse_shape=(3, 2))
    host = dl.FFBinDataLoader(m, path, shuffle=True, seed=2,
                              sparse_shape=(3, 2), prefetch=False)
    try:
        for _ in range(5):
            db, hb = staged.next_batch(), host.next_host_batch()
            assert db["sparse"].dtype == torch.int64
            assert db["label"].dtype == torch.float32
            for k in ("dense", "sparse", "label"):
                np.testing.assert_array_equal(db[k].numpy(),
                                              hb[k].astype(db[k].numpy(
                                              ).dtype))
            m.train_batch_device(db)
    finally:
        staged.close()
        host.close()


def test_read_errors_retry_then_raise(tmp_path):
    x, y = _data(16)
    path = str(tmp_path / "d.ffbin")
    dl.write_ffbin(path, x["dense"], x["sparse"], y)
    with faults.active_plan(
            faults.FaultPlan(io_errors={"ffbin_read": 2})) as plan:
        loader = dl.FFBinDataLoader(_stub(), path, sparse_shape=(3, 2),
                                    prefetch=False, io_backoff_s=0.001)
        np.testing.assert_array_equal(loader.next_host_batch()["dense"],
                                      x["dense"][:BS])
        loader.close()
    assert [h for h, _ in plan.fired] == ["io_error", "io_error"]
    with faults.active_plan(
            faults.FaultPlan(io_errors={"ffbin_read": 3})):
        loader = dl.FFBinDataLoader(_stub(), path, sparse_shape=(3, 2),
                                    prefetch=False, io_retries=2,
                                    io_backoff_s=0.001)
        with pytest.raises(IOError, match="injected"):
            loader.next_host_batch()
        loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.next_host_batch()


def test_bad_files_and_shapes_raise(tmp_path):
    x, y = _data(16)
    path = str(tmp_path / "d.ffbin")
    dl.write_ffbin(path, x["dense"], x["sparse"], y)
    with pytest.raises(ValueError, match="sparse_shape"):
        dl.FFBinDataLoader(_stub(), path, sparse_shape=(4, 2))
    bad = tmp_path / "bad.ffbin"
    bad.write_bytes(b"FFB2" + bytes(64))
    with pytest.raises(IOError, match="cannot open"):
        dl.FFBinDataLoader(_stub(), str(bad))
    with pytest.raises(IOError, match="cannot open"):
        dl.FFBinDataLoader(_stub(), str(tmp_path / "missing.ffbin"))


def test_native_build_location_and_missing_compiler(tmp_path, monkeypatch):
    lib = native.get_lib()
    assert native.library_path().exists()
    assert native.library_path().parent.parts[-2:] == ("build", "native")
    assert lib is native.get_lib()
    out = tmp_path / "libffloader-x.so"
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native._build(out)
    assert list(tmp_path.iterdir()) == []
