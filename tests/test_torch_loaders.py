"""The port's image and HDF5 loaders (``data/dataloader.py``:
``write_img_ffbin``, ``ImgDataLoader4D``, ``ImgDataLoader2D``,
``load_dlrm_hdf5``) against the JAX package's, on the CPU.

The same files (images from a numpy seed: 24 of 3 × 4 × 4, 5 classes;
a Criteo-layout HDF5 of 96 rows, 4 dense features, 4 tables) read by
both packages give the same arrays, BITWISE, batch by batch, shuffled
and not, through the .ffbin reader and from .npz / .npy; the staged
batches equal the host ones. Without h5py, ``load_dlrm_hdf5`` raises an
ImportError naming h5py and ``write_ffbin``. The launcher trains from an
.h5 file BITWISE as from the same data in an .npz.
"""

import sys

import numpy as np
import pytest
import torch

import dlrm_flexflow_tpu as ff
from dlrm_flexflow_tpu.data import dataloader as jax_loader

import dlrm_flexflow_tpu_torch as pt
from dlrm_flexflow_tpu_torch.core.optimizers import SGDOptimizer
from dlrm_flexflow_tpu_torch.data import dataloader as loader
from dlrm_flexflow_tpu_torch.examples.native import dlrm as launcher

from test_torch_launch import ARGS, _params

N, C, H, W, B = 24, 3, 4, 4, 4


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("img")
    r = np.random.RandomState(7)
    imgs = r.rand(N, C, H, W).astype(np.float32)
    labels = r.randint(0, 5, size=N)
    loader.write_img_ffbin(str(d / "port.ffbin"), imgs, labels)
    jax_loader.write_img_ffbin(str(d / "jax.ffbin"), imgs, labels)
    np.savez(d / "imgs.npz", images=imgs, labels=labels)
    np.save(d / "imgs.npy", imgs)
    np.save(d / "imgs_labels.npy", labels)
    return d, imgs, labels


def _jax_model():
    return ff.FFModel(ff.FFConfig(batch_size=B))


def _port_model(rank):
    m = pt.FFModel(pt.FFConfig(batch_size=B, device="cpu"))
    shape = (B, C, H, W) if rank == 4 else (B, C * H * W)
    t = m.create_tensor(shape, name="image")
    if rank == 4:
        t = m.reshape(t, (B, C * H * W))
    m.dense(t, 5, activation="softmax", name="fc")
    m.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
              ["accuracy"])
    return m


def test_img_ffbin_files_are_the_same_bytes(images):
    d, _, _ = images
    assert (d / "port.ffbin").read_bytes() == (d / "jax.ffbin").read_bytes()


@pytest.mark.parametrize("rank", [4, 2])
@pytest.mark.parametrize("src", ["port.ffbin", "imgs.npz", "imgs.npy"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_image_loaders_read_as_jax(images, rank, src, shuffle):
    d, imgs, labels = images
    kw = dict(batch_size=B, shuffle=shuffle, seed=3)
    if src.endswith(".ffbin") and rank == 4:
        kw["image_shape"] = (C, H, W)
    cls = loader.ImgDataLoader4D if rank == 4 else loader.ImgDataLoader2D
    jcls = (jax_loader.ImgDataLoader4D if rank == 4
            else jax_loader.ImgDataLoader2D)
    pm = _port_model(rank)
    mine = cls(pm, str(d / src), prefetch=False, **kw)
    theirs = jcls(_jax_model(), str(d / src), prefetch=False, **kw)
    staged = cls(pm, str(d / src), **kw)
    try:
        assert (mine.num_samples, mine.num_batches) == (
            theirs.num_samples, theirs.num_batches) == (N, N // B)
        assert tuple(mine.image_shape) == tuple(theirs.image_shape)
        for _ in range(2 * mine.num_batches):     # two epochs
            a, b = mine.next_host_batch(), theirs.next_host_batch()
            assert set(a) == set(b) == {"image", "label"}
            for k in a:
                assert a[k].dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))
            s = staged.next_batch()
            np.testing.assert_array_equal(s["image"].numpy(), a["image"])
            assert s["label"].dtype == torch.int64
            np.testing.assert_array_equal(s["label"].numpy(), a["label"])
    finally:
        for ld in (mine, theirs, staged):
            ld.close()


def test_image_loaders_refuse_what_jax_refuses(images):
    d, _, _ = images
    pm = _port_model(4)
    with pytest.raises(ValueError, match="image_shape"):
        loader.ImgDataLoader4D(pm, str(d / "port.ffbin"))
    with pytest.raises(ValueError, match="stored width"):
        loader.ImgDataLoader4D(pm, str(d / "port.ffbin"),
                               image_shape=(3, 4, 5))
    with pytest.raises(ValueError, match="unsupported"):
        loader.ImgDataLoader4D(pm, str(d / "imgs.bmp"))


def _write_h5(path, n=96, seed=4):
    import h5py
    r = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        f["X_int"] = np.log1p(r.randint(0, 100, size=(n, 4))).astype(
            np.float32)
        f["X_cat"] = r.randint(0, 64, size=(n, 4)).astype(np.int32)
        f["y"] = r.randint(0, 2, size=n).astype(np.float32)


def test_hdf5_reads_as_jax_and_trains_as_the_npz(tmp_path):
    path = str(tmp_path / "train.h5")
    _write_h5(path)
    x, y = loader.load_dlrm_hdf5(path)
    jx, jy = jax_loader.load_dlrm_hdf5(path)
    assert set(x) == set(jx) == {"dense", "sparse"}
    for k in x:
        assert x[k].dtype == jx[k].dtype and x[k].shape == jx[k].shape
        np.testing.assert_array_equal(x[k], jx[k])
    np.testing.assert_array_equal(y, jy)
    assert x["sparse"].shape == (96, 4, 1) and y.shape == (96, 1)
    np.savez(tmp_path / "train.npz", dense=x["dense"], sparse=x["sparse"],
             label=y)
    from_h5 = launcher.main(ARGS + ["--data-path", path])
    from_npz = launcher.main(ARGS + ["--data-path",
                                     str(tmp_path / "train.npz")])
    assert from_h5["steps"] == from_npz["steps"] == 2 * 6
    a, b = _params(from_h5), _params(from_npz)
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


def test_hdf5_without_h5py_names_it(tmp_path, monkeypatch):
    path = str(tmp_path / "train.h5")
    _write_h5(path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py") as e:
        loader.load_dlrm_hdf5(path)
    assert "write_ffbin" in str(e.value)
    with pytest.raises(ImportError, match="h5py"):
        launcher.main(ARGS + ["--data-path", path])
