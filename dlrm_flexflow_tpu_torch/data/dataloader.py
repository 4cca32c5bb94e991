"""Data loaders (the port of ``dlrm_flexflow_tpu.data.dataloader``).

The dataset stays in host memory as numpy (or mmap'd by the native
``.ffbin`` reader); ``next_batch`` hands back one batch on the model's
device. Staging runs through the depth-K prefetch ring
(``data/prefetch.py``): a background thread slices batch N+1..N+K and
copies it to the card (pinned memory, a side CUDA stream) while the
device trains batch N. ``FFConfig.prefetch_depth`` sets K (0 stages in
the consumer's thread); ``state()``/``reset()``/``set_state()`` drain the
ring first, so prefetching never changes the delivered sequence.

Image datasets (``write_img_ffbin``, ``ImgDataLoader4D``,
``ImgDataLoader2D``) ride the same ``.ffbin`` reader and ring, or load
``.npz`` / ``.npy`` into memory; ``load_dlrm_hdf5`` reads a Criteo HDF5
file. All return the JAX loaders' arrays.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from ..utils import faults
from ..utils.logging import get_logger

log_data = get_logger("data")


def read_with_retries(fn: Callable, site: str, retries: int = 3,
                      backoff_s: float = 0.05):
    """Run a read, absorbing up to `retries` transient IOError/OSErrors
    with exponential backoff. Each attempt first gives the fault harness
    (``utils.faults``) a chance to inject an error at `site`."""
    for attempt in range(retries + 1):
        try:
            faults.maybe_io_error(site)
            return fn()
        except (IOError, OSError) as e:
            if attempt >= retries:
                raise
            delay = backoff_s * (2 ** attempt)
            log_data.warning(
                "transient read error at %s (attempt %d/%d): %s — "
                "retrying in %.0f ms", site, attempt + 1, retries, e,
                1e3 * delay)
            time.sleep(delay)


def coalesce_batches(batches):
    """Concatenate a list of same-keyed host feature dicts along the
    sample dim into ONE batch — the serving engine's request
    coalescing. Ragged keys or per-sample shapes/dtypes fail here with
    the offending key."""
    if not batches:
        raise ValueError("coalesce_batches needs at least one batch")
    keys = set(batches[0])
    for i, b in enumerate(batches[1:], 1):
        if set(b) != keys:
            raise ValueError(
                f"batch {i} keys {sorted(b)} differ from batch 0 keys "
                f"{sorted(keys)}; coalesced requests must be homogeneous")
    out = {}
    for k in batches[0]:
        arrs = [np.asarray(b[k]) for b in batches]
        if any(a.shape[1:] != arrs[0].shape[1:] or a.dtype != arrs[0].dtype
               for a in arrs[1:]):
            raise ValueError(
                f"input {k!r} has ragged per-sample shapes/dtypes across "
                f"requests; cannot coalesce into one batch")
        out[k] = (arrs[0] if len(arrs) == 1
                  else np.concatenate(arrs, axis=0))
    return out


def pad_batch_rows(batch, rows: int):
    """Zero-pad every array's sample dim up to `rows` (the serving
    bucket). Zeros are in-domain: float features pad with 0.0, ids with
    row 0; the padded samples' outputs are discarded by
    ``FFModel.forward_bucket``."""
    n = int(next(iter(batch.values())).shape[0])
    if rows < n:
        raise ValueError(f"pad_batch_rows: target {rows} < batch rows {n}")
    if rows == n:
        return batch
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        pad = np.zeros((rows - n,) + v.shape[1:], v.dtype)
        out[k] = np.concatenate([v, pad], axis=0)
    return out


_ZIPF_CDF_CACHE: Dict[tuple, np.ndarray] = {}


def zipf_indices(rng: np.random.RandomState, rows: int, size,
                 alpha: float) -> np.ndarray:
    """Draw ids in [0, rows) with p(k) ∝ 1/(k+1)^alpha via the inverse
    CDF (cached per (rows, alpha)). alpha <= 0 draws uniformly with
    ``rng.randint``, so seeded data match the JAX package's draws."""
    if alpha <= 0.0:
        return rng.randint(0, rows, size=size)
    key = (int(rows), float(alpha))
    cdf = _ZIPF_CDF_CACHE.get(key)
    if cdf is None:
        p = 1.0 / np.power(np.arange(1, rows + 1, dtype=np.float64),
                           float(alpha))
        cdf = np.cumsum(p)
        cdf /= cdf[-1]
        _ZIPF_CDF_CACHE[key] = cdf
    n = int(np.prod(size))
    draws = np.searchsorted(cdf, rng.random_sample(n), side="right")
    return draws.reshape(size).astype(np.int64)


def rank_window(model, batch_size: int):
    """(first row, rows) of each global batch of ``batch_size`` that this
    rank trains on: rank r of a mesh of W ranks holds rows [r·b, (r+1)·b),
    b = batch_size / W (``parallel.distributed.host_local_slice``); (0,
    batch_size) on one rank."""
    mesh = getattr(model, "mesh", None)
    if mesh is None or mesh.size == 1:
        return 0, batch_size
    from ..parallel import distributed
    model._dist()        # the mesh must be the process group
    if batch_size % mesh.size:
        raise ValueError(f"global batch {batch_size} does not divide over "
                         f"{mesh.size} ranks")
    b = batch_size // mesh.size
    return mesh.ranks.index(distributed.rank()) * b, b


def _config_depth(model, depth: Optional[int]) -> int:
    if depth is not None:
        return max(int(depth), 0)
    cfg = getattr(model, "config", None)
    return max(int(getattr(cfg, "prefetch_depth", 2) or 0), 0)


class SingleDataLoader:
    """Cycles a dict of full host arrays in batches.

    Staging runs through the prefetch ring: which samples land in batch
    ordinal i is a deterministic function of the seed, so the staging
    thread can slice and copy ahead without changing the delivered
    sequence; per-epoch shuffle orders are cached with their RNG
    snapshots, so ``state()`` captures the exact resume point even while
    the ring holds batches of the next epoch.

    Across ranks ``batch_size`` is the global batch and each rank's
    loader hands back its rows of each (``rank_window``), shuffled by the
    same permutation on every rank (the same seed): the ranks' batches,
    joined in rank order, are the one-rank loader's."""

    def __init__(self, model, inputs: Dict[str, np.ndarray],
                 labels: np.ndarray, batch_size: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0,
                 prefetch: bool = True, depth: Optional[int] = None):
        self.model = model
        self.inputs = dict(inputs)
        self.labels = labels
        self.batch_size = batch_size or model.config.batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.num_samples = len(labels)
        self.num_batches = self.num_samples // self.batch_size
        self._lo, self._rows = rank_window(model, self.batch_size)
        # the model stages the batches as a rank's rows
        self._kw = {"local": True} if self._rows != self.batch_size else {}
        if self.num_batches == 0:
            raise ValueError(
                f"dataset ({self.num_samples}) smaller than one batch "
                f"({self.batch_size})")
        order = np.arange(self.num_samples)
        if self.shuffle:
            self.rng.shuffle(order)
        # per-epoch orders, computed lazily in sequence by whichever
        # thread asks first, each with its post-shuffle RNG snapshot
        self._orders: Dict[int, np.ndarray] = {0: order}
        self._rng_states: Dict[int, tuple] = {0: self.rng.get_state()}
        self._max_epoch = 0
        self._sched_lock = threading.Lock()
        self._idx = 0      # batches consumed (absolute ordinal)
        self._depth = _config_depth(model, depth)
        self._prefetch = bool(prefetch) and self._depth > 0
        self._pipe = None

    # --- schedule -------------------------------------------------------
    def _epoch_order(self, e: int) -> np.ndarray:
        with self._sched_lock:
            while self._max_epoch < e:
                nxt = self._orders[self._max_epoch]
                if self.shuffle:
                    nxt = nxt.copy()
                    self.rng.shuffle(nxt)
                self._max_epoch += 1
                self._orders[self._max_epoch] = nxt
                self._rng_states[self._max_epoch] = self.rng.get_state()
            return self._orders[e]

    def _consumed_epoch(self) -> int:
        return (self._idx - 1) // self.num_batches if self._idx > 0 else 0

    def _prune_epochs(self):
        ce = self._consumed_epoch()
        with self._sched_lock:
            for e in [e for e in self._orders if e < ce]:
                del self._orders[e]
                del self._rng_states[e]

    def _host_batch_at(self, ordinal: int) -> Dict[str, np.ndarray]:
        e, b = divmod(ordinal, self.num_batches)
        order = self._epoch_order(e)
        lo = b * self.batch_size + self._lo
        sl = order[lo:lo + self._rows]
        batch = {k: v[sl] for k, v in self.inputs.items()}
        batch["label"] = self.labels[sl]
        return batch

    # --- prefetch ring --------------------------------------------------
    def _ensure_pipe(self):
        if self._pipe is None:
            from .prefetch import PrefetchPipeline
            base = self._idx

            def produce(k):
                hb = self._host_batch_at(base + k)
                return (hb, self.model._stage_step(hb, **self._kw))

            self._pipe = PrefetchPipeline(produce, depth=self._depth,
                                          name="SingleDataLoader")
        return self._pipe

    def _close_pipe(self):
        if self._pipe is not None:
            self._pipe.close()
            self._pipe = None

    def close(self):
        self._close_pipe()

    def reset(self):
        """Back to batch 0, reshuffling from the consumed epoch's order
        when shuffling."""
        self._close_pipe()
        with self._sched_lock:
            order = self._orders[min(self._consumed_epoch(),
                                     self._max_epoch)]
            if self.shuffle:
                order = order.copy()
                self.rng.shuffle(order)
            self._orders = {0: order}
            self._rng_states = {0: self.rng.get_state()}
            self._max_epoch = 0
        self._idx = 0

    def next_host_batch(self) -> Dict[str, np.ndarray]:
        """Next host-side (numpy) batch. Interleaves with next_batch:
        both consume the same staged stream."""
        if self._prefetch:
            hb, _ = self._ensure_pipe().get()
        else:
            hb = self._host_batch_at(self._idx)
        self._idx += 1
        self._prune_epochs()
        return hb

    def next_batch(self) -> Dict:
        """Next batch on the model's device; wraps around at the end of
        the dataset."""
        if self._prefetch:
            _, staged = self._ensure_pipe().get()
            db = staged.wait()
        else:
            db = self.model._device_batch(self._host_batch_at(self._idx),
                                          **self._kw)
        self._idx += 1
        self._prune_epochs()
        return db

    def state(self) -> Dict:
        """Serializable position (cursor, shuffle order, RNG state):
        ``set_state()`` on a fresh loader over the same data resumes the
        exact batch sequence. Drains the prefetch ring."""
        self._close_pipe()
        ce = self._consumed_epoch()
        s = self._rng_states[ce]
        return {"idx": int(self._idx),
                "order": [int(i) for i in self._orders[ce]],
                "rng": [s[0], [int(v) for v in s[1]], int(s[2]),
                        int(s[3]), float(s[4])]}

    def set_state(self, state: Dict) -> None:
        self._close_pipe()
        self._idx = int(state["idx"])
        order = np.asarray(state["order"], dtype=np.int64)
        r = state["rng"]
        self.rng.set_state((r[0], np.asarray(r[1], dtype=np.uint32),
                            int(r[2]), int(r[3]), float(r[4])))
        ce = self._consumed_epoch()
        with self._sched_lock:
            self._orders = {ce: order}
            self._rng_states = {ce: self.rng.get_state()}
            self._max_epoch = ce

    def __iter__(self) -> Iterator[Dict]:
        self.reset()
        for _ in range(self.num_batches):
            yield self.next_batch()


class _PrefetchMixin:
    """Prefetch plumbing for loaders whose host batches come from a
    stateful sequential read (``_read_host_batch``). Ring items are
    (host batch, staged batch or None); whether the staging thread also
    copies to the device is decided by the consumer's first call, so a
    loader driven only through next_host_batch never touches the
    model's staging."""

    _pipe = None
    _pipe_stages_device = False
    # the host batches are this rank's rows of the global ones: the
    # model stages them so
    _local = False

    @property
    def _kw(self):
        return {"local": True} if self._local else {}

    def _init_prefetch(self, model, prefetch: bool,
                       depth: Optional[int]) -> None:
        self._depth = _config_depth(model, depth)
        self._prefetch_on = bool(prefetch) and self._depth > 0

    def _read_host_batch(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _ensure_pipe(self, stage_device: bool):
        if self._pipe is None:
            from .prefetch import PrefetchPipeline
            self._pipe_stages_device = stage_device

            def produce(_k):
                hb = self._read_host_batch()
                staged = (self.model._stage_step(hb, **self._kw)
                          if self._pipe_stages_device else None)
                return (hb, staged)

            self._pipe = PrefetchPipeline(produce, depth=self._depth,
                                          name=type(self).__name__)
        return self._pipe

    def _close_pipe(self):
        if self._pipe is not None:
            self._pipe.close()
            self._pipe = None

    def next_host_batch(self) -> Dict[str, np.ndarray]:
        if not self._prefetch_on:
            return self._read_host_batch()
        return self._ensure_pipe(stage_device=False).get()[0]

    def next_batch(self) -> Dict:
        if not self._prefetch_on:
            return self.model._device_batch(self._read_host_batch(),
                                            **self._kw)
        hb, staged = self._ensure_pipe(stage_device=True).get()
        # a ring opened in host-only mode stages on the consumer instead
        return (staged.wait() if staged is not None
                else self.model._device_batch(hb, **self._kw))


def write_ffbin(path: str, dense: np.ndarray, sparse: np.ndarray,
                labels: np.ndarray) -> None:
    """Write a dataset in the native loader's .ffbin format (see the
    header of native/ffloader.cc). sparse may be (n, T) or (n, T, bag):
    it is stored flattened per sample and reshaped on load."""
    n = len(labels)
    dense = np.ascontiguousarray(dense, dtype=np.float32).reshape(n, -1)
    sparse = np.ascontiguousarray(sparse, dtype=np.int32).reshape(n, -1)
    labels = np.ascontiguousarray(labels, dtype=np.float32).reshape(n)
    with open(path, "wb") as f:
        f.write(b"FFB1")
        np.asarray([n, dense.shape[1], sparse.shape[1]],
                   dtype=np.int64).tofile(f)
        dense.tofile(f)
        sparse.tofile(f)
        labels.tofile(f)


class FFBinDataLoader(_PrefetchMixin):
    """Native prefetching loader over an .ffbin file.

    The C++ side (native/ffloader.cc) keeps the dataset mmap'd and a
    background thread assembling (shuffled) batches into a ring; on the
    Python side the prefetch ring copies the assembled batches to the
    card ahead of the training loop, so ``next_batch`` hands back a
    staged batch. ``sparse_shape`` restores the per-sample sparse
    layout, e.g. (T, bag). The native library is built with g++ at first
    use; without a compiler this raises.

    Across ranks ``batch_size`` is the global batch and the native
    reader copies only this rank's rows of each (``rank_window``, the
    reader's row window); the shuffle's permutation does not depend on
    the window, so the ranks' batches, joined in rank order, are the
    one-rank loader's, bitwise."""

    def __init__(self, model, path: str, batch_size: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0,
                 sparse_shape: Optional[tuple] = None,
                 io_retries: int = 3, io_backoff_s: float = 0.05,
                 prefetch: bool = True, depth: Optional[int] = None):
        from ..native import get_lib
        self._handle = None
        self._lib = get_lib()
        self.model = model
        self.io_retries = io_retries
        self.io_backoff_s = io_backoff_s
        self.batch_size = batch_size or model.config.batch_size
        self._init_prefetch(model, prefetch, depth)
        lo, self.rows = rank_window(model, self.batch_size)
        self._local = self.rows != self.batch_size
        self._handle = self._lib.ffloader_open(
            path.encode(), self.batch_size, 1 if shuffle else 0, seed, lo,
            self.rows)
        if not self._handle:
            raise IOError(f"cannot open .ffbin dataset {path!r}")
        meta = (ctypes.c_int64 * 4)()
        self._lib.ffloader_meta(self._handle, meta)
        self.num_samples, self.dense_dim, self._sparse_flat, \
            self.num_batches = (int(meta[0]), int(meta[1]), int(meta[2]),
                                int(meta[3]))
        self.sparse_shape = tuple(sparse_shape) if sparse_shape else \
            (self._sparse_flat, 1)
        if int(np.prod(self.sparse_shape)) != self._sparse_flat:
            self.close()
            raise ValueError(
                f"sparse_shape {self.sparse_shape} != stored width "
                f"{self._sparse_flat}")

    def _read_host_batch(self) -> Dict[str, np.ndarray]:
        if not self._handle:
            raise RuntimeError("loader is closed")
        # fresh arrays each call: the C side copies straight into them
        n = self.rows
        dense = np.empty((n, self.dense_dim), dtype=np.float32)
        sparse = np.empty((n, self._sparse_flat), dtype=np.int32)
        label = np.empty(n, dtype=np.float32)
        bi = read_with_retries(
            lambda: self._lib.ffloader_next(
                self._handle,
                dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                sparse.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                label.ctypes.data_as(ctypes.POINTER(ctypes.c_float))),
            "ffbin_read", retries=self.io_retries,
            backoff_s=self.io_backoff_s)
        if bi < 0:
            raise RuntimeError("native loader stopped")
        return {
            "dense": dense,
            "sparse": sparse.reshape((n,) + self.sparse_shape),
            "label": label.reshape(-1, 1),
        }

    def close(self):
        self._close_pipe()
        if self._handle:
            self._lib.ffloader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter teardown: nothing to report to
            pass

    def __iter__(self) -> Iterator[Dict]:
        for _ in range(self.num_batches):
            yield self.next_batch()


def write_img_ffbin(path: str, images: np.ndarray,
                    labels: np.ndarray) -> None:
    """Store an image dataset in the .ffbin format: images flattened
    into the dense block (sparse width 0), labels into the label block,
    so the same reader and ring serve images and DLRM alike."""
    n = len(labels)
    imgs = np.ascontiguousarray(images, dtype=np.float32).reshape(n, -1)
    write_ffbin(path, imgs, np.empty((n, 0), np.int32), labels)


class ImgDataLoader4D(_PrefetchMixin):
    """On-disk image loader feeding 4-D (N, C, H, W) inputs.

    Sources by extension:
      - ``.ffbin`` — the native reader and the prefetch ring staging
        reshaped batches to the device (write with ``write_img_ffbin``);
        ``image_shape`` restores (C, H, W);
      - ``.npz`` — arrays ``images`` (N, C, H, W) and ``labels``;
      - ``.npy`` — the images; labels from ``<stem>_labels.npy``.

    ``next_batch()`` returns a staged dict {input_name: (b, C, H, W),
    "label": (b, 1)} for ``train_batch_device``; ``next_host_batch()``
    the same as host arrays (labels int32)."""

    rank = 4

    def __init__(self, model, path: str, image_shape=None,
                 input_name: str = "image", batch_size: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0,
                 prefetch: bool = True, depth: Optional[int] = None):
        self.model = model
        self.input_name = input_name
        self.batch_size = batch_size or model.config.batch_size
        self._init_prefetch(model, prefetch, depth)
        self._native = None
        if path.endswith(".ffbin"):
            if self.rank == 4 and image_shape is None:
                raise ValueError(
                    ".ffbin stores images flattened; pass "
                    "image_shape=(C, H, W)")
            # the inner reader stays synchronous; THIS loader's ring
            # stages the reshaped batches
            self._native = FFBinDataLoader(model, path,
                                           batch_size=self.batch_size,
                                           shuffle=shuffle, seed=seed,
                                           sparse_shape=(0, 1),
                                           prefetch=False)
            flat = self._native.dense_dim
            if self.rank == 4:
                if int(np.prod(image_shape)) != flat:
                    raise ValueError(f"image_shape {image_shape} != stored "
                                     f"width {flat}")
                self.image_shape = tuple(image_shape)
            else:
                self.image_shape = (flat,)
            self.num_samples = self._native.num_samples
            self.num_batches = self._native.num_batches
            self._local = self._native._local
            return
        if path.endswith(".npz"):
            with np.load(path) as d:
                images, labels = d["images"], d["labels"]
        elif path.endswith(".npy"):
            images = np.load(path)
            labels = np.load(path[:-len(".npy")] + "_labels.npy")
        else:
            raise ValueError(f"unsupported image dataset {path!r} "
                             f"(.ffbin/.npz/.npy)")
        images = np.asarray(images, np.float32)
        if self.rank == 2:
            images = images.reshape(len(images), -1)
        self.image_shape = images.shape[1:]
        self._fallback = SingleDataLoader(
            model, {input_name: images},
            np.asarray(labels, np.int32).reshape(len(labels), -1),
            batch_size=self.batch_size, shuffle=shuffle, seed=seed,
            prefetch=prefetch, depth=depth)
        self.num_samples = self._fallback.num_samples
        self.num_batches = self._fallback.num_batches

    def _read_host_batch(self) -> Dict[str, np.ndarray]:
        raw = self._native._read_host_batch()
        imgs = raw["dense"].reshape((len(raw["label"]),) + self.image_shape)
        return {self.input_name: imgs,
                "label": raw["label"].astype(np.int32)}

    def next_host_batch(self) -> Dict[str, np.ndarray]:
        if self._native is None:
            return self._fallback.next_host_batch()
        return _PrefetchMixin.next_host_batch(self)

    def next_batch(self) -> Dict:
        if self._native is None:
            return self._fallback.next_batch()
        return _PrefetchMixin.next_batch(self)

    def close(self):
        self._close_pipe()
        if self._native is not None:
            self._native.close()
        else:
            self._fallback.close()

    def __iter__(self) -> Iterator[Dict]:
        for _ in range(self.num_batches):
            yield self.next_batch()


class ImgDataLoader2D(ImgDataLoader4D):
    """Flattened (N, D) variant."""

    rank = 2


def load_dlrm_hdf5(path: str):
    """Criteo DLRM HDF5 (datasets ``X_int`` dense, ``X_cat`` sparse ids,
    ``y`` labels, as examples/native/preprocess_hdf.py writes them) ->
    ({"dense": (n, 13) fp32, "sparse": (n, T, 1) int32}, (n, 1) fp32
    labels). Needs ``h5py``; without it, raises ImportError."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"reading {path!r} needs h5py, which is not installed; convert "
            f"the dataset to .ffbin with data.dataloader.write_ffbin on a "
            f"machine that has h5py") from e
    with h5py.File(path, "r") as f:
        x_int = np.asarray(f["X_int"], dtype=np.float32)
        x_cat = np.asarray(f["X_cat"], dtype=np.int32)
        y = np.asarray(f["y"], dtype=np.float32).reshape(-1, 1)
    if x_cat.ndim == 2:
        x_cat = x_cat[:, :, None]  # (n, T) -> (n, T, bag=1)
    return {"dense": x_int, "sparse": x_cat}, y
