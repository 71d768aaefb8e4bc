"""Data iterators of the port (mirrors ``mxnet_tpu/io.py``; parity:
python/mxnet/io.py and the C++ iterators of src/io/).

``NDArrayIter``, ``MNISTIter`` and ``CSVIter`` yield NDArrays on the
host, as MXNet's give CPU arrays, and the trainer uploads them (through
pinned memory, without a host sync).  The batching rules (``pad`` with
wrap-around, ``discard``, ``roll_over``) and the shuffles (numpy's
global RNG for ``NDArrayIter``, ``RandomState(seed)`` for ``MNISTIter``)
are the reference's, so the same seed gives the same batches in both
packages.  ``ImageRecordIter`` (``image.py``) yields batches already on
its device.

``PrefetchingIter`` runs one producer thread per iterator, so host
batch preparation overlaps the device; ``DevicePrefetchIter`` keeps
``depth`` batches already copied to the card, staging host batches
through pinned buffers of ``storage`` on a staging stream (the
consumer's stream waits on each copy's event, no host wait) and passing
batches already on the device straight through.  Stack them as
``ImageRecordIter -> PrefetchingIter -> DevicePrefetchIter``.

With telemetry on (``MXTPU_TELEMETRY=1``), each stage counts the
batches it hands out in ``data_batches_total{iterator}`` and the time
its consumer spent inside ``next()`` in
``data_batch_wait_seconds{iterator}`` (the JAX package's families;
filter a stacked pipeline by the ``iterator`` label).  Neither reads
anything back from the card.
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
import time
from collections import namedtuple

import numpy as np
import torch

from . import ndarray as nd
from . import telemetry as _tm
from .context import cpu

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "DevicePrefetchIter", "MNISTIter", "CSVIter",
           "ImageRecordIter", "step_multi_feeds"]

DataDesc = namedtuple("DataDesc", ["name", "shape"])


# --- telemetry families (the JAX package's names).  Stacked pipelines
# (ImageRecordIter -> PrefetchingIter) report per stage: filter by the
# `iterator` label for the stage you care about.
_TM_BATCHES = _tm.counter(
    "data_batches_total", "batches produced, per iterator class",
    labels=("iterator",))
_TM_BATCH_WAIT = _tm.histogram(
    "data_batch_wait_seconds",
    "time the consumer spent inside next() waiting for a batch "
    "(input-pipeline starvation when the upstream stage is prefetched)",
    labels=("iterator",))


def _record_batch(it, t0):
    """One produced batch: count it and record the consumer's wait."""
    name = type(it).__name__
    _TM_BATCHES.inc(iterator=name)
    _TM_BATCH_WAIT.observe(time.perf_counter() - t0, iterator=name)


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    def __init__(self):
        self.batch_size = 0

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        t0 = time.perf_counter() if _tm.enabled() else None
        if self.iter_next():
            batch = DataBatch(data=self.getdata(), label=self.getlabel(),
                              pad=self.getpad(), index=self.getindex())
            if t0 is not None:
                _record_batch(self, t0)
            return batch
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Array / list / dict input -> ``[(name, float32 numpy array)]``."""
    if data is None:
        if not allow_empty:
            raise ValueError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, nd.NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("data must be NDArray, numpy array, list or dict")
    return [(k, np.asarray(v.asnumpy() if isinstance(v, nd.NDArray) else v,
                           dtype=np.float32))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays: shuffle, ``pad`` / ``discard`` /
    ``roll_over`` handling of the last batch, data and label dicts."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__()
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]

        if shuffle:
            idx = np.random.permutation(self.num_data)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]

        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n

        if self.num_data < batch_size:
            raise ValueError("batch_size must be <= data size")
        self.batch_size = batch_size
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:])
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:])
                for k, v in self.label]

    def reset(self):
        if (self.last_batch_handle == "roll_over"
                and self.cursor > self.num_data):
            self.cursor = (-self.batch_size
                           + (self.cursor % self.num_data) % self.batch_size)
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        if self.cursor + self.batch_size <= self.num_data:
            return [nd.array(v[self.cursor:self.cursor + self.batch_size],
                             ctx=cpu())
                    for _, v in data_source]
        # the last batch wraps around to the start
        pad = self.batch_size - (self.num_data - self.cursor)
        return [nd.array(np.concatenate([v[self.cursor:], v[:pad]], axis=0),
                         ctx=cpu())
                for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if (self.last_batch_handle == "pad"
                and self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize another iterator to ``size`` batches per epoch, truncating
    it or starting it over."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Thread-prefetching wrapper (parity: io.py PrefetchingIter;
    src/io/iter_prefetcher.h:50-155): one producer thread per
    iterator keeps one batch ready, so host batch preparation overlaps
    the device.  ``rename_data``/``rename_label`` (one dict per
    iterator) rename the descriptors.  An error in a producer is raised
    in the consumer (the JAX package's thread dies with it, and the
    consumer waits for ever)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.current_batch = [None] * self.n_iter
        self.next_batch = [None] * self.n_iter
        self.started = True
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()

        def prefetch(i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                except Exception as exc:  # noqa: BLE001 — for the consumer
                    self.next_batch[i] = exc
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch, args=[i], daemon=True)
            for i in range(self.n_iter)]
        for t in self.prefetch_threads:
            t.start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[n], s) for n, s in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[n], s) for n, s in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        for b in self.next_batch:
            if isinstance(b, Exception):
                raise b
        if self.next_batch[0] is None:
            return False
        self.current_batch = DataBatch(
            sum([b.data for b in self.next_batch], []),
            sum([b.label for b in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        t0 = time.perf_counter() if _tm.enabled() else None
        if self.iter_next():
            if t0 is not None:
                _record_batch(self, t0)
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class DevicePrefetchIter(DataIter):
    """Keeps up to ``depth`` batches already on ``device`` (default: the
    card) while the consumer computes (parity: the reference's
    PrefetcherIter feeding device memory, src/io/iter_prefetcher.h).

    A producer thread pulls batches from ``base_iter``; an array already
    on ``device`` passes straight through, a host one is copied into a
    pinned buffer of ``storage`` (unless it is pinned already) and
    staged on the staging stream, with the stream that was current
    where this iterator was made waiting on the copy.  A producer error
    is raised in the consumer; ``reset`` stops the producer and drops
    every staged batch before the next epoch starts."""

    def __init__(self, base_iter, depth=2, device=None):
        super().__init__()
        self._base = base_iter
        self.batch_size = base_iter.batch_size
        self._device = nd._device(device)
        self._stream = (torch.cuda.current_stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = False
        self._exhausted = False
        self._thread = None
        self._start()

    def _stage(self, arr):
        from . import storage

        t = arr.tensor if isinstance(arr, nd.NDArray) else torch.as_tensor(arr)
        if t.device == self._device:
            return nd.NDArray(t)
        if self._device.type != "cuda" or t.is_cuda:
            return nd.NDArray(t.to(self._device))
        if not t.is_pinned():
            buf = storage.staging_empty(t.shape, t.dtype, pin=True)
            buf.copy_(t)
            t = buf
        return nd.NDArray(storage.stage_to_device(t, self._device,
                                                  self._stream))

    def _start(self):
        def producer():
            try:
                for batch in self._base:
                    if self._stop:
                        return
                    self._q.put(DataBatch(
                        [self._stage(d) for d in batch.data],
                        [self._stage(x) for x in batch.label or []],
                        batch.pad, batch.index))
            except Exception as exc:  # noqa: BLE001 — raised in the consumer
                self._q.put(exc)
                return
            self._q.put(None)

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    @property
    def provide_data(self):
        return self._base.provide_data

    @property
    def provide_label(self):
        return self._base.provide_label

    def reset(self):
        self._stop = True
        # unblock the producer (it may wait on a full queue), let it end,
        # then drain everything: a stale batch or the end marker would
        # replay into, or end, the next epoch
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._base.reset()
        self._stop = False
        self._exhausted = False
        self._start()

    def iter_next(self):
        try:
            self._current = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getpad(self):
        return self._current.pad

    def next(self):
        if self._exhausted:
            # the producer has ended and its marker is taken: a blocking
            # get would wait for ever
            raise StopIteration
        t0 = time.perf_counter() if _tm.enabled() else None
        item = self._q.get()
        if item is None:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, Exception):
            self._exhausted = True
            raise item
        self._current = item
        if t0 is not None:
            _record_batch(self, t0)
        return item


class MNISTIter(NDArrayIter):
    """MNIST idx files, gzipped or not (parity: src/io/iter_mnist.cc:241):
    pixels scaled to [0, 1], ``flat`` ``(batch, 784)`` else ``(batch, 1,
    28, 28)``, shuffled once by ``RandomState(seed)``, the last partial
    batch discarded."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, **kwargs):
        images = self._read_idx(image)
        labels = self._read_idx(label)
        images = images.astype(np.float32) / 255.0
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1, images.shape[1],
                                    images.shape[2])
        if shuffle:
            rs = np.random.RandomState(seed)
            idx = rs.permutation(images.shape[0])
            images, labels = images[idx], labels[idx]
        super().__init__(images, labels.astype(np.float32),
                         batch_size=batch_size, shuffle=False,
                         last_batch_handle="discard")

    @staticmethod
    def _read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            path, opener = path + ".gz", gzip.open
        with opener(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            data = np.frombuffer(f.read(), dtype=np.uint8)
            return data.reshape(dims)


class CSVIter(NDArrayIter):
    """CSV rows reshaped to ``data_shape`` (parity: src/io/iter_csv.cc:131);
    labels from ``label_csv`` or zeros; the last partial batch
    discarded."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=128, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((data.shape[0],)
                                  + tuple(label_shape)).squeeze()
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="discard")


def ImageRecordIter(*args, **kwargs):
    """Parity: ImageRecordIter (src/io/iter_image_recordio.cc:459), the
    RecordIO image pipeline of ``image.py``."""
    from .image import ImageRecordIter as _impl

    return _impl(*args, **kwargs)


def step_multi_feeds(data_iter, steps_per_call, data_names=("data",),
                     label_names=("softmax_label",), drop_remainder=False):
    """Group a DataIter's batches into ``FusedTrainer.step_multi`` feeds:
    dicts of input name -> a k-tuple of the per-step batches (host or
    device arrays, as the iterator yields them), with no re-stacking::

        for feed in io.step_multi_feeds(it, 8):
            trainer.step_multi(**feed)

    A trailing group shorter than ``steps_per_call`` is yielded as it is
    (its steps replay the graph captured for the same per-step shapes)
    unless ``drop_remainder``."""
    names = list(data_names) + list(label_names)
    group = []
    for batch in data_iter:
        group.append(list(batch.data) + list(batch.label or []))
        if len(group) == int(steps_per_call):
            yield {n: tuple(g[i] for g in group)
                   for i, n in enumerate(names)}
            group = []
    if group and not drop_remainder:
        yield {n: tuple(g[i] for g in group) for i, n in enumerate(names)}
