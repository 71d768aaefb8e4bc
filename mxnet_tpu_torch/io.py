"""Data iterators of the port (``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter`` and ``step_multi_feeds`` of
``mxnet_tpu/io.py``; parity: python/mxnet/io.py).

Batches stay on the host: ``NDArrayIter`` yields NDArrays on the CPU,
as MXNet's gives CPU arrays, and the trainer uploads them (through
pinned memory, without a host sync).  The batching rules (``pad`` with
wrap-around, ``discard``, ``roll_over``) and the shuffle (one
permutation from numpy's global RNG, drawn at construction) are the
reference's, so the same ``np.random.seed`` gives the same batches in
both packages.

Not ported yet (ROADMAP Queue 1 item 6): ``PrefetchingIter``,
``DevicePrefetchIter``, ``MNISTIter``, ``CSVIter`` and
``ImageRecordIter``, and the telemetry of the batch waits.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from . import ndarray as nd
from .context import cpu

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "step_multi_feeds"]

DataDesc = namedtuple("DataDesc", ["name", "shape"])


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
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
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


def step_multi_feeds(data_iter, steps_per_call, data_names=("data",),
                     label_names=("softmax_label",), drop_remainder=False):
    """Group a DataIter's batches into ``FusedTrainer.step_multi`` feeds:
    dicts of input name -> a k-tuple of the per-step batches, with no
    re-stacking on the host::

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
