"""Bucketed sentence iterator of the port (``mxnet_tpu/rnn/io.py``;
parity: python/mxnet/rnn/io.py ``BucketSentenceIter``).

Sentences are binned by the smallest bucket that holds them and padded
with ``invalid_label``; a sentence longer than every bucket is dropped.
Each batch carries its ``bucket_key`` so a ``BucketingModule`` switches
to that bucket's executor, and the labels are the data shifted by one
step.  The shuffle is the reference's: Python's ``random`` shuffles the
batch order and numpy's global generator each bucket, in that order, so
one ``random.seed`` and ``np.random.seed`` give both packages the same
batches; ``rng=`` (a ``numpy.random.RandomState``) draws both shuffles
from it instead.  Each ``reset`` uploads the epoch's buckets to
``ctx`` (default: the card) once; batches are device views of them, so
the batch loop makes no host sync and no upload.
"""
from __future__ import annotations

import bisect
import random as pyrandom

import numpy as np

from .. import ndarray as nd
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT", init_states=None, rng=None, ctx=None):
        super().__init__()
        if not buckets:
            buckets = [i for i, j in enumerate(np.bincount(
                [len(s) for s in sentences])) if j >= batch_size]
        buckets.sort()
        self.data = [[] for _ in buckets]
        for sentence in sentences:
            buck = bisect.bisect_left(buckets, len(sentence))
            if buck == len(buckets):
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sentence)] = sentence
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        self._rng = rng
        self._ctx = ctx
        # init_states: [(name, shape)] fed as zeros with every batch (the
        # lstm_bucketing example's initial c/h)
        self.init_states = list(init_states or [])
        self._init_arrays = [nd.zeros(s, ctx=ctx, dtype=dtype)
                             for _, s in self.init_states]
        self.provide_data = [DataDesc(data_name, (batch_size,
                                                  self.default_bucket_key))] \
            + [DataDesc(n, s) for n, s in self.init_states]
        self.provide_label = [DataDesc(label_name, (batch_size,
                                                    self.default_bucket_key))]
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in range(
                0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        if self._rng is None:
            pyrandom.shuffle(self.idx)
            for buck in self.data:
                np.random.shuffle(buck)
        else:
            self._rng.shuffle(self.idx)
            for buck in self.data:
                self._rng.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(buck, ctx=self._ctx,
                                        dtype=self.dtype))
            self.ndlabel.append(nd.array(label, ctx=self._ctx,
                                         dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch(
            [data] + self._init_arrays, [label], pad=0,
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, data.shape)]
            + [DataDesc(n, s) for n, s in self.init_states],
            provide_label=[DataDesc(self.label_name, label.shape)])
