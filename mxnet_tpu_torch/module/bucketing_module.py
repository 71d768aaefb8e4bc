"""``BucketingModule`` of the port (``mxnet_tpu/module/bucketing_module.py``;
parity: python/mxnet/module/bucketing_module.py): variable-length
training with one ``Module`` per bucket key, all sharing the default
bucket's parameters and optimizer.

A bucket is bound on first use with the default bucket's module as its
``shared_module``: the executor group binds the donor's parameter and
aux tensors themselves (``module/executor_group.py``), so every bucket
reads and updates one set of weights, and a bucket made after
``init_optimizer`` borrows the default bucket's optimizer and updater.

``compile_buckets`` caps the number of bound executors (in the port a
"compile bucket" is one bound executor, and one captured graph where
the caller captures): bucket keys round up to the smallest compile key
that covers them, and each batch is padded on the device along its
bucketed axes to that key's shapes, data with ``data_pad`` and labels
with ``label_pad``.  A symbol built with ``use_ignore=True,
ignore_label=label_pad`` then takes exactly the gradients of the
unpadded bucket, and ``update_metric`` reads the padded labels, whose
padding the metric's ``ignore_label`` drops.  ``compile_buckets=True``
runs every bucket through the default bucket's executor.
``install_monitor`` taps every bucket's executor, and a bucket bound
later gets the same monitor (as MXNet's ``switch_bucket`` does; the JAX
package taps only the buckets bound before the install).
"""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..io import DataBatch, DataDesc
from ..ndarray import NDArray
from .base_module import BaseModule
from .module import Module


def _key_tuple(key):
    return tuple(key) if isinstance(key, (list, tuple)) else (key,)


def _key_le(a, b):
    ta, tb = _key_tuple(a), _key_tuple(b)
    return len(ta) == len(tb) and all(x <= y for x, y in zip(ta, tb))


def _pad_shape(shape, default_shape, key, default_key, ckey):
    """Compute the padded target shape for one array.

    The bucketed axes are exactly those where this batch's shape differs
    from the default bucket's bound shape (so constant axes — batch size,
    hidden dims — are never touched even if they numerically collide with a
    bucket key).  Each such axis maps to the bucket-key component whose
    value matches it, and is promoted to that component of the compile key.
    """
    if default_shape is None or len(default_shape) != len(shape):
        return tuple(shape)
    tk = _key_tuple(key)
    tdk = _key_tuple(default_key)
    tck = _key_tuple(ckey)
    out = []
    for d, dd in zip(shape, default_shape):
        if d != dd:
            for j, kc in enumerate(tk):
                if d == kc and (j >= len(tdk) or tdk[j] == dd):
                    d = tck[j]
                    break
        out.append(d)
    return tuple(out)


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 compile_buckets=None, data_pad=0.0, label_pad=0.0):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._monitor = None
        if compile_buckets is True:
            compile_buckets = [default_bucket_key]
        if compile_buckets:
            compile_buckets = list(compile_buckets)
            if not any(_key_le(default_bucket_key, k) for k in compile_buckets):
                compile_buckets.append(default_bucket_key)
            compile_buckets.sort(key=_key_tuple)
        self._compile_buckets = compile_buckets or None
        self._data_pad = data_pad
        self._label_pad = label_pad
        self._metric_labels = None  # padded labels for update_metric

    def _compile_key(self, bucket_key):
        """Smallest compile bucket covering bucket_key (identity when off)."""
        if not self._compile_buckets:
            return bucket_key
        for ck in self._compile_buckets:
            if _key_le(bucket_key, ck):
                return ck
        raise MXNetError(
            f"bucket_key {bucket_key!r} exceeds every compile bucket "
            f"{self._compile_buckets!r}")

    def _pad_batch(self, data_batch, key, ckey):
        """Pad a bucket-``key`` batch up to the compile bucket's shapes.

        Data pads with ``data_pad``; labels pad with ``label_pad`` so that a
        use_ignore symbol contributes zero loss/gradient at the padding."""
        default_mod = self._buckets[self._default_bucket_key]
        defaults = dict(default_mod._data_shapes)
        if default_mod._label_shapes:
            defaults.update(dict(default_mod._label_shapes))

        def pad(arrs, descs, names, fill):
            out_arrs, out_descs = [], []
            for i, a in enumerate(arrs):
                shape = tuple(a.shape)
                name = descs[i][0] if descs and i < len(descs) else names[i]
                tgt = _pad_shape(shape, defaults.get(name), key,
                                 self._default_bucket_key, ckey)
                if tgt != shape:
                    # padded where the array lives: no host round trip
                    # for device batches
                    raw = (a.tensor if isinstance(a, NDArray) else a
                           if isinstance(a, torch.Tensor)
                           else torch.as_tensor(np.asarray(a)))
                    widths = []
                    for s, t in reversed(list(zip(shape, tgt))):
                        widths += [0, t - s]
                    a = NDArray(F.pad(raw, widths, value=fill))
                out_arrs.append(a)
                out_descs.append(DataDesc(name, tgt))
            return out_arrs, out_descs

        mod = self._curr_module
        data, ddesc = pad(data_batch.data, data_batch.provide_data or [],
                          mod.data_names, self._data_pad)
        if data_batch.label is not None:
            label, ldesc = pad(data_batch.label, data_batch.provide_label or [],
                               mod._label_names, self._label_pad)
        else:
            label, ldesc = None, None
        return DataBatch(data, label=label, pad=data_batch.pad,
                         index=data_batch.index, bucket_key=ckey,
                         provide_data=ddesc, provide_label=ldesc)

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _gen_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context, work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        assert shared_module is None, "shared_module not supported for BucketingModule"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it first (with the
        default bucket's module as its ``shared_module``) if it is new."""
        assert self.binded, "call bind before switching buckets"
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key])
            if self.optimizer_initialized:
                # buckets created after init_optimizer share its state
                module.borrow_optimizer(
                    self._buckets[self._default_bucket_key])
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def get_params(self):
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._curr_module.init_params(initializer, arg_params, aux_params,
                                      allow_missing, force_init)
        self.params_initialized = True
        self._params_dirty = False

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            bucket_key = self._default_bucket_key
        compile_key = self._compile_key(bucket_key)
        self._orig_labels = data_batch.label
        if compile_key != bucket_key:
            data_batch = self._pad_batch(data_batch, bucket_key, compile_key)
            bucket_key = compile_key
        self._metric_labels = data_batch.label
        data_shapes = data_batch.provide_data or [
            (n, a.shape) for n, a in zip(self._curr_module.data_names, data_batch.data)
        ]
        label_shapes = data_batch.provide_label
        self.switch_bucket(bucket_key, data_shapes, label_shapes)
        default_mod = self._buckets[self._default_bucket_key]
        if self._curr_module.params_initialized is False:
            self._curr_module.params_initialized = True
        # propagate the latest params into the bucket's executor, unless
        # it binds the default bucket's parameter tensors themselves
        # (then it sees every update already)
        if (self._curr_module is not default_mod
                and not getattr(self._curr_module._exec_group,
                                "shares_param_storage", False)):
            self._curr_module._exec_group.set_params(
                default_mod._arg_params or {},
                default_mod._aux_params or {})
        self._curr_module._arg_params = default_mod._arg_params
        self._curr_module._aux_params = default_mod._aux_params
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)
        self._params_dirty = True

    def update(self):
        self._curr_module.update()
        # write updated params back to the default bucket's master copy
        self._curr_module._sync_params_from_devices()
        self._params_dirty = False

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        # Under compile-bucket padding the executor outputs carry the
        # padded length, so the labels the caller took from the ORIGINAL
        # batch no longer line up — substitute the padded labels (the
        # ignore_label masks the padding).  Only the fit()-style case
        # where the caller passes that same batch's labels is rewritten;
        # custom label lists pass through untouched.
        if (self._compile_buckets and self._metric_labels is not None
                and labels is not None
                and getattr(self, "_orig_labels", None) is not None
                and len(labels) == len(self._orig_labels)
                and all(a is b for a, b in zip(labels, self._orig_labels))):
            labels = self._metric_labels
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    @property
    def _params_dirty(self):
        return getattr(self, "_params_dirty_flag", False)

    @_params_dirty.setter
    def _params_dirty(self, val):
        self._params_dirty_flag = val
