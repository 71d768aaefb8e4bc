"""Checkpoints and the legacy ``FeedForward`` estimator of the port
(mirrors ``mxnet_tpu/model.py``).

A checkpoint is ``prefix-symbol.json`` (the graph's JSON) and
``prefix-%04d.params`` (``nd.save`` of a dict whose keys carry ``arg:``
and ``aux:`` prefixes), so one written by either package — or the
reference's binary ``.params`` — loads in the other.

:func:`_create_kvstore` is the reference's decision (``model.py:20-45``)
of the store a Module trains through.  :class:`FeedForward`
(``model.py:72-200``) is the pre-Module estimator — ``create``, ``fit``,
``predict``, ``score``, ``save``/``load`` — and, as in the JAX package,
delegates to a :class:`~.module.Module`: numpy (or NDArray) ``X``/``y``
become an ``NDArrayIter`` of ``numpy_batch_size`` rows whose last
partial batch is discarded in training and padded in inference, and
parameters the caller does not give start from ``Uniform(0.01)``.
"""
from __future__ import annotations

import logging

import numpy as np

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError

__all__ = ["save_checkpoint", "load_checkpoint", "FeedForward"]


def _create_kvstore(kvstore, num_device, arg_params):
    """``(store or None, update_on_kvstore)`` as the reference decides:
    None or a string on one device (not ``dist``) gives no store and the
    Module's own updater; a ``KVStore`` instance is used as given; a
    string on several devices creates one, and ``local`` aggregates only
    when a parameter has over 16 M elements."""
    from . import kvstore as kvs

    update_on_kvstore = True
    if kvstore is None:
        kv = None
        update_on_kvstore = False
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
            update_on_kvstore = False
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max((int(np.prod(p.shape))
                                for p in arg_params.values()), default=0)
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    return kv, (update_on_kvstore if kv else False)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``symbol`` (unless ``None``) and the params; values may be
    NDArrays, tensors or numpy arrays."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd.save(f"{prefix}-{epoch:04d}.params", save_dict)
    logging.info('Saved checkpoint to "%s-%04d.params"', prefix, epoch)


def split_params(save_dict):
    """``{"arg:name": v, "aux:name": v}`` -> ``(arg_params, aux_params)``."""
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError(f"checkpoint key {k!r} has no arg:/aux: prefix")
    return arg_params, aux_params


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)`` with the params as NDArrays
    on ``ctx`` (default: the card)."""
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    save_dict = nd.load(f"{prefix}-{epoch:04d}.params", ctx=ctx)
    return (symbol,) + split_params(save_dict)


class FeedForward:
    """The legacy estimator (parity: model.py:387): a symbol, its
    context (default: the card) and its training settings; ``kwargs``
    may carry ``momentum``, ``wd``, ``clip_gradient``, ``lr_scheduler``
    and ``rescale_grad`` for the optimizer."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, learning_rate=0.01, **kwargs):
        from .initializer import Uniform

        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.learning_rate = learning_rate
        self.kwargs = dict(kwargs)
        self._module = None

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward over the checkpoint ``prefix``/``epoch``, its
        parameters on ``ctx`` (default: the card)."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=ctx)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               **kwargs):
        """Build a FeedForward and fit it."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger)
        return model

    def _init_iter(self, X, y, is_train):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        if isinstance(X, (np.ndarray, nd.NDArray)):
            X = X.asnumpy() if isinstance(X, nd.NDArray) else X
            if y is not None:
                y = y.asnumpy() if isinstance(y, nd.NDArray) \
                    else np.asarray(y)
            batch = min(self.numpy_batch_size, X.shape[0])
            return NDArrayIter(X, y, batch_size=batch, shuffle=is_train,
                               last_batch_handle="discard" if is_train
                               else "pad")
        raise TypeError("X must be DataIter or array")

    def _get_module(self, data_iter):
        from .module import Module

        ctx = self.ctx
        if ctx is not None and not isinstance(ctx, list):
            ctx = [ctx]
        # an iterator without labels (predict on arrays) leaves the
        # label arguments as inputs, not parameters, as MXNet's
        # _init_predictor binds them (the JAX package's FeedForward
        # counts them as missing parameters there and raises)
        label_names = [l[0] for l in data_iter.provide_label] or [
            n for n in self.symbol.list_arguments() if n.endswith("label")]
        return Module(self.symbol,
                      data_names=[d[0] for d in data_iter.provide_data],
                      label_names=label_names, context=ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None):
        """Train ``num_epoch`` epochs over ``X`` (a DataIter, or arrays
        with labels ``y``) through a Module; the trained parameters land
        in ``arg_params``/``aux_params``."""
        train_data = self._init_iter(X, y, is_train=True)
        if eval_data is not None and isinstance(eval_data, tuple):
            eval_data = self._init_iter(eval_data[0], eval_data[1],
                                        is_train=False)
        self._module = self._get_module(train_data)
        optimizer_params = {"learning_rate": self.learning_rate}
        for k in ("momentum", "wd", "clip_gradient", "lr_scheduler",
                  "rescale_grad"):
            if k in self.kwargs:
                optimizer_params[k] = self.kwargs[k]
        self._module.fit(
            train_data, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer,
            optimizer_params=tuple(optimizer_params.items()),
            initializer=self.initializer, arg_params=self.arg_params,
            aux_params=self.aux_params, allow_missing=True,
            begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
            monitor=monitor)
        self.arg_params, self.aux_params = self._module.get_params()

    def _bound_for(self, data_iter):
        """The Module bound at ``data_iter``'s data shapes: the one this
        model has when its shapes match (the trained one after ``fit``),
        else a new one bound for inference with this model's parameters
        (as MXNet's ``_init_predictor`` rebinds on new shapes)."""
        mod = self._module
        if mod is None or not mod.binded or \
                dict(mod.data_shapes) != {n: tuple(s) for n, s in
                                          data_iter.provide_data}:
            self._module = self._get_module(data_iter)
            self._module.bind(data_shapes=data_iter.provide_data,
                              label_shapes=data_iter.provide_label or None,
                              for_training=False)
            self._module.init_params(arg_params=self.arg_params,
                                     aux_params=self.aux_params,
                                     allow_missing=False)
        return self._module

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy arrays (padding dropped)."""
        data_iter = self._init_iter(X, None, is_train=False)
        out = self._bound_for(data_iter).predict(data_iter,
                                                 num_batch=num_batch,
                                                 reset=reset)
        if isinstance(out, list):
            return [o.asnumpy() for o in out]
        return out.asnumpy()

    def score(self, X, y=None, eval_metric="acc", num_batch=None):
        """``eval_metric``'s value over ``X`` (and labels ``y``)."""
        data_iter = self._init_iter(X, y, is_train=False)
        res = self._bound_for(data_iter).score(data_iter, eval_metric,
                                               num_batch=num_batch)
        return res[0][1]

    def save(self, prefix, epoch=None):
        """Write the symbol and the parameters as checkpoint
        ``prefix``/``epoch`` (default: ``num_epoch``)."""
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})
