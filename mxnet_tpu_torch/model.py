"""Checkpoints of the port: ``save_checkpoint``/``load_checkpoint``
(mirrors ``mxnet_tpu/model.py:48-69``).

A checkpoint is ``prefix-symbol.json`` (the graph's JSON) and
``prefix-%04d.params`` (``nd.save`` of a dict whose keys carry ``arg:``
and ``aux:`` prefixes), so one written by either package — or the
reference's binary ``.params`` — loads in the other.

:func:`_create_kvstore` is the reference's decision (``model.py:20-45``)
of the store a Module trains through.  ``FeedForward`` waits for ROADMAP
Queue 1 item 6.
"""
from __future__ import annotations

import logging

import numpy as np

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError

__all__ = ["save_checkpoint", "load_checkpoint"]


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
