"""Checkpoints of the port: ``save_checkpoint``/``load_checkpoint``
(mirrors ``mxnet_tpu/model.py:48-69``).

A checkpoint is ``prefix-symbol.json`` (the graph's JSON) and
``prefix-%04d.params`` (``nd.save`` of a dict whose keys carry ``arg:``
and ``aux:`` prefixes), so one written by either package — or the
reference's binary ``.params`` — loads in the other.  ``FeedForward``
waits for ``Module`` (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError

__all__ = ["save_checkpoint", "load_checkpoint"]


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
