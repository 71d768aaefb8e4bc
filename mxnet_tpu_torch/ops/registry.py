"""Operator registry of the port (mirrors ``mxnet_tpu/ops/registry.py``).

One registry serves the symbolic path: :mod:`mxnet_tpu_torch.symbol`
generates ``sym.<Op>`` constructors from it and the graph interpreter
(:func:`mxnet_tpu_torch.executor._build_graph_fn`) calls each op's
``fn(ctx, *inputs, **attrs)`` on tensors.  Gradients come from
``torch.autograd``; ops with MXNet's own backward semantics (loss
outputs that ignore the head gradient) and ops backed by a hand-written
kernel wrap themselves in a ``torch.autograd.Function``.

The imperative ``nd.<op>`` dispatch of the JAX package is not ported
yet (ROADMAP Queue 1 item 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from ..base import MXNetError

__all__ = ["OpCtx", "OpDef", "register", "get", "list_ops"]

_OPS: dict = {}


class OpCtx:
    """Per-invocation context handed to op implementations: train/eval
    mode, the device the graph runs on, and the ``torch.Generator`` that
    random ops draw from (the JAX package passes a PRNG key and a
    platform name instead)."""

    __slots__ = ("is_train", "device", "generator")

    def __init__(self, is_train: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        self.is_train = is_train
        self.device = device
        self.generator = generator


@dataclass
class OpDef:
    name: str
    fn: Callable  # fn(ctx, *inputs, **attrs) -> out | tuple | (outs, aux)
    arg_names: Sequence[str] = ("data",)
    aux_names: Sequence[str] = ()
    num_outputs: int = 1
    output_names: Sequence[str] = ("output",)
    # infer_params(attrs, *known_input_shapes) -> {param_or_aux: shape}
    infer_params: Optional[Callable] = None
    # optional_args(attrs) -> names dropped (e.g. bias under no_bias)
    optional_args: Optional[Callable] = None
    doc: str = ""

    def resolve_arg_names(self, attrs) -> list:
        names = list(self.arg_names)
        if self.optional_args is not None:
            dropped = self.optional_args(attrs)
            names = [n for n in names if n not in dropped]
        return names


def register(name, *, arg_names=("data",), aux_names=(), num_outputs=1,
             output_names=("output",), infer_params=None, optional_args=None,
             aliases=()):
    """Decorator registering an op implementation under ``name`` (and
    each of ``aliases``)."""

    def deco(fn):
        op = OpDef(name=name, fn=fn, arg_names=tuple(arg_names),
                   aux_names=tuple(aux_names), num_outputs=num_outputs,
                   output_names=tuple(output_names),
                   infer_params=infer_params, optional_args=optional_args,
                   doc=fn.__doc__ or "")
        _OPS[name] = op
        for alias in aliases:
            _OPS[alias] = op
        return fn

    return deco


def get(name: str) -> OpDef:
    try:
        return _OPS[name]
    except KeyError:
        raise MXNetError(f"operator '{name}' is not registered") from None


def list_ops() -> list:
    return sorted(_OPS)
