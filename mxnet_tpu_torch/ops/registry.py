"""Operator registry of the port (mirrors ``mxnet_tpu/ops/registry.py``).

One registry serves both execution styles: :mod:`mxnet_tpu_torch.symbol`
generates ``sym.<Op>`` constructors from it and the graph interpreter
(:func:`mxnet_tpu_torch.executor._build_graph_fn`) calls each op's
``fn(ctx, *inputs, **attrs)`` on tensors; :mod:`mxnet_tpu_torch.ndarray`
generates ``nd.<op>`` functions that dispatch through :func:`invoke`,
eagerly (the JAX package's jit cache has no counterpart: PyTorch runs
each op as it is called).  Gradients come from ``torch.autograd``; ops
with MXNet's own backward semantics (loss outputs that ignore the head
gradient) and ops backed by a hand-written kernel wrap themselves in a
``torch.autograd.Function``.
"""
from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import torch

from .. import profiler as _prof
from ..base import MXNetError

__all__ = ["OpCtx", "OpDef", "register", "get", "exists", "list_ops",
           "invoke", "decode_attr"]

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
    # variadic inputs (ElementWiseSum): fn(ctx, *inputs, **attrs)
    varargs: bool = False
    # draws random numbers (constant_fold never folds such an op)
    needs_rng: bool = False
    # attr-dependent output count (``num_outputs=-1`` reads the
    # ``num_outputs`` attr, as SliceChannel does)
    num_outputs_fn: Optional[Callable] = None
    # defaults of attrs that decide the inputs (Deconvolution's no_bias)
    attr_defaults: dict = field(default_factory=dict)
    # attr-dependent input names (a Custom op's come from its Prop)
    arg_names_fn: Optional[Callable] = None
    doc: str = ""

    def with_defaults(self, attrs) -> dict:
        """``attrs`` over :attr:`attr_defaults`."""
        return {**self.attr_defaults, **attrs} if self.attr_defaults \
            else attrs

    def resolve_arg_names(self, attrs) -> list:
        if self.arg_names_fn is not None:
            return list(self.arg_names_fn(attrs))
        names = list(self.arg_names)
        if self.optional_args is not None:
            dropped = self.optional_args(self.with_defaults(attrs))
            names = [n for n in names if n not in dropped]
        return names

    def count_outputs(self, attrs) -> int:
        if self.num_outputs_fn is not None:
            return int(self.num_outputs_fn(attrs))
        if self.num_outputs == -1:
            return int(decode_attr(attrs.get("num_outputs", 1)))
        return self.num_outputs


def register(name, *, arg_names=("data",), aux_names=(), num_outputs=1,
             output_names=("output",), infer_params=None, optional_args=None,
             varargs=False, needs_rng=False, num_outputs_fn=None,
             attr_defaults=None, arg_names_fn=None, aliases=()):
    """Decorator registering an op implementation under ``name`` (and
    each of ``aliases``)."""

    def deco(fn):
        op = OpDef(name=name, fn=fn, arg_names=tuple(arg_names),
                   aux_names=tuple(aux_names), num_outputs=num_outputs,
                   output_names=tuple(output_names),
                   infer_params=infer_params, optional_args=optional_args,
                   varargs=varargs, needs_rng=needs_rng,
                   num_outputs_fn=num_outputs_fn,
                   attr_defaults=dict(attr_defaults or {}),
                   arg_names_fn=arg_names_fn, doc=fn.__doc__ or "")
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


def exists(name: str) -> bool:
    """Is ``name`` a registered op name (or alias)?"""
    return name in _OPS


def list_ops() -> list:
    return sorted(_OPS)


def decode_attr(value):
    """An attr as symbol JSON carries it, decoded the way
    :func:`mxnet_tpu_torch.symbol.load_json` decodes it: a string that
    is JSON (``"true"``, ``"0.5"``, ``"[3, 3]"``) becomes its value, any
    other value stays as it is (the ops read the rest with
    ``parse_attr``)."""
    if not isinstance(value, str):
        return value
    try:
        return json.loads(value)
    except json.JSONDecodeError:
        return value


def invoke(name: str, inputs, attrs=None, is_train: bool = True,
           device=None):
    """Run op ``name`` once, eagerly, on tensors (the imperative path;
    mirrors ``mxnet_tpu/ops/registry.py:invoke``).

    ``device`` is where an op without inputs (``_arange``) creates its
    output; it defaults to the first input's.  Returns the op's output
    or tuple of outputs; ops with aux states drop the aux updates, as
    the JAX package's imperative calls do.  A random op draws from the
    process generator of its device (:func:`mxnet_tpu_torch.random.generator`,
    as the JAX package draws ``random.next_key()``).  Runs under
    ``no_grad``: the imperative NDArray records no autograd graph.
    While the profiler runs in mode ``all`` the call is an
    ``imperative`` span that ends with a device sync."""
    op = get(name)
    attrs = {k: decode_attr(v) for k, v in (attrs or {}).items()}
    if device is None and inputs:
        device = inputs[0].device
    gen = None
    if op.needs_rng and device is not None:
        from .. import random as _random

        gen = _random.generator(device)
    ctx = OpCtx(is_train=is_train, device=device, generator=gen)
    # profiled imperative ops (MXNET_PROFILER_MODE=all): the span closes
    # after a device sync, so it times the op's work
    span = (_prof.span(op.name, device=str(device), category="imperative",
                       sync=_prof.device_sync(device))
            if _prof.is_running() and _prof.mode() == "all"
            else contextlib.nullcontext())
    with span, torch.no_grad():
        out = op.fn(ctx, *inputs, **attrs)
    if op.aux_names:
        out = out[0]
    from .. import engine

    return engine.on_push(out)
