"""Reduction ops of the port (``mxnet_tpu/ops/reduce.py``, every name it
registers): ``sum``/``sum_axis``, ``mean``, ``prod``, ``nansum``,
``nanprod``, ``max``/``max_axis``, ``min``/``min_axis``, ``norm`` and
``argmax``/``argmin``/``argmax_channel``.

``axis`` may be an int, a tuple or empty (reduce everything), with
``keepdims``.  ``max``/``min`` reduce with ``amax``/``amin``, whose
gradient splits evenly among tied entries, as ``jax.grad`` of
``jnp.max`` does (``torch.max(dim)`` would give all of it to one).  The
arg ops return the first index of a tie, as float values in the data's
dtype (MXNet's convention).
"""
from __future__ import annotations

import torch

from ..base import parse_attr, parse_bool
from .registry import register


def _axes(attrs, data):
    """The reduced axes as a tuple (all of them when none are given)."""
    axis = parse_attr(attrs.get("axis", None))
    if axis is None or axis == () or axis == []:
        return tuple(range(data.ndim))
    if isinstance(axis, int):
        return (axis,)
    return tuple(axis)


def _keep(attrs):
    return parse_bool(attrs.get("keepdims", False))


def _prod(data, axes, keepdims):
    """``prod`` over several axes (``torch.prod`` takes one): the reduced
    axes moved last and flattened."""
    axes = sorted(a % data.ndim for a in axes) if data.ndim else []
    rest = [a for a in range(data.ndim) if a not in axes]
    moved = data.permute(*rest, *axes)
    out = moved.reshape(moved.shape[:len(rest)] + (-1,)).prod(-1)
    if keepdims:
        out = out.reshape([1 if a in axes else data.shape[a]
                           for a in range(data.ndim)])
    return out


_REDUCE = {
    "sum": lambda x, ax, kd: torch.sum(x, ax, keepdim=kd),
    "mean": lambda x, ax, kd: torch.mean(x, ax, keepdim=kd),
    "prod": _prod,
    "nansum": lambda x, ax, kd: torch.nansum(x, ax, keepdim=kd),
    "nanprod": lambda x, ax, kd: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x), ax, kd),
    "max": lambda x, ax, kd: torch.amax(x, ax, keepdim=kd),
    "min": lambda x, ax, kd: torch.amin(x, ax, keepdim=kd),
}
_ALIASES = {"sum": ("sum_axis",), "max": ("max_axis",), "min": ("min_axis",)}


def _reduce(fn):
    def impl(ctx, data, **attrs):
        return fn(data, _axes(attrs, data), _keep(attrs))

    return impl


for _name, _fn in _REDUCE.items():
    register(_name, aliases=_ALIASES.get(_name, ()))(_reduce(_fn))


@register("norm")
def _norm(ctx, data, **attrs):
    """L2 over the whole array, shape ``(1,)``."""
    return torch.sqrt(torch.sum(data.square())).reshape((1,))


def _arg_reduce(fn):
    def impl(ctx, data, **attrs):
        axis = parse_attr(attrs.get("axis", None))
        if axis is None:
            return fn(data.reshape(-1), 0).to(data.dtype)
        return fn(data, int(axis), _keep(attrs)).to(data.dtype)

    return impl


register("argmax")(_arg_reduce(
    lambda x, ax, kd=False: torch.argmax(x, ax, keepdim=kd)))
register("argmin")(_arg_reduce(
    lambda x, ax, kd=False: torch.argmin(x, ax, keepdim=kd)))


@register("argmax_channel")
def _argmax_channel(ctx, data, **attrs):
    """argmax over axis 1, as a float in the data's dtype."""
    return torch.argmax(data, 1).to(data.dtype)
