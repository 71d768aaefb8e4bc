"""Elementwise ops of the port (a subset of ``mxnet_tpu/ops/elemwise.py``):
``elemwise_add`` and its aliases, ``_plus_scalar`` and
``broadcast_add``.  torch promotes mixed float dtypes as JAX does."""
from __future__ import annotations

import torch

from ..base import MXNetError, parse_attr
from .registry import register


@register("elemwise_add", arg_names=("lhs", "rhs"),
          aliases=("_plus", "_add", "_Plus"))
def _elemwise_add(ctx, lhs, rhs, **attrs):
    if lhs.shape != rhs.shape:
        raise MXNetError(f"elemwise_add: shapes {tuple(lhs.shape)} and "
                         f"{tuple(rhs.shape)} differ; use broadcast_add")
    return lhs + rhs


@register("_plus_scalar")
def _plus_scalar(ctx, data, **attrs):
    """The scalar is cast to data's dtype first."""
    s = torch.tensor(parse_attr(attrs["scalar"]), dtype=data.dtype,
                     device=data.device)
    return data + s


@register("broadcast_add", arg_names=("lhs", "rhs"))
def _broadcast_add(ctx, lhs, rhs, **attrs):
    return lhs + rhs
