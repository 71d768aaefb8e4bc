"""Indexing ops of the port (``Embedding`` and ``one_hot`` from
``mxnet_tpu/ops/indexing.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import numeric_dtype, parse_attr
from .registry import register


def _embedding_params(attrs, *in_shapes):
    inp = int(parse_attr(attrs["input_dim"]))
    out = int(parse_attr(attrs["output_dim"]))
    return {"weight": (inp, out)}


@register("Embedding", arg_names=("data", "weight"),
          infer_params=_embedding_params)
def _embedding(ctx, data, weight, **attrs):
    """``data`` holds float ids (MXNet's convention), truncated to
    integers and clipped to the table; output ``data.shape +
    (output_dim,)``."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


@register("one_hot", aliases=("_onehot_encode",))
def _one_hot(ctx, data, **attrs):
    """``data`` holds float ids, truncated to integers; ids outside
    ``[0, depth)`` give a row of ``off_value`` (as ``jax.nn.one_hot``).
    Output ``data.shape + (depth,)`` in ``dtype`` (float32 default)."""
    depth = int(parse_attr(attrs["depth"]))
    on = float(parse_attr(attrs.get("on_value", 1.0)))
    off = float(parse_attr(attrs.get("off_value", 0.0)))
    dtype = numeric_dtype(attrs.get("dtype", "float32"))
    idx = data.to(torch.int32)
    classes = torch.arange(depth, dtype=torch.int32, device=data.device)
    hot = idx.unsqueeze(-1) == classes
    on, off = (torch.full((), v, dtype=dtype, device=data.device)
               for v in (on, off))
    return torch.where(hot, on, off)
