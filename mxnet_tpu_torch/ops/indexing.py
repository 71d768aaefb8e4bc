"""Indexing ops of the port (``Embedding`` from
``mxnet_tpu/ops/indexing.py``)."""
from __future__ import annotations

import torch.nn.functional as F

from ..base import parse_attr
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
