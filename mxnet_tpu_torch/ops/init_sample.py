"""Creation ops of the port (``_arange`` from
``mxnet_tpu/ops/init_sample.py``; the sampling ops wait for ROADMAP
Queue 1 item 1's random ``nd`` ops)."""
from __future__ import annotations

import torch

from ..base import numeric_dtype, parse_attr
from .registry import register


@register("_arange", arg_names=())
def _arange(ctx, **attrs):
    """``start``/``stop``/``step`` as ``numpy.arange`` (one bound means
    ``[0, start)``), each value repeated ``repeat`` times, in ``dtype``
    (float32 by default), on ``ctx.device``."""
    start = parse_attr(attrs.get("start", 0))
    stop = parse_attr(attrs.get("stop", None))
    step = parse_attr(attrs.get("step", 1.0))
    repeat = int(parse_attr(attrs.get("repeat", 1)))
    if stop in (None, "None"):
        start, stop = 0, start
    out = torch.arange(start, stop, step,
                       dtype=numeric_dtype(attrs.get("dtype", "float32")),
                       device=ctx.device)
    if repeat > 1:
        out = out.repeat_interleave(repeat)
    return out
