"""Creation and sampling ops of the port (``mxnet_tpu/ops/init_sample.py``,
every name it registers): ``_zeros``, ``_ones``, ``_full``, ``_arange``,
``_set_value``, and ``uniform``/``normal`` with their aliases.  Each
makes its output on ``ctx.device``, in ``dtype`` (float32 by default);
the samplers draw from ``ctx.generator`` (the JAX ops draw from a PRNG
key: the two packages' draws agree in distribution, not in value)."""
from __future__ import annotations

import torch

from ..base import numeric_dtype, parse_attr
from .registry import register


def _dtype_of(attrs):
    dt = attrs.get("dtype")
    return numeric_dtype("float32" if dt is None else dt)


def _shape(attrs, key="shape"):
    return tuple(parse_attr(attrs[key]))


@register("_zeros", arg_names=())
def _zeros(ctx, **attrs):
    return torch.zeros(_shape(attrs), dtype=_dtype_of(attrs),
                       device=ctx.device)


@register("_ones", arg_names=())
def _ones(ctx, **attrs):
    return torch.ones(_shape(attrs), dtype=_dtype_of(attrs),
                      device=ctx.device)


@register("_full", arg_names=())
def _full(ctx, **attrs):
    return torch.full(_shape(attrs), parse_attr(attrs["value"]),
                      dtype=_dtype_of(attrs), device=ctx.device)


@register("_set_value", arg_names=())
def _set_value(ctx, **attrs):
    """The NDArray function ``_set_value``: ``shape`` filled with
    ``src``."""
    return torch.full(_shape(attrs), parse_attr(attrs["src"]),
                      dtype=_dtype_of(attrs), device=ctx.device)


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
    out = torch.arange(start, stop, step, dtype=_dtype_of(attrs),
                       device=ctx.device)
    if repeat > 1:
        out = out.repeat_interleave(repeat)
    return out


@register("uniform", arg_names=(), needs_rng=True,
          aliases=("_sample_uniform", "random_uniform"))
def _uniform(ctx, **attrs):
    """``U[low, high)`` of ``shape``."""
    low = float(parse_attr(attrs.get("low", 0.0)))
    high = float(parse_attr(attrs.get("high", 1.0)))
    out = torch.empty(_shape(attrs), dtype=_dtype_of(attrs),
                      device=ctx.device)
    return out.uniform_(low, high, generator=ctx.generator)


@register("normal", arg_names=(), needs_rng=True,
          aliases=("_sample_normal", "random_normal"))
def _normal(ctx, **attrs):
    """``loc + scale * N(0, 1)`` of ``shape``."""
    loc = float(parse_attr(attrs.get("loc", 0.0)))
    scale = float(parse_attr(attrs.get("scale", 1.0)))
    out = torch.empty(_shape(attrs), dtype=_dtype_of(attrs),
                      device=ctx.device)
    return loc + scale * out.normal_(generator=ctx.generator)
