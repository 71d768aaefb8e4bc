"""Shape ops of the port (a subset of ``mxnet_tpu/ops/matrix.py``):
``transpose``, ``Reshape``, ``Flatten``, ``crop``/``slice`` and
``slice_axis``."""
from __future__ import annotations

import numpy as np

from ..base import MXNetError, parse_attr
from .registry import register


@register("transpose")
def _transpose(ctx, data, **attrs):
    axes = parse_attr(attrs.get("axes", None))
    if axes is None or axes == ():
        return data.permute(*reversed(range(data.ndim)))
    return data.permute(*axes)


def _infer_reshape(shape, target):
    """MXNet's reshape codes: 0 copies the input dim, -1 infers.  The
    later codes -2/-3/-4 are refused, as the reference knows only 0 and
    -1 too."""
    target = list(target)
    for code in (-2, -3, -4):
        if code in target:
            raise MXNetError(f"Reshape: shape code {code} is not supported "
                             f"(only 0 and -1); got shape {tuple(target)}")
    for i, t in enumerate(target):
        if t == 0:
            target[i] = shape[i]
    if -1 in target:
        known = int(np.prod([t for t in target if t != -1]))
        total = int(np.prod(shape))
        target[target.index(-1)] = total // max(known, 1)
    return tuple(int(t) for t in target)


@register("Reshape")
def _reshape(ctx, data, **attrs):
    """0 / -1 shape codes; a view where torch can make one.  ``shape``,
    or ``target_shape`` (the v0.9.4 spelling older symbol JSON carries)."""
    shape = parse_attr(attrs.get("shape", attrs.get("target_shape")))
    return data.reshape(_infer_reshape(tuple(data.shape), tuple(shape)))


@register("Flatten", aliases=("flatten",))
def _flatten(ctx, data, **attrs):
    """Collapse all but axis 0 (of the logical layout: a channels-last
    tensor flattens in NCHW order, copying where it must)."""
    return data.reshape(data.shape[0], -1)


@register("crop", aliases=("slice",))
def _slice(ctx, data, **attrs):
    """Per-axis ``begin``/``end`` (None: from the start / to the end)."""
    begin = tuple(parse_attr(attrs["begin"]))
    end = tuple(parse_attr(attrs["end"]))
    return data[tuple(slice(b, e) for b, e in zip(begin, end))]


@register("slice_axis")
def _slice_axis(ctx, data, **attrs):
    """``end`` may be None for "to the end"."""
    axis = int(parse_attr(attrs["axis"]))
    begin = int(parse_attr(attrs["begin"]))
    end = parse_attr(attrs.get("end", None))
    idx = [slice(None)] * data.ndim
    idx[axis] = slice(begin, None if end in (None, "None") else int(end))
    return data[tuple(idx)]
