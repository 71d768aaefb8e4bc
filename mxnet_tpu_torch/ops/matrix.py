"""Matrix and shape ops of the port (``mxnet_tpu/ops/matrix.py``, every
name it registers): ``dot``, ``batch_dot``, ``transpose``,
``SwapAxis``, ``Reshape``, ``Flatten``, ``expand_dims``, ``crop``,
``slice_axis``, ``flip``, ``repeat``, ``tile``, the ordering ops
``sort``/``argsort``/``topk`` and the assignment helpers
``_crop_assign``/``_crop_assign_scalar``/``_identity_with_attr_like_rhs``.

Products of mixed dtypes promote as the JAX ops do (torch's matmul
refuses mixed operands).  The ordering ops sort stably, as
``jnp.argsort`` and ``lax.top_k`` do, and return indices in the data's
dtype (in bf16 an index above 256 rounds, as in the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, parse_attr, parse_bool
from .registry import register


def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _reverse_axes(t):
    """``t.T`` of numpy: every axis reversed."""
    return t.permute(*reversed(range(t.ndim)))


@register("dot", arg_names=("lhs", "rhs"))
def _dot(ctx, lhs, rhs, **attrs):
    """``jnp.dot``: the last axis of ``lhs`` against the second-to-last
    of ``rhs`` (its only axis when 1-D); 1-D x 1-D gives shape ``(1,)``.
    ``transpose_a``/``transpose_b`` reverse every axis of that operand
    first (numpy's ``.T``)."""
    a, b = _promoted(lhs, rhs)
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b).reshape((1,))
    if parse_bool(attrs.get("transpose_a", False)):
        a = _reverse_axes(a)
    if parse_bool(attrs.get("transpose_b", False)):
        b = _reverse_axes(b)
    if a.ndim <= 2 and b.ndim <= 2:
        return a @ b
    return torch.tensordot(a, b, dims=([a.ndim - 1], [max(b.ndim - 2, 0)]))


@register("batch_dot", arg_names=("lhs", "rhs"))
def _batch_dot(ctx, lhs, rhs, **attrs):
    """``(B, M, K) x (B, K, N)``, the last two axes of either operand
    swapped first under ``transpose_a``/``transpose_b``."""
    a, b = _promoted(lhs, rhs)
    if parse_bool(attrs.get("transpose_a", False)):
        a = a.transpose(-1, -2)
    if parse_bool(attrs.get("transpose_b", False)):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


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


@register("SwapAxis", aliases=("swapaxes",))
def _swapaxis(ctx, data, **attrs):
    return data.transpose(int(parse_attr(attrs.get("dim1", 0))),
                          int(parse_attr(attrs.get("dim2", 0))))


@register("Reshape", aliases=("reshape",))
def _reshape(ctx, data, **attrs):
    """0 / -1 shape codes; a view where torch can make one.  ``shape``,
    or ``target_shape`` (the v0.9.4 spelling older symbol JSON carries)."""
    shape = parse_attr(attrs.get("shape", attrs.get("target_shape")))
    target = _infer_reshape(tuple(data.shape), tuple(shape))
    from ..parallel import mesh as _mesh

    if _mesh.is_dtensor(data):
        return _reshape_placed(data, target)
    return data.reshape(target)


def _reshape_placed(data, target):
    """Reshape of a DTensor (a mesh).  DTensor keeps a split through a
    reshape where the split dimension's blocks stay whole (d_model into
    heads over a ``model`` axis that divides the heads); where they would
    not (2 heads over 4 ranks), the tensor keeps only its split of the
    rows and is gathered on the rest first, as GSPMD re-shards."""
    from torch.distributed.tensor import Replicate, Shard

    try:
        return data.reshape(target)
    except RuntimeError:
        place = tuple(p if isinstance(p, Shard) and p.dim == 0
                      else Replicate() for p in data.placements)
        if place == tuple(data.placements):
            raise
    return data.redistribute(data.device_mesh, place).reshape(target)


@register("Flatten", aliases=("flatten",))
def _flatten(ctx, data, **attrs):
    """Collapse all but axis 0 (of the logical layout: a channels-last
    tensor flattens in NCHW order, copying where it must)."""
    return data.reshape(data.shape[0], -1)


@register("expand_dims")
def _expand_dims(ctx, data, **attrs):
    return data.unsqueeze(int(parse_attr(attrs["axis"])))


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


@register("flip")
def _flip(ctx, data, **attrs):
    axis = parse_attr(attrs["axis"])
    return torch.flip(data, (axis,) if isinstance(axis, int) else
                      tuple(axis))


@register("repeat")
def _repeat(ctx, data, **attrs):
    """Each element ``repeats`` times along ``axis`` (the flattened
    array when there is none)."""
    axis = parse_attr(attrs.get("axis", None))
    return torch.repeat_interleave(
        data, int(parse_attr(attrs["repeats"])),
        dim=None if axis in (None, "None") else int(axis))


@register("tile")
def _tile(ctx, data, **attrs):
    return torch.tile(data, tuple(parse_attr(attrs["reps"])))


# --- ordering ---------------------------------------------------------
def _sort_axis(data, attrs):
    """``(data, axis)``: ``axis=None`` sorts the flattened array."""
    axis = parse_attr(attrs.get("axis", -1))
    if axis in (None, "None"):
        return data.reshape(-1), 0
    return data, int(axis)


@register("sort")
def _sort(ctx, data, **attrs):
    data, axis = _sort_axis(data, attrs)
    out = torch.sort(data, dim=axis, stable=True).values
    if parse_bool(attrs.get("is_ascend", True)):
        return out
    return torch.flip(out, (axis,))


@register("argsort")
def _argsort(ctx, data, **attrs):
    """The stable ascending order, flipped for ``is_ascend=False``: equal
    values then come out in reverse index order, as in the JAX op (a
    stable descending sort would keep them in index order)."""
    data, axis = _sort_axis(data, attrs)
    idx = torch.argsort(data, dim=axis, stable=True)
    if not parse_bool(attrs.get("is_ascend", True)):
        idx = torch.flip(idx, (axis,))
    return idx.to(data.dtype)


@register("topk", num_outputs=2, output_names=("output", "indices"))
def _topk(ctx, data, **attrs):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, ties in
    index order as ``lax.top_k`` gives them.  ``ret_typ`` selects what
    comes out: ``indices`` (default, in the data's dtype), ``value``,
    ``both`` (values, indices) or ``mask`` (1 where an element was
    chosen)."""
    axis = parse_attr(attrs.get("axis", -1))
    k = int(parse_attr(attrs.get("k", 1)))
    ret_typ = attrs.get("ret_typ", "indices")
    ascend = parse_bool(attrs.get("is_ascend", False))
    axis = data.ndim - 1 if axis in (None, "None") \
        else int(axis) % data.ndim
    order = torch.sort(data, dim=axis, descending=not ascend, stable=True)
    vals = order.values.narrow(axis, 0, k)
    idx = order.indices.narrow(axis, 0, k)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return (vals, idx.to(data.dtype))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(
            axis, idx, torch.ones_like(vals))
    return idx.to(data.dtype)


# --- assignment -------------------------------------------------------
@register("_identity_with_attr_like_rhs", arg_names=("lhs", "rhs"))
def _identity_like_rhs(ctx, lhs, rhs, **attrs):
    return lhs + torch.zeros_like(rhs)


def _crop_index(attrs):
    begin = tuple(parse_attr(attrs["begin"]))
    end = tuple(parse_attr(attrs["end"]))
    return tuple(slice(b, e) for b, e in zip(begin, end))


@register("_crop_assign", arg_names=("lhs", "rhs"))
def _crop_assign(ctx, lhs, rhs, **attrs):
    """A copy of ``lhs`` with the ``begin``/``end`` box set to ``rhs``
    (cast to ``lhs``'s dtype)."""
    out = lhs.clone()
    out[_crop_index(attrs)] = rhs.to(out.dtype)
    return out


@register("_crop_assign_scalar")
def _crop_assign_scalar(ctx, data, **attrs):
    out = data.clone()
    out[_crop_index(attrs)] = parse_attr(attrs.get("scalar", 0.0))
    return out
