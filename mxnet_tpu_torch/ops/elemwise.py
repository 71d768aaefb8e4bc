"""Elementwise ops of the port (a subset of ``mxnet_tpu/ops/elemwise.py``):
the same-shape binaries ``elemwise_add/sub/mul/div`` and ``_power`` with
their aliases, ``negative``, the ``_*_scalar`` family, the six
comparisons and their ``broadcast_*`` and ``_scalar`` forms, the
broadcasting arithmetic and ``broadcast_to`` — what ``NDArray``'s
operators dispatch to.  torch promotes mixed float dtypes as JAX does.

MXNet semantics kept: ``elemwise_*`` refuses operands of different
shapes (``broadcast_*`` broadcast); comparisons return 0/1 in the
input's dtype, not bool; a scalar is cast to the data's dtype before
the op.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, parse_attr
from .registry import register


def _same_shape(name, fn):
    bname = "broadcast_" + name.replace("elemwise_", "").strip("_")

    def impl(ctx, lhs, rhs, **attrs):
        if lhs.shape != rhs.shape:
            raise MXNetError(
                f"{name}: shapes {tuple(lhs.shape)} and {tuple(rhs.shape)} "
                f"differ; use {bname}")
        return fn(lhs, rhs)

    return impl


def _as_dtype(fn):
    """A comparison returning 0/1 in the left operand's dtype."""
    return lambda a, b: fn(a, b).to(a.dtype)


_BINARY = {
    "elemwise_add": (torch.add, ("_plus", "_add", "_Plus")),
    "elemwise_sub": (torch.sub, ("_minus", "_sub", "_Minus")),
    "elemwise_mul": (torch.mul, ("_mul", "_Mul")),
    "elemwise_div": (torch.true_divide, ("_div", "_Div")),
    "_power": (torch.pow, ("_Power",)),
}
_LOGIC = {
    "_equal": torch.eq, "_not_equal": torch.ne, "_greater": torch.gt,
    "_greater_equal": torch.ge, "_lesser": torch.lt, "_lesser_equal": torch.le,
}
for _name, (_fn, _aliases) in _BINARY.items():
    register(_name, arg_names=("lhs", "rhs"), aliases=_aliases)(
        _same_shape(_name, _fn))
for _name, _fn in _LOGIC.items():
    register(_name, arg_names=("lhs", "rhs"))(
        _same_shape(_name, _as_dtype(_fn)))

register("negative")(lambda ctx, data, **attrs: torch.neg(data))


# ---------------------------------------------------------------- scalars
def _scalar(fn, reverse):
    def impl(ctx, data, **attrs):
        # a 0-d tensor of the data's dtype: the scalar rounds to that
        # dtype first, as the JAX op's jnp.asarray(s, dtype) does, and
        # no host-to-device copy is made on the card (torch.full fills)
        s = torch.full((), parse_attr(attrs["scalar"]), dtype=data.dtype,
                       device=data.device)
        return fn(s, data) if reverse else fn(data, s)

    return impl


_SCALAR = {
    "_plus_scalar": (torch.add, False),
    "_minus_scalar": (torch.sub, False),
    "_rminus_scalar": (torch.sub, True),
    "_mul_scalar": (torch.mul, False),
    "_div_scalar": (torch.true_divide, False),
    "_rdiv_scalar": (torch.true_divide, True),
    "_power_scalar": (torch.pow, False),
    "_rpower_scalar": (torch.pow, True),
    "_maximum_scalar": (torch.maximum, False),
    "_minimum_scalar": (torch.minimum, False),
    "_hypot_scalar": (torch.hypot, False),
}
_SCALAR.update({f"{name}_scalar": (_as_dtype(fn), False)
                for name, fn in _LOGIC.items()})
for _name, (_fn, _rev) in _SCALAR.items():
    register(_name)(_scalar(_fn, _rev))


# ------------------------------------------------------------- broadcasts
_BROADCAST = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.true_divide,
}
_BROADCAST.update({f"broadcast{name}": _as_dtype(fn)
                   for name, fn in _LOGIC.items()})
for _name, _fn in _BROADCAST.items():
    register(_name, arg_names=("lhs", "rhs"))(
        lambda ctx, lhs, rhs, _fn=_fn, **attrs: _fn(lhs, rhs))


@register("broadcast_to")
def _broadcast_to(ctx, data, **attrs):
    """A 0 in ``shape`` keeps the source's dim, as in MXNet."""
    shape = tuple(parse_attr(attrs["shape"]))
    shape = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return data.broadcast_to(shape)
