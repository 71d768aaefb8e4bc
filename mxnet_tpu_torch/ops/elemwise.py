"""Elementwise ops of the port (``mxnet_tpu/ops/elemwise.py``): the unary
math table, ``Cast``, ``BlockGrad``, ``_copy``, the same-shape binaries
and their ``_scalar`` and ``broadcast_*`` forms, the comparisons,
``ElementWiseSum``, ``clip``, ``smooth_l1``, ``softmax`` and
``log_softmax``.  torch promotes mixed float dtypes as JAX does.

MXNet semantics kept: ``elemwise_*`` refuses operands of different
shapes (``broadcast_*`` broadcast); comparisons return 0/1 in the
input's dtype, not bool; a scalar is cast to the data's dtype before
the op.

Gradients are JAX's where torch's differ: ``abs`` passes the cotangent
unchanged at 0, ``power`` differentiates ``y * x**(y - 1)`` and ``log(x)
* x**y`` (0 read as 1 in the log) without torch's special cases, and
``clip`` is ``minimum(maximum(x, lo), hi)``, so a value on a bound gets
half the cotangent, as ``maximum``/``minimum`` split it at a tie in both
packages, and ``hypot`` is JAX's formula, which also gives each side half
the cotangent at the origin.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, numeric_dtype, parse_attr
from .registry import register


# ------------------------------------------------- JAX's gradient rules
class _Abs(torch.autograd.Function):
    """``abs`` with JAX's derivative: ``g`` where x >= 0, else ``-g``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


class _Pow(torch.autograd.Function):
    """``x ** y`` (broadcasting) with JAX's float derivatives: ``g * y *
    x ** (y - 1)`` for x, ``g * log(x or 1) * x ** y`` for y."""

    @staticmethod
    def forward(ctx, x, y):
        out = torch.pow(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, out = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = (g * (y * torch.pow(x, y - 1))).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            logx = torch.log(torch.where(x == 0, torch.ones_like(x), x))
            gy = (g * (logx * out)).sum_to_size(y.shape)
        return gx, gy


def _hypot(x, y):
    """``jnp.hypot``'s formula (broadcasting): ``M * sqrt(1 + (m / M)^2)``
    over ``M, m = max, min(|x|, |y|)``, 0 where M is 0, inf where either
    is inf — so its gradient is JAX's, at the origin too."""
    x, y = _Abs.apply(x), _Abs.apply(y)
    inf = torch.isposinf(x) | torch.isposinf(y)
    big, small = torch.maximum(x, y), torch.minimum(x, y)
    zero = big == 0
    ratio = small / torch.where(zero, torch.ones_like(big), big)
    out = torch.where(zero, big, big * torch.sqrt(1 + torch.square(ratio)))
    return torch.where(inf, torch.full_like(out, float("inf")), out)


def _gamma(x):
    """``exp(gammaln(x))``, as the reference computes it: |Gamma(x)|, the
    sign lost for negative x."""
    return torch.exp(torch.lgamma(x))


# ------------------------------------------------------------ unary math
_UNARY = {
    "abs": _Abs.apply,
    "arccos": torch.arccos,
    "arccosh": torch.arccosh,
    "arcsin": torch.arcsin,
    "arcsinh": torch.arcsinh,
    "arctan": torch.arctan,
    "arctanh": torch.arctanh,
    "ceil": torch.ceil,
    "cos": torch.cos,
    "cosh": torch.cosh,
    "degrees": torch.rad2deg,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "fix": torch.trunc,
    "floor": torch.floor,
    "gamma": _gamma,
    "gammaln": torch.lgamma,
    "log": torch.log,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "log2": torch.log2,
    "negative": torch.neg,
    "radians": torch.deg2rad,
    "rint": torch.round,    # half to even, as jnp.rint
    "round": torch.round,   # half to even, as jnp.round
    "rsqrt": torch.rsqrt,
    "sign": torch.sign,
    "sin": torch.sin,
    "sinh": torch.sinh,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "tan": torch.tan,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
}
for _name, _fn in _UNARY.items():
    register(_name)(lambda ctx, data, _fn=_fn, **attrs: _fn(data))

register("_copy", aliases=("identity",))(
    lambda ctx, data, **attrs: data.clone())


@register("BlockGrad", aliases=("stop_gradient",))
def _block_grad(ctx, data, **attrs):
    """Identity forward, zero gradient."""
    return data.detach()


@register("Cast", aliases=("cast",))
def _cast(ctx, data, **attrs):
    """``data`` in ``dtype``; ``.to`` keeps a channels-last tensor
    channels-last, and returns ``data`` itself when it already has the
    dtype.  The gradient is cast back to the input's dtype."""
    return data.to(numeric_dtype(parse_attr(attrs["dtype"])))


# ---------------------------------------------------- same-shape binaries
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
    "_power": (_Pow.apply, ("_Power",)),
    "_maximum": (torch.maximum, ("_Maximum",)),
    "_minimum": (torch.minimum, ("_Minimum",)),
    "_hypot": (_hypot, ()),
    # the gradient-aggregation add
    "_grad_add": (torch.add, ()),
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


@register("smooth_l1")
def _smooth_l1(ctx, data, **attrs):
    """``0.5 (sigma x)^2`` where ``|x| < 1/sigma^2``, else ``|x| - 0.5 /
    sigma^2``; sigma from the ``scalar`` (or ``sigma``) attr, 1 by
    default."""
    sigma = float(parse_attr(attrs.get("scalar", attrs.get("sigma", 1.0))))
    s2 = sigma * sigma
    a = _Abs.apply(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * torch.square(data),
                       a - 0.5 / s2)


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
    "_power_scalar": (_Pow.apply, False),
    "_rpower_scalar": (_Pow.apply, True),
    "_maximum_scalar": (torch.maximum, False),
    "_minimum_scalar": (torch.minimum, False),
    "_hypot_scalar": (_hypot, False),
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
    "broadcast_power": _Pow.apply,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": _hypot,
    "broadcast_plus": torch.add,
    "broadcast_minus": torch.sub,
}
_BROADCAST.update({f"broadcast{name}": _as_dtype(fn)
                   for name, fn in _LOGIC.items()})
for _name, _fn in _BROADCAST.items():
    register(_name, arg_names=("lhs", "rhs"))(
        lambda ctx, lhs, rhs, _fn=_fn, **attrs: _fn(lhs, rhs))


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(ctx, data, **attrs):
    """Each axis of ``axis`` (of size 1) repeated to its ``size``."""
    axes = parse_attr(attrs.get("axis", ()))
    sizes = parse_attr(attrs.get("size", ()))
    if isinstance(axes, int):
        axes = (axes,)
    if isinstance(sizes, int):
        sizes = (sizes,)
    shape = list(data.shape)
    for ax, sz in zip(axes, sizes):
        if shape[ax] != 1:
            raise MXNetError("broadcast_axis: source axis must have size 1")
        shape[ax] = sz
    return data.broadcast_to(tuple(shape))


@register("broadcast_to")
def _broadcast_to(ctx, data, **attrs):
    """A 0 in ``shape`` keeps the source's dim, as in MXNet."""
    shape = tuple(parse_attr(attrs["shape"]))
    shape = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return data.broadcast_to(shape)


@register("ElementWiseSum", varargs=True, aliases=("add_n", "_sum"))
def _element_wise_sum(ctx, *args, **attrs):
    """The sum of the inputs, added left to right."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("clip")
def _clip(ctx, data, **attrs):
    """``minimum(maximum(data, a_min), a_max)``, the bounds rounded to
    the data's dtype (``jnp.clip``, gradient included)."""
    lo, hi = (torch.full((), float(parse_attr(attrs[k])), dtype=data.dtype,
                         device=data.device) for k in ("a_min", "a_max"))
    return torch.minimum(torch.maximum(data, lo), hi)


@register("softmax")
def _softmax(ctx, data, **attrs):
    """Softmax over ``axis`` (default -1) as an activation, with its true
    gradient (``SoftmaxOutput`` is the loss op)."""
    return torch.softmax(data, int(parse_attr(attrs.get("axis", -1))))


@register("log_softmax")
def _log_softmax(ctx, data, **attrs):
    """``log(softmax(data))`` over ``axis`` (default -1), computed
    stably."""
    return torch.log_softmax(data, int(parse_attr(attrs.get("axis", -1))))
