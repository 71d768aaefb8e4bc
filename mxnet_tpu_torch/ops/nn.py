"""Neural-network layer ops of the port (a subset of
``mxnet_tpu/ops/nn.py``): FullyConnected, LayerNorm, Activation,
Convolution, BatchNorm and Pooling.

Mixed dtypes promote as the JAX package's do (bf16 with fp32 gives
fp32): torch's matmul and convolution refuse mixed operands, so
FullyConnected and Convolution cast both to the promoted type first.

Layout: tensors are logical NCHW, as at the JAX package's public
functions.  The JAX executor's channels-last layout pass becomes torch's
``channels_last`` memory format (ops keep the format they are given,
and cuDNN keeps it through conv, BN, ReLU, pooling and the adds), so no
op reads the ``__layout__`` attr that pass injects at trace time.  1-D
and 3-D convolution and pooling, Deconvolution, Dropout and the rest of
``ops/nn.py`` wait for ROADMAP Queue 1 item 2.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, normalize_tuple, parse_attr, parse_bool
from .registry import register


def _fc_params(attrs, data_shape, *rest):
    num_hidden = int(parse_attr(attrs["num_hidden"]))
    in_dim = int(np.prod(data_shape[1:]))
    shapes = {"weight": (num_hidden, in_dim)}
    if not parse_bool(attrs.get("no_bias", False)):
        shapes["bias"] = (num_hidden,)
    return shapes


def _no_bias_drop(attrs):
    return {"bias"} if parse_bool(attrs.get("no_bias", False)) else set()


@register("FullyConnected", arg_names=("data", "weight", "bias"),
          infer_params=_fc_params,
          optional_args=_no_bias_drop)
def _fully_connected(ctx, data, weight, bias=None, **attrs):
    """Always flattens trailing dims; the weight is ``(out, in)``.  The
    bias is added after the product is rounded, as the JAX op does."""
    x = data.reshape(data.shape[0], -1)
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = x.to(dt) @ weight.to(dt).t()
    if bias is not None:
        out = out + bias
    return out


def _ln_params(attrs, data_shape, *rest):
    axis = int(attrs.get("axis", -1))
    return {"gamma": (data_shape[axis],), "beta": (data_shape[axis],)}


@register("LayerNorm", arg_names=("data", "gamma", "beta"),
          infer_params=_ln_params)
def _layer_norm(ctx, data, gamma, beta, **attrs):
    """Normalise over ``axis`` (default last) with single-pass fp32
    moments, ``E[x²] - E[x]²`` clamped at 0; the result is cast back to
    the input dtype."""
    eps = float(parse_attr(attrs.get("eps", 1e-5)))
    axis = int(parse_attr(attrs.get("axis", -1)))
    x32 = data.float()
    mean = x32.mean(axis, keepdim=True)
    var = (x32.square().mean(axis, keepdim=True)
           - mean.square()).clamp_min(0.0)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    bshape = [1] * data.ndim
    bshape[axis] = data.shape[axis]
    out = out * gamma.reshape(bshape).float() + beta.reshape(bshape).float()
    return out.to(data.dtype)


@register("Activation")
def _activation(ctx, data, **attrs):
    """act_type relu / sigmoid / tanh / softrelu / gelu (``jax.nn.gelu``'s
    default, the tanh form)."""
    act = attrs.get("act_type", "relu")
    if act == "relu":
        return torch.relu(data)
    if act == "sigmoid":
        return torch.sigmoid(data)
    if act == "tanh":
        return torch.tanh(data)
    if act == "softrelu":
        return torch.logaddexp(data, torch.zeros_like(data))
    if act == "gelu":
        return F.gelu(data, approximate="tanh")
    raise MXNetError(f"Activation: unknown act_type {act}")


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------
def _conv_attrs(attrs):
    kernel = normalize_tuple(attrs["kernel"], 2, "kernel")
    stride = normalize_tuple(attrs.get("stride", (1, 1)), 2, "stride")
    pad = normalize_tuple(attrs.get("pad", (0, 0)), 2, "pad")
    dilate = normalize_tuple(attrs.get("dilate", (1, 1)), 2, "dilate")
    num_filter = int(parse_attr(attrs["num_filter"]))
    num_group = int(parse_attr(attrs.get("num_group", 1)))
    no_bias = parse_bool(attrs.get("no_bias", False))
    return kernel, stride, pad, dilate, num_filter, num_group, no_bias


def _conv_params(attrs, data_shape, *rest):
    kernel, _, _, _, num_filter, num_group, no_bias = _conv_attrs(attrs)
    shapes = {"weight": (num_filter, data_shape[1] // num_group)
              + tuple(kernel)}
    if not no_bias:
        shapes["bias"] = (num_filter,)
    return shapes


@register("Convolution", arg_names=("data", "weight", "bias"),
          infer_params=_conv_params, optional_args=_no_bias_drop)
def _convolution(ctx, data, weight, bias=None, **attrs):
    """2-D convolution (cuDNN on the card); the weight is OIHW as in the
    JAX package.  The bias is added to the rounded product, as the JAX
    op adds it after ``conv_general_dilated``."""
    if data.ndim != 4:
        raise MXNetError(f"Convolution on {data.ndim}-D data is not ported "
                         "yet (ROADMAP Queue 1 item 2)")
    _, stride, pad, dilate, _, num_group, _ = _conv_attrs(attrs)
    dt = torch.promote_types(data.dtype, weight.dtype)
    out = F.conv2d(data.to(dt), weight.to(dt), None, stride, pad, dilate,
                   num_group)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------
def _bn_params(attrs, data_shape, *rest):
    c = data_shape[1]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


@register("BatchNorm", arg_names=("data", "gamma", "beta"),
          aux_names=("moving_mean", "moving_var"), infer_params=_bn_params)
def _batch_norm(ctx, data, gamma, beta, moving_mean, moving_var, **attrs):
    """Defaults as the JAX op: eps 1e-3, momentum 0.9, fix_gamma True.
    Returns ``(out, (new_moving_mean, new_moving_var))``.

    Eval mode (or use_global_stats): ``(x - mean) * rsqrt(var + eps) *
    gamma + beta`` from the moving stats, in the data's dtype (promoted
    with the stats' as JAX promotes), the stats passed through.  Train
    mode: single-pass fp32 moments with the biased ``E[x^2] - E[x]^2``
    (clamped at 0), the moving stats updated as ``moving * m + batch *
    (1 - m)`` — not torch's ``batch_norm`` update, whose variance is
    unbiased and whose momentum runs the other way."""
    eps = float(parse_attr(attrs.get("eps", 1e-3)))
    momentum = float(parse_attr(attrs.get("momentum", 0.9)))
    fix_gamma = parse_bool(attrs.get("fix_gamma", True))
    use_global = parse_bool(attrs.get("use_global_stats", False))
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    axes = (0,) + tuple(range(2, data.ndim))
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    if ctx.is_train and not use_global:
        if os.environ.get("MXTPU_BN_STATS_DTYPE") == "compute":
            raise MXNetError("MXTPU_BN_STATS_DTYPE=compute is not ported "
                             "yet (ROADMAP Queue 1 item 2)")
        n = 1.0
        for ax in axes:
            n *= data.shape[ax]
        data32 = data.float()
        mean32 = data32.sum(axes) / n
        sqmean = data32.square().sum(axes) / n
        var32 = (sqmean - mean32.square()).clamp_min(0.0)
        mean = mean32.to(data.dtype)
        var = var32.to(data.dtype)
        new_mean = (moving_mean * momentum + mean32 * (1 - momentum)).detach()
        new_var = (moving_var * momentum + var32 * (1 - momentum)).detach()
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = (data - mean.reshape(bshape)) * inv.reshape(bshape) \
        * gamma.reshape(bshape) + beta.reshape(bshape)
    return out, (new_mean, new_var)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------
@register("Pooling")
def _pooling(ctx, data, **attrs):
    """2-D max / avg / sum pooling; ``global_pool``; pooling_convention
    ``valid`` (floor, default) or ``full`` (ceil: the right edge is
    extended until the last window fits, as the JAX op pads it).  max
    pads with -inf; avg counts the padding and divides by the kernel's
    size (count-include-pad)."""
    if data.ndim != 4:
        raise MXNetError(f"Pooling on {data.ndim}-D data is not ported yet "
                         "(ROADMAP Queue 1 item 2)")
    x = data
    if parse_bool(attrs.get("global_pool", False)):
        kernel = tuple(x.shape[2:])
        stride, pad = (1, 1), (0, 0)
    else:
        kernel = normalize_tuple(attrs["kernel"], 2, "kernel")
        stride = normalize_tuple(attrs.get("stride", (1, 1)), 2, "stride")
        pad = normalize_tuple(attrs.get("pad", (0, 0)), 2, "pad")
    pool_type = attrs.get("pool_type", "max")
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"Pooling: unknown pool_type {pool_type}")
    extra = [0, 0]  # right-edge extension of the "full" convention
    if attrs.get("pooling_convention", "valid") == "full":
        for i in range(2):
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                extra[i] = stride[i] - rem
    # torch pads symmetrically and at most half a window; anything else
    # is padded here first (-inf for max, 0 for the sums)
    if any(extra) or any(p > k // 2 for p, k in zip(pad, kernel)):
        fill = float("-inf") if pool_type == "max" else 0.0
        x = F.pad(x, (pad[1], pad[1] + extra[1], pad[0], pad[0] + extra[0]),
                  value=fill)
        pad = (0, 0)
    if pool_type == "max":
        out = F.max_pool2d(x, kernel, stride, pad)
    else:
        # sum over the window (padding included) / kernel size, or / 1
        div = int(np.prod(kernel)) if pool_type == "avg" else 1
        out = F.avg_pool2d(x, kernel, stride, pad, count_include_pad=True,
                           divisor_override=div)
    return out.to(data.dtype)
