"""Neural-network layer ops of the port (a subset of
``mxnet_tpu/ops/nn.py``): FullyConnected, LayerNorm and Activation.

Mixed dtypes promote as the JAX package's do (bf16 with fp32 gives
fp32): torch's matmul refuses mixed operands, so FullyConnected casts
both to the promoted type first.  The rest of ``ops/nn.py``
(Convolution, BatchNorm, Pooling, Dropout, ...) waits for ROADMAP
Queue 1 item 2.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, parse_attr, parse_bool
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
