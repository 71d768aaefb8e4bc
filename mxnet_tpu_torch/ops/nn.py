"""Neural-network layer ops of the port (``mxnet_tpu/ops/nn.py``, every
name it registers): FullyConnected, LayerNorm, Activation, LeakyReLU,
Convolution and Deconvolution (1-, 2- and 3-D), BatchNorm,
InstanceNorm, L2Normalization, Pooling (1-, 2- and 3-D), Dropout, LRN,
Concat, SliceChannel, Pad, UpSampling and Crop.

Mixed dtypes promote as the JAX package's do (bf16 with fp32 gives
fp32): torch's matmul and convolution refuse mixed operands, so
FullyConnected and the convolutions cast both to the promoted type
first.

Layout: tensors are logical NCHW, as at the JAX package's public
functions.  The JAX executor's channels-last layout pass becomes torch's
``channels_last`` memory format (ops keep the format they are given,
and cuDNN keeps it through conv, BN, ReLU, pooling, the adds and
``torch.cat``), so no op reads the ``__layout__`` attr that pass injects
at trace time.

Random ops (Dropout, LeakyReLU's rrelu) draw from ``OpCtx.generator``,
the generator the executor or trainer hands to the graph; the two
packages' generators differ, so their draws are compared by statistics.
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


_NUMPY_FLOAT = {torch.float16: np.float16, torch.float32: np.float32,
                torch.float64: np.float64}


def _weak(value, like):
    """The Python scalar ``value`` rounded to ``like``'s dtype: a JAX op
    converts a Python scalar to its array's dtype before the arithmetic
    (a weak type), where torch computes with it in fp32.  Rounded on the
    host with numpy (bf16: round to nearest even on the fp32 bits), so a
    graph's ops make no tensor of it."""
    if not like.dtype.is_floating_point:
        return value
    if like.dtype == torch.bfloat16:
        bits = np.array(value, np.float32).view(np.uint32)
        bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
            & np.uint32(0xFFFF0000)
        return float(bits.view(np.float32))
    return float(_NUMPY_FLOAT[like.dtype](value))


def _prelu_params(attrs, data_shape, *rest):
    if attrs.get("act_type", "leaky") == "prelu":
        return {"gamma": (data_shape[1],)}
    return {}


def _leaky_optional(attrs):
    return set() if attrs.get("act_type", "leaky") == "prelu" else {"gamma"}


def _uniform(ctx, shape, lo, hi, like):
    """fp32 ``U[lo, hi)`` of ``shape`` on ``like``'s device, from the
    graph's generator, in ``like``'s memory format where the shapes
    agree."""
    if tuple(shape) == tuple(like.shape):
        u = torch.empty_like(like, dtype=torch.float32)
    else:
        u = torch.empty(shape, dtype=torch.float32, device=like.device)
    return u.uniform_(lo, hi, generator=ctx.generator)


@register("LeakyReLU", arg_names=("data", "gamma"),
          infer_params=_prelu_params, optional_args=_leaky_optional,
          needs_rng=True)
def _leaky_relu(ctx, data, gamma=None, **attrs):
    """act_type leaky / elu (``slope``), prelu (the learned per-channel
    ``gamma``) or rrelu: a slope per channel drawn from ``U[lower_bound,
    upper_bound)`` in training (fp32, so bf16 data promotes, as the JAX
    op's fp32 draw does), their mean at eval."""
    act = attrs.get("act_type", "leaky")
    slope = _weak(float(parse_attr(attrs.get("slope", 0.25))), data)
    if act == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2))
        return torch.where(data > 0, data, g * data)
    if act == "rrelu":
        lo = float(parse_attr(attrs.get("lower_bound", 0.125)))
        hi = float(parse_attr(attrs.get("upper_bound", 0.334)))
        if ctx.is_train:
            s = _uniform(ctx, (1, data.shape[1]) + (1,) * (data.ndim - 2),
                         lo, hi, data)
        else:
            s = _weak((lo + hi) / 2.0, data)
        return torch.where(data > 0, data, s * data)
    raise MXNetError(f"LeakyReLU: unknown act_type {act}")


@register("Dropout", needs_rng=True)
def _dropout(ctx, data, **attrs):
    """Inverted dropout in training: ``where(mask, data / keep, 0)`` with
    ``mask ~ Bernoulli(keep)`` (``U[0, 1) < keep``, drawn from the
    graph's generator); the identity at eval or for ``p <= 0``.  It
    divides by ``keep`` as the JAX op does (a multiply by ``1/keep``
    rounds differently in bf16)."""
    p = float(parse_attr(attrs.get("p", 0.5)))
    if not ctx.is_train or p <= 0.0:
        return data
    keep = 1.0 - p
    mask = _uniform(ctx, data.shape, 0.0, 1.0, data) < keep
    return torch.where(mask, data / _weak(keep, data), 0.0)


@register("LRN")
def _lrn(ctx, data, **attrs):
    """Cross-channel local response normalisation, ``data * (knorm +
    alpha/nsize * Σ_window data²)^-beta``, the window padded
    ``(nsize//2, nsize-1-nsize//2)`` across channels and summed in
    order, all in the input dtype, as the JAX op computes it."""
    alpha = float(parse_attr(attrs.get("alpha", 1e-4)))
    beta = float(parse_attr(attrs.get("beta", 0.75)))
    knorm = float(parse_attr(attrs.get("knorm", 2.0)))
    nsize = int(parse_attr(attrs["nsize"]))
    half = nsize // 2
    c = data.shape[1]
    sq = F.pad(data.square(),
               (0, 0) * (data.ndim - 2) + (half, nsize - 1 - half))
    ssum = sq.narrow(1, 0, c)
    for i in range(1, nsize):
        ssum = ssum + sq.narrow(1, i, c)
    norm = _weak(knorm, data) + _weak(alpha / nsize, data) * ssum
    return data * torch.pow(norm, _weak(-beta, data))


# ---------------------------------------------------------------------------
# Concat / SliceChannel
# ---------------------------------------------------------------------------
@register("Concat", varargs=True, aliases=("concat",))
def _concat(ctx, *args, **attrs):
    """``torch.cat`` along ``dim`` (default 1); mixed dtypes promote.
    Channels-last inputs give a channels-last output."""
    dim = int(parse_attr(attrs.get("dim", 1)))
    return torch.cat(args, dim)


@register("SliceChannel", num_outputs=-1, aliases=("split",))
def _slice_channel(ctx, data, **attrs):
    """``num_outputs`` equal parts along ``axis`` (default 1), each
    squeezed there under ``squeeze_axis``; new tensors, not views."""
    num = int(parse_attr(attrs["num_outputs"]))
    axis = int(parse_attr(attrs.get("axis", 1)))
    squeeze = parse_bool(attrs.get("squeeze_axis", False))
    n = data.shape[axis]
    if n % num:
        raise MXNetError(f"SliceChannel: axis {axis} of size {n} does not "
                         f"split into {num} equal parts")
    parts = torch.split(data, n // num, dim=axis)
    if squeeze:
        parts = [t.squeeze(axis) for t in parts]
    return tuple(t.clone() for t in parts)


# ---------------------------------------------------------------------------
# Convolution / Deconvolution
# ---------------------------------------------------------------------------
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_attrs(attrs):
    kernel = parse_attr(attrs["kernel"])
    nd = 1 if isinstance(kernel, int) else len(tuple(kernel))
    if nd not in _CONV:
        raise MXNetError("Convolution supports 1/2/3 spatial dims")
    kernel = normalize_tuple(kernel, nd, "kernel")
    stride = normalize_tuple(attrs.get("stride", (1,) * nd), nd, "stride")
    pad = normalize_tuple(attrs.get("pad", (0,) * nd), nd, "pad")
    dilate = normalize_tuple(attrs.get("dilate", (1,) * nd), nd, "dilate")
    num_filter = int(parse_attr(attrs["num_filter"]))
    num_group = int(parse_attr(attrs.get("num_group", 1)))
    no_bias = parse_bool(attrs.get("no_bias", False))
    return nd, kernel, stride, pad, dilate, num_filter, num_group, no_bias


def _conv_params(attrs, data_shape, *rest):
    _, kernel, _, _, _, num_filter, num_group, no_bias = _conv_attrs(attrs)
    shapes = {"weight": (num_filter, data_shape[1] // num_group)
              + tuple(kernel)}
    if not no_bias:
        shapes["bias"] = (num_filter,)
    return shapes


@register("Convolution", arg_names=("data", "weight", "bias"),
          infer_params=_conv_params, optional_args=_no_bias_drop)
def _convolution(ctx, data, weight, bias=None, **attrs):
    """1-, 2- or 3-D convolution (cuDNN on the card); the weight is
    ``(num_filter, C/group, *kernel)`` as in the JAX package.  The bias
    is added to the rounded product, as the JAX op adds it after
    ``conv_general_dilated``."""
    nd, _, stride, pad, dilate, _, num_group, _ = _conv_attrs(attrs)
    dt = torch.promote_types(data.dtype, weight.dtype)
    out = _CONV[nd](data.to(dt), weight.to(dt), None, stride, pad, dilate,
                    num_group)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


def _deconv_params(attrs, data_shape, *rest):
    _, kernel, _, _, _, num_filter, num_group, no_bias = _conv_attrs(attrs)
    shapes = {"weight": (data_shape[1], num_filter // num_group) + kernel}
    if not no_bias:
        shapes["bias"] = (num_filter,)
    return shapes


@register("Deconvolution", arg_names=("data", "weight", "bias"),
          infer_params=_deconv_params, optional_args=_no_bias_drop,
          attr_defaults={"no_bias": True})
def _deconvolution(ctx, data, weight, bias=None, **attrs):
    """Transposed convolution; the weight is ``(C, num_filter/group,
    *kernel)``, MXNet's and ``conv_transpose``'s layout.  The output is
    ``(in-1)*stride - 2*pad + dilate*(kernel-1) + 1 + adj``;
    ``target_shape`` sets ``adj`` with the JAX op's reachability check.

    ``no_bias`` defaults to True, as in MXNet (``deconvolution-inl.h``)
    and as the JAX op declares (``attr_defaults``) but never applies:
    its ``sym.Deconvolution`` makes a bias (ROADMAP Queue 3).  A bias
    given as an input is added all the same."""
    nd, kernel, stride, pad, dilate, _, num_group, _ = _conv_attrs(attrs)
    adj = normalize_tuple(attrs.get("adj", (0,) * nd), nd, "adj")
    if attrs.get("target_shape"):
        tgt = normalize_tuple(parse_attr(attrs["target_shape"]), nd,
                              "target_shape")
        adj = tuple(
            int(t) - ((i - 1) * s - 2 * p + d * (k - 1) + 1)
            for t, i, s, p, d, k in zip(tgt, data.shape[2:], stride, pad,
                                        dilate, kernel))
        if any(a < 0 or a >= s for a, s in zip(adj, stride)):
            raise MXNetError(
                f"Deconvolution: target_shape {tgt} unreachable from input "
                f"{tuple(data.shape[2:])} with stride {stride}")
    if any(a < 0 or a >= s for a, s in zip(adj, stride)):
        # MXNet's own check; torch's output_padding obeys it too
        raise MXNetError(f"Deconvolution: adj {adj} must lie in [0, "
                         f"stride {stride})")
    dt = torch.promote_types(data.dtype, weight.dtype)
    out = _CONV_T[nd](data.to(dt), weight.to(dt), None, stride, pad, adj,
                      num_group, dilate)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


# ---------------------------------------------------------------------------
# BatchNorm / InstanceNorm / L2Normalization
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
    unbiased and whose momentum runs the other way.
    ``MXTPU_BN_STATS_DTYPE=compute`` takes the moments in the data's
    dtype with fp32 sums, shifted by the moving mean rounded to that
    dtype (and that rounded shift is what is added back)."""
    eps = float(parse_attr(attrs.get("eps", 1e-3)))
    momentum = float(parse_attr(attrs.get("momentum", 0.9)))
    fix_gamma = parse_bool(attrs.get("fix_gamma", True))
    use_global = parse_bool(attrs.get("use_global_stats", False))
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    axes = (0,) + tuple(range(2, data.ndim))
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    if ctx.is_train and not use_global:
        n = 1.0
        for ax in axes:
            n *= data.shape[ax]
        if os.environ.get("MXTPU_BN_STATS_DTYPE") == "compute":
            shift = moving_mean.detach().to(data.dtype)
            centered = data - shift.reshape(bshape)
            m1 = centered.sum(axes, dtype=torch.float32) / n
            sq = centered.square().sum(axes, dtype=torch.float32) / n
            mean32 = m1 + shift.float()
            var32 = (sq - m1.square()).clamp_min(0.0)
        else:
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


def _in_params(attrs, data_shape, *rest):
    return {"gamma": (data_shape[1],), "beta": (data_shape[1],)}


@register("InstanceNorm", arg_names=("data", "gamma", "beta"),
          infer_params=_in_params)
def _instance_norm(ctx, data, gamma, beta, **attrs):
    """Per-sample, per-channel normalisation over the spatial axes, eps
    1e-3.  ``jnp.mean`` and ``jnp.var`` compute in fp32 (the var in two
    passes) and round to the input dtype; so do these."""
    eps = float(parse_attr(attrs.get("eps", 1e-3)))
    axes = tuple(range(2, data.ndim))
    x32 = data.float()
    mean = x32.mean(axes, keepdim=True).to(data.dtype)
    var = x32.var(axes, unbiased=False, keepdim=True).to(data.dtype)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    out = (data - mean) * torch.rsqrt(var + _weak(eps, data))
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("L2Normalization")
def _l2_normalization(ctx, data, **attrs):
    """``data / sqrt(Σ data² + eps)`` over the mode's axes: instance (all
    but the batch, default), channel (axis 1) or spatial (axes 2 on);
    the square in the input dtype, its sum in fp32 rounded back, as
    ``jnp.sum`` computes it."""
    eps = float(parse_attr(attrs.get("eps", 1e-10)))
    mode = attrs.get("mode", "instance")
    if mode == "instance":
        axes = tuple(range(1, data.ndim))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.ndim))
    else:
        raise MXNetError(f"L2Normalization: unknown mode {mode}")
    ssum = data.square().sum(axes, keepdim=True, dtype=torch.float32)
    return data / torch.sqrt(ssum.to(data.dtype) + _weak(eps, data))


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling")
def _pooling(ctx, data, **attrs):
    """1-, 2- or 3-D max / avg / sum pooling; ``global_pool``;
    pooling_convention ``valid`` (floor, default) or ``full`` (ceil: the
    right edge is extended until the last window fits, as the JAX op
    pads it).  max pads with -inf; avg counts the padding and divides by
    the kernel's size (count-include-pad).  1-D runs as 2-D over a unit
    height."""
    nd = data.ndim - 2
    if nd not in (1, 2, 3):
        raise MXNetError(f"Pooling on {data.ndim}-D data: 1/2/3 spatial "
                         "dims only")
    x = data
    if parse_bool(attrs.get("global_pool", False)):
        kernel = tuple(x.shape[2:])
        stride, pad = (1,) * nd, (0,) * nd
    else:
        kernel = normalize_tuple(attrs["kernel"], nd, "kernel")
        stride = normalize_tuple(attrs.get("stride", (1,) * nd), nd, "stride")
        pad = normalize_tuple(attrs.get("pad", (0,) * nd), nd, "pad")
    pool_type = attrs.get("pool_type", "max")
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"Pooling: unknown pool_type {pool_type}")
    extra = [0] * nd  # right-edge extension of the "full" convention
    if attrs.get("pooling_convention", "valid") == "full":
        for i in range(nd):
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                extra[i] = stride[i] - rem
    # torch pads symmetrically and at most half a window; anything else
    # is padded here first (-inf for max, 0 for the sums)
    if any(extra) or any(p > k // 2 for p, k in zip(pad, kernel)):
        fill = float("-inf") if pool_type == "max" else 0.0
        flat = []
        for i in reversed(range(nd)):
            flat += [pad[i], pad[i] + extra[i]]
        x = F.pad(x, flat, value=fill)
        pad = (0,) * nd
    if nd == 1:
        x = x.unsqueeze(2)
        kernel, stride, pad = (1,) + kernel, (1,) + stride, (0,) + pad
    pd = max(nd, 2)
    if pd == 3 and pool_type != "max" and x.dtype == torch.bfloat16 \
            and x.device.type == "cpu":
        x = x.float()  # torch's CPU avg_pool3d has no bf16 kernel
    if pool_type == "max":
        out = _MAX_POOL[pd](x, kernel, stride, pad)
    else:
        # sum over the window (padding included) / kernel size, or / 1
        div = int(np.prod(kernel)) if pool_type == "avg" else 1
        out = _AVG_POOL[pd](x, kernel, stride, pad, count_include_pad=True,
                            divisor_override=div)
    if nd == 1:
        out = out.squeeze(2)
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# Pad / UpSampling / Crop
# ---------------------------------------------------------------------------
def _pad_index(n, lo, hi, mode, device):
    """Source positions of a padded axis of length ``n`` (numpy's edge
    and reflect modes, any pad width), made on ``device``: an upload of
    host positions would wait for the stream, which a CUDA-graph capture
    (``step_multi``) refuses."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


@register("Pad", aliases=("pad",))
def _pad(ctx, data, **attrs):
    """``pad_width`` in MXNet's flat (before, after)-per-axis order, on
    any axis, as ``jnp.pad`` takes it; modes constant
    (``constant_value``), edge and reflect (numpy's, gathered by index:
    ``F.pad``'s own modes pad only trailing dims)."""
    pw = tuple(parse_attr(attrs["pad_width"]))
    mode = attrs.get("mode", "constant")
    pads = [(int(pw[2 * i]), int(pw[2 * i + 1])) for i in range(data.ndim)]
    if mode == "constant":
        value = float(parse_attr(attrs.get("constant_value", 0.0)))
        flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
        return F.pad(data, flat, value=value)
    if mode not in ("edge", "reflect"):
        raise MXNetError(f"Pad: unknown mode {mode}")
    # a half-precision gather runs in fp32 (exact), so its gradient sums
    # the repeated positions in fp32 and rounds once
    half = data.dtype in (torch.bfloat16, torch.float16)
    out = data.float() if half else data
    for axis, (lo, hi) in enumerate(pads):
        if lo or hi:
            out = out.index_select(axis, _pad_index(
                data.shape[axis], lo, hi, mode, data.device))
    return out.to(data.dtype)


def _upsampling_params(attrs, data_shape, *rest):
    if attrs.get("sample_type", "nearest") == "bilinear":
        scale = int(parse_attr(attrs["scale"]))
        num_filter = int(parse_attr(attrs.get("num_filter", data_shape[1])))
        k = 2 * scale - scale % 2
        return {"weight": (num_filter, 1, k, k)}
    return {}


def _upsampling_optional(attrs):
    return set() if attrs.get("sample_type", "nearest") == "bilinear" \
        else {"weight"}


@register("UpSampling", arg_names=("data", "weight"),
          infer_params=_upsampling_params,
          optional_args=_upsampling_optional)
def _upsampling(ctx, data, weight=None, **attrs):
    """``n·scale`` rows and columns, as MXNet gives: nearest repeats each
    pixel; bilinear is a per-channel transposed conv with stride
    ``scale``, kernel ``2·scale - scale%2`` and pad
    ``ceil((scale-1)/2)`` over the ``(C, 1, k, k)`` weight.

    The JAX op pads ``scale-1`` more on the high side, so its output is
    ``n·scale + scale-1`` wide (ROADMAP Queue 3); these are its leading
    ``n·scale`` rows and columns.  It correlates the dilated input with
    the weight as stored, so the weight is flipped here for
    ``conv_transpose``: a checkpoint of either package means the same."""
    scale = int(parse_attr(attrs["scale"]))
    if attrs.get("sample_type", "nearest") == "nearest":
        return data.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
    p = scale // 2  # ceil((scale - 1) / 2)
    dt = torch.promote_types(data.dtype, weight.dtype)
    return F.conv_transpose2d(data.to(dt), weight.to(dt).flip(2, 3), None,
                              scale, p, 0, data.shape[1])


@register("Crop", arg_names=("data", "crop_like"),
          optional_args=lambda a: set()
          if int(parse_attr(a.get("num_args", 1))) > 1 else {"crop_like"})
def _crop_layer(ctx, data, crop_like=None, **attrs):
    """The spatial dims cut to ``crop_like``'s (or ``h_w``) at
    ``offset``, or centred under ``center_crop``; a new tensor."""
    if crop_like is not None:
        th, tw = crop_like.shape[2], crop_like.shape[3]
    else:
        th, tw = tuple(parse_attr(attrs["h_w"]))
    offset = parse_attr(attrs.get("offset", (0, 0)))
    h, w = data.shape[2], data.shape[3]
    if parse_bool(attrs.get("center_crop", False)):
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw].clone()
