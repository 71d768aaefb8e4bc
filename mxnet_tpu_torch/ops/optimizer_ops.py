"""Optimizer updates of the port (the ``sgd_update``, ``sgd_mom_update``,
``adam_update`` and ``rmsprop_update`` of ``mxnet_tpu/ops/optimizer_ops.py``).

Unlike the JAX package's pure functions, these update **in place**: the
weight and the state tensors passed in are overwritten (and returned),
so a step holds no second copy of the fp32 masters or of Adam's
moments.  The arithmetic is the JAX package's, operation for operation
(``rescale_grad``, ``clip_gradient``, then ``wd * weight`` added to the
gradient); Adam has no bias correction.

The learning rate may be a number or an fp32 0-d tensor on the
weight's device: ``FusedTrainer`` passes the tensor it refills before
each step, so a captured step reads the rate of its replay and the
update makes no host sync.
"""
from __future__ import annotations

import torch

from ..base import parse_attr
from .registry import register

_REQUIRED = object()


def _scalar(attrs, name, default=_REQUIRED):
    val = attrs.get(name, default)
    if val is _REQUIRED:
        raise KeyError(f"optimizer update requires attr {name!r}")
    if val is None:
        return None
    return float(parse_attr(val))


def _lr(attrs):
    """The ``lr`` attr: a tensor as it is, anything else as a float."""
    lr = attrs.get("lr", _REQUIRED)
    return lr if isinstance(lr, torch.Tensor) else _scalar(attrs, "lr")


def _prep_grad(grad, weight, attrs):
    """``clip(grad * rescale) + wd * weight`` as a new tensor; a factor
    of 1 and a wd of 0 are left out (they change no value)."""
    rescale = float(parse_attr(attrs.get("rescale_grad", 1.0)))
    clip = parse_attr(attrs.get("clip_gradient", None))
    wd = float(parse_attr(attrs.get("wd", 0.0)))
    g = grad * rescale if rescale != 1.0 else grad
    if clip is not None and float(clip) > 0:
        g = g.clamp(-float(clip), float(clip))
    return g + wd * weight if wd != 0.0 else g


@register("sgd_update", arg_names=("weight", "grad"))
def _sgd_update(ctx, weight, grad, **attrs):
    lr = _lr(attrs)
    return weight.sub_(lr * _prep_grad(grad, weight, attrs))


@register("sgd_mom_update", arg_names=("weight", "grad", "mom"),
          num_outputs=2, output_names=("weight", "mom"))
def _sgd_mom_update(ctx, weight, grad, mom, **attrs):
    """mom = momentum*mom - lr*grad';  weight += mom."""
    lr = _lr(attrs)
    momentum = float(parse_attr(attrs.get("momentum", 0.0)))
    g = _prep_grad(grad, weight, attrs)
    mom.mul_(momentum).sub_(lr * g)
    return weight.add_(mom), mom


@register("adam_update", arg_names=("weight", "grad", "mean", "var"),
          num_outputs=3, output_names=("weight", "mean", "var"))
def _adam_update(ctx, weight, grad, mean, var, **attrs):
    """``w -= lr * m / (sqrt(v) + eps)`` after the moment updates."""
    lr = _lr(attrs)
    beta1 = float(parse_attr(attrs.get("beta1", 0.9)))
    beta2 = float(parse_attr(attrs.get("beta2", 0.999)))
    eps = float(parse_attr(attrs.get("epsilon", 1e-8)))
    g = _prep_grad(grad, weight, attrs)
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * g.square())
    weight.sub_(lr * mean / (var.sqrt() + eps))
    return weight, mean, var


@register("rmsprop_update", arg_names=("weight", "grad", "n"),
          num_outputs=2, output_names=("weight", "n"))
def _rmsprop_update(ctx, weight, grad, n, **attrs):
    """Plain (Tieleman-Hinton) RMSProp with optional weight clipping."""
    lr = _lr(attrs)
    gamma1 = float(parse_attr(attrs.get("gamma1", 0.95)))
    eps = float(parse_attr(attrs.get("epsilon", 1e-8)))
    clip_weights = parse_attr(attrs.get("clip_weights", None))
    g = _prep_grad(grad, weight, attrs)
    n.mul_(gamma1).add_((1 - gamma1) * g.square())
    weight.sub_(lr * g / (n + eps).sqrt())
    if clip_weights is not None and float(clip_weights) > 0:
        cw = float(clip_weights)
        weight.clamp_(-cw, cw)
    return weight, n
