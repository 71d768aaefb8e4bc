"""Loss output ops of the port (``SoftmaxOutput`` from
``mxnet_tpu/ops/loss.py``).

MXNet's output ops source their own gradient and ignore the head
gradient: SoftmaxOutput's backward is ``(p - onehot(label)) *
grad_scale`` with null / batch / valid normalization and an optional
ignore label.  A ``torch.autograd.Function`` whose backward never reads
``grad_output`` reproduces that, so the trainer's ``ones`` head changes
nothing.  With the default ``normalization="null"`` there is no 1/N:
gradients sum over every row.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, parse_attr, parse_bool
from .registry import register


def _norm_enum(attrs):
    n = attrs.get("normalization", "null")
    return n if n in ("null", "batch", "valid") else "null"


def _softmax_label_shape(attrs, data_shape, *rest):
    return {"label": (data_shape[0],)}


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, cfg):
        out = torch.softmax(data, dim=1 if data.ndim > 1 else 0)
        ctx.save_for_backward(out, label)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, _head):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization = ctx.cfg
        lab = label.reshape(-1).long()
        # jax.nn.one_hot: an id outside [0, classes) gives a row of zeros
        classes = torch.arange(out.shape[-1], device=out.device)
        grad = out.reshape(lab.shape[0], -1) \
            - (lab[:, None] == classes).to(out.dtype)
        mask = None
        if use_ignore:
            mask = label.reshape(-1) != ignore_label
            grad = grad * mask[:, None].to(grad.dtype)
        grad = grad.reshape(out.shape)
        if normalization == "batch":
            grad = grad / out.shape[0]
        elif normalization == "valid" and mask is not None:
            grad = grad / mask.to(grad.dtype).sum().clamp_min(1.0)
        elif normalization == "valid":
            # every label is valid: divide by the label count
            grad = grad / float(label.numel())
        return grad_scale * grad, None, None


@register("SoftmaxOutput", arg_names=("data", "label"), aliases=("Softmax",),
          infer_params=_softmax_label_shape)
def _softmax_output(ctx, data, label, **attrs):
    """Forward: softmax over axis 1 of ``(N, C)`` data.  Backward:
    ``(p - onehot(label)) * grad_scale`` with null / batch / valid
    normalization and use_ignore masking; the head gradient is ignored.
    ``multi_output``, ``preserve_shape`` and data of more than 2 dims are
    not ported yet (ROADMAP Queue 1 item 3; the JAX package's backward
    fails on the last)."""
    for unported in ("multi_output", "preserve_shape"):
        if parse_bool(attrs.get(unported, False)):
            raise MXNetError(f"SoftmaxOutput({unported}=True) is not ported "
                             "yet (ROADMAP Queue 1 item 3)")
    if data.ndim > 2:
        raise MXNetError(f"SoftmaxOutput on {data.ndim}-D data is not ported "
                         "yet (ROADMAP Queue 1 item 3)")
    cfg = (float(parse_attr(attrs.get("grad_scale", 1.0))),
           float(parse_attr(attrs.get("ignore_label", -1.0))),
           parse_bool(attrs.get("use_ignore", False)),
           _norm_enum(attrs))
    return _SoftmaxOutput.apply(data, label, cfg)
