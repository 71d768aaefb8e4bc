"""CTC loss of the port (``mxnet_tpu/ops/ctc.py``): :func:`ctc_loss`,
the ``WarpCTC`` op and ``_contrib_CTCLoss`` (alias ``ctc_loss``).

The forward recursion runs in log space over the extended label
sequence (blank, l1, blank, l2, ..., blank), vectorised over the batch
and the labels; the JAX package's ``lax.scan`` over time becomes a
Python loop of T steps under autograd.  Log zero is ``-1e30``, not
``-inf``: ``_log_add`` of two ``-inf`` would give NaN.  Blank is label
0 (warp-ctc's convention), which also pads the labels.

``WarpCTC``'s forward is the softmax over the alphabet; its backward is
the gradient of the summed CTC loss with respect to the activations and
ignores the head gradient, as warp-ctc's plugin (and the JAX op's
``custom_vjp``) do.  That backward runs inside a ``torch.profiler``
range named ``WarpCTC.backward``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import parse_attr
from .registry import register

_NEG = -1e30


def _log_add(a, b):
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(-torch.abs(a - b)))


def ctc_loss(logits, labels, input_lengths=None, label_lengths=None,
             blank=0):
    """Batched CTC negative log-likelihood, (N,) losses.

    ``logits`` (T, N, C) before the softmax; ``labels`` (N, L) integers,
    0 the blank and the padding; ``input_lengths`` (N,) frames read of
    each sequence (default T), ``label_lengths`` (N,) labels (default the
    non-blank count)."""
    t, n, _ = logits.shape
    l = labels.shape[1]
    dev = logits.device
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)  # (T, N, C)
    if label_lengths is None:
        label_lengths = (labels != blank).sum(dim=1)
    if input_lengths is None:
        input_lengths = torch.full((n,), t, dtype=torch.long, device=dev)
    label_lengths = label_lengths.long()
    input_lengths = input_lengths.long()

    s = 2 * l + 1
    ext = torch.full((n, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    pos = torch.arange(s, device=dev)[None, :]
    ext_valid = pos < (2 * label_lengths + 1)[:, None]
    # a skip from s-2 when ext[s] is a label other than ext[s-2]
    ext_prev2 = F.pad(ext, (2, 0), value=blank)[:, :s]
    can_skip = (ext != blank) & (ext != ext_prev2) & (pos >= 2)
    neg = torch.full((), _NEG, dtype=logp.dtype, device=dev)

    def emit(lp_t):
        # (N, C) -> the emission log-prob of each extended label (N, S)
        return lp_t.gather(1, ext)

    first = emit(logp[0])
    init = torch.cat([
        first[:, :1],
        torch.where(label_lengths > 0, first[:, 1], neg)[:, None],
        neg.expand(n, s - 2)], dim=1)
    alphas = [init]
    alpha = init
    for step in range(1, t):
        a_prev1 = F.pad(alpha, (1, 0), value=_NEG)[:, :s]
        a_prev2 = F.pad(alpha, (2, 0), value=_NEG)[:, :s]
        acc = _log_add(alpha, a_prev1)
        acc = torch.where(can_skip, _log_add(acc, a_prev2), acc)
        alpha = torch.where(ext_valid, acc + emit(logp[step]), neg)
        alphas.append(alpha)
    alphas = torch.stack(alphas)  # (T, N, S)

    # read out at each sequence's last frame, positions 2L and 2L-1
    batch = torch.arange(n, device=dev)
    final = alphas[(input_lengths - 1).clamp(0, t - 1), batch]  # (N, S)
    end1 = final[batch, 2 * label_lengths]
    end2 = torch.where(label_lengths > 0,
                       final[batch, (2 * label_lengths - 1).clamp(min=0)],
                       neg)
    return -_log_add(end1, end2)


class _WarpCTC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, labels, tshape):
        ctx.save_for_backward(data, labels)
        ctx.tshape = tshape
        return torch.softmax(data, dim=-1)

    @staticmethod
    def backward(ctx, _head):
        data, labels = ctx.saved_tensors
        with torch.enable_grad(), torch.profiler.record_function(
                "WarpCTC.backward"):
            x = data.detach().requires_grad_(True)
            loss = ctc_loss(x.reshape(ctx.tshape), labels).sum()
            grad, = torch.autograd.grad(loss, x)
        return grad, None, None


@register("WarpCTC", arg_names=("data", "label"))
def _warp_ctc(ctx, data, label, **attrs):
    """data: (T * N, C) activations (warp-ctc's flat layout, time-major)
    or (T, N, C); label (N, L), 0-padded, read up to ``label_length``.
    Forward: the softmax of the data; backward: the gradient of the
    summed CTC loss, whatever the head gradient."""
    label_length = int(parse_attr(attrs.get("label_length",
                                            label.shape[-1])))
    input_length = int(parse_attr(attrs.get("input_length", 0)))
    if data.ndim == 2:
        n = label.shape[0]
        t = input_length if input_length > 0 else data.shape[0] // n
        tshape = (t, n, data.shape[-1])
    else:
        tshape = tuple(data.shape)
    labels = label.reshape(label.shape[0], -1)[:, :label_length].to(
        torch.int32)
    return _WarpCTC.apply(data, labels, tshape)


@register("_contrib_CTCLoss", arg_names=("data", "label"),
          aliases=("ctc_loss",))
def _ctc_loss_op(ctx, data, label, **attrs):
    """Per-sequence CTC loss, (N,): data (T, N, C) before the softmax,
    label (N, L) 0-padded.  Differentiable through the recursion, with no
    head-gradient rule of its own (train it through ``MakeLoss``)."""
    labels = label.reshape(label.shape[0], -1).to(torch.int32)
    return ctc_loss(data, labels)
