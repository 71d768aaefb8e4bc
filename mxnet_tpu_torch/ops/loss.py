"""Loss and output ops of the port (``mxnet_tpu/ops/loss.py``, every name
it registers): the heads ``SoftmaxOutput`` (``Softmax``),
``LinearRegressionOutput``, ``LogisticRegressionOutput``,
``MAERegressionOutput``, ``SVMOutput``, ``MakeLoss`` and
``IdentityAttachKLSparseReg``, and ``softmax_cross_entropy`` and
``SoftmaxActivation``.

MXNet's heads source their own gradient and ignore the head gradient:
SoftmaxOutput's backward is ``(p - onehot(label)) * grad_scale`` with
null / batch / valid normalization and an optional ignore label, the
regression heads' ``grad_scale / num_output * f(out, label)``.  A
``torch.autograd.Function`` whose backward never reads ``grad_output``
reproduces that, so the trainer's ``ones`` head changes nothing.  With
the default ``normalization="null"`` there is no 1/N: gradients sum
over every row.  ``softmax_cross_entropy`` and ``SoftmaxActivation``
are plain functions with autograd's gradient, as in the JAX package,
and so is :func:`token_nll`, the LM loss outside the op registry.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, parse_attr, parse_bool
from .indexing import jax_gather
from .nn import _weak
from .registry import register


def token_nll(logits, labels):
    """Mean next-token negative log-likelihood of ``[..., T, V]`` logits
    against ``[..., T]`` integer (or float-encoded, truncated) labels:
    the functional LM loss (parity: the loss SoftmaxOutput computes
    implicitly in its backward).  A plain torch function; its gradient
    is autograd's."""
    logits = torch.as_tensor(logits)
    labels = torch.as_tensor(labels, device=logits.device)
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, labels.long()[..., None]).mean()


def _norm_enum(attrs):
    n = attrs.get("normalization", "null")
    return n if n in ("null", "batch", "valid") else "null"


def _softmax_label_shape(attrs, data_shape, *rest):
    """``(N,)``, or ``(N, d...)`` under ``multi_output``."""
    if parse_bool(attrs.get("multi_output", False)):
        return {"label": (data_shape[0],) + tuple(data_shape[2:])}
    return {"label": (data_shape[0],)}


def _regression_label_shape(attrs, data_shape, *rest):
    """The data's shape, ``(N,)`` for ``(N, 1)`` data."""
    if len(data_shape) == 2 and data_shape[1] == 1:
        return {"label": (data_shape[0],)}
    return {"label": tuple(data_shape)}


def _onehot(lab, classes, like, dim):
    """``jax.nn.one_hot`` along ``dim`` in ``like``'s dtype: an id outside
    ``[0, classes)`` gives zeros."""
    shape = [1] * (lab.ndim + 1)
    shape[dim] = classes
    ids = torch.arange(classes, device=lab.device).reshape(shape)
    return (lab.unsqueeze(dim) == ids).to(like.dtype)


def _softmax_output_grad(out, label, cfg, offset=0):
    """SoftmaxOutput's gradient ``(p - onehot(label)) * grad_scale`` with
    its normalizations; ``offset`` is the first class of ``out``'s
    columns (a vocab-split block: labels outside it hit no column)."""
    (grad_scale, ignore_label, use_ignore, normalization, multi,
     rows, valid) = cfg
    mask = None
    if multi and out.ndim > 2:
        # label (N, d...) indexes the channel axis 1
        grad = out - _onehot(label.long() - offset, out.shape[1], out, 1)
        if use_ignore:
            mask = label != ignore_label
            grad = grad * mask.unsqueeze(1).to(grad.dtype)
    else:
        lab = label.reshape(-1).long() - offset
        grad = out.reshape(lab.shape[0], -1) \
            - _onehot(lab, out.shape[-1], out, 1)
        if use_ignore:
            mask = label.reshape(-1) != ignore_label
            grad = grad * mask[:, None].to(grad.dtype)
        grad = grad.reshape(out.shape)
    # ``rows``/``valid``: the global batch and valid-label count when
    # this runs on one rank's rows of a mesh (None: these rows are all)
    if normalization == "batch":
        grad = grad / (out.shape[0] if rows is None else rows)
    elif normalization == "valid" and mask is not None:
        grad = grad / (mask.to(grad.dtype).sum() if valid is None
                       else valid.to(grad.dtype)).clamp_min(1.0)
    elif normalization == "valid":
        # every label is valid: divide by the label count (N * d...
        # under multi_output)
        grad = grad / float(label.numel() if rows is None
                            else rows * (label.numel()
                                         // max(label.shape[0], 1)))
    return grad_scale * grad


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
        return _softmax_output_grad(out, label, ctx.cfg), None, None


class _VocabParallelSoftmaxOutput(torch.autograd.Function):
    """SoftmaxOutput on one rank's block of the classes (Megatron's
    vocab-parallel softmax): the row maxima and sums are all-reduced
    over ``group`` (MAX, then SUM), so each rank gets its block of the
    global softmax without gathering the logits; the gradient is local."""

    @staticmethod
    def forward(ctx, data, label, cfg, group, offset):
        import torch.distributed as td

        x = data.float()
        m = x.amax(1, keepdim=True)
        td.all_reduce(m, op=td.ReduceOp.MAX, group=group)
        e = torch.exp(x - m)
        total = e.sum(1, keepdim=True)
        td.all_reduce(total, group=group)
        out = (e / total).to(data.dtype)
        ctx.save_for_backward(out, label)
        ctx.cfg, ctx.offset = cfg, offset
        return out

    @staticmethod
    def backward(ctx, _head):
        out, label = ctx.saved_tensors
        return (_softmax_output_grad(out, label, ctx.cfg, ctx.offset),
                None, None, None, None)


@register("SoftmaxOutput", arg_names=("data", "label"), aliases=("Softmax",),
          infer_params=_softmax_label_shape)
def _softmax_output(ctx, data, label, **attrs):
    """Forward: softmax over axis 1 (of ``(N, C)`` data, or of ``(N, C,
    d...)`` under ``multi_output``, with ``(N, d...)`` labels).  Over
    DTensors (a mesh) each rank runs its rows, and a class axis split
    over one mesh axis stays split (the vocab-parallel softmax).
    Backward: ``(p - onehot(label)) * grad_scale`` with null / batch /
    valid normalization and use_ignore masking; the head gradient is
    ignored.  ``preserve_shape`` changes nothing for data of up to 2
    dims.  Data of more than 2 dims without ``multi_output`` is refused:
    the JAX package's backward fails on it (ROADMAP Queue 3)."""
    multi = parse_bool(attrs.get("multi_output", False))
    if data.ndim > 2 and not multi:
        raise MXNetError(f"SoftmaxOutput on {data.ndim}-D data without "
                         "multi_output is refused: the reference's "
                         "backward fails on it (ROADMAP Queue 3)")
    cfg = (float(parse_attr(attrs.get("grad_scale", 1.0))),
           float(parse_attr(attrs.get("ignore_label", -1.0))),
           parse_bool(attrs.get("use_ignore", False)),
           _norm_enum(attrs), multi)
    from ..parallel import mesh as _mesh

    if _mesh.is_dtensor(data):
        return _softmax_output_placed(data, label, cfg)
    return _SoftmaxOutput.apply(data, label, cfg + (None, None))


def _softmax_output_placed(data, label, cfg):
    """SoftmaxOutput over DTensors (a mesh): each rank runs the op on its
    own rows; a class axis split evenly over one mesh axis (the LM head
    under ``megatron_rules``) stays split and takes the vocab-parallel
    softmax, any other split of it is gathered first; the
    normalizations use the global batch and valid-label counts."""
    from torch.distributed.tensor import Replicate, Shard

    from ..parallel import mesh as _mesh

    mesh = data.device_mesh
    lab_place = tuple(p if isinstance(p, Shard) and p.dim == 0
                      else Replicate() for p in data.placements)
    split = [i for i, p in enumerate(data.placements)
             if isinstance(p, Shard) and p.dim == 1]
    vocab = data.shape[1] if data.ndim > 1 else 0
    if len(split) == 1 and vocab % mesh.size(split[0]) == 0:
        place = tuple(Shard(1) if i == split[0] else p
                      for i, p in enumerate(lab_place))
    else:
        split, place = [], lab_place
    data = data.redistribute(mesh, place)
    label = label.redistribute(mesh, lab_place)
    _, ignore_label, use_ignore, normalization, _multi = cfg
    valid = None
    if normalization == "valid" and use_ignore:
        valid = _mesh.full_value((label != ignore_label).float().sum())
    cfg = cfg + (int(data.shape[0]), valid)
    if split:
        group = mesh.get_group(split[0])
        offset = (mesh.get_local_rank(split[0])
                  * (vocab // mesh.size(split[0])))

        def run(d, lab):
            return _VocabParallelSoftmaxOutput.apply(d, lab, cfg, group,
                                                     offset)
    else:
        def run(d, lab):
            return _SoftmaxOutput.apply(d, lab, cfg)

    return _mesh.local_map(run, out_placements=(place,),
                           in_placements=(place, lab_place),
                           device_mesh=mesh)(data, label)


# --- regression heads -------------------------------------------------
class _Regression(torch.autograd.Function):
    """Forward ``fwd(data)``; backward ``bwd(out, label) * grad_scale /
    num_output`` (``num_output`` = the label's elements per row)."""

    @staticmethod
    def forward(ctx, data, label, fwd, bwd, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.bwd, ctx.grad_scale = bwd, grad_scale
        return out

    @staticmethod
    def backward(ctx, _head):
        out, label = ctx.saved_tensors
        num_output = max(label.numel() // label.shape[0], 1) \
            if label.ndim > 0 else 1
        grad = ctx.bwd(out, label.reshape(out.shape)) \
            * (ctx.grad_scale / num_output)
        return grad, None, None, None, None


def _regression_output(name, fwd, bwd, doc):
    @register(name, arg_names=("data", "label"),
              infer_params=_regression_label_shape)
    def _impl(ctx, data, label, **attrs):
        return _Regression.apply(data, label, fwd, bwd, float(
            parse_attr(attrs.get("grad_scale", 1.0))))

    _impl.__doc__ = doc
    return _impl


_regression_output("LinearRegressionOutput", lambda d: d,
                   lambda o, l: o - l,
                   "Identity forward; gradient ``out - label``.")
_regression_output("LogisticRegressionOutput", torch.sigmoid,
                   lambda o, l: o - l,
                   "Sigmoid forward; gradient ``out - label``.")
_regression_output("MAERegressionOutput", lambda d: d,
                   lambda o, l: torch.sign(o - l),
                   "Identity forward; gradient ``sign(out - label)``.")


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, _head):
        data, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.cfg
        onehot = _onehot(label.reshape(-1).long(), data.shape[1], data, 1)
        sign = 2.0 * onehot - 1.0  # +1 at the true class, -1 elsewhere
        slack = _weak(margin, data) - sign * data
        if use_linear:
            grad = -sign * _weak(reg, data)
        else:
            grad = -2.0 * slack * sign * _weak(reg, data)
        grad = torch.where(slack > 0, grad, torch.zeros_like(grad))
        return grad.to(data.dtype), None, None, None, None


@register("SVMOutput", arg_names=("data", "label"),
          infer_params=_softmax_label_shape)
def _svm_output(ctx, data, label, **attrs):
    """Identity forward; the hinge loss's gradient where the margin is
    violated: ``-sign * reg`` (``use_linear``, L1) or ``-2 (margin -
    sign * x) sign * reg`` (L2), with ``sign`` +1 at the true class and
    -1 elsewhere."""
    return _SVMOutput.apply(
        data, label, float(parse_attr(attrs.get("margin", 1.0))),
        float(parse_attr(attrs.get("regularization_coefficient", 1.0))),
        parse_bool(attrs.get("use_linear", False)))


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scale):
        ctx.scale = scale
        return data.clone()

    @staticmethod
    def backward(ctx, head):
        return torch.full_like(head, ctx.scale), None


@register("MakeLoss")
def _make_loss(ctx, data, **attrs):
    """Identity forward; the gradient is ``grad_scale`` everywhere (over
    the batch size under ``normalization="batch"``, over the element
    count under ``"valid"``), whatever the head gradient."""
    scale = float(parse_attr(attrs.get("grad_scale", 1.0)))
    normalization = _norm_enum(attrs)
    if normalization == "batch":
        scale = scale / data.shape[0]
    elif normalization == "valid":
        scale = scale / max(math.prod(data.shape), 1)
    return _MakeLoss.apply(data, scale)


@register("softmax_cross_entropy", arg_names=("data", "label"),
          infer_params=_softmax_label_shape)
def _softmax_cross_entropy(ctx, data, label, **attrs):
    """``-sum(log_softmax(data)[i, label[i]])`` as shape ``(1,)``; a label
    outside the classes reads as a JAX gather reads it
    (:func:`~.indexing.jax_gather`)."""
    logp = torch.log_softmax(data, dim=-1)
    n = data.shape[-1]
    lab = label.reshape(-1).long()
    lab = torch.where(lab < 0, lab + n, lab)
    picked = logp.gather(1, lab.clamp(0, n - 1)[:, None])[:, 0]
    return -jax_gather(picked, (lab >= 0) & (lab < n)).sum().reshape((1,))


@register("SoftmaxActivation")
def _softmax_activation(ctx, data, **attrs):
    """``mode="instance"`` (default): softmax over the trailing dims of
    each row, flattened; ``"channel"``: softmax over axis 1."""
    if attrs.get("mode", "instance") == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=1).reshape(data.shape)


def _kl_params(attrs, data_shape, *rest):
    return {"moving_avg": (data_shape[1],)}


class _AttachKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, kl_grad):
        ctx.save_for_backward(kl_grad)
        ctx.ndim = data.ndim
        return data.clone()

    @staticmethod
    def backward(ctx, head):
        (kl_grad,) = ctx.saved_tensors
        shape = (1, -1) + (1,) * (ctx.ndim - 2)
        return head + kl_grad.reshape(shape), None


@register("IdentityAttachKLSparseReg", arg_names=("data",),
          aux_names=("moving_avg",), infer_params=_kl_params)
def _identity_attach_kl(ctx, data, moving_avg, **attrs):
    """Identity forward; the backward adds the gradient of a KL sparsity
    penalty, ``penalty * (-rho/avg + (1 - rho)/(1 - avg))`` per channel,
    ``avg`` the moving average of the activations that came in (clipped
    to ``[1e-6, 1 - 1e-6]``), ``rho`` the ``sparseness_target``.  In
    training the aux state moves to ``avg * momentum + mean(data) * (1 -
    momentum)`` (the mean over every axis but 1)."""
    penalty = float(parse_attr(attrs.get("penalty", 0.001)))
    target = float(parse_attr(attrs.get("sparseness_target", 0.1)))
    momentum = float(parse_attr(attrs.get("momentum", 0.9)))
    axes = tuple(i for i in range(data.ndim) if i != 1)
    with torch.no_grad():
        if ctx.is_train:
            new_avg = moving_avg * momentum \
                + data.mean(axes) * (1 - momentum)
        else:
            new_avg = moving_avg
        rho = moving_avg.clamp(1e-6, 1 - 1e-6)
        kl_grad = penalty * (-target / rho + (1.0 - target) / (1.0 - rho))
    return _AttachKL.apply(data, kl_grad), (new_avg,)
