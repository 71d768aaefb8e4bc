"""PyTorch modules as graph ops (mirrors ``mxnet_tpu/plugins/
torch_plugin.py``; parity: plugin/torch/ — TorchModule/TorchCriterion,
which embedded Lua-torch layers inside MXNet graphs).

The JAX package runs the user's module on the host behind
``jax.pure_callback``, with a backward that runs the forward again.
Here the graph is PyTorch already, so the module runs in place: on the
op's device, under autograd, through ``torch.func.functional_call``
with the op's inputs as its parameters.  No host round trip and no host
sync, in the forward or the backward; the gradients into the data and
the parameters are autograd's.  The parameters stay graph inputs, so
any optimizer of the port trains them, and after each call the
registered module holds the values the op ran with, as in the
reference.

The forward runs in train or eval mode as the op's ``is_train`` says:
buffers (BatchNorm's running statistics) advance once per training
forward and never at inference.  Random layers (``Dropout``) draw from
the op's generator, not from torch's global one: every random ATen op
of the module's forward gets the op's generator (a dispatch mode), and
``native_dropout`` (the fused CUDA dropout, which takes none) is drawn
the port's way.  Shape inference runs the module on meta tensors.

Usage::

    torch_mod = torch.nn.Linear(4, 3)
    out = nd.TorchModule(x, w, b, module_id=register_module(torch_mod))

or symbolically with a variable for each torch parameter (its shape
declared, in ``module.parameters()`` order).
"""
from __future__ import annotations

import contextlib
import itertools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..base import MXNetError, parse_attr
from ..ops.registry import register

__all__ = ["register_module", "register_criterion"]

_MODULES: dict[int, "torch.nn.Module"] = {}
_CRITERIA: dict[int, "torch.nn.Module"] = {}


def register_module(module) -> int:
    """Register a torch.nn.Module; returns the id to pass as module_id.
    The module's parameters (in ``module.parameters()`` order) become
    the op's trailing inputs; the module moves to the op's device at its
    first call there."""
    mid = len(_MODULES)
    _MODULES[mid] = module
    return mid


def register_criterion(criterion) -> int:
    """Register a torch loss; returns the id to pass as criterion_id."""
    mid = len(_CRITERIA)
    _CRITERIA[mid] = criterion
    return mid


def _on(module, device):
    """``module`` with its parameters and buffers on ``device``."""
    if any(t.device != device for t in itertools.chain(
            module.parameters(), module.buffers())):
        module.to(device)
    return module


@contextlib.contextmanager
def _mode(module, is_train):
    was = module.training
    module.train(bool(is_train))
    try:
        yield
    finally:
        module.train(was)


class _OpGenerator(TorchDispatchMode):
    """Every random ATen op of the module's forward draws from ``gen``:
    an op with a ``generator`` argument is given it, and
    ``native_dropout`` is drawn as the port's ``Dropout`` draws (a
    uniform from ``gen`` below the keep rate), returning its output and
    mask so that autograd's ``native_dropout_backward`` applies."""

    def __init__(self, gen):
        super().__init__()
        self.gen = gen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.ops.aten.native_dropout.default:
            x, p = args[0], float(args[1])
            train = args[2] if len(args) > 2 else kwargs.get("train")
            if train is False:
                return x.clone(), torch.ones_like(x, dtype=torch.bool)
            keep = 1.0 - p
            u = torch.empty_like(x, dtype=torch.float32).uniform_(
                0.0, 1.0, generator=self.gen)
            mask = u < keep
            scale = 1.0 / keep if keep > 0 else 0.0
            return x * mask * scale, mask
        if kwargs.get("generator") is None and any(
                a.name == "generator" for a in func._schema.arguments):
            kwargs["generator"] = self.gen
        return func(*args, **kwargs)


def _meta_state(module):
    return {n: torch.empty_like(t, device="meta") for n, t in
            itertools.chain(module.named_parameters(),
                            module.named_buffers())}


@register("TorchModule", arg_names=("data",), varargs=True, needs_rng=True)
def _torch_module(ctx, data, *params, **attrs):
    """Run a registered torch.nn.Module as a graph node (parity:
    plugin/torch/torch_module-inl.h).  Inputs: data + one array per
    torch parameter, cast to float32 as in the reference; attrs:
    module_id."""
    mid = int(parse_attr(attrs["module_id"]))
    if mid not in _MODULES:
        raise MXNetError(f"TorchModule: no module registered as {mid}")
    module = _MODULES[mid]
    names = [n for n, _ in module.named_parameters()]
    if len(params) != len(names):
        raise MXNetError(f"TorchModule({mid}) takes data and {len(names)} "
                         f"parameters {names}, got {len(params)}")
    x = data.to(torch.float32)
    if x.device.type == "meta":
        # shape inference: parameters and buffers stand in as meta
        # tensors, so the module's own stay untouched
        with _mode(module, ctx.is_train):
            return torch.func.functional_call(module, _meta_state(module),
                                              (x,))
    _on(module, x.device)
    ps = {n: p.to(torch.float32) for n, p in zip(names, params)}
    gen = ctx.generator if ctx.is_train else None
    with _mode(module, ctx.is_train), (
            _OpGenerator(gen) if gen is not None
            else contextlib.nullcontext()):
        out = torch.func.functional_call(module, ps, (x,))
    # the registered module holds the values the op ran with
    with torch.no_grad():
        for p, v in zip(module.parameters(), ps.values()):
            p.copy_(v)
    return out


def _label(crit, data, label):
    """The label as the criterion takes it: float32, as in the
    reference, except class indices (one dimension fewer than the data)
    for a criterion that has an ``ignore_index`` (``CrossEntropyLoss``,
    ``NLLLoss``), which need int64."""
    if (getattr(crit, "ignore_index", None) is not None
            and label.dim() == data.dim() - 1):
        return label.to(torch.int64)
    return label.to(torch.float32)


class _CriterionFn(torch.autograd.Function):
    """The loss forward; the backward feeds ``grad_scale · ∂loss/∂data``
    and ignores the head gradient, like the reference's loss layers."""

    @staticmethod
    def forward(fctx, crit, grad_scale, x, y):
        with torch.no_grad():
            loss = crit(x, y)
        if loss.numel() != 1:
            raise MXNetError(
                "TorchCriterion requires a scalar loss — register the "
                "criterion with a reduction (e.g. reduction='mean'), got "
                f"output shape {tuple(loss.shape)}")
        fctx.crit, fctx.grad_scale = crit, grad_scale
        fctx.save_for_backward(x, y)
        return loss.reshape(()).to(torch.float32)

    @staticmethod
    def backward(fctx, _head):
        x, y = fctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            (dx,) = torch.autograd.grad(fctx.crit(xd, y), xd)
        return None, None, dx * fctx.grad_scale, None


@register("TorchCriterion", arg_names=("data", "label"))
def _torch_criterion(ctx, data, label, **attrs):
    """Torch loss as an output op (parity: plugin/torch/
    torch_criterion-inl.h): the scalar loss, left on the device."""
    mid = int(parse_attr(attrs["criterion_id"]))
    if mid not in _CRITERIA:
        raise MXNetError(f"TorchCriterion: no criterion registered as {mid}")
    crit = _CRITERIA[mid]
    grad_scale = float(parse_attr(attrs.get("grad_scale", 1.0)))
    x = data.to(torch.float32)
    if x.device.type == "meta":
        return torch.empty((), dtype=torch.float32, device="meta")
    return _CriterionFn.apply(crit, grad_scale, x, _label(crit, x, label))


# late registration: regenerate the op functions so nd.TorchModule /
# sym.TorchModule exist even though this plugin loads after the package
# (both skip names that already exist)
from .. import ndarray as _nd  # noqa: E402
from .. import symbol as _sym  # noqa: E402

_nd._init_op_functions()
_sym._init_symbol_functions()
