"""Per-tensor optimizer rules of the port (``_RULES`` of
``mxnet_tpu/optim_rules.py``).

Each rule factory takes the optimizer's hyperparameters and returns
``(init_state, update)``: ``init_state(w)`` makes the state tensors and
``update(w, g, state, lr, wd_mult)`` runs the op of
:mod:`mxnet_tpu_torch.ops.optimizer_ops` on them, **in place** (the
master ``w`` and its state are overwritten; they are also returned, as
the JAX rules return their new values).  The flat and sparse rule
variants of the kvstore paths are not ported yet (ROADMAP Queue 1
item 6).
"""
from __future__ import annotations

import torch

from . import ops
from .base import parse_bool

__all__ = ["_RULES"]


def _sgd_rule(opt_params):
    momentum = opt_params.get("momentum", 0.0)
    base_wd = float(opt_params.get("wd", 0.0))
    attrs = {k: opt_params[k] for k in ("rescale_grad", "clip_gradient")
             if k in opt_params}

    def init_state(w):
        return (torch.zeros_like(w),) if momentum else ()

    def update(w, g, state, lr, wd_mult=1.0):
        octx = ops.OpCtx()
        wd = base_wd * wd_mult
        if momentum:
            new_w, new_m = ops.get("sgd_mom_update").fn(
                octx, w, g, state[0], momentum=momentum, lr=lr, wd=wd,
                **attrs)
            return new_w, (new_m,)
        return ops.get("sgd_update").fn(octx, w, g, lr=lr, wd=wd,
                                        **attrs), ()

    return init_state, update


def _adam_rule(opt_params):
    base_wd = float(opt_params.get("wd", 0.0))
    attrs = {k: opt_params[k] for k in ("rescale_grad", "clip_gradient",
                                       "beta1", "beta2", "epsilon")
             if k in opt_params}

    def init_state(w):
        return (torch.zeros_like(w), torch.zeros_like(w))

    def update(w, g, state, lr, wd_mult=1.0):
        new_w, m, v = ops.get("adam_update").fn(
            ops.OpCtx(), w, g, state[0], state[1], lr=lr,
            wd=base_wd * wd_mult, **attrs)
        return new_w, (m, v)

    return init_state, update


def _rmsprop_rule(opt_params):
    if parse_bool(opt_params.get("centered", False)):
        raise ValueError("the fused rmsprop rule is the plain "
                         "(Tieleman-Hinton) variant; centered RMSProp is "
                         "not ported")
    base_wd = float(opt_params.get("wd", 0.0))
    attrs = {k: opt_params[k] for k in ("rescale_grad", "clip_gradient",
                                       "gamma1", "epsilon", "clip_weights")
             if k in opt_params}

    def init_state(w):
        return (torch.zeros_like(w),)

    def update(w, g, state, lr, wd_mult=1.0):
        new_w, n = ops.get("rmsprop_update").fn(
            ops.OpCtx(), w, g, state[0], lr=lr, wd=base_wd * wd_mult,
            **attrs)
        return new_w, (n,)

    return init_state, update


_RULES = {"sgd": _sgd_rule, "adam": _adam_rule, "rmsprop": _rmsprop_rule}
