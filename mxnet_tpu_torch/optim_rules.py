"""Per-tensor optimizer rules of the port (``_RULES`` of
``mxnet_tpu/optim_rules.py``).

Each rule factory takes the optimizer's hyperparameters and returns
``(init_state, update)``: ``init_state(w)`` makes the state tensors and
``update(w, g, state, lr, wd_mult)`` runs the op of
:mod:`mxnet_tpu_torch.ops.optimizer_ops` on them, **in place** (the
master ``w`` and its state are overwritten; they are also returned, as
the JAX rules return their new values).

:func:`multi_rule` is the multi-tensor form the bucketed kvstore update
(:mod:`mxnet_tpu_torch.kvstore_fused`) runs over every key of a bucket:
the same arithmetic as the per-tensor rule, operation for operation,
through ``torch._foreach_*`` ops, so a bucket costs a fixed number of
launches whatever its key count (the JAX engine tree-maps the per-tensor
rule inside one jitted program instead).  :func:`sparse_rule` is the
row-wise lazy form the row-sparse update runs on gathered rows
(:func:`mxnet_tpu_torch.sparse.make_row_program`).  The flat (sharded)
variant waits for ROADMAP Queue 1 item 10b.
"""
from __future__ import annotations

import torch

from . import ops
from .base import parse_bool

__all__ = ["_RULES", "multi_rule", "sparse_rule"]


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

# the row-wise lazy variants: every per-tensor rule is elementwise, so
# applied to the gathered touched rows of a table it is the exact
# per-row arithmetic of the dense rule; untouched rows are neither
# decayed nor moved (the reference's lazy_update)
_SPARSE_NSLOTS = {"adam": 2, "rmsprop": 1}


def sparse_rule(rule_name, opt_params):
    """``(state slots, row_update)`` of rule ``rule_name`` for the
    row-sparse update, or None when it has no sparse form.
    ``row_update`` is the per-tensor rule's ``update``, applied to
    ``(rows, ...)`` stacks instead of whole tensors."""
    factory = _RULES.get(rule_name)
    if factory is None:
        return None
    _init, update = factory(dict(opt_params))
    if rule_name == "sgd":
        nslots = 1 if opt_params.get("momentum") else 0
    else:
        nslots = _SPARSE_NSLOTS[rule_name]
    return nslots, update


# ---------------------------------------------------- multi-tensor rules
def _prep_flat(flat, opt_params):
    """``clip(flat * rescale)`` in place on the bucket's merged gradient
    (``_prep_grad`` of the ops, less the weight decay, which is per
    key)."""
    rescale = float(opt_params.get("rescale_grad", 1.0))
    clip = float(opt_params.get("clip_gradient", 0.0) or 0.0)
    if rescale != 1.0:
        flat.mul_(rescale)
    if clip > 0:
        flat.clamp_(-clip, clip)


def _add_wd(ws, gs, wds):
    """``g += wd * w`` for the keys whose wd is not 0 (the ops leave a
    wd of 0 out)."""
    sel = [i for i, wd in enumerate(wds) if wd != 0.0]
    if sel:
        torch._foreach_add_([gs[i] for i in sel], torch._foreach_mul(
            [ws[i] for i in sel], [wds[i] for i in sel]))


def _multi_sgd(opt_params):
    momentum = float(opt_params.get("momentum", 0.0))

    def update(ws, gs, states, lrs):
        # lr * g, in the scratch gradient (it is not read again)
        torch._foreach_mul_(gs, lrs)
        if momentum:
            moms = [s[0] for s in states]
            torch._foreach_mul_(moms, momentum)
            torch._foreach_sub_(moms, gs)
            torch._foreach_add_(ws, moms)
        else:
            torch._foreach_sub_(ws, gs)

    return (1 if momentum else 0), update


def _multi_adam(opt_params):
    beta1 = float(opt_params.get("beta1", 0.9))
    beta2 = float(opt_params.get("beta2", 0.999))
    eps = float(opt_params.get("epsilon", 1e-8))

    def update(ws, gs, states, lrs):
        means = [s[0] for s in states]
        var = [s[1] for s in states]
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(means, beta1)
        torch._foreach_mul_(gs, 1 - beta1)
        torch._foreach_add_(means, gs)
        torch._foreach_mul_(var, beta2)
        torch._foreach_mul_(sq, 1 - beta2)
        torch._foreach_add_(var, sq)
        den = torch._foreach_sqrt(var)
        torch._foreach_add_(den, eps)
        num = torch._foreach_mul(means, lrs)
        torch._foreach_div_(num, den)
        torch._foreach_sub_(ws, num)

    return 2, update


def _multi_rmsprop(opt_params):
    if parse_bool(opt_params.get("centered", False)):
        raise ValueError("the multi-tensor rmsprop rule is the plain "
                         "(Tieleman-Hinton) variant")
    gamma1 = float(opt_params.get("gamma1", 0.95))
    eps = float(opt_params.get("epsilon", 1e-8))
    cw = float(opt_params.get("clip_weights", 0.0) or 0.0)

    def update(ws, gs, states, lrs):
        n = [s[0] for s in states]
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1 - gamma1)
        torch._foreach_mul_(n, gamma1)
        torch._foreach_add_(n, sq)
        den = torch._foreach_add(n, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_mul_(gs, lrs)
        torch._foreach_div_(gs, den)
        torch._foreach_sub_(ws, gs)
        if cw > 0:
            torch._foreach_clamp_min_(ws, -cw)
            torch._foreach_clamp_max_(ws, cw)

    return 1, update


_MULTI_RULES = {"sgd": _multi_sgd, "adam": _multi_adam,
                "rmsprop": _multi_rmsprop}


def multi_rule(rule_name, opt_params):
    """``(state slots, update)`` of rule ``rule_name`` over a list of
    tensors.  ``update(flat, ws, gs, states, lrs, wds)`` takes the
    bucket's merged gradient ``flat``, the per-key weights ``ws``, their
    gradients ``gs`` (views of ``flat``, used as scratch), the state
    tuples and the per-key lr and effective wd, and updates ``ws`` and
    the states in place."""
    nslots, step = _MULTI_RULES[rule_name](opt_params)

    def update(flat, ws, gs, states, lrs, wds):
        _prep_flat(flat, opt_params)
        _add_wd(ws, gs, wds)
        step(ws, gs, states, lrs)

    return nslots, update
