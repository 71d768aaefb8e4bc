"""Inference-mode Conv+BatchNorm folding (a copy of
``mxnet_tpu/passes/convbn.py`` over the port's Symbol).

At inference a BatchNorm over frozen moving statistics is an affine map
per channel:  ``y = (x - mean) * gamma/sqrt(var+eps) + beta``.  When
``x`` is the output of a Convolution, that affine folds INTO the conv:

    scale_c = gamma_c / sqrt(var_c + eps)          (ones when fix_gamma)
    W'_c    = W_c * scale_c
    b'_c    = beta_c + (b_c - mean_c) * scale_c    (b_c = 0 when no_bias)

so the rewritten graph runs one conv where the original ran a conv plus
a full normalization.

Inference-only: train-mode BN normalizes with batch statistics and
updates the moving stats, so this pass never runs inside
``apply_graph_passes`` (it is registered ``training_safe=False`` and
needs the parameter VALUES, which graph-level bind passes do not see).

Safety conditions per (conv, bn) pair — all structural, all checked:
the conv feeds ONLY the BN (any other consumer sees pre-BN
activations), the conv's weight/bias and the BN's gamma/beta/moving
stats are variables consumed only here (weight sharing would corrupt
the other consumer), and every needed value is present in the params.

Values may be numpy arrays, torch tensors, or anything with
``.asnumpy()`` or ``__array__`` (the JAX package's NDArrays and
arrays); the folded weights and biases come back as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import parse_attr, parse_bool
from ..symbol import Symbol, _Node
from . import register_pass
from .common import consumer_counts


def _value(params, name):
    v = params.get(name)
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)


def _sole_var(entry, counts):
    node, oidx = entry
    return (node.is_variable
            and counts.get((id(node), oidx), 0) == 1)


def fold_conv_bn(symbol, arg_params, aux_params):
    """Fold every eligible Conv->BN pair.

    Returns ``(symbol, arg_params, aux_params, n_folded)`` — new dicts,
    inputs untouched.  Weights are recomputed in float64 and cast back
    to the original weight dtype, keeping the fold's own rounding noise
    below the bf16 tolerances downstream.
    """
    arg_params = dict(arg_params or {})
    aux_params = dict(aux_params or {})
    counts = consumer_counts(symbol)

    folds: dict = {}  # id(bn node) -> fold plan
    for node in symbol.nodes:
        if node.is_variable or node.op != "BatchNorm":
            continue
        if len(node.inputs) != 5:
            continue
        (conv, conv_idx) = node.inputs[0]
        if conv.is_variable or conv.op != "Convolution" or conv_idx != 0:
            continue
        if counts.get((id(conv), 0), 0) != 1:
            continue  # someone else reads the pre-BN activation
        gamma_e, beta_e, mean_e, var_e = node.inputs[1:5]
        if not all(_sole_var(e, counts)
                   for e in (gamma_e, beta_e, mean_e, var_e)):
            continue
        if len(conv.inputs) < 2:
            continue
        weight_e = conv.inputs[1]
        bias_e = conv.inputs[2] if len(conv.inputs) > 2 else None
        if not _sole_var(weight_e, counts):
            continue
        if bias_e is not None and not _sole_var(bias_e, counts):
            continue

        w = _value(arg_params, weight_e[0].name)
        beta = _value(arg_params, beta_e[0].name)
        mean = _value(aux_params, mean_e[0].name)
        var = _value(aux_params, var_e[0].name)
        if any(v is None for v in (w, beta, mean, var)):
            continue
        fix_gamma = parse_bool(node.attrs.get("fix_gamma", True))
        gamma = None if fix_gamma else _value(arg_params, gamma_e[0].name)
        if not fix_gamma and gamma is None:
            continue
        bias = (_value(arg_params, bias_e[0].name)
                if bias_e is not None else None)
        eps = float(parse_attr(node.attrs.get("eps", 1e-3)))

        scale = 1.0 / np.sqrt(var.astype(np.float64) + eps)
        if gamma is not None:
            scale = scale * gamma.astype(np.float64)
        w_dtype = w.dtype
        w64 = w.astype(np.float64) * scale.reshape((-1,) + (1,) * (w.ndim - 1))
        b64 = beta.astype(np.float64) - mean.astype(np.float64) * scale
        if bias is not None:
            b64 = b64 + bias.astype(np.float64) * scale
        folds[id(node)] = {
            "conv": conv,
            "weight_name": weight_e[0].name,
            "bias_entry": bias_e,
            "bias_name": (bias_e[0].name if bias_e is not None
                          else f"{conv.name}_bias"),
            "drop_args": [gamma_e[0].name, beta_e[0].name],
            "drop_aux": [mean_e[0].name, var_e[0].name],
            "w": w64.astype(w_dtype),
            "b": b64.astype(w_dtype),
        }

    if not folds:
        return symbol, arg_params, aux_params, 0

    memo: dict = {}
    for node in symbol.nodes:
        if node.is_variable:
            memo[id(node)] = ((node, 0),)
            continue
        plan = folds.get(id(node))
        if plan is not None:
            conv = plan["conv"]
            data_entry = memo[id(conv.inputs[0][0])][conv.inputs[0][1]]
            weight_entry = memo[id(conv.inputs[1][0])][0]
            if plan["bias_entry"] is not None:
                bias_entry = memo[id(plan["bias_entry"][0])][0]
            else:
                bias_entry = (_Node(None, plan["bias_name"]), 0)
            attrs = dict(conv.attrs)
            attrs["no_bias"] = False
            folded = _Node("Convolution", conv.name, attrs=attrs,
                           inputs=[data_entry, weight_entry, bias_entry],
                           extra_attrs=conv.extra_attrs)
            memo[id(node)] = ((folded, 0),)
            continue
        new_inputs = [memo[id(src)][oidx] for src, oidx in node.inputs]
        if all(e[0] is src and e[1] == oidx
               for e, (src, oidx) in zip(new_inputs, node.inputs)):
            memo[id(node)] = tuple(
                (node, k) for k in range(node.num_outputs()))
        else:
            clone = _Node(node.op, node.name, attrs=node.attrs,
                          inputs=new_inputs, extra_attrs=node.extra_attrs)
            memo[id(node)] = tuple(
                (clone, k) for k in range(clone.num_outputs()))
    rewritten = Symbol([memo[id(n)][i] for n, i in symbol._outputs])

    for plan in folds.values():
        arg_params[plan["weight_name"]] = plan["w"]
        arg_params[plan["bias_name"]] = plan["b"]
        for name in plan["drop_args"]:
            arg_params.pop(name, None)
        for name in plan["drop_aux"]:
            aux_params.pop(name, None)
    return rewritten, arg_params, aux_params, len(folds)


@register_pass("convbn_fold", training_safe=False, needs_params=True)
def convbn_fold(symbol, arg_params, aux_params):
    """Pass-registry entry point (telemetry-counted wrapper lives in
    ``passes.apply_convbn_fold``); see :func:`fold_conv_bn`."""
    return fold_conv_bn(symbol, arg_params, aux_params)
