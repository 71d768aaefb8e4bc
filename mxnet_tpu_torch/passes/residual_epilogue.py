"""Residual-epilogue fusion pass (a copy of
``mxnet_tpu/passes/residual_epilogue.py`` over the port's Symbol).

Matches the residual tails ``models/resnet.py`` (and friends) produce —
the ``conv3 + shortcut`` sum flowing into the next unit's norm/ReLU —
and collapses them into the fused epilogue ops of
``ops/residual_epilogue.py``, so the CUDA kernel (or the plain version
on the CPU) replaces separate add / normalise / ReLU kernels without
any model-code change.

Two patterns, innermost-first:

- ``Activation[relu](elemwise_add(a, b))``
  -> ``_residual_epilogue(a, b)``
- ``Activation[relu](BatchNorm(elemwise_add(a, b)))``
  -> ``_residual_epilogue_bn(a, b, gamma, beta | mean, var)``
  (BN attrs carried over; the op replays the exact train-mode
  composite and fuses only where the stats are static — see the op's
  docstring — which is what keeps this pass ``training_safe``.)

Safety: every interior value (the add's output, the BN's output) must
have exactly ONE consumer and must not be exposed as a graph head —
otherwise the observable value would be rewritten away.
"""
from __future__ import annotations

from ..symbol import Symbol, _Node
from . import register_pass
from .common import consumer_counts

_ADD_OPS = frozenset({"elemwise_add", "_plus", "_add", "_Plus"})


def _is_relu(node):
    return (node.op == "Activation"
            and str(node.attrs.get("act_type", "relu")) == "relu")


def _sole(entry, counts):
    return counts.get((id(entry[0]), entry[1]), 0) == 1


@register_pass("residual_epilogue", training_safe=True)
def residual_epilogue(symbol: Symbol) -> Symbol:
    counts = consumer_counts(symbol)

    # id(relu node) -> ("plain", add_node) | ("bn", bn_node, add_node)
    matches: dict = {}
    for node in symbol.nodes:
        if node.is_variable or not _is_relu(node) or len(node.inputs) != 1:
            continue
        src, oidx = node.inputs[0]
        if oidx != 0 or src.is_variable:
            continue
        if src.op in _ADD_OPS and _sole(node.inputs[0], counts):
            matches[id(node)] = ("plain", src)
        elif src.op == "BatchNorm" and _sole(node.inputs[0], counts):
            inner, iidx = src.inputs[0]
            if (not inner.is_variable and inner.op in _ADD_OPS
                    and iidx == 0 and _sole(src.inputs[0], counts)):
                matches[id(node)] = ("bn", src, inner)
    if not matches:
        return symbol

    memo: dict = {}
    for node in symbol.nodes:
        if node.is_variable:
            memo[id(node)] = ((node, 0),)
            continue
        m = matches.get(id(node))
        if m is not None and m[0] == "plain":
            add = m[1]
            fused = _Node(
                "_residual_epilogue", node.name, attrs={},
                inputs=[memo[id(s)][i] for s, i in add.inputs],
                extra_attrs=node.extra_attrs)
            memo[id(node)] = ((fused, 0),)
            continue
        if m is not None:
            _, bn, add = m
            # inputs: add's (a, b) then BN's gamma/beta + moving stats
            # (the aux pair must stay LAST: _eval_node maps the op's
            # aux_names onto the trailing inputs)
            ins = [memo[id(s)][i] for s, i in add.inputs]
            ins += [memo[id(s)][i] for s, i in bn.inputs[1:]]
            fused = _Node("_residual_epilogue_bn", node.name,
                          attrs=dict(bn.attrs), inputs=ins,
                          extra_attrs=node.extra_attrs)
            memo[id(node)] = ((fused, 0),)
            continue
        # interior nodes of a match still get memo entries (the fused
        # node reads memo of the ADD'S inputs); reconstruction from the
        # heads prunes them from the result
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
    return Symbol([memo[id(n)][i] for n, i in symbol._outputs])
