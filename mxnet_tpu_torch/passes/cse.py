"""Common-subexpression elimination over the symbolic graph (a copy of
``mxnet_tpu/passes/cse.py`` over the port's Symbol).

Two op nodes are merged when they agree on op type, attrs, extra attrs,
and (recursively deduplicated) input entries; internal op-node *names*
are ignored, so a graph written twice (``a*b + a*b``) and a graph
written once with a shared subexpression rewrite to the identical DAG.

The JAX pass never merges random ops (two Dropout nodes draw different
masks) or its Custom/native escape hatches; the port has none of those
ops yet, so every op node is a candidate — the port of the first random
op must bring that exclusion back (``OpDef.needs_rng`` in the JAX
registry).  Aux-carrying ops (BatchNorm) merge only when every input
including the aux-state variables is shared, in which case the duplicate
would have produced identical aux updates.
"""
from __future__ import annotations

from ..base import frozen_attrs
from ..symbol import Symbol, _Node
from . import register_pass


@register_pass("cse", training_safe=True)
def cse(symbol):
    """Merge structurally identical nodes; duplicates become unreachable
    and are pruned by reconstruction.  Training-safe: the merged node
    is the same pure function of the same inputs, so vjp sums the
    cotangents from all former consumers exactly as the duplicated
    graph would have accumulated them."""
    memo: dict = {}
    seen: dict = {}
    for node in symbol.nodes:
        if node.is_variable:
            memo[id(node)] = ((node, 0),)
            continue
        new_inputs = [memo[id(src)][oidx] for src, oidx in node.inputs]
        unchanged = all(e[0] is src and e[1] == oidx
                        for e, (src, oidx) in zip(new_inputs, node.inputs))
        if unchanged:
            cand = node
        else:
            cand = _Node(node.op, node.name, attrs=node.attrs,
                         inputs=new_inputs, extra_attrs=node.extra_attrs)
        entries = tuple((cand, k) for k in range(cand.num_outputs()))
        try:
            key = (node.op, frozen_attrs(node.attrs),
                   tuple(sorted(node.extra_attrs.items())),
                   tuple((id(e[0]), e[1]) for e in new_inputs))
        except TypeError:  # unhashable attr value: leave the node be
            key = None
        if key is not None:
            prev = seen.get(key)
            if prev is not None:
                entries = prev
            else:
                seen[key] = entries
        memo[id(node)] = entries
    return Symbol([memo[id(n)][i] for n, i in symbol._outputs])
