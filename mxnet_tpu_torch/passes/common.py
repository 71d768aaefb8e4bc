"""Shared graph-rewrite machinery for the pass pipeline (a copy of
``mxnet_tpu/passes/common.py`` over the port's Symbol).

Every pass is Symbol -> Symbol over the lightweight ``_Node`` DAG in
symbol.py.  Nodes are treated as immutable: a rewrite never mutates a
node in place (the original symbol stays bound to the executor as the
user-facing interface), it rebuilds the affected slice of the graph
bottom-up and shares every untouched node with the input symbol.
Reconstruction from the output entries doubles as dead-node pruning —
anything the new heads cannot reach simply is not part of the result
(the same property the reference gets from nnvm's IndexedGraph).
"""
from __future__ import annotations

from ..symbol import Symbol, _Node


def op_node_count(symbol: Symbol) -> int:
    """Number of op (non-variable) nodes — the pass-effect metric."""
    return sum(1 for n in symbol.nodes if not n.is_variable)


def consumer_counts(symbol: Symbol):
    """{(id(node), out_idx): number of consumers}, counting each output
    head of the symbol as one extra consumer (an entry a head exposes is
    observable and must not be rewritten away as 'internal')."""
    counts: dict = {}
    for node in symbol.nodes:
        for src, oidx in node.inputs:
            key = (id(src), oidx)
            counts[key] = counts.get(key, 0) + 1
    for node, oidx in symbol._outputs:
        key = (id(node), oidx)
        counts[key] = counts.get(key, 0) + 1
    return counts


def clone_rewrite(symbol: Symbol, rewrite):
    """Rebuild ``symbol`` bottom-up through ``rewrite``.

    ``rewrite(node, new_inputs)`` is called once per op node in topo
    order with the node's inputs already remapped into the new graph.
    It returns either ``None`` — keep the node (re-created only if its
    inputs actually moved, shared otherwise) — or a list of replacement
    entries, one per node output.  Variables are always shared: they are
    the bind interface and passes must never rename or copy them.
    """
    memo: dict = {}
    for node in symbol.nodes:
        if node.is_variable:
            memo[id(node)] = ((node, 0),)
            continue
        new_inputs = [memo[id(src)][oidx] for src, oidx in node.inputs]
        replaced = rewrite(node, new_inputs)
        if replaced is not None:
            memo[id(node)] = tuple(replaced)
            continue
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
