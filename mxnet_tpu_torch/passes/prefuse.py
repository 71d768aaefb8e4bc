"""Elementwise-chain pre-fusion (a copy of ``mxnet_tpu/passes/prefuse.py``
over the port's Symbol).

Collapses maximal single-consumer chains of ``ops/elemwise.py``
primitives (unary math, scalar binaries, clip, smooth_l1, Cast) into
ONE ``_fused_elemwise`` node whose attrs carry the op program, so a
chain of k ops is one node of the graph interpreter (one registry
lookup and one ``_eval_node`` call).  The kernels it launches are the
chain's own, in order; autograd differentiates straight through the
replayed chain, identical math to the unfused graph.
"""
from __future__ import annotations

from .. import ops
from ..base import frozen_attrs
from ..ops import elemwise as _ew
from ..symbol import _Node
from . import register_pass
from .common import clone_rewrite, consumer_counts

# fusible primitives: single-input, single-output, elementwise, pure
FUSIBLE = (frozenset(_ew._UNARY) | frozenset(_ew._SCALAR)
           | {"_copy", "identity", "BlockGrad", "stop_gradient",
              "Cast", "cast", "clip", "smooth_l1"})

MIN_CHAIN = 2


@ops.register("_fused_elemwise", arg_names=("data",))
def _fused_elemwise(ctx, data, **attrs):
    """Replay a pre-fused elementwise chain (attrs['ops'] = tuple of
    (opname, frozen_attrs) in application order)."""
    out = data
    for opname, fattrs in attrs["ops"]:
        out = ops.get(opname).fn(ctx, out, **dict(fattrs))
    return out


def _fusible(node):
    return (not node.is_variable and node.op in FUSIBLE
            and len(node.inputs) == 1 and node.num_outputs() == 1
            and "ctx_group" not in node.extra_attrs)


@register_pass("prefuse", training_safe=True)
def prefuse(symbol):
    """Collapse maximal fusible chains into single ``_fused_elemwise``
    nodes.  A chain link requires the producer to be consumed ONLY by
    the next op in the chain and by no output head — interior values
    must not be observable."""
    counts = consumer_counts(symbol)

    # chains[id(tail)] = the chain's nodes, head..tail
    chains: dict = {}
    chain_member: set = set()
    for node in reversed(symbol.nodes):  # tails appear after their heads
        if id(node) in chain_member or not _fusible(node):
            continue
        run = [node]
        cur = node
        while True:
            src, oidx = cur.inputs[0]
            if (_fusible(src) and oidx == 0
                    and counts.get((id(src), 0), 0) == 1):
                run.append(src)
                cur = src
            else:
                break
        if len(run) >= MIN_CHAIN:
            run.reverse()  # head..tail
            chains[id(node)] = run
            chain_member.update(id(n) for n in run)

    if not chains:
        return symbol
    heads = {id(run[0]) for run in chains.values()}
    feeds: dict = {}  # id(chain head) -> its rebuilt feed entry

    def rewrite(node, new_inputs):
        if id(node) in heads:
            feeds[id(node)] = new_inputs[0]
        run = chains.get(id(node))
        if run is None:
            return None  # interior nodes are pruned by the rebuild
        program = tuple((n.op, frozen_attrs(n.attrs)) for n in run)
        return [(_Node("_fused_elemwise", node.name, attrs={"ops": program},
                       inputs=[feeds[id(run[0])]],
                       extra_attrs=node.extra_attrs), 0)]

    return clone_rewrite(symbol, rewrite)
