"""The graph interpreter of the port (``_build_graph_fn`` of
``mxnet_tpu/executor.py``).

:func:`_build_graph_fn` turns a Symbol into ``f(args, aux, gen,
is_train) -> (outputs, new_aux)``, which evaluates the nodes eagerly in
topological order; ``torch.autograd`` records the graph for the
backward.  The port runs the graph as written: the JAX package's graph
passes (ROADMAP Queue 1 item 5), its channels-last layout pass and its
row-sparse Embedding path are not ported, and neither are ``Executor`` /
``bind`` (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

from typing import Dict

from . import ops
from .symbol import Symbol, _topo_order

__all__ = ["_build_graph_fn"]


def _eval_node(node, env, ctx):
    """Evaluate one op node into ``env``; returns ``{aux_name: value}``."""
    od = ops.get(node.op)
    ins = [env[id(src)][oidx] for src, oidx in node.inputs]
    res = od.fn(ctx, *ins, **node.attrs)
    aux_updates = {}
    if od.aux_names:
        res, updates = res
        for (aux_node, _), val in zip(node.inputs[-len(od.aux_names):],
                                      updates):
            aux_updates[aux_node.name] = val
    env[id(node)] = res if isinstance(res, tuple) else (res,)
    return aux_updates


def _build_graph_fn(symbol: Symbol, device=None):
    """``f(arg_vals, aux_vals, gen, is_train) -> (outputs, new_aux)``.

    ``arg_vals``/``aux_vals`` map variable names to tensors; ``gen`` is
    the ``torch.Generator`` random ops draw from (or None); ``device`` is
    handed to the ops through their :class:`~.ops.registry.OpCtx`."""
    out_entries = list(symbol._outputs)
    topo = _topo_order([n for n, _ in out_entries])

    def fn(arg_vals: Dict, aux_vals: Dict, gen, is_train: bool):
        env = {}
        new_aux = dict(aux_vals)
        ctx = ops.OpCtx(is_train=is_train, device=device, generator=gen)
        for node in topo:
            if node.is_variable:
                src = aux_vals if node.is_aux else arg_vals
                env[id(node)] = (src[node.name],)
                continue
            new_aux.update(_eval_node(node, env, ctx))
        return [env[id(n)][i] for n, i in out_entries], new_aux

    return fn
