"""Constant folding (a copy of ``mxnet_tpu/passes/constant_fold.py``
over the port's Symbol): evaluate constant subgraphs once, at bind.

A subgraph is constant when every leaf is a creation op without inputs
(``_zeros``/``_ones``/``_full``/``_arange``/...) and every interior op
is deterministic (no random draw, no aux state, no Custom escape hatch).
The frontier of each maximal constant region — the constant node that a
non-constant consumer or an output head reads — is evaluated here once,
on the CPU, and baked into the graph as a ``_literal`` node carrying its
bytes; the op places the value on the bind's device.

Leaves alone are not folded (one creation op either way), so a node
folds only when it has an input.  A value larger than
``FOLD_MAX_BYTES`` stays unfolded: its bytes would bloat the attrs.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..base import numeric_dtype
from ..symbol import _Node
from . import register_pass
from .common import clone_rewrite

# ops that must never fold even when their inputs are constant: PRNG
# draws differ per step, Custom/native ops may touch external state
_BLOCKLIST = {"Custom", "_Native", "_NDArray"}

FOLD_MAX_BYTES = 1 << 16

_CPU = torch.device("cpu")
# each folded constant's copy on each device it ran on: a forward then
# makes no host-to-device copy (which would wait on the host)
_PLACED: dict = {}


@ops.register("_literal", arg_names=())
def _literal(ctx, **attrs):
    """A folded constant: its bytes, dtype and shape in the attrs (so
    two graphs folding to different values differ in their attrs), on
    ``ctx.device`` (made there once)."""
    device = torch.device(ctx.device or _CPU)
    shape = tuple(attrs["shape"])
    key = (attrs["data"], attrs["dtype"], shape, device)
    t = _PLACED.get(key)
    if t is None:
        dtype = numeric_dtype(attrs["dtype"])
        buf = bytearray(attrs["data"])
        t = (torch.frombuffer(buf, dtype=dtype) if buf
             else torch.empty(0, dtype=dtype))
        t = _PLACED[key] = t.reshape(shape).to(device)
    return t


def _is_const(node, const):
    if node.is_variable:
        return False
    od = ops.get(node.op)
    if od.needs_rng or od.aux_names or node.op in _BLOCKLIST:
        return False
    return all(const.get(id(src), False) for src, _ in node.inputs)


def _eval_const(node, values):
    """Evaluate one constant node on the CPU (memoised); the tuple of
    its output tensors."""
    got = values.get(id(node))
    if got is not None:
        return got
    ins = [_eval_const(src, values)[oidx] for src, oidx in node.inputs]
    with torch.no_grad():
        res = ops.get(node.op).fn(ops.OpCtx(is_train=False, device=_CPU),
                                  *ins, **node.attrs)
    if not isinstance(res, tuple):
        res = (res,)
    values[id(node)] = res
    return res


def _host_bytes(t: torch.Tensor):
    """``(bytes, dtype name)`` of a CPU tensor; bf16 through its 16-bit
    pattern, which numpy lacks."""
    t = t.detach().contiguous()
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.asarray(t.numpy()).tobytes(), name


@register_pass("constant_fold", training_safe=True)
def constant_fold(symbol):
    """Fold the frontier of every maximal constant subgraph into
    ``_literal`` nodes.  Training-safe: a constant has no variable
    ancestor, hence no gradient path."""
    const: dict = {}
    for node in symbol.nodes:
        if not node.is_variable:
            const[id(node)] = _is_const(node, const)

    values: dict = {}

    def rewrite(node, new_inputs):
        if not const.get(id(node)) or not node.inputs:
            return None
        if node.op == "_literal":
            return None  # already folded (idempotent re-runs)
        try:
            outs = _eval_const(node, values)
        except Exception:  # noqa: BLE001 — an op that refuses eager
            return None    # evaluation simply stays in the graph
        if sum(o.numel() * o.element_size() for o in outs) > FOLD_MAX_BYTES:
            return None
        entries = []
        for k, o in enumerate(outs):
            data, dtype = _host_bytes(o)
            lit = _Node("_literal",
                        node.name if len(outs) == 1 else f"{node.name}_{k}",
                        attrs={"data": data, "dtype": dtype,
                               "shape": tuple(int(s) for s in o.shape)},
                        extra_attrs=node.extra_attrs)
            entries.append((lit, 0))
        return entries

    return clone_rewrite(symbol, rewrite)
