"""The graph interpreter and the inference Executor of the port
(``mxnet_tpu/executor.py``).

:func:`_build_graph_fn` turns a Symbol into ``f(args, aux, gen,
is_train) -> (outputs, new_aux)``, which evaluates the nodes eagerly in
topological order; ``torch.autograd`` records the graph for the
backward (the trainer's path).

:func:`simple_bind` / :class:`Executor` bind a symbol for the forward:
the graph passes run at bind (``passes.apply_graph_passes``, as the JAX
executor runs them), and the JAX executor's channels-last (NHWC) layout
pass becomes torch's ``channels_last`` memory format: every 4-D
argument (the image input, the conv weights) is allocated channels-last
once at bind, tensors stay logical NCHW, and cuDNN keeps the
activations channels-last through conv, BN, ReLU, pooling and the adds,
which is what lets the residual-epilogue kernel view them as ``(N*H*W,
C)``.  ``MXTPU_CONV_LAYOUT=NCHW`` keeps every tensor contiguous
(NCHW memory), as it turns the JAX pass off.

Not ported yet (ROADMAP Queue 1 item 3), each raising where a caller
can reach it: ``backward``, train-mode ``forward`` and grad_req
``write``/``add`` (so the fused fwd+bwd), ctx-group placement, ``bind``
with given arrays, ``reshape``, ``type_dict``, the program cache and the
row-sparse Embedding path.
"""
from __future__ import annotations

import os
from typing import Dict

import torch

from . import ops
from .base import MXNetError
from .context import resolve_device
from .convert import _to_tensor
from .symbol import Symbol, _topo_order

__all__ = ["_build_graph_fn", "Executor", "simple_bind",
           "channels_last_default"]


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


def channels_last_default() -> bool:
    """``MXTPU_CONV_LAYOUT`` (default NHWC): channels-last memory for the
    4-D arguments of a bind unless it says NCHW."""
    return os.environ.get("MXTPU_CONV_LAYOUT", "NHWC").upper() != "NCHW"


def _not_ported(what):
    return MXNetError(f"{what} is not ported yet (ROADMAP Queue 1 item 3)")


class Executor:
    """A bound symbol (the JAX package's ``Executor``, forward only).

    ``arg_dict`` / ``aux_dict`` map names to the bound tensors on the
    bind device; :meth:`forward` runs the post-pass graph on them under
    ``torch.no_grad`` and keeps the outputs on the device (no host
    sync); :attr:`outputs` returns them."""

    def __init__(self, symbol: Symbol, device, arg_dict, aux_dict):
        from .passes import apply_graph_passes

        self._device = device
        self.arg_dict = dict(arg_dict)
        self.aux_dict = dict(aux_dict)
        # the graph passes run once, at bind; they never rename or drop
        # a variable, so the argument names stay as bound
        self._exec_symbol = apply_graph_passes(symbol)
        self._graph_fn = _build_graph_fn(self._exec_symbol, device)
        self._outputs = None

    @property
    def device(self) -> torch.device:
        return self._device

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``{name: value}`` (numpy arrays, tensors, NDArrays, JAX
        arrays) into the bound tensors, keeping their dtype, device and
        memory format; a name the bind lacks raises unless
        ``allow_extra_params``."""
        for kind, have, given in (("param", self.arg_dict, arg_params),
                                  ("aux", self.aux_dict, aux_params)):
            for k, v in (given or {}).items():
                dst = have.get(k)
                if dst is None:
                    if not allow_extra_params:
                        raise MXNetError(f"unknown {kind} {k}")
                    continue
                src = _to_tensor(v, dst.dtype, dst.device)
                if src.shape != dst.shape:
                    raise MXNetError(f"copy_params_from: {k} has shape "
                                     f"{tuple(src.shape)}, bound "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)

    def forward(self, is_train=False, **kwargs):
        """Run the graph in inference mode; ``kwargs`` set arguments
        first."""
        if is_train:
            raise _not_ported("Executor.forward(is_train=True) (the train "
                              "step of the Executor)")
        for k, v in kwargs.items():
            dst = self.arg_dict.get(k)
            if dst is None:
                raise MXNetError(f"unknown input {k}")
            dst.copy_(_to_tensor(v, dst.dtype, dst.device))
        with torch.no_grad():
            outs, _ = self._graph_fn(self.arg_dict, self.aux_dict, None,
                                     False)
        self._outputs = outs
        return outs

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("no forward has been run")
        return self._outputs

    def backward(self, out_grads=None):
        raise _not_ported("Executor.backward")


def simple_bind(symbol: Symbol, device=None, grad_req="null",
                group2ctx=None, **shapes) -> Executor:
    """Infer shapes from ``shapes``, allocate zeros (float32) for every
    argument and aux state on ``device`` (default: the card), and bind.
    4-D arguments are channels-last unless ``MXTPU_CONV_LAYOUT=NCHW``."""
    if grad_req != "null":
        raise _not_ported(f"simple_bind(grad_req={grad_req!r}) (the "
                          "backward)")
    if group2ctx:
        raise _not_ported("ctx-group placement (group2ctx)")
    device = resolve_device(device)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    if arg_shapes is None:
        raise MXNetError(f"simple_bind: cannot infer shapes from {shapes}")
    cl = channels_last_default()

    def alloc(shape):
        t = torch.zeros(shape, dtype=torch.float32, device=device)
        return t.contiguous(memory_format=torch.channels_last) \
            if cl and t.ndim == 4 else t

    args = {n: alloc(s) for n, s in zip(symbol.list_arguments(), arg_shapes)}
    aux = {n: alloc(s)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return Executor(symbol, device, args, aux)
