"""The graph interpreter and the Executor of the port
(``mxnet_tpu/executor.py``).

:func:`_build_graph_fn` turns a Symbol into ``f(args, aux, gen,
is_train) -> (outputs, new_aux)``, which evaluates the nodes eagerly in
topological order; ``torch.autograd`` records the graph for the
backward (the trainer's path).

:func:`simple_bind` / :func:`bind` / :class:`Executor` bind a symbol:
the graph passes run at bind (``passes.apply_graph_passes``, as the JAX
executor runs them), and the JAX executor's channels-last (NHWC) layout
pass becomes torch's ``channels_last`` memory format: every 4-D
argument (the image input, the conv weights) is allocated channels-last
once at bind, tensors stay logical NCHW, and cuDNN keeps the
activations channels-last through conv, BN, ReLU, pooling and the adds,
which is what lets the residual-epilogue kernel view them as ``(N*H*W,
C)``.  ``MXTPU_CONV_LAYOUT=NCHW`` keeps every tensor contiguous
(NCHW memory), as it turns the JAX pass off.

Training (the reference's fused fwd+bwd, ``_make_fwdbwd``):
``forward(is_train=True)`` runs the graph under ``torch.autograd`` with
the arguments whose ``grad_req`` is not ``null`` as leaves, writes the
aux states back and keeps the outputs readable; ``backward(out_grads)``
differentiates that graph once — the head gradient is ones when none is
given (the loss ops ignore it), a caller's head takes the output's dtype
— and writes each gradient into its bound buffer (``write``) or adds it
there (``add``).  Under AMP loss scaling (``MXTPU_LOSS_SCALE`` with
``MXTPU_AMP``, decided at bind) each gradient is multiplied by the
scaler's device scale first, in the gradient's dtype.  The graph is
freed by the backward, so a second ``backward`` needs a new
``forward``.

Monitoring (``set_monitor_callback``, parity:
GraphExecutor::SetMonitorCallback): after each inference forward and
each backward (a training step taps once, as the JAX executor) the
internal outputs of the symbol (``get_internals``, without the passes)
are evaluated in inference mode and handed to the callback by name.  A
callback that is a bound method of an object with an ``activated`` flag
(``monitor.Monitor.stat_helper``) is tapped only while the flag is set.

Bound arrays are tensors: ``arg_dict``/``grad_dict``/``aux_dict`` map
names to torch tensors on the bind device (``bind`` shares the storage
of the tensors or NDArrays it is given), and ``outputs`` are tensors.
Not ported yet, each raising where a caller can reach it: ctx-group
placement (``group2ctx``) and the structural-signature program cache
(ROADMAP Queue 1 item 4), and row-sparse gradients (item 7).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from . import amp as _amp
from . import ops
from . import random as _random
from .base import MXNetError, numeric_dtype
from .context import resolve_device
from .convert import _to_tensor
from .ndarray import NDArray
from .symbol import Symbol, _topo_order

__all__ = ["_build_graph_fn", "Executor", "simple_bind", "bind",
           "channels_last_default"]

_GRAD_REQ = ("null", "write", "add")


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


def _not_ported(what, item):
    return MXNetError(f"{what} is not ported yet (ROADMAP Queue 1 item "
                      f"{item})")


def _as_list(names, given, what):
    """``given`` (a dict or a list in ``names`` order) as a dict."""
    if given is None:
        return {}
    if isinstance(given, dict):
        return dict(given)
    given = list(given)
    if len(given) != len(names):
        raise MXNetError(f"bind: expected {len(names)} {what} ({names}), "
                         f"got {len(given)}")
    return dict(zip(names, given))


def _req_dict(arg_names, grad_req):
    if isinstance(grad_req, str):
        req = {k: grad_req for k in arg_names}
    elif isinstance(grad_req, (list, tuple)):
        req = dict(zip(arg_names, grad_req))
    else:
        req = {k: grad_req.get(k, "null") for k in arg_names}
    for k, v in req.items():
        if v not in _GRAD_REQ:
            raise MXNetError(f"invalid grad_req {v} for {k}")
    return req


def _refuse_row_sparse(symbol):
    for node in symbol.nodes:
        if (node.is_variable and node.extra_attrs.get("__grad_stype__")
                == "row_sparse"):
            raise _not_ported(f"row-sparse gradients ({node.name})", 7)


class Executor:
    """A bound symbol.

    ``arg_dict`` / ``aux_dict`` / ``grad_dict`` map names to the bound
    tensors on the bind device; :meth:`forward` runs the post-pass graph
    on them and keeps the outputs on the device (no host sync);
    :attr:`outputs` returns them; :meth:`backward` fills ``grad_dict``
    per ``grad_req``."""

    def __init__(self, symbol: Symbol, device, arg_dict, aux_dict,
                 grad_dict=None, grad_req="null"):
        from .passes import apply_graph_passes

        self._symbol = symbol
        self._device = device
        arg_names = symbol.list_arguments()
        missing = [k for k in arg_names if k not in arg_dict]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")
        missing = [k for k in symbol.list_auxiliary_states()
                   if k not in aux_dict]
        if missing:
            raise MXNetError(f"bind: missing aux states {missing}")
        self.arg_dict = {k: arg_dict[k] for k in arg_names}
        self.aux_dict = dict(aux_dict)
        self.grad_dict = dict(grad_dict or {})
        self.grad_req = _req_dict(arg_names, grad_req)
        for k in arg_names:
            # an argument without a gradient buffer cannot be written
            if k not in self.grad_dict:
                self.grad_req[k] = "null"
        self._grad_names = [k for k in arg_names
                            if self.grad_req[k] != "null"]
        # the graph passes run once, at bind; they never rename or drop
        # a variable, so the argument names stay as bound
        self._exec_symbol = apply_graph_passes(symbol)
        self._graph_fn = _build_graph_fn(self._exec_symbol, device)
        # AMP loss scaling is decided at bind; the scaler's state moves
        # to this bind's device once, here
        self._amp_scale = _amp.scaling_active()
        if self._amp_scale:
            _amp.global_scaler().place(device)
        self._outputs = None
        self._pending = None  # (outputs with their graph, grad leaves)
        self._monitor_callback = None
        self._monitor_fn = None
        self._monitor_names = None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def symbol(self) -> Symbol:
        return self._symbol

    @property
    def arg_arrays(self):
        return list(self.arg_dict.values())

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(k) for k in self.arg_dict]

    @property
    def aux_arrays(self):
        return [self.aux_dict[k]
                for k in self._symbol.list_auxiliary_states()]

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
        """Run the graph; ``kwargs`` set arguments first.  In training
        the arguments with a gradient are autograd leaves and the aux
        states are written back."""
        for k, v in kwargs.items():
            dst = self.arg_dict.get(k)
            if dst is None:
                raise MXNetError(f"unknown input {k}")
            dst.copy_(_value(v, dst))
        # a forward drops the graph of one without its backward first
        self._pending = None
        if not is_train:
            with torch.no_grad():
                outs, _ = self._graph_fn(self.arg_dict, self.aux_dict, None,
                                         False)
            self._outputs = outs
            self._run_monitor()
            return outs
        args = dict(self.arg_dict)
        leaves = {k: args[k].detach().requires_grad_(True)
                  for k in self._grad_names}
        args.update(leaves)
        with torch.enable_grad():
            outs, new_aux = self._graph_fn(args, self.aux_dict,
                                           _random.generator(self._device),
                                           True)
        with torch.no_grad():
            for k, v in new_aux.items():
                dst = self.aux_dict[k]
                if v is not dst:
                    dst.copy_(v)
        self._pending = (outs, leaves)
        self._outputs = [o.detach() for o in outs]
        return self._outputs

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("no forward has been run")
        return self._outputs

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def backward(self, out_grads=None):
        """Differentiate the last training forward into ``grad_dict``.
        ``out_grads`` (one value or a list, one per output) seeds the
        outputs; none seeds ones, which the loss ops ignore."""
        if self._pending is None:
            raise MXNetError("backward() requires forward(is_train=True) "
                             "first")
        outs, leaves = self._pending
        self._pending = None
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            if len(out_grads) != len(outs):
                raise MXNetError(f"backward: {len(out_grads)} head "
                                 f"gradients for {len(outs)} outputs")
            heads = [_value(g, o) for g, o in zip(out_grads, outs)]
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs and names:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[k] for k in names],
                grad_outputs=[h for _, h in pairs], allow_unused=True)
        if self._amp_scale:
            # the loss scale multiplies each gradient here, not the head:
            # the loss ops discard the head gradient
            scale = _amp.global_scaler().scale_raw()
            grads = [None if g is None else g * scale.to(g.dtype)
                     for g in grads]
        with torch.no_grad():
            for k, g in zip(names, grads):
                buf = self.grad_dict[k]
                if self.grad_req[k] == "add":
                    if g is not None:
                        buf.add_(g)
                elif g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
        self._run_monitor()

    def set_monitor_callback(self, callback):
        """Tap every internal output: ``callback(name, NDArray)`` after
        each inference forward and each backward (parity: GraphExecutor::
        SetMonitorCallback, graph_executor.cc:63)."""
        self._monitor_callback = callback

    def _run_monitor(self):
        cb = self._monitor_callback
        if cb is None or not getattr(getattr(cb, "__self__", None),
                                     "activated", True):
            return
        if self._monitor_fn is None:
            internals = self._symbol.get_internals()
            self._monitor_fn = _build_graph_fn(internals, self._device)
            self._monitor_names = internals.list_outputs()
        with torch.no_grad():
            outs, _ = self._monitor_fn(self.arg_dict, self.aux_dict, None,
                                       False)
        for name, val in zip(self._monitor_names, outs):
            cb(name, NDArray(val))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new input shapes: arrays whose shape is
        unchanged share storage with this executor's (as MXNet's
        reshape), the others are new zeros."""
        shapes = {k: tuple(v.shape) for k, v in self.arg_dict.items()}
        shapes.update({k: tuple(v) for k, v in kwargs.items()})
        types = {k: v.dtype for k, v in self.arg_dict.items()}
        types.update({k: v.dtype for k, v in self.aux_dict.items()})
        new = simple_bind(self._symbol, self._device, grad_req=self.grad_req,
                          type_dict=types, **shapes)
        for mine, theirs in ((self.arg_dict, new.arg_dict),
                             (self.aux_dict, new.aux_dict),
                             (self.grad_dict, new.grad_dict)):
            for k, t in list(theirs.items()):
                if k in mine and mine[k].shape == t.shape:
                    theirs[k] = mine[k]
        return new


def _value(v, like: torch.Tensor) -> torch.Tensor:
    """An input as a tensor on ``like``'s device in ``like``'s dtype: a
    tensor or a port NDArray without a host round trip, anything else
    (numpy, lists, JAX arrays) through ``convert._to_tensor``."""
    if isinstance(v, NDArray):
        v = v.tensor
    if not isinstance(v, torch.Tensor):
        return _to_tensor(v, like.dtype, like.device)
    return v.to(device=like.device, dtype=like.dtype)


def _dtypes(symbol, type_dict):
    dtypes = {}
    for node in symbol.nodes:
        if node.is_variable and "__dtype__" in node.extra_attrs:
            dtypes[node.name] = numeric_dtype(node.extra_attrs["__dtype__"])
    dtypes.update({k: numeric_dtype(v) for k, v in (type_dict or {}).items()})
    return dtypes


def simple_bind(symbol: Symbol, device=None, grad_req="write",
                type_dict=None, group2ctx=None, shared_exec=None,
                **shapes) -> Executor:
    """Infer shapes from ``shapes``, allocate zeros for every argument
    and aux state on ``device`` (default: the card) in its dtype
    (``type_dict``, else a ``__dtype__`` attr, else float32), a gradient
    buffer like each argument whose ``grad_req`` is not ``null``, and
    bind.  4-D arrays are channels-last unless
    ``MXTPU_CONV_LAYOUT=NCHW``.  ``shared_exec`` is accepted for the
    reference's signature; there is no program to share."""
    if group2ctx:
        raise _not_ported("ctx-group placement (group2ctx)", 4)
    _refuse_row_sparse(symbol)
    device = resolve_device(device)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    if arg_shapes is None:
        raise MXNetError(f"simple_bind: cannot infer shapes from {shapes}")
    cl = channels_last_default()
    dtypes = _dtypes(symbol, type_dict)

    def alloc(name, shape):
        t = torch.zeros(shape, dtype=dtypes.get(name, torch.float32),
                        device=device)
        return t.contiguous(memory_format=torch.channels_last) \
            if cl and t.ndim == 4 else t

    arg_names = symbol.list_arguments()
    args = {n: alloc(n, s) for n, s in zip(arg_names, arg_shapes)}
    aux = {n: alloc(n, s)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    req = _req_dict(arg_names, grad_req)
    grads = {n: torch.zeros_like(args[n]) for n in arg_names
             if req[n] != "null"}
    return Executor(symbol, device, args, aux, grads, req)


def bind(symbol: Symbol, device, args, args_grad=None, grad_req="write",
         aux_states=None, group2ctx=None, shared_exec=None) -> Executor:
    """Bind ``symbol`` to the given arrays (a dict, or a list in
    ``list_arguments()`` order; tensors and NDArrays are bound as they
    are, sharing their storage; numpy data is copied to ``device``)."""
    if group2ctx:
        raise _not_ported("ctx-group placement (group2ctx)", 4)
    _refuse_row_sparse(symbol)
    device = resolve_device(device)

    def tensor(v):
        if isinstance(v, NDArray):
            return v.tensor
        if isinstance(v, torch.Tensor):
            return v
        return torch.from_numpy(np.array(v, dtype=np.float32)).to(device)

    arg_names = symbol.list_arguments()
    args = {k: tensor(v) for k, v in _as_list(arg_names, args,
                                              "args").items()}
    grads = {k: tensor(v) for k, v in _as_list(arg_names, args_grad,
                                               "args_grad").items()
             if v is not None}
    aux = {k: tensor(v) for k, v in _as_list(
        symbol.list_auxiliary_states(), aux_states, "aux_states").items()}
    return Executor(symbol, device, args, aux, grads, grad_req)
