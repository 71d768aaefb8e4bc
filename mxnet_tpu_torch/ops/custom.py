"""The ``Custom`` op (mirrors ``mxnet_tpu/ops/custom.py``; parity:
src/operator/custom-inl.h): runs the :class:`~mxnet_tpu_torch.operator.
CustomOpProp` registered as ``op_type``.

The JAX package runs the user's numpy code inside the compiled step
through ``jax.pure_callback``.  Here the op is a ``torch.autograd.
Function``: its forward copies the inputs to the host (one stream
synchronisation for all of them on the card), calls the user's
``forward`` there with ``mx.Context("cpu")`` as the current context (so
``mx.nd.array`` in user code makes host arrays), and uploads the
outputs from pinned memory; its backward does the same with the user's
``backward``.  Only what the Prop's ``declare_backward_dependency``
names is kept from the forward and copied for the backward; the other
host arrays it is handed are zeros, so a ``need_top_grad=False`` op (a
loss head) gets no head gradient.  The user writes outputs and input
gradients with ``req="write"``; the executor applies ``grad_req``
(``add`` accumulates across backwards).

A forward and a backward each synchronise with the host once when the
inputs are on the card, by nature: :func:`stats` counts those syncs,
the calls, the host seconds (download, user code, upload) and, of
those, the seconds spent waiting in the syncs for the queued work.  Shapes
and types come from ``prop.infer_shape``/``infer_type``, never from
running the op: on meta tensors (the port's shape inference) the op
answers from its Prop.  A CUDA graph cannot capture host Python, so
``FusedTrainer.step_multi`` refuses a graph with a ``Custom`` node;
under ``remat`` the recompute calls the user's forward a second time,
as ``jax.checkpoint`` does in the reference.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..base import MXNetError, frozen_attrs
from .registry import register as _register_op

__all__ = ["get_prop", "invalidate_num_outputs_cache", "stats",
           "reset_stats"]

_FRAMEWORK_ATTRS = ("op_type", "num_args", "name")
_stats_lock = threading.Lock()
_STATS = {"forward": 0, "backward": 0, "syncs": 0, "host_s": 0.0,
          "wait_s": 0.0}


def stats() -> dict:
    """Forward and backward calls, host synchronisations, host seconds
    and the seconds waiting in the syncs, of every Custom op since the
    last :func:`reset_stats`."""
    with _stats_lock:
        return dict(_STATS)


def reset_stats():
    with _stats_lock:
        _STATS.update(forward=0, backward=0, syncs=0, host_s=0.0,
                      wait_s=0.0)


def _count(kind, seconds):
    with _stats_lock:
        _STATS[kind] += 1
        _STATS["host_s"] += seconds


def get_prop(op_type, attrs=None):
    """The Prop of ``op_type`` built from the user kwargs in ``attrs``
    (not the framework's own: ``op_type``, ``num_args``, ``name`` and
    ``__*__`` attrs)."""
    from .. import operator as _op_mod

    config = {k: v for k, v in (attrs or {}).items()
              if k not in _FRAMEWORK_ATTRS and not k.startswith("__")}
    return _op_mod.get_prop(op_type, config)


_NUM_OUTPUTS_CACHE: dict = {}


def invalidate_num_outputs_cache(op_type: str):
    """Drop the cached output counts of ``op_type`` (``register`` calls
    this when a name is registered again)."""
    for key in [k for k in _NUM_OUTPUTS_CACHE if k[0] == op_type]:
        del _NUM_OUTPUTS_CACHE[key]


def _op_type(attrs):
    op_type = attrs.get("op_type")
    if not op_type:
        raise MXNetError("Custom requires op_type")
    return str(op_type)


def _num_custom_outputs(attrs):
    """The output count from the Prop, cached per ``(op_type, attrs)``:
    the graph passes ask on every walk, and a user Prop's constructor
    need not run each time."""
    key = (_op_type(attrs), frozen_attrs(attrs))
    if key not in _NUM_OUTPUTS_CACHE:
        _NUM_OUTPUTS_CACHE[key] = len(
            get_prop(key[0], attrs).list_outputs())
    return _NUM_OUTPUTS_CACHE[key]


def _arg_names(attrs):
    prop = get_prop(_op_type(attrs), attrs)
    return list(prop.list_arguments()) + list(prop.list_auxiliary_states())


def _infer_shapes(prop, in_shapes):
    """``(arg, out, aux)`` shapes; a Prop may answer ``(args, outs)``."""
    res = prop.infer_shape([None if s is None else list(s)
                            for s in in_shapes])
    args, outs, aux = res if len(res) == 3 else (res[0], res[1], [])
    return ([None if s is None else tuple(s) for s in args],
            [tuple(s) for s in outs], [tuple(s) for s in aux or []])


def _infer_params(attrs, *in_shapes):
    """The shapes of the inputs the Prop infers (a label from the data)."""
    prop = get_prop(_op_type(attrs), attrs)
    names = list(prop.list_arguments()) + list(prop.list_auxiliary_states())
    args, _, aux = _infer_shapes(prop, in_shapes)
    return {n: s for n, s in zip(names, list(args) + list(aux))
            if s is not None}


def _host_dtype(dtype: torch.dtype):
    """The numpy dtype a tensor reaches user code in (bfloat16 widens to
    float32: numpy has no bfloat16)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty(0, dtype=dtype).numpy().dtype


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(np_dtype))).dtype


def _download(tensors):
    """``tensors`` as fresh host numpy arrays: one host sync for all of
    them when any lies on the card (counted, with its wait)."""
    hosts, on_card = [], None
    for t in tensors:
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.is_cuda:
            on_card = t.device
            hosts.append(t.to("cpu", non_blocking=True))
        else:
            hosts.append(t.clone())
    if on_card is not None:
        t0 = time.perf_counter()
        torch.cuda.current_stream(on_card).synchronize()
        with _stats_lock:
            _STATS["syncs"] += 1
            _STATS["wait_s"] += time.perf_counter() - t0
    return [h.numpy() for h in hosts]


def _upload(arrays, device, dtypes):
    """Host arrays as tensors on ``device`` in ``dtypes`` (from pinned
    memory, queued without a wait, to the card)."""
    out = []
    for a, dt in zip(arrays, dtypes):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t.to(dt))
    return out


class _Spec:
    """One call of a Custom op: the Prop and what the forward fixed."""

    def __init__(self, prop, n_args, in_shapes, in_dtypes, out_shapes,
                 out_dtypes, is_train, device):
        self.prop = prop
        self.n_args = n_args
        self.in_shapes = in_shapes
        self.in_dtypes = in_dtypes
        self.out_shapes = out_shapes
        self.out_dtypes = out_dtypes
        self.is_train = is_train
        self.device = device
        n_out = len(out_shapes)
        deps = prop.declare_backward_dependency(
            list(range(n_out)), list(range(n_out, n_out + n_args)),
            list(range(n_out + n_args, 2 * n_out + n_args)))
        self.deps = frozenset(int(d) for d in deps)


def _host_call(kind, fn):
    """Run ``fn`` (the host half of a forward or backward) with the
    host as the current context, counting the call and its seconds."""
    from ..context import Context

    t0 = time.perf_counter()
    with Context("cpu"):
        result = fn()
    _count(kind, time.perf_counter() - t0)
    return result


class _CustomFn(torch.autograd.Function):
    """The user's forward and backward as one autograd node."""

    @staticmethod
    def forward(fctx, spec, *inputs):
        from ..operator import _HostArray

        n_args, n_out = spec.n_args, len(spec.out_shapes)

        def run():
            arrs = _download(inputs)
            op = spec.prop.create_operator(
                None, spec.in_shapes[:n_args],
                [a.dtype for a in arrs[:n_args]])
            outs = [_HostArray(np.zeros(s, _host_dtype(dt)))
                    for s, dt in zip(spec.out_shapes, spec.out_dtypes)]
            op.forward(is_train=spec.is_train, req=["write"] * n_out,
                       in_data=[_HostArray(a) for a in arrs[:n_args]],
                       out_data=outs,
                       aux=[_HostArray(a) for a in arrs[n_args:]])
            return _upload([o._npvalue for o in outs], spec.device,
                           spec.out_dtypes)

        outs = _host_call("forward", run)
        # keep only what the backward declared it reads
        keep_in = [j for j in range(n_args) if n_out + j in spec.deps]
        keep_out = [k for k in range(n_out)
                    if n_out + n_args + k in spec.deps]
        fctx.spec, fctx.keep_in, fctx.keep_out = spec, keep_in, keep_out
        fctx.save_for_backward(*[inputs[j] for j in keep_in],
                               *[outs[k] for k in keep_out],
                               *inputs[n_args:])
        return tuple(outs)

    @staticmethod
    def backward(fctx, *grads):
        from ..operator import _HostArray

        spec = fctx.spec
        n_args, n_out = spec.n_args, len(spec.out_shapes)
        saved = fctx.saved_tensors
        n_in, n_o = len(fctx.keep_in), len(fctx.keep_out)
        keep_og = [i for i in range(n_out) if i in spec.deps]
        og = [grads[i] if grads[i] is not None
              else torch.zeros(spec.out_shapes[i], dtype=spec.out_dtypes[i],
                               device=spec.device) for i in keep_og]
        need = [j for j in range(n_args) if fctx.needs_input_grad[1 + j]]

        def run():
            arrs = _download(list(og) + list(saved))

            def full(kept, have, shapes, dtypes):
                got = dict(zip(kept, have))
                return [_HostArray(got[i] if i in got else
                                   np.zeros(shapes[i], _host_dtype(dtypes[i])))
                        for i in range(len(shapes))]

            ogs = full(keep_og, arrs[:len(og)], spec.out_shapes,
                       spec.out_dtypes)
            rest = arrs[len(og):]
            ins = full(fctx.keep_in, rest[:n_in], spec.in_shapes[:n_args],
                       spec.in_dtypes[:n_args])
            outs = full(fctx.keep_out, rest[n_in:n_in + n_o],
                        spec.out_shapes, spec.out_dtypes)
            auxs = [_HostArray(a) for a in rest[n_in + n_o:]]
            op = spec.prop.create_operator(
                None, spec.in_shapes[:n_args], [a.dtype for a in ins])
            igs = [_HostArray(np.zeros(s, _host_dtype(dt)))
                   for s, dt in zip(spec.in_shapes[:n_args],
                                    spec.in_dtypes[:n_args])]
            op.backward(req=["write"] * n_args, out_grad=ogs, in_data=ins,
                        out_data=outs, in_grad=igs, aux=auxs)
            ups = _upload([igs[j]._npvalue for j in need], spec.device,
                          [spec.in_dtypes[j] for j in need])
            return dict(zip(need, ups))

        in_grads = _host_call("backward", run)
        n_aux = len(spec.in_shapes) - n_args
        return (None,) + tuple(in_grads.get(j) for j in range(n_args)) \
            + (None,) * n_aux


@_register_op("Custom", varargs=True, num_outputs_fn=_num_custom_outputs,
              arg_names_fn=_arg_names, infer_params=_infer_params)
def _custom(ctx, *inputs, **attrs):
    """Runs the registered CustomOpProp/CustomOp of ``op_type`` on the
    host (parity: Custom, src/operator/custom-inl.h)."""
    op_type = _op_type(attrs)
    prop = get_prop(op_type, attrs)
    n_args = len(prop.list_arguments())
    n_aux = len(prop.list_auxiliary_states())
    if len(inputs) != n_args + n_aux:
        raise MXNetError(
            f"Custom({op_type}) expects {n_args} args + {n_aux} aux states, "
            f"got {len(inputs)} inputs")
    in_shapes = [tuple(x.shape) for x in inputs]
    _, out_shapes, _ = _infer_shapes(prop, in_shapes[:n_args])
    _, out_types, _ = prop.infer_type(
        [_host_dtype(x.dtype).type for x in inputs[:n_args]])
    out_dtypes = [_torch_dtype(t) for t in out_types]
    device = inputs[0].device if inputs else ctx.device
    if device is not None and torch.device(device).type == "meta":
        # shape inference: the Prop answers, the user's code never runs
        outs = tuple(torch.empty(s, dtype=dt, device="meta")
                     for s, dt in zip(out_shapes, out_dtypes))
        return outs[0] if len(outs) == 1 else outs
    spec = _Spec(prop, n_args, in_shapes, [x.dtype for x in inputs],
                 out_shapes, out_dtypes, bool(ctx.is_train),
                 torch.device(device))
    outs = _CustomFn.apply(spec, *inputs)
    return outs[0] if len(outs) == 1 else outs
