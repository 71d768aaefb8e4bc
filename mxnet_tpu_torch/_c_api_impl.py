"""What the port's C ABIs call (mirrors ``mxnet_tpu/_c_api_impl.py``).

The general C API (``csrc/c_api.cc``, the surface of ``src/mxtpu_capi.h``:
NDArray lifecycle and sync copies, symbol creators, compose, JSON,
lists and shape inference, executor bind/forward/backward, kvstore
init/push/pull/updater, ``MXImperativeInvoke``, data iterators) and the
predict ABI (``csrc/c_predict.cc``, the ``MXPred*`` half of
``src/mxtpu.h``) embed CPython and call these functions; the math runs
in the port on the card.  A handle on the C side is a ``PyObject*``
owned through its reference count.  Errors are exceptions; the C layer
turns them into -1 and the thread's ``MXGetLastError`` /
``MXPredGetLastError`` text.

``dev_type`` is MXNet's own (``c_predict_api.h``): 1 is the CPU, 2 the
card ``cuda:<dev_id>``.  Without a card, 2 raises (it never runs on the
CPU instead), and any other value is refused by name.  (The JAX layer
maps 2 to its accelerator and every other value to the CPU.)

Copies across the ABI are synchronous, as MXNet's: a borrowed C buffer
is copied before ``MXNDArraySyncCopyFromCPU``/``MXPredSetInput`` return
(the caller may free it at once), and ``MXNDArraySyncCopyToCPU``/
``MXPredGetOutput`` wait for the card.
"""
from __future__ import annotations

import ast
import copy

import numpy as np
import torch

from . import ndarray as nd
from . import symbol as _symbol_mod
from .base import MXNetError
from .ndarray import NDArray


def _device(dev_type, dev_id):
    """MXNet's ``dev_type``/``dev_id`` as a ``torch.device``."""
    dev_type, dev_id = int(dev_type), int(dev_id)
    if dev_type == 1:
        return torch.device("cpu")
    if dev_type == 2:
        if not torch.cuda.is_available():
            raise MXNetError("dev_type 2 asks for the card, but no CUDA "
                             "device is available (dev_type 1 is the CPU)")
        if not 0 <= dev_id < torch.cuda.device_count():
            raise MXNetError(f"dev_id {dev_id}: this host has "
                             f"{torch.cuda.device_count()} CUDA devices")
        return torch.device("cuda", dev_id)
    raise MXNetError(f"unknown dev_type {dev_type} (1: the CPU, 2: the "
                     "card)")


def _as_ndarray(t):
    """A tensor (an executor's bound array or output) as an NDArray over
    the same storage."""
    return t if isinstance(t, NDArray) else NDArray(t.detach())


# ------------------------------------------------------------------ NDArray
def ndarray_create(shape, dev_type, dev_id):
    return nd.zeros(tuple(int(s) for s in shape),
                    ctx=_device(dev_type, dev_id))


def ndarray_shape(arr):
    return [int(s) for s in arr.shape]


def ndarray_sync_copy_from(arr, buf):
    """``buf``: a C float32 buffer of exactly ``arr.size`` items, borrowed
    for the call.  It is copied into host memory the port owns before
    the upload, and the upload finishes before this returns."""
    src = np.frombuffer(buf, dtype=np.float32, count=arr.size).copy()
    t = arr.tensor
    t.copy_(torch.from_numpy(src).reshape(t.shape))
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def ndarray_sync_copy_to(arr):
    """``arr`` as float32 bytes, after the card has computed it."""
    t = _as_ndarray(arr).tensor.detach()
    return np.ascontiguousarray(t.float().cpu().numpy()).tobytes()


def ndarray_wait_all():
    from . import engine

    engine.wait_for_all()
    engine.wait_for_all_host()


# ------------------------------------------------------------------- Symbol
class _AtomicSymbol:
    """``MXSymbolCreateAtomicSymbol``'s result: an op and its attrs
    awaiting ``MXSymbolCompose`` (parity: c_api.cc CreateAtomicSymbol ->
    Symbol::Compose)."""

    def __init__(self, op, attrs):
        self.op = op
        self.attrs = attrs
        self.symbol = None  # set by compose


def symbol_list_atomic_creators():
    from .ops import registry

    return sorted(registry.list_ops())


def symbol_create_atomic(op_name, keys, vals):
    if not hasattr(_symbol_mod, op_name):
        raise MXNetError(f"unknown operator {op_name!r}")
    return _AtomicSymbol(op_name, dict(zip(keys, vals)))


def symbol_create_variable(name):
    return _symbol_mod.Variable(name)


def symbol_compose(handle, name, keys, args):
    """Fill an atomic symbol's inputs (no keys: positional)."""
    if not isinstance(handle, _AtomicSymbol):
        raise MXNetError("Compose target must be an atomic symbol")
    fn = getattr(_symbol_mod, handle.op)
    kwargs = dict(handle.attrs)
    if name:
        kwargs["name"] = name
    inputs = [_sym(a) for a in args]
    if keys:
        kwargs.update(zip(keys, inputs))
        handle.symbol = fn(**kwargs)
    else:
        handle.symbol = fn(*inputs, **kwargs)
    return handle


def _sym(handle):
    if isinstance(handle, _AtomicSymbol):
        if handle.symbol is None:
            raise MXNetError(f"atomic symbol {handle.op!r} is not composed "
                             "yet")
        return handle.symbol
    return handle


def symbol_from_json(json_str):
    return _symbol_mod.load_json(json_str)


def symbol_to_json(handle):
    return _sym(handle).tojson()


def symbol_list_arguments(handle):
    return _sym(handle).list_arguments()


def symbol_list_outputs(handle):
    return _sym(handle).list_outputs()


def symbol_list_auxiliary_states(handle):
    return _sym(handle).list_auxiliary_states()


def symbol_infer_shape(handle, keys, shapes):
    arg_shapes, out_shapes, aux_shapes = _sym(handle).infer_shape(
        **{k: tuple(v) for k, v in zip(keys, shapes)})
    if arg_shapes is None:
        raise MXNetError(f"cannot infer shapes from {dict(zip(keys, shapes))}")

    def to_list(shs):
        return [[int(d) for d in sh] for sh in shs]

    return to_list(arg_shapes), to_list(out_shapes), to_list(aux_shapes)


# ----------------------------------------------------------------- Executor
def executor_simple_bind(handle, dev_type, dev_id, grad_req, keys, shapes):
    from .executor import simple_bind

    return simple_bind(_sym(handle), _device(dev_type, dev_id),
                       grad_req=grad_req,
                       **{k: tuple(v) for k, v in zip(keys, shapes)})


def executor_forward(ex, is_train):
    ex.forward(is_train=bool(is_train))


def executor_backward(ex):
    ex.backward()


def executor_num_outputs(ex):
    return len(ex.outputs)


def executor_output(ex, index):
    return _as_ndarray(ex.outputs[int(index)])


def executor_arg_array(ex, name):
    """The bound argument ``name`` as an NDArray over the executor's own
    tensor: writes through it (a sync copy, an in-place update op) feed
    the next forward."""
    try:
        return _as_ndarray(ex.arg_dict[name])
    except KeyError:
        raise MXNetError(f"no argument named {name!r}") from None


def executor_grad_array(ex, name):
    g = ex.grad_dict.get(name)
    if g is None:
        raise MXNetError(f"no gradient for {name!r} (grad_req null?)")
    return _as_ndarray(g)


def executor_arg_names(ex):
    return list(ex.arg_dict.keys())


# ------------------------------------------------------------------ KVStore
def kvstore_create(kv_type):
    from . import kvstore

    return kvstore.create(kv_type.decode() if isinstance(kv_type, bytes)
                          else kv_type)


def kvstore_init(kv, keys, vals):
    kv.init(list(keys), list(vals))


def kvstore_push(kv, keys, vals, priority):
    kv.push(list(keys), list(vals), priority=int(priority))


def kvstore_pull(kv, keys, outs, priority):
    kv.pull(list(keys), out=list(outs), priority=int(priority))


def kvstore_set_updater(kv, py_callback):
    """``py_callback(key, recv, local)``: the C layer wraps the user's C
    function pointer in a Python callable."""
    kv._set_updater(py_callback)


def kvstore_rank(kv):
    return int(kv.rank)


def kvstore_num_workers(kv):
    return int(kv.num_workers)


# --------------------------------------------------------------------- misc
def random_seed(seed):
    from . import random as _random

    _random.seed(int(seed))


# ------------------------------------------------------------ imperative
def imperative_invoke(op_name, inputs, keys, vals):
    """``MXImperativeInvoke``: a registered op on NDArray handles; the
    list of its outputs.  An update op (``sgd_update``...) writes its
    weight in place, as MXNet's does with ``out=weight``."""
    from . import ops as _ops

    # only registered ops: a bare getattr would reach every attribute
    # of the module
    if op_name not in _ops.list_ops():
        raise ValueError(f"unknown imperative op {op_name!r}")
    fn = getattr(nd, op_name, None)
    if fn is None:
        raise ValueError(f"op {op_name!r} has no imperative binding")
    out = fn(*inputs, **dict(zip(keys, vals)))
    return list(out) if isinstance(out, (list, tuple)) else [out]


# -------------------------------------------------------------- data iter
class _IterState:
    __slots__ = ("it", "batch")

    def __init__(self, it):
        self.it = it
        self.batch = None


def _parse_iter_val(v):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _iter_registry():
    from . import io as mio

    return {"MNISTIter": mio.MNISTIter, "CSVIter": mio.CSVIter,
            "ImageRecordIter": mio.ImageRecordIter}


def list_data_iters():
    return sorted(_iter_registry())


def data_iter_create(name, keys, vals):
    reg = _iter_registry()
    if name not in reg:
        raise ValueError(f"unknown iterator {name!r}; have {sorted(reg)}")
    kwargs = {k: _parse_iter_val(v) for k, v in zip(keys, vals)}
    return _IterState(reg[name](**kwargs))


def data_iter_next(state):
    try:
        state.batch = state.it.next()
        return 1
    except StopIteration:
        state.batch = None
        return 0


def data_iter_before_first(state):
    state.it.reset()
    state.batch = None


def _batch_part(state, part):
    if state.batch is None:
        raise ValueError("no current batch; call MXDataIterNext first")
    arrs = getattr(state.batch, part)
    if not arrs:
        raise ValueError(f"batch has no {part}")
    return arrs[0]


def data_iter_data(state):
    return _batch_part(state, "data")


def data_iter_label(state):
    return _batch_part(state, "label")


def data_iter_pad(state):
    if state.batch is None:
        raise ValueError("no current batch; call MXDataIterNext first")
    return int(state.batch.pad or 0)


# ---------------------------------------------------------- predict ABI
def pred_create(symbol_json, param_bytes, keys, shapes, dev_type, dev_id):
    """``MXPredCreate``: a Predictor over the symbol's JSON and the bytes
    of a ``.params`` file (``nd.save``'s, either package's)."""
    from .predict import Predictor

    return Predictor(symbol_json_str=symbol_json, param_bytes=param_bytes,
                     input_shapes={k: tuple(int(d) for d in s)
                                   for k, s in zip(keys, shapes)},
                     dev_type=_device(dev_type, dev_id))


def pred_set_input(p, key, buf):
    """``MXPredSetInput``: ``buf`` (a borrowed C float32 buffer) as input
    ``key`` of its bound shape.  ``Predictor.set_input`` copies it into
    the pinned staging buffer (to the card) or the bound tensor (on the
    CPU) before it returns, so the caller may reuse ``buf`` at once."""
    if key not in p._input_names:
        raise MXNetError(f"unknown input {key}; inputs: {p._input_names}")
    shape = tuple(p._params[key].shape)
    arr = np.frombuffer(buf, dtype=np.float32)
    if arr.size != int(np.prod(shape)):
        raise MXNetError(f"input {key}: {arr.size} values for the bound "
                         f"shape {shape}")
    p.set_input(key, arr.reshape(shape))


def pred_forward(p):
    p.forward()


def pred_forward_async(p):
    return int(p.forward_async())


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def pred_get_async(p, ticket, index):
    return _f32(p.get_async(int(ticket), int(index)))


def pred_get_output_shape(p, index):
    return tuple(int(d) for d in p.get_output_shape(int(index)))


def pred_get_output(p, index):
    """Output ``index`` as a contiguous float32 host array (waits for
    the card)."""
    return _f32(p.get_output(int(index)))


def pred_reshape(p, keys, shapes):
    """``MXPredReshape``: a new Predictor bound to the new input shapes
    over the same weights; ``p`` stays as it was."""
    new = copy.copy(p)
    new.reshape({k: tuple(int(d) for d in s) for k, s in zip(keys, shapes)})
    return new
