"""Imperative NDArray of the port (mirrors ``mxnet_tpu/ndarray.py``).

An :class:`NDArray` holds a torch tensor.  The JAX package fakes
in-place writes over immutable buffers with a versioned ``_Chunk`` and
``(chunk, index, shape)`` views; torch tensors are mutable, so here a
view is a real torch view and a write is an in-place ``copy_`` into the
array's own storage.  Axis-0 slices (``x[1]``, ``x[1:3]``,
``x.slice(1, 3)``) and ``reshape`` share memory with their source and
write through to it, as in the reference's ``NDArray::Slice``/
``Reshape``; any other indexing, ``T``, ``astype`` and ``copy`` make
new arrays.

Every registered op is generated as a module function ``nd.<op>`` (and
its lowercase alias, unless that names another op) dispatching through
:func:`mxnet_tpu_torch.ops.registry.invoke`; PyTorch's asynchronous
launches take the place of the engine, and :meth:`NDArray.asnumpy` is
the sync point.  The creators (``array``, ``zeros``, ...) default to
the card (:func:`~mxnet_tpu_torch.context.current_context`, or the
innermost ``with mx.Context(...)`` scope) and raise without one; pass
``ctx="cpu"`` (or ``mx.cpu()``) for the host.  On ``mx.cpu_pinned()``
(given or scoped) they, ``copyto`` and ``as_in_context`` place the
array in pinned host memory from the ``storage`` pool.

``save``/``load`` read and write the JAX package's npz layout key for
key — a row-sparse array (:mod:`mxnet_tpu_torch.sparse`, also reachable
as ``nd.sparse``) as its ``ri:``/``rv:``/``rs:`` (indices, values,
shape) triple — and ``load`` also reads the reference's ``.params``
binary (magic ``0x112``, :mod:`mxnet_tpu_torch.interop`).  Not ported
yet, each raising "not ported yet": remote URIs in save/load,
``imdecode``, and bfloat16 in files (below).

bfloat16: numpy has no bfloat16 type, so the JAX package's ``nd.save``
writes a bfloat16 array as untyped 2-byte records (``|V2``) that its own
``nd.load`` refuses.  The port's ``save`` refuses bfloat16 by name
(cast to float32 first) and its ``load`` names a ``|V2`` entry;
``asnumpy`` of a bfloat16 array returns its values widened to float32.
"""
from __future__ import annotations

import io
import os
import re
import sys

import numpy as np
import torch

from . import engine as _engine
from . import ops
from . import storage as _storage
from .base import MXNetError, numeric_dtype
from .context import Context, current_context, is_pinned, resolve_device

# generated op functions (``slice``, ``crop``) shadow builtins in this
# module's namespace: keep the builtin
_py_slice = slice

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "onehot_encode", "waitall", "save", "load",
           "load_frombuffer"]

_NUMPY_TYPES = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.float16: np.float16, torch.int64: np.int64, torch.int32: np.int32,
    torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_,
}
# what a numpy array becomes on upload: the JAX package runs without x64,
# so its NDArrays hold float64 / int64 data as float32 / int32
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _device(ctx=None) -> torch.device:
    """``ctx`` (``None``: the card) as a ``torch.device`` with its index."""
    if ctx is None:
        return current_context()
    dev = resolve_device(ctx)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _placed(t: torch.Tensor, ctx=None) -> torch.Tensor:
    """``t`` (on the host when ``ctx`` is pinned) in pinned host memory
    when ``ctx`` (None: the ``with`` scope's) is ``cpu_pinned``."""
    if not is_pinned(ctx) or t.is_pinned():
        return t
    out = _storage.pinned_empty(t.shape, t.dtype)
    out.copy_(t)
    return out


def _from_numpy(a, device) -> torch.Tensor:
    """A new tensor on ``device`` holding a copy of host array ``a``."""
    a = np.asarray(a)
    if a.dtype.kind == "V":
        raise MXNetError(f"untyped {a.dtype.str} data cannot become an "
                         "NDArray (the JAX package's nd.save writes "
                         "bfloat16 so)")
    dt = _CANONICAL.get(a.dtype, a.dtype)
    owned = (a.dtype != dt or not a.flags.c_contiguous
             or not a.flags.writeable)
    if owned:
        a = np.array(a, dtype=dt, order="C")
    t = torch.from_numpy(a)
    if device.type == "cpu":
        return t if owned else t.clone()
    return t.to(device)


# tensors a host engine task will write (a dist kvstore's lazy pull):
# id(tensor) -> (weakref to it, the function that lands the write).
# asnumpy and wait_to_read land it before they read (WaitToRead).
_pending_writes: dict = {}


def set_pending_write(t: torch.Tensor, resolve):
    import weakref

    _pending_writes[id(t)] = (weakref.ref(t), resolve)


def clear_pending_write(t: torch.Tensor):
    _pending_writes.pop(id(t), None)


def resolve_pending_write(t: torch.Tensor):
    """Land the pending write into ``t``, if one is registered."""
    entry = _pending_writes.get(id(t))
    if entry is not None and entry[0]() is t:
        entry[1]()


class NDArray:
    """An n-dimensional array on one device, over a torch tensor."""

    __slots__ = ("_t",)

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._t
        if isinstance(data, torch.Tensor):
            if ctx is not None:
                data = data.to(_device(ctx))
        else:
            data = _from_numpy(data, _device(ctx))
        self._t = data
        _engine.track(data)

    # ------------------------------------------------------------ reads
    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        """The numpy scalar type (``np.float32``); ``torch.bfloat16``
        for bfloat16, which numpy lacks."""
        return _NUMPY_TYPES.get(self._t.dtype, self._t.dtype)

    @property
    def size(self):
        return self._t.numel()

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def context(self) -> torch.device:
        return self._t.device

    ctx = context

    @property
    def tensor(self) -> torch.Tensor:
        """The underlying torch tensor (shares memory with the array)."""
        return self._t

    def asnumpy(self) -> np.ndarray:
        """A host copy (the sync point: waits for the writes before it)."""
        if _pending_writes:
            resolve_pending_write(self._t)
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            raise ValueError("NDArray host conversion always copies; "
                             "np.asarray with copy=False is unsatisfiable")
        a = self.asnumpy()
        return a.astype(dtype, copy=False) if dtype is not None else a

    def asscalar(self):
        a = self.asnumpy()
        if a.size != 1:
            raise MXNetError("The current array is not a scalar")
        return a.reshape(-1)[0]

    def wait_to_read(self):
        if _pending_writes:
            resolve_pending_write(self._t)
        _engine.wait_for_var(self._t)

    # ----------------------------------------------------------- writes
    def _set(self, new):
        """Write ``new`` (a tensor of this shape, or broadcastable to it)
        into this array's storage, in place, through any view."""
        if new.shape != self._t.shape and new.numel() == self._t.numel():
            new = new.reshape(self._t.shape)
        self._t.copy_(new)
        return self

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._t
        elif isinstance(value, np.generic):
            value = value.item()
        elif not isinstance(value, (torch.Tensor, bool, int, float)):
            value = torch.as_tensor(np.asarray(value), dtype=self._t.dtype,
                                    device=self._t.device)
        if isinstance(key, _py_slice) and key == _py_slice(None):
            if isinstance(value, torch.Tensor):
                self._t.copy_(value)
            else:
                self._t.fill_(value)
        else:
            self._t[key] = value

    def __getitem__(self, key):
        if isinstance(key, (int, _py_slice)):
            return NDArray(self._t[key])     # a view (NDArray::At / Slice)
        out = self._t[key]
        return NDArray(out.clone() if out._is_view() else out)

    def slice(self, start, stop):
        """Axis-0 slice sharing memory (NDArray::Slice)."""
        return self[_py_slice(start, stop)]

    def reshape(self, shape):
        """Shares memory with the source where its strides allow
        (NDArray::Reshape)."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        size = self.size
        if -1 in shape:
            known = int(np.prod([s for s in shape if s != -1]))
            # (``max`` here would be the generated op, not the builtin)
            shape = tuple(s if s != -1 else size // (known or 1)
                          for s in shape)
        if int(np.prod(shape)) != size:
            raise MXNetError(f"cannot reshape {self.shape} to {shape}")
        return NDArray(self._t.reshape(shape))

    def broadcast_to(self, shape):
        return broadcast_to(self, shape=shape)  # noqa: F821 (generated)

    def copy(self) -> "NDArray":
        return NDArray(self._t.clone(memory_format=torch.contiguous_format))

    def copyto(self, other):
        """To a device (a new array) or into an NDArray (NDArray::
        CopyFromTo)."""
        if isinstance(other, NDArray):
            return other._set(self._t)
        if is_pinned(other):
            return NDArray(_placed(self._t.cpu(), other))
        if isinstance(other, (torch.device, str, int, Context)):
            return NDArray(self._t.to(_device(other), copy=True))
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_context(self, ctx) -> "NDArray":
        if is_pinned(ctx):
            return self if self._t.is_pinned() else self.copyto(ctx)
        return self if _device(ctx) == self._t.device else self.copyto(ctx)

    def astype(self, dtype) -> "NDArray":
        return NDArray(self._t.to(numeric_dtype(dtype), copy=True))

    @property
    def T(self):
        dims = tuple(reversed(range(self.ndim)))
        return NDArray(torch.permute(self._t, dims)
                       .clone(memory_format=torch.contiguous_format))

    # ------------------------------------------------------- arithmetic
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            if a.shape == b.shape or not op.startswith("elemwise_"):
                return _invoke(op, [a, b])
            return _invoke("broadcast_" + op[len("elemwise_"):], [a, b])
        if np.isscalar(other):
            return _invoke(scalar_op, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "elemwise_sub", "_rminus_scalar",
                            reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "elemwise_div", "_rdiv_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "_power", "_power_scalar")

    def __rpow__(self, o):
        return _invoke("_rpower_scalar", [self], {"scalar": float(o)})

    def __neg__(self):
        return _invoke("negative", [self])

    def _inplace(self, out):
        return out if out is NotImplemented else self._set(out._t)

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    def _cmp(self, o, op):
        """0/1 in this array's dtype, as MXNet's comparisons give."""
        if isinstance(o, NDArray):
            return _invoke(op if self.shape == o.shape else "broadcast" + op,
                           [self, o])
        return _invoke(op + "_scalar", [self], {"scalar": float(o)})

    def __eq__(self, o):
        return self._cmp(o, "_equal")

    def __ne__(self, o):
        return self._cmp(o, "_not_equal")

    def __gt__(self, o):
        return self._cmp(o, "_greater")

    def __ge__(self, o):
        return self._cmp(o, "_greater_equal")

    def __lt__(self, o):
        return self._cmp(o, "_lesser")

    def __le__(self, o):
        return self._cmp(o, "_lesser_equal")

    def __hash__(self):
        return id(self)

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return (f"<NDArray {'x'.join(map(str, self.shape))} "
                f"@{self.context}>\n{self.asnumpy()}")

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")


# ------------------------------------------------------- the op functions
def _invoke(opname, inputs, attrs=None, out=None, is_train=True,
            device=None):
    """Run a registered op on NDArrays (tensors and numpy arrays are
    taken too; numpy goes to the first tensor's device, else the card)."""
    raw = [x._t if isinstance(x, NDArray) else x for x in inputs]
    if device is None:
        device = next((t.device for t in raw if isinstance(t, torch.Tensor)),
                      None) or current_context()
    raw = [t if isinstance(t, torch.Tensor) else _from_numpy(t, device)
           for t in raw]
    result = ops.invoke(opname, raw, attrs, is_train=is_train,
                        device=device)
    if isinstance(result, tuple):
        if out is not None:
            raise MXNetError("out= not supported for multi-output ops")
        return tuple(NDArray(r) for r in result)
    if out is not None:
        return out._set(result)
    return NDArray(result)


def _make_op_fn(opname: str):
    op = ops.get(opname)
    tensor_args = tuple(op.arg_names) + tuple(op.aux_names)

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)    # accepted for symbol parity
        ctx = kwargs.pop("ctx", None)
        inputs = list(args)
        for an in tensor_args:
            if an in kwargs and isinstance(
                    kwargs[an], (NDArray, np.ndarray, torch.Tensor)):
                inputs.append(kwargs.pop(an))
        res = _invoke(opname, inputs, kwargs, out=out,
                      device=None if ctx is None or inputs else _device(ctx))
        if ctx is not None and isinstance(res, NDArray):
            res = res.as_in_context(ctx)
        return res

    fn.__name__ = opname
    fn.__doc__ = op.doc
    return fn


def _init_op_functions():
    mod = sys.modules[__name__]
    all_ops = ops.list_ops()
    registered = set(all_ops)
    for opname in all_ops:
        if not hasattr(mod, opname):
            setattr(mod, opname, _make_op_fn(opname))
    # lowercase aliases, as the reference's codegen makes them; an alias
    # never shadows a registered op (layer ``Crop`` vs tensor ``crop``)
    for opname in all_ops:
        low = opname.lower()
        if low != opname and low not in registered and not hasattr(mod, low):
            setattr(mod, low, _make_op_fn(opname))


# ------------------------------------------------------------ creators
def array(source, ctx=None, dtype=None) -> NDArray:
    """A new array holding ``source`` (array-like, NDArray or tensor) in
    ``dtype`` — float32 by default, even from integer data."""
    tdt = numeric_dtype(np.float32 if dtype is None else dtype)
    dev = _device(ctx)
    if isinstance(source, NDArray):
        source = source._t
    if isinstance(source, torch.Tensor):
        return NDArray(_placed(source.detach().to(dev, tdt, copy=True), ctx))
    npdt = _NUMPY_TYPES.get(tdt, np.float32)   # bfloat16 via float32
    return NDArray(_placed(
        _from_numpy(np.asarray(source, dtype=npdt), dev).to(tdt), ctx))


def zeros(shape, ctx=None, dtype=np.float32) -> NDArray:
    return NDArray(_placed(torch.zeros(shape, dtype=numeric_dtype(dtype),
                                       device=_device(ctx)), ctx))


def ones(shape, ctx=None, dtype=np.float32) -> NDArray:
    return NDArray(_placed(torch.ones(shape, dtype=numeric_dtype(dtype),
                                      device=_device(ctx)), ctx))


def full(shape, val, ctx=None, dtype=np.float32) -> NDArray:
    return NDArray(_placed(torch.full(
        shape if not isinstance(shape, int) else (shape,), val,
        dtype=numeric_dtype(dtype), device=_device(ctx)), ctx))


def empty(shape, ctx=None, dtype=np.float32) -> NDArray:
    """Zeros, as in the JAX package (it has no uninitialised memory)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=np.float32) -> NDArray:
    attrs = {"start": start, "stop": stop, "step": step, "repeat": repeat,
             "dtype": np.dtype(dtype).name}
    return _invoke("_arange", [], attrs, device=_device(ctx))


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return NDArray(torch.cat([a._t for a in arrays], dim=axis))


def onehot_encode(indices, out):
    """Write the one-hot rows of ``indices`` into ``out`` (its width is
    the depth)."""
    return _invoke("one_hot", [indices], {"depth": out.shape[1]}, out=out)


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0, channels=3,
             mean=None, ctx=None):
    """Parity: mx.nd.imdecode (src/io/image_io.cc ``_imdecode``): the
    image's (H, W, C) float32 pixels on ``ctx`` (default: the card)."""
    from .image import imdecode as _imdecode

    return _imdecode(str_img, channels=channels, ctx=ctx)


def waitall():
    """Wait for every launch on the card (a ``torch.cuda.synchronize``)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# ---------------------------------------------------------- save / load
def _local_path(fname: str) -> str:
    """``fname`` without a ``file://`` scheme; other schemes raise."""
    fname = str(fname)
    if "://" in fname:
        scheme, rest = fname.split("://", 1)
        if scheme != "file":
            raise MXNetError(f"{scheme}:// URIs in nd.save/nd.load are not "
                             "ported yet (filesystem.py, ROADMAP Queue 1 "
                             "item 11)")
        return rest
    return fname


def _entries(key, v) -> dict:
    """The npz entries of one value: itself, or a row-sparse array's
    ``(indices, values, shape)`` triple (densifying would lose the
    storage type and write a table-sized blob for a few rows)."""
    if getattr(v, "stype", "default") == "row_sparse":
        return {f"ri:{key}": _host_array(key, v.indices),
                f"rv:{key}": _host_array(key, v.data),
                f"rs:{key}": np.asarray(v.shape, np.int64)}
    return {key: _host_array(key, v)}


def _host_array(key, v) -> np.ndarray:
    if isinstance(v, NDArray):
        v = v._t
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise MXNetError(
                f"nd.save: {key} is bfloat16, which an npz file cannot type "
                "(the JAX package writes it as untyped |V2 records it cannot "
                "load back); cast it to float32 first")
        return v.detach().to("cpu", copy=True).numpy()
    if hasattr(v, "asnumpy"):   # the JAX package's NDArrays
        v = v.asnumpy()
    a = np.asarray(v)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        raise MXNetError(f"nd.save: {key} is bfloat16 or untyped "
                         f"({a.dtype}); cast it to float32 first")
    return a


def save(fname: str, data):
    """Write an NDArray, a list or a dict of them in the JAX package's
    layout: an npz archive with keys ``l:%08d`` (list) or ``d:<name>``
    (dict), at exactly ``fname`` (numpy's ``.npz`` suffix is undone)."""
    path = _local_path(fname)
    if isinstance(data, (NDArray, torch.Tensor)):
        data = [data]
    payload = {}
    if isinstance(data, dict):
        for k, v in data.items():
            payload.update(_entries(f"d:{k}", v))
    elif isinstance(data, (list, tuple)):
        for i, v in enumerate(data):
            payload.update(_entries(f"l:{i:08d}", v))
    else:
        raise TypeError("save expects NDArray, list or dict")
    np.savez(path, **payload)
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        os.replace(path + ".npz", path)


_LIST_KEY = re.compile(r"^(r[ivs]:)?l:\d{8}$")


def load_frombuffer(blob: bytes, ctx=None):
    """What :func:`load` returns for a file holding ``blob``."""
    dev = _device(ctx)
    if len(blob) >= 8 and int.from_bytes(blob[:8], "little") == 0x112:
        from .interop import load_params_raw

        return load_params_raw(blob, dev)
    with np.load(io.BytesIO(blob), allow_pickle=False) as f:
        keys = list(f.keys())

        def arr(k):
            a = f[k]
            if a.dtype.kind == "V":
                raise MXNetError(
                    f"nd.load: {k} holds untyped {a.dtype.str} records (how "
                    "the JAX package's nd.save writes bfloat16): not loadable")
            return _from_numpy(a, dev)

        def build(inner):
            out = {}
            for k in inner:
                if k.startswith(("ri:", "rv:", "rs:")):
                    name = k[3:]
                    if name not in out:
                        from .sparse import RowSparseNDArray

                        out[name] = RowSparseNDArray(
                            arr(f"ri:{name}"), arr(f"rv:{name}"),
                            tuple(int(s) for s in f[f"rs:{name}"]))
                else:
                    out[k] = NDArray(arr(k))
            return out

        # a list is exactly l:%08d keys (and their row-sparse triples); a
        # dict key that starts with "l:" is saved as "d:l:..."
        if all(_LIST_KEY.match(k) for k in keys):
            items = build(keys)
            return [items[k] for k in sorted(items)]
        items = build([k for k in keys if k.startswith(
            ("d:", "ri:d:", "rv:d:", "rs:d:"))])
        return {k[2:]: v for k, v in items.items()}


def load(fname: str, ctx=None):
    """Read a file that :func:`save` (of either package) or the
    reference's ``NDArray::Save`` wrote: a list or a dict of NDArrays on
    ``ctx`` (default: the card)."""
    dev = _device(ctx)
    with open(_local_path(fname), "rb") as fh:
        return load_frombuffer(fh.read(), dev)


_init_op_functions()
