"""Custom operators written in Python (mirrors ``mxnet_tpu/operator.py``;
parity: python/mxnet/operator.py CustomOp, CustomOpProp, register and
the legacy PythonOp/NumpyOp, and src/operator/custom-inl.h).

A user subclasses :class:`CustomOpProp` (arguments, outputs, shape and
type inference, the operator factory) and :class:`CustomOp` (forward
and backward on host arrays), registers the Prop with
:func:`register`, and calls it as ``mx.sym.Custom(..., op_type=name)``
or ``mx.nd.Custom``.  The op itself is :mod:`.ops.custom`: the JAX
package runs the user's code through ``jax.pure_callback``; the port
copies the inputs to the host, runs it there and uploads the results,
inside a ``torch.autograd.Function`` whose backward runs the user's
backward the same way.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop", "PythonOp",
           "NumpyOp", "NDArrayOp"]

_PROPS: dict = {}


class CustomOp:
    """Base class of a user op: ``forward``/``backward`` on host arrays
    (each has ``asnumpy()``, ``shape`` and ``dtype``); results go into
    ``out_data``/``in_grad`` through :meth:`assign`."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` (an NDArray, a host array or array-like) into
        ``dst`` per ``req``: ``write``/``inplace`` overwrites, ``add``
        adds to what ``dst`` holds, ``null`` does nothing."""
        if req in ("null", 0):
            return
        src = np.asarray(src.asnumpy() if hasattr(src, "asnumpy") else src)
        if req in ("add", "add_to"):
            dst._npvalue[...] = dst._npvalue + src
        else:
            dst._npvalue[...] = src


class CustomOpProp:
    """A user op's metadata and factory.  ``need_top_grad=False`` makes
    the op a loss head: its backward does not read the head gradient."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        t = in_type[0] if in_type else np.float32
        return ([t] * len(self.list_arguments()),
                [t] * len(self.list_outputs()),
                [t] * len(self.list_auxiliary_states()))

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """The ids (from the three lists) the backward reads: only these
        are kept from the forward and copied to the host for it."""
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Decorator registering a :class:`CustomOpProp` subclass as
    ``op_type=reg_name``.  Registering a name again replaces its Prop:
    the cached output counts of that name and the executor's program
    cache are dropped."""

    def deco(prop_cls):
        if not (isinstance(prop_cls, type)
                and issubclass(prop_cls, CustomOpProp)):
            raise MXNetError("can only register subclasses of CustomOpProp")
        _PROPS[reg_name] = prop_cls
        from .executor import program_cache_clear
        from .ops.custom import invalidate_num_outputs_cache

        invalidate_num_outputs_cache(reg_name)
        program_cache_clear()
        return prop_cls

    return deco


def get_prop(op_type: str, config=None) -> CustomOpProp:
    """A new instance of the Prop registered as ``op_type``; the user
    kwargs of the ``Custom`` call in ``config`` reach its constructor as
    strings (sequences in their tuple form, ``'(1, 2)'``), as the
    reference's custom-inl.h forwards them."""
    try:
        cls = _PROPS[op_type]
    except KeyError:
        raise MXNetError(f"custom op type '{op_type}' is not registered "
                         "(use @mx.operator.register)") from None
    kwargs = {k: (str(tuple(v)) if isinstance(v, (list, tuple)) else str(v))
              for k, v in (config or {}).items()}
    return cls(**kwargs)


class _HostArray:
    """The array handed to user code: ``asnumpy()``, ``shape``,
    ``dtype``, ``__array__``; :meth:`CustomOp.assign` writes into it."""

    __slots__ = ("_npvalue",)

    def __init__(self, arr):
        self._npvalue = np.asarray(arr)

    def asnumpy(self):
        return self._npvalue

    @property
    def shape(self):
        return self._npvalue.shape

    @property
    def dtype(self):
        return self._npvalue.dtype

    def __array__(self, dtype=None, copy=None):
        return self._npvalue if dtype is None else self._npvalue.astype(dtype)


# ---------------------------------------------------------------------------
# The legacy numpy-callback op styles (the reference marks them deprecated
# in favour of CustomOp); one shim maps them onto the Custom op.
# ---------------------------------------------------------------------------
class PythonOp:
    """Deprecated base (parity: operator.py PythonOp).  Use CustomOp."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def __call__(self, *args, **kwargs):
        return self.get_symbol(*args, **kwargs)

    def get_symbol(self, *args, **kwargs):
        raise NotImplementedError

    def forward(self, in_data, out_data):
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_


class NumpyOp(PythonOp):
    """The deprecated NumpyOp: ``forward(in_data, out_data)`` and
    ``backward(out_grad, in_data, out_data, in_grad)`` on numpy arrays,
    writing the outputs in place, through the Custom op."""

    def get_symbol(self, *args, **kwargs):
        from . import symbol as sym

        outer = self
        name = f"_numpy_op_{type(self).__name__}_{id(self):x}"

        class _Prop(CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=outer.need_top_grad())

            def list_arguments(self):
                return outer.list_arguments()

            def list_outputs(self):
                return outer.list_outputs()

            def infer_shape(self, in_shape):
                # a 2-tuple answer is completed by the Custom op
                return outer.infer_shape(in_shape)

            def create_operator(self, ctx, in_shapes, in_dtypes):
                class _Op(CustomOp):
                    def forward(self, is_train, req, in_data, out_data, aux):
                        outer.forward([d.asnumpy() for d in in_data],
                                      [o._npvalue for o in out_data])

                    def backward(self, req, out_grad, in_data, out_data,
                                 in_grad, aux):
                        outer.backward([g.asnumpy() for g in out_grad],
                                       [d.asnumpy() for d in in_data],
                                       [o.asnumpy() for o in out_data],
                                       [g._npvalue for g in in_grad])

                return _Op()

        if name not in _PROPS:
            _PROPS[name] = _Prop
        return sym._make_symbol_fn("Custom")(*args, op_type=name, **kwargs)


NDArrayOp = NumpyOp  # the reference exposes both protocols; one shim serves
