"""Common utilities of the PyTorch port (mirrors ``mxnet_tpu/base.py``).

The port keeps its own copies of what it needs: importing anything from
``mxnet_tpu`` would import JAX through that package's ``__init__``.
"""
from __future__ import annotations

import ast
import os

import numpy as np
import torch

__version__ = "0.1.0"


class MXNetError(RuntimeError):
    """Error raised by mxnet_tpu_torch (parity: dmlc::Error)."""


def get_env(name: str, default, dtype=None):
    """Read an environment variable with a typed default (parity:
    dmlc::GetEnv): unset gives ``default``; otherwise the value parsed
    as ``dtype`` (default: ``type(default)``), where a bool is false for
    ``"0"``, ``"false"`` (any case) and ``""``."""
    val = os.environ.get(name)
    if val is None:
        return default
    ty = dtype or type(default)
    if ty is bool:
        return val.lower() not in ("0", "false", "")
    return ty(val)


def _env_int(name, default):
    """Integer env knob; unset or empty means ``default``."""
    v = os.environ.get(name)
    return default if not v else int(v)


# every dtype an NDArray may hold, by numpy name; the compute dtypes of
# ``torch_dtype`` are a subset
_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "float16": torch.float16, "int64": torch.int64, "int32": torch.int32,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_COMPUTE = ("float32", "float", "bfloat16")


def _lookup(dtype, names) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name is None:
        name = np.dtype(dtype).name
    if str(name) not in names:
        raise MXNetError(f"unsupported dtype {dtype!r} (want one of "
                         f"{sorted(names)})")
    return _DTYPES[str(name)]


def torch_dtype(dtype) -> torch.dtype:
    """A compute dtype — ``torch.float32``, ``"bfloat16"``, ``np.float32``
    or a JAX-style dtype object (anything with a ``name``) -> the
    ``torch.dtype``."""
    return _lookup(dtype, _COMPUTE)


def numeric_dtype(dtype) -> torch.dtype:
    """Any dtype an NDArray may hold (``np.int32``, ``"float16"``,
    ``torch.uint8``, a JAX dtype) -> the ``torch.dtype``."""
    return _lookup(dtype, _DTYPES)


def parse_attr(value):
    """An op attribute that may arrive as a string, as Python data.

    Symbol attrs come through as strings (``"(0, 2, 1, 3)"``, ``"True"``,
    ``"1e-5"``); native values pass through unchanged and a string that
    is no Python literal is returned as it is."""
    if not isinstance(value, str):
        return value
    s = value.strip()
    low = s.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return value


_BOOL_STRS = {"true": True, "false": False, "1": True, "0": False}


def parse_bool(value) -> bool:
    if isinstance(value, str):
        return _BOOL_STRS.get(value.lower(), bool(value))
    return bool(value)


def normalize_tuple(value, ndim: int, name: str = "value"):
    """Broadcast an int (or 1-tuple) to an ndim-tuple (kernel/stride/pad)."""
    value = parse_attr(value)
    if isinstance(value, int):
        return (value,) * ndim
    value = tuple(value)
    if len(value) == 1:
        return value * ndim
    if len(value) != ndim:
        raise ValueError(f"{name} must have {ndim} elements, got {value}")
    return value


def frozen_attrs(attrs: dict) -> tuple:
    """Hashable view of an attr dict (the CSE pass's node key)."""

    def freeze(v):
        if isinstance(v, (list, tuple)):
            return tuple(freeze(x) for x in v)
        if isinstance(v, dict):
            return tuple(sorted((k, freeze(x)) for k, x in v.items()))
        return v

    return tuple(sorted((k, freeze(v)) for k, v in attrs.items()))


class NameManager:
    """Auto-namer for symbols: an unnamed op gets ``<op>N`` with a
    per-hint counter (mirrors ``mxnet_tpu.base.NameManager``)."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        hint = hint.lower()
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"


_NAME_MANAGER = NameManager()


def current_name_manager() -> NameManager:
    return _NAME_MANAGER


class AttrScope:
    """Scoped symbol attributes (mirrors ``mxnet_tpu.base.AttrScope``):
    inside ``with AttrScope(ctx_group="dev1"):`` every new Variable and
    op node gets the scope's attrs (as strings), merged under the attrs
    the call itself passes; nested scopes merge outer then inner.
    ``bind(group2ctx={group: device})`` places the nodes of each
    ``ctx_group`` on its device (``executor.placement_plan``)."""

    _current = None

    def __init__(self, **kwargs):
        self._attr = {k: str(v) for k, v in kwargs.items()}

    def get(self, attr):
        merged = dict(self._attr)
        if attr:
            merged.update(attr)
        return merged

    def __enter__(self):
        self._old = AttrScope._current
        if self._old is not None:
            scope = AttrScope()
            scope._attr = {**self._old._attr, **self._attr}
            AttrScope._current = scope
        else:
            AttrScope._current = self
        return self

    def __exit__(self, *exc):
        AttrScope._current = self._old


def current_attr_scope():
    return AttrScope._current


def scoped_attrs(attr):
    """``attr`` merged over the current :class:`AttrScope`'s attrs."""
    scope = AttrScope._current
    return scope.get(attr) if scope else dict(attr or {})
