"""Common utilities of the PyTorch port (mirrors ``mxnet_tpu/base.py``).

The port keeps its own copies of what it needs: importing anything from
``mxnet_tpu`` would import JAX through that package's ``__init__``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__version__ = "0.1.0"


class MXNetError(RuntimeError):
    """Error raised by mxnet_tpu_torch (parity: dmlc::Error)."""


def _env_int(name, default):
    """Integer env knob; unset or empty means ``default``."""
    v = os.environ.get(name)
    return default if not v else int(v)


_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(dtype) -> torch.dtype:
    """``torch.float32``, ``"bfloat16"``, ``np.float32`` or a JAX-style
    dtype object (anything with a ``name``) -> the ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name is None:
        name = np.dtype(dtype).name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r} (want one of "
                         f"{sorted(_DTYPES)})") from None
