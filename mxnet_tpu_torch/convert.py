"""The weight carry: the JAX package's ``arg_params`` -> the port's tensors.

Duck-typed on purpose, so the port never imports ``mxnet_tpu``: a value
may be anything with ``.asnumpy()`` (an ``mxnet_tpu`` NDArray), anything
numpy can read through ``__array__`` (a JAX array, including bfloat16
ones), a numpy array, or a torch tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import torch_dtype
from .context import resolve_device

__all__ = ["from_jax_params"]


def _to_tensor(value, dtype, device) -> torch.Tensor:
    """One parameter as a contiguous tensor of ``dtype`` on ``device``."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        a = value.asnumpy() if hasattr(value, "asnumpy") else value
        a = np.asarray(a)
        if (a.dtype != np.float32 or not a.flags.writeable
                or not a.flags.c_contiguous):
            # float64 (the JAX side runs without x64) and bfloat16
            # (ml_dtypes, which torch cannot read) go through float32;
            # read-only views are copied before torch wraps them
            a = np.array(a, np.float32, order="C")
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype).contiguous()


def from_jax_params(arg_params, dtype=torch.float32, device=None):
    """``{name: value}`` -> ``{name: tensor}`` in ``dtype`` on ``device``
    (default: the card; pass ``device="cpu"`` for the host)."""
    dtype = torch_dtype(dtype)
    device = resolve_device(device)
    return {k: _to_tensor(v, dtype, device) for k, v in arg_params.items()}
