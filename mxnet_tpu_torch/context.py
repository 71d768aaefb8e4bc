"""Device contexts of the port (mirrors ``mxnet_tpu/context.py``).

``gpu(i)`` is ``torch.device("cuda", i)``.  Every entry point of the
port resolves its ``device`` argument through :func:`resolve_device`:
the default is the card, and without one it raises instead of quietly
running on the CPU.  Tests pass ``device="cpu"``.  The JAX package's
``Context`` objects become ``torch.device``s here; :func:`current_context`
is the card the imperative ``nd.*`` creators use when given no ``ctx``.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "current_context", "resolve_device"]


def cpu(device_id: int = 0) -> torch.device:
    """The host (``device_id`` is accepted for MXNet parity and ignored)."""
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (the current card); a string, index or
    ``torch.device`` passes through.  Raises :class:`MXNetError` when
    the resolved device is CUDA and no card is available."""
    if device is None:
        device = torch.device("cuda")
    elif isinstance(device, int):
        device = gpu(device)
    else:
        device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host explicitly")
    return device


def current_context() -> torch.device:
    """The card the imperative creators default to, with its index
    (``cuda:<current device>``); raises :class:`MXNetError` without one."""
    resolve_device(None)
    return gpu(torch.cuda.current_device())
