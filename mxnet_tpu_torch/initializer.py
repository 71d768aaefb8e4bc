"""Weight initializers of the port (mirrors ``mxnet_tpu/initializer.py``:
the name-based dispatch and ``Uniform``, the trainer's default).

``_weight`` names go to the initializer's own rule; ``_gamma`` and
``_moving_var`` fill with ones; ``_beta``, ``_bias``, ``_moving_mean``
and every unknown suffix (``pos_embed``) with zeros.  Tensors are filled
in place from a ``torch.Generator``: the one given to the initializer,
else the process generator of the tensor's device
(:func:`mxnet_tpu_torch.random.generator`).  The JAX package draws from
numpy's global stream, so the two packages' random weights differ; the
parity tests carry weights across with :mod:`mxnet_tpu_torch.convert`.
"""
from __future__ import annotations

import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Uniform"]


class Initializer:
    def __init__(self, generator=None):
        self._generator = generator

    def _gen(self, arr):
        return self._generator or _random.generator(arr.device)

    def __call__(self, name, arr: torch.Tensor):
        if not isinstance(name, str):
            raise TypeError("name must be str")
        if (name.startswith("upsampling")
                or name.endswith(("_bilinear", "_parameters"))):
            raise MXNetError(f"initializer for {name!r} (bilinear / fused "
                             "RNN parameters) is not ported yet (ROADMAP "
                             "Queue 1 item 6)")
        if name.endswith("_gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("_beta"):
            self._init_beta(name, arr)
        elif name.endswith("_weight"):
            self._init_weight(name, arr)
        elif name.endswith("_bias"):
            self._init_bias(name, arr)
        elif name.endswith("_moving_mean") or name.endswith("_moving_avg"):
            self._init_zero(name, arr)
        elif name.endswith("_moving_var"):
            self._init_one(name, arr)
        else:
            self._init_default(name, arr)

    def _init_zero(self, name, arr):
        arr.zero_()

    def _init_one(self, name, arr):
        arr.fill_(1.0)

    _init_gamma = _init_one
    _init_beta = _init_zero
    _init_bias = _init_zero
    _init_default = _init_zero

    def _init_weight(self, name, arr):
        raise NotImplementedError


class Uniform(Initializer):
    """Weights uniform in ``[-scale, scale)``."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr.uniform_(-self.scale, self.scale, generator=self._gen(arr))
