"""Weight initializers of the port (mirrors ``mxnet_tpu/initializer.py``:
the name-based dispatch, ``Uniform`` (the trainer's default),
``Normal``, ``Constant``, ``One``, ``Zero``, ``Xavier`` and
``MSRAPrelu``).

``_weight`` names go to the initializer's own rule; ``_gamma`` and
``_moving_var`` fill with ones; ``_parameters`` (the fused ``RNN`` op's
packed vector, whose per-matrix fan-in the 1-D shape cannot tell) draws
``U(-0.07, 0.07)``, as the JAX package does; ``_beta``, ``_bias``,
``_moving_mean`` and every unknown suffix (``pos_embed``) fill with
zeros.  Tensors are filled
in place from a ``torch.Generator``: the one given to the initializer,
else the process generator of the tensor's device
(:func:`mxnet_tpu_torch.random.generator`).  The JAX package draws from
numpy's global stream, so the two packages' random weights differ; the
parity tests carry weights across with :mod:`mxnet_tpu_torch.convert`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Constant", "One", "Zero",
           "Xavier", "MSRAPrelu"]


class Initializer:
    def __init__(self, generator=None):
        self._generator = generator

    def _gen(self, arr):
        return self._generator or _random.generator(arr.device)

    def __call__(self, name, arr: torch.Tensor):
        if not isinstance(name, str):
            raise TypeError("name must be str")
        if name.startswith("upsampling") or name.endswith("_bilinear"):
            raise MXNetError(f"initializer for {name!r} (bilinear) is not "
                             "ported yet (ROADMAP Queue 1 item 6)")
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
        elif name.endswith("_parameters"):
            self._init_rnn_fused(name, arr)
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

    def _init_rnn_fused(self, name, arr):
        arr.uniform_(-0.07, 0.07, generator=self._gen(arr))

    def _init_weight(self, name, arr):
        raise NotImplementedError


class Uniform(Initializer):
    """Weights uniform in ``[-scale, scale)``."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr.uniform_(-self.scale, self.scale, generator=self._gen(arr))


class Normal(Initializer):
    """Weights normal with mean 0 and standard deviation ``sigma``."""

    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr.normal_(0.0, self.sigma, generator=self._gen(arr))


class Constant(Initializer):
    """Every tensor filled with ``value``, whatever its name."""

    def __init__(self, value=0.0):
        super().__init__()
        self.value = value

    def __call__(self, name, arr):
        arr.fill_(self.value)


class One(Initializer):
    def _init_weight(self, name, arr):
        arr.fill_(1.0)


class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr.zero_()


class Xavier(Initializer):
    """Glorot: uniform in ``[-s, s)`` (``rnd_type="uniform"``) or normal
    with deviation ``s`` (``"gaussian"``), ``s = sqrt(magnitude /
    factor)`` where the factor is the fan-in, the fan-out or their mean
    (``factor_type`` ``"in"``, ``"out"``, ``"avg"``); the fans count the
    kernel's spatial size."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale if len(shape) > 1 else shape[0]
        fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError(f"invalid factor_type {self.factor_type}")
        scale = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=self._gen(arr))
        elif self.rnd_type == "gaussian":
            arr.normal_(0.0, scale, generator=self._gen(arr))
        else:
            raise MXNetError(f"invalid rnd_type {self.rnd_type}")


class MSRAPrelu(Xavier):
    """He initialisation for PReLU nets: gaussian Xavier with magnitude
    ``2 / (1 + slope**2)``."""

    def __init__(self, factor_type="avg", slope=0.25, generator=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         generator)
