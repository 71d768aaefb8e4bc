"""Weight initializers of the port (mirrors ``mxnet_tpu/initializer.py``:
the name-based dispatch, ``Uniform`` (the trainer's default),
``Normal``, ``Constant``, ``One``, ``Zero``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu``, ``Bilinear``, ``Load`` and ``Mixed``, with ``dumps`` and
:func:`create` for a variable's ``__init__`` attr).

``upsampling*`` and ``*_bilinear`` names get the bilinear upsampling
kernel (computed as the reference does, so exactly its values);
``_weight`` names go to the initializer's own rule; ``_gamma`` and
``_moving_var`` fill with ones; ``_parameters`` (the fused ``RNN`` op's
packed vector, whose per-matrix fan-in the 1-D shape cannot tell) draws
``U(-0.07, 0.07)``, as the JAX package does; ``_beta``, ``_bias``,
``_moving_mean`` and every unknown suffix (``pos_embed``) fill with
zeros.  Tensors (or NDArrays, as the reference's initializers take) are
filled
in place from a ``torch.Generator``: the one given to the initializer,
else the process generator of the tensor's device
(:func:`mxnet_tpu_torch.random.generator`).  The JAX package draws from
numpy's global stream, so the two packages' random weights differ; the
parity tests carry weights across with :mod:`mxnet_tpu_torch.convert`.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Initializer", "Uniform", "Normal", "Constant", "One", "Zero",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "Load", "Mixed",
           "create", "variable_initializers"]


class Initializer:
    def __init__(self, generator=None):
        self._generator = generator

    def _gen(self, arr):
        return self._generator or _random.generator(arr.device)

    def __call__(self, name, arr):
        """Fill ``arr`` (a tensor, or an NDArray whose tensor is filled)
        in place by the rule of ``name``'s suffix."""
        if not isinstance(name, str):
            raise TypeError("name must be str")
        if isinstance(arr, NDArray):
            arr = arr.tensor
        if name.startswith("upsampling") or name.endswith("_bilinear"):
            self._init_bilinear(name, arr)
        elif name.endswith("_gamma"):
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

    def dumps(self):
        """``[name, kwargs]`` as JSON, what :func:`create` rebuilds."""
        return json.dumps([self.__class__.__name__.lower(),
                           getattr(self, "_kwargs", {})])

    def _init_bilinear(self, name, arr):
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(weight.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr.copy_(torch.from_numpy(weight.reshape(shape)))

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
        self._kwargs = {"scale": scale}

    def _init_weight(self, name, arr):
        arr.uniform_(-self.scale, self.scale, generator=self._gen(arr))


class Normal(Initializer):
    """Weights normal with mean 0 and standard deviation ``sigma``."""

    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator)
        self.sigma = sigma
        self._kwargs = {"sigma": sigma}

    def _init_weight(self, name, arr):
        arr.normal_(0.0, self.sigma, generator=self._gen(arr))


class Constant(Initializer):
    """Every tensor filled with ``value``, whatever its name."""

    def __init__(self, value=0.0):
        super().__init__()
        self.value = value
        self._kwargs = {"value": value}

    def __call__(self, name, arr):
        arr.fill_(self.value)


class One(Initializer):
    def _init_weight(self, name, arr):
        arr.fill_(1.0)


class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr.zero_()


class Orthogonal(Initializer):
    """Orthogonal weights (Saxe et al.): the ``(out, in)`` factor of the
    SVD of a uniform (``rand_type="uniform"``) or normal draw, times
    ``scale``, so ``W Wᵀ = scale² I`` when ``out <= in``."""

    def __init__(self, scale=1.414, rand_type="uniform", generator=None):
        super().__init__(generator)
        self.scale = scale
        self.rand_type = rand_type
        self._kwargs = {"scale": scale, "rand_type": rand_type}

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        tmp = torch.empty((nout, nin), dtype=torch.float64,
                          device=arr.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=self._gen(arr))
        else:
            tmp.normal_(0.0, 1.0, generator=self._gen(arr))
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr.copy_((self.scale * q).reshape(arr.shape))


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
        self._kwargs = {"rnd_type": rnd_type, "factor_type": factor_type,
                        "magnitude": magnitude}

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
        self._kwargs = {"factor_type": factor_type, "slope": slope}


class Bilinear(Initializer):
    """The bilinear upsampling kernel for every ``_weight``."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)


class Load:
    """Values from a saved parameter dict (a file of ``nd.save`` or a
    dict; ``arg:``/``aux:`` prefixes dropped), ``default_init`` for the
    rest."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from . import ndarray as nd

            param = nd.load(param, ctx="cpu")
        self.param = {}
        for name, arr in param.items():
            self.param[name.replace("arg:", "").replace("aux:", "")] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        from .convert import _to_tensor

        if name in self.param:
            src = _to_tensor(self.param[name], arr.dtype, arr.device)
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError(f"shape mismatch for {name}")
            arr.copy_(src)
        else:
            if self.default_init is None:
                raise MXNetError(f"no init for {name}")
            self.default_init(name, arr)


class Mixed:
    """The first initializer whose pattern (a regex, matched at the
    start of the name) matches."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must pair up")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(name):
                init(name, arr)
                return
        raise MXNetError(f"no initializer pattern matches {name}")


def create(dumps_json: str) -> Initializer:
    """An initializer from its :meth:`Initializer.dumps` JSON (a
    variable's ``__init__`` attr)."""
    name, kwargs = json.loads(dumps_json)
    registry = {
        "uniform": Uniform, "normal": Normal, "one": One, "zero": Zero,
        "constant": Constant, "orthogonal": Orthogonal, "xavier": Xavier,
        "msraprelu": MSRAPrelu, "bilinear": Bilinear,
    }
    if name not in registry:
        raise MXNetError(f"unknown initializer '{name}'")
    return registry[name](**kwargs)


def variable_initializers(symbol) -> dict:
    """``{name: initializer}`` of the variables of ``symbol`` that carry
    their own ``__init__`` attr (``Variable(init=...)``, e.g. SSD's
    ``conv4_3_scale``); an attr naming no known initializer is left
    out.  What ``Module.init_params`` uses before its own initializer,
    and what a loop over an executor's ``arg_dict`` should too."""
    inits = {}
    for node in symbol.nodes:
        if node.is_variable and node.extra_attrs.get("__init__"):
            try:
                inits[node.name] = create(node.extra_attrs["__init__"])
            except MXNetError:
                pass
    return inits
