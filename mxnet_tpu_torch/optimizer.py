"""Optimizers of the port (mirrors ``mxnet_tpu/optimizer.py``; parity:
python/mxnet/optimizer.py).

The registry and :func:`create`, :class:`Optimizer` (``rescale_grad``,
``clip_gradient``, ``param_idx2name``, the lr and wd multipliers by name
— no weight decay on anything but ``*_weight`` and ``*_gamma`` —, the
update counts, ``lr_scheduler``, ``fused_rule``/``fused_lr`` for the
bucketed kvstore update and fp32 master weights), the zoo (``SGD``,
``NAG``, ``SGLD``, ``CcSGD``, ``Adam``, ``AdaGrad``, ``RMSProp``,
``AdaDelta``, ``DCASGD``, ``Test``) and :class:`Updater`.

Weights, gradients and states are port NDArrays; an update rewrites the
weight and its state tensors **in place** (the JAX package rebinds new
arrays), through the ops of :mod:`mxnet_tpu_torch.ops.optimizer_ops`
where the reference calls its fused ops, and as the reference's NDArray
arithmetic, operation for operation, elsewhere.  A state is made like
its weight (``zeros_like``: same device and memory format), so a
channels-last conv weight gets channels-last momentum.

``Updater.get_states`` pickles ``{key: numpy state}`` as the reference
does, so a state file written by either package loads in the other;
states loaded by ``set_states`` take their device and layout from the
weight at the key's next update.  Under AMP loss scaling the
``Updater`` divides each gradient by the live scale first
(``amp.maybe_unscale_grad``; no skip-step on this eager path, as in the
reference).  A row-sparse gradient takes the touched-rows-only update
(``sparse.eager_update``, the row update the bucketed engine runs), which
needs an optimizer with a fused rule.
"""
from __future__ import annotations

import logging
import math
import pickle
from typing import Dict

import numpy as np
import torch

from . import amp as _amp
from . import ops
from . import random as _random
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "CcSGD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "DCASGD", "Test", "Updater", "create",
           "register", "get_updater"]

_OPT_REGISTRY: Dict[str, type] = {}


def register(klass):
    """Register an optimizer class under its lowercase name."""
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _t(x) -> torch.Tensor:
    return x.tensor if isinstance(x, NDArray) else x


def _zeros_like(weight, dtype=None) -> NDArray:
    return NDArray(torch.zeros_like(_t(weight), dtype=dtype))


def _clip(g, clip):
    """``nd.clip(g, -clip, clip)`` when a clip is set (the reference's
    eager optimizers test ``is not None``)."""
    return g if clip is None else g.clamp(-clip, clip)


class Optimizer:
    """Base optimizer: hyperparameters, multipliers and update counts."""

    # classes whose state layout carries an fp32 master as the last slot
    master_supported = False

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 **kwargs):
        if "lr" in kwargs:
            learning_rate = kwargs.pop("lr")
        if kwargs:
            logging.warning("Optimizer: ignoring unknown arguments %s",
                            sorted(kwargs))
        self.multi_precision = bool(multi_precision)
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict = {}
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.lr_mult: Dict = {}
        self.wd_mult: Dict = {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in _OPT_REGISTRY:
            raise MXNetError(f"unknown optimizer {name}")
        return _OPT_REGISTRY[name.lower()](**kwargs)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update) if self.lr_scheduler
              else self.lr)
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # --------------------------------------------- fp32 master weights
    def _use_master(self, weight) -> bool:
        """An fp32 master for a bf16/fp16 weight, as the last state slot,
        when ``multi_precision`` (or ``MXTPU_AMP``) asks for one."""
        return self.master_supported and _amp.master_weights_wanted(
            self, _t(weight).dtype)

    def _master_state(self, weight) -> NDArray:
        return NDArray(_t(weight).float())

    def _warn_low_precision(self, index, weight):
        """Warn once per key for a low-precision weight that updates
        without an fp32 master."""
        if _amp.is_low_precision(_t(weight).dtype):
            _amp.warn_no_master(self.idx2name.get(index, index))

    # ------------------------------------------------- fused kvstore path
    def fused_rule(self):
        """``(rule name, host hyperparameters)`` for the bucketed kvstore
        update (:mod:`mxnet_tpu_torch.kvstore_fused`), or None when this
        optimizer runs the eager per-key updater.  ``wd`` is the 1.0 base
        the per-key effective wd scales."""
        return None

    def fused_lr(self, index):
        """The per-key lr of the bucketed update, read after
        ``_update_count(index)``."""
        return self._get_lr(index)


def create(name, **kwargs):
    """``mx.optimizer.create``: an optimizer by registered name."""
    return Optimizer.create_optimizer(name, **kwargs)


@register
class SGD(Optimizer):
    """SGD with momentum, over ``sgd_update`` / ``sgd_mom_update``."""

    master_supported = True

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self._use_master(weight):
            mom = () if self.momentum == 0.0 else (
                _zeros_like(weight, torch.float32),)
            return mom + (self._master_state(weight),)
        self._warn_low_precision(index, weight)
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = {"lr": self._get_lr(index), "wd": self._get_wd(index),
                 "rescale_grad": self.rescale_grad,
                 "clip_gradient": self.clip_gradient or 0.0}
        w, g = _t(weight), _t(grad)
        master = None
        if self._use_master(weight) and isinstance(state, (tuple, list)):
            master, g = _t(state[-1]), g.float()
            state = state[0] if self.momentum != 0.0 else None
        target = master if master is not None else w
        octx = ops.OpCtx()
        if state is not None:
            ops.get("sgd_mom_update").fn(octx, target, g, _t(state),
                                         momentum=self.momentum, **attrs)
        else:
            ops.get("sgd_update").fn(octx, target, g, **attrs)
        if master is not None:
            w.copy_(master)

    def fused_rule(self):
        # NAG subclasses SGD with other math: only SGD and ccSGD fuse
        if type(self) not in (SGD, CcSGD):
            return None
        return "sgd", {"momentum": float(self.momentum), "wd": 1.0,
                       "rescale_grad": float(self.rescale_grad),
                       "clip_gradient": float(self.clip_gradient or 0.0)}


@register
class NAG(SGD):
    """Nesterov accelerated SGD: ``mom = momentum*mom + g'``; ``w -= lr *
    (g' + momentum*mom)``."""

    master_supported = False

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _clip(_t(grad) * self.rescale_grad, self.clip_gradient)
        g = g + wd * w
        if state is not None:
            mom = _t(state).mul_(self.momentum).add_(g)
            w.sub_(lr * (g + self.momentum * mom))
        else:
            w.sub_(lr * g)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics; the noise comes from the
    port's generator of the weight's device."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _clip(_t(grad) * self.rescale_grad, self.clip_gradient)
        noise = torch.normal(0.0, math.sqrt(lr), w.shape, dtype=w.dtype,
                             device=w.device,
                             generator=_random.generator(w.device))
        w.copy_(w - lr / 2 * (g + wd * w) + noise)


@register
class CcSGD(SGD):
    """ccSGD: the same math as SGD."""


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the lr, over
    ``adam_update``."""

    master_supported = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        dt = torch.float32 if self._use_master(weight) else None
        slots = (_zeros_like(weight, dt), _zeros_like(weight, dt))
        if self._use_master(weight):
            return slots + (self._master_state(weight),)
        self._warn_low_precision(index, weight)
        return slots

    def _lr_t(self, index):
        t = self._index_update_count[index]
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        return self._get_lr(index) * math.sqrt(coef2) / coef1

    def update(self, index, weight, grad, state):
        self._update_count(index)
        w, g = _t(weight), _t(grad)
        use_master = self._use_master(weight) and len(state) == 3
        target = _t(state[2]) if use_master else w
        ops.get("adam_update").fn(
            ops.OpCtx(), target, g.float() if use_master else g,
            _t(state[0]), _t(state[1]), lr=self._lr_t(index),
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
            wd=self._get_wd(index), rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient or 0.0)
        if use_master:
            w.copy_(target)

    def fused_rule(self):
        if type(self) is not Adam:
            return None
        return "adam", {"wd": 1.0, "rescale_grad": float(self.rescale_grad),
                        "clip_gradient": float(self.clip_gradient or 0.0),
                        "beta1": float(self.beta1),
                        "beta2": float(self.beta2),
                        "epsilon": float(self.epsilon)}

    fused_lr = _lr_t


@register
class AdaGrad(Optimizer):
    """``history += g'^2``; ``w -= lr * (g' / sqrt(history + eps) + wd *
    w)``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _clip(_t(grad) * self.rescale_grad, self.clip_gradient)
        history = _t(state)
        history.copy_(history + g * g)
        w.copy_(w - lr * (g / torch.sqrt(history + self.float_stable_eps)
                          + wd * w))


@register
class RMSProp(Optimizer):
    """Tieleman-Hinton RMSProp over ``rmsprop_update``; ``centered=True``
    is Graves' variant, as the reference's NDArray arithmetic."""

    master_supported = True

    def __init__(self, learning_rate=0.001, gamma1=0.95, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros_like(weight) for _ in range(3))
        if self._use_master(weight):
            return (_zeros_like(weight, torch.float32),
                    self._master_state(weight))
        self._warn_low_precision(index, weight)
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        if not self.centered:
            use_master = (self._use_master(weight)
                          and isinstance(state, (tuple, list)))
            n = _t(state[0] if use_master else state)
            target = _t(state[1]) if use_master else w
            g = _t(grad).float() if use_master else _t(grad)
            ops.get("rmsprop_update").fn(
                ops.OpCtx(), target, g, n, lr=lr, gamma1=self.gamma1,
                epsilon=self.epsilon, wd=wd, rescale_grad=self.rescale_grad,
                clip_gradient=self.clip_gradient or 0.0,
                clip_weights=self.clip_weights or 0.0)
            if use_master:
                w.copy_(target)
            return
        n, gm, delta = (_t(s) for s in state)
        g = _clip(_t(grad) * self.rescale_grad + wd * w, self.clip_gradient)
        n.copy_(self.gamma1 * n + (1 - self.gamma1) * g * g)
        gm.copy_(self.gamma1 * gm + (1 - self.gamma1) * g)
        delta.copy_(self.gamma2 * delta
                    - lr * g / torch.sqrt(n - gm * gm + self.epsilon))
        w.copy_(w + delta)

    def fused_rule(self):
        if type(self) is not RMSProp or self.centered:
            return None
        return "rmsprop", {"wd": 1.0,
                           "rescale_grad": float(self.rescale_grad),
                           "clip_gradient": float(self.clip_gradient or 0.0),
                           "gamma1": float(self.gamma1),
                           "epsilon": float(self.epsilon),
                           "clip_weights": float(self.clip_weights or 0.0)}


@register
class AdaDelta(Optimizer):
    """Zeiler's AdaDelta."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        w = _t(weight)
        g = _clip(_t(grad) * self.rescale_grad, self.clip_gradient)
        acc_g, acc_delta = (_t(s) for s in state)
        acc_g.copy_(self.rho * acc_g + (1 - self.rho) * g * g)
        delta = (torch.sqrt(acc_delta + self.epsilon)
                 / torch.sqrt(acc_g + self.epsilon) * g)
        acc_delta.copy_(self.rho * acc_delta + (1 - self.rho) * delta * delta)
        w.copy_(w - (delta + wd * w))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = NDArray(_t(weight).clone())
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros_like(weight), prev)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _clip(_t(grad) * self.rescale_grad, self.clip_gradient)
        mom, prev = state
        prev = _t(prev)
        comp = g + self.lamda * g * g * (w - prev)
        if mom is not None:
            mom = _t(mom)
            mom.copy_(self.momentum * mom - lr * (comp + wd * w))
            step = mom
        else:
            step = -lr * (comp + wd * w)
        prev.copy_(w)
        w.copy_(w + step)


@register
class Test(Optimizer):
    """``weight += grad * rescale_grad``: the kvstore arithmetic fixture."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        w = _t(weight)
        w.copy_(w + _t(grad) * self.rescale_grad)


class Updater:
    """The per-key updater a KVStore or a Module calls: ``updater(index,
    grad, weight)`` with lazily created state."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict = {}
        # a bucketed engine whose sharded update holds some keys' states
        # as flat slices (kvstore_fused): gathered back before a read
        self._shard_owner = None

    def sync_sharded(self):
        """Gather the states a sharded bucket update holds back into
        :attr:`states` (a collective every rank of the store makes)."""
        if self._shard_owner is not None:
            self._shard_owner.ensure_host_state()

    def ensure_state(self, index, weight):
        """The key's state, made on first use (the bucketed kvstore
        engine reads it here too, so eager and bucketed steps share one
        state store).  A state loaded by :meth:`set_states` becomes
        tensors like ``weight`` (its device and memory format) here.  A
        state the sharded update holds is gathered back first."""
        if (self._shard_owner is not None and index not in self.states
                and self._shard_owner.holds_state_of(index)):
            self._shard_owner.ensure_host_state()
        st = self.states.get(index, _MISSING)
        if st is _MISSING:
            st = self.optimizer.create_state(index, weight)
        elif _is_host(st):
            st = _state_from_np(st, _t(weight))
        self.states[index] = st
        return st

    def __call__(self, index, grad, weight):
        # under AMP loss scaling: the gradient divided by the live scale
        # (a new array); the bucketed update unscales in its own step
        grad = _amp.maybe_unscale_grad(grad)
        if getattr(grad, "stype", "default") == "row_sparse":
            from . import sparse as _sparse

            _sparse.eager_update(self.optimizer, self, index, weight, grad)
            return
        self.optimizer.update(index, weight, grad,
                              self.ensure_state(index, weight))

    def get_states(self):
        """Pickled ``{key: state}`` with every state as numpy (the
        reference's format)."""
        self.sync_sharded()
        return pickle.dumps({k: _state_to_np(v)
                             for k, v in self.states.items()})

    def set_states(self, states):
        """Load :meth:`get_states` bytes of either package; the arrays
        reach the device at each key's next update."""
        if self._shard_owner is not None:
            self._shard_owner.drop_shards()
        self.states = dict(pickle.loads(states))


_MISSING = object()


def _is_host(state):
    if isinstance(state, np.ndarray):
        return True
    return (isinstance(state, tuple)
            and any(isinstance(s, np.ndarray) for s in state))


def _state_to_np(state):
    if state is None or isinstance(state, np.ndarray):
        return state
    if isinstance(state, (tuple, list)):
        return tuple(_state_to_np(s) for s in state)
    return state.asnumpy()


def _state_from_np(state, like: torch.Tensor):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_from_np(s, like) for s in state)
    src = torch.from_numpy(np.ascontiguousarray(state))
    dst = torch.empty_like(like, dtype=src.dtype)
    if dst.shape != src.shape:
        raise MXNetError(f"optimizer state of shape {tuple(src.shape)} for "
                         f"a weight of shape {tuple(dst.shape)}")
    return NDArray(dst.copy_(src))


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
