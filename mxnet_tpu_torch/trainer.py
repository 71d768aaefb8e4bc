"""FusedTrainer of the port (mirrors ``mxnet_tpu/trainer.py``).

One training step over a Symbol: forward through the graph interpreter,
``torch.autograd`` backward with the head gradient ignored by the loss
ops, then the optimizer update.  The JAX package compiles all of it into
one XLA program with donated buffers; the port runs it eagerly and gets
the same memory behaviour by updating in place: the fp32 master
weights, the optimizer state and the carried compute-dtype copy are
overwritten, never duplicated.

Mixed precision (``dtype="bfloat16"``, or ``MXTPU_AMP=bf16`` with
``dtype=None``): fp32 masters, a bf16 copy that the forward reads and
the update rewrites from the new masters, gradients cast to fp32 before
the update.  Data inputs are cast to the compute dtype, as in the JAX
package (in bf16 that rounds token ids above 256 before ``Embedding``;
the port keeps that on purpose so the two agree); labels are not.

The step has no host sync (no ``.item()`` / ``.cpu()``); the caller
reads the returned outputs when it needs them.  Not ported yet, and
raising when asked for: ``mesh`` / ``sharding_rules`` (ROADMAP Queue 1
item 10), ``remat=True`` and ``step_multi`` (item 4), checkpoints
(item 7), ``fit`` (item 6) and the numerics sentinel ``MXTPU_SENTINEL``
(item 11).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, torch_dtype
from .context import resolve_device
from .executor import _build_graph_fn
from .initializer import Uniform
from .optim_rules import _RULES

__all__ = ["FusedTrainer"]


def _not_ported(what, item):
    return MXNetError(f"FusedTrainer: {what} is not ported yet (ROADMAP "
                      f"Queue 1 item {item})")


class FusedTrainer:
    """Training-step runner over a Symbol, on one device.

    ``device`` (default: the card) is where parameters, state and the
    step live; tests pass ``device="cpu"``."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), optimizer="sgd",
                 optimizer_params=None, mesh=None, initializer=None,
                 dtype=None, sharding_rules=(), remat=None,
                 fixed_param_names=(), clip_global_norm=None,
                 lr_scheduler=None, device=None):
        if mesh is not None or sharding_rules:
            raise _not_ported("mesh / sharding_rules", 10)
        if remat is None:
            remat = os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0") == "1"
        if remat:
            raise _not_ported("remat=True (MXNET_BACKWARD_DO_MIRROR)", 4)
        if os.environ.get("MXTPU_SENTINEL", "0").strip().lower() not in (
                "", "0", "off", "false", "no"):
            raise _not_ported("the numerics sentinel (MXTPU_SENTINEL)", 11)
        self.symbol = symbol
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.device = resolve_device(device)
        if dtype is None:
            from . import amp as _amp

            dtype = _amp.amp_dtype() or torch.float32
        self.dtype = torch_dtype(dtype)
        opt_params = dict(optimizer_params or {})
        opt_params.setdefault("lr", opt_params.pop("learning_rate", 0.01))
        self._base_lr = float(opt_params.pop("lr"))
        self._lr_scheduler = lr_scheduler
        if lr_scheduler is not None and hasattr(lr_scheduler, "base_lr"):
            lr_scheduler.base_lr = self._base_lr
        if optimizer not in _RULES:
            raise ValueError(f"FusedTrainer supports {sorted(_RULES)}")
        self._init_state, self._update = _RULES[optimizer](opt_params)
        if isinstance(fixed_param_names, str):
            fixed_param_names = (fixed_param_names,)
        self._fixed = frozenset(fixed_param_names)
        if clip_global_norm is not None and not float(clip_global_norm) > 0:
            raise ValueError("clip_global_norm must be > 0 (a negative "
                             "threshold would flip gradient signs; 0 would "
                             "silently disable clipping)")
        self._clip_global_norm = (None if clip_global_norm is None
                                  else float(clip_global_norm))
        self._initializer = initializer or Uniform(0.01)
        # per-param multipliers: params not named *_weight / *_gamma
        # (biases, norm betas) get no weight decay; __lr_mult__ /
        # __wd_mult__ Variable attrs override
        self._lr_mult, self._wd_mult = {}, {}
        for name in symbol.list_arguments():
            if not (name.endswith("_weight") or name.endswith("_gamma")):
                self._wd_mult[name] = 0.0
        for name, attr in symbol.attr_dict().items():
            if "__lr_mult__" in attr:
                self._lr_mult[name] = float(attr["__lr_mult__"])
            if "__wd_mult__" in attr:
                self._wd_mult[name] = float(attr["__wd_mult__"])
        self._graph_fn = _build_graph_fn(symbol, device=self.device)
        self.params: Dict[str, torch.Tensor] = {}
        self.aux: Dict[str, torch.Tensor] = {}
        self.opt_state: Dict[str, tuple] = {}
        self._use_ccache = self.dtype != torch.float32
        self._cparams: Dict[str, torch.Tensor] = {}
        self._step = 0

    # ------------------------------------------------------------ setup
    def init(self, **input_shapes):
        """Infer every parameter's shape from the input shapes, fill the
        fp32 masters with the initializer, zero the optimizer state and
        build the compute-dtype copy."""
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise MXNetError(f"FusedTrainer.init: cannot infer the "
                             f"parameter shapes from {input_shapes}")
        inputs = set(self.data_names + self.label_names)
        for name, shape in zip(self.symbol.list_arguments(), arg_shapes):
            if name in inputs:
                continue
            arr = torch.zeros(shape, dtype=torch.float32, device=self.device)
            self._initializer(name, arr)
            self.params[name] = arr
        unknown = self._fixed - set(self.params)
        if unknown:
            raise MXNetError(f"fixed_param_names not in the model: "
                             f"{sorted(unknown)} (have "
                             f"{sorted(self.params)[:8]}...)")
        for name, w in self.params.items():
            if name not in self._fixed:
                self.opt_state[name] = tuple(self._init_state(w))
        for name, shape in zip(self.symbol.list_auxiliary_states(),
                               aux_shapes):
            arr = torch.zeros(shape, dtype=torch.float32, device=self.device)
            self._initializer(name, arr)
            self.aux[name] = arr
        self._refresh_compute_cache()
        return self

    def _refresh_compute_cache(self):
        """(Re)build the carried compute-dtype copy from the fp32 masters.
        Call after any direct overwrite of ``self.params`` outside
        :meth:`step` (``init`` and ``convert.load_trainer_params`` do)."""
        if self._use_ccache:
            self._cparams = {k: v.to(self.dtype)
                             for k, v in self.params.items()}

    # ---------------------------------------------------------- running
    def _to_device(self, batch):
        out = {}
        for k, v in batch.items():
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = v.to(self.device, non_blocking=True)
        return out

    def _args(self, batch, compute_params):
        args = dict(compute_params)
        for k in self.data_names:
            args[k] = batch[k].to(self.dtype)
        return args

    def _compute_params(self):
        # in fp32 the masters are what the forward reads
        return self._cparams if self._use_ccache else self.params

    def current_lr(self):
        """The learning rate the next step will apply."""
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler(self._step + 1))
        return self._base_lr

    def step(self, **batch):
        """One training step; returns the graph's outputs (tensors on the
        trainer's device, not synchronised)."""
        # the JAX step receives lr as an fp32 scalar
        lr = float(np.float32(self.current_lr()))
        self._step += 1
        sb = self._to_device(batch)
        compute = self._compute_params()
        trainable = {k: v.detach().requires_grad_(True)
                     for k, v in compute.items() if k not in self._fixed}
        args = self._args(sb, compute)
        args.update(trainable)
        for k in self.label_names:
            args[k] = sb[k]
        compute_aux = {k: v.to(self.dtype) for k, v in self.aux.items()}
        outs, new_aux = self._graph_fn(args, compute_aux,
                                       _random.generator(self.device), True)
        # the head is ones, as in the JAX package; the loss ops ignore it
        grads = torch.autograd.grad(
            outs, list(trainable.values()),
            grad_outputs=[torch.ones_like(o) for o in outs],
            allow_unused=True)
        with torch.no_grad():
            f32 = {k: (torch.zeros_like(self.params[k]) if g is None
                       else g.float())
                   for k, g in zip(trainable, grads)}
            if self._clip_global_norm is not None:
                gnorm = torch.sqrt(sum(g.square().sum() for g in f32.values()))
                scale = (self._clip_global_norm
                         / gnorm.clamp_min(1e-12)).clamp_max(1.0)
                for g in f32.values():
                    g.mul_(scale)
            for k, w in self.params.items():
                if k in self._fixed:
                    continue
                self._update(w, f32[k], self.opt_state[k],
                             lr * self._lr_mult.get(k, 1.0),
                             self._wd_mult.get(k, 1.0))
                if self._use_ccache:
                    self._cparams[k].copy_(w)
            self.aux = {k: v.detach().float() for k, v in new_aux.items()}
        return [o.detach() for o in outs]

    def eval(self, **batch):
        """Forward in inference mode; a missing label is zeros."""
        sb = self._to_device(batch)
        with torch.no_grad():
            args = self._args(sb, self._compute_params())
            n = sb[self.data_names[0]].shape[0]
            for k in self.label_names:
                args[k] = sb[k] if k in sb else torch.zeros(
                    (n,), dtype=torch.float32, device=self.device)
            compute_aux = {k: v.to(self.dtype) for k, v in self.aux.items()}
            outs, _ = self._graph_fn(args, compute_aux,
                                     _random.generator(self.device), False)
        return outs

    def get_params(self):
        """``(arg_params, aux_params)``: copies of the fp32 masters and aux
        states, as tensors on the trainer's device."""
        return ({k: v.clone() for k, v in self.params.items()},
                {k: v.clone() for k, v in self.aux.items()})

    # ------------------------------------------------------- not ported
    def step_multi(self, *args, **kwargs):
        raise _not_ported("step_multi", 4)

    def fit(self, *args, **kwargs):
        raise _not_ported("fit", 6)

    def save_checkpoint(self, *args, **kwargs):
        raise _not_ported("save_checkpoint", 7)

    def load_checkpoint(self, *args, **kwargs):
        raise _not_ported("load_checkpoint", 7)

    def save_state(self, *args, **kwargs):
        raise _not_ported("save_state", 7)

    def restore_state(self, *args, **kwargs):
        raise _not_ported("restore_state", 7)

    def rebind_mesh(self, *args, **kwargs):
        raise _not_ported("rebind_mesh", 10)
