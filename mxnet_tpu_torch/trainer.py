"""FusedTrainer of the port (mirrors ``mxnet_tpu/trainer.py``).

One training step over a Symbol: forward through the graph interpreter,
``torch.autograd`` backward with the head gradient ignored by the loss
ops, then the optimizer update.  The JAX package compiles all of it into
one XLA program with donated buffers; the port runs it eagerly
(:meth:`FusedTrainer.step`) or replays it as one captured CUDA graph
(:meth:`FusedTrainer.step_multi`), and gets the donation's memory
behaviour by updating in place.

Every tensor a step reads or writes keeps its storage from step to
step: the fp32 masters, the optimizer state, the carried compute-dtype
copy, the aux states (written back in place), the learning rate (an
fp32 0-d tensor on the device, refilled before each step) and the batch
buffers (one per input name, shape and dtype, which each step's batch
is copied into).  That is what lets a captured graph of the step
replay against the live state.

Mixed precision (``dtype="bfloat16"``, or ``MXTPU_AMP=bf16`` with
``dtype=None``): fp32 masters, a bf16 copy that the forward reads and
the update rewrites from the new masters, gradients cast to fp32 before
the update; the aux states enter the forward rounded to bf16 and their
updates are stored in fp32, as the JAX step rounds them.  Data inputs
are cast to the compute dtype, as in the JAX package (in bf16 that
rounds token ids above 256 before ``Embedding``; the port keeps that on
purpose so the two agree); labels are not.

Channels-last weights (the JAX trainer's HWIO storage,
``_discover_hwio_params``): under ``MXTPU_CONV_LAYOUT`` NHWC (the
default) the conv weights that only 2-D convolutions consume are kept
in ``torch.channels_last`` memory (master, optimizer state and bf16
copy), so cuDNN reads them with no relayout, and batches of 4-D data
are copied into channels-last buffers, as the Predictor binds them.
``MXTPU_HWIO_STORAGE=0`` keeps the weights contiguous; a weight with
any other consumer stays contiguous.  Shapes stay logical OIHW, and
:meth:`FusedTrainer.get_params` returns contiguous copies.

The trainer runs the graph the pass pipeline rewrote
(``passes.apply_graph_passes``, as the JAX trainer does), so
``MXTPU_AMP=bf16`` gives it the ``amp_cast`` graph; ``self.symbol``
stays the user's symbol, whose names the passes never change.

Recompute (``remat=True``, or ``MXNET_BACKWARD_DO_MIRROR=1``): the
whole forward runs under ``torch.utils.checkpoint`` (non-reentrant), as
the JAX step wraps it in ``jax.checkpoint``: its activations are not
kept, and the backward runs it again.  The random ops must draw the
same numbers the second time, as JAX replays its key: the recompute
draws from a second generator whose state is set to the trainer
generator's before each step (outside any capture), and a captured step
registers both with its graph, so the two advance together replay by
replay.  The graph function is functional (BatchNorm returns its new
moving statistics), so the recompute writes nothing; a ``Custom`` op's
user forward runs again in the recompute, as ``jax.checkpoint`` calls
the reference's callback again.

Checkpoints (:mod:`mxnet_tpu_torch.checkpoint`): :meth:`save_state` /
:meth:`restore_state` write and read a survival checkpoint (masters, aux
states, optimizer slots, the step, the graph's structural signature,
this package's generator state), in the JAX package's layout, so either
package resumes the other's (conv weights the JAX trainer stores HWIO
are relaid out; a JAX threefry key cannot continue a torch generator,
which is reseeded with a warning); :meth:`save_checkpoint` /
:meth:`load_checkpoint` write the Module format plus a ``.states`` file;
``fit(checkpoint=, resume=)`` (or ``MXTPU_CKPT_DIR``) snapshots every
``MXTPU_CKPT_EVERY`` steps behind the queued steps, saves a boundary
checkpoint and raises ``checkpoint.Preempted`` on SIGTERM, saves a
terminal checkpoint at the end, and resumes mid-epoch from the batch
cursor.

Health and perf planes (:mod:`mxnet_tpu_torch.telemetry`): under
``MXTPU_SENTINEL`` each step also computes, from the raw (pre-clip)
fp32 gradients, a per-parameter ``isfinite`` flag and the global
gradient norm, packed into one device tensor that
``health.sentinel_record`` parks unread (site ``fused_step``, or
``fused_step_multi`` with one row a step; in a captured step the graph
writes it to a buffer that each replay's row is copied out of); the
sync happens at the next reporting boundary (the async window's drain,
``engine.wait_for_all``, an explicit ``sentinel_check``).  The first
step records the step's memory row (``health.record_program``), an
allocator failure in a step re-raises as ``DeviceOOMError`` with the
ranked memory report, and the bytes updated in place count as
``device_memory_donated_bytes_total``.  Under ``MXTPU_PERF_ATTR`` the
first eager step (for ``step_multi`` on the card, its first warm-up
step, never the capture) counts its FLOPs into the step's cost row, and
every step adds its host wall; ``fit`` appends each batch to the flight
ring (``MXTPU_FLIGHT_RECORD``, default on), splits each batch's wall
into ``data_wait`` / ``dispatch`` / ``window_stall`` and the epoch's
drain into ``boundary_sync``, and writes the flight record on an
uncaught exception when ``MXTPU_FLIGHT_RECORD`` names a path.  A new
autotuner winner (``autotune.fingerprint()``) drops the captured graphs
that launch a tuned kernel (the residual epilogue), so a step never
replays a launch schedule it captured before a search; the others stay.

The steps make no host sync (no ``.item()`` / ``.cpu()``), checkpoints
and planes armed or not; the caller reads the returned outputs when it
needs them.  With ``MXTPU_COORD_ADDR`` set, ``fit`` joins the
coordinator (:mod:`mxnet_tpu_torch.parallel.coordinator`), polls it once
a step on the host and, when the cluster's generation moves, writes a
boundary checkpoint (when armed) and raises
:class:`~mxnet_tpu_torch.parallel.dist.GenerationChanged`.  Not ported
yet, and raising when asked for: ``mesh`` / ``sharding_rules``
(ROADMAP Queue 1 item 10b).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import autotune as _autotune
from . import profiler as _prof
from . import random as _random
from . import telemetry as _tm
from .base import MXNetError, torch_dtype
from .context import resolve_device
from .executor import _build_graph_fn, channels_last_default
from .initializer import Uniform
from .ndarray import NDArray
from .ops import residual_epilogue as _epilogue
from .optim_rules import _RULES
from .passes import apply_graph_passes

__all__ = ["FusedTrainer"]

# the reference's ops that draw random numbers (``needs_rng``): a
# captured step registers the trainer's generator with its graph, so
# each replay draws afresh; a torch without that API refuses them
_RANDOM_OPS = frozenset({"Dropout", "LeakyReLU", "RNN", "uniform",
                         "_sample_uniform", "random_uniform", "normal",
                         "_sample_normal", "random_normal"})
# eager steps run on the capture stream before a capture, so cuDNN's
# plans, cuBLAS's workspaces and the allocator's blocks are settled
_WARMUP_STEPS = 2


def _not_ported(what, item):
    return MXNetError(f"FusedTrainer: {what} is not ported yet (ROADMAP "
                      f"Queue 1 item {item})")


def _as_tensor(value) -> torch.Tensor:
    """A batch input (NDArray, tensor, numpy array or list) as a tensor,
    where it lies."""
    if isinstance(value, NDArray):
        return value.tensor
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.ascontiguousarray(value))


class _Captured(NamedTuple):
    """One captured training step: replaying ``graph`` runs the step on
    the batch in ``inputs`` and leaves its outputs in ``outputs`` (and
    the sentinel's flags and norm in ``sent`` under ``MXTPU_SENTINEL``)."""
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]
    outputs: list
    sent: Optional[torch.Tensor]
    # the graph launches the residual epilogue, whose schedule the
    # autotuner may change
    tuned: bool


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
            raise _not_ported("mesh / sharding_rules", "10b")
        if remat is None:
            remat = os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0") == "1"
        self.remat = bool(remat)
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
        # the executed graph is the rewritten one; self.symbol stays the
        # user-facing interface (the passes never rename variables)
        self._exec_symbol = apply_graph_passes(symbol)
        self._graph_fn = _build_graph_fn(self._exec_symbol,
                                         device=self.device)
        self.params: Dict[str, torch.Tensor] = {}
        self.aux: Dict[str, torch.Tensor] = {}
        self.opt_state: Dict[str, tuple] = {}
        self._use_ccache = self.dtype != torch.float32
        self._cparams: Dict[str, torch.Tensor] = {}
        self._step = 0
        # filled by init(): the layout decision, the device lr, the
        # batch buffers and the captured steps
        self._channels_last = False
        self._cl_params: frozenset = frozenset()
        self._lr = None
        self._bufs: Dict[tuple, torch.Tensor] = {}
        self._graphs: Dict[tuple, _Captured] = {}
        self._graphs_fingerprint = None
        # the recompute's generator (remat): set to the trainer
        # generator's state before each step
        self._remat_gen = (torch.Generator(device=self.device)
                           if self.remat else None)
        self._signature = None
        # step()'s profiler span (recorded only while the profiler runs)
        self._span = f"forward_backward[{symbol.name or 'graph'}]"
        self._sync = _prof.device_sync(self.device)
        # the health and perf planes' label of the step, and their state
        # (set for real by init)
        self._label = f"fused_step[{symbol.name or 'graph'}]"
        self._sentinel = False
        self._sent_names = ()
        self._mem_recorded = False
        self._cost_recorded = False
        self._donated_bytes = 0

    # ------------------------------------------------------------ setup
    def init(self, **input_shapes):
        """Infer every parameter's shape from the input shapes, fill the
        fp32 masters with the initializer, zero the optimizer state and
        build the compute-dtype copy."""
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise MXNetError(f"FusedTrainer.init: cannot infer the "
                             f"parameter shapes from {input_shapes}")
        arg_names = self.symbol.list_arguments()
        self._channels_last = channels_last_default()
        self._cl_params = self._discover_channels_last(
            dict(zip(arg_names, arg_shapes)))
        inputs = set(self.data_names + self.label_names)
        self.params, self.aux, self.opt_state = {}, {}, {}
        for name, shape in zip(arg_names, arg_shapes):
            if name in inputs:
                continue
            # filled in logical OIHW order, then stored channels-last, so
            # the draws do not depend on the layout
            arr = torch.zeros(shape, dtype=torch.float32, device=self.device)
            self._initializer(name, arr)
            if name in self._cl_params:
                arr = arr.contiguous(memory_format=torch.channels_last)
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
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        self._cparams = {}
        self._bufs = {}
        self._graphs = {}
        # the numerics sentinel is sampled here, as the JAX trainer samples
        # it when it builds its step program
        self._sentinel = _tm.health.sentinel_mode() is not None
        self._sent_names = tuple(k for k in self.params
                                 if k not in self._fixed)
        self._mem_recorded = False
        self._cost_recorded = False
        self._refresh_compute_cache()
        return self

    def _discover_channels_last(self, shapes):
        """The conv weights that only 2-D convolutions consume (as their
        weight input), which get channels-last storage; none when
        ``MXTPU_CONV_LAYOUT=NCHW`` or ``MXTPU_HWIO_STORAGE=0``."""
        if (os.environ.get("MXTPU_HWIO_STORAGE", "1") == "0"
                or not self._channels_last):
            return frozenset()
        conv_w, other = set(), set()
        for node in self.symbol.nodes:
            if node.is_variable:
                continue
            for idx, (src, _) in enumerate(node.inputs):
                if not src.is_variable:
                    continue
                if (node.op == "Convolution" and idx == 1
                        and len(shapes.get(src.name) or ()) == 4):
                    conv_w.add(src.name)
                else:
                    other.add(src.name)
        # a weight that is itself an output is read in its logical layout
        other.update(n.name for n, _ in self.symbol._outputs
                     if n.is_variable)
        return frozenset(conv_w - other)

    def _refresh_compute_cache(self):
        """(Re)fill the carried compute-dtype copy from the fp32 masters,
        in place once it exists.  Call after any direct overwrite of
        ``self.params`` outside :meth:`step` (``init`` and
        ``convert.load_trainer_params`` do)."""
        if not self._use_ccache:
            return
        for k, v in self.params.items():
            c = self._cparams.get(k)
            if c is None:
                self._cparams[k] = v.to(self.dtype)
            else:
                c.copy_(v)

    def _state(self):
        """Every tensor a step overwrites, in a fixed order."""
        yield from self.params.values()
        yield from self._cparams.values()
        for st in self.opt_state.values():
            yield from st
        yield from self.aux.values()

    # ---------------------------------------------------------- running
    def _require_init(self, what):
        if self._lr is None:
            raise MXNetError(f"FusedTrainer.{what}: call init() first")

    def _buffer(self, name, src):
        """The persistent device buffer of input ``name`` at ``src``'s
        shape and dtype (channels-last for 4-D data under NHWC)."""
        key = (name, tuple(src.shape), src.dtype)
        buf = self._bufs.get(key)
        if buf is None:
            fmt = (torch.channels_last
                   if self._channels_last and src.dim() == 4
                   else torch.contiguous_format)
            buf = torch.empty(src.shape, dtype=src.dtype, device=self.device,
                              memory_format=fmt)
            self._bufs[key] = buf
        return buf

    def _pinned(self, t):
        """``t`` in pinned host memory when it is bound for the card from
        the host, so its upload is queued without waiting."""
        if (self.device.type == "cuda" and t.device.type == "cpu"
                and not t.is_pinned()):
            return t.pin_memory()
        return t

    def _stage(self, batch):
        """Copy each input into its buffer (no host sync); returns
        ``{name: buffer}``."""
        staged = {}
        for name, value in batch.items():
            src = self._pinned(_as_tensor(value))
            buf = self._buffer(name, src)
            buf.copy_(src, non_blocking=True)
            staged[name] = buf
        return staged

    def _args(self, batch, compute_params):
        args = dict(compute_params)
        for k in self.data_names:
            args[k] = batch[k].to(self.dtype)
        return args

    def _compute_params(self):
        # in fp32 the masters are what the forward reads
        return self._cparams if self._use_ccache else self.params

    def _lr_at(self, num_update):
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler(num_update))
        return self._base_lr

    def current_lr(self):
        """The learning rate the next step will apply."""
        return self._lr_at(self._step + 1)

    def _train_step(self, sb):
        """Forward, backward and update on the staged batch ``sb`` at the
        rate in ``self._lr``; the state is updated in place.  The body
        of both :meth:`step` and the captured graph.  Returns ``(outputs,
        sent)``: ``sent`` is the sentinel's ``(n_params + 1,)`` fp32
        tensor (flags, then the norm) or None when it is off."""
        compute = self._compute_params()
        trainable = {k: v.detach().requires_grad_(True)
                     for k, v in compute.items() if k not in self._fixed}
        args = self._args(sb, compute)
        args.update(trainable)
        for k in self.label_names:
            args[k] = sb[k]
        compute_aux = {k: v.to(self.dtype) for k, v in self.aux.items()}
        gen = _random.generator(self.device)
        if self.remat:
            outs, new_aux = self._remat_forward(args, compute_aux, gen)
        else:
            outs, new_aux = self._graph_fn(args, compute_aux, gen, True)
        # the head is ones, as in the JAX package; the loss ops ignore it
        grads = torch.autograd.grad(
            outs, list(trainable.values()),
            grad_outputs=[torch.ones_like(o) for o in outs],
            allow_unused=True)
        # the range names the update's kernels in a profile of eager steps
        with torch.no_grad(), torch.profiler.record_function(
                "FusedTrainer.update"):
            f32 = {k: (torch.zeros_like(self.params[k]) if g is None
                       else g.float())
                   for k, g in zip(trainable, grads)}
            # raw (pre-clip) gradients: a finite clip rescale cannot mask
            # an inf/nan, and the norm is the divergence signal
            sent = (_tm.health.sentinel_vector(
                f32[k] for k in self._sent_names)
                if self._sentinel else None)
            if self._clip_global_norm is not None:
                gnorm = torch.sqrt(sum(g.square().sum() for g in f32.values()))
                scale = (self._clip_global_norm
                         / gnorm.clamp_min(1e-12)).clamp_max(1.0)
                for g in f32.values():
                    g.mul_(scale)
            for k, w in self.params.items():
                if k in self._fixed:
                    continue
                mult = self._lr_mult.get(k, 1.0)
                self._update(w, f32[k], self.opt_state[k],
                             self._lr if mult == 1.0 else self._lr * mult,
                             self._wd_mult.get(k, 1.0))
                if self._use_ccache:
                    self._cparams[k].copy_(w)
            for k, v in new_aux.items():
                self.aux[k].copy_(v)
        return [o.detach() for o in outs], sent

    def _remat_forward(self, args, aux, gen):
        """The forward under ``torch.utils.checkpoint``: the first run
        draws from ``gen``, the recompute from the remat generator, which
        holds the state ``gen`` had when the step began."""
        calls = [0]

        def run():
            g = gen if calls[0] == 0 else self._remat_gen
            calls[0] += 1
            outs, new_aux = self._graph_fn(args, aux, g, True)
            return tuple(outs), new_aux

        outs, new_aux = torch.utils.checkpoint.checkpoint(
            run, use_reentrant=False, preserve_rng_state=False)
        return list(outs), new_aux

    def _sync_remat_gen(self):
        """Give the recompute's generator the trainer generator's state
        (host values only; never inside a capture)."""
        if self._remat_gen is not None:
            self._remat_gen.set_state(
                _random.generator(self.device).get_state())

    def step(self, **batch):
        """One training step, eagerly; returns the graph's outputs
        (tensors on the trainer's device, not synchronised; while the
        profiler runs, the step is a ``forward_backward[...]`` span that
        ends with a device sync)."""
        self._require_init("step")
        return self._eager_step(batch, "fused_step")

    def _eager_step(self, batch, site):
        """:meth:`step`'s body; the sentinel parks its flags under
        ``site``."""
        # the JAX step receives lr as an fp32 scalar
        lr = float(np.float32(self.current_lr()))
        self._step += 1
        perf_on = _tm.perf.enabled()
        t0 = time.perf_counter() if (perf_on or _tm.enabled()) else None
        sb = self._stage(batch)
        self._record_step_memory(sb)
        self._lr.fill_(lr)
        self._sync_remat_gen()
        with _prof.span(self._span, device=str(self.device),
                        sync=self._sync):
            try:
                outs, sent = self._counted_step(sb)
            except Exception as e:  # noqa: BLE001 — an OOM gets the report
                _tm.health.reraise_if_oom(e, site="trainer.step")
                raise
        if sent is not None:
            _tm.health.sentinel_record(site=site, step=self._step,
                                       names=self._sent_names, finite=sent,
                                       packed_norm=True)
        if t0 is not None:
            _tm.health.donation_saved(self._donated_bytes,
                                      site="trainer_step")
            if perf_on:
                _tm.perf.record_dispatch(self._label,
                                         time.perf_counter() - t0)
        return outs

    def _counted_step(self, sb):
        """:meth:`_train_step`; under ``MXTPU_PERF_ATTR`` the first one
        counts its FLOPs into the step's cost row (eager only: never
        called inside a capture)."""
        if self._cost_recorded or not _tm.perf.enabled():
            return self._train_step(sb)
        self._cost_recorded = True
        with _tm.perf.counting() as c:
            res = self._train_step(sb)
        _tm.perf.record_cost(self._label, flops=c.flops,
                             source="flop_counter")
        return res

    def _record_step_memory(self, sb):
        """The step's memory row, once: the state is updated in place
        (the JAX step donates it), so the peak is about the state plus
        the batch.  Shape math."""
        if self._mem_recorded:
            return
        self._mem_recorded = True
        state = sum(t.numel() * t.element_size() for t in self._state())
        batch = sum(t.numel() * t.element_size() for t in sb.values())
        self._donated_bytes = state
        _tm.health.record_program(self._label, argument=state + batch,
                                  output=state, alias=state,
                                  source="shape_math")

    def _steps_of(self, value):
        """One ``step_multi`` input -> its k per-step tensors: the rows
        of a stacked ``(k, B, ...)`` value, or the elements of a k-list;
        host tensors bound for the card are pinned."""
        if isinstance(value, (list, tuple)):
            rows = [_as_tensor(v) for v in value]
        else:
            rows = list(_as_tensor(value).unbind(0))
        return [self._pinned(r) for r in rows]

    def step_multi(self, **stacked):
        """k training steps; every input carries a leading steps axis,
        stacked ``(k, B, ...)`` or a k-list/tuple of per-step ``(B, ...)``
        batches (``io.step_multi_feeds`` makes those).

        Interchangeable with k calls of :meth:`step` at any point of a
        run: the same lr schedule, the same updates.  On the card the
        whole step (forward, backward, update, bf16 copy refresh, aux
        write-back) is one CUDA graph, captured on the first call for
        these per-step shapes and dtypes and cached, then replayed once
        per step after the step's batch and lr are copied into its
        buffers.  A graph with random ops (Dropout, ``RNN(p>0)``) is
        captured with the trainer's generator registered as its state:
        each replay advances the generator as an eager step would, so
        every step draws a fresh mask and the draws follow the seed.  A
        step that cannot be captured raises; it never falls back to
        eager steps.  On the CPU the k steps run through :meth:`step`.
        A graph with a ``Custom`` op (user Python on the host) raises,
        on any device.

        Returns the per-step outputs stacked on axis 0, not
        synchronised."""
        self._require_init("step_multi")
        custom = sorted({str(n.attrs.get("op_type")) for n in
                         self._exec_symbol.nodes if n.op == "Custom"})
        if custom:
            raise MXNetError(
                f"FusedTrainer.step_multi: the graph runs the Custom op "
                f"{', '.join(custom)} (user Python on the host), which a "
                f"captured CUDA graph cannot replay; train it with step()")
        if not stacked:
            raise MXNetError("FusedTrainer.step_multi: no inputs given")
        rows = {name: self._steps_of(v) for name, v in stacked.items()}
        counts = {name: len(r) for name, r in rows.items()}
        if len(set(counts.values())) != 1 or 0 in counts.values():
            raise MXNetError(f"FusedTrainer.step_multi: every input needs "
                             f"the same number of steps (>= 1), got "
                             f"{counts}")
        k = next(iter(counts.values()))
        for name, r in rows.items():
            if any(x.shape != r[0].shape or x.dtype != r[0].dtype
                   for x in r):
                raise MXNetError(f"FusedTrainer.step_multi: the steps of "
                                 f"{name!r} differ in shape or dtype")
        if self.device.type != "cuda":
            outs = [self._eager_step({n: r[i] for n, r in rows.items()},
                                     "fused_step_multi")
                    for i in range(k)]
            return [torch.stack(o) for o in zip(*outs)]
        perf_on = _tm.perf.enabled()
        t0 = time.perf_counter() if (perf_on or _tm.enabled()) else None
        try:
            cap = self._captured({n: r[0] for n, r in rows.items()})
        except Exception as e:  # noqa: BLE001 — an OOM gets the report
            _tm.health.reraise_if_oom(e, site="trainer.step_multi")
            raise
        lrs = [float(np.float32(self._lr_at(self._step + 1 + i)))
               for i in range(k)]
        step0 = self._step
        self._step += k
        stacked_outs = [torch.empty((k,) + tuple(o.shape), dtype=o.dtype,
                                    device=o.device) for o in cap.outputs]
        sents = (torch.empty((k,) + tuple(cap.sent.shape),
                             dtype=cap.sent.dtype, device=cap.sent.device)
                 if cap.sent is not None else None)
        for i in range(k):
            for name, r in rows.items():
                cap.inputs[name].copy_(r[i], non_blocking=True)
            self._lr.fill_(lrs[i])
            self._sync_remat_gen()
            cap.graph.replay()
            # the next replay overwrites the graph's outputs (and the
            # sentinel's row)
            for dst, out in zip(stacked_outs, cap.outputs):
                dst[i].copy_(out)
            if sents is not None:
                sents[i].copy_(cap.sent)
        if sents is not None:
            # rows map to steps step0+1 .. step0+k
            _tm.health.sentinel_record(site="fused_step_multi",
                                       step=step0 + 1,
                                       names=self._sent_names, finite=sents,
                                       packed_norm=True)
        if t0 is not None:
            _tm.health.donation_saved(self._donated_bytes * k,
                                      site="trainer_step_multi")
            if perf_on:
                _tm.perf.record_dispatch(self._label,
                                         time.perf_counter() - t0)
        return stacked_outs

    def _captured(self, example):
        """The captured step for the per-step batch shapes and dtypes of
        ``example`` (captured now if there is none)."""
        # a new autotuner winner drops the captures that launch a tuned
        # kernel: a graph bakes in the launch schedules its kernels read
        # at capture time
        fingerprint = _autotune.fingerprint()
        if fingerprint != self._graphs_fingerprint:
            self._graphs = {k: c for k, c in self._graphs.items()
                            if not c.tuned}
            self._graphs_fingerprint = fingerprint
        key = tuple(sorted((n, tuple(t.shape), t.dtype)
                           for n, t in example.items()))
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._capture(example)
            self._graphs[key] = cap
        return cap

    def _capture(self, example):
        random_ops = sorted({n.op for n in self.symbol.nodes
                             if not n.is_variable and n.op in _RANDOM_OPS})
        if random_ops and not hasattr(torch.cuda.CUDAGraph,
                                      "register_generator_state"):
            raise MXNetError(
                f"FusedTrainer.step_multi: the graph draws random numbers "
                f"({', '.join(random_ops)}); a captured step would replay "
                f"one draw, so it is not captured (use step()): this torch "
                f"has no CUDAGraph.register_generator_state")
        inputs = self._stage(example)
        self._record_step_memory(inputs)
        dev = self.device
        gen = _random.generator(dev)
        # warm up on the capture stream, then put the state back: the
        # warm-up steps are not part of the run, nor are their draws
        saved = [t.clone() for t in self._state()]
        gen_offset = gen.get_state()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(_WARMUP_STEPS):
                self._sync_remat_gen()
                # eager: the perf plane may count the first one
                self._counted_step(inputs)
        torch.cuda.current_stream(dev).wait_stream(stream)
        for t, s in zip(self._state(), saved):
            t.copy_(s)
        del saved
        gen.set_state(gen_offset)
        self._sync_remat_gen()
        graph = torch.cuda.CUDAGraph()
        if random_ops:
            graph.register_generator_state(gen)
            if self._remat_gen is not None:
                graph.register_generator_state(self._remat_gen)
        # a capture registers the card's default generator (and the
        # trainer's); one that fails leaves them in capture mode (every
        # later draw raises) and the capture stream current, so all are
        # put back
        default_gen = torch.cuda.default_generators[
            dev.index if dev.index is not None
            else torch.cuda.current_device()]
        gen_states = [(g, g.clone_state()) for g in (default_gen, gen,
                                                      self._remat_gen)
                      if g is not None]
        prev_stream = torch.cuda.current_stream(dev)
        n_epi = _epilogue.launch_count()
        try:
            with torch.cuda.graph(graph, stream=stream):
                outputs, sent = self._train_step(inputs)
        except RuntimeError as exc:
            for g, state in gen_states:
                g.graphsafe_set_state(state)
            torch.cuda.set_stream(prev_stream)
            first = exc.__context__ or exc
            raise MXNetError(
                f"FusedTrainer.step_multi: the training step could not be "
                f"captured as a CUDA graph ({first}); an op on its path "
                f"synchronises with the host or is not capturable") from exc
        return _Captured(graph, inputs, outputs, sent,
                         _epilogue.launch_count() != n_epi)

    def eval(self, **batch):
        """Forward in inference mode; a missing label is zeros."""
        self._require_init("eval")
        sb = self._stage(batch)
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
        """``(arg_params, aux_params)``: contiguous copies of the fp32
        masters (logical OIHW whatever their storage) and aux states, as
        tensors on the trainer's device."""
        def copy(v):
            return v.clone(memory_format=torch.contiguous_format)

        return ({k: copy(v) for k, v in self.params.items()},
                {k: copy(v) for k, v in self.aux.items()})

    # -------------------------------------------------------------- fit
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            validation_metric=None, num_epoch=1, batch_end_callback=None,
            epoch_end_callback=None, logger=None, checkpoint=None,
            resume=None):
        """The Module.fit-shaped loop on :meth:`step`: init from the first
        batch's shapes when needed, a metric update per batch (fused: no
        host sync), batch-end callbacks with a ``BatchEndParam``,
        epoch-end callbacks with ``(epoch, symbol, arg, aux)`` from
        :meth:`get_params`, and an eval pass per epoch.  The loop waits
        only in the async window (``MXTPU_ASYNC_DEPTH`` steps in flight)
        and at the epoch boundary.

        ``checkpoint`` (a ``CheckpointManager`` or a directory; default
        ``MXTPU_CKPT_DIR`` with ``MXTPU_CKPT_EVERY``) arms snapshots
        behind the queued steps, a boundary checkpoint and
        ``checkpoint.Preempted`` on SIGTERM, and a terminal checkpoint;
        ``resume=True`` (or a path) restores the newest complete
        checkpoint and skips the batches its cursor already trained.
        Returns self."""
        from . import checkpoint as _ckpt
        from . import metric as metric_mod

        log = logger or logging.getLogger()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            if validation_metric is None and eval_data is not None:
                validation_metric = metric_mod.create(eval_metric)
            eval_metric = metric_mod.create(eval_metric)
        if validation_metric is not None and not isinstance(
                validation_metric, metric_mod.EvalMetric):
            validation_metric = metric_mod.create(validation_metric)
        if eval_data is not None and validation_metric is None:
            raise ValueError(
                "pass validation_metric when eval_metric is a metric "
                "instance (instances hold state; eval needs its own)")
        mgr = _ckpt.resolve_manager(checkpoint)
        start_epoch, resume_nbatch = 0, -1
        if resume not in (None, False):
            if self._lr is None:
                self.init(**{d[0]: tuple(d[1]) for d in
                             list(train_data.provide_data)
                             + list(train_data.provide_label or [])})
            path = _ckpt.resolve_resume(resume, mgr)
            if path is None:
                log.warning("fit(resume=%r): no complete checkpoint found; "
                            "starting fresh", resume)
            else:
                meta = self.restore_state(path)
                if meta.get("epoch") is not None:
                    start_epoch = int(meta["epoch"])
                if meta.get("nbatch") is not None:
                    resume_nbatch = int(meta["nbatch"])
                log.info("resumed from %s (step %d, epoch %d, batch cursor "
                         "%d)", path, self._step, start_epoch, resume_nbatch)
        if mgr is not None:
            mgr.install_preempt_handler()
        try:
            self._fit_epochs(train_data, eval_data, eval_metric,
                             validation_metric, num_epoch,
                             batch_end_callback, epoch_end_callback, log,
                             mgr, start_epoch, resume_nbatch)
            if mgr is not None and self._lr is not None:
                # terminal checkpoint: resuming a finished run is a no-op
                self.save_state(mgr, epoch=num_epoch, nbatch=-1,
                                background=False)
        except BaseException:
            # black box first, then crash: the ring, the registry and the
            # memory report of the dying run (MXTPU_FLIGHT_RECORD path)
            _tm.health.auto_dump("exception")
            raise
        finally:
            if mgr is not None:
                try:
                    mgr.wait()
                except Exception as exc:  # noqa: BLE001 — log, not mask
                    log.warning("checkpoint writer failed: %r", exc)
                mgr.uninstall_preempt_handler()
        return self

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, num_epoch, batch_end_callback,
                    epoch_end_callback, log, mgr, start_epoch,
                    resume_nbatch):
        from . import checkpoint as _ckpt
        from . import engine
        from .module.base_module import BatchEndParam, _as_list
        from .parallel import coordinator as _coordinator

        # membership: armed by MXTPU_COORD_ADDR; step_poll is a
        # host-side flag check
        coord = _coordinator.client_from_env()
        train_names = ([d[0] for d in train_data.provide_data]
                       + [d[0] for d in train_data.provide_label])
        eval_label_names = ([d[0] for d in getattr(eval_data, "provide_label",
                                                   None) or []]
                            if eval_data is not None else [])
        eval_names = ([d[0] for d in eval_data.provide_data]
                      + eval_label_names if eval_data is not None else None)
        flight = _tm.health.flight_enabled()
        perf_on = _tm.perf.enabled()
        rec = flight or perf_on
        for epoch in range(start_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            window = engine.AsyncWindow()
            prev_tick = None  # per epoch: wall_s must not span eval/reset
            for nbatch, batch in enumerate(train_data):
                if epoch == start_epoch and nbatch <= resume_nbatch:
                    # the checkpoint's cursor trained these already
                    continue
                feed = dict(zip(train_names,
                                list(batch.data) + list(batch.label)))
                if self._lr is None:
                    self.init(**{k: tuple(v.shape) for k, v in feed.items()})
                t0 = time.perf_counter() if rec else 0.0
                outs = self.step(**feed)
                eval_metric.update(batch.label, [NDArray(o) for o in outs])
                tp = time.perf_counter() if perf_on else 0.0
                window.push(outs)
                if rec:
                    # host clock stamps only: no device sync
                    now = time.perf_counter()
                    wall = now - (prev_tick if prev_tick is not None else t0)
                    if flight:
                        _tm.health.record_step(
                            loop="fused", step=self._step, epoch=epoch,
                            nbatch=nbatch, depth=len(window),
                            dispatch_s=now - t0, wall_s=wall,
                            program=self._label)
                    if perf_on:
                        # the three buckets partition the batch's wall:
                        # the iterator and host work between steps, the
                        # step's launches, the window's backpressure
                        _tm.perf.record_step_buckets(
                            wall_s=wall,
                            data_wait=(max(t0 - prev_tick, 0.0)
                                       if prev_tick is not None else 0.0),
                            dispatch=tp - t0, window_stall=now - tp)
                    prev_tick = now
                if coord is not None and coord.step_poll():
                    # the generation moved: checkpoint this boundary,
                    # then leave by name
                    w = None
                    if mgr is not None:
                        w = self.save_state(mgr, epoch=epoch, nbatch=nbatch,
                                            background=False)
                    coord.raise_generation_changed(getattr(w, "path", None))
                if mgr is not None:
                    if mgr.preempted:
                        # the snapshot is ordered behind the queued steps
                        # and written now; then the run stops by name
                        w = self.save_state(mgr, epoch=epoch, nbatch=nbatch,
                                            background=False)
                        raise _ckpt.Preempted(
                            "SIGTERM: checkpoint saved to "
                            f"{getattr(w, 'path', mgr.directory)!r}; "
                            "restart with fit(resume=True)")
                    if mgr.due(self._step):
                        self.save_state(mgr, epoch=epoch, nbatch=nbatch)
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=None)
                    for cb in _as_list(batch_end_callback):
                        cb(params)
            td0 = time.perf_counter() if perf_on else 0.0
            window.drain()
            if perf_on:
                _tm.perf.record_bucket("boundary_sync",
                                       time.perf_counter() - td0)
            for name, val in eval_metric.get_global_name_value():
                log.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            log.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            if epoch_end_callback is not None:
                arg, aux = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg, aux)
            if eval_data is not None:
                vm = validation_metric
                vm.reset()
                eval_data.reset()
                window = engine.AsyncWindow()
                for batch in eval_data:
                    feed = dict(zip(eval_names,
                                    list(batch.data)
                                    + (list(batch.label)
                                       if eval_label_names else [])))
                    outs = self.eval(**feed)
                    vm.update(batch.label, [NDArray(o) for o in outs])
                    window.push(outs)
                window.drain()
                for name, val in vm.get_global_name_value():
                    log.info("Epoch[%d] Validation-%s=%f", epoch, name, val)

    # ------------------------------------------------------- survival
    def structural_signature(self):
        """The executed (post-pass) graph's signature, which a survival
        checkpoint carries."""
        if self._signature is None:
            self._signature = self._exec_symbol.structural_signature()
        return self._signature

    def _checkpoint_arrays(self):
        """The tensors a step owns: fp32 masters, aux states, every
        optimizer slot (the compute-dtype copy is derived, not saved).
        The snapshot copies them to logical (contiguous) layout."""
        arrs = {"param/" + k: v for k, v in self.params.items()}
        arrs.update({"aux/" + k: v for k, v in self.aux.items()})
        for k, slots in self.opt_state.items():
            for i, sl in enumerate(slots):
                arrs[f"opt/{k}/{i}"] = sl
        return arrs

    def _checkpoint_meta(self, epoch=None, nbatch=None):
        from . import checkpoint as _ckpt

        meta = {"trainer": "fused", "step": int(self._step),
                "epoch": None if epoch is None else int(epoch),
                "nbatch": None if nbatch is None else int(nbatch),
                "signature": self.structural_signature(),
                # the port stores conv weights in logical OIHW (their
                # channels-last storage is a memory format)
                "hwio": []}
        meta.update(_ckpt.generator_meta(_random.generator(self.device)))
        return meta

    def save_state(self, target, epoch=None, nbatch=None, background=True):
        """Write a resumable checkpoint through
        :mod:`~mxnet_tpu_torch.checkpoint`: the tensors are cloned behind
        the queued steps (no host sync), the copy to the host and the
        files go to a writer thread when ``background``.  ``target`` is a
        ``CheckpointManager`` or a directory.  Returns the write handle
        (None when the manager skipped the snapshot)."""
        from . import checkpoint as _ckpt

        self._require_init("save_state")
        meta = self._checkpoint_meta(epoch=epoch, nbatch=nbatch)
        arrays = self._checkpoint_arrays()
        if isinstance(target, _ckpt.CheckpointManager):
            return target.save(self._step, arrays, meta=meta,
                               background=background)
        return _ckpt.save(str(target), self._step, arrays, meta=meta,
                          background=background)

    def restore_state(self, source):
        """Restore a survival checkpoint (of either package) into this
        initialised trainer, in place (a captured step stays valid):
        checksums and the graph's signature are checked, conv weights
        the JAX trainer stored HWIO are relaid to OIHW, the step cursor
        and this package's generator state come back.  ``source`` is a
        checkpoint, a directory of them (the newest complete one) or a
        ``CheckpointManager``.  Returns the manifest's meta."""
        from . import checkpoint as _ckpt

        self._require_init("restore_state")
        if isinstance(source, _ckpt.CheckpointManager):
            path = source.latest()
        elif os.path.exists(os.path.join(str(source), _ckpt.MANIFEST)):
            path = str(source)
        else:
            path = _ckpt.latest(str(source))
        if path is None:
            raise _ckpt.CheckpointError(
                f"no complete checkpoint found under {source!r}")
        arrays, manifest = _ckpt.load(path)
        meta = manifest.get("meta", {})
        sig = self.structural_signature()
        saved_sig = meta.get("signature")
        if saved_sig is not None and saved_sig != sig:
            raise _ckpt.CheckpointError(
                f"checkpoint {path!r} was saved from a different graph "
                f"(signature {saved_sig[:16]}... vs bound {sig[:16]}...); "
                "refusing to load mismatched weights")
        saved_hwio = set(meta.get("hwio", ()))

        def put(name, key, dst, relayout):
            if name not in arrays:
                raise _ckpt.CheckpointError(
                    f"checkpoint {path!r} lacks {name!r} (a different "
                    "optimizer?)")
            host = arrays[name]
            if relayout and host.ndim == 4 and key in saved_hwio:
                host = np.transpose(host, (3, 2, 0, 1))  # HWIO -> OIHW
            if tuple(host.shape) != tuple(dst.shape):
                raise _ckpt.CheckpointError(
                    f"checkpoint {path!r}: {name} has shape {host.shape}, "
                    f"the trainer {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.ascontiguousarray(host)))

        with torch.no_grad():
            for k, v in self.params.items():
                put("param/" + k, k, v, True)
            for k, v in self.aux.items():
                put("aux/" + k, k, v, False)
            for k, slots in self.opt_state.items():
                for i, sl in enumerate(slots):
                    put(f"opt/{k}/{i}", k, sl, True)
        if meta.get("step") is not None:
            self._step = int(meta["step"])
        _ckpt.restore_generator(_random.generator(self.device), meta)
        self._refresh_compute_cache()
        if _tm.enabled():
            _ckpt._TM_RESUME.inc(status="ok")
        return meta

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        background=False):
        """``prefix-symbol.json`` and ``prefix-%04d.params`` (the Module
        format; conv weights in logical OIHW), plus the reference's
        FusedTrainer ``.states`` file (``key:slot`` arrays and
        ``__step__``) when ``save_optimizer_states``.  ``background``
        snapshots now and writes on a thread, which is returned (join it
        with :meth:`wait_checkpoint`)."""
        from . import checkpoint as _ckpt
        from . import model as _model
        from . import ndarray as nd_mod

        self._require_init("save_checkpoint")
        arrays = self._checkpoint_arrays()
        if not save_optimizer_states:
            arrays = {k: v for k, v in arrays.items()
                      if not k.startswith("opt/")}
        step = self._step
        snap = _ckpt.snapshot(arrays)

        def _write():
            host = snap.host()
            arg = {k[6:]: v for k, v in host.items()
                   if k.startswith("param/")}
            aux = {k[4:]: v for k, v in host.items() if k.startswith("aux/")}
            _model.save_checkpoint(prefix, epoch, self.symbol, arg, aux)
            if save_optimizer_states:
                flat = {"__step__": np.array([step], np.int64)}
                for k, v in host.items():
                    if k.startswith("opt/"):
                        name, i = k[4:].rsplit("/", 1)
                        flat[f"{name}:{i}"] = v
                nd_mod.save("%s-%04d.states" % (prefix, epoch), flat)

        if not background:
            _write()
            return None
        import threading

        def _runner():
            try:
                _write()
            except BaseException as e:  # noqa: BLE001 — surfaced in join
                thread.exc = e

        thread = threading.Thread(target=_runner, daemon=False,
                                  name="mxtt-ckpt-writer")
        thread.exc = None
        thread.start()
        return thread

    @staticmethod
    def wait_checkpoint(thread):
        """Join a background :meth:`save_checkpoint` and re-raise its
        error."""
        if thread is None:
            return
        thread.join()
        if getattr(thread, "exc", None) is not None:
            raise thread.exc

    def load_checkpoint(self, prefix, epoch, load_optimizer_states=False):
        """Restore what :meth:`save_checkpoint` (of either package) wrote
        into this initialised trainer, in place; a missing parameter,
        aux state or optimizer slot raises."""
        from . import model as _model
        from . import ndarray as nd_mod

        self._require_init("load_checkpoint")
        _, arg, aux = _model.load_checkpoint(prefix, epoch, ctx="cpu")
        for have, got, what in ((self.params, arg, "params"),
                                (self.aux, aux, "aux states")):
            missing = set(have) - set(got)
            if missing:
                raise MXNetError(f"checkpoint {prefix!r} lacks {what} "
                                 f"{sorted(missing)[:5]}...")
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(arg[k].tensor)
            for k, v in self.aux.items():
                v.copy_(aux[k].tensor)
            if load_optimizer_states:
                spath = "%s-%04d.states" % (prefix, epoch)
                flat = nd_mod.load(spath, ctx="cpu")
                step = flat.pop("__step__", None)
                if step is not None:
                    self._step = int(step.asnumpy()[0])
                for k, slots in self.opt_state.items():
                    for i, sl in enumerate(slots):
                        got = flat.get(f"{k}:{i}")
                        if got is None:
                            raise MXNetError(
                                f"optimizer state {k}:{i} missing from "
                                f"{spath!r} (different optimizer, or a "
                                "truncated save?)")
                        sl.copy_(got.tensor.reshape(sl.shape))
        self._refresh_compute_cache()

    # ------------------------------------------------------- not ported
    def rebind_mesh(self, *args, **kwargs):
        raise _not_ported("rebind_mesh", "10b")
