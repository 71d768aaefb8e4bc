"""Predict-only inference API (the port of ``mxnet_tpu/predict.py``).

The ``MXPredCreate`` / ``SetInput`` / ``Forward`` / ``GetOutput``
lifecycle of the reference's C predict ABI in one object, over the
port's Symbol, graph passes and Executor.  The JAX Predictor is one
jitted program per forward; here the forward is the graph interpreter
running eagerly on the card, the weights already in the compute dtype
and, under the default layout, channels-last.

A deployment loads a checkpoint: :func:`create` reads the
``prefix-symbol.json`` / ``prefix-%04d.params`` pair that
``model.save_checkpoint`` (of either package) writes, and
``param_bytes=`` takes the bytes of such a ``.params`` file (npz, or the
reference's ``0x112`` binary), as the C ABI's ``MXPredCreate`` does.

``output_index`` cuts the graph at internal outputs and
``partial_forward`` runs it up to one (``MXPredCreatePartialOut`` /
``MXPredPartialForward``); ``quantize="int8"`` keeps the matmul and conv
weights as int8 + per-channel scales on the device
(``serving/quantize.py``); ``forward_async``/``get_async`` pipeline
forwards against their copy-outs.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from . import symbol as sym_mod
from . import telemetry as _tm
from .base import MXNetError, torch_dtype
from .context import gpu, resolve_device

__all__ = ["Predictor", "create"]


# forward_async tickets kept before the oldest is evicted (a pipelined
# client holds a handful; an abandoned ticket must not pin device memory)
MAX_IN_FLIGHT = 64


def _cut(symbol, output_index):
    """``symbol`` cut at internal outputs: ``output_index`` is an index
    or a name of ``get_internals()``'s outputs, or a list of them."""
    internals = symbol.get_internals()
    names = internals.list_outputs()
    picked = []
    for sel in (output_index if isinstance(output_index, (list, tuple))
                else [output_index]):
        if isinstance(sel, str):
            if sel not in names:
                raise MXNetError(f"unknown output {sel!r}; internals: "
                                 f"{names}")
            picked.append(internals[names.index(sel)])
        elif isinstance(sel, int):
            picked.append(internals[sel])
        else:
            raise MXNetError(
                f"output_index entries must be int or str, got {sel!r}")
    return picked[0] if len(picked) == 1 else sym_mod.Group(picked)


def _device(dev_type, dev_id):
    """``None`` -> the card; ``"cpu"``; ``"gpu"``/``"cuda"`` -> card
    ``dev_id``; a ``torch.device`` passes through."""
    if isinstance(dev_type, str) and dev_type.lower() in ("gpu", "cuda"):
        return resolve_device(gpu(dev_id))
    return resolve_device(dev_type)


class Predictor:
    """A bound inference graph: construct, ``forward(data=...)``,
    ``get_output(0)``.

    ``arg_params``/``aux_params`` may hold numpy arrays, torch tensors,
    the port's NDArrays, or the JAX package's NDArrays and arrays;
    ``param_bytes`` (used when ``arg_params`` is not given) is the
    content of a ``.params`` file, split into both by its ``arg:``/
    ``aux:`` prefixes.  Before the bind the
    Conv+BN fold (``passes.apply_convbn_fold``) folds every frozen
    BatchNorm behind a conv into the conv's weight and a new
    ``<conv>_bias``; the bind then runs the graph passes
    (``MXTPU_GRAPH_PASSES=0`` turns both off).  Label arguments
    (``softmax_label``, any ``*_label``) left out of ``input_shapes`` get
    inferred shapes and are bound to zeros; any other argument that is
    neither a param nor an input raises.

    ``dtype``: ``None`` (the checkpoint's precision, fp32) or
    ``"bfloat16"`` (``MXTPU_PREDICT_DTYPE`` sets it when the argument is
    not given): fp32 params, aux states and inputs are cast to bf16 —
    the weights once here, the inputs on the device after upload — and
    the outputs are cast back to fp32.  ``dev_type`` defaults to the card (the JAX
    Predictor defaults to the CPU); ``"cpu"`` runs on the host.

    ``quantize="int8"`` (or ``MXTPU_PREDICT_INT8=1``): after the fold,
    every float 2-D or 4-D ``*weight`` is quantized per output channel
    (``serving.quantize.quantize_per_channel``, from the folded fp32
    values); the device keeps the int8 payload and its fp32 scales, and
    each forward dequantizes them in the compute dtype
    (``q.to(dtype) * scale``) for the convolutions and matmuls.  The
    fp32 copies of those weights move to the host (``reshape`` and
    ``partial_forward`` read them).  ``output_index`` cuts the graph at
    ``get_internals()`` outputs (an index, a name, or a list), before
    the fold."""

    def __init__(self, symbol_json_str=None, param_bytes=None,
                 input_shapes=None, dev_type=None, dev_id=0, symbol=None,
                 arg_params=None, aux_params=None, output_index=None,
                 dtype=None, quantize=None):
        from .executor import simple_bind
        from .passes import apply_convbn_fold

        if quantize is None and os.environ.get(
                "MXTPU_PREDICT_INT8", "0").lower() not in ("", "0", "false"):
            quantize = "int8"
        if quantize not in (None, "int8"):
            raise MXNetError(f"unknown quantize mode {quantize!r} "
                             "(supported: 'int8')")
        if symbol is None:
            if symbol_json_str is None:
                raise MXNetError("need symbol or symbol_json_str")
            symbol = sym_mod.load_json(symbol_json_str)
        if output_index is not None:
            # the cut comes before the Conv+BN fold, as in the reference:
            # the names and indices are those of the checkpoint's graph
            symbol = _cut(symbol, output_index)
        device = _device(dev_type, dev_id)
        if arg_params is None and param_bytes is not None:
            from .model import split_params
            from .ndarray import load_frombuffer

            # host NDArrays: the fold reads them there, and the bind
            # copies each once to the device
            arg_params, aux_params = split_params(
                load_frombuffer(param_bytes, "cpu"))
        arg_params = dict(arg_params or {})
        aux_params = dict(aux_params or {})

        # inference-mode Conv+BN folding before the bind (passes/convbn.py)
        symbol, arg_params, aux_params, self._n_bn_folded = \
            apply_convbn_fold(symbol, arg_params, aux_params)
        self.symbol = symbol
        self._input_names = [n for n in symbol.list_arguments()
                             if n not in arg_params]
        input_shapes = {k: tuple(v) for k, v in (input_shapes or {}).items()}
        missing = [n for n in self._input_names if n not in input_shapes]
        # label-style args (softmax_label) are not fed at inference: bind
        # zeros of their inferred shapes.  Any other argument the params
        # and input_shapes leave out is a weight the checkpoint lacks.
        # (The JAX Predictor binds zeros to every such argument, so a
        # missing weight there computes silently; the port refuses it.)
        label_args = {n for n in missing
                      if n == "label" or n.endswith("_label")}
        uncovered = [n for n in missing if n not in label_args]
        if uncovered:
            raise MXNetError(
                f"params cover no value for {uncovered[:5]} (corrupt or "
                "truncated checkpoint, name mismatch, or an input missing "
                "from input_shapes)")
        if label_args:
            arg_shapes, _, _ = symbol.infer_shape(**input_shapes)
            if arg_shapes is None:
                raise MXNetError(f"cannot infer the shapes of "
                                 f"{sorted(label_args)} from {input_shapes}")
            inferred = dict(zip(symbol.list_arguments(), arg_shapes))
            for n in label_args:
                input_shapes[n] = inferred[n]
            self._input_names = [n for n in self._input_names
                                 if n not in label_args]
        self._label_args = label_args
        self._exec = simple_bind(symbol, device, grad_req="null",
                                 **input_shapes)
        self._exec.copy_params_from(arg_params, aux_params,
                                    allow_extra_params=True)

        if dtype is None:
            dtype = os.environ.get("MXTPU_PREDICT_DTYPE") or None
        self._dtype = dtype
        cast = None if dtype is None else torch_dtype(dtype)
        self._cast = None if cast in (None, torch.float32) else cast

        def compute(t):
            return t.to(self._cast) if (self._cast is not None
                                        and t.dtype == torch.float32) else t

        # the weights never change after construction (reshape builds a
        # new Predictor): cast them once; the inputs are the only
        # tensors a forward writes
        self._quantize = quantize
        self._qparams = {}
        if quantize == "int8":
            self._quantize_weights()
        self._params = {k: compute(v) for k, v in self._exec.arg_dict.items()
                        if k not in self._qparams}
        self._aux = {k: compute(v) for k, v in self._exec.aux_dict.items()}
        self._staged = {}   # input name -> (pinned buffer, upload event)
        self._outs = None
        self._dirty = True
        self._inflight = {}     # ticket -> [(host buffer, copy event)]
        self._inflight_lock = threading.Lock()
        self._ticket = 0
        self._copy_stream = None

    def _quantize_weights(self):
        """Move the bound float 2-D/4-D ``*weight`` params into
        ``self._qparams`` as int8 + fp32 scales on the device, their fp32
        values onto the host."""
        from .serving.quantize import (QuantizedTensor, _host,
                                       default_weight_filter,
                                       quantize_per_channel)

        dq = self._cast or torch.float32
        for k, v in list(self._exec.arg_dict.items()):
            if k in self._input_names or k in self._label_args \
                    or not default_weight_filter(k, v):
                continue
            q, scale = quantize_per_channel(_host(v), axis=0)
            q = torch.from_numpy(q).to(v.device)
            if v.ndim == 4 and v.is_contiguous(
                    memory_format=torch.channels_last):
                q = q.contiguous(memory_format=torch.channels_last)
            self._qparams[k] = QuantizedTensor(
                q, torch.from_numpy(scale).to(v.device), dtype=dq)
            self._exec.arg_dict[k] = v.cpu()

    # ------------------------------------------------------------------ API
    @property
    def device(self) -> torch.device:
        return self._exec.device

    def set_input(self, name, value):
        """Copy ``value`` (numpy array or tensor) into the bound input
        ``name``.  A host array crosses to the card as it is (fp32, in its
        own layout) through a pinned staging buffer, without waiting for
        the card, and is cast and laid out channels-last there: asked to
        do both at once, ``copy_`` would convert on the host first."""
        if name not in self._input_names:
            raise MXNetError(f"unknown input {name}; inputs: "
                             f"{self._input_names}")
        dst = self._params[name]
        src = value if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise MXNetError(f"shape mismatch for {name}: got "
                             f"{tuple(src.shape)}, bound {tuple(dst.shape)}")
        if dst.is_cuda and not src.is_cuda:
            src = self._stage(name, src).to(dst.device, non_blocking=True)
            # the staging buffer may be refilled once this copy is done
            self._staged[name][1].record()
        dst.copy_(src)
        self._dirty = True

    def _stage(self, name, src):
        """``src`` in the pinned host buffer of input ``name``, after the
        previous upload out of that buffer has finished."""
        buf, done = self._staged.get(name, (None, None))
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            done = torch.cuda.Event()
            self._staged[name] = (buf, done)
        else:
            done.synchronize()
        buf.copy_(src)
        return buf

    def forward(self, **inputs):
        """Set ``inputs`` and run the graph.  The outputs stay on the
        device: nothing here waits for the card; :meth:`get_output`
        copies out.  With telemetry on, the graph's dispatch is an
        ``executor_forward_seconds`` observation (the JAX Predictor's
        one-program forward records none)."""
        for name, value in inputs.items():
            self.set_input(name, value)
        params = self._params
        if self._qparams:
            params = dict(params)
            params.update((k, qt.dequantize())
                          for k, qt in self._qparams.items())
        t0 = time.perf_counter() if _tm.enabled() else None
        with torch.no_grad():
            outs, _ = self._exec._graph_fn(params, self._aux, None, False)
        if self._cast is not None:
            outs = [o.float() if o.dtype == self._cast else o for o in outs]
        self._outs = outs
        self._dirty = False
        if t0 is not None:
            from .executor import _TM_FWD_SEC

            _TM_FWD_SEC.observe(time.perf_counter() - t0)

    def get_output(self, index=0) -> np.ndarray:
        """Output ``index`` as a host array (a blocking copy-out)."""
        if self._dirty:
            self.forward()
        return self._outs[index].detach().cpu().numpy()

    def get_output_shape(self, index=0):
        """Output ``index``'s shape, before the first forward too (C
        clients size their buffers with it)."""
        if self._outs is not None:
            return tuple(self._outs[index].shape)
        shapes = {n: tuple(self._params[n].shape) for n in self._input_names}
        _, out_shapes, _ = self.symbol.infer_shape(**shapes)
        return tuple(out_shapes[index])

    @property
    def num_outputs(self):
        return len(self.symbol.list_outputs())

    def reshape(self, input_shapes):
        """Rebind with new input shapes on the same device and dtype (the
        folded params carry over)."""
        arg_params = {k: v for k, v in self._exec.arg_dict.items()
                      if k not in self._input_names
                      and k not in self._label_args}
        new = Predictor(symbol=self.symbol, arg_params=arg_params,
                        aux_params=dict(self._exec.aux_dict),
                        input_shapes=input_shapes, dev_type=self.device,
                        dtype=self._dtype, quantize=self._quantize)
        self.__dict__.update(new.__dict__)

    def forward_async(self, **inputs):
        """Run a forward and start copying its outputs out, without
        waiting; returns a ticket for :meth:`get_async`.  On the card
        the copies run on a side stream into pinned host buffers, each
        with its own event, so consecutive calls pipeline each one's
        copy-out against the next one's compute, and ``get_async`` waits
        for its own output only.  At most :data:`MAX_IN_FLIGHT` (64)
        tickets are kept, the oldest evicted first.  ``get_output``
        afterwards reads this forward (the latest)."""
        self.forward(**inputs)
        outs = list(self._outs)
        if outs and outs[0].is_cuda:
            dev = outs[0].device
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(dev)
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream(dev))
            entries = []
            with torch.cuda.stream(stream):
                for o in outs:
                    host = torch.empty(o.shape, dtype=o.dtype,
                                       pin_memory=True)
                    host.copy_(o, non_blocking=True)
                    o.record_stream(stream)
                    done = torch.cuda.Event()
                    done.record(stream)
                    entries.append((host, done))
        else:
            entries = [(o, None) for o in outs]
        with self._inflight_lock:
            self._ticket += 1
            ticket = self._ticket
            self._inflight[ticket] = entries
            while len(self._inflight) > MAX_IN_FLIGHT:
                self._inflight.pop(next(iter(self._inflight)))
        return ticket

    def get_async(self, ticket, index=0) -> np.ndarray:
        """Output ``index`` of a :meth:`forward_async` ticket as a host
        array, after its own copy has finished.  Each output is
        fetchable once; the ticket retires with its last output (or
        through :meth:`discard_async`)."""
        with self._inflight_lock:
            entries = self._inflight.get(ticket)
            if entries is None:
                raise MXNetError(
                    f"unknown or already-retired ticket {ticket}")
            if not 0 <= index < len(entries) or entries[index] is None:
                raise MXNetError(
                    f"ticket {ticket}: output {index} is out of range or "
                    f"already fetched ({len(entries)} outputs)")
            (host, done), entries[index] = entries[index], None
            if all(e is None for e in entries):
                del self._inflight[ticket]
        if done is not None:
            done.synchronize()
        return host.detach().float().numpy() if host.dtype != torch.float32 \
            else host.detach().numpy()

    def discard_async(self, ticket):
        """Drop an in-flight ticket without fetching it; an unknown
        ticket is a no-op."""
        with self._inflight_lock:
            self._inflight.pop(ticket, None)

    def partial_forward(self, step):
        """Output ``step`` of ``get_internals()`` of the bound (folded)
        graph, as host arrays: the graph cut there, bound on the same
        device with the same params and inputs, run once
        (``MXPredPartialForward``; ``step`` past the end is the last
        internal output).  A step that names a variable returns its
        bound value."""
        from .executor import simple_bind

        internals = self.symbol.get_internals()
        sub = internals[min(step, len(internals.list_outputs()) - 1)]
        # every argument's bound shape: an internal output that is a
        # variable (a weight, a label) then binds too (the JAX Predictor
        # passes the input shapes only and fails on those)
        shapes = {n: tuple(self._exec.arg_dict[n].shape)
                  for n in sub.list_arguments() if n in self._exec.arg_dict}
        ex = simple_bind(sub, self.device, grad_req="null", **shapes)
        ex.copy_params_from(
            {k: v for k, v in self._exec.arg_dict.items()
             if k not in self._input_names},
            dict(self._exec.aux_dict), allow_extra_params=True)
        inputs = {n: self._params[n] for n in self._input_names
                  if n in ex.arg_dict}
        outs = ex.forward(is_train=False, **inputs)
        return [o.detach().float().cpu().numpy() for o in outs]


def create(prefix, epoch, input_shapes, dev_type=None, dev_id=0, dtype=None,
           quantize=None):
    """A Predictor over the checkpoint ``prefix``/``epoch`` that
    ``model.save_checkpoint`` wrote (the common ``MXPredCreate`` use).
    The params are read to the host and copied once to the device."""
    from .model import load_checkpoint

    symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                     ctx="cpu")
    return Predictor(symbol=symbol, arg_params=arg_params,
                     aux_params=aux_params, input_shapes=input_shapes,
                     dev_type=dev_type, dev_id=dev_id, dtype=dtype,
                     quantize=quantize)
