"""Post-training int8 weight quantization, in PyTorch.

The port of ``mxnet_tpu/serving/quantize.py``.  Weights are stored as
**int8 tensors + per-channel fp32 scales** on the device and dequantized
where they are consumed: ``q.to(dtype) * scale``, then the matmul or
gather that reads the weight, inside each decode step or forward.  The
device holds int8 (a quarter of fp32, half of bf16); compute stays in
the compute dtype, and the symmetric per-channel scales bound the
per-weight error at ``max|w|/254`` per channel.

Scheme: per-channel symmetric.  For a weight ``w`` with output channels
on ``axis`` (axis 0 for both ``FullyConnected`` ``(out, in)`` and conv
``(O, I, kH, kW)``), ``scale_c = max|w_c| / 127`` and ``q =
rint(w / scale)`` (round half to even) clipped to [-127, 127]; rows that
are all zero get scale 1.  The arithmetic is numpy's, as in the JAX
package, so ``q`` and ``scale`` are bit-equal across the two packages.

:class:`QuantizedTensor` is what :class:`~mxnet_tpu_torch.models.decode.
KVDecoder` and the Predictor hold in place of a quantized weight.  An
embedding table (one scale per row) is read through
:meth:`QuantizedTensor.rows`: gathering int8 rows and scaling them gives
the values of the dequantized table at those rows, without
dequantizing the rest.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import torch_dtype
from ..context import resolve_device

__all__ = ["QuantizedTensor", "quantize_per_channel", "quantize_params",
           "default_weight_filter", "prepare_inference_params"]


class QuantizedTensor:
    """int8 payload ``q`` + fp32 ``scale`` (shaped to broadcast against
    ``q``), dequantized to ``dtype`` on read."""

    __slots__ = ("q", "scale", "dtype", "axis")

    def __init__(self, q, scale, dtype=torch.float32, axis=0):
        self.q = q
        self.scale = scale
        self.dtype = torch_dtype(dtype)
        self.axis = axis

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def nbytes(self):
        return int(np.prod(self.shape)) + 4 * int(np.prod(
            tuple(self.scale.shape)))

    def dequantize(self):
        """The whole weight in ``dtype``: ``q.to(dtype) * scale``, with
        the scale rounded to ``dtype`` first, as the JAX package's
        ``q.astype(dtype) * scale.astype(dtype)``."""
        return self.q.to(self.dtype) * self.scale.to(self.dtype)

    def rows(self, idx):
        """Rows ``idx`` of the dequantized weight (axis 0 scales only):
        the rows of ``q`` and of ``scale`` are gathered first."""
        return self.q[idx].to(self.dtype) * self.scale[idx].to(self.dtype)

    def __repr__(self):
        return (f"QuantizedTensor(shape={self.shape}, axis={self.axis}, "
                f"dtype={str(self.dtype).replace('torch.', '')})")


def quantize_per_channel(w, axis=0):
    """``w`` (numpy, any float dtype) -> (int8 q, fp32 scale) with the
    scale shaped to broadcast against ``w`` (size-1 on every axis but
    ``axis``)."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.abs(w).max(axis=reduce_axes, keepdims=True) \
        if reduce_axes else np.abs(w)
    scale = amax / 127.0
    scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _host(arr):
    """A param as a host numpy array: tensors (bf16 through fp32),
    NDArrays of either package, JAX and numpy arrays."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(arr.asnumpy() if hasattr(arr, "asnumpy") else arr)


def _dtype_kind(arr):
    if isinstance(arr, torch.Tensor):
        return "f" if arr.is_floating_point() else "i"
    return np.dtype(getattr(arr, "dtype", np.float32)).kind


def default_weight_filter(name, arr):
    """The weights the pass touches by default: float 2-D matmul /
    embedding tables and 4-D conv kernels named ``*weight`` (biases,
    norms and positional tables stay in floating point)."""
    if not name.endswith("weight"):
        return False
    if _dtype_kind(arr) != "f":
        return False
    return len(getattr(arr, "shape", ())) in (2, 4)


def quantize_params(params, dtype=torch.float32, weight_filter=None,
                    device_put=True, device=None):
    """Quantize a name->array dict.  Returns a new dict where every
    filtered entry is a :class:`QuantizedTensor` and everything else
    passes through untouched.  With ``device_put`` (the default) ``q``
    and ``scale`` are tensors on ``device`` (default: the card);
    otherwise they stay numpy arrays."""
    weight_filter = weight_filter or default_weight_filter
    dev = resolve_device(device) if device_put else None
    out = {}
    for name, arr in params.items():
        if not weight_filter(name, arr):
            out[name] = arr
            continue
        q, scale = quantize_per_channel(_host(arr), axis=0)
        if device_put:
            q = torch.from_numpy(q).to(dev)
            scale = torch.from_numpy(scale).to(dev)
        out[name] = QuantizedTensor(q, scale, dtype=dtype)
    return out


def prepare_inference_params(symbol, arg_params, aux_params, quantize="int8",
                             dtype=torch.float32, weight_filter=None,
                             device_put=True, device=None):
    """Rewrite (symbol, params) for serving: Conv+BN fold, THEN int8.

    The fold multiplies each conv's weight rows by the BN scale, so the
    per-channel scales must be computed from the FOLDED weights.
    ``Predictor(quantize="int8")`` does the same internally; this is
    the explicit form for code that manages its own executors.

    Returns ``(symbol, params, aux_params, n_folded)``; ``quantize=None``
    skips the int8 step and returns the folded params."""
    from ..passes import apply_convbn_fold

    symbol, arg_params, aux_params, n_folded = apply_convbn_fold(
        symbol, arg_params, aux_params)
    if quantize == "int8":
        arg_params = quantize_params(arg_params, dtype=dtype,
                                     weight_filter=weight_filter,
                                     device_put=device_put, device=device)
    return symbol, arg_params, aux_params, n_folded
