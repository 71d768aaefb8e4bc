"""Sequence ops of the port (``mxnet_tpu/ops/sequence.py``):
``SequenceLast``, ``SequenceMask`` and ``SequenceReverse`` over
time-major ``(T, N, ...)`` data, with the optional ``sequence_length``
input when ``use_sequence_length`` is set.  Gathers and selects on the
device: no length is read on the host.  A length outside ``[1, T]``
reads as the JAX gather reads it (clamped to the time axis, with no
gradient through the clamped step)."""
from __future__ import annotations

import torch

from ..base import parse_attr, parse_bool
from .indexing import jax_gather
from .registry import register


def _seq_optional(attrs):
    if parse_bool(attrs.get("use_sequence_length", False)):
        return set()
    return {"sequence_length"}


def _steps(data):
    """``(T, 1)`` time indices and ``(1, N)`` batch indices."""
    return (torch.arange(data.shape[0], device=data.device)[:, None],
            torch.arange(data.shape[1], device=data.device)[None, :])


def _gather_time(data, idx):
    """``data[idx[t, n], n]`` for a ``(T', N)`` index, as a JAX gather
    reads it (:func:`~.indexing.jax_gather`)."""
    t = data.shape[0]
    idx = torch.where(idx < 0, idx + t, idx)
    out = data[idx.clamp(0, t - 1), _steps(data)[1].expand_as(idx)]
    return jax_gather(out, (idx >= 0) & (idx < t))


@register("SequenceLast", arg_names=("data", "sequence_length"),
          optional_args=_seq_optional)
def _sequence_last(ctx, data, sequence_length=None, **attrs):
    """The last step of each sequence: ``data[length - 1, n]``."""
    if sequence_length is None:
        return data[-1]
    idx = sequence_length.to(torch.int32).long() - 1
    return _gather_time(data, idx[None, :])[0]


@register("SequenceMask", arg_names=("data", "sequence_length"),
          optional_args=_seq_optional)
def _sequence_mask(ctx, data, sequence_length=None, **attrs):
    """Steps at or past each sequence's length set to ``value``."""
    if sequence_length is None:
        return data + 0
    value = float(parse_attr(attrs.get("value", 0.0)))
    steps, _ = _steps(data)
    mask = steps < sequence_length.to(torch.int32)[None, :]
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("SequenceReverse", arg_names=("data", "sequence_length"),
          optional_args=_seq_optional)
def _sequence_reverse(ctx, data, sequence_length=None, **attrs):
    """Each sequence's first ``length`` steps reversed, the rest kept."""
    if sequence_length is None:
        return torch.flip(data, (0,))
    lengths = sequence_length.to(torch.int32).long()[None, :]
    steps, _ = _steps(data)
    rev = torch.where(steps < lengths, lengths - 1 - steps, steps)
    return _gather_time(data, rev)
