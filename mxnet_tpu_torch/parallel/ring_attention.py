"""Single-device attention dispatch (mirrors
``mxnet_tpu/parallel/ring_attention.py:138-203``).

Only :func:`full_attention`, :func:`attention` and :func:`_env_block`
are ported; the ring itself (K/V rotation over a mesh) waits for ROADMAP
Queue 1 item 10.
"""
from __future__ import annotations

import math
import os
import warnings

import torch

__all__ = ["full_attention", "attention"]


def full_attention(q, k, v, causal=False, scale=None):
    """Reference attention that materialises the ``(T, T)`` scores, with
    the JAX package's dtypes: the scores come out of the product in q's
    dtype and are scaled in fp32 (the JAX code multiplies by a numpy
    float64 scale, which promotes bf16 to fp32), so bf16 inputs give an
    fp32 softmax and an fp32 result; masked scores are -inf."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        t = s.shape[-1]
        mask = torch.ones(s.shape[-2], t, dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(p.dtype))


def attention(q, k, v, causal=False, scale=None, impl="auto"):
    """Single-device attention dispatcher.

    ``impl="auto"``: on CUDA tensors the hand-written flash kernels
    (``ops/flash_attention.py``) where ``supports()`` takes the shape
    with the ``MXTPU_FLASH_BLOCK_Q/K`` tiles (default 128, clamped to
    T), else :func:`full_attention`; CPU tensors take the flash kernels'
    plain versions, whatever the shape.  ``impl="flash"`` (or the JAX
    package's ``"flash_interpret"``) always takes the flash path and
    raises on a shape the gate refuses; anything else (``"lax"``) takes
    :func:`full_attention`, as in the JAX package."""
    from ..ops import flash_attention as fa

    bq = min(_env_block("MXTPU_FLASH_BLOCK_Q"), q.shape[2])
    bk = min(_env_block("MXTPU_FLASH_BLOCK_K"), q.shape[2])
    if impl == "auto":
        if q.device.type in ("cpu", "meta"):
            # the plain versions take any shape: the gate only concerns
            # the CUDA kernels
            return fa.apply(q, k, v, causal, scale)
        impl = "flash" if fa.supports(q.shape, bq, bk) else "lax"
    if impl in ("flash", "flash_interpret"):
        return fa.flash_attention(q, k, v, causal, scale, bq, bk)
    return full_attention(q, k, v, causal=causal, scale=scale)


def _env_block(name, default=128):
    """Tile-size env knob: malformed or non-positive values fall back to
    the default with a warning instead of crashing unrelated paths."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        val = int(raw)
    except ValueError:
        val = 0
    if val <= 0:
        warnings.warn(f"{name}={raw!r} is not a positive integer; "
                      f"using {default}", stacklevel=3)
        return default
    return val
