"""Sequence parallelism and the single-device attention dispatch
(mirrors ``mxnet_tpu/parallel/ring_attention.py``).

Sequences shard over a mesh axis (``seq``; ``batch_axis`` adds a
data-parallel split of the batch, dp x sp) and attention runs either as

- :func:`ring_attention`: K/V blocks rotate around the axis's ring
  (:func:`~.dist.ppermute`: one ``all_to_all_single`` with uneven
  splits) while each rank streams an online-softmax accumulation
  over them, or
- :func:`ulysses_attention`: an all-to-all re-shards seq -> heads, each
  rank runs full-sequence attention on its heads, and a second
  all-to-all shards back.

Both are exact and differentiable: the rotation is the reference's
``ppermute``, whose backward rotates the other way, and the all-to-all
is ``torch.distributed.nn``'s, whose backward is the inverse exchange.
They are plain PyTorch math, as the reference's are plain ``jnp``: no
kernel of the port runs in them.
Their inputs are DTensors (placed as the spec says, or redistributed
to it) or full tensors every rank holds (each rank keeps its block);
the result is a DTensor placed on ``(batch_axis, None, axis_name,
None)``.

:func:`full_attention` is the oracle, :func:`attention` the
single-device dispatcher the ``FlashAttention`` op calls.
"""
from __future__ import annotations

import math
import os
import warnings

import torch

from . import dist as _dist

__all__ = ["full_attention", "attention", "ring_attention",
           "ulysses_attention"]


def _stream_block(q, k, v, m, l, o, scale, mask=None):
    """One online-softmax accumulation step (blockwise attention's inner
    op).  q: (B, H, Tq, D), k/v: (B, H, Tk, D); m/l: (B, H, Tq); o the
    accumulator.  Fully masked rows (max -inf) are guarded as in the
    reference."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, s.amax(-1))
    finite = torch.isfinite(m_new)
    m_safe = torch.where(finite, m_new, torch.zeros_like(m_new))
    corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                 torch.full_like(m, float("-inf"))))
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, o_new


def _group_layout(group):
    """(this rank's index in ``group``, the group's global ranks)."""
    import torch.distributed as td

    ranks = td.get_process_group_ranks(group)
    return ranks.index(td.get_rank()), ranks


def _placed(x, sharding):
    """``x`` as a DTensor placed by ``sharding``: a DTensor is
    redistributed, a full tensor every rank holds keeps this rank's block
    (a differentiable slice)."""
    from . import mesh as _mesh

    if _mesh.is_dtensor(x):
        return x.redistribute(sharding.mesh.device_mesh, sharding.placements)
    return _mesh.from_block(_mesh.narrow_local(x, sharding),
                            sharding.mesh.device_mesh, sharding.placements,
                            x.shape)


def _seq_parallel(local_fn, q, k, v, mesh, axis_name, batch_axis):
    from . import mesh as _mesh

    sh = _mesh.NamedSharding(mesh, (batch_axis, None, axis_name, None))
    q, k, v = (_placed(x, sh) for x in (q, k, v))
    group = mesh.get_group(axis_name)
    return _mesh.local_map(
        lambda a, b, c: local_fn(a, b, c, group),
        out_placements=(sh.placements,),
        in_placements=(sh.placements,) * 3,
        device_mesh=mesh.device_mesh)(q, k, v)


def ring_attention(q, k, v, mesh, axis_name: str = "seq",
                   causal: bool = False, scale: float = None,
                   batch_axis: str = None):
    """Exact attention over sequence-sharded q/k/v.

    q, k, v: (B, H, T_global, D), sharded over T on ``axis_name``.
    Returns the output with the same sharding (a DTensor).
    ``batch_axis`` additionally shards B over a second mesh axis — the
    standard dp x sp long-context layout (each data-parallel replica
    runs its own ring)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    def local_fn(q, k, v, group):
        # the local shards (B_local, H, T/n, D)
        idx, ranks = _group_layout(group)
        n = len(ranks)
        b, h, t_local, _ = q.shape
        m = torch.full((b, h, t_local), float("-inf"), dtype=q.dtype,
                       device=q.device)
        l = torch.zeros((b, h, t_local), dtype=q.dtype, device=q.device)
        o = torch.zeros_like(q)
        pos = torch.arange(t_local, device=q.device)
        q_pos = idx * t_local + pos
        kv = torch.stack([k, v])
        for step in range(n):
            src = (idx - step) % n        # whose K/V block this rank holds
            mask = (q_pos[:, None] >= (src * t_local + pos)[None, :]
                    if causal else None)
            m, l, o = _stream_block(q, kv[0], kv[1], m, l, o, scale, mask)
            if step + 1 < n:              # pass K/V to the next rank
                kv = _dist.ppermute(kv, group,
                                    [(i, (i + 1) % n) for i in range(n)])
        return o / l.clamp_min(1e-20)[..., None]

    return _seq_parallel(local_fn, q, k, v, mesh, axis_name, batch_axis)


def _all_to_all(x, group, split, concat):
    """The reference's tiled ``lax.all_to_all``: split ``x`` into the
    group's size along ``split``, exchange the pieces, concatenate what
    arrives along ``concat`` (differentiable)."""
    from torch.distributed.nn.functional import all_to_all_single

    _, ranks = _group_layout(group)
    n = len(ranks)
    if n == 1:
        return x
    send = torch.stack(x.chunk(n, dim=split)).contiguous()
    got = all_to_all_single(torch.empty_like(send), send, group=group)
    return torch.cat(got.unbind(0), dim=concat)


def ulysses_attention(q, k, v, mesh, axis_name: str = "seq",
                      causal: bool = False, scale: float = None,
                      batch_axis: str = None):
    """DeepSpeed-Ulysses-style SP: all-to-all (seq->heads), full local
    attention, all-to-all back.  Requires H % mesh.shape[axis] == 0.
    ``batch_axis`` additionally shards B over a second mesh axis (dp x
    sp; the all-to-alls stay within each data replica's 'seq' group)."""
    h, d = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n = mesh.shape[axis_name]
    if h % n != 0:
        raise ValueError(f"heads {h} not divisible by seq-par degree {n}")

    def local_fn(q, k, v, group):
        # local: (B, H, T/n, D) -> a2a -> (B, H/n, T, D)
        ql, kl, vl = (_all_to_all(x, group, 1, 2) for x in (q, k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", ql, kl) * scale
        if causal:
            tq = s.shape[-2]
            mask = torch.ones(tq, tq, dtype=torch.bool,
                              device=s.device).tril()
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        ol = torch.einsum("bhqk,bhkd->bhqd", p, vl)
        # back: (B, H/n, T, D) -> (B, H, T/n, D)
        return _all_to_all(ol, group, 2, 1)

    return _seq_parallel(local_fn, q, k, v, mesh, axis_name, batch_axis)


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
