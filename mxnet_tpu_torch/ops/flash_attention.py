"""Flash attention: blockwise exact attention with its own backward.

The port of ``mxnet_tpu/ops/flash_attention.py``.  Three functions, each
with two lowerings picked by where the tensors live:

- the forward, ``(q, k, v) -> (O, LSE)``;
- dQ from ``(q, k, v, dO, LSE, δ)``;
- (dK, dV) from the same inputs.

CUDA tensors launch the hand-written kernels of ``csrc/flash_attention.cu``
(they replace the Pallas TPU kernels ``_fwd_kernel``, ``_bwd_dq_kernel``
and ``_bwd_dkv_kernel``).  In bf16 the backward is bound by its
products and the forward by its bytes, so all three run on the tensor
cores (``wgmma`` fed by TMA copies, a producer warpgroup and two
consumers; the tiles' bytes never pass through the threads); fp32 runs
on the CUDA cores, since the tensor cores would round it to TF32.  A
shape or dtype the kernels cannot take raises, there is no fallback.
CPU tensors take the plain versions
(:func:`fwd_plain`, :func:`dq_plain`, :func:`dkv_plain`), which compute
the same functions over the whole ``(T, T)`` score matrix in fp32.

Semantics kept from the JAX package: masked scores are ``NEG_INF``
(-1e30, not -inf); ``LSE = m + log(max(l, 1e-20))`` in fp32, shaped
``(B, H, T)``; the backward recomputes ``P = exp(s - LSE)``;
``δ = rowsum(O∘dO)`` is computed in fp32 outside the kernels; dQ and dK
come back in q's dtype and dV in v's; the scale defaults to 1/√D.

Each kernel launch reports its analytic FLOPs to the perf plane
(``telemetry.perf.kernel_flops``; a dispatch-mode counter sees the
plain versions' matmuls but not a ctypes launch).

:func:`flash_attention` is the differentiable entry point (a
``torch.autograd.Function`` in place of the ``jax.custom_vjp``), and the
``FlashAttention`` op is registered at the end of this module.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError, parse_attr, parse_bool
from ..telemetry import perf as _perf
from .registry import register

__all__ = ["NEG_INF", "MAX_D", "supports", "flash_attention", "apply",
           "fwd_plain", "dq_plain", "dkv_plain", "launch_counts",
           "reset_launch_counts"]

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp()/max() NaN-free

# the CUDA kernels' own limit: a thread keeps D/16 <= 8 output columns of
# each of its 4 rows in registers
MAX_D = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of each CUDA kernel in this process: plain integers, bumped
# where the kernel is launched and nowhere else
_launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0


def supports(q_shape, block_q=128, block_k=128):
    """True when the kernels take this shape: the JAX package's gate
    (T divisible by both blocks, D % 8 == 0) plus the CUDA kernels' own
    limit D <= MAX_D (128)."""
    b, h, t, d = q_shape
    return (t % block_q == 0 and t % block_k == 0 and d % 8 == 0
            and d <= MAX_D)


def _resolve_scale(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _check_shape(shape, bq, bk):
    b, h, t, d = shape
    if t % bq or t % bk or d % 8:
        raise ValueError(
            f"flash_attention requires T divisible by block sizes "
            f"({bq}, {bk}) and D % 8 == 0; got T={t}, D={d}. "
            "Use parallel.ring_attention.attention(impl='auto') for "
            "automatic fallback.")


# ----------------------------------------------------------------- plain
def _probs(q, k, lse, scale, causal):
    """fp32 scores ``(q·scale)·kᵀ`` with the causal NEG_INF mask and, when
    ``lse`` is given, the recomputed ``P = exp(s - lse)``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        t = s.shape[-1]
        live = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~live, NEG_INF)
    if lse is None:
        return s
    return torch.exp(s - lse[..., None])


def fwd_plain(q, k, v, scale, causal):
    """The forward kernel's plain version: ``(O in q's dtype, LSE fp32
    (B, H, T))``, fp32 inside."""
    s = _probs(q, k, None, scale, causal)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l_safe = p.sum(-1).clamp_min(1e-20)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe[..., None]
    return o.to(q.dtype), m + torch.log(l_safe)


def _ds(q, k, v, do, lse, delta, scale, causal):
    p = _probs(q, k, lse, scale, causal)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def dq_plain(q, k, v, do, lse, delta, scale, causal):
    """The dQ kernel's plain version: ``Σ_k dS·K`` in q's dtype."""
    _p, ds = _ds(q, k, v, do, lse, delta, scale, causal)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def dkv_plain(q, k, v, do, lse, delta, scale, causal):
    """The dK/dV kernel's plain version: ``(Σ_q dSᵀ·Q in q's dtype,
    Σ_q Pᵀ·dO in v's dtype)``."""
    p, ds = _ds(q, k, v, do, lse, delta, scale, causal)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(q.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ CUDA
_SIGNATURES = {
    # (dtype, q, k, v, o, lse, B*H, T, D, scale, causal, stream)
    "mxtt_flash_fwd": "ipppppiiifip",
    # (dtype, q, k, v, do, lse, delta, dq, B*H, T, D, scale, causal, stream)
    "mxtt_flash_bwd_dq": "ipppppppiiifip",
    # (dtype, q, k, v, do, lse, delta, dk, dv, B*H, T, D, scale, causal,
    #  stream)
    "mxtt_flash_bwd_dkv": "ippppppppiiifip",
}
_CTYPE = {"i": ctypes.c_int, "p": ctypes.c_void_p, "f": ctypes.c_float}


def _fn(name):
    from . import _build

    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPE[c] for c in _SIGNATURES[name]]
        fn.restype = ctypes.c_int
    return fn


def _require(q, k, v, extra=()):
    """Raise unless the kernels can take these tensors: q/k/v (and the
    ``extra`` ``(name, tensor, dtype)`` triples) contiguous, on one CUDA
    device, q's dtype float32 or bfloat16, D % 8 == 0 and D <= MAX_D."""
    B, H, T, D = q.shape
    if q.dtype not in _DTYPE_CODE or D % 8 or D > MAX_D or D < 8:
        raise MXNetError(
            f"flash_attention CUDA kernels do not support D={D}, dtype="
            f"{q.dtype}: they need float32 or bfloat16, D % 8 == 0 and "
            f"D <= {MAX_D}")
    for name, t, dt, shape in (("q", q, q.dtype, q.shape),
                               ("k", k, q.dtype, q.shape),
                               ("v", v, q.dtype, q.shape), *extra):
        if (t.device != q.device or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape)):
            raise MXNetError(
                f"flash_attention: {name} must be a contiguous {dt} tensor "
                f"of shape {tuple(shape)} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _kernel_flops(products, q, causal):
    """Report a launch's analytic FLOPs to the perf plane (its counter
    cannot see a ctypes launch): each (query, key) pair the kernel
    visits — T(T+1)/2 of them when causal — costs 2*D flops in each of
    its ``products`` matrix products (2 in the forward, 3 in dQ, 4 in
    dK/dV)."""
    B, H, T, D = q.shape
    pairs = T * (T + 1) // 2 if causal else T * T
    # trace-ok: a capture opens no counting region (perf.counting runs at
    # a program's first eager dispatch only), so this is an attribute read
    _perf.kernel_flops(2 * products * B * H * pairs * D)


def _launch(name, q, args):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(name)(*args, stream)
    if err < 0:  # the driver refused a TMA map (the bf16 sm90 kernels)
        raise MXNetError(f"{name} CUDA launch failed: cuTensorMapEncodeTiled "
                         f"returned CUresult {-err}")
    if err != 0:
        raise MXNetError(f"{name} CUDA launch failed: cuda error {err}")
    # trace-ok: counts the wrapper's launches; under capture that is the
    # one launch recorded into the graph, and a replay is not counted
    _launches[name[len("mxtt_"):]] += 1


def _cuda_fwd(q, k, v, scale, causal):
    _require(q, k, v)
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch("mxtt_flash_fwd", q, (
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B * H, T, D, float(scale),
        int(causal)))
    _kernel_flops(2, q, causal)
    return o, lse


def _bwd_extra(q, do, lse, delta):
    B, H, T, _D = q.shape
    return (("do", do, q.dtype, q.shape),
            ("lse", lse, torch.float32, (B, H, T)),
            ("delta", delta, torch.float32, (B, H, T)))


def _cuda_dq(q, k, v, do, lse, delta, scale, causal):
    _require(q, k, v, _bwd_extra(q, do, lse, delta))
    B, H, T, D = q.shape
    dq = torch.empty_like(q)
    _launch("mxtt_flash_bwd_dq", q, (
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B * H, T, D, float(scale), int(causal)))
    _kernel_flops(3, q, causal)
    return dq


def _cuda_dkv(q, k, v, do, lse, delta, scale, causal):
    _require(q, k, v, _bwd_extra(q, do, lse, delta))
    B, H, T, D = q.shape
    dk = torch.empty_like(q)
    dv = torch.empty_like(v)
    _launch("mxtt_flash_bwd_dkv", q, (
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B * H, T, D, float(scale), int(causal)))
    _kernel_flops(4, q, causal)
    return dk, dv


# ------------------------------------------------------------- lowerings
def _on(q, cpu_fn, cuda_fn, *args):
    # meta tensors (shape inference) take the plain versions too
    if q.device.type in ("cpu", "meta"):
        return cpu_fn(*args)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention: no lowering for device "
                         f"{q.device}")
    return cuda_fn(*args)


def _fwd_impl(q, k, v, scale, causal):
    """``(O, LSE)``: the forward kernel on CUDA tensors, its plain
    version on CPU tensors."""
    return _on(q, fwd_plain, _cuda_fwd, q, k, v, scale, causal)


def _bwd_impl(q, k, v, o, lse, do, scale, causal):
    """``(dQ, dK, dV)``: δ in fp32 here (as the JAX package computes it
    outside its kernels), then the dQ and dK/dV kernels (CUDA) or their
    plain versions (CPU)."""
    delta = (o.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal)
    dq = _on(q, dq_plain, _cuda_dq, *args)
    dk, dv = _on(q, dkv_plain, _cuda_dkv, *args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp``: the forward saves (q, k, v, O,
    LSE) and the backward runs the two backward kernels on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _fwd_impl(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        # the perf plane's regions counting this forward count its
        # backward too, on whichever thread autograd runs it
        # trace-ok: reads which host-side counting regions are open (none
        # under capture); no device value, nothing a replay needs
        ctx.perf_regions = _perf.open_regions()
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # trace-ok: thread-local routing of the perf plane's FLOP reports
        # (empty under capture); no device value, nothing a replay needs
        with _perf.reporting_to(ctx.perf_regions):
            dq, dk, dv = _bwd_impl(q, k, v, o, lse, do.contiguous(),
                                   ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_q=128,
                    block_k=128):
    """Blockwise exact attention over ``(B, H, T, D)``; returns ``(B, H,
    T, D)`` in q's dtype, differentiable.  The blocks are clamped to T
    and gate the shape as in the JAX package (T divisible by both, D %
    8 == 0); the CUDA kernels tile by their own sizes and memory stays
    O(T·D)."""
    bq = min(block_q, q.shape[2])
    bk = min(block_k, q.shape[2])
    _check_shape(q.shape, bq, bk)
    return apply(q, k, v, causal, scale)


def apply(q, k, v, causal=False, scale=None):
    """:func:`flash_attention` without the block gate: the autograd
    Function over the kernels (CUDA) or their plain versions (CPU)."""
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 float(_resolve_scale(scale, q.shape[-1])))


# ------------------------------------------------- op registration
@register("FlashAttention", arg_names=("query", "key", "value"))
def _flash_attention_op(ctx, query, key, value, **attrs):
    """Exact blockwise attention over (B, H, T, D) inputs.  impl: auto |
    flash | lax (the JAX package's flash_interpret has no counterpart:
    CPU tensors already take the plain versions)."""
    causal = parse_bool(attrs.get("causal", False))
    scale = attrs.get("scale")
    scale = float(parse_attr(scale)) if scale is not None else None
    impl = str(attrs.get("impl", "auto"))
    from ..parallel.ring_attention import attention

    def run(q, k, v):
        return attention(q, k, v, causal=causal, scale=scale, impl=impl)

    from ..parallel import mesh as _mesh

    if _mesh.is_dtensor(query):
        return _on_local_heads(run, query, key, value)
    return run(query, key, value)


def _on_local_heads(run, q, k, v):
    """The op under a mesh: each rank runs ``run`` (the kernels on the
    card) on its own block of batch rows and heads, and the result is
    placed as q is.  A sequence split on T (or D) is refused by name:
    attention over a split sequence is the ring's or Ulysses' work
    (``parallel/ring_attention.py``)."""
    from torch.distributed.tensor import Replicate, Shard

    from ..parallel import mesh as _mesh

    place = tuple(q.placements)
    for p in place:
        if not (isinstance(p, Replicate)
                or (isinstance(p, Shard) and p.dim in (0, 1))):
            raise MXNetError(
                f"FlashAttention under a mesh runs on each rank's batch "
                f"rows and heads; the query is placed {place}, split on "
                f"its sequence or head width (use ring_attention or "
                f"ulysses_attention for a split sequence)")
    if tuple(k.placements) != place or tuple(v.placements) != place:
        k = k.redistribute(q.device_mesh, place)
        v = v.redistribute(q.device_mesh, place)
    return _mesh.local_map(run, out_placements=(place,),
                           in_placements=(place, place, place),
                           device_mesh=q.device_mesh)(q, k, v)
