"""Fused residual epilogue: ``relu((x + shortcut) * scale + bias)``.

The port of ``mxnet_tpu/ops/residual_epilogue.py``.  The tail of a
ResNet unit — the per-channel affine (inference BatchNorm folded into
scale/bias), the residual add and the ReLU — in one pass over the
channels-last ``(N*H*W, C)`` view: each element of x and s is read once
and the output written once.  One entry point,
:func:`residual_epilogue`, with two lowerings:

- **the CUDA kernel** (``csrc/residual_epilogue.cu``) for CUDA tensors
  whose ``(rows, C)`` view exists without a copy — channels-last memory
  (``torch.channels_last``) of a logical NCHW tensor with the channel
  axis 1, or a contiguous tensor with the channel axis last — and whose
  shape passes :func:`supports`.  It replaces the Pallas TPU kernel
  ``_pallas_fwd``.  A tensor it cannot take raises; there is no
  fallback when a build or a launch fails.
- **the plain version** (:func:`_plain_fwd`), the JAX package's lax twin
  ``_lax_fwd``: for CPU tensors, for ``impl="lax"``, and wherever the
  reference's own gate sends the op to lax (no channels-last view, as
  under ``MXTPU_CONV_LAYOUT=NCHW``, or a shape :func:`supports` refuses).

The two round differently in bf16, as their JAX counterparts do: the
kernel (like the TPU kernel) adds x and s in fp32, the plain version
(like ``_lax_fwd``) adds them in the input dtype and then widens.  In
fp32 they are bit-identical.

The backward is plain torch (``_epilogue_bwd``'s selects and two
per-channel sums) behind one ``torch.autograd.Function``.

Schedule: where the JAX package tunes the Pallas kernel's ``block_rows``,
the port tunes the CUDA kernel's launch — ``{"threads": 128|256|512,
"blocks_per_sm": 2|4|8|16}`` (default ``{"threads": 256,
"blocks_per_sm": 8}``).  :func:`tune` searches the candidates on the card
through the autotuner (``MXTPU_SCHEDULE_CACHE``) under the reference's
key ``r<rows>c<C>_<dtype>``; each launch reads its schedule with the pure
``autotune.schedule_for`` and falls back to the default for one it
cannot read (the reference's ``{"block_rows": ...}`` from a shared CPU
cache, say).  The kernel is a grid-stride elementwise pass, so every
schedule gives bit-identical output.

Graph entry points (matched by ``passes/residual_epilogue.py``):
``_residual_epilogue(data, shortcut)`` and
``_residual_epilogue_bn(data, shortcut, gamma, beta | mean, var)``.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError, parse_attr, parse_bool
from .registry import get as _get_op
from .registry import register

__all__ = ["supports", "residual_epilogue", "tune", "launch_count",
           "reset_launch_count", "DEFAULT_SCHEDULE", "candidate_schedules",
           "make_bench_fn"]

# the JAX package's static row block; only supports() reads it here
_BLOCK_ROWS = 256

# the CUDA kernel's launch schedule: threads per block (one kernel
# instantiation each) and the most blocks per SM of its grid-stride grid
DEFAULT_SCHEDULE = {"threads": 256, "blocks_per_sm": 8}
_THREADS = (128, 256, 512)
_BLOCKS_PER_SM = (2, 4, 8, 16)
# the bytes a timed pass of tune() moves at least (three times the
# H100's 50 MB L2): each launch of a pass reads its own copy of x and s,
# so a candidate is timed on cold inputs, as the Predictor's launches
# read them
_COLD_BYTES = 150e6

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_IMPLS = ("auto", "lax", "cuda")

# launches of the CUDA kernel in this process: a plain integer, bumped
# where the kernel is launched and nowhere else
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count():
    global _launches
    _launches = 0


def supports(rows: int, channels: int) -> bool:
    """The JAX package's gate: C must fill whole 128-wide lanes and rows
    must split into row blocks (a multiple of 8).  ResNet-50's residual
    tails (C = 256 / 512 / 1024 / 2048, rows = N*H*W) all qualify."""
    if channels % 128 != 0:
        return False
    return rows % _default_block_rows(rows) == 0 and rows >= 8


def _default_block_rows(rows: int) -> int:
    if rows % _BLOCK_ROWS == 0:
        return _BLOCK_ROWS
    for b in (128, 64, 32, 16, 8):
        if rows % b == 0:
            return b
    return rows  # not tileable; supports() returns False upstream


def _keysig(rows: int, channels: int, dtype) -> str:
    """The autotuner key, the JAX package's format (``r%dc%d_%s`` with
    the dtype's name, ``float32`` or ``bfloat16``)."""
    return "r%dc%d_%s" % (rows, channels,
                          str(dtype).replace("torch.", ""))


def candidate_schedules():
    """Every launch schedule :func:`tune` measures, the default among
    them (a search never loses to not searching)."""
    return [{"threads": t, "blocks_per_sm": b}
            for t in _THREADS for b in _BLOCKS_PER_SM]


def _valid(sched) -> bool:
    try:
        return (int(sched["threads"]) in _THREADS
                and int(sched["blocks_per_sm"]) >= 1)
    except (KeyError, TypeError, ValueError):
        return False


def _schedule_for(rows: int, channels: int, dtype) -> dict:
    """The launch schedule of this ``(rows, C, dtype)``: the tuned winner
    when the schedule cache holds one this kernel can read, else
    :data:`DEFAULT_SCHEDULE`.  A dict read (``autotune.schedule_for``):
    no clock, no device, safe inside a CUDA-graph capture."""
    from .. import autotune as _autotune

    sched = _autotune.schedule_for("residual_epilogue",
                                   _keysig(rows, channels, dtype),
                                   DEFAULT_SCHEDULE)
    return sched if _valid(sched) else DEFAULT_SCHEDULE


def make_bench_fn(rows, channels, dtype):
    """``bench(schedule) -> thunk`` for the autotuner on the card: the
    thunk replays one pass that launches the kernel under ``schedule``
    once on each of ``n`` seeded copies of a ``(rows, C)`` x and s, ``n``
    chosen so the pass moves at least ``_COLD_BYTES`` (its launches
    never find their inputs in L2; drawn at the first call, so a cache
    hit draws nothing), and returns the pass's ``n`` outputs.  The pass
    is captured as a CUDA graph, so a replay runs its launches back to
    back and times the card, not the Python wrapper (~30 µs a launch,
    more than a small tail's kernel).  A schedule asked for again gets
    the thunk of its first capture, so two timings of one schedule time
    one pass on the same buffers.  A schedule outside the kernel's
    raises ``autotune.ScheduleRejected`` before any launch."""
    from .. import autotune as _autotune

    inputs = []
    replays = {}

    def draw():
        dev = torch.device("cuda")
        item = torch.tensor([], dtype=dtype).element_size()
        n = max(1, min(16, -(-int(_COLD_BYTES)
                             // (3 * rows * channels * item))))
        gen = torch.Generator(device=dev).manual_seed(0)
        xs = [torch.randn((rows, channels), generator=gen,
                          device=dev).to(dtype) for _ in range(n)]
        ss = [torch.randn((rows, channels), generator=gen,
                          device=dev).to(dtype) for _ in range(n)]
        scale = torch.randn((channels,), generator=gen, device=dev)
        bias = torch.randn((channels,), generator=gen, device=dev)
        return list(zip(xs, ss)), scale, bias

    def bench(cand):
        if not _valid(cand):
            raise _autotune.ScheduleRejected(
                f"residual_epilogue: schedule {cand!r} is not one of the "
                f"kernel's ({_THREADS} threads, blocks_per_sm >= 1)")
        key = (int(cand["threads"]), int(cand["blocks_per_sm"]))
        if key in replays:
            return replays[key]
        if not inputs:
            inputs.append(draw())
        pairs, scale, bias = inputs[0]

        def launch():
            return [_cuda_fwd(x, s, scale, bias, 1, schedule=cand)
                    for x, s in pairs]

        launch()                       # loads the library before capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = launch()

        def replay():
            graph.replay()
            return outs

        replays[key] = replay
        return replay

    return bench


def tune(rows, channels, dtype=torch.float32):
    """Search the CUDA kernel's launch schedule for the ``(rows, C)``
    view and install the winner in the schedule cache (a bind-time call
    site; each launch only reads it).  Returns the schedule dict.

    On the card every candidate of :func:`candidate_schedules` is timed
    by CUDA events (warm-up, best of 10, ``autotune.measure``) over
    replays of :func:`make_bench_fn`'s captured pass, on inputs cold in
    L2 (the cache's ``best_us`` is that of one pass): the card's time,
    not the host's.  The default stays unless a candidate beats it by
    more than its spread.  A CUDA error raises.
    Without a card the plain version runs, which has no schedule: the
    default is returned and nothing is recorded — the port's counterpart
    of the JAX package tuning its kernel in interpret mode on the CPU.
    A shape :func:`supports` refuses keeps the default too."""
    from .. import autotune as _autotune

    rows, channels = int(rows), int(channels)
    dtype = getattr(torch, str(dtype).replace("torch.", ""), dtype)
    if (not supports(rows, channels) or dtype not in _DTYPE_CODE
            or not torch.cuda.is_available()):
        return dict(DEFAULT_SCHEDULE)
    return _autotune.ensure(
        "residual_epilogue", _keysig(rows, channels, dtype),
        dict(DEFAULT_SCHEDULE), candidate_schedules(),
        make_bench_fn(rows, channels, dtype), warmup=3, best_of=10)


def has_rows_view(t: torch.Tensor, channel_axis: int) -> bool:
    """Does ``t`` hold its ``(rows, C)`` view densely, element (r, c) at
    offset ``r * C + c``?  True for a contiguous tensor whose channel
    axis is last, and for a 4-D channels-last tensor whose channel axis
    is 1 (the port's layout: logical NCHW, physical NHWC)."""
    if channel_axis == t.ndim - 1 and t.is_contiguous():
        return True
    return (t.ndim == 4 and channel_axis == 1
            and t.is_contiguous(memory_format=torch.channels_last))


# ------------------------------------------------------------------ plain
def _plain_fwd(x, s, scale, bias, channel_axis):
    """``_lax_fwd``: add in x's dtype, then the fp32 affine and ReLU,
    rounded back to x's dtype."""
    bshape = [1] * x.ndim
    bshape[channel_axis] = x.shape[channel_axis]
    t = (x + s).float() * scale.reshape(bshape) + bias.reshape(bshape)
    return torch.relu(t).to(x.dtype)


# ------------------------------------------------------------------ CUDA
def _lib():
    from . import _build

    fn = _build.load("residual_epilogue").mxtt_residual_epilogue
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _cuda_fwd(x, s, scale, bias, channel_axis, schedule=None):
    """Launch the kernel under ``schedule`` (None: :func:`_schedule_for`
    this shape); raise :class:`MXNetError` on anything it cannot take (a
    CPU tensor, no dense ``(rows, C)`` view, mismatched shapes or
    dtypes, a shape :func:`supports` refuses, a dtype other than
    fp32/bf16, a pointer not 16-byte aligned, a schedule outside the
    kernel's)."""
    # trace-ok: counts the wrapper's launches; under capture that is the
    # one launch recorded into the graph, and a replay is not counted
    global _launches
    if x.device.type != "cuda":
        raise MXNetError(f"residual_epilogue CUDA kernel: x lies on "
                         f"{x.device}, not on a CUDA device")
    if s.device != x.device or s.shape != x.shape or s.dtype != x.dtype:
        raise MXNetError(
            f"residual_epilogue CUDA kernel: x {tuple(x.shape)} {x.dtype} "
            f"on {x.device} and s {tuple(s.shape)} {s.dtype} on {s.device} "
            "must match")
    if x.dtype not in _DTYPE_CODE:
        raise MXNetError(f"residual_epilogue CUDA kernel: dtype {x.dtype} "
                         "(it takes float32 or bfloat16)")
    if not (has_rows_view(x, channel_axis) and has_rows_view(s, channel_axis)):
        raise MXNetError(
            f"residual_epilogue CUDA kernel: x and s need a dense (rows, C) "
            f"view — channels-last memory with the channel axis 1, or "
            f"contiguous with it last (channel_axis={channel_axis}, x "
            f"strides {x.stride()}, s strides {s.stride()})")
    c = x.shape[channel_axis]
    rows = x.numel() // max(c, 1)
    if not supports(rows, c):
        raise MXNetError(
            f"residual_epilogue CUDA kernel does not support rows={rows}, "
            f"C={c}: it needs C % 128 == 0 and rows a multiple of 8")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise MXNetError(f"residual_epilogue: scale {tuple(scale.shape)} and "
                         f"bias {tuple(bias.shape)} must be ({c},)")
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), s.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr())
    if any(p % 16 for p in ptrs):
        raise MXNetError("residual_epilogue CUDA kernel: every tensor must "
                         "start on a 16-byte boundary (a sliced view?)")
    if schedule is None:
        schedule = _schedule_for(rows, c, x.dtype)
    elif not _valid(schedule):
        raise MXNetError(f"residual_epilogue: schedule {schedule!r} is not "
                         f"one of the kernel's ({_THREADS} threads, "
                         f"blocks_per_sm >= 1)")
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], *ptrs, rows, c,
                 int(schedule["threads"]), int(schedule["blocks_per_sm"]),
                 stream)
    if err != 0:
        raise MXNetError(f"residual_epilogue CUDA launch failed: cuda error "
                         f"{err}")
    _launches += 1
    return out


class _Epilogue(torch.autograd.Function):
    """Forward: the kernel or the plain version.  Backward: plain torch,
    ``_epilogue_bwd`` of the JAX package — the ReLU mask from the
    output, two per-channel sums in fp32."""

    @staticmethod
    def forward(ctx, x, s, scale, bias, channel_axis, use_kernel):
        if use_kernel:
            out = _cuda_fwd(x, s, scale, bias, channel_axis)
        else:
            out = _plain_fwd(x, s, scale, bias, channel_axis)
        ctx.save_for_backward(x, s, scale, out)
        ctx.channel_axis = channel_axis
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, s, scale, out = ctx.saved_tensors
        ax = ctx.channel_axis
        bshape = [1] * x.ndim
        bshape[ax] = x.shape[ax]
        axes = tuple(a for a in range(x.ndim) if a != ax)
        g32 = torch.where(out > 0, g.float(), 0.0)
        gs = g32 * scale.reshape(bshape).float()
        dscale = (g32 * (x + s).float()).sum(axes)
        dbias = g32.sum(axes)
        return (gs.to(x.dtype), gs.to(s.dtype), dscale.to(scale.dtype),
                dbias.to(ctx.bias_dtype), None, None)


def residual_epilogue(x, s, scale=None, bias=None, channel_axis=-1,
                      impl="auto"):
    """``relu((x + s) * scale + bias)`` with per-channel ``scale`` and
    ``bias`` (default 1 and 0, fp32) along ``channel_axis``.

    ``impl``: ``auto`` — the CUDA kernel for a CUDA tensor with a dense
    ``(rows, C)`` view whose shape :func:`supports` admits, the plain
    version otherwise (the reference's gate); ``lax`` — the plain
    version; ``cuda`` — the kernel, raising where it cannot run."""
    channel_axis = channel_axis % x.ndim
    c = x.shape[channel_axis]
    if scale is None:
        scale = torch.ones((c,), dtype=torch.float32, device=x.device)
    if bias is None:
        bias = torch.zeros((c,), dtype=torch.float32, device=x.device)
    if impl not in _IMPLS:
        raise MXNetError(f"residual_epilogue: unknown impl {impl!r} "
                         f"(one of {_IMPLS})")
    if impl == "auto":
        rows = x.numel() // max(c, 1)
        use_kernel = (x.device.type == "cuda"
                      and has_rows_view(x, channel_axis)
                      and has_rows_view(s, channel_axis)
                      and supports(rows, c))
    else:
        use_kernel = impl == "cuda"
    return _Epilogue.apply(x, s, scale, bias, channel_axis, use_kernel)


# ---------------------------------------------------------------------------
# op registrations (graph entry points for passes/residual_epilogue.py)
# ---------------------------------------------------------------------------
def _impl(attrs):
    return str(attrs.get("impl", "auto"))


# the graph ops take logical NCHW tensors (channel axis 1); the
# executor's channels-last memory is what gives them the (rows, C) view


@register("_residual_epilogue", arg_names=("data", "shortcut"))
def _residual_epilogue_op(ctx, data, shortcut, **attrs):
    """``relu(data + shortcut)`` as one fused epilogue (the affine is
    identity); ``impl`` picks the lowering."""
    return residual_epilogue(data, shortcut, channel_axis=1,
                             impl=_impl(attrs))


def _epi_bn_params(attrs, data_shape, *rest):
    if data_shape is None:
        raise TypeError("need data shape")
    c = data_shape[1]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


@register("_residual_epilogue_bn",
          arg_names=("data", "shortcut", "gamma", "beta"),
          aux_names=("moving_mean", "moving_var"),
          infer_params=_epi_bn_params)
def _residual_epilogue_bn_op(ctx, data, shortcut, gamma, beta, moving_mean,
                             moving_var, **attrs):
    """``relu(BatchNorm(data + shortcut))``.

    Train mode (no use_global_stats) replays the unfused composite —
    the ``BatchNorm`` op on the sum, then ReLU, aux updates included.
    Inference folds the moving stats in fp32 into ``scale = gamma *
    rsqrt(var + eps)`` (gamma 1 under fix_gamma, default True; eps
    default 1e-3) and ``bias = beta - mean * scale``, runs the fused
    epilogue, and passes the aux pair through unchanged."""
    use_global = parse_bool(attrs.get("use_global_stats", False))
    if ctx.is_train and not use_global:
        out, aux_updates = _get_op("BatchNorm").fn(
            ctx, data + shortcut, gamma, beta, moving_mean, moving_var,
            **attrs)
        return torch.relu(out), aux_updates
    eps = float(parse_attr(attrs.get("eps", 1e-3)))
    fix_gamma = parse_bool(attrs.get("fix_gamma", True))
    g32 = torch.ones_like(gamma, dtype=torch.float32) if fix_gamma \
        else gamma.float()
    scale = g32 * torch.rsqrt(moving_var.float() + eps)
    bias = beta.float() - moving_mean.float() * scale
    out = residual_epilogue(data, shortcut, scale, bias, channel_axis=1,
                            impl=_impl(attrs))
    return out, (moving_mean, moving_var)
