"""Runtime-compiled CUDA kernels from user source (the port of
``mxnet_tpu/rtc.py``; replaces its ``Rtc._compiled``, the
``pl.pallas_call`` over user Pallas source, at ``mxnet_tpu/rtc.py:62``).

The contract is the reference's MXRtc (``src/common/mxrtc.cc``,
``python/mxnet/rtc.py`` of MXNet 0.9): ``kernel`` is the *body* of a
CUDA C kernel.  :func:`decorate` wraps it as MXRtc did into ``extern "C"
__global__ void <name>(const T* <in>, ..., T* <out>, ...)`` with
``<arg>_ndim`` and ``<arg>_dims[]`` constants for every argument; NVRTC
compiles that to a cubin for the card's own architecture when the
:class:`Rtc` is built, and the driver API launches it on PyTorch's
current stream with the grid and block that :meth:`Rtc.push` is given.

What the design is bound by: a user kernel is whatever its source says,
so its bound is that kernel's; the wrapper adds one ``cuLaunchKernel``
and the argument checks per push (host time only: no sync, no copy of
an NDArray argument).  Compiles are cached process-wide by (decorated
source, architecture, card), so a second ``Rtc`` of the same name,
source and template shapes makes no NVRTC call.

Differences from the JAX package (kept on purpose, ROADMAP Queue 3):
the source is CUDA C, not Pallas Python; ``grid_dims`` and
``block_dims`` are required and honoured (the JAX ``push`` validates and
ignores them); and ``Rtc`` runs only on a CUDA card — construction
without one, or a ``push`` of CPU arrays, raises, because the port
cannot interpret CUDA C the way Pallas runs in interpret mode on the
CPU, and a user kernel has no plain version to fall back on.
"""
from __future__ import annotations

import re
import threading
import time

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray, _from_numpy
from .ops import _nvrtc

__all__ = ["Rtc", "decorate", "launch_count", "reset_launch_count"]

# C type of each template dtype, and the header it needs
_C_TYPES = {
    torch.float32: ("float", None),
    torch.float64: ("double", None),
    torch.float16: ("__half", "cuda_fp16.h"),
    torch.bfloat16: ("__nv_bfloat16", "cuda_bf16.h"),
    torch.int64: ("long long", None),
    torch.int32: ("int", None),
    torch.int8: ("signed char", None),
    torch.uint8: ("unsigned char", None),
}
_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_MAX_THREADS = 1024

_lock = threading.Lock()
_functions = {}         # (source, arch, card) -> CUfunction
_launches = [0]


def launch_count() -> int:
    """Kernels launched by :meth:`Rtc.push` in this process."""
    return _launches[0]


def reset_launch_count():
    _launches[0] = 0


def _tensor(value) -> torch.Tensor:
    return value._t if isinstance(value, NDArray) else value


def decorate(name, inputs, outputs, kernel) -> str:
    """MXRtc's decoration of the kernel body ``kernel``: the signature
    from the ``(argname, template)`` pairs (inputs ``const``), then each
    argument's ``_ndim`` and ``_dims[]``, then the body.  Raises
    :class:`MXNetError` on a name that is no C identifier, a repeated
    argname, a 0-d template or a dtype without a C type."""
    if not _IDENT.match(str(name)):
        raise MXNetError(f"Rtc name {name!r} is not a C identifier")
    args = [(n, _tensor(t), i < len(inputs))
            for i, (n, t) in enumerate(list(inputs) + list(outputs))]
    seen = set()
    headers = []
    sig, consts = [], []
    for argname, t, is_input in args:
        if not _IDENT.match(str(argname)):
            raise MXNetError(f"Rtc '{name}': argname {argname!r} is not a "
                             "C identifier")
        if argname in seen:
            raise MXNetError(f"Rtc '{name}': argname {argname!r} repeats")
        seen.add(argname)
        if t.dtype not in _C_TYPES:
            raise MXNetError(f"Rtc '{name}': {argname} has dtype {t.dtype}, "
                             f"which has no C type here (want one of "
                             f"{sorted(str(d) for d in _C_TYPES)})")
        if t.dim() == 0:
            raise MXNetError(f"Rtc '{name}': {argname} is 0-d; give it shape "
                             "(1,) (MXRtc declares one _dims entry per dim)")
        ctype, header = _C_TYPES[t.dtype]
        if header and header not in headers:
            headers.append(header)
        sig.append(("const " if is_input else "") + f"{ctype}* {argname}")
        consts.append(f"const int {argname}_ndim = {t.dim()};\n"
                      f"const int {argname}_dims[] = "
                      f"{{{','.join(str(d) for d in t.shape)}}};\n")
    return ("".join(f"#include <{h}>\n" for h in headers)
            + f'\nextern "C" __global__ void {name}({",".join(sig)}) {{\n'
            + "".join(consts) + kernel + "\n}\n")


def _check_args(name, kind, templates, values, device, upload):
    """``values`` as tensors, each equal to its template in shape, dtype
    and card and contiguous; numpy values are uploaded when ``upload``."""
    if len(values) != len(templates):
        raise MXNetError(f"Rtc '{name}' expects {len(templates)} {kind}s, "
                         f"got {len(values)}")
    out = []
    for (argname, tmpl), v in zip(templates, values):
        if upload and not isinstance(v, (NDArray, torch.Tensor)):
            v = _from_numpy(v, device)
        t = _tensor(v)
        if not isinstance(t, torch.Tensor):
            raise MXNetError(f"Rtc '{name}': {kind} {argname} must be an "
                             f"NDArray, not {type(v).__name__}")
        if t.device != device:
            raise MXNetError(
                f"Rtc compiles CUDA C and runs on a CUDA device: {kind} "
                f"{argname} is on {t.device}, the kernel on {device}")
        if tuple(t.shape) != tuple(tmpl.shape) or t.dtype != tmpl.dtype:
            raise MXNetError(
                f"Rtc '{name}': {kind} {argname} is {tuple(t.shape)} "
                f"{t.dtype}, the template {tuple(tmpl.shape)} {tmpl.dtype} "
                "(its dims are compiled into the kernel)")
        if not t.is_contiguous():
            raise MXNetError(f"Rtc '{name}': {kind} {argname} is not "
                             "contiguous (the kernel indexes it densely)")
        out.append(t)
    return out


def _dims(what, dims):
    if dims is None:
        raise MXNetError(f"Rtc.push needs {what}: a CUDA launch has no "
                         "default grid or block")
    dims = tuple(dims)
    if len(dims) != 3 or not all(isinstance(d, (int, np.integer)) and d > 0
                                 for d in dims):
        raise MXNetError(f"Rtc.push {what} must be 3 positive ints, got "
                         f"{dims!r}")
    return tuple(int(d) for d in dims)


class Rtc:
    """A user CUDA kernel compiled at construction (MXNet's ``mx.rtc``).

    ``inputs``/``outputs``: ``[(argname, NDArray), ...]`` templates on
    one card; their shapes and dtypes are compiled into the kernel and
    every :meth:`push` must match them.  ``kernel``: the body of the
    kernel, CUDA C.  A compile error raises :class:`MXNetError` with
    NVRTC's log."""

    def __init__(self, name, inputs, outputs, kernel):
        self.name = name
        self._in = [(n, _tensor(t)) for n, t in inputs]
        self._out = [(n, _tensor(t)) for n, t in outputs]
        self.source = decorate(name, self._in, self._out, kernel)
        devices = {t.device for _, t in self._in + self._out}
        if not torch.cuda.is_available() or len(devices) != 1 \
                or next(iter(devices)).type != "cuda":
            where = sorted(map(str, devices))
            raise MXNetError(
                "Rtc compiles CUDA C and runs on a CUDA device: its templates "
                f"must lie on one card (they are on {where}"
                f"{'' if torch.cuda.is_available() else '; no card here'})")
        dev = next(iter(devices))
        self.device = torch.device("cuda", dev.index if dev.index is not None
                                   else torch.cuda.current_device())
        major, minor = torch.cuda.get_device_capability(self.device)
        self.arch = f"sm_{major}{minor}"
        key = (self.source, self.arch, self.device.index)
        self.compile_ms = None   # None: the cache held it
        with _lock:
            self._fn = _functions.get(key)
            if self._fn is None:
                t0 = time.perf_counter()
                cubin = _nvrtc.compile_cubin(self.source, name, self.arch)
                self.compile_ms = (time.perf_counter() - t0) * 1e3
                self._fn = _nvrtc.load_function(cubin, name,
                                                self.device.index)
                _functions[key] = self._fn

    def push(self, inputs, outputs, grid_dims=None, block_dims=None):
        """Launch the kernel on ``inputs`` and ``outputs`` (NDArrays
        matching the templates; inputs may be numpy, uploaded) with
        ``grid_dims`` and ``block_dims`` (3-tuples, at most 1024 threads
        a block), on the current stream, writing the outputs' own
        storage.  Returns ``outputs``; nothing waits for the card."""
        grid = _dims("grid_dims", grid_dims)
        block = _dims("block_dims", block_dims)
        if block[0] * block[1] * block[2] > _MAX_THREADS:
            raise MXNetError(f"Rtc.push block_dims {block} exceed "
                             f"{_MAX_THREADS} threads")
        ins = _check_args(self.name, "input", self._in, inputs, self.device,
                          upload=True)
        outs = _check_args(self.name, "output", self._out, outputs,
                           self.device, upload=False)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _nvrtc.launch(self._fn, self.device.index, grid, block, stream,
                      [t.data_ptr() for t in ins + outs])
        _launches[0] += 1
        return outputs
