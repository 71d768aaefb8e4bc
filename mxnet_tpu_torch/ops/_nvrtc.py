"""ctypes bindings of NVRTC and the CUDA driver API, for ``rtc.Rtc``.

NVRTC compiles CUDA C source to a cubin for one architecture
(:func:`compile_cubin`); the driver API loads it into the card's primary
context and launches it on a stream (:func:`load_function`,
:func:`launch`).  Both libraries are found and opened at first use,
never at import, so the module imports on a host without CUDA; every
``nvrtcResult`` and ``CUresult`` that is not success becomes an
:class:`MXNetError` carrying the library's own error string (and, for a
failed compile, NVRTC's program log).

``libnvrtc`` is searched under ``CUDA_HOME``/``CUDA_PATH`` and the
toolkit PyTorch found (so that NVRTC and the ``cuda_fp16.h`` it
includes come from one release), then in the ``nvidia/cuda_nvrtc``
directory that PyTorch's wheels ship, then through
``ctypes.util.find_library``; the driver is ``libcuda.so.1``.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import importlib.util
import os
import threading

from ..base import MXNetError

__all__ = ["compile_cubin", "compile_count", "load_function", "launch"]

_lock = threading.Lock()
_libs = {}
_contexts = {}          # device index -> CUcontext (the primary context)
_compiles = [0]         # nvrtcCompileProgram calls in this process

_c_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_uint = ctypes.c_uint


def compile_count() -> int:
    """How many times this process has called ``nvrtcCompileProgram``."""
    return _compiles[0]


def _cuda_roots():
    roots = [os.environ.get(v) for v in ("CUDA_HOME", "CUDA_PATH")]
    from torch.utils import cpp_extension

    roots.append(cpp_extension.CUDA_HOME)
    return [r for r in dict.fromkeys(roots) if r]


def _wheel_dirs(*parts):
    """``nvidia/<parts>`` inside each installed ``nvidia`` package dir
    (PyTorch's CUDA wheels put NVRTC and the runtime headers there)."""
    spec = importlib.util.find_spec("nvidia")
    if spec is None or not spec.submodule_search_locations:
        return []
    return [os.path.join(p, *parts) for p in spec.submodule_search_locations]


def _nvrtc_dirs():
    dirs = []
    for root in _cuda_roots():
        dirs += [os.path.join(root, "lib64"), os.path.join(root, "lib")]
    return dirs + _wheel_dirs("cuda_nvrtc", "lib")


def include_dirs():
    """Directories holding ``cuda_fp16.h``/``cuda_bf16.h`` (NVRTC needs
    them passed with ``-I``)."""
    dirs = [os.path.join(r, "include") for r in _cuda_roots()]
    dirs += _wheel_dirs("cuda_runtime", "include")
    return [d for d in dict.fromkeys(dirs)
            if os.path.isfile(os.path.join(d, "cuda_fp16.h"))]


def _open_nvrtc():
    searched = []
    for d in _nvrtc_dirs():
        searched.append(d)
        libs = sorted(p for p in glob.glob(os.path.join(d, "libnvrtc.so*"))
                      if "builtins" not in os.path.basename(p))
        if not libs:
            continue
        # libnvrtc dlopens its builtins by soname: load them first, from
        # the same directory, so the lookup needs no LD_LIBRARY_PATH
        for b in sorted(glob.glob(os.path.join(d,
                                               "libnvrtc-builtins.so*"))):
            ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
            break
        return ctypes.CDLL(libs[0])
    found = ctypes.util.find_library("nvrtc")
    searched.append("ctypes.util.find_library('nvrtc')")
    if found:
        return ctypes.CDLL(found)
    raise MXNetError("libnvrtc (NVRTC) not found; searched: "
                     + ", ".join(searched))


def _nvrtc():
    with _lock:
        lib = _libs.get("nvrtc")
        if lib is None:
            lib = _open_nvrtc()
            P, S = ctypes.POINTER(_c_p), ctypes.POINTER(ctypes.c_size_t)
            cpp = ctypes.POINTER(ctypes.c_char_p)
            for name, args in (
                    ("nvrtcCreateProgram", [P, ctypes.c_char_p,
                                            ctypes.c_char_p, _c_int, cpp,
                                            cpp]),
                    ("nvrtcCompileProgram", [_c_p, _c_int, cpp]),
                    ("nvrtcGetProgramLogSize", [_c_p, S]),
                    ("nvrtcGetProgramLog", [_c_p, ctypes.c_char_p]),
                    ("nvrtcGetCUBINSize", [_c_p, S]),
                    ("nvrtcGetCUBIN", [_c_p, ctypes.c_char_p]),
                    ("nvrtcDestroyProgram", [P])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, _c_int
            lib.nvrtcGetErrorString.argtypes = [_c_int]
            lib.nvrtcGetErrorString.restype = ctypes.c_char_p
            _libs["nvrtc"] = lib
        return lib


def _nvrtc_check(lib, rc, what):
    if rc != 0:
        raise MXNetError(f"{what} failed: "
                         f"{lib.nvrtcGetErrorString(rc).decode()}")


def compile_cubin(source: str, name: str, arch: str) -> bytes:
    """Compile ``source`` with NVRTC into a cubin for ``arch``
    (``"sm_90"``).  A compile error raises :class:`MXNetError` with
    NVRTC's error string and program log."""
    lib = _nvrtc()
    prog = _c_p()
    _nvrtc_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), f"{name}.cu".encode(), 0, None,
        None), "nvrtcCreateProgram")
    try:
        opts = [f"--gpu-architecture={arch}"] + [
            f"--include-path={d}" for d in include_dirs()]
        copts = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        with _lock:
            _compiles[0] += 1
        rc = lib.nvrtcCompileProgram(prog, len(opts), copts)
        if rc != 0:
            size = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value)
            lib.nvrtcGetProgramLog(prog, log)
            raise MXNetError(
                f"NVRTC failed to compile Rtc kernel '{name}' for {arch}: "
                f"{lib.nvrtcGetErrorString(rc).decode()}\n"
                f"{log.value.decode(errors='replace')}")
        size = ctypes.c_size_t()
        _nvrtc_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


# ------------------------------------------------------------ driver API
def _driver():
    with _lock:
        lib = _libs.get("cuda")
        if lib is None:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError as exc:
                raise MXNetError(f"the CUDA driver (libcuda.so.1) cannot be "
                                 f"loaded: {exc}") from None
            P = ctypes.POINTER(_c_p)
            for name, args in (
                    ("cuInit", [_c_uint]),
                    ("cuDeviceGet", [ctypes.POINTER(_c_int), _c_int]),
                    ("cuDevicePrimaryCtxRetain", [P, _c_int]),
                    ("cuCtxSetCurrent", [_c_p]),
                    ("cuModuleLoadData", [P, _c_p]),
                    ("cuModuleGetFunction", [P, _c_p, ctypes.c_char_p]),
                    ("cuLaunchKernel", [_c_p] + [_c_uint] * 7
                     + [_c_p, P, P]),
                    ("cuGetErrorString", [_c_int,
                                          ctypes.POINTER(ctypes.c_char_p)])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, _c_int
            _check(lib, lib.cuInit(0), "cuInit")
            _libs["cuda"] = lib
        return lib


def _check(lib, rc, what):
    if rc != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(rc, ctypes.byref(msg))
        text = msg.value.decode() if msg.value else "unknown error"
        raise MXNetError(f"{what} failed: CUresult {rc} ({text})")


def _context(lib, index: int):
    """The primary context of card ``index`` (the one PyTorch's runtime
    uses), retained once per process and made current on this thread:
    driver calls need a current context, and a thread that never
    touched CUDA through PyTorch has none."""
    ctx = _contexts.get(index)
    if ctx is None:
        dev = _c_int()
        _check(lib, lib.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
        ctx = _c_p()
        _check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
               "cuDevicePrimaryCtxRetain")
        _contexts[index] = ctx
    _check(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return ctx


def load_function(cubin: bytes, name: str, index: int):
    """Load ``cubin`` into card ``index``'s primary context and return
    the ``CUfunction`` of kernel ``name``.  The module stays loaded for
    the life of the process (the caller caches the function)."""
    lib = _driver()
    _context(lib, index)
    module = _c_p()
    buf = ctypes.create_string_buffer(cubin, len(cubin))
    _check(lib, lib.cuModuleLoadData(ctypes.byref(module), buf),
           "cuModuleLoadData")
    fn = _c_p()
    _check(lib, lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                        name.encode()),
           f"cuModuleGetFunction({name})")
    return fn


def launch(fn, index: int, grid, block, stream: int, pointers):
    """``cuLaunchKernel`` of ``fn`` on card ``index`` with the device
    ``pointers`` as its arguments, on ``stream`` (a ``CUstream`` handle
    as an int); no shared memory beyond the kernel's static
    ``__shared__``, no sync.  A refused launch raises."""
    lib = _driver()
    _context(lib, index)
    args = [_c_p(p) for p in pointers]          # kept alive for the call
    params = (_c_p * max(len(args), 1))(
        *[ctypes.cast(ctypes.byref(a), _c_p) for a in args])
    _check(lib, lib.cuLaunchKernel(fn, *grid, *block, 0, _c_p(stream),
                                   params, None), "cuLaunchKernel")
