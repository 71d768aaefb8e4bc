"""The port's C libraries, for C and C++ programs (parity:
python/mxnet/libinfo.py's ``find_lib_path``).

Two libraries are built with ``g++`` at first use from the port's
sources (``csrc/``) into the ignored ``build/torch_kernels/``:

- ``predict``: the predict ABI (``MXPredCreate`` ... ``MXPredFree``,
  declared by ``src/mxtpu.h``), from ``csrc/c_predict.cc``;
- ``capi``: the general C API (``src/mxtpu_capi.h``, the ABI of
  ``bindings/cpp/mxtpu.hpp``), from ``csrc/c_api.cc``.

Both embed CPython: they link the interpreter's shared library, with
the flags ``sysconfig`` gives (``Py_ENABLE_SHARED``, ``LDLIBRARY``,
``LIBDIR``), and import ``mxnet_tpu_torch`` into it at their first
call.  A Python built without a shared library cannot host them, and
:func:`find_lib_path` says so.

A C program compiles with ``-I`` of :func:`include_dirs`, links the
file :func:`find_lib_path` returns (its directory as rpath), and runs
with :func:`client_env`'s ``PYTHONPATH`` so that the embedded
interpreter finds the port and its packages::

    g++ client.cc -I<src> <libmxtpu_capi_....so> -Wl,-rpath,<dir>
"""
from __future__ import annotations

import os
import site
import sysconfig

# MXNetError is imported where it is raised: the rest needs the standard
# library alone (python -m mxnet_tpu_torch.amalgamate prints
# embed_flags() without importing torch)

__all__ = ["find_lib_path", "include_dirs", "embed_flags", "client_env"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PKG)
_CSRC = os.path.join(_PKG, "csrc")
_SRC = os.path.join(_REPO, "src")

_LIBS = {
    "predict": ("mxtpu_predict", ("c_predict.cc",), ("mxtpu.h",)),
    "capi": ("mxtpu_capi", ("c_api.cc",), ("mxtpu_capi.h",)),
}


def include_dirs():
    """The directories of the ABIs' headers: ``src/`` (``mxtpu.h``,
    ``mxtpu_capi.h``) and the C++ binding (``mxtpu.hpp``)."""
    return [_SRC, os.path.join(_REPO, "bindings", "cpp")]


def embed_flags():
    """``(cflags, ldflags)`` that embed this interpreter, from
    ``sysconfig``.  Raises :class:`MXNetError` where Python has no shared
    library to link."""
    var = sysconfig.get_config_var
    libdir, ldlib = var("LIBDIR"), var("LDLIBRARY")
    if not var("Py_ENABLE_SHARED") or not ldlib or not libdir or \
            not os.path.exists(os.path.join(libdir, ldlib)):
        from .base import MXNetError

        raise MXNetError(
            f"this Python ({var('LDVERSION')}) has no shared library "
            f"({ldlib!r} in {libdir!r}; Py_ENABLE_SHARED="
            f"{var('Py_ENABLE_SHARED')}): the C ABIs embed it")
    cflags = [f"-I{sysconfig.get_paths()['include']}"]
    ldflags = [f"-L{libdir}", f"-lpython{var('LDVERSION')}",
               f"-Wl,-rpath,{libdir}"]
    for extra in (var("LIBS"), var("SYSLIBS")):
        ldflags.extend((extra or "").split())
    return cflags, ldflags


def find_lib_path(kind="capi") -> str:
    """The path of the port's ``kind`` library (``"predict"`` or
    ``"capi"``), built first when this exact source has no build."""
    from .ops import _build

    if kind not in _LIBS:
        from .base import MXNetError

        raise MXNetError(f"unknown library {kind!r}; have {sorted(_LIBS)}")
    name, sources, headers = _LIBS[kind]
    cflags, ldflags = embed_flags()
    return _build.build_host(
        name, [os.path.join(_CSRC, s) for s in sources]
        + [os.path.join(_CSRC, "py_embed.h")]
        + [os.path.join(_SRC, h) for h in headers],
        include_dirs=[_SRC, _CSRC], cflags=cflags, ldflags=ldflags)


def client_env(env=None) -> dict:
    """``env`` (default: this process's) with ``PYTHONPATH`` led by the
    repository and this interpreter's site-packages, which the
    interpreter embedded in a C program would not find otherwise."""
    env = dict(os.environ if env is None else env)
    paths = [_REPO, *site.getsitepackages()]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env
