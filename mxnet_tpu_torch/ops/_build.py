"""Build and load the port's hand-written CUDA kernels.

Each source under ``ops/csrc/`` has a plain C interface and is compiled
by ``nvcc`` into its own shared library, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Libraries go to
``build/torch_kernels/`` beside the package (a directory ``.gitignore``
lists), named by the hash of their source and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  The
compiler's report (``-Xptxas -v``) is kept beside each library as
``.log`` and read back with it, so ``build_logs`` holds it whether this
process compiled the library or found it built.  Nothing is built at
import: the first launch builds.

Host code (the native runtime and the JPEG decoder of ``src/``, the
compiled FFI backend, the C ABIs of ``csrc/``) is built the same way by
:func:`build_host`/:func:`load_host`, with ``g++`` in place of
``nvcc``, into the same directory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["NVCC_FLAGS", "HOST_FLAGS", "source_path", "nvcc_path",
           "nvcc_command", "build", "load", "links", "build_host",
           "load_host"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_kernels")

# sm_90a (not sm_90): the target that admits Hopper's wgmma/setmaxnreg;
# -Xptxas -v puts each kernel's registers and spills into build_logs
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
# compiler output (the -Xptxas -v reports) of every library loaded or
# built by this process, by source name
build_logs = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then
    the toolkit PyTorch found; raises :class:`MXNetError` without one."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils import cpp_extension

    root = cpp_extension.CUDA_HOME
    if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
        return os.path.join(root, "bin", "nvcc")
    raise MXNetError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use")


def nvcc_command(src: str, out: str) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, src]


def _lib_path(name: str, src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _log_path(lib_path: str) -> str:
    return lib_path[:-len(".so")] + ".log"


def _compile(names) -> None:
    """Build every source of ``names`` that has no library yet: one nvcc
    per source, all started together, then wait for all.  Called with
    ``_lock`` held."""
    procs = []
    for name in names:
        src = source_path(name)
        path = _lib_path(name, src)
        if os.path.exists(path):
            if name not in build_logs and os.path.exists(_log_path(path)):
                with open(_log_path(path)) as f:
                    build_logs[name] = f.read()
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        procs.append((name, src, path, tmp, subprocess.Popen(
            nvcc_command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, src, path, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src} (exit "
                          f"{proc.returncode}):\n{out}{err}")
            continue
        with open(tmp + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp + ".log", _log_path(path))
        os.replace(tmp, path)
        build_logs[name] = out + err
    if failed:
        raise MXNetError("\n".join(failed))


def build(names) -> None:
    """Compile (in parallel) and load the libraries of ``names``."""
    with _lock:
        _compile([n for n in names if n not in _libs])
    for name in names:
        load(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, compiled first if no
    build of this exact source exists.  Thread-safe; one build per
    process at most, and concurrent processes race benignly (each writes
    a private file and renames it into place)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _compile([name])
        lib = ctypes.CDLL(_lib_path(name, source_path(name)))
        _libs[name] = lib
        return lib


# the flags of src/Makefile (CXXFLAGS), for host libraries
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_links = {}


def links(lib: str) -> bool:
    """Whether ``g++`` links an empty program against ``-l<lib>`` (the
    probe of ``src/Makefile``); asked once per process."""
    with _lock:
        if lib not in _links:
            cxx = os.environ.get("CXX") or shutil.which("g++")
            ok = False
            if cxx:
                try:
                    ok = subprocess.run(
                        [cxx, "-x", "c++", "-", f"-l{lib}", "-o",
                         os.devnull], input="int main(){return 0;}",
                        capture_output=True, text=True,
                        timeout=120).returncode == 0
                except (OSError, subprocess.SubprocessError):
                    ok = False
            _links[lib] = ok
        return _links[lib]


def build_host(name: str, sources, libs=(), include_dirs=(), cflags=(),
               ldflags=()) -> str:
    """The path of host library ``name``, compiled by ``g++`` with
    :data:`HOST_FLAGS` plus ``cflags`` and ``-I`` of ``include_dirs``
    from ``sources`` (paths; headers they include are hashed too when
    listed) and linked with ``ldflags`` and ``libs`` if no build of
    these exact sources and flags exists.  A library named in
    ``ldflags`` by its path is hashed by its path, which names its
    content.  Raises :class:`MXNetError` when the compiler is missing or
    fails."""
    flags = (HOST_FLAGS + tuple(cflags)
             + tuple(f"-I{d}" for d in include_dirs))
    tail = tuple(ldflags) + tuple(f"-l{x}" for x in libs)
    h = hashlib.sha256(" ".join(flags + ("|",) + tail).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    with _lock:
        if os.path.exists(path):
            return path
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise MXNetError(f"g++ not found: {name} is built from "
                             "source at first use")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cc = [s for s in sources if s.endswith((".cc", ".cpp"))]
        proc = subprocess.run([cxx, *flags, *cc, "-o", tmp, *tail],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise MXNetError(f"g++ failed to build {name} (exit "
                             f"{proc.returncode}):\n{proc.stdout}"
                             f"{proc.stderr}")
        os.replace(tmp, path)
        return path


def load_host(name: str, sources, libs=()) -> ctypes.CDLL:
    """The loaded host library ``name`` (:func:`build_host` with the
    same arguments), loaded once per process."""
    with _lock:
        lib = _libs.get(name)
    if lib is None:
        path = build_host(name, sources, libs)
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(path))
    return lib
