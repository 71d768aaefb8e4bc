"""The native runtime of the port (mirrors ``mxnet_tpu/_native.py``):
the host dependency engine, the pooled storage arena, the RecordIO
reader and writer, the JPEG decoder, and the compiled FFI backend.

Everything is compiled from the repository's own sources with ``g++``
at first use (``ops/_build``) into the port's ignored ``build/``
directory — never into ``mxnet_tpu/lib/``:

- the core library from ``src/engine.cc``, ``src/recordio.cc`` and
  ``src/storage.cc`` (with ``src/mxtpu.h``): the var-ordered threaded
  engine (``mxe_*``), the sharded record scanner (``mxr_*``, the byte
  ranges of ``dmlc::InputSplit`` aligned to records) and the size-class
  arena (``mxs_*``);
- ``_mxtpu_ext``, the compiled backend, from ``src/py_ext.cc`` against
  Python's headers (``sysconfig``), linked to the core library's exact
  file: both backends drive ONE engine scheduler and ONE storage pool,
  as in the reference, where ``_ctypes/`` and ``cython/`` share one
  libmxnet;
- ``src/jpeg_decode.cc``: libjpeg decode to RGB uint8 (``mxj_*``), built
  only where ``-ljpeg`` links (the probe of ``src/Makefile``).  The
  decode runs without the GIL (``ctypes`` releases it), so the decode
  threads of ``ImageRecordIter`` scale.

Two interchangeable FFI backends (parity: the reference's ``_ctypes/``
and ``cython/`` pair, MXNET_ENABLE_CYTHON): ``ctypes`` (the bindings
below) and ``cext`` (``_mxtpu_ext``: a record batch comes back as a
list of bytes built in one crossing, an engine op carries an INCREF'd
callable instead of a ctypes trampoline).  The default is the compiled
backend when it builds; ``MXTPU_FFI=ctypes|cext`` pins it, and every
wrapper takes ``backend=``.

Everything degrades as in the reference: without a compiler the callers
take their pure-Python paths (``engine.push`` runs its task on the
calling thread), and without libjpeg the decoder returns None so
``image.imdecode_np`` falls back to Pillow.
"""
from __future__ import annotations

import atexit
import ctypes
import os
import sysconfig
import threading

import numpy as np

from .base import MXNetError

__all__ = ["available", "get_lib", "get_ext", "ffi_backend", "NativeEngine",
           "NativeRecordReader", "native_index", "NativeRecordWriter",
           "NativeArena", "jpeg_available", "decode_jpeg"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
_CORE = tuple(os.path.join(_SRC, f) for f in (
    "engine.cc", "recordio.cc", "storage.cc", "mxtpu.h"))
_lock = threading.Lock()
_LIB = None
_LIB_PATH = None
_EXT = None
_JPEG_LIB = None

ENGINE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def _bind(lib):
    lib.mxe_create.restype = ctypes.c_void_p
    lib.mxe_create.argtypes = [ctypes.c_int]
    lib.mxe_destroy.argtypes = [ctypes.c_void_p]
    lib.mxe_new_var.restype = ctypes.c_int64
    lib.mxe_new_var.argtypes = [ctypes.c_void_p]
    lib.mxe_push_ex.restype = ctypes.c_int
    lib.mxe_push_ex.argtypes = [
        ctypes.c_void_p, ENGINE_FN, ctypes.c_void_p, ENGINE_FN,
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int]
    lib.mxe_wait_for_var.restype = ctypes.c_int
    lib.mxe_wait_for_var.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.mxe_wait_all.argtypes = [ctypes.c_void_p]
    lib.mxe_pending.restype = ctypes.c_int64
    lib.mxe_pending.argtypes = [ctypes.c_void_p]

    lib.mxr_open.restype = ctypes.c_void_p
    lib.mxr_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.mxr_close.argtypes = [ctypes.c_void_p]
    lib.mxr_reset.argtypes = [ctypes.c_void_p]
    lib.mxr_next.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.mxr_next.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_uint64)]
    lib.mxr_next_batch.restype = ctypes.c_int64
    lib.mxr_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
    lib.mxr_index.restype = ctypes.c_int64
    lib.mxr_index.argtypes = [ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_uint64),
                              ctypes.c_int64]
    lib.mxr_writer_open.restype = ctypes.c_void_p
    lib.mxr_writer_open.argtypes = [ctypes.c_char_p]
    lib.mxr_write.restype = ctypes.c_int
    lib.mxr_write.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_uint8),
                              ctypes.c_uint64]
    lib.mxr_writer_close.argtypes = [ctypes.c_void_p]

    lib.mxs_alloc.restype = ctypes.c_void_p
    lib.mxs_alloc.argtypes = [ctypes.c_uint64]
    lib.mxs_free.argtypes = [ctypes.c_void_p]
    lib.mxs_pool_bytes.restype = ctypes.c_uint64
    lib.mxs_release_all.argtypes = []


def get_lib():
    """The core library, built on first use; None when it cannot be
    built here (no compiler, no ``src/``)."""
    global _LIB, _LIB_PATH
    with _lock:
        if _LIB is None:
            from .ops import _build

            try:
                path = _build.build_host("mxtpu", _CORE)
                lib = ctypes.CDLL(path)
                _bind(lib)
                _LIB, _LIB_PATH = lib, path
            except (MXNetError, OSError, AttributeError):
                _LIB = False
        return _LIB or None


def lib_path():
    """The core library's file (None when it cannot be built)."""
    return _LIB_PATH if get_lib() is not None else None


def available() -> bool:
    """Whether the core library is usable."""
    return get_lib() is not None


def _require():
    lib = get_lib()
    if lib is None:
        raise MXNetError("the native runtime (src/engine.cc, recordio.cc, "
                         "storage.cc) could not be built")
    return lib


def get_ext():
    """The compiled FFI module ``_mxtpu_ext`` (``src/py_ext.cc``, linked
    to the core library's file), built on first use; None when it cannot
    be built or loaded (no Python headers)."""
    global _EXT
    core = lib_path()       # before the lock: get_lib() takes it
    with _lock:
        if _EXT is None:
            _EXT = False
            if core is not None:
                import importlib.util

                from .ops import _build

                try:
                    path = _build.build_host(
                        "mxtpu_ext", [os.path.join(_SRC, "py_ext.cc"),
                                      os.path.join(_SRC, "mxtpu.h")],
                        include_dirs=[sysconfig.get_paths()["include"]],
                        ldflags=[core])
                    spec = importlib.util.spec_from_file_location(
                        "_mxtpu_ext", path)
                    mod = importlib.util.module_from_spec(spec)
                    spec.loader.exec_module(mod)
                    _EXT = mod
                except (MXNetError, OSError, ImportError):
                    _EXT = False
        return _EXT or None


def ffi_backend(override=None) -> str:
    """The FFI backend's name: ``override`` > ``MXTPU_FFI`` > the
    compiled backend when it loads (the reference's MXNET_ENABLE_CYTHON
    default) > ``ctypes``."""
    choice = override or os.environ.get("MXTPU_FFI", "").strip().lower()
    if choice == "cext":
        if get_ext() is None:
            raise MXNetError("MXTPU_FFI=cext but _mxtpu_ext (src/py_ext.cc) "
                             "could not be built")
        return "cext"
    if choice == "ctypes":
        return "ctypes"
    if choice:
        raise ValueError(f"unknown FFI backend {choice!r} "
                         "(expected 'ctypes' or 'cext')")
    return "cext" if get_ext() is not None else "ctypes"


class NativeEngine:
    """Host-side async dependency engine (parity: Engine::PushAsync /
    NewVariable / WaitForVar / WaitForAll, include/mxnet/engine.h:75-229).

    Python callables are pushed with read (``const_vars``) and write
    (``mutable_vars``) dependencies: writers to a var run one at a time
    in push order, readers in parallel.  An exception raised by a task
    is kept and raised at the next wait.  Both backends run the same
    scheduler; ``cext`` skips the per-op trampoline and the closure
    registry (the C module owns the op's reference)."""

    def __init__(self, num_threads=0, backend=None):
        self._be = ffi_backend(backend)
        self._errors = []
        if self._be == "cext":
            self._ext = get_ext()
            self._handle = self._ext.eng_create(int(num_threads))
        else:
            self._lib = _require()
            self._handle = self._lib.mxe_create(int(num_threads))
            self._callbacks = {}      # token -> CFUNCTYPE, kept alive
            self._retired = []        # tokens whose op has unwound
            self._cb_lock = threading.Lock()
            self._cb_id = 0
            # one retirement hook for every op: the worker calls it with
            # the op's token strictly after the op returned (the
            # mxe_push_ex contract), the safe point to drop its closure
            self._retire_cb = ENGINE_FN(self._on_retire)
        # tear down while the interpreter can still run callbacks
        atexit.register(self._shutdown)

    def _shutdown(self):
        if getattr(self, "_handle", None) is None:
            return
        try:
            if self._be == "cext":
                self._ext.eng_wait_all(self._handle)
                self._ext.eng_destroy(self._handle)
            else:
                self._lib.mxe_wait_all(self._handle)
                self._reap()
                self._lib.mxe_destroy(self._handle)
        finally:
            self._handle = None

    def new_var(self) -> int:
        if self._be == "cext":
            return int(self._ext.eng_new_var(self._handle))
        return int(self._lib.mxe_new_var(self._handle))

    def _on_retire(self, token_ptr):
        with self._cb_lock:
            self._retired.append(int(token_ptr or 0))

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        if self._be == "cext":
            self._ext.eng_push(self._handle, fn, tuple(const_vars),
                               tuple(mutable_vars), self._errors,
                               int(priority))
            return
        self._reap()
        with self._cb_lock:
            self._cb_id += 1
            token = self._cb_id

        def trampoline(_ctx, _fn=fn):
            try:
                _fn()
            except BaseException as e:  # noqa: BLE001 — raised at a wait
                self._errors.append(e)

        cfn = ENGINE_FN(trampoline)
        with self._cb_lock:
            self._callbacks[token] = cfn
        nc, nm = len(const_vars), len(mutable_vars)
        carr = (ctypes.c_int64 * max(nc, 1))(*const_vars)
        marr = (ctypes.c_int64 * max(nm, 1))(*mutable_vars)
        rc = self._lib.mxe_push_ex(self._handle, cfn, None, self._retire_cb,
                                   ctypes.c_void_p(token), carr, nc, marr,
                                   nm, int(priority))
        if rc != 0:
            with self._cb_lock:
                self._callbacks.pop(token, None)
            if rc == -2:
                raise ValueError(
                    "unknown engine var id in const/mutable var lists "
                    "(freed, or created on a different engine?)")
            raise ValueError(
                "duplicate or overlapping const/mutable var lists "
                "(parity: ThreadedEngine::CheckDuplicate)")

    def _reap(self):
        """Drop the closures of retired ops (a token is retired only
        after its trampoline returned)."""
        with self._cb_lock:
            for token in self._retired:
                self._callbacks.pop(token, None)
            self._retired.clear()

    def wait_for_var(self, var: int):
        if self._be == "cext":
            self._ext.eng_wait_for_var(self._handle, int(var))
        else:
            self._lib.mxe_wait_for_var(self._handle, int(var))
            self._reap()
        self._raise_pending()

    def wait_all(self):
        if self._be == "cext":
            self._ext.eng_wait_all(self._handle)
        else:
            self._lib.mxe_wait_all(self._handle)
            self._reap()
        self._raise_pending()

    def pending(self) -> int:
        if self._be == "cext":
            return int(self._ext.eng_pending(self._handle))
        return int(self._lib.mxe_pending(self._handle))

    def _raise_pending(self):
        if self._errors:
            raise self._errors.pop(0)

    def __del__(self):
        try:
            self._shutdown()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class NativeRecordReader:
    """Sharded sequential RecordIO reader (parity: dmlc::InputSplit +
    RecordIOChunkReader, iter_image_recordio.cc:259-368): shard
    ``part_index`` of ``num_parts`` by byte range, aligned to records."""

    def __init__(self, path, part_index=0, num_parts=1, backend=None):
        self._be = ffi_backend(backend)
        if self._be == "cext":
            self._ext = get_ext()
            self._handle = self._ext.rec_open(os.fsdecode(path),
                                              int(part_index),
                                              int(num_parts))
            return
        self._lib = _require()
        self._handle = self._lib.mxr_open(os.fsencode(path),
                                          int(part_index), int(num_parts))
        if not self._handle:
            raise IOError(f"cannot open {path}")

    def read(self):
        """The next record's payload as bytes, or None at the end of the
        shard."""
        if self._be == "cext":
            return self._ext.rec_next(self._handle)
        length = ctypes.c_uint64()
        ptr = self._lib.mxr_next(self._handle, ctypes.byref(length))
        if not ptr:
            return None
        return ctypes.string_at(ptr, length.value)

    def read_batch(self, max_records=1024, buf_bytes=1 << 24):
        """Up to ``max_records`` payloads in one crossing into the
        library; a record larger than ``buf_bytes`` comes through the
        per-record path rather than reading as the end.  The compiled
        backend builds the list inside the crossing."""
        if self._be == "cext":
            return self._ext.rec_next_batch(self._handle, int(max_records))
        if not hasattr(self, "_batch_buf") or len(self._batch_buf) < buf_bytes:
            self._batch_buf = (ctypes.c_uint8 * buf_bytes)()
            self._batch_lens = (ctypes.c_uint64 * max(max_records, 1024))()
        if len(self._batch_lens) < max_records:
            self._batch_lens = (ctypes.c_uint64 * max_records)()
        n = self._lib.mxr_next_batch(self._handle, self._batch_buf,
                                     buf_bytes, self._batch_lens,
                                     max_records)
        if n <= 0:
            rec = self.read()
            return [rec] if rec is not None else []
        raw = memoryview(self._batch_buf)
        lens = np.frombuffer(self._batch_lens, dtype=np.uint64, count=n)
        ends = np.cumsum(lens)
        starts = ends - lens
        return [bytes(raw[int(s):int(e)]) for s, e in zip(starts, ends)]

    def reset(self):
        if self._be == "cext":
            self._ext.rec_reset(self._handle)
        else:
            self._lib.mxr_reset(self._handle)

    def close(self):
        if getattr(self, "_handle", None):
            if self._be == "cext":
                self._ext.rec_close(self._handle)
            else:
                self._lib.mxr_close(self._handle)
        self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def __iter__(self):
        while True:
            rec = self.read()
            if rec is None:
                return
            yield rec


def native_index(path, backend=None):
    """The offset of every record in a RecordIO file (a fast ``.idx``
    rebuild): a first pass counts, a second fills."""
    if ffi_backend(backend) == "cext":
        return np.asarray(get_ext().rec_index(os.fsdecode(path)),
                          dtype=np.uint64)
    lib = _require()
    total = lib.mxr_index(os.fsencode(path), (ctypes.c_uint64 * 1)(), 0)
    if total < 0:
        raise IOError(f"cannot open {path}")
    buf = (ctypes.c_uint64 * max(total, 1))()
    n = lib.mxr_index(os.fsencode(path), buf, total)
    if n < 0:
        raise IOError(f"cannot open {path}")
    n = min(n, total)
    return np.ctypeslib.as_array(buf, shape=(max(total, 1),))[:n].copy()


class NativeRecordWriter:
    """Sequential RecordIO writer: the reference's framing, byte for
    byte."""

    def __init__(self, path, backend=None):
        self._be = ffi_backend(backend)
        if self._be == "cext":
            self._ext = get_ext()
            self._handle = self._ext.rec_writer_open(os.fsdecode(path))
            return
        self._lib = _require()
        self._handle = self._lib.mxr_writer_open(os.fsencode(path))
        if not self._handle:
            raise IOError(f"cannot open {path} for writing")

    def write(self, buf: bytes):
        if self._be == "cext":
            self._ext.rec_write(self._handle, bytes(buf))
            return
        arr = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
        if self._lib.mxr_write(self._handle, arr, len(buf)) != 0:
            raise IOError("record write failed")

    def close(self):
        if getattr(self, "_handle", None):
            if self._be == "cext":
                self._ext.rec_writer_close(self._handle)
            else:
                self._lib.mxr_writer_close(self._handle)
        self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class NativeArena:
    """Pooled host buffers (parity: Storage::Alloc/Free with the pooled
    manager's recycling, src/storage/pooled_storage_manager.h): numpy
    views over arena-owned memory; :meth:`free` returns a block to its
    power-of-two size class.  Every arena of the process, on either
    backend, shares the library's one pool."""

    def __init__(self, backend=None):
        self._be = ffi_backend(backend)
        if self._be == "cext":
            self._ext = get_ext()
        else:
            self._lib = _require()
        # keyed by the buffer's address: id() of a view can be reused
        # once it is collected, orphaning the native block
        self._ptrs = set()

    def alloc(self, shape, dtype=np.float32):
        dtype = np.dtype(dtype)
        count = int(np.prod(shape))
        nbytes = max(count * dtype.itemsize, 1)
        if self._be == "cext":
            ptr, buf = self._ext.storage_alloc(nbytes)
        else:
            ptr = self._lib.mxs_alloc(nbytes)
            if not ptr:
                raise MemoryError(f"arena alloc of {nbytes} bytes failed")
            buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dtype, count=count).reshape(shape)
        self._ptrs.add(int(ptr))
        return arr

    def free(self, arr):
        ptr = int(arr.ctypes.data)
        if ptr not in self._ptrs:
            return
        self._ptrs.discard(ptr)
        if self._be == "cext":
            self._ext.storage_free(ptr)
        else:
            self._lib.mxs_free(ptr)

    def pool_bytes(self) -> int:
        if self._be == "cext":
            return int(self._ext.storage_pool_bytes())
        return int(self._lib.mxs_pool_bytes())

    def release_all(self):
        if self._be == "cext":
            self._ext.storage_release_all()
        else:
            self._lib.mxs_release_all()


def _get_jpeg_lib():
    """The JPEG library, built where ``-ljpeg`` links; None elsewhere."""
    global _JPEG_LIB
    if _JPEG_LIB is None:
        from .ops import _build

        lib = False
        if _build.links("jpeg"):
            try:
                lib = _build.load_host(
                    "mxtpu_jpeg", [os.path.join(_SRC, "jpeg_decode.cc"),
                                   os.path.join(_SRC, "mxtpu.h")],
                    libs=("jpeg",))
                lib.mxj_dims.restype = ctypes.c_int
                lib.mxj_dims.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                    ctypes.POINTER(ctypes.c_uint32),
                    ctypes.POINTER(ctypes.c_uint32),
                    ctypes.POINTER(ctypes.c_uint32)]
                lib.mxj_decode.restype = ctypes.c_int
                lib.mxj_decode.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
            except (MXNetError, OSError, AttributeError):
                lib = False
        with _lock:
            if _JPEG_LIB is None:
                _JPEG_LIB = lib
    return _JPEG_LIB or None


def jpeg_available() -> bool:
    """Whether the native libjpeg decoder is usable here."""
    return _get_jpeg_lib() is not None


def decode_jpeg(buf):
    """A JPEG byte string as an RGB uint8 HWC array through libjpeg, or
    None when the native decoder is missing or the stream does not
    decode (the caller falls back to Pillow)."""
    lib = _get_jpeg_lib()
    if lib is None:
        return None
    raw = bytes(buf)
    src = ctypes.cast(ctypes.c_char_p(raw), ctypes.POINTER(ctypes.c_uint8))
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    c = ctypes.c_uint32()
    if lib.mxj_dims(src, len(raw), ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(c)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.mxj_decode(src, len(raw),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      out.nbytes) != 0:
        return None
    return out
