"""The native record reader/writer and JPEG decoder of the port (the
RecordIO and JPEG half of ``mxnet_tpu/_native.py``).

Both libraries are compiled from the repository's own sources with
``g++`` at first use (``ops/_build.load_host``) into the port's ignored
``build/`` directory — never into ``mxnet_tpu/lib/``:

- ``src/recordio.cc`` (with ``src/mxtpu.h``): the sharded record
  scanner (``mxr_*``), the same byte-range sharding with record
  alignment as ``dmlc::InputSplit``;
- ``src/jpeg_decode.cc``: libjpeg decode to RGB uint8 (``mxj_*``), built
  only where ``-ljpeg`` links (the probe of ``src/Makefile``).  The
  decode runs without the GIL (``ctypes`` releases it), so the decode
  threads of ``ImageRecordIter`` scale.

Only the ``ctypes`` backend is ported.  The engine (``NativeEngine``),
the storage arena (``NativeArena``; the port's staging pool is
``storage.py`` over pinned tensors) and the compiled FFI backend
(``_mxtpu_ext``, ``MXTPU_FFI``) wait for ROADMAP Queue 1 item 11.
Everything degrades as in the reference: without a compiler the callers
take their pure-Python paths, and without libjpeg the decoder returns
None so ``image.imdecode_np`` falls back to Pillow.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .base import MXNetError

__all__ = ["available", "get_lib", "NativeRecordReader", "native_index",
           "NativeRecordWriter", "jpeg_available", "decode_jpeg"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
_lock = threading.Lock()
_LIB = None
_JPEG_LIB = None


def _bind(lib):
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


def get_lib():
    """The record library, built on first use; None when it cannot be
    built here (no compiler, no ``src/``)."""
    global _LIB
    with _lock:
        if _LIB is None:
            from .ops import _build

            try:
                lib = _build.load_host(
                    "mxtpu_recordio",
                    [os.path.join(_SRC, "recordio.cc"),
                     os.path.join(_SRC, "mxtpu.h")])
                _bind(lib)
                _LIB = lib
            except (MXNetError, OSError, AttributeError):
                _LIB = False
        return _LIB or None


def available() -> bool:
    """Whether the native record library is usable."""
    return get_lib() is not None


def _require():
    lib = get_lib()
    if lib is None:
        raise MXNetError("the native record library (src/recordio.cc) "
                         "could not be built")
    return lib


class NativeRecordReader:
    """Sharded sequential RecordIO reader (parity: dmlc::InputSplit +
    RecordIOChunkReader, iter_image_recordio.cc:259-368): shard
    ``part_index`` of ``num_parts`` by byte range, aligned to records."""

    def __init__(self, path, part_index=0, num_parts=1):
        self._lib = _require()
        self._handle = self._lib.mxr_open(os.fsencode(path),
                                          int(part_index), int(num_parts))
        if not self._handle:
            raise IOError(f"cannot open {path}")

    def read(self):
        """The next record's payload as bytes, or None at the end of the
        shard."""
        length = ctypes.c_uint64()
        ptr = self._lib.mxr_next(self._handle, ctypes.byref(length))
        if not ptr:
            return None
        return ctypes.string_at(ptr, length.value)

    def read_batch(self, max_records=1024, buf_bytes=1 << 24):
        """Up to ``max_records`` payloads in one crossing into the
        library; a record larger than ``buf_bytes`` comes through the
        per-record path rather than reading as the end."""
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
        self._lib.mxr_reset(self._handle)

    def close(self):
        if getattr(self, "_handle", None):
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


def native_index(path):
    """The offset of every record in a RecordIO file (a fast ``.idx``
    rebuild): a first pass counts, a second fills."""
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

    def __init__(self, path):
        self._lib = _require()
        self._handle = self._lib.mxr_writer_open(os.fsencode(path))
        if not self._handle:
            raise IOError(f"cannot open {path} for writing")

    def write(self, buf: bytes):
        arr = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
        if self._lib.mxr_write(self._handle, arr, len(buf)) != 0:
            raise IOError("record write failed")

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.mxr_writer_close(self._handle)
        self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


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
