"""Reader of the reference's NDArray-list binary (mirrors the reading
half of ``mxnet_tpu/interop.py``, copied rather than imported).

The format behind ``prefix-0001.params`` (src/ndarray/ndarray.cc:593-694
of the reference): uint64 magic ``0x112`` + reserved, then a dmlc
vector of arrays — each a TShape (uint32 ndim + uint32 dims), a Context
(int32 dev_type + int32 dev_id), an int32 mshadow type flag and the raw
row-major bytes — then a dmlc vector of name strings (``arg:``/``aux:``
prefixed by ``model.save_checkpoint``).  :func:`mxnet_tpu_torch.ndarray.
load` routes such files here.  Writing the format and the reference's
symbol JSON are not ported yet.
"""
from __future__ import annotations

import struct
from typing import Dict

import numpy as np

from .base import MXNetError

_MAGIC = 0x112
# mshadow type flags (mshadow/base.h TypeFlag)
_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32}


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def take(self, n):
        if self.o + n > len(self.d):
            raise MXNetError("truncated .params file")
        out = self.d[self.o:self.o + n]
        self.o += n
        return out

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]


def _read_ndarray(r: _Reader):
    ndim = r.u32()                       # TShape::Save
    if ndim == 0:
        return None                      # is_none() array
    shape = struct.unpack("<%dI" % ndim, r.take(4 * ndim))
    r.i32()                              # Context dev_type (ignored)
    r.i32()                              # Context dev_id
    flag = r.i32()
    dt = _DTYPES.get(flag)
    if dt is None:
        raise MXNetError(f"unknown mshadow type flag {flag}")
    count = int(np.prod(shape))
    raw = r.take(count * np.dtype(dt).itemsize)
    return np.frombuffer(raw, dtype=dt).reshape(shape)


def _read_names(r: _Reader):
    n = r.u64()
    return [r.take(r.u64()).decode() for _ in range(n)]


def load_params_raw(blob: bytes, ctx=None) -> Dict:
    """The contents of a reference NDArray-list file -> ``{name:
    NDArray}`` on ``ctx`` (names exactly as stored, ``arg:``/``aux:``
    prefixes included; unnamed arrays are keyed ``"0"``, ``"1"``, ...)."""
    from .ndarray import NDArray

    r = _Reader(blob)
    if r.u64() != _MAGIC:
        raise MXNetError("not a reference NDArray file (bad magic)")
    r.u64()  # reserved
    n = r.u64()
    arrays = [_read_ndarray(r) for _ in range(n)]
    names = _read_names(r)
    if names and len(names) != len(arrays):
        raise MXNetError(f"{len(arrays)} arrays but {len(names)} names")
    if not names:
        names = [str(i) for i in range(len(arrays))]
    return {name: NDArray(a, ctx=ctx) for name, a in zip(names, arrays)
            if a is not None}
