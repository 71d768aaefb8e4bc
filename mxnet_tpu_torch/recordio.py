"""RecordIO files of the port (mirrors ``mxnet_tpu/recordio.py``;
parity: python/mxnet/recordio.py + dmlc-core RecordIO).

The bytes on disk are the reference's: records framed by the magic
0xced7230a and a length word, payloads padded to 4 bytes; ``IRHeader``
packs ``(flag, label, id, id2)`` as ``<IfQQ``, with a vector label
after it when ``flag`` counts its floats.  ``MXIndexedRecordIO`` keeps
the ``.idx`` sidecar of tab-separated keys and offsets.  URIs open
through :mod:`.filesystem` (local paths, ``file://``, ``mem://``).
Pure host code: nothing here touches a device.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

_MAGIC = 0xCED7230A
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential RecordIO reader/writer (parity: recordio.py:22)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.fp = None
        self.is_open = False
        self.open()

    def open(self):
        # URIs route through the filesystem registry (parity: dmlc
        # Stream::Create) — local paths behave exactly as before, and
        # mem:// / registered remote schemes work transparently
        from .filesystem import open_uri

        if self.flag == "w":
            self.fp = open_uri(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fp = open_uri(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("invalid flag " + self.flag)
        self.is_open = True

    def close(self):
        if self.is_open and self.fp:
            self.fp.close()
            self.is_open = False

    def __del__(self):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf: bytes):
        assert self.writable
        length = len(buf)
        self.fp.write(struct.pack("<II", _MAGIC, length))
        self.fp.write(buf)
        pad = (4 - length % 4) % 4
        if pad:
            self.fp.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        header = self.fp.read(8)
        if len(header) < 8:
            return None
        magic, length = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError(f"invalid RecordIO magic {magic:#x} in {self.uri}")
        buf = self.fp.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.fp.read(pad)
        return buf

    def tell(self):
        return self.fp.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with .idx sidecar (parity: recordio.py:103)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    key, pos = line.strip().split("\t")
                    key = self.key_type(key)
                    self.idx[key] = int(pos)
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.fp.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Parity: recordio.py pack (:176) — header(+vector label) + payload."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        out = struct.pack(_IR_FORMAT, header.flag, header.label, header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        out = struct.pack(_IR_FORMAT, header.flag, header.label, header.id, header.id2)
        out += label.tobytes()
    return out + s


def unpack(s: bytes):
    """Parity: recordio.py unpack (:210)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    payload = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(payload[: header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        payload = payload[header.flag * 4 :]
    return header, payload


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Parity: recordio.py pack_img — encodes with Pillow if available,
    else raw npy bytes (the decode side mirrors this)."""
    from .image import imencode

    return pack(header, imencode(img, quality=quality, img_fmt=img_fmt))


def unpack_img(s, iscolor=-1):
    """Parity: recordio.py unpack_img."""
    from .image import imdecode_np

    header, payload = unpack(s)
    return header, imdecode_np(payload)
