"""The filesystem layer of the port, local half (mirrors
``mxnet_tpu/filesystem.py``; parity: dmlc-core's ``dmlc::Stream`` and
``dmlc::InputSplit``).

A scheme registry maps ``scheme://`` to a :class:`FileSystem`: local
paths and ``file://``, and ``mem://`` (in-process, the test double for
remote stores).  :class:`InputSplit` shards one or more URIs by byte
range, each boundary aligned forward to the next record head — the
RecordIO magic for ``.rec``, a newline for text — so no record is read
twice or skipped; ``ImageRecordIter`` falls back to it where the native
reader is not built, and it works over any registered filesystem.

The reference's HTTP(S), S3, GS and WebHDFS adapters wait for ROADMAP
Queue 1 item 11: their schemes are registered to raise, naming that
item; :func:`register_filesystem` plugs in a user's adapter meanwhile.
"""
from __future__ import annotations

import glob as _glob
import io
import os
import struct
import threading
from typing import Dict, List

from .base import MXNetError

__all__ = ["FileSystem", "LocalFileSystem", "MemFileSystem",
           "register_filesystem", "get_filesystem", "open_uri", "is_remote",
           "InputSplit"]

_RECORDIO_MAGIC = 0xCED7230A


class FileSystem:
    """Interface (parity: dmlc::FileSystem)."""

    def open(self, path: str, mode: str = "rb"):
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, pattern: str) -> List[str]:
        """Expand a glob-ish pattern to concrete paths."""
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    def open(self, path, mode="rb"):
        if "w" in mode or "a" in mode:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
        return open(path, mode)

    def size(self, path):
        return os.path.getsize(path)

    def exists(self, path):
        return os.path.exists(path)

    def list(self, pattern):
        hits = sorted(_glob.glob(pattern))
        return hits if hits else [pattern]


class MemFileSystem(FileSystem):
    """In-process filesystem (scheme ``mem://``) — the test double for
    remote stores, and an in-memory space for notebooks."""

    def __init__(self):
        self._files: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def open(self, path, mode="rb"):
        if "a" in mode or "+" in mode:
            raise NotImplementedError(
                "mem:// supports only plain read ('rb') and truncating "
                "write ('wb') modes")
        if "w" in mode:
            fs = self

            class _Writer(io.BytesIO):
                def close(self_inner):
                    with fs._lock:
                        fs._files[path] = self_inner.getvalue()
                    super().close()

            return _Writer()
        with self._lock:
            if path not in self._files:
                raise FileNotFoundError(path)
            return io.BytesIO(self._files[path])

    def size(self, path):
        with self._lock:
            return len(self._files[path])

    def exists(self, path):
        with self._lock:
            return path in self._files

    def list(self, pattern):
        import fnmatch

        with self._lock:
            hits = sorted(p for p in self._files
                          if fnmatch.fnmatch(p, pattern))
        return hits if hits else [pattern]


class _NotPorted(FileSystem):
    """A remote scheme whose adapter is not ported yet."""

    def __init__(self, scheme):
        self.scheme = scheme

    def _refuse(self, *args, **kwargs):
        raise MXNetError(f"the {self.scheme}:// filesystem is not ported "
                         "yet (ROADMAP Queue 1 item 11); register an "
                         "adapter with register_filesystem")

    open = size = exists = list = _refuse


_REGISTRY: Dict[str, FileSystem] = {
    "": LocalFileSystem(),
    "file": LocalFileSystem(),
    "mem": MemFileSystem(),
    **{scheme: _NotPorted(scheme)
       for scheme in ("http", "https", "s3", "gs", "hdfs", "webhdfs")},
}


def register_filesystem(scheme: str, fs: FileSystem):
    """Plug in a remote store adapter (s3/hdfs/gs/...)."""
    _REGISTRY[scheme.rstrip(":/")] = fs


def _split_scheme(uri: str):
    if "://" in uri:
        scheme, rest = uri.split("://", 1)
        return scheme, uri
    return "", uri


def get_filesystem(uri: str) -> FileSystem:
    scheme, _ = _split_scheme(uri)
    fs = _REGISTRY.get(scheme)
    if fs is None:
        raise MXNetError(
            f"no filesystem registered for scheme {scheme!r} "
            f"(register one with mxnet_tpu_torch.filesystem.register_filesystem; "
            f"built-ins: {sorted(_REGISTRY)})")
    return fs


def _strip_local(uri: str) -> str:
    return uri[7:] if uri.startswith("file://") else uri


def open_uri(uri: str, mode: str = "rb"):
    scheme, _ = _split_scheme(uri)
    path = _strip_local(uri) if scheme in ("", "file") else uri
    return get_filesystem(uri).open(path, mode)


def is_remote(uri: str) -> bool:
    """True when the URI names a non-local filesystem (the save/load
    paths stage through a temp file + open_uri for these — checkpoints
    write straight to s3://, gs://, hdfs://, mem://)."""
    scheme, _ = _split_scheme(str(uri))
    return scheme not in ("", "file")


class InputSplit:
    """Byte-range sharded reader over one or more URIs (parity:
    dmlc::InputSplit::Create with part_index/num_parts).

    ``uri`` may be a single path, a comma-separated list, or a glob.
    ``split_type``: 'recordio' aligns shard starts to the RecordIO magic;
    'text' aligns to the next newline.  Iterating yields whole records
    (payload bytes for recordio, lines without trailing newline for text).
    """

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 split_type: str = "recordio"):
        if not 0 <= part_index < num_parts:
            raise MXNetError(f"part_index {part_index} out of range "
                             f"({num_parts} parts)")
        self.split_type = split_type
        pieces = []
        for u in uri.split(","):
            u = u.strip()
            if not u:
                continue
            fs = get_filesystem(u)
            scheme, _ = _split_scheme(u)
            raw = _strip_local(u) if scheme in ("", "file") else u
            for path in fs.list(raw):
                pieces.append((fs, path, fs.size(path)))
        if not pieces:
            raise MXNetError(f"InputSplit: nothing matches {uri!r}")
        self._pieces = pieces
        total = sum(sz for _, _, sz in pieces)
        lo = total * part_index // num_parts
        hi = total * (part_index + 1) // num_parts
        self._lo, self._hi = lo, hi

    # ------------------------------------------------------------- iteration
    def __iter__(self):
        # walk files, tracking the global byte offset; align the start of
        # our [lo, hi) range to the next record head, and keep reading the
        # record that STARTS before hi even if it ends after (dmlc rule:
        # a record belongs to the shard its head falls in).  Only the
        # shard's own byte range is read (seek-based), never whole files.
        global_off = 0
        for fs, path, sz in self._pieces:
            file_lo = max(self._lo - global_off, 0)
            file_hi = min(self._hi - global_off, sz)
            if file_hi <= 0 or file_lo >= sz:
                global_off += sz
                continue
            with fs.open(path, "rb") as f:
                if self.split_type == "recordio":
                    yield from self._iter_recordio(f, file_lo, file_hi, sz)
                else:
                    yield from self._iter_text(f, file_lo, file_hi, sz)
            global_off += sz

    def _iter_recordio(self, f, lo, hi, sz):
        start = (lo + 3) // 4 * 4  # records live at 4-aligned offsets only
        f.seek(start)
        data = f.read(hi - start)  # the shard's slice; extended on demand
        pos = self._align_recordio(data, 0)
        end_rel = hi - start
        while pos < end_rel:
            if pos + 8 > len(data):
                # header cut by the slice boundary — it starts before hi,
                # so the record is ours; pull in the rest of the header
                extra = f.read(pos + 8 - len(data))
                data += extra
                if pos + 8 > len(data):
                    return
            magic, lrec = struct.unpack_from("<II", data, pos)
            if magic != _RECORDIO_MAGIC:
                pos = self._align_recordio(data, pos + 4)
                continue
            length = lrec & ((1 << 29) - 1)
            need = pos + 8 + ((length + 3) // 4) * 4
            if need > len(data):
                # the record straddling hi belongs to this shard: pull in
                # exactly its remainder
                extra = f.read(need - len(data))
                data += extra
                if need > len(data):
                    return  # truncated tail — not a complete record
            yield data[pos + 8: pos + 8 + length]
            pos = need

    @staticmethod
    def _align_recordio(data, pos):
        """First position >= pos that starts a PLAUSIBLE record: the magic
        at a 4-aligned offset whose length word chains to EOF-or-another-
        magic.  The chain check rejects payload bytes that merely look
        like the magic (a payload is stored raw here; scanning alone
        cannot distinguish it)."""
        n = len(data)
        magic = struct.pack("<I", _RECORDIO_MAGIC)
        pos = (pos + 3) // 4 * 4
        while pos + 4 <= n:
            if data[pos:pos + 4] == magic:
                if pos + 8 > n:
                    return pos  # header cut by the slice: caller extends
                (lrec,) = struct.unpack_from("<I", data, pos + 4)
                nxt = pos + 8 + (((lrec & ((1 << 29) - 1)) + 3) // 4) * 4
                if nxt >= n or data[nxt:nxt + 4] == magic:
                    return pos
            pos += 4
        return n

    def _iter_text(self, f, lo, hi, sz):
        if lo == 0:
            start = 0
        else:
            # a shard starts at the first line head AFTER byte lo-1
            f.seek(lo - 1)
            chunk = f.read(hi - lo + 1)
            nl = chunk.find(b"\n")
            if nl == -1:
                return
            start = lo - 1 + nl + 1
        f.seek(start)
        data = f.read(hi - start)
        pos = 0
        end_rel = hi - start
        while pos < end_rel and pos < len(data):
            end = data.find(b"\n", pos)
            while end == -1:
                extra = f.read(1 << 16)  # line straddles hi: extend
                if not extra:
                    end = len(data)
                    break
                data += extra
                end = data.find(b"\n", pos)
            yield data[pos:end]
            pos = end + 1
