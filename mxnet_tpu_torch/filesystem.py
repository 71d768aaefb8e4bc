"""The filesystem layer of the port (mirrors ``mxnet_tpu/filesystem.py``;
parity: dmlc-core's ``dmlc::Stream`` and ``dmlc::InputSplit``).

A scheme registry maps ``scheme://`` to a :class:`FileSystem`: local
paths and ``file://``, ``mem://`` (in-process), and the remote stores
the reference reaches through dmlc-core — ``http(s)://`` byte-range
reads, ``s3://`` (AWS SigV4), ``gs://`` (a bearer token) and
``hdfs://``/``webhdfs://`` (the WebHDFS REST API).  Every remote store
reads in block-aligned ranges and writes whole objects: a writer
buffers and uploads once on ``close``, and discards its buffer when the
``with`` body raised.  The endpoints and credentials are the
reference's environment names: ``S3_ENDPOINT``, ``AWS_ACCESS_KEY_ID``,
``AWS_SECRET_ACCESS_KEY``, ``AWS_SESSION_TOKEN``, ``AWS_REGION``/
``AWS_DEFAULT_REGION``; ``GS_ENDPOINT``, ``GS_OAUTH2_TOKEN``/
``GOOGLE_OAUTH_ACCESS_TOKEN``; ``WEBHDFS_ENDPOINT``,
``HADOOP_USER_NAME``, ``WEBHDFS_TOKEN``.  Pure host code.

:class:`InputSplit` shards one or more URIs by byte range, each
boundary aligned forward to the next record head — the RecordIO magic
for ``.rec``, a newline for text — so no record is read twice or
skipped; ``ImageRecordIter`` reads every remote scheme through it, and
it works over any registered filesystem.
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
           "HttpFileSystem", "S3FileSystem", "GSFileSystem",
           "WebHdfsFileSystem", "register_filesystem", "get_filesystem",
           "open_uri", "is_remote", "InputSplit"]

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


class HttpFileSystem(FileSystem):
    """HTTP(S) byte-range filesystem — the working model of every remote
    object store the reference reaches through dmlc-core (S3, GCS, and
    WebHDFS all expose exactly this Range interface; presigned URLs work
    too, since size discovery falls back from HEAD to a 1-byte Range GET).
    Reads are lazy and buffered: `read` fetches block_size-aligned spans
    with a Range header, so small sequential reads (RecordIO headers)
    cost one round trip per block, and InputSplit shards pull just their
    slice of a remote file.  Servers that ignore Range (plain 200) are
    handled by downloading the body once and serving reads from cache."""

    def __init__(self, block_size: int = 1 << 20, timeout: float = 60.0):
        self.block_size = block_size
        self.timeout = timeout
        self._size_cache: Dict[str, int] = {}

    class _RangeFile(io.RawIOBase):
        def __init__(self, fs, url, size):
            self._fs = fs
            self._url = url
            self._size = size
            self._pos = 0
            self._buf = b""       # last fetched block
            self._buf_lo = 0
            self._whole = None    # full body cache (non-Range servers)

        def seekable(self):
            return True

        def readable(self):
            return True

        def seek(self, off, whence=io.SEEK_SET):
            if whence == io.SEEK_SET:
                self._pos = off
            elif whence == io.SEEK_CUR:
                self._pos += off
            else:
                self._pos = self._size + off
            return self._pos

        def tell(self):
            return self._pos

        def _fetch(self, lo, hi):
            """[lo, hi) from the server; populates _whole on 200."""
            data, partial = self._fs._fetch_range(self._url, lo, hi)
            if not partial:
                # server ignored the range: it sent the whole body — keep
                # it so later reads cost no further transfers
                self._whole = data
                return data[lo:hi]
            return data

        def read(self, n=-1):
            if n is None or n < 0:
                n = self._size - self._pos
            n = min(n, self._size - self._pos)
            if n <= 0:
                return b""
            if self._whole is not None:
                out = self._whole[self._pos:self._pos + n]
                self._pos += len(out)
                return out
            lo, hi = self._pos, self._pos + n
            blo, bhi = self._buf_lo, self._buf_lo + len(self._buf)
            if not (blo <= lo and hi <= bhi):
                # block-aligned read-ahead: one round trip covers many
                # small sequential reads (RecordIO header/payload/pad)
                bs = max(self._fs.block_size, n)
                fetch_lo = lo
                fetch_hi = min(lo + bs, self._size)
                self._buf = self._fetch(fetch_lo, fetch_hi)
                self._buf_lo = fetch_lo
                if self._whole is not None:
                    return self.read(n)
                blo = fetch_lo
            out = self._buf[lo - blo:lo - blo + n]
            self._pos += len(out)
            return out

    # auth hook: subclasses (S3/GS) rewrite the URI to a concrete endpoint
    # URL and inject auth headers; the base class is a pass-through
    def _prepare(self, uri, headers, method, data=None):
        return uri, headers

    # range hook: how [lo, hi) is expressed on the wire.  HTTP object
    # stores use a Range header; WebHDFS uses offset/length query params.
    # Returns (bytes, is_partial) — is_partial False means the whole body
    # arrived (server ignored the range).
    def _fetch_range(self, uri, lo, hi):
        with self._urlopen(uri, headers={
                "Range": f"bytes={lo}-{hi - 1}"}) as r:
            return r.read(), r.status == 206

    def _urlopen(self, uri, headers=None, method="GET", data=None):
        import urllib.request

        url, hdrs = self._prepare(uri, dict(headers or {}), method,
                                  data=data)
        req = urllib.request.Request(url, headers=hdrs, method=method,
                                     data=data)
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _put(self, path, data):
        raise MXNetError(f"{type(self).__name__} is read-only")

    def open(self, path, mode="rb"):
        if "a" in mode or "+" in mode:
            raise MXNetError("object stores support only 'rb' and "
                             "truncating 'wb'")
        if "w" in mode:
            if type(self)._put is HttpFileSystem._put:
                # fail at open, not buried in a close the caller (or GC)
                # might swallow
                raise MXNetError(f"{type(self).__name__} is read-only")
            fs = self

            class _Writer(io.BytesIO):
                """Buffer locally, upload the whole object on close —
                object stores write whole objects, not streams (the
                reference's dmlc-core S3 writer buffers the same way).

                A failed `with` body must NOT publish: a half-written
                buffer uploaded on close would overwrite a good remote
                object (WebHDFS create uses overwrite=true) with a
                truncated one, so __exit__ discards on exception."""

                _discard = False

                def __exit__(self_inner, exc_type, exc, tb):
                    if exc_type is not None:
                        self_inner._discard = True
                    return super().__exit__(exc_type, exc, tb)

                def close(self_inner):
                    if not self_inner.closed and not self_inner._discard:
                        fs._put(path, self_inner.getvalue())
                        fs._size_cache.pop(path, None)
                    super().close()

            return _Writer()
        return self._RangeFile(self, path, self.size(path))

    def size(self, path):
        import urllib.error

        cached = self._size_cache.get(path)
        if cached is not None:
            return cached

        def done(n):
            self._size_cache[path] = n
            return n

        try:
            with self._urlopen(path, method="HEAD") as r:
                cl = r.headers["Content-Length"]
                if cl is not None:
                    return done(int(cl))
        except (urllib.error.URLError, OSError):
            pass  # presigned URLs often sign GET only — fall through
        try:
            # 1-byte Range GET: Content-Range carries the total size
            with self._urlopen(path, headers={"Range": "bytes=0-0"}) as r:
                cr = r.headers.get("Content-Range")  # "bytes 0-0/12345"
                total = cr.rsplit("/", 1)[1] if cr and "/" in cr else None
                if total and total != "*":  # '*' = RFC 7233 unknown length
                    return done(int(total))
                cl = r.headers.get("Content-Length")
                if r.status == 200 and cl is not None:
                    return done(int(cl))  # server sent the whole body
        except (urllib.error.URLError, OSError, ValueError) as exc:
            raise MXNetError(f"http filesystem: cannot reach {path!r}: "
                             f"{exc}") from exc
        raise MXNetError(f"http filesystem: server for {path!r} reports "
                         "no usable Content-Length/Content-Range; cannot "
                         "do ranged reads over a chunked stream")

    def exists(self, path):
        try:
            self.size(path)
            return True
        except MXNetError:
            return False

    def list(self, pattern):
        return [pattern]  # no server-side listing over plain HTTP


_EMPTY_SHA256 = (
    "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855")


def _sigv4_headers(method, host, path, headers, access_key, secret_key,
                   region, amzdate, session_token=None, service="s3",
                   payload_hash=_EMPTY_SHA256):
    """AWS Signature Version 4 (GET/HEAD, and PUT when ``payload_hash``
    is the body's sha256).

    Pure-stdlib signing of the canonical request -> string-to-sign ->
    derived key chain, per the SigV4 spec; returns the full header dict
    including Authorization.  Split out from S3FileSystem so it can be
    pinned against the published AWS test vector.
    """
    import hashlib
    import hmac
    from urllib.parse import quote

    hdrs = dict(headers)
    hdrs["x-amz-date"] = amzdate
    hdrs["x-amz-content-sha256"] = payload_hash
    if session_token:
        hdrs["x-amz-security-token"] = session_token
    hdrs["host"] = host

    canon_uri = quote(path, safe="/~")
    items = sorted((k.lower(), " ".join(str(v).split()))
                   for k, v in hdrs.items())
    signed = ";".join(k for k, _ in items)
    canon_headers = "".join(f"{k}:{v}\n" for k, v in items)
    canonical = "\n".join([method, canon_uri, "", canon_headers, signed,
                           payload_hash])
    datestamp = amzdate[:8]
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amzdate, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])

    def _hmac(key, msg):
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(_hmac(_hmac(k, region), service), "aws4_request")
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    hdrs["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}")
    del hdrs["host"]  # urllib sets Host itself; it was only for signing
    return hdrs


class S3FileSystem(HttpFileSystem):
    """s3://bucket/key with AWS SigV4 request signing (parity: dmlc-core's
    USE_S3 InputSplit backend, make/config.mk:138-146; credentials come
    from the same env vars the reference documents in
    docs/how_to/env_var.md — AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY).

    Also honored: AWS_SESSION_TOKEN, AWS_REGION/AWS_DEFAULT_REGION
    (default us-east-1), and S3_ENDPOINT (custom/on-prem endpoint,
    path-style addressing — also how the tests point the signer at a
    local double).  Unsigned public-bucket access works when no
    credentials are set.  A writer uploads the whole object in one
    signed PUT on close; listing requires a full URI (no server-side
    wildcard).
    """

    def __init__(self, **kw):
        super().__init__(**kw)

    def _creds(self):
        env = os.environ
        return (env.get("AWS_ACCESS_KEY_ID"),
                env.get("AWS_SECRET_ACCESS_KEY"),
                env.get("AWS_SESSION_TOKEN"),
                env.get("AWS_REGION",
                        env.get("AWS_DEFAULT_REGION", "us-east-1")))

    def _prepare(self, uri, headers, method, data=None):
        from urllib.parse import quote, urlsplit

        parts = urlsplit(uri)
        bucket, key = parts.netloc, parts.path.lstrip("/")
        endpoint = os.environ.get("S3_ENDPOINT")
        if endpoint:
            endpoint = endpoint.rstrip("/")
            base = endpoint if "://" in endpoint else "https://" + endpoint
            ep = urlsplit(base)
            host = ep.netloc
            # any endpoint path prefix (S3 behind a reverse-proxy subpath)
            # must be part of the SIGNED canonical URI too, or the server
            # rejects with SignatureDoesNotMatch
            path = f"{ep.path}/{bucket}/{key}"
            url = f"{ep.scheme}://{ep.netloc}" + quote(path, safe="/~")
        else:
            _, _, _, region = self._creds()
            host = f"{bucket}.s3.{region}.amazonaws.com"
            path = "/" + key
            url = f"https://{host}" + quote(path, safe="/~")
        ak, sk, tok, region = self._creds()
        if ak and sk:
            import datetime as _dt
            import hashlib

            amzdate = _dt.datetime.now(_dt.timezone.utc).strftime(
                "%Y%m%dT%H%M%SZ")
            payload_hash = (hashlib.sha256(data).hexdigest()
                            if data is not None else _EMPTY_SHA256)
            headers = _sigv4_headers(method, host, path, headers, ak, sk,
                                     region, amzdate, tok,
                                     payload_hash=payload_hash)
        return url, headers

    def _put(self, path, data):
        """Signed PUT of a whole object (parity: dmlc-core's S3 write
        stream, which buffers and multipart-uploads; whole-object PUT
        covers the checkpoint/save_checkpoint use case)."""
        with self._urlopen(path, method="PUT", data=data) as r:
            if r.status not in (200, 201):
                raise MXNetError(f"s3 PUT {path!r} -> HTTP {r.status}")


class GSFileSystem(HttpFileSystem):
    """gs://bucket/object over the GCS XML/JSON endpoint with a bearer
    token (GS_OAUTH2_TOKEN or GOOGLE_OAUTH_ACCESS_TOKEN env; unset =
    unauthenticated access to public objects).  GS_ENDPOINT overrides the
    endpoint for test doubles / emulators."""

    def _prepare(self, uri, headers, method, data=None):
        from urllib.parse import quote, urlsplit

        parts = urlsplit(uri)
        bucket, key = parts.netloc, parts.path.lstrip("/")
        base = os.environ.get("GS_ENDPOINT",
                              "https://storage.googleapis.com").rstrip("/")
        url = base + quote(f"/{bucket}/{key}", safe="/~")
        token = os.environ.get("GS_OAUTH2_TOKEN",
                               os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN"))
        if token:
            headers["Authorization"] = f"Bearer {token}"
        return url, headers

    def _put(self, path, data):
        # the GCS XML API accepts whole-object PUT on the same URL shape
        with self._urlopen(path, method="PUT", data=data) as r:
            if r.status not in (200, 201):
                raise MXNetError(f"gs PUT {path!r} -> HTTP {r.status}")


class WebHdfsFileSystem(HttpFileSystem):
    """hdfs://namenode[:port]/path over the WebHDFS REST API (the
    transport dmlc-core's libhdfs-free deployments use; parity for the
    reference's USE_HDFS InputSplit backend without a JVM).

    Ranged reads map to ``op=OPEN&offset=&length=`` (the namenode's 307
    redirect to a datanode is followed by urllib); size comes from
    ``op=GETFILESTATUS``.  Auth: ``HADOOP_USER_NAME`` adds the simple
    ``user.name`` query credential; ``WEBHDFS_TOKEN`` adds a delegation
    token.  ``WEBHDFS_ENDPOINT`` overrides the namenode address (also
    how tests point at a loopback double); default port 9870.
    """

    def _base(self, parts):
        ep = os.environ.get("WEBHDFS_ENDPOINT")
        if ep:
            ep = ep.rstrip("/")
            return ep if "://" in ep else "http://" + ep
        host = parts.netloc or "localhost"
        if ":" not in host:
            host += ":9870"
        return f"http://{host}"

    def _url(self, uri, op, extra=""):
        from urllib.parse import quote, urlsplit

        parts = urlsplit(uri)
        auth = ""
        user = os.environ.get("HADOOP_USER_NAME")
        if user:
            auth += "&user.name=" + quote(user, safe="")
        token = os.environ.get("WEBHDFS_TOKEN")
        if token:
            auth += "&delegation=" + quote(token, safe="")
        return (f"{self._base(parts)}/webhdfs/v1"
                f"{quote(parts.path, safe='/~')}?op={op}{extra}{auth}")

    def _fetch_range(self, uri, lo, hi):
        url = self._url(uri, "OPEN", f"&offset={lo}&length={hi - lo}")
        with self._urlopen(url) as r:
            return r.read(), True  # OPEN always returns exactly the span

    def _put(self, path, data):
        """WebHDFS CREATE (the two-step namenode->datanode dance): PUT
        op=CREATE gets a 307 with the datanode Location, the body goes
        there.  Servers that skip the redirect (single-node doubles)
        accept the body on the first request."""
        import urllib.error
        import urllib.request

        url = self._url(path, "CREATE", "&overwrite=true")

        class _NoRedirect(urllib.request.HTTPRedirectHandler):
            def redirect_request(self, *a, **kw):
                return None

        opener = urllib.request.build_opener(_NoRedirect)
        req = urllib.request.Request(url, method="PUT", data=b"")
        try:
            with opener.open(req, timeout=self.timeout) as r:
                status, location = r.status, r.headers.get("Location")
        except urllib.error.HTTPError as e:
            status, location = e.code, e.headers.get("Location")
        if status == 307:
            if not location:
                raise MXNetError(
                    f"webhdfs CREATE {path!r}: 307 without Location")
            target = location
        elif status in (200, 201):
            # no redirect (single-node doubles): the body goes straight
            # to the namenode URL
            target = url
        else:
            raise MXNetError(f"webhdfs CREATE {path!r} -> HTTP {status}")
        req2 = urllib.request.Request(target, method="PUT", data=data)
        with urllib.request.urlopen(req2, timeout=self.timeout) as r2:
            if r2.status not in (200, 201):
                raise MXNetError(
                    f"webhdfs PUT {path!r} -> HTTP {r2.status}")
        self._size_cache.pop(path, None)

    def size(self, path):
        import json as _json

        cached = self._size_cache.get(path)
        if cached is not None:
            return cached
        try:
            with self._urlopen(self._url(path, "GETFILESTATUS")) as r:
                st = _json.loads(r.read().decode())
            n = int(st["FileStatus"]["length"])
        except Exception as exc:  # noqa: BLE001
            raise MXNetError(
                f"webhdfs: cannot stat {path!r}: {exc}") from exc
        self._size_cache[path] = n
        return n

    def _liststatus(self, diruri):
        import json as _json

        with self._urlopen(self._url(diruri, "LISTSTATUS")) as r:
            st = _json.loads(r.read().decode())
        return st["FileStatuses"]["FileStatus"]

    def list(self, pattern):
        import fnmatch
        import urllib.error
        from urllib.parse import urlsplit

        parts = urlsplit(pattern)
        if any(c in parts.path for c in "*?["):
            # glob: LISTSTATUS the parent dir and fnmatch basenames (dmlc
            # wildcard semantics; one level, like dmlc's InputSplit)
            parent, _, leaf = parts.path.rstrip("/").rpartition("/")
            base = f"{parts.scheme}://{parts.netloc}{parent}"
            try:
                entries = self._liststatus(base)
            except (urllib.error.URLError, OSError, KeyError,
                    ValueError) as exc:
                raise MXNetError(
                    f"webhdfs: cannot list {base!r} for pattern "
                    f"{pattern!r}: {exc}") from exc
            hits = sorted(f"{base}/{e['pathSuffix']}" for e in entries
                          if fnmatch.fnmatch(e["pathSuffix"], leaf))
            return hits if hits else [pattern]
        try:
            entries = self._liststatus(pattern)
        except Exception:
            return [pattern]  # plain file (or unlistable): single entry
        base = pattern.rstrip("/")
        return [base if e["pathSuffix"] == "" else
                f"{base}/{e['pathSuffix']}" for e in entries]


_REGISTRY: Dict[str, FileSystem] = {
    "": LocalFileSystem(),
    "file": LocalFileSystem(),
    "mem": MemFileSystem(),
    "http": HttpFileSystem(),
    "https": HttpFileSystem(),
    "s3": S3FileSystem(),
    "gs": GSFileSystem(),
    "hdfs": WebHdfsFileSystem(),
    "webhdfs": WebHdfsFileSystem(),
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
