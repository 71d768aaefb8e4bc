"""The port's RecordIO layer against the JAX package, on the CPU:
``recordio`` (files written by either package read back byte for byte
in the other, plain and indexed; ``pack``/``unpack`` and
``pack_img``/``unpack_img``), the native reader and writer of
``_native`` (built from ``src/recordio.cc`` into the port's ``build/``)
against the Python reader, and ``filesystem`` (``InputSplit`` shards,
``mem://``, the remote schemes against loopback doubles).

Records come from numpy seeds; every comparison here is exact.
"""
import os
import re

import numpy as np
import pytest

from mxnet_tpu import filesystem as jfs
from mxnet_tpu import recordio as jrec

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import _native as tnative
from mxnet_tpu_torch import filesystem as tfs
from mxnet_tpu_torch import recordio as trec

# the JAX package's native library, built and loaded under the lock
# shared by the test processes (see test_torch_native_engine.py)
from test_torch_native_engine import jax_native  # noqa: F401


def _payloads(n=23, seed=0):
    """Records of every length mod 4 (the padding), an empty one, and
    one holding the magic word."""
    rs = np.random.RandomState(seed)
    out = [rs.bytes(int(k)) for k in rs.randint(0, 300, n)]
    out[3] = b""
    out[5] = b"ab\x0a\x23\xd7\xce" + rs.bytes(40)
    return out


def _write(mod, path, records):
    w = mod.MXRecordIO(path, "w")
    for r in records:
        w.write(r)
    w.close()


def _read_all(mod, path):
    r = mod.MXRecordIO(path, "r")
    out = []
    while True:
        rec = r.read()
        if rec is None:
            break
        out.append(rec)
    r.close()
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------- recordio
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_plain_files_are_the_same_bytes_both_ways(tmp_path, writer):
    recs = _payloads()
    mine, theirs = (jrec, trec) if writer == "jax" else (trec, jrec)
    _write(mine, str(tmp_path / "a.rec"), recs)
    _write(theirs, str(tmp_path / "b.rec"), recs)
    assert _bytes(tmp_path / "a.rec") == _bytes(tmp_path / "b.rec")
    assert _read_all(theirs, str(tmp_path / "a.rec")) == recs
    assert _read_all(mine, str(tmp_path / "a.rec")) == recs


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_indexed_files_are_the_same_bytes_both_ways(tmp_path, writer):
    recs = _payloads(11, seed=1)
    for name, mod in (("j", jrec), ("t", trec)):
        w = mod.MXIndexedRecordIO(str(tmp_path / f"{name}.idx"),
                                  str(tmp_path / f"{name}.rec"), "w")
        for i, r in enumerate(recs):
            w.write_idx(i * 3, r)
        w.close()
    for ext in ("rec", "idx"):
        assert _bytes(tmp_path / f"j.{ext}") == _bytes(tmp_path / f"t.{ext}")
    src = "j" if writer == "jax" else "t"
    reader = (trec if writer == "jax" else jrec).MXIndexedRecordIO(
        str(tmp_path / f"{src}.idx"), str(tmp_path / f"{src}.rec"), "r")
    assert reader.keys == [i * 3 for i in range(len(recs))]
    for i in (7, 0, 3, 10):
        assert reader.read_idx(i * 3) == recs[i]
    reader.close()


@pytest.mark.parametrize("label", [3.0, 0.5, [1.0, 2.5, -3.0], [7.0]])
def test_pack_unpack_like_jax(label):
    header = (0, label, 17, 5)
    payload = b"payload-bytes"
    packed = trec.pack(trec.IRHeader(*header), payload)
    assert packed == jrec.pack(jrec.IRHeader(*header), payload)
    th, tp = trec.unpack(packed)
    jh, jp = jrec.unpack(packed)
    assert tp == jp == payload
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_unpack_img_like_jax(fmt):
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (12, 17, 3)).astype(np.uint8)
    header = trec.IRHeader(0, 4.0, 1, 0)
    packed = trec.pack_img(header, img, quality=90, img_fmt=fmt)
    assert packed == jrec.pack_img(header, img, quality=90, img_fmt=fmt)
    (th, timg), (jh, jimg) = trec.unpack_img(packed), jrec.unpack_img(packed)
    assert th.label == jh.label == 4.0
    np.testing.assert_array_equal(timg, jimg)
    if fmt == ".png":
        np.testing.assert_array_equal(timg, img)


def test_reading_a_bad_magic_raises(tmp_path):
    path = str(tmp_path / "bad.rec")
    with open(path, "wb") as f:
        f.write(b"\x00" * 16)
    with pytest.raises(MXNetError, match="magic"):
        trec.MXRecordIO(path, "r").read()


# --------------------------------------------------------------- native
def test_native_library_builds_into_the_port_build_dir():
    from mxnet_tpu_torch.ops import _build

    assert tnative.available()
    # the core library (engine, records, arena): libmxtpu_<hash>.so
    built = [f for f in os.listdir(_build.BUILD_DIR)
             if re.fullmatch(r"libmxtpu_[0-9a-f]{16}\.so", f)]
    assert built


def test_native_reader_matches_the_python_reader(tmp_path):
    recs = _payloads(40, seed=3)
    path = str(tmp_path / "n.rec")
    _write(trec, path, recs)
    rd = tnative.NativeRecordReader(path)
    assert list(rd) == recs
    rd.reset()
    batch = rd.read_batch(max_records=7)
    assert batch == recs[:7]
    assert rd.read_batch() == recs[7:]
    assert rd.read_batch() == []
    rd.close()


def test_native_read_batch_takes_a_record_larger_than_its_buffer(tmp_path):
    recs = [b"a" * 10, b"b" * 5000, b"c" * 3]
    path = str(tmp_path / "big.rec")
    _write(trec, path, recs)
    rd = tnative.NativeRecordReader(path)
    got = []
    while True:
        part = rd.read_batch(buf_bytes=1024)
        if not part:
            break
        got.extend(part)
    assert got == recs


def test_native_writer_and_index_match_jax(tmp_path, jax_native):
    recs = _payloads(19, seed=4)
    path = str(tmp_path / "w.rec")
    w = tnative.NativeRecordWriter(path)
    for r in recs:
        w.write(r)
    w.close()
    _write(jrec, str(tmp_path / "j.rec"), recs)
    assert _bytes(path) == _bytes(tmp_path / "j.rec")
    np.testing.assert_array_equal(tnative.native_index(path),
                                  jax_native.native_index(path))
    idx = tnative.native_index(path)
    r = trec.MXRecordIO(path, "r")
    for off, rec in zip(idx, recs):
        r.fp.seek(int(off))
        assert r.read() == rec


@pytest.mark.parametrize("num_parts", [2, 3, 4])
def test_native_shards_match_jax(tmp_path, num_parts, jax_native):
    recs = _payloads(50, seed=5)
    path = str(tmp_path / "s.rec")
    _write(trec, path, recs)
    union = []
    for part in range(num_parts):
        mine = list(tnative.NativeRecordReader(path, part, num_parts))
        theirs = list(jax_native.NativeRecordReader(path, part, num_parts,
                                                    backend="ctypes"))
        assert mine == theirs
        union.extend(mine)
    assert union == recs


# ------------------------------------------------------------ filesystem
@pytest.mark.parametrize("part", [0, 1, 2, 3])
def test_input_split_shards_match_jax(tmp_path, part):
    recs = _payloads(37, seed=6)
    path = str(tmp_path / "i.rec")
    _write(trec, path, recs)
    mine = list(tfs.InputSplit(path, part, 4))
    assert mine == list(jfs.InputSplit(path, part, 4))
    union = [r for p in range(4) for r in tfs.InputSplit(path, p, 4)]
    assert union == recs


def test_input_split_text_and_globs_match_jax(tmp_path):
    for i in range(3):
        (tmp_path / f"t{i}.txt").write_text(
            "".join(f"line {i}-{k}\n" for k in range(7 + i)))
    uri = str(tmp_path / "t*.txt")
    for part in range(3):
        assert (list(tfs.InputSplit(uri, part, 3, split_type="text"))
                == list(jfs.InputSplit(uri, part, 3, split_type="text")))


def test_mem_filesystem_round_trip_and_split():
    recs = _payloads(9, seed=7)
    _write(trec, "mem://torch-test/m.rec", recs)
    assert tfs.is_remote("mem://torch-test/m.rec")
    assert not tfs.is_remote("/tmp/x.rec")
    assert _read_all(trec, "mem://torch-test/m.rec") == recs
    union = [r for p in range(2)
             for r in tfs.InputSplit("mem://torch-test/m.rec", p, 2)]
    assert union == recs


@pytest.mark.parametrize("uri", ["s3://b/x.rec", "gs://b/x.rec",
                                 "http://h/x.rec", "hdfs://h/x.rec"])
def test_remote_filesystems_wait_for_their_item(uri, monkeypatch):
    """The remote schemes no longer wait: each has the reference's
    adapter.  Records go to a loopback double of the store and come back
    (``S3_ENDPOINT``, ``GS_ENDPOINT``, ``WEBHDFS_ENDPOINT``; no request
    leaves 127.0.0.1); plain HTTP is read-only and refuses a writer
    before any request."""
    import chip_smoke
    from test_torch_filesystem_remote import _WebHdfs

    scheme = uri.split("://", 1)[0]
    fs = tfs.get_filesystem(uri)
    assert type(fs).__name__ == {"s3": "S3FileSystem", "gs": "GSFileSystem",
                                 "http": "HttpFileSystem",
                                 "hdfs": "WebHdfsFileSystem"}[scheme]
    if scheme == "http":
        with pytest.raises(MXNetError, match="read-only"):
            tfs.open_uri(uri, "wb")
        return
    for k in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
              "AWS_SESSION_TOKEN", "GS_OAUTH2_TOKEN",
              "GOOGLE_OAUTH_ACCESS_TOKEN"):
        monkeypatch.delenv(k, raising=False)
    double = _WebHdfs(redirect=True) if scheme == "hdfs" \
        else chip_smoke.S3Double()
    monkeypatch.setenv({"s3": "S3_ENDPOINT", "gs": "GS_ENDPOINT",
                        "hdfs": "WEBHDFS_ENDPOINT"}[scheme], double.endpoint)
    fs._size_cache.clear()
    try:
        _write(trec, uri, _payloads(9))
        assert _read_all(trec, uri) == _payloads(9)
    finally:
        double.close()


def test_unknown_scheme_and_a_registered_adapter():
    with pytest.raises(MXNetError, match="no filesystem registered"):
        tfs.get_filesystem("nosuch://x")
    fs = tfs.MemFileSystem()
    tfs.register_filesystem("user://", fs)
    assert tfs.get_filesystem("user://a") is fs
    with pytest.raises(MXNetError, match="out of range"):
        tfs.InputSplit("user://a", 2, 2)
