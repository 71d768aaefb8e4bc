"""The data iterators' telemetry in the port against the JAX package's,
on the CPU: ``data_batches_total{iterator}`` and
``data_batch_wait_seconds{iterator}`` (type, help text, labels, and
the counts per iterator class) over the same iterators fed the same
data in both packages — ``NDArrayIter``, ``MNISTIter``, a
``PrefetchingIter`` stack, ``ImageIter`` and ``ImageRecordIter`` — the
``data-io`` spans in the profiler, nothing recorded while telemetry is
off, and no host read of a tensor per batch.
"""
import json
import random

import numpy as np
import pytest
import torch

from mxnet_tpu import image as jimg
from mxnet_tpu import io as jio
from mxnet_tpu import profiler as jprof
from mxnet_tpu import telemetry as jtm

from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch import telemetry as ttm

FAMILIES = ("data_batches_total", "data_batch_wait_seconds")
SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
         "__int__")


@pytest.fixture(autouse=True)
def _telemetry_on():
    for tm in (jtm, ttm):
        tm.reset()
        tm.enable()
    yield
    for tm in (jtm, ttm):
        tm.reset()
        tm.enable(False)


def _families(tm):
    """Each data family: its type, help and label names, and per label
    set its batch count (a counter's value, a histogram's count)."""
    snap = tm.json_snapshot()["metrics"]
    out = {}
    for name in FAMILIES:
        e = snap[name]
        out[name] = (e["type"], e["help"], tuple(e["labelnames"]), {
            tuple(sorted(s["labels"].items())):
                s.get("count", s.get("value")) for s in e["samples"]})
    return out


def _drain(it, epochs=1):
    n = 0
    for e in range(epochs):
        if e:
            it.reset()
        for _ in it:
            n += 1
    return n


def _arrays(n=50, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.uniform(size=(n, 3, 4, 4)).astype(np.float32),
            rs.randint(0, 5, n).astype(np.float32))


def test_families_match_jax_before_any_batch():
    assert _families(ttm) == _families(jtm)
    kinds = {n: f[0] for n, f in _families(ttm).items()}
    assert kinds == {"data_batches_total": "counter",
                     "data_batch_wait_seconds": "histogram"}


@pytest.mark.parametrize("kw", [{}, {"last_batch_handle": "discard"},
                                {"last_batch_handle": "roll_over"}],
                         ids=["pad", "discard", "roll_over"])
def test_ndarray_iter_counts_match_jax(kw):
    x, y = _arrays()
    n = {}
    for name, io in (("jax", jio), ("port", tio)):
        n[name] = _drain(io.NDArrayIter(x, y, batch_size=8, **kw), epochs=2)
    assert n["port"] == n["jax"]
    fams = _families(ttm)
    assert fams == _families(jtm)
    key = (("iterator", "NDArrayIter"),)
    assert fams["data_batches_total"][3] == {key: n["port"]}
    assert fams["data_batch_wait_seconds"][3] == {key: n["port"]}


def test_prefetching_stack_reports_each_stage_like_jax():
    x, y = _arrays(40)
    for io in (jio, tio):
        base = io.NDArrayIter(x, y, batch_size=8)
        _drain(io.PrefetchingIter(base), epochs=2)
    fams = _families(ttm)
    want = _families(jtm)
    # the producer thread may run one batch ahead of the consumer at the
    # epoch's end in either package: the consumer-facing stage is exact
    key = (("iterator", "PrefetchingIter"),)
    for name in FAMILIES:
        assert fams[name][:3] == want[name][:3]
        assert fams[name][3][key] == want[name][3][key] == 10
        assert set(fams[name][3]) == set(want[name][3])


def _images(n, h=20, w=27, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 255, (h, w, 3)).astype(np.uint8)
            for _ in range(n)]


def _write_rec(tmp_path, n=21):
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i, img in enumerate(_images(n)):
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i % 10), i, 0),
                                     img, quality=90, img_fmt=".png"))
    w.close()
    return rec


@pytest.mark.parametrize("kind", ["ImageRecordIter", "ImageIter"])
def test_image_iters_count_like_jax(tmp_path, kind):
    rec = _write_rec(tmp_path)
    n = {}
    for name, mod, extra in (("jax", jimg, {}),
                             ("port", timg, {"device": "cpu"})):
        random.seed(3)
        np.random.seed(3)
        if kind == "ImageRecordIter":
            it = mod.ImageRecordIter(rec, (3, 16, 16), 4,
                                     preprocess_threads=1, **extra)
        else:
            it = mod.ImageIter(4, (3, 16, 16), path_imgrec=rec, **extra)
        n[name] = _drain(it, epochs=2)
    assert n["port"] == n["jax"] == 12
    fams = _families(ttm)
    assert fams == _families(jtm)
    assert fams["data_batches_total"][3] == {(("iterator", kind),): 12}


def test_mnist_iter_is_labelled_by_its_class(tmp_path):
    import gzip
    import struct

    rs = np.random.RandomState(1)
    img, lab = str(tmp_path / "i.gz"), str(tmp_path / "l.gz")
    with gzip.open(img, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 20, 28, 28))
        f.write(rs.randint(0, 255, (20, 28, 28)).astype(np.uint8).tobytes())
    with gzip.open(lab, "wb") as f:
        f.write(struct.pack(">II", 2049, 20))
        f.write(rs.randint(0, 10, 20).astype(np.uint8).tobytes())
    for io in (jio, tio):
        _drain(io.MNISTIter(image=img, label=lab, batch_size=5))
    assert _families(ttm) == _families(jtm)
    assert _families(ttm)["data_batches_total"][3] == {
        (("iterator", "MNISTIter"),): 4}


def test_nothing_is_recorded_while_telemetry_is_off():
    ttm.enable(False)
    x, y = _arrays(16)
    _drain(tio.NDArrayIter(x, y, batch_size=4))
    fams = _families(ttm)
    assert all(not f[3] for f in fams.values())


def test_image_iter_spans_in_the_profile(tmp_path):
    """``ImageRecordIter.next`` is a ``data-io`` event of the profile in
    both packages, one a batch, and the epoch's end adds none."""
    rec = _write_rec(tmp_path, n=8)
    names = {}
    for tag, mod, prof, extra in (("jax", jimg, jprof, {}),
                                  ("port", timg, tprof, {"device": "cpu"})):
        prof.profiler_set_state("stop")
        prof.clear()
        prof.profiler_set_config(mode="all",
                                 filename=str(tmp_path / f"{tag}.json"))
        prof.profiler_set_state("run")
        it = mod.ImageRecordIter(rec, (3, 16, 16), 4, preprocess_threads=1,
                                 **extra)
        _drain(it)
        prof.profiler_set_state("stop")
        prof.dump_profile()
        prof.clear()
        with open(str(tmp_path / f"{tag}.json")) as f:
            events = json.load(f)["traceEvents"]
        names[tag] = sorted(e["name"] for e in events
                            if e.get("cat") == "data-io")
    assert names["port"] == names["jax"] == ["ImageRecordIter.next"] * 2


def test_no_host_sync_a_batch(monkeypatch):
    """With telemetry on, handing out batches reads nothing back from
    a tensor: the counters cost no host sync."""
    x, y = _arrays(48)
    stack = tio.PrefetchingIter(tio.NDArrayIter(x, y, batch_size=8))
    calls = []

    def count(name, orig):
        def f(*a, **k):
            calls.append(name)
            return orig(*a, **k)
        return f

    with monkeypatch.context() as mp:
        for name in SYNCS:
            mp.setattr(torch.Tensor, name, count(name,
                                                 getattr(torch.Tensor, name)))
        n = _drain(stack)
    assert n == 6 and calls == []
    assert _families(ttm)["data_batches_total"][3][
        (("iterator", "PrefetchingIter"),)] == 6
