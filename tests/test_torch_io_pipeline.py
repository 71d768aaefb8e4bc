"""The port's input pipeline against the JAX package, on the CPU:
``io.PrefetchingIter`` (two iterators, renames), ``io.DevicePrefetchIter``
with ``device="cpu"`` (reset mid-epoch, a producer error, the end),
``MNISTIter`` and ``CSVIter`` on seeded files, the ``storage`` staging
pool (size classes, reuse, ``MXTPU_STORAGE_POOL=0``, no block handed
out while its copy may still read it), ``mp_io.MultiProcessImageRecordIter``
(two ``forkserver`` workers: every record once, uneven shards, a decode
error, ``close`` mid-epoch, a worker that touches ``torch.cuda``), and
``fit`` fed by ``ImageRecordIter`` through the prefetchers, whose host
syncs must not grow with the batch count (``FusedTrainer.fit``,
``Module.fit``, ``step_multi`` over ``step_multi_feeds``).

Inputs come from numpy seeds; batches are compared exactly.
"""
import gzip
import struct
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import mp_io
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch import storage
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

CPU = "cpu"


def _arrays(n=20, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(n, 2, 3)).astype(np.float32),
            rs.randint(0, 5, n).astype(np.float32))


def _host(batches):
    return [([d.asnumpy() for d in b.data], [x.asnumpy() for x in b.label],
             b.pad) for b in batches]


def _same(a, b):
    assert len(a) == len(b) > 0
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------- prefetchers
def test_prefetching_iter_two_iters_with_renames_like_jax():
    x1, y1 = _arrays(seed=1)
    x2, y2 = _arrays(seed=2)
    out = []
    for mx in (jmx, tmx):
        its = [mx.io.NDArrayIter(x1, y1, batch_size=6),
               mx.io.NDArrayIter(x2, y2, batch_size=6,
                                 data_name="data2", label_name="label2")]
        it = mx.io.PrefetchingIter(
            its, rename_data=[{"data": "a"}, {"data2": "b"}],
            rename_label=[{"softmax_label": "la"}, {"label2": "lb"}])
        assert [d[0] for d in it.provide_data] == ["a", "b"]
        assert [d[0] for d in it.provide_label] == ["la", "lb"]
        assert it.batch_size == 6
        first = _host(list(it))
        it.reset()
        out.append((first, _host(list(it))))
    _same(out[0][0], out[1][0])
    _same(out[0][1], out[1][1])
    assert [p for _, _, p in out[1][0]] == [0, 0, 0, 4]


def test_prefetching_iter_raises_the_producer_error_in_the_consumer():
    class Broken(tio.NDArrayIter):
        def next(self):
            if self.cursor >= 4:
                raise ValueError("bad batch")
            return super().next()

    x, y = _arrays(16)
    it = tio.PrefetchingIter(Broken(x, y, batch_size=4))
    assert it.next().data[0].shape == (4, 2, 3)
    assert it.next().data[0].shape == (4, 2, 3)
    with pytest.raises(ValueError, match="bad batch"):
        it.next()


def test_device_prefetch_reset_mid_epoch_replays_nothing():
    x, y = _arrays(40)
    want = _host(tio.NDArrayIter(x, y, batch_size=4))
    it = tio.DevicePrefetchIter(tio.NDArrayIter(x, y, batch_size=4),
                                depth=3, device=CPU)
    first = _host([it.next() for _ in range(3)])
    _same(first, want[:3])
    time.sleep(0.05)           # let the producer fill its queue
    it.reset()
    _same(_host(list(it)), want)
    assert not it.iter_next()  # exhausted: no hang, no batch
    with pytest.raises(StopIteration):
        it.next()
    it.reset()
    _same(_host(list(it)), want)


def test_device_prefetch_raises_the_producer_error_in_the_consumer():
    class Broken(tio.NDArrayIter):
        def next(self):
            if self.cursor >= 4:
                raise ValueError("bad batch")
            return super().next()

    x, y = _arrays(16)
    it = tio.DevicePrefetchIter(Broken(x, y, batch_size=4), device=CPU)
    assert it.next().data[0].shape == (4, 2, 3)
    assert it.next().data[0].shape == (4, 2, 3)
    with pytest.raises(ValueError, match="bad batch"):
        it.next()
    with pytest.raises(StopIteration):
        it.next()


def test_device_prefetch_passes_device_batches_through():
    x, y = _arrays(8)
    base = tio.NDArrayIter(x, y, batch_size=4)
    it = tio.DevicePrefetchIter(base, device=CPU)
    batch = it.next()
    assert batch.data[0].context == torch.device("cpu")
    assert it.provide_data == base.provide_data
    assert it.provide_label == base.provide_label


def test_image_record_iter_alias():
    assert tio.ImageRecordIter.__doc__ and callable(tio.ImageRecordIter)


# ------------------------------------------------------------ MNIST / CSV
def _write_idx(path, arr, gz):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("flat,shuffle,gz", [
    (False, True, False), (True, False, False), (False, False, True)])
def test_mnist_iter_like_jax(tmp_path, flat, shuffle, gz):
    rs = np.random.RandomState(3)
    images = rs.randint(0, 256, (70, 28, 28))
    labels = rs.randint(0, 10, 70)
    ext = ".gz" if gz else ""
    img, lab = str(tmp_path / "img-idx3"), str(tmp_path / "lab-idx1")
    _write_idx(img + ext, images, gz)
    _write_idx(lab + ext, labels, gz)
    out = []
    for mx in (jmx, tmx):
        it = mx.io.MNISTIter(image=img, label=lab, batch_size=16, flat=flat,
                             shuffle=shuffle, seed=4)
        out.append(_host(list(it)))
    _same(*out)
    assert len(out[1]) == 4   # 70 // 16: the partial batch is discarded
    assert out[1][0][0][0].shape == ((16, 784) if flat else (16, 1, 28, 28))


@pytest.mark.parametrize("with_labels", [True, False])
def test_csv_iter_like_jax(tmp_path, with_labels):
    rs = np.random.RandomState(5)
    data = rs.normal(size=(23, 6)).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    kw = {}
    if with_labels:
        np.savetxt(tmp_path / "l.csv", rs.randint(0, 3, 23), delimiter=",")
        kw["label_csv"] = str(tmp_path / "l.csv")
    out = [_host(list(mx.io.CSVIter(str(tmp_path / "d.csv"), (2, 3),
                                    batch_size=5, **kw)))
           for mx in (jmx, tmx)]
    _same(*out)
    assert out[1][0][0][0].shape == (5, 2, 3)


# ---------------------------------------------------------- staging pool
@pytest.fixture
def pool():
    storage.release_all()
    yield storage
    storage.release_all()


def test_pool_size_classes_and_reuse(pool):
    a = pool.staging_empty((3, 5), np.float32)
    assert a.shape == (3, 5) and a.dtype == torch.float32
    ptr = a.data_ptr()
    pool.staging_free(a)
    assert pool.pool_bytes() == 256            # 60 bytes: the 256 class
    b = pool.staging_empty(40, np.uint8)       # the same class: reused
    assert b.data_ptr() == ptr and pool.pool_bytes() == 0
    c = pool.staging_empty((300,), np.float32)  # 1200 bytes: 2048
    pool.staging_free(b)
    pool.staging_free(c)
    assert pool.pool_bytes() == 256 + 2048
    pool.staging_free(torch.zeros(3))          # not the pool's: ignored
    assert pool.pool_bytes() == 256 + 2048
    pool.release_all()
    assert pool.pool_bytes() == 0


def test_pool_host_array_shares_memory(pool):
    a = pool.staging_empty((4, 3), np.float32)
    view = pool.host_array(a)
    view[...] = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(a.numpy(), view)


def test_pool_off(pool, monkeypatch):
    monkeypatch.setattr(storage, "_enabled", None)
    monkeypatch.setenv("MXTPU_STORAGE_POOL", "0")
    a = pool.staging_empty((8,), np.float32)
    pool.staging_free(a)
    assert pool.pool_bytes() == 0
    b = pool.staging_empty((8,), np.float32)
    assert b.data_ptr() != a.data_ptr() or b is not a
    monkeypatch.setattr(storage, "_enabled", None)
    monkeypatch.delenv("MXTPU_STORAGE_POOL")
    with pool.pooling_disabled():
        assert not storage._pool_on()
    assert storage._pool_on()


class _Event:
    """A copy's event that has or has not completed yet."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_pool_holds_a_block_until_its_copy_completes(pool):
    a = pool.staging_empty((64,), np.float32)
    ev = _Event()
    pool.release_after(a, ev)
    b = pool.staging_empty((64,), np.float32)
    assert b.data_ptr() != a.data_ptr()        # still being copied
    assert pool.pool_bytes() == 0
    ev.done = True
    c = pool.staging_empty((64,), np.float32)
    assert c.data_ptr() == a.data_ptr()


def test_stage_to_device_copies_and_recycles_on_the_cpu(pool):
    buf = pool.staging_empty((2, 3), np.float32)
    buf.copy_(torch.arange(6.0).reshape(2, 3))
    out = pool.stage_to_device(buf, CPU)
    assert out.data_ptr() != buf.data_ptr()
    again = pool.staging_empty((2, 3), np.float32)
    assert again.data_ptr() == buf.data_ptr()   # recycled at once
    again.fill_(-1.0)
    np.testing.assert_array_equal(out.numpy(),
                                  np.arange(6.0).reshape(2, 3))


def test_stage_to_device_without_a_card_raises(pool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(MXNetError, match="no CUDA device"):
        pool.stage_to_device(pool.staging_empty((2,), np.float32))


# --------------------------------------------------------------- mp_io
def _labeled_rec(tmp_path, n=24, size=16, bad=None):
    """PNG records whose pixels encode their label: record i is the
    constant image (i * 7) % 256."""
    rec = str(tmp_path / "mp.rec")
    w = trec.MXRecordIO(rec, "w")
    for i in range(n):
        img = np.full((size, size, 3), (i * 7) % 256, np.uint8)
        payload = (b"\xff\xd8broken" if i == bad
                   else timg.imencode(img, img_fmt=".png"))
        w.write(trec.pack(trec.IRHeader(0, float(i), i, 0), payload))
    w.close()
    return rec


def _mp(rec, **kw):
    kw.setdefault("num_workers", 2)
    return timg.MultiProcessImageRecordIter(
        path_imgrec=rec, data_shape=(3, 16, 16), batch_size=4,
        stall_timeout=120, device=CPU, **kw)


def test_mp_iter_covers_every_record_once_each_epoch(tmp_path):
    it = _mp(_labeled_rec(tmp_path))
    try:
        for _ in range(2):
            seen, total, pads = [], 0, 0
            for batch in it:
                data = batch.data[0].asnumpy()
                labels = batch.label[0].asnumpy()
                for s in range(4):
                    want = (int(labels[s]) * 7) % 256
                    np.testing.assert_array_equal(
                        data[s], np.full((3, 16, 16), want, np.float32))
                real = 4 - batch.pad
                seen.extend(labels[:real].astype(int).tolist())
                total += 4
                pads += batch.pad
            assert total - pads == 24
            assert sorted(seen) == list(range(24))
            it.reset()
    finally:
        it.close()


def test_mp_iter_uneven_shards_pad(tmp_path):
    it = _mp(_labeled_rec(tmp_path, n=10))
    try:
        batches = list(it)
        total = sum(b.data[0].shape[0] for b in batches)
        assert total - sum(b.pad for b in batches) == 10
        labels = {int(v) for b in batches
                  for v in b.label[0].asnumpy()[:4 - b.pad]}
        assert labels == set(range(10))
    finally:
        it.close()


def test_mp_iter_decode_error_surfaces(tmp_path):
    it = _mp(_labeled_rec(tmp_path, n=12, bad=5))
    try:
        with pytest.raises(MXNetError, match="input worker .* failed"):
            list(it)
    finally:
        it.close()


def test_mp_iter_close_mid_epoch_does_not_hang(tmp_path):
    it = _mp(_labeled_rec(tmp_path, n=40))
    it.next()
    t0 = time.perf_counter()
    it.close()
    assert time.perf_counter() - t0 < 60  # joins are bounded at 15 s each
    assert all(not p.is_alive() for p in it._procs)
    with pytest.raises(MXNetError, match="closed"):
        it.next()
    it.close()


def test_mp_iter_worker_touching_cuda_fails(tmp_path):
    from torch_mp_probe import TouchesCuda

    it = _mp(_labeled_rec(tmp_path, n=8), preprocess_threads=TouchesCuda())
    try:
        with pytest.raises(MXNetError, match="touched torch.cuda"):
            list(it)
    finally:
        it.close()


def test_mp_iter_starts_workers_with_forkserver(tmp_path, monkeypatch):
    monkeypatch.delenv("MXTPU_MP_START", raising=False)
    it = _mp(_labeled_rec(tmp_path, n=8), num_workers=1)
    try:
        assert type(it._procs[0]).__module__.endswith("context")
        assert it._procs[0]._popen.method == "forkserver"
        assert len(list(it)) == 2
    finally:
        it.close()
    with pytest.raises(MXNetError, match="num_workers"):
        mp_io.MultiProcessImageRecordIter("x.rec", (3, 4, 4), 2,
                                          num_workers=0, device=CPU)


# ------------------------------------------------------- fit over records
def _net(s):
    data = s.Variable("data")
    net = s.Convolution(data, name="conv1", kernel=(3, 3), num_filter=4)
    net = s.Activation(net, act_type="relu")
    net = s.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = s.FullyConnected(s.Flatten(net), name="fc", num_hidden=10)
    return s.SoftmaxOutput(net, name="softmax")


def _jpeg_rec(tmp_path, n):
    rs = np.random.RandomState(7)
    rec = str(tmp_path / f"fit{n}.rec")
    w = trec.MXRecordIO(rec, "w")
    for i in range(n):
        img = rs.randint(0, 256, (20, 22, 3)).astype(np.uint8)
        w.write(trec.pack_img(trec.IRHeader(0, float(i % 10), i, 0), img,
                              quality=90))
    w.close()
    return rec


_SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
          "__int__")


def _pipeline(rec):
    it = timg.ImageRecordIter(rec, (3, 16, 16), 8, rand_crop=True,
                              rand_mirror=True, shuffle=True,
                              preprocess_threads=2, device=CPU)
    return tio.DevicePrefetchIter(tio.PrefetchingIter(it), device=CPU)


def _count_syncs(monkeypatch, run):
    """Host reads made by the thread that runs the loop (the consumer
    side: the producer threads fill host buffers, which is no sync)."""
    counts = []
    consumer = threading.current_thread()

    def count(name, orig):
        def f(*a, **k):
            if threading.current_thread() is consumer:
                counts.append(name)
            return orig(*a, **k)
        return f

    storage.release_all()
    with monkeypatch.context() as mp:
        for name in _SYNCS:
            mp.setattr(torch.Tensor, name,
                       count(name, getattr(torch.Tensor, name)))
        run()
    return len(counts)


@pytest.mark.parametrize("route", ["trainer", "module", "step_multi"])
def test_record_fed_fit_host_syncs_do_not_grow(tmp_path, monkeypatch, route):
    def run_with(nbatch):
        rec = _jpeg_rec(tmp_path, 8 * nbatch)
        if route == "module":
            mod = tmx.mod.Module(_net(tsym), context=tmx.cpu())
            # the pipeline starts its threads when made: inside the count
            return lambda: mod.fit(
                _pipeline(rec), eval_metric="acc", num_epoch=1,
                optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                batch_end_callback=tmx.callback.Speedometer(8, 100))
        tt = TTrainer(_net(tsym), device=CPU,
                      optimizer_params={"lr": 0.1}).init(data=(8, 3, 16, 16))
        if route == "trainer":
            return lambda: tt.fit(_pipeline(rec), eval_metric="acc",
                                  num_epoch=1)
        return lambda: [tt.step_multi(**feed)
                        for feed in tio.step_multi_feeds(_pipeline(rec), 2)]

    small = _count_syncs(monkeypatch, run_with(4))
    large = _count_syncs(monkeypatch, run_with(16))
    assert large == small <= 4, (small, large)


def test_step_multi_feeds_over_prefetched_records_like_steps(tmp_path):
    rec = _jpeg_rec(tmp_path, 32)
    feeds = list(tio.step_multi_feeds(_pipeline(rec), 2))
    assert len(feeds) == 2 and len(feeds[0]["data"]) == 2
    a = TTrainer(_net(tsym), device=CPU, optimizer_params={"lr": 0.1})
    b = TTrainer(_net(tsym), device=CPU, optimizer_params={"lr": 0.1})
    for tr in (a, b):
        tmx.random.seed(1)
        tr.init(data=(8, 3, 16, 16))
    for feed in feeds:
        a.step_multi(**feed)
        for i in range(2):
            b.step(**{k: v[i] for k, v in feed.items()})
    for k in a.params:
        np.testing.assert_array_equal(a.params[k].cpu().numpy(),
                                      b.params[k].cpu().numpy())
