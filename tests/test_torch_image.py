"""The port's ``image`` module against the JAX package, on the CPU:
``imdecode_np`` on the same bytes (JPEG through libjpeg in both here,
PNG and the raw format), ``imencode``, every augmenter and
``CreateAugmenter`` under one ``random.seed``/``np.random.seed``,
``ImageIter`` (``.rec``, indexed ``.rec``, ``.lst``, ``imglist``) and
``ImageRecordIter`` batches — shuffle on and off across two epochs,
``rand_crop``/``rand_mirror``, ``mean_*``/``scale``, ``label_width``
2, wrap-around padding — and ``nd.imdecode``.

The random augmenters draw from Python's ``random`` (and ``np.random``
for the lighting) in both packages, so with one preprocess thread the
same seeds give the same batches: every comparison here is exact.
"""
import random
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu import image as jimg

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch import recordio as trec

CPU = "cpu"


def _images(n, h=20, w=27, seed=0):
    """Low-frequency patterns plus noise (JPEG-like content)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        base = 128 + 80 * np.sin(xx / (3.0 + i % 5) + i) * np.cos(yy / 4.0)
        img = base[..., None] + rs.normal(0, 20, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _write_rec(tmp_path, n=37, label_width=1, fmt=".jpg", name="r"):
    rec = str(tmp_path / f"{name}.rec")
    idx = str(tmp_path / f"{name}.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i, img in enumerate(_images(n)):
        label = (float(i % 10) if label_width == 1
                 else [float(i % 10), float(i // 10)])
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, label, i, 0), img,
                                     quality=90, img_fmt=fmt))
    w.close()
    return rec, idx


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _epochs(it, n=2):
    out = []
    for e in range(n):
        if e:
            it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    return out


def _same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb) > 0
        for (da, la, pa), (db, lb, pb) in zip(ea, eb):
            assert pa == pb
            assert da.dtype == db.dtype == np.float32
            np.testing.assert_array_equal(da, db)
            np.testing.assert_array_equal(la, lb)


# --------------------------------------------------------------- codecs
@pytest.mark.parametrize("fmt,quality", [(".jpg", 90), (".jpg", 75),
                                         (".png", 95)])
def test_imencode_and_imdecode_np_like_jax(fmt, quality):
    img = _images(1, 33, 41, seed=3)[0]
    buf = timg.imencode(img, quality=quality, img_fmt=fmt)
    assert buf == jimg.imencode(img, quality=quality, img_fmt=fmt)
    got = timg.imdecode_np(buf)
    assert got.dtype == np.uint8 and got.shape == (33, 41, 3)
    np.testing.assert_array_equal(got, jimg.imdecode_np(buf))


def test_jpeg_goes_through_libjpeg_here():
    from mxnet_tpu_torch import _native

    img = _images(1, seed=4)[0]
    buf = timg.imencode(img, quality=90)
    assert timg.codecs() == {"encode": "pillow", "decode_jpeg": "libjpeg"}
    np.testing.assert_array_equal(_native.decode_jpeg(buf),
                                  timg.imdecode_np(buf))
    assert _native.decode_jpeg(b"\xff\xd8 not a jpeg") is None


def test_without_pillow_the_raw_format_and_the_refusals(monkeypatch):
    img = _images(1, seed=5)[0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    buf = timg.imencode(img)
    assert buf == jimg.imencode(img)
    assert buf[:8] == b"MXTPURAW"
    np.testing.assert_array_equal(timg.imdecode_np(buf), img)
    assert timg.codecs()["encode"] == "raw"
    for aug in (timg.ResizeAug(8), timg.ForceResizeAug((8, 8))):
        with pytest.raises(ImportError):
            aug(img)


def test_nd_imdecode():
    img = _images(1, seed=6)[0]
    buf = timg.imencode(img, img_fmt=".png")
    arr = tnd.imdecode(buf, ctx=CPU)
    assert arr.shape == (20, 27, 3) and arr.dtype == np.float32
    np.testing.assert_array_equal(arr.asnumpy(), img.astype(np.float32))
    np.testing.assert_array_equal(timg.imdecode(bytearray(buf),
                                                ctx=CPU).asnumpy(),
                                  jimg.imdecode(buf).asnumpy())


# ------------------------------------------------------------ augmenters
_AUGS = {
    "resize": lambda m: m.ResizeAug(14),
    "force_resize": lambda m: m.ForceResizeAug((11, 9)),
    "random_crop": lambda m: m.RandomCropAug((9, 7)),
    "center_crop": lambda m: m.CenterCropAug((9, 7)),
    "flip": lambda m: m.HorizontalFlipAug(0.5),
    "brightness": lambda m: m.BrightnessJitterAug(0.4),
    "contrast": lambda m: m.ContrastJitterAug(0.4),
    "saturation": lambda m: m.SaturationJitterAug(0.4),
    "lighting": lambda m: m.LightingAug(
        0.1, [55.46, 4.794, 1.148], [[-0.5675, 0.7192, 0.4009],
                                     [-0.5808, -0.0045, -0.8140],
                                     [-0.5836, -0.6948, 0.4203]]),
}


@pytest.mark.parametrize("name", sorted(_AUGS))
def test_each_augmenter_like_jax(name):
    imgs = _images(6, seed=7)
    outs = []
    for mod in (jimg, timg):
        aug = _AUGS[name](mod)
        _seed(11)
        outs.append([np.asarray(aug(im)) for im in imgs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    {},
    {"rand_crop": True, "rand_mirror": True},
    {"resize": 18, "rand_crop": True},
    {"brightness": 0.3, "contrast": 0.3, "saturation": 0.3,
     "pca_noise": 0.1, "rand_mirror": True},
])
def test_create_augmenter_like_jax(kw):
    imgs = _images(5, seed=8)
    outs = []
    for mod in (jimg, timg):
        augs = mod.CreateAugmenter((3, 12, 10), **kw)
        _seed(12)
        res = []
        for im in imgs:
            for aug in augs:
                im = aug(im)
            res.append(np.asarray(im))
        outs.append((res, [type(a).__name__ for a in augs]))
    assert outs[0][1] == outs[1][1]
    for a, b in zip(outs[0][0], outs[1][0]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- ImageRecordIter
@pytest.mark.parametrize("kw", [
    {"shuffle": False},
    {"shuffle": True, "seed": 3},
    {"shuffle": True, "rand_crop": True, "rand_mirror": True},
    {"mean_r": 123.68, "mean_g": 116.28, "mean_b": 103.53, "scale": 0.017},
    {"label_width": 2, "rand_crop": True},
], ids=["plain", "shuffle", "rand_aug", "mean_scale", "label_width2"])
def test_image_record_iter_batches_like_jax(tmp_path, kw):
    rec, _ = _write_rec(tmp_path, label_width=kw.get("label_width", 1))
    outs = []
    for mod, extra in ((jimg, {}), (timg, {"device": CPU})):
        _seed(5)
        it = mod.ImageRecordIter(rec, (3, 16, 16), 8, preprocess_threads=1,
                                 **kw, **extra)
        outs.append(_epochs(it))
    _same(*outs)
    # 37 records in batches of 8: the last batch wraps around 3 records
    assert [b[2] for b in outs[1][0]] == [0, 0, 0, 0, 3]


def test_image_record_iter_shards_like_jax(tmp_path):
    rec, _ = _write_rec(tmp_path, n=29)
    for part in range(3):
        outs = [_epochs(mod.ImageRecordIter(rec, (3, 16, 16), 4,
                                            part_index=part, num_parts=3,
                                            preprocess_threads=1, **extra), 1)
                for mod, extra in ((jimg, {}), (timg, {"device": CPU}))]
        _same(*outs)


def test_image_record_iter_falls_back_to_input_split(tmp_path, monkeypatch):
    from mxnet_tpu_torch import _native

    rec, _ = _write_rec(tmp_path, n=13)
    want = _epochs(timg.ImageRecordIter(rec, (3, 16, 16), 4,
                                        device=CPU), 1)
    monkeypatch.setattr(_native, "available", lambda: False)
    _same(want, _epochs(timg.ImageRecordIter(rec, (3, 16, 16), 4,
                                             device=CPU), 1))


def test_image_record_iter_threads_give_the_same_unaugmented_batches(
        tmp_path):
    rec, _ = _write_rec(tmp_path, n=21)
    one = _epochs(timg.ImageRecordIter(rec, (3, 16, 16), 8, device=CPU,
                                       preprocess_threads=1), 1)
    four = _epochs(timg.ImageRecordIter(rec, (3, 16, 16), 8, device=CPU,
                                        preprocess_threads=4), 1)
    _same(one, four)


def test_image_record_iter_decode_error_frees_its_buffer(tmp_path):
    from mxnet_tpu_torch import storage

    rec = str(tmp_path / "bad.rec")
    w = trec.MXRecordIO(rec, "w")
    w.write(trec.pack(trec.IRHeader(0, 1.0, 0, 0), b"\xff\xd8broken"))
    w.close()
    it = timg.ImageRecordIter(rec, (3, 8, 8), 1, device=CPU)
    storage.release_all()
    with pytest.raises(Exception):
        it.next()
    assert storage.pool_bytes() >= 3 * 8 * 8 * 4


# -------------------------------------------------------------- ImageIter
@pytest.mark.parametrize("source,shuffle", [
    ("rec", False), ("indexed", False), ("indexed", True), ("lst", False),
    ("lst", True), ("imglist", False), ("imglist", True)])
def test_image_iter_batches_like_jax(tmp_path, source, shuffle):
    # a sequential .rec has no order to shuffle
    n = 19
    rec, idx = _write_rec(tmp_path, n=n, fmt=".png")
    kw = {}
    if source == "rec":
        kw = {"path_imgrec": rec}
    elif source == "indexed":
        kw = {"path_imgrec": rec, "path_imgidx": idx}
    else:
        entries = []
        for i, img in enumerate(_images(n)):
            fname = f"img{i}.png"
            with open(tmp_path / fname, "wb") as f:
                f.write(timg.imencode(img, img_fmt=".png"))
            entries.append((float(i % 10), fname))
        if source == "lst":
            lst = tmp_path / "a.lst"
            lst.write_text("".join(f"{i}\t{lab}\t{f}\n"
                                   for i, (lab, f) in enumerate(entries)))
            kw = {"path_imglist": str(lst), "path_root": str(tmp_path)}
        else:
            kw = {"imglist": [[lab, f] for lab, f in entries],
                  "path_root": str(tmp_path)}
    outs = []
    for mod, extra in ((jimg, {}), (timg, {"device": CPU})):
        _seed(9)
        aug = mod.CreateAugmenter((3, 16, 16), rand_crop=True,
                                  rand_mirror=True)
        it = mod.ImageIter(5, (3, 16, 16), shuffle=shuffle, aug_list=aug,
                           mean=[120.0, 110.0, 100.0], std=[58.0, 57.0, 57.5],
                           **kw, **extra)
        outs.append(_epochs(it))
    _same(*outs)
    assert [b[2] for b in outs[1][0]] == [0, 0, 0, 1]


def test_image_iter_sharded_and_label_width(tmp_path):
    rec, idx = _write_rec(tmp_path, n=23, label_width=2, fmt=".png")
    for part in range(2):
        outs = [_epochs(mod.ImageIter(4, (3, 16, 16), label_width=2,
                                      path_imgrec=rec, path_imgidx=idx,
                                      part_index=part, num_parts=2,
                                      **extra), 1)
                for mod, extra in ((jimg, {}), (timg, {"device": CPU}))]
        _same(*outs)
        assert outs[1][0][0][1].shape == (4, 2)


def test_image_iters_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    rec, _ = _write_rec(tmp_path, n=5)
    with pytest.raises(MXNetError, match="no CUDA device"):
        timg.ImageRecordIter(rec, (3, 16, 16), 4).next()
    with pytest.raises(MXNetError, match="no CUDA device"):
        timg.ImageIter(4, (3, 16, 16), path_imgrec=rec).next()


def test_image_iters_describe_their_batches(tmp_path):
    rec, idx = _write_rec(tmp_path, n=5)
    for it in (timg.ImageRecordIter(rec, (3, 16, 16), 4, label_width=2,
                                    device=CPU),
               timg.ImageIter(4, (3, 16, 16), label_width=2,
                              path_imgrec=rec, device=CPU)):
        assert it.provide_data == [("data", (4, 3, 16, 16))]
        assert it.provide_label == [("softmax_label", (4, 2))]
