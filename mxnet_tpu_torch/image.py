"""Image decode, augmentation and the image iterators of the port
(mirrors ``mxnet_tpu/image.py``; parity: python/mxnet/image.py and the
C++ ImageRecordIter stack, src/io/iter_image_recordio.cc:150-487 +
image_aug_default.cc).

The reference's staged design, on the host:

  RecordIO shard read (part_index/num_parts)     [native reader or
                                                  filesystem.InputSplit]
    -> parallel decode + augment                  [thread pool,
       (crop / mirror / resize / jitter)           preprocess_threads]
    -> batch assembly (NCHW float32)              [a pooled, pinned
                                                   staging buffer]
    -> copy-on-stage to the device                [storage.stage_to_device]

Decode order, as the reference's: JPEG through the native libjpeg
decoder (``_native.decode_jpeg``, without the GIL) where ``-ljpeg``
links, else Pillow; the raw format of :func:`imencode` without Pillow
(``MXTPURAW`` + shape + bytes) always decodes.  Resizing is Pillow's
bilinear resize, as in the reference: without Pillow ``ResizeAug``,
``ForceResizeAug`` and ``resize > 0`` raise on import, as there.

The random draws go to the reference's sources, so one
``random.seed``/``np.random.seed`` gives the same batches in both
packages: Python's ``random`` for the crops, the flip and the colour
jitters, ``np.random`` for the lighting noise, and
``np.random.RandomState(seed)`` (``seed += 1`` an epoch) for
``ImageRecordIter``'s shuffle.  With ``preprocess_threads > 1`` the
draws of Python's ``random`` interleave in the threads' order, in both
packages.

Batches land on ``device`` (default: the card; ``device="cpu"`` for the
host): data ``(batch,) + data_shape`` float32, labels ``(batch,)`` or
``(batch, label_width)``.  The iterators resolve the device at their
first batch, so a decode worker process (``mp_io``) that only calls
``ImageRecordIter._next_into`` never touches CUDA.  Each batch is a
``data-io`` span (``ImageIter.next``/``ImageRecordIter.next``: a
profiler event while the profiler runs, ``data_batch_wait_seconds``
with telemetry on) and a ``data_batches_total`` count, as in the JAX
package; the end of an epoch records neither.
"""
from __future__ import annotations

import io as _io
import os
import random as pyrandom
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import ndarray as nd
from .base import _env_int
from .io import DataBatch, DataDesc, DataIter
from .recordio import MXIndexedRecordIO, MXRecordIO, unpack

__all__ = ["imencode", "imdecode_np", "imdecode", "codecs", "Augmenter",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "HorizontalFlipAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "LightingAug", "CreateAugmenter",
           "ImageIter", "ImageRecordIter", "MultiProcessImageRecordIter"]

_RAW_MAGIC = b"MXTPURAW"


def _have_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def codecs() -> dict:
    """What this host encodes and decodes with: ``{"encode": "pillow" |
    "raw", "decode_jpeg": "libjpeg" | "pillow" | "none"}``."""
    from . import _native

    pil = _have_pil()
    if _native.jpeg_available():
        dec = "libjpeg"
    else:
        dec = "pillow" if pil else "none"
    return {"encode": "pillow" if pil else "raw", "decode_jpeg": dec}


def imencode(img, quality=95, img_fmt=".jpg"):
    """Encode HWC uint8 RGB to bytes (parity: cv::imencode in
    tools/im2rec.cc): JPEG or PNG through Pillow, the raw format
    without it."""
    img = np.asarray(img)
    try:
        from PIL import Image

        buf = _io.BytesIO()
        fmt = "JPEG" if "jpg" in img_fmt or "jpeg" in img_fmt else "PNG"
        Image.fromarray(img.astype(np.uint8)).save(buf, format=fmt,
                                                   quality=quality)
        return buf.getvalue()
    except ImportError:
        h, w, c = img.shape
        return _RAW_MAGIC + np.array([h, w, c], np.int32).tobytes() + \
            img.astype(np.uint8).tobytes()


def imdecode_np(buf: bytes) -> np.ndarray:
    """Decode bytes to an HWC uint8 RGB numpy array (parity:
    cv::imdecode): raw records directly, JPEG through libjpeg where it
    is built, everything else (and JPEG without it) through Pillow."""
    if buf[:8] == _RAW_MAGIC:
        h, w, c = np.frombuffer(buf[8:20], np.int32)
        return np.frombuffer(buf[20:], np.uint8).reshape(h, w, c).copy()
    if buf[:2] == b"\xff\xd8":  # JPEG SOI
        from . import _native

        out = _native.decode_jpeg(buf)
        if out is not None:
            return out
    from PIL import Image

    img = Image.open(_io.BytesIO(buf))
    return np.asarray(img.convert("RGB"))


def imdecode(buf, channels=3, ctx=None, **kwargs):
    """Parity: mx.image.imdecode (src/io/image_io.cc ``_imdecode``): an
    (H, W, C) float32 NDArray on ``ctx`` (default: the card)."""
    return nd.array(imdecode_np(bytes(buf)).astype(np.float32), ctx=ctx)


# ---------------------------------------------------------------------------
# augmenters (parity: image.py CreateAugmenter :233 + image_aug_default.cc)
# ---------------------------------------------------------------------------
def _resize_shorter(img, size):
    from PIL import Image

    h, w = img.shape[:2]
    if h < w:
        new_h, new_w = size, int(w * size / h)
    else:
        new_h, new_w = int(h * size / w), size
    return np.asarray(Image.fromarray(img).resize((new_w, new_h),
                                                  Image.BILINEAR))


def _fixed_crop(img, x0, y0, w, h):
    return img[y0:y0 + h, x0:x0 + w]


def _center_crop(img, size):
    h, w = img.shape[:2]
    x0 = (w - size[0]) // 2
    y0 = (h - size[1]) // 2
    return _fixed_crop(img, x0, y0, size[0], size[1])


def _rand_crop(img, size):
    h, w = img.shape[:2]
    x0 = pyrandom.randint(0, max(w - size[0], 0))
    y0 = pyrandom.randint(0, max(h - size[1], 0))
    return _fixed_crop(img, x0, y0, size[0], size[1])


class Augmenter:
    def __call__(self, img):
        raise NotImplementedError


class ResizeAug(Augmenter):
    """Resize the shorter side to ``size`` (Pillow, bilinear)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        return _resize_shorter(img, self.size)


class ForceResizeAug(Augmenter):
    """Resize to ``size`` = (w, h) (Pillow, bilinear)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize(self.size,
                                                      Image.BILINEAR))


class RandomCropAug(Augmenter):
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        return _rand_crop(img, self.size)


class CenterCropAug(Augmenter):
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        return _center_crop(img, self.size)


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img):
        if pyrandom.random() < self.p:
            return img[:, ::-1]
        return img


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        self.brightness = brightness

    def __call__(self, img):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return np.clip(img.astype(np.float32) * alpha, 0,
                       255).astype(np.uint8)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        self.contrast = contrast

    def __call__(self, img):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = img.astype(np.float32).mean()
        return np.clip((img.astype(np.float32) - gray) * alpha + gray, 0,
                       255).astype(np.uint8)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        self.saturation = saturation

    def __call__(self, img):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = img.astype(np.float32).mean(axis=2, keepdims=True)
        return np.clip(img.astype(np.float32) * alpha + gray * (1 - alpha),
                       0, 255).astype(np.uint8)


class LightingAug(Augmenter):
    """PCA lighting noise (parity: image_aug_default.cc
    random_illumination)."""

    def __init__(self, alphastd, eigval, eigvec):
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, img):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = self.eigvec @ (alpha * self.eigval)
        return np.clip(img.astype(np.float32) + rgb, 0, 255).astype(np.uint8)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """Parity: image.py CreateAugmenter (:233)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size))
    else:
        auglist.append(CenterCropAug(crop_size))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    if brightness > 0:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast > 0:
        auglist.append(ContrastJitterAug(contrast))
    if saturation > 0:
        auglist.append(SaturationJitterAug(saturation))
    if pca_noise > 0:
        eigval = [55.46, 4.794, 1.148]
        eigvec = [[-0.5675, 0.7192, 0.4009],
                  [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    return auglist


# ---------------------------------------------------------------------------
# iterators
# ---------------------------------------------------------------------------
def _label_desc(batch_size, label_width):
    shape = (batch_size,) if label_width == 1 else (batch_size, label_width)
    return [DataDesc("softmax_label", shape)]


def _stage_batch(data, labels, pad, device):
    """The batch of host buffer ``data`` (from the pool) and labels
    ``(batch, label_width)`` on ``device``: both copied on stage, and
    ``data`` back to the pool once its copy has read it."""
    from . import storage

    label_out = labels[:, 0] if labels.shape[1] == 1 else labels
    lbuf = storage.staging_empty(label_out.shape, np.float32,
                                 pin=device.type == "cuda")
    lbuf.copy_(torch.from_numpy(np.ascontiguousarray(label_out)))
    return DataBatch([nd.NDArray(storage.stage_to_device(data, device))],
                     [nd.NDArray(storage.stage_to_device(lbuf, device))],
                     pad=pad)


class _OnDevice:
    """The device an iterator stages to, resolved at its first batch."""

    def _target(self):
        if self._dev is None:
            self._dev = nd._device(self._device_arg)
        return self._dev


class ImageIter(DataIter, _OnDevice):
    """Python image iterator over a ``.rec`` (sequential, or indexed
    with ``path_imgidx``), a ``.lst`` + image files, or an ``imglist``
    (parity: image.py ImageIter :277)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", mean=None, std=None,
                 device=None, **kwargs):
        super().__init__()
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self._device_arg, self._dev = device, None
        self.imgidx = None
        if path_imgrec:
            if path_imgidx:
                self.imgrec = MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = MXRecordIO(path_imgrec, "r")
        else:
            self.imgrec = None

        self.imglist = None
        if path_imglist:
            self.imglist = {}
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = np.array(parts[1:-1], dtype=np.float32)
                    self.imglist[int(parts[0])] = (label, parts[-1])
        elif isinstance(imglist, list):
            self.imglist = {}
            for i, item in enumerate(imglist):
                self.imglist[i] = (np.array(item[0], dtype=np.float32)
                                   if not np.isscalar(item[0])
                                   else np.array([item[0]], dtype=np.float32),
                                   item[1])

        self.path_root = path_root
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None
        if aug_list is None:
            aug_list = CreateAugmenter(data_shape)
        self.auglist = aug_list
        self.cur = 0
        if self.imglist is not None:
            self.seq = list(self.imglist.keys())
        elif self.imgidx is not None:
            self.seq = self.imgidx
        else:
            self.seq = None
        if num_parts > 1 and self.seq is not None:
            self.seq = self.seq[part_index::num_parts]
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return _label_desc(self.batch_size, self.label_width)

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                header, img = unpack(self.imgrec.read_idx(idx))
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root or "", fname), "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = unpack(s)
        return header.label, img

    def _process(self, raw):
        img = imdecode_np(raw)
        for aug in self.auglist:
            img = aug(img)
        img = img.astype(np.float32)
        if self.mean is not None:
            img = img - self.mean
        if self.std is not None:
            img = img / self.std
        return img.transpose(2, 0, 1)  # HWC -> CHW

    def next(self):
        from . import telemetry as _tm
        from .io import _TM_BATCHES

        # the end of the epoch is checked before the span: its
        # StopIteration records no data-io event
        if self.seq is not None and self.cur >= len(self.seq):
            raise StopIteration
        with _tm.span("ImageIter.next", category="data-io",
                      histogram_name="data_batch_wait_seconds",
                      iterator="ImageIter"):
            batch = self._next_impl()
        _TM_BATCHES.inc(iterator="ImageIter")
        return batch

    def _next_impl(self):
        from . import storage

        dev = self._target()
        data = storage.staging_empty((self.batch_size,) + self.data_shape,
                                     np.float32, pin=dev.type == "cuda")
        view = storage.host_array(data)
        labels = np.empty((self.batch_size, self.label_width), np.float32)
        i = 0
        pad = 0
        try:
            try:
                while i < self.batch_size:
                    label, raw = self.next_sample()
                    view[i] = self._process(raw)
                    lab = np.atleast_1d(np.asarray(label, np.float32))
                    labels[i, :self.label_width] = lab[:self.label_width]
                    i += 1
            except StopIteration:
                if i == 0:
                    raise
                pad = self.batch_size - i
                view[i:] = 0.0
                labels[i:] = 0.0
        except BaseException:
            # a decode error (or the end) must not leak the pooled block
            storage.staging_free(data)
            raise
        return _stage_batch(data, labels, pad, dev)


class ImageRecordIter(DataIter, _OnDevice):
    """Threaded RecordIO image pipeline (parity: ImageRecordIter,
    src/io/iter_image_recordio.cc:459): the shard's records are read
    once (the native reader for a local file, else
    :class:`~.filesystem.InputSplit`, which reads every remote scheme:
    ``s3://``, ``hdfs://``, ``http(s)://``, ...), then each batch is
    decoded and augmented on ``preprocess_threads`` threads (default
    ``MXNET_CPU_WORKER_NTHREADS``, 4) straight into a pooled staging
    buffer.  Wrap with ``io.PrefetchingIter`` for the
    PrefetcherIter stage."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, part_index=0, num_parts=1,
                 preprocess_threads=None, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, scale=1.0, resize=0,
                 path_imgidx=None, round_batch=True, seed=0, device=None,
                 **kwargs):
        super().__init__()
        self._device_arg, self._dev = device, None
        self.batch_size = batch_size
        self.data_shape = tuple(int(x) for x in data_shape)
        self.label_width = label_width
        self.scale = scale
        mean = None
        if mean_r or mean_g or mean_b:
            mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.mean = mean
        nthread = preprocess_threads or _env_int("MXNET_CPU_WORKER_NTHREADS",
                                                 4)
        self.pool = ThreadPoolExecutor(max_workers=nthread)
        self.aug = CreateAugmenter((self.data_shape if len(self.data_shape) == 3
                                    else (3,) + self.data_shape),
                                   resize=resize, rand_crop=rand_crop,
                                   rand_mirror=rand_mirror)
        from .filesystem import InputSplit, is_remote

        self.records = []
        native_ok = False
        if not is_remote(path_imgrec):
            try:
                from . import _native

                if _native.available():
                    rd = _native.NativeRecordReader(path_imgrec, part_index,
                                                    num_parts)
                    while True:
                        batch = rd.read_batch()  # a crossing per 1024
                        if not batch:
                            break
                        self.records.extend(batch)
                    rd.close()
                    native_ok = True
            except Exception:  # noqa: BLE001 — fall back to InputSplit
                self.records = []
        if not native_ok:
            # byte-range sharding with record alignment over any
            # registered filesystem (s3://, hdfs://, http(s)://, mem://):
            # a remote scheme comes here directly, never through the
            # local-only native scanner
            self.records = list(InputSplit(path_imgrec, part_index,
                                           num_parts))
        self.shuffle = shuffle
        self.seed = seed
        self.order = list(range(len(self.records)))
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return _label_desc(self.batch_size, self.label_width)

    def reset(self):
        if self.shuffle:
            rs = np.random.RandomState(self.seed)
            rs.shuffle(self.order)
            self.seed += 1
        self.cur = 0

    def _decode_one(self, rec):
        header, payload = unpack(rec)
        img = imdecode_np(payload)
        for aug in self.aug:
            img = aug(img)
        img = img.astype(np.float32)
        if self.mean is not None:
            img = img - self.mean
        if self.scale != 1.0:
            img = img * self.scale
        lab = np.atleast_1d(np.asarray(header.label, np.float32))
        return img.transpose(2, 0, 1), lab

    def _next_into(self, data, labels):
        """Decode the next batch into the caller's numpy buffers
        (``data`` ``(batch,) + data_shape`` float32, ``labels`` ``(batch,
        label_width)`` float32); returns the pad count or raises
        StopIteration.  The device-free core of :meth:`next`: the decode
        workers of ``mp_io`` call it with shared-memory ring slots."""
        if self.cur >= len(self.order):
            raise StopIteration
        idxs = self.order[self.cur:self.cur + self.batch_size]
        pad = self.batch_size - len(idxs)
        while len(idxs) < self.batch_size:
            # wrap-around padding, looped: a shard smaller than one batch
            # still fills every row
            idxs = idxs + self.order[:self.batch_size - len(idxs)]
        self.cur += self.batch_size

        def work(slot, rec):
            img, lab = self._decode_one(rec)
            data[slot] = img
            n = min(self.label_width, lab.size)
            labels[slot, :n] = lab[:n]
            labels[slot, n:] = 0.0

        list(self.pool.map(work, range(len(idxs)),
                           [self.records[i] for i in idxs]))
        return pad

    def next(self):
        from . import telemetry as _tm
        from .io import _TM_BATCHES

        if self.cur >= len(self.order):
            raise StopIteration
        # data-io profiling (parity: profiler_imageiter.py); the span
        # feeds data_batch_wait_seconds while telemetry is on
        with _tm.span("ImageRecordIter.next", category="data-io",
                      histogram_name="data_batch_wait_seconds",
                      iterator="ImageRecordIter"):
            batch = self._next_impl()
        _TM_BATCHES.inc(iterator="ImageRecordIter")
        return batch

    def _next_impl(self):
        from . import storage

        dev = self._target()
        data = storage.staging_empty((self.batch_size,) + self.data_shape,
                                     np.float32, pin=dev.type == "cuda")
        labels = np.empty((self.batch_size, self.label_width), np.float32)
        try:
            pad = self._next_into(storage.host_array(data), labels)
        except BaseException:
            storage.staging_free(data)  # a decode error must not leak it
            raise
        return _stage_batch(data, labels, pad, dev)


# the multi-process pipeline (decode processes -> shared-memory ring ->
# this process), surfaced beside the single-process iterator it
# parallelises
from .mp_io import MultiProcessImageRecordIter  # noqa: E402,F401
