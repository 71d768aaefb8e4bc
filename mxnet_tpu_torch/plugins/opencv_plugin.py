"""OpenCV plugin (mirrors ``mxnet_tpu/plugins/opencv_plugin.py``;
parity: plugin/opencv — imdecode / resize / copyMakeBorder NDArray
functions plus the python augment helpers in plugin/opencv/opencv.py).

Like the reference plugin, the functions call real libopencv (cv2) when
it is importable: imdecode, resize and copyMakeBorder go straight to
cv2 with the reference's flag values (which match cv2's numerically).
Without cv2 the same API rides the port's own decode path
(:func:`mxnet_tpu_torch.image.imdecode_np`: native libjpeg where it is
built, Pillow otherwise) and numpy/Pillow for geometry.  The work is
host work either way; each result is an NDArray on the current context
(the card, or the innermost ``with mx.Context(...)``), float32 as
``nd.array`` makes it.

ONE deliberate deviation from cv2 either way: channel order is **RGB**
(matching the rest of the image pipeline), not BGR — ported scripts
must flip any BGR-ordered mean/std constants.
"""
from __future__ import annotations

import numpy as np

from .. import image as _image
from ..base import MXNetError
from ..ndarray import NDArray, array

try:  # real OpenCV when present — the reference plugin's backend
    import cv2 as _cv2
except ImportError:  # pragma: no cover - depends on image
    _cv2 = None

# cv2 flag parity
INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_CUBIC = 2
BORDER_CONSTANT = 0
BORDER_REPLICATE = 1

_PIL_INTERP = {INTER_NEAREST: 0, INTER_LINEAR: 2, INTER_CUBIC: 3}


def imdecode(str_img, flag=1):
    """Decode a jpeg/png byte string into an HWC uint8 NDArray.
    flag=1 color, flag=0 grayscale (cv2.imdecode convention)."""
    raw = bytes(str_img)
    if _cv2 is not None:
        buf = np.frombuffer(raw, np.uint8)
        mode = (_cv2.IMREAD_UNCHANGED if flag < 0
                else _cv2.IMREAD_COLOR if flag else _cv2.IMREAD_GRAYSCALE)
        img = _cv2.imdecode(buf, mode)
        if img is None:
            raise MXNetError("cv2.imdecode failed (corrupt stream?)")
        if img.ndim == 2:
            img = img[..., None]
        elif img.shape[-1] >= 3:  # RGB contract (alpha stays last)
            img = img[..., [2, 1, 0] + list(range(3, img.shape[-1]))]
        return array(np.ascontiguousarray(img))
    img = _image.imdecode_np(raw)  # HWC uint8 (native libjpeg or PIL)
    if flag == 0:
        # ITU-R BT.601 luma over RGB-ordered channels
        img = (img @ np.array([0.299, 0.587, 0.114]))[..., None]
        img = img.astype(np.uint8)
    return array(img)


def resize(src, size, interpolation=INTER_LINEAR):
    """Resize HWC image to `size` = (w, h) (cv2 size convention)."""
    data = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    if _cv2 is not None and data.dtype in (np.uint8, np.uint16,
                                           np.float32, np.float64):
        # flag values match cv2's numerically (INTER_* = 0/1/2); other
        # dtypes (int64 from np.asarray of ints, float16, ...) fall
        # through to the PIL plane path, which casts and restores
        out = _cv2.resize(data, tuple(size), interpolation=interpolation)
        if data.ndim == 3 and data.shape[-1] == 1:
            out = out[..., None]  # cv2 drops the singleton channel
        return array(np.ascontiguousarray(out))
    from PIL import Image
    interp = _PIL_INTERP.get(interpolation, 2)
    if data.dtype == np.uint8:
        squeeze = data.shape[-1] == 1
        pil = Image.fromarray(data.squeeze(-1) if squeeze else data)
        out = np.asarray(pil.resize(tuple(size), interp))
        if squeeze:
            out = out[..., None]
    else:
        # float input (e.g. color_normalize output, zero-centered): cv2
        # preserves dtype, so resize channel-wise as mode-'F' planes —
        # casting to uint8 here would truncate/wrap the values
        if data.ndim == 2:
            out = np.asarray(Image.fromarray(
                data.astype(np.float32), mode="F").resize(tuple(size), interp))
        else:
            planes = [
                np.asarray(Image.fromarray(
                    data[..., c].astype(np.float32), mode="F").resize(
                        tuple(size), interp))
                for c in range(data.shape[-1])
            ]
            out = np.stack(planes, axis=-1)
        out = out.astype(data.dtype)
    return array(out)


def copyMakeBorder(src, top, bot, left, right, border_type=BORDER_CONSTANT,
                   value=0):
    """Pad an HWC image (cv2.copyMakeBorder)."""
    data = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    if _cv2 is not None and border_type in (BORDER_CONSTANT,
                                            BORDER_REPLICATE):
        # flag values match cv2's numerically (BORDER_* = 0/1)
        val = value if isinstance(value, (tuple, list)) else [value] * 4
        out = _cv2.copyMakeBorder(data, top, bot, left, right, border_type,
                                  value=val)
        if data.ndim == 3 and data.shape[-1] == 1 and out.ndim == 2:
            out = out[..., None]
        return array(np.ascontiguousarray(out))
    pads = ((top, bot), (left, right), (0, 0))
    if border_type == BORDER_CONSTANT:
        out = np.pad(data, pads, constant_values=value)
    elif border_type == BORDER_REPLICATE:
        out = np.pad(data, pads, mode="edge")
    else:
        raise MXNetError(f"unsupported border_type {border_type}")
    return array(out)


def scale_down(src_size, size):
    """Parity: opencv.py scale_down — fit (w,h) inside src_size."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def fixed_crop(src, x0, y0, w, h, size=None, interpolation=INTER_CUBIC):
    """Crop [y0:y0+h, x0:x0+w], optionally resizing to `size`."""
    data = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    out = array(data[y0:y0 + h, x0:x0 + w])
    if size is not None and (w, h) != tuple(size):
        out = resize(out, size, interpolation)
    return out


def random_crop(src, size, rng=None):
    """Random crop to (w,h) (scaled down to fit), returns (img, (x0,y0,w,h))."""
    rng = rng or np.random
    h, w = (src.shape[0], src.shape[1])
    new_w, new_h = scale_down((w, h), size)
    x0 = int(rng.uniform(0, w - new_w + 1))
    y0 = int(rng.uniform(0, h - new_h + 1))
    out = fixed_crop(src, x0, y0, new_w, new_h, size)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    """(img - mean) / std in float32."""
    data = src.asnumpy().astype(np.float32)
    data -= np.asarray(mean, np.float32)
    if std is not None:
        data /= np.asarray(std, np.float32)
    return array(data)


def random_size_crop(src, size, min_area=0.25, ratio=(3.0 / 4.0, 4.0 / 3.0),
                     rng=None):
    """Inception-style area+aspect jittered crop; falls back to
    random_crop when no candidate fits (parity: opencv.py)."""
    rng = rng or np.random
    h, w = src.shape[0], src.shape[1]
    for _ in range(10):
        area = h * w
        target_area = rng.uniform(min_area, 1.0) * area
        aspect = rng.uniform(*ratio)
        new_w = int(round(np.sqrt(target_area * aspect)))
        new_h = int(round(np.sqrt(target_area / aspect)))
        if rng.uniform(0, 1) < 0.5:
            new_w, new_h = new_h, new_w
        if new_w <= w and new_h <= h:
            x0 = int(rng.uniform(0, w - new_w + 1))
            y0 = int(rng.uniform(0, h - new_h + 1))
            return fixed_crop(src, x0, y0, new_w, new_h, size), \
                (x0, y0, new_w, new_h)
    return random_crop(src, size, rng)


class ImageListIter:
    """Minimal folder+list iterator (parity: opencv.py ImageListIter):
    decodes with this module, yields NCHW float batches."""

    def __init__(self, root, flist, batch_size, size, mean=None):
        self.root = root
        self.list = list(flist)
        self.batch_size = batch_size
        self.size = tuple(size)
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.cur = 0

    def reset(self):
        self.cur = 0

    def __iter__(self):
        return self

    def __next__(self):
        import os

        if self.cur + self.batch_size > len(self.list):
            raise StopIteration
        batch = np.zeros((self.batch_size, 3, self.size[1], self.size[0]),
                         np.float32)
        for i in range(self.batch_size):
            with open(os.path.join(self.root, self.list[self.cur + i]),
                      "rb") as f:
                img = imdecode(f.read())
            img, _ = random_crop(img, self.size)
            data = img.asnumpy().astype(np.float32)
            if self.mean is not None:
                data -= self.mean
            batch[i] = data.transpose(2, 0, 1)
        self.cur += self.batch_size
        return array(batch)

    next = __next__
