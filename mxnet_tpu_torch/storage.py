"""The host staging pool of the port (mirrors ``mxnet_tpu/storage.py``;
parity: include/mxnet/storage.h, src/storage/pooled_storage_manager.h
and the MXStorageEmptyCache C API).

What the reference's pooled storage manager buys on a card is host
*staging*: the per-batch buffers the data pipeline fills before the
copy to the device.  Here they are pinned host tensors, because only a
copy from pinned memory runs asynchronously on a stream, and pinning a
fresh ~19 MB batch each time is a synchronous ``cudaHostAlloc``:

- :func:`staging_empty` hands out an uninitialised host tensor from the
  pool, pinned when ``pin`` (the target is the card); blocks are
  recycled by power-of-two size class (at least 256 bytes, the classes
  of ``src/storage.cc``), pinned and pageable apart;
- :func:`host_array` is the numpy view of a staging buffer (made once
  a block, so a steady pipeline calls no ``Tensor.numpy`` a batch);
- :func:`staging_free` returns one; :func:`pool_bytes` counts the bytes
  parked in the free lists and :func:`release_all` drops them (parity:
  MXStorageEmptyCache);
- :func:`pinned_empty` hands a pinned block of the pool to a caller
  that keeps it (the ``cpu_pinned`` context's arrays): it leaves the
  pool, and PyTorch's pinned-memory cache takes it back when the array
  dies;
- :func:`stage_to_device` is copy-on-stage, as in the reference: the
  returned tensor never aliases the pooled buffer.  To the card, the
  copy runs on a staging stream into a tensor allocated under that
  stream; the consumer's stream waits on the copy's event (no host
  wait) and the tensor is recorded on it; the buffer goes back to the
  pool only after that event has completed (:func:`release_after`,
  polled with ``Event.query`` when a buffer is next asked for).  To the
  CPU it is a copy, and the buffer is free at once.

``MXTPU_STORAGE_POOL=0`` turns pooling off (a fresh tensor per call),
as in the reference; :class:`pooling_disabled` does so for a block.
The pool is shared by every thread of the process; decode worker
processes (``mp_io``) never call into it.
"""
from __future__ import annotations

import os
import threading
from collections import defaultdict

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device

__all__ = ["staging_empty", "host_array", "staging_free", "pinned_empty",
           "stage_to_device",
           "release_after", "pool_bytes", "release_all", "pooling_disabled"]

_lock = threading.Lock()
_free = defaultdict(list)   # (class bytes, pinned) -> free blocks
_live = {}                  # data_ptr -> (block, class bytes, pinned)
# a block is (uint8 tensor, its numpy view)
_pending = []               # (event, data_ptr): copies still reading
_streams = {}               # device -> its staging stream
_enabled = None             # None: read MXTPU_STORAGE_POOL at first use


def _pool_on() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("MXTPU_STORAGE_POOL", "1").strip() != "0"
    return _enabled


def _class_bytes(nbytes: int) -> int:
    size = 256
    while size < nbytes:
        size <<= 1
    return size


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _reclaim():
    """Move the blocks whose copies have completed back to the free
    lists (``Event.query`` does not wait).  Called with ``_lock``."""
    keep = []
    for event, ptr in _pending:
        if event.query():
            block, size, pinned = _live.pop(ptr)
            _free[(size, pinned)].append(block)
        else:
            keep.append((event, ptr))
    _pending[:] = keep


def staging_empty(shape, dtype=np.float32, pin=False) -> torch.Tensor:
    """An uninitialised host tensor of ``shape`` from the pool, in
    pinned memory when ``pin``."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    shape = tuple(int(s) for s in shape)
    tdtype = _torch_dtype(dtype)
    if not _pool_on():
        return torch.empty(shape, dtype=tdtype, pin_memory=pin)
    nbytes = int(np.prod(shape)) * torch.empty(0, dtype=tdtype).element_size()
    size = _class_bytes(nbytes)
    with _lock:
        _reclaim()
        free = _free[(size, bool(pin))]
        block = free.pop() if free else None
    if block is None:
        t = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
        block = (t, t.numpy())
    view = block[0][:nbytes].view(tdtype).view(shape)
    with _lock:
        _live[view.data_ptr()] = (block, size, bool(pin))
    return view


def pinned_empty(shape, dtype=np.float32) -> torch.Tensor:
    """An uninitialised pinned host tensor of ``shape`` that the caller
    owns: a free pinned block of its size class when the pool has one,
    else a new one.  Pinning needs a card: without one it raises
    :class:`MXNetError`."""
    if not torch.cuda.is_available():
        raise MXNetError("pinned host memory (cpu_pinned) needs a CUDA "
                         "device; use cpu() on a host without one")
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    shape = tuple(int(s) for s in shape)
    tdtype = _torch_dtype(dtype)
    nbytes = int(np.prod(shape)) * torch.empty(0, dtype=tdtype).element_size()
    block = None
    if _pool_on():
        with _lock:
            _reclaim()
            free = _free[(_class_bytes(nbytes), True)]
            block = free.pop() if free else None
    t = block[0] if block is not None else torch.empty(
        max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
    return t[:nbytes].view(tdtype).view(shape)


def host_array(buf) -> np.ndarray:
    """The numpy array sharing ``buf``'s memory (``buf`` from
    :func:`staging_empty`)."""
    with _lock:
        hit = _live.get(buf.data_ptr())
    if hit is None:
        return buf.numpy()
    nbytes = buf.numel() * buf.element_size()
    npdtype = np.dtype(str(buf.dtype).split(".")[-1])
    return hit[0][1][:nbytes].view(npdtype).reshape(buf.shape)


def staging_free(buf):
    """Return a :func:`staging_empty` buffer to the pool (a no-op for
    any other tensor)."""
    with _lock:
        hit = _live.pop(buf.data_ptr(), None)
        if hit is not None:
            block, size, pinned = hit
            _free[(size, pinned)].append(block)


def release_after(buf, event):
    """Return a pooled ``buf`` once ``event`` (anything with a
    non-blocking ``query()``) has completed: until then no
    :func:`staging_empty` hands its block out again."""
    with _lock:
        if buf.data_ptr() in _live:
            _pending.append((event, buf.data_ptr()))


def _staging_stream(device) -> torch.cuda.Stream:
    with _lock:
        stream = _streams.get(device)
        if stream is None:
            stream = _streams[device] = torch.cuda.Stream(device)
        return stream


def stage_to_device(buf, device=None, stream=None) -> torch.Tensor:
    """A copy of host tensor ``buf`` on ``device`` (default: the card);
    ``buf`` goes back to the pool once the copy no longer reads it.

    On the card the copy is asynchronous on the staging stream, and
    ``stream`` (default: the calling thread's current stream) — the one
    that will read the result — waits for it on the device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        out = buf.to(dev, copy=True)
        staging_free(buf)
        return out
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    consumer = stream if stream is not None else torch.cuda.current_stream(dev)
    staging = _staging_stream(dev)
    with torch.cuda.stream(staging):
        out = torch.empty(buf.shape, dtype=buf.dtype, device=dev)
        out.copy_(buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record(staging)
    consumer.wait_event(event)
    out.record_stream(consumer)
    if buf.is_pinned():
        release_after(buf, event)
    else:
        # a copy from pageable memory has left it before returning
        staging_free(buf)
    return out


def pool_bytes() -> int:
    """Bytes parked in the free lists (0 when pooling is off)."""
    with _lock:
        _reclaim()
        return sum(size * len(blocks) for (size, _), blocks in _free.items())


def release_all():
    """Drop every free block (parity: MXStorageEmptyCache); buffers
    handed out or still being copied stay theirs."""
    with _lock:
        _reclaim()
        _free.clear()


class pooling_disabled:
    """Run a block with the pool off (a fresh tensor per call),
    restoring the setting afterwards — for A/B measurement and tests."""

    def __enter__(self):
        global _enabled
        self._saved = _pool_on()
        _enabled = False
        return self

    def __exit__(self, *exc):
        global _enabled
        _enabled = self._saved
        return False
