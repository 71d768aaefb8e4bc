"""The multi-process image pipeline of the port (mirrors
``mxnet_tpu/mp_io.py``; parity: src/io/iter_image_recordio.cc:150-368).

The reference's one process decodes on an OpenMP thread pool because
C++ threads scale with cores; a Python host adds the GIL on the numpy
and augment stages, so the whole pipeline fans out across processes:

    worker p of N:  its shard (the native reader or InputSplit) ->
                    decode -> augment -> batch, written once, straight
                    into a shared-memory ring slot
                    (``ImageRecordIter._next_into`` with ring views)
    consumer:       pops finished slots, copies each into a pinned
                    staging buffer (``storage``), hands the slot back and
                    stages the buffer to the device

Workers never touch CUDA: they are started by ``forkserver`` by default
(``MXTPU_MP_START`` or ``start_method=`` choose another), so a parent
whose CUDA context is up is never forked, and each worker turns
``torch.cuda``'s initialisation into an error before it decodes, which
reaches the consumer as :class:`MXNetError`.  Stack
``MultiProcessImageRecordIter -> io.DevicePrefetchIter`` to overlap the
host pipeline with the device.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod

import numpy as np
import torch

from .base import MXNetError
from .io import DataDesc, DataIter

__all__ = ["MultiProcessImageRecordIter"]


def _attach_shm(name):
    from multiprocessing import shared_memory
    import inspect

    # the parent owns the segments' lifetime: workers attach without
    # resource-tracker registration (3.13+ has track=False; a 3.12 attach
    # does not register, and an explicit unregister would make the
    # tracker's count go negative at exit)
    if "track" in inspect.signature(
            shared_memory.SharedMemory.__init__).parameters:
        return shared_memory.SharedMemory(name=name, track=False)
    return shared_memory.SharedMemory(name=name)


def _forbid_cuda():
    """Make any initialisation of CUDA in this process an error (and
    refuse to run in one where it already happened)."""
    import torch

    if torch.cuda.is_initialized():
        raise MXNetError("an mp_io decode worker started with CUDA "
                         "initialised")

    def refuse(*args, **kwargs):
        raise MXNetError("an mp_io decode worker touched torch.cuda; "
                         "workers must stay off the device")

    torch.cuda._lazy_init = refuse
    torch.cuda.init = refuse
    torch.cuda.is_available = refuse
    torch.cuda.device_count = refuse


def _worker(path, data_shape, batch_size, label_width, wid, num_workers,
            part_index, num_parts, slot_names, free_q, full_q, stop,
            barrier, seed, iter_kwargs):
    """Decode worker: the whole shard -> decode -> augment -> batch
    pipeline over shard ``wid`` of ``num_workers``, each batch written
    into a free ring slot.  After a pass it posts ``end`` and waits at
    the barrier until the consumer has drained the epoch."""
    import traceback

    try:
        _forbid_cuda()
        from .image import ImageRecordIter

        shms = {name: _attach_shm(name) for name in slot_names}
    except Exception as exc:  # noqa: BLE001 — surface in the consumer
        full_q.put(("error", wid, "".join(traceback.format_exception(exc))))
        return
    data_elems = batch_size * int(np.prod(data_shape))
    try:
        # this host's part composes with the fan-out: the worker owns
        # global shard part_index * num_workers + wid
        it = ImageRecordIter(path_imgrec=path, data_shape=data_shape,
                             batch_size=batch_size, label_width=label_width,
                             part_index=part_index * num_workers + wid,
                             num_parts=num_parts * num_workers,
                             seed=seed + wid, device="cpu", **iter_kwargs)
        while not stop.is_set():
            it.reset()
            while True:
                slot = free_q.get()
                if slot is None or stop.is_set():
                    return
                buf = shms[slot].buf
                data = np.ndarray((batch_size,) + tuple(data_shape),
                                  np.float32, buffer=buf)
                labels = np.ndarray((batch_size, label_width), np.float32,
                                    buffer=buf, offset=data_elems * 4)
                try:
                    pad = it._next_into(data, labels)  # noqa: SLF001
                except StopIteration:
                    free_q.put(slot)
                    break
                except Exception as exc:  # noqa: BLE001
                    # a decode failure surfaces in the consumer at once,
                    # not as a stall
                    free_q.put(slot)
                    full_q.put(("error", wid,
                                "".join(traceback.format_exception(exc))))
                    return
                full_q.put(("batch", slot, pad))
            full_q.put(("end", wid))
            try:
                barrier.wait()
            except Exception:  # noqa: BLE001 — an aborted barrier: shutdown
                return
    except Exception as exc:  # noqa: BLE001
        full_q.put(("error", wid, "".join(traceback.format_exception(exc))))
    finally:
        for shm in shms.values():
            shm.close()


class MultiProcessImageRecordIter(DataIter):
    """N-process RecordIO image pipeline over a shared-memory ring.

    ``path_imgrec``/``data_shape``/``batch_size``/``label_width`` and the
    augmentation keywords are ``ImageRecordIter``'s (each worker builds
    one over its own shard).  ``num_workers`` processes publish batches
    into ``slots`` ring slots (default ``2 * workers + 2``);
    ``part_index``/``num_parts`` shard across hosts, subdivided across
    this host's workers.  One epoch is every worker's pass over its
    shard (each wrap-pads its own last batch); workers run ahead into
    the next epoch while the consumer drains this one.  Batches land on
    ``device`` (default: the card).  ``close()`` (or garbage
    collection) stops the processes and unlinks the ring."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 num_workers=2, part_index=0, num_parts=1, slots=None,
                 seed=0, start_method=None, stall_timeout=300.0,
                 device=None, **iter_kwargs):
        super().__init__()
        from multiprocessing import shared_memory

        self._device_arg, self._dev = device, None
        self.batch_size = int(batch_size)
        self.data_shape = tuple(int(x) for x in data_shape)
        self.label_width = int(label_width)
        self.num_workers = int(num_workers)
        if self.num_workers < 1:
            raise MXNetError("num_workers must be >= 1")
        self._closed = True
        self._stall_timeout = float(stall_timeout)
        default = "forkserver" if hasattr(os, "fork") else "spawn"
        method = start_method or os.environ.get("MXTPU_MP_START", default)
        ctx = mp.get_context(method)
        n_slots = int(slots) if slots else 2 * self.num_workers + 2
        data_elems = self.batch_size * int(np.prod(self.data_shape))
        slot_bytes = 4 * (data_elems + self.batch_size * self.label_width)
        self._data_elems = data_elems
        self._shms = [shared_memory.SharedMemory(create=True, size=slot_bytes)
                      for _ in range(n_slots)]
        self._shm_by_name = {s.name: s for s in self._shms}
        self._free_q = ctx.Queue()
        for s in self._shms:
            self._free_q.put(s.name)
        self._full_q = ctx.Queue()
        self._stop = ctx.Event()
        # workers and consumer meet here at every epoch boundary
        self._barrier = ctx.Barrier(self.num_workers + 1)
        self._ends = set()
        self._closed = False
        self._procs = [
            ctx.Process(
                target=_worker,
                args=(path_imgrec, self.data_shape, self.batch_size,
                      self.label_width, wid, self.num_workers,
                      int(part_index), int(num_parts),
                      [s.name for s in self._shms], self._free_q,
                      self._full_q, self._stop, self._barrier, seed,
                      iter_kwargs),
                daemon=True)
            for wid in range(self.num_workers)
        ]
        for p in self._procs:
            p.start()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        # the workers run on; the consumer just opens the next epoch
        pass

    def next(self):
        from . import telemetry as _tm
        from .io import _TM_BATCHES

        with _tm.span("MultiProcessImageRecordIter.next",
                      category="data-io",
                      histogram_name="data_batch_wait_seconds",
                      iterator="MultiProcessImageRecordIter"):
            batch = self._next_impl()
        _TM_BATCHES.inc(iterator="MultiProcessImageRecordIter")
        return batch

    def _next_impl(self):
        from . import ndarray as nd
        from . import storage
        from .image import _stage_batch

        if self._closed:
            raise MXNetError("iterator is closed")
        if self._dev is None:
            self._dev = nd._device(self._device_arg)
        waited = 0.0
        while True:
            try:
                msg = self._full_q.get(timeout=1.0)
            except queue_mod.Empty:
                # a worker that died before it could report (a start-up
                # failure, a signal) is named at once, not after a stall
                dead = {w: p.exitcode for w, p in enumerate(self._procs)
                        if p.exitcode not in (None, 0)}
                waited += 1.0
                if dead or waited >= self._stall_timeout:
                    raise MXNetError(
                        f"input workers stalled for {waited:.0f}s (dead "
                        f"workers and exit codes: {dead or 'none'})"
                    ) from None
                continue
            waited = 0.0
            if msg[0] == "error":
                raise MXNetError(f"input worker {msg[1]} failed:\n{msg[2]}")
            if msg[0] == "end":
                self._ends.add(msg[1])
                if len(self._ends) == self.num_workers:
                    self._ends = set()
                    self._barrier.wait(timeout=self._stall_timeout)
                    raise StopIteration
                continue
            _, slot, pad = msg
            buf = self._shm_by_name[slot].buf
            view = np.ndarray((self.batch_size,) + self.data_shape,
                              np.float32, buffer=buf)
            lview = np.ndarray((self.batch_size, self.label_width),
                               np.float32, buffer=buf,
                               offset=self._data_elems * 4)
            # one copy into a pooled (pinned) staging buffer, then the
            # slot goes straight back: the ring never waits on the copy
            # to the device
            data = storage.staging_empty(
                (self.batch_size,) + self.data_shape, np.float32,
                pin=self._dev.type == "cuda")
            data.copy_(torch.from_numpy(view))
            labels = lview.copy()
            del view, lview
            self._free_q.put(slot)
            return _stage_batch(data, labels, pad, self._dev)

    def close(self):
        """Stop the workers, drain the ring, unlink the shared memory."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            self._barrier.abort()  # wake workers parked at an epoch end
        except Exception:  # noqa: BLE001
            pass
        for _ in self._procs:  # wake workers blocked on free_q.get()
            self._free_q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        # drain the queues so their feeder threads do not block exit
        for q in (self._full_q, self._free_q):
            try:
                while True:
                    q.get_nowait()
            except (queue_mod.Empty, OSError):
                pass
            q.close()
        for shm in self._shms:
            try:
                shm.close()
                shm.unlink()
            except Exception:  # noqa: BLE001 — double close at exit
                pass
        self._shms = []

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
