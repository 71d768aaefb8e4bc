"""Resource manager of the port (mirrors ``mxnet_tpu/resource.py``;
parity: include/mxnet/resource.h ResourceRequest/Resource/
ResourceManager).

The reference hands ops two kinds of resource; the graph's own ops here
draw from the port's ``torch.Generator``s (:mod:`.random`) and get their
scratch from PyTorch's caching allocator, so the manager serves the
host-side consumers (``Custom`` ops, plugins):

- ``kRandom``: a seeded ``numpy.random.Generator`` stream per context,
  the same stream as the JAX package's for the same seed
  (``numpy.random.default_rng``); ``mx.random.seed`` reseeds every one;
- ``kTempSpace``: reusable host scratch from the native arena
  (``_native.NativeArena``, ``src/storage.cc``), as in the reference
  (``mxnet_tpu/resource.py:102-120``): a space that grows hands its
  block back to the arena's size-class pool; pageable numpy memory
  where the library cannot be built.  Grown on demand, never shrunk;
  ``MXNET_EXEC_NUM_TEMP`` (default 1) bounds the spaces per context,
  handed out round-robin.
"""
from __future__ import annotations

import os
import threading

import numpy as np

from .base import MXNetError

__all__ = ["ResourceRequest", "Resource", "ResourceManager"]


class ResourceRequest:
    """Parity: ResourceRequest::Type (resource.h:18-36)."""

    kRandom = "random"
    kTempSpace = "temp_space"

    def __init__(self, type):  # noqa: A002 - the reference's field name
        if type not in (self.kRandom, self.kTempSpace):
            raise MXNetError(f"unknown resource type {type!r}")
        self.type = type

    def __repr__(self):
        return f"ResourceRequest({self.type})"


class Resource:
    """A granted resource: ``generator()``/``seed(n)`` for ``kRandom``,
    ``get_space(shape, dtype)`` for ``kTempSpace`` (a numpy array over
    the space's block, whose contents are undefined and which the next
    call reuses)."""

    def __init__(self, req, ctx, slot):
        self.req = req
        self.ctx = ctx
        self._slot = slot
        self._lock = threading.Lock()
        if req.type == ResourceRequest.kRandom:
            self._gen = np.random.default_rng(0)
        else:
            self._buf = None  # a uint8 array, grown on demand

    # ------------------------------------------------------------ kRandom
    def generator(self):
        if self.req.type != ResourceRequest.kRandom:
            raise MXNetError("not a random resource")
        return self._gen

    def seed(self, seed):
        self._gen = np.random.default_rng(seed)

    # --------------------------------------------------------- kTempSpace
    def get_space(self, shape, dtype=np.float32):
        """Scratch of ``shape`` and ``dtype`` (parity: Resource::
        get_space, resource.h:84-100)."""
        if self.req.type != ResourceRequest.kTempSpace:
            raise MXNetError("not a temp_space resource")
        dtype = np.dtype(dtype)
        count = int(np.prod(shape)) if shape else 1
        nbytes = count * dtype.itemsize
        with self._lock:
            if self._buf is None or self._buf.nbytes < nbytes:
                arena = _arena()
                if self._buf is not None and arena is not None:
                    arena.free(self._buf)   # back to its size class
                self._buf = arena.alloc((nbytes,), np.uint8) \
                    if arena is not None else np.empty(nbytes, np.uint8)
            flat = self._buf[:nbytes].view(dtype)
        return flat[:count].reshape(shape)


_ARENA = None       # the shared NativeArena; False: no library here
_ARENA_LOCK = threading.Lock()


def _arena():
    """The native arena that backs the temp spaces, or None where the
    library cannot be built."""
    global _ARENA
    with _ARENA_LOCK:
        if _ARENA is None:
            from . import _native

            _ARENA = _native.NativeArena() if _native.available() else False
        return _ARENA or None


class ResourceManager:
    """The per-context resource registry (parity: ResourceManager::
    Get()); ``get()`` is the process's one manager."""

    _instance = None
    _ilock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._temp = {}  # ctx str -> [Resource]
        self._rand = {}  # ctx str -> Resource
        self._rr = {}

    @classmethod
    def get(cls):
        with cls._ilock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def request(self, ctx, req):
        """The resource of kind ``req`` (a ResourceRequest or its type
        string) for ``ctx``."""
        if isinstance(req, str):
            req = ResourceRequest(req)
        key = str(ctx)
        with self._lock:
            if req.type == ResourceRequest.kRandom:
                if key not in self._rand:
                    self._rand[key] = Resource(req, ctx, 0)
                return self._rand[key]
            num = max(1, int(os.environ.get("MXNET_EXEC_NUM_TEMP", "1")
                             or 1))
            slots = self._temp.setdefault(key, [])
            if len(slots) < num:
                slots.append(Resource(req, ctx, len(slots)))
                return slots[-1]
            self._rr[key] = (self._rr.get(key, -1) + 1) % num
            return slots[self._rr[key]]

    def seed_random(self, seed):
        """Reseed every ``kRandom`` stream (MXRandomSeed's every-device
        seeding)."""
        with self._lock:
            for r in self._rand.values():
                # lock-ok: r is a Resource kRandom stream whose seed() is
                # a plain generator reseed; the lint's virtual dispatch also
                # matches random.seed (which re-enters this manager), but
                # that callee cannot be reached from a Resource value
                r.seed(seed)
