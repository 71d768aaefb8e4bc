"""KVStore of the port: the local and device stores (mirrors
``mxnet_tpu/kvstore.py:104-500``; parity: include/mxnet/kvstore.h and
python/mxnet/kvstore.py).

``init``/``push``/``pull`` over one key or a list of keys.  A pushed
value may be a list of copies (one per device in MXNet); they are summed
(``Comm::Reduce``) on the device of the stored value.  With an optimizer
set (``set_optimizer``) a push runs the update on the stored weight
(update_on_kvstore); without one it replaces the stored value
(aggregation only).  Batched pushes and pulls over key lists go through
the bucketed update engine of :mod:`mxnet_tpu_torch.kvstore_fused` when
the optimizer has a fused rule; ``MXTPU_FUSED_UPDATE=0``, an optimizer
without one (NAG, centered RMSProp), a custom updater and keys the
engine does not know keep the eager per-key loops, as in the reference.

Stored values keep the memory format of the value they were initialised
from (a channels-last conv weight stays channels-last).  ``dist_*``
stores wait for ROADMAP Queue 1 item 10 and ``row_sparse_pull`` for
item 7; both raise.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_LOCAL_TYPES = ("local", "device", "local_allreduce_cpu",
                "local_allreduce_device", "local_update_cpu")


def _key_list(key):
    return ((key if isinstance(key, (list, tuple)) else [key]),
            not isinstance(key, (list, tuple)))


def _check_pairs(keys, values, op, what="values"):
    """A key list zipped against a value list of another length would
    silently drop keys."""
    if values is None or len(keys) != len(values):
        got = "None" if values is None else str(len(values))
        raise MXNetError(f"KVStore.{op}: got {len(keys)} keys but {got} "
                         f"{what}")


def _tensor(v) -> torch.Tensor:
    return v.tensor if isinstance(v, NDArray) else v


class KVStore:
    """A single-process store (``local``, ``device`` and their aliases)."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store: Dict = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None
        self._fused = None

    # ------------------------------------------------------------ basic
    def init(self, key, value):
        """Store a copy of each value; each key once."""
        keys, _ = _key_list(key)
        values = value if isinstance(value, (list, tuple)) else [value]
        _check_pairs(keys, values, "init")
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"duplicate init of key {k}")
            self._store[k] = NDArray(_tensor(v).detach().clone())

    def _merge(self, k, v) -> torch.Tensor:
        """One pushed value (or the sum of a list of copies) on the
        stored value's device."""
        dev = self._store[k].tensor.device
        vlist = v if isinstance(v, (list, tuple)) else [v]
        merged = _tensor(vlist[0]).to(dev)
        if len(vlist) > 1:
            merged = merged.clone()
            for other in vlist[1:]:
                merged += _tensor(other).to(dev)
        return merged

    def push(self, key, value, priority=0):
        """Push one value (or a list of per-device copies) per key."""
        keys, single = _key_list(key)
        if single:
            values = [value]
        else:
            values = value
            _check_pairs(keys, values, "push")
        if (self._fused is not None and not single
                and self._fused.handle_push(keys, values)):
            return
        for k, v in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"KVStore.push: key {k!r} was never "
                                 "initialised")
            merged = self._merge(k, v)
            if self._updater is not None:
                self._updater(k, NDArray(merged), self._store[k])
            else:
                # aggregation only: the merged value replaces the stored
                self._store[k].tensor.copy_(merged)

    def pull(self, key, out=None, priority=0):
        """Copy each key's stored value into its out array(s)."""
        keys, single = _key_list(key)
        if single:
            outs = [out]
        else:
            outs = out
            _check_pairs(keys, outs, "pull", what="out arrays")
        if (self._fused is not None and not single
                and self._fused.handle_pull(keys, outs)):
            return
        for k, o in zip(keys, outs):
            src = self._store[k].tensor
            for oo in (o if isinstance(o, (list, tuple)) else [o]):
                _tensor(oo).copy_(src)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("KVStore.row_sparse_pull (row-sparse keys) is not "
                         "ported yet (ROADMAP Queue 1 item 7)")

    # -------------------------------------------------------- optimizer
    def set_optimizer(self, optimizer):
        """Run ``optimizer`` in the store (update_on_kvstore); batched
        pushes go through the bucketed engine when it has a fused rule."""
        from . import kvstore_fused as kvf
        from . import optimizer as opt

        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self._fused = None
        if kvf.fused_update_enabled() and optimizer.fused_rule() is not None:
            self._fused = kvf.FusedUpdateEngine(self, optimizer,
                                                self._updater)

    def _set_updater(self, updater):
        """A custom updater ``updater(key, grad, weight)``: the eager
        per-key path."""
        self._updater = updater
        self._optimizer = None
        self._fused = None

    set_updater = _set_updater

    # ------------------------------------------------------ distributed
    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def barrier(self):
        pass

    def save_optimizer_states(self, fname):
        if self._updater is None or not hasattr(self._updater, "get_states"):
            raise MXNetError("no updater/optimizer set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None or not hasattr(self._updater, "set_states"):
            raise MXNetError("no updater/optimizer set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def create(name="local") -> KVStore:
    """``mx.kv.create``: ``local``/``device`` (and the reference's
    aliases) are ported; ``dist_*`` raises."""
    if not isinstance(name, str):
        raise TypeError("name must be str")
    if "dist" in name:
        raise MXNetError(f"kvstore {name!r}: the distributed stores are not "
                         "ported yet (ROADMAP Queue 1 item 10)")
    if name in _LOCAL_TYPES:
        return KVStore(name)
    raise MXNetError(f"unknown kvstore type {name}")
