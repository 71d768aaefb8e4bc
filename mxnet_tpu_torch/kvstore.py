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
from (a channels-last conv weight stays channels-last).

Row-sparse keys (:mod:`mxnet_tpu_torch.sparse`): a key initialised with
a ``RowSparseNDArray`` (``sparse.full_row_sparse(table)``) is row-sparse
for good, and pushes to it must be row-sparse, as pushes to a dense key
must be dense (a mismatch either way raises).  The stored table is dense;
a row-sparse push runs the touched-rows-only update
(``sparse.eager_update`` through the ``Updater``, or the bucketed
engine's sparse buckets), and ``row_sparse_pull`` copies out only the
rows asked for.  Every pull copies: the table is updated in place, so
no array a caller holds aliases it.  ``dist_*`` stores wait for ROADMAP
Queue 1 item 10 and raise.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import faults as _faults
from . import sparse as _sparse
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
        # each key's storage type, fixed at init
        self._stypes: Dict = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None
        self._fused = None

    # ------------------------------------------------------------ basic
    def init(self, key, value):
        """Store a copy of each value; each key once.  A row-sparse value
        makes the key row-sparse (its table is stored dense)."""
        keys, _ = _key_list(key)
        values = value if isinstance(value, (list, tuple)) else [value]
        _check_pairs(keys, values, "init")
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"duplicate init of key {k}")
            stype = getattr(v, "stype", "default")
            self._stypes[k] = stype
            if stype == "row_sparse":
                v = v.todense()
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
        """Push one value (or a list of per-device copies) per key
        (fault site ``kv_push``)."""
        _faults.maybe_fail("kv_push")
        keys, single = _key_list(key)
        if single:
            values = [value]
        else:
            values = value
            _check_pairs(keys, values, "push")
        self._check_push_stypes(keys, values)
        if (self._fused is not None and not single
                and self._fused.handle_push(keys, values)):
            return
        for k, v in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"KVStore.push: key {k!r} was never "
                                 "initialised")
            vlist = v if isinstance(v, (list, tuple)) else [v]
            if getattr(vlist[0], "stype", "default") == "row_sparse":
                self._push_row_sparse(k, vlist)
                continue
            merged = self._merge(k, v)
            if self._updater is not None:
                self._updater(k, NDArray(merged), self._store[k])
            else:
                # aggregation only: the merged value replaces the stored
                self._store[k].tensor.copy_(merged)

    def _check_push_stypes(self, keys, values):
        """A row-sparse gradient on a dense key, or a dense one on a
        row-sparse key, raises: the dense path would scatter garbage and
        the sparse path would decay rows it should not touch."""
        for k, v in zip(keys, values):
            vl = v if isinstance(v, (list, tuple)) else [v]
            vstype = getattr(vl[0], "stype", "default") if vl else "default"
            if any(getattr(o, "stype", "default") != vstype for o in vl[1:]):
                raise MXNetError(f"KVStore.push: key {k!r} received mixed "
                                 "storage types across device copies")
            kstype = self._stypes.get(k)
            if kstype is not None and vstype != kstype:
                raise MXNetError(
                    f"KVStore.push: key {k!r} was initialized {kstype!r} "
                    f"but received a {vstype!r} value; init the key with "
                    "the matching storage type (mx.nd.sparse / dense "
                    "NDArray)")

    def _push_row_sparse(self, k, vlist):
        """The eager per-key row-sparse push: the device copies are
        concatenated (the row update's segment sum adds them) and the
        touched-rows-only update runs through the updater."""
        merged = _sparse.concat_rows(vlist)
        if self._updater is not None:
            self._updater(k, merged, self._store[k])
        else:
            # aggregation only: the merged gradient replaces the value
            self._store[k] = merged.copy()
        if _sparse._tm.enabled():
            rows = int(merged._indices.shape[0])
            _sparse._TM_SPARSE_ROWS.inc(rows, store=self.type)
            _sparse._TM_SPARSE_DENSITY.observe(
                rows / max(merged.shape[0], 1), store=self.type)

    def pull(self, key, out=None, priority=0):
        """Copy each key's stored value into its out array(s); a
        row-sparse out array on a dense value raises (use
        :meth:`row_sparse_pull`; fault site ``kv_pull``)."""
        _faults.maybe_fail("kv_pull")
        keys, single = _key_list(key)
        if single:
            outs = [out]
        else:
            outs = out
            _check_pairs(keys, outs, "pull", what="out arrays")
        for k, o in zip(keys, outs):
            for oo in (o if isinstance(o, (list, tuple)) else [o]):
                if (getattr(oo, "stype", "default") == "row_sparse"
                        and getattr(self._store[k], "stype",
                                    "default") == "default"):
                    raise MXNetError(
                        f"KVStore.pull: key {k!r} holds a 'default' (dense) "
                        "value but the out array is 'row_sparse'; use "
                        "row_sparse_pull(key, row_ids=...) for row subsets")
        if (self._fused is not None and not single
                and self._fused.handle_pull(keys, outs)):
            return
        for k, o in zip(keys, outs):
            stored = self._store[k]
            for oo in (o if isinstance(o, (list, tuple)) else [o]):
                if getattr(stored, "stype", "default") == "row_sparse":
                    stored.copyto(oo)  # aggregation-mode gradients
                else:
                    _tensor(oo).copy_(stored.tensor)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Copy only the rows ``row_ids`` (duplicates allowed, order
        kept) of a row-sparse key out, as a ``RowSparseNDArray`` (into
        ``out`` when given, a new one otherwise).  The rows are a copy:
        a later push does not change them."""
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        keys, single = _key_list(key)
        outs = [out] if out is None or isinstance(out, NDArray) \
            else list(out)
        ids_list = [row_ids] if not isinstance(row_ids, (list, tuple)) \
            else list(row_ids)
        if len(ids_list) != len(keys):
            raise MXNetError(f"row_sparse_pull: got {len(keys)} keys but "
                             f"{len(ids_list)} row_ids")
        results = []
        for k, o, ids in zip(keys, outs, ids_list):
            if self._stypes.get(k) != "row_sparse":
                raise MXNetError(
                    f"row_sparse_pull: key {k!r} was initialized "
                    f"{self._stypes.get(k, 'default')!r}, not 'row_sparse'")
            stored = self._store[k]
            if getattr(stored, "stype", "default") == "row_sparse":
                stored = stored.todense()  # aggregation-mode gradients
            raw = stored.tensor
            if isinstance(ids, NDArray):
                ids = ids.tensor
            idx = (ids.to(device=raw.device, dtype=torch.int32)
                   if isinstance(ids, torch.Tensor)
                   else torch.from_numpy(np.asarray(ids, dtype=np.int32)
                                         .copy()).to(raw.device)).reshape(-1)
            rows = raw.index_select(0, idx.long())
            if o is None:
                o = _sparse.RowSparseNDArray(idx, rows, tuple(raw.shape))
            else:
                if getattr(o, "stype", "default") != "row_sparse":
                    raise MXNetError("row_sparse_pull: out must be a "
                                     "RowSparseNDArray")
                o._set_rows(idx, rows)
            results.append(o)
        return results[0] if single else results

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
