"""Row-sparse gradients of the port (mirrors ``mxnet_tpu/sparse.py``;
parity: python/mxnet/ndarray/sparse.py ``RowSparseNDArray`` and the
row_sparse storage type).

An embedding table's gradient touches only the rows a batch looked up.
As in the JAX package everything is **shape-stable**: a row-sparse
gradient carries exactly one slot per looked-up id (``K`` slots, the
lookup count), coalesced by sort and segment sum — the first occurrence
of an id holds the sum, later duplicates keep their id with a zero row.
Dense conversion is therefore a scatter-add.  Nothing here reads a
device value on the host (no ``unique``, no boolean mask), so the row
math queues without a sync.

Three consumers share one row-update factory, :func:`make_row_program`,
so their arithmetic is the same operation for operation:

- the executor's Embedding backward (``__grad_stype__="row_sparse"``
  variables) emits the coalesced ``(indices, values)`` pair,
- ``kvstore_fused``'s sparse buckets run it once a key and step,
- the eager per-key path (:func:`eager_update`, the ``Updater``) runs
  the same function.

The update gathers the touched rows of the weight and of every state
slot, runs the optimizer's per-tensor rule on them
(``optim_rules.sparse_rule``) and adds the masked delta back with
``index_add_`` (the reference's ``w.at[sid].add(new - old)``): rows no
id touched, and duplicate slots, are left byte-identical — the lazy
update.  The JAX package donates the table; the port updates it in
place, so pulls copy (``kvstore.row_sparse_pull``, ``pull``) and no
array a caller holds aliases a table.

The segment sum is ``torch.segment_reduce`` over the sorted ids, which
adds each segment's rows in order on the CPU and the card alike.  The
write-backs are ``index_add_``: duplicate slots add exact zeros, so
their order cannot change a bit.

``MXTPU_SPARSE_UPDATE=0`` makes ``simple_bind`` allocate dense
gradients for ``grad_stype="row_sparse"`` variables, which restores the
dense path exactly.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import telemetry as _tm
from .base import MXNetError, parse_bool
from .ndarray import NDArray, _device, _from_numpy
from .ndarray import zeros as _dense_zeros

__all__ = ["RowSparseNDArray", "row_sparse_array", "zeros",
           "full_row_sparse", "annotated_rs_names", "rs_plan",
           "coalesce_rows", "make_row_program", "row_program",
           "concat_rows", "eager_update", "sparse_update_enabled"]

# --- telemetry families (the JAX package's) --------------------------------
_TM_SPARSE_ROWS = _tm.counter(
    "kvstore_sparse_rows_total",
    "gradient row slots pushed through the sparse update path (one per "
    "looked-up id, duplicates included — host-known, never a device "
    "sync)", labels=("store",))
_TM_SPARSE_DENSITY = _tm.histogram(
    "kvstore_sparse_density",
    "pushed row slots / table rows per sparse push (the touched "
    "fraction upper bound)", labels=("store",),
    buckets=(1e-5, 1e-4, 1e-3, 1e-2, 0.05, 0.1, 0.25, 0.5, 1.0))
_TM_SPARSE_SEC = _tm.histogram(
    "kvstore_sparse_update_seconds",
    "wall time of one batched sparse-bucket update (launches, not "
    "device completion)", labels=("store",))


def sparse_update_enabled() -> bool:
    """``MXTPU_SPARSE_UPDATE`` (default on), read at bind."""
    return parse_bool(os.environ.get("MXTPU_SPARSE_UPDATE", "1"))


def _index_tensor(indices, device) -> torch.Tensor:
    if isinstance(indices, NDArray):
        indices = indices.tensor
    if isinstance(indices, torch.Tensor):
        return indices.to(device=device, dtype=torch.int32)
    return torch.from_numpy(
        np.asarray(indices, dtype=np.int32).reshape(-1).copy()).to(device)


class RowSparseNDArray(NDArray):
    """An ``(indices, values)`` pair standing for a tensor whose rows
    outside ``indices`` are zero.

    ``indices`` is int32 ``(K,)``; ``values`` is ``(K,) + shape[1:]``.
    Duplicate indices are allowed and sum on dense conversion.  A dense
    read (``.tensor``, a dense write) raises: a table-sized silent
    densification is what this type prevents; use :meth:`todense`,
    :attr:`data` and :attr:`indices`."""

    __slots__ = ("_indices", "_values", "_full_shape")

    stype = "row_sparse"

    def __init__(self, indices, values, shape):
        val = values.tensor if isinstance(values, NDArray) else values
        if not isinstance(val, torch.Tensor):
            val = torch.from_numpy(np.ascontiguousarray(values))
        ind = _index_tensor(indices, val.device)
        shape = tuple(int(s) for s in shape)
        if ind.dim() != 1:
            raise MXNetError(
                f"row_sparse indices must be 1-D, got {tuple(ind.shape)}")
        if tuple(val.shape) != (ind.shape[0],) + shape[1:]:
            raise MXNetError(
                f"row_sparse values shape {tuple(val.shape)} does not "
                f"match {(ind.shape[0],) + shape[1:]} (indices "
                f"{tuple(ind.shape)}, shape {shape})")
        self._indices = ind
        self._values = val
        self._full_shape = shape
        # the NDArray plumbing (dtype, context) reads the values
        self._t = val

    # ------------------------------------------------------------ parts
    @property
    def indices(self) -> NDArray:
        return NDArray(self._indices)

    @property
    def data(self) -> NDArray:
        """The value rows."""
        return NDArray(self._values)

    values = data

    @property
    def shape(self):
        return self._full_shape

    @property
    def size(self):
        return int(np.prod(self._full_shape)) if self._full_shape else 1

    @property
    def ndim(self):
        return len(self._full_shape)

    def __len__(self):
        return self._full_shape[0]

    def __repr__(self):
        return (f"<RowSparseNDArray {'x'.join(map(str, self.shape))} "
                f"rows={self._indices.shape[0]} @{self.context}>")

    # ------------------------------------------------------------ reads
    @property
    def tensor(self):
        raise MXNetError(
            "row_sparse NDArray cannot be read as a dense array; use "
            ".todense() / .tostype('default') (explicit) or .indices/"
            ".data for the sparse parts")

    def asnumpy(self):
        return self.todense().asnumpy()

    def wait_to_read(self):
        if self._values.is_cuda:
            torch.cuda.current_stream(self._values.device).synchronize()

    def todense(self) -> NDArray:
        """The dense tensor: a scatter-add of the value rows."""
        dense = torch.zeros(self._full_shape, dtype=self._values.dtype,
                            device=self._values.device)
        return NDArray(dense.index_add_(0, self._indices.long(),
                                        self._values))

    def tostype(self, stype: str):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return self.todense()
        raise MXNetError(f"unknown storage type {stype!r}")

    def copy(self) -> "RowSparseNDArray":
        return RowSparseNDArray(self._indices.clone(), self._values.clone(),
                                self._full_shape)

    def copyto(self, other):
        if isinstance(other, RowSparseNDArray):
            if other._full_shape != self._full_shape:
                raise MXNetError(
                    f"copyto: shape mismatch {self._full_shape} vs "
                    f"{other._full_shape}")
            return other._set_rows(self._indices.clone(),
                                   self._values.clone())
        if isinstance(other, NDArray):
            return other._set(self.todense().tensor)
        return NDArray(self.todense().tensor.to(_device(other), copy=True))

    # ----------------------------------------------------------- writes
    def _set_rows(self, indices, values):
        """Rebind the ``(indices, values)`` pair (the executor's backward
        and the row pulls land here).  The slot count may change between
        binds; the row width and the full shape are fixed."""
        ind = _index_tensor(indices, values.device)
        if (tuple(values.shape[1:]) != self._full_shape[1:]
                or values.shape[0] != ind.shape[0]):
            raise MXNetError(
                f"row_sparse write: values {tuple(values.shape)} does not "
                f"match indices {tuple(ind.shape)} + row shape "
                f"{self._full_shape[1:]}")
        self._indices = ind
        self._values = values
        self._t = values
        return self

    def _set(self, new):
        raise MXNetError("row_sparse NDArray does not support dense writes; "
                         "use _set_rows(indices, values)")

    def __setitem__(self, key, value):
        self._set(value)

    def __getitem__(self, key):
        raise MXNetError("row_sparse NDArray cannot be indexed densely; use "
                         ".todense()")


def _as_stype(arr) -> str:
    return getattr(arr, "stype", "default")


# ------------------------------------------------------- constructors
def row_sparse_array(arg, shape=None, ctx=None, dtype=None):
    """``mx.nd.sparse.row_sparse_array``: ``arg`` is ``(data, indices)``
    (rows and their row ids, sorted here) or a dense array-like, whose
    non-zero rows are kept."""
    dev = _device(ctx)

    def host(x, dt=None):
        a = x.asnumpy() if isinstance(x, NDArray) else x
        return np.asarray(a, dtype=dt)

    if isinstance(arg, tuple) and len(arg) == 2:
        data, indices = host(arg[0], dtype), host(arg[1], np.int32)
        order = np.argsort(indices, kind="stable")
        indices, data = indices[order], data[order]
        if shape is None:
            top = int(indices[-1]) + 1 if indices.size else 0
            shape = (top,) + data.shape[1:]
        if indices.size and (int(indices[0]) < 0
                             or int(indices[-1]) >= shape[0]):
            raise MXNetError(f"row_sparse_array: row id out of bounds for "
                             f"shape {tuple(shape)}")
        return RowSparseNDArray(_from_numpy(indices, dev),
                                _from_numpy(data, dev), tuple(shape))
    if isinstance(arg, RowSparseNDArray):
        return arg.copy()
    dense = host(arg, dtype)
    if shape is None:
        shape = dense.shape
    nz = np.flatnonzero(dense.reshape(dense.shape[0], -1).any(axis=1))
    return RowSparseNDArray(_from_numpy(nz.astype(np.int32), dev),
                            _from_numpy(dense[nz], dev), tuple(shape))


def zeros(stype, shape, ctx=None, dtype=np.float32):
    """``mx.nd.sparse.zeros``: an all-zero array of the storage type (a
    row_sparse zero holds no rows)."""
    if stype == "default":
        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    if stype != "row_sparse":
        raise MXNetError(f"unknown storage type {stype!r}")
    from .base import numeric_dtype

    dev = _device(ctx)
    shape = tuple(shape)
    return RowSparseNDArray(
        torch.zeros((0,), dtype=torch.int32, device=dev),
        torch.zeros((0,) + shape[1:], dtype=numeric_dtype(dtype),
                    device=dev), shape)


def full_row_sparse(arr) -> RowSparseNDArray:
    """Every row of a dense table as a row_sparse array (indices
    ``arange``) — how a table enters ``KVStore.init`` for a key that
    will receive row-sparse pushes."""
    t = arr.tensor if isinstance(arr, NDArray) else arr
    return RowSparseNDArray(
        torch.arange(t.shape[0], dtype=torch.int32, device=t.device),
        t, tuple(t.shape))


# ------------------------------------------------------ graph analysis
def annotated_rs_names(symbol) -> List[str]:
    """Variable names carrying ``__grad_stype__="row_sparse"``."""
    return [n.name for n in symbol.nodes
            if n.is_variable
            and n.extra_attrs.get("__grad_stype__") == "row_sparse"]


def rs_plan(symbol) -> Dict[str, object]:
    """``{weight name: its Embedding node}`` for every annotated
    variable whose only consumer is one Embedding op reading it as the
    weight.  A weight with any other consumer (a tied decoder, a
    regularizer) keeps its dense gradient, silently: the dense gradient
    is always right."""
    rs_names = set(annotated_rs_names(symbol))
    if not rs_names:
        return {}
    consumers: Dict[str, list] = {w: [] for w in rs_names}
    for node in symbol.nodes:
        if node.is_variable:
            continue
        for pos, (src, _oidx) in enumerate(node.inputs):
            if src.is_variable and src.name in rs_names:
                consumers[src.name].append((node, pos))
    return {w: cons[0][0] for w, cons in consumers.items()
            if len(cons) == 1 and cons[0][0].op == "Embedding"
            and cons[0][1] == 1}


# ------------------------------------------------------------ row math
def coalesce_rows(idx: torch.Tensor, vals: torch.Tensor):
    """Sort the ids (stably) and sum duplicate rows into the first
    occurrence — K slots in, K slots out; later duplicates keep their id
    with a zero row.  Returns ``(sorted_ids, summed_vals, first_mask)``,
    computed on the device without a host read."""
    k = idx.shape[0]
    if k == 0:
        return idx, vals, torch.zeros((0,), dtype=torch.bool,
                                      device=idx.device)
    order = torch.argsort(idx, stable=True)
    sid = idx.index_select(0, order)
    sval = vals.index_select(0, order)
    first = torch.ones((k,), dtype=torch.bool, device=idx.device)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1
    lengths = torch.zeros((k,), dtype=torch.int64,
                          device=idx.device).index_add_(
        0, seg, torch.ones_like(seg))
    summed = torch.segment_reduce(sval, "sum", lengths=lengths, axis=0,
                                  unsafe=True)
    mask = first.reshape((-1,) + (1,) * (vals.dim() - 1))
    return sid, torch.where(mask, summed.index_select(0, seg), 0), first


def make_row_program(rule_name: str, opt_params: tuple, wd_mult: float,
                     mp: bool = False, scaling: bool = False):
    """The touched-rows-only update of one row-sparse key:
    ``step(idx_parts, val_parts, w, slots, lr, scale=None)``
    concatenates the per-device ``(idx, vals)`` parts, coalesces them,
    gathers the touched rows of ``w`` and of each state slot, runs the
    optimizer's rule on the gathered rows and adds the masked delta back
    into ``w`` and the slots in place.

    ``mp`` (AMP fp32 master rows): the last slot is the fp32 master
    table of a low-precision ``w``; the rule runs in fp32 on the master
    rows, and the touched rows of ``w`` become the cast of their new
    master rows.  ``scaling`` (AMP loss scaling): ``scale`` (a device
    scalar) unscales the rows first, and a step whose rows are not all
    finite leaves every row as it was (the skip-step); ``step`` then
    returns the finite flag, else None.

    ``rows=(lo, n)``: ``w`` and the slots are one rank's block of a
    table split by rows (rows ``lo`` to ``lo + n``); the pushed rows
    outside it are left to the ranks that hold them."""
    from .optim_rules import sparse_rule

    rule = sparse_rule(rule_name, dict(opt_params))
    if rule is None:
        raise MXNetError(f"no row-sparse form of the {rule_name!r} rule")
    _nslots, update = rule

    def step(idx_parts, val_parts, w, slots, lr, scale=None, rows=None):
        if _tm.enabled():
            # the table and its slots are updated in place (the JAX
            # program donates them)
            _tm.health.donation_saved(
                sum(t.numel() * t.element_size() for t in (w,) + slots),
                site="kv_sparse")
        idx = idx_parts[0] if len(idx_parts) == 1 else torch.cat(idx_parts)
        vals = val_parts[0] if len(val_parts) == 1 \
            else torch.cat(val_parts)
        fin = None
        if scaling:
            fin = torch.isfinite(vals).all()
            vals = vals * (1.0 / scale).to(vals.dtype)
        sid, gvals, first = coalesce_rows(idx, vals)
        sidl = sid.long()
        if rows is not None:
            lo, n = rows
            first = first & (sidl >= lo) & (sidl < lo + n)
            sidl = (sidl - lo).clamp(0, n - 1)
        if mp:
            master, rslots = slots[-1], slots[:-1]
            w_rows = master.index_select(0, sidl)
            gvals = gvals.float()
        else:
            master, rslots = None, slots
            w_rows = w.index_select(0, sidl)
        s_rows = tuple(s.index_select(0, sidl) for s in rslots)
        # the rule updates in place: it gets copies of the old rows
        new_rows, new_s_rows = update(
            w_rows.clone(), gvals, tuple(r.clone() for r in s_rows), lr,
            wd_mult)
        if scaling:
            new_rows = torch.where(fin, new_rows, w_rows)
            new_s_rows = tuple(torch.where(fin, ns, sr)
                               for ns, sr in zip(new_s_rows, s_rows))
        mask = first.reshape((-1,) + (1,) * (vals.dim() - 1))
        for s, ns, sr in zip(rslots, new_s_rows, s_rows):
            s.index_add_(0, sidl, torch.where(mask, (ns - sr).to(s.dtype),
                                              0))
        delta = torch.where(mask, new_rows - w_rows, 0)
        if mp:
            master.index_add_(0, sidl, delta)
            # the table's rows become the cast of their master rows: an
            # add of (cast(new) - current) on first occurrences
            cur = w.index_select(0, sidl)
            w.index_add_(0, sidl, torch.where(mask,
                                              new_rows.to(w.dtype) - cur, 0))
        else:
            w.index_add_(0, sidl, delta.to(w.dtype))
        return fin

    return step


def _state_slots(state) -> Tuple:
    if state is None:
        return ()
    if isinstance(state, (tuple, list)):
        return tuple(state)
    return (state,)


def concat_rows(values) -> RowSparseNDArray:
    """A per-device list of row-sparse gradients as one uncoalesced pair
    (the row update's segment sum does the cross-device sum)."""
    values = list(values)
    if len(values) == 1:
        return values[0]
    shape = values[0].shape
    for v in values[1:]:
        if v.shape != shape:
            raise MXNetError(f"row_sparse reduce: mismatched shapes {shape} "
                             f"vs {v.shape}")
    dev = values[0]._values.device
    return RowSparseNDArray(
        torch.cat([v._indices.to(dev) for v in values]),
        torch.cat([v._values.to(dev) for v in values]), shape)


_PROGRAMS: Dict[tuple, object] = {}


def row_program(rule_name, opt_params: tuple, wd_mult: float, mp=False,
                scaling=False):
    """:func:`make_row_program` built once for its arguments and kept
    (the eager path and the fused sparse buckets share the entries)."""
    key = (rule_name, opt_params, float(wd_mult), mp, scaling)
    fn = _PROGRAMS.get(key)
    if fn is None:
        fn = _PROGRAMS[key] = make_row_program(*key)
    return fn


def eager_update(optimizer, updater, index, weight,
                 rs_grad: RowSparseNDArray):
    """The per-key row-sparse update of the eager paths (the kvstore's
    per-key loop, the Module's own ``Updater``): the host bookkeeping of
    the dense eager update (update count, lr with Adam's bias
    correction, per-key wd), then the row update the fused sparse bucket
    runs."""
    rule = optimizer.fused_rule() if optimizer is not None else None
    if rule is None:
        name = type(optimizer).__name__ if optimizer is not None \
            else "a custom updater"
        raise MXNetError(
            f"row_sparse gradients need an optimizer with a fused rule "
            f"(SGD/ccSGD/Adam/RMSProp); {name} must densify explicitly "
            f"via .todense()")
    rule_name, opt_params = rule
    optimizer._update_count(index)
    lr = float(np.float32(optimizer.fused_lr(index)))
    wd_mult = float(optimizer._get_wd(index))
    slots = _state_slots(updater.ensure_state(index, weight))
    fn = row_program(rule_name, tuple(sorted(opt_params.items())), wd_mult,
                     mp=optimizer._use_master(weight))
    w = weight.tensor if isinstance(weight, NDArray) else weight
    fn((rs_grad._indices,), (rs_grad._values.to(w.device),), w,
       tuple(s.tensor if isinstance(s, NDArray) else s for s in slots), lr)
