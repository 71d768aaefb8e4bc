"""Bucketed KVStore update engine of the port (mirrors
``mxnet_tpu/kvstore_fused.py``: ``FusedUpdateEngine``, dense and not
sharded).

The eager path pays one updater call, and about seven kernel launches,
per parameter per step.  This engine groups the registered keys into
size-capped buckets (``MXTPU_KV_BUCKET_MB``, default 4 MB; stable key
order; one gradient dtype per bucket; a parameter larger than the cap
gets its own bucket) and steps each bucket as one torch function, the
JAX package's jitted bucket program:

- the bucket's gradients are concatenated once into a flat buffer (the
  per-device copies of a key are summed there), which is the step's
  scratch, so the caller's gradients are never written;
- the optimizer rule runs over every key of the bucket through
  ``torch._foreach_*`` (``optim_rules.multi_rule``), so the launches per
  bucket do not grow with its key count;
- pulls copy the stored values out through ``torch._foreach_copy_``
  (one call per device and dtype pair).

The optimizer state lives in the ``Updater``'s store (``ensure_state``),
so eager and bucketed steps interleave on one state.  Per-key lr
(Adam's bias correction included) and wd are host floats read each
step, as in the eager update.  An fp32 master weight (the last state
slot) takes the update, and the weight is its cast.

Under AMP loss scaling (``MXTPU_LOSS_SCALE`` with ``MXTPU_AMP``) each
bucket takes the scale as a device scalar: ``fin = isfinite(merged).all()``
on the merged gradient, then ``merged *= (1 / scale)`` in the gradient's
dtype, then the rule.  The rule updates in place, so the bucket's
weights, states and masters are first copied into one flat snapshot per
slot (``torch.cat``), and after the rule each slot is put back as
``torch.where(fin, new, old)`` (a select: NaN times 0 would be NaN) —
the skip-step.  The step's flags go to one
``amp.global_scaler().end_step``.  Nothing on this path reads a device
value on the host.

Row-sparse keys (a key initialised row-sparse, pushed
``RowSparseNDArray`` gradients) get a sparse bucket each: one
touched-rows-only update (:func:`mxnet_tpu_torch.sparse.make_row_program`,
the function the eager path runs, so the two are bit-identical) over the
concatenated device copies, its cost set by the rows a batch touched,
not by the table.  Dense and sparse keys ride one push; under loss
scaling the sparse buckets' finite flags join the dense buckets' in the
step's one ``end_step``, and a bf16 table whose state holds an fp32
master table updates the master rows and re-casts the table's.

The numerics sentinel (``MXTPU_SENTINEL``): each bucket also computes a
per-key ``isfinite(g).all()`` flag and the bucket's gradient norm on the
device, packed into one tensor that ``telemetry.health.sentinel_record``
parks unread (site ``kv_bucket<i>``, or ``kv_sparse<i>`` for a sparse
bucket, step = this store's push count); the sync happens at the next
reporting boundary.  Each plan records a memory row per bucket
(``telemetry.health.record_program``), the perf plane counts each
bucket's FLOPs at its first step after a plan (``MXTPU_PERF_ATTR``), and
an allocator failure in a push re-raises as ``DeviceOOMError`` with the
ranked memory report.

The sharded bucket program (ROADMAP Queue 1 item 10b; it needs several
cards, which the Module refuses) is not ported.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import amp as _amp
from . import sparse as _sparse
from . import telemetry as _tm
from .base import MXNetError, parse_bool
from .ndarray import NDArray
from .optim_rules import multi_rule

__all__ = ["fused_update_enabled", "bucket_cap_bytes", "FusedUpdateEngine"]

_DEFAULT_BUCKET_MB = 4.0


def fused_update_enabled() -> bool:
    """``MXTPU_FUSED_UPDATE`` (default on)."""
    return parse_bool(os.environ.get("MXTPU_FUSED_UPDATE", "1"))


def bucket_cap_bytes() -> int:
    """``MXTPU_KV_BUCKET_MB`` in bytes (fractions allowed)."""
    raw = os.environ.get("MXTPU_KV_BUCKET_MB", "").strip()
    try:
        mb = float(raw) if raw else _DEFAULT_BUCKET_MB
    except ValueError:
        mb = _DEFAULT_BUCKET_MB
    return max(int(mb * (1 << 20)), 1)


def _state_slots(state) -> Tuple:
    """An Updater state as the rule's slot tuple."""
    if state is None:
        return ()
    if isinstance(state, (tuple, list)):
        return tuple(state)
    return (state,)


def _t(x) -> torch.Tensor:
    return x.tensor if isinstance(x, NDArray) else x


def _dense(t: torch.Tensor) -> bool:
    return t.is_contiguous() or (
        t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements in memory order, as a 1-D view when ``t`` is
    dense (contiguous or channels-last), else as a contiguous copy."""
    if not _dense(t):
        t = t.contiguous()
    return t.as_strided((t.numel(),), (1,))


def _views(flat: torch.Tensor, like) -> List[torch.Tensor]:
    """``flat`` cut into one view per tensor of ``like``, in order, each
    in that tensor's layout (the inverse of concatenating their
    ``_flat`` forms)."""
    out, off = [], 0
    for t in like:
        seg = flat[off:off + t.numel()]
        off += t.numel()
        out.append(seg.as_strided(t.shape, t.stride()) if _dense(t)
                   else seg.view(t.shape))
    return out


class _Bucket:
    __slots__ = ("dtype", "keys", "shapes", "sizes", "nbytes")

    def __init__(self, dtype):
        self.dtype = dtype
        self.keys: List = []
        self.shapes: List[tuple] = []
        self.sizes: List[int] = []
        self.nbytes = 0


class _SparseBucket:
    """One row-sparse key's touched-rows-only update unit."""

    __slots__ = ("key", "shape")

    def __init__(self, key, shape):
        self.key = key
        self.shape = tuple(shape)


class FusedUpdateEngine:
    """The bucketed update of one KVStore.  ``handle_push`` and
    ``handle_pull`` return False for a call they cannot bucket, and the
    store then runs its eager loops."""

    def __init__(self, kvstore, optimizer, updater):
        self._kv = kvstore
        self._opt = optimizer
        self._updater = updater
        self._buckets: Optional[List[_Bucket]] = None
        self._sparse_buckets: List[_SparseBucket] = []
        self._plan_keys: Optional[tuple] = None
        self._plan_stypes: Optional[tuple] = None
        self._key_index: Dict = {}
        self._ndev = 0
        self._rule = None
        self._push_count = 0       # the sentinel's step id for this store
        self._cost_done = set()    # buckets whose FLOPs were counted

    def _key_name(self, k):
        """Kvstore key -> the name the sentinel reports (the optimizer's
        ``param_idx2name`` when keys are indices)."""
        if isinstance(k, str):
            return k
        name = getattr(self._opt, "idx2name", {}).get(k)
        return name if name else str(k)

    @staticmethod
    def _label(i, b):
        """A bucket's program label (the JAX package's format, less its
        ``/mp`` suffix: the port finds fp32 masters at each step)."""
        return f"kv_bucket{i}[{str(b.dtype).replace('torch.', '')}" \
            f"x{len(b.keys)}]"

    @property
    def num_buckets(self) -> int:
        return len(self._buckets or ())

    # ------------------------------------------------------------- plan
    def _build_plan(self, keys, vlists, ndev):
        cap = bucket_cap_bytes()
        buckets: List[_Bucket] = []
        sparse_buckets: List[_SparseBucket] = []
        cur = None
        for k, vl in zip(keys, vlists):
            if getattr(vl[0], "stype", "default") == "row_sparse":
                sparse_buckets.append(_SparseBucket(k,
                                                    self._kv._store[k].shape))
                continue
            g0 = _t(vl[0])
            nbytes = g0.numel() * g0.element_size()
            if (cur is None or cur.dtype != g0.dtype
                    or (cur.nbytes and cur.nbytes + nbytes > cap)):
                cur = _Bucket(g0.dtype)
                buckets.append(cur)
            cur.keys.append(k)
            cur.shapes.append(tuple(g0.shape))
            cur.sizes.append(g0.numel())
            cur.nbytes += nbytes
        self._buckets = buckets
        self._sparse_buckets = sparse_buckets
        self._plan_keys = tuple(keys)
        self._key_index = {k: i for i, k in enumerate(keys)}
        self._ndev = ndev
        self._cost_done = set()
        nslots = self._rule[1][0]
        for i, b in enumerate(buckets):
            # memory row per bucket: ndev gradient copies + weights in,
            # weights (+ state, weight-sized per slot) out — shape math,
            # enough to RANK programs in the OOM report
            state_b = b.nbytes * max(nslots, 1)
            _tm.health.record_program(
                self._label(i, b), argument=b.nbytes * (ndev + 1) + state_b,
                output=b.nbytes + state_b, temp=b.nbytes,
                source="shape_math")
        for si, sb in enumerate(sparse_buckets):
            w = self._kv._store[sb.key]
            state_b = _t(w).numel() * _t(w).element_size() * max(nslots, 1)
            _tm.health.record_program(
                f"kv_sparse[{sb.key}:{'x'.join(map(str, sb.shape))}]",
                argument=state_b, output=state_b, source="shape_math")

    # ------------------------------------------------------------- push
    def handle_push(self, keys, values) -> bool:
        """The bucketed update for one batched push; False when the call
        cannot be bucketed (an unregistered key, copy lists of unequal
        length).  The store has checked the storage types already."""
        kv = self._kv
        vlists = [list(v) if isinstance(v, (list, tuple)) else [v]
                  for v in values]
        if not vlists or not vlists[0]:
            return False
        ndev = len(vlists[0])
        for k, vl in zip(keys, vlists):
            if k not in kv._store or len(vl) != ndev:
                return False
        stypes = tuple(getattr(vl[0], "stype", "default") for vl in vlists)
        opt = self._opt
        rule_name, opt_params = opt.fused_rule()
        if self._rule is None or self._rule[0] != (rule_name, opt_params):
            self._rule = ((rule_name, opt_params),
                          multi_rule(rule_name, opt_params))
        nslots, update = self._rule[1]
        if (self._plan_keys != tuple(keys) or self._ndev != ndev
                or self._plan_stypes != stypes):
            self._build_plan(keys, vlists, ndev)
            self._plan_stypes = stypes
        # host bookkeeping first, as the eager order gives every key of
        # the step the same num_update
        for k in keys:
            opt._update_count(k)
        lrs = {k: float(opt.fused_lr(k)) for k in keys}
        wds = {k: float(opt._get_wd(k)) for k in keys}
        # AMP loss scaling: one fp32 1/scale for the step, a finite flag
        # per bucket, one lattice step for all of them
        inv = None
        if _amp.scaling_active():
            scaler = _amp.global_scaler()
            # the scale lives where the weights do (a no-op after a bind)
            scaler.place(kv._store[keys[0]].tensor.device)
            inv = scaler.inv_scale_raw()
        self._push_count += 1
        sentinel = _tm.health.sentinel_mode() is not None
        perf_on = _tm.perf.enabled()
        try:
            flags = []
            for bi, b in enumerate(self._buckets):
                args = (b, bi, vlists, nslots, update, lrs, wds, inv,
                        sentinel)
                if perf_on and bi not in self._cost_done:
                    # the bucket's FLOPs, once per plan (its first step)
                    self._cost_done.add(bi)
                    with _tm.perf.counting() as c:
                        flags.append(self._step_bucket(*args))
                    _tm.perf.record_cost(self._label(bi, b), flops=c.flops,
                                         source="flop_counter")
                else:
                    flags.append(self._step_bucket(*args))
            if self._sparse_buckets:
                t0 = time.perf_counter() if _sparse._tm.enabled() else None
                for si, sb in enumerate(self._sparse_buckets):
                    flags.append(self._step_sparse_bucket(
                        sb, si, vlists, nslots, rule_name, opt_params, lrs,
                        wds, None if inv is None else scaler.scale_raw(),
                        sentinel))
                if t0 is not None:
                    _sparse._TM_SPARSE_SEC.observe(time.perf_counter() - t0,
                                                   store=kv.type)
            if inv is not None:
                scaler.end_step(flags)
        except Exception as e:  # noqa: BLE001 — an OOM gets the report
            _tm.health.reraise_if_oom(e, site="kvstore_fused.push")
            raise
        return True

    def _step_sparse_bucket(self, sb, si, vlists, nslots, rule_name,
                            opt_params, lrs, wds, scale=None,
                            sentinel=False):
        """One row-sparse key's update: the device copies' ``(idx,
        vals)`` parts go through its row function, which updates the
        table and its state rows in place; returns the finite flag under
        loss scaling.  With the sentinel, the gradient rows' finite flag
        and norm are parked (site ``kv_sparse<si>``)."""
        kv, upd = self._kv, self._updater
        w = kv._store[sb.key]
        slots = _state_slots(upd.ensure_state(sb.key, w))
        mp = len(slots) == nslots + 1
        dev = w.tensor.device
        parts = vlists[self._key_index[sb.key]]
        idx_parts = tuple(v._indices.to(dev) for v in parts)
        val_parts = tuple(v._values.to(dev) for v in parts)
        if sentinel:
            # the key's one flag covers every device copy's rows
            vec = _tm.health.sentinel_vector(val_parts)
            _tm.health.sentinel_record(
                site=f"kv_sparse{si}", step=self._push_count,
                names=[self._key_name(sb.key)],
                finite=torch.stack([vec[:-1].min(), vec[-1]]),
                packed_norm=True)
        fn = _sparse.row_program(rule_name, tuple(sorted(opt_params.items())),
                                 wds[sb.key], mp, scale is not None)
        flag = fn(idx_parts, val_parts, w.tensor,
                  tuple(_t(x) for x in slots),
                  float(np.float32(lrs[sb.key])), scale)
        if _sparse._tm.enabled():
            rows = sum(int(i.shape[0]) for i in idx_parts)
            _sparse._TM_SPARSE_ROWS.inc(rows, store=kv.type)
            _sparse._TM_SPARSE_DENSITY.observe(rows / max(sb.shape[0], 1),
                                               store=kv.type)
        return flag

    def _merged(self, b, vlists, device) -> torch.Tensor:
        """The bucket's gradients, concatenated once per device copy and
        summed: a new flat buffer on ``device``."""
        idx = self._key_index
        flat = None
        for d in range(self._ndev):
            segs = [_flat(_t(vlists[idx[k]][d])) for k in b.keys]
            part = torch.cat(segs) if len(segs) > 1 else segs[0].clone()
            part = part.to(device)
            flat = part if flat is None else flat.add_(part)
        return flat

    def _step_bucket(self, b, bi, vlists, nslots, update, lrs, wds,
                     inv=None, sentinel=False):
        """One bucket's update; with ``inv`` (the fp32 ``1 / scale``),
        the skip-step, returning the bucket's finite flag.  With the
        sentinel, the per-key finite flags and the bucket's gradient norm
        (of the unscaled gradient, before the rule uses it as scratch)
        are parked as one tensor."""
        kv, upd = self._kv, self._updater
        weights = [kv._store[k] for k in b.keys]
        slots = [_state_slots(upd.ensure_state(k, w))
                 for k, w in zip(b.keys, weights)]
        for k, s in zip(b.keys, slots):
            if len(s) not in (nslots, nslots + 1):
                raise MXNetError(f"kvstore_fused: key {k!r} holds "
                                 f"{len(s)} state slots, the rule "
                                 f"{nslots}")
        # an fp32 master as the last slot takes the update
        masters = [len(s) == nslots + 1 for s in slots]
        if any(masters) and not all(masters):
            raise MXNetError("kvstore_fused: a bucket mixes keys with and "
                             "without fp32 master weights")
        mp = all(masters)
        ws = [_t(s[-1]) if mp else _t(w) for s, w in zip(slots, weights)]
        states = [tuple(_t(x) for x in s[:nslots]) for s in slots]
        flat = self._merged(b, vlists, ws[0].device)
        fin = None
        if inv is not None:
            fin = torch.isfinite(flat).all()
            flat.mul_(inv.to(flat.dtype))
            # the slots the rule overwrites, and the weights a master
            # writes, as one flat snapshot each
            held = [ws] + [[st[j] for st in states] for j in range(nslots)]
            if mp:
                held.append([_t(w) for w in weights])
            old = [torch.cat([_flat(t) for t in ts]) for ts in held]
        if mp:
            flat = flat.float()
        # each key's slice, in its gradient's layout
        idx = self._key_index
        gs = _views(flat, [_t(vlists[idx[k]][0]) for k in b.keys])
        if sentinel:
            _tm.health.sentinel_record(
                site=f"kv_bucket{bi}", step=self._push_count,
                names=[self._key_name(k) for k in b.keys],
                finite=_tm.health.sentinel_vector(gs), packed_norm=True)
        update(flat, ws, gs, states, [lrs[k] for k in b.keys],
               [wds[k] for k in b.keys])
        if mp:
            torch._foreach_copy_([_t(w) for w in weights], ws)
        if fin is not None:
            for ts, o in zip(held, old):
                new = torch.cat([_flat(t) for t in ts])
                torch.where(fin, new, o, out=new)
                torch._foreach_copy_(ts, _views(new, ts))
        return fin

    # ------------------------------------------------------------- pull
    def handle_pull(self, keys, outs) -> bool:
        """Copy the stored values out, one ``_foreach_copy_`` per device
        and dtype pair; False for keys the store does not hold."""
        kv = self._kv
        if any(k not in kv._store for k in keys):
            return False
        dst, src = [], []
        for k, o in zip(keys, outs):
            for oo in (o if isinstance(o, (list, tuple)) else [o]):
                dst.append(_t(oo))
                src.append(kv._store[k].tensor)
        groups: Dict = {}
        for d, s in zip(dst, src):
            pair = groups.setdefault((d.device, d.dtype, s.device, s.dtype),
                                     ([], []))
            pair[0].append(d)
            pair[1].append(s)
        for d, s in groups.values():
            torch._foreach_copy_(d, s)
        return True
