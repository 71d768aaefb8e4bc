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

Telemetry (``MXTPU_TELEMETRY``): each bucketed push is a
``kvstore_fused_update_seconds`` observation of its dispatch; a plan
sets ``kvstore_bucket_count`` and observes each dense bucket's bytes in
``kvstore_bucket_bytes``; a bucket program's first step in the process
(keyed through the executor's program cache, as the JAX package keys
its jitted programs) counts in ``executor_compile_total{kind=kv_update}``
(``kv_sparse`` for a row-sparse key).

**Across processes** (the collective ``dist_sync`` store,
:class:`~mxnet_tpu_torch.kvstore.KVStoreDist` without servers, over a
launched world of N > 1 ranks): each rank pushes its own gradients and
the bucket's flat gradient is summed over the world.  By default
(``MXTPU_SHARD_UPDATE=1``, read at each plan) a bucket whose weights
share one dtype and whose gradients and weights share one layout runs
the **sharded update** (Xu et al., arXiv:2004.13336; the reference's
``_make_sharded_bucket_program``): the flat gradient padded to a
multiple of N is reduce-scattered, each rank runs the bucket's
multi-tensor rule on its 1/N slice as one flat tensor, with per-element
lr and wd where the slice's keys differ (:func:`_slice_update`), against
flat optimizer state it alone holds (the fp32 masters as the last slot under AMP; the
skip-step's select under loss scaling, with the finite flag agreed over
the world), and the fresh parameters are all-gathered back into every
rank's weights.  The per-key states leave the ``Updater`` while their
shards hold the truth (1/N of the state bytes a rank);
:meth:`FusedUpdateEngine.ensure_host_state` gathers them back before any
reader of the per-key states (an eager update, ``get_states`` and
``save_optimizer_states``, a checkpoint, a new plan), and counts its
host time in ``kvstore_shard_gather_seconds``.  ``MXTPU_SHARD_UPDATE=0``,
or a bucket that cannot shard, keeps the replicated step after one
all-reduce of the flat gradient; at a world of two the two are equal to
the bit (a two-term sum is exact in either order, and both run the same
multi-tensor rule on the same elements).  These collectives are a step's
only communication; ``executor_collective_bytes_total`` counts their
payload (``op`` ``grad_allreduce``, ``kv_grad_shard``,
``kv_param_allgather``).

A row-sparse key whose stored table is a DTensor sharded by rows over a
mesh (one ``Shard(0)`` placement) keeps that layout through its update:
each rank updates the pushed rows that fall in its block (the pushes are
the same on every rank), and a pull gathers the table.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import amp as _amp
from . import executor as _executor
from . import sparse as _sparse
from . import telemetry as _tm
from .base import MXNetError, parse_bool
from .ndarray import NDArray
from .optim_rules import multi_rule
from .parallel import dist as _dist
from .parallel import mesh as _mesh

__all__ = ["fused_update_enabled", "shard_update_enabled",
           "bucket_cap_bytes", "FusedUpdateEngine"]

# --- telemetry families (the JAX package's names) ---------------------------
_TM_FUSED_SEC = _tm.histogram(
    "kvstore_fused_update_seconds",
    "wall time of one batched fused push (bucket reductions + jitted "
    "multi-tensor optimizer updates; dispatch, not device completion)",
    labels=("store",))
_TM_BUCKET_COUNT = _tm.gauge(
    "kvstore_bucket_count",
    "flat buckets in the current fused-update plan", labels=("store",))
_TM_BUCKET_BYTES = _tm.histogram(
    "kvstore_bucket_bytes",
    "bytes per flat bucket at plan build (dtype-segregated, capped by "
    "MXTPU_KV_BUCKET_MB)", labels=("store",),
    buckets=(1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20,
             1 << 22, 1 << 23, 1 << 24, 1 << 26))

_TM_SHARD_GATHER = _tm.histogram(
    "kvstore_shard_gather_seconds",
    "host time materializing sharded optimizer-state vectors back into "
    "per-key NDArrays (sync_shard_state: save/load, eager interleave, "
    "plan rebuild — never the per-step hot path)", labels=("store",))

_DEFAULT_BUCKET_MB = 4.0


def fused_update_enabled() -> bool:
    """``MXTPU_FUSED_UPDATE`` (default on)."""
    return parse_bool(os.environ.get("MXTPU_FUSED_UPDATE", "1"))


def shard_update_enabled() -> bool:
    """``MXTPU_SHARD_UPDATE`` (default on): a bucket of a store that
    spans several processes updates each rank's 1/N slice against state
    sharded over the ranks (reduce-scatter, the bucket's rule on the
    slice, all-gather);
    ``0`` keeps the replicated update after one all-reduce.  Read at
    each plan build."""
    return parse_bool(os.environ.get("MXTPU_SHARD_UPDATE", "1"))


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


def _local_block(t):
    return t.to_local() if _mesh.is_dtensor(t) else t


def _row_block(t) -> int:
    """The first row of this rank's block of a table split by rows (one
    ``Shard(0)`` placement, the rest replicated, an even split)."""
    from torch.distributed.tensor import Replicate, Shard

    dm, lo = t.device_mesh, None
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == 0 and lo is None:
            n = dm.size(i)
            if t.shape[0] % n:
                break
            lo = dm.get_coordinate()[i] * (t.shape[0] // n)
        elif not isinstance(p, Replicate):
            lo = None
            break
    if lo is None:
        raise MXNetError(f"kvstore_fused: a row-sparse table placed as "
                         f"{tuple(t.placements)} (one even Shard(0) "
                         "over the mesh is supported)")
    return lo


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


def _slice_update(b, update, g, w, state, lrs, wds):
    """A multi-tensor rule's ``update`` (:func:`~.optim_rules.multi_rule`)
    on a rank's slice of a sharded bucket as one flat tensor: the
    gradient ``g``, the weights ``w`` and the state slices ``state``,
    with the lr and wd of the keys in the slice (``lrs``, ``wds`` by
    key) as floats where they agree and as fp32 vectors of one value an
    element where they differ (0 in the padding; kept on the bucket for
    the last values seen).  The rule is elementwise, so every element
    takes the replicated step's arithmetic, and a slice of padding only
    takes none."""
    size = g.numel()
    parts = b.overlaps(b.lo, b.lo + size)
    if not parts:
        return
    key = (tuple(lrs[k] for k in b.keys), tuple(wds[k] for k in b.keys))
    factors = b.factors.get(key)
    if factors is None:
        factors = []
        for vals in key:
            mine = {vals[i] for i, _, _ in parts}
            if len(mine) == 1:
                factors.append(mine.pop())
                continue
            host = np.zeros(size, np.float32)
            pos = 0
            for i, a, e in parts:
                host[pos:pos + e - a] = vals[i]
                pos += e - a
            vec = torch.from_numpy(host)
            if g.device.type == "cuda":
                vec = vec.pin_memory().to(g.device, non_blocking=True)
            factors.append(vec)
        b.factors = {key: factors}
    lr, wd = factors
    update(g, [w], [g], [tuple(state)], [lr], [wd])


class _Bucket:
    __slots__ = ("dtype", "keys", "shapes", "sizes", "nbytes",
                 # the sharded update (arXiv:2004.13336)
                 "shard_n", "padded", "offsets", "wdtype", "mp",
                 "shard_state", "lo", "factors", "key_of_el")

    def __init__(self, dtype):
        self.dtype = dtype
        self.keys: List = []
        self.shapes: List[tuple] = []
        self.sizes: List[int] = []
        self.nbytes = 0
        self.shard_n = 1        # > 1: this bucket runs the sharded update
        self.padded = 0         # flat length padded to a multiple of it
        self.offsets: List[int] = []
        self.wdtype = None      # the bucket's one weight dtype
        self.mp = False         # the last state slot is an fp32 master
        self.shard_state = None  # this rank's flat state slices
        self.lo = 0             # this rank's slice starts here
        self.factors = {}       # (lrs, wds) -> this slice's lr and wd
        self.key_of_el = None   # the sentinel's key index per element

    @property
    def total(self) -> int:
        return int(sum(self.sizes))

    def overlaps(self, lo, hi):
        """``[(key index, start, stop)]``: the parts of the keys that lie
        in ``[lo, hi)`` of the flat vector, as offsets into each key."""
        out = []
        for i, (off, n) in enumerate(zip(self.offsets, self.sizes)):
            a, b = max(lo, off), min(hi, off + n)
            if a < b:
                out.append((i, a - off, b - off))
        return out


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
        self._ran = set()          # buckets stepped since the plan
        self._programs = set()     # program keys run by this engine

    def _world(self) -> int:
        """The ranks a push sums over: the world of a collective store
        that spans several processes, else 1."""
        kv = self._kv
        if getattr(kv, "collective", False) and kv.num_workers > 1:
            return kv.num_workers
        return 1

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
        # the old plan's shards go back to the per-key states first
        self.ensure_host_state()
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
        for b in buckets:
            self._maybe_shard(b, vlists)
        self._cost_done = set()
        self._ran = set()
        if _tm.enabled():
            _TM_BUCKET_COUNT.set(len(buckets), store=self._kv.type)
            for b in buckets:
                _TM_BUCKET_BYTES.observe(b.nbytes, store=self._kv.type)
        nslots = self._rule[1][0]
        for i, b in enumerate(buckets):
            # memory row per bucket: ndev gradient copies + weights in,
            # weights (+ state, weight-sized per slot, 1/N of it for a
            # sharded bucket) out — shape math, enough to RANK programs
            # in the OOM report
            state_b = b.nbytes * max(nslots, 1) // b.shard_n
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

    def _maybe_shard(self, b, vlists):
        """Mark ``b`` for the sharded update when the store spans several
        processes, ``MXTPU_SHARD_UPDATE`` is on, the bucket's weights
        share one dtype and every key's gradient and weight share one
        memory layout."""
        b.offsets = [int(o) for o in np.cumsum([0] + b.sizes)[:-1]]
        n = self._world()
        if n <= 1 or not shard_update_enabled():
            return
        ws = [_t(self._kv._store[k]) for k in b.keys]
        gs = [_t(vlists[self._key_index[k]][0]) for k in b.keys]
        if len({w.dtype for w in ws}) != 1 or any(
                _mesh.is_dtensor(w) or not _dense(w)
                or w.stride() != g.stride() for w, g in zip(ws, gs)):
            return
        b.wdtype = ws[0].dtype
        b.shard_n = n
        b.padded = -(-b.total // n) * n
        b.lo = _dist.rank() * (b.padded // n)
        b.factors = {}

    # ---------------------------------------------------- sharded state
    def _ingest(self, b, weights):
        """Make the bucket's flat state slices from the per-key states
        (created where absent, as the eager update would), then drop the
        per-key states: the slices hold the truth until
        :meth:`ensure_host_state`.  A per-key state present again (an
        eager update, a load) is taken in again."""
        upd = self._updater
        if b.shard_state is not None and not any(k in upd.states
                                                 for k in b.keys):
            return
        nslots = self._rule[1][0]
        slots = [_state_slots(upd.ensure_state(k, w))
                 for k, w in zip(b.keys, weights)]
        mp = {len(s) == nslots + 1 for s in slots}
        if len(mp) != 1 or any(len(s) not in (nslots, nslots + 1)
                               for s in slots):
            raise MXNetError("kvstore_fused: a sharded bucket's keys hold "
                             f"{sorted({len(s) for s in slots})} state "
                             f"slots, the rule {nslots}")
        b.mp = mp.pop()
        size = b.padded // b.shard_n
        parts = b.overlaps(b.lo, b.lo + size)
        state = []
        for j in range(len(slots[0])):
            segs = [_flat(_t(slots[i][j]))[a:e] for i, a, e in parts]
            flat = torch.cat(segs) if segs else \
                _t(slots[0][j]).new_empty(0)
            pad = size - flat.numel()
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            state.append(flat)
        b.shard_state = tuple(state)
        for k in b.keys:
            del upd.states[k]
        upd._shard_owner = self

    def holds_state_of(self, key) -> bool:
        """Whether ``key``'s optimizer state lives in a bucket's shards."""
        return any(b.shard_state is not None and key in b.keys
                   for b in self._buckets or ())

    def ensure_host_state(self):
        """Gather every sharded bucket's state back into per-key states
        of the ``Updater`` (one all-gather a slot; every rank of the
        store calls it at the same point).  A no-op when nothing is
        sharded; the next sharded step takes the states in again."""
        buckets = [b for b in self._buckets or ()
                   if b.shard_state is not None]
        if not buckets:
            return
        t0 = time.perf_counter() if _tm.enabled() else None
        kv, upd = self._kv, self._updater
        for b in buckets:
            fulls = [_dist.all_gather(s)[:b.total] for s in b.shard_state]
            b.shard_state = None
            for i, k in enumerate(b.keys):
                if k in upd.states:
                    continue  # loaded since: the per-key state is newer
                st = upd.optimizer.create_state(k, kv._store[k])
                for j, s in enumerate(_state_slots(st)):
                    seg = fulls[j][b.offsets[i]:b.offsets[i] + b.sizes[i]]
                    _t(s).copy_(_views(seg, [_t(s)])[0])
                upd.states[k] = st
        if t0 is not None:
            _TM_SHARD_GATHER.observe(time.perf_counter() - t0,
                                     store=kv.type)

    def drop_shards(self):
        """Forget the shards (the per-key states were replaced)."""
        for b in self._buckets or ():
            b.shard_state = None

    def optimizer_state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds for the store's
        dense keys: the shards, and the per-key states."""
        n = sum(t.nbytes for b in self._buckets or ()
                for t in (b.shard_state or ()))
        keys = {k for b in self._buckets or () for k in b.keys}
        for k, st in self._updater.states.items():
            if k in keys:
                # (a loaded state is numpy until the key's next update)
                n += sum(int(_t(s).nbytes) for s in _state_slots(st)
                         if s is not None)
        return n

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
        t0 = time.perf_counter() if _tm.enabled() else None
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
        world = self._world()
        try:
            flags = []
            for bi, b in enumerate(self._buckets):
                args = (b, bi, vlists, nslots, update, lrs, wds, inv,
                        sentinel, world)
                tc = None
                if bi not in self._ran:
                    self._ran.add(bi)
                    tc = self._program_start(
                        ("kvfused", str(b.dtype), tuple(b.shapes),
                         tuple(wds[k] for k in b.keys), b.shard_n),
                        rule_name, opt_params, sentinel, inv is not None)
                if perf_on and bi not in self._cost_done:
                    # the bucket's FLOPs, once per plan (its first step)
                    self._cost_done.add(bi)
                    with _tm.perf.counting() as c:
                        flags.append(self._step_bucket(*args))
                    _tm.perf.record_cost(self._label(bi, b), flops=c.flops,
                                         source="flop_counter")
                else:
                    flags.append(self._step_bucket(*args))
                _executor._compile_done(tc, "kv_update")
            if self._sparse_buckets:
                ts = time.perf_counter() if _sparse._tm.enabled() else None
                for si, sb in enumerate(self._sparse_buckets):
                    tc = None
                    if ("sparse", si) not in self._ran:
                        self._ran.add(("sparse", si))
                        tc = self._program_start(
                            ("kvsparse", sb.shape, wds[sb.key]), rule_name,
                            opt_params, sentinel, inv is not None)
                    flags.append(self._step_sparse_bucket(
                        sb, si, vlists, nslots, rule_name, opt_params, lrs,
                        wds, None if inv is None else scaler.scale_raw(),
                        sentinel))
                    _executor._compile_done(tc, "kv_sparse")
                if ts is not None:
                    _sparse._TM_SPARSE_SEC.observe(time.perf_counter() - ts,
                                                   store=kv.type)
            if inv is not None:
                scaler.end_step(flags)
        except Exception as e:  # noqa: BLE001 — an OOM gets the report
            _tm.health.reraise_if_oom(e, site="kvstore_fused.push")
            raise
        if t0 is not None:
            _TM_FUSED_SEC.observe(time.perf_counter() - t0, store=kv.type)
        return True

    def _program_start(self, key, rule_name, opt_params, sentinel, scaling):
        """The first step of a bucket program not run in this process
        (the JAX package's program-cache miss, a trace there): its start
        time under telemetry, for ``executor_compile_total``; else None.
        The keys go through the executor's program cache as the JAX
        package's jitted bucket programs do."""
        key = key + (rule_name, tuple(sorted(opt_params.items())),
                     sentinel, scaling)
        if key in self._programs:
            return None
        self._programs.add(key)
        if _executor.program_cache_get(key) is not None:
            return None
        _executor.program_cache_put(key, key)
        return time.perf_counter() if _tm.enabled() else None

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
        table, rows = w.tensor, None
        if _mesh.is_dtensor(table):
            # a table split by rows over a mesh: this rank's block
            rows = (_row_block(table), table.to_local().shape[0])
            table = table.to_local()
        dev = table.device
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
        flag = fn(idx_parts, val_parts, table,
                  tuple(_local_block(_t(x)) for x in slots),
                  float(np.float32(lrs[sb.key])), scale, rows)
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
                     inv=None, sentinel=False, world=1):
        """One bucket's update; with ``inv`` (the fp32 ``1 / scale``),
        the skip-step, returning the bucket's finite flag.  With the
        sentinel, the per-key finite flags and the bucket's gradient norm
        (of the unscaled gradient, before the rule uses it as scratch)
        are parked as one tensor.  Over a ``world`` of several processes
        the flat gradient is first summed over it (one all-reduce), or
        the sharded bucket takes the step."""
        if b.shard_n > 1:
            return self._step_sharded(b, bi, vlists, lrs, wds, inv,
                                      sentinel)
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
        if world > 1:
            _dist.all_reduce(flat)
            if _tm.enabled():
                _executor._TM_COLLECTIVE.inc(
                    flat.numel() * flat.element_size(), op="grad_allreduce")
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

    def _sentinel_shard(self, b, bi, g):
        """The sentinel's record of a sharded bucket: each key's sum of
        squares over this rank's slice of the summed gradient, added
        over the world (one small all-reduce), gives its finite flag and
        the bucket's norm."""
        nk = len(b.keys)
        if b.key_of_el is None or b.key_of_el.device != g.device:
            size = g.numel()
            ids = np.full(size, nk, np.int64)
            pos = 0
            for i, a, e in b.overlaps(b.lo, b.lo + size):
                ids[pos:pos + e - a] = i
                pos += e - a
            ids = torch.from_numpy(ids)
            if g.device.type == "cuda":
                ids = ids.pin_memory().to(g.device, non_blocking=True)
            b.key_of_el = ids
        sq = torch.zeros(nk + 1, dtype=torch.float64, device=g.device)
        sq.index_add_(0, b.key_of_el, g.double().square())
        _dist.all_reduce_stats(sq)
        norms = sq[:nk].sqrt()
        _tm.health.sentinel_record(
            site=f"kv_bucket{bi}", step=self._push_count,
            names=[self._key_name(k) for k in b.keys],
            finite=torch.cat([torch.isfinite(norms).float(),
                              sq[:nk].sum().sqrt().float().reshape(1)]),
            packed_norm=True)

    def _step_sharded(self, b, bi, vlists, lrs, wds, inv, sentinel):
        """One sharded bucket's update (arXiv:2004.13336): the padded
        flat gradient reduce-scattered over the world, the bucket's
        multi-tensor rule on this rank's slice against its state slices
        (:func:`_slice_update`), the fresh slice all-gathered into every
        rank's weights.  Under loss scaling the ranks agree on one finite
        flag (one small all-reduce) and a skipped step keeps the slices
        as they were."""
        kv = self._kv
        weights = [kv._store[k] for k in b.keys]
        self._ingest(b, weights)
        update = self._rule[1][1]
        wts = [_t(w) for w in weights]
        dev = wts[0].device
        flat = self._merged(b, vlists, dev)
        if b.padded > flat.numel():
            flat = torch.cat([flat, flat.new_zeros(b.padded - flat.numel())])
        g = _dist.reduce_scatter(flat)
        size = g.numel()
        fin = None
        if inv is not None:
            bad = (~torch.isfinite(g)).any().float().reshape(1)
            _dist.all_reduce_stats(bad)
            fin = (bad == 0).reshape(())
            g.mul_(inv.to(g.dtype))
        if sentinel:
            self._sentinel_shard(b, bi, g)
        state = list(b.shard_state)
        if b.mp:
            g = g.float()
            w, rule_state = state[-1], state[:-1]
            held = state
        else:
            segs = [_flat(wts[i])[a:e]
                    for i, a, e in b.overlaps(b.lo, b.lo + size)]
            w = torch.cat(segs) if segs else g.new_empty(0)
            if w.numel() < size:
                w = torch.cat([w, w.new_zeros(size - w.numel())])
            rule_state = state
            held = state + [w]
        old = [t.clone() for t in held] if fin is not None else ()
        _slice_update(b, update, g, w, rule_state, lrs, wds)
        for t, o in zip(held, old):
            torch.where(fin, t, o, out=t)
        out = w.to(b.wdtype) if b.mp else w
        full = _dist.all_gather(out)
        torch._foreach_copy_(wts, _views(full[:b.total], wts))
        if _tm.enabled():
            _executor._TM_COLLECTIVE.inc(
                b.padded * flat.element_size() // b.shard_n,
                op="kv_grad_shard")
            _executor._TM_COLLECTIVE.inc(b.padded * out.element_size(),
                                         op="kv_param_allgather")
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
            # a table sharded over a mesh is gathered (a collective)
            value = _mesh.full_value(kv._store[k].tensor)
            for oo in (o if isinstance(o, (list, tuple)) else [o]):
                dst.append(_t(oo))
                src.append(value)
        groups: Dict = {}
        for d, s in zip(dst, src):
            pair = groups.setdefault((d.device, d.dtype, s.device, s.dtype),
                                     ([], []))
            pair[0].append(d)
            pair[1].append(s)
        for d, s in groups.values():
            torch._foreach_copy_(d, s)
        return True
