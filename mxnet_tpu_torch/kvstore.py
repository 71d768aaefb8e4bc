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
no array a caller holds aliases it.

``dist_sync``, ``dist_device_sync`` and ``dist_async``
(:class:`KVStoreDist`, mirrors ``mxnet_tpu/kvstore.py:506-1149``) are
MXNet's parameter-server stores: under ``python -m
mxnet_tpu_torch.launch -n W -s S`` every worker talks to the CPU-only
servers of :mod:`~mxnet_tpu_torch.kvstore_server` over host TCP
(:class:`_PSClient`).  A key at or above ``MXNET_KVSTORE_BIGARRAY_BOUND``
elements (default 10**6) is split evenly over every server as
``key#p<i>``; a smaller one lives on one server chosen by a stable hash.
Each RPC retries a broken connection with backoff
(``MXTPU_DIST_RETRIES``, ``MXTPU_DIST_BACKOFF_MS``; fault sites
``dist_send``/``dist_recv``) and the server applies it once.  Pushes and
pulls run as per-key tasks on the native host engine
(``_native.NativeEngine``, one var per key): a push snapshots the
gradient into a pinned host buffer on a side stream behind the producing
kernels (the caller's later kernels wait for that copy on the card) and
its task waits for the copy, so the loop never waits for the card; a
pull's task waits for the key's push, fetches the value and
leaves it for the out array, which is written when the pull is resolved
(:meth:`KVStoreDist.wait_pulls`: ``Module.forward`` and the module's
parameter reads do it, and so do ``asnumpy``/``wait_to_read`` of the out
array).  Resolving is the PS path's host sync: one wait per key a step,
counted in :meth:`KVStoreDist.comm_stats`.  ``MXTPU_PS_ASYNC=0`` (or
``MXNET_ENGINE_TYPE=NaiveEngine``) runs every RPC on the calling thread.
Without ``MXTPU_PS_SERVERS``, ``dist_sync`` and ``dist_device_sync`` are
the **collective** store (mirrors ``mxnet_tpu/kvstore.py:828-846,
920-930``): ``collective`` is true, the workers of ``python -m
mxnet_tpu_torch.launch -n W -s 0`` form one process group
(``parallel.dist.init_from_env``; NCCL when each rank has a card, gloo
on the CPU and when ranks share a card) and take rank and size from it.
``init`` gives every rank worker 0's value (a broadcast); each worker
pushes its own gradients and a push sums them over the world, batched
through the bucketed engine (one all-reduce a bucket, or the sharded
update: reduce-scatter, the rule on 1/N of the state, all-gather; see
:mod:`~mxnet_tpu_torch.kvstore_fused`), per key on the eager path (one
all-reduce a key); a pull reads the local copy, the same on every rank.
The Module then batches its push and pull as for a local store, and its
effective batch is its batch times the workers (``rescale_grad``), as on
the parameter-server ``dist_sync``.  A single process is the collective
store at world 1, whose steps are the local store's.  ``dist_async``
without servers keeps the local semantics, as the reference does.
Row-sparse pushes over several workers are not ported (ROADMAP Queue 1
item 10b, slice 5).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import faults as _faults
from . import sparse as _sparse
from . import ndarray as _nd_mod
from . import telemetry as _tm
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "KVStoreDist", "create"]

# --- telemetry families of the dist stores (the JAX package's names) --------
_TM_PUSH = _tm.counter(
    "kvstore_push_total", "per-key push operations", labels=("store",))
_TM_PUSH_BYTES = _tm.counter(
    "kvstore_push_bytes_total",
    "logical payload bytes pushed (per key, post-merge)", labels=("store",))
_TM_PUSH_SEC = _tm.histogram(
    "kvstore_push_seconds",
    "per-key push latency (local: reduce+update dispatch; dist: the RPC)",
    labels=("store",))
_TM_PULL = _tm.counter(
    "kvstore_pull_total", "per-key pull operations", labels=("store",))
_TM_PULL_BYTES = _tm.counter(
    "kvstore_pull_bytes_total",
    "logical payload bytes pulled (per key, one copy per out array)",
    labels=("store",))
_TM_PULL_SEC = _tm.histogram(
    "kvstore_pull_seconds",
    "per-key pull latency (local: broadcast dispatch; dist: the RPC)",
    labels=("store",))
_TM_DIST_RETRY = _tm.counter(
    "kvstore_dist_retries_total",
    "KVStoreDist RPC attempts retried after a transport failure "
    "(broken pipe / reset / injected drop); each retry reconnects with "
    "exponential backoff + jitter and retransmits idempotently by "
    "request id", labels=("op",))
_TM_DEAD_WORKERS = _tm.gauge(
    "kvstore_dead_workers",
    "worker ranks whose heartbeats went stale (PS: the server-side "
    "staleness the client unions via get_num_dead_node; collective: "
    "hosts the coordinator declared dead); also surfaced in /healthz")

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

    @property
    def collective(self) -> bool:
        """Whether a dist store aggregates without parameter servers
        (then ``Module.update`` batches its push and pull as for a local
        store, instead of the per-key RPC loop); False here."""
        return False

    def barrier(self):
        pass

    def send_command_to_servers(self, head, body):
        pass

    def get_num_dead_node(self, node_id, timeout=60):
        """In-process stores have no remote nodes."""
        return 0

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


def dist_retries() -> int:
    """MXTPU_DIST_RETRIES: transport retries per RPC (default 5)."""
    try:
        return max(int(os.environ.get("MXTPU_DIST_RETRIES", "5")), 0)
    except ValueError:
        return 5


def dist_backoff_ms() -> float:
    """MXTPU_DIST_BACKOFF_MS: the first retry's backoff (default 50 ms,
    doubled each attempt with jitter, at most 5 s)."""
    try:
        return max(float(os.environ.get("MXTPU_DIST_BACKOFF_MS", "50")),
                   1.0)
    except ValueError:
        return 50.0


def bigarray_bound() -> int:
    """MXNET_KVSTORE_BIGARRAY_BOUND: the element count from which a key
    is split over every server (default 10**6)."""
    return int(os.environ.get("MXNET_KVSTORE_BIGARRAY_BOUND",
                              str(1000 * 1000)))


def key_assignment(key, size, num_servers, bound=None):
    """``[(server, part_key, flat_slice)]`` of one logical key (parity:
    EncodeKey, kvstore_dist.h:264-302): below the bound (or with one
    server) the whole key on the server of a stable hash, else an even
    split over every server as ``key#p<i>``."""
    import zlib

    bound = bigarray_bound() if bound is None else bound
    if size < bound or num_servers == 1:
        server = zlib.crc32(str(key).encode()) % num_servers
        return [(server, str(key), slice(0, size))]
    bounds = np.linspace(0, size, num_servers + 1).astype(np.int64)
    return [(i, f"{key}#p{i}", slice(int(bounds[i]), int(bounds[i + 1])))
            for i in range(num_servers)]


class _PSClient:
    """The worker's parameter-server client (parity: the ps::KVWorker
    role of src/kvstore/kvstore_dist.h; mirrors
    ``mxnet_tpu/kvstore.py:506-790``).  Two connections to each server,
    one for pulls and one for everything else, so a pull that the server
    parks until the other workers have pushed never holds up this
    worker's pushes; a third, opened by the heartbeat thread, keeps the
    worker's liveness visible while the others are parked."""

    _MUTATING_CMDS = ("init", "push", "barrier", "control")
    _CHANNELS = ("push", "pull")

    def __init__(self, servers, rank=0):
        import itertools
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from . import kvstore_server as ps

        self._ps = ps
        self.rank = rank
        self._servers = list(servers)
        self.num_servers = len(servers)
        self.bigarray_bound = bigarray_bound()
        # request ids for idempotent retransmit (the pid keeps a
        # restarted worker's ids apart from its previous life's)
        self._rids = itertools.count(1)
        self._pool = ThreadPoolExecutor(max_workers=max(len(servers), 1))
        self._socks = {c: [None] * self.num_servers for c in self._CHANNELS}
        self._locks = {c: [threading.Lock() for _ in servers]
                       for c in self._CHANNELS}
        # bytes sent on each connection, counted under its lock
        self._sent = {(c, i): 0 for c in self._CHANNELS
                      for i in range(self.num_servers)}
        for i in range(self.num_servers):
            # servers start beside the workers: wait until each listens
            deadline = time.monotonic() + 120
            while True:
                try:
                    self._socks["push"][i] = self._connect_server(i, 120)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="mxtpu-kvstore-heartbeat")
        self._hb_thread.start()

    def _heartbeat_loop(self):
        import socket

        interval = float(os.environ.get("MXTPU_PS_HEARTBEAT_S", "1.0"))
        socks = [None] * self.num_servers
        while not self._hb_stop.wait(interval):
            for i, addr in enumerate(self._servers):
                try:
                    if socks[i] is None:
                        host, port = addr.rsplit(":", 1)
                        socks[i] = socket.create_connection(
                            (host, int(port)), timeout=5)
                    self._ps.send_msg(socks[i], {"cmd": "heartbeat",
                                                 "rank": self.rank})
                    self._ps.recv_msg(socks[i])
                except OSError:
                    if socks[i] is not None:
                        socks[i].close()
                    socks[i] = None
        for s in socks:
            if s is not None:
                s.close()

    def dead_nodes(self, timeout):
        """The union of stale worker ranks over every server (on fresh
        connections: the request ones may be parked)."""
        import socket

        dead = set()
        for addr in self._servers:
            try:
                host, port = addr.rsplit(":", 1)
                with socket.create_connection((host, int(port)),
                                              timeout=10) as s:
                    self._ps.send_msg(s, {"cmd": "dead_nodes",
                                          "timeout": timeout})
                    reply = self._ps.recv_msg(s)
                    if reply is not None:  # None: EOF mid-shutdown
                        dead.update(reply.get("dead", []))
            except OSError:
                continue
        return sorted(dead)

    def _connect_server(self, server, timeout=5.0):
        import socket

        host, port = self._servers[server].rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(None)  # reads may legitimately park (sync mode)
        return s

    def _drop_sock(self, channel, server):
        s = self._socks[channel][server]
        if s is not None:
            try:
                s.close()
            except OSError:
                pass
        self._socks[channel][server] = None

    def rpc(self, server, msg, retries=None):
        """One RPC with bounded retry: a transport failure (broken pipe,
        reset, truncated reply, an injected ``dist_send``/``dist_recv``
        drop) closes the connection, backs off exponentially with jitter,
        reconnects and retransmits under the same request id, which the
        server applies once.  After ``MXTPU_DIST_RETRIES`` retries the
        failure is an :class:`MXNetError` naming the peer and the
        attempts."""
        import random as _random
        import socket

        if msg.get("cmd") in self._MUTATING_CMDS and "rid" not in msg:
            msg["rid"] = f"{self.rank}:{os.getpid()}:{next(self._rids)}"
        channel = "pull" if msg.get("cmd") == "pull" else "push"
        max_attempts = (dist_retries() if retries is None
                        else max(int(retries), 0)) + 1
        delay = dist_backoff_ms() / 1000.0
        last_exc = None
        for attempt in range(1, max_attempts + 1):
            try:
                with self._locks[channel][server]:
                    if self._socks[channel][server] is None:
                        self._socks[channel][server] = \
                            self._connect_server(server)
                    sock = self._socks[channel][server]
                    try:
                        if _faults.should_drop("dist_send"):
                            raise OSError("injected dist_send drop")
                        self._sent[channel, server] += self._ps.send_msg(
                            sock, msg)
                        if _faults.should_drop("dist_recv"):
                            raise OSError("injected dist_recv drop")
                        reply = self._ps.recv_msg(sock)
                        if reply is None:
                            raise OSError("connection closed by peer")
                    except (OSError, socket.timeout):
                        # the stream may hold a half-sent request or an
                        # unread reply: never reuse it
                        self._drop_sock(channel, server)
                        raise
                return reply
            except (OSError, socket.timeout) as exc:
                last_exc = exc
                if attempt >= max_attempts:
                    break
                if _tm.enabled():
                    _TM_DIST_RETRY.inc(op=str(msg.get("cmd", "?")))
                time.sleep(delay * (0.5 + _random.random()))
                delay = min(delay * 2.0, 5.0)
        dump = _tm.health.auto_dump("fault")
        raise MXNetError(
            f"KVStoreDist RPC {msg.get('cmd')!r} to server "
            f"{self._servers[server]} failed after {max_attempts} "
            f"attempt(s): {last_exc!r}"
            + (f" (flight record: {dump})" if dump else "")
        ) from last_exc

    @property
    def bytes_sent(self) -> int:
        return sum(self._sent.values())

    def rpc_all(self, msg):
        return list(self._pool.map(lambda i: self.rpc(i, dict(msg)),
                                   range(self.num_servers)))

    def _assignment(self, key, size):
        return key_assignment(key, size, self.num_servers,
                              self.bigarray_bound)

    def init(self, key, value: np.ndarray):
        flat = value.reshape(-1)
        for server, pkey, sl in self._assignment(key, flat.size):
            self.rpc(server, {"cmd": "init", "key": pkey, "value": flat[sl]})

    def push(self, key, value: np.ndarray):
        flat = np.ascontiguousarray(value).reshape(-1)
        parts = self._assignment(key, flat.size)
        if len(parts) == 1:
            server, pkey, sl = parts[0]
            self.rpc(server, {"cmd": "push", "key": pkey, "value": flat[sl],
                              "rank": self.rank})
            return
        list(self._pool.map(
            lambda p: self.rpc(p[0], {"cmd": "push", "key": p[1],
                                      "value": flat[p[2]],
                                      "rank": self.rank}), parts))

    def pull(self, key, shape, dtype):
        size = int(np.prod(shape))
        parts = self._assignment(key, size)
        if len(parts) == 1:
            server, pkey, _ = parts[0]
            # the reply's array is this call's own
            value = np.asarray(self.rpc(server, {
                "cmd": "pull", "key": pkey, "rank": self.rank})["value"],
                dtype=dtype)
            return value.reshape(shape)
        out = np.empty(size, dtype=dtype)

        def fetch(p):
            out[p[2]] = self.rpc(p[0], {"cmd": "pull", "key": p[1],
                                        "rank": self.rank})["value"]

        list(self._pool.map(fetch, parts))
        return out.reshape(shape)

    def barrier(self):
        self.rpc(0, {"cmd": "barrier"})

    def control(self, head, body=None):
        self.rpc_all({"cmd": "control", "head": head, "body": body})

    def control_sequential(self, head, body=None):
        """Deliver a control message to every server without the thread
        pool (at exit the interpreter refuses new pool futures); the
        connection gets a bounded timeout and no retries, so a hung
        server cannot hold the exit.  Returns ``[(server, exception)]``
        for the servers that could not be reached."""
        errors = []
        for i in range(self.num_servers):
            try:
                if self._socks["push"][i] is not None:
                    self._socks["push"][i].settimeout(5.0)
                self.rpc(i, {"cmd": "control", "head": head, "body": body},
                         retries=0)
            except Exception as exc:  # noqa: BLE001 — collected, not hidden
                errors.append((i, exc))
        return errors

    def close(self):
        self._hb_stop.set()
        self._pool.shutdown(wait=False)
        for channel in self._CHANNELS:
            for i in range(self.num_servers):
                self._drop_sock(channel, i)


def _host_dtype(t: torch.Tensor):
    """The numpy dtype a tensor travels as (bf16, which numpy lacks, as
    fp32)."""
    if t.dtype == torch.bfloat16:
        return np.float32
    # sync-ok: a 0-d tensor made on the host here, only for numpy's name
    # of the dtype
    return torch.empty((), dtype=t.dtype).numpy().dtype


class KVStoreDist(KVStore):
    """MXNet's parameter-server stores (parity: src/kvstore/kvstore_dist.h,
    the ps-lite worker; mirrors ``mxnet_tpu/kvstore.py:792-1137``).

    With ``MXTPU_PS_SERVERS`` set (by the launcher) every key lives on
    the servers: ``init`` by worker 0 then a barrier, ``push`` sums the
    workers' gradients there (sync) or applies each at once (async), and
    ``pull`` fetches the server's value.  ``set_optimizer`` ships the
    optimizer to the servers (worker 0), so its state lives there.  The
    recovery contract ``MXTPU_KV_RECOVERY=1`` (kvstore_dist.h:35-39): a
    restarted worker neither re-initialises keys nor re-ships the
    optimizer nor waits on the startup barriers; the servers still hold
    the model.  Without servers ``dist_sync``/``dist_device_sync`` are
    the collective store over the launched world (one process: world 1)
    and ``dist_async`` keeps the local semantics (the module docstring).
    """

    def __init__(self, kv_type):
        super().__init__(kv_type)
        self._rank = int(os.environ.get("MXTPU_RANK",
                                        os.environ.get("DMLC_RANK", "0")))
        self._size = int(os.environ.get("MXTPU_NUM_WORKERS",
                                        os.environ.get("DMLC_NUM_WORKER", "1")))
        self._recovery = os.environ.get(
            "MXTPU_KV_RECOVERY", os.environ.get("DMLC_RECOVERY", "")) == "1"
        self._shapes = {}
        self._client = None
        self._engine = None
        self._pull_engine = None
        self._key_vars = {}
        self._pull_vars = {}
        self._pending = {}          # key -> [(targets, holder)]
        self._host_bufs = {}        # key -> pinned host tensor (card grads)
        self._buf_busy = set()
        self._d2h_stream = None
        self._stats = {"pushes": 0, "pulls": 0, "push_bytes": 0,
                       "pull_bytes": 0, "push_enqueue_s": 0.0,
                       "pull_wait_s": 0.0, "loop_waits": 0}
        servers = os.environ.get("MXTPU_PS_SERVERS", "")
        # no servers: dist_sync is the collective store; dist_async keeps
        # the local semantics (its no-barrier updates need the servers)
        self._collective = not servers and "async" not in kv_type
        if not servers:
            if self._collective and self._size > 1:
                self._join_world(kv_type)
            else:
                # one process: the local semantics (rank 0 of 1), as the
                # reference launched without a tracker
                self._rank, self._size = 0, 1
            return
        self._client = _PSClient(servers.split(","), rank=self._rank)
        if (os.environ.get("MXTPU_PS_ASYNC", "1") == "1"
                and os.environ.get("MXNET_ENGINE_TYPE", "") != "NaiveEngine"):
            from . import _native

            if _native.available():
                # two engines: a pull the server parks until the other
                # workers pushed must never hold a thread a push needs
                self._engine = _native.NativeEngine()
                self._pull_engine = _native.NativeEngine()
        if "async" not in kv_type and not self._recovery:
            if self._rank == 0:
                from .kvstore_server import K_SYNC_MODE

                self._client.control(K_SYNC_MODE)
            self._client.barrier()
        import atexit

        atexit.register(self._send_stop)

    def _join_world(self, kv_type):
        """Join the launched world's process group; rank and size come
        from it."""
        from .parallel import dist as _dist

        if not _dist.is_multi_host():
            raise MXNetError(
                f"kvstore {kv_type!r}: {self._size} workers without "
                "parameter servers (MXTPU_PS_SERVERS) and without a "
                "rendezvous address (MXTPU_COORDINATOR): start them with "
                f"python -m mxnet_tpu_torch.launch -n {self._size} -s 0 "
                "(the collective dist_sync) or -s <servers> (the "
                "parameter servers)")
        _dist.init_from_env(device="cuda" if torch.cuda.is_available()
                            else "cpu")
        td = _dist._dist()
        self._rank, self._size = td.get_rank(), td.get_world_size()

    def _spans_world(self) -> bool:
        return self._client is None and self._collective and self._size > 1

    # ------------------------------------------------------------ state
    @property
    def rank(self) -> int:
        return self._rank

    @property
    def num_workers(self) -> int:
        return self._size

    @property
    def collective(self) -> bool:
        """True for ``dist_sync``/``dist_device_sync`` without servers:
        pushes are summed by collectives over the launched world (at
        world 1, locally)."""
        return self._client is None and self._collective

    def comm_stats(self) -> dict:
        """This worker's counts so far: pushes and pulls (per key), their
        payload bytes, the loop thread's seconds spent enqueueing pushes
        and waiting for pulls, and its waits (one per resolved key)."""
        out = dict(self._stats)
        if self._client is not None:
            out["wire_bytes_sent"] = self._client.bytes_sent
        return out

    def _var(self, key):
        v = self._key_vars.get(key)
        if v is None:
            v = self._key_vars[key] = self._engine.new_var()
        return v

    def _pvar(self, key):
        v = self._pull_vars.get(key)
        if v is None:
            # race-ok: made on the calling thread only; the other writer
            # the lint sees is _send_stop, an atexit handler, which runs
            # on the main thread after user code has ended
            v = self._pull_vars[key] = self._pull_engine.new_var()
        return v

    def _wait_outstanding(self):
        if self._engine is not None:
            self._engine.wait_all()
            self._pull_engine.wait_all()

    @staticmethod
    def _named_comm_error(op, k, exc):
        """A dead peer surfaces the key being moved, the peer and the
        attempts (in the transport error) and the flight record."""
        return MXNetError(f"KVStoreDist.{op}: key {k!r}: {exc}")

    # -------------------------------------------------------------- ops
    def init(self, key, value):
        if self._client is None:
            super().init(key, value)
            if self._spans_world():
                # every rank starts from worker 0's value
                from .kvstore_fused import _flat
                from .parallel import dist as _dist

                for k in _key_list(key)[0]:
                    _dist.broadcast(_flat(self._store[k].tensor), 0)
            return
        keys, _ = _key_list(key)
        values = value if isinstance(value, (list, tuple)) else [value]
        _check_pairs(keys, values, "init")
        for k, v in zip(keys, values):
            t = _tensor(v)
            self._shapes[k] = (tuple(t.shape), _host_dtype(t))
            if self._rank == 0 and not self._recovery:
                try:
                    self._client.init(k, self._host(t))
                except (MXNetError, OSError) as exc:
                    raise self._named_comm_error("init", k, exc) from exc
        if not self._recovery:
            # a recovered worker skips the init barrier: the others
            # passed it long ago and will not arrive again
            self._client.barrier()

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """A host copy of ``t`` in logical (contiguous) order."""
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        # sync-ok: init's one-off copy, and _snapshot's for a tensor already
        # on the host (a card tensor leaves through the pinned side-stream
        # copy, waited for on the engine's thread)
        return t.to("cpu", copy=True).contiguous().numpy()

    def _snapshot(self, k, merged: torch.Tensor):
        """Capture the value to push now (the caller may overwrite it
        once ``push`` returns) and return a function giving it as numpy.
        A card tensor is copied into the key's pinned buffer on a side
        stream behind the kernels that made it; the function, run on the
        engine, waits for that copy's event."""
        if merged.device.type != "cuda":
            arr = self._host(merged)
            return lambda: arr
        if k in self._buf_busy:
            # the previous push of this key still reads the buffer
            self._stats["loop_waits"] += 1
            self._engine.wait_for_var(self._var(k))
        buf = self._host_bufs.get(k)
        dtype = torch.float32 if merged.dtype == torch.bfloat16 \
            else merged.dtype
        if buf is None or buf.shape != merged.shape or buf.dtype != dtype:
            buf = self._host_bufs[k] = torch.empty(
                merged.shape, dtype=dtype, pin_memory=True)
        if self._d2h_stream is None:
            self._d2h_stream = torch.cuda.Stream(device=merged.device)
        side = self._d2h_stream
        cur = torch.cuda.current_stream(merged.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            buf.copy_(merged, non_blocking=True)
            merged.record_stream(side)
            done = torch.cuda.Event()
            done.record(side)
        # the caller may overwrite the value once push returns: its next
        # kernels wait for the copy on the card (no host wait)
        cur.wait_event(done)
        self._buf_busy.add(k)

        def read():
            done.synchronize()
            return buf.numpy()

        return read

    def _merge(self, k, v) -> torch.Tensor:
        """The local merge, then, over a collective world, the sum over
        it (the eager path's one all-reduce a key)."""
        merged = super()._merge(k, v)
        if self._spans_world():
            from .parallel import dist as _dist

            merged = _dist.all_reduce(merged.clone())
        return merged

    def _check_push_stypes(self, keys, values):
        super()._check_push_stypes(keys, values)
        if self._spans_world() and any(
                k in self._stypes and self._stypes[k] == "row_sparse"
                for k in keys):
            raise MXNetError(
                f"kvstore {self.type!r}: a row_sparse push over "
                f"{self._size} workers of the collective store is not "
                "ported yet (ROADMAP Queue 1 item 10b, slice 5); launch "
                "parameter servers (-s <servers>) or densify the "
                "gradient with .todense()")

    def push(self, key, value, priority=0):
        if self._client is None:
            return super().push(key, value, priority)
        _faults.maybe_fail("kv_push")
        keys, single = _key_list(key)
        values = [value] if single else value
        if not single:
            _check_pairs(keys, values, "push")
        for v in values:
            v0 = v[0] if isinstance(v, (list, tuple)) and v else v
            if getattr(v0, "stype", "default") == "row_sparse":
                # a dist push would densify and run the server's dense
                # update (momentum and wd on every row): other math than
                # the local lazy update
                raise MXNetError(
                    "row_sparse push is not supported on dist stores "
                    "yet; densify explicitly with .todense() to accept "
                    "dense (non-lazy) update semantics")
        for k, v in zip(keys, values):
            if k in self._pending:
                # a pull of this key made before this push reads the
                # value before it (the engine's order on the key's var)
                self.wait_pulls([k])
            t0 = time.perf_counter()
            vlist = v if isinstance(v, (list, tuple)) else [v]
            merged = _tensor(vlist[0])
            for other in vlist[1:]:
                merged = merged + _tensor(other).to(merged.device)
            if k not in self._shapes:
                self._shapes[k] = (tuple(merged.shape), _host_dtype(merged))
            read = self._snapshot(k, merged)
            nbytes = int(merged.numel()) * np.dtype(
                self._shapes[k][1]).itemsize
            self._stats["pushes"] += 1
            self._stats["push_bytes"] += nbytes
            if self._engine is None:
                self._do_push(k, read, nbytes)
            else:
                self._engine.push(
                    lambda k=k, read=read, nbytes=nbytes:
                        self._do_push(k, read, nbytes),
                    mutable_vars=[self._var(k)], priority=priority)
            self._stats["push_enqueue_s"] += time.perf_counter() - t0

    def _do_push(self, k, read, nbytes):
        from . import profiler as _prof

        t0 = time.perf_counter()
        with _prof.span(f"kvstore_push[{k}]", category="kvstore"):
            try:
                self._client.push(k, read())
            except (MXNetError, OSError) as exc:
                raise self._named_comm_error("push", k, exc) from exc
            finally:
                self._buf_busy.discard(k)
        if _tm.enabled():
            _TM_PUSH.inc(store=self.type)
            _TM_PUSH_BYTES.inc(nbytes, store=self.type)
            _TM_PUSH_SEC.observe(time.perf_counter() - t0, store=self.type)

    def pull(self, key, out=None, priority=0):
        if self._client is None:
            return super().pull(key, out, priority)
        _faults.maybe_fail("kv_pull")
        keys, single = _key_list(key)
        if single:
            outs = [out]
        else:
            outs = out
            _check_pairs(keys, outs, "pull", what="out arrays")
        for k, o in zip(keys, outs):
            shape, dtype = self._shapes[k]
            targets = list(o) if isinstance(o, (list, tuple)) else [o]
            self._stats["pulls"] += 1
            self._stats["pull_bytes"] += (int(np.prod(shape, dtype=np.int64))
                                          * np.dtype(dtype).itemsize
                                          * len(targets))
            if self._engine is None:
                holder = {}
                self._do_pull(k, shape, dtype, holder, len(targets))
                self._write(targets, holder["val"])
                continue
            holder = {}
            pvar = self._pvar(k)
            # the key's push var is looked up (or made) here, on the
            # calling thread: made on the pull engine's thread it could
            # race the loop's first push of the key into a second var,
            # and later pulls would no longer wait for that push
            push_var = self._var(k)
            self._pull_engine.push(
                lambda k=k, shape=shape, dtype=dtype, holder=holder,
                n=len(targets), push_var=push_var: self._do_pull(
                    k, shape, dtype, holder, n, push_var=push_var),
                mutable_vars=[pvar], priority=priority)
            self._pending.setdefault(k, []).append((targets, holder))
            for t in targets:
                _nd_mod.set_pending_write(_tensor(t), self.wait_pulls)

    def _do_pull(self, k, shape, dtype, holder, ntargets, push_var=None):
        from . import profiler as _prof

        if push_var is not None:
            # ordered after this key's pushes (they run on the other
            # engine, whose threads never park on a pull)
            self._engine.wait_for_var(push_var)
        t0 = time.perf_counter()
        with _prof.span(f"kvstore_pull[{k}]", category="kvstore"):
            try:
                holder["val"] = self._client.pull(k, shape, dtype)
            except (MXNetError, OSError) as exc:
                raise self._named_comm_error("pull", k, exc) from exc
        if _tm.enabled():
            _TM_PULL.inc(store=self.type)
            _TM_PULL_BYTES.inc(holder["val"].nbytes * ntargets,
                               store=self.type)
            _TM_PULL_SEC.observe(time.perf_counter() - t0, store=self.type)

    @staticmethod
    def _write(targets, val):
        src = torch.from_numpy(val)
        for t in targets:
            dst = _tensor(t)
            # a pageable source: the copy is staged before it returns,
            # and queued on this thread's stream ahead of the next reads
            dst.copy_(src.reshape(dst.shape), non_blocking=True)

    def wait_pulls(self, keys=None):
        """Resolve the pulls still pending (of ``keys``, default all):
        wait for each key's pull task (one wait on the calling thread per
        key) and write its value into the out arrays, in the order the
        pulls were made."""
        if not self._pending:
            return
        t0 = time.perf_counter()
        for k in list(self._pending if keys is None else keys):
            entries = self._pending.pop(k, None)
            if entries is None:
                continue
            # race-ok: the loop's thread (or a reader resolving a pending
            # write) counts here; the other writer the lint sees is
            # _send_stop, an atexit handler run on the main thread after
            # user code has ended
            self._stats["loop_waits"] += 1
            self._pull_engine.wait_for_var(self._pvar(k))
            for targets, holder in entries:
                self._write(targets, holder["val"])
                for t in targets:
                    _nd_mod.clear_pending_write(_tensor(t))
        self._stats["pull_wait_s"] += time.perf_counter() - t0

    def set_optimizer(self, optimizer):
        if self._client is None:
            return super().set_optimizer(optimizer)
        if self._recovery:
            return  # the servers hold the optimizer of the first life
        # parity: worker 0 ships the optimizer to the servers
        if self._rank == 0:
            from .kvstore_server import K_SET_OPTIMIZER, dumps_host

            self._client.control(K_SET_OPTIMIZER, dumps_host(optimizer))
        self._optimizer = optimizer
        self._client.barrier()

    def send_command_to_servers(self, head, body):
        if self._client is not None and self._rank == 0:
            self._client.control(head, body)

    def barrier(self):
        if self._client is not None:
            self.wait_pulls()
            self._wait_outstanding()  # in-flight pushes precede it
            self._client.barrier()
        elif self._spans_world():
            from .parallel import dist as _dist

            _dist.barrier("kvstore")

    def get_num_dead_node(self, node_id, timeout=60):
        """Parity: KVStore::get_num_dead_node (kvstore_dist.h:151-160):
        the worker ranks whose heartbeats went stale on any server.
        ``node_id`` is accepted for the signature; the servers track one
        worker group.  Without servers the coordinator's lease-expiry
        deaths count, when ``MXTPU_COORD_ADDR`` arms one.  The count
        lands on the ``kvstore_dead_workers`` gauge."""
        if self._client is None:
            from .parallel import coordinator as _coord

            n = 0
            client = _coord.client_from_env()
            if client is not None:
                n = len(client.cluster().get("dead", []))
        else:
            n = len(self._client.dead_nodes(timeout))
        if _tm.enabled():
            _TM_DEAD_WORKERS.set(n)
        return n

    def _send_stop(self):
        if self._client is None:
            return
        try:
            self.wait_pulls()
            self._wait_outstanding()
        except Exception as exc:  # noqa: BLE001 — still stop the servers
            logging.warning("kvstore: outstanding comm failed: %r", exc)
        client, self._client = self._client, None
        from .kvstore_server import K_STOP_SERVER

        # the body is the rank: a worker that stopped cleanly is not
        # counted dead by the server's stop accounting
        for server, exc in client.control_sequential(K_STOP_SERVER,
                                                     client.rank):
            logging.warning("kvstore: failed to stop server %d: %r",
                            server, exc)
        client.close()


def create(name="local") -> KVStore:
    """``mx.kv.create`` (parity: kvstore.py:385 and the type parsing of
    src/kvstore/kvstore.cc:17-45): ``local``/``device`` and the
    reference's aliases, and the ``dist_*`` parameter-server stores."""
    if not isinstance(name, str):
        raise TypeError("name must be str")
    if "dist" in name:
        return KVStoreDist(name)
    if name in _LOCAL_TYPES:
        return KVStore(name)
    raise MXNetError(f"unknown kvstore type {name}")
