"""Parameter-server process of the port: the ``dist_*`` kvstore backend
(mirrors ``mxnet_tpu/kvstore_server.py``; parity:
src/kvstore/kvstore_dist_server.h and python/mxnet/kvstore_server.py).

MXNet's servers hold the model on the host and aggregate the workers'
pushes: in **sync** mode a key's pushes are summed until every worker
has contributed, the updater runs once on the sum, and pulls that wait
for that round are answered after it (kvstore_dist_server.h:164-199); in
**async** mode every push updates at once (:200-210).  Controller
commands (``K_STOP_SERVER``, ``K_SYNC_MODE``, ``K_SET_OPTIMIZER``) set
the mode, install the workers' optimizer and stop the server.

The transport is the JAX package's: length-prefixed pickles over TCP
whose unpickler admits only the globals numpy arrays need, so a worker
of either package can talk to a server of either package.  An array is
sent from its own memory (the stream's bytes are those of an in-band
protocol-5 pickle, less its optional frames) and received with one
copy.  A server process runs each update on one intra-op thread.  Parameters
live here as numpy arrays.  The server-side optimizer is this package's
:func:`~mxnet_tpu_torch.optimizer.get_updater` run on CPU tensors that
share the arrays' memory: a server never creates a CUDA context, as
MXNet's servers are CPU-only.  The optimizer arrives pickled by worker
0, whose tensors (if it holds any) were moved to the host before
pickling (:func:`dumps_host`).

Launch contract (``python -m mxnet_tpu_torch.launch``): every process
gets ``MXTPU_ROLE`` (worker|server), ``MXTPU_SERVER_RANK``,
``MXTPU_NUM_WORKERS``, ``MXTPU_NUM_SERVERS`` and ``MXTPU_PS_SERVERS``
(comma-separated host:port, one per server).  Servers run the same user
script as workers: ``import mxnet_tpu_torch`` calls
:func:`_init_kvstore_server_module` as its last statement, which serves
until every live worker has asked it to stop and then exits the process
with a one-line summary on stdout (``kvstore_server {json}``: pushes,
pulls, updates and their seconds, bytes, and whether CUDA was
initialised).
"""
from __future__ import annotations

import io
import json
import os
import pickle
import pickletools
import socket
import socketserver
import struct
import sys
import threading
import time
from collections import OrderedDict

import numpy as np

__all__ = ["KVStoreServer", "K_STOP_SERVER", "K_SYNC_MODE",
           "K_SET_OPTIMIZER", "send_msg", "recv_msg", "dumps_host"]

# controller command heads (parity: kvstore_dist_server.h:33-38)
K_STOP_SERVER = 0
K_SYNC_MODE = 1
K_SET_OPTIMIZER = 2


def _role():
    return os.environ.get("MXTPU_ROLE", os.environ.get("DMLC_ROLE", "worker"))


def _logical_key(part_key):
    """'3' / '3#p1' -> 3; non-integer logical keys pass through as str."""
    base = str(part_key).split("#p", 1)[0]
    try:
        return int(base)
    except ValueError:
        return base


class _SysModulesUnpickler(pickle.Unpickler):
    """Resolves classes from ``sys.modules`` without the import machinery:
    the server's main thread is parked inside ``import mxnet_tpu_torch``
    (holding the package's import lock), so a handler thread that
    imported would wait on that lock forever."""

    def find_class(self, module, name):
        mod = sys.modules.get(module)
        if mod is not None:
            return getattr(mod, name)
        return super().find_class(module, name)


def _loads_no_import(data):
    return _SysModulesUnpickler(io.BytesIO(data)).load()


class _HostPickler(pickle.Pickler):
    """Pickles every torch tensor as a host tensor, so the unpickling
    server never touches a card."""

    def reducer_override(self, obj):
        import torch

        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return obj.detach().cpu().__reduce_ex__(pickle.HIGHEST_PROTOCOL)
        return NotImplemented


def dumps_host(obj) -> bytes:
    """``pickle.dumps`` with any tensor moved to the host first (what a
    worker ships as the ``K_SET_OPTIMIZER`` body)."""
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


# Transport messages are dicts of str/int/float/bytes/ndarray; the
# unpickler admits exactly the globals numpy payloads need, so the
# transport is no arbitrary-object deserializer.  The one richer payload,
# the K_SET_OPTIMIZER body, travels as bytes inside a data message and is
# unpickled separately under MXNet's trusted-cluster assumption.
_SAFE_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}


class _DataUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS:
            mod = sys.modules.get(module)
            if mod is None:
                mod = __import__(module, fromlist=[name])
            return getattr(mod, name)
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not allowed on the kvstore transport")


def _wire_parts(obj):
    """``obj`` as the transport's pickle (protocol 5, each array's bytes
    in band, the stream the JAX package's ``pickle.dumps`` makes less its
    optional frames), in parts: an array's bytes are not copied into the
    stream but sent from the array's own memory."""
    bufs = []
    head = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    if not bufs:
        return [head]
    parts, pos, nb = [], 0, 0
    for op, _arg, at in pickletools.genops(head):
        if op.name == "FRAME":
            parts.append(head[pos:at])
            pos = at + 9
        elif op.name == "NEXT_BUFFER":
            raw = bufs[nb].raw()
            nb += 1
            ro = head[at + 1:at + 2] == pickle.READONLY_BUFFER
            parts.append(head[pos:at] + (pickle.BINBYTES8 if ro
                                         else pickle.BYTEARRAY8)
                         + struct.pack("<Q", raw.nbytes))
            parts.append(raw)
            pos = at + (2 if ro else 1)
    parts.append(head[pos:])
    return parts


def send_msg(sock, obj):
    """One length-prefixed message; returns the bytes sent."""
    parts = _wire_parts(obj)
    n = sum(len(p) if isinstance(p, bytes) else p.nbytes for p in parts)
    sock.sendall(struct.pack("<Q", n) + parts[0])
    for part in parts[1:]:
        sock.sendall(part)
    return n + 8


class _Reader:
    """A file over a received payload for the unpickler: an array's bytes
    are copied once, straight into the array (``readinto``)."""

    __slots__ = ("_buf", "_view", "_i")

    def __init__(self, buf):
        self._buf, self._view, self._i = buf, memoryview(buf), 0

    def read(self, n=-1):
        i = self._i
        j = len(self._buf) if n is None or n < 0 else min(i + n,
                                                          len(self._buf))
        self._i = j
        return bytes(self._view[i:j])

    def readinto(self, b):
        i = self._i
        n = min(len(b), len(self._buf) - i)
        memoryview(b).cast("B")[:n] = self._view[i:i + n]
        self._i = i + n
        return n

    def readline(self):
        i = self._i
        j = self._buf.find(b"\n", i)
        j = len(self._buf) if j < 0 else j + 1
        self._i = j
        return bytes(self._view[i:j])


def recv_msg(sock):
    header = _recv_exact(sock, 8)
    if header is None:
        return None
    (length,) = struct.unpack("<Q", header)
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    return _DataUnpickler(_Reader(payload)).load()


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], n - got)
        except ConnectionResetError:
            # a dead peer (or a worker's retry path that abandoned a
            # broken stream) reads as EOF: the retransmission arrives on
            # a fresh connection
            return None
        if not k:
            return None
        got += k
    return buf


class _ServerState:
    """Shared mutable server state guarded by one lock and condvar."""

    def __init__(self, num_workers):
        self.num_workers = num_workers
        self.store = {}            # key -> np.ndarray (the weights)
        self.merge_buf = {}        # key -> [summed np.ndarray, set(ranks)]
        self.updater = None        # fn(key, recv, stored): mutates stored
        self.sync_mode = False
        self.barrier_count = 0
        self.barrier_gen = 0
        self.stop_count = 0
        self.stopped = False
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        # failure detection (parity: ps-lite heartbeats surfaced through
        # KVStore::get_num_dead_node, kvstore_dist.h:151-160): workers
        # beat on a dedicated connection; any ranked message refreshes
        self.heartbeats = {}        # rank -> monotonic time of last sign
        self.stopped_ranks = set()  # ranks that sent a clean kStopServer
        self.start_time = time.monotonic()
        # idempotent retransmit: a non-idempotent message (push, barrier,
        # init, control) carries a request id; a retransmitted id whose
        # first delivery applied replays the cached reply (a re-applied
        # sync push would count the gradient twice, a re-applied barrier
        # release the round early); one still in flight waits for it
        self.rid_done = OrderedDict()
        self.rid_inflight = set()
        self.rid_cap = 4096
        self.stats = {"pushes": 0, "pulls": 0, "updates": 0,
                      "update_s": 0.0, "bytes_in": 0, "bytes_out": 0}

    def dead_nodes(self, timeout):
        """Worker ranks with no sign of life within ``timeout`` seconds.
        Never-connected ranks count from the server's start; ranks that
        sent a clean kStopServer are done, not dead."""
        now = time.monotonic()
        return [r for r in range(self.num_workers)
                if r not in self.stopped_ranks
                and now - self.heartbeats.get(r, self.start_time) > timeout]

    def should_stop(self, dead_timeout):
        """Every live worker has asked to stop (a crashed worker never
        sends kStopServer)."""
        if self.stop_count >= self.num_workers:
            return True
        return (self.stop_count > 0 and
                self.stop_count >= self.num_workers
                - len(self.dead_nodes(dead_timeout)))

    @staticmethod
    def default_update(key, recv, stored):
        # parity: kvstore_dist_server.h:229-236: without an optimizer the
        # server only aggregates (update_on_kvstore=False)
        stored[...] = recv

    def apply(self, key, recv):
        """Run the updater on ``recv`` for ``key`` (lock held)."""
        t0 = time.perf_counter()
        (self.updater or self.default_update)(key, recv, self.store[key])
        self.stats["updates"] += 1
        self.stats["update_s"] += time.perf_counter() - t0


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        st: _ServerState = self.server.state
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            msg = recv_msg(sock)
            if msg is None:
                return
            cmd = msg["cmd"]
            rank = msg.get("rank", -1)
            if isinstance(rank, int) and rank >= 0:
                with st.cond:
                    st.heartbeats[rank] = time.monotonic()
            if cmd == "heartbeat":
                send_msg(sock, {"ok": True})
            elif cmd == "dead_nodes":
                with st.cond:
                    dead = st.dead_nodes(float(msg.get("timeout", 60)))
                send_msg(sock, {"dead": dead})
            elif cmd == "pull":
                # pulls are idempotent: a retransmission just re-reads
                value = self._pull(st, msg["key"], rank)
                n = send_msg(sock, {"value": value})
                with st.cond:
                    st.stats["pulls"] += 1
                    st.stats["bytes_out"] += n
            elif cmd in ("init", "push", "barrier", "control"):
                send_msg(sock, self._apply_once(st, cmd, msg))
                if cmd == "control" and msg["head"] == K_STOP_SERVER:
                    with st.cond:
                        if st.stop_count >= st.num_workers:
                            return
            else:
                send_msg(sock, {"error": f"unknown cmd {cmd}"})

    def _apply_once(self, st, cmd, msg):
        """Apply one non-idempotent message exactly once (see
        ``_ServerState.rid_done``)."""
        rid = msg.get("rid")
        if rid is not None:
            with st.cond:
                while rid in st.rid_inflight:
                    st.cond.wait()
                if rid in st.rid_done:
                    return st.rid_done[rid]
                st.rid_inflight.add(rid)
        reply = None
        try:
            reply = self._apply(st, cmd, msg)
        finally:
            if rid is not None:
                # discard and cache under one lock hold: a retransmission
                # woken between them would re-apply the message
                with st.cond:
                    st.rid_inflight.discard(rid)
                    if reply is not None:
                        st.rid_done[rid] = reply
                        while len(st.rid_done) > st.rid_cap:
                            st.rid_done.popitem(last=False)
                    st.cond.notify_all()
        return reply

    def _apply(self, st, cmd, msg):
        if cmd == "init":
            with st.cond:
                st.store[msg["key"]] = np.array(msg["value"], copy=True)
        elif cmd == "push":
            self._push(st, msg)
        elif cmd == "barrier":
            self._barrier(st)
        else:  # control
            self._control(st, msg["head"], msg.get("body"))
        return {"ok": True}

    # parity: DataHandle (kvstore_dist_server.h:136-227)
    def _push(self, st, msg):
        key, recv = msg["key"], np.asarray(msg["value"])
        if not recv.flags.writeable:
            recv = recv.copy()
        rank = msg.get("rank", -1)
        with st.cond:
            st.stats["pushes"] += 1
            st.stats["bytes_in"] += recv.nbytes
            if key not in st.store:
                # the first push defines a key no init announced
                st.store[key] = np.zeros_like(recv)
            if st.sync_mode:
                buf = st.merge_buf.get(key)
                if buf is None:
                    # the message's own array: nothing else holds it
                    buf = st.merge_buf[key] = [recv, set()]
                else:
                    buf[0] += recv
                buf[1].add(rank)
                if len(buf[1]) == st.num_workers:
                    st.apply(key, buf[0])
                    del st.merge_buf[key]
                    st.cond.notify_all()
            else:
                st.apply(key, recv)

    @staticmethod
    def _pull(st, key, rank=-1):
        with st.cond:
            # sync mode: park the pull only while a merge this worker
            # already contributed to is in flight (it wants the updated
            # value; parity: the parked pull replies of
            # kvstore_dist_server.h:186-198).  A pull from a worker that
            # has not contributed belongs to the previous round and gets
            # the last completed value at once.
            while (st.sync_mode and key in st.merge_buf
                   and rank in st.merge_buf[key][1]):
                st.cond.wait()
            # copy under the lock: updaters mutate the array in place
            return st.store[key].copy()

    @staticmethod
    def _barrier(st):
        with st.cond:
            gen = st.barrier_gen
            st.barrier_count += 1
            if st.barrier_count == st.num_workers:
                st.barrier_count = 0
                st.barrier_gen += 1
                st.cond.notify_all()
            else:
                while st.barrier_gen == gen:
                    st.cond.wait()

    # parity: CommandHandle (kvstore_dist_server.h:121-133)
    @staticmethod
    def _control(st, head, body):
        with st.cond:
            if head == K_SYNC_MODE:
                st.sync_mode = True
            elif head == K_SET_OPTIMIZER:
                st.updater = _make_updater(body)
            elif head == K_STOP_SERVER:
                st.stop_count += 1
                rank = body if isinstance(body, int) else -1
                if rank >= 0:
                    st.stopped_ranks.add(rank)
                if st.stop_count >= st.num_workers:
                    st.stopped = True
                st.cond.notify_all()


def _make_updater(body):
    """The numpy-facing updater around the workers' optimizer: CPU
    tensors over the stored array's memory, so the update lands in place.
    The modules are taken from ``sys.modules``: they were imported before
    the server started, and a handler thread must not import."""
    torch = sys.modules["torch"]
    opt = sys.modules[__package__ + ".optimizer"]
    NDArray = sys.modules[__package__ + ".ndarray"].NDArray

    updater = opt.get_updater(_loads_no_import(body))

    def np_updater(key, recv, stored):
        # the store key is the part key ('3' or '3#p0'); the optimizer's
        # multipliers are indexed by the logical key (parity: the
        # server's DecodeKey, kvstore_dist_server.h:221-224)
        updater(_logical_key(key), NDArray(torch.from_numpy(recv)),
                NDArray(torch.from_numpy(stored)))

    return np_updater


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class KVStoreServer:
    """The blocking server loop (parity: python/mxnet/kvstore_server.py
    ``KVStoreServer``)."""

    def __init__(self, num_workers=None, port=None, host=None):
        self.num_workers = num_workers or int(
            os.environ.get("MXTPU_NUM_WORKERS",
                           os.environ.get("DMLC_NUM_WORKER", "1")))
        self.rank = int(os.environ.get("MXTPU_SERVER_RANK", "0"))
        servers = os.environ.get("MXTPU_PS_SERVERS", "").split(",")
        if port is None:
            port = (int(servers[self.rank].rsplit(":", 1)[1])
                    if servers[0] else 9090)
        if host is None:
            # bind the address advertised for this server rank (127.0.0.1
            # for local launches), not 0.0.0.0, which would expose the
            # transport to anything that reaches the port
            advertised = (servers[self.rank].rsplit(":", 1)[0]
                          if servers[0] else "127.0.0.1")
            host = os.environ.get("MXTPU_PS_BIND",
                                  advertised or "127.0.0.1")
        self.host = host
        self.port = port
        self.state = _ServerState(self.num_workers)
        self._srv = None

    def start(self):
        """Bind and serve on a daemon thread; returns self (``port=0``
        binds an ephemeral port, read back from :attr:`port`)."""
        self._srv = _TCPServer((self.host, self.port), _Handler)
        self._srv.state = self.state
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever, daemon=True,
                         name="mxtpu-kvstore-server").start()
        return self

    def run(self):
        """Serve until every live worker has sent kStopServer.  A crashed
        worker is detected by heartbeat staleness
        (``MXTPU_PS_DEAD_TIMEOUT_S``, default 60 s), so the server still
        exits when the others stop.  The dead count is published on the
        ``kvstore_dead_workers`` gauge as the loop wakes."""
        from . import telemetry as _tm
        from .kvstore import _TM_DEAD_WORKERS

        dead_timeout = float(os.environ.get("MXTPU_PS_DEAD_TIMEOUT_S", "60"))
        if self._srv is None:
            self.start()
        with self.state.cond:
            while not self.state.stopped:
                if self.state.should_stop(dead_timeout):
                    self.state.stopped = True
                    break
                if _tm.enabled():
                    _TM_DEAD_WORKERS.set(
                        len(self.state.dead_nodes(dead_timeout)))
                self.state.cond.wait(timeout=2.0)
        self.shutdown()

    def shutdown(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None

    def summary(self) -> dict:
        """What this server did: its rank, the message counts, the
        updater's calls and seconds, the bytes in and out, and whether
        this process initialised CUDA (a server never should)."""
        torch = sys.modules.get("torch")
        with self.state.cond:
            out = dict(self.state.stats)
        out["update_ms_mean"] = (out["update_s"] * 1e3 / out["updates"]
                                 if out["updates"] else 0.0)
        out["rank"] = self.rank
        out["cuda_initialized"] = bool(
            torch is not None and torch.cuda.is_initialized())
        return out


def _init_kvstore_server_module():
    """Parity: kvstore_server.py:70-90: a process launched in the server
    role serves, then exits (it never returns to user code)."""
    if _role() == "server":
        # The main thread parks here while still inside ``import
        # mxnet_tpu_torch``, holding the package's import lock.  The
        # package body has run (this is its last statement), so mark it
        # initialised: handler threads then find it without the lock.
        pkg = sys.modules.get(__package__)
        spec = getattr(pkg, "__spec__", None)
        if spec is not None and getattr(spec, "_initializing", False):
            spec._initializing = False
        # each handler thread runs its key's update on one intra-op
        # thread (MXNet's server updates on one executor thread): torch's
        # default of one thread a core, in every server beside the
        # workers, oversubscribes the host's cores
        sys.modules["torch"].set_num_threads(1)
        server = KVStoreServer()
        server.run()
        # one write: the servers and workers of a launch share stdout
        sys.stdout.flush()
        os.write(sys.stdout.fileno(), ("kvstore_server " + json.dumps(
            server.summary()) + "\n").encode())
        sys.exit(0)
