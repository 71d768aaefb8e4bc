"""The port's parameter-server stores against the JAX package's, on the
CPU.

In process: a ``KVStoreServer`` of each package runs in threads, and the
same numpy-seeded push/pull sequences go through each package's
``KVStoreDist`` (two workers in threads; the JAX side with
``MXTPU_PS_ASYNC=0``, the port's on its native engine with lazy pulls):
sync merges, async applies, a key split as ``key#p<i>`` at
``MXNET_KVSTORE_BIGARRAY_BOUND=1000``, a pickled server optimizer
(SGD with momentum and wd), the recovery contract, dead-node counts, and
``dist_send``/``dist_recv`` drops that are retried and applied once.
The pulled values agree to 1e-6 relative (the servers' updaters are the
two packages' SGD; the sums are exact).

Launched: ``Module.fit(kvstore="dist_sync")`` on a small MLP, 2 workers
and 2 servers, through ``tools/launch.py`` for the JAX package
(``JAX_PLATFORMS=cpu MXTPU_PLATFORM=cpu``) and ``python -m
mxnet_tpu_torch.launch`` for the port (``context=mx.cpu()``), from the
same numpy params: the workers' weights are bit-equal to each other in
each package and the two packages agree to 1e-5 (fp32).  The port's
workers launched by ``tools/launch.py`` unchanged give the same weights
bit for bit (one environment contract).  A ``dist_async`` launch whose
worker 1 dies at the ``host_crash`` site (``crash_after:2``) is
restarted by ``--max-restarts 1`` with ``MXTPU_KV_RECOVERY=1``, pulls
the servers' trained model instead of re-initialising it, and worker 0
sees it dead through ``get_num_dead_node``.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
import types

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import faults as jfaults
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import kvstore_server as jserver

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import kvstore_server as tserver
from mxnet_tpu_torch import telemetry as ttm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32
TOL = dict(rtol=1e-6, atol=1e-7)

# out arrays are fresh arrays (np.zeros through nd.array): a worker
# thread must never share its out array's storage with another's
JAX = types.SimpleNamespace(
    name="jax", kv=jkv, server=jserver, faults=jfaults,
    arr=lambda x: jmx.nd.array(x),
    zeros=lambda s: jmx.nd.array(np.zeros(s, F32)),
    opt=lambda name, **kw: jmx.optimizer.create(name, **kw), ps_async="0")
PORT = types.SimpleNamespace(
    name="port", kv=tkv, server=tserver, faults=tfaults,
    arr=lambda x: tmx.nd.array(x, ctx="cpu"),
    zeros=lambda s: tmx.nd.array(np.zeros(s, F32), ctx="cpu"),
    opt=lambda name, **kw: tmx.optimizer.create(name, **kw), ps_async="1")


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class _Cluster:
    """Servers of one package in threads, and one store per worker."""

    def __init__(self, P, monkeypatch, kv_type, workers, servers,
                 clients=None):
        self.P = P
        ports = _free_ports(servers)
        monkeypatch.setenv("MXTPU_PS_SERVERS", ",".join(
            f"127.0.0.1:{p}" for p in ports))
        monkeypatch.setenv("MXTPU_NUM_WORKERS", str(workers))
        monkeypatch.setenv("MXTPU_PS_ASYNC", P.ps_async)
        self.servers = [P.server.KVStoreServer(num_workers=workers, port=p,
                                               host="127.0.0.1")
                        for p in ports]
        self.threads = [threading.Thread(target=s.run, daemon=True)
                        for s in self.servers]
        for t in self.threads:
            t.start()
        self.stores = []
        for rank in range(workers if clients is None else clients):
            self.stores.append(self.store(monkeypatch, kv_type, rank))
        if "async" not in kv_type and self.stores:
            # what worker 0's constructor sends, before any init
            self.stores[0]._client.control(P.server.K_SYNC_MODE)
        monkeypatch.delenv("MXTPU_KV_RECOVERY", raising=False)

    def store(self, monkeypatch, kv_type, rank, recovery=False):
        """A worker's store; built in recovery mode (no startup
        barrier, so the workers can be made one after another) and put
        back to the normal mode unless ``recovery``."""
        monkeypatch.setenv("MXTPU_RANK", str(rank))
        monkeypatch.setenv("MXTPU_KV_RECOVERY", "1")
        kv = self.P.kv.KVStoreDist(kv_type)
        kv._recovery = recovery
        return kv

    def run(self, fn):
        """``fn(P, kv, rank)`` on every worker at once; their results."""
        out, errs = [None] * len(self.stores), []

        def work(rank):
            try:
                out[rank] = fn(self.P, self.stores[rank], rank)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errs.append(exc)

        ts = [threading.Thread(target=work, args=(r,))
              for r in range(len(self.stores))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        if errs:
            raise errs[0]
        return out

    def stop(self):
        for kv in self.stores:
            kv._send_stop()
        for t in self.threads:
            t.join(30)
        assert not any(t.is_alive() for t in self.threads)


SHAPES = {"a": (4, 5), "big": (40, 30)}     # big: 1200 > the bound 1000


def _sync_sequence(P, kv, rank):
    init = np.random.RandomState(7)
    for k, s in SHAPES.items():
        kv.init(k, P.arr(init.standard_normal(s).astype(F32)))
    rs = np.random.RandomState(100 + rank)
    pulled = []
    for rnd in range(5):
        if rnd == 2:
            kv.set_optimizer(P.opt("sgd", learning_rate=0.1, momentum=0.9,
                                   wd=1e-3, rescale_grad=0.5))
        for k, s in SHAPES.items():
            kv.push(k, P.arr(rs.standard_normal(s).astype(F32)))
        for k, s in SHAPES.items():
            o = P.zeros(s)
            kv.pull(k, out=o)
            pulled.append(o.asnumpy())
    return pulled


def _run_sync(P, monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "1000")
    cl = _Cluster(P, monkeypatch, "dist_sync", workers=2, servers=2)
    try:
        pulled = cl.run(_sync_sequence)
        stores = [sorted(s.state.store) for s in cl.servers]
        # recovery: a restarted worker 1 neither re-inits nor re-ships
        # the optimizer; it pulls the live model
        kv = cl.store(monkeypatch, "dist_sync", 1, recovery=True)
        kv.init("a", P.zeros(SHAPES["a"]))
        kv.set_optimizer(P.opt("sgd", learning_rate=99.0))
        o = P.zeros(SHAPES["a"])
        kv.pull("a", out=o)
        recovered = o.asnumpy()
        kv._client.close()
        kv._client = None
    finally:
        cl.stop()
    return pulled, stores, recovered


def test_sync_merge_split_optimizer_and_recovery_match_jax(monkeypatch):
    jp, jstores, jrec = _run_sync(JAX, monkeypatch)
    tp, tstores, trec = _run_sync(PORT, monkeypatch)
    # the big key is split over both servers, the small one on one
    assert tstores == jstores
    assert "big#p0" in tstores[0] and "big#p1" in tstores[1]
    assert sum("a" in s for s in tstores) == 1
    for rank in range(2):
        for j, t in zip(jp[rank], tp[rank]):
            np.testing.assert_allclose(t, j, **TOL)
    # every worker pulls the same model, and the aggregation-only rounds
    # are the exact sums of the two workers' pushes
    for a, b in zip(tp[0], tp[1]):
        np.testing.assert_array_equal(a, b)
    rs = [np.random.RandomState(100 + r) for r in range(2)]
    for i, (k, s) in enumerate(SHAPES.items()):
        g = [r.standard_normal(s).astype(F32) for r in rs]
        np.testing.assert_array_equal(tp[0][i], g[0] + g[1])
    np.testing.assert_array_equal(trec, tp[0][-2])
    np.testing.assert_allclose(trec, jrec, **TOL)


def _async_sequence(P, kv, rank):
    kv.init("a", P.arr(np.linspace(-1, 1, 20).astype(F32).reshape(4, 5)))
    kv.set_optimizer(P.opt("sgd", learning_rate=0.5, momentum=0.5,
                           rescale_grad=1.0))
    kv.barrier()
    rs = np.random.RandomState(200 + rank)
    pulled = []
    for _ in range(3):
        for turn in range(2):  # the workers push in turn: one order
            if turn == rank:
                kv.push("a", P.arr(rs.standard_normal((4, 5)).astype(F32)))
            kv.barrier()
        o = P.zeros((4, 5))
        kv.pull("a", out=o)
        pulled.append(o.asnumpy())
        kv.barrier()  # both read before either pushes the next round
    return pulled


def _run_async(P, monkeypatch):
    cl = _Cluster(P, monkeypatch, "dist_async", workers=2, servers=1)
    try:
        return cl.run(_async_sequence)
    finally:
        cl.stop()


def test_async_apply_matches_jax(monkeypatch):
    jp = _run_async(JAX, monkeypatch)
    tp = _run_async(PORT, monkeypatch)
    for rank in range(2):
        for j, t in zip(jp[rank], tp[rank]):
            np.testing.assert_allclose(t, j, **TOL)
    # after each round's barrier both workers read one model
    for a, b in zip(tp[0], tp[1]):
        np.testing.assert_array_equal(a, b)


def test_pull_takes_the_push_var_on_the_calling_thread(monkeypatch):
    """A lazy pull waits for its key's pushes on the push var, which the
    pull looks up (or makes) on the calling thread: made on the pull
    engine's thread, it could race the loop's first push of the key into
    a second var, and later pulls would not wait for that push."""
    cl = _Cluster(PORT, monkeypatch, "dist_async", workers=1, servers=1)
    kv = cl.stores[0]
    assert kv._pull_engine is not None, "the native engine did not build"
    callers = []
    var = tkv.KVStoreDist._var

    def spy(self, key):
        callers.append(threading.get_ident())
        return var(self, key)

    monkeypatch.setattr(tkv.KVStoreDist, "_var", spy)
    try:
        kv.init("w", PORT.arr(np.ones((3, 4), F32)))
        outs = [PORT.zeros((3, 4)) for _ in range(3)]
        kv.pull("w", out=outs[0])             # before any push of "w"
        kv.push("w", PORT.arr(np.full((3, 4), 2.0, F32)))
        kv.pull("w", out=outs[1])
        kv.pull("w", out=outs[2])
        kv.wait_pulls()
        got = [o.asnumpy() for o in outs]
    finally:
        cl.stop()
    assert callers and set(callers) == {threading.get_ident()}
    # the two pulls after the push read the pushed value
    np.testing.assert_array_equal(got[1], np.full((3, 4), 2.0, F32))
    np.testing.assert_array_equal(got[2], got[1])


def _run_dead(P, monkeypatch):
    monkeypatch.setenv("MXTPU_PS_HEARTBEAT_S", "0.1")
    monkeypatch.setenv("MXTPU_PS_DEAD_TIMEOUT_S", "0.5")
    # a 2-worker cluster where worker 1 never connects
    cl = _Cluster(P, monkeypatch, "dist_async", workers=2, servers=2,
                  clients=1)
    try:
        time.sleep(1.0)
        return (cl.stores[0].get_num_dead_node(0, timeout=0.5),
                cl.stores[0].get_num_dead_node(0, timeout=60))
    finally:
        cl.stop()


def test_dead_node_counts_match_jax(monkeypatch):
    was = ttm.enabled()
    ttm.enable()
    try:
        assert _run_dead(PORT, monkeypatch) == _run_dead(JAX, monkeypatch) \
            == (1, 0)
        assert "kvstore_dead_workers" in ttm.json_snapshot()["metrics"]
    finally:
        ttm.enable(was)


def _run_drops(P, monkeypatch):
    monkeypatch.setenv("MXTPU_DIST_BACKOFF_MS", "1")
    cl = _Cluster(P, monkeypatch, "dist_sync", workers=1, servers=1)
    w0 = np.arange(6, dtype=F32).reshape(2, 3)
    g = np.full((2, 3), 0.25, F32)
    try:
        kv = cl.stores[0]
        kv.init("w", P.arr(w0))
        kv.set_optimizer(P.opt("sgd", learning_rate=1.0, rescale_grad=1.0))
        # the push's first send is lost, then its first reply (after
        # the server applied it): the retransmission must replay the
        # cached reply, not apply the gradient again
        monkeypatch.setenv("MXTPU_FAULT_PLAN",
                           "dist_send:drop_first:1,dist_recv:drop_first:1")
        P.faults.reset()
        kv.push("w", P.arr(g))
        o = P.zeros((2, 3))
        kv.pull("w", out=o)
        return o.asnumpy(), w0 - g
    finally:
        monkeypatch.delenv("MXTPU_FAULT_PLAN")
        P.faults.reset()
        cl.stop()


def test_dropped_sends_and_replies_are_retried_once_applied(monkeypatch):
    was = ttm.enabled()
    ttm.enable()
    ttm.reset()
    try:
        jgot, want = _run_drops(JAX, monkeypatch)
        tgot, _ = _run_drops(PORT, monkeypatch)
        np.testing.assert_array_equal(jgot, want)
        np.testing.assert_array_equal(tgot, want)
        retries = ttm.json_snapshot()["metrics"][
            "kvstore_dist_retries_total"]["samples"]
        assert {s["labels"]["op"]: s["value"] for s in retries} == \
            {"push": 2}
    finally:
        ttm.enable(was)


@pytest.mark.parametrize("sender,receiver", [("port", "jax"),
                                             ("jax", "port"),
                                             ("port", "port")])
def test_transport_messages_cross_the_packages(sender, receiver):
    """The port sends an array from its own memory and reads one with a
    single copy; the stream is the JAX package's in-band pickle, so
    either side reads the other's messages, arrays writable (or, sent
    read-only, read-only) and bit-equal."""
    mods = {"port": tserver, "jax": jserver}
    a, b = socket.socketpair()
    big = np.random.RandomState(0).standard_normal(300_000).astype(F32)
    ro = np.arange(7, dtype=np.int64)
    ro.flags.writeable = False
    msgs = [{"cmd": "push", "key": "3#p1", "value": big[5:250_000],
             "rank": 1, "rid": "1:2:3"},
            {"cmd": "heartbeat", "rank": 0},
            {"value": ro, "body": b"\x00optimizer", "head": 2},
            {"dead": [0, 1], "value": np.float32(2.5)}]
    try:
        for msg in msgs:
            t = threading.Thread(target=mods[sender].send_msg, args=(a, msg))
            t.start()
            got = mods[receiver].recv_msg(b)
            t.join(30)
            assert set(got) == set(msg)
            for k, v in msg.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(got[k], v)
                    assert got[k].dtype == v.dtype
                    assert got[k].flags.writeable == v.flags.writeable
                else:
                    assert got[k] == v
    finally:
        a.close()
        b.close()


def _ff_fit(monkeypatch, kvstore):
    """``FeedForward.fit`` of a small MLP on the CPU from fixed params."""
    rs = np.random.RandomState(4)
    X = rs.uniform(-1, 1, (32, 6)).astype(F32)
    Y = rs.randint(0, 3, 32).astype(F32)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    arg = {"fc_weight": rs.normal(0, .3, (3, 6)).astype(F32),
           "fc_bias": np.zeros(3, F32)}
    ff = tmx.model.FeedForward(net, ctx=tmx.cpu(), num_epoch=2,
                               numpy_batch_size=8, learning_rate=0.1,
                               momentum=0.9, arg_params=arg)
    np.random.seed(0)  # the training iterator shuffles with numpy's RNG
    ff.fit(X, Y, kvstore=kvstore)
    return {k: v.asnumpy() for k, v in ff.arg_params.items()}, ff


def test_feedforward_fit_through_a_server_equals_the_local_store(
        monkeypatch):
    """``FeedForward`` (a Module underneath) through ``dist_sync`` with
    one worker and one server: the server's update on the host is the
    module's own, so the weights equal the local path's to the bit, and
    the pulls land in the module's weights before each forward."""
    want, _ = _ff_fit(monkeypatch, "local")
    cl = _Cluster(PORT, monkeypatch, "dist_sync", workers=1, servers=1,
                  clients=0)
    monkeypatch.setenv("MXTPU_RANK", "0")
    ff = None
    try:
        got, ff = _ff_fit(monkeypatch, "dist_sync")
        kv = ff._module._kvstore
        assert isinstance(kv, tkv.KVStoreDist) and not kv.collective
        # 2 epochs of 4 batches, 2 keys
        assert cl.servers[0].state.stats["updates"] == 2 * 4 * 2
    finally:
        if ff is not None:
            ff._module._kvstore._send_stop()
        for t in cl.threads:
            t.join(30)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_collective_launch_without_servers_names_item_10b(monkeypatch):
    """The collective dist_sync (ROADMAP Queue 1 item 10b, slice 3) is
    ported: workers without servers join the launcher's rendezvous, and
    several workers without one are named with the launch command."""
    monkeypatch.delenv("MXTPU_PS_SERVERS", raising=False)
    monkeypatch.delenv("MXTPU_COORDINATOR", raising=False)
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    with pytest.raises(MXNetError, match="mxnet_tpu_torch.launch -n 2 -s 0"):
        tmx.kv.create("dist_sync")


def test_server_updater_is_the_ports_updater_on_host_arrays():
    """The server's updater (the optimizer worker 0 ships, unpickled
    without imports) updates the stored numpy array in place, bit for
    bit as the port's own ``Updater`` on CPU tensors; a split key's
    part is updated under its logical key."""
    import torch

    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                               wd=1e-3, rescale_grad=0.5)
    upd = tserver._make_updater(tserver.dumps_host(opt))
    ref = tmx.optimizer.get_updater(tmx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.5))
    rs = np.random.RandomState(3)
    stored = rs.standard_normal((6, 5)).astype(F32)
    want = tmx.nd.NDArray(torch.from_numpy(stored.copy()))
    for _ in range(3):
        g = rs.standard_normal((6, 5)).astype(F32)
        upd("7#p1", g, stored)
        ref(7, tmx.nd.NDArray(torch.from_numpy(g)), want)
    np.testing.assert_array_equal(stored, want.asnumpy())


# ------------------------------------------------------------ launches
MLP_WORKER = textwrap.dedent("""
    import importlib, os
    import numpy as np
    mx = importlib.import_module(os.environ["PKG"])
    rank = int(os.environ["MXTPU_RANK"])
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Activation(
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                              name="fc1"), act_type="relu"),
        num_hidden=5, name="fc2"), name="softmax")
    rs = np.random.RandomState(11)
    X = rs.uniform(-1, 1, (64, 8)).astype(np.float32)
    Y = rs.randint(0, 5, 64).astype(np.float32)
    it = mx.io.NDArrayIter(X[rank::2], Y[rank::2], batch_size=8)
    init = np.load(os.environ["INIT_NPZ"])
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(it, num_epoch=2, kvstore="dist_sync", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params=({k: mx.nd.array(init[k], ctx=mx.cpu())
                         for k in init.files} if rank == 0 else None),
            initializer=mx.init.Uniform(0.5))
    arg, _ = mod.get_params()
    np.savez(os.path.join(os.environ["OUT"], "w%d.npz" % rank),
             **{k: v.asnumpy() for k, v in arg.items()})
""")


def _env(tmp_path, **extra):
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("MXTPU_", "DMLC_", "MXNET_")):
            del env[k]
    env.update(JAX_PLATFORMS="cpu", MXTPU_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    env.update(extra)
    return env


def _launch(launcher, script, n, s, env, extra=(), timeout=240):
    cmd = ([sys.executable, "-m", "mxnet_tpu_torch.launch"]
           if launcher == "port" else
           [sys.executable, os.path.join(REPO, "tools", "launch.py")])
    proc = subprocess.run(
        cmd + ["-n", str(n), "-s", str(s), *extra, "--launcher", "local",
               sys.executable, str(script)],
        env=env, cwd=REPO, timeout=timeout, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout + proc.stderr


def _mlp_fit(tmp_path, pkg, launcher):
    out = tmp_path / f"{pkg}-{launcher}"
    out.mkdir()
    script = tmp_path / "mlp_worker.py"
    script.write_text(MLP_WORKER)
    # the JAX side's RPCs run on the calling thread (its native engine
    # would be built by both workers at once)
    log = _launch(launcher, script, 2, 2, _env(
        tmp_path, PKG=pkg, OUT=str(out), INIT_NPZ=str(tmp_path / "init.npz"),
        MXNET_KVSTORE_BIGARRAY_BOUND="64",
        MXTPU_PS_ASYNC="0" if pkg == "mxnet_tpu" else "1"))
    w = [dict(np.load(out / f"w{r}.npz")) for r in range(2)]
    return w, log


def test_module_fit_dist_sync_matches_jax_under_both_launchers(tmp_path):
    rs = np.random.RandomState(0)
    np.savez(tmp_path / "init.npz",
             fc1_weight=rs.normal(0, .3, (16, 8)).astype(F32),
             fc1_bias=np.zeros(16, F32),
             fc2_weight=rs.normal(0, .3, (5, 16)).astype(F32),
             fc2_bias=np.zeros(5, F32))
    jw, _ = _mlp_fit(tmp_path, "mxnet_tpu", "jax")
    tw, tlog = _mlp_fit(tmp_path, "mxnet_tpu_torch", "port")
    tw2, _ = _mlp_fit(tmp_path, "mxnet_tpu_torch", "jax")
    servers = [json.loads(line.split(" ", 1)[1]) for line in
               tlog.splitlines() if line.startswith("kvstore_server ")]
    assert len(servers) == 2 and not any(s["cuda_initialized"]
                                         for s in servers)
    # fc1_weight (128 elements) is split over both servers at bound 64
    assert all(s["updates"] > 0 for s in servers)
    init = np.load(tmp_path / "init.npz")
    for k in jw[0]:
        np.testing.assert_array_equal(tw[0][k], tw[1][k])
        np.testing.assert_array_equal(jw[0][k], jw[1][k])
        np.testing.assert_array_equal(tw2[0][k], tw[0][k])
        np.testing.assert_allclose(tw[0][k], jw[0][k], rtol=1e-5, atol=1e-5)
        assert not np.array_equal(tw[0][k], init[k])


CRASH_WORKER = textwrap.dedent("""
    import os, json
    rank = int(os.environ.get("MXTPU_RANK", "-1"))    # servers have none
    recovered = os.environ.get("MXTPU_KV_RECOVERY") == "1"
    if rank == 1 and not recovered:
        # the first life dies at the coordinator poll of batch 3
        os.environ["MXTPU_FAULT_PLAN"] = "host_crash:crash_after:2"
    import time
    import numpy as np
    import mxnet_tpu_torch as mx
    OUT = os.environ["OUT"]
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=4, name="fc"), name="softmax")
    rs = np.random.RandomState(rank)
    X = rs.uniform(-1, 1, (48, 6)).astype(np.float32)
    Y = rs.randint(0, 4, 48).astype(np.float32)
    mod = mx.mod.Module(net, context=mx.cpu())
    it = mx.io.NDArrayIter(X, Y, batch_size=8)
    seen = {"dead": 0}
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.init.Uniform(0.5))
    local_init = mod.get_params()[0]["fc_weight"].asnumpy().copy()
    mod.init_optimizer(kvstore="dist_async", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    pulled = mod.get_params()[0]["fc_weight"].asnumpy()
    if rank == 0:
        np.save(os.path.join(OUT, "init0.npy"), pulled)
    mod.fit(it, num_epoch=1)
    kv = mod._kvstore
    if rank == 0:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not seen["dead"]:
            seen["dead"] = kv.get_num_dead_node(0, timeout=1.0)
            time.sleep(0.1)
    kv.barrier()
    with open(os.path.join(OUT, "r%d.json" % rank), "w") as f:
        json.dump({"recovered": recovered, "dead_seen": seen["dead"],
                   "local_init": local_init.tolist(),
                   "pulled": pulled.tolist()}, f)
""")


def test_dist_async_worker_crash_restarts_without_reinit(tmp_path):
    from mxnet_tpu_torch.parallel.coordinator import CoordinatorService

    svc = CoordinatorService(port=0, lease_s=120.0).start()
    try:
        script = tmp_path / "crash_worker.py"
        script.write_text(CRASH_WORKER)
        log = _launch("port", script, 2, 1, _env(
            tmp_path, OUT=str(tmp_path), MXTPU_COORD_ADDR=svc.address,
            MXTPU_PS_HEARTBEAT_S="0.2"), extra=("--max-restarts", "1"))
    finally:
        svc.stop()
    assert "worker 1 exited with code 137" in log
    assert "MXTPU_KV_RECOVERY=1" in log
    r0 = json.loads((tmp_path / "r0.json").read_text())
    r1 = json.loads((tmp_path / "r1.json").read_text())
    assert r0["dead_seen"] >= 1 and not r0["recovered"]
    assert r1["recovered"]
    init0 = np.load(tmp_path / "init0.npy")
    pulled = np.asarray(r1["pulled"], F32)
    # the restarted worker took the servers' trained model: neither its
    # own random init nor the model the servers started from
    assert not np.array_equal(pulled, np.asarray(r1["local_init"], F32))
    assert not np.array_equal(pulled, init0)
