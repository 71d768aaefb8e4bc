"""The port's serving fleet on the CPU: ``ReplicaRouter`` and
``start_router`` over the port's replicas (the cases of
``tests/test_serving_fleet.py:108-498`` the port can run), the serve CLI
``python -m mxnet_tpu_torch.serving`` as a subprocess replica (SIGKILL
through the ``replica_kill`` fault site, SIGTERM drains), and the
``pagewalk``/``pallas`` modes of ``MXTPU_PAGED_KERNEL``.

Answers relayed through the router are held against the JAX decoder's
greedy tokens on the same numpy-seeded checkpoint (2 layers, 2 heads,
d_model 32, vocab 17, max_len 32; the subprocess replicas serve the
CLI's demo LM, held against the JAX package's demo weights).  Every
HTTP server binds port 0 and is shut down in ``finally``; every router
scrape thread is stopped.
"""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.models.decode import KVDecoder as JaxDecoder

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import telemetry as tm
from mxnet_tpu_torch.models.decode import KVDecoder
from mxnet_tpu_torch.serving import (
    NoReplicaAvailable, ReplicaDied, ReplicaRouter, ReplicaTimeout,
    RouterRetriesExhausted, SlotScheduler, register_replica,
    serve_decoder, start_router)
from mxnet_tpu_torch.serving import __main__ as serve_cli
from mxnet_tpu_torch.serving.paged_kv import PagedSlots

L, H, D, T, V = 2, 2, 32, 32, 17
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_MODEL = ["--num-layers", "1", "--num-heads", "1", "--d-model", "16",
             "--vocab-size", "32", "--max-len", "32"]


def _params():
    net = jmodels.transformer.transformer_lm(
        num_layers=L, num_heads=H, d_model=D, seq_len=T, vocab_size=V)
    ex = net.simple_bind(ctx=jmx.cpu(), grad_req="null",
                         data=(1, T), softmax_label=(1, T))
    rs = np.random.RandomState(0)
    return {name: rs.normal(0, 0.08, arr.shape).astype(np.float32)
            for name, arr in ex.arg_dict.items()
            if name not in ("data", "softmax_label")}


@pytest.fixture(scope="module")
def decs():
    p = _params()
    return (JaxDecoder(p, num_layers=L, num_heads=H, max_len=T),
            KVDecoder(p, num_layers=L, num_heads=H, max_len=T,
                      device="cpu"))


@pytest.fixture()
def metrics():
    was = tm.enabled()
    tm.enable()
    yield tm.get_registry()
    tm.enable(was)


def _post(port, body, path="/generate", timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def _fleet(dec, n=2, **kw):
    """n in-process replicas + a started router; see _teardown."""
    servers, scheds = [], []
    for _ in range(n):
        s, sch = serve_decoder(dec, port=0, num_slots=2, queue_size=16)
        servers.append(s)
        scheds.append(sch)
    addrs = ["127.0.0.1:%d" % s.server_address[1] for s in servers]
    kw.setdefault("scrape_s", 0.1)
    router = ReplicaRouter(replicas=addrs, **kw)
    rsrv = start_router(router, port=0)
    return servers, scheds, addrs, router, rsrv


def _teardown(servers, scheds, router, rsrv):
    if rsrv is not None:
        rsrv.shutdown()
        rsrv.server_close()
    router.stop()
    for s in servers:
        s.shutdown()
        s.server_close()
    for sch in scheds:
        sch.close()


def _stub_replica(post_handler):
    """A bare HTTP server whose POST /generate is ``post_handler``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _H(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0") or 0)
            self.rfile.read(n)
            post_handler(self)

        def log_message(self, *args):
            pass

    class _S(ThreadingHTTPServer):
        daemon_threads = True

    srv = _S(("127.0.0.1", 0), _H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, "127.0.0.1:%d" % srv.server_address[1]


def _routable(router, addr):
    router._replicas[addr].update(
        ok=True, health={"slots": 2, "occupied": 0, "queue_depth": 0,
                         "queue_size": 4})


# ------------------------------------------------------------ router core
def test_router_relays_and_balances(decs, metrics):
    """Requests through the router equal the JAX decoder's greedy tokens,
    the answering replica is named, load spreads over both replicas, and
    the router families and the federated ``/fleet`` view are live."""
    jd, td = decs
    servers, scheds, addrs, router, rsrv = _fleet(td)
    rport = rsrv.server_address[1]
    try:
        rs = np.random.RandomState(1)
        used = set()
        for i in range(8):
            prompt = rs.randint(0, V, 4 + i % 5).tolist()
            st, out, hdr = _post(rport, {"prompt": prompt,
                                         "max_tokens": 5})
            assert st == 200 and out["outcome"] == "ok"
            ref = jd.generate(np.array(prompt)[None], 5, temperature=0)
            assert out["tokens"] == ref[0].tolist()
            used.add(hdr.get("X-MXTPU-Replica"))
        assert used <= set(addrs)
        # least-loaded: a busier replica in the cache loses the pick
        router.stop()
        for busy, idle in (addrs, addrs[::-1]):
            router._replicas[busy]["health"]["occupied"] = 1
            router._replicas[idle]["health"]["occupied"] = 0
            assert router.pick() == idle
        router.start()
        hz = _get(rport, "/healthz")
        assert hz["status"] == "ok" and hz["healthy"] == 2
        assert hz["role"] == "router" and set(hz["replicas"]) == set(addrs)
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{rport}/metrics", timeout=30).read().decode()
        for fam in ("router_requests_total", "router_replicas",
                    "router_request_seconds"):
            assert fam in text
        fl = _get(rport, "/fleet")
        assert fl["healthy"] == 2 and len(fl["replicas"]) == 2
        labels = {s["labels"].get("host")
                  for s in fl["metrics"]["serve_requests_total"]["samples"]}
        assert labels and labels <= set(addrs)
    finally:
        _teardown(servers, scheds, router, rsrv)


def test_router_retries_connect_failures(decs, metrics):
    """A replica that looks healthy in the cache but is gone re-routes:
    the request succeeds on the next replica, the retry counts with
    reason=connect, and the dead row is marked."""
    _, td = decs
    server, sched = serve_decoder(td, port=0, num_slots=2, queue_size=8)
    live = "127.0.0.1:%d" % server.server_address[1]
    dead = "127.0.0.1:1"
    router = ReplicaRouter(replicas=[dead, live], scrape_s=30, retries=2)
    try:
        router.scrape_once()
        retr = metrics.get("router_retries_total")
        r0 = retr.value(reason="connect")
        router._replicas[dead].update(
            ok=True, health={"slots": 8, "occupied": 0,
                             "queue_depth": 0, "queue_size": 16})
        status, data, addr = router.route_generate(
            json.dumps({"prompt": [1, 2, 3], "max_tokens": 3}).encode())
        assert status == 200 and addr == live
        assert json.loads(data)["outcome"] == "ok"
        assert retr.value(reason="connect") - r0 >= 1
        assert router.replicas()[dead]["ok"] is False
    finally:
        _teardown([server], [sched], router, None)


def test_router_all_draining_returns_503(decs):
    _, td = decs
    servers, scheds, addrs, router, rsrv = _fleet(td)
    rport = rsrv.server_address[1]
    try:
        st, out, _ = _post(rport, {}, path="/admin/drain")
        assert st == 200 and set(out["replicas"]) == set(addrs)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(rport, {"prompt": [1], "max_tokens": 2})
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After")
        st, out, _ = _post(rport, {}, path="/admin/undrain")
        assert st == 200
        router.scrape_once()
        st, out, _ = _post(rport, {"prompt": [1], "max_tokens": 2})
        assert st == 200 and out["outcome"] == "ok"
    finally:
        _teardown(servers, scheds, router, rsrv)


def test_router_exhaustion_is_named():
    router = ReplicaRouter(replicas=["127.0.0.1:1"], scrape_s=30,
                           retries=1)
    _routable(router, "127.0.0.1:1")
    with pytest.raises(RouterRetriesExhausted, match="127.0.0.1:1"):
        router.route_generate(b'{"prompt": [1]}')
    with pytest.raises(NoReplicaAvailable):
        router.route_generate(b'{"prompt": [1]}')


def test_router_all_shed_keeps_backpressure_503():
    def shed(h):
        h.send_response(429)
        h.send_header("Content-Length", "0")
        h.end_headers()

    srvs, addrs = zip(*(_stub_replica(shed) for _ in range(2)))
    try:
        router = ReplicaRouter(replicas=list(addrs), scrape_s=30,
                               retries=2)
        for a in addrs:
            _routable(router, a)
        with pytest.raises(NoReplicaAvailable, match="429/503"):
            router.route_generate(b'{"prompt": [1]}')
        assert all(r["ok"] for r in router.replicas().values())
    finally:
        for s in srvs:
            s.shutdown()
            s.server_close()


def test_router_slow_replica_is_timeout_not_dead():
    release = threading.Event()

    def slow(h):
        release.wait(10)
        h.send_response(200)
        h.send_header("Content-Length", "0")
        h.end_headers()

    srv, addr = _stub_replica(slow)
    try:
        router = ReplicaRouter(replicas=[addr], scrape_s=30, retries=1,
                               generate_timeout_s=0.3)
        _routable(router, addr)
        with pytest.raises(ReplicaTimeout, match="did not answer"):
            router.route_generate(b'{"prompt": [1]}')
        assert router.replicas()[addr]["ok"]
    finally:
        release.set()
        srv.shutdown()
        srv.server_close()


def test_rolling_upgrade_under_live_traffic(decs, metrics):
    """Drain each replica, wait drained, undrain — under 4 clients'
    continuous traffic, with no failed request."""
    _, td = decs
    servers, scheds, addrs, router, rsrv = _fleet(td)
    rport = rsrv.server_address[1]
    stop = threading.Event()
    results, errors = [], []

    def client(i):
        r2 = np.random.RandomState(100 + i)
        while not stop.is_set():
            try:
                st, out, _ = _post(rport, {
                    "prompt": r2.randint(0, V, 1 + i % 6).tolist(),
                    "max_tokens": 4})
                results.append((st, out["outcome"]))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)
                return

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while not results and time.monotonic() < deadline:
            time.sleep(0.01)
        upgraded = router.rolling_upgrade(drain_timeout=60)
        stop.set()
        for t in threads:
            t.join(120)
        assert [u["replica"] for u in upgraded] == sorted(addrs)
        assert not errors, errors[:3]
        assert results and all(r == (200, "ok") for r in results)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        _teardown(servers, scheds, router, rsrv)


def _closed_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens here
    return port


def test_coordinator_registration_is_refused(monkeypatch):
    """Registration with a coordinator nobody runs is refused by name
    (the JAX package's HostLostError, site "coordinator"); without any
    address it names the missing address; a router with neither replicas
    nor a coordinator still refuses."""
    from mxnet_tpu_torch.parallel.dist import HostLostError

    dead = f"127.0.0.1:{_closed_port()}"
    with pytest.raises(HostLostError, match=dead) as ei:
        register_replica("127.0.0.1:1", coordinator=dead)
    assert ei.value.site == "coordinator" and ei.value.host == dead
    monkeypatch.delenv("MXTPU_COORD_ADDR", raising=False)
    with pytest.raises(MXNetError, match="no coordinator address"):
        register_replica("127.0.0.1:1")
    with pytest.raises(MXNetError, match="needs replicas"):
        ReplicaRouter(replicas=[])


def test_register_replica_through_port_coordinator(decs):
    """A replica joins the port's coordinator with role "serve"; a router
    given only the coordinator finds it in /cluster, routes to it, and
    drops it once it leaves (the JAX package's registry, copied)."""
    from mxnet_tpu_torch.parallel.coordinator import CoordinatorService

    svc = CoordinatorService(port=0, lease_s=5.0).start()
    srv, sch = serve_decoder(decs[1], port=0, num_slots=2, queue_size=4)
    addr = "127.0.0.1:%d" % srv.server_address[1]
    router = rsrv = client = None
    try:
        client = register_replica(addr, coordinator=svc.address)
        member = svc.cluster()["members"][client.member]
        assert member["role"] == "serve" and member["telemetry"] == addr
        assert member["rank"] == -1
        router = ReplicaRouter(coordinator=svc.address, scrape_s=0.1)
        rows = router.scrape_once()
        assert set(rows) == {addr}
        assert rows[addr]["source"] == "coordinator" and rows[addr]["ok"]
        rsrv = start_router(router, port=0)
        status, body, _ = _post(rsrv.server_address[1],
                                {"prompt": [1, 2, 3], "max_tokens": 4})
        assert status == 200 and len(body["tokens"]) == 4
        client.leave(why="drained")
        client = None
        assert router.scrape_once() == {}
    finally:
        if client is not None:
            client.stop()
        if rsrv is not None:
            rsrv.shutdown()
            rsrv.server_close()
        if router is not None:
            router.stop()
        srv.shutdown()
        srv.server_close()
        sch.close()
        svc.stop()


def test_router_knobs_read_the_jax_names(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_REPLICAS", "h1:1, h2:2")
    monkeypatch.setenv("MXTPU_ROUTER_SCRAPE_S", "0.25")
    monkeypatch.setenv("MXTPU_ROUTER_RETRIES", "5")
    r = ReplicaRouter()
    assert sorted(r.replicas()) == ["h1:1", "h2:2"]
    assert r.scrape_s == 0.25 and r.retries == 5


# ---------------------------------------------------- subprocess replicas
def _spawn_replica(extra_env=None, extra_flags=()):
    env = dict(os.environ)
    env.pop("MXTPU_TELEMETRY_HTTP_PORT", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.update(extra_env or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serving", "--demo",
         "--device", "cpu", "--port", "0", *CLI_MODEL, *extra_flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env)
    addr, lines = None, []
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        m = re.search(r"serving on http://([0-9.]+:[0-9]+)", line)
        if m:
            addr = m.group(1)
            break
    if addr is None:
        proc.kill()
        proc.wait(30)
        raise AssertionError("replica never came up:\n" + "".join(lines))
    threading.Thread(target=lambda f=proc.stdout: [None for _ in f],
                     daemon=True).start()
    return proc, addr


def _demo_reference(prompt, n):
    """The JAX decoder over the CLI's demo weights (the JAX
    ``tools/serve.py --demo`` recipe, same flags)."""
    net = jmodels.transformer.transformer_lm(
        num_layers=1, num_heads=1, d_model=16, seq_len=32, vocab_size=32)
    ex = net.simple_bind(ctx=jmx.cpu(), grad_req="null", data=(1, 32),
                         softmax_label=(1, 32))
    rs = np.random.RandomState(0)
    params = {}
    for name, arr in ex.arg_dict.items():
        if name in ("data", "softmax_label"):
            continue
        params[name] = rs.normal(0, 0.08, arr.shape).astype(np.float32)
    dec = JaxDecoder(params, num_layers=1, num_heads=1, max_len=32)
    return dec.generate(np.array(prompt)[None], n, temperature=0)[0]


def test_router_survives_replica_sigkill_mid_request(decs, metrics):
    """``replica_kill:crash_after:3`` kills the subprocess replica
    mid-decode: the in-flight request gets the named 502, the process
    exits 137, new work re-routes to the survivor, and the registry
    names the dead replica dead."""
    _, td = decs
    proc, faulty = _spawn_replica(
        extra_env={"MXTPU_FAULT_PLAN": "replica_kill:crash_after:3"})
    server, sched = serve_decoder(td, port=0, num_slots=2, queue_size=8)
    live = "127.0.0.1:%d" % server.server_address[1]
    router = ReplicaRouter(replicas=[faulty, live], scrape_s=0.1, retries=2)
    rsrv = start_router(router, port=0)
    rport = rsrv.server_address[1]
    try:
        router.drain(live)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(rport, {"prompt": [1, 2, 3], "max_tokens": 20})
        assert ei.value.code == 502
        body = json.loads(ei.value.read())
        assert body["router_error"] == ReplicaDied.__name__
        assert faulty in body["error"]
        assert proc.wait(timeout=60) == 137
        router.undrain(live)
        router.scrape_once()
        st, out, hdr = _post(rport, {"prompt": [4, 5], "max_tokens": 3})
        assert st == 200 and out["outcome"] == "ok"
        assert hdr.get("X-MXTPU-Replica") == live
        rows = router.replicas()
        assert rows[faulty]["ok"] is False and rows[live]["ok"] is True
        assert _get(rport, "/healthz")["healthy"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        _teardown([server], [sched], router, rsrv)


def test_serve_cli_sigterm_drains_then_exits():
    """SIGTERM on the port's serve CLI finishes the in-flight request
    (24 tokens, the whole budget) and exits 0; its tokens are the JAX
    demo replica's."""
    proc, addr = _spawn_replica()
    port = int(addr.rsplit(":", 1)[1])
    result = {}

    def client():
        try:
            result["resp"] = _post(port, {"prompt": [1, 2],
                                          "max_tokens": 24})
        except Exception as exc:  # noqa: BLE001
            result["error"] = exc

    t = threading.Thread(target=client)
    try:
        t.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                if _get(port, "/healthz", timeout=10)["occupied"] > 0:
                    break
            except OSError:
                pass
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        t.join(120)
        assert proc.wait(timeout=120) == 0
        assert "error" not in result, result.get("error")
        st, out, _ = result["resp"]
        assert st == 200 and out["outcome"] == "ok"
        assert out["n_tokens"] == 24
        assert out["tokens"] == _demo_reference([1, 2], 24).tolist()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        t.join(30)


def test_serve_cli_demo_params_are_the_jax_demo():
    p = serve_cli.demo_params(1, 1, 16, 32, 32)
    net = jmodels.transformer.transformer_lm(
        num_layers=1, num_heads=1, d_model=16, seq_len=32, vocab_size=32)
    ex = net.simple_bind(ctx=jmx.cpu(), grad_req="null", data=(1, 32),
                         softmax_label=(1, 32))
    names = [n for n in ex.arg_dict if n not in ("data", "softmax_label")]
    assert list(p) == names


def test_serve_cli_refuses_the_coordinator(monkeypatch):
    """``--coord``/``--register`` are the JAX CLI's flags: a replica
    told of a coordinator nobody runs stops with the named error (its
    server shut down), and a router with neither replicas nor a
    coordinator refuses."""
    from mxnet_tpu_torch.parallel.dist import HostLostError

    dead = f"127.0.0.1:{_closed_port()}"
    monkeypatch.setattr(serve_cli, "_arm_sigterm", threading.Event)
    with pytest.raises(HostLostError, match=dead):
        serve_cli.main(CLI_MODEL + ["--demo", "--device", "cpu", "--coord",
                                    dead, "--port", "0"])
    monkeypatch.delenv("MXTPU_SERVE_REPLICAS", raising=False)
    with pytest.raises(MXNetError, match="needs replicas"):
        serve_cli.main(["--router", "--register"])
    args = serve_cli._parse_args([])
    assert args.device == "cuda" and args.coord is None


# --------------------------------------------------- MXTPU_PAGED_KERNEL
def test_pagewalk_mode_matches_gather_and_jax(decs):
    """``pagewalk`` walks only live pages and gives the gather path's
    tokens, which are the JAX decoder's."""
    jd, td = decs
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, V, n) for n in (3, 9, 12)]
    runs = {}
    for mode in ("gather", "pagewalk"):
        sched = SlotScheduler(td, num_slots=2, queue_size=8, paged=True,
                              kv_block=8, paged_kernel=mode)
        try:
            assert sched.backend.kernel == mode
            reqs = [sched.submit(p, max_new_tokens=6) for p in prompts]
            runs[mode] = [list(map(int, r.wait(120).tokens)) for r in reqs]
        finally:
            sched.close()
    assert runs["pagewalk"] == runs["gather"]
    for p, got in zip(prompts, runs["pagewalk"]):
        assert got == jd.generate(p[None], 6, temperature=0)[0].tolist()


def test_pagewalk_attention_reads_only_live_pages(decs):
    """A page past every cursor may hold anything: the walk never reads
    it, and the gather path masks it to an exact zero weight."""
    import torch

    from mxnet_tpu_torch.ops import paged_attention as pa

    _, td = decs
    pg = PagedSlots(td, 2, block=8, prefill_buckets=(8, 16),
                    kernel="pagewalk")
    pg.admit(0, np.arange(1, 6))
    q = torch.randn(2, H, 1, D // H)
    bt = torch.as_tensor(pg.bt)
    cur = torch.as_tensor(pg.cursor)
    ref = pa._gather_attention(q, pg.pool[0], pg.pool[1], bt, cur, 0, 8)
    junk = [t.clone() for t in pg.pool]
    for t in junk:
        t[2:] = float("nan")          # pages nothing has reached
    got = pa._pagewalk_attention(q, junk[0], junk[1], bt, cur, 0, 8, 1)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_pallas_mode_forces_the_kernel(decs, monkeypatch):
    """``pallas`` is the kernel or an error: on a CPU pool it raises; on
    a (faked) CUDA pool whose shape the kernel refuses it names the
    limit instead of switching to gather, where ``auto`` would too."""
    import torch

    _, td = decs
    with pytest.raises(MXNetError, match="needs a CUDA pool"):
        PagedSlots(td, 2, block=8, prefill_buckets=(8,), kernel="pallas")
    monkeypatch.setenv("MXTPU_PAGED_KERNEL", "pallas")
    with pytest.raises(MXNetError, match="needs a CUDA pool"):
        SlotScheduler(td, num_slots=2, paged=True, kv_block=8)
    monkeypatch.delenv("MXTPU_PAGED_KERNEL")
    monkeypatch.setattr(td, "device", torch.device("cuda"))
    pg = PagedSlots.__new__(PagedSlots)
    pg.decoder, pg.block, pg.max_blocks = td, 4, 8
    pg.kernel_mode = "pallas"
    with pytest.raises(MXNetError, match="block=4"):
        pg._resolve_schedule()
    pg.block = 8
    assert pg._resolve_schedule()["impl"] == "cuda"
    pg.kernel_mode = "bogus"
    with pytest.raises(MXNetError, match="unknown MXTPU_PAGED_KERNEL"):
        pg._resolve_schedule()
