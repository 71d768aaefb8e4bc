"""The port's coordinator (``mxnet_tpu_torch.parallel.coordinator``):
``tests/test_coordinator.py``'s ten cases on the port's modules, the
fleet plane (``/fleet`` over the members' ``/metrics.json``, the
step-time skew and the straggler it names), the clock offset the
heartbeats record, and the wire format shared with the JAX package: a
JAX ``CoordinatorClient`` joins the port's service and a port client
joins the JAX service, and both ``/cluster`` documents hold the same
keys.  Leases are short (0.5 s) so deaths show within seconds.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
import urllib.request

import pytest

from mxnet_tpu.parallel import coordinator as jcoord

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults
from mxnet_tpu_torch import telemetry as tm
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.parallel.coordinator import (CoordinatorClient,
                                                  CoordinatorService)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def service():
    svc = CoordinatorService(port=0, lease_s=0.5).start()
    yield svc
    svc.stop()


@pytest.fixture
def telemetry_on():
    was = tm.enabled()
    tm.enable()
    yield
    tm.enable(was)


def _closed_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_join_heartbeat_cluster_roundtrip(service):
    c0 = CoordinatorClient(service.address, member="h0", rank=0)
    c1 = CoordinatorClient(service.address, member="h1", rank=1)
    try:
        status = c0.cluster()
        assert status["generation"] == 0
        assert status["hosts_alive"] == 2
        assert set(status["members"]) == {"h0", "h1"}
        assert status["members"]["h1"]["rank"] == 1
        assert not c0.step_poll() and not c1.step_poll()
        with urllib.request.urlopen(
                f"http://{service.address}/cluster", timeout=5) as resp:
            raw = json.loads(resp.read())
        assert raw["hosts_alive"] == 2
    finally:
        c0.stop()
        c1.stop()


def test_lease_expiry_declares_death_and_bumps_generation(service,
                                                          telemetry_on):
    c0 = CoordinatorClient(service.address, member="h0", rank=0)
    c1 = CoordinatorClient(service.address, member="h1", rank=1)
    try:
        c1.stop()  # heartbeats stop; the lease lapses
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not c0.changed():
            time.sleep(0.1)
        assert c0.changed(), "survivor never saw the generation bump"
        status = c0.cluster()
        assert status["generation"] == 1
        assert status["hosts_alive"] == 1
        assert [d["member"] for d in status["dead"]] == ["h1"]
        with pytest.raises(dist.GenerationChanged) as ei:
            c0.raise_generation_changed("/tmp/ck-42")
        assert ei.value.generation == 1
        assert "ck-42" in str(ei.value)
        assert isinstance(ei.value, dist.HostLostError)
    finally:
        c0.stop()


def test_generation_bump_under_heartbeat_fault_injection(service,
                                                         monkeypatch,
                                                         telemetry_on):
    """``coord_heartbeat`` drops starve the lease and the service
    publishes the next generation (the plan drops every heartbeat of
    this process, so the service side is read)."""
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "coord_heartbeat:drop:1")
    faults.reset()
    c1 = None
    try:
        c1 = CoordinatorClient(service.address, member="h1", rank=1)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and service.generation == 0:
            time.sleep(0.1)
        assert service.generation == 1, \
            "dropped heartbeats never expired the lease"
        status = service.cluster()
        assert [d["member"] for d in status["dead"]] == ["h1"]
        assert status["hosts_alive"] == 0
    finally:
        monkeypatch.delenv("MXTPU_FAULT_PLAN")
        faults.reset()
        if c1 is not None:
            c1.stop()


def test_standby_rejoin_announcement_bumps(service):
    c0 = CoordinatorClient(service.address, member="h0", rank=0)
    try:
        gen0 = service.generation
        rejoiner = CoordinatorClient(service.address, member="h1-reborn",
                                     rank=1, standby=True)
        status = c0.cluster()
        assert status["generation"] == gen0 + 1
        assert status["standby"] == ["h1-reborn"]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not c0.changed():
            time.sleep(0.05)
        assert c0.changed()
        rejoiner.stop()
    finally:
        c0.stop()


def test_clean_leave_bumps_only_with_survivors(service):
    c0 = CoordinatorClient(service.address, member="h0", rank=0)
    c1 = CoordinatorClient(service.address, member="h1", rank=1)
    gen0 = service.generation
    c1.leave()
    assert service.generation == gen0 + 1  # the survivor must react
    c0.leave()
    assert service.generation == gen0 + 1  # an empty cluster: nobody


def test_host_crash_fault_site_fires_from_step_poll(service, monkeypatch):
    c0 = CoordinatorClient(service.address, member="h0", rank=0)
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "host_crash:err:1")
    faults.reset()
    try:
        with pytest.raises(faults.InjectedFault, match="host_crash"):
            c0.step_poll()
    finally:
        monkeypatch.delenv("MXTPU_FAULT_PLAN")
        faults.reset()
        c0.stop()


def test_unreachable_coordinator_is_named_not_hung():
    addr = f"127.0.0.1:{_closed_port()}"
    t0 = time.monotonic()
    with pytest.raises(dist.HostLostError) as ei:
        CoordinatorClient(addr, member="h0", rank=0)
    assert time.monotonic() - t0 < 30
    assert ei.value.site == "coordinator"
    assert ei.value.host == addr


def test_healthz_surfaces_cluster_gauges(service, telemetry_on,
                                         monkeypatch):
    """``/healthz`` answers with the dead-worker count and the
    generation without a full exposition render."""
    monkeypatch.delenv("MXTPU_PS_SERVERS", raising=False)
    monkeypatch.delenv("MXTPU_NUM_WORKERS", raising=False)
    kv = mx.kv.create("dist_sync")          # one process, no coordinator
    assert kv.get_num_dead_node(0) == 0     # sets kvstore_dead_workers
    svc = CoordinatorService(port=0, lease_s=5.0).start()  # sets the gen
    srv = tm.start_http_server(0)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
            payload = json.loads(resp.read())
        assert payload["status"] == "ok"
        assert payload["kvstore_dead_workers"] == 0
        assert "dist_generation" in payload
        assert "dist_hosts_alive" in payload
    finally:
        srv.shutdown()
        svc.stop()


def test_maybe_start_from_env(monkeypatch):
    from mxnet_tpu_torch.parallel import coordinator

    port = _closed_port()
    monkeypatch.setenv("MXTPU_COORD_PORT", str(port))
    monkeypatch.setenv("MXTPU_RANK", "1")
    assert coordinator.maybe_start_from_env() is None  # rank 1 never hosts
    monkeypatch.setenv("MXTPU_RANK", "0")
    svc = coordinator.maybe_start_from_env()
    try:
        assert svc is not None and svc.port == port
    finally:
        svc.stop()


WEDGE_WATCHDOG = textwrap.dedent("""
    import os, sys, time
    os.environ["MXTPU_DIST_BARRIER_TIMEOUT_S"] = "0.5"
    os.environ["MXTPU_COORD_LEASE_S"] = "0.4"
    from mxnet_tpu_torch.parallel.coordinator import (CoordinatorClient,
                                                      CoordinatorService)
    svc = CoordinatorService(port=0, lease_s=0.4).start()
    me = CoordinatorClient(svc.address, member="h0", rank=0)
    other = CoordinatorClient(svc.address, member="h1", rank=1)
    me.step_poll()            # the loop is live
    other.stop()              # the peer dies; its lease lapses
    print("wedging", flush=True)
    time.sleep(30)            # a wedged collective: never polls again
    print("WATCHDOG FAILED TO FIRE", flush=True)
    sys.exit(7)
""")


def test_wedge_watchdog_exits_host_lost():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", WEDGE_WATCHDOG], env=env,
                          timeout=120, capture_output=True, text=True)
    assert proc.returncode == dist.EXIT_HOST_LOST, (
        proc.returncode, proc.stdout, proc.stderr)
    assert "WATCHDOG FAILED" not in proc.stdout
    assert time.monotonic() - t0 < 60


# --------------------------------------------- fleet and clock offset
def test_fleet_federates_members_and_names_the_straggler(telemetry_on):
    """Two members advertise their /metrics endpoints; ``/fleet`` merges
    both, host-labeled.  Heartbeat step times 4x apart make the slow
    member the named straggler with its skew ratio published."""
    from mxnet_tpu_torch.telemetry import fleet

    # a long lease: the members' own heartbeats (every lease/3) must not
    # replace the step times this test feeds
    svc = CoordinatorService(port=0, lease_s=30.0).start()
    servers = [tm.start_http_server(0) for _ in range(2)]
    addrs = ["127.0.0.1:%d" % s.server_address[1] for s in servers]
    clients = []
    try:
        for i, a in enumerate(addrs):
            clients.append(CoordinatorClient(svc.address, member=f"h{i}",
                                             rank=i, telemetry_addr=a))
        for i, c in enumerate(clients):
            svc.heartbeat(c.member, steps={"count": 8,
                                           "step_wall_s": 0.1 * (1 + 3 * i)})
        for _ in range(fleet.STRAGGLER_SUSTAIN):
            strag = svc.eval_straggler()
        assert strag["member"] == "h1" and strag["ratio"] == 4.0
        svc.scraper.scrape_once()
        fl = svc.fleet()
        assert set(fl["hosts"]) == {"h0", "h1"}
        assert all(r["scrape_ok"] for r in fl["hosts"].values())
        assert fl["straggler"]["member"] == "h1"
        assert fl["step_skew_ratio"] == 4.0
        hosts = {s["labels"].get("host")
                 for s in fl["metrics"]["dist_step_skew_ratio"]["samples"]}
        assert hosts == {"h0", "h1"}
    finally:
        for c in clients:
            c.stop()
        for s in servers:
            s.shutdown()
        svc.stop()


def test_heartbeats_record_the_clock_offset(service):
    """Each heartbeat reply carries the service's clock; the client
    records the RTT-midpoint offset for the flight record."""
    tm.health.set_clock_offset(123.0, source="test")
    c0 = CoordinatorClient(service.address, member="h0", rank=0)
    try:
        deadline = time.monotonic() + 10
        while (time.monotonic() < deadline
               and tm.health.clock_offset()["source"] != "coordinator"):
            time.sleep(0.05)
        off = tm.health.clock_offset()
        assert off["source"] == "coordinator" and abs(off["offset_s"]) < 1
        assert off["rtt_s"] is not None and off["rtt_s"] >= 0
    finally:
        c0.stop()


# ------------------------------------------- across the two packages
CLUSTER_KEYS = {"generation", "lease_s", "hosts_alive", "members",
                "standby", "dead", "straggler", "step_skew_ratio", "events",
                "uptime_s"}


def test_jax_client_joins_the_port_service_and_back():
    psvc = CoordinatorService(port=0, lease_s=0.5).start()
    jsvc = jcoord.CoordinatorService(port=0, lease_s=0.5).start()
    jc = tc = None
    try:
        jc = jcoord.CoordinatorClient(psvc.address, member="jax0", rank=0)
        tc = CoordinatorClient(jsvc.address, member="port0", rank=0)
        pst, jst = psvc.cluster(), jsvc.cluster()
        assert set(pst) == set(jst) == CLUSTER_KEYS
        assert set(pst["members"]) == {"jax0"}
        assert set(jst["members"]) == {"port0"}
        assert set(pst["members"]["jax0"]) == set(jst["members"]["port0"])
        assert not jc.step_poll() and not tc.step_poll()
        # a death on either side is the other package's generation bump
        jc.stop()
        tc.stop()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (psvc.generation == 0
                                               or jsvc.generation == 0):
            time.sleep(0.1)
        assert psvc.generation == jsvc.generation == 1
        assert [d["member"] for d in psvc.cluster()["dead"]] == ["jax0"]
        assert [d["member"] for d in jsvc.cluster()["dead"]] == ["port0"]
    finally:
        for c in (jc, tc):
            if c is not None:
                c.stop()
        psvc.stop()
        jsvc.stop()
