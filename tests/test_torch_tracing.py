"""The port's tracing + SLO plane and fleet plane on the CPU
(``tests/test_tracing.py:101-489`` mirrored): the W3C ``traceparent``
grammar (minted by the port, parsed by both packages), the bounded span
ring, SLO burn-rate math against the JAX package's ``SloPlane`` on the
same records, ``/slo``, one trace through a router retry joined with
``telemetry.fleet.fetch_spans``, TTFT from receipt, the derived
``Retry-After``, the ``serve_slow`` fault site, tracing bit-identical on
outputs, and ``merge_snapshots``/``FleetScraper`` against the reference.

Checkpoint: 2 layers, 2 heads, d_model 32, vocab 17, max_len 32 (the
reference fixtures), on the CPU.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.models.decode import KVDecoder as JaxDecoder
from mxnet_tpu.telemetry import fleet as jfleet
from mxnet_tpu.telemetry import tracing as jtracing

from mxnet_tpu_torch import faults
from mxnet_tpu_torch import telemetry as tm
from mxnet_tpu_torch.models.decode import KVDecoder
from mxnet_tpu_torch.serving import (ReplicaRouter, SlotScheduler,
                                     serve_decoder, start_router)
from mxnet_tpu_torch.telemetry import fleet, tracing

L, H, D, T, V = 2, 2, 32, 32, 17


@pytest.fixture(scope="module")
def decs():
    net = jmodels.transformer.transformer_lm(
        num_layers=L, num_heads=H, d_model=D, seq_len=T, vocab_size=V)
    ex = net.simple_bind(ctx=jmx.cpu(), grad_req="null",
                         data=(1, T), softmax_label=(1, T))
    rs = np.random.RandomState(0)
    p = {name: rs.normal(0, 0.08, arr.shape).astype(np.float32)
         for name, arr in ex.arg_dict.items()
         if name not in ("data", "softmax_label")}
    return (JaxDecoder(p, num_layers=L, num_heads=H, max_len=T),
            KVDecoder(p, num_layers=L, num_heads=H, max_len=T,
                      device="cpu"))


@pytest.fixture()
def metrics():
    was = tm.enabled()
    tm.enable()
    yield tm.get_registry()
    tm.enable(was)


@pytest.fixture(autouse=True)
def _tracing_off_after():
    was = tracing.trace_on()
    tracing.clear_spans()
    yield
    tracing.enable_tracing(was)
    tracing.clear_spans()


@pytest.fixture()
def traced(monkeypatch):
    """Tracing on, everything sampled, every tick recorded."""
    monkeypatch.setenv("MXTPU_TRACE_SAMPLE", "1")
    monkeypatch.setattr(tracing, "TICK_EVERY", 1)
    tracing.enable_tracing(True)
    yield


def _post(port, body, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def _stop(*servers):
    for s in servers:
        s.shutdown()
        s.server_close()


# --------------------------------------------------------- traceparent
def test_traceparent_mint_parse_roundtrip():
    tp = tracing.mint_traceparent(sampled=True)
    ctx = tracing.parse_traceparent(tp)
    assert ctx == jtracing.parse_traceparent(tp)
    assert len(ctx["trace"]) == 32 and len(ctx["parent"]) == 16
    assert ctx["sampled"] is True
    assert tracing.parse_traceparent(
        tracing.mint_traceparent(sampled=False))["sampled"] is False
    child = tracing.child_traceparent(ctx["trace"], True)
    cctx = tracing.parse_traceparent(child)
    assert cctx["trace"] == ctx["trace"] and cctx["parent"] != ctx["parent"]
    sid = tracing.mint_span_id()
    reused = tracing.parse_traceparent(
        tracing.child_traceparent(ctx["trace"], False, sid))
    assert reused["parent"] == sid and reused["sampled"] is False
    assert jtracing.child_traceparent(ctx["trace"], False, sid) == \
        tracing.child_traceparent(ctx["trace"], False, sid)


def test_mint_samples_by_the_knob(monkeypatch):
    tracing.enable_tracing(False)
    assert not tracing.parse_traceparent(tracing.mint_traceparent())[
        "sampled"]
    tracing.enable_tracing(True)
    for rate, want in (("0", False), ("1", True)):
        monkeypatch.setenv("MXTPU_TRACE_SAMPLE", rate)
        assert tracing.sample_rate() == jtracing.sample_rate()
        assert all(tracing.parse_traceparent(tracing.mint_traceparent())[
            "sampled"] is want for _ in range(20))


def test_traceparent_malformed_degrades_to_none():
    bad = [None, "", "garbage", "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
           "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
           "00-" + "a" * 32 + "-" + "b" * 15 + "-01",
           "00-" + "g" * 32 + "-" + "b" * 16 + "-01", 42]
    for header in bad:
        assert tracing.parse_traceparent(header) is None
    up = ("00-" + "A" * 32 + "-" + "B" * 16 + "-01").upper()
    assert tracing.parse_traceparent(up)["trace"] == "a" * 32


def test_span_ring_is_bounded(monkeypatch, metrics):
    monkeypatch.setenv("MXTPU_SPAN_RING", "16")
    for i in range(40):
        tracing.record_span("s%d" % i, "replica", "t" * 32, 0.001)
    got = tracing.spans()
    assert len(got) == 16 and got[-1]["name"] == "s39"
    assert len({s["sid"] for s in got}) == 16
    tracing.record_span("x", "router", "u" * 32, 0.0)
    assert [s["name"] for s in tracing.spans("u" * 32)] == ["x"]
    tracing.clear_spans()
    assert tracing.spans() == []


# ------------------------------------------------------------ SLO plane
@pytest.mark.parametrize("knobs", [{}, {"MXTPU_SLO_TTFT_MS": "100",
                                        "MXTPU_SLO_AVAIL": "0.9"}])
def test_slo_plane_burn_math_matches_jax(metrics, monkeypatch, knobs):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    assert (tracing.slo_ttft_ms(), tracing.slo_avail()) == \
        (jtracing.slo_ttft_ms(), jtracing.slo_avail())
    planes = (tracing.SloPlane(), jtracing.SloPlane())
    for plane in planes:
        for _ in range(8):
            plane.record(True, ttft_s=0.01)
        plane.record(False)
        plane.record(True, ttft_s=0.2, trace="e" * 32)
    snaps = [p.snapshot() for p in planes]
    for s in snaps:
        for ex in s["exemplars"]:
            ex.pop("t")
    assert snaps[0] == snaps[1]
    w = snaps[0]["windows"]["60s"]
    assert w["requests"] == 10
    assert w["bad_availability"] == 1
    if knobs:
        assert w["burn_rate"]["availability"] == pytest.approx(1.0)
        assert w["burn_rate"]["ttft"] == pytest.approx((1 / 9) / 0.1,
                                                       abs=1e-3)
    assert snaps[0]["exemplars"][0]["trace"] == "e" * 32


def test_slo_endpoint_and_metric_families(metrics):
    router = ReplicaRouter(replicas=["127.0.0.1:9"], scrape_s=30)
    rsrv = start_router(router, port=0)
    try:
        router.slo.record(True, ttft_s=0.001, trace="a" * 32)
        router.slo.record(False, trace="b" * 32)
        slo = _get(rsrv.server_address[1], "/slo")
        assert slo["objectives"]["availability"] == router.slo.avail
        assert slo["windows"]["5s"]["requests"] == 2
        assert slo["violations_total"]["availability"] == 1
        text = tm.generate_text(tm.get_registry())
        assert "slo_burn_rate" in text and "slo_violations_total" in text
        tracing.record_span("x", "router", "c" * 32, 0.0)
        assert "trace_spans_total" in tm.generate_text(tm.get_registry())
    finally:
        _stop(rsrv)
        router.stop()


# ------------------------------------------------- e2e through a retry
def _stub_shed_replica():
    """Healthy on /healthz, sheds every POST /generate with a 503."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _H(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps({"status": "ok", "slots": 2, "occupied": 0,
                               "queue_depth": 0, "queue_size": 16,
                               "ticks": 0}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0") or 0)
            self.rfile.read(n)
            self.send_response(503)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    class _S(ThreadingHTTPServer):
        daemon_threads = True

    srv = _S(("127.0.0.1", 0), _H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, "127.0.0.1:%d" % srv.server_address[1]


def test_e2e_trace_through_retry_joined_by_fetch_spans(decs, metrics,
                                                      traced):
    """One request bounces off a shedding replica and finishes on a real
    one: route, both attempts, queue wait, prefill, admit, decode ticks
    and the terminal span land under ONE trace id with router and
    replica lanes, parented as the reference parents them, and
    ``fleet.fetch_spans`` over the router and the replica joins them.
    The tokens are the JAX decoder's."""
    jd, td = decs
    stub, stub_addr = _stub_shed_replica()
    server, sched = serve_decoder(td, port=0, num_slots=2, queue_size=16)
    real_addr = "127.0.0.1:%d" % server.server_address[1]
    router = ReplicaRouter(replicas=[stub_addr, real_addr], scrape_s=0.1)
    rsrv = start_router(router, port=0)
    rport = rsrv.server_address[1]
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not all(
                r["ok"] for r in router.replicas().values()):
            time.sleep(0.02)
        st, out, hdr = _post(rport, {"prompt": [1, 2, 3], "max_tokens": 4})
        assert st == 200
        assert out["tokens"] == jd.generate(
            np.array([[1, 2, 3]]), 4, temperature=0)[0].tolist()
        tid = hdr["X-MXTPU-Trace"]
        assert len(tid) == 32 and out["trace"] == tid
        assert hdr["X-MXTPU-Replica"] == real_addr
        joined = {}
        for addr in ("127.0.0.1:%d" % rport, real_addr):
            payload = fleet.fetch_spans(addr, trace=tid)
            assert payload["trace_on"] is True and "offset_s" in \
                payload["clock"]
            joined.update((s["sid"], s) for s in payload["spans"])
        spans = list(joined.values())
        names = [s["name"] for s in spans]
        for need in ("route", "attempt", "queue_wait", "prefill", "admit",
                     "decode_tick", "request"):
            assert need in names, f"missing span {need!r} in {names}"
        attempts = [s for s in spans if s["name"] == "attempt"]
        assert sorted(str(a["status"]) for a in attempts) == ["200", "503"]
        assert {s["svc"] for s in spans} == {"router", "replica"}
        route = next(s for s in spans if s["name"] == "route")
        assert all(a["parent"] == route["sid"] for a in attempts)
        ok_att = next(a for a in attempts if str(a["status"]) == "200")
        qw = next(s for s in spans if s["name"] == "queue_wait")
        assert qw["parent"] == ok_att["sid"]
        starts = {s["name"]: s["t"] - s["dur_s"] for s in spans}
        assert starts["queue_wait"] <= starts["prefill"] \
            <= starts["decode_tick"]
    finally:
        _stop(rsrv, stub, server)
        router.stop()
        sched.close()


def test_tracing_off_records_nothing_and_spans_json(decs, metrics):
    _, td = decs
    tracing.enable_tracing(False)
    server, sched = serve_decoder(td, port=0, num_slots=2, queue_size=16)
    addr = "127.0.0.1:%d" % server.server_address[1]
    router = ReplicaRouter(replicas=[addr], scrape_s=0.1)
    rsrv = start_router(router, port=0)
    try:
        st, out, hdr = _post(rsrv.server_address[1],
                             {"prompt": [1, 2], "max_tokens": 3})
        assert st == 200 and len(hdr["X-MXTPU-Trace"]) == 32
        payload = _get(rsrv.server_address[1], "/spans.json")
        assert payload["trace_on"] is False and payload["spans"] == []
        assert "offset_s" in payload["clock"]
    finally:
        _stop(rsrv, server)
        router.stop()
        sched.close()


def test_ttft_includes_queue_wait_on_saturated_queue(decs, metrics,
                                                     traced):
    _, td = decs
    sched = SlotScheduler(td, num_slots=1, queue_size=8)
    try:
        reqs = [sched.submit([1, 2, 3, 4], max_new_tokens=8, temperature=0,
                             trace="%032x" % i, sampled=True)
                for i in range(3)]
        for r in reqs:
            r.wait(120)
            assert r.outcome == "ok"
        last = reqs[-1]
        assert last.queue_wait > 0 and last.ttft >= last.queue_wait
        pf = next(s for s in tracing.spans(trace=last.trace)
                  if s["name"] == "prefill")
        assert last.ttft >= last.queue_wait + pf["dur_s"] - 5e-3
        text = tm.generate_text(tm.get_registry())
        assert "serve_queue_wait_seconds" in text
        assert "serve_ttft_seconds" in text
    finally:
        sched.close()


# ------------------------------------------------------------ Retry-After
def test_retry_after_tracks_fleet_queue_depth():
    router = ReplicaRouter(replicas=["h1:1", "h2:1"], scrape_s=30)

    def _load(qd, draining=False, ok=True):
        for a in router._replicas:
            router._replicas[a].update(
                ok=ok, draining=draining,
                health={"slots": 2, "occupied": 0, "queue_depth": qd,
                        "queue_size": 64})

    _load(0)
    shallow = router.retry_after_s()
    _load(16)
    deep = router.retry_after_s()
    _load(80)
    assert shallow < deep < router.retry_after_s()
    assert shallow == 1 and deep == 1 + 32 // 4
    _load(10 ** 6)
    assert router.retry_after_s() == 30
    _load(0, draining=True)
    assert router.retry_after_s() == 10
    _load(0, ok=False)
    assert router.retry_after_s() == 10


def test_router_503_carries_derived_retry_after(metrics):
    router = ReplicaRouter(replicas=["127.0.0.1:9"], scrape_s=30)
    rsrv = start_router(router, port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(rsrv.server_address[1], {"prompt": [1]})
        err = ei.value
        assert err.code == 503
        assert int(err.headers["Retry-After"]) == router.retry_after_s() \
            == 10
        assert len(err.headers["X-MXTPU-Trace"]) == 32
        assert json.loads(err.read())["trace"] == \
            err.headers["X-MXTPU-Trace"]
    finally:
        _stop(rsrv)
        router.stop()


# ------------------------------------------------------------ serve_slow
def test_serve_slow_fault_parks_the_engine(decs, metrics, monkeypatch):
    """``serve_slow:drop:1`` parks the engine thread for
    ``MXTPU_FAULT_SLOW_S`` on every tick: each of the request's ticks
    counts one injected drop, the request takes at least that many
    parks of 0.05 s (a wall-clock lower bound, whatever the load), and
    the tokens are those of the run without the fault."""
    _, td = decs
    sched = SlotScheduler(td, num_slots=1, queue_size=4)
    try:
        fast_req = sched.submit([1, 2, 3], max_new_tokens=6, temperature=0)
        fast_req.wait(120)
        monkeypatch.setenv("MXTPU_FAULT_PLAN", "serve_slow:drop:1")
        monkeypatch.setenv("MXTPU_FAULT_SLOW_S", "0.05")
        faults.reset()
        assert faults.fault_slow_s() == 0.05
        injected = metrics.get("fault_injected_total")
        ticks0, hits0 = sched.stats["ticks"], injected.value(
            site="serve_slow", mode="drop")
        t0 = time.monotonic()
        req = sched.submit([1, 2, 3], max_new_tokens=6, temperature=0)
        req.wait(120)
        slow = time.monotonic() - t0
        ticks = sched.stats["ticks"] - ticks0
        assert req.outcome == "ok" and req.tokens == fast_req.tokens
        assert ticks >= 5
        assert injected.value(site="serve_slow", mode="drop") - hits0 \
            == ticks
        assert slow >= 0.05 * ticks
    finally:
        monkeypatch.delenv("MXTPU_FAULT_PLAN", raising=False)
        faults.reset()
        sched.close()


def test_tracing_is_bit_identical_on_scheduler_outputs(decs, metrics,
                                                       monkeypatch):
    _, td = decs
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11], [12]]

    def run():
        sched = SlotScheduler(td, num_slots=2, queue_size=16)
        try:
            reqs = [sched.submit(p, max_new_tokens=6,
                                 temperature=(0 if i % 2 else 0.7),
                                 seed=i, trace="%032x" % i, sampled=True)
                    for i, p in enumerate(prompts)]
            return [list(r.wait(120).tokens) for r in reqs]
        finally:
            sched.close()

    tracing.enable_tracing(False)
    base = run()
    assert not tracing.spans()
    monkeypatch.setattr(tracing, "TICK_EVERY", 1)
    tracing.enable_tracing(True)
    on = run()
    assert tracing.spans()
    assert on == base


# ------------------------------------------------------------ fleet plane
def test_merge_snapshots_matches_jax():
    snap = {"m1": {"a_total": {"type": "counter", "help": "h",
                               "labelnames": ["k"],
                               "samples": [{"labels": {"k": "x"},
                                            "value": 2.0}]}},
            "m0": {"b_seconds": {"type": "histogram", "help": "",
                                 "labelnames": [], "buckets": [0.1, 1.0],
                                 "samples": [{"labels": {}, "count": 3,
                                              "sum": 0.5}]}}}
    assert fleet.merge_snapshots(snap) == jfleet.merge_snapshots(snap)
    assert fleet.fleet_scrape_s() == jfleet.fleet_scrape_s()
    assert fleet.straggler_ratio() == jfleet.straggler_ratio()
    assert (fleet.STRAGGLER_MIN_STEPS, fleet.STRAGGLER_SUSTAIN) == \
        (jfleet.STRAGGLER_MIN_STEPS, jfleet.STRAGGLER_SUSTAIN)


def test_fleet_scraper_sweeps_live_and_dead_members(decs, metrics):
    _, td = decs
    server, sched = serve_decoder(td, port=0, num_slots=2, queue_size=4)
    live = "127.0.0.1:%d" % server.server_address[1]
    scraper = fleet.FleetScraper(lambda: {"a": live, "b": "127.0.0.1:1"},
                                 interval_s=0.1)
    try:
        rows = scraper.scrape_once()
        assert rows["a"]["ok"] and "serve_requests_total" in \
            rows["a"]["metrics"]
        assert rows["b"]["ok"] is False and rows["b"]["error"]
        assert scraper.snapshot() == rows
        scraper.start()
        assert scraper._thread is not None
        assert fleet.post_json(live, "/admin/drain", {}, 5.0)["status"] \
            in ("draining", "drained")
        assert fleet.fetch_json(live, "/healthz", 5.0)["draining"]
    finally:
        scraper.stop()
        assert scraper._thread is None
        _stop(server)
        sched.close()
