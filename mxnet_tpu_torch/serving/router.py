"""Serving-fleet router: least-loaded balancing over N replicas with
draining rolling upgrades (the port of ``mxnet_tpu/serving/router.py``,
pure stdlib).

A router process (``python -m mxnet_tpu_torch.serving --router``) owns
the replica registry and fronts ``POST /generate``:

- **registry** — a static ``host:port`` list (``MXTPU_SERVE_REPLICAS``
  or ``replicas=``).  Self-registration through a coordinator
  (``coordinator=``, :func:`register_replica`) waits for
  ``parallel/coordinator.py`` (ROADMAP Queue 1 item 10) and raises.
- **balancing** — each replica's ``/healthz`` ``{slots, occupied,
  queue_depth, queue_size, draining}`` is scraped every
  ``MXTPU_ROUTER_SCRAPE_S`` on a background thread and cached;
  ``/generate`` goes to the least-loaded live replica
  (``(occupied + queue_depth) / slots``).
- **retries** — failures where the replica provably did no generation
  work (connect-stage errors, 429 queue-full, 503 draining) re-route to
  the next replica, bounded by ``MXTPU_ROUTER_RETRIES`` and counted in
  ``router_retries_total{reason}``; exhaustion raises the named
  :class:`RouterRetriesExhausted`.  A connection that breaks AFTER the
  request was accepted is NOT retried (tokens may have been generated):
  it returns the named :class:`ReplicaDied` as an HTTP 502 naming the
  replica; a replica that exceeds ``generate_timeout_s`` returns the
  named :class:`ReplicaTimeout` as an HTTP 504 and is NOT marked dead.
- **backpressure** — 503 + ``Retry-After`` whenever EVERY replica is
  draining or full, including when every re-route was shed with a live
  429/503.
- **rolling upgrade** — ``POST /admin/drain`` fans out (or targets one
  replica); :meth:`ReplicaRouter.rolling_upgrade` drains one replica,
  waits ``drained``, restarts it, un-drains, then moves to the next.
- **tracing + SLO** — ``POST /generate`` adopts the client's
  ``traceparent`` (or mints one), forwards the SAME trace id on every
  attempt under a fresh parent span id, answers with ``X-MXTPU-Trace``,
  and feeds every terminal outcome into
  :class:`~mxnet_tpu_torch.telemetry.tracing.SloPlane` (``GET /slo``);
  the span buffer is at ``GET /spans.json``.

``GET /fleet`` serves per-replica health rows plus the replicas'
``/metrics.json`` merged host-labeled
(:func:`telemetry.fleet.merge_snapshots`).  The answering replica is
named in the ``X-MXTPU-Replica`` reply header.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time

from .. import telemetry as _tm
from ..base import MXNetError
from ..telemetry import fleet as _fleet
from ..telemetry import tracing as _tracing

__all__ = ["ReplicaRouter", "start_router", "register_replica",
           "RouterRetriesExhausted", "NoReplicaAvailable", "ReplicaDied",
           "ReplicaTimeout", "router_scrape_s", "router_retries"]

_logger = logging.getLogger("mxnet_tpu_torch.serving.router")

# --- router metric families (the JAX package's names) ----------------------
_TM_ROUTED = _tm.counter(
    "router_requests_total",
    "requests routed by terminal outcome: relayed (a replica answered — "
    "whatever its status), unavailable (every replica draining/full, "
    "HTTP 503), exhausted (MXTPU_ROUTER_RETRIES re-routes all failed, "
    "502), dead (replica died mid-request, 502), timeout (replica "
    "exceeded generate_timeout_s, 504 — not marked dead)",
    labels=("outcome",))
_TM_RETRIES = _tm.counter(
    "router_retries_total",
    "idempotent re-routes to the next replica by reason: connect "
    "(connection-stage failure, no work started), draining (503), "
    "full (429)", labels=("reason",))
_TM_REPLICAS = _tm.gauge(
    "router_replicas",
    "replica registry by state: healthy (routable), draining "
    "(finishing in-flight work), dead (healthz unreachable)",
    labels=("state",))
_TM_PROXY_SEC = _tm.histogram(
    "router_request_seconds",
    "end-to-end routed /generate latency through the router, retries "
    "included")


class NoReplicaAvailable(MXNetError):
    """Every registered replica is draining, full, or dead — shed load
    (HTTP 503 + Retry-After)."""


class RouterRetriesExhausted(MXNetError):
    """Every idempotent re-route failed: MXTPU_ROUTER_RETRIES+1
    replicas were tried and none accepted the request (HTTP 502)."""


class ReplicaDied(MXNetError):
    """The connection broke AFTER a replica accepted the request —
    generation may have happened, so the router must NOT silently
    retry; the client decides (HTTP 502 naming the replica)."""


class ReplicaTimeout(MXNetError):
    """The replica accepted the request but did not answer within
    ``generate_timeout_s`` — slow, not provably dead: the router
    neither retries (generation may still be running) nor marks the
    replica dead (HTTP 504 naming the replica)."""


def router_scrape_s() -> float:
    """``MXTPU_ROUTER_SCRAPE_S`` — replica /healthz scrape interval
    (default 1s; the routing signal's staleness bound)."""
    try:
        return max(float(os.environ.get("MXTPU_ROUTER_SCRAPE_S", "1")),
                   0.05)
    except ValueError:
        return 1.0


def router_retries() -> int:
    """``MXTPU_ROUTER_RETRIES`` — bounded idempotent re-routes per
    request after the first attempt (default 2)."""
    try:
        return max(int(os.environ.get("MXTPU_ROUTER_RETRIES", "2")), 0)
    except ValueError:
        return 2


def replicas_from_env():
    """``MXTPU_SERVE_REPLICAS`` — static ``host:port`` list."""
    raw = os.environ.get("MXTPU_SERVE_REPLICAS", "")
    return [a.strip() for a in raw.split(",") if a.strip()]


def _coordinator_refused():
    return MXNetError(
        "replica self-registration through a coordinator is not ported "
        "yet: it needs parallel/coordinator.py (ROADMAP Queue 1 item 10); "
        "list the replicas instead (MXTPU_SERVE_REPLICAS or replicas=)")


def register_replica(serve_addr, coordinator=None, member=None):
    """Self-register a serving replica with a coordinator — not ported
    yet (ROADMAP Queue 1 item 10): raises :class:`MXNetError`."""
    raise _coordinator_refused()


class ReplicaRouter:
    """The replica registry + least-loaded balancer.

    ``replicas``: static ``host:port`` list (default:
    ``MXTPU_SERVE_REPLICAS``).  ``coordinator`` (a coordinator whose
    members join the registry) is not ported yet and raises.
    ``start()`` launches the background health scrape;
    :func:`start_router` adds the HTTP front-end.
    """

    def __init__(self, replicas=None, coordinator=None, scrape_s=None,
                 retries=None, generate_timeout_s=300.0):
        if coordinator:
            raise _coordinator_refused()
        static = list(replicas) if replicas is not None \
            else replicas_from_env()
        self.coordinator = None
        if not static:
            raise MXNetError(
                "router needs replicas: set MXTPU_SERVE_REPLICAS or pass "
                "replicas=")
        self.scrape_s = (router_scrape_s() if scrape_s is None
                         else float(scrape_s))
        self.retries = router_retries() if retries is None \
            else int(retries)
        self.generate_timeout_s = float(generate_timeout_s)
        # the SLO plane lives at the router: it sees every request's
        # terminal outcome, replicas only see their own (GET /slo)
        self.slo = _tracing.SloPlane()
        self._lock = threading.Lock()
        self._replicas = {}
        for addr in static:
            self._replicas[addr] = self._new_row(addr, "static")
        self._stop = threading.Event()
        self._thread = None

    @staticmethod
    def _new_row(addr, source):
        return {"addr": addr, "source": source, "ok": False,
                "draining": False, "health": None, "error": None,
                "at": 0.0}

    # ------------------------------------------------------------- registry
    def scrape_once(self):
        """One registry sweep: re-scrape every replica's /healthz into
        the routing cache.  Pure host-side HTTP; one dead replica costs a
        bounded timeout, never the sweep."""
        with self._lock:
            addrs = list(self._replicas)
        for addr in addrs:
            try:
                hz = _fleet.fetch_json(addr, "/healthz",
                                       timeout=min(self.scrape_s, 2.0))
                row = {"ok": True, "error": None, "health": hz,
                       "draining": bool(hz.get("draining")
                                        or hz.get("status")
                                        in ("draining", "drained")),
                       "at": time.time()}
            except Exception as exc:  # noqa: BLE001 — dead replica =
                #                       one row marked dead, sweep lives
                row = {"ok": False, "error": repr(exc), "health": None,
                       "draining": False, "at": time.time()}
            with self._lock:
                if addr in self._replicas:
                    self._replicas[addr].update(row)
        self._set_gauges()
        # refresh slo_burn_rate{objective,window} each sweep, so the
        # gauges decay with the trailing windows without /slo polling
        self.slo.snapshot()
        return self.replicas()

    def _set_gauges(self):
        with self._lock:
            rows = list(self._replicas.values())
        _TM_REPLICAS.set(sum(1 for r in rows if r["ok"]
                             and not r["draining"]), state="healthy")
        _TM_REPLICAS.set(sum(1 for r in rows if r["ok"]
                             and r["draining"]), state="draining")
        _TM_REPLICAS.set(sum(1 for r in rows if not r["ok"]),
                         state="dead")

    def replicas(self):
        """Registry snapshot: addr -> cached health row."""
        with self._lock:
            return {a: dict(r) for a, r in self._replicas.items()}

    # ------------------------------------------------------------ balancing
    @staticmethod
    def _full(hz):
        slots = int(hz.get("slots") or 0)
        if slots < 1:
            return True
        if int(hz.get("occupied") or 0) < slots:
            return False
        return int(hz.get("queue_depth") or 0) >= \
            int(hz.get("queue_size", 1 << 30))

    def pick(self, exclude=()):
        """The least-loaded live replica ((occupied + queue_depth) /
        slots over the cached healthz), or None when every replica is
        draining, full, dead, or excluded."""
        with self._lock:
            best, best_load = None, None
            for addr, row in self._replicas.items():
                if addr in exclude or not row["ok"] or row["draining"]:
                    continue
                hz = row["health"] or {}
                if self._full(hz):
                    continue
                load = (int(hz.get("occupied") or 0)
                        + int(hz.get("queue_depth") or 0)) \
                    / max(int(hz.get("slots") or 1), 1)
                if best_load is None or load < best_load:
                    best, best_load = addr, load
            return best

    def _mark_dead(self, addr, exc):
        with self._lock:
            row = self._replicas.get(addr)
            if row is not None:
                row.update(ok=False, error=repr(exc), health=None,
                           at=time.time())

    def route_generate(self, body: bytes, traceparent=None):
        """Forward one /generate body to the least-loaded replica,
        re-routing idempotent failures; returns ``(status, payload
        bytes, replica addr)``.  Raises :class:`NoReplicaAvailable`
        (503), :class:`RouterRetriesExhausted` (502),
        :class:`ReplicaDied` (502) or :class:`ReplicaTimeout` (504).

        ``traceparent``: the client's W3C header — absent or malformed
        degrades to a freshly minted trace, never an error.  Every
        (re-)route attempt forwards the SAME trace id under a fresh
        parent span id (the replica's spans parent the router's
        attempt span exactly), and the terminal outcome feeds the SLO
        plane: availability = relayed without a 5xx/transport failure,
        TTFT read from the replica's reply."""
        import http.client

        ctx = _tracing.parse_traceparent(traceparent) or \
            _tracing.parse_traceparent(_tracing.mint_traceparent())
        trace, sampled = ctx["trace"], ctx["sampled"]
        traced = sampled and _tracing.trace_on()
        route_sid = _tracing.mint_span_id()
        t0 = time.perf_counter()
        tried = set()
        last_error = None
        attempts = 0
        slo_ok = False        # flips only on a relayed non-5xx
        slo_ttft = None
        shed_only = True      # every failure so far was a live 429/503

        def _span_attempt(t_att, att_sid, addr, status):
            if traced:
                _tracing.record_span(
                    "attempt", "router", trace,
                    time.perf_counter() - t_att, parent=route_sid,
                    span=att_sid, replica=addr, status=status,
                    attempt=attempts)

        try:
            for _ in range(self.retries + 1):
                addr = self.pick(exclude=tried)
                if addr is None:
                    break
                attempts += 1
                host, port = addr.rsplit(":", 1)
                conn = http.client.HTTPConnection(
                    host, int(port), timeout=self.generate_timeout_s)
                accepted = False
                att_sid = _tracing.mint_span_id()
                t_att = time.perf_counter()
                try:
                    try:
                        conn.request(
                            "POST", "/generate", body,
                            {"Content-Type": "application/json",
                             "traceparent": _tracing.child_traceparent(
                                 trace, sampled, att_sid)})
                        accepted = True
                        resp = conn.getresponse()
                        data = resp.read()
                        status = resp.status
                    except Exception as exc:  # noqa: BLE001 — sorted
                        #   into idempotent-retry vs mid-request below
                        if not accepted or isinstance(
                                exc, ConnectionRefusedError):
                            # connection-stage failure: the replica never
                            # saw the request — idempotent, re-route
                            self._mark_dead(addr, exc)
                            _TM_RETRIES.inc(reason="connect")
                            _span_attempt(t_att, att_sid, addr,
                                          "connect_error")
                            tried.add(addr)
                            last_error = exc
                            shed_only = False
                            continue
                        if isinstance(exc, (TimeoutError,
                                            socket.timeout)):
                            # accepted but slow: past generate_timeout_s
                            # the replica is NOT provably dead — surface
                            # the named 504 and keep it routable
                            _TM_ROUTED.inc(outcome="timeout")
                            _span_attempt(t_att, att_sid, addr, "timeout")
                            raise ReplicaTimeout(
                                f"replica {addr} did not answer within "
                                f"{self.generate_timeout_s}s: {exc!r} "
                                "(generation may still be running; "
                                "resubmit if safe)") from exc
                        # the request was accepted and the replica died
                        # under it: prefill/decode may have run — NOT
                        # idempotent, surface the named 502
                        self._mark_dead(addr, exc)
                        _TM_ROUTED.inc(outcome="dead")
                        _span_attempt(t_att, att_sid, addr, "died")
                        raise ReplicaDied(
                            f"replica {addr} died mid-request: {exc!r} "
                            "(generation may have started; resubmit if "
                            "safe)") from exc
                finally:
                    conn.close()
                _span_attempt(t_att, att_sid, addr, status)
                if status in (429, 503):
                    # the replica's own admission shed the request —
                    # provably no work started, re-route
                    reason = "full" if status == 429 else "draining"
                    if status == 503:
                        with self._lock:
                            row = self._replicas.get(addr)
                            if row is not None:
                                row["draining"] = True
                    _TM_RETRIES.inc(reason=reason)
                    tried.add(addr)
                    last_error = MXNetError(
                        f"replica {addr}: HTTP {status}")
                    continue
                _TM_ROUTED.inc(outcome="relayed")
                slo_ok = status < 500
                if status == 200:
                    # the replica's reply carries its TTFT — the SLO
                    # plane's latency objective reads it off the relay
                    try:
                        ttft_ms = json.loads(data).get("ttft_ms")
                        if ttft_ms is not None:
                            slo_ttft = float(ttft_ms) / 1e3
                    except (ValueError, AttributeError):
                        pass
                return status, data, addr
            if tried and not shed_only:
                _TM_ROUTED.inc(outcome="exhausted")
                raise RouterRetriesExhausted(
                    f"no replica accepted the request after trying "
                    f"{sorted(tried)} (MXTPU_ROUTER_RETRIES="
                    f"{self.retries}); last error: {last_error!r}")
            # nothing routable, or every attempt was a live 429/503
            # admission shed — the fleet is saturated/draining, not
            # broken: keep the backpressure contract (503 + Retry-After)
            _TM_ROUTED.inc(outcome="unavailable")
            raise NoReplicaAvailable(
                "every replica is draining, full, or unreachable — "
                "retry after backoff"
                + (f" (tried {sorted(tried)}: all answered 429/503)"
                   if tried else ""))
        finally:
            dur = time.perf_counter() - t0
            _TM_PROXY_SEC.observe(dur)
            # EVERY terminal outcome feeds the SLO plane — the raise
            # paths above unwind through here with slo_ok still False
            self.slo.record(slo_ok, ttft_s=slo_ttft, trace=trace)
            if traced:
                _tracing.record_span(
                    "route", "router", trace, dur, parent=ctx["parent"],
                    span=route_sid, attempts=attempts, ok=slo_ok)

    def retry_after_s(self) -> int:
        """Retry-After guidance for the router's own 503, derived from
        the cached fleet state instead of a constant: deeper aggregate
        queues push clients further out (``1 + queue_depth/slots`` over
        the routable replicas, clamped to 30 s); a fleet with NOTHING
        routable — every replica draining or dead — answers 10 s, the
        drain/restart timescale of the rolling-upgrade runbook."""
        with self._lock:
            rows = list(self._replicas.values())
        qd = slots = 0
        for r in rows:
            if not r["ok"] or r["draining"]:
                continue
            hz = r["health"] or {}
            qd += int(hz.get("queue_depth") or 0)
            slots += int(hz.get("slots") or 0)
        if slots < 1:
            return 10
        return min(1 + qd // slots, 30)

    # -------------------------------------------------------------- admin
    def _admin(self, addr, action):
        return _fleet.post_json(addr, f"/admin/{action}", {},
                                timeout=10.0)

    def drain(self, replica=None):
        """Proxy ``/admin/drain`` to one replica (or fan out to all) —
        the first step of the rolling-upgrade runbook.  Returns
        addr -> reply/error."""
        return self._fan(replica, "drain")

    def undrain(self, replica=None):
        return self._fan(replica, "undrain")

    def _fan(self, replica, action):
        addrs = [replica] if replica else list(self.replicas())
        out = {}
        for addr in addrs:
            try:
                out[addr] = self._admin(addr, action)
                with self._lock:
                    row = self._replicas.get(addr)
                    if row is not None:
                        row["draining"] = (action == "drain")
            except Exception as exc:  # noqa: BLE001 — report per replica
                out[addr] = {"error": repr(exc)}
        return out

    def wait_drained(self, addr, timeout=60.0):
        """Poll the replica's /healthz until ``drained`` (no queued or
        in-flight work left — safe to restart)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                hz = _fleet.fetch_json(addr, "/healthz", timeout=5.0)
                if hz.get("status") == "drained":
                    return True
            except OSError:
                pass
            time.sleep(0.05)
        return False

    def rolling_upgrade(self, restart_fn=None, drain_timeout=60.0):
        """Upgrade the fleet under live traffic, one replica at a time:
        drain -> wait ``drained`` -> ``restart_fn(addr)`` -> undrain.
        With the default no-op restart this is a rolling drain/undrain
        cycle (config reload); pass a function that actually restarts
        the replica process for a binary upgrade.  Returns the per-
        replica outcome list; raises if a replica never drains (the
        fleet is left with that replica draining for the operator)."""
        results = []
        for addr in sorted(self.replicas()):
            self.drain(addr)
            if not self.wait_drained(addr, timeout=drain_timeout):
                raise MXNetError(
                    f"replica {addr} did not reach 'drained' within "
                    f"{drain_timeout}s — aborting the rolling upgrade "
                    "(it keeps draining; undrain it to cancel)")
            if restart_fn is not None:
                restart_fn(addr)
            self.undrain(addr)
            self.scrape_once()
            results.append({"replica": addr, "ok": True})
        return results

    # -------------------------------------------------------------- fleet
    def fleet(self):
        """The router's ``GET /fleet``: per-replica health rows plus
        every live replica's /metrics.json merged host-labeled
        (telemetry.fleet.merge_snapshots)."""
        rows = self.replicas()
        per_member = {}
        for addr, row in rows.items():
            if not row["ok"]:
                continue
            try:
                snap = _fleet.fetch_json(addr, "/metrics.json",
                                         timeout=5.0)
                per_member[addr] = snap.get("metrics") or {}
                row["scrape_ok"] = True
            except Exception as exc:  # noqa: BLE001 — row-level status
                row["scrape_ok"] = False
                row["scrape_error"] = repr(exc)
        return {
            "replicas": rows,
            "healthy": sum(1 for r in rows.values()
                           if r["ok"] and not r["draining"]),
            "scrape_interval_s": self.scrape_s,
            "metrics": _fleet.merge_snapshots(per_member),
        }

    # ---------------------------------------------------------- lifecycle
    def start(self):
        """Launch the background health scrape (one sweep immediately,
        so the first /generate has a routing table)."""
        if self._thread is not None:
            return self
        try:
            self.scrape_once()
        except Exception:  # noqa: BLE001 — the loop retries
            _logger.exception("router: initial scrape failed")
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.scrape_s):
                try:
                    self.scrape_once()
                except Exception:  # noqa: BLE001 — the scrape must survive
                    _logger.exception("router scrape sweep failed")

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="mxtpu-router-scrape")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def start_router(router: ReplicaRouter, port: int = 0,
                 addr: str = "127.0.0.1", registry=None):
    """Serve the router over HTTP on a daemon thread (the same shape as
    :func:`serving.server.start_server`).  Returns the HTTP server;
    ``server.shutdown()`` stops serving, ``router.stop()`` stops the
    scrape loop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry or _tm.get_registry()
    router.start()

    class _Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload, ctype="application/json",
                   headers=()):
            body = payload if isinstance(payload, bytes) \
                else json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path in ("/", "/metrics"):
                self._reply(200, _tm.generate_text(reg).encode("utf-8"),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/metrics.json":
                self._reply(200, _tm.json_snapshot(reg))
            elif path in ("/healthz", "/replicas"):
                rows = router.replicas()
                healthy = sum(1 for r in rows.values()
                              if r["ok"] and not r["draining"])
                self._reply(200, {
                    "status": "ok" if healthy else "unavailable",
                    "role": "router",
                    "healthy": healthy,
                    "replicas": rows,
                })
            elif path == "/fleet":
                self._reply(200, router.fleet())
            elif path == "/slo":
                self._reply(200, router.slo.snapshot())
            elif path == "/spans.json":
                self._reply(200, _tracing.spans_payload())
            else:
                self._reply(404, {"error": f"no such path {path!r}"})

        def do_POST(self):
            path = self.path.split("?", 1)[0]
            if path in ("/admin/drain", "/admin/undrain"):
                try:
                    n = int(self.headers.get("Content-Length", "0") or 0)
                    msg = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as exc:
                    self._reply(400, {"error": f"malformed JSON: {exc}"})
                    return
                action = path.rsplit("/", 1)[1]
                out = (router.drain if action == "drain"
                       else router.undrain)(msg.get("replica"))
                self._reply(200, {"action": action, "replicas": out})
                return
            if path != "/generate":
                self._reply(404, {"error": f"no such path {path!r}"})
                return
            length = int(self.headers.get("Content-Length", "0") or 0)
            body = self.rfile.read(length)
            # adopt the client's traceparent or mint one HERE, so the
            # error replies below can still name the trace id
            tp = self.headers.get("traceparent")
            if _tracing.parse_traceparent(tp) is None:
                tp = _tracing.mint_traceparent()
            trace_id = _tracing.parse_traceparent(tp)["trace"]
            trace_hdr = ("X-MXTPU-Trace", trace_id)
            try:
                status, data, addr_ = router.route_generate(
                    body, traceparent=tp)
            except NoReplicaAvailable as exc:
                # Retry-After derived from fleet queue depth + drain
                # state (retry_after_s), not a constant
                self._reply(503, {"error": str(exc), "trace": trace_id},
                            headers=(("Retry-After",
                                      str(router.retry_after_s())),
                                     trace_hdr))
                return
            except (RouterRetriesExhausted, ReplicaDied) as exc:
                self._reply(502, {
                    "error": str(exc),
                    "router_error": type(exc).__name__,
                    "trace": trace_id,
                }, headers=(trace_hdr,))
                return
            except ReplicaTimeout as exc:
                self._reply(504, {
                    "error": str(exc),
                    "router_error": "ReplicaTimeout",
                    "trace": trace_id,
                }, headers=(trace_hdr,))
                return
            self._reply(status, data,
                        headers=(("X-MXTPU-Replica", addr_), trace_hdr))

        def log_message(self, *args):  # health probes are chatty
            pass

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        request_queue_size = 128

    srv = _Server((addr, port), _Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True,
                              name="mxtpu-router-http")
    thread.start()
    return srv
