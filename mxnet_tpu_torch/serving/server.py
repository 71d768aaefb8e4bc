"""HTTP serving front-end for the slot-pool scheduler (PyTorch port).

The port of ``mxnet_tpu/serving/server.py``, verbatim apart from its
imports: the endpoints, status codes and payloads are the JAX server's.

A request-serving process on the stdlib ``ThreadingHTTPServer`` (one thread per
connection — each handler thread just blocks on its request's event
while the single engine thread batches everyone's decode), no
dependencies, same ops endpoints the training stack already exposes.

Endpoints:

``POST /generate``
    body: ``{"prompt": [token ids], "max_tokens": 16, "temperature": 0,
    "top_k": null, "eos_id": null, "deadline_ms": null, "seed": 0}``.
    200: ``{"tokens": [...], "outcome": "ok", "ttft_ms": ..,
    "queue_wait_ms": .., "latency_ms": ..}``.  429 when the bounded
    admission queue is full (body carries ``Retry-After`` guidance),
    504 when the deadline expires (partial ``tokens`` included), 400 on
    malformed input, 500 on an engine error.  A ``traceparent`` request
    header (the router forwards one per attempt — docs/tracing.md)
    threads the trace through the scheduler; the reply echoes the
    trace id.  TTFT is measured from REQUEST RECEIPT — the handler
    stamps the arrival before reading the body, so queue wait and
    parse time are inside it, not silently dropped.
``GET /metrics`` / ``/metrics.json``
    Prometheus text / JSON snapshot of the process registry — the
    serving families (docs/telemetry.md) plus everything else the
    process emits.
``GET /spans.json``
    This process's bounded span buffer + host identity + clock offset —
    what ``tools/fleetstat.py trace <id>`` joins across the fleet
    (docs/tracing.md).
``GET /healthz``
    ``{"status", "draining", "slots", "occupied", "queue_depth",
    "queue_size", "ticks"}`` — liveness + the saturation and drain
    signals an orchestrator (and the serving router,
    ``serving/router.py``) scales and balances on.  ``status`` is
    ``"draining"`` after ``/admin/drain`` (and ``"drained"`` once
    nothing is in flight — safe to restart).  With the paged KV
    backend a ``paged`` object carries ``{block, pages_total,
    pages_free, prefix_pages}``.
``POST /admin/drain`` / ``POST /admin/undrain``
    Rolling-restart support (docs/fault_tolerance.md): stop admitting
    (new ``/generate`` calls get 503 + Retry-After), finish queued and
    in-flight requests, report drain progress; ``undrain`` re-opens
    admission (a cancelled drain, or the post-restart re-open).
    Idempotent.
"""
from __future__ import annotations

import json
import math
import threading
import time

from .. import telemetry as _tm
from ..base import MXNetError
from ..telemetry import tracing as _tracing
from .scheduler import (AdmissionQueueFull, SchedulerDraining,
                        SlotScheduler)

__all__ = ["start_server", "serve_decoder"]

_GENERATE_FIELDS = {"prompt", "max_tokens", "temperature", "top_k",
                    "eos_id", "deadline_ms", "seed"}


def _number(body, name, integral=False, lo=None, hi=None):
    """Pull an optional numeric field out of a /generate body, rejecting
    wrong types (bools included), non-finite values (json.loads happily
    parses NaN/Infinity), and out-of-range values — malformed sampling
    params must die here with a 400, not inside the engine thread."""
    v = body.get(name)
    if v is None:
        return None
    ok = int if integral else (int, float)
    if isinstance(v, bool) or not isinstance(v, ok):
        kind = "an integer" if integral else "a number"
        raise MXNetError(f"{name} must be {kind}, got {v!r}")
    if not math.isfinite(v):
        raise MXNetError(f"{name} must be finite, got {v!r}")
    if lo is not None and v < lo:
        raise MXNetError(f"{name} must be >= {lo}, got {v!r}")
    if hi is not None and v > hi:
        raise MXNetError(f"{name} must be <= {hi}, got {v!r}")
    return v


def _parse_generate(body):
    """Validate a /generate JSON body into Request kwargs (raises
    MXNetError with a client-facing message)."""
    if not isinstance(body, dict):
        raise MXNetError("body must be a JSON object")
    unknown = set(body) - _GENERATE_FIELDS
    if unknown:
        raise MXNetError(f"unknown fields {sorted(unknown)}; "
                         f"accepted: {sorted(_GENERATE_FIELDS)}")
    prompt = body.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       and t >= 0 for t in prompt)):
        raise MXNetError("prompt must be a non-empty list of token ids")
    kwargs = {}
    for name, dst, integral, lo, hi in (
            ("max_tokens", "max_new_tokens", True, 1, None),
            ("temperature", "temperature", False, 0, None),
            ("top_k", "top_k", True, 1, None),
            ("eos_id", "eos_id", True, 0, None),
            ("deadline_ms", "deadline_ms", True, 0, None),
            ("seed", "seed", True, 0, 2 ** 32 - 1)):
        v = _number(body, name, integral=integral, lo=lo, hi=hi)
        if v is not None:
            kwargs[dst] = v
    kwargs.setdefault("max_new_tokens", 16)
    return prompt, kwargs


def _request_json(req):
    out = {
        "id": req.id,
        "tokens": [int(t) for t in req.tokens],
        "n_tokens": len(req.tokens),
        "outcome": req.outcome,
        "ttft_ms": round(req.ttft * 1000.0, 3) if req.ttft is not None
        else None,
        "queue_wait_ms": round(req.queue_wait * 1000.0, 3)
        if req.queue_wait is not None else None,
    }
    if req.trace is not None:
        out["trace"] = req.trace
    return out


def start_server(scheduler: SlotScheduler, port: int = 0,
                 addr: str = "127.0.0.1", registry=None):
    """Serve the scheduler over HTTP on a daemon thread.  ``port=0``
    binds an ephemeral port — read it back from
    ``server.server_address``.  ``server.shutdown()`` stops serving
    (the scheduler is closed separately: ``scheduler.close()``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry or _tm.get_registry()

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
            elif path == "/spans.json":
                self._reply(200, _tracing.spans_payload())
            elif path == "/healthz":
                status = "ok"
                if scheduler.draining:
                    status = "drained" if scheduler.drained else "draining"
                payload = {
                    "status": status,
                    "draining": scheduler.draining,
                    "slots": scheduler.num_slots,
                    "occupied": scheduler.occupied,
                    "queue_depth": scheduler.queue_depth,
                    "queue_size": scheduler.queue_size,
                    "ticks": scheduler.stats["ticks"],
                }
                paged = scheduler.paged_stats()
                if paged is not None:
                    payload["paged"] = paged
                self._reply(200, payload)
            else:
                self._reply(404, {"error": f"no such path {path!r}"})

        def do_POST(self):
            path = self.path.split("?", 1)[0]
            if path == "/admin/drain":
                scheduler.drain()
                self._reply(200, {
                    "status": "drained" if scheduler.drained
                    else "draining",
                    "occupied": scheduler.occupied,
                    "queue_depth": scheduler.queue_depth,
                })
                return
            if path == "/admin/undrain":
                # a drain that was cancelled (or the post-restart
                # re-open of the rolling-upgrade runbook)
                scheduler.undrain()
                self._reply(200, {"status": "ok",
                                  "occupied": scheduler.occupied})
                return
            if path != "/generate":
                self._reply(404, {"error": f"no such path {path!r}"})
                return
            # TTFT origin: stamp receipt BEFORE the body is
            # read or parsed — serve_ttft_seconds must cover queue wait
            # and parse time, not start when a slot frees up
            t_arrival = time.monotonic()
            ctx = _tracing.parse_traceparent(
                self.headers.get("traceparent"))
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                prompt, kwargs = _parse_generate(body)
            except MXNetError as exc:
                self._reply(400, {"error": str(exc)})
                return
            except (ValueError, UnicodeDecodeError) as exc:
                self._reply(400, {"error": f"malformed JSON: {exc}"})
                return
            kwargs["arrival"] = t_arrival
            if ctx is not None:
                kwargs.update(trace=ctx["trace"], parent=ctx["parent"],
                              sampled=ctx["sampled"])
            try:
                req = scheduler.submit(prompt, **kwargs)
            except SchedulerDraining as exc:
                # the orchestrator asked this replica to die: clients
                # retry against another replica, not this one
                self._reply(503, {"error": str(exc)},
                            headers=(("Retry-After", "5"),))
                return
            except AdmissionQueueFull as exc:
                self._reply(429, {"error": str(exc)},
                            headers=(("Retry-After", "1"),))
                return
            except (MXNetError, TypeError, ValueError) as exc:
                # backstop for values _parse_generate let through that
                # Request.__init__ still rejects — a 400, not a dropped
                # connection from an unwound handler thread
                self._reply(400, {"error": str(exc)})
                return
            # block this connection thread on the terminal outcome; the
            # engine enforces the deadline, the +5s slack only guards
            # against a wedged engine
            limit = None
            if req.deadline is not None:
                import time as _time

                limit = max(req.deadline - _time.monotonic(), 0.0) + 5.0
            req.wait(limit)
            payload = _request_json(req)
            if req.outcome == "ok":
                self._reply(200, payload)
            elif req.outcome == "timeout":
                self._reply(504, payload)
            elif req.outcome is None:
                payload["error"] = "engine did not reach a terminal state"
                self._reply(500, payload)
            else:
                payload["error"] = repr(req.error) if req.error else \
                    req.outcome
                self._reply(500, payload)

        def log_message(self, *args):  # health probes are chatty
            pass

    class _Server(ThreadingHTTPServer):
        daemon_threads = True
        # the stdlib default backlog of 5 resets bursty concurrent
        # connects long before the bounded admission queue (the real
        # backpressure signal, HTTP 429) ever gets to answer them
        request_queue_size = 128

    srv = _Server((addr, port), _Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True,
                              name="mxtpu-serve-http")
    thread.start()
    return srv


def serve_decoder(decoder, port=0, addr="127.0.0.1", **scheduler_kwargs):
    """Convenience bring-up: scheduler + HTTP server around a bound
    KVDecoder.  Returns ``(server, scheduler)``."""
    scheduler = SlotScheduler(decoder, **scheduler_kwargs)
    server = start_server(scheduler, port=port, addr=addr)
    return server, scheduler
