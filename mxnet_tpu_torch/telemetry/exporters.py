"""Exporters of the port: Prometheus text exposition, JSON snapshot (and
its file dump), the telemetry HTTP server and a periodic logging
reporter.

A copy of ``mxnet_tpu/telemetry/exporters.py``: the two renderers the
serving front-end's ``/metrics`` and ``/metrics.json`` endpoints call,
:func:`dump_json`, :func:`start_http_server` (``/metrics``,
``/metrics.json``, ``/profile``, ``/spans.json``, ``/healthz``) and
:class:`LoggingReporter`, whose lines carry the
``[rank/size@g<generation>]`` prefix of ``parallel.dist.log_prefix``
while a process group spans several processes.  The text format follows the Prometheus exposition
format v0.0.4 (``# HELP`` / ``# TYPE`` headers, escaped label values,
cumulative histogram buckets with an explicit ``+Inf``).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from .registry import Histogram, Registry, get_registry

__all__ = ["generate_text", "json_snapshot", "dump_json",
           "start_http_server", "LoggingReporter"]


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    if f != f:
        return "NaN"
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels_str(names, values, extra=()):
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def generate_text(registry: Optional[Registry] = None) -> str:
    """Render the registry in Prometheus text exposition format."""
    registry = registry or get_registry()
    out = []
    for fam in registry.collect():
        out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        out.append(f"# TYPE {fam.name} {fam.typename}")
        if isinstance(fam, Histogram):
            for key, s in fam.samples():
                cum = 0
                for ub, c in zip(fam.buckets, s.counts):
                    cum += c
                    le = _fmt_value(ub)
                    out.append(
                        f"{fam.name}_bucket"
                        f"{_labels_str(fam.labelnames, key, [('le', le)])}"
                        f" {cum}")
                cum += s.counts[-1]
                out.append(
                    f"{fam.name}_bucket"
                    f"{_labels_str(fam.labelnames, key, [('le', '+Inf')])}"
                    f" {cum}")
                ls = _labels_str(fam.labelnames, key)
                out.append(f"{fam.name}_sum{ls} {_fmt_value(s.sum)}")
                out.append(f"{fam.name}_count{ls} {s.count}")
        else:
            for key, v in fam.samples():
                ls = _labels_str(fam.labelnames, key)
                out.append(f"{fam.name}{ls} {_fmt_value(v)}")
    return "\n".join(out) + ("\n" if out else "")


def json_snapshot(registry: Optional[Registry] = None) -> dict:
    """Registry contents as one JSON-serializable dict."""
    registry = registry or get_registry()
    snap = {"timestamp": time.time(), "metrics": {}}
    for fam in registry.collect():
        entry = {"type": fam.typename, "help": fam.help,
                 "labelnames": list(fam.labelnames), "samples": []}
        if isinstance(fam, Histogram):
            entry["buckets"] = list(fam.buckets)
            for key, s in fam.samples():
                entry["samples"].append({
                    "labels": dict(zip(fam.labelnames, key)),
                    "counts": list(s.counts),
                    "sum": s.sum, "count": s.count,
                })
        else:
            for key, v in fam.samples():
                entry["samples"].append({
                    "labels": dict(zip(fam.labelnames, key)), "value": v})
        snap["metrics"][fam.name] = entry
    return snap


def dump_json(filename: str, registry: Optional[Registry] = None) -> str:
    """Write :func:`json_snapshot` to ``filename``; returns the path."""
    with open(filename, "w") as f:
        json.dump(json_snapshot(registry), f, indent=1)
    return filename


def start_http_server(port: int = 0, addr: str = "127.0.0.1",
                      registry: Optional[Registry] = None,
                      max_tries: int = 1):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` on a
    daemon thread.  ``port=0`` binds an ephemeral port — read it back
    from the returned server's ``server_address``.  ``max_tries`` > 1
    auto-increments past ports already bound (multi-worker-per-host
    runs must not fight over the socket — each worker lands on the next
    free port).  ``/profile`` serves the perf plane's ranked programs,
    ``/spans.json`` the span buffer and ``/healthz`` a liveness probe
    with this process's fleet identity and flight-ring length, as the
    JAX package's server does.  Call ``.shutdown()`` to stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry or get_registry()

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path in ("/", "/metrics", "/metrics.json"):
                # fold the perf-attribution ledgers into program_mfu/
                # program_roofline right before the render — derived
                # gauges are computed per scrape, not per batch (lazy
                # import: perf pulls health which pulls this module)
                from . import perf as _perf

                _perf.publish_gauges()
            if path in ("/", "/metrics"):
                body = generate_text(reg).encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = json.dumps(json_snapshot(reg)).encode("utf-8")
                ctype = "application/json"
            elif path == "/profile":
                # the perf-attribution plane's ranked-programs document:
                # cost rows x runtime ledger x peak table, rendered by
                # tools/explain.py
                from . import perf as _perf

                body = json.dumps(_perf.profile_payload(),
                                  default=str).encode("utf-8")
                ctype = "application/json"
            elif path == "/spans.json":
                # the bounded trace-span buffer + identity/clock offset
                # (telemetry/tracing.py) — every metrics endpoint serves
                # it, so fleetstat.py trace can join spans from training
                # hosts too, not just the serving fleet
                from . import tracing as _tracing

                body = json.dumps(_tracing.spans_payload(),
                                  default=str).encode("utf-8")
                ctype = "application/json"
            elif path == "/healthz":
                # liveness probe, distinct from the scrape endpoint:
                # answers "is the process serving" without the cost (or
                # cardinality) of a full exposition render
                from . import health as _health

                ident = _health.host_identity()
                payload = {
                    "status": "ok",
                    "families": len(reg.collect()),
                    "flight_ring_len": len(_health.flight_ring()),
                    # fleet topology self-assembly: a scraper probing
                    # health endpoints alone learns who this process is
                    # and where its membership authority lives
                    "rank": ident["rank"],
                    "generation": ident["generation"],
                    "coordinator_addr": os.environ.get(
                        "MXTPU_COORD_ADDR", "").strip() or None,
                }
                # cluster-health gauges ride along when their families
                # exist: the dead-worker count the PS / coordinator
                # tracks, and the elastic generation — the two numbers
                # an operator probing a sick cluster needs
                for fam_name, key in (("kvstore_dead_workers",
                                       "kvstore_dead_workers"),
                                      ("dist_generation",
                                       "dist_generation"),
                                      ("dist_hosts_alive",
                                       "dist_hosts_alive")):
                    for fam in reg.collect():
                        if fam.name == fam_name:
                            vals = [v for _, v in fam.samples()]
                            if vals:
                                payload[key] = max(vals)
                body = json.dumps(payload).encode("utf-8")
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapers are chatty; stay quiet
            pass

    last_exc = None
    for i in range(max(int(max_tries), 1)):
        try:
            srv = ThreadingHTTPServer((addr, port + i if port else 0),
                                      _Handler)
            break
        except OSError as exc:
            last_exc = exc
    else:
        raise last_exc
    srv.daemon_threads = True
    thread = threading.Thread(target=srv.serve_forever, daemon=True,
                              name="mxtt-telemetry-http")
    thread.start()
    return srv


def _dist_log_prefix() -> str:
    """``[rank/size@g<generation>] `` in multi-process runs (the import
    is lazy: ``parallel.dist`` imports this package)."""
    try:
        from ..parallel import dist as _dist

        return _dist.log_prefix()
    except Exception:  # noqa: BLE001 — logging must never require dist
        return ""


class LoggingReporter:
    """Periodically log a compact snapshot (counters and gauges, each
    histogram's count and mean): the Speedometer generalised to every
    registered family.  Lines carry the ``[rank/size@g<generation>]``
    prefix in multi-process runs, so interleaved launcher logs stay
    attributable.  :meth:`start` runs :meth:`report_once` every
    ``interval`` seconds on a daemon thread until :meth:`stop`."""

    def __init__(self, interval: float = 60.0, logger=None,
                 registry: Optional[Registry] = None, level=logging.INFO):
        self.interval = float(interval)
        self.logger = logger or logging.getLogger(
            "mxnet_tpu_torch.telemetry")
        self.level = level
        self.registry = registry or get_registry()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def report_once(self):
        parts = []
        for fam in self.registry.collect():
            for key, s in fam.samples():
                tag = fam.name
                if key:
                    tag += "{" + ",".join(
                        f"{n}={v}" for n, v in zip(fam.labelnames, key)) + "}"
                if isinstance(fam, Histogram):
                    mean = s.sum / s.count if s.count else 0.0
                    parts.append(f"{tag} n={s.count} mean={mean:.6g}s")
                else:
                    parts.append(f"{tag}={s:.6g}" if isinstance(s, float)
                                 else f"{tag}={s}")
        if parts:
            self.logger.log(self.level, "%stelemetry: %s",
                            _dist_log_prefix(), "  ".join(parts))

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.report_once()
                except Exception:  # noqa: BLE001 — reporting must not kill
                    self.logger.exception("telemetry reporter failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mxtt-telemetry-report")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
