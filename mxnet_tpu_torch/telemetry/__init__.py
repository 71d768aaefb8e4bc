"""Telemetry of the port: metrics registry, exporters, tracing, fleet,
and the health and perf-attribution planes.

Copies of ``mxnet_tpu/telemetry``'s registry, exporters (the
``/metrics``, ``/metrics.json``, ``/profile``, ``/spans.json`` and
``/healthz`` server, ``dump_json`` and ``LoggingReporter`` included),
tracing (with the SLO plane), fleet, health (memory accounting, the
numerics sentinel ``MXTPU_SENTINEL``, the flight recorder
``MXTPU_FLIGHT_RECORD``) and perf (``MXTPU_PERF_ATTR``) modules, with
the profiler-backed ``span``/``timed``.  Fault injection is
:mod:`mxnet_tpu_torch.faults`.  ``MXTPU_TELEMETRY=1`` enables
recording at import; ``MXTPU_TELEMETRY_HTTP_PORT=<port>`` also serves
``/metrics`` from import on (0 binds an ephemeral port, a taken one
moves on to the next free port), and :func:`http_address` reports where:
the coordinator join advertises it for the fleet's federation scrape.
"""
from __future__ import annotations

from . import fleet, tracing  # noqa: F401
from .exporters import (  # noqa: F401
    LoggingReporter, dump_json, generate_text, json_snapshot,
    start_http_server,
)
from .registry import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, Registry, counter,
    disable, enable, enabled, gauge, get_registry, histogram, reset,
    sanitize_name, span, timed,
)
from .tracing import (  # noqa: F401
    enable_tracing, parse_traceparent, record_span, spans_payload,
    trace_on,
)
from . import health  # noqa: F401
from .health import (  # noqa: F401
    DeviceOOMError, NumericsError, dump_flight_record, flight_ring,
    format_memory_report, memory_report, record_step, sentinel_check,
    sentinel_record,
)
from . import perf  # noqa: F401
from .perf import profile_payload  # noqa: F401

import os as _os

_http_server = None
_port = _os.environ.get("MXTPU_TELEMETRY_HTTP_PORT")
if _port:
    enable()
    _http_server = start_http_server(int(_port), max_tries=16)


def http_address():
    """``host:port`` of the import-time ``/metrics`` server
    (``MXTPU_TELEMETRY_HTTP_PORT``), or None when none runs."""
    if _http_server is None:
        return None
    host, port = _http_server.server_address[:2]
    return "%s:%d" % (host, port)
