"""Telemetry of the port: metrics registry, exporters, tracing, fleet,
and the health and perf-attribution planes.

Copies of ``mxnet_tpu/telemetry``'s registry, exporters (the
``/metrics``, ``/metrics.json``, ``/profile``, ``/spans.json`` and
``/healthz`` server included), tracing (with the SLO plane), fleet,
health (memory accounting, the numerics sentinel ``MXTPU_SENTINEL``, the
flight recorder ``MXTPU_FLIGHT_RECORD``) and perf (``MXTPU_PERF_ATTR``)
modules, with the profiler-backed ``span``/``timed``.  Fault injection
is :mod:`mxnet_tpu_torch.faults`.  ``MXTPU_TELEMETRY=1`` enables
recording at import.
"""
from __future__ import annotations

from . import fleet, tracing  # noqa: F401
from .exporters import (  # noqa: F401
    generate_text, json_snapshot, start_http_server,
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
