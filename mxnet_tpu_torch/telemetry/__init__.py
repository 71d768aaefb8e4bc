"""Telemetry of the port: metrics registry, exporters and span buffer.

Trimmed copies of ``mxnet_tpu/telemetry``'s registry, exporters and
tracing modules — what the serving path emits through.  The perf
attribution plane, the health/flight-ring plane and fault injection are
not ported yet.  ``MXTPU_TELEMETRY=1`` enables recording at import.
"""
from __future__ import annotations

from . import tracing  # noqa: F401
from .exporters import generate_text, json_snapshot  # noqa: F401
from .registry import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, Registry, counter,
    enable, enabled, gauge, get_registry, histogram,
)
from .tracing import (  # noqa: F401
    enable_tracing, parse_traceparent, record_span, spans_payload,
    trace_on,
)
