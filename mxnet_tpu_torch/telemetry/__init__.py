"""Telemetry of the port: metrics registry, exporters and span buffer.

Trimmed copies of ``mxnet_tpu/telemetry``'s registry, exporters and
tracing modules — what the serving path emits through — with the
profiler-backed ``span``/``timed``.  The perf attribution plane and the
health/flight-ring plane are not ported yet (fault injection is
:mod:`mxnet_tpu_torch.faults`).  ``MXTPU_TELEMETRY=1`` enables recording
at import.
"""
from __future__ import annotations

from . import tracing  # noqa: F401
from .exporters import generate_text, json_snapshot  # noqa: F401
from .registry import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, Registry, counter,
    enable, enabled, gauge, get_registry, histogram, sanitize_name, span,
    timed,
)
from .tracing import (  # noqa: F401
    enable_tracing, parse_traceparent, record_span, spans_payload,
    trace_on,
)
