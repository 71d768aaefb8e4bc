"""Telemetry of the port: metrics registry, exporters, tracing and fleet.

Copies of ``mxnet_tpu/telemetry``'s registry, exporters, tracing (with
the SLO plane) and fleet modules — what the serving path and its router
emit through — with the profiler-backed ``span``/``timed``.  The perf
attribution plane and the health/flight-ring plane are not ported yet
(ROADMAP Queue 1 item 11b; fault injection is
:mod:`mxnet_tpu_torch.faults`).  ``MXTPU_TELEMETRY=1`` enables recording
at import.
"""
from __future__ import annotations

from . import fleet, tracing  # noqa: F401
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
