"""Request-scoped tracing of the port: the per-process span buffer.

A trimmed copy of ``mxnet_tpu/telemetry/tracing.py`` keeping what a
serving replica calls: the W3C ``traceparent`` parser the HTTP handler
threads into each request, the bounded span ring the scheduler and the
paged KV cache append to, and the ``GET /spans.json`` payload.  The
router-side SLO plane and trace minting are not ported (no router in
this package yet).

Spans are stamped with the END wall time ``t`` plus ``dur_s``; a record
is a pure host-side deque write, never a device sync.
"""
from __future__ import annotations

import os
import re
import socket
import threading
import time
from collections import deque

from . import registry as _reg

__all__ = [
    "trace_on", "enable_tracing", "span_ring_size", "parse_traceparent",
    "record_span", "spans", "spans_payload", "TICK_EVERY",
]

_TM_SPANS = _reg.counter(
    "trace_spans_total",
    "spans recorded into the bounded per-process span buffer "
    "(GET /spans.json) by emitting component", labels=("svc",))

# Decode-tick span cadence: with tracing on, every TICK_EVERY-th engine
# tick emits one span per sampled live request (a per-tick span per
# request would swamp the ring at decode rates).  Tests lower it to 1.
TICK_EVERY = 16

_TP_RE = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


class _State:
    __slots__ = ("enabled",)

    def __init__(self, on):
        self.enabled = on


_state = _State(os.environ.get("MXTPU_TRACE", "0").lower()
                not in ("", "0", "false", "off"))


def trace_on() -> bool:
    """Is span recording on?  (``MXTPU_TRACE=1`` at import, or
    :func:`enable_tracing` at runtime.)"""
    return _state.enabled


def enable_tracing(on: bool = True):
    """Turn span recording on/off at runtime (tests, A/B runs)."""
    _state.enabled = bool(on)


def span_ring_size() -> int:
    """``MXTPU_SPAN_RING`` — bounded span-buffer capacity (default
    2048 spans; the oldest are overwritten)."""
    try:
        return max(int(os.environ.get("MXTPU_SPAN_RING", "2048")), 16)
    except ValueError:
        return 2048


def parse_traceparent(header):
    """``{"trace", "parent", "sampled"}`` from a traceparent header, or
    None when absent/malformed (a bad client header degrades to a fresh
    trace, never a 4xx)."""
    if not header or not isinstance(header, str):
        return None
    m = _TP_RE.match(header.strip().lower())
    if m is None:
        return None
    return {"trace": m.group(1), "parent": m.group(2),
            "sampled": bool(int(m.group(3), 16) & 1)}


_spans: deque = deque(maxlen=span_ring_size())
_spans_lock = threading.Lock()
_span_seq = 0


def record_span(name, svc, trace, dur_s, t=None, parent=None, span=None,
                **attrs):
    """Append one span: a pure host-side dict + deque write.  ``t`` is
    the END wall-clock stamp (``time.time()`` now when omitted) and
    ``dur_s`` the span length.  ``trace`` may be None for ambient
    process events (e.g. a step-time KV eviction with no admitting
    request).  Extra ``attrs`` land flat on the record; reserved keys
    lose."""
    global _spans, _span_seq
    rec = dict(attrs)
    with _spans_lock:
        _span_seq += 1
        sid = span or ("%d-%d" % (os.getpid(), _span_seq))
        rec.update(sid=sid, trace=trace, parent=parent, name=str(name),
                   svc=str(svc), t=(time.time() if t is None else float(t)),
                   dur_s=float(dur_s))
        if _spans.maxlen != span_ring_size():
            _spans = deque(_spans, maxlen=span_ring_size())
        _spans.append(rec)
    _TM_SPANS.inc(svc=str(svc))
    return rec


def spans(trace=None):
    """Snapshot of the buffer, oldest first (optionally one trace's)."""
    with _spans_lock:
        out = list(_spans)
    if trace is not None:
        out = [s for s in out if s.get("trace") == trace]
    return out


def _rank() -> int:
    try:
        return int(os.environ.get("MXTPU_RANK",
                                  os.environ.get("DMLC_RANK", "0")) or 0)
    except ValueError:
        return 0


def spans_payload(trace=None) -> dict:
    """The ``GET /spans.json`` body: this process's identity, its clock
    offset and the span snapshot.  The port has no coordinator client
    yet, so the offset is always the local clock's (0)."""
    return {"host": socket.gethostname(), "pid": os.getpid(),
            "rank": _rank(),
            "clock": {"offset_s": 0.0, "rtt_s": None, "at": None,
                      "source": "none"},
            "trace_on": trace_on(), "spans": spans(trace)}
