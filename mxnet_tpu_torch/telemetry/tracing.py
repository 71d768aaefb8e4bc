"""Request-scoped tracing of the port, and the serving fleet's SLO plane.

A copy of ``mxnet_tpu/telemetry/tracing.py``.  The router mints a W3C
``traceparent`` per ``POST /generate`` (:func:`mint_traceparent`;
sampling is decided once, at mint time, by ``MXTPU_TRACE_SAMPLE``) and
forwards it on every re-route attempt under a fresh parent span id
(:func:`child_traceparent`); each replica threads it through its
scheduler.  Every process keeps a bounded span ring (``MXTPU_SPAN_RING``)
served at ``GET /spans.json``.  Spans are stamped with the END wall time
``t`` plus ``dur_s``; a record is a pure host-side deque write, never a
device sync.

:class:`SloPlane` turns the router's per-request outcomes into burn
rates over trailing 5 s and 60 s windows against two objectives —
``availability`` (relayed without a 5xx or transport failure) and
``ttft`` (under ``MXTPU_SLO_TTFT_MS``) — each targeting the
``MXTPU_SLO_AVAIL`` good fraction; burn rate = bad fraction / (1 -
``MXTPU_SLO_AVAIL``).  It keeps the trace ids of the slowest TTFTs as
exemplars (``GET /slo`` on the router).

Knobs: ``MXTPU_TRACE``, ``MXTPU_TRACE_SAMPLE``, ``MXTPU_SPAN_RING``,
``MXTPU_SLO_TTFT_MS``, ``MXTPU_SLO_AVAIL``.
"""
from __future__ import annotations

import os
import re
import threading
import time
from collections import deque

from . import registry as _reg

__all__ = [
    "trace_on", "enable_tracing", "sample_rate", "span_ring_size",
    "mint_traceparent", "parse_traceparent", "child_traceparent",
    "mint_span_id", "record_span", "spans", "spans_payload",
    "clear_spans", "slo_ttft_ms", "slo_avail", "SloPlane", "TICK_EVERY",
]

_TM_SPANS = _reg.counter(
    "trace_spans_total",
    "spans recorded into the bounded per-process span buffer "
    "(GET /spans.json) by emitting component", labels=("svc",))
_TM_SLO_BURN = _reg.gauge(
    "slo_burn_rate",
    "SLO error-budget burn rate per objective and trailing window: "
    "observed bad fraction / (1 - MXTPU_SLO_AVAIL); 1.0 burns the "
    "budget exactly at the objective, >1 pages",
    labels=("objective", "window"))
_TM_SLO_VIOL = _reg.counter(
    "slo_violations_total",
    "requests that violated an SLO objective: availability (5xx or "
    "transport failure through the router) or ttft (time-to-first-"
    "token above MXTPU_SLO_TTFT_MS)", labels=("objective",))

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


def sample_rate() -> float:
    """``MXTPU_TRACE_SAMPLE`` — fraction of routed requests minted with
    the W3C sampled flag (default 1.0).  Unsampled requests still get a
    trace id but record no spans."""
    try:
        return min(max(float(
            os.environ.get("MXTPU_TRACE_SAMPLE", "1") or 1.0), 0.0), 1.0)
    except ValueError:
        return 1.0


def span_ring_size() -> int:
    """``MXTPU_SPAN_RING`` — bounded span-buffer capacity (default
    2048 spans; the oldest are overwritten)."""
    try:
        return max(int(os.environ.get("MXTPU_SPAN_RING", "2048")), 16)
    except ValueError:
        return 2048


def slo_ttft_ms() -> float:
    """``MXTPU_SLO_TTFT_MS`` — the TTFT objective threshold
    (default 250 ms)."""
    try:
        return max(float(os.environ.get("MXTPU_SLO_TTFT_MS", "250")
                         or 250.0), 0.0)
    except ValueError:
        return 250.0


def slo_avail() -> float:
    """``MXTPU_SLO_AVAIL`` — target good fraction for BOTH objectives
    (default 0.99).  The error budget is ``1 - MXTPU_SLO_AVAIL``."""
    try:
        v = float(os.environ.get("MXTPU_SLO_AVAIL", "0.99") or 0.99)
    except ValueError:
        return 0.99
    return min(max(v, 0.0), 0.999999)


def mint_span_id() -> str:
    return os.urandom(8).hex()


def mint_traceparent(sampled=None) -> str:
    """A fresh ``00-<trace>-<span>-<flags>`` header.  ``sampled=None``
    decides by ``MXTPU_TRACE_SAMPLE`` (always False while tracing is
    off — unsampled ids still correlate logs and SLO exemplars)."""
    if sampled is None:
        sampled = trace_on() and os.urandom(1)[0] < sample_rate() * 256.0
    return "00-%s-%s-%02x" % (os.urandom(16).hex(), mint_span_id(),
                              1 if sampled else 0)


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


def child_traceparent(trace: str, sampled: bool, span=None) -> str:
    """Same trace, fresh parent span id — what the router forwards on
    each (re-)route attempt; ``span`` reuses a pre-minted id (the
    router records its attempt span under the id it forwards)."""
    return "00-%s-%s-%02x" % (trace, span or mint_span_id(),
                              1 if sampled else 0)


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


def clear_spans():
    """Drop the buffer (A/B runs, test isolation)."""
    with _spans_lock:
        _spans.clear()


def spans_payload(trace=None) -> dict:
    """The ``GET /spans.json`` body: this process's identity and clock
    offset (so ``fleetstat.py trace`` lanes and aligns it) and the span
    snapshot.  A pure host-side buffer read."""
    from . import health as _health

    ident = _health.host_identity()
    return {"host": ident["host"], "pid": ident["pid"],
            "rank": ident["rank"], "clock": _health.clock_offset(),
            "trace_on": trace_on(), "spans": spans(trace)}


class SloPlane:
    """Multi-window burn rates over per-request records.

    :meth:`record` is on the router's per-request path: one bounded
    deque append and counter bumps under a lock.  :meth:`snapshot` (the
    ``GET /slo`` body; the router's scrape sweep calls it too, so the
    gauges stay fresh) recomputes each trailing window's bad fraction
    and burn rate, and returns the slowest-TTFT exemplar trace ids."""

    WINDOWS = (5.0, 60.0)

    def __init__(self, ttft_ms=None, avail=None, capacity=4096,
                 max_exemplars=8):
        self.ttft_s = (slo_ttft_ms() if ttft_ms is None
                       else float(ttft_ms)) / 1e3
        self.avail = slo_avail() if avail is None else float(avail)
        self.max_exemplars = int(max_exemplars)
        self._lock = threading.Lock()
        self._records = deque(maxlen=int(capacity))
        self._violations = {"availability": 0, "ttft": 0}
        self._exemplars = []          # [(ttft_s, trace, t)] slowest first

    def record(self, ok, ttft_s=None, trace=None):
        """One terminal routed request: ``ok`` = relayed without a
        5xx/transport failure; ``ttft_s`` when the replica reported
        one.  Returns the (availability, ttft) violation pair."""
        bad_avail = not ok
        bad_ttft = ttft_s is not None and ttft_s > self.ttft_s
        with self._lock:
            self._records.append(
                (time.time(), bool(ok), ttft_s, trace))
            if bad_avail:
                self._violations["availability"] += 1
            if bad_ttft:
                self._violations["ttft"] += 1
            if ttft_s is not None:
                self._exemplars.append((float(ttft_s), trace, time.time()))
                self._exemplars.sort(key=lambda e: -e[0])
                del self._exemplars[self.max_exemplars:]
        if bad_avail:
            _TM_SLO_VIOL.inc(objective="availability")
        if bad_ttft:
            _TM_SLO_VIOL.inc(objective="ttft")
        return bad_avail, bad_ttft

    def snapshot(self) -> dict:
        now = time.time()
        with self._lock:
            recs = list(self._records)
            viol = dict(self._violations)
            exemplars = list(self._exemplars)
        budget = max(1.0 - self.avail, 1e-9)
        windows = {}
        for w in self.WINDOWS:
            sel = [r for r in recs if r[0] >= now - w]
            n = len(sel)
            bad_avail = sum(1 for r in sel if not r[1])
            with_ttft = [r for r in sel if r[2] is not None]
            bad_ttft = sum(1 for r in with_ttft if r[2] > self.ttft_s)
            label = "%ds" % int(w)
            burn_avail = (bad_avail / n) / budget if n else 0.0
            burn_ttft = (bad_ttft / len(with_ttft)) / budget \
                if with_ttft else 0.0
            _TM_SLO_BURN.set(burn_avail, objective="availability",
                             window=label)
            _TM_SLO_BURN.set(burn_ttft, objective="ttft", window=label)
            windows[label] = {
                "requests": n,
                "bad_availability": bad_avail,
                "bad_ttft": bad_ttft,
                "burn_rate": {"availability": round(burn_avail, 4),
                              "ttft": round(burn_ttft, 4)},
            }
        return {
            "objectives": {"ttft_ms": round(self.ttft_s * 1e3, 3),
                           "availability": self.avail},
            "error_budget": round(budget, 9),
            "windows": windows,
            "violations_total": viol,
            "exemplars": [
                {"trace": tr, "ttft_ms": round(tt * 1e3, 3), "t": at}
                for tt, tr, at in exemplars],
        }
