"""Metrics core of the port: labeled Counter / Gauge / Histogram families.

A copy of ``mxnet_tpu/telemetry/registry.py``: one process-wide
registry of named metric families (a ``Gauge`` also moves by
``inc``/``dec``), one switch (``MXTPU_TELEMETRY`` / :func:`enable`)
governing all of it, and a single flag check on every record path
while it is off.  :func:`span` (and its decorator form :func:`timed`) times a
region into two sinks: a latency histogram here while telemetry is on,
and a chrome-trace event through ``profiler.record`` while the profiler
runs, on the profiler's timeline.
"""
from __future__ import annotations

import functools
import os
import re
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "enabled", "enable", "disable", "reset",
    "counter", "gauge", "histogram", "get_registry",
    "DEFAULT_BUCKETS", "sanitize_name", "span", "timed",
]

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")

# Prometheus-conventional latency buckets (seconds).
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _State:
    __slots__ = ("enabled",)

    def __init__(self, on: bool):
        self.enabled = on


_state = _State(os.environ.get("MXTPU_TELEMETRY", "0").lower()
                not in ("", "0", "false"))


def enabled() -> bool:
    """Is the telemetry runtime recording?"""
    return _state.enabled


def enable(on: bool = True):
    """Turn metric recording on (or off with ``on=False``).  Disabled is
    the default unless ``MXTPU_TELEMETRY=1`` is set in the environment."""
    _state.enabled = bool(on)


def disable():
    enable(False)


def sanitize_name(name: str) -> str:
    """Coerce an arbitrary string into a valid Prometheus metric name."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not name or not _NAME_RE.match(name):
        name = "_" + name
    return name


class MetricFamily:
    """One named metric with a fixed label-name schema and per-label-value
    samples.  Subclasses define the sample record type and record verbs."""

    typename = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._samples: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if tuple(labels) != self.labelnames and \
                set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def clear(self):
        with self._lock:
            self._samples.clear()

    def samples(self):
        """[(label_values_tuple, sample)] — a consistent snapshot."""
        with self._lock:
            return list(self._samples.items())


class Counter(MetricFamily):
    """Monotonically increasing value (e.g. ``*_total`` counts/bytes)."""

    typename = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if not _state.enabled:
            return
        if amount < 0:
            raise ValueError("counters cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._samples.get(key, 0.0))

    def total(self) -> float:
        """Sum over every label combination (test/report convenience)."""
        with self._lock:
            return float(sum(self._samples.values()))


class Gauge(MetricFamily):
    """Point-in-time value that can go up and down."""

    typename = "gauge"

    def set(self, value: float, **labels):
        if not _state.enabled:
            return
        key = self._key(labels)
        with self._lock:
            self._samples[key] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        if not _state.enabled:
            return
        key = self._key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._samples.get(key, 0.0))


class _HistSample:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(MetricFamily):
    """Bucketed distribution (latencies, sizes).  Exported in Prometheus
    cumulative-bucket form (``_bucket{le=...}`` + ``_sum`` + ``_count``)."""

    typename = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bl = sorted(float(b) for b in buckets)
        if not bl:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = tuple(bl)  # +Inf is implicit

    def observe(self, value: float, **labels):
        if not _state.enabled:
            return
        key = self._key(labels)
        value = float(value)
        with self._lock:
            s = self._samples.get(key)
            if s is None:
                s = self._samples[key] = _HistSample(len(self.buckets) + 1)
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    s.counts[i] += 1
                    break
            else:
                s.counts[-1] += 1  # +Inf bucket
            s.sum += value
            s.count += 1

    def count(self, **labels) -> int:
        key = self._key(labels)
        with self._lock:
            s = self._samples.get(key)
            return s.count if s is not None else 0

    def sum(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            s = self._samples.get(key)
            return s.sum if s is not None else 0.0


class Registry:
    """Name -> family map.  Families register once (module import time);
    get-or-create keeps re-imports idempotent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def get_or_create(self, cls, name, help="", labelnames=(), **kwargs):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.typename}, not {cls.typename}")
                if tuple(labelnames) != fam.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.labelnames}, not {tuple(labelnames)}")
                return fam
            fam = cls(name, help, labelnames, **kwargs)
            self._families[name] = fam
            return fam

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def collect(self):
        """Families in registration order (stable export order)."""
        with self._lock:
            return list(self._families.values())

    def reset(self):
        """Zero every family's samples.  Families stay registered —
        instrumented modules hold references created at import time."""
        for fam in self.collect():
            fam.clear()


_default_registry = Registry()


def get_registry() -> Registry:
    return _default_registry


def reset():
    """Zero all metric values in the default registry (test isolation)."""
    _default_registry.reset()


def counter(name, help="", labels=()) -> Counter:
    return _default_registry.get_or_create(Counter, name, help, labels)


def gauge(name, help="", labels=()) -> Gauge:
    return _default_registry.get_or_create(Gauge, name, help, labels)


def histogram(name, help="", labels=(), buckets=DEFAULT_BUCKETS) -> Histogram:
    return _default_registry.get_or_create(Histogram, name, help, labels,
                                           buckets=buckets)


# ---------------------------------------------------------------------------
# spans: one region, two sinks (the reference's registry.py:296-359)
# ---------------------------------------------------------------------------
@contextmanager
def span(name: str, category: str = "host", device: str = "host",
         sync=None, histogram_name: Optional[str] = None, trace=None,
         **labels):
    """Time a region.  While the profiler runs, a chrome-trace event
    ``name`` of ``category`` (the op spans' sink and timebase); while
    telemetry is on, the seconds go to histogram ``histogram_name``
    (default: the sanitised ``<name>_seconds``) with ``labels``; with
    ``trace`` and request tracing on, a span of that trace in the span
    buffer.  ``sync`` (a zero-argument callable) runs before the region
    closes, so asynchronous device work is counted.  With every sink off
    the region runs untimed."""
    from .. import profiler as _prof
    from . import tracing as _tracing

    prof_on = _prof.is_running()
    trace_on = trace is not None and _tracing.trace_on()
    if not (prof_on or _state.enabled or trace_on):
        yield
        return
    us0 = _prof.now_us() if prof_on else 0.0
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            sync()
        dt = time.perf_counter() - t0
        if prof_on:
            _prof.record(name, device, us0, _prof.now_us(), category)
        if trace_on:
            _tracing.record_span(name, category, trace, dt, **labels)
        if _state.enabled:
            hname = histogram_name or sanitize_name(name) + "_seconds"
            histogram(hname, f"wall time of {name} (seconds)",
                      labels=tuple(labels)).observe(dt, **labels)


def timed(name: str, category: str = "host", **labels):
    """Decorator form of :func:`span`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, category=category, **labels):
                return fn(*args, **kwargs)

        return wrapper

    return deco
