"""Per-program performance attribution plane of the port.

The port of ``mxnet_tpu/telemetry/perf.py``: it answers "where does the
step time GO" while a real run is running.  Three ledgers, all
host-side, all pure arithmetic:

- **cost rows** — PyTorch has no compiled program whose
  ``cost_analysis()`` could be read, so at a program's FIRST eager
  dispatch the plane runs that dispatch under :func:`counting`:
  ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of every
  matmul, convolution and attention op it sees, and the hand-written
  CUDA kernels — launched through ctypes, invisible to a dispatch mode —
  add their analytic counts through :func:`kernel_flops` (the flash
  forward, dQ and dK/dV kernels and the paged-attention kernel, whose
  plain versions the counter would see as matmuls).  The row is keyed
  by the same label the memory rows use.  Nothing counts bytes, so a
  row's ``bytes_accessed`` is ``None`` with its ``source``
  (``flop_counter``) — the plane never guesses.  Counting never runs
  when the plane is disarmed, never inside a CUDA-graph capture and
  never on a later step.
- **runtime attribution** — the already-timed dispatch sites
  (executor forward/backward, FusedTrainer.step, the serving tick)
  feed a per-program cumulative host-wall ledger, and the fit loops
  split each step's wall into ``data_wait`` / ``dispatch`` /
  ``window_stall`` buckets (plus the epoch-boundary ``boundary_sync``
  drain) from perf_counter stamps they already take — zero new
  per-batch device syncs by construction.
- **roofline/MFU** — FLOPs over measured wall against the device-kind
  peak table yields a live ``program_mfu``; the operational intensity
  (flops/byte) against the machine balance (peak FLOP/s over peak
  bytes/s) yields the roofline verdict where a byte count exists.

Armed by ``MXTPU_PERF_ATTR=1`` (or :func:`enable`); served on
``GET /profile`` and ``/metrics.json``; rendered by
``tools/explain.py``; folded into the flight dump.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from contextlib import contextmanager

from . import registry as _reg

__all__ = [
    "PEAK_TFLOPS", "PEAK_GBPS",
    "peak_flops", "peak_bytes_per_sec", "machine_balance", "device_kind",
    "enabled", "enable", "disable",
    "counting", "kernel_flops", "open_regions", "reporting_to",
    "count_cost", "record_cost", "cost_table",
    "record_dispatch", "record_step_buckets", "record_bucket",
    "runtime_table", "bucket_table",
    "publish_gauges", "profile_payload", "speedometer_suffix", "reset",
]

# ---------------------------------------------------------------------------
# device peaks
# ---------------------------------------------------------------------------
# (substring, peak TFLOP/s) matched against the lower-cased device name,
# first hit wins, and the nominal "cpu" row stays LAST so it can never
# shadow a card.  The H100 SXM's dense bf16 peak.  The "cpu" entry is
# the JAX package's NOMINAL attribution reference (0.1 TFLOP/s), not a
# hardware claim: it keeps MFU-shaped numbers comparable across CPU
# runs of both packages instead of degenerating to null.
PEAK_TFLOPS = (
    ("h100", 989.0),
    ("cpu", 0.1),
)
# (substring, peak memory GB/s) — the denominator of machine balance
# for the roofline verdict: the H100 SXM's HBM3.  Same matching rules;
# the "cpu" row is the same kind of nominal reference as its FLOP/s twin.
PEAK_GBPS = (
    ("h100", 3350.0),
    ("cpu", 50.0),
)


def peak_flops(kind):
    """Peak FLOP/s for a device name (None when the kind is not in the
    table — callers surface that, never guess)."""
    k = str(kind or "").lower()
    for sub, tflops in PEAK_TFLOPS:
        if sub in k:
            return tflops * 1e12
    return None


def peak_bytes_per_sec(kind):
    """Peak memory bytes/s for a device name (None on a miss)."""
    k = str(kind or "").lower()
    for sub, gbps in PEAK_GBPS:
        if sub in k:
            return gbps * 1e9
    return None


def machine_balance(kind):
    """FLOPs per byte at which this device flips from memory- to
    compute-bound (peak FLOP/s over peak bytes/s); None off-table."""
    pf, pb = peak_flops(kind), peak_bytes_per_sec(kind)
    return (pf / pb) if pf and pb else None


_device_kind = None


def device_kind():
    """The local device kind — ``torch.cuda.get_device_name()`` on a
    card, ``"cpu"`` without one — resolved once and cached ("unknown"
    when the backend cannot be asked)."""
    global _device_kind
    if _device_kind is None:
        try:
            import torch

            _device_kind = (torch.cuda.get_device_name(
                torch.cuda.current_device())
                if torch.cuda.is_available() else "cpu")
        except Exception:  # noqa: BLE001 — attribution must never raise
            _device_kind = "unknown"
    return _device_kind


# ---------------------------------------------------------------------------
# arming
# ---------------------------------------------------------------------------
def _env_armed() -> bool:
    return os.environ.get("MXTPU_PERF_ATTR", "").strip().lower() \
        not in ("", "0", "false", "off", "no")


_armed = _env_armed()


def enabled() -> bool:
    """Is the attribution plane armed (``MXTPU_PERF_ATTR`` / enable())?"""
    return _armed


def enable():
    global _armed
    _armed = True


def disable():
    global _armed
    _armed = False


# ---------------------------------------------------------------------------
# telemetry families (docs/telemetry.md)
# ---------------------------------------------------------------------------
_TM_PROG_COST = _reg.gauge(
    "program_cost",
    "per-program cost counted at its first dispatch (FlopCounterMode plus "
    "the hand-written kernels' analytic counts; component=flops/"
    "bytes_accessed/peak_memory; flops and bytes are per call)",
    labels=("program", "component"))
_TM_PROG_WALL = _reg.counter(
    "program_wall_seconds",
    "cumulative host wall attributed to each program at its "
    "dispatch site (perf plane; MXTPU_PERF_ATTR)",
    labels=("program",))
_TM_MFU = _reg.gauge(
    "program_mfu",
    "model FLOPs utilization per program: counted FLOPs x dispatches "
    "over measured wall x device peak (perf plane)",
    labels=("program",))
_TM_ROOFLINE = _reg.gauge(
    "program_roofline",
    "operational intensity (flops/byte) over machine balance — >= 1 "
    "means the program should be compute-bound, < 1 memory-bound",
    labels=("program",))
_TM_STEP_TIME = _reg.counter(
    "step_time_seconds",
    "cumulative step wall split into buckets (data_wait/dispatch/"
    "window_stall per step; boundary_sync at epoch boundaries; "
    "sample at serving ticks)",
    labels=("bucket",))

# ---------------------------------------------------------------------------
# ledgers (host-side, capped, lock-guarded — exporter threads read them)
# ---------------------------------------------------------------------------
_CAP = 128
_lock = threading.Lock()
_costs: "OrderedDict[str, dict]" = OrderedDict()
_runtime: "OrderedDict[str, dict]" = OrderedDict()
_buckets: "OrderedDict[str, dict]" = OrderedDict()
_steps = {"count": 0, "wall_s": 0.0}


class _Count:
    """What one :func:`counting` region counted: ``flops`` (set when the
    region ends) = the dispatch mode's FLOPs + the kernels' analytic
    FLOPs reported through :func:`kernel_flops`."""

    __slots__ = ("flops", "kernel", "open")

    def __init__(self):
        self.flops = None
        self.kernel = 0.0
        self.open = True


# the open counting regions of each thread: a region counts the work its
# own thread launches, and the backward that work's autograd Functions
# run (on autograd's own thread for a CUDA backward) through
# open_regions()/reporting_to(); a serving thread's launches never land
# in a trainer's row
_tls = threading.local()


def open_regions() -> tuple:
    """This thread's open :func:`counting` regions (a forward stores them
    for its backward: :func:`reporting_to`)."""
    return tuple(getattr(_tls, "regions", ()))


@contextmanager
def reporting_to(regions):
    """Report the kernels launched inside to ``regions`` (the open
    regions a forward saw) in place of this thread's own."""
    prev = getattr(_tls, "regions", None)
    _tls.regions = list(regions)
    try:
        yield
    finally:
        _tls.regions = prev if prev is not None else []


@contextmanager
def counting():
    """Count the FLOPs of the work inside the region: ``with counting()
    as c: ...`` leaves the total in ``c.flops``.  A host-side dispatch
    mode — never enter it inside a CUDA-graph capture, and only at a
    program's first dispatch (it slows dispatch down)."""
    from torch.utils.flop_counter import FlopCounterMode

    box = _Count()
    mode = FlopCounterMode(display=False)
    regions = getattr(_tls, "regions", None)
    if regions is None:
        regions = _tls.regions = []
    regions.append(box)
    try:
        with mode:
            yield box
    finally:
        box.open = False
        if box in _tls.regions:
            _tls.regions.remove(box)
    box.flops = float(mode.get_total_flops()) + box.kernel


def kernel_flops(n):
    """A hand-written kernel's analytic FLOPs for one launch, added to
    this thread's open :func:`counting` regions (an attribute read when
    there are none)."""
    for box in getattr(_tls, "regions", ()):
        if box.open:
            box.kernel += float(n)


def count_cost(program: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under :func:`counting` and record its
    FLOPs as ``program``'s cost row (``bytes_accessed`` None: nothing
    counts bytes).  Returns ``fn``'s result."""
    with counting() as c:
        out = fn(*args, **kwargs)
    record_cost(program, flops=c.flops, source="flop_counter")
    return out


def record_cost(program: str, flops=None, bytes_accessed=None,
                peak_memory=None, source: str = "unknown"):
    """Record (or refresh) one program's cost row.  ``peak_memory``
    defaults to the memory row's peak bytes for the same label — the two
    planes share the program key on purpose."""
    if peak_memory is None:
        from . import health as _health

        try:
            for row in _health.program_table():
                if row["program"] == program:
                    peak_memory = row.get("peak_bytes")
                    break
        except Exception:  # noqa: BLE001
            peak_memory = None
    entry = {
        "program": str(program),
        "flops": float(flops) if flops else None,
        "bytes_accessed": float(bytes_accessed) if bytes_accessed else None,
        "peak_memory": int(peak_memory) if peak_memory else None,
        "source": source,
    }
    with _lock:
        _costs[entry["program"]] = entry
        _costs.move_to_end(entry["program"])
        while len(_costs) > _CAP:
            _costs.popitem(last=False)
    if _reg.enabled():
        for comp in ("flops", "bytes_accessed", "peak_memory"):
            if entry[comp] is not None:
                _TM_PROG_COST.set(float(entry[comp]),
                                  program=entry["program"], component=comp)
    return entry


def record_dispatch(program: str, seconds: float):
    """Fold one dispatch's host wall into the program's runtime ledger.
    No-op when the plane is disarmed; pure dict arithmetic when armed."""
    if not _armed or program is None:
        return
    with _lock:
        row = _runtime.get(program)
        if row is None:
            row = _runtime[program] = {"program": str(program),
                                       "wall_s": 0.0, "dispatches": 0}
            while len(_runtime) > _CAP:
                _runtime.popitem(last=False)
        row["wall_s"] += float(seconds)
        row["dispatches"] += 1
    _TM_PROG_WALL.inc(float(seconds), program=str(program))


def record_step_buckets(wall_s: float, **buckets):
    """Fold one step's decomposition into the bucket ledger.  The
    buckets of one call partition that step's wall by construction
    (the stamps nest), so the ledger's step buckets always sum to the
    accumulated step wall."""
    if not _armed:
        return
    with _lock:
        _steps["count"] += 1
        _steps["wall_s"] += float(wall_s)
        for name, sec in buckets.items():
            b = _buckets.get(name)
            if b is None:
                b = _buckets[name] = {"seconds": 0.0, "count": 0,
                                      "in_step": True}
            b["seconds"] += float(sec)
            b["count"] += 1
            b["in_step"] = True
    for name, sec in buckets.items():
        _TM_STEP_TIME.inc(float(sec), bucket=name)


def record_bucket(name: str, seconds: float):
    """Fold a NON-step bucket (epoch-boundary drain, serving admit) —
    reported alongside the step buckets but outside the sums-to-step-
    wall identity."""
    if not _armed:
        return
    with _lock:
        b = _buckets.get(name)
        if b is None:
            b = _buckets[name] = {"seconds": 0.0, "count": 0,
                                  "in_step": False}
        b["seconds"] += float(seconds)
        b["count"] += 1
    _TM_STEP_TIME.inc(float(seconds), bucket=name)


def cost_table():
    with _lock:
        return [dict(r) for r in _costs.values()]


def runtime_table():
    with _lock:
        return [dict(r) for r in _runtime.values()]


def bucket_table():
    with _lock:
        return {n: dict(b) for n, b in _buckets.items()}


def reset(costs: bool = True):
    """Clear the ledgers (tests, and warm-up isolation).  Pass
    ``costs=False`` to keep the first-dispatch cost rows — a bench
    resets runtime between warm-up and the timed loop without counting
    again."""
    global _device_kind
    with _lock:
        _runtime.clear()
        _buckets.clear()
        _steps["count"] = 0
        _steps["wall_s"] = 0.0
        if costs:
            _costs.clear()
    if costs:
        _device_kind = None


# ---------------------------------------------------------------------------
# derivation + surfaces
# ---------------------------------------------------------------------------
def _derive(rt, cost, peak, balance):
    """(mfu, intensity, ratio, verdict) for one program from its
    runtime row + cost row against the device peaks; Nones where a
    term is unknown."""
    mfu = intensity = ratio = None
    verdict = "unknown"
    flops = cost.get("flops") if cost else None
    nbytes = cost.get("bytes_accessed") if cost else None
    wall = rt.get("wall_s") or 0.0
    n = rt.get("dispatches") or 0
    if flops and peak and wall > 0.0 and n > 0:
        mfu = (flops * n) / (wall * peak)
    if flops and nbytes:
        intensity = flops / nbytes
        if balance:
            ratio = intensity / balance
            verdict = "compute_bound" if ratio >= 1.0 else "memory_bound"
    return mfu, intensity, ratio, verdict


def publish_gauges():
    """Fold the ledgers into the ``program_mfu`` / ``program_roofline``
    gauge families.  Called by the exporter right before a scrape
    renders (and by :func:`profile_payload`) — pure host arithmetic
    over the locked ledgers, never a device touch."""
    if not (_armed and _reg.enabled()):
        return
    kind = device_kind()
    peak, balance = peak_flops(kind), machine_balance(kind)
    with _lock:
        rows = [dict(r) for r in _runtime.values()]
        costs = {p: dict(c) for p, c in _costs.items()}
    for rt in rows:
        mfu, _, ratio, _ = _derive(rt, costs.get(rt["program"]),
                                   peak, balance)
        if mfu is not None:
            _TM_MFU.set(mfu, program=rt["program"])
        if ratio is not None:
            _TM_ROOFLINE.set(ratio, program=rt["program"])


def profile_payload(topn=None) -> dict:
    """The ``GET /profile`` document: ranked programs (device wall,
    MFU, roofline verdict, memory), the step-bucket decomposition, and
    the peaks the numbers were derived against.  ``topn`` defaults to
    ``MXTPU_PROFILE_TOPN`` (20); <= 0 means unranked-complete (the
    flight dump uses that so a post-mortem never reads a truncated
    table)."""
    if topn is None:
        try:
            topn = int(os.environ.get("MXTPU_PROFILE_TOPN", "20") or 20)
        except ValueError:
            topn = 20
    publish_gauges()
    kind = device_kind()
    peak, bw = peak_flops(kind), peak_bytes_per_sec(kind)
    balance = machine_balance(kind)
    with _lock:
        rt = {p: dict(r) for p, r in _runtime.items()}
        costs = {p: dict(c) for p, c in _costs.items()}
        buckets = {n: dict(b) for n, b in _buckets.items()}
        steps = dict(_steps)
    programs = []
    for label in set(rt) | set(costs):
        row_rt = rt.get(label, {"wall_s": 0.0, "dispatches": 0})
        cost = costs.get(label)
        mfu, intensity, ratio, verdict = _derive(row_rt, cost, peak,
                                                 balance)
        programs.append({
            "program": label,
            "wall_s": row_rt.get("wall_s", 0.0),
            "dispatches": row_rt.get("dispatches", 0),
            "flops": cost.get("flops") if cost else None,
            "bytes_accessed": cost.get("bytes_accessed") if cost else None,
            "peak_memory": cost.get("peak_memory") if cost else None,
            "cost_source": cost["source"] if cost else "unknown",
            "mfu": mfu,
            "intensity": intensity,
            "roofline_ratio": ratio,
            "roofline": verdict,
        })
    programs.sort(key=lambda p: p["wall_s"], reverse=True)
    total = len(programs)
    if topn and topn > 0:
        programs = programs[:topn]
    return {
        "version": 1,
        "armed": enabled(),
        "device_kind": kind,
        "peak_flops": peak,
        "peak_bytes_per_sec": bw,
        "machine_balance": balance,
        "programs": programs,
        "programs_total": total,
        "buckets": buckets,
        "steps": steps,
    }


def speedometer_suffix() -> str:
    """`` mfu=0.42 top=dispatch`` for the epoch log line: the MFU of
    the program with the most attributed wall plus the dominant step
    bucket.  Pure host reads of the ledgers — adds zero device syncs
    to the Speedometer; empty when disarmed or before any data."""
    if not _armed:
        return ""
    kind = device_kind()
    peak, balance = peak_flops(kind), machine_balance(kind)
    with _lock:
        rows = [dict(r) for r in _runtime.values()]
        costs = {p: dict(c) for p, c in _costs.items()}
        buckets = [(n, b["seconds"]) for n, b in _buckets.items()
                   if b.get("in_step")]
    parts = []
    if rows:
        top = max(rows, key=lambda r: r["wall_s"])
        mfu, _, _, _ = _derive(top, costs.get(top["program"]), peak,
                               balance)
        if mfu is not None:
            parts.append("mfu=%.2f" % mfu)
    if buckets:
        dom = max(buckets, key=lambda kv: kv[1])[0]
        parts.append("top=%s" % dom)
    return (" " + " ".join(parts)) if parts else ""
