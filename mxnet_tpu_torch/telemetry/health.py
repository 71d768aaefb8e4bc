"""Training health layer of the port: device-memory accounting, the
NaN/Inf sentinel, and a crash flight recorder.

The port of ``mxnet_tpu/telemetry/health.py``.  The async training
stack (the bucketed update, fused metrics, the bounded in-flight window,
captured steps) moved the classic failure modes of a production run —
device OOM, silent NaN/Inf divergence, a hang inside the in-flight
window — off the host thread where nothing observes them.
The registry (registry.py) answers "how fast"; this module answers "how
healthy" and "why did it die", the per-program memory/cost attribution
that fused-execution stacks (arXiv:2004.13336 sharded updates, TVM
arXiv:1802.04799) rely on to keep compiled execution debuggable.

Three subsystems, one module:

- **device-memory accounting** — every bind/plan/step-build records a
  per-program memory attribution row (argument/output/temp/peak bytes,
  shape math; PyTorch has no compiled program to analyse).  Dispatch
  sites call :func:`reraise_if_oom` so a ``torch.cuda.OutOfMemoryError``
  (or the CPU allocator's failure) surfaces a ranked memory report (top
  programs by peak bytes, the tracked live tensors, and on a card the
  caching allocator's ``torch.cuda.memory_stats``) chained onto the
  original exception instead of a bare allocator message.
- **numerics sentinel** (``MXTPU_SENTINEL``, default off) — the bucketed
  update and the FusedTrainer step compute an isfinite-per-key mask and
  a gradient-norm scalar on the device, in the same launch stream as
  the step (inside the captured graph of ``step_multi`` too);
  :func:`sentinel_record` parks the resulting device tensors without
  reading them, and :func:`sentinel_check` (called at the same
  reporting boundaries that drain fused metrics) performs the only host
  sync — so a clean epoch keeps the zero-per-batch-sync property.  A non-finite flag raises :class:`NumericsError` (or warns,
  ``MXTPU_SENTINEL=warn``) naming the step id, site/bucket, and keys.
- **flight recorder** (``MXTPU_FLIGHT_RECORD``, default on) — a bounded
  ring of per-step records (step id, pipeline depth, dispatch latency,
  program signature, sentinel backlog) that :func:`dump_flight_record`
  writes together with the registry snapshot, the program-cache
  contents, and the memory report as ONE JSON — the black box read
  after a crash.  ``Module.fit``/``FusedTrainer.fit`` auto-dump on an
  uncaught exception (when ``MXTPU_FLIGHT_RECORD`` names a path) and a
  ``SIGUSR1`` dumps a live run without stopping it.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
import warnings
from collections import OrderedDict, deque

from ..base import MXNetError
from . import registry as _reg
from .exporters import json_snapshot

__all__ = [
    "NumericsError", "DeviceOOMError",
    "sentinel_mode", "sentinel_vector", "sentinel_record", "sentinel_check",
    "sentinel_pending",
    "record_program", "program_table",
    "memory_report", "format_memory_report", "is_oom", "reraise_if_oom",
    "donation_saved",
    "flight_enabled", "record_step", "flight_ring", "dump_flight_record",
    "auto_dump",
    "host_identity", "set_clock_offset", "clock_offset", "step_time_stats",
]

_logger = logging.getLogger("mxnet_tpu_torch.telemetry")

# --- telemetry families (docs/telemetry.md) --------------------------------
_TM_PROG_MEM = _reg.gauge(
    "program_memory_bytes",
    "per-program memory attribution recorded at bind/plan time "
    "(component=argument/output/temp/peak; shape math)",
    labels=("program", "component"))
_TM_OOM = _reg.counter(
    "device_memory_oom_total",
    "device out-of-memory errors intercepted at a dispatch site (each one "
    "re-raised as DeviceOOMError carrying the ranked memory report)",
    labels=("site",))
_TM_DONATED = _reg.counter(
    "device_memory_donated_bytes_total",
    "bytes updated in place per dispatch (the port's counterpart of "
    "XLA buffer donation: storage the allocator never double-buffers)",
    labels=("site",))
_TM_SENT_REC = _reg.counter(
    "sentinel_records_total",
    "sentinel accumulations enqueued device-side (no host sync)",
    labels=("site",))
_TM_SENT_SYNC = _reg.counter(
    "sentinel_sync_total",
    "host syncs of parked sentinel state (site=boundary: a reporting "
    "boundary drained it; overflow: the pending window hit "
    "MXTPU_SENTINEL_WINDOW; manual: an explicit sentinel_check)",
    labels=("site",))
_TM_SENT_BAD = _reg.counter(
    "sentinel_nonfinite_total",
    "non-finite (key, step) gradient flags the sentinel attributed",
    labels=("site",))
_TM_SENT_NORM = _reg.gauge(
    "sentinel_grad_norm",
    "last synced gradient norm from the sentinel's on-device "
    "accumulator", labels=("site",))
_TM_FLIGHT_REC = _reg.counter(
    "flight_recorder_records_total",
    "per-step records appended to the flight-recorder ring")
_TM_FLIGHT_DUMP = _reg.counter(
    "flight_recorder_dumps_total",
    "flight-record JSON dumps written", labels=("trigger",))


class NumericsError(MXNetError):
    """Non-finite gradients detected by the fused sentinel."""


class DeviceOOMError(MXNetError):
    """Device out of memory, re-raised with the memory report."""


# ---------------------------------------------------------------------------
# device-memory accounting
# ---------------------------------------------------------------------------
_PROG_CAP = 128
_programs: "OrderedDict[str, dict]" = OrderedDict()
_programs_lock = threading.Lock()


def record_program(program: str, argument: int = 0, output: int = 0,
                   temp: int = 0, alias: int = 0, peak=None,
                   source: str = "shape_math"):
    """Record (or refresh) one program's memory attribution row.

    Called at bind time (executor), plan build (kvstore_fused), and
    the first step (trainer).  Rows are kept host-side regardless of the
    telemetry switch so the OOM report works in any configuration; the
    ``program_memory_bytes`` gauge mirrors them when recording is on.
    """
    if peak is None:
        peak = max(int(argument) + int(output) + int(temp) - int(alias), 0)
    entry = {"program": str(program), "argument_bytes": int(argument),
             "output_bytes": int(output), "temp_bytes": int(temp),
             "alias_bytes": int(alias), "peak_bytes": int(peak),
             "source": source}
    with _programs_lock:
        _programs[entry["program"]] = entry
        _programs.move_to_end(entry["program"])
        while len(_programs) > _PROG_CAP:
            _programs.popitem(last=False)
    if _reg.enabled():
        for comp in ("argument", "output", "temp", "peak"):
            _TM_PROG_MEM.set(entry[f"{comp}_bytes"],
                             program=entry["program"], component=comp)
    return entry


def program_table():
    """Current attribution rows, ranked by peak bytes (descending)."""
    with _programs_lock:
        rows = list(_programs.values())
    return sorted(rows, key=lambda r: r["peak_bytes"], reverse=True)


def donation_saved(nbytes: int, site: str):
    """Count bytes a dispatch site updated in place (what the JAX package
    donates to XLA)."""
    if _reg.enabled() and nbytes > 0:
        _TM_DONATED.inc(nbytes, site=site)


def _allocator_stats():
    """The caching allocator's view of the current card (``None`` on a
    host without one, or before CUDA is initialised): allocated,
    reserved and peak bytes, and the allocator's retry and OOM counts."""
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        st = torch.cuda.memory_stats()
        return {"allocated_bytes": int(st.get("allocated_bytes.all.current",
                                              0)),
                "reserved_bytes": int(st.get("reserved_bytes.all.current",
                                             0)),
                "peak_allocated_bytes": int(st.get("allocated_bytes.all.peak",
                                                   0)),
                "num_alloc_retries": int(st.get("num_alloc_retries", 0)),
                "num_ooms": int(st.get("num_ooms", 0))}
    except Exception:  # noqa: BLE001 — the report must never raise
        return None


def memory_report() -> dict:
    """Ranked per-program memory table + live tensor breakdown + the
    caching allocator's statistics (``None`` without a card)."""
    from .. import engine as _engine

    return {"programs": program_table(), "live": _engine.live_memory(),
            "allocator": _allocator_stats()}


def format_memory_report(report=None, top: int = 10) -> str:
    """Human-readable rendering of :func:`memory_report` (the text that
    rides on a DeviceOOMError)."""
    report = report or memory_report()
    lines = ["programs ranked by peak bytes:"]
    rows = report["programs"][:top]
    if not rows:
        lines.append("  (no programs recorded)")
    for r in rows:
        lines.append(
            "  %-48s peak=%d arg=%d out=%d temp=%d alias=%d (%s)" % (
                r["program"][:48], r["peak_bytes"], r["argument_bytes"],
                r["output_bytes"], r["temp_bytes"], r["alias_bytes"],
                r["source"]))
    live = report["live"]
    lines.append("live device arrays: %d (%d bytes)"
                 % (live["arrays"], live["bytes"]))
    for t in live.get("top", []):
        lines.append("  %12d bytes  %s %s"
                     % (t["bytes"], t["dtype"], t["shape"]))
    alloc = report.get("allocator")
    if alloc:
        lines.append("caching allocator: allocated=%d reserved=%d "
                     "peak=%d retries=%d ooms=%d"
                     % (alloc["allocated_bytes"], alloc["reserved_bytes"],
                        alloc["peak_allocated_bytes"],
                        alloc["num_alloc_retries"], alloc["num_ooms"]))
    return "\n".join(lines)


_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "resource_exhausted",
                "Resource exhausted", "Out of memory", "out of memory",
                "can't allocate memory")


def is_oom(exc) -> bool:
    """Does this exception look like an allocator failure?
    ``torch.cuda.OutOfMemoryError``, the CPU allocator's ``can't
    allocate memory``, or the JAX package's RESOURCE_EXHAUSTED
    wording."""
    try:
        import torch

        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except Exception:  # noqa: BLE001 — no torch.cuda: markers only
        pass
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def reraise_if_oom(exc, site: str):
    """Dispatch-site guard: when ``exc`` is an allocator failure, log the
    ranked memory report and raise :class:`DeviceOOMError`
    (report attached, original exception chained).  Any other exception
    returns so the caller re-raises it unchanged."""
    if not is_oom(exc):
        return
    _TM_OOM.inc(site=site)
    try:
        text = format_memory_report()
    except Exception:  # noqa: BLE001 — the report must not mask the OOM
        text = "(memory report unavailable)"
    _logger.error("device OOM at %s\n%s", site, text)
    raise DeviceOOMError(
        f"device memory exhausted at {site}.\n{text}") from exc


# ---------------------------------------------------------------------------
# fused numerics sentinel
# ---------------------------------------------------------------------------
_pending: deque = deque()
_pending_lock = threading.Lock()


def sentinel_mode():
    """MXTPU_SENTINEL: None (off, default) | 'raise' | 'warn'."""
    raw = os.environ.get("MXTPU_SENTINEL", "0").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return None
    if raw == "warn":
        return "warn"
    return "raise"


def sentinel_window() -> int:
    """MXTPU_SENTINEL_WINDOW — parked records before a forced sync."""
    try:
        return max(int(os.environ.get("MXTPU_SENTINEL_WINDOW", "1024")), 8)
    except ValueError:
        return 1024


def sentinel_pending() -> int:
    return len(_pending)


def _host_all(values):
    """Parked sentinel values as numpy arrays, in order — the sync
    point: the tensors on one device are flattened into one buffer
    there and copied to the host in ONE transfer, so a boundary costs
    the same few reads however many steps were parked."""
    import numpy as np
    import torch

    out = [None] * len(values)
    by_dev = {}
    for i, v in enumerate(values):
        if hasattr(v, "detach"):
            by_dev.setdefault(v.device, []).append(i)
        else:
            out[i] = np.asarray(v, np.float32)
    for idx in by_dev.values():
        ts = [values[i].detach().reshape(-1).float() for i in idx]
        flat = ts[0] if len(ts) == 1 else torch.cat(ts)
        host = flat.cpu().numpy()
        off = 0
        for i in idx:
            n = values[i].numel()
            out[i] = host[off:off + n].reshape(tuple(values[i].shape))
            off += n
    return out


def sentinel_vector(tensors):
    """The packed sentinel tensor of ``tensors`` (gradients), on their
    device and unread: one 0/1 flag per tensor (1 when every element is
    finite), then their global L2 norm.  One multi-tensor norm in fp64
    gives both — a sum of squares of finite fp32 values cannot overflow
    fp64, so a tensor's norm is finite exactly when all its elements
    are — in a few launches however many tensors there are."""
    import torch

    norms = torch.stack(torch._foreach_norm(list(tensors), 2,
                                            dtype=torch.float64))
    return torch.cat([torch.isfinite(norms).float(),
                      norms.square().sum().sqrt().float().reshape(1)])


def sentinel_record(site: str, step: int, names, finite, norm=None,
                    packed_norm=False):
    """Park one step's sentinel outputs WITHOUT reading them.

    ``finite`` is a device tensor of 0/1 flags — one per key (1-D), or
    one per (step, key) for a multi-step dispatch (2-D, row i is step
    ``step + i``).  ``norm`` is the step's gradient-norm scalar; with
    ``packed_norm`` the norm rides as the LAST entry of ``finite``
    instead (one tensor per dispatch, the cheapest shape for the hot
    loop).  The tensors stay unread on the device until
    :func:`sentinel_check` syncs them at a reporting boundary,
    preserving the hot loop's zero-per-batch-sync property."""
    with _pending_lock:
        _pending.append({"site": site, "step": int(step),
                         "names": tuple(names), "finite": finite,
                         "norm": norm, "packed": bool(packed_norm)})
        overflow = len(_pending) > sentinel_window()
    if _reg.enabled():
        _TM_SENT_REC.inc(site=site)
    if overflow:
        sentinel_check(site="overflow")


def sentinel_check(site: str = "boundary"):
    """Sync every parked sentinel record (the fused path's ONLY
    device→host sentinel sync) and attribute non-finite flags.

    Returns the offender list ``[(step, site, key_name), ...]``; raises
    :class:`NumericsError` naming them under ``MXTPU_SENTINEL=raise``
    (warns under ``warn``).  No-op when nothing is parked."""
    with _pending_lock:
        if not _pending:
            return []
        recs = list(_pending)
        _pending.clear()
    if _reg.enabled():
        _TM_SENT_SYNC.inc(site=site)
    offenders = []
    vals = [r["finite"] for r in recs]
    vals += [r["norm"] for r in recs if r["norm"] is not None]
    host = iter(_host_all(vals))
    finite = [next(host) for _ in recs]
    norms = {id(r): next(host) for r in recs if r["norm"] is not None}
    for r, f in zip(recs, finite):
        if f.ndim == 0:
            f = f.reshape(1)
        rows = f.reshape(1, -1) if f.ndim == 1 else f
        steps = ([r["step"]] if f.ndim == 1
                 else [r["step"] + i for i in range(rows.shape[0])])
        norm = norms.get(id(r))
        if r.get("packed"):
            norm = rows[-1, -1]
            rows = rows[:, :-1]
        for row, step_id in zip(rows, steps):
            for j, ok in enumerate(row):
                if not ok:
                    name = (r["names"][j] if j < len(r["names"])
                            else f"#{j}")
                    offenders.append((step_id, r["site"], name))
        if norm is not None and _reg.enabled():
            try:
                _TM_SENT_NORM.set(float(norm), site=r["site"])
            except Exception:  # noqa: BLE001
                pass
    if not offenders:
        return []
    if _reg.enabled():
        for _, osite, _ in offenders:
            _TM_SENT_BAD.inc(site=osite)
    msg = ("non-finite gradient(s) detected by MXTPU_SENTINEL: "
           + "; ".join(f"step {s} [{b}] key {n!r}"
                       for s, b, n in offenders[:16])
           + (f" (+{len(offenders) - 16} more)"
              if len(offenders) > 16 else ""))
    if sentinel_mode() == "raise":
        raise NumericsError(msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return offenders


# ---------------------------------------------------------------------------
# fleet identity + cross-host clock correlation (telemetry/fleet.py)
# ---------------------------------------------------------------------------
def host_identity() -> dict:
    """Who this process is in the fleet: host / pid / rank / generation.

    Env view on purpose (``MXTPU_RANK`` / ``MXTPU_DIST_GENERATION``, the
    JAX package's contract) — stamping a flight dump or a health probe
    must never initialise CUDA."""
    import socket

    def _int_env(name, alt=None):
        try:
            return int(os.environ.get(name, os.environ.get(alt, "0")
                                      if alt else "0") or 0)
        except ValueError:
            return 0

    return {"host": socket.gethostname(), "pid": os.getpid(),
            "rank": _int_env("MXTPU_RANK", "DMLC_RANK"),
            "generation": _int_env("MXTPU_DIST_GENERATION")}


_clock = {"offset_s": 0.0, "rtt_s": None, "at": None, "source": "none"}
_clock_lock = threading.Lock()


def set_clock_offset(offset_s: float, rtt_s=None, source="coordinator"):
    """Record this host's clock-offset estimate vs the coordinator.

    ``offset_s`` is (coordinator clock - local clock), as the
    coordinator client (:mod:`mxnet_tpu_torch.parallel.coordinator`)
    derives it from each heartbeat's RTT midpoint.  The estimate rides
    every flight dump and span so a trace merger can put per-host lanes
    on one timebase."""
    with _clock_lock:
        _clock["offset_s"] = float(offset_s)
        _clock["rtt_s"] = None if rtt_s is None else float(rtt_s)
        _clock["at"] = time.time()
        _clock["source"] = str(source)


def clock_offset() -> dict:
    """Latest clock-offset estimate ({offset_s, rtt_s, at, source})."""
    with _clock_lock:
        return dict(_clock)


def step_time_stats(window: int = 32) -> dict:
    """Per-step timing summary from the newest ``window`` flight-ring
    records — the straggler-detection feed the coordinator heartbeat
    reports.  Pure host-side ring reads (the records were stamped by
    the fit loops without syncing the device), so attaching this to
    every heartbeat preserves the zero-per-batch-host-sync property.

    Returns ``{count}`` plus, when the ring has them, ``step_wall_s``
    (mean wall seconds per step: explicit ``wall_s`` fields, falling
    back to deltas of the records' wall stamps), ``dispatch_s`` (mean
    dispatch latency) and ``last_step_t``."""
    recs = flight_ring()[-max(int(window), 2):]
    walls, disps = [], []
    prev_t = None
    for r in recs:
        w = r.get("wall_s")
        t = r.get("t")
        if w is None and prev_t is not None and t is not None:
            w = t - prev_t
        if t is not None:
            prev_t = t
        if w is not None and 0 <= w:
            walls.append(float(w))
        d = r.get("dispatch_s")
        if d is not None:
            disps.append(float(d))
    out = {"count": len(recs)}
    if walls:
        out["step_wall_s"] = sum(walls) / len(walls)
    if disps:
        out["dispatch_s"] = sum(disps) / len(disps)
    if recs and recs[-1].get("t") is not None:
        out["last_step_t"] = recs[-1]["t"]
    return out


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
_OFF = ("0", "off", "false", "no")


def _flight_raw() -> str:
    return os.environ.get("MXTPU_FLIGHT_RECORD", "1").strip()


def flight_enabled() -> bool:
    """MXTPU_FLIGHT_RECORD gate (default on — a ring append per step)."""
    return _flight_raw().lower() not in _OFF


def _auto_dump_path():
    """A pathy MXTPU_FLIGHT_RECORD value enables crash auto-dump there."""
    raw = _flight_raw()
    if raw.lower() in _OFF or raw in ("1", "on", "true", "yes"):
        return None
    return raw


def flight_ring_size() -> int:
    try:
        return max(int(os.environ.get("MXTPU_FLIGHT_RING", "256")), 4)
    except ValueError:
        return 256


_ring: deque = deque(maxlen=flight_ring_size())
_ring_lock = threading.Lock()
_step_seq = 0


def _fault_slow_s() -> float:
    """MXTPU_FAULT_SLOW_S — seconds the ``slow_step`` fault site parks
    each step (default 0.05): the injected-straggler knob."""
    try:
        return max(float(os.environ.get("MXTPU_FAULT_SLOW_S", "0.05")), 0.0)
    except ValueError:
        return 0.05


def record_step(**fields):
    """Append one per-step record to the ring (host-only, no sync).

    Callers pass whatever is cheap at the dispatch site — step/epoch
    ids, pipeline depth, dispatch latency, program signature; a global
    sequence number, wall-clock stamp, and the sentinel backlog are
    added here.

    Fault site ``slow_step`` (docs/fault_tolerance.md): a ``drop``
    parks the host ``MXTPU_FAULT_SLOW_S`` here before stamping, so the
    ring's step walls — and everything downstream of them: heartbeat
    step stats, the coordinator's skew computation — see a genuinely
    slow host.  The straggler-detection tests ride this."""
    global _ring, _step_seq
    if not flight_enabled():
        return None
    from .. import faults as _faults

    if _faults.active() and _faults.should_drop("slow_step"):
        time.sleep(_fault_slow_s())
    rec = dict(fields)
    with _ring_lock:
        _step_seq += 1
        rec.setdefault("seq", _step_seq)
        rec.setdefault("t", time.time())
        rec.setdefault("sentinel_pending", len(_pending))
        if _ring.maxlen != flight_ring_size():
            _ring = deque(_ring, maxlen=flight_ring_size())
        _ring.append(rec)
    if _reg.enabled():
        _TM_FLIGHT_REC.inc()
    return rec


def flight_ring():
    """Snapshot of the ring, oldest first."""
    with _ring_lock:
        return list(_ring)


def _default_dump_name() -> str:
    """Rank/generation-aware dump filename: N workers per host (or per
    generation) must never overwrite each other's black boxes."""
    ident = host_identity()
    return ("mxtpu_flight_record_r%d_g%d_%d.json"
            % (ident["rank"], ident["generation"], ident["pid"]))


def dump_flight_record(path=None, trigger: str = "manual") -> str:
    """Write the flight record as ONE JSON: the step-record ring, the
    registry snapshot, the executor's program-cache contents, the ranked
    memory report, the sentinel state, and this host's fleet identity
    (host/rank/generation + the coordinator clock-offset estimate, so
    ``tools/fleetstat.py merge-trace`` can lane and align it).
    Returns the path written."""
    from .. import executor as _executor

    if path is None:
        path = _auto_dump_path() or _default_dump_name()
    if os.path.isdir(path):
        path = os.path.join(path, _default_dump_name())
    with _executor._program_cache_lock:
        cache_keys = [repr(k)[:200] for k in _executor._program_cache]
    payload = {
        "version": 2,
        "time": time.time(),
        "trigger": trigger,
        "identity": {
            **host_identity(),
            "clock": clock_offset(),
            "coordinator": os.environ.get("MXTPU_COORD_ADDR",
                                          "").strip() or None,
        },
        "ring": flight_ring(),
        "registry": json_snapshot(),
        "program_cache": {
            "capacity": _executor.program_cache_capacity(),
            "size": len(cache_keys),
            "entries": cache_keys,
        },
        "memory": memory_report(),
        "sentinel": {"mode": sentinel_mode() or "off",
                     "pending": len(_pending)},
    }
    # the span buffer rides every dump — a post-mortem keeps the last
    # requests' traces, not just aggregate rings
    from . import tracing as _tracing

    payload["spans"] = _tracing.spans()
    # the perf-attribution ledgers ride too (lazy import: perf imports
    # this module), untruncated (topn<=0) so a post-mortem never reads a cut table
    from . import perf as _perf

    payload["perf"] = _perf.profile_payload(topn=0)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    _TM_FLIGHT_DUMP.inc(trigger=trigger)
    return path


def _step_suffix_path(path: str) -> str:
    """``.../flight.json`` -> ``.../flight_step<seq>.json`` — each auto
    dump gets its own file keyed by the flight ring's step sequence, so
    a SIGUSR1 (or repeated faults) never clobbers the previous dump."""
    root, ext = os.path.splitext(path)
    return f"{root}_step{_step_seq}{ext or '.json'}"


def _prune_dumps(path: str):
    """Bounded dump retention: keep the newest ``MXTPU_FLIGHT_RING``
    step-suffixed dumps sharing this path's stem (same knob as the
    in-memory ring — the black boxes rotate like the records do)."""
    import glob
    import re

    root, ext = os.path.splitext(path)
    base = re.sub(r"_step\d+$", "", root)
    pat = re.compile(re.escape(base) + r"_step(\d+)" + re.escape(ext or
                                                                 ".json")
                     + "$")
    found = []
    for f in glob.glob(glob.escape(base) + "_step*" + (ext or ".json")):
        m = pat.match(f)
        if m:
            found.append((int(m.group(1)), f))
    found.sort()
    for _, f in found[:-flight_ring_size()] if found else []:
        try:
            os.remove(f)
        except OSError:
            pass


def auto_dump(trigger: str):
    """Best-effort dump for crash/signal/fault paths.

    ``exception``/``fault`` dump only when ``MXTPU_FLIGHT_RECORD``
    names a path (an uncaught exception must not litter the cwd by
    default); ``signal`` always dumps (the operator asked).  Dumps are
    step-suffixed and rotated (``MXTPU_FLIGHT_RING`` files max) so
    successive triggers never clobber each other.  Never raises;
    returns the path written (or None)."""
    try:
        if not flight_enabled():
            return None
        path = _auto_dump_path()
        if path is None and trigger != "signal":
            return None
        if path is None:
            path = _default_dump_name()
        if os.path.isdir(path):
            path = os.path.join(path, _default_dump_name())
        if trigger != "exception":
            # live-run triggers (SIGUSR1, injected faults) recur: each
            # dump gets a step-id suffix and the set rotates under the
            # MXTPU_FLIGHT_RING retention; the terminal exception dump
            # keeps the exact configured path (one per process death)
            path = _step_suffix_path(path)
        out = dump_flight_record(path, trigger=trigger)
        if trigger != "exception":
            _prune_dumps(out)
        return out
    except Exception:  # noqa: BLE001 — a dump failure must not mask the crash
        _logger.exception("flight-record auto-dump failed")
        return None


def _install_sigusr1():
    """SIGUSR1 -> dump the flight record of a live run (main thread
    only; chains any previously-installed handler)."""
    import signal

    try:
        prev = signal.getsignal(signal.SIGUSR1)

        def _handler(signum, frame):
            auto_dump("signal")
            if callable(prev) and prev not in (signal.SIG_DFL,
                                               signal.SIG_IGN):
                prev(signum, frame)

        signal.signal(signal.SIGUSR1, _handler)
    except (ValueError, OSError, AttributeError):
        pass  # non-main thread / platform without SIGUSR1


if flight_enabled():
    _install_sigusr1()
