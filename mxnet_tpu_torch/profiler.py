"""Operator-level profiler emitting chrome://tracing JSON (mirrors
``mxnet_tpu/profiler.py``; parity: src/engine/profiler.{h,cc} and
python/mxnet/profiler.py, with the ``MXNET_PROFILER_AUTOSTART`` and
``MXNET_PROFILER_MODE`` knobs of docs/how_to/env_var.md).

Host spans: ``mode="symbolic"`` records the executors' ``forward[...]``
and ``forward_backward[...]`` spans and ``FusedTrainer.step``'s;
``mode="all"`` adds every imperative ``nd`` op (category
``imperative``).  A span on the card closes after a device
synchronisation, as the reference's closes after
``block_until_ready``, so it measures the work and not its enqueue:
while the profiler runs, every profiled region syncs; while it is off,
none does.  ``dump_profile`` writes the spans as chrome-trace ``X``
events (``profile.json``) and clears them.

Device trace: the reference's ``xla_trace_dir`` starts an xprof trace
through ``jax.profiler``.  The port keeps the keyword: with it set,
``profiler_set_state("run")`` starts a ``torch.profiler`` trace (CUDA
activity when a card is present, with the host's op ranges) and
``"stop"`` writes it as a chrome trace into that directory
(``<host>.<pid>.<n>.pt.trace.json``; :func:`device_trace_files` lists
them).  The two files keep their own clocks, as the reference's host
spans and xprof trace do: :func:`now_us` is the profiler's monotonic
timeline, the device trace's timestamps are torch.profiler's.  Only
one ``torch.profiler`` can run in a process at a time.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from contextlib import contextmanager

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "clear", "record", "span", "now_us", "is_running", "mode",
           "device_sync", "device_trace_files"]

_lock = threading.Lock()
_state = {
    "mode": os.environ.get("MXNET_PROFILER_MODE", "symbolic"),
    "filename": "profile.json",
    "running": os.environ.get("MXNET_PROFILER_AUTOSTART", "0").strip()
    not in ("", "0"),
    "xla_trace_dir": None,
    "trace": None,        # the running torch.profiler.profile
    "traces": [],         # the device trace files written
}
_events: list = []
_t0 = time.monotonic()


def now_us() -> float:
    """Microseconds on the profiler's timeline (the timebase of every
    host span, telemetry spans included)."""
    return (time.monotonic() - _t0) * 1e6


def profiler_set_config(mode="symbolic", filename="profile.json",
                        xla_trace_dir=None):
    """``mode`` is ``"symbolic"`` (executor spans) or ``"all"``
    (imperative ops too, each synced); ``xla_trace_dir`` also captures
    a device trace there while the profiler runs."""
    if mode not in ("symbolic", "all"):
        raise ValueError("mode must be 'symbolic' or 'all'")
    with _lock:
        _state["mode"] = mode
        _state["filename"] = filename
        _state["xla_trace_dir"] = xla_trace_dir


def _start_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _state["trace"] = prof


def _stop_trace():
    prof, _state["trace"] = _state["trace"], None
    prof.stop()
    directory = _state["xla_trace_dir"]
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{socket.gethostname()}.{os.getpid()}."
                        f"{len(_state['traces'])}.pt.trace.json")
    prof.export_chrome_trace(path)
    _state["traces"].append(path)


def profiler_set_state(state="stop"):
    """``"run"`` or ``"stop"`` (parity: MXSetProfilerState)."""
    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    with _lock:
        _state["running"] = state == "run"
        if _state["running"] and _state["xla_trace_dir"] \
                and _state["trace"] is None:
            _start_trace()
        elif not _state["running"] and _state["trace"] is not None:
            _stop_trace()


def device_trace_files() -> list:
    """The device traces written so far, oldest first."""
    with _lock:
        return list(_state["traces"])


def is_running() -> bool:
    return _state["running"]


def mode() -> str:
    return _state["mode"]


def record(name: str, device: str, start_us: float, end_us: float,
           category: str = "operator"):
    """Append one complete (``X``) chrome-trace event (parity:
    OprExecStat + EmitEvent, src/engine/profiler.h:90-110)."""
    with _lock:
        _events.append({
            "name": name,
            "cat": category,
            "ph": "X",
            "ts": start_us,
            "dur": max(end_us - start_us, 0.0),
            "pid": device,
            "tid": threading.get_ident() & 0xFFFF,
        })


def device_sync(device):
    """A zero-argument callable that waits for ``device``'s queued work
    (None on the host, where the work is done when the call returns)."""
    import torch

    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    return lambda: torch.cuda.synchronize(device)


@contextmanager
def span(name: str, device: str = "cpu/0", category: str = "operator",
         sync=None):
    """Time a region while the profiler runs; ``sync`` (a zero-argument
    callable) runs before the span closes so asynchronous work is
    counted."""
    if not _state["running"]:
        yield
        return
    start = now_us()
    try:
        yield
    finally:
        if sync is not None:
            sync()
        record(name, device, start, now_us(), category)


def dump_profile(filename=None):
    """Write the recorded events as chrome://tracing JSON and clear them
    (parity: MXDumpProfile); returns the file name."""
    fname = filename or _state["filename"]
    with _lock:
        payload = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
        _events.clear()
    with open(fname, "w") as f:
        json.dump(payload, f)
    return fname


def clear():
    with _lock:
        _events.clear()
