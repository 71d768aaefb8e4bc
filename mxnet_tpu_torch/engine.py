"""Host-side waiting and live-memory accounting of the port (the async
window and the live-array half of ``mxnet_tpu/engine.py``).

PyTorch launches CUDA work asynchronously, as PjRt dispatches, so a
training loop that never reads a value can run arbitrarily far ahead
of the card.  :class:`AsyncWindow` bounds that: each pushed step
records a CUDA event, and once more than ``depth`` steps are in flight
the host waits on the oldest event.  With fused metrics the window is
the only place the steady-state ``fit`` loop waits.  Its drain, and
:func:`wait_for_all`, are reporting boundaries: they sync the numerics
sentinel's parked flags (``MXTPU_SENTINEL``).  With telemetry on, the
window reports ``engine_pipeline_depth`` and each wait as a
``trainer_host_stall_seconds{site}`` observation; ``engine_naive_mode``
says whether ``MXNET_ENGINE_TYPE=NaiveEngine`` is set.

:func:`track` registers every NDArray's tensor (weakly) so
:func:`live_memory` can rank the live ones for the OOM report;
:func:`on_push` makes every imperative op wait under
``MXNET_ENGINE_TYPE=NaiveEngine``; :func:`wait_for_var` is
``Engine::WaitForVar``.

The host task engine (:func:`push`, :func:`new_host_var`,
:func:`wait_for_host_var`, :func:`wait_for_all_host`) runs host work —
the reference's IO prefetch, checkpoint writes and staging lambdas —
on the native var-ordered scheduler of ``src/engine.cc``
(``_native.NativeEngine``, ``MXNET_CPU_WORKER_NTHREADS`` threads, 0 for
one a core).  Device work is ordered by CUDA streams, not here.
``MXNET_ENGINE_TYPE=NaiveEngine`` runs each task on the pushing thread,
and so does a host where the library cannot be built.
"""
from __future__ import annotations

import os
import time
import weakref
from collections import deque

import torch

from . import telemetry as _tm

__all__ = ["async_depth", "AsyncWindow", "wait_for_all", "wait_for_var",
           "track", "live_memory", "on_push", "host_engine", "push",
           "new_host_var", "wait_for_host_var", "wait_for_all_host"]

_live_arrays: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
    weakref.WeakValueDictionary()
_counter = 0
_live_bytes = 0.0

# --- telemetry families (the JAX package's names) ---------------------------
_TM_LIVE = _tm.gauge(
    "engine_live_arrays",
    "live device arrays currently tracked for wait_for_all")
_TM_LIVE_BYTES = _tm.gauge(
    "engine_live_bytes",
    "total bytes of the live tracked device arrays (running total while "
    "telemetry is enabled; the OOM report's live breakdown recomputes "
    "exactly on demand)")
_TM_NAIVE = _tm.gauge(
    "engine_naive_mode",
    "1 when MXNET_ENGINE_TYPE=NaiveEngine (every dispatch blocks)")
_TM_WAIT_SEC = _tm.histogram(
    "engine_wait_seconds",
    "time the host blocked on device results (wait_to_read / "
    "wait_for_all)", labels=("call",))
_TM_PIPE_DEPTH = _tm.gauge(
    "engine_pipeline_depth",
    "training steps currently in flight in the loop's bounded async "
    "window")
_TM_HOST_STALL = _tm.histogram(
    "trainer_host_stall_seconds",
    "host time blocked on an in-flight step (site=window: the async "
    "window was full; site=boundary: an epoch/checkpoint boundary "
    "drained it)", labels=("site",))


def _nbytes(t) -> int:
    try:
        return int(t.numel()) * int(t.element_size())
    except Exception:  # noqa: BLE001 — non-tensor trackees count as 0
        return 0


def _on_freed(nbytes):
    global _live_bytes
    _live_bytes -= nbytes
    if _tm.enabled():
        _TM_LIVE_BYTES.set(max(_live_bytes, 0.0))


def track(t) -> int:
    """Register a live tensor (weakly) for :func:`live_memory`; with
    telemetry on, its bytes join the ``engine_live_bytes`` gauge until it
    is freed."""
    global _counter, _live_bytes
    _counter += 1
    try:
        _live_arrays[_counter] = t
    except TypeError:
        return _counter
    if _tm.enabled():
        _TM_LIVE.set(len(_live_arrays))
        nbytes = _nbytes(t)
        if nbytes:
            _live_bytes += nbytes
            weakref.finalize(t, _on_freed, nbytes)
        _TM_LIVE_BYTES.set(max(_live_bytes, 0.0))
    return _counter


def live_memory(top: int = 10) -> dict:
    """Exact live-tensor breakdown computed on demand (count, total
    bytes, the ``top`` largest tensors) — the OOM report's live view,
    independent of the telemetry switch."""
    items = []
    total = 0
    for t in list(_live_arrays.values()):
        nbytes = _nbytes(t)
        total += nbytes
        items.append((nbytes, str(t.dtype).replace("torch.", ""),
                      str(tuple(t.shape))))
    items.sort(reverse=True)
    return {"arrays": len(items), "bytes": total,
            "top": [{"bytes": b, "dtype": d, "shape": s}
                    for b, d, s in items[:top]]}


def _engine_is_naive() -> bool:
    naive = os.environ.get("MXNET_ENGINE_TYPE",
                           "ThreadedEnginePerDevice") == "NaiveEngine"
    _TM_NAIVE.set(1.0 if naive else 0.0)
    return naive


def async_depth(default: int = 2) -> int:
    """``MXTPU_ASYNC_DEPTH``: how many training steps the host may run
    ahead of the card (at least 1).  ``MXNET_ENGINE_TYPE=NaiveEngine``
    forces 1."""
    try:
        depth = int(os.environ.get("MXTPU_ASYNC_DEPTH", default))
    except ValueError:
        depth = default
    if _engine_is_naive():
        return 1
    return max(1, depth)


def _cuda_device(handle):
    """The CUDA device of the first tensor in ``handle`` (a tensor, an
    NDArray or a list of them), or None when none lies on a card."""
    items = handle if isinstance(handle, (list, tuple)) else [handle]
    for h in items:
        t = getattr(h, "tensor", h)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return None


class AsyncWindow:
    """Bounded window of steps in flight.

    :meth:`push` takes a dispatched step's outputs and records a CUDA
    event behind them on the current stream; once more than ``depth``
    steps are in flight the host waits on the OLDEST event.  Outputs on
    the CPU are already computed and record nothing.  :meth:`drain`
    waits for everything in flight (epoch end, any boundary that needs
    the card caught up).  With telemetry on, ``engine_pipeline_depth``
    follows the steps in flight and each step leaving the window is a
    ``trainer_host_stall_seconds`` observation (``site="window"`` when
    the window was full, the drain's ``site`` otherwise): host clock
    stamps around the event wait the window makes anyway."""

    def __init__(self, depth=None):
        self.depth = async_depth() if depth is None else max(1, int(depth))
        self._dq = deque()
        self.waits = 0  # host waits on an event, for the loops' counters

    def __len__(self):
        return len(self._dq)

    def push(self, handle):
        device = _cuda_device(handle)
        event = None
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        self._dq.append(event)
        if _tm.enabled():
            _TM_PIPE_DEPTH.set(len(self._dq))
        while len(self._dq) > self.depth:
            self._wait_one("window")

    def _wait_one(self, site):
        event = self._dq.popleft()
        t0 = time.perf_counter() if _tm.enabled() else None
        if event is not None:
            self.waits += 1
            event.synchronize()
        if t0 is not None:
            _TM_HOST_STALL.observe(time.perf_counter() - t0, site=site)
            _TM_PIPE_DEPTH.set(len(self._dq))

    def drain(self, site: str = "boundary"):
        while self._dq:
            self._wait_one(site)
        # epoch/checkpoint boundaries are the loops' reporting points:
        # the sentinel syncs HERE (never per batch), where fused metrics
        # drain
        _tm.health.sentinel_check("boundary")


def on_push(result):
    """Called after every imperative op: under ``NaiveEngine`` each op
    waits for its own launches (parity with src/engine/naive_engine.cc,
    where work runs on the pushing thread)."""
    if _engine_is_naive():
        dev = _cuda_device(result)
        if dev is not None:
            torch.cuda.current_stream(dev).synchronize()
    return result


def wait_for_var(t):
    """Wait until ``t``'s producing launches are done (parity:
    ``Engine::WaitForVar``, include/mxnet/engine.h:180)."""
    dev = _cuda_device(t)
    if dev is None:
        return
    t0 = time.perf_counter() if _tm.enabled() else None
    torch.cuda.current_stream(dev).synchronize()
    if t0 is not None:
        _TM_WAIT_SEC.observe(time.perf_counter() - t0, call="wait_for_var")


def wait_for_all():
    """Wait for every launch on every card (parity:
    ``Engine::WaitForAll``), then sync the sentinel's parked flags: the
    device is drained, a reporting boundary."""
    t0 = time.perf_counter() if _tm.enabled() else None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    if t0 is not None:
        _TM_WAIT_SEC.observe(time.perf_counter() - t0, call="wait_for_all")
    _tm.health.sentinel_check("boundary")


# --- the host task engine ----------------------------------------------------
_host_engine = None


def host_engine():
    """The process's ``NativeEngine`` (built on first use), or None when
    the native library cannot be built here."""
    global _host_engine
    if _host_engine is None:
        from . import _native

        try:
            threads = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS", "0")
                          or 0)
        except ValueError:
            threads = 0
        _host_engine = _native.NativeEngine(num_threads=threads) \
            if _native.available() else False
    return _host_engine or None


def push(fn, const_vars=(), mutable_vars=(), priority=0):
    """Run ``fn()`` on the host engine once the tasks before it on its
    vars are done: writers of a var (``mutable_vars``) one at a time in
    push order, readers (``const_vars``) side by side (parity:
    Engine::PushAsync, include/mxnet/engine.h:125).  Synchronous under
    ``NaiveEngine`` or without the library."""
    eng = host_engine()
    if eng is None or _engine_is_naive():
        fn()
        return
    eng.push(fn, const_vars=const_vars, mutable_vars=mutable_vars,
             priority=priority)


def new_host_var():
    """A new var of the host engine (parity: Engine::NewVariable); 0
    without the library, where every task runs synchronously."""
    eng = host_engine()
    return eng.new_var() if eng is not None else 0


def wait_for_host_var(var):
    """Wait for the host tasks of ``var``; a task's exception is raised
    here."""
    eng = host_engine()
    if eng is not None:
        eng.wait_for_var(var)


def wait_for_all_host():
    """Wait for every host task; a task's exception is raised here."""
    eng = host_engine()
    if eng is not None:
        eng.wait_all()
