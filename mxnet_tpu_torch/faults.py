"""Fault injection (``MXTPU_FAULT_PLAN``; mirrors ``mxnet_tpu/faults.py``).

The recovery paths — a checkpoint that falls back to the last published
one, a serving engine that survives a failed admission — stay correct
only while they are exercised.  This module injects failures at named
sites so tests prove each fault path ends in recovery or in a clean,
named error, never in a hang or silent corruption.

Plan grammar (comma-separated ``<site>:<mode>:<arg>`` entries; the last
entry of a site wins)::

    MXTPU_FAULT_PLAN="kv_push:err:0.01,ckpt_write:crash_after:3"

Modes: ``err:<p>`` raises :class:`InjectedFault` with probability ``p``;
``drop:<p>`` asks the site to lose its payload with probability ``p``;
``err_first:<n>``/``drop_first:<n>`` do so on the first ``n`` hits, then
never; ``crash_after:<n>`` lets ``n`` hits pass and ends the process
with ``os._exit(137)`` (the SIGKILL-shaped exit of a preemption) on hit
``n + 1``.  The draws come from Python's ``random.Random`` seeded by
``MXTPU_FAULT_SEED`` (default 0), as in the JAX package, so one plan
and seed fire at the same hits in both packages.  Every injected fault
counts in ``fault_injected_total{site,mode}``.

Sites wired in the port: ``kv_push`` and ``kv_pull`` (``KVStore.push``/
``pull``, the bucketed update included), ``ckpt_write`` (the checkpoint
writer: no manifest is published) and ``serve_admit`` (a serving
admission: the request fails, the engine serves on), ``replica_kill``
(a serving engine tick: ``crash_after`` kills the replica mid-decode),
``serve_slow`` (a serving engine tick: ``drop`` parks the engine
thread for :func:`fault_slow_s` seconds) and ``slow_step`` (the flight
recorder's per-step record, ``telemetry.health.record_step``: ``drop``
parks the training host as long, so the ring's step walls see a
straggler).  The reference's other sites belong to modules not ported
yet; a site no code fires, or one a plan does not name, never fires.
An injected error, and a ``crash_after`` crash, first write the flight
record (``telemetry.health.auto_dump("fault")``) when
``MXTPU_FLIGHT_RECORD`` names a path, and the error names the dump.
"""
from __future__ import annotations

import logging
import os
import random
import threading

from . import telemetry as _tm
from .base import MXNetError

__all__ = ["InjectedFault", "plan", "active", "fire", "maybe_fail",
           "should_drop", "reset", "fault_slow_s"]

_logger = logging.getLogger("mxnet_tpu_torch.faults")

_TM_INJECTED = _tm.counter(
    "fault_injected_total",
    "faults injected by the MXTPU_FAULT_PLAN harness at a named site "
    "(mode=err/drop/crash)", labels=("site", "mode"))

_MODES = ("err", "drop", "err_first", "drop_first", "crash_after")


class InjectedFault(MXNetError):
    """A failure injected by ``MXTPU_FAULT_PLAN`` (the plan is the only
    trigger)."""


class _Entry:
    __slots__ = ("site", "mode", "arg", "hits")

    def __init__(self, site, mode, arg):
        self.site = site
        self.mode = mode
        self.arg = arg
        self.hits = 0


_lock = threading.Lock()
_state = {"raw": None, "plan": {}, "rng": None}


def _parse(raw: str):
    entries = {}
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        if len(parts) != 3:
            raise MXNetError(
                f"MXTPU_FAULT_PLAN entry {item!r}: expected "
                "'<site>:<mode>:<arg>' "
                "(e.g. 'kv_push:err:0.01,ckpt_write:crash_after:3')")
        site, mode, arg = (p.strip() for p in parts)
        if mode not in _MODES:
            raise MXNetError(
                f"MXTPU_FAULT_PLAN entry {item!r}: unknown mode {mode!r} "
                f"(supported: {', '.join(_MODES)})")
        try:
            if mode in ("err", "drop"):
                val = float(arg)
                if not 0.0 <= val <= 1.0:
                    raise ValueError
            else:
                val = int(arg)
                if val < 0:
                    raise ValueError
        except ValueError:
            kind = ("a probability in [0, 1]" if mode in ("err", "drop")
                    else "a non-negative integer")
            raise MXNetError(
                f"MXTPU_FAULT_PLAN entry {item!r}: arg must be {kind}, "
                f"got {arg!r}") from None
        entries[site] = _Entry(site, mode, val)
    return entries


def plan() -> dict:
    """The parsed plan (site -> entry), read again whenever the
    environment's plan changes (hit counts and draws restart then)."""
    raw = os.environ.get("MXTPU_FAULT_PLAN", "")
    with _lock:
        if raw != _state["raw"]:
            _state["plan"] = _parse(raw) if raw.strip() else {}
            _state["raw"] = raw
            _state["rng"] = random.Random(
                int(os.environ.get("MXTPU_FAULT_SEED", "0") or 0))
        return _state["plan"]


def fault_slow_s() -> float:
    """``MXTPU_FAULT_SLOW_S`` — seconds a slow-fault site parks its
    thread (default 0.05), read by ``telemetry.health._fault_slow_s``."""
    return _tm.health._fault_slow_s()


def active() -> bool:
    return bool(plan())


def reset():
    """Forget the hit counts and the draw stream (test isolation)."""
    with _lock:
        _state["raw"] = None
        _state["plan"] = {}
        _state["rng"] = None


def fire(site: str):
    """Evaluate the plan at ``site``: ``None`` (no fault), ``"err"`` or
    ``"drop"``; a tripped ``crash_after`` never returns."""
    entries = plan()
    if not entries:
        return None
    e = entries.get(site)
    if e is None:
        return None
    with _lock:
        e.hits += 1
        hits = e.hits
        if e.mode in ("err", "drop"):
            action = e.mode if _state["rng"].random() < e.arg else None
        elif e.mode in ("err_first", "drop_first"):
            action = e.mode.split("_")[0] if hits <= e.arg else None
        else:  # crash_after
            action = "crash" if hits > e.arg else None
    if action is None:
        return None
    if _tm.enabled():
        _TM_INJECTED.inc(site=site, mode=action)
    if action == "crash":
        _logger.error("MXTPU_FAULT_PLAN: crashing at site %r after %d "
                      "hits (crash_after:%d)", site, hits - 1, e.arg)
        # best-effort black box before the simulated preemption
        _tm.health.auto_dump("fault")
        os._exit(137)
    _logger.warning("MXTPU_FAULT_PLAN: injected %r at site %r (hit %d)",
                    action, site, hits)
    return action


def maybe_fail(site: str) -> bool:
    """The call sites' helper: raises :class:`InjectedFault` naming the
    site on ``err``, returns True on ``drop`` (the caller loses the
    payload), False when nothing fired."""
    action = fire(site)
    if action == "err":
        # the named error carries the black box (when
        # MXTPU_FLIGHT_RECORD names a dump path)
        dump = _tm.health.auto_dump("fault")
        raise InjectedFault(
            f"injected fault at site {site!r} (MXTPU_FAULT_PLAN)"
            + (f" (flight record: {dump})" if dump else ""))
    return action == "drop"


def should_drop(site: str) -> bool:
    """True when the plan asks this hit of ``site`` to lose its payload;
    ``err`` entries raise from here too."""
    return maybe_fail(site)
