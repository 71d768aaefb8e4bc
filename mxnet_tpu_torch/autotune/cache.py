"""The schedule cache: pure lookup side of the autotuner.

The port of ``mxnet_tpu/autotune/cache.py``.  This module is
import-light (stdlib only; torch is touched lazily and exactly once, to
name the device kind) and side-effect-free on the hot path:
:func:`schedule_for` is a dict read — no telemetry, no clock, no device
— so a kernel wrapper may call it at every launch, inside a CUDA-graph
capture too.  All measuring, counting and persistence lives in
:mod:`mxnet_tpu_torch.autotune.search`.

Cache layout (``MXTPU_SCHEDULE_CACHE``) — one JSON document::

    {"version": 1,
     "entries": {
       "<device_kind>": {
         "<kernel>|<keysig>": {"schedule": {...}, "best_us": 12.3,
                               "trials": 5}}}}

Entries are segregated by *device kind* (the sanitized
``torch.cuda.get_device_name()`` on a card, ``"cpu"`` without one — the
string the JAX package writes on the CPU): a CPU-rig search can never
pollute the schedules a card will load, one shared cache file serves a
heterogeneous fleet, and a file either package wrote on the CPU loads
in the other.  A corrupt, unreadable or version-mismatched file
degrades to an empty cache — defaults win, nothing raises.

Modes (parsed by :func:`cache_spec` from ``MXTPU_SCHEDULE_CACHE``):

- unset / ``""`` / ``off`` / ``0`` — autotuning off: every consumer
  uses its built-in default schedule;
- ``readonly:<path>`` — load winners, never search, never write
  (production serving: tuned elsewhere, pinned here);
- ``search:<path>`` or a bare ``<path>`` — load winners, search on
  miss, persist new winners atomically.
"""
from __future__ import annotations

import json
import os
import re
import threading

__all__ = [
    "SCHEMA_VERSION", "cache_spec", "device_kind", "prime",
    "schedule_for", "record", "fingerprint", "load_file", "reset",
]

SCHEMA_VERSION = 1

_lock = threading.RLock()


class _CacheState:
    """Process-wide lookup state, held as attributes (not module
    globals), as the JAX package keeps it."""

    def __init__(self):
        # (device_kind, kernel, keysig) -> schedule dict
        self.memo = {}
        # paths whose on-disk entries were folded into memo already
        self.loaded = set()
        # bumped on every record() and first disk load — composed into
        # the executor program-cache key (fingerprint), so a schedule
        # change re-keys the programs bound under the old winner
        self.epoch = 0
        self.kind = None


_state = _CacheState()


def cache_spec():
    """``(mode, path)`` from ``MXTPU_SCHEDULE_CACHE``: ``("off", None)``,
    ``("readonly", path)`` or ``("search", path)``."""
    raw = os.environ.get("MXTPU_SCHEDULE_CACHE", "").strip()
    if raw.lower() in ("", "0", "off", "false"):
        return ("off", None)
    if raw.startswith("readonly:"):
        return ("readonly", raw[len("readonly:"):])
    if raw.startswith("search:"):
        return ("search", raw[len("search:"):])
    return ("search", raw)


def _raw_kind() -> str:
    """The card's name (``torch.cuda.get_device_name()``), or ``"cpu"``
    when no card is visible."""
    try:
        import torch

        if torch.cuda.is_available():
            return torch.cuda.get_device_name(torch.cuda.current_device())
    except Exception:  # noqa: BLE001 — naming must never raise
        return "unknown"
    return "cpu"


def device_kind() -> str:
    """Sanitized device name — the segregation key of the on-disk
    cache.  Memoized; the one place this module touches torch."""
    if _state.kind is None:
        _state.kind = re.sub(r"[^A-Za-z0-9_.-]+", "_",
                             str(_raw_kind())).strip("_") or "unknown"
    return _state.kind


def load_file(path):
    """Parse one cache file; ``{}`` for anything unusable (missing,
    unreadable, bad JSON, wrong schema version, wrong shape)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) or doc.get("version") != SCHEMA_VERSION:
        return {}
    entries = doc.get("entries")
    return entries if isinstance(entries, dict) else {}


def _fold_disk(path):
    """Merge ``path``'s entries for THIS device kind into the memo
    (memo entries win: in-process winners are fresher)."""
    kind = device_kind()
    loaded = 0
    for ks, ent in (load_file(path).get(kind) or {}).items():
        if "|" not in ks or not isinstance(ent, dict):
            continue
        kernel, keysig = ks.split("|", 1)
        sched = ent.get("schedule")
        if isinstance(sched, dict):
            _state.memo.setdefault((kind, kernel, keysig), sched)
            loaded += 1
    if loaded:
        _state.epoch += 1


def prime():
    """The MUTATING half of lookup: resolve the device kind and fold
    the on-disk cache into the memo.  Host-side bind/tune sites call
    this (``fingerprint`` at every executor bind, ``search.ensure`` at
    every tuning site) so :func:`schedule_for` can stay a pure READ
    even when tracing reaches it."""
    mode, path = cache_spec()
    if mode == "off":
        return
    device_kind()
    with _lock:
        if path not in _state.loaded:
            _state.loaded.add(path)
            _fold_disk(path)


def schedule_for(kernel: str, keysig: str, default):
    """The tuned schedule for ``(kernel, keysig)`` on this device kind,
    or ``default`` when autotuning is off / nothing is cached.

    PURE lookup — no telemetry, no clock, no device, no writes of any
    kind: the residual epilogue reads its launch schedule here at every
    launch.  The memo it reads is primed by the host-side bind paths
    (:func:`prime`); an unprimed process just gets defaults.  Hit/miss accounting happens in ``search.ensure``,
    which owns the measuring side."""
    mode, path = cache_spec()
    if mode == "off":
        return default
    with _lock:
        if _state.kind is None or path not in _state.loaded:
            return default
        return _state.memo.get((_state.kind, kernel, keysig), default)


def record(kernel: str, keysig: str, schedule, best_us, trials,
           persist=True):
    """Install a search winner in the memo and (in ``search`` mode,
    when ``persist``) merge it into the on-disk cache atomically
    (tmp file + ``os.replace``; existing entries for other kernels and
    device kinds are preserved)."""
    kind = device_kind()
    mode, path = cache_spec()
    with _lock:
        _state.memo[(kind, kernel, keysig)] = dict(schedule)
        _state.epoch += 1
        if not (persist and mode == "search" and path):
            return
        entries = load_file(path)
        entries.setdefault(kind, {})["%s|%s" % (kernel, keysig)] = {
            "schedule": dict(schedule),
            "best_us": round(float(best_us), 3),
            "trials": int(trials),
        }
        tmp = "%s.tmp.%d" % (path, os.getpid())
        try:
            with open(tmp, "w") as f:
                json.dump({"version": SCHEMA_VERSION, "entries": entries},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            # persistence is best-effort: the in-memory winner still
            # applies to this process
            try:
                os.remove(tmp)
            except OSError:
                pass


def fingerprint():
    """What the executor composes into its program-cache key: the cache
    mode + path select which winners load, the epoch re-keys programs
    bound under an older winner (and ``FusedTrainer`` re-captures its
    CUDA graphs when it moves).  Called host-side at every bind, so it
    doubles as the priming hook — the disk cache is folded in BEFORE the
    epoch is read and BEFORE a launch consults :func:`schedule_for`."""
    prime()
    mode, path = cache_spec()
    with _lock:
        return (mode, path, _state.epoch)


def reset():
    """Forget every in-memory winner and disk load (test isolation)."""
    with _lock:
        _state.memo.clear()
        _state.loaded.clear()
        _state.epoch += 1
