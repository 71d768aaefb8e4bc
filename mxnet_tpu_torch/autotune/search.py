"""The measuring side of the autotuner: bounded schedule search.

The port of ``mxnet_tpu/autotune/search.py``.  TVM's observation
(arXiv:1802.04799), scoped to the port's two tunable CUDA kernels: no
single hand-picked launch schedule wins across shapes and cards, but a
SMALL per-(kernel, shape, dtype, device kind) search — warm-up and
best-of-k timing of each candidate, winner cached — recovers the
headroom at a one-time cost.  Searching happens only at bind/admit-time
call sites (``PagedSlots`` construction, an explicit epilogue
``tune()``), NEVER per tick and never inside a CUDA-graph capture:
:func:`measure` synchronises with the card by design, and the
steady-state loops only ever see the already-chosen schedule through the
pure :func:`~mxnet_tpu_torch.autotune.cache.schedule_for`.

Unlike the JAX package, a candidate whose build or launch raises is not
skipped: only a candidate its own gate refuses BEFORE launch (the
kernel's ``supports()``, a ``chunk_pages`` that does not fit) is, by
raising :class:`ScheduleRejected`.  A CUDA error during a search is a
fault of the kernel and propagates.
"""
from __future__ import annotations

import os
import time

from .. import telemetry as _tm
from ..base import MXNetError
from . import cache as _cache

__all__ = ["trials_budget", "measure", "ensure", "ScheduleRejected"]

# --- autotune metric families (the JAX package's names) ---------------------
_TM_TRIALS = _tm.counter(
    "autotune_trials_total",
    "candidate schedules benchmarked by the autotuner, per kernel "
    "(zero on a warm schedule cache: every consumer should hit)",
    labels=("kernel",))
_TM_CACHE = _tm.counter(
    "autotune_cache_total",
    "schedule-cache lookups at tuning call sites: hit = a persisted or "
    "in-process winner was reused, miss = none existed yet (a miss in "
    "search mode triggers a bounded search; in readonly mode the "
    "consumer keeps its default schedule)",
    labels=("result",))
_TM_BEST = _tm.gauge(
    "autotune_best_us",
    "best-of-k microseconds of the winning schedule at its last "
    "search, per kernel",
    labels=("kernel",))


class ScheduleRejected(MXNetError):
    """A candidate schedule its kernel's own gate refuses before any
    launch; :func:`ensure` skips it (any other error propagates)."""


def trials_budget() -> int:
    """``MXTPU_AUTOTUNE_TRIALS`` — max timings per search: candidates,
    and the four re-timings that confirm a winner over the default
    (default 16; 0 disables searching while still honoring cached
    winners)."""
    try:
        return max(int(os.environ.get("MXTPU_AUTOTUNE_TRIALS", "16")
                       or 16), 0)
    except ValueError:
        return 16


def _card_of(out):
    """The card of the first tensor of ``out`` that lies on one, else
    None (CPU work is done when the call returns)."""
    import torch

    items = out if isinstance(out, (list, tuple)) else [out]
    for t in items:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return None


def _timings(fn, warmup=2, best_of=5):
    """Microseconds of each of ``best_of`` timed calls of ``fn()`` (which
    returns its tensors), after ``warmup`` untimed ones.  Work on a card
    is timed by CUDA events on its current stream around the call, each
    call waited for before the next; CPU work by the host's clock."""
    import torch

    dev = None
    for _ in range(max(warmup, 0)):
        dev = _card_of(fn())
        if dev is not None:
            torch.cuda.synchronize(dev)
    out = []
    for _ in range(max(best_of, 1)):
        if dev is None:
            t0 = time.perf_counter()
            dev = _card_of(fn())
            if dev is not None:        # no warm-up told us: wait, and
                torch.cuda.synchronize(dev)   # time by the host's clock
            out.append((time.perf_counter() - t0) * 1e6)
            continue
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        fn()
        end.record(stream)
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3)
    return out


def measure(fn, warmup=2, best_of=5):
    """Best-of-k microseconds of ``fn()`` (:func:`_timings`: CUDA events
    on a card, the host's clock on the CPU).  The autotuner's sanctioned
    sync boundary — never reachable from a steady-state loop."""
    return min(_timings(fn, warmup=warmup, best_of=best_of))


def _spread(us):
    """The noise of one candidate's timings: its median less its best."""
    s = sorted(us)
    return s[len(s) // 2] - s[0]


def ensure(kernel: str, keysig: str, default, candidates, bench_fn,
           warmup=2, best_of=5, accept=None):
    """The tuning call site: return the schedule to install for
    ``(kernel, keysig)`` on this device kind.

    - cache ``off``: ``default``, no counters — the autotuner is out of
      the picture entirely;
    - cached winner (in-process or loaded from disk) that ``accept``
      (when given) takes: count a ``hit``, return it — zero trials; one
      it refuses (a winner another configuration recorded under the
      same key) is treated as a miss;
    - miss in ``readonly`` mode: count the miss, return ``default``;
    - miss in ``search`` mode: measure up to :func:`trials_budget`
      ``candidates`` through ``bench_fn(candidate) -> fn`` (the returned
      thunk is timed with warm-up + best-of-k), record + persist the
      winner, return it.  A candidate whose ``bench_fn`` raises
      :class:`ScheduleRejected` is skipped; any other error raises.  If
      every candidate is rejected, ``default`` wins.

    ``default`` should normally appear in ``candidates`` so a search
    can never do worse than not searching: when it was measured, a
    candidate replaces it only by beating its best by more than its
    spread (:func:`_spread`), so a winner inside the noise stays the
    default.  A winner that passes is then confirmed: it and the default
    are timed again, interleaved (winner, default, winner, default), and
    it is recorded only if its best still beats the best of the
    default's new timings by more than their spread; otherwise, or when
    the four re-timings do not fit in what is left of
    :func:`trials_budget`, the default is recorded.
    ``autotune_trials_total`` counts the re-timings too; the cache
    entry's ``trials`` counts the candidates.  The JAX package's
    ``ensure`` takes the plain minimum of one round: this stricter rule
    is the port's own, because one round on the card let a winner inside
    the noise replace the default.
    """
    mode, _path = _cache.cache_spec()
    if mode == "off":
        return default
    _cache.prime()
    sentinel = object()
    got = _cache.schedule_for(kernel, keysig, sentinel)
    if got is not sentinel and (accept is None or accept(got)):
        _TM_CACHE.inc(result="hit")
        return got
    _TM_CACHE.inc(result="miss")
    if mode == "readonly":
        return default
    best_sched, best_us, trials = None, float("inf"), 0
    best_fn = default_fn = default_us = None
    budget = trials_budget()
    for cand in candidates:
        if trials >= budget:
            break
        try:
            fn = bench_fn(cand)
        except ScheduleRejected:
            continue
        us = _timings(fn, warmup=warmup, best_of=best_of)
        trials += 1
        if cand == default:
            default_fn, default_us = fn, us
        if min(us) < best_us:
            best_sched, best_us, best_fn = cand, min(us), fn
    retimed = 0
    if default_us is not None and best_sched != default:
        if best_us < min(default_us) - _spread(default_us) and \
                trials + 4 <= budget:
            # confirm the gain on fresh, interleaved timings
            won_us, def_us = [], []
            for _ in range(2):
                won_us += _timings(best_fn, warmup=warmup, best_of=best_of)
                def_us += _timings(default_fn, warmup=warmup,
                                   best_of=best_of)
            retimed = 4
            if min(won_us) < min(def_us) - _spread(def_us):
                best_us = min(won_us)
            else:
                best_sched, best_us = default, min(def_us)
        else:
            best_sched, best_us = default, min(default_us)
    if trials:
        _TM_TRIALS.inc(trials + retimed, kernel=kernel)
    if best_sched is None:
        return default
    _TM_BEST.set(best_us, kernel=kernel)
    _cache.record(kernel, keysig, best_sched, best_us, trials)
    if _tm.perf.enabled():
        _log_winner_roofline(kernel, best_us, trials)
    return best_sched


def _log_winner_roofline(kernel: str, best_us: float, trials: int):
    """Achieved-vs-roofline context for a search winner (perf plane):
    when a cost row exists for a program whose label mentions the
    kernel, compare the winner's achieved wall to the analytical
    roofline floor — max(flops/peak_flops, bytes/peak_bw) — else just
    name the peaks the consumer's live MFU will be measured against.
    Logging only; never raises."""
    import logging

    try:
        kind = _tm.perf.device_kind()
        pf = _tm.perf.peak_flops(kind)
        pb = _tm.perf.peak_bytes_per_sec(kind)
        row = next((r for r in _tm.perf.cost_table()
                    if kernel in r["program"]), None)
        msg = ("autotune: %s winner %.1fus over %d trials on %s"
               % (kernel, best_us, trials, kind))
        if row and pf and pb and (row["flops"] or row["bytes_accessed"]):
            floor_s = max((row["flops"] or 0.0) / pf,
                          (row["bytes_accessed"] or 0.0) / pb)
            msg += (" (roofline floor %.1fus, achieved %.0f%% of it)"
                    % (floor_s * 1e6,
                       100.0 * floor_s * 1e6 / best_us if best_us else 0.0))
        elif pf:
            msg += " (peak %.0f TFLOP/s, no cost row yet)" % (pf / 1e12)
        logging.getLogger("mxnet_tpu_torch.autotune").info(msg)
    except Exception:  # noqa: BLE001 — reporting must never break a search
        pass
