"""Slot-pool continuous-batching scheduler, in PyTorch.

The port of ``mxnet_tpu/serving/scheduler.py``.  A fixed number of
decode *slots* share ONE ``KVDecoder`` batch.  Every engine tick runs
one decode step over all slots (``PagedSlots.step`` or the contiguous
``KVDecoder.step_slots``); a request that finishes (eos / token budget /
cache capacity / deadline) frees its slot **mid-flight**, and queued
requests are admitted into free slots at the next iteration: admission
is one bucketed-length prefill.

Host/device split: per-slot windows, queued requests and sampling live
on the HOST (numpy); no tick reads device state except the one (B, V)
logits fetch that sampling needs anyway.

Backpressure is explicit: the admission queue is bounded
(``MXTPU_SERVE_QUEUE``); a full queue raises
:class:`AdmissionQueueFull`, which the HTTP layer maps to 429.
Deadlines (``MXTPU_SERVE_DEADLINE_MS`` default, per-request override)
are enforced both while queued and mid-generation.

Fault sites (``MXTPU_FAULT_PLAN``): admission is ``serve_admit`` (an
injected fault fails that request and the engine serves the next); each
tick first fires ``replica_kill`` (``crash_after:n`` kills the process
mid-decode, the death the router's re-route and 502 paths survive) and
``serve_slow`` (``drop`` parks the engine thread for
``MXTPU_FAULT_SLOW_S`` seconds, so queue wait and TTFT really grow).

Health and perf planes: a sampled request's terminal span is mirrored
into the flight ring (``loop="serve"``, its trace id, outcome, wall and
TTFT), and under ``MXTPU_PERF_ATTR`` each tick's wall splits into the
decode dispatch (the step and its one logits fetch) and the host
sampling loop, the dispatch attributed to ``decode_step_paged`` or
``decode_step_slots`` — clock stamps the tick takes anyway.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np

from .. import faults as _faults
from .. import telemetry as _tm
from ..base import MXNetError, _env_int
from ..telemetry import tracing as _tracing
from . import paged_kv as _paged_kv

__all__ = ["Request", "SlotScheduler", "AdmissionQueueFull"]

# --- serving metric families (docs/telemetry.md, serving section) ----------
_TM_REQS = _tm.counter(
    "serve_requests_total",
    "requests by terminal outcome: ok (completed), rejected (admission "
    "queue full), timeout (deadline while queued or generating), error, "
    "shutdown", labels=("outcome",))
_TM_TOKENS = _tm.counter(
    "serve_tokens_total", "tokens generated and delivered to requests")
_TM_QUEUE = _tm.gauge(
    "serve_queue_depth", "requests waiting in the bounded admission queue")
_TM_OCCUPANCY = _tm.gauge(
    "serve_slot_occupancy", "decode slots currently running a request")
_TM_TTFT = _tm.histogram(
    "serve_ttft_seconds",
    "time-to-first-token: request ARRIVAL (HTTP receipt, before "
    "parse/queue — the server passes its receipt stamp into Request) "
    "to the first sampled token: queue wait + admission prefill")
_TM_QWAIT = _tm.histogram(
    "serve_queue_wait_seconds",
    "time a request spent in the bounded admission queue before a "
    "slot freed up — the queueing component of serve_ttft_seconds, "
    "reported separately so saturation (queue wait) and compute "
    "(prefill) are tellable apart at the replica")
_TM_REQ_SEC = _tm.histogram(
    "serve_request_seconds", "request latency: arrival to terminal outcome")
_TM_REUSE = _tm.counter(
    "serve_slot_reuse_total",
    "admissions into a slot that already served an earlier request — "
    "continuous batching in action (0 means every request got a cold slot)")
_TM_TICK = _tm.histogram(
    "serve_tick_seconds",
    "one engine tick: a fused decode step over all slots + host sampling")


class SchedulerDraining(MXNetError):
    """Submitted while draining (POST /admin/drain): the server is
    finishing in-flight work before a restart — resubmit elsewhere."""


class AdmissionQueueFull(MXNetError):
    """The bounded admission queue is full — shed load (HTTP 429)."""


def _host(logits):
    """Logits (a device tensor) -> float32 numpy: the host fetch."""
    return logits.float().cpu().numpy()


class Request:
    """One generation request and its (thread-safe) result slot.

    ``wait(timeout)`` blocks until a terminal outcome; ``tokens`` then
    holds everything generated (possibly partial on ``timeout``).
    """

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens=16, temperature=0.0,
                 top_k=None, eos_id=None, deadline_ms=None, seed=0,
                 arrival=None, trace=None, parent=None, sampled=False):
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise MXNetError(
                f"prompt must be a non-empty 1-D token-id sequence, got "
                f"shape {prompt.shape}")
        if max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        temperature = float(temperature)
        if not np.isfinite(temperature) or temperature < 0:
            raise MXNetError(
                f"temperature must be a finite number >= 0, got "
                f"{temperature!r}")
        if top_k is not None:
            top_k = int(top_k)
            if top_k < 1:
                raise MXNetError(f"top_k must be >= 1, got {top_k}")
        if deadline_ms is not None and not (
                np.isfinite(deadline_ms) and deadline_ms >= 0):
            raise MXNetError(
                f"deadline_ms must be a finite number >= 0, got "
                f"{deadline_ms!r}")
        seed = int(seed)
        if not 0 <= seed < 2 ** 32:
            raise MXNetError(f"seed must be in [0, 2**32), got {seed}")
        self.id = next(Request._ids)
        self.prompt = prompt.astype(np.int64)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        # TTFT origin: the server stamps monotonic receipt
        # time BEFORE reading/parsing the body and passes it here, so
        # serve_ttft_seconds includes the full queue wait
        self.arrival = (time.monotonic() if arrival is None
                        else float(arrival))
        self.deadline = (self.arrival + deadline_ms / 1000.0
                         if deadline_ms else None)
        # trace context (telemetry/tracing.py): the W3C traceparent the
        # router minted; spans are recorded only when `sampled` rode in
        # on the flags byte AND tracing is on in this process
        self.trace = trace
        self.parent = parent
        self.sampled = bool(sampled)
        self.queue_wait = None
        self.tokens = []
        self.outcome = None   # ok | timeout | error | shutdown
        self.error = None
        self.ttft = None
        self._rng = np.random.RandomState(seed)
        self._event = threading.Event()

    def wait(self, timeout=None):
        """Block until the request reaches a terminal outcome (or the
        wait times out — ``outcome`` is then still None)."""
        self._event.wait(timeout)
        return self

    @property
    def done(self):
        return self._event.is_set()


class _ContiguousSlots:
    """The contiguous slot pool behind the backend interface the
    scheduler drives: one ``(L, slots, H, max_len, dh)`` cache pair,
    left-padded bucketed prefill + ``adopt_row`` admission, per-slot
    ``[start, cursor]`` windows.  The paged twin is
    :class:`~mxnet_tpu_torch.serving.paged_kv.PagedSlots`."""

    paged = False

    def __init__(self, decoder, num_slots, prefill_buckets):
        self.decoder = decoder
        self.num_slots = num_slots
        self.prefill_buckets = prefill_buckets
        self.cache = decoder.init_slot_state(num_slots)
        self.start = np.zeros(num_slots, np.int32)
        self.cursor = np.zeros(num_slots, np.int32)

    def stats(self):
        return None

    def admit(self, slot, prompt, trace=None):
        """Bucketed left-padded prefill + one slot cache write;
        returns the next-token logits row of the last prompt token.
        ``trace`` is accepted for backend-interface parity with the
        paged pool (which records kv_admit/kv_evict spans); the
        contiguous pool has no per-admit KV events to attribute."""
        plen = int(prompt.size)
        bucket = next(b for b in self.prefill_buckets if b >= plen)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, bucket - plen:] = prompt
        row, logits = self.decoder.prefill_padded(padded, [plen])
        self.cache = self.decoder.adopt_row(self.cache, row, slot)
        self.start[slot] = bucket - plen
        self.cursor[slot] = bucket
        return logits[0, -1]

    def step(self, tokens, occupied):
        """ONE decode step over the whole pool; advances the
        occupied rows' windows.  Never starves (each slot owns its full
        max_len row) — the empty second return keeps the interface."""
        tokens = np.asarray(tokens).copy()
        start = self.start.copy()
        cursor = self.cursor.copy()
        free = ~occupied
        # free rows ride along; pin their write to position 0 —
        # adopt_row overwrites the whole row on admission
        tokens[free] = 0
        start[free] = 0
        cursor[free] = 0
        self.cache, logits = self.decoder.step_slots(
            self.cache, tokens, start, cursor)
        self.cursor[occupied] += 1
        return logits, []

    def exhausted(self, slot):
        return self.cursor[slot] >= self.decoder.max_len

    def release(self, slot):
        self.start[slot] = 0
        self.cursor[slot] = 0


class SlotScheduler:
    """Continuous batching over one :class:`~mxnet_tpu_torch.models.
    decode.KVDecoder`.

    ``prefill_buckets``: padded prompt lengths of the admission prefill
    (default: powers of two from 8 up to the decoder's ``max_len``).  A
    request's prompt is padded to the smallest bucket that fits, so the
    prefill runs at O(log max_len) distinct shapes.

    ``paged``/``kv_block``/``num_pages``/``prefix_cache`` select the
    paged KV backend (`serving/paged_kv.py`): block-table indirection
    over a shared page pool with prompt-prefix reuse.  Default follows
    ``MXTPU_KV_BLOCK`` (0/unset = contiguous).  ``paged_kernel``
    overrides ``MXTPU_PAGED_KERNEL`` — the paged step's attention
    lowering (the CUDA page-walk kernel or the plain gather path),
    resolved once at construction.
    """

    def __init__(self, decoder, num_slots=None, queue_size=None,
                 default_deadline_ms=None, prefill_buckets=None,
                 idle_wait=0.05, paged=None, kv_block=None,
                 num_pages=None, prefix_cache=None, paged_kernel=None):
        self.decoder = decoder
        # `is not None` (not truthiness): an explicit 0 must reach the
        # guards below, not silently become the env/default value
        self.num_slots = int(
            num_slots if num_slots is not None
            else _env_int("MXTPU_SERVE_SLOTS", 4))
        self.queue_size = int(
            queue_size if queue_size is not None
            else _env_int("MXTPU_SERVE_QUEUE", 16))
        self.default_deadline_ms = (
            default_deadline_ms
            if default_deadline_ms is not None
            else _env_int("MXTPU_SERVE_DEADLINE_MS", 30000))
        if self.num_slots < 1:
            raise MXNetError("need at least one decode slot")
        if self.queue_size < 0:
            raise MXNetError("queue_size must be >= 0 (0 disables "
                             "queueing: every submit sheds load)")
        if prefill_buckets is None:
            prefill_buckets, b = [], 8
            while b < decoder.max_len:
                prefill_buckets.append(b)
                b *= 2
            prefill_buckets.append(decoder.max_len)
        self.prefill_buckets = tuple(sorted(set(prefill_buckets)))
        if self.prefill_buckets[-1] > decoder.max_len:
            raise MXNetError(
                f"prefill bucket {self.prefill_buckets[-1]} exceeds the "
                f"decoder's max_len {decoder.max_len}")

        blk = kv_block if kv_block is not None else _paged_kv.kv_block()
        if paged is None:
            paged = blk > 0
        if paged:
            self.backend = _paged_kv.PagedSlots(
                decoder, self.num_slots, block=(blk or None),
                num_pages=num_pages, prefix_cache=prefix_cache,
                prefill_buckets=self.prefill_buckets,
                kernel=paged_kernel)
        else:
            self.backend = _ContiguousSlots(
                decoder, self.num_slots, self.prefill_buckets)
        self.slots = [None] * self.num_slots
        self._next_tok = np.zeros(self.num_slots, np.int64)
        self._slot_used = [False] * self.num_slots
        self._queue = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._draining = False
        self._idle_wait = float(idle_wait)
        # rolled-up engine stats (bench + /healthz): mean slot occupancy
        # = slot_ticks / ticks
        self.stats = {"ticks": 0, "slot_ticks": 0, "admitted": 0,
                      "completed": 0}
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="mxtpu-serve-engine-%d" % id(self))
        self._thread.start()

    # ------------------------------------------------------------ client API
    def submit(self, prompt, **kwargs):
        """Enqueue a generation request; returns the :class:`Request`.
        Raises :class:`AdmissionQueueFull` when the bounded queue is full
        and :class:`MXNetError` for requests that can never be served
        (prompt longer than the largest prefill bucket)."""
        kwargs.setdefault("deadline_ms", self.default_deadline_ms or None)
        req = Request(prompt, **kwargs)
        vocab = getattr(self.decoder, "vocab", None)
        if req.top_k is not None and vocab and req.top_k > vocab:
            _TM_REQS.inc(outcome="rejected")
            raise MXNetError(
                f"top_k {req.top_k} exceeds the vocab size {vocab}")
        if req.prompt.size > self.prefill_buckets[-1]:
            _TM_REQS.inc(outcome="rejected")
            raise MXNetError(
                f"prompt length {req.prompt.size} exceeds the largest "
                f"prefill bucket {self.prefill_buckets[-1]}")
        with self._cond:
            if self._stop:
                raise MXNetError("scheduler is shut down")
            if self._draining:
                _TM_REQS.inc(outcome="rejected")
                raise SchedulerDraining(
                    "scheduler is draining: not admitting new requests "
                    "(in-flight and queued requests will finish)")
            if len(self._queue) >= self.queue_size:
                _TM_REQS.inc(outcome="rejected")
                raise AdmissionQueueFull(
                    f"admission queue full ({self.queue_size} waiting)")
            self._queue.append(req)
            _TM_QUEUE.set(len(self._queue))
            self._cond.notify()
        return req

    def generate(self, prompt, timeout=None, **kwargs):
        """submit() + wait(): returns the finished :class:`Request`."""
        req = self.submit(prompt, **kwargs)
        limit = timeout
        if limit is None and req.deadline is not None:
            limit = max(req.deadline - time.monotonic(), 0.0) + 5.0
        return req.wait(limit)

    # ------------------------------------------------------------- draining
    def drain(self):
        """Stop admitting new requests; queued and in-flight requests
        finish normally (the rolling-restart half of the survival
        layer: an orchestrator drains a replica, waits for
        :attr:`drained`, then restarts it under live traffic).
        Idempotent; ``submit`` raises :class:`SchedulerDraining` until
        shutdown or :meth:`undrain`."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def undrain(self):
        """Re-open admission (a drain that was cancelled)."""
        with self._cond:
            self._draining = False
            self._cond.notify_all()

    @property
    def draining(self):
        return self._draining

    @property
    def drained(self):
        """True when a draining scheduler has no queued or in-flight
        work left — safe to restart."""
        with self._cond:
            return (self._draining and not self._queue
                    and all(r is None for r in self.slots))

    @property
    def paged(self):
        return self.backend.paged

    def paged_stats(self):
        """Page-pool occupancy for ``/healthz`` (None when running the
        contiguous backend): {block, pages_total, pages_free,
        prefix_pages}."""
        return self.backend.stats()

    @property
    def occupied(self):
        return sum(1 for r in self.slots if r is not None)

    @property
    def queue_depth(self):
        with self._cond:
            return len(self._queue)

    def close(self, timeout=10.0):
        """Stop the engine thread; queued and in-flight requests finish
        with outcome ``shutdown``."""
        with self._cond:
            if self._stop:
                return
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout)
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
        _TM_QUEUE.set(0)
        # the engine never touches the queue after _stop, so queued
        # requests are safe to terminate here either way
        for req in queued:
            self._terminal(req, "shutdown")
        if self._thread.is_alive():
            # engine wedged past the join timeout (e.g. blocked inside a
            # device call): leave the slots to it — it may still finish
            # them, and _terminal is idempotent if it does so later; the
            # in-flight clients' own wait() deadlines bound their hang
            return
        for req in self.slots:
            if req is not None:
                self._terminal(req, "shutdown")
        # race-ok: reached only after _thread.join() proved the engine
        # thread dead (is_alive() returns above otherwise) — the join is
        # the happens-before edge static analysis can't see
        self.slots = [None] * self.num_slots
        _TM_OCCUPANCY.set(0)

    # ---------------------------------------------------------- engine loop
    def _run(self):
        while True:
            with self._cond:
                while (not self._stop and not self._queue
                       and all(r is None for r in self.slots)):
                    self._cond.wait(self._idle_wait)
                if self._stop:
                    return
            # the engine thread must OUTLIVE any single bad request: an
            # exception anywhere in an iteration terminates the affected
            # requests with outcome `error` and the loop keeps serving —
            # a dead engine would hang every in-flight and future client
            try:
                now = time.monotonic()
                self._expire_queued(now)
                self._admit(now)
                if any(r is not None for r in self.slots):
                    self._tick()
            except Exception as exc:  # noqa: BLE001 — requests must
                #                       terminate, not hang their clients
                for i, req in enumerate(self.slots):
                    if req is not None:
                        req.error = exc
                        self._finish_slot(i, "error")

    def _expire_queued(self, now):
        with self._cond:
            keep = deque()
            for req in self._queue:
                if req.deadline is not None and now > req.deadline:
                    self._terminal(req, "timeout")
                else:
                    keep.append(req)
            if len(keep) != len(self._queue):
                self._queue = keep
                _TM_QUEUE.set(len(keep))

    def _admit(self, now):
        """Move queued requests into free slots: bucketed prefill + one
        traced-slot cache write each; the first token is sampled straight
        from the prefill logits (that fetch IS the TTFT)."""
        while True:
            free = next((i for i, r in enumerate(self.slots) if r is None),
                        None)
            if free is None:
                return
            with self._cond:
                if not self._queue:
                    return
                req = self._queue.popleft()
                _TM_QUEUE.set(len(self._queue))
            req.queue_wait = time.monotonic() - req.arrival
            _TM_QWAIT.observe(req.queue_wait)
            traced = req.sampled and _tracing.trace_on()
            if traced:
                _tracing.record_span(
                    "queue_wait", "replica", req.trace, req.queue_wait,
                    parent=req.parent, request=req.id)
            t_admit0 = time.perf_counter()
            try:
                # the whole admission for THIS request — prefill, first
                # sample, cache write — fails only this request; the
                # slot stays free and the engine moves on
                _faults.maybe_fail("serve_admit")
                t_pf0 = time.perf_counter()
                logits = self.backend.admit(
                    free, req.prompt,
                    trace=(req.trace if traced else None))
                pf_dur = time.perf_counter() - t_pf0
                first = self._sample(req, _host(logits))
            except Exception as exc:  # noqa: BLE001
                self.backend.release(free)
                req.error = exc
                self._terminal(req, "error")
                continue
            self._next_tok[free] = first
            if self._slot_used[free]:
                _TM_REUSE.inc()
            self._slot_used[free] = True
            self.slots[free] = req
            req.tokens.append(first)
            req.ttft = time.monotonic() - req.arrival
            _TM_TTFT.observe(req.ttft)
            _TM_TOKENS.inc()
            self.stats["admitted"] += 1
            _TM_OCCUPANCY.set(self.occupied)
            if traced:
                plen = int(req.prompt.size)
                bucket = next(b for b in self.prefill_buckets
                              if b >= plen)
                _tracing.record_span(
                    "prefill", "replica", req.trace, pf_dur,
                    parent=req.parent, bucket=bucket, prompt_len=plen,
                    request=req.id)
                _tracing.record_span(
                    "admit", "replica", req.trace,
                    time.perf_counter() - t_admit0, parent=req.parent,
                    slot=free, request=req.id)
            self._maybe_finish(free, time.monotonic())

    def _tick(self):
        """ONE decode step over the whole pool + host sampling."""
        _faults.fire("replica_kill")
        if _faults.active() and _faults.should_drop("serve_slow"):
            time.sleep(_tm.health._fault_slow_s())
        t0 = time.perf_counter()
        occupied = [i for i, r in enumerate(self.slots) if r is not None]
        # sampled decode-tick spans: every TICK_EVERY-th tick
        # records one span per sampled live request — pure host dict
        # writes after the tick, so the zero-host-sync invariant holds;
        # requests are captured NOW because _finish_slot clears slots
        tick_reqs = ()
        if _tracing.trace_on() \
                and self.stats["ticks"] % _tracing.TICK_EVERY == 0:
            tick_reqs = [(i, self.slots[i]) for i in occupied
                         if self.slots[i].sampled]
        occ_mask = np.array([r is not None for r in self.slots])
        logits, starved = self.backend.step(self._next_tok, occ_mask)
        logits = _host(logits)                    # the ONE host sync/tick
        t_fetch = time.perf_counter()
        now = time.monotonic()
        for i in occupied:
            if i in starved:
                # page pool exhausted mid-generation: deliver what was
                # generated so far (the paged analog of the contiguous
                # cache-window truncation — documented in serving.md)
                self._finish_slot(i, "ok")
                continue
            req = self.slots[i]
            nxt = self._sample(req, logits[i])
            req.tokens.append(nxt)
            self._next_tok[i] = nxt
            _TM_TOKENS.inc()
            self._maybe_finish(i, now)
        self.stats["ticks"] += 1
        self.stats["slot_ticks"] += len(occupied)
        tick_dur = time.perf_counter() - t0
        _TM_TICK.observe(tick_dur)
        if _tm.perf.enabled() and occupied:
            # the tick's wall: the decode dispatch (step + the logits
            # fetch above) and the host sampling loop
            _tm.perf.record_dispatch(
                "decode_step_paged"
                if getattr(self.backend, "paged", False)
                else "decode_step_slots", t_fetch - t0)
            _tm.perf.record_step_buckets(
                wall_s=tick_dur, dispatch=t_fetch - t0,
                sample=tick_dur - (t_fetch - t0))
        for i, req in tick_reqs:
            _tracing.record_span(
                "decode_tick", "replica", req.trace, tick_dur,
                parent=req.parent, slot=i, tick=self.stats["ticks"] - 1,
                tokens=len(req.tokens), request=req.id)

    def _maybe_finish(self, slot, now):
        req = self.slots[slot]
        if req.deadline is not None and now > req.deadline:
            self._finish_slot(slot, "timeout")
        elif (req.eos_id is not None and req.tokens
              and req.tokens[-1] == req.eos_id):
            self._finish_slot(slot, "ok")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish_slot(slot, "ok")
        elif self.backend.exhausted(slot):
            # cache window exhausted: the checkpoint's positional table
            # ends here — deliver what fits (documented truncation)
            self._finish_slot(slot, "ok")

    def _finish_slot(self, slot, outcome):
        req = self.slots[slot]
        self.slots[slot] = None
        self.backend.release(slot)
        self._next_tok[slot] = 0
        self.stats["completed"] += 1
        _TM_OCCUPANCY.set(self.occupied)
        self._terminal(req, outcome)

    def _terminal(self, req, outcome):
        if req.outcome is not None:   # idempotent: first outcome wins
            return
        req.outcome = outcome
        _TM_REQS.inc(outcome=outcome)
        wall = time.monotonic() - req.arrival
        _TM_REQ_SEC.observe(wall)
        if req.sampled and _tracing.trace_on():
            # the terminal span covers the whole request (arrival →
            # outcome)
            _tracing.record_span(
                "request", "replica", req.trace, wall,
                parent=req.parent, outcome=outcome,
                tokens=len(req.tokens), request=req.id)
            # mirrored into the flight ring, so post-mortem dumps carry
            # the trace id
            _tm.health.record_step(
                loop="serve", trace=req.trace, outcome=outcome,
                wall_s=wall, ttft_s=req.ttft)
        req._event.set()

    @staticmethod
    def _sample(req, logits):
        """Host-side per-request sampling — same math as
        KVDecoder.generate, but with each request's own params/rng so
        heterogeneous requests co-batch."""
        if req.temperature <= 0:
            return int(logits.argmax())
        lg = logits / req.temperature
        if req.top_k:
            # clamp to the vocab: submit() validates against the
            # decoder's vocab when known, this keeps np.partition safe
            # for decoders that don't expose one
            k = min(req.top_k, lg.shape[-1])
            kth = np.partition(lg, -k)[-k]
            lg = np.where(lg < kth, -np.inf, lg)
        z = lg - lg.max()
        prob = np.exp(z)
        prob /= prob.sum()
        return int(req._rng.choice(lg.shape[-1], p=prob))
