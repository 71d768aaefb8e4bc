"""Paged KV cache: block-table indirection + prompt-prefix reuse, in PyTorch.

The port of ``mxnet_tpu/serving/paged_kv.py``.  ONE shared device pool
of fixed-size pages (``MXTPU_KV_BLOCK`` tokens per page), per-slot
*block tables* mapping each slot's logical cache positions onto pool
pages, and a chain-hashed prefix index so identical prompt prefixes map
to the SAME immutable pages (the shared system prompt is prefilled
once).  Copy-on-write at the divergence point is structural: sharing is
block-aligned and a request's first write lands at its prompt length,
so the partially-filled divergence block is always private to the fork.

Page allocation, refcounts, block tables and the prefix index are pure
host-side bookkeeping; the device does one decode step over all slots
per tick and one bucketed prefill per admission.

Unlike the JAX package, the pool ``(P, L, H, block, dh)`` is updated IN
PLACE: JAX rebuilds it functionally (``.at[].set``), which here would
copy the whole pool (0.5 GB at full width) on every tick.  The step's
attention is the hand-written CUDA kernel (``ops/paged_attention.py``)
or, by ``MXTPU_PAGED_KERNEL``, the plain gather math or the live-page
walk; the prefill always gathers the slot's table and attends with
plain tensor code.  Under ``MXTPU_PAGED_KERNEL=auto`` with a schedule
cache (``MXTPU_SCHEDULE_CACHE``) the autotuner picks the step's
attention schedule at construction — the kernel's split on a card,
gather or the pagewalk on the CPU — and never per tick.  Under
``MXTPU_PERF_ATTR`` the first step and each prefill bucket's first
admission count their FLOPs into the perf plane's cost rows
(``decode_step_paged``, ``decode_prefill_paged[b<bucket>]``).  The
first step and each bucket's first prefill are also what
``executor_compile_total{kind=decode_step_paged|decode_prefill_paged}``
counts: the JAX package's traces, which the port does not make.
"""
from __future__ import annotations

import hashlib
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import autotune as _autotune
from .. import telemetry as _tm
from ..base import MXNetError
from ..executor import _compile_done, _compile_start
from ..models.decode import _ln, _snap
from ..ops import paged_attention as _pa
from ..telemetry import tracing as _tracing

__all__ = ["PagedSlots", "PoolExhausted", "kv_block", "prefix_cache_on",
           "paged_kernel_mode"]

# --- paged serving metric families (same names as the JAX package) ---------
_TM_PREFIX_HITS = _tm.counter(
    "serve_prefix_hits_total",
    "prompt blocks served from the prefix cache instead of being "
    "prefilled (each hit skips one MXTPU_KV_BLOCK-token block of "
    "prefill compute)")
_TM_PAGES = _tm.gauge(
    "serve_kv_pages",
    "KV-cache page pool occupancy: total usable pages, currently free "
    "pages, and pages pinned by the prompt-prefix cache",
    labels=("state",))



class PoolExhausted(MXNetError):
    """No free KV page and nothing evictable — the pool is fully pinned
    by live requests (size the pool, or shed load upstream)."""


# The port reads the JAX package's knob names (MXTPU_KV_BLOCK,
# MXTPU_PAGED_KERNEL, MXTPU_PREFIX_CACHE, MXTPU_SERVE_SLOTS,
# MXTPU_SERVE_QUEUE, MXTPU_SERVE_DEADLINE_MS, MXTPU_SERVE_REPLICAS) and
# adds none of its own: docs/how_to/env_var.md documents them all, and
# the port lint (python -m mxnet_tpu_torch.analysis) checks it.
def kv_block() -> int:
    """``MXTPU_KV_BLOCK`` — tokens per KV page; 0/unset keeps the
    contiguous slot cache."""
    try:
        return max(int(os.environ.get("MXTPU_KV_BLOCK", "0") or 0), 0)
    except ValueError:
        return 0


def prefix_cache_on() -> bool:
    """``MXTPU_PREFIX_CACHE`` — prompt-prefix page reuse (default on
    whenever paging is on)."""
    return os.environ.get("MXTPU_PREFIX_CACHE", "1").lower() \
        not in ("0", "false", "off")


def paged_kernel_mode() -> str:
    """``MXTPU_PAGED_KERNEL`` — the step-attention lowering.

    ``auto`` (default, also ``1``): the CUDA kernel on a CUDA pool (a
    page shape, dtype or context the kernel cannot take raises
    :class:`MXNetError`), the plain gather path on a CPU pool; with a
    schedule cache, the autotuner's winner among the kernel's splits
    (among gather and pagewalk on a CPU pool).
    ``0``/``off``/``gather``: pin the gather path.  ``pagewalk``: the
    plain live-page walk (``ops/paged_attention.py:_pagewalk_attention``)
    on either device.  ``pallas``: force the hand-written kernel (the
    JAX package's name for it): a CPU pool, or a shape the kernel
    refuses, raises, with no switch to gather.  ``interpret`` (the JAX
    package runs its Pallas kernel in an interpreter on the CPU) raises:
    a CUDA kernel has no CPU interpreter, and ``gather`` is its plain
    twin.  An unknown mode raises at :class:`PagedSlots`
    construction."""
    raw = os.environ.get("MXTPU_PAGED_KERNEL", "auto").strip().lower()
    if raw in ("", "1", "auto"):
        return "auto"
    if raw in ("0", "off", "false", "gather"):
        return "gather"
    return raw


class _PagedPrograms:
    """The decode step and the tail prefill over the page pool.

    Pool layout ``(P, L, H, block, dh)`` — page-major so one gather by
    page id reconstructs a slot's table.  The layer math is the
    decoder's own (``_block_qkv``/``_block_tail``/``_head``)."""

    def __init__(self, decoder, block, max_blocks, num_pages, schedule):
        self.dec = decoder
        self.block = int(block)
        self.max_blocks = int(max_blocks)
        self.num_pages = int(num_pages)
        # {"impl": "cuda", "chunk_pages": p}, {"impl": "gather"} or
        # {"impl": "pagewalk", "chunk": c}
        self.schedule = dict(schedule)
        self.kernel = self.schedule["impl"]

    def init_pool(self):
        d = self.dec
        shape = (self.num_pages, d.L, d.H, self.block, d.dh)
        with torch.inference_mode():
            return (torch.zeros(shape, dtype=d._cache_dtype, device=d.device),
                    torch.zeros(shape, dtype=d._cache_dtype, device=d.device))

    # ---------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self, pool_k, pool_v, bt, tokens, cursor, n_live,
             live_rows=None):
        """One decode position for every slot, the pool updated in
        place: row ``b`` writes its new K/V at absolute cache position
        ``cursor[b]`` (page ``bt[b, cursor//block]``, offset
        ``cursor%block``) and then attends over ``[0, cursor[b]]``.  Free
        rows ride along with ``bt[b]=0``/``cursor=0`` — their writes land
        in the scratch page the allocator never hands out.  ``n_live``
        is the pagewalk's page count and ``live_rows`` the kernel's live
        K/V rows (the perf plane's count), both from the host's cursors.
        Returns logits ``(B, V)``."""
        d = self.dec
        p = d.p
        B = tokens.shape[0]
        cur = cursor.long()
        tok = d._embed(tokens)                                  # (B, D)
        pos_ids = cur.clamp(0, d.max_len - 1)
        h = (tok + p["pos_embed"][0][pos_ids])[:, None]         # (B, 1, D)
        pages = bt.long().gather(1, (cur // self.block)[:, None])[:, 0]
        offs = cur % self.block
        for i in range(d.L):
            name = f"layer{i}"
            h2 = _ln(h, p[f"{name}_ln1_gamma"], p[f"{name}_ln1_beta"])
            q, k, v = d._block_qkv(i, h2)
            # the new token's K/V go into the pool BEFORE the attention
            # reads it, on the same stream: attention covers [0, cursor]
            pool_k[pages, i, :, offs] = d._heads(k, B, 1)[:, :, 0]
            pool_v[pages, i, :, offs] = d._heads(v, B, 1)[:, :, 0]
            qh = d._heads(q, B, 1)                              # (B, H, 1, dh)
            if self.kernel == "cuda":
                ctx = _pa.paged_attention(
                    qh, pool_k, pool_v, bt, cursor, i, block=self.block,
                    chunk_pages=self.schedule["chunk_pages"],
                    live_rows=live_rows)
            elif self.kernel == "pagewalk":
                ctx = _pa._pagewalk_attention(
                    qh, pool_k, pool_v, bt, cursor, i, self.block, n_live,
                    self.schedule.get("chunk", 1))
            else:
                ctx = _pa._gather_attention(qh, pool_k, pool_v, bt, cursor,
                                            i, self.block)
            ctx = ctx.transpose(1, 2).reshape(B, 1, d.d_model)
            h = d._block_tail(i, h, ctx)
        return d._head(h)[:, 0]                                 # (B, V)

    # ------------------------------------------------------------- prefill
    @torch.inference_mode()
    def prefill(self, pool_k, pool_v, bt_row, tokens, hist, t):
        """Tail prefill behind a (possibly reused) history: ``tokens``
        (1, T) RIGHT-padded, the ``t`` real tokens sit at absolute
        positions ``hist .. hist+t-1``.  Returns logits ``(1, T, V)``.

        Only the ``t`` real rows are written into their pages.  The JAX
        program sends the pad rows' writes to out-of-bounds indices
        (position ``S``, page ``num_pages``) and relies on XLA dropping
        them; an out-of-bounds ``index_put_`` raises on the CPU and
        faults on the card, so the pad rows are never written at all."""
        d = self.dec
        p = d.p
        T = tokens.shape[1]
        S = self.max_blocks * self.block
        dev = d.device
        j = torch.arange(T, device=dev)
        qpos = hist + j                                         # absolute
        tok = d._embed(tokens)                                  # (1, T, D)
        h = tok + p["pos_embed"][0][qpos.clamp(0, d.max_len - 1)][None]
        rpos = qpos[:t]                                         # real rows
        pages = bt_row.long()[rpos // self.block]
        offs = rpos % self.block
        valid = torch.arange(S, device=dev)[None, :] <= qpos[:, None]
        for i in range(d.L):
            name = f"layer{i}"
            h2 = _ln(h, p[f"{name}_ln1_gamma"], p[f"{name}_ln1_beta"])
            q, k, v = d._block_qkv(i, h2)
            pool_k[pages, i, :, offs] = k[0, :t].reshape(t, d.H, d.dh)
            pool_v[pages, i, :, offs] = v[0, :t].reshape(t, d.H, d.dh)
            # the table gathered after the write holds exactly what the
            # JAX program's gathered-then-scattered table holds
            kc = _pa.gather_tables(pool_k, bt_row[None], self.block, i)
            vc = _pa.gather_tables(pool_v, bt_row[None], self.block, i)
            ctx = d._attend(d._heads(q, 1, T), kc, vc, valid[None, None])
            h = d._block_tail(i, h, ctx)
        return d._head(h)                                       # (1, T, V)


class PagedSlots:
    """Paged scheduler backend: the device pool + pure-host page
    bookkeeping (block tables, refcounts, prefix index).

    The pool holds ``num_pages`` usable pages plus page 0, a scratch
    page free rows write into (never allocated).  Default sizing —
    ``num_slots * max_len/block`` — matches the contiguous footprint,
    so prefix sharing turns straight into headroom.  Refcounts: one per
    slot whose table references the page, plus one while the prefix
    index pins it; a page drops to the free list at refcount 0.  The
    prefix index evicts LRU pages nothing else references when the
    free list runs dry; a request that still cannot get a page at
    admission fails that admission, and one starving mid-decode is
    delivered truncated (reported by :meth:`step`).
    """

    paged = True

    def __init__(self, decoder, num_slots, block=None, num_pages=None,
                 prefix_cache=None, prefill_buckets=None, kernel=None):
        if decoder.mesh is not None:
            raise MXNetError(
                "paged KV is not supported together with a tensor-"
                "parallel mesh yet (serve the paged fleet data-parallel)")
        self.decoder = decoder
        self.num_slots = int(num_slots)
        self.block = int(block if block is not None else (kv_block() or 16))
        if self.block < 1:
            raise MXNetError(f"KV block must be >= 1, got {self.block}")
        if decoder.max_len % self.block:
            raise MXNetError(
                f"MXTPU_KV_BLOCK {self.block} must divide the decoder's "
                f"max_len {decoder.max_len}")
        self.max_blocks = decoder.max_len // self.block
        self.num_pages = int(
            num_pages if num_pages is not None
            else self.num_slots * self.max_blocks)
        if self.num_pages < self.max_blocks:
            raise MXNetError(
                f"pool of {self.num_pages} pages cannot hold one "
                f"max_len request ({self.max_blocks} pages)")
        self.prefix_on = (prefix_cache_on() if prefix_cache is None
                          else bool(prefix_cache))
        self.prefill_buckets = tuple(prefill_buckets or ())
        self.kernel_mode = (paged_kernel_mode() if kernel is None
                            else str(kernel).strip().lower())
        self.schedule = self._resolve_schedule()
        self.kernel = self.schedule["impl"]
        self.programs = _PagedPrograms(
            decoder, self.block, self.max_blocks, self.num_pages + 1,
            self.schedule)
        self.pool = self.programs.init_pool()
        self.bt = np.zeros((self.num_slots, self.max_blocks), np.int32)
        self.cursor = np.zeros(self.num_slots, np.int32)
        self._free = list(range(self.num_pages, 0, -1))   # pop() -> page 1 last
        self._ref = np.zeros(self.num_pages + 1, np.int64)
        self._prefix = OrderedDict()      # chain hash -> page (LRU first)
        self._slot_pages = [[] for _ in range(self.num_slots)]
        # trace id of the admission currently allocating, so _alloc can
        # attribute its prefix evictions; None for step-time evictions
        self._trace_ctx = None
        # perf plane: one cost row for the step and one per prefill
        # bucket, counted at their first dispatch
        self._cost_step_done = False
        self._cost_prefill_done = set()
        self._set_gauges()

    # ----------------------------------------------------------- schedule
    def _resolve_schedule(self):
        """The step-attention schedule, decided ONCE here, never per tick
        (a search's device syncs are ``autotune.search.measure``'s
        declared boundary): ``{"impl": "cuda", "chunk_pages": p}`` (the
        hand-written kernel), ``{"impl": "gather"}`` or ``{"impl":
        "pagewalk", "chunk": c}``."""
        mode = self.kernel_mode
        if mode == "gather":
            return {"impl": "gather"}
        if mode == "pagewalk":
            return {"impl": "pagewalk", "chunk": 1}
        if mode == "interpret":
            raise MXNetError(
                "MXTPU_PAGED_KERNEL=interpret: the port's kernel is CUDA, "
                "which has no CPU interpreter; MXTPU_PAGED_KERNEL=gather is "
                "its plain twin (the JAX package interprets its Pallas "
                "kernel)")
        if mode not in ("auto", "pallas"):
            raise MXNetError(
                f"unknown MXTPU_PAGED_KERNEL mode {mode!r} (want auto, "
                "gather/0, pallas, pagewalk or interpret)")
        d = self.decoder
        M, blk = self.max_blocks, self.block
        dtype = d._cache_dtype
        platform = d.device.type
        if platform != "cuda":
            if mode == "pallas":
                raise MXNetError(
                    "MXTPU_PAGED_KERNEL=pallas forces the hand-written "
                    f"kernel, which needs a CUDA pool (this one is on "
                    f"{d.device}); use auto, gather or pagewalk")
        else:
            # a CUDA pool the kernel cannot take is an error, never a
            # quiet switch to the gather path: pin
            # MXTPU_PAGED_KERNEL=gather for that
            _pa.require(blk, d.dh, dtype, M * blk)
            if mode == "pallas":
                return _pa.default_schedule(platform, blk, d.dh, dtype)
        # auto: the default (the kernel under today's split on a card,
        # gather on the CPU) unless a schedule cache holds or finds a
        # winner.  On a card every candidate is a split of the kernel,
        # and a cached winner outside the candidates (a gather winner a
        # shared file holds, say) is not taken: a search never hands a
        # card's work to a plain version
        B = self.num_slots
        cands = _pa.candidate_schedules(platform, blk, d.dh, M, dtype)
        return dict(_autotune.ensure(
            "paged_attention", _pa.keysig(B, d.H, M, blk, d.dh, dtype),
            _pa.default_schedule(platform, blk, d.dh, dtype), cands,
            lambda c: _pa.make_bench_fn(c, B=B, H=d.H, M=M, block=blk,
                                        dh=d.dh, L=d.L, dtype=dtype,
                                        device=d.device),
            accept=lambda s: s in cands))

    # --------------------------------------------------------- bookkeeping
    def _set_gauges(self):
        _TM_PAGES.set(self.num_pages, state="total")
        _TM_PAGES.set(len(self._free), state="free")
        _TM_PAGES.set(len(self._prefix), state="prefix")

    def stats(self):
        """The ``/healthz`` ``paged`` payload."""
        return {"block": self.block,
                "pages_total": self.num_pages,
                "pages_free": len(self._free),
                "prefix_pages": len(self._prefix),
                "kernel": self.kernel,
                "schedule": dict(self.schedule)}

    def _alloc(self, n):
        """``n`` pages off the free list, evicting LRU prefix-only pages
        when it runs dry; all-or-nothing (rolls back on exhaustion)."""
        got = []
        while len(got) < n:
            if self._free:
                got.append(self._free.pop())
                continue
            evicted = None
            for hh, pg in self._prefix.items():     # LRU order
                if self._ref[pg] == 1:              # only the index holds it
                    evicted = (hh, pg)
                    break
            if evicted is None:
                self._free.extend(got)
                raise PoolExhausted(
                    f"KV page pool exhausted: {self.num_pages} pages all "
                    f"pinned by live requests (needed {n})")
            hh, pg = evicted
            del self._prefix[hh]
            self._ref[pg] = 0
            got.append(pg)
            if _tracing.trace_on():
                _tracing.record_span(
                    "kv_evict", "replica", self._trace_ctx, 0.0, page=pg)
        for pg in got:
            self._ref[pg] = 1           # owned by the requesting slot
        return got

    @property
    def max_prompt(self):
        """The longest prompt an admission takes: the decoder's
        ``max_len``."""
        return self.decoder.max_len

    def _block_hashes(self, prompt, n_blocks):
        """Chain hashes of the prompt's full blocks: ``d_i = H(d_{i-1}
        || tokens_i)`` — a block's hash commits to its whole prefix, so
        one dict hit per block reconstructs the longest shared chain."""
        prev = b"mxtpu-prefix"
        out = []
        for i in range(n_blocks):
            prev = hashlib.blake2b(
                prev + prompt[i * self.block:(i + 1) * self.block]
                .tobytes(), digest_size=16).digest()
            out.append(prev)
        return out

    # ------------------------------------------------------------ admission
    def admit(self, slot, prompt, trace=None):
        """Prefix lookup + page allocation + ONE bucketed tail prefill
        writing straight into the pool; returns the next-token logits
        row of the last prompt token (a device tensor)."""
        t_kv0 = time.perf_counter()
        prompt = np.asarray(prompt, np.int64)
        p_len = int(prompt.size)
        blk = self.block
        n_full = p_len // blk
        hashes = self._block_hashes(prompt, n_full) if self.prefix_on \
            else []
        shared = []
        # reuse the longest cached chain, capped so >=1 tail token is
        # always prefilled (its logits seed the first sampled token) and
        # the cursor page stays fork-private
        for i in range((p_len - 1) // blk):
            pg = self._prefix.get(hashes[i]) if i < len(hashes) else None
            if pg is None:
                break
            shared.append(pg)
            self._prefix.move_to_end(hashes[i])
        n_shared = len(shared)
        hist = n_shared * blk
        tail = prompt[hist:]
        t = int(tail.size)
        # pin the matched chain BEFORE allocating: _alloc evicts ref==1
        # prefix pages, which would otherwise include this request's own
        # shared chain under pool pressure
        for pg in shared:
            self._ref[pg] += 1
        self._trace_ctx = trace
        try:
            owned = self._alloc((p_len + blk - 1) // blk - n_shared)
        except PoolExhausted:
            for pg in shared:
                self._ref[pg] -= 1
            raise
        finally:
            self._trace_ctx = None
        row = shared + owned
        self.bt[slot, :len(row)] = row
        self.bt[slot, len(row):] = 0
        self._slot_pages[slot] = list(row)
        if n_shared:
            _TM_PREFIX_HITS.inc(n_shared)
        bucket = next(b for b in self.prefill_buckets if b >= t)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :t] = tail
        dev = self.decoder.device
        # _snap: self.bt is mutated in place by later admits/steps
        args = (self.pool[0], self.pool[1], _snap(self.bt[slot], dev),
                _snap(padded, dev, np.int64), hist, t)
        tc = _compile_start(self.programs, "decode_prefill_paged", bucket)
        if bucket not in self._cost_prefill_done and _tm.perf.enabled():
            self._cost_prefill_done.add(bucket)
            logits = _tm.perf.count_cost(f"decode_prefill_paged[b{bucket}]",
                                         self.programs.prefill, *args)
        else:
            logits = self.programs.prefill(*args)
        _compile_done(tc, "decode_prefill_paged")
        self.cursor[slot] = p_len
        # promote this prompt's full blocks: they are never written
        # again (writes happen at cursor >= p_len), so they are safe to
        # share with every later identical prefix
        if self.prefix_on:
            for i in range(n_full):
                if hashes[i] not in self._prefix:
                    pg = row[i]
                    self._prefix[hashes[i]] = pg
                    self._ref[pg] += 1
        self._set_gauges()
        if trace is not None and _tracing.trace_on():
            if n_shared:
                _tracing.record_span(
                    "kv_prefix_hit", "replica", trace, 0.0,
                    blocks=n_shared, tokens=hist)
            _tracing.record_span(
                "kv_admit", "replica", trace,
                time.perf_counter() - t_kv0, slot=slot,
                pages_shared=n_shared, pages_owned=len(owned),
                bucket=bucket)
        return logits[0, t - 1]

    # ----------------------------------------------------------------- tick
    def step(self, tokens, occupied):
        """One decode step over the pool.  Rows crossing a block
        boundary get their next page here; a row the pool cannot feed
        is reported in ``starved`` for the scheduler to deliver
        truncated (its garbage write lands in the scratch page)."""
        starved = []
        for b in np.flatnonzero(occupied):
            b = int(b)
            c = int(self.cursor[b])
            if c >= self.decoder.max_len:
                raise MXNetError(
                    f"slot cursor at max_len {self.decoder.max_len}: "
                    "finish or evict the request before ticking it")
            idx = c // self.block
            if c % self.block == 0 and len(self._slot_pages[b]) <= idx:
                try:
                    pg = self._alloc(1)[0]
                except PoolExhausted:
                    starved.append(b)
                    continue
                self.bt[b, idx] = pg
                self._slot_pages[b].append(pg)
        dev = self.decoder.device
        # _snap: bt/cursor are mutated in place right below and on the
        # next tick — the uploads must never alias them
        # pages the largest cursor has reached (the pagewalk's trip count)
        n_live = int(self.cursor.max()) // self.block + 1
        args = (self.pool[0], self.pool[1], _snap(self.bt, dev),
                _snap(tokens, dev), _snap(self.cursor, dev), n_live)
        tc = _compile_start(self.programs, "decode_step_paged")
        if not self._cost_step_done and _tm.perf.enabled():
            self._cost_step_done = True
            # the kernel's live K/V rows, for its analytic FLOPs
            live_rows = int(np.minimum(self.cursor + 1, self.max_blocks
                                       * self.block).sum())
            logits = _tm.perf.count_cost("decode_step_paged",
                                         self.programs.step, *args,
                                         live_rows)
        else:
            logits = self.programs.step(*args)
        _compile_done(tc, "decode_step_paged")
        adv = occupied.copy()
        adv[starved] = False
        self.cursor[adv] += 1
        if starved:
            self._set_gauges()
        return logits, starved

    def exhausted(self, slot):
        return self.cursor[slot] >= self.decoder.max_len

    def release(self, slot):
        for pg in self._slot_pages[slot]:
            self._ref[pg] -= 1
            if self._ref[pg] == 0:
                self._free.append(pg)
        self._slot_pages[slot] = []
        self.bt[slot] = 0
        self.cursor[slot] = 0
        self._set_gauges()
