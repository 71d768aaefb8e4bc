"""Paged decode attention: walk the block table over the page pool.

The port of ``mxnet_tpu/ops/paged_attention.py``.  One entry point,
:func:`paged_attention`, with two lowerings picked by where the tensors
live:

- **the CUDA kernel** (``csrc/paged_attention.cu``) for tensors on the
  card.  It replaces the Pallas TPU kernel ``_pallas_attention``.  The
  function is bound by the bytes of the live K/V rows, so the kernel
  splits each (slot, head) across the sequence: one thread block per
  chunk of whole pages (:func:`split_of`) reads only the pages the
  slot's cursor has reached, with 16-byte loads and an online softmax,
  and writes a partial to an fp32 workspace; a second kernel merges the
  chunks in a fixed order.  A shape :func:`supports` rejects raises;
  there is no fallback.
- **the plain version** (:func:`_gather_attention`) for tensors on the
  CPU: materialise the slot's table with :func:`gather_tables`, then
  einsum / masked softmax / einsum — the JAX package's gather math.  The
  serving step also calls it on the card when ``MXTPU_PAGED_KERNEL``
  pins the gather path.

A third lowering, :func:`_pagewalk_attention` (the JAX package's
``_pagewalk_attention``), is plain tensor code that reads only the pages
some slot's cursor has reached, in granules of ``chunk`` pages; the
serving step takes it under ``MXTPU_PAGED_KERNEL=pagewalk``.

Schedules are plain dicts chosen by ``mxnet_tpu_torch.autotune`` at
``PagedSlots`` construction — never per tick — under the reference's key
(:func:`keysig`).  On a card whose shape :func:`supports` takes, the
search picks the kernel's split, ``{"impl": "cuda", "chunk_pages": p}``
with ``p`` pages a chunk; elsewhere it picks among ``{"impl":
"gather"}`` and ``{"impl": "pagewalk", "chunk": c}``
(:func:`candidate_schedules`).  :func:`default_schedule` on a card is
today's split (:func:`split_of`), so a search never loses to not
searching; :func:`make_bench_fn` times one tick's attention over all
layers for the search.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from ..telemetry import perf as _perf

__all__ = ["supports", "require", "gather_tables", "paged_attention",
           "split_of", "launch_count", "reset_launch_count", "MAX_DH",
           "MAX_CONTEXT", "keysig", "default_schedule",
           "candidate_schedules", "make_bench_fn"]

# the masking constant of the decode stack (== models.decode.NEG_INF;
# kept literal so this op module never imports the models package)
NEG_INF = -1e30

# the CUDA kernel's own limits.  MAX_DH: a warp merges its rows in
# shared memory sized for dh <= 256.  MAX_CONTEXT: the split kernel
# keeps no scores in shared memory, so nothing on the card bounds the
# context any more; the limit stays because it is what the kernel is
# tested to (tests/test_torch_kernels_cuda.py runs a slot at it) and
# because the combine kernel walks a (slot, head)'s chunks one after
# another (384 of them here).  Lifting it is a ROADMAP item.
MAX_DH = 256
MAX_CONTEXT = 49152                  # M * block positions

# the split: each thread block takes a chunk of whole pages covering about
# SPLIT_POSITIONS positions (at most MAX_CHUNK_PAGES pages, the kernel's
# shared-memory table of page ids)
SPLIT_POSITIONS = 128
MAX_CHUNK_PAGES = 16

# the schedules' knobs: the pagewalk's page granules (the JAX package's
# _PAGEWALK_CHUNKS) and the kernel's pages a chunk (up to MAX_CHUNK_PAGES)
_PAGEWALK_CHUNKS = (1, 2, 4, 8)
_CHUNK_PAGES = (1, 2, 4, 8, MAX_CHUNK_PAGES)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel in this process: a plain integer, bumped
# where the kernel is launched and nowhere else
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count():
    global _launches
    _launches = 0


def split_of(M: int, block: int):
    """``(pages per chunk, chunks)`` of the CUDA kernel's split of a
    ``(B, M)`` table of ``block``-position pages: chunks of whole pages,
    about ``SPLIT_POSITIONS`` positions each, from the shapes alone (no
    device value is read)."""
    pages = max(1, min(MAX_CHUNK_PAGES, SPLIT_POSITIONS // block))
    return pages, -(-M // pages)


def supports(block: int, dh: int, dtype) -> bool:
    """Can the CUDA kernel run ``(block, dh)`` KV pages of ``dtype``?

    The JAX package's gate — f32 or bf16, ``block % 8 == 0``,
    ``dh % 8 == 0`` — plus the kernel's own limit ``dh <= MAX_DH`` (256).
    The context ``M * block`` must also stay within ``MAX_CONTEXT``
    (49152 positions, the context the kernel is tested to);
    :func:`require` checks that one too, since the gate does not see
    ``M``."""
    if dtype not in _DTYPE_CODE:
        return False
    return (block > 0 and dh > 0 and block % 8 == 0 and dh % 8 == 0
            and dh <= MAX_DH)


def require(block: int, dh: int, dtype, context: int, chunk_pages=None):
    """Raise :class:`MXNetError` naming the limit unless the CUDA kernel
    can take ``(block, dh)`` pages of ``dtype`` over ``context``
    positions (``M * block``), split into chunks of ``chunk_pages``
    pages (when given: 1 to ``MAX_CHUNK_PAGES``, the kernel's
    shared-memory table of page ids)."""
    if not supports(block, dh, dtype):
        raise MXNetError(
            f"paged_attention CUDA kernel does not support block={block}, "
            f"dh={dh}, dtype={dtype}: it needs float32 or bfloat16, block "
            f"% 8 == 0, dh % 8 == 0 and dh <= {MAX_DH}")
    if context > MAX_CONTEXT:
        raise MXNetError(
            f"paged_attention CUDA kernel: context {context} exceeds "
            f"MAX_CONTEXT {MAX_CONTEXT}")
    if chunk_pages is not None and not 1 <= int(chunk_pages) \
            <= MAX_CHUNK_PAGES:
        raise MXNetError(
            f"paged_attention CUDA kernel: chunk_pages {chunk_pages} is "
            f"outside 1..{MAX_CHUNK_PAGES} (its table of page ids)")


# ------------------------------------------------------------- schedules
def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def keysig(B: int, H: int, M: int, block: int, dh: int, dtype) -> str:
    """The autotuner shape signature of one decode-step workload (the
    JAX package's format)."""
    return "b%dh%dm%dk%dd%d_%s" % (B, H, M, block, dh, _dtype_name(dtype))


def default_schedule(platform: str, block: int, dh: int, dtype) -> dict:
    """What runs with no tuned winner: on a card (``platform`` "cuda")
    whose shape the kernel takes, the kernel under today's split
    (:func:`split_of`); the gather path everywhere else."""
    if platform == "cuda" and supports(block, dh, dtype):
        # split_of's pages a chunk depend on the page size alone
        return {"impl": "cuda", "chunk_pages": split_of(1, block)[0]}
    return {"impl": "gather"}


def candidate_schedules(platform: str, block: int, dh: int, M: int,
                        dtype) -> list:
    """The search space for one shape signature.  On a card whose shape
    the kernel takes, the kernel's splits of ``p`` pages a chunk, ``p <=
    MAX_CHUNK_PAGES`` (today's split among them): a search picks how
    the kernel runs, never whether it runs — the gather and pagewalk
    paths are the plain versions, reached on a card only by pinning
    ``MXTPU_PAGED_KERNEL``.  Elsewhere the JAX package's list: gather
    (a winner never loses to not tuning) and the pagewalk granules that
    divide the table width."""
    if platform == "cuda" and supports(block, dh, dtype):
        return [{"impl": "cuda", "chunk_pages": p} for p in _CHUNK_PAGES]
    cands = [{"impl": "gather"}]
    for ch in _PAGEWALK_CHUNKS:
        if ch <= M and M % ch == 0:
            cands.append({"impl": "pagewalk", "chunk": ch})
    return cands


# ---------------------------------------------------------------- gather
def gather_tables(pool, bt, block: int, layer=None):
    """``(P, L, H, blk, dh)[bt (B, M)] -> (L, B, H, M*blk, dh)``, or
    ``(B, H, M*blk, dh)`` for one ``layer`` (which gathers that layer's
    pages only)."""
    B, M = bt.shape
    _P, L, H, blk, dh = pool.shape
    idx = bt.long()
    if layer is not None:
        t = pool[:, layer][idx]                  # (B, M, H, blk, dh)
        return t.permute(0, 2, 1, 3, 4).reshape(B, H, M * block, dh)
    t = pool[idx]                                # (B, M, L, H, blk, dh)
    t = t.permute(2, 0, 3, 1, 4, 5)              # (L, B, H, M, blk, dh)
    return t.reshape(L, B, H, M * block, dh)


@functools.lru_cache(maxsize=None)
def _scale(dh: int, dtype) -> float:
    """``sqrt(dh)`` rounded to ``dtype``, as the JAX math computes it
    (``jnp.sqrt(jnp.asarray(dh, q.dtype))``): 11.3125 for dh=128 in
    bf16, not 11.3137."""
    return float(torch.tensor(float(dh), dtype=dtype).sqrt())


def _attend(q, kc, vc, valid):
    """The port's one plain attention: ``q (B, H, n, dh)`` over
    ``kc``/``vc`` ``(B, H, S, dh)`` where ``valid`` (broadcastable to
    ``(B, H, n, S)``) is True; returns ``(B, H, n, dh)`` in q's dtype.

    Masked scores are NEG_INF (-1e30), not -inf, and the scale is
    ``sqrt(dh)`` rounded to q's dtype, like the JAX math.  Scores,
    softmax and the weighted sum run in fp32 and the result is rounded
    once to q's dtype — what the CUDA kernel computes.  In fp32 this is
    the JAX math exactly; in bf16 it leaves out the JAX math's roundings
    of scores and weights to bf16, which at full width move the logits
    by several bf16 ulps and would hide a kernel error of that size.
    The decoder's contiguous path, the paged prefill and the plain
    version of the kernel all attend through this function."""
    scores = torch.einsum("bhnd,bhsd->bhns", q.float(), kc.float()) \
        / _scale(q.shape[-1], q.dtype)
    scores = scores.masked_fill(~valid, NEG_INF)
    att = torch.softmax(scores, dim=-1)
    return torch.einsum("bhns,bhsd->bhnd", att, vc.float()).to(q.dtype)


def _gather_attention(q, pool_k, pool_v, bt, cursor, layer, block):
    """The plain version of the kernel: gather the slot's table, then
    :func:`_attend` over ``[0, cursor[b]]``."""
    kc = gather_tables(pool_k, bt, block, layer)
    vc = gather_tables(pool_v, bt, block, layer)
    S = kc.shape[2]
    valid = torch.arange(S, device=q.device)[None, :] <= cursor[:, None]
    return _attend(q, kc, vc, valid[:, None, None, :])


def _pagewalk_attention(q, pool_k, pool_v, bt, cursor, layer, block,
                        n_live, chunk=1):
    """The live-page walk: the first ``n_live`` pages of every slot's
    table (the pages the largest cursor has reached, a host int the
    caller knows without reading the device), rounded up to whole
    granules of ``chunk`` pages, then :func:`_attend` over ``[0,
    cursor[b]]``.  The same values as the gather path, which attends
    over all ``M * block`` positions with the dead ones masked to exact
    zeros."""
    B, H, _n, dh = q.shape
    chunk = max(1, int(chunk))
    m = max(1, min(-(-int(n_live) // chunk) * chunk, bt.shape[1]))
    pgs = bt[:, :m].long()
    k = pool_k[pgs, layer].permute(0, 2, 1, 3, 4).reshape(B, H, m * block, dh)
    v = pool_v[pgs, layer].permute(0, 2, 1, 3, 4).reshape(B, H, m * block, dh)
    valid = torch.arange(m * block, device=q.device)[None, :] \
        <= cursor[:, None]
    return _attend(q, k, v, valid[:, None, None, :])


# ------------------------------------------------------------------ CUDA
def _lib():
    from . import _build

    lib = _build.load("paged_attention")
    fn = lib.mxtt_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _cuda_attention(q, pool_k, pool_v, bt, cursor, layer, block,
                    chunk_pages=None, live_rows=None):
    global _launches
    B, H, n, dh = q.shape
    P, L, Hp, blk, dhp = pool_k.shape
    M = bt.shape[1]
    if chunk_pages is None:
        chunk_pages = split_of(M, block)[0]
    require(block, dh, q.dtype, M * block, chunk_pages)
    if (n != 1 or (Hp, blk, dhp) != (H, block, dh)
            or pool_v.shape != pool_k.shape or bt.shape[0] != B
            or cursor.shape != (B,) or not 0 <= layer < L):
        raise MXNetError(
            f"paged_attention: inconsistent shapes q={tuple(q.shape)} "
            f"pool={tuple(pool_k.shape)} bt={tuple(bt.shape)} "
            f"cursor={tuple(cursor.shape)} layer={layer} block={block}")
    for name, t, dt in (("q", q, q.dtype), ("pool_k", pool_k, q.dtype),
                        ("pool_v", pool_v, q.dtype), ("bt", bt, torch.int32),
                        ("cursor", cursor, torch.int32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise MXNetError(
                f"paged_attention: {name} must be a contiguous {dt} tensor "
                f"on {q.device}, got {t.dtype} on {t.device}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if t.data_ptr() % 16:
            raise MXNetError(f"paged_attention: {name} must start on a "
                             f"16-byte boundary (the kernel's loads)")
    out = torch.empty_like(q)
    chunk_pages = int(chunk_pages)
    n_split = -(-M // chunk_pages)
    # the chunks' partials (acc[dh], m, l), from the caching allocator
    part = torch.empty(B * H * n_split * (dh + 2), dtype=torch.float32,
                       device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), pool_k.data_ptr(),
                 pool_v.data_ptr(), bt.data_ptr(), cursor.data_ptr(),
                 part.data_ptr(), out.data_ptr(), B, H, M, block, dh, L,
                 int(layer), chunk_pages, _scale(dh, q.dtype), stream)
    if err != 0:
        raise MXNetError(f"paged_attention CUDA launch failed: cuda error "
                         f"{err}")
    _launches += 1
    if live_rows is not None:
        # the perf plane's count: 2 products of 2*dh flops a live row
        _perf.kernel_flops(4 * int(live_rows) * H * dh)
    return out


# ------------------------------------------------------------------ entry
def paged_attention(q, pool_k, pool_v, bt, cursor, layer, *, block,
                    chunk_pages=None, live_rows=None):
    """Decode attention for one layer straight off the page pool.

    ``q``: ``(B, H, 1, dh)``; ``pool_k``/``pool_v``: ``(P, L, H, block,
    dh)``; ``bt``: ``(B, M)`` int32 page ids; ``cursor``: ``(B,)`` int32
    absolute positions (attend over ``[0, cursor[b]]``).  Returns ``(B,
    H, 1, dh)`` in q's dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel split into chunks of ``chunk_pages`` pages
    (None: :func:`split_of`, the default schedule), or raise when it
    cannot take the shape or the split.  ``live_rows`` (the caller's
    host count of live K/V rows, ``sum(cursor + 1)``) feeds the perf
    plane's FLOP count of the launch."""
    if q.device.type == "cpu":
        return _gather_attention(q, pool_k, pool_v, bt, cursor, layer,
                                 block)
    if q.device.type != "cuda":
        raise MXNetError(f"paged_attention: no lowering for device "
                         f"{q.device}")
    return _cuda_attention(q, pool_k, pool_v, bt, cursor, layer, block,
                           chunk_pages, live_rows)


# ------------------------------------------------------------- benchmark
def make_bench_fn(schedule, *, B, H, M, block, dh, L, dtype=torch.float32,
                  device="cpu"):
    """A thunk timing one decode tick's attention (all ``L`` layers)
    under ``schedule`` on a seeded steady-state pool on ``device``:
    per-slot cursors spread raggedly across the context (mean about half
    full — the regime a serving mix sits in), block tables dense.  Each
    lowering runs as the serving step runs it, layer by layer (the
    gather path gathers one layer's pages at a time).  A CUDA schedule
    the kernel refuses (its shape or its split) raises
    ``autotune.ScheduleRejected`` here, before any launch; the search
    skips it.  Used by the ``PagedSlots`` tuning call site."""
    from ..autotune import ScheduleRejected

    sched = dict(schedule or {"impl": "gather"})
    impl = sched.get("impl", "gather")
    device = torch.device(device)
    if impl == "cuda":
        try:
            if device.type != "cuda":
                raise MXNetError(f"the kernel needs a CUDA pool, not "
                                 f"{device}")
            require(block, dh, dtype, M * block, sched.get("chunk_pages"))
        except MXNetError as exc:
            raise ScheduleRejected(f"paged_attention schedule {sched}: "
                                   f"{exc}") from exc
    elif impl not in ("gather", "pagewalk"):
        raise ScheduleRejected(f"paged_attention: unknown schedule {sched}")
    S = M * block
    P = B * M + 1
    # drawn where they live: a full-width pool is 10^8 values a table
    gen = torch.Generator(device=device).manual_seed(0)
    pool_k = torch.randn((P, L, H, block, dh), generator=gen,
                         device=device).to(dtype)
    pool_v = torch.randn((P, L, H, block, dh), generator=gen,
                         device=device).to(dtype)
    q = torch.randn((B, H, 1, dh), generator=gen, device=device).to(dtype)
    bt = (torch.randperm(P - 1, generator=gen, device=device)[:B * M]
          + 1).reshape(B, M).to(torch.int32)
    cursor_host = torch.linspace(block, S - 1, B).to(torch.int32)
    cursor = cursor_host.to(device)
    n_live = int(cursor_host.max()) // block + 1

    def gather():
        with torch.inference_mode():
            return sum(_gather_attention(q, pool_k, pool_v, bt, cursor, i,
                                         block)
                       for i in range(L))

    def pagewalk():
        with torch.inference_mode():
            return sum(_pagewalk_attention(q, pool_k, pool_v, bt, cursor, i,
                                           block, n_live,
                                           sched.get("chunk", 1))
                       for i in range(L))

    def kernel():
        return sum(_cuda_attention(q, pool_k, pool_v, bt, cursor, i, block,
                                   sched["chunk_pages"])
                   for i in range(L))

    return {"gather": gather, "pagewalk": pagewalk, "cuda": kernel}[impl]
