"""Incremental (KV-cache) decoding for the transformer LM, in PyTorch.

The port of ``mxnet_tpu/models/decode.py``.  The decoder reads the SAME
``arg_params`` a ``transformer_lm`` checkpoint binds
(``tok_embed``/``pos_embed``/``layer{i}_*``/``final_ln``/``lm_head``,
see ``models/transformer.py:lm_param_shapes``) and runs the forward as
plain tensor code on an explicit ``device``.

Three differences from the JAX decoder, all deliberate:

- The caches are updated IN PLACE.  JAX rebuilds its ``(L, B, H,
  max_len, dh)`` cache functionally on every call; here ``step`` and
  ``step_slots`` write the new K/V into the cache tensors they are given
  and return those same tensors, so no per-token copy of the cache is
  made.  A state passed to ``step`` is consumed by it.
- Everything runs eagerly under ``torch.inference_mode()``; there is no
  compile step and no program cache.
- Attention scores, softmax and the weighted sum run in fp32 and are
  rounded once to the cache dtype (``ops/paged_attention.py:_attend``),
  on every path; in fp32 that is the JAX math exactly, in bf16 it skips
  the JAX math's intermediate bf16 roundings.

``quantize="int8"`` keeps every ``*weight`` matrix as int8 + per-row
fp32 scales on the device (``serving/quantize.py``) and dequantizes it
where it is consumed, inside each step; the embedding table is read
row by row (:meth:`KVDecoder._embed`), so a step never dequantizes the
whole table.  ``generate_scan`` runs its token loop on the device with
no host sync per token; ``beam_search`` keeps the reference's host
bookkeeping.  Not ported yet: ``mesh=`` tensor parallelism (ROADMAP
Queue 1 item 10b).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import telemetry as _tm
from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from ..convert import from_jax_params
from ..ops import paged_attention as _pa

__all__ = ["KVDecoder", "NEG_INF", "SCAN_EOS_CHECK"]

NEG_INF = -1e30

# generate_scan with an eos_id reads ``done.all()`` back to the host
# every SCAN_EOS_CHECK tokens (one sync each) to exit early; finished
# rows are eos-frozen, so the output equals a per-token test's
SCAN_EOS_CHECK = 16


def _snap(x, device, dtype=np.int32):
    """Device copy of host-side slot state (tokens/start/cursor/block
    tables) that can never alias the caller's buffer: the host array is
    copied first, and the tensor is made from that private copy.  The
    scheduler mutates ``cursor``/``bt`` in place right after a dispatch
    (``cursor[b] += 1``, ``bt[b, idx] = page``); on the CPU
    ``torch.from_numpy`` would otherwise share their memory, and no
    upload ever goes through pinned memory that a later host write could
    reach before the copy ran."""
    return torch.from_numpy(np.array(x, dtype, copy=True)).to(device)


def _ln(x, g, b, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * g + b


class _DequantView(dict):
    """Param dict whose quantized entries dequantize on read (the JAX
    package's ``_DequantView``): ``p[name]`` of an int8 weight is
    ``q.to(dtype) * scale``, made where the step consumes it, so the
    device keeps only the int8 storage between steps."""

    def __getitem__(self, key):
        v = dict.__getitem__(self, key)
        return v.dequantize() if _quantized(v) else v


def _quantized(v):
    """Is ``v`` a ``QuantizedTensor`` (torch tensors have a
    ``dequantize`` method of their own)?"""
    return not isinstance(v, torch.Tensor) and hasattr(v, "dequantize")


def _logsumexp(x):
    m = x.max(-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(-1, keepdims=True))


def _fc(x, w, b=None):
    y = x @ w.T
    return y if b is None else y + b


def _gelu(x):
    # jax.nn.gelu defaults to approximate=True (the tanh form) and the JAX
    # decoder calls it with the default; torch's default is the exact erf
    return F.gelu(x, approximate="tanh")


class KVDecoder:
    """One instance per (checkpoint, max_len, dtype, device).

    state = (k_cache, v_cache, pos):
      k/v_cache (L, B, H, max_len, dh); pos — tokens filled so far (host int).
    """

    def __init__(self, arg_params, num_layers, num_heads, max_len,
                 dtype=torch.float32, mesh=None, model_axis="model",
                 quantize=None, device=None):
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} "
                             "(supported: 'int8')")
        if quantize == "int8" and mesh is not None:
            raise ValueError(
                "quantize='int8' is not supported together with a "
                "tensor-parallel mesh (shard the fp weights instead)")
        if mesh is not None:
            raise MXNetError(
                "KVDecoder(mesh=...) tensor-parallel serving is not ported "
                "yet (ROADMAP Queue 1 item 10b)")
        self.device = resolve_device(device)
        self.dtype = torch_dtype(dtype)
        # every param in the compute dtype first: int8 scales are taken
        # from the rounded weights, as in the JAX decoder
        p = from_jax_params(arg_params, self.dtype, self.device)
        self.mesh = None
        self.model_axis = model_axis
        self.L, self.H = int(num_layers), int(num_heads)
        self.max_len = int(max_len)
        self.d_model = p["tok_embed_weight"].shape[1]
        self.dh = self.d_model // self.H
        self.vocab = p["lm_head_weight"].shape[0]
        self._cache_dtype = p["tok_embed_weight"].dtype
        if p["pos_embed"].shape[1] < self.max_len:
            raise ValueError(
                f"checkpoint pos table {p['pos_embed'].shape[1]} < "
                f"max_len {self.max_len}")
        if quantize == "int8":
            from ..serving.quantize import quantize_params

            p = quantize_params(p, dtype=self.dtype, device=self.device)
        if any(_quantized(v) for v in p.values()):
            p = _DequantView(p)
        self.quantize = quantize
        self.p = p
        self.last_scan_syncs = 0
        # perf plane: one cost row per decode program, at its first
        # dispatch
        self._cost_step_done = False
        self._cost_prefill_done = set()

    def weight_bytes(self) -> int:
        """Bytes the parameters hold on the device (int8 payloads and
        their fp32 scales for quantized weights)."""
        total = 0
        for v in dict.values(self.p):
            if _quantized(v):
                total += v.q.numel() * v.q.element_size() \
                    + v.scale.numel() * v.scale.element_size()
            else:
                total += v.numel() * v.element_size()
        return total

    # ---------------------------------------------------------------- core
    def _block_qkv(self, i, h2):
        p = self.p
        name = f"layer{i}"
        q = _fc(h2, p[f"{name}_q_weight"], p[f"{name}_q_bias"])
        k = _fc(h2, p[f"{name}_k_weight"], p[f"{name}_k_bias"])
        v = _fc(h2, p[f"{name}_v_weight"], p[f"{name}_v_bias"])
        return q, k, v

    def _block_tail(self, i, h, ctx):
        """Output projection + residual + the FFN half of block ``i``:
        ``ctx`` ``(B, n, D)`` is the attention output."""
        p = self.p
        name = f"layer{i}"
        h = h + _fc(ctx, p[f"{name}_proj_weight"], p[f"{name}_proj_bias"])
        h2 = _ln(h, p[f"{name}_ln2_gamma"], p[f"{name}_ln2_beta"])
        f = _fc(h2, p[f"{name}_ffn_in_weight"], p[f"{name}_ffn_in_bias"])
        f = _gelu(f)
        f = _fc(f, p[f"{name}_ffn_out_weight"], p[f"{name}_ffn_out_bias"])
        return h + f

    def _head(self, h):
        p = self.p
        h = _ln(h, p["final_ln_gamma"], p["final_ln_beta"])
        return _fc(h, p["lm_head_weight"], p["lm_head_bias"])

    def _embed(self, tokens):
        """Token embeddings ``tok_embed_weight[tokens]``; an int8 table
        is gathered row by row and only those rows are scaled."""
        w = dict.__getitem__(self.p, "tok_embed_weight")
        idx = tokens.long()
        return w.rows(idx) if _quantized(w) else w[idx]

    def _heads(self, a, B, n):
        """``(B, n, D) -> (B, H, n, dh)``."""
        return a.reshape(B, n, self.H, self.dh).transpose(1, 2)

    def _attend(self, qh, kc, vc, valid):
        """Masked attention through the port's one plain attention
        (``ops/paged_attention.py:_attend``: fp32 inside, NEG_INF masking,
        the scale rounded to the cache dtype), merged back to ``(B, n,
        D)``."""
        ctx = _pa._attend(qh, kc, vc, valid)
        B, _H, n, _dh = ctx.shape
        return ctx.transpose(1, 2).reshape(B, n, self.d_model)

    @torch.inference_mode()
    def _forward_positions(self, kc, vc, pos, tokens, n):
        """Run ``n`` new positions (tokens (B, n)) against the cache,
        writing their K/V at ``pos .. pos+n-1`` in place."""
        p = self.p
        B = tokens.shape[0]
        tok = self._embed(tokens)                               # (B, n, D)
        h = tok + p["pos_embed"][:, pos:pos + n]
        span = pos + torch.arange(n, device=self.device)
        mask = torch.arange(self.max_len, device=self.device)[None, :] \
            <= span[:, None]                                    # (n, S)
        for i in range(self.L):
            name = f"layer{i}"
            h2 = _ln(h, p[f"{name}_ln1_gamma"], p[f"{name}_ln1_beta"])
            q, k, v = self._block_qkv(i, h2)
            kc[i, :, :, pos:pos + n] = self._heads(k, B, n)
            vc[i, :, :, pos:pos + n] = self._heads(v, B, n)
            ctx = self._attend(self._heads(q, B, n), kc[i], vc[i],
                               mask[None, None])
            h = self._block_tail(i, h, ctx)
        return (kc, vc), self._head(h)                          # (B, n, V)

    # ----------------------------------------------------------------- API
    def init_state(self, batch):
        """state = (k_cache, v_cache, pos) — pos is a HOST int."""
        shape = (self.L, batch, self.H, self.max_len, self.dh)
        with torch.inference_mode():
            kc = torch.zeros(shape, dtype=self._cache_dtype,
                             device=self.device)
            vc = torch.zeros(shape, dtype=self._cache_dtype,
                             device=self.device)
        return (kc, vc, 0)

    def _tokens(self, tokens):
        return torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)

    def prefill(self, tokens):
        """tokens (B, T) -> (state, logits (B, T, V))."""
        tokens = self._tokens(tokens)
        B, T = tokens.shape
        if T > self.max_len:
            raise ValueError(f"prompt {T} > max_len {self.max_len}")
        kc, vc, pos = self.init_state(B)
        (kc, vc), logits = self._forward_positions(kc, vc, pos, tokens, T)
        return (kc, vc, pos + T), logits

    def step(self, state, token):
        """token (B,) -> (state, logits (B, V)); updates the state's
        caches in place."""
        kc, vc, pos = state
        if pos >= self.max_len:
            raise ValueError(
                f"cache full: {self.max_len} positions decoded (the "
                "checkpoint's positional table ends there)")
        (kc, vc), logits = self._forward_positions(
            kc, vc, pos, self._tokens(token).reshape(-1, 1), 1)
        return (kc, vc, pos + 1), logits[:, 0]

    # ------------------------------------------------- slot-pool API
    # (continuous batching, mxnet_tpu_torch/serving/): each batch row is
    # an independent request slot whose cache window [start, cursor] the
    # CALLER tracks as host int arrays — no step reads device state.

    @torch.inference_mode()
    def _forward_slots(self, kc, vc, tokens, start, cursor):
        """One decode position for EVERY slot at once, each row at its
        own cache position: row ``b`` writes its new K/V at ``cursor[b]``
        (in place) and attends over ``[start[b], cursor[b]]`` with
        position embedding ``cursor[b] - start[b]``.  Free rows ride
        along; their writes land where :meth:`adopt_row` overwrites."""
        p = self.p
        B = tokens.shape[0]
        tok = self._embed(tokens)                               # (B, D)
        pos_ids = (cursor - start).clamp(0, self.max_len - 1).long()
        h = (tok + p["pos_embed"][0][pos_ids])[:, None]         # (B, 1, D)
        s_idx = torch.arange(self.max_len, device=self.device)
        valid = (s_idx[None, :] >= start[:, None]) & \
            (s_idx[None, :] <= cursor[:, None])                 # (B, S)
        rows = torch.arange(B, device=self.device)
        cur = cursor.long()
        for i in range(self.L):
            name = f"layer{i}"
            h2 = _ln(h, p[f"{name}_ln1_gamma"], p[f"{name}_ln1_beta"])
            q, k, v = self._block_qkv(i, h2)
            kc[i, rows, :, cur] = self._heads(k, B, 1)[:, :, 0]
            vc[i, rows, :, cur] = self._heads(v, B, 1)[:, :, 0]
            ctx = self._attend(self._heads(q, B, 1), kc[i], vc[i],
                               valid[:, None, None, :])
            h = self._block_tail(i, h, ctx)
        return (kc, vc), self._head(h)[:, 0]                    # (B, V)

    @torch.inference_mode()
    def _forward_padded(self, kc, vc, tokens, start):
        """Left-padded prefill: ``tokens`` (B, T) with row ``b``'s real
        prompt right-aligned in the last ``T - start[b]`` positions.
        Real tokens write K/V at their padded index and attend over
        ``[start[b], n]``; pad queries attend to themselves only."""
        p = self.p
        B, T = tokens.shape
        tok = self._embed(tokens)                               # (B, T, D)
        n_idx = torch.arange(T, device=self.device)
        pos_ids = (n_idx[None, :] - start[:, None]).clamp(
            0, self.max_len - 1).long()                         # (B, T)
        h = tok + p["pos_embed"][0][pos_ids]
        s_idx = torch.arange(self.max_len, device=self.device)
        lo = torch.minimum(start[:, None], n_idx[None, :])      # (B, T)
        valid = (s_idx[None, None, :] <= n_idx[None, :, None]) & \
            (s_idx[None, None, :] >= lo[:, :, None])            # (B, T, S)
        for i in range(self.L):
            name = f"layer{i}"
            h2 = _ln(h, p[f"{name}_ln1_gamma"], p[f"{name}_ln1_beta"])
            q, k, v = self._block_qkv(i, h2)
            kc[i, :, :, :T] = self._heads(k, B, T)
            vc[i, :, :, :T] = self._heads(v, B, T)
            ctx = self._attend(self._heads(q, B, T), kc[i], vc[i],
                               valid[:, None])
            h = self._block_tail(i, h, ctx)
        return (kc, vc), self._head(h)                          # (B, T, V)

    def init_slot_state(self, num_slots):
        """Empty slot-pool cache ``(k_cache, v_cache)`` for ``num_slots``
        slots; the per-slot ``start``/``cursor`` windows live with the
        caller (host int arrays)."""
        kc, vc, _ = self.init_state(num_slots)
        return kc, vc

    def prefill_padded(self, tokens, lengths):
        """Variable-length co-batched prefill.  ``tokens`` (B, T)
        LEFT-padded, ``lengths`` (B,) real prompt lengths (0 < len <= T).
        Returns ``((kc, vc), logits)`` with logits (B, T, V);
        ``logits[:, -1]`` is every row's next-token distribution.  The
        caller's slot windows are ``start = T - lengths``, ``cursor = T``."""
        tokens = self._tokens(tokens)
        B, T = tokens.shape
        lengths = np.asarray(lengths, np.int64)
        if T > self.max_len:
            raise ValueError(f"padded prompt {T} > max_len {self.max_len}")
        if lengths.shape != (B,) or (lengths <= 0).any() \
                or (lengths > T).any():
            raise ValueError(
                f"lengths must be (B,) in [1, {T}], got {lengths!r}")
        kc, vc, _ = self.init_state(B)
        start = _snap(T - lengths, self.device)
        if T not in self._cost_prefill_done and _tm.perf.enabled():
            # perf plane: the bucket's cost row, at its first dispatch
            self._cost_prefill_done.add(T)
            return _tm.perf.count_cost(f"decode_prefill[b{T}]",
                                       self._forward_padded, kc, vc, tokens,
                                       start)
        return self._forward_padded(kc, vc, tokens, start)

    def step_slots(self, cache, tokens, start, cursor):
        """One decode tick over the whole slot pool: (B,) next tokens in,
        ``((kc, vc), logits (B, V))`` out, the caches updated in place.
        The caller advances ``cursor[b] += 1`` for every row it consumed
        and MUST keep ``cursor < max_len``."""
        kc, vc = cache
        cursor = np.asarray(cursor)
        if (cursor >= self.max_len).any():
            raise ValueError(
                f"slot cursor at max_len {self.max_len}: finish or evict "
                "the request before ticking it")
        args = (kc, vc, _snap(tokens, self.device),
                _snap(start, self.device), _snap(cursor, self.device))
        if not self._cost_step_done and _tm.perf.enabled():
            # perf plane: the tick's cost row, at its first dispatch
            self._cost_step_done = True
            return _tm.perf.count_cost("decode_step_slots",
                                       self._forward_slots, *args)
        return self._forward_slots(*args)

    def adopt_row(self, cache, row_cache, slot):
        """Copy a freshly prefilled batch-1 cache (from
        :meth:`prefill_padded` at B=1) into slot ``slot`` of the pool, in
        place — the admission write of the continuous-batching
        scheduler."""
        kc, vc = cache
        kr, vr = row_cache
        if kr.shape[1] != 1:
            raise ValueError(f"row cache must be batch-1, got {kr.shape}")
        with torch.inference_mode():
            kc[:, slot:slot + 1] = kr
            vc[:, slot:slot + 1] = vr
        return kc, vc

    def _check_generation_budget(self, prompt, n_tokens):
        prompt = np.asarray(prompt)
        total = prompt.shape[1] + n_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt+n_tokens = {total} exceeds max_len "
                f"{self.max_len} (the checkpoint's positional table)")
        empty = (np.zeros((prompt.shape[0], 0), np.int64)
                 if n_tokens <= 0 else None)
        return prompt, empty

    def generate(self, prompt, n_tokens, temperature=1.0, top_k=None,
                 rng=None):
        """Greedy/temperature sampling loop; returns (B, n_tokens)."""
        rng = rng or np.random.RandomState(0)
        prompt, empty = self._check_generation_budget(prompt, n_tokens)
        if empty is not None:
            return empty
        state, logits = self.prefill(prompt)
        last = logits[:, -1]
        out = []
        for i in range(n_tokens):
            lg = last.float().cpu().numpy()
            if temperature <= 0:
                nxt = lg.argmax(-1)
            else:
                lg = lg / temperature
                if top_k:
                    kth = np.partition(lg, -top_k, axis=-1)[:, -top_k, None]
                    lg = np.where(lg < kth, -np.inf, lg)
                z = lg - lg.max(-1, keepdims=True)
                prob = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
                nxt = np.array([rng.choice(lg.shape[-1], p=p_)
                                for p_ in prob])
            out.append(nxt)
            if i + 1 < n_tokens:  # the last sampled token needs no step
                state, last = self.step(state, nxt)
        return np.stack(out, axis=1)

    def generate_scan(self, prompt, n_tokens, temperature=0.0,
                      top_k=None, seed=0, eos_id=None):
        """:meth:`generate`, with the whole token loop on the device: the
        picked tokens go into a device buffer that the host reads once,
        at the end, and no token waits for the host.  Greedy when
        ``temperature <= 0`` (token-for-token :meth:`generate`'s output);
        otherwise categorical sampling (Gumbel-max over ``logits /
        temperature``, the JAX package's ``jax.random.categorical``)
        from a ``torch.Generator`` seeded with ``seed``, after an
        optional ``top_k`` cut.

        With ``eos_id``, rows that emit it are eos-padded from then on
        (``beam_search``'s convention) and the loop exits once every row
        has finished.  That test reads ``done.all()`` on the host every
        :data:`SCAN_EOS_CHECK` (16) tokens, one sync each; finished rows
        are frozen, so the output is the same as with a test after every
        token.  ``last_scan_syncs`` holds the host syncs of the last
        call: 1, or 1 + ceil((n_tokens - 1) / 16) at most with
        ``eos_id``."""
        prompt, empty = self._check_generation_budget(prompt, n_tokens)
        if empty is not None:
            return empty
        (kc, vc, pos), logits = self.prefill(prompt)
        greedy = temperature <= 0
        gen = None
        if not greedy:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))

        def pick(lg):
            lg = lg.float()
            if top_k:
                kth = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
                lg = lg.masked_fill(lg < kth, NEG_INF)
            if greedy:
                return lg.argmax(-1)
            u = torch.rand(lg.shape, generator=gen, device=lg.device)
            return (lg / temperature - torch.log(-torch.log(u))).argmax(-1)

        B = prompt.shape[0]
        syncs = 0
        with torch.inference_mode():
            toks = torch.empty((B, n_tokens), dtype=torch.int64,
                               device=self.device)
            tok = pick(logits[:, -1])
            toks[:, 0] = tok
            done = None if eos_id is None else tok == eos_id
            for i in range(n_tokens - 1):
                if done is not None and i % SCAN_EOS_CHECK == 0:
                    syncs += 1
                    if bool(done.all()):
                        toks[:, i + 1:] = eos_id
                        break
                (kc, vc), lg = self._forward_positions(
                    kc, vc, pos + i, tok[:, None], 1)
                tok = pick(lg[:, 0])
                if done is not None:
                    tok = tok.masked_fill(done, eos_id)   # freeze finished
                    done = done | (tok == eos_id)
                toks[:, i + 1] = tok
            out = toks.cpu().numpy()
        self.last_scan_syncs = syncs + 1
        return out

    def beam_search(self, prompt, n_tokens, beam_size=4,
                    length_penalty=0.0, eos_id=None):
        """Beam decode: returns (tokens (B, beam, n_tokens),
        scores (B, beam)) sorted best-first per batch row.

        With ``eos_id`` set, beams that emit it stop accumulating score
        (further positions are eos-padded) and ``length_penalty``
        normalizes each beam's score by its OWN length^penalty.  Without
        an eos every beam has equal length and the penalty only rescales
        scores.

        The cache runs at batch B*beam from the start (prompt rows
        replicated); the beams' reorder is a row gather of the device
        cache (skipped on the last step), and the bookkeeping
        (log-probs, back-pointers) is the JAX package's host numpy,
        operation for operation."""
        prompt = np.asarray(prompt)
        B, T = prompt.shape
        if T + n_tokens > self.max_len:
            raise ValueError(
                f"prompt+n_tokens = {T + n_tokens} exceeds max_len "
                f"{self.max_len}")
        if beam_size > self.vocab:
            raise ValueError(
                f"beam_size {beam_size} > vocab {self.vocab}")
        if n_tokens <= 0:
            return (np.zeros((B, beam_size, 0), np.int64),
                    np.zeros((B, beam_size), np.float32))
        K = beam_size

        def topk(mat, k):
            part = np.argpartition(-mat, k - 1, axis=-1)[:, :k]
            vals = np.take_along_axis(mat, part, axis=-1)
            order = np.argsort(-vals, axis=-1)
            return np.take_along_axis(part, order, axis=-1)

        def host(x):
            return x.float().cpu().numpy()

        state, logits = self.prefill(np.repeat(prompt, K, axis=0))
        last = host(logits[:, -1])                       # (B*K, V)
        V = last.shape[-1]
        logp = last - _logsumexp(last)
        # first expansion: distinct top-K continuations per batch row
        first = logp.reshape(B, K, V)[:, 0]              # replicas identical
        top = topk(first, K)                             # (B, K)
        scores = np.take_along_axis(first, top, axis=-1)  # (B, K)
        seqs = top[:, :, None]                           # (B, K, 1)
        finished = (top == eos_id) if eos_id is not None \
            else np.zeros((B, K), bool)
        lengths = np.ones((B, K), np.int64)
        nxt = top.reshape(-1)
        for i in range(1, n_tokens):
            if finished.all():
                pad = np.full((B, K, n_tokens - i), eos_id, np.int64)
                seqs = np.concatenate([seqs, pad], axis=2)
                break
            state, lg = self.step(state, nxt)
            logp = host(lg)
            logp = (logp - _logsumexp(logp)).reshape(B, K, V)
            cand = scores[:, :, None] + logp             # (B, K, V)
            if eos_id is not None:
                # a finished beam contributes exactly one candidate:
                # itself, eos-padded, score frozen
                cand[finished] = NEG_INF
                cand[finished, eos_id] = scores[finished]
            flat = cand.reshape(B, K * V)
            top = topk(flat, K)                          # (B, K)
            beam_idx, tok = top // V, top % V
            scores = np.take_along_axis(flat, top, axis=-1)
            seqs = np.concatenate(
                [np.take_along_axis(seqs, beam_idx[:, :, None], axis=1),
                 tok[:, :, None]], axis=2)
            parent_fin = np.take_along_axis(finished, beam_idx, axis=-1)
            lengths = np.take_along_axis(lengths, beam_idx, axis=-1) \
                + (~parent_fin)
            if eos_id is not None:
                finished = parent_fin | (tok == eos_id)
            nxt = tok.reshape(-1)
            if i + 1 < n_tokens and not finished.all():
                # follow the survivors on the device cache (skipped on
                # the last step — nothing consumes it)
                rows = torch.as_tensor(
                    (np.arange(B)[:, None] * K + beam_idx).reshape(-1),
                    device=self.device)
                kc, vc, pos = state
                with torch.inference_mode():
                    state = (kc[:, rows], vc[:, rows], pos)
        if length_penalty:
            scores = scores / (lengths.astype(np.float32)
                               ** length_penalty)
        order = np.argsort(-scores, axis=-1)
        return (np.take_along_axis(seqs, order[:, :, None], axis=1),
                np.take_along_axis(scores, order, axis=-1))
