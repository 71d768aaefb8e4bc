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

Not ported yet: ``generate_scan``, ``beam_search``, ``mesh=`` tensor
parallelism and ``quantize="int8"`` (the last two raise).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from ..convert import from_jax_params
from ..ops import paged_attention as _pa

__all__ = ["KVDecoder", "NEG_INF"]

NEG_INF = -1e30


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
        if mesh is not None:
            raise MXNetError(
                "KVDecoder(mesh=...) tensor-parallel serving is not ported "
                "yet")
        if quantize is not None:
            raise MXNetError(
                f"KVDecoder(quantize={quantize!r}) is not ported yet")
        self.device = resolve_device(device)
        self.dtype = torch_dtype(dtype)
        p = from_jax_params(arg_params, self.dtype, self.device)
        self.mesh = None
        self.model_axis = model_axis
        self.quantize = None
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
        self.p = p

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
        tok = p["tok_embed_weight"][tokens.long()]             # (B, n, D)
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
        tok = p["tok_embed_weight"][tokens.long()]              # (B, D)
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
        tok = p["tok_embed_weight"][tokens.long()]              # (B, T, D)
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
        return self._forward_slots(
            kc, vc, _snap(tokens, self.device), _snap(start, self.device),
            _snap(cursor, self.device))

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

    def generate_scan(self, *args, **kwargs):
        raise MXNetError("KVDecoder.generate_scan is not ported yet "
                         "(use generate)")

    def beam_search(self, *args, **kwargs):
        raise MXNetError("KVDecoder.beam_search is not ported yet")
