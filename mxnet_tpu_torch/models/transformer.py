"""Decoder-only transformer LM (mirrors ``mxnet_tpu/models/transformer.py``).

:func:`transformer_lm` builds the training Symbol (causal
``FlashAttention`` inside each block, LayerNorm, gelu FFN,
``SoftmaxOutput`` head) for :class:`mxnet_tpu_torch.trainer.FusedTrainer`;
:func:`lm_param_shapes` states the names and shapes it binds (the
checkpoint layout the decoder reads) and :func:`lm_random_params` fills
them from a seed; :func:`lm_train_flops_per_token` is the FLOP count MFU
is computed from.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .. import symbol as sym

__all__ = ["MFU_HEADLINE_CONFIG", "transformer_lm", "get_symbol",
           "lm_train_flops_per_token", "lm_param_shapes", "lm_random_params"]

# the repo's largest LM configuration: 8 layers, d_model 2048, d_ff 8192,
# vocab 32768, seq_len 1024 — about 0.54 B parameters
MFU_HEADLINE_CONFIG = dict(num_layers=8, num_heads=16, d_model=2048,
                           d_ff=8192, seq_len=1024, vocab_size=32768)


def _attention_block(h, seq_len, d_model, num_heads, name):
    dh = d_model // num_heads
    ln = sym.LayerNorm(h, name=f"{name}_ln1")
    x2 = sym.Reshape(ln, shape=(-1, d_model))

    # separate q/k/v projections, as in the JAX package
    def heads(proj_name):
        p = sym.FullyConnected(x2, num_hidden=d_model, name=proj_name)
        p = sym.Reshape(p, shape=(-1, seq_len, num_heads, dh))
        return sym.transpose(p, axes=(0, 2, 1, 3))  # (N, H, T, Dh)

    att = sym.FlashAttention(heads(f"{name}_q"), heads(f"{name}_k"),
                             heads(f"{name}_v"),
                             causal=True, name=f"{name}_attn")
    att = sym.transpose(att, axes=(0, 2, 1, 3))
    att = sym.Reshape(att, shape=(-1, d_model))
    proj = sym.FullyConnected(att, num_hidden=d_model, name=f"{name}_proj")
    proj = sym.Reshape(proj, shape=(-1, seq_len, d_model))
    return h + proj


def _ffn_block(h, seq_len, d_model, d_ff, name, dropout):
    ln = sym.LayerNorm(h, name=f"{name}_ln2")
    x2 = sym.Reshape(ln, shape=(-1, d_model))
    f = sym.FullyConnected(x2, num_hidden=d_ff, name=f"{name}_ffn_in")
    f = sym.Activation(f, act_type="gelu")
    if dropout > 0:
        f = sym.Dropout(f, p=dropout)
    f = sym.FullyConnected(f, num_hidden=d_model, name=f"{name}_ffn_out")
    f = sym.Reshape(f, shape=(-1, seq_len, d_model))
    return h + f


def transformer_lm(num_layers=4, num_heads=4, d_model=128, d_ff=None,
                   seq_len=128, vocab_size=1000, dropout=0.0,
                   ignore_label=None, max_len=None):
    """Next-token LM: ``data`` (N, T) token ids, ``softmax_label`` (N, T).

    ``ignore_label`` masks padding out of the loss and gradient
    (normalization "valid"); ``max_len`` sizes the positional table
    apart from this ``seq_len``.  ``pos_embed`` has no suffix the
    initializer knows, so it starts at zeros."""
    if d_model % num_heads:
        raise ValueError("d_model must divide by num_heads")
    d_ff = d_ff or 4 * d_model
    max_len = max_len or seq_len
    if max_len < seq_len:
        raise ValueError("max_len must be >= seq_len")
    data = sym.Variable("data")
    tok = sym.Embedding(data, input_dim=vocab_size, output_dim=d_model,
                        name="tok_embed")
    pos = sym.Variable("pos_embed", shape=(1, max_len, d_model))
    if max_len != seq_len:
        pos = sym.slice_axis(pos, axis=1, begin=0, end=seq_len)
    h = sym.broadcast_add(tok, pos)
    for i in range(num_layers):
        h = _attention_block(h, seq_len, d_model, num_heads, f"layer{i}")
        h = _ffn_block(h, seq_len, d_model, d_ff, f"layer{i}", dropout)
    h = sym.LayerNorm(h, name="final_ln")
    h = sym.Reshape(h, shape=(-1, d_model))
    logits = sym.FullyConnected(h, num_hidden=vocab_size, name="lm_head")
    label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
    loss_kw = {}
    if ignore_label is not None:
        loss_kw = {"use_ignore": True, "ignore_label": ignore_label,
                   "normalization": "valid"}
    return sym.SoftmaxOutput(logits, label, name="softmax", **loss_kw)


def get_symbol(num_classes=1000, **kwargs):
    """``models.get_symbol("transformer-lm", ...)``: the vocabulary is
    ``num_classes`` unless ``vocab_size`` is given."""
    kwargs.setdefault("vocab_size", num_classes)
    return transformer_lm(**kwargs)


def lm_train_flops_per_token(num_layers, d_model, d_ff, seq_len,
                             vocab_size):
    """Model FLOPs of one training token (the JAX package's accounting):
    6 x the matmul parameters (q/k/v/proj, FFN, head; embedding gathers
    are free) plus causal-halved attention, 6*L*T*D."""
    n_mat = (num_layers * (4 * d_model * d_model + 2 * d_model * d_ff)
             + d_model * vocab_size)
    return 6 * n_mat + 6 * num_layers * seq_len * d_model


def lm_param_shapes(num_layers, num_heads, d_model, d_ff, vocab_size,
                    max_len):
    """``{name: shape}`` of every parameter ``transformer_lm`` binds, in
    bind order.  FullyConnected weights are ``(out, in)``, as MXNet
    stores them; LayerNorm keeps ``gamma``/``beta`` of width ``d_model``."""
    if d_model % num_heads:
        raise ValueError("d_model must divide by num_heads")
    D = d_model
    shapes = OrderedDict()
    shapes["tok_embed_weight"] = (vocab_size, D)
    shapes["pos_embed"] = (1, max_len, D)
    for i in range(num_layers):
        n = f"layer{i}"
        shapes[f"{n}_ln1_gamma"] = (D,)
        shapes[f"{n}_ln1_beta"] = (D,)
        for proj in ("q", "k", "v", "proj"):
            shapes[f"{n}_{proj}_weight"] = (D, D)
            shapes[f"{n}_{proj}_bias"] = (D,)
        shapes[f"{n}_ln2_gamma"] = (D,)
        shapes[f"{n}_ln2_beta"] = (D,)
        shapes[f"{n}_ffn_in_weight"] = (d_ff, D)
        shapes[f"{n}_ffn_in_bias"] = (d_ff,)
        shapes[f"{n}_ffn_out_weight"] = (D, d_ff)
        shapes[f"{n}_ffn_out_bias"] = (D,)
    shapes["final_ln_gamma"] = (D,)
    shapes["final_ln_beta"] = (D,)
    shapes["lm_head_weight"] = (vocab_size, D)
    shapes["lm_head_bias"] = (vocab_size,)
    return shapes


def lm_random_params(shapes, seed=0, std=0.02):
    """float32 numpy parameters for ``shapes``: weights and embeddings
    ``N(0, std)`` drawn in ``shapes`` order from
    ``np.random.default_rng(seed)``, LayerNorm ``gamma`` ones, ``beta``
    and biases zeros — a fresh-initialised checkpoint."""
    rng = np.random.default_rng(seed)
    out = OrderedDict()
    for name, shape in shapes.items():
        if name.endswith("_gamma"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            out[name] = np.zeros(shape, np.float32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(std)
            out[name] = a
    return out
