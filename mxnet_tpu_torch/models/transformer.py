"""The transformer LM's parameter layout (mirrors
``mxnet_tpu/models/transformer.py``).

The port has no Symbol graph yet, so instead of ``transformer_lm`` this
module states the names and shapes that ``transformer_lm(...)``'s
``simple_bind`` creates — the checkpoint layout the decoder reads — and
a numpy helper that fills them from a seed.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

__all__ = ["MFU_HEADLINE_CONFIG", "lm_param_shapes", "lm_random_params"]

# the repo's largest LM configuration: 8 layers, d_model 2048, d_ff 8192,
# vocab 32768, seq_len 1024 — about 0.54 B parameters
MFU_HEADLINE_CONFIG = dict(num_layers=8, num_heads=16, d_model=2048,
                           d_ff=8192, seq_len=1024, vocab_size=32768)


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
