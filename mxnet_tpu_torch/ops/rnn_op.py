"""The fused ``RNN`` op of the port (``mxnet_tpu/ops/rnn_op.py``; parity:
src/operator/rnn-inl.h): modes ``lstm``, ``gru``, ``rnn_tanh`` and
``rnn_relu``, several layers, bidirectional, dropout ``p`` between
layers, ``state_outputs``.

Inputs as in the reference: time-major data ``(T, N, input_size)``, one
packed 1-D ``parameters`` vector (:func:`rnn_param_size` long), the
initial ``state`` ``(layers * dirs, N, H)`` and, for LSTM,
``state_cell``.  Packing (cuDNN's layout, which the reference adopts):
for each layer and direction W_ih ``(G*H, in)`` then W_hh ``(G*H, H)``,
and after all weights, for each layer and direction b_ih then b_hh.
Gate order: i, g, f, o for LSTM (not cuDNN's or torch's i, f, g, o) and
r, z, n for GRU, where ``n = tanh(nx + r * (W_hn h + b_hn))``.

The JAX op is a ``lax.scan`` that XLA compiles; this is the same
arithmetic in PyTorch: one input-projection product per layer and
direction hoisted out of the time loop, then per step ``h @ W_hhᵀ`` and
the pointwise cell, in the JAX op's order of additions.  Dropout draws
from ``ctx.generator`` in training, on the outputs of every layer but
the last.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, parse_attr, parse_bool
from .nn import _uniform, _weak
from .registry import register

__all__ = ["rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """The packed parameter count (parity: rnn-inl.h ``rnn_param_size``)."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (in_size + state_size + 2)
    return size


def _unpack(params, num_layers, input_size, state_size, dirs, mode):
    """``[(w_ih, w_hh, b_ih, b_hh)]`` per layer and direction: views of
    the packed vector."""
    gh = _GATES[mode] * state_size
    weights, offset = [], 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * dirs
        for _ in range(dirs):
            w_ih = params[offset:offset + gh * in_size].reshape(gh, in_size)
            offset += gh * in_size
            w_hh = params[offset:offset + gh * state_size].reshape(
                gh, state_size)
            offset += gh * state_size
            weights.append((w_ih, w_hh))
    out = []
    for w_ih, w_hh in weights:
        b_ih = params[offset:offset + gh]
        b_hh = params[offset + gh:offset + 2 * gh]
        offset += 2 * gh
        out.append((w_ih, w_hh, b_ih, b_hh))
    return out


def _mm(a, b):
    """``a @ b`` in the promoted dtype (torch refuses mixed operands)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _run_layer(x, w_ih, w_hh, b_ih, b_hh, h, c, mode, reverse):
    """One direction of one layer over time (``x`` ``(T, N, in)``):
    ``(ys, h_T, c_T)``."""
    if reverse:
        x = torch.flip(x, (0,))
    pre_x = _mm(x, w_ih.t()) + b_ih    # hoisted: (T, N, G*H)
    ys = []
    for px in pre_x.unbind(0):
        hh = _mm(h, w_hh.t())
        if mode == "lstm":
            i, g, f, o = (px + hh + b_hh).chunk(4, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            rx, zx, nx = px.chunk(3, -1)
            rh, zh, nh = (hh + b_hh).chunk(3, -1)
            r = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx + r * nh)
            h = (1 - z) * n + z * h
        else:
            pre = px + hh + b_hh
            h = torch.relu(pre) if mode == "rnn_relu" else torch.tanh(pre)
        ys.append(h)
    ys = torch.stack(ys)
    if reverse:
        ys = torch.flip(ys, (0,))
    return ys, h, c


def _rnn_params_hook(attrs, data_shape, *rest):
    mode = attrs.get("mode", "lstm")
    state_size = int(parse_attr(attrs["state_size"]))
    num_layers = int(parse_attr(attrs["num_layers"]))
    bidirectional = parse_bool(attrs.get("bidirectional", False))
    dirs = 2 if bidirectional else 1
    shapes = {
        "parameters": (rnn_param_size(num_layers, data_shape[2], state_size,
                                      bidirectional, mode),),
        "state": (num_layers * dirs, data_shape[1], state_size),
    }
    if mode == "lstm":
        shapes["state_cell"] = shapes["state"]
    return shapes


def _rnn_optional(attrs):
    return set() if attrs.get("mode", "lstm") == "lstm" else {"state_cell"}


def _rnn_num_outputs(attrs):
    if not parse_bool(attrs.get("state_outputs", False)):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


@register("RNN", arg_names=("data", "parameters", "state", "state_cell"),
          output_names=("output", "state", "state_cell"),
          infer_params=_rnn_params_hook, optional_args=_rnn_optional,
          num_outputs_fn=_rnn_num_outputs, needs_rng=True)
def _rnn(ctx, data, parameters, state, state_cell=None, **attrs):
    """Output ``(T, N, H * dirs)``, and with ``state_outputs`` the final
    states ``(layers * dirs, N, H)`` (h, then c for LSTM).  Mixed dtypes
    promote, as the JAX op's products do."""
    mode = attrs.get("mode", "lstm")
    if mode not in _GATES:
        raise MXNetError(f"RNN: unknown mode {mode}")
    state_size = int(parse_attr(attrs["state_size"]))
    num_layers = int(parse_attr(attrs["num_layers"]))
    dirs = 2 if parse_bool(attrs.get("bidirectional", False)) else 1
    p = float(parse_attr(attrs.get("p", 0.0)))
    x = data
    layers = _unpack(parameters, num_layers, data.shape[2], state_size,
                     dirs, mode)
    h_out, c_out = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            idx = layer * dirs + d
            c0 = state_cell[idx] if mode == "lstm" else None
            ys, h, c = _run_layer(x, *layers[idx], state[idx], c0, mode,
                                  reverse=d == 1)
            outs.append(ys)
            h_out.append(h)
            c_out.append(c)
        x = outs[0] if dirs == 1 else torch.cat(outs, -1)
        if p > 0.0 and ctx.is_train and layer < num_layers - 1:
            keep = 1.0 - p
            mask = _uniform(ctx, x.shape, 0.0, 1.0, x) < keep
            x = torch.where(mask, x / _weak(keep, x), 0.0)
    if not parse_bool(attrs.get("state_outputs", False)):
        return x
    if mode == "lstm":
        return x, torch.stack(h_out), torch.stack(c_out)
    return x, torch.stack(h_out)
