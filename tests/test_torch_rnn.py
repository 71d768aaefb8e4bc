"""The fused ``RNN`` op and the ``rnn`` cells of the port against the JAX
package's, on the CPU.

- the ``RNN`` op in its four modes, 2 layers, one and two directions,
  with and without ``state_outputs``: outputs and the gradients of the
  data, the packed parameters and the initial states (``jax.vjp``
  against ``torch.autograd.grad`` under a seeded cotangent);
- ``rnn_param_size`` and the op's inferred shapes;
- every cell's ``unroll`` (``layout`` NTC and TNC, symbol and list
  inputs): the JSON under fresh name managers, and the outputs of both
  packages' executors from the same numpy parameters;
- a ``FusedRNNCell`` against the unrolled cells it unpacks into
  (``unpack_weights``/``pack_weights``), both directions;
- the ``_parameters`` initializer, ``RNN(p>0)`` and ``DropoutCell`` by
  statistics (the packages' generators differ).

Tolerances: ``1e-5`` relative and absolute for forwards; ``1e-4`` for
gradients through time (8 steps and 2 layers of recurrent products in
fp32, summed in another order by each library); the fused op against
the unrolled cells ``1e-5`` (the same products, in another grouping).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import base as jbase
from mxnet_tpu import ops as jops
from mxnet_tpu import symbol as jsym
from mxnet_tpu.ops import rnn_op as jrnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn_op as trnn

T, N, C, H = 8, 3, 5, 4


def _n(seed, *shape, scale=1.0):
    return np.asarray(np.random.RandomState(seed).normal(size=shape)
                      * scale, dtype=np.float32)


def _rnn_inputs(mode, layers, bidirectional, seed=0):
    dirs = 2 if bidirectional else 1
    size = jrnn.rnn_param_size(layers, C, H, bidirectional, mode)
    ins = [_n(seed, T, N, C), _n(seed + 1, size, scale=0.3),
           _n(seed + 2, layers * dirs, N, H, scale=0.5)]
    if mode == "lstm":
        ins.append(_n(seed + 3, layers * dirs, N, H, scale=0.5))
    return ins


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("state_outputs", [False, True])
def test_rnn_op_matches_jax(mode, bidirectional, state_outputs):
    ins = _rnn_inputs(mode, 2, bidirectional)
    attrs = {"mode": mode, "state_size": H, "num_layers": 2,
             "bidirectional": bidirectional, "state_outputs": state_outputs}
    jop, top = jops.get("RNN"), treg.get("RNN")
    jout, vjp = jax.vjp(lambda *xs: jop.fn(jops.OpCtx(), *xs, **attrs),
                        *[jnp.asarray(a) for a in ins])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    tout = top.fn(treg.OpCtx(), *ts, **attrs)
    jouts = list(jout) if isinstance(jout, tuple) else [jout]
    touts = list(tout) if isinstance(tout, tuple) else [tout]
    assert len(touts) == top.count_outputs(attrs) == len(jouts)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5)
    cts = [_n(50 + i, *t.shape) for i, t in enumerate(touts)]
    jg = vjp(tuple(jnp.asarray(c) for c in cts) if isinstance(jout, tuple)
             else jnp.asarray(cts[0]))
    tg = torch.autograd.grad(touts, ts, [torch.from_numpy(c) for c in cts])
    for j, t in zip(jg, tg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("layers,bidirectional,input_size",
                         [(1, False, 7), (2, False, 5), (3, True, 6)])
def test_rnn_param_size_matches_jax(mode, layers, bidirectional, input_size):
    assert trnn.rnn_param_size(layers, input_size, 9, bidirectional, mode) \
        == jrnn.rnn_param_size(layers, input_size, 9, bidirectional, mode)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_op_infers_the_packed_shapes(mode):
    net = tsym.RNN(tsym.Variable("data"), mode=mode, state_size=H,
                   num_layers=2, bidirectional=True, state_outputs=True,
                   name="rnn")
    args, outs, _ = net.infer_shape(data=(T, N, C))
    shapes = dict(zip(net.list_arguments(), args))
    jnet = jsym.RNN(jsym.Variable("data"), mode=mode, state_size=H,
                    num_layers=2, bidirectional=True, state_outputs=True,
                    name="rnn")
    jargs, jouts, _ = jnet.infer_shape(data=(T, N, C))
    assert shapes == dict(zip(jnet.list_arguments(), jargs))
    assert [tuple(o) for o in outs] == [tuple(o) for o in jouts]
    assert net.list_outputs() == jnet.list_outputs()


# ------------------------------------------------------------- cells
def _both(build):
    """``build(package)`` under fresh name managers in both packages:
    ``(jax symbol, port symbol)``."""
    with jbase.NameManager():
        want = build(jmx)
    old = tbase._NAME_MANAGER
    tbase._NAME_MANAGER = tbase.NameManager()
    try:
        got = build(tmx)
    finally:
        tbase._NAME_MANAGER = old
    return want, got


def _unrolled(cell_fn, layout="NTC", inputs="symbol", merge=None):
    def build(mx):
        cell = cell_fn(mx)
        if inputs == "symbol":
            x = mx.sym.Variable("data")
        else:
            x = [mx.sym.Variable(f"x{i}") for i in range(T)]
        outs, states = cell.unroll(T, inputs=x, layout=layout,
                                   merge_outputs=merge)
        outs = outs if isinstance(outs, list) else [outs]
        return mx.sym.Group(list(outs) + list(states))
    return build


def _lstm_stack(mx):
    cell = mx.rnn.SequentialRNNCell()
    cell.add(mx.rnn.LSTMCell(H, prefix="l0_"))
    cell.add(mx.rnn.DropoutCell(0.0))
    cell.add(mx.rnn.LSTMCell(H, prefix="l1_"))
    return cell


CELLS = {
    "rnn_tanh": lambda mx: mx.rnn.RNNCell(H, prefix="r_"),
    "rnn_relu": lambda mx: mx.rnn.RNNCell(H, activation="relu"),
    "lstm": lambda mx: mx.rnn.LSTMCell(H, forget_bias=0.0),
    "lstmp": lambda mx: mx.rnn.LSTMPCell(H, 3),
    "gru": lambda mx: mx.rnn.GRUCell(H),
    "stack": _lstm_stack,
    "zoneout": lambda mx: mx.rnn.ZoneoutCell(mx.rnn.GRUCell(H),
                                             zoneout_outputs=0.3,
                                             zoneout_states=0.2),
    "fused_lstm": lambda mx: mx.rnn.FusedRNNCell(H, num_layers=2,
                                                 get_next_state=True),
    "fused_gru_bi": lambda mx: mx.rnn.FusedRNNCell(H, mode="gru",
                                                   bidirectional=True),
    "fused_tanh": lambda mx: mx.rnn.FusedRNNCell(H, mode="rnn_tanh",
                                                 prefix="f_",
                                                 get_next_state=True),
}
UNROLLS = {
    "symbol_ntc": ("NTC", "symbol", None),
    "symbol_tnc": ("TNC", "symbol", None),
    "list_merged": ("NTC", "list", True),
}


def _data_shapes(port_sym, layout, inputs):
    shapes = {}
    for name in port_sym.list_arguments():
        if name == "data":
            shapes[name] = (N, T, C) if layout == "NTC" else (T, N, C)
        elif name.startswith("x") and inputs == "list":
            shapes[name] = (N, C)
    return shapes


def _bind_both(jnet, tnet, shapes):
    """Both executors bound at the input ``shapes`` and fed the same numpy
    values (parameters from seeds); ``(jax outputs, port outputs)`` of
    an eval forward."""
    args, _, _ = tnet.infer_shape(**shapes)
    values = {n: _n(i, *s, scale=0.4)
              for i, (n, s) in enumerate(zip(tnet.list_arguments(), args))}
    jexe = jnet.simple_bind(ctx=jmx.cpu(), **{k: v.shape
                                              for k, v in values.items()})
    texe = tnet.simple_bind("cpu", **{k: v.shape for k, v in values.items()})
    jexe.forward(is_train=False, **values)
    touts = texe.forward(is_train=False, **values)
    return [o.asnumpy() for o in jexe.outputs], [t.numpy() for t in touts]


@pytest.mark.parametrize("unroll", sorted(UNROLLS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_unroll_matches_jax(cell, unroll):
    layout, inputs, merge = UNROLLS[unroll]
    if cell.startswith("fused") and inputs == "list":
        merge = None   # the fused cell returns one merged output
    jnet, tnet = _both(_unrolled(CELLS[cell], layout, inputs, merge))
    assert tnet.tojson() == jnet.tojson()
    assert tnet.list_arguments() == jnet.list_arguments()
    shapes = _data_shapes(tnet, layout, inputs)
    state_shapes = {}
    for k in tnet.list_arguments():
        if "begin_state" in k:
            if cell.startswith("fused"):
                dirs = 2 if "bi" in cell else 1
                layers = 2 if cell == "fused_lstm" else 1
                state_shapes[k] = (layers * dirs, N, H)
            elif cell == "lstmp" and k.endswith("_0"):
                state_shapes[k] = (N, 3)
            else:
                state_shapes[k] = (N, H)
    shapes.update(state_shapes)
    jouts, touts = _bind_both(jnet, tnet, shapes)
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_bidirectional_cell_matches_jax():
    def build(mx):
        cell = mx.rnn.BidirectionalCell(mx.rnn.LSTMCell(H, prefix="l_"),
                                        mx.rnn.GRUCell(H, prefix="r_"))
        outs, states = cell.unroll(T, inputs=mx.sym.Variable("data"))
        return mx.sym.Group(list(outs) + list(states))

    jnet, tnet = _both(build)
    assert tnet.tojson() == jnet.tojson()
    shapes = {k: (N, H) for k in tnet.list_arguments() if "begin" in k}
    shapes["data"] = (N, T, C)
    jouts, touts = _bind_both(jnet, tnet, shapes)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_begin_state_and_rnn_unroll():
    cell = tmx.rnn.LSTMCell(H, prefix="c_")
    states = cell.begin_state()
    assert [s.name for s in states] == ["c_begin_state_0",
                                        "c_begin_state_1"]
    outs, _ = tmx.rnn.rnn_unroll(tmx.rnn.GRUCell(H, prefix="g_"), 3,
                                 inputs=tsym.Variable("data"))
    assert len(outs) == 3
    assert cell.state_shape == [(0, H), (0, H)]
    fused = tmx.rnn.FusedRNNCell(H, num_layers=3, bidirectional=True)
    assert fused.state_shape == [(6, 0, H), (6, 0, H)]


# ------------------------------------------- fused against unrolled
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_fused_cell_equals_its_unpacked_cells(mode):
    layers = 2
    fused = tmx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                 prefix="f_")
    fnet, _ = fused.unroll(T, inputs=tsym.Variable("data"), layout="TNC")
    stack = tmx.rnn.SequentialRNNCell()
    for i in range(layers):
        make = {"lstm": tmx.rnn.LSTMCell, "gru": tmx.rnn.GRUCell,
                "rnn_tanh": tmx.rnn.RNNCell}[mode]
        stack.add(make(H, prefix=f"f_l{i}_"))
    outs, _ = stack.unroll(T, inputs=tsym.Variable("data"), layout="TNC",
                           merge_outputs=True)
    size = trnn.rnn_param_size(layers, C, H, False, mode)
    packed = _n(7, size, scale=0.3)
    args = fused.unpack_weights({"f_parameters": packed})
    assert sorted(args) == sorted(
        n for n in outs.list_arguments() if n != "data"
        and "begin_state" not in n)
    back = fused.pack_weights(dict(args))
    np.testing.assert_array_equal(back["f_parameters"], packed)
    for kind in (torch.from_numpy, lambda a: tmx.nd.array(a, ctx="cpu")):
        round_trip = fused.pack_weights(fused.unpack_weights(
            {"f_parameters": kind(packed)}))["f_parameters"]
        np.testing.assert_array_equal(
            round_trip.asnumpy() if hasattr(round_trip, "asnumpy")
            else round_trip.numpy(), packed)
    x = _n(8, T, N, C)
    fexe = fnet.simple_bind("cpu", data=(T, N, C),
                            f_begin_state_0=(layers, N, H),
                            **({"f_begin_state_1": (layers, N, H)}
                               if mode == "lstm" else {}))
    (fo,) = fexe.forward(data=x, f_parameters=packed)
    shapes = {k: (N, H) for k in outs.list_arguments() if "begin" in k}
    uexe = outs.simple_bind("cpu", data=(T, N, C), **shapes)
    (uo,) = uexe.forward(data=x, **args)
    # the unrolled cells merge their steps on axis 1, whatever the layout
    np.testing.assert_allclose(uo.numpy().transpose(1, 0, 2), fo.numpy(),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ by statistics
def test_parameters_initializer_by_statistics():
    for init in (tinit.Uniform(0.01), tinit.Xavier(), tinit.Normal(0.5)):
        arr = torch.zeros(40000)
        init("lstm_parameters", arr)
        x = arr.numpy()
        assert x.min() >= -0.07 and x.max() < 0.07
        assert abs(x.mean()) < 4 * 0.07 / np.sqrt(3 * x.size)
        assert abs(x.std() - 0.07 / np.sqrt(3)) < 1e-3
    # bilinear names are ported (they raised here before): the upsampling
    # kernel, whatever the initializer
    up = torch.zeros(2, 2, 4, 4)
    tinit.Uniform()("up_bilinear", up)
    np.testing.assert_allclose(up[0, 0, 1].numpy(),
                               [0.1875, 0.5625, 0.5625, 0.1875])


def test_rnn_dropout_between_layers_by_statistics():
    # rnn_relu, 2 layers: layer 1 outputs relu(b_ih) = 1 everywhere, and
    # unit 0 of layer 2 reads unit 0 of layer 1 after the dropout, so it
    # is 0 or 1 / keep
    size = trnn.rnn_param_size(2, C, H, False, "rnn_relu")
    params = np.zeros(size, np.float32)
    weights = H * C + 3 * H * H
    params[weights:weights + H] = 1.0          # layer 1 b_ih
    params[H * C + H * H] = 1.0                # layer 2 W_ih[0, 0]
    ins = [torch.ones(64, 256, C), torch.from_numpy(params),
           torch.zeros(2, 256, H)]
    gen = torch.Generator().manual_seed(0)
    attrs = {"mode": "rnn_relu", "state_size": H, "num_layers": 2, "p": 0.3}
    out = treg.get("RNN").fn(treg.OpCtx(is_train=True, generator=gen),
                             *ins, **attrs)
    v = out[..., 0].reshape(-1)
    kept = (v != 0).double().mean().item()
    assert abs(kept - 0.7) < 4 * np.sqrt(0.21 / v.numel())
    torch.testing.assert_close(v[v != 0], torch.full_like(v[v != 0],
                                                          1 / 0.7))
    # the last layer's outputs are not dropped; eval drops nothing
    assert bool((out[..., 1:] == 0).all())
    ev = treg.get("RNN").fn(treg.OpCtx(is_train=False), *ins, **attrs)
    assert bool((ev[..., 0] == 1).all())


def test_dropout_cell_by_statistics():
    cell = tmx.rnn.DropoutCell(0.4)
    outs, _ = cell.unroll(2, inputs=tsym.Variable("data"))
    net = tsym.Group(list(outs))
    exe = net.simple_bind("cpu", data=(200, 2, 100))
    trandom.seed(1)
    a = exe.forward(is_train=True, data=np.ones((200, 2, 100), np.float32))
    kept = np.concatenate([o.numpy().ravel() for o in a])
    share = (kept != 0).mean()
    assert abs(share - 0.6) < 4 * np.sqrt(0.24 / kept.size)
    np.testing.assert_allclose(kept[kept != 0], 1 / 0.6, rtol=1e-6)
    b = exe.forward(is_train=False, data=np.ones((200, 2, 100), np.float32))
    assert all(bool((o == 1).all()) for o in b)


def test_bidirectional_fused_cell_equals_its_unpacked_cells():
    fused = tmx.rnn.FusedRNNCell(H, num_layers=1, bidirectional=True,
                                 prefix="f_")
    fnet, _ = fused.unroll(T, inputs=tsym.Variable("data"), layout="TNC")
    bi = tmx.rnn.BidirectionalCell(tmx.rnn.LSTMCell(H, prefix="f_l0_"),
                                   tmx.rnn.LSTMCell(H, prefix="f_r0_"))
    outs, _ = bi.unroll(T, inputs=tsym.Variable("data"), layout="TNC")
    unet = tsym.Group(outs)
    packed = _n(9, trnn.rnn_param_size(1, C, H, True, "lstm"), scale=0.3)
    args = fused.unpack_weights({"f_parameters": packed})
    x = _n(10, T, N, C)
    fexe = fnet.simple_bind("cpu", data=(T, N, C),
                            f_begin_state_0=(2, N, H),
                            f_begin_state_1=(2, N, H))
    (fo,) = fexe.forward(data=x, f_parameters=packed)
    uexe = unet.simple_bind("cpu", data=(T, N, C), **{
        k: (N, H) for k in unet.list_arguments() if "begin" in k})
    uo = uexe.forward(data=x, **args)
    np.testing.assert_allclose(torch.stack(uo).numpy(), fo.numpy(),
                               rtol=1e-5, atol=1e-5)
