"""The unrolled LSTM language model of the port (``mxnet_tpu/models/lstm.py``;
parity: example/rnn/lstm.py, the lstm_bucketing / PTB workload).

``lstm_unroll`` builds the same graph, node for node and name for name,
as the JAX package (its JSON is equal): an ``Embedding``, per step and
layer an LSTM cell of two ``FullyConnected`` products, a
``SliceChannel`` into the gates (i, g, f, o) and the pointwise update,
``Dropout`` on the inputs of every layer but the first and on each
step's output, then one ``FullyConnected`` over the time-major
``Concat`` of the steps and a ``SoftmaxOutput`` against the transposed
labels.  The models table of :func:`mxnet_tpu_torch.models.get_symbol`
has no ``lstm`` entry, as the reference's has none: this module is
reached as ``models.lstm``.
"""
from collections import namedtuple

from .. import symbol as sym

LSTMState = namedtuple("LSTMState", ["c", "h"])
LSTMParam = namedtuple("LSTMParam", ["i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias"])


def lstm(num_hidden, indata, prev_state, param, seqidx, layeridx, dropout=0.0):
    """One LSTM step of layer ``layeridx`` at time ``seqidx``."""
    if dropout > 0.0:
        indata = sym.Dropout(indata, p=dropout)
    i2h = sym.FullyConnected(indata, weight=param.i2h_weight, bias=param.i2h_bias,
                             num_hidden=num_hidden * 4,
                             name=f"t{seqidx}_l{layeridx}_i2h")
    h2h = sym.FullyConnected(prev_state.h, weight=param.h2h_weight,
                             bias=param.h2h_bias, num_hidden=num_hidden * 4,
                             name=f"t{seqidx}_l{layeridx}_h2h")
    gates = i2h + h2h
    slice_gates = sym.SliceChannel(gates, num_outputs=4,
                                   name=f"t{seqidx}_l{layeridx}_slice")
    in_gate = sym.Activation(slice_gates[0], act_type="sigmoid")
    in_transform = sym.Activation(slice_gates[1], act_type="tanh")
    forget_gate = sym.Activation(slice_gates[2], act_type="sigmoid")
    out_gate = sym.Activation(slice_gates[3], act_type="sigmoid")
    next_c = (forget_gate * prev_state.c) + (in_gate * in_transform)
    next_h = out_gate * sym.Activation(next_c, act_type="tanh")
    return LSTMState(c=next_c, h=next_h)


def lstm_unroll(num_lstm_layer, seq_len, input_size, num_hidden, num_embed,
                num_label, dropout=0.0, ignore_label=None):
    """The language model over ``seq_len`` steps (the bucketing
    ``sym_gen`` body).  The initial states ``l{i}_init_c``/``l{i}_init_h``
    are inputs, fed as zeros.  ``ignore_label`` masks that label id out
    of the loss and its gradient (a use_ignore ``SoftmaxOutput``), which
    makes compile-bucket padding exact
    (``BucketingModule(compile_buckets=...)``)."""
    embed_weight = sym.Variable("embed_weight")
    cls_weight = sym.Variable("cls_weight")
    cls_bias = sym.Variable("cls_bias")
    param_cells = []
    last_states = []
    for i in range(num_lstm_layer):
        param_cells.append(LSTMParam(
            i2h_weight=sym.Variable(f"l{i}_i2h_weight"),
            i2h_bias=sym.Variable(f"l{i}_i2h_bias"),
            h2h_weight=sym.Variable(f"l{i}_h2h_weight"),
            h2h_bias=sym.Variable(f"l{i}_h2h_bias")))
        last_states.append(LSTMState(
            c=sym.Variable(f"l{i}_init_c"), h=sym.Variable(f"l{i}_init_h")))

    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data, weight=embed_weight, input_dim=input_size,
                          output_dim=num_embed, name="embed")
    wordvec = sym.SliceChannel(embed, num_outputs=seq_len, axis=1,
                               squeeze_axis=True)

    hidden_all = []
    for seqidx in range(seq_len):
        hidden = wordvec[seqidx]
        for i in range(num_lstm_layer):
            next_state = lstm(num_hidden, indata=hidden,
                              prev_state=last_states[i], param=param_cells[i],
                              seqidx=seqidx, layeridx=i,
                              dropout=dropout if i > 0 else 0.0)
            hidden = next_state.h
            last_states[i] = next_state
        if dropout > 0.0:
            hidden = sym.Dropout(hidden, p=dropout)
        hidden_all.append(hidden)

    hidden_concat = sym.Concat(*hidden_all, dim=0)
    pred = sym.FullyConnected(hidden_concat, num_hidden=num_label,
                              weight=cls_weight, bias=cls_bias, name="pred")
    label_t = sym.transpose(label)
    label_flat = sym.Reshape(label_t, shape=(-1,))
    if ignore_label is not None:
        return sym.SoftmaxOutput(pred, label_flat, name="softmax",
                                 use_ignore=True, ignore_label=ignore_label)
    return sym.SoftmaxOutput(pred, label_flat, name="softmax")


def get_symbol(num_classes=10000, seq_len=32, num_hidden=200, num_embed=200,
               num_lstm_layer=2, dropout=0.2, **kwargs):
    """PTB's 2 x 200 LSTM over ``num_classes`` words, ``dropout`` 0.2."""
    return lstm_unroll(num_lstm_layer, seq_len, num_classes, num_hidden,
                       num_embed, num_classes, dropout)
