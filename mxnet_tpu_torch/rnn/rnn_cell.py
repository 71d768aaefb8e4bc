"""RNN cells of the port (``mxnet_tpu/rnn/rnn_cell.py``; parity:
python/mxnet/rnn/rnn_cell.py): ``RNNCell``, ``LSTMCell``, ``LSTMPCell``,
``GRUCell``, ``FusedRNNCell`` over the ``RNN`` op, ``SequentialRNNCell``,
``BidirectionalCell``, ``ModifierCell``, ``DropoutCell`` and
``ZoneoutCell``, each unrolled into port Symbols with the JAX package's
node names (the two unrolls' JSON is equal).  Gate order i, g, f, o for
LSTM and r, z, n for GRU, in the cells and in the fused op alike, so a
``FusedRNNCell``'s packed vector unpacks
(:meth:`FusedRNNCell.unpack_weights`) into whole ``i2h``/``h2h``
matrices that the unrolled cells of prefix ``{prefix}l{layer}_`` (and
``{prefix}r{layer}_`` for the reverse direction) read as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ndarray as nd
from .. import symbol

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _concat(parts):
    """Arrays of one kind (numpy arrays, tensors or NDArrays) flattened
    and joined into one vector of that kind."""
    if isinstance(parts[0], nd.NDArray):
        return nd.NDArray(torch.cat([p.tensor.reshape(-1) for p in parts]))
    if isinstance(parts[0], torch.Tensor):
        return torch.cat([p.reshape(-1) for p in parts])
    return np.concatenate([np.asarray(p).reshape(-1) for p in parts])


class RNNParams:
    """The cell's parameter Variables, made on first use and shared
    between the cells given the same container."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Parity: rnn_cell.py BaseRNNCell."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_shape(self):
        raise NotImplementedError

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.Variable, **kwargs):
        """Parity: BaseRNNCell.begin_state."""
        assert not self._modified
        states = []
        for info in self.state_shape:
            self._init_counter += 1
            state = func(f"{self._prefix}begin_state_{self._init_counter}", **kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """``args`` as the unrolled cells read them (a copy: the
        unfused cells' weights are whole gate matrices already)."""
        return dict(args)

    def pack_weights(self, args):
        """The inverse of :meth:`unpack_weights`."""
        return dict(args)

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Parity: BaseRNNCell.unroll."""
        self.reset()
        if inputs is None:
            inputs = [symbol.Variable(f"{input_prefix}t{i}_data") for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs) == 1
            axis = layout.find("T")
            inputs = symbol.SliceChannel(inputs, axis=axis, num_outputs=length,
                                         squeeze_axis=True)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=1) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (parity: rnn_cell.py RNNCell:161)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden, name=f"{name}i2h")
        h2h = symbol.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                                    num_hidden=self._num_hidden, name=f"{name}h2h")
        output = symbol.Activation(i2h + h2h, act_type=self._activation,
                                   name=f"{name}out")
        return output, [output]


def _lstm_step(name, inputs, prev_h, prev_c, num_hidden, iW, iB, hW, hB):
    """The shared LSTM recurrence (gate order i, g(tanh), f, o):
    returns (next_h, next_c)."""
    i2h = symbol.FullyConnected(inputs, weight=iW, bias=iB,
                                num_hidden=num_hidden * 4, name=f"{name}i2h")
    h2h = symbol.FullyConnected(prev_h, weight=hW, bias=hB,
                                num_hidden=num_hidden * 4, name=f"{name}h2h")
    slice_gates = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                      name=f"{name}slice")
    in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid")
    in_transform = symbol.Activation(slice_gates[1], act_type="tanh")
    forget_gate = symbol.Activation(slice_gates[2], act_type="sigmoid")
    out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid")
    next_c = forget_gate * prev_c + in_gate * in_transform
    next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
    return next_h, next_c


class LSTMCell(BaseRNNCell):
    """LSTM cell (parity: rnn_cell.py LSTMCell:224; gate order i,g,f,o)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None, forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden), (0, self._num_hidden)]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        next_h, next_c = _lstm_step(name, inputs, states[0], states[1],
                                    self._num_hidden, self._iW, self._iB,
                                    self._hW, self._hB)
        return next_h, [next_h, next_c]


class LSTMPCell(BaseRNNCell):
    """LSTM with a linear projection of the hidden state (LSTMP,
    Sak et al. 2014 — the acoustic-model cell the reference builds
    inline in example/speech-demo/lstm_proj.py:49-56): the recurrence
    and the output both use ``r_t = W_r h_t`` with ``num_proj`` units,
    shrinking the h2h matmul from H×4H to P×4H.  State = [r, c]."""

    def __init__(self, num_hidden, num_proj, prefix="lstmp_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_proj = num_proj
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")
        self._pW = self.params.get("proj_weight")

    @property
    def state_shape(self):
        return [(0, self._num_proj), (0, self._num_hidden)]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        next_h, next_c = _lstm_step(name, inputs, states[0], states[1],
                                    self._num_hidden, self._iW, self._iB,
                                    self._hW, self._hB)
        next_r = symbol.FullyConnected(next_h, weight=self._pW, no_bias=True,
                                       num_hidden=self._num_proj,
                                       name=f"{name}proj")
        return next_r, [next_r, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (parity: rnn_cell.py GRUCell)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 3, name=f"{name}i2h")
        h2h = symbol.FullyConnected(prev_state_h, weight=self._hW, bias=self._hB,
                                    num_hidden=self._num_hidden * 3, name=f"{name}h2h")
        i2h_r, i2h_z, i2h = symbol.SliceChannel(i2h, num_outputs=3, name=f"{name}i2h_slice")
        h2h_r, h2h_z, h2h = symbol.SliceChannel(h2h, num_outputs=3, name=f"{name}h2h_slice")
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = update_gate * prev_state_h + (1.0 - update_gate) * next_h_tmp
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """A multi-layer RNN as one ``RNN`` op over a packed ``parameters``
    vector (parity: rnn_cell.py FusedRNNCell, which wraps the cuDNN op)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm", bidirectional=False,
                 dropout=0.0, get_next_state=False, prefix=None, params=None):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._parameters = self.params.get("parameters")

    @property
    def state_shape(self):
        dirs = 2 if self._bidirectional else 1
        n = [(self._num_layers * dirs, 0, self._num_hidden)]
        if self._mode == "lstm":
            n.append((self._num_layers * dirs, 0, self._num_hidden))
        return n

    def _slices(self, size):
        """``[(name, offset, shape)]`` of each matrix and bias in a packed
        vector of ``size`` elements, in the ``RNN`` op's packing order;
        names ``{prefix}{l|r}{layer}_{i2h|h2h}_{weight|bias}``."""
        dirs = 2 if self._bidirectional else 1
        gh = _GATES[self._mode] * self._num_hidden
        h = self._num_hidden
        # size = dirs*gh*(in + h + 2) + (layers-1)*dirs*gh*(dirs*h + h + 2)
        rest = (self._num_layers - 1) * dirs * gh * (dirs * h + h + 2)
        num_input = (size - rest) // (dirs * gh) - h - 2
        names = [f"{self._prefix}{'lr'[d]}{layer}_"
                 for layer in range(self._num_layers) for d in range(dirs)]
        out, offset = [], 0
        for k, name in enumerate(names):
            in_size = num_input if k < dirs else dirs * h
            for part, cols in (("i2h", in_size), ("h2h", h)):
                out.append((f"{name}{part}_weight", offset, (gh, cols)))
                offset += gh * cols
        for name in names:
            for part in ("i2h", "h2h"):
                out.append((f"{name}{part}_bias", offset, (gh,)))
                offset += gh
        return out

    def unpack_weights(self, args):
        """``args`` with the packed ``{prefix}parameters`` replaced by its
        matrices and biases (copies), named as the unfused cells of
        prefix ``{prefix}l{layer}_`` / ``{prefix}r{layer}_`` name theirs."""
        args = dict(args)
        arr = args.pop(self._parameters.name)
        wrap = isinstance(arr, nd.NDArray)
        flat = (arr.tensor if wrap else arr).reshape(-1)
        for name, offset, shape in self._slices(flat.shape[0]):
            piece = flat[offset:offset + int(np.prod(shape))].reshape(shape)
            piece = piece.copy() if isinstance(piece, np.ndarray) \
                else piece.clone()
            args[name] = nd.NDArray(piece) if wrap else piece
        return args

    def pack_weights(self, args):
        """The inverse of :meth:`unpack_weights`: the unfused cells'
        matrices and biases packed into ``{prefix}parameters``."""
        args = dict(args)
        h = self._num_hidden
        dirs = 2 if self._bidirectional else 1
        gh = _GATES[self._mode] * h
        num_input = args[f"{self._prefix}l0_i2h_weight"].shape[1]
        size = dirs * gh * (num_input + h + 2) \
            + (self._num_layers - 1) * dirs * gh * (dirs * h + h + 2)
        args[self._parameters.name] = _concat(
            [args.pop(name) for name, _, _ in self._slices(size)])
        return args

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        if isinstance(inputs, symbol.Symbol):
            if layout == "NTC":
                inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)  # -> TNC
        else:
            inputs = [symbol.expand_dims(i, axis=0) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=0)
        if begin_state is None:
            begin_state = self.begin_state()
        states = list(begin_state)
        kwargs = {"state": states[0]}
        if self._mode == "lstm":
            kwargs["state_cell"] = states[1]
        rnn = symbol.RNN(inputs, parameters=self._parameters,
                         mode=self._mode, state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         name=f"{self._prefix}rnn", **kwargs)
        if self._get_next_state:
            outputs = rnn[0]
            next_states = [rnn[i] for i in range(1, len(rnn))]
        else:
            outputs, next_states = rnn, []
        if layout == "NTC":
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        return outputs, next_states


class SequentialRNNCell(BaseRNNCell):
    """Stack cells (parity: rnn_cell.py SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_shape(self):
        return sum([c.state_shape for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._cells:
            n = len(cell.state_shape)
            state = states[pos : pos + n]
            pos += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states


class BidirectionalCell(BaseRNNCell):
    """Parity: rnn_cell.py BidirectionalCell."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._l_cell = l_cell
        self._r_cell = r_cell
        self._output_prefix = output_prefix

    @property
    def state_shape(self):
        return self._l_cell.state_shape + self._r_cell.state_shape

    def begin_state(self, **kwargs):
        return self._l_cell.begin_state(**kwargs) + self._r_cell.begin_state(**kwargs)

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        if isinstance(inputs, symbol.Symbol):
            axis = layout.find("T")
            inputs = symbol.SliceChannel(inputs, axis=axis, num_outputs=length,
                                         squeeze_axis=True)
            inputs = list(inputs)
        if begin_state is None:
            begin_state = self.begin_state()
        nl = len(self._l_cell.state_shape)
        l_outputs, l_states = self._l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:nl], layout=layout)
        r_outputs, r_states = self._r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[nl:], layout=layout)
        if isinstance(r_outputs, list):
            r_outputs = list(reversed(r_outputs))
        outputs = [
            symbol.Concat(l, r, dim=1, name=f"{self._output_prefix}t{i}")
            for i, (l, r) in enumerate(zip(l_outputs, r_outputs))
        ]
        return outputs, l_states + r_states


class ModifierCell(BaseRNNCell):
    """Parity: rnn_cell.py ModifierCell."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_shape(self):
        return self.base_cell.state_shape

    def begin_state(self, init_sym=symbol.Variable, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=init_sym, **kwargs)
        self.base_cell._modified = True
        return begin


class DropoutCell(BaseRNNCell):
    """Parity: rnn_cell.py DropoutCell — dropout as a cell."""

    def __init__(self, dropout=0.0, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_shape(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Parity: rnn_cell.py ZoneoutCell — stochastic state preservation."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        if self.zoneout_outputs > 0.0:
            prev = self.prev_output
            if prev is None:
                prev = next_output * 0.0
            mask = symbol.Dropout(next_output * 0.0 + 1.0, p=self.zoneout_outputs)
            next_output = mask * next_output * (1.0 - self.zoneout_outputs) + \
                (1.0 - mask * (1.0 - self.zoneout_outputs)) * prev
        if self.zoneout_states > 0.0:
            new_states = []
            for ns, s in zip(next_states, states):
                mask = symbol.Dropout(ns * 0.0 + 1.0, p=self.zoneout_states)
                new_states.append(mask * ns * (1.0 - self.zoneout_states) +
                                  (1.0 - mask * (1.0 - self.zoneout_states)) * s)
            next_states = new_states
        self.prev_output = next_output
        return next_output, next_states
