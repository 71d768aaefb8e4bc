"""RNN toolkit of the port (``mxnet_tpu/rnn/``; parity:
python/mxnet/rnn/): the cells, ``BucketSentenceIter`` and
:func:`rnn_unroll`."""
from .io import BucketSentenceIter  # noqa: F401
from .rnn_cell import (BaseRNNCell, BidirectionalCell,  # noqa: F401
                       DropoutCell, FusedRNNCell, GRUCell, LSTMCell,
                       LSTMPCell, ModifierCell, RNNCell, RNNParams,
                       SequentialRNNCell, ZoneoutCell)


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):
    """``cell.unroll(...)`` as a function (parity: rnn/rnn.py
    rnn_unroll)."""
    return cell.unroll(length, inputs=inputs, begin_state=begin_state,
                       input_prefix=input_prefix, layout=layout)
