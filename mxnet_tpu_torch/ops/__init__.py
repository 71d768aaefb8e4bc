"""Operators of the port.  Importing the package registers every ported
op; ``paged_attention`` has a CUDA kernel but no op (the decoder calls
it directly).  ``custom`` is the ``Custom`` op over the Props that
:mod:`mxnet_tpu_torch.operator` registers."""
from . import (ctc, custom, elemwise, flash_attention,  # noqa: F401
               indexing, init_sample, loss, matrix, nn, optimizer_ops,
               paged_attention, reduce, residual_epilogue, rnn_op,
               sequence, vision)
from .registry import (OpCtx, decode_attr, get, invoke,  # noqa: F401
                       list_ops, register)
