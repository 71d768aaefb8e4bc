"""Operators of the port.  Importing the package registers every ported
op; ``paged_attention`` has a CUDA kernel but no op (the decoder calls
it directly)."""
from . import (elemwise, flash_attention, indexing,  # noqa: F401
               init_sample, loss, matrix, nn, optimizer_ops,
               paged_attention, reduce, residual_epilogue, rnn_op,
               sequence)
from .registry import (OpCtx, decode_attr, get, invoke,  # noqa: F401
                       list_ops, register)
