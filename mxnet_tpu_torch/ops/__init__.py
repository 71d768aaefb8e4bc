"""Operators of the port.  Importing the package registers every ported
op; ``paged_attention`` has a CUDA kernel but no op (the decoder calls
it directly)."""
from . import (elemwise, flash_attention, indexing, loss, matrix,  # noqa: F401
               nn, optimizer_ops, paged_attention, residual_epilogue)
from .registry import OpCtx, get, list_ops, register  # noqa: F401
